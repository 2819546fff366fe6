"""Model bundle: everything static that defines one registration problem
(port of ``ir_sgmcmc_tpu/engine/bundle.py``)."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from .._device import resolve_device
from ..models.gmm import GMM
from ..models.reg_loss import RegLoss
from ..ops.sobolev import sobolev_kernel_1d, sobolev_smooth


@dataclass
class ModelBundle:
    dims: tuple
    gmm: GMM
    scale_prior: Any  # prior over GMM log-scales
    proportion_prior: Any  # prior over GMM log-proportions
    reg_loss: RegLoss
    transformation: Any  # SVF3D / SVFFD3D / BSplineFFD3D
    reg_loc_prior: Optional[Any] = None  # for learnable RegLossLogNormal
    reg_scale_prior: Optional[Any] = None
    reg_w_reg_prior: Optional[Any] = None  # for learnable RegLossL2
    sobolev_s: Optional[int] = 3
    sobolev_lambda: float = 0.5
    uniform_noise_alpha: Optional[float] = 0.1
    noise_scheme: str = "post"
    block_warp: bool = True
    block_radius: int = 2
    block_size: int = 8
    virtual_decimation: bool = True
    _sobolev_kernel: Optional[torch.Tensor] = field(default=None, repr=False)

    def __post_init__(self):
        if self.sobolev_s is not None:
            k, _ = sobolev_kernel_1d(self.sobolev_s, self.sobolev_lambda)
            self._sobolev_kernel = torch.as_tensor(k, dtype=torch.float32)

    def smooth(self, v: torch.Tensor) -> torch.Tensor:
        """Sobolev-smooth a field (identity backward); no-op when disabled."""
        if self._sobolev_kernel is None:
            return v
        return sobolev_smooth(v, self._sobolev_kernel)

    @property
    def field_dims(self) -> tuple:
        """Spatial shape of the sampled state (the control grid for SVFFD)."""
        if hasattr(self.transformation, "control_dims"):
            return tuple(self.transformation.control_dims)
        return tuple(self.dims)

    def init_q_v(self, sigma_v_init: float, u_v_init: float, device=None) -> dict:
        """Variational parameters: ``mu = 0``, ``log_var = 2 log sigma_v_init``,
        ``u = u_v_init``, each ``(3, D, H, W)``, on ``device`` (default: the
        CUDA card)."""
        device = resolve_device(device)
        shape = (3,) + self.field_dims
        return {
            "mu": torch.zeros(shape, dtype=torch.float32, device=device),
            "log_var": torch.full(shape, 2.0 * math.log(sigma_v_init),
                                  dtype=torch.float32, device=device),
            "u": torch.full(shape, float(u_v_init), dtype=torch.float32, device=device),
        }

    def gmm_prior_terms(self, gmm_params: dict) -> torch.Tensor:
        """GMM hyperprior log-densities, summed over components, per chain."""
        return (torch.sum(self.scale_prior(gmm_params["log_std"]), dim=-1)
                + self.proportion_prior(GMM.log_proportions(gmm_params)))
