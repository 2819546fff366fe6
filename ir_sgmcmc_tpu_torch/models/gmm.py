"""Gaussian-mixture likelihood over LCC residuals, with virtual decimation
(port of ``ir_sgmcmc_tpu/models/gmm.py``).

Parameters are dicts of tensors ``{"logits": (…, K), "log_std": (…, K)}``;
a leading chain axis on the parameters pairs with a leading chain axis on
the residuals ``(…, D, H, W)``.  Reductions are mask-weighted over the full
grid and return one value per leading index; a ``layout``
(``ops/_layout.py``) takes their sums over voxels (the spatially sharded
steps' over slabs).
"""

from __future__ import annotations

import math

import torch

from .._device import resolve_device
from ..kernels.lcn_residual import lcn_residual
from ..ops._layout import ONE_DEVICE, OneDevice

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _over_voxels(p: torch.Tensor) -> torch.Tensor:
    """``(…, K)`` -> ``(…, 1, 1, 1, K)`` to broadcast against ``(…, D, H, W, K)``."""
    return p.reshape(tuple(p.shape[:-1]) + (1, 1, 1, p.shape[-1]))


class GMM:
    """K-component zero-mean GMM with learnable proportions and scales."""

    def __init__(self, no_components: int, s: int):
        self.no_components = int(no_components)
        self.radius = int(s)
        self.window = float((2 * self.radius + 1) ** 3)

    def init_params(self, device=None) -> dict:
        """Equal logits and unit scales on ``device`` (default: the CUDA card)."""
        K = self.no_components
        device = resolve_device(device)
        return {"logits": torch.zeros((K,), dtype=torch.float32, device=device),
                "log_std": torch.zeros((K,), dtype=torch.float32, device=device)}

    def init_scales_from_residual_std(self, params: dict, sigma) -> dict:
        """Spread component scales over ``[sigma/100, 5 sigma]`` (log-linear)."""
        sigma = torch.as_tensor(sigma, dtype=torch.float32)
        lo = torch.log(sigma / 100.0)
        hi = torch.log(sigma * 5.0)
        K = self.no_components
        ar = torch.arange(K, dtype=torch.float32, device=lo.device)
        return {**params, "log_std": lo + (hi - lo) * ar / max(K - 1, 1)}

    @staticmethod
    def log_proportions(params: dict) -> torch.Tensor:
        return torch.log_softmax(params["logits"] + 1e-2, dim=-1)

    @staticmethod
    def scales(params: dict) -> torch.Tensor:
        return torch.exp(params["log_std"])

    @staticmethod
    def proportions(params: dict) -> torch.Tensor:
        return torch.exp(GMM.log_proportions(params))

    def residual_map(self, im_fixed: torch.Tensor, im_moving: torch.Tensor) -> torch.Tensor:
        """Local-contrast-normalised residual ``lcn(f) - lcn(m)``: kernels
        L1/L2 on float32 operands on the card, the plain stencils elsewhere
        (``kernels/lcn_residual.py``); on the card ``im_fixed`` may not
        require a gradient."""
        return lcn_residual(im_fixed, im_moving, self.radius)

    def _log_w(self, params: dict) -> torch.Tensor:
        return self.log_proportions(params) - params["log_std"] - _LOG_SQRT_2PI

    def log_pdf(self, params: dict, z: torch.Tensor) -> torch.Tensor:
        """Per-voxel mixture log-density of residuals ``z (…, D, H, W)``."""
        e = 0.5 * (z[..., None] * _over_voxels(torch.exp(-params["log_std"]))) ** 2
        return torch.logsumexp(_over_voxels(self._log_w(params)) - e, dim=-1)

    def masked_nll(self, params: dict, z: torch.Tensor, mask: torch.Tensor,
                   layout: OneDevice = ONE_DEVICE) -> torch.Tensor:
        """``-Σ log p`` over the masked voxels, per leading index."""
        lp = layout.map(self.log_pdf, layout.local(params), z)
        return layout.total(-torch.sum(torch.where(mask, lp, torch.zeros_like(lp)),
                                       dim=(-3, -2, -1)))

    def rescale_residuals(self, params: dict, res: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``Σ_k z_k ∂(-log p_VD)/∂z_k`` with ``z_k = res·exp(-log_std_k)``.

        The JAX package takes the inner gradient with ``jax.grad``; here it
        is the closed form ``Σ_k γ_k z_k²`` with ``γ`` the responsibilities
        ``softmax_k(log w_k - z_k²/2)``.
        """
        res_masked = torch.where(mask, res, torch.zeros_like(res))
        z = res_masked[..., None] * _over_voxels(torch.exp(-params["log_std"]))
        gamma = torch.softmax(_over_voxels(self._log_w(params)) - 0.5 * z ** 2, dim=-1)
        return torch.sum(z * (gamma * z), dim=-1)

    @staticmethod
    def vd_factor(residual: torch.Tensor, mask: torch.Tensor,
                  layout: OneDevice = ONE_DEVICE) -> torch.Tensor:
        """Virtual-decimation factor from lag-1 residual autocorrelation."""
        res_masked = torch.where(mask, residual, torch.zeros_like(residual))
        vox = (-3, -2, -1)
        # masked voxels (per row for a per-row mask)
        return GMM.vd_factor_from_sums(layout.total(torch.sum(mask, dim=vox)),
                                       layout.total(torch.sum(res_masked ** 2, dim=vox)),
                                       *layout.lag1_sums(res_masked))

    @staticmethod
    def vd_factor_from_sums(n, sum_sq, lag_x, lag_y, lag_z) -> torch.Tensor:
        """:meth:`vd_factor` from its sums over the masked residual: the
        masked voxels ``n``, ``Σ r²`` and the lag-1 products ``Σ r_p r_{p+e}``
        along W, H and D."""
        var = sum_sq / n

        def lag1(s):
            corr = torch.clamp(s / n / var, min=1e-12)
            return torch.clamp(-2.0 / math.pi * torch.log(corr), max=1.0)

        return torch.sqrt(lag1(lag_x) * lag1(lag_y) * lag1(lag_z))

    @torch.no_grad()
    def vd_alpha(self, params: dict, res: torch.Tensor, mask: torch.Tensor,
                 layout: OneDevice = ONE_DEVICE) -> torch.Tensor:
        """Full VD pipeline on detached residuals, per leading index."""
        rescaled = layout.map(self.rescale_residuals, layout.local(params), res, mask)
        return self.vd_factor(rescaled, mask, layout)
