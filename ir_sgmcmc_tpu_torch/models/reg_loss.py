"""Regularisation losses over the field-gradient energy ``y = Σ ||∇v||²``
(port of ``ir_sgmcmc_tpu/models/reg_loss.py``; the slice runs
``RegLossLogNormal``, and the other three variants come along).

Each loss returns ``(loss, log_y)`` per leading (chain) index.  The
energy's difference operator is ``"GradientOperator"`` (forward
differences), ``"Fourier1stDerivativeOperator"`` (``y = Σ ‖ |ω| v̂ ‖²``
through ``torch.fft``) or the identity.
"""

from __future__ import annotations

import math

import torch

from .._device import resolve_device
from ..ops.fourier import fourier_derivative_magnitude
from ..ops.stencil import reg_energy
from .distributions import expgamma_expectation, gamma_log_pdf


class RegLoss:
    """Base: energy computation + dof bookkeeping."""

    learnable = False
    param_names: tuple = ()

    def __init__(self, diff_op="GradientOperator", dims=None, learnable=False):
        if diff_op not in (None, "Identity", "GradientOperator",
                           "Fourier1stDerivativeOperator"):
            raise ValueError(f"unsupported diff_op: {diff_op}")
        self.diff_op = diff_op or "Identity"
        self.dims = tuple(dims) if dims is not None else None
        self.dof = float(3.0 * math.prod(self.dims)) if dims is not None else None
        self.learnable = bool(learnable)

    def energy(self, v: torch.Tensor) -> torch.Tensor:
        if self.diff_op == "GradientOperator":
            return reg_energy(v)
        if self.diff_op == "Fourier1stDerivativeOperator":
            v = fourier_derivative_magnitude(v)
        if v.ndim == 4:
            return torch.sum(v * v)
        return torch.sum(v * v, dim=tuple(range(1, v.ndim)))

    def init_params(self, device=None) -> dict:
        """Learnable parameters on ``device`` (default: the CUDA card)."""
        resolve_device(device)
        return {}

    def __call__(self, params: dict, v: torch.Tensor):
        return self._loss(params, self.energy(v))

    def _loss(self, params, y):
        raise NotImplementedError


class RegLossL2(RegLoss):
    """``0.5 w_reg y - 0.5 dof log w_reg`` with learnable ``log_w_reg``."""

    param_names = ("log_w_reg",)

    def __init__(self, w_reg, diff_op="GradientOperator", dims=None, learnable=False):
        super().__init__(diff_op, dims, learnable)
        self.w_reg = float(w_reg)

    def init_params(self, device=None):
        return {"log_w_reg": torch.tensor(math.log(self.w_reg), dtype=torch.float32,
                                          device=resolve_device(device))}

    def _loss(self, params, y):
        lw = params["log_w_reg"]
        return 0.5 * torch.exp(lw) * y - 0.5 * self.dof * lw, torch.log(y)


class RegLossStudent(RegLoss):
    """Student-t marginal of a Gamma precision prior on the field."""

    def __init__(self, diff_op="GradientOperator", dims=None, nu0=2e-6, lambda0=1e-6,
                 a0=1e-6, b0=1e-6):
        super().__init__(diff_op, dims, learnable=False)
        self.a0 = nu0 / 2.0 if nu0 != 2e-6 else a0
        if lambda0 != 1e-6:
            b0 = self.a0 / lambda0
        self.b0_twice = 2.0 * b0

    def _loss(self, params, y):
        return torch.log(self.b0_twice + y) * (self.a0 + 0.5 * self.dof), torch.log(y)


class RegLossEnergyBased(RegLoss):
    """Prior on the scalar energy, as a prior on the field:
    ``loss = -log p(y) + (dof/2 - 1) log y``."""

    def _mlog_energy_prior(self, params, y):
        raise NotImplementedError

    def _loss(self, params, y):
        log_y = torch.log(y)
        return self._mlog_energy_prior(params, y) + (0.5 * self.dof - 1.0) * log_y, log_y


class RegLossLogNormal(RegLossEnergyBased):
    """Log-normal prior on the energy with learnable ``(loc, log_scale)``."""

    param_names = ("loc", "log_scale")

    def __init__(self, w_reg=1.0, diff_op="GradientOperator", dims=None, learnable=False):
        super().__init__(diff_op, dims, learnable)
        self.w_reg = float(w_reg)

    def init_params(self, device=None):
        loc0 = expgamma_expectation(0.5 * self.dof, 0.5 * self.w_reg)
        device = resolve_device(device)
        return {"loc": loc0.to(device),
                "log_scale": (math.log(4.0) + torch.log(loc0)).to(device)}

    def _mlog_energy_prior(self, params, y):
        log_y = torch.log(y)
        scale = torch.exp(params["log_scale"])
        return log_y + params["log_scale"] + 0.5 * ((log_y - params["loc"]) / scale) ** 2


class RegLossLogNormalL2(RegLossEnergyBased):
    """Gamma(dof/2, w_reg/2) prior on the energy."""

    def __init__(self, w_reg, diff_op="GradientOperator", dims=None):
        super().__init__(diff_op, dims, learnable=False)
        self.w_reg = float(w_reg)

    def _mlog_energy_prior(self, params, y):
        return -gamma_log_pdf(torch.log(y), 0.5 * self.dof, 0.5 * self.w_reg)


_REGISTRY = {
    # reference config type names
    "RegLoss_L2": RegLossL2,
    "RegLoss_Student": RegLossStudent,
    "RegLoss_LogNormal": RegLossLogNormal,
    "RegLoss_LogNormal_L2": RegLossLogNormalL2,
    # native names
    "RegLossL2": RegLossL2,
    "RegLossStudent": RegLossStudent,
    "RegLossLogNormal": RegLossLogNormal,
    "RegLossLogNormalL2": RegLossLogNormalL2,
}


def make_reg_loss(kind: str, **kwargs) -> RegLoss:
    """Config-layer factory (type names as in the reference's configs)."""
    if kind not in _REGISTRY:
        raise ValueError(f"unknown reg loss: {kind}")
    return _REGISTRY[kind](**kwargs)
