"""Distributions and hyperpriors (port of
``ir_sgmcmc_tpu/models/distributions.py``): pure log-pdf callables over
float32 tensors."""

from __future__ import annotations

import math

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _f32(x, like: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` as float32 on ``like``'s device; a Python number is filled in
    there (no host-to-device copy, which would wait for the device)."""
    device = like.device if isinstance(like, torch.Tensor) else None
    if isinstance(x, (int, float)):
        return torch.full((), float(x), dtype=torch.float32, device=device)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def normal_log_pdf(x, loc, log_scale):
    """log N(x | loc, exp(log_scale)²)."""
    e = 0.5 * ((x - loc) * torch.exp(-_f32(log_scale, x))) ** 2
    return -e - log_scale - _LOG_SQRT_2PI


def gamma_log_pdf(log_x, shape, rate):
    """log Gamma(x | shape, rate) at x = exp(log_x), in float32 like the JAX
    version (the constants are float32 tensors, not doubles)."""
    shape = _f32(shape, log_x)
    rate = _f32(rate, log_x)
    return (shape * torch.log(rate) + (shape - 1.0) * log_x
            - rate * torch.exp(log_x) - torch.lgamma(shape))


def expgamma_log_pdf(x, shape, rate):
    """log pdf of X = log Z, Z ~ Gamma(shape, rate)."""
    return gamma_log_pdf(x, shape, rate) + x


def expgamma_expectation(shape, rate) -> torch.Tensor:
    """E[log Z] for Z ~ Gamma(shape, rate)."""
    return torch.digamma(_f32(shape)) - torch.log(_f32(rate))


def exp_inverse_gamma_log_pdf(x, shape, rate):
    """log pdf of X = log Z, Z ~ InverseGamma(shape, rate)."""
    return gamma_log_pdf(-x, shape, rate) - 2.0 * x + x


class NormalDistribution:
    """Univariate normal with fixed loc/scale."""

    def __init__(self, loc=None, scale=None, learnable=False):
        self.loc = float(loc if loc is not None else 0.0)
        self.log_scale = math.log(float(scale if scale is not None else math.log(10.0)))

    def __call__(self, x):
        return normal_log_pdf(x, self.loc, self.log_scale)


class DirichletPrior:
    """Dirichlet prior over mixture log-proportions ``(…, K)``."""

    def __init__(self, no_classes, alpha=None):
        a = 0.5 if alpha is None else alpha
        conc = torch.as_tensor(a, dtype=torch.float32).reshape(-1)
        if conc.numel() == 1:
            conc = conc.expand(no_classes).clone()
        if conc.shape[0] != no_classes:
            raise ValueError(f"alpha has {conc.shape[0]} entries, expected {no_classes}")
        self.concentration = conc
        self._on_device = {}  # a copy per device: no host copy per call

    def __call__(self, log_proportions):
        dev = log_proportions.device
        if dev not in self._on_device:
            self._on_device[dev] = self.concentration.to(dev)
        c = self._on_device[dev]
        return (torch.sum(log_proportions * (c - 1.0), dim=-1)
                + torch.lgamma(torch.sum(c, dim=-1))
                - torch.sum(torch.lgamma(c), dim=-1))


class LogScaleNormalPrior:
    """Normal prior on a log-scale parameter."""

    def __init__(self, loc, scale, learnable=False):
        self.loc = float(loc)
        self.log_scale = math.log(float(scale))

    def __call__(self, log_scale):
        return normal_log_pdf(log_scale, self.loc, self.log_scale)


class LogPrecisionExpGammaPrior:
    """ExpGamma prior on ``log w_reg`` (a Gamma prior on ``w_reg``)."""

    def __init__(self, shape=1e-3, rate=1e-3, **_):
        self.shape = float(shape)
        self.rate = float(rate)

    def __call__(self, log_w_reg):
        return expgamma_log_pdf(log_w_reg, self.shape, self.rate)


class LogEnergyExpGammaPrior:
    """ExpGamma(ν·dof/2, ν·w_reg/2) prior over a log-energy."""

    def __init__(self, w_reg, dof, nu=1.0, learnable=False):
        self.w_reg = float(w_reg)
        self.dof = float(dof)
        self.nu = float(nu)

    def expectation(self):
        return expgamma_expectation(0.5 * self.nu * self.dof, 0.5 * self.nu * self.w_reg)

    def __call__(self, log_energy):
        return expgamma_log_pdf(log_energy, 0.5 * self.nu * self.dof,
                                0.5 * self.nu * self.w_reg)


_REGISTRY = {
    "NormalDistribution": NormalDistribution,
    "DirichletPrior": DirichletPrior,
    "LogScaleNormalPrior": LogScaleNormalPrior,
    "LogPrecisionExpGammaPrior": LogPrecisionExpGammaPrior,
    "LogEnergyExpGammaPrior": LogEnergyExpGammaPrior,
}


def make_distribution(kind: str, **kwargs):
    """Config-layer factory (type names as in the reference's configs)."""
    if kind not in _REGISTRY:
        raise ValueError(f"unknown distribution: {kind}")
    return _REGISTRY[kind](**kwargs)
