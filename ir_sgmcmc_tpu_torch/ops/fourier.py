"""Frequency-domain operators (port of ``ir_sgmcmc_tpu/ops/fourier.py``):
the isotropic first-derivative magnitude ``|ω|`` and a Gaussian blur, both
as multipliers on the 3D FFT (``torch.fft``) of the trailing three axes."""

from __future__ import annotations

import math

import torch


def _omega_norm(shape, device) -> torch.Tensor:
    """``|ω|`` over the full 3D FFT grid of ``shape`` (angular frequency)."""
    ws = [torch.fft.fftfreq(s, device=device) * (2.0 * math.pi) for s in shape]
    wz, wy, wx = torch.meshgrid(*ws, indexing="ij")
    return torch.sqrt(wx ** 2 + wy ** 2 + wz ** 2).to(torch.float32)


def _apply_multiplier(field: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    f = torch.fft.fftn(field, dim=(-3, -2, -1))
    return torch.fft.ifftn(f * mult, dim=(-3, -2, -1)).real.to(field.dtype)


def fourier_derivative_magnitude(field: torch.Tensor) -> torch.Tensor:
    """``F⁻¹(|ω| · F(field))`` over the trailing three (spatial) axes."""
    return _apply_multiplier(field, _omega_norm(field.shape[-3:], field.device))


def gaussian_smooth_fft(field: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian blur as the spectrum multiplier ``exp(-σ²|ω|²/2)``: an exact
    periodic Gaussian blur."""
    w2 = _omega_norm(field.shape[-3:], field.device) ** 2
    return _apply_multiplier(field, torch.exp(-0.5 * (sigma ** 2) * w2))


class GaussianGradSmooth(torch.autograd.Function):
    """:func:`gaussian_smooth_fft` forward, identity backward (the FFT
    analogue of the Sobolev-gradient trick)."""

    @staticmethod
    def forward(ctx, field, sigma):
        return gaussian_smooth_fft(field, sigma)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gaussian_grad_smooth(field: torch.Tensor, sigma: float) -> torch.Tensor:
    return GaussianGradSmooth.apply(field, float(sigma))
