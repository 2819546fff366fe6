"""Sobolev gradient smoothing (port of ``ir_sgmcmc_tpu/ops/sobolev.py``).

The kernel is the middle row of ``(I - λL)^{-1}`` for a 1D finite-difference
Laplacian ``L`` of size ``2s+1``; smoothing runs as three separable passes
with an identity backward (the Sobolev-gradient trick).
"""

from __future__ import annotations

import numpy as np
import torch

from .stencil import separable_conv3d


def sobolev_kernel_1d(s: int, lam: float) -> tuple[np.ndarray, np.ndarray]:
    """1D Sobolev kernel and its square root, each normalised to sum 1."""
    n = 2 * s + 1
    L = np.zeros((n, n))
    idx = np.arange(n)
    L[idx, idx] = -2.0
    L[idx[:-1], idx[:-1] + 1] = 1.0
    L[idx[1:], idx[1:] - 1] = 1.0

    w, v = np.linalg.eigh(L)
    w = 1.0 - lam * w
    inv_sqrt_w = np.where(np.abs(w) > 1e-10, 1.0 / np.sqrt(np.abs(w)), 0.0)
    half = v * inv_sqrt_w  # V diag(w^-1/2)
    kernel = half @ half[s]  # middle row of (I - λL)^{-1}
    kernel_sqrt = half @ v[s]  # middle row of (I - λL)^{-1/2}
    return kernel / kernel.sum(), kernel_sqrt / kernel_sqrt.sum()


class SobolevSmooth(torch.autograd.Function):
    """Separable smoothing forward, identity backward."""

    @staticmethod
    def forward(ctx, field, kernel):
        return separable_conv3d(field, kernel)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sobolev_smooth(field: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    return SobolevSmooth.apply(field, kernel)
