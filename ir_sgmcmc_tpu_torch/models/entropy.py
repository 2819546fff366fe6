"""Entropy terms of the rank-1-plus-diagonal Gaussian variational family
``q(v) = N(mu, diag(sigma²) + u uᵀ)`` (port of
``ir_sgmcmc_tpu/models/entropy.py``).

Inputs are ``(3, D, H, W)`` fields or batched ``(N, 3, D, H, W)``;
reductions run over the channel and spatial axes, one value per batch
element.
"""

from __future__ import annotations

import torch

from ..ops._layout import ONE_DEVICE, OneDevice


def _reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum over channel+spatial axes, keeping an optional leading batch."""
    if x.ndim == 4:
        return torch.sum(x)
    return torch.sum(x, dim=tuple(range(x.ndim - 4, x.ndim)))


def entropy_analytic(log_var: torch.Tensor, u: torch.Tensor,
                     layout: OneDevice = ONE_DEVICE) -> torch.Tensor:
    """``0.5 (log1p ||u/sigma||² + Σ log sigma²)``, the entropy up to
    constants (matrix determinant lemma for the rank-1 term)."""
    sigma = torch.exp(0.5 * log_var)
    un2, log_var_sum = layout.total(_reduce((u / sigma) ** 2)), layout.total(_reduce(log_var))
    return 0.5 * (torch.log1p(un2) + log_var_sum)


def entropy_sample(sample: torch.Tensor, mu: torch.Tensor, log_var: torch.Tensor,
                   u: torch.Tensor, layout: OneDevice = ONE_DEVICE) -> torch.Tensor:
    """Sample-based quadratic term ``0.5 (v-mu)ᵀ Σ⁻¹ (v-mu)`` by
    Sherman-Morrison, with ``sn = (v-mu)/σ``, ``un = u/σ``."""
    sigma = torch.exp(0.5 * log_var)
    sn = (sample - mu) / sigma
    un = u / sigma
    sn2, snun, un2 = (layout.total(_reduce(sn ** 2)), layout.total(_reduce(sn * un)),
                      layout.total(_reduce(un ** 2)))
    return 0.5 * (sn2 - snun ** 2 / (1.0 + un2))
