"""Samplers: SGLD noise and uniform field noise (port of
``ir_sgmcmc_tpu/models/sampler.py``).  Randomness comes from explicit
``torch.Generator``s; tests inject the JAX draws instead."""

from __future__ import annotations

import math

import torch

from .._device import resolve_device


def langevin_noise(generator: torch.Generator, sigma: torch.Tensor, tau: float,
                   eps: torch.Tensor | None = None) -> torch.Tensor:
    """``sqrt(2 tau) * sigma * eps`` with ``eps ~ N(0, 1)`` (or the given one)."""
    if eps is None:
        eps = torch.randn(sigma.shape, generator=generator, dtype=sigma.dtype,
                          device=sigma.device)
    return math.sqrt(2.0) * math.sqrt(tau) * sigma * eps


def uniform_voxel_noise(generator: torch.Generator, shape, alpha: float,
                        device=None) -> torch.Tensor:
    """``U(-alpha, alpha)`` noise in voxel units, on ``device`` (default: the
    generator's, else the CUDA card)."""
    if device is None and generator is not None:
        device = generator.device
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=resolve_device(device))
    return u * (2.0 * alpha) - alpha


def sample_q_v(generator: torch.Generator, q_v: dict, antithetic: bool = False,
               eps: torch.Tensor | None = None, x: torch.Tensor | None = None):
    """Draw from ``q(v) = N(mu, diag(sigma²) + u uᵀ)``: ``mu + eps·sigma +
    x·u`` with ``eps ~ N(0, I)`` over the field and ONE scalar ``x ~ N(0, 1)``
    (the rank-1 direction).  ``eps`` and ``x`` are drawn from ``generator``
    (in that order) unless given.  With ``antithetic=True``, returns the pair
    ``(mu + delta, mu - delta)``."""
    sigma = torch.exp(0.5 * q_v["log_var"])
    if eps is None:
        eps = torch.randn(sigma.shape, generator=generator, dtype=sigma.dtype,
                          device=sigma.device)
    if x is None:
        x = torch.randn((), generator=generator, dtype=sigma.dtype, device=sigma.device)
    delta = eps * sigma + x * q_v["u"]
    if antithetic:
        return q_v["mu"] + delta, q_v["mu"] - delta
    return q_v["mu"] + delta
