"""Split-composition kernels B1 (forward) and B2 (backward), with their
plain PyTorch versions.

CUDA source: ``csrc/split_warp.cu``.  Replaces the Pallas kernels
``ir_sgmcmc_tpu/ops/pallas_split_warp.py::split_warp_pallas`` (B1) and
``::split_warp_bwd_pallas`` (B2).

A CPU tensor takes the plain version; a CUDA tensor takes the kernel, and a
launch or build failure raises — there is no fallback between the two.
"""

from __future__ import annotations

import torch

from ..ops.stencil import _split_compose_impl
from ._lib import Kernel, check_operand, ptr

# Work per voxel at C channels of d: B1 reads d and u and writes d'; each
# channel is three lerps (6 flops each) plus the +u.  B2 reads d, u, g and
# writes gd, gu; each channel is three transposes (6), the A and B stages
# (12), three offset differences and three accumulations (9).
B1 = Kernel("split_warp_fwd", "ir_sgmcmc_tpu_torch/csrc/split_warp.cu",
            "ir_sgmcmc_tpu/ops/pallas_split_warp.py:373",
            bytes_per_voxel=lambda C: 4 * (2 * C + 3), flops_per_voxel=lambda C: 19 * C)
B2 = Kernel("split_warp_bwd", "ir_sgmcmc_tpu_torch/csrc/split_warp.cu",
            "ir_sgmcmc_tpu/ops/pallas_split_warp.py:436",
            bytes_per_voxel=lambda C: 4 * (3 * C + 6), flops_per_voxel=lambda C: 39 * C)


# ---- plain versions ------------------------------------------------------------

def split_compose_plain(d: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``u + L_z(L_y(L_x(d; ũx); ũy); ũz)``, ``ũ = clip(u, ±1)``."""
    return _split_compose_impl(d, u)


def split_compose_vjp_plain(d: torch.Tensor, u: torch.Tensor, g: torch.Tensor):
    """``(ḡ_d, ḡ_u)`` of the plain step by autograd (includes the ``+g`` of
    the direct ``+u`` term), as the JAX package's XLA path takes them."""
    with torch.enable_grad():
        d_ = d.detach().requires_grad_(True)
        u_ = u.detach().requires_grad_(True)
        gd, gu = torch.autograd.grad(_split_compose_impl(d_, u_), (d_, u_), g)
    return gd, gu


# ---- CUDA wrappers -------------------------------------------------------------

def _check(d: torch.Tensor, u: torch.Tensor):
    if d.ndim != 5:
        raise ValueError(f"d: expected (B, C, D, H, W), got {tuple(d.shape)}")
    B, C, D, H, W = d.shape
    if C != 3:
        raise ValueError(f"d: the composition step adds u, so C must be 3, got {C}")
    check_operand("d", d, (B, C, D, H, W))
    check_operand("u", u, (B, 3, D, H, W), device=d.device)
    return B, C, D, H, W


def split_warp_fwd_cuda(d: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """B1: the composition step ``u + L_z L_y L_x d`` on the card."""
    B, C, D, H, W = _check(d, u)
    out = torch.empty_like(d)
    B1.launch(d.device, ptr(d), ptr(u), ptr(out), B, C, D, H, W)
    return out


def split_warp_bwd_cuda(d: torch.Tensor, u: torch.Tensor, g: torch.Tensor):
    """B2: ``(ḡ_d, ū_warp)`` — the warp part's cotangents, without the
    ``+g`` of the direct ``+u`` term (the caller adds it)."""
    B, C, D, H, W = _check(d, u)
    check_operand("g", g, (B, C, D, H, W), device=d.device)
    gd = torch.empty_like(d)
    gu = torch.empty_like(u)
    B2.launch(d.device, ptr(d), ptr(u), ptr(g), ptr(gd), ptr(gu), B, C, D, H, W)
    return gd, gu


# ---- dispatch ------------------------------------------------------------------

def split_compose(d: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    if d.is_cuda:
        return split_warp_fwd_cuda(d, u)
    return split_compose_plain(d, u)


def split_compose_vjp(d: torch.Tensor, u: torch.Tensor, g: torch.Tensor):
    if d.is_cuda:
        gd, gu = split_warp_bwd_cuda(d, u, g)
        return gd, gu + g
    return split_compose_vjp_plain(d, u, g)
