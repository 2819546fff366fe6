"""Taylor squaring kernels T1 (forward) and T2 (backward), and the dispatch
between them and their plain versions.

CUDA source: ``csrc/taylor_square.cu``.  They replace the plain stencils of
``ops/stencil.py``'s ``TaylorSquaringStep`` (``_taylor_squaring_impl`` and
``_taylor_squaring_vjp_impl``, which stay as the oracles) for float32
fields on the card: one kernel each way in place of about 80 elementwise,
copy and reduction launches.  The JAX package has no Pallas kernel for this
step; XLA fuses its stencils (``ir_sgmcmc_tpu/ops/stencil.py:124``).

T1 rounds each difference, product and sum on its own in the plain
version's order, so it equals ``_taylor_squaring_impl`` bit for bit.  T2
keeps the plain VJP's order too (``_taylor_squaring_vjp_impl``), summing the
channel term ``Σ_i g_i (D_a d)_i`` as ``(t0 + t1) + t2``: on the card it
matched the plain VJP bit for bit, whose channel sum is torch's reduction.

Fields are ``(…, 3, D, H, W)`` with any leading axes (flattened into one
batch axis for the launch) and ``D, H, W >= 2``.  A CPU or bfloat16 tensor
takes the plain versions; a float32 CUDA tensor takes the kernels, and a
launch or build failure raises — there is no fallback between the two.
"""

from __future__ import annotations

import torch

from ..ops.stencil import _taylor_squaring_impl, _taylor_squaring_vjp_impl
from ._lib import Kernel, ptr

# Work per voxel of the (B, 3, D, H, W) field.  T1 reads d and writes d';
# per axis 3 differences, 3 products and 3 sums, and the doubling: 10 per
# channel.  T2 reads d and g and writes ḡ; per axis 3 differences, 3
# products and 2 sums for the channel term and its add, then per channel
# the product g·d_a, its difference with the neighbour's, and the add: 18
# per axis, 3 for 2g: 19 per channel.
T1 = Kernel("taylor_square_fwd", "ir_sgmcmc_tpu_torch/csrc/taylor_square.cu",
            "ir_sgmcmc_tpu/ops/stencil.py:124",
            bytes_per_voxel=lambda C: 4 * 2 * C, flops_per_voxel=lambda C: 10 * C)
T2 = Kernel("taylor_square_bwd", "ir_sgmcmc_tpu_torch/csrc/taylor_square.cu",
            "ir_sgmcmc_tpu/ops/stencil.py:124",
            bytes_per_voxel=lambda C: 4 * 3 * C, flops_per_voxel=lambda C: 19 * C)


# ---- CUDA wrappers -------------------------------------------------------------

def _geometry(name: str, t: torch.Tensor) -> tuple:
    """``(N, D, H, W)`` of a float32 CUDA field ``(…, 3, D, H, W)``."""
    if t.ndim < 4 or t.shape[-4] != 3:
        raise ValueError(f"{name}: expected (…, 3, D, H, W), got {tuple(t.shape)}")
    D, H, W = t.shape[-3:]
    if min(D, H, W) < 2:
        raise ValueError(f"{name}: D, H and W must be at least 2, got {(D, H, W)}")
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: dtype {t.dtype}, expected torch.float32")
    return t.numel() // (3 * D * H * W), D, H, W


def taylor_square_fwd_cuda(d: torch.Tensor) -> torch.Tensor:
    """T1: ``2d + (d·∇)d`` of a float32 field on the card."""
    d = d.contiguous()
    N, D, H, W = _geometry("d", d)
    out = torch.empty_like(d)
    T1.launch(d.device, ptr(d), ptr(out), N, D, H, W)
    return out


def taylor_square_bwd_cuda(d: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """T2: the VJP ``ḡ`` of T1 at ``d`` for the cotangent ``g``."""
    d, g = d.contiguous(), g.contiguous()
    N, D, H, W = _geometry("d", d)
    if g.shape != d.shape or g.dtype != d.dtype or g.device != d.device:
        raise ValueError(f"g: {tuple(g.shape)} {g.dtype} on {g.device}, expected d's "
                         f"{tuple(d.shape)} {d.dtype} on {d.device}")
    gd = torch.empty_like(d)
    T2.launch(d.device, ptr(d), ptr(g), ptr(gd), N, D, H, W)
    return gd


# ---- dispatch ------------------------------------------------------------------

def _on_kernels(d: torch.Tensor) -> bool:
    # bfloat16 fields keep the plain stencils on the card too
    return d.is_cuda and d.dtype == torch.float32


def taylor_square(d: torch.Tensor) -> torch.Tensor:
    if _on_kernels(d):
        return taylor_square_fwd_cuda(d)
    return _taylor_squaring_impl(d)


def taylor_square_vjp(d: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    if _on_kernels(d):
        return taylor_square_bwd_cuda(d, g)
    return _taylor_squaring_vjp_impl(d, g)
