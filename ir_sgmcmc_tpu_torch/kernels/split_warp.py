"""Split-composition kernels B1 (forward) and B2 (backward), with their
plain PyTorch versions, in float32 and in bfloat16.

CUDA source: ``csrc/split_warp.cu``.  Replaces the Pallas kernels
``ir_sgmcmc_tpu/ops/pallas_split_warp.py::split_warp_pallas`` (B1) and
``::split_warp_bwd_pallas`` (B2), in both of their operand dtypes: f32, and
bf16 (``SVF3D``'s ``compute_dtype: "bfloat16"``), where every operand and
output is bf16 in memory, all arithmetic is f32 on widened values, and each
output is rounded once.

B1 and B2 have a z-halo mode (B1Z, B2Z), for a z-slab of a field cut along
D over several shards (``parallel/halo.py::split_compose_sharded``): ``d_h``
and ``u_h`` are ``(B, 3, D + 2, H, W)``, the slab's D planes and one
neighbour plane on each side (at the volume's two ends the edge plane
repeated, which is the border replication of one device).  B1Z writes the
composition step of the D interior planes, reading z±1 from the halo and
never clamping z; B2Z is its VJP, ``(ḡ_d, ū)`` on all ``D + 2`` planes with
the halo planes' shares left unfolded, for the caller's halo exchange to
send to the shards that own them (or, at the two ends, to fold onto the
edge plane).  They are B1's and B2's kernels under a template flag, in both
operand dtypes: B1Z/B2Z in f32, B1Z-bf16/B2Z-bf16 with the bf16 modes'
storage and arithmetic.

A CPU tensor takes the plain version; a CUDA tensor takes the kernel, and a
launch or build failure raises — there is no fallback between the two.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.stencil import _clip_offsets, _split_compose_impl, _split_warp_impl
from ._lib import Kernel, check_operand, ptr

# Work per voxel at C channels of d: B1 reads d and u and writes d'; each
# channel is three lerps (6 flops each) plus the +u.  B2 reads d, u, g and
# writes gd, gu; each channel is three transposes (6), the A and B stages
# (12), three offset differences and three accumulations (9).  The bf16
# kernels do the same f32 arithmetic on 2-byte words.
B1 = Kernel("split_warp_fwd", "ir_sgmcmc_tpu_torch/csrc/split_warp.cu",
            "ir_sgmcmc_tpu/ops/pallas_split_warp.py:373",
            bytes_per_voxel=lambda C: 4 * (2 * C + 3), flops_per_voxel=lambda C: 19 * C)
B2 = Kernel("split_warp_bwd", "ir_sgmcmc_tpu_torch/csrc/split_warp.cu",
            "ir_sgmcmc_tpu/ops/pallas_split_warp.py:436",
            bytes_per_voxel=lambda C: 4 * (3 * C + 6), flops_per_voxel=lambda C: 39 * C)
B1_BF16 = Kernel("split_warp_fwd_bf16", "ir_sgmcmc_tpu_torch/csrc/split_warp.cu",
                 "ir_sgmcmc_tpu/ops/pallas_split_warp.py:373",
                 bytes_per_voxel=lambda C: 2 * (2 * C + 3), flops_per_voxel=lambda C: 19 * C)
B2_BF16 = Kernel("split_warp_bwd_bf16", "ir_sgmcmc_tpu_torch/csrc/split_warp.cu",
                 "ir_sgmcmc_tpu/ops/pallas_split_warp.py:436",
                 bytes_per_voxel=lambda C: 2 * (3 * C + 6), flops_per_voxel=lambda C: 39 * C)

# z-halo modes: the same work per output voxel; B1Z also reads the two halo
# planes of d and u, and B2Z reads them and writes its two gradients there
B1Z = Kernel("split_warp_fwd_zhalo", "ir_sgmcmc_tpu_torch/csrc/split_warp.cu",
             "ir_sgmcmc_tpu/ops/pallas_split_warp.py:373", bytes_per_voxel=B1.bytes_per_voxel,
             flops_per_voxel=B1.flops_per_voxel, z_halo=lambda C: 4 * (C + 3))
B2Z = Kernel("split_warp_bwd_zhalo", "ir_sgmcmc_tpu_torch/csrc/split_warp.cu",
             "ir_sgmcmc_tpu/ops/pallas_split_warp.py:436", bytes_per_voxel=B2.bytes_per_voxel,
             flops_per_voxel=B2.flops_per_voxel, z_halo=lambda C: 8 * (C + 3))

B1Z_BF16 = Kernel("split_warp_fwd_zhalo_bf16", "ir_sgmcmc_tpu_torch/csrc/split_warp.cu",
                  "ir_sgmcmc_tpu/ops/pallas_split_warp.py:373",
                  bytes_per_voxel=B1_BF16.bytes_per_voxel,
                  flops_per_voxel=B1_BF16.flops_per_voxel, z_halo=lambda C: 2 * (C + 3))
B2Z_BF16 = Kernel("split_warp_bwd_zhalo_bf16", "ir_sgmcmc_tpu_torch/csrc/split_warp.cu",
                  "ir_sgmcmc_tpu/ops/pallas_split_warp.py:436",
                  bytes_per_voxel=B2_BF16.bytes_per_voxel,
                  flops_per_voxel=B2_BF16.flops_per_voxel, z_halo=lambda C: 4 * (C + 3))

# operand dtype -> (forward kernel, backward kernel), default and z-halo modes
_KERNELS = {torch.float32: (B1, B2), torch.bfloat16: (B1_BF16, B2_BF16)}
_ZHALO_KERNELS = {torch.float32: (B1Z, B2Z), torch.bfloat16: (B1Z_BF16, B2Z_BF16)}


# ---- plain versions ------------------------------------------------------------

def split_compose_plain(d: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``u + L_z(L_y(L_x(d; ũx); ũy); ũz)``, ``ũ = clip(u, ±1)``, computed
    in f32 and rounded once to the operands' dtype, as B1 does."""
    return _split_compose_impl(d.float(), u.float()).to(d.dtype)


def split_warp_vjp_plain(d: torch.Tensor, u: torch.Tensor, g: torch.Tensor):
    """B2's own outputs ``(ḡ_d, ū_warp)``: the f32 VJP of the warp part
    ``L_z L_y L_x d`` (without the ``+g`` of the direct ``+u`` term), each
    rounded once to the operands' dtype."""
    with torch.enable_grad():
        d_ = d.detach().float().requires_grad_(True)
        u_ = u.detach().float().requires_grad_(True)
        out = _split_warp_impl(d_, _clip_offsets(u_))
        gd, gu = torch.autograd.grad(out, (d_, u_), g.float())
    return gd.to(d.dtype), gu.to(d.dtype)


def split_compose_vjp_plain(d: torch.Tensor, u: torch.Tensor, g: torch.Tensor):
    """``(ḡ_d, ḡ_u)`` of the plain step: :func:`split_warp_vjp_plain` with
    the ``+g`` of the direct ``+u`` term added in the operands' dtype, as
    the JAX wrapper adds it to the Pallas kernel's ``ū``
    (``ir_sgmcmc_tpu/ops/stencil.py:322``)."""
    gd, gu = split_warp_vjp_plain(d, u, g)
    return gd, gu + g


def split_compose_zhalo_plain(d_h: torch.Tensor, u_h: torch.Tensor) -> torch.Tensor:
    """B1Z's function: :func:`split_compose_plain` on the haloed slab, its
    interior planes kept (bf16 operands: computed in f32, rounded once)."""
    return split_compose_plain(d_h, u_h)[:, :, 1:-1]


def split_warp_vjp_zhalo_plain(d_h: torch.Tensor, u_h: torch.Tensor, g: torch.Tensor):
    """B2Z's own outputs: the VJP of the warp part of B1Z's function,
    ``(ḡ_d, ū_warp)`` on the haloed slab (the halo planes' shares
    unfolded).  It is :func:`split_warp_vjp_plain` with ``g`` zero on the
    two halo planes, where the forward writes no output (bf16 operands:
    computed in f32, each output rounded once)."""
    return split_warp_vjp_plain(d_h, u_h, F.pad(g, (0, 0, 0, 0, 1, 1)))


def split_compose_zhalo_vjp_plain(d_h: torch.Tensor, u_h: torch.Tensor, g: torch.Tensor):
    """``(ḡ_d, ḡ_u)`` of B1Z's function: :func:`split_warp_vjp_zhalo_plain`
    with the ``+g`` of the direct ``+u`` term on the interior planes."""
    gd, gu = split_warp_vjp_zhalo_plain(d_h, u_h, g)
    return gd, gu + F.pad(g, (0, 0, 0, 0, 1, 1))


# ---- CUDA wrappers -------------------------------------------------------------

def _check(d: torch.Tensor, u: torch.Tensor):
    """Shape ``(B, 3, D, H, W)`` and the kernels of ``d``'s dtype (f32 or
    bf16); ``u`` must match it in everything but channels."""
    if d.ndim != 5:
        raise ValueError(f"d: expected (B, C, D, H, W), got {tuple(d.shape)}")
    B, C, D, H, W = d.shape
    if C != 3:
        raise ValueError(f"d: the composition step adds u, so C must be 3, got {C}")
    if d.dtype not in _KERNELS:
        raise ValueError(f"d: dtype {d.dtype}, expected torch.float32 or torch.bfloat16")
    check_operand("d", d, (B, C, D, H, W), d.dtype)
    check_operand("u", u, (B, 3, D, H, W), d.dtype, device=d.device)
    return (B, C, D, H, W), _KERNELS[d.dtype]


def split_warp_fwd_cuda(d: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """B1 (f32) or B1-bf16: the composition step ``u + L_z L_y L_x d`` on
    the card, in ``d``'s dtype."""
    (B, C, D, H, W), (fwd, _) = _check(d, u)
    out = torch.empty_like(d)
    fwd.launch(d.device, ptr(d), ptr(u), ptr(out), B, C, D, H, W)
    return out


def split_warp_bwd_cuda(d: torch.Tensor, u: torch.Tensor, g: torch.Tensor):
    """B2 (f32) or B2-bf16: ``(ḡ_d, ū_warp)`` — the warp part's cotangents,
    without the ``+g`` of the direct ``+u`` term (the caller adds it)."""
    (B, C, D, H, W), (_, bwd) = _check(d, u)
    check_operand("g", g, (B, C, D, H, W), d.dtype, device=d.device)
    gd = torch.empty_like(d)
    gu = torch.empty_like(u)
    bwd.launch(d.device, ptr(d), ptr(u), ptr(g), ptr(gd), ptr(gu), B, C, D, H, W)
    return gd, gu


def _check_zhalo(d_h: torch.Tensor, u_h: torch.Tensor):
    """The haloed operands' shape ``(B, 3, D + 2, H, W)`` and the z-halo
    kernels of their dtype (f32 or bf16)."""
    (B, C, Dh, H, W), _ = _check(d_h, u_h)
    if Dh < 3:
        raise ValueError(f"d_h: a haloed slab has at least 3 planes, got {Dh}")
    return (B, C, Dh - 2, H, W), _ZHALO_KERNELS[d_h.dtype]


def split_warp_fwd_zhalo_cuda(d_h: torch.Tensor, u_h: torch.Tensor) -> torch.Tensor:
    """B1Z (f32) or B1Z-bf16 on the card: the composition step of the
    slab's interior planes, ``(B, 3, D, H, W)`` from operands of ``D + 2``
    planes, in ``d_h``'s dtype."""
    (B, C, D, H, W), (fwd, _) = _check_zhalo(d_h, u_h)
    out = torch.empty((B, C, D, H, W), dtype=d_h.dtype, device=d_h.device)
    fwd.launch(d_h.device, ptr(d_h), ptr(u_h), ptr(out), B, C, D, H, W)
    return out


def split_warp_bwd_zhalo_cuda(d_h: torch.Tensor, u_h: torch.Tensor, g: torch.Tensor):
    """B2Z (f32) or B2Z-bf16 on the card: ``(ḡ_d, ū_warp)`` on the haloed
    slab from the interior's cotangent ``g (B, 3, D, H, W)``, without the
    ``+g`` of the direct ``+u`` term."""
    (B, C, D, H, W), (_, bwd) = _check_zhalo(d_h, u_h)
    check_operand("g", g, (B, C, D, H, W), d_h.dtype, device=d_h.device)
    gd = torch.empty_like(d_h)
    gu = torch.empty_like(u_h)
    bwd.launch(d_h.device, ptr(d_h), ptr(u_h), ptr(g), ptr(gd), ptr(gu), B, C, D, H, W)
    return gd, gu


# ---- dispatch ------------------------------------------------------------------

def split_compose(d: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    if d.is_cuda:
        return split_warp_fwd_cuda(d, u)
    return split_compose_plain(d, u)


def split_compose_vjp(d: torch.Tensor, u: torch.Tensor, g: torch.Tensor):
    if d.is_cuda:
        gd, gu = split_warp_bwd_cuda(d, u, g)
        return gd, gu + g  # in the operands' dtype, as the plain version adds it
    return split_compose_vjp_plain(d, u, g)


def split_compose_zhalo(d_h: torch.Tensor, u_h: torch.Tensor) -> torch.Tensor:
    """B1Z (B1Z-bf16 on bf16 operands), or its plain version on the CPU."""
    if d_h.is_cuda:
        return split_warp_fwd_zhalo_cuda(d_h, u_h)
    return split_compose_zhalo_plain(d_h, u_h)


def split_compose_zhalo_vjp(d_h: torch.Tensor, u_h: torch.Tensor, g: torch.Tensor):
    """B2Z (B2Z-bf16) plus the direct term's ``+g`` on the interior planes,
    added in the operands' dtype, or the plain VJP on the CPU."""
    if d_h.is_cuda:
        gd, gu = split_warp_bwd_zhalo_cuda(d_h, u_h, g)
        gu[:, :, 1:-1] += g
        return gd, gu
    return split_compose_zhalo_vjp_plain(d_h, u_h, g)
