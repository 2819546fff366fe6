"""Block-gather warp kernels B3 (forward) and B4 (residual gradient), with
their plain PyTorch versions.

CUDA source: ``csrc/block_warp.cu``.  Replaces the Pallas kernels
``ir_sgmcmc_tpu/ops/pallas_block_warp.py::block_warp_pallas`` (B3) and
``::block_warp_dgrad_pallas`` (B4).

Operands (batched over chains): ``vol (B, C, D, H, W)`` f32, the
residual ``r (B, 3, D, H, W)`` f32 clipped to ``±radius`` (channel 0 = x),
the block means
``m (B, 3, D/k, H/k, W/k)`` int32 for block edge ``k``.  Both versions
evaluate ``Σ_o tri(r-o) V[clamp(p+m+o)]`` through its two non-zero taps
per axis, with the derivative-of-triangle weights ``-sign(t)·1{|t|<1}``
for the gradient (zero along an axis whose residual is an integer).

A CPU tensor takes the plain version; a CUDA tensor takes the kernel, and a
launch or build failure raises.
"""

from __future__ import annotations

import torch

from ._lib import Kernel, check_operand, ptr

# Work per voxel at C channels of vol, with the path's block of 8 (m adds
# 3 int32 per 8³ voxels): B3 reads vol and r and writes C channels, from 8
# taps (18 flops of weights and coordinates per voxel, 15 per channel); B4
# reads vol, r and g and writes 3 channels (per tap a C-channel dot
# product, then ~64 flops of weight combinations).
_M_BYTES = 12 / 8 ** 3
B3 = Kernel("block_warp_fwd", "ir_sgmcmc_tpu_torch/csrc/block_warp.cu",
            "ir_sgmcmc_tpu/ops/pallas_block_warp.py:420",
            bytes_per_voxel=lambda C: 4 * (2 * C + 3) + _M_BYTES,
            flops_per_voxel=lambda C: 24 + 15 * C)
B4 = Kernel("block_warp_dgrad", "ir_sgmcmc_tpu_torch/csrc/block_warp.cu",
            "ir_sgmcmc_tpu/ops/pallas_block_warp.py:445",
            bytes_per_voxel=lambda C: 4 * (2 * C + 6) + _M_BYTES,
            flops_per_voxel=lambda C: 64 + 16 * C)


# ---- plain versions ------------------------------------------------------------

def _expand_blocks(m: torch.Tensor, block: int) -> torch.Tensor:
    return (m.repeat_interleave(block, dim=-3).repeat_interleave(block, dim=-2)
             .repeat_interleave(block, dim=-1))


def _axis_taps(r: torch.Tensor, base: torch.Tensor, n: int):
    """Clamped indices, tri and dtri weights of taps ``floor(r)`` and +1."""
    k = torch.floor(r)
    out = []
    for kk in (k, k + 1.0):
        t = r - kk
        idx = torch.clamp(base + kk.to(torch.int64), 0, n - 1)
        w = torch.clamp(1.0 - torch.abs(t), min=0.0)
        dw = -torch.sign(t) * (torch.abs(t) < 1.0).to(t.dtype)
        out.append((idx, w, dw))
    return out


def _taps(r: torch.Tensor, m: torch.Tensor, block: int):
    B, _, D, H, W = r.shape
    mf = _expand_blocks(m, block).to(torch.int64)
    dev = r.device
    pz = torch.arange(D, device=dev).view(D, 1, 1)
    py = torch.arange(H, device=dev).view(1, H, 1)
    px = torch.arange(W, device=dev).view(1, 1, W)
    tx = _axis_taps(r[:, 0], px + mf[:, 0], W)
    ty = _axis_taps(r[:, 1], py + mf[:, 1], H)
    tz = _axis_taps(r[:, 2], pz + mf[:, 2], D)
    return tx, ty, tz


def _gather(vol: torch.Tensor, iz, iy, ix) -> torch.Tensor:
    """``vol[b, c, iz, iy, ix]`` per output voxel -> ``(B, C, D, H, W)``."""
    B, C, D, H, W = vol.shape
    flat = ((iz * H + iy) * W + ix).reshape(B, 1, -1).expand(B, C, -1)
    return torch.gather(vol.reshape(B, C, -1), 2, flat).reshape(B, C, D, H, W)


def block_warp_plain(vol: torch.Tensor, r: torch.Tensor, m: torch.Tensor,
                     block: int = 8) -> torch.Tensor:
    """B3's function: trilinear warp at ``p + m_b + r``."""
    tx, ty, tz = _taps(r, m, block)
    acc = None
    for iz, wz, _ in tz:
        for iy, wy, _ in ty:
            inner = None
            for ix, wx, _ in tx:
                term = wx.unsqueeze(1) * _gather(vol, iz, iy, ix)
                inner = term if inner is None else inner + term
            term = (wz * wy).unsqueeze(1) * inner
            acc = term if acc is None else acc + term
    return acc


def block_warp_dgrad_plain(vol: torch.Tensor, r: torch.Tensor, m: torch.Tensor,
                           g: torch.Tensor, block: int = 8) -> torch.Tensor:
    """B4's function: ``∂(Σ_c g_c·warp_c)/∂r``, ``(B, 3, D, H, W)``."""
    tx, ty, tz = _taps(r, m, block)
    acc = [None, None, None]

    def add(i, t):
        acc[i] = t if acc[i] is None else acc[i] + t

    for iz, wz, dwz in tz:
        for iy, wy, dwy in ty:
            sg = [torch.sum(g * _gather(vol, iz, iy, ix), dim=1) for ix, _, _ in tx]
            a_sum = tx[0][2] * sg[0] + tx[1][2] * sg[1]
            b_sum = tx[0][1] * sg[0] + tx[1][1] * sg[1]
            add(0, (wz * wy) * a_sum)
            add(1, (wz * dwy) * b_sum)
            add(2, (dwz * wy) * b_sum)
    return torch.stack(acc, dim=1)


# ---- CUDA wrappers -------------------------------------------------------------

def _check(vol, r, m, block):
    if vol.ndim != 5:
        raise ValueError(f"vol: expected (B, C, D, H, W), got {tuple(vol.shape)}")
    B, C, D, H, W = vol.shape
    if any(s % block for s in (D, H, W)):
        raise ValueError(f"spatial dims {(D, H, W)} must divide by block {block}")
    check_operand("vol", vol, (B, C, D, H, W))
    check_operand("r", r, (B, 3, D, H, W), device=vol.device)
    check_operand("m", m, (B, 3, D // block, H // block, W // block),
                  dtype=torch.int32, device=vol.device)
    return B, C, D, H, W


def _check_radius(radius) -> int:
    if int(radius) != radius or radius < 0:
        raise ValueError(f"radius must be a non-negative integer, got {radius!r}")
    return int(radius)


def block_warp_cuda(vol, r, m, radius: int, block: int = 8) -> torch.Tensor:
    """B3 on the card.  ``r`` arrives clipped to ``±radius``: at block 8 and
    radius 1-3 the kernel stages each block's ``(block + 2·radius)³``
    source window and takes the taps from it (an ``r`` beyond that stays
    inside the window but reads wrong taps)."""
    B, C, D, H, W = _check(vol, r, m, block)
    radius = _check_radius(radius)
    out = torch.empty_like(vol)
    B3.launch(vol.device, ptr(vol), ptr(r), ptr(m), ptr(out),
              B, C, D, H, W, block, radius)
    return out


def block_warp_dgrad_cuda(vol, r, m, g, radius: int, block: int = 8) -> torch.Tensor:
    """B4 on the card; ``radius`` as for :func:`block_warp_cuda`."""
    B, C, D, H, W = _check(vol, r, m, block)
    radius = _check_radius(radius)
    check_operand("g", g, (B, C, D, H, W), device=vol.device)
    out = torch.empty_like(r)
    B4.launch(vol.device, ptr(vol), ptr(r), ptr(m), ptr(g), ptr(out),
              B, C, D, H, W, block, radius)
    return out


# ---- dispatch ------------------------------------------------------------------

def block_warp(vol, r, m, radius: int, block: int = 8) -> torch.Tensor:
    """B3; ``radius`` is the clip of ``r``, which only the kernel needs."""
    if vol.is_cuda:
        return block_warp_cuda(vol, r, m, radius, block)
    return block_warp_plain(vol, r, m, block)


def block_warp_dgrad(vol, r, m, g, radius: int, block: int = 8) -> torch.Tensor:
    """B4; ``radius`` as for :func:`block_warp`."""
    if vol.is_cuda:
        return block_warp_dgrad_cuda(vol, r, m, g, radius, block)
    return block_warp_dgrad_plain(vol, r, m, g, block)
