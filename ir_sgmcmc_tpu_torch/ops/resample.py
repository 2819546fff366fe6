"""3D resampling, main-path subset (port of ``ir_sgmcmc_tpu/ops/resample.py``).

* :func:`grid_sample` — torch ``grid_sample`` semantics (trilinear or
  nearest, border padding, ``align_corners=True``); the image warp below
  64³, and with :func:`warp` the trainer's segmentation warp;
  :func:`grid_sample_each` samples each field of a batch at its own grid
  (the gather-based integrations of ``SVF3D(use_gather=True)`` and
  ``SVF2D``).
* :func:`warp_block_gather` — the exact trilinear warp by a smooth bounded
  displacement, decomposed into per-block integer means plus a clipped
  residual; kernels B3/B4 on the card (``kernels/block_warp.py``).
* :func:`warp_bounded` — the blend warp by a displacement clipped to ``±R``
  voxels; kernels B5-B7 on the card (``kernels/warp_bounded.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import block_warp as _bw
from ..kernels import warp_bounded as _wb


def _nearest(v: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``v (C, D, H, W)`` at the nearest voxel of each point of ``grid (…, 3,
    D', H', W')``: ``(…, C, D', H', W')``.  The coordinate arithmetic is the
    JAX package's (``i = (g + 1) · 0.5 · (S - 1)``, clamped to the volume),
    rounded half to even as ``jnp.rint`` does."""
    C = v.shape[0]
    D, H, W = v.shape[-3:]

    def index(c: torch.Tensor, n: int) -> torch.Tensor:
        return torch.round(torch.clamp((c + 1.0) * 0.5 * (n - 1), 0.0, n - 1)).to(torch.int64)

    flat = (index(grid[..., 2, :, :, :], D) * H
            + index(grid[..., 1, :, :, :], H)) * W + index(grid[..., 0, :, :, :], W)
    out = v.reshape(C, -1)[:, flat.reshape(-1)].reshape((C,) + tuple(flat.shape))
    return torch.movedim(out, 0, -4)


def grid_sample(vol: torch.Tensor, grid: torch.Tensor, mode: str = "linear") -> torch.Tensor:
    """Sample ``vol`` at normalised ``grid``, torch ``grid_sample`` semantics
    (border padding, ``align_corners=True``).

    :param vol: ``(D, H, W)`` or ``(C, D, H, W)``, shared by every grid.
    :param grid: ``(…, 3, D', H', W')`` normalised coordinates, channel 0 =
        x/W — the order ``F.grid_sample`` reads from its last axis.
    :param mode: ``"linear"`` (trilinear, ``F.grid_sample``) or
        ``"nearest"`` (a gather at the rounded coordinates, half to even).
    :return: ``(…, [C,] D', H', W')``.
    """
    squeeze = vol.ndim == 3
    v = vol[None] if squeeze else vol
    if mode == "nearest":
        out = _nearest(v, grid)
        return out.squeeze(-4) if squeeze else out
    if mode != "linear":
        raise ValueError(f"unknown mode: {mode}")
    lead = grid.shape[:-4]
    g = grid.reshape((-1,) + tuple(grid.shape[-4:]))
    n = g.shape[0]
    out = F.grid_sample(v[None].expand((n,) + tuple(v.shape)),
                        g.permute(0, 2, 3, 4, 1), mode="bilinear",
                        padding_mode="border", align_corners=True)
    out = out.reshape(tuple(lead) + tuple(out.shape[1:]))
    return out.squeeze(-4) if squeeze else out


def grid_sample_each(field: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Each field of a batch at its own normalised grid, bilinear or
    trilinear with :func:`grid_sample`'s semantics: ``field (B, C, *S)`` at
    ``grid (B, n, *S')`` with ``n = len(S)`` (2 or 3) channels, channel 0 =
    x -> ``(B, C, *S')``."""
    perm = (0,) + tuple(range(2, grid.ndim)) + (1,)
    return F.grid_sample(field, grid.permute(perm), mode="bilinear",
                         padding_mode="border", align_corners=True)


def _block_means(disp_vox: torch.Tensor, block: int, max_disp: float) -> torch.Tensor:
    """Per-block rounded mean displacement ``(…, 3, nbz, nby, nbx)`` int32,
    clipped to ``±max_disp`` (``torch.round`` is half-to-even like jnp)."""
    D, H, W = disp_vox.shape[-3:]
    k = block
    lead = tuple(disp_vox.shape[:-3])
    x = disp_vox.to(torch.float32).reshape(lead + (D // k, k, H // k, k, W // k, k))
    n = len(lead)
    s = x.sum(dim=(n + 1, n + 3, n + 5)) / float(k ** 3)
    return torch.clamp(torch.round(s), -max_disp, max_disp).to(torch.int32)


def _residual(disp_vox: torch.Tensor, block: int, max_disp: float):
    m = _block_means(disp_vox.detach(), block, max_disp)
    return m, disp_vox - _bw._expand_blocks(m, block).to(disp_vox.dtype)


class BlockGatherWarp(torch.autograd.Function):
    """Forward B3; backward B4 masked where ``|r_raw| > R``.  The volume is
    a constant (no cotangent), as in the JAX ``warp_block_gather``."""

    @staticmethod
    def forward(ctx, vol, disp_vox, max_disp, radius, block):
        m, r_raw = _residual(disp_vox, block, max_disp)
        r_c = torch.clamp(r_raw, -radius, radius).contiguous()
        ctx.block, ctx.radius = block, radius
        ctx.save_for_backward(vol, r_c, m, torch.abs(r_raw) <= radius)
        return _bw.block_warp(vol, r_c, m, radius, block)

    @staticmethod
    def backward(ctx, g):
        vol, r_c, m, inside = ctx.saved_tensors
        g_r = _bw.block_warp_dgrad(vol, r_c, m, g.contiguous(), ctx.radius, ctx.block)
        return None, torch.where(inside, g_r, torch.zeros_like(g_r)), None, None, None


def warp_block_gather(vol: torch.Tensor, disp_vox: torch.Tensor, max_disp: int,
                      radius: int = 2, block: int = 8) -> torch.Tensor:
    """Warp ``vol (B, C, D, H, W)`` by ``disp_vox (B, 3, D, H, W)`` (voxel
    units, ``|disp| ≤ max_disp``): exact trilinear wherever each voxel stays
    within ``radius`` of its block's rounded mean, clamped beyond (count
    those with :func:`block_residual_overflow`)."""
    return BlockGatherWarp.apply(vol, disp_vox, max_disp, radius, block)


def block_residual_overflow(disp_vox: torch.Tensor, max_disp: int,
                            radius: int = 2, block: int = 8) -> torch.Tensor:
    """Voxels whose block residual exceeds ``radius``, per leading batch."""
    _, r = _residual(disp_vox, block, max_disp)
    over = torch.any(torch.abs(r) > radius, dim=-4)
    return torch.sum(over, dim=(-3, -2, -1))


class WarpBounded(torch.autograd.Function):
    """Forward B5; backward B6 masked where ``|disp| > R`` and B7, each only
    for an input that needs its gradient.  Saves only ``(vol, disp)``, as
    the JAX package's custom VJP does."""

    @staticmethod
    def forward(ctx, vol, disp, radius):
        vol, disp = vol.contiguous(), disp.contiguous()
        ctx.radius = radius
        ctx.save_for_backward(vol, disp)
        return _wb.warp_bounded_fwd(vol, disp, radius)

    @staticmethod
    def backward(ctx, g):
        vol, disp = ctx.saved_tensors
        R = ctx.radius
        g = g.contiguous()
        g_vol = g_disp = None
        if ctx.needs_input_grad[1]:
            g_disp = _wb.warp_bounded_dgrad(vol, disp, g, R)
            g_disp = torch.where(torch.abs(disp) <= R, g_disp, torch.zeros_like(g_disp))
        if ctx.needs_input_grad[0]:
            g_vol = _wb.warp_bounded_tblend(disp, g, R)
        return g_vol, g_disp, None


def warp_bounded(vol: torch.Tensor, disp_vox: torch.Tensor, radius: int) -> torch.Tensor:
    """Warp ``vol (B, C, D, H, W)`` by ``disp_vox (B, 3, D, H, W)`` (voxels,
    channel 0 = x): exact trilinear with border clamping where
    ``|disp| <= radius``, the displacement clipped to ``±radius`` beyond."""
    return WarpBounded.apply(vol, disp_vox, int(radius))


def warp(moving: torch.Tensor, transformation: torch.Tensor, *,
         method: str = "linear") -> torch.Tensor:
    """Warp an image or segmentation ``(D, H, W)`` by a dense normalised
    transformation ``(…, 3, D, H, W)``: ``"linear"`` for intensity images,
    ``"nearest"`` for masks and segmentations.  The volume is sampled as
    float32; ``"nearest"`` casts the result back to an integer or bool
    input's dtype."""
    out = grid_sample(moving.to(torch.float32), transformation, mode=method)
    if method == "nearest" and moving.dtype != torch.float32:
        out = out.to(moving.dtype)
    return out
