"""Bounded blend warp kernels B5 (forward), B6 (displacement gradient) and
B7 (volume gradient), with their plain PyTorch versions.

CUDA source: ``csrc/warp_bounded.cu``.  Replaces the Pallas kernels
``ir_sgmcmc_tpu/ops/pallas_warp.py::warp_bounded_pallas`` (B5),
``::warp_bounded_dgrad_pallas`` (B6) and ``::warp_bounded_tblend_pallas``
with the caller's edge fold (B7).

Operands, batched over a leading axis: ``vol (B, C, D, H, W)`` f32,
``disp (B, 3, D, H, W)`` f32 in voxels (channel 0 = x), the cotangent
``g (B, C, D, H, W)``, the radius ``R``.  The warp is the blend of the
``(2R+1)³`` edge-padded shifted copies of ``vol`` with separable triangular
weights at ``clip(disp, ±R)``: exact trilinear interpolation with border
clamping where ``|disp| <= R``.

The plain versions are the JAX package's XLA forms
(``ir_sgmcmc_tpu/ops/resample.py``: ``_warp_bounded_impl``,
``_bwd_dgrads_xla`` without its mask, ``_tblend_acc_xla`` and
``_fold_edge``), written with a leading batch axis.  A CPU tensor takes the
plain version; a CUDA tensor takes the kernel, and a launch or build
failure raises.

B5 and B6 have a z-halo mode (``z_halo=True``, the Pallas kernels' own
flag), for a z-slab of a volume split along z: ``vol`` is ``(B, C, D + 2R,
H, W)`` and its R first and last planes are the slab's real neighbour rows,
so a tap at output plane ``z`` and offset ``o`` reads vol plane ``z + R +
o`` with no clamp in z; y and x keep the edge padding.  ``disp``, ``g`` and
the output are ``(B, ., D, H, W)``.  The caller is the halo-exchanged warp
of ``parallel/halo.py`` (the JAX package's ``ir_sgmcmc_tpu/parallel/halo.py``);
the kernels are separate C entries with their own launch counters.

B7 has a z-pad mode (B7Z, ``warp_bounded_tblend_zpad``): the transpose blend
with y and x folded onto the border and the ``2R`` z pad planes kept
unfolded, ``(B, C, D + 2R, H, W)``: output plane ``p + R`` collects the taps
that land exactly on plane ``p`` in ``[-R, D + R)``.  That is the Pallas
kernel's output with the caller's y fold and no z fold
(``ir_sgmcmc_tpu/parallel/halo.py::_local_tblend_zpad``): the pad planes of
a z-slab carry the gradient mass that belongs to its neighbours, which the
halo exchange sends to them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._lib import Kernel, check_operand, ptr

# Work per voxel at C channels of vol (or g): B5 reads vol and disp and
# writes C channels; B6 reads vol, disp and g and writes 3; B7 reads disp
# and g and writes C.  Of the (2R+1)³ blend taps only the 8 of the
# trilinear stencil have a non-zero weight, so the flops are B3's and B4's
# (B7: 8 weighted adds per channel).
B5 = Kernel("warp_bounded_fwd", "ir_sgmcmc_tpu_torch/csrc/warp_bounded.cu",
            "ir_sgmcmc_tpu/ops/pallas_warp.py:458",
            bytes_per_voxel=lambda C: 4 * (2 * C + 3), flops_per_voxel=lambda C: 24 + 15 * C)
B6 = Kernel("warp_bounded_dgrad", "ir_sgmcmc_tpu_torch/csrc/warp_bounded.cu",
            "ir_sgmcmc_tpu/ops/pallas_warp.py:211",
            bytes_per_voxel=lambda C: 4 * (2 * C + 6), flops_per_voxel=lambda C: 64 + 16 * C)
# z-halo modes: the same work per output voxel, and 2R more vol planes read
B5Z = Kernel("warp_bounded_fwd_zhalo", "ir_sgmcmc_tpu_torch/csrc/warp_bounded.cu",
             "ir_sgmcmc_tpu/ops/pallas_warp.py:458", bytes_per_voxel=B5.bytes_per_voxel,
             flops_per_voxel=B5.flops_per_voxel, z_halo=True)
B6Z = Kernel("warp_bounded_dgrad_zhalo", "ir_sgmcmc_tpu_torch/csrc/warp_bounded.cu",
             "ir_sgmcmc_tpu/ops/pallas_warp.py:211", bytes_per_voxel=B6.bytes_per_voxel,
             flops_per_voxel=B6.flops_per_voxel, z_halo=True)
B7 = Kernel("warp_bounded_tblend", "ir_sgmcmc_tpu_torch/csrc/warp_bounded.cu",
            "ir_sgmcmc_tpu/ops/pallas_warp.py:372",
            bytes_per_voxel=lambda C: 4 * (2 * C + 3), flops_per_voxel=lambda C: 18 + 16 * C)
# z-pad mode: the same work per voxel of g, and 2R more output planes written
B7Z = Kernel("warp_bounded_tblend_zpad", "ir_sgmcmc_tpu_torch/csrc/warp_bounded.cu",
             "ir_sgmcmc_tpu/ops/pallas_warp.py:372", bytes_per_voxel=B7.bytes_per_voxel,
             flops_per_voxel=B7.flops_per_voxel, z_halo=True)


# ---- plain versions ------------------------------------------------------------

def _tri(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(t), min=0.0)


def _dtri(t: torch.Tensor) -> torch.Tensor:
    return -torch.sign(t) * (torch.abs(t) < 1.0).to(t.dtype)


def _clipped_axes(disp: torch.Tensor, R: int):
    """``(dx, dy, dz)`` of ``clip(disp, ±R)``, each ``(B, 1, D, H, W)``."""
    d = torch.clamp(disp, -R, R)
    return d[:, 0:1], d[:, 1:2], d[:, 2:3]


def _slab(padded: torch.Tensor, P: int, oz: int, oy: int, ox: int, shape):
    D, H, W = shape
    return padded[..., P + oz:P + oz + D, P + oy:P + oy + H, P + ox:P + ox + W]


def fold_edge(gp: torch.Tensor, P: int, axes=(-3, -2, -1)) -> torch.Tensor:
    """Transpose of the edge padding by ``P``: sum the pad slabs of each of
    ``axes`` onto that axis's border voxels."""
    for axis in axes:
        n = gp.shape[axis] - 2 * P
        core = gp.narrow(axis, P, n).clone()
        core.narrow(axis, 0, 1).add_(gp.narrow(axis, 0, P).sum(dim=axis, keepdim=True))
        core.narrow(axis, n - 1, 1).add_(
            gp.narrow(axis, P + n, P).sum(dim=axis, keepdim=True))
        gp = core
    return gp


def _padded(vol: torch.Tensor, R: int, z_halo: bool) -> torch.Tensor:
    """``vol`` edge-padded by ``R`` in (y, x), and in z unless it carries
    its z-halo already."""
    return F.pad(vol, (R,) * 4 + ((0, 0) if z_halo else (R, R)), mode="replicate")


def warp_bounded_plain(vol: torch.Tensor, disp: torch.Tensor, R: int,
                       z_halo: bool = False) -> torch.Tensor:
    """B5's function: the ``(2R+1)³`` blend of edge-padded shifted copies."""
    shape = tuple(disp.shape[-3:])
    dx, dy, dz = _clipped_axes(disp, R)
    padded = _padded(vol, R, z_halo)
    offsets = range(-R, R + 1)
    wx = [_tri(dx - o) for o in offsets]
    wy = [_tri(dy - o) for o in offsets]
    wz = [_tri(dz - o) for o in offsets]
    acc = None
    for iz, oz in enumerate(offsets):
        for iy, oy in enumerate(offsets):
            wzy = wz[iz] * wy[iy]
            for ix, ox in enumerate(offsets):
                term = (wzy * wx[ix]) * _slab(padded, R, oz, oy, ox, shape)
                acc = term if acc is None else acc + term
    return acc


def warp_bounded_dgrad_plain(vol: torch.Tensor, disp: torch.Tensor, g: torch.Tensor,
                             R: int, z_halo: bool = False) -> torch.Tensor:
    """B6's function: ``∂(Σ_c g_c·out_c)/∂disp`` before the ``|disp| > R``
    mask, ``(B, 3, D, H, W)``."""
    shape = tuple(disp.shape[-3:])
    dx, dy, dz = _clipped_axes(disp, R)
    padded = _padded(vol, R, z_halo)
    offsets = range(-R, R + 1)
    wx, wy, wz = ([_tri(d - o) for o in offsets] for d in (dx, dy, dz))
    dwx, dwy, dwz = ([_dtri(d - o) for o in offsets] for d in (dx, dy, dz))
    g_dx = g_dy = g_dz = torch.zeros_like(dx)
    for iz, oz in enumerate(offsets):
        for iy, oy in enumerate(offsets):
            for ix, ox in enumerate(offsets):
                gs = torch.sum(g * _slab(padded, R, oz, oy, ox, shape), dim=1, keepdim=True)
                g_dx = g_dx + (dwx[ix] * wy[iy] * wz[iz]) * gs
                g_dy = g_dy + (wx[ix] * dwy[iy] * wz[iz]) * gs
                g_dz = g_dz + (wx[ix] * wy[iy] * dwz[iz]) * gs
    return torch.cat([g_dx, g_dy, g_dz], dim=1)


def tblend_acc_plain(disp: torch.Tensor, g: torch.Tensor, R: int) -> torch.Tensor:
    """The unfolded transpose blend: ``w_o ⊙ g`` added at padded index
    ``p + R + o`` for every offset, ``(B, C, D+2R, H+2R, W+2R)``."""
    B, C, D, H, W = g.shape
    dx, dy, dz = _clipped_axes(disp, R)
    acc = g.new_zeros((B, C, D + 2 * R, H + 2 * R, W + 2 * R))
    offsets = range(-R, R + 1)
    wx = [_tri(dx - o) for o in offsets]
    wy = [_tri(dy - o) for o in offsets]
    for oz in offsets:
        wz = _tri(dz - oz)
        for iy, oy in enumerate(offsets):
            for ix, ox in enumerate(offsets):
                _slab(acc, R, oz, oy, ox, (D, H, W)).add_((wx[ix] * wy[iy] * wz) * g)
    return acc


def warp_bounded_tblend_plain(disp: torch.Tensor, g: torch.Tensor, R: int) -> torch.Tensor:
    """B7's function: ``∂(Σ_c g_c·out_c)/∂vol``, the transpose blend folded
    back onto the border, ``(B, C, D, H, W)``."""
    return fold_edge(tblend_acc_plain(disp, g, R), R)


def warp_bounded_tblend_zpad_plain(disp: torch.Tensor, g: torch.Tensor, R: int) -> torch.Tensor:
    """B7Z's function: the transpose blend with y and x folded and the z pad
    planes kept, ``(B, C, D + 2R, H, W)``."""
    return fold_edge(tblend_acc_plain(disp, g, R), R, axes=(-2, -1))


# ---- CUDA wrappers -------------------------------------------------------------

def _check(vol_or_g: torch.Tensor, disp: torch.Tensor, R: int, name: str,
           z_halo: bool = False):
    """``(B, C, D, H, W)`` of the output; in z-halo mode ``vol_or_g`` is
    ``2R`` planes deeper than ``disp``."""
    if vol_or_g.ndim != 5:
        raise ValueError(f"{name}: expected (B, C, D, H, W), got {tuple(vol_or_g.shape)}")
    if int(R) != R or R < 1:
        raise ValueError(f"radius must be a positive integer, got {R!r}")
    B, C, Dv, H, W = vol_or_g.shape
    D = Dv - 2 * int(R) if z_halo else Dv
    if D < 1:
        raise ValueError(f"{name}: depth {Dv} leaves no plane inside a z-halo of {R}")
    check_operand(name, vol_or_g, (B, C, Dv, H, W))
    check_operand("disp", disp, (B, 3, D, H, W), device=vol_or_g.device)
    return B, C, D, H, W


def warp_bounded_fwd_cuda(vol: torch.Tensor, disp: torch.Tensor, R: int,
                          z_halo: bool = False) -> torch.Tensor:
    """B5 on the card."""
    B, C, D, H, W = _check(vol, disp, R, "vol", z_halo)
    out = vol.new_empty((B, C, D, H, W))
    (B5Z if z_halo else B5).launch(vol.device, ptr(vol), ptr(disp), ptr(out),
                                   B, C, D, H, W, int(R))
    return out


def warp_bounded_dgrad_cuda(vol: torch.Tensor, disp: torch.Tensor, g: torch.Tensor,
                            R: int, z_halo: bool = False) -> torch.Tensor:
    """B6 on the card (unmasked)."""
    B, C, D, H, W = _check(vol, disp, R, "vol", z_halo)
    check_operand("g", g, (B, C, D, H, W), device=vol.device)
    out = torch.empty_like(disp)
    (B6Z if z_halo else B6).launch(vol.device, ptr(vol), ptr(disp), ptr(g), ptr(out),
                                   B, C, D, H, W, int(R))
    return out


def warp_bounded_tblend_cuda(disp: torch.Tensor, g: torch.Tensor, R: int,
                             z_pad: bool = False) -> torch.Tensor:
    """B7 on the card: the folded volume gradient, or with ``z_pad`` B7Z,
    ``(B, C, D + 2R, H, W)`` with the z pad planes unfolded."""
    B, C, D, H, W = _check(g, disp, R, "g")
    out = g.new_empty((B, C, D + 2 * int(R), H, W)) if z_pad else torch.empty_like(g)
    (B7Z if z_pad else B7).launch(g.device, ptr(disp), ptr(g), ptr(out), B, C, D, H, W, int(R))
    return out


# ---- dispatch ------------------------------------------------------------------

def warp_bounded_fwd(vol, disp, R: int, z_halo: bool = False) -> torch.Tensor:
    if vol.is_cuda:
        return warp_bounded_fwd_cuda(vol, disp, R, z_halo)
    return warp_bounded_plain(vol, disp, R, z_halo)


def warp_bounded_dgrad(vol, disp, g, R: int, z_halo: bool = False) -> torch.Tensor:
    if vol.is_cuda:
        return warp_bounded_dgrad_cuda(vol, disp, g, R, z_halo)
    return warp_bounded_dgrad_plain(vol, disp, g, R, z_halo)


def warp_bounded_tblend(disp, g, R: int, z_pad: bool = False) -> torch.Tensor:
    if g.is_cuda:
        return warp_bounded_tblend_cuda(disp, g, R, z_pad)
    if z_pad:
        return warp_bounded_tblend_zpad_plain(disp, g, R)
    return warp_bounded_tblend_plain(disp, g, R)
