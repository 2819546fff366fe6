"""Spatially sharded stencil ops by explicit halo exchange (port of
``ir_sgmcmc_tpu/parallel/halo.py``).

Fields cut along their leading spatial axis (D) over a ``'space'`` axis of
a :class:`~.mesh.Mesh` need, for a stencil of radius ``r``, only ``r``
planes of halo from each neighbour; the outermost shards replicate their
own edge plane, which is the single-device replicate padding exactly.  The
JAX package moves the halos with ``lax.ppermute`` under ``shard_map``; here
they are slab copies between the shards' devices (``.to(device,
non_blocking=True)``), issued from the one controlling thread.

Each op takes a :class:`~.mesh.Sharded` field (one D-slab per device, mesh
order) or a whole tensor, which it cuts first, and returns a ``Sharded``
result; :func:`~.mesh.gather` reassembles it.  On a mesh with other axes
beside ``axis_name`` each row along it computes the same result (the JAX
specs replicate over the other axes).  Each shard takes the kernels on a
CUDA device and their plain versions on the CPU, by the device of its
slab, with no fallback.
"""

from __future__ import annotations

import torch

from ..kernels import warp_bounded as _wb
from ..ops.stencil import conv1d_axis
from .mesh import Mesh, Sharded, shard_tree_spatial


def _slabs(field, mesh: Mesh, axis_name: str) -> Sharded:
    """``field`` cut along D over ``axis_name`` (as given, if it already is)."""
    if isinstance(field, Sharded):
        return field
    if field.shape[-3] % mesh.shape[axis_name]:
        raise ValueError(f"depth {field.shape[-3]} does not divide over "
                         f"{mesh.shape[axis_name]} shards")
    return shard_tree_spatial(field, mesh, field.shape[-3], axis_name)


def _per_row(op, mesh: Mesh, axis_name: str, *fields) -> Sharded:
    """``op(slabs, …) -> out slabs`` along each row of ``mesh`` over
    ``axis_name``, reassembled in mesh order, cut along D."""
    sharded = [_slabs(f, mesh, axis_name) for f in fields]
    out = [None] * mesh.size
    for row in mesh.rows(axis_name):
        for i, y in zip(row, op(*([s[i] for i in row] for s in sharded))):
            out[i] = y
    return Sharded(out, mesh, [((out[0].ndim - 3, axis_name),)])


def _exchange_halo_d(xs: list, r: int) -> list:
    """Each slab of ``xs`` (neighbours in order along D) with ``r`` planes of
    halo on both sides of D (-3): its neighbours' edge planes, or at the two
    ends its own edge plane repeated (replicate padding)."""
    n = len(xs)
    out = []
    for i, x in enumerate(xs):
        if x.shape[-3] < r:
            raise ValueError(f"a shard of {x.shape[-3]} planes cannot give a halo of {r}")
        reps = [1] * x.ndim
        reps[-3] = r
        left = (x[..., :1, :, :].repeat(reps) if i == 0
                else xs[i - 1][..., -r:, :, :].to(x.device, non_blocking=True))
        right = (x[..., -1:, :, :].repeat(reps) if i == n - 1
                 else xs[i + 1][..., :r, :, :].to(x.device, non_blocking=True))
        out.append(torch.cat([left, x, right], dim=-3))
    return out


def _conv_d_valid(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Valid 1D correlation along D (-3) of a halo-padded slab."""
    taps = int(kernel.shape[0])
    n_out = x.shape[-3] - taps + 1
    out = None
    for j in range(taps):
        term = kernel[j] * x.narrow(-3, j, n_out)
        out = term if out is None else out + term
    return out


def separable_conv3d_sharded(field, kernel, mesh: Mesh, axis_name: str = "space") -> Sharded:
    """Separable 3D convolution of a D-sharded ``(…, D, H, W)`` field
    (replicate padding): the H and W passes are local, the D pass uses an
    ``r``-plane halo."""

    def run(xs):
        k = [torch.as_tensor(kernel, dtype=x.dtype, device=x.device) for x in xs]
        r = int(k[0].shape[0]) // 2
        xs = [conv1d_axis(conv1d_axis(x, kk, -1), kk, -2) for x, kk in zip(xs, k)]
        return [_conv_d_valid(x, kk) for x, kk in zip(_exchange_halo_d(xs, r), k)]

    return _per_row(run, mesh, axis_name, field)


def gradient_d_sharded(field, mesh: Mesh, axis_name: str = "space") -> Sharded:
    """Forward difference along D of a D-sharded ``(…, D, H, W)`` field,
    ``ops.stencil.gradient``'s D component: the last difference of the
    volume repeated at its last plane."""

    def run(xs):
        n, out = len(xs), []
        for i, x in enumerate(xs):
            nxt = (x[..., -1:, :, :] if i == n - 1
                   else xs[i + 1][..., :1, :, :].to(x.device, non_blocking=True))
            xp = torch.cat([x, nxt], dim=-3)
            d = xp[..., 1:, :, :] - xp[..., :-1, :, :]
            if i == n - 1:  # replicate the previous difference, as on one device
                d = torch.cat([d[..., :-1, :, :], d[..., -2:-1, :, :]], dim=-3)
            out.append(d)
        return out

    return _per_row(run, mesh, axis_name, field)


def _exchange_tblend_z(accs: list, R: int) -> list:
    """Resolve the z pad planes of the slabs' transpose-blend accumulators
    ``(B, C, D_loc + 2R, H, W)``: a slab's R planes below (above) its own go
    to the neighbour below (above); at the two ends they fold onto the
    border plane (the transpose of the replicate padding), which is the
    single-device edge fold."""
    n, out = len(accs), []
    for i, acc in enumerate(accs):
        d_loc = acc.shape[-3] - 2 * R
        g = acc[..., R:R + d_loc, :, :].clone()
        lo, hi = acc[..., :R, :, :], acc[..., R + d_loc:, :, :]
        if i > 0:
            g[..., :R, :, :] += accs[i - 1][..., -R:, :, :].to(acc.device, non_blocking=True)
        if i < n - 1:
            g[..., d_loc - R:, :, :] += accs[i + 1][..., :R, :, :].to(acc.device,
                                                                      non_blocking=True)
        if i == 0:
            g[..., :1, :, :] += lo.sum(dim=-3, keepdim=True)
        if i == n - 1:
            g[..., -1:, :, :] += hi.sum(dim=-3, keepdim=True)
        out.append(g)
    return out


class HaloWarp(torch.autograd.Function):
    """The bounded warp of D-slabs ``(B, C, D_loc, H, W)`` by ``(B, 3, D_loc,
    H, W)`` displacements, with the JAX package's analytic backward.

    Forward: exchange an R-plane halo, then B5 in its z-halo mode on each
    slab.  Backward: recompute the halo; B6 in its z-halo mode, masked where
    ``|disp| > R``; B7 in its z-pad mode (B7Z) and the exchange of its pad
    planes.  Only ``O(R·H·W)`` planes cross between devices either way.
    Inputs: ``radius``, the slab count ``n``, then the ``n`` vol and the
    ``n`` disp slabs; one output slab per shard."""

    @staticmethod
    def forward(ctx, radius, n, *slabs):
        vols, disps = slabs[:n], slabs[n:]
        ctx.radius, ctx.n = radius, n
        ctx.save_for_backward(*vols, *disps)
        return tuple(_wb.warp_bounded_fwd(vh, d, radius, z_halo=True)
                     for vh, d in zip(_exchange_halo_d(list(vols), radius), disps))

    @staticmethod
    def backward(ctx, *gs):
        R, n = ctx.radius, ctx.n
        saved = ctx.saved_tensors
        vols, disps = saved[:n], saved[n:]
        gs = [g.contiguous() for g in gs]
        g_vol, g_disp = [None] * n, [None] * n
        if any(ctx.needs_input_grad[2 + n:]):
            for i, (vh, d, g) in enumerate(zip(_exchange_halo_d(list(vols), R), disps, gs)):
                gd = _wb.warp_bounded_dgrad(vh, d, g, R, z_halo=True)
                g_disp[i] = torch.where(torch.abs(d) <= R, gd, torch.zeros_like(gd))
        if any(ctx.needs_input_grad[2:2 + n]):
            g_vol = _exchange_tblend_z(
                [_wb.warp_bounded_tblend(d, g, R, z_pad=True) for d, g in zip(disps, gs)], R)
        return (None, None, *g_vol, *g_disp)


def warp_bounded_sharded(vol, disp_vox, radius: int, mesh: Mesh,
                         axis_name: str = "space") -> Sharded:
    """Bounded trilinear warp of a D-sharded volume by halo exchange:
    exact trilinear with border clamping where ``|disp| <= radius``, as
    ``ops.resample.warp_bounded`` on one device.

    ``vol``: ``(C?, D, H, W)`` (or ``(B, C, D, H, W)``); ``disp_vox``:
    ``(3, D, H, W)`` (or ``(B, 3, D, H, W)``) in voxels, channel 0 = x; both
    cut along D over ``axis_name`` the same way.  Differentiable in both
    (:class:`HaloWarp`).  Each shard must hold at least ``2·radius``
    planes."""
    R = int(radius)
    n_space = mesh.shape[axis_name]
    D = (sum(vol[i].shape[-3] for i in mesh.rows(axis_name)[0]) if isinstance(vol, Sharded)
         else vol.shape[-3])
    if D // n_space < 2 * R:
        raise ValueError(f"warp_bounded_sharded: {D} rows over {n_space} shards leaves "
                         f"{D // n_space} rows/shard < 2*radius={2 * R}")

    def run(vs, ds):
        v5 = [v.reshape((1,) * (5 - v.ndim) + tuple(v.shape)).contiguous() for v in vs]
        d5 = [d.reshape((1,) * (5 - d.ndim) + tuple(d.shape)).contiguous() for d in ds]
        outs = HaloWarp.apply(R, len(vs), *v5, *d5)
        return [o.reshape(tuple(v.shape[:-3]) + tuple(o.shape[-3:])) for o, v in zip(outs, vs)]

    return _per_row(run, mesh, axis_name, vol, disp_vox)
