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

The spatially sharded training steps (``parallel/spatial.py``) take a halo
form of every stencil of the step, which the JAX package leaves to GSPMD's
partitioner, in a list form (``*_slabs``: one row's slabs in, slabs or one
reduced tensor out, summed on the first slab's device) that composes into
one autograd graph over a row; :class:`_Slabs` carries a field's slabs
between them.  The halo exchanges are differentiable (slices, ``repeat``,
``.to`` and ``cat``), so autograd sends each halo plane's gradient back to
the shard that owns it and folds the replicated pad planes at the volume's
two ends onto its edge plane.  Forward differences along D take the next
shard's first plane, and the last shard repeats its previous difference, as
one device does at the volume's last plane (``ops.stencil._fwd_diff_axis``).
"""

from __future__ import annotations

import functools
import math

import torch

from ..kernels import block_warp as _bw
from ..kernels import split_warp as _sw
from ..kernels import warp_bounded as _wb
from ..ops._layout import _lag1_sum
from ..ops.resample import _residual, block_residual_overflow
from ..ops.stencil import TaylorComposeStep, TaylorSquaringStep, conv1d_axis
from .mesh import Mesh, Sharded, halo_images_spatial, shard_tree_spatial


_SLAB_METHODS = frozenset(("contiguous", "detach", "expand", "float", "to", "unsqueeze"))


class _Slabs:
    """One row's D-slabs of a field, in order along D, each on its shard's
    device (``parts``: a list form's operand).  Torch functions, the tensor
    methods of ``_SLAB_METHODS`` and operators apply slab by slab; an
    operand that is not a ``_Slabs`` goes to every slab as it is.  A
    reduction over D gives per-slab partial results: the layout's ``total``
    adds them.  ``shape``, ``dtype``, ``ndim`` and ``device`` are the first
    slab's: its device is where the row's sums over voxels land."""

    def __init__(self, parts):
        self.parts = list(parts)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _each(func, *args, **(kwargs or {}))

    def __getattr__(self, name):
        if name not in _SLAB_METHODS:
            raise AttributeError(f"D-slabs do not apply Tensor.{name} slab by slab")
        method = getattr(torch.Tensor, name)
        return lambda *args, **kwargs: _each(method, self, *args, **kwargs)

    shape = property(lambda self: self.parts[0].shape)
    dtype = property(lambda self: self.parts[0].dtype)
    ndim = property(lambda self: self.parts[0].ndim)
    device = property(lambda self: self.parts[0].device)


for _name in ("add", "radd", "sub", "rsub", "mul", "rmul", "truediv", "rtruediv", "pow", "neg",
              "lt", "ge", "getitem"):
    setattr(_Slabs, f"__{_name}__", functools.partialmethod(
        lambda self, method, *args: _each(method, self, *args),
        getattr(torch.Tensor, f"__{_name}__")))


def _width(x) -> int:
    """The slab count of the ``_Slabs`` in ``x`` (0: none)."""
    if isinstance(x, _Slabs):
        return len(x.parts)
    if isinstance(x, (list, tuple, dict)):
        return max(map(_width, x.values() if isinstance(x, dict) else x), default=0)
    return 0


def _pick(x, k: int):
    """``x`` with each ``_Slabs`` in it replaced by its slab ``k``."""
    if isinstance(x, _Slabs):
        return x.parts[k]
    if isinstance(x, list) or type(x) is tuple:
        return type(x)(_pick(e, k) for e in x)
    if isinstance(x, dict):
        return {a: _pick(e, k) for a, e in x.items()}
    return x


def _each(fn, *args, **kwargs) -> _Slabs:
    """``fn`` of each slab of the ``_Slabs`` among the arguments in turn."""
    return _Slabs(fn(*_pick(args, k), **_pick(kwargs, k))
                  for k in range(_width((args, kwargs))))


def _lifted(fn):
    """A layout method of ``fn``, a halo op of lists of slabs: ``_Slabs``
    operands as lists, a list result as ``_Slabs``."""
    def method(self, *args):
        out = fn(*(a.parts if isinstance(a, _Slabs) else a for a in args))
        return _Slabs(out) if isinstance(out, list) else out
    return method


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


def separable_conv3d_slabs(xs: list, kernel) -> list:
    """:func:`separable_conv3d_sharded` of one row's slabs: the D pass first,
    on an ``r``-plane halo, then the local H and W passes, the order of
    ``ops.stencil.separable_conv3d`` (so each slab's values are the
    unsharded op's, to the bit).  ``kernel``: one 1D kernel, or a list of
    it on each slab's device (no copy per call)."""
    k = (list(kernel) if isinstance(kernel, (list, tuple))
         else [torch.as_tensor(kernel, dtype=x.dtype, device=x.device) for x in xs])
    r = int(k[0].shape[0]) // 2
    return [conv1d_axis(conv1d_axis(_conv_d_valid(x, kk), kk, -2), kk, -1)
            for x, kk in zip(_exchange_halo_d(xs, r), k)]


def separable_conv3d_sharded(field, kernel, mesh: Mesh, axis_name: str = "space") -> Sharded:
    """Separable 3D convolution of a D-sharded ``(…, D, H, W)`` field
    (replicate padding): the D pass uses an ``r``-plane halo, the H and W
    passes are local."""
    return _per_row(lambda xs: separable_conv3d_slabs(xs, kernel), mesh, axis_name, field)


@functools.lru_cache(maxsize=64)
def _ones(taps: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The box filter's kernel, made once per device (filled there: a host
    copy per call would wait for the device)."""
    return torch.ones((taps,), dtype=dtype, device=device)


def box_filter3d_slabs(xs: list, radius: int) -> list:
    """``ops.stencil.box_filter3d`` of one row's slabs: the sum over a cubic
    ``(2r+1)³`` window with replicate padding."""
    return separable_conv3d_slabs(xs, [_ones(2 * int(radius) + 1, x.device, x.dtype)
                                       for x in xs])


class SobolevSmoothSlabs(torch.autograd.Function):
    """``ops.sobolev.SobolevSmooth`` of one row's slabs: the separable
    filter by halo exchange forward (:func:`separable_conv3d_slabs`), the
    identity backward.  Inputs: the slab count ``n``, the kernel on each
    slab's device, then the ``n`` slabs."""

    @staticmethod
    def forward(ctx, n, *args):
        ctx.n = n
        return tuple(separable_conv3d_slabs(list(args[n:]), list(args[:n])))

    @staticmethod
    def backward(ctx, *gs):
        return (None,) * (1 + ctx.n) + gs


def box_filter3d_sharded(field, radius: int, mesh: Mesh, axis_name: str = "space") -> Sharded:
    """:func:`ops.stencil.box_filter3d` of a D-sharded field (the LCC
    residual's local means and variances)."""
    return _per_row(lambda xs: box_filter3d_slabs(xs, radius), mesh, axis_name, field)


def _next_planes(xs: list) -> list:
    """Each slab's next plane along D, from the next shard (None for the
    last shard)."""
    n = len(xs)
    return [xs[i + 1][..., :1, :, :].to(x.device, non_blocking=True) if i < n - 1 else None
            for i, x in enumerate(xs)]


def fwd_diff_d_slabs(xs: list) -> list:
    """The forward difference along D (-3) of one row's slabs,
    ``ops.stencil._fwd_diff_axis`` of the volume: the next shard's first
    plane closes each slab, and the last shard repeats its previous
    difference at the volume's last plane."""
    out = []
    for x, nxt in zip(xs, _next_planes(xs)):
        xp = torch.cat([x, x[..., -1:, :, :] if nxt is None else nxt], dim=-3)
        d = xp[..., 1:, :, :] - xp[..., :-1, :, :]
        if nxt is None:  # replicate the previous difference, as on one device
            d = torch.cat([d[..., :-1, :, :], d[..., -2:-1, :, :]], dim=-3)
        out.append(d)
    return out


def gradient_d_sharded(field, mesh: Mesh, axis_name: str = "space") -> Sharded:
    """Forward difference along D of a D-sharded ``(…, D, H, W)`` field,
    ``ops.stencil.gradient``'s D component: the last difference of the
    volume repeated at its last plane."""
    return _per_row(fwd_diff_d_slabs, mesh, axis_name, field)


def taylor_squaring_slabs(ds: list) -> list:
    """One Taylor squaring ``d' = 2d + (d·∇)d`` of one row's slabs of a
    ``(…, 3, D, H, W)`` field, with its analytic backward
    (``ops.stencil.TaylorSquaringStep``): each slab but the last takes the
    next shard's first plane, squares the closed slab and keeps its own
    planes; the last shard squares its slab as it is, whose forward
    difference repeats the previous one at the volume's last plane.  The
    planes kept are the unsharded step's, to the bit, and so is the
    gradient: the added plane's cotangent is 0."""
    out = []
    for d, nxt in zip(ds, _next_planes(ds)):
        if nxt is None:
            out.append(TaylorSquaringStep.apply(d))
        else:
            closed = TaylorSquaringStep.apply(torch.cat([d, nxt], dim=-3))
            out.append(closed[..., :-1, :, :])
    return out


def taylor_compose_slabs(ds: list, us: list) -> list:
    """One Taylor composition ``d' = u + d + (u·∇)d`` of one row's slabs of
    ``(…, 3, D, H, W)`` fields, with its analytic backward
    (``ops.stencil.TaylorComposeStep``): as :func:`taylor_squaring_slabs`,
    each slab of ``d`` but the last takes the next shard's first plane (a
    one-plane halo along D, whose cotangent autograd sends back to that
    shard), and ``u``, read at each voxel alone, takes its own last plane
    again; each slab keeps its own planes, the unsharded step's to the
    bit."""
    out = []
    for d, u, nxt in zip(ds, us, _next_planes(ds)):
        if nxt is None:
            out.append(TaylorComposeStep.apply(d, u))
        else:
            closed = TaylorComposeStep.apply(torch.cat([d, nxt], dim=-3),
                                             torch.cat([u, u[..., -1:, :, :]], dim=-3))
            out.append(closed[..., :-1, :, :])
    return out


def taylor_compose_sharded(d, u, mesh: Mesh, axis_name: str = "space") -> Sharded:
    """``ops.stencil.taylor_compose_step`` of D-sharded ``(…, 3, D, H, W)``
    fields (each shard at least 2 planes), differentiable in both."""
    return _per_row(taylor_compose_slabs, mesh, axis_name, d, u)


def taylor_squaring_sharded(field, mesh: Mesh, axis_name: str = "space") -> Sharded:
    """``ops.stencil.taylor_squaring_step`` of a D-sharded ``(…, 3, D, H,
    W)`` field (each shard at least 2 planes), differentiable."""
    return _per_row(taylor_squaring_slabs, mesh, axis_name, field)


class SplitComposeZHalo(torch.autograd.Function):
    """The split composition of a z-slab from its haloed operands ``d_h``,
    ``u_h`` ``(B, 3, D + 2, H, W)``: forward B1Z, backward B2Z plus the
    direct term's ``g`` (``kernels/split_warp.py``), the gradients on the
    haloed slab with the halo planes' shares unfolded."""

    @staticmethod
    def forward(ctx, d_h, u_h):
        ctx.save_for_backward(d_h, u_h)
        return _sw.split_compose_zhalo(d_h, u_h)

    @staticmethod
    def backward(ctx, g):
        d_h, u_h = ctx.saved_tensors
        return _sw.split_compose_zhalo_vjp(d_h, u_h, g.contiguous())


def split_compose_slabs(ds: list, u_hs: list) -> list:
    """One split composition ``d' = u + d ∘ (id+u)`` of one row's slabs:
    ``d`` exchanges a one-plane halo (the edge plane repeated at the
    volume's ends, which is the border replication of one device), then
    B1Z on each slab.  ``u_hs``: ``u``'s slabs with their halo, exchanged
    once by the caller for every composition that reuses ``u``."""
    return [SplitComposeZHalo.apply(d_h.contiguous(), u_h)
            for d_h, u_h in zip(_exchange_halo_d(ds, 1), u_hs)]


def split_compose_sharded(d, u, mesh: Mesh, axis_name: str = "space") -> Sharded:
    """``ops.stencil.split_compose_step`` of D-sharded ``(B, 3, D, H, W)``
    fields (B1Z/B2Z on the card), differentiable in both."""

    def run(ds, us):
        return split_compose_slabs(ds, [u_h.contiguous() for u_h in _exchange_halo_d(us, 1)])

    return _per_row(run, mesh, axis_name, d, u)


class BlockGatherWarpZHalo(torch.autograd.Function):
    """``ops.resample.BlockGatherWarp`` of a z-slab: forward B3Z on the
    slab's window ``vol_h (B, C, D + 2h, H, W)``, backward B4Z masked where
    ``|r_raw| > R``.  The block means are the slab's own, which are the
    volume's when the slab is a whole number of blocks.  The window is a
    constant (no cotangent)."""

    @staticmethod
    def forward(ctx, vol_h, disp_vox, max_disp, radius, block, h):
        m, r_raw = _residual(disp_vox, block, max_disp)
        r_c = torch.clamp(r_raw, -radius, radius).contiguous()
        ctx.block, ctx.radius, ctx.h = block, radius, h
        ctx.save_for_backward(vol_h, r_c, m, torch.abs(r_raw) <= radius)
        return _bw.block_warp_zhalo(vol_h, r_c, m, radius, h, block)

    @staticmethod
    def backward(ctx, g):
        vol_h, r_c, m, inside = ctx.saved_tensors
        g_r = _bw.block_warp_dgrad_zhalo(vol_h, r_c, m, g.contiguous(), ctx.radius, ctx.h,
                                         ctx.block)
        return None, torch.where(inside, g_r, torch.zeros_like(g_r)), None, None, None, None


def block_halo(max_disp: int, radius: int) -> int:
    """Planes of the moving volume's window on each side of a slab that
    every tap of the block-gather warp stays inside: the block means' bound,
    the residual's radius, and one for the upper tap."""
    return int(max_disp) + int(radius) + 1


def warp_block_gather_slabs(vol_hs: list, disps: list, max_disp: int, radius: int,
                            block: int, h: int) -> list:
    """``ops.resample.warp_block_gather`` of one row's slabs: ``vol_hs`` the
    slabs' windows of ``h >= block_halo(max_disp, radius)`` planes on each
    side (:func:`~.mesh.halo_images_spatial`), ``disps`` the displacement's
    slabs, each a whole number of blocks."""
    if h < block_halo(max_disp, radius):
        raise ValueError(f"a window of {h} planes does not hold the taps of bound {max_disp} "
                         f"and radius {radius}: it needs {block_halo(max_disp, radius)}")
    for d in disps:
        if d.shape[-3] % block:
            raise ValueError(f"a slab of {d.shape[-3]} planes is not a whole number of "
                             f"blocks of {block}")
    return [BlockGatherWarpZHalo.apply(v, d, max_disp, radius, block, h)
            for v, d in zip(vol_hs, disps)]


def sum_slabs(parts: list, device=None) -> torch.Tensor:
    """The sum of per-slab partial results on ``device`` (default: the
    first slab's), differentiable."""
    device = parts[0].device if device is None else device
    total = None
    for p in parts:
        p = p.to(device, non_blocking=True)
        total = p if total is None else total + p
    return total


def block_residual_overflow_slabs(disps: list, max_disp: int, radius: int,
                                  block: int) -> torch.Tensor:
    """``ops.resample.block_residual_overflow`` of one row's slabs, summed
    on the first slab's device."""
    return sum_slabs([block_residual_overflow(d, max_disp, radius, block) for d in disps])


def lag1_sums_slabs(xs: list) -> tuple:
    """The lag-1 product sums ``Σ x_p x_{p+e}`` over the voxels along W, H
    and D of one row's slabs of ``(…, D, H, W)``, summed on the first slab's
    device: along D each slab's own pairs and the pair across its upper
    boundary (the next shard's first plane)."""
    sx = sum_slabs([_lag1_sum(x, -1) for x in xs])
    sy = sum_slabs([_lag1_sum(x, -2) for x in xs])
    sz = sum_slabs([_lag1_sum(x if nxt is None else torch.cat([x, nxt], dim=-3), -3)
                    for x, nxt in zip(xs, _next_planes(xs))])
    return sx, sy, sz


def allgather_slabs(xs: list) -> list:
    """The whole field of one row's slabs (concatenated along D), one copy
    on each slab's device, differentiable: autograd sends each slab its
    share of every copy's gradient (``.to`` and ``cat``).  Unlike the halo
    exchange it does not cut the field's memory: every shard holds the
    whole field, as GSPMD's all-gather does for the JAX package's gather
    path (``SVF3D(use_gather=True)``)."""
    return [torch.cat([y.to(x.device, non_blocking=True) for y in xs], dim=-3) for x in xs]


@functools.lru_cache(maxsize=64)
def _omega2_rows(dims: tuple, h0: int, h1: int, device: torch.device) -> torch.Tensor:
    """``|ω|²`` over the 3D FFT grid of ``dims`` (angular frequency), rows
    ``[h0, h1)`` of H: ``(D, h1 - h0, W)``, made once per device."""
    ws = [torch.fft.fftfreq(n, device=device) * (2.0 * math.pi) for n in dims]
    wz, wy, wx = torch.meshgrid(ws[0], ws[1][h0:h1], ws[2], indexing="ij")
    return (wx ** 2 + wy ** 2 + wz ** 2).to(torch.float32)


def fourier_energy_slabs(xs: list, dims) -> torch.Tensor:
    """``RegLoss.energy`` with the ``Fourier1stDerivativeOperator`` of one
    row's slabs ``(B, C, D_loc, H, W)`` of a real field of ``dims``: ``y =
    Σ (F⁻¹(|ω| x̂))² = Σ_ω |ω|² |x̂|² / N`` per leading index (Parseval;
    ``|ω| x̂`` is Hermitian, so the inverse transform is real), on the first
    slab's device.  Each slab takes the 2D FFT over (H, W); an all-to-all
    re-cuts the spectrum along H (shard ``k`` gathers rows ``[h_k, h_k+1)``
    of every slab, concatenated along D); each shard takes the FFT along D
    of its rows and sums ``|ω|² |x̂|²`` over them.  No shard holds more than
    its share of the spectrum, and the energy is a scalar, so there is no
    inverse transform.  Differentiable (``torch.fft``, slices, ``.to`` and
    ``cat``)."""
    D, H, W = (int(n) for n in dims)
    n = len(xs)
    spectra = [torch.fft.fft2(x, dim=(-2, -1)) for x in xs]
    cuts = [k * H // n for k in range(n + 1)]
    parts = []
    for k, x in enumerate(xs):
        h0, h1 = cuts[k], cuts[k + 1]
        if h1 == h0:
            continue
        rows = torch.cat([s[..., h0:h1, :].to(x.device, non_blocking=True) for s in spectra],
                         dim=-3)
        f = torch.fft.fft(rows, dim=-3)
        p = (f.real ** 2 + f.imag ** 2) * _omega2_rows((D, H, W), h0, h1, x.device)
        parts.append(torch.sum(p, dim=tuple(range(1, p.ndim))))
    return sum_slabs(parts, xs[0].device) / float(D * H * W)


def _reduce_row(op, mesh: Mesh, axis_name: str, *fields):
    """``op(slabs, …)`` over the first row along ``axis_name`` (every row
    computes the same), on that row's first device."""
    sharded = [_slabs(f, mesh, axis_name) for f in fields]
    row = mesh.rows(axis_name)[0]
    return op(*([s[i] for i in row] for s in sharded))


def sum_sharded(field, mesh: Mesh, dims=(-3, -2, -1), axis_name: str = "space") -> torch.Tensor:
    """``torch.sum(field, dims)`` of a D-sharded field (``dims`` must hold
    D): per-slab partial sums added on the row's first device."""
    return _reduce_row(lambda xs: sum_slabs([torch.sum(x, dim=dims) for x in xs]),
                       mesh, axis_name, field)


def fourier_energy_sharded(field, mesh: Mesh, axis_name: str = "space") -> torch.Tensor:
    """:func:`fourier_energy_slabs` of a D-sharded ``(B, C, D, H, W)``
    field, on the row's first device."""
    def run(xs):
        D = sum(x.shape[-3] for x in xs)
        return fourier_energy_slabs(xs, (D,) + tuple(xs[0].shape[-2:]))

    return _reduce_row(run, mesh, axis_name, field)


def lag1_sums_sharded(field, mesh: Mesh, axis_name: str = "space") -> tuple:
    """:func:`lag1_sums_slabs` of a D-sharded field, on the row's first
    device (the VD factor's lag-1 autocorrelation sums)."""
    return _reduce_row(lag1_sums_slabs, mesh, axis_name, field)


def block_residual_overflow_sharded(disp_vox, max_disp: int, mesh: Mesh, radius: int = 2,
                                    block: int = 8, axis_name: str = "space") -> torch.Tensor:
    """``ops.resample.block_residual_overflow`` of a D-sharded ``(B, 3, D,
    H, W)`` displacement, on the row's first device."""
    return _reduce_row(lambda ds: block_residual_overflow_slabs(ds, max_disp, radius, block),
                       mesh, axis_name, disp_vox)


def warp_block_gather_sharded(vol, disp_vox, max_disp: int, mesh: Mesh, radius: int = 2,
                              block: int = 8, axis_name: str = "space") -> Sharded:
    """``ops.resample.warp_block_gather`` of a D-sharded displacement: the
    whole ``vol (B, C, D, H, W)`` (a constant) is placed once as each
    shard's window (:func:`~.mesh.halo_images_spatial`, ``h =
    block_halo(max_disp, radius)``), then B3Z (backward B4Z) on each slab.
    Each shard's slab must be a whole number of blocks."""
    h = block_halo(max_disp, radius)
    windows = halo_images_spatial({"vol": vol}, mesh, vol.shape[-3], h, axis_name)
    n = len(mesh.device_list)
    vols = Sharded([windows[i]["vol"] for i in range(n)], mesh,
                   [((vol.ndim - 3, axis_name),)])
    return _per_row(lambda vs, ds: warp_block_gather_slabs(vs, ds, max_disp, radius, block, h),
                    mesh, axis_name, vols, disp_vox)


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
