"""The likelihood's residual map, ``lcn(fixed) - lcn(warped)``: kernels L1
(forward) and L2 (backward), their plain versions, and the dispatch between
them.

CUDA source: ``csrc/lcn_residual.cu``.  ``lcn(x) = (x - mu) / sqrt(var +
1e-10)`` with ``mu = box(x) / n`` and ``var = box((x - mu)**2) / n``, the box
a sum over the ``(2r+1)**3`` window of a replicate-padded volume
(``ops.stencil.box_filter3d``) and ``n`` its size.  The kernels replace the
plain shift-and-add stencils of :func:`lcn_residual_plain` and autograd's
VJP of them: one launch each way in place of some 90.  The JAX package has
no Pallas kernel here; XLA fuses its stencils (``ir_sgmcmc_tpu/models/gmm.py``).

L1 rounds each operation on its own in the plain version's order, so it
equals :func:`lcn_residual_plain` bit for bit.  L2 computes, from the
cotangent ``g`` and the moving side's ``dm = warped - mu`` and ``s =
sqrt(var + 1e-10)`` that L1 saves,

    A = ((g·((dm/s)/s)) / (2s)) / n,    a = (-g)/s + boxᵀ(A)·(2dm),
    ḡ = a + boxᵀ((-a) / n),

in autograd's order of every add (:func:`lcn_residual_vjp_plain` spells it
out; on the CPU it equals autograd of the plain forward bit for bit).
Through :class:`LCNResidual` the fixed image is data: no gradient flows to
it.

``warped`` is ``(…, D, H, W)``; ``fixed`` has its shape (one image per row)
or holds one ``(D, H, W)`` image that every row shares.  A CPU or bfloat16
tensor, or a radius without a kernel, takes the plain versions; a float32
CUDA tensor takes the kernels, and a launch or build failure raises — there
is no fallback between the two.
"""

from __future__ import annotations

import math

import torch

from ..ops.stencil import box_filter3d
from ._lib import Kernel, ptr

# the radii the kernels are built for (template instances of csrc/lcn_residual.cu)
RADII = (1, 2)

# Work per voxel of the moving volume, as a main operand (N, C, D, H, W) with
# C the fixed images per row: 1, or 1/N where the N rows share one.  L1 reads
# fixed and warped and writes the residual, dm and s (16 + 4C bytes); per
# image two boxes of 6 adds at radius 1, 2 scalings, x - mu, its square, the
# epsilon, the root and the quotient (19), and the residual's difference: 20
# + 19C.  L2 reads g, dm and s and writes ḡ (16 bytes); A 6 (two quotients, a
# product, 2s, a quotient, the scaling), a 4 ((-g)/s, 2dm, a product, the
# add), -a/n 2, two adjoint boxes of 6 adds and their edge folds, the last
# add into a: 26.
L1 = Kernel("lcn_residual_fwd", "ir_sgmcmc_tpu_torch/csrc/lcn_residual.cu",
            "ir_sgmcmc_tpu_torch/kernels/lcn_residual.py:lcn_residual_plain",
            bytes_per_voxel=lambda C: 16 + 4 * C, flops_per_voxel=lambda C: 20 + 19 * C)
L2 = Kernel("lcn_residual_bwd", "ir_sgmcmc_tpu_torch/csrc/lcn_residual.cu",
            "ir_sgmcmc_tpu_torch/kernels/lcn_residual.py:lcn_residual_vjp_plain",
            bytes_per_voxel=lambda C: 16, flops_per_voxel=lambda C: 26)


# ---- plain versions ------------------------------------------------------------

def _window(radius: int) -> float:
    return float((2 * radius + 1) ** 3)


def lcn_parts(im: torch.Tensor, radius: int, box=box_filter3d) -> tuple:
    """``(im - mu, sqrt(var + 1e-10))`` of the local contrast normalisation
    ``lcn(im) = (im - mu) / sqrt(var + 1e-10)``, ``box(x, radius)`` the
    window sum (the spatially sharded steps' sums over slabs by halo
    exchange)."""
    window = _window(radius)
    mu = box(im, radius) / window
    var = box((im - mu) ** 2, radius) / window
    return im - mu, torch.sqrt(var + 1e-10)


def _lcn(im: torch.Tensor, radius: int, box=box_filter3d) -> torch.Tensor:
    dm, s = lcn_parts(im, radius, box)
    return dm / s


def lcn_residual_plain(fixed: torch.Tensor, warped: torch.Tensor, radius: int) -> torch.Tensor:
    """Local-contrast-normalised residual ``lcn(fixed) - lcn(warped)``, plain
    stencils (the CPU path, and L1's oracle)."""
    return _lcn(fixed, radius) - _lcn(warped, radius)


def _box_adjoint_axis(G: torch.Tensor, axis: int, radius: int, acc=None) -> torch.Tensor:
    """Autograd's VJP of ``ops.stencil.conv1d_axis`` with unit taps, in its
    order of adds: each tap's slice of the replicate-padded buffer (zero
    elsewhere) summed into the buffer in turn, then the buffer's middle,
    added to ``acc`` where given, then the high pad's sum folded back onto
    the last plane, then the low pad's onto the first."""
    n, r = G.shape[axis], radius
    zeros = torch.zeros_like(G.narrow(axis, 0, 1)).expand(
        *[2 * r if a == axis % G.ndim else s for a, s in enumerate(G.shape)])
    Gz = torch.cat([zeros, G, zeros], dim=axis)
    padded = Gz.narrow(axis, 0, n + 2 * r)
    for k in range(1, 2 * r + 1):
        padded = padded + Gz.narrow(axis, k, n + 2 * r)
    mid = padded.narrow(axis, r, n)
    out = mid if acc is None else acc + mid
    for start, plane in ((n + r, n - 1), (0, 0)):  # the high pad, then the low
        pad = padded.narrow(axis, start, r).sum(dim=axis, keepdim=True)
        fold = torch.zeros_like(G)
        fold.narrow(axis, plane, 1).copy_(pad)
        out = out + fold
    return out


def _box_adjoint(G: torch.Tensor, radius: int, acc=None) -> torch.Tensor:
    """``box_filter3d``'s VJP: along W, then H, then D (the forward's
    reverse), ``acc`` added before the last axis' pads."""
    G = _box_adjoint_axis(G, -1, radius)
    G = _box_adjoint_axis(G, -2, radius)
    return _box_adjoint_axis(G, -3, radius, acc)


def lcn_residual_vjp_plain(dm: torch.Tensor, s: torch.Tensor, g: torch.Tensor,
                           radius: int) -> torch.Tensor:
    """The VJP of :func:`lcn_residual_plain` with respect to ``warped`` for
    the cotangent ``g``, from the moving side's :func:`lcn_parts` ``(dm,
    s)``: each operation of autograd's backward through the plain forward,
    in its order (L2's oracle)."""
    window = _window(radius)
    g_lcn = -g                               # through the residual's difference
    g_dm2 = g_lcn / s                        # through dm / s, to dm ...
    g_s = -g_lcn * ((dm / s) / s)            # ... and to s
    A = (g_s / (2 * s)) / window             # through the root and var = box / n
    g_dm = _box_adjoint(A, radius) * (2.0 * dm)  # through the box and the square
    a = g_dm2 + g_dm                         # dm's two uses, into warped first
    return _box_adjoint((-a) / window, radius, acc=a)  # through mu = box(warped) / n


# ---- CUDA wrappers -------------------------------------------------------------

def _geometry(fixed: torch.Tensor, warped: torch.Tensor, radius: int) -> tuple:
    """``(N, D, H, W, fixed_shared, out_shape)``: the shapes and radius
    first, then float32 operands on one card."""
    if warped.ndim < 3 or fixed.ndim < 3 or fixed.shape[-3:] != warped.shape[-3:]:
        raise ValueError(f"fixed {tuple(fixed.shape)} and warped {tuple(warped.shape)}: "
                         "expected volumes (…, D, H, W) of one size")
    D, H, W = warped.shape[-3:]
    shared = fixed.numel() == D * H * W
    if not shared and fixed.shape != warped.shape:
        raise ValueError(f"fixed {tuple(fixed.shape)}: expected warped's shape "
                         f"{tuple(warped.shape)} or one (D, H, W) image")
    if radius not in RADII:
        raise ValueError(f"radius {radius}: the kernels are built for {RADII}")
    for name, t in (("fixed", fixed), ("warped", warped)):
        if not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if fixed.device != warped.device:
        raise ValueError(f"fixed on {fixed.device}, warped on {warped.device}")
    # the broadcast shape: a shared image's extra leading axes are all 1
    # (torch.broadcast_shapes would import sympy at its first call: seconds)
    lead = fixed.ndim - warped.ndim
    out_shape = tuple(fixed.shape[:max(lead, 0)]) + tuple(warped.shape)
    return math.prod(out_shape) // (D * H * W), D, H, W, shared, out_shape


def lcn_residual_fwd_cuda(fixed: torch.Tensor, warped: torch.Tensor, radius: int,
                          stats: bool = True) -> tuple:
    """L1: ``(res, dm, s)``, the residual map and the moving side's
    :func:`lcn_parts` (``None`` each where ``stats`` is False)."""
    N, D, H, W, shared, out_shape = _geometry(fixed, warped, radius)
    fixed, warped = fixed.contiguous(), warped.contiguous()
    res = torch.empty(out_shape, dtype=torch.float32, device=warped.device)
    dm = torch.empty_like(res) if stats else None
    s = torch.empty_like(res) if stats else None
    L1.launch(warped.device, ptr(fixed), ptr(warped), ptr(res),
              *(None if t is None else ptr(t) for t in (dm, s)),  # None: a null pointer
              N, D, H, W, int(shared), int(radius))
    return res, dm, s


def lcn_residual_bwd_cuda(dm: torch.Tensor, s: torch.Tensor, g: torch.Tensor,
                          radius: int) -> torch.Tensor:
    """L2: the VJP with respect to ``warped`` from L1's ``dm`` and ``s``."""
    N, D, H, W, _, _ = _geometry(dm, dm, radius)
    for name, t in (("s", s), ("g", g)):
        if t.shape != dm.shape or t.dtype != dm.dtype or t.device != dm.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on {t.device}, expected "
                             f"dm's {tuple(dm.shape)} {dm.dtype} on {dm.device}")
    dm, s, g = dm.contiguous(), s.contiguous(), g.contiguous()
    gw = torch.empty_like(dm)
    L2.launch(dm.device, ptr(g), ptr(dm), ptr(s), ptr(gw), N, D, H, W, int(radius))
    return gw


# ---- dispatch ------------------------------------------------------------------

def on_kernels(fixed: torch.Tensor, warped: torch.Tensor, radius: int) -> bool:
    """Whether the residual map runs L1/L2: float32 operands on the card at a
    built radius (bfloat16 keeps the plain stencils on the card too)."""
    return (warped.is_cuda and warped.dtype == torch.float32 and fixed.dtype == torch.float32
            and radius in RADII)


class LCNResidual(torch.autograd.Function):
    """``lcn(fixed) - lcn(warped)`` saving only the moving side's ``dm`` and
    ``s``; L1/L2 on float32 CUDA operands, the plain versions elsewhere.
    ``fixed`` is data and may not require a gradient."""

    @staticmethod
    def forward(ctx, fixed, warped, radius):
        if fixed.requires_grad:
            raise ValueError("fixed: the residual map takes no gradient to the fixed image")
        ctx.radius = radius
        if on_kernels(fixed, warped, radius):
            res, dm, s = lcn_residual_fwd_cuda(fixed, warped, radius,
                                               stats=ctx.needs_input_grad[1])
        else:
            dm, s = lcn_parts(warped, radius)
            res = _lcn(fixed, radius) - dm / s
        ctx.save_for_backward(dm, s)
        return res

    @staticmethod
    def backward(ctx, g):
        dm, s = ctx.saved_tensors
        if on_kernels(dm, dm, ctx.radius):
            return None, lcn_residual_bwd_cuda(dm, s, g, ctx.radius), None
        return None, lcn_residual_vjp_plain(dm, s, g, ctx.radius), None


def lcn_residual(fixed: torch.Tensor, warped: torch.Tensor, radius: int) -> torch.Tensor:
    """The residual map: :class:`LCNResidual` on the kernels' operands, the
    plain stencils (and autograd through them) elsewhere."""
    if on_kernels(fixed, warped, radius):
        return LCNResidual.apply(fixed, warped, radius)
    return lcn_residual_plain(fixed, warped, radius)
