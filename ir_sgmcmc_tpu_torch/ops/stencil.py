"""Stencil operators (port of ``ir_sgmcmc_tpu/ops/stencil.py``).

Every stencil is shift-and-add over replicate-padded tensors, never
``conv3d``: no cuDNN path, so no TF32 rounding can enter.  Fields are
``(…, 3, D, H, W)`` with any number of leading (chain) axes.
"""

from __future__ import annotations

import torch


def _replicate_pad_axis(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    n = x.shape[axis]
    parts = []
    if lo:
        parts.append(x.narrow(axis, 0, 1).expand(*_rep_shape(x, axis, lo)))
    parts.append(x)
    if hi:
        parts.append(x.narrow(axis, n - 1, 1).expand(*_rep_shape(x, axis, hi)))
    return torch.cat(parts, dim=axis) if len(parts) > 1 else x


def _rep_shape(x: torch.Tensor, axis: int, k: int):
    s = list(x.shape)
    s[axis] = k
    return s


def conv1d_axis(x: torch.Tensor, kernel: torch.Tensor, axis: int) -> torch.Tensor:
    """Correlate ``x`` with an odd 1D ``kernel`` along ``axis`` (replicate pad)."""
    taps = int(kernel.shape[0])
    if taps % 2 != 1:
        raise ValueError("kernel length must be odd")
    k = kernel.to(dtype=x.dtype, device=x.device)
    r = taps // 2
    xp = _replicate_pad_axis(x, axis, r, r)
    n = x.shape[axis]
    out = None
    for j in range(taps):
        term = k[j] * xp.narrow(axis, j, n)
        out = term if out is None else out + term
    return out


def separable_conv3d(field: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The same odd 1D kernel along D, H and W."""
    out = field
    for axis in (-3, -2, -1):
        out = conv1d_axis(out, kernel, axis)
    return out


def box_filter3d(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Sum over a cubic ``(2r+1)^3`` window with replicate padding."""
    ones = torch.ones((2 * radius + 1,), dtype=x.dtype, device=x.device)
    return separable_conv3d(x, ones)


def _fwd_diff_axis(field: torch.Tensor, axis: int) -> torch.Tensor:
    """Forward difference with the trailing edge replicated."""
    n = field.shape[axis]
    d = field.narrow(axis, 1, n - 1) - field.narrow(axis, 0, n - 1)
    return _replicate_pad_axis(d, axis, 0, 1)


def _fwd_diff_axis_t(y: torch.Tensor, axis: int) -> torch.Tensor:
    """Transpose of :func:`_fwd_diff_axis`.

    ``D x = [x1-x0, …, x_{n-1}-x_{n-2}, x_{n-1}-x_{n-2}]``, so
    ``(Dᵀy)_j = y_{j-1}[j≥1] - y_j[j≤n-2]``, plus ``±y_{n-1}`` on the last
    two entries from the replicated trailing difference.
    """
    n = y.shape[axis]
    body = y.narrow(axis, 0, n - 1)
    zero = torch.zeros_like(y.narrow(axis, 0, 1))
    out = torch.cat([zero, body], dim=axis) - torch.cat([body, zero], dim=axis)
    last = y.narrow(axis, n - 1, 1)
    fold = torch.cat([torch.zeros_like(y.narrow(axis, 0, n - 2)), -last, last],
                     dim=axis)
    return out + fold


def gradient(field: torch.Tensor, *, normalised_spacing: bool = False) -> torch.Tensor:
    """Forward-difference Jacobian ``(…, 3, 3, D, H, W)`` of a vector field;
    ``[c, d]`` is ∂field_c/∂x_d with d = 0,1,2 ↔ x, y, z."""
    D, H, W = field.shape[-3:]
    d_dx = _fwd_diff_axis(field, -1)
    d_dy = _fwd_diff_axis(field, -2)
    d_dz = _fwd_diff_axis(field, -3)
    if normalised_spacing:
        d_dx = d_dx * ((W - 1) / 2.0)
        d_dy = d_dy * ((H - 1) / 2.0)
        d_dz = d_dz * ((D - 1) / 2.0)
    return torch.stack([d_dx, d_dy, d_dz], dim=field.ndim - 3)


def reg_energy(field: torch.Tensor) -> torch.Tensor:
    """``y = sum ||∇v||²`` per leading batch element (scalar for ``(3,D,H,W)``)."""
    jac = gradient(field)
    if field.ndim == 4:
        return torch.sum(jac * jac)
    return torch.sum(jac * jac, dim=tuple(range(1, jac.ndim)))


# ---- Taylor squaring --------------------------------------------------------

_AXES = ((0, -1), (1, -2), (2, -3))  # (channel, axis it displaces along)


def _taylor_squaring_impl(d: torch.Tensor) -> torch.Tensor:
    out = 2.0 * d
    for c, axis in _AXES:
        out = out + _fwd_diff_axis(d, axis) * d[..., c:c + 1, :, :, :]
    return out


class TaylorSquaringStep(torch.autograd.Function):
    """``d' = 2d + (d·∇)d`` with the Jacobian-free backward of the JAX
    ``taylor_squaring_step``: only ``d`` is saved, and the backward rebuilds
    the three directional differences

        ḡ = 2g + Σ_a [ e_a Σ_i g_i (D_a d)_i  +  D_aᵀ(g · d_a) ].
    """

    @staticmethod
    def forward(ctx, d):
        ctx.save_for_backward(d)
        return _taylor_squaring_impl(d)

    @staticmethod
    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        gd = 2.0 * g
        for c, axis in _AXES:
            diff = _fwd_diff_axis(d, axis)
            gd[..., c, :, :, :] += torch.sum(g * diff, dim=-4)
            gd = gd + _fwd_diff_axis_t(g * d[..., c:c + 1, :, :, :], axis)
        return gd


def taylor_squaring_step(d: torch.Tensor) -> torch.Tensor:
    """One second-order scaling-and-squaring step (see the JAX docstring)."""
    return TaylorSquaringStep.apply(d)


# ---- split composition -------------------------------------------------------

def _shift_axis(field: torch.Tensor, off: int, axis: int) -> torch.Tensor:
    """``field(p + off·e_axis)`` with the border replicated (off = ±1)."""
    n = field.shape[axis]
    if off > 0:
        return _replicate_pad_axis(field.narrow(axis, 1, n - 1), axis, 0, 1)
    return _replicate_pad_axis(field.narrow(axis, 0, n - 1), axis, 1, 0)


def _axis_lerp(d: torch.Tensor, u_c: torch.Tensor, axis: int) -> torch.Tensor:
    # convex 2-tap lerp d(p + u_c·e_axis) for |u_c| <= 1
    up = torch.clamp(u_c, min=0.0).unsqueeze(-4)
    un = torch.clamp(u_c, max=0.0).unsqueeze(-4)
    return (d + up * (_shift_axis(d, +1, axis) - d)
              - un * (_shift_axis(d, -1, axis) - d))


def _split_warp_impl(d: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    out = d
    for c, axis in _AXES:
        out = _axis_lerp(out, u[..., c, :, :, :], axis)
    return out


def _split_compose_impl(d: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain split step ``d' = u + L_z(L_y(L_x(d; ũx); ũy); ũz)``,
    ``ũ = clip(u, ±1)``: the reference for kernels B1/B2."""
    return u + _split_warp_impl(d, torch.clamp(u, -1.0, 1.0))


class SplitComposeStep(torch.autograd.Function):
    """Forward B1, backward B2 plus ``g`` (the direct ``+u`` term).

    CPU tensors run the plain step and its autograd VJP; CUDA tensors run
    the kernels (``kernels/split_warp.py``) and never the plain path.
    """

    @staticmethod
    def forward(ctx, d, u):
        from ..kernels import split_warp

        ctx.save_for_backward(d, u)
        return split_warp.split_compose(d, u)

    @staticmethod
    def backward(ctx, g):
        from ..kernels import split_warp

        d, u = ctx.saved_tensors
        return split_warp.split_compose_vjp(d, u, g.contiguous())


def split_compose_step(d: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One composition ``d' = u + d ∘ (id+u)`` by dimensional splitting.
    ``d (B, C, D, H, W)``, ``u (B, 3, D, H, W)``."""
    return SplitComposeStep.apply(d, u)
