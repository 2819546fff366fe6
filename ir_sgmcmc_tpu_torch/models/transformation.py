"""Transformation models: SVF (scaling and squaring), B-spline FFD, SVFFD
(port of ``ir_sgmcmc_tpu/models/transformation.py``).

``SVF3D.integrate`` runs scaling and squaring: ``no_taylor`` second-order
Taylor squarings (plain stencils), the squarings above ``taylor_threshold``
as ``d + warp_bounded(d, d, 1)`` (kernels B5-B7), then ``2^e - 1``
compositions in the ``"split"`` form (kernels B1/B2) or the ``"warp"`` form
(B5-B7).  With an image, the image rides the composition phase as radius-1
blend warps (the ``"pre"`` noise scheme's cascade).  See the JAX class for
the integration plan and its measurements.  ``use_gather=True`` selects
the reference formulation instead: ``no_steps`` squarings through
``grid_sample``.

``BSplineFFD3D`` spreads control points into a dense displacement;
``SVFFD3D`` spreads them into a dense velocity and integrates it with
``SVF3D``.  ``SVF2D`` is the 2D gather-based SVF.
"""

from __future__ import annotations

import math

import torch

from .._device import resolve_device
from ..ops.bspline import CubicBSplineFFD3D, control_grid_size
from ..ops.grids import identity_grid, normalised_to_voxel, voxel_to_normalised
from ..ops.resample import grid_sample, grid_sample_each, warp_bounded
from ..ops.stencil import split_compose_step, taylor_squaring_step


class SVF3D:
    """Stationary velocity field ``v (B, 3, D, H, W)`` in voxel units.

    Returns ``(transformation, displacement)``: the transformation in
    normalised coordinates, the displacement in voxels.  The constructor's
    plan (``e``, ``no_taylor``, the clamp bounds read by the saturation
    guard) is the JAX one, line for line.
    """

    def __init__(self, dims, no_steps: int = 12, max_disp: int = 8,
                 use_gather: bool = False, taylor_threshold: float = 0.5,
                 taylor_compositions: bool | str | None = None):
        self.dims = tuple(int(d) for d in dims)
        self.no_steps = int(no_steps)
        self.max_disp = int(max_disp)
        self.use_gather = bool(use_gather)
        self.taylor_threshold = float(taylor_threshold)
        if taylor_compositions is None:
            form = "split"
        elif taylor_compositions is False:
            form = "warp"
        elif taylor_compositions is True:
            form = "taylor"
        else:
            form = str(taylor_compositions)
        if form not in ("warp", "taylor", "split"):
            raise ValueError(
                f"taylor_compositions must be one of False/'warp', "
                f"True/'taylor', 'split'; got {taylor_compositions!r}")
        bound = (min(self.taylor_threshold, 1.0)
                 if form == "taylor" and self.taylor_threshold > 0 else 1.0)
        e = 0
        if self.max_disp > bound:
            ratio = int(math.ceil(self.max_disp / bound - 1e-9))
            e = (ratio - 1).bit_length()
        if form == "taylor" and (e > self.no_steps or self.taylor_threshold <= 0):
            form = "warp"
            e = min(self.no_steps, max(0, (self.max_disp - 1).bit_length()))
        e = min(self.no_steps, e)
        self.composition_form = form
        self.taylor_compositions = form == "taylor"
        self.no_squarings = self.no_steps - e
        self.no_compositions = 2 ** e
        e_img = min(self.no_steps, max(0, (self.max_disp - 1).bit_length()))
        self.no_image_compositions = 2 ** min(e, e_img)
        self.displacement_clamp_bound = (float("inf") if form == "taylor"
                                         else float(self.no_compositions))
        self.image_clamp_bound = float(self.no_image_compositions)
        self.no_taylor = sum(
            1 for k in range(self.no_squarings)
            if self.max_disp / 2 ** (self.no_steps - k) <= self.taylor_threshold
        )
        if form == "taylor":
            raise NotImplementedError(
                "taylor_compositions='taylor' is not ported (ROADMAP rule "
                "'Not ported'); use 'split' or 'warp'")

    def __call__(self, v: torch.Tensor):
        transformation, disp, _ = self.integrate(v)
        return transformation, disp

    def integrate(self, v: torch.Tensor, im: torch.Tensor | None = None,
                  per_row: bool = False):
        """Integrate ``v (B, 3, D, H, W)``; optionally warp ``im`` by the
        transformation.

        Returns ``(transformation, displacement, im_warped)``.  ``im`` is
        ``(D, H, W)`` or ``(C, D, H, W)``, shared by the batch, or with
        ``per_row`` ``(B, C, D, H, W)``, one per row; the warped image is
        ``(B, D, H, W)`` or ``(B, C, D, H, W)``.  In the ``"split"``
        form the image takes one radius-1 warp by ``ψ = φ^m`` every
        ``m = N // K`` split steps (``K = no_image_compositions``); in the
        ``"warp"`` form it rides the compositions as the last channel(s) of
        one fused ``[d | g]`` carry.  With ``use_gather`` the image is
        warped once by ``grid_sample`` at the transformation, and without an
        image ``im_warped`` is None.
        """
        if per_row and im is not None and im.ndim != 5:
            raise ValueError(f"per-row images are (B, C, D, H, W), got {tuple(im.shape)}")
        if self.use_gather:
            transformation, disp = self._call_gather(v)
            if im is None:
                warped = None
            elif per_row:
                warped = grid_sample_each(im, transformation)
            else:
                warped = grid_sample(im, transformation)
            return transformation, disp, warped
        disp = v / float(2 ** self.no_steps)
        for _ in range(self.no_taylor):
            disp = taylor_squaring_step(disp)
        for _ in range(self.no_squarings - self.no_taylor):
            disp = disp + warp_bounded(disp, disp, 1)
        u_phi = disp.contiguous()
        N = self.no_compositions

        if self.composition_form == "split":
            def dstep(d):
                return split_compose_step(d.contiguous(), u_phi)
        else:
            def dstep(d):
                return u_phi + warp_bounded(d, u_phi, 1)

        g = None
        if im is None:
            for _ in range(N - 1):
                disp = dstep(disp)
        else:
            if per_row:
                vol = im
            else:
                vol = im if im.ndim == 4 else im[None]
                vol = vol.expand((v.shape[0],) + tuple(vol.shape))
            if self.composition_form == "split":
                K = self.no_image_compositions
                m = N // K
                u_psi = u_phi
                for _ in range(m - 1):
                    u_psi = dstep(u_psi)
                disp = u_psi
                g = warp_bounded(vol, u_psi, 1)
                for _ in range(K - 1):
                    for _ in range(m):
                        disp = dstep(disp)
                    g = warp_bounded(g, u_psi, 1)
            else:
                g = warp_bounded(vol, u_phi, 1)  # g_1 = im ∘ φ
                if N > 1:
                    # one fused 4-channel warp and one add per step
                    u_phi_g = torch.cat([u_phi, torch.zeros_like(g)], dim=1)
                    state = torch.cat([u_phi, g], dim=1)
                    for _ in range(N - 1):
                        state = warp_bounded(state, u_phi, 1) + u_phi_g
                    disp, g = state[:, :3], state[:, 3:]
            if not per_row and im.ndim == 3:
                g = g[:, 0]
        transformation = identity_grid(self.dims, device=v.device) + voxel_to_normalised(disp)
        return transformation, disp, g

    def _call_gather(self, v: torch.Tensor):
        """The reference formulation: ``no_steps`` squarings
        ``d <- d + d(id + d)`` in normalised units, each through
        ``grid_sample``."""
        id_grid = identity_grid(self.dims, device=v.device)
        disp = voxel_to_normalised(v) / float(2 ** self.no_steps)
        for _ in range(self.no_steps):
            disp = disp + grid_sample_each(disp, id_grid + disp)
        return id_grid + disp, normalised_to_voxel(disp)


class SVF2D:
    """2D stationary velocity field, integrated by ``no_steps`` squarings
    through a bilinear ``grid_sample`` (the reference's ``SVF_2D``).

    ``v`` is ``(…, 2, H, W)`` in voxel units, channel 0 = x; returns
    ``(transformation, displacement)``, normalised and in voxels.
    """

    def __init__(self, dims, no_steps: int = 12):
        self.dims = tuple(int(d) for d in dims)  # (H, W)
        self.no_steps = int(no_steps)

    def _scale(self, device, to_normalised: bool) -> torch.Tensor:
        H, W = self.dims
        sizes = torch.tensor([W, H], dtype=torch.float32, device=device)
        s = 2.0 / (sizes - 1.0) if to_normalised else (sizes - 1.0) / 2.0
        return s.reshape(2, 1, 1)

    def id_grid(self, device=None) -> torch.Tensor:
        """``(2, H, W)`` normalised identity, on ``device`` (default: the
        CUDA card)."""
        H, W = self.dims
        device = resolve_device(device)
        y = torch.linspace(-1.0, 1.0, H, device=device)
        x = torch.linspace(-1.0, 1.0, W, device=device)
        yy, xx = torch.meshgrid(y, x, indexing="ij")
        return torch.stack([xx, yy], dim=0)

    def __call__(self, v: torch.Tensor):
        squeeze = v.ndim == 3
        vb = v[None] if squeeze else v.reshape((-1,) + tuple(v.shape[-3:]))
        id_grid = self.id_grid(v.device)
        disp = vb * self._scale(v.device, True) / float(2 ** self.no_steps)
        for _ in range(self.no_steps):
            disp = disp + grid_sample_each(disp, id_grid + disp)
        transformation = id_grid + disp
        disp = disp * self._scale(v.device, False)
        if squeeze:
            return transformation[0], disp[0]
        return (transformation.reshape(v.shape), disp.reshape(v.shape))


class BSplineFFD3D:
    """Cubic B-spline FFD as a *displacement* model: ``__call__`` spreads the
    control points ``(…, 3, cD, cH, cW)`` into a voxel-unit displacement and
    returns ``(transformation, displacement)``; :meth:`dense_velocity`
    gives the spread field alone (SVFFD integrates it).  No integration."""

    def __init__(self, dims, cps):
        self.dims = tuple(int(d) for d in dims)
        self.cps = tuple(int(c) for c in cps)
        self.control_dims = control_grid_size(self.dims, self.cps)
        self._ffd = CubicBSplineFFD3D(self.dims, self.cps)

    def dense_velocity(self, cp: torch.Tensor) -> torch.Tensor:
        return self._ffd(cp)

    def __call__(self, cp: torch.Tensor):
        disp = self._ffd(cp)
        transformation = identity_grid(self.dims, device=cp.device) + voxel_to_normalised(disp)
        return transformation, disp


class SVFFD3D:
    """B-spline-parameterised SVF: spread the control points into a dense
    velocity, then integrate it with :class:`SVF3D` (the same kernels as
    the dense model)."""

    def __init__(self, dims, cps, no_steps: int = 12, max_disp: int = 8,
                 use_gather: bool = False, taylor_threshold: float = 0.5,
                 taylor_compositions: bool | str | None = None):
        self.dims = tuple(int(d) for d in dims)
        self.cps = tuple(int(c) for c in cps)
        self.ffd = BSplineFFD3D(dims, cps)
        self.svf = SVF3D(dims, no_steps, max_disp=max_disp, use_gather=use_gather,
                         taylor_threshold=taylor_threshold,
                         taylor_compositions=taylor_compositions)
        self.max_disp = self.svf.max_disp
        self.displacement_clamp_bound = self.svf.displacement_clamp_bound
        self.image_clamp_bound = self.svf.image_clamp_bound
        self.use_gather = self.svf.use_gather
        self.control_dims = self.ffd.control_dims

    def __call__(self, cp: torch.Tensor):
        return self.svf(self.ffd.dense_velocity(cp))

    def integrate(self, cp: torch.Tensor, im: torch.Tensor | None = None,
                  per_row: bool = False):
        return self.svf.integrate(self.ffd.dense_velocity(cp), im, per_row)


def make_transformation(kind: str, dims, cps=None, no_steps: int = 12, max_disp: int = 8,
                        use_gather: bool = False, taylor_threshold: float = 0.5,
                        unroll: int | bool | None = None,
                        taylor_compositions: bool | str | None = None,
                        compute_dtype: str | None = None):
    """Config-layer factory with the JAX one's arguments.

    ``unroll`` is the JAX package's scan unroll factor; the port's
    integration is a Python loop, so it has no effect here.  The JAX
    package resolves ``compute_dtype=None`` to float32 off a TPU, and the
    port computes in float32; ``"bfloat16"`` raises (ROADMAP rule: bf16 only
    once it is measured on the H100).  What is not ported raises
    ``NotImplementedError`` naming its ROADMAP item.
    """
    if compute_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(
            f"compute_dtype must be None (auto: bfloat16 on TPU), "
            f"'float32' or 'bfloat16'; got {compute_dtype!r}")
    if compute_dtype == "bfloat16":
        raise NotImplementedError(
            "compute_dtype='bfloat16' is not ported: the port computes in "
            "float32, and bf16 comes only once measured on the H100 (ROADMAP "
            "'Rules of the port', Precision)")
    if kind in ("SVF_3D", "SVF3D"):
        return SVF3D(dims, no_steps, max_disp=max_disp, use_gather=use_gather,
                     taylor_threshold=taylor_threshold,
                     taylor_compositions=taylor_compositions)
    if kind in ("SVF_2D", "SVF2D"):
        return SVF2D(dims, no_steps)
    if kind in ("SVFFD_3D", "SVFFD3D"):
        if cps is None:
            raise ValueError("SVFFD requires a control point spacing (cps)")
        return SVFFD3D(dims, cps, no_steps, max_disp=max_disp, use_gather=use_gather,
                       taylor_threshold=taylor_threshold,
                       taylor_compositions=taylor_compositions)
    if kind in ("Cubic_B_spline_FFD_3D", "BSplineFFD3D"):
        if cps is None:
            raise ValueError("a B-spline FFD requires a control point spacing (cps)")
        return BSplineFFD3D(dims, cps)
    raise ValueError(f"unknown transformation model: {kind}")
