"""SVF transformation model, split-composition path (port of
``ir_sgmcmc_tpu/models/transformation.py``).

``SVF3D.integrate`` runs the main path's scaling and squaring: ``no_taylor``
second-order Taylor squarings (plain stencils), then ``2^e - 1`` one-sided
split compositions (kernels B1/B2 on the card).  See the JAX class for the
integration plan and its measurements.
"""

from __future__ import annotations

import math

import torch

from ..ops.grids import identity_grid, voxel_to_normalised
from ..ops.stencil import split_compose_step, taylor_squaring_step


class SVF3D:
    """Stationary velocity field ``v (…, 3, D, H, W)`` in voxel units.

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
        # paths of the JAX model the port does not have yet (ROADMAP A12)
        if self.use_gather:
            raise NotImplementedError(
                "SVF3D(use_gather=True) is not ported yet (ROADMAP A12)")
        if form != "split":
            raise NotImplementedError(
                f"taylor_compositions={form!r} needs the bounded blend warp "
                "(kernels B5-B7, ROADMAP A12); only 'split' is ported")
        if self.no_squarings != self.no_taylor:
            raise NotImplementedError(
                "squarings above taylor_threshold need the bounded blend warp "
                "(kernels B5-B7, ROADMAP A12)")

    def __call__(self, v: torch.Tensor):
        transformation, disp, _ = self.integrate(v)
        return transformation, disp

    def integrate(self, v: torch.Tensor, im: torch.Tensor | None = None):
        """``(transformation, displacement, None)``; ``im`` must be None
        (the image cascade of the 'pre' noise scheme is ROADMAP A12)."""
        if im is not None:
            raise NotImplementedError(
                "integrate(im=...) (the 'pre' noise scheme's image cascade) "
                "needs the bounded blend warp (ROADMAP A12)")
        disp = v / float(2 ** self.no_steps)
        for _ in range(self.no_taylor):
            disp = taylor_squaring_step(disp)
        u_phi = disp.contiguous()
        for _ in range(self.no_compositions - 1):
            disp = split_compose_step(disp.contiguous(), u_phi)
        transformation = identity_grid(self.dims, device=v.device) + voxel_to_normalised(disp)
        return transformation, disp, None


def make_transformation(kind: str, dims, no_steps: int = 12, max_disp: int = 8,
                        use_gather: bool = False, taylor_threshold: float = 0.5,
                        taylor_compositions: bool | str | None = None):
    """Config-layer factory; only ``SVF_3D`` is ported (ROADMAP A11-A12)."""
    if kind in ("SVF_3D", "SVF3D"):
        return SVF3D(dims, no_steps, max_disp=max_disp, use_gather=use_gather,
                     taylor_threshold=taylor_threshold,
                     taylor_compositions=taylor_compositions)
    raise NotImplementedError(f"transformation {kind!r} is not ported yet "
                              "(ROADMAP A11-A12)")
