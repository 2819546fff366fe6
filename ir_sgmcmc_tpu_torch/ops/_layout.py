"""The field operations the forward chain, the likelihood and the
regulariser are written in (``SVF3D.integrate``, ``engine.vi``, ``GMM``,
``RegLoss.energy``, the entropy), as one device runs them.

Each of those takes a layout, :data:`ONE_DEVICE` by default, and calls
through it what differs where the fields are D-slabs over several devices:
the stencils that read across a cut, the sums over voxels (``total``) and
the placement of small parameter trees beside the fields (``local``,
``map``).  Elementwise arithmetic is written on the fields themselves.  The
spatially sharded steps pass the rows of ``parallel/spatial.py``.

The block-gather warp is not here.  Only the engine's forward chain warps
by blocks, and it resolves the warp through ``engine.vi.warp_block_gather``
at each call, which ops may not import; so the engine's one device
(``engine.vi._ONE_CARD``, the engine's default layout) is this class with
``block_warp`` added, and the models, which never warp by blocks, default
to :data:`ONE_DEVICE`.
"""

from __future__ import annotations

import torch

from .fourier import fourier_derivative_magnitude
from .grids import identity_grid, normalised_to_voxel, voxel_to_normalised
from .resample import block_residual_overflow, grid_sample_each, warp_bounded
from .stencil import (box_filter3d, gradient, reg_energy, split_compose_step,
                      taylor_compose_step, taylor_squaring_step)


def _lag1_sum(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``Σ x_p x_{p+e}`` over the voxels of ``x``'s own planes along ``axis``."""
    n = x.shape[axis]
    return torch.sum(x.narrow(axis, 0, n - 1) * x.narrow(axis, 1, n - 1), dim=(-3, -2, -1))


class OneDevice:
    """Each operation on whole fields."""

    def map(self, fn, *args):  # on slabs: of each slab in turn
        return fn(*args)

    def local(self, tree):  # on slabs: a copy on each slab's device
        return tree

    def total(self, x):  # on slabs: the partial sums, added on the first slab's device
        return x

    def integrate(self, transformation, v, **kwargs):  # on slabs: with this layout
        return transformation.integrate(v, **kwargs)

    def identity(self, dims, like):
        return identity_grid(dims, device=like.device)

    def to_normalised(self, x):
        return voxel_to_normalised(x)

    def to_voxel(self, x):
        return normalised_to_voxel(x)

    def taylor_squaring(self, d):
        return taylor_squaring_step(d)

    def split_operand(self, u):  # on slabs: with its halo, exchanged once
        return u

    def split_compose(self, d, u):
        return split_compose_step(d.contiguous(), u)

    def taylor_compose(self, d, u):
        return taylor_compose_step(d, u)

    def warp(self, vol, disp, radius: int = 1):
        return warp_bounded(vol, disp, radius)

    def gather_sample(self, d, id_grid):  # on slabs: the whole field at each slab's points
        return grid_sample_each(d, id_grid + d)

    def gradient(self, x, normalised: bool = False):
        return gradient(x, normalised_spacing=normalised)

    def box_filter(self, x, radius: int):
        return box_filter3d(x, radius)

    def lag1_sums(self, x) -> tuple:
        """``Σ x_p x_{p+e}`` over the voxels along W, H and D."""
        return _lag1_sum(x, -1), _lag1_sum(x, -2), _lag1_sum(x, -3)

    def smooth(self, bundle, v):
        return bundle.smooth(v)

    def block_overflow(self, disp, bound: int, radius: int, block: int):
        return block_residual_overflow(disp, bound, radius, block)

    def residual_map(self, gmm, fixed: dict, warped):
        return gmm.residual_map(fixed["im"], warped)

    def fourier_energy(self, v):
        """``Σ ‖F⁻¹(|ω| v̂)‖²`` per leading index (one value for ``(3, D, H, W)``)."""
        return reg_energy(v, fourier_derivative_magnitude)


ONE_DEVICE = OneDevice()
