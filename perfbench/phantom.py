"""Synthetic brain phantom pairs, made on the device from a seed.

Each subject is a textured head phantom (a skull shell, grey and white
matter, two ventricles, a coarse and a fine multiplicative texture) and a
moving image that is the same phantom warped by a smooth random
displacement of a few voxels.  The mask is the brain ellipsoid.  Every
seed gives the same sizes and the same kind of deformation; only the
random draws differ.

Plain PyTorch only: ``torch.randn`` on a ``torch.Generator`` of the
device, ``F.interpolate`` and ``F.grid_sample``, in a few calls per pair.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MAX_WARP_VOX = 3.0  # peak of the smooth random displacement, in voxels


def _grid(dims, device) -> torch.Tensor:
    """``(D, H, W, 3)`` coordinates in ``[-1, 1]``, last axis (x, y, z)."""
    axes = [torch.linspace(-1.0, 1.0, n, device=device) for n in dims]
    z, y, x = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([x, y, z], dim=-1)


def _smooth_noise(gen, coarse: int, dims, device, channels: int = 1) -> torch.Tensor:
    """``(channels, D, H, W)``: standard normal noise on a ``coarse``³ grid,
    trilinearly upsampled to ``dims``."""
    c = torch.randn((1, channels, coarse, coarse, coarse), generator=gen, device=device)
    return F.interpolate(c, size=tuple(dims), mode="trilinear", align_corners=True)[0]


def _ellipsoid(grid, centre, radii) -> torch.Tensor:
    """Squared normalised radius of each voxel to an ellipsoid."""
    return (((grid - centre) / radii) ** 2).sum(-1)


def brain_phantom(gen: torch.Generator, dims, device) -> tuple:
    """One subject: ``(image (D, H, W) f32, mask (D, H, W) bool)``."""
    g = _grid(dims, device)
    jitter = torch.rand((12,), generator=gen, device=device)
    head = _ellipsoid(g, 0.0, 0.78 + 0.08 * jitter[0:3])
    brain = _ellipsoid(g, 0.0, 0.66 + 0.08 * jitter[3:6])
    white = _ellipsoid(g, 0.0, 0.42 + 0.08 * jitter[6:9])
    vent_radii = torch.tensor([0.08, 0.22, 0.12], device=device)
    zero = torch.zeros((), device=device)
    vent = torch.minimum(*(
        _ellipsoid(g, torch.stack([side * (0.12 + 0.04 * jitter[9]), 0.05 * jitter[10] - 0.025 + zero,
                                   0.1 * jitter[11]]), vent_radii)
        for side in (1.0, -1.0)))

    def soft(r2, width=0.04):
        return torch.sigmoid((1.0 - r2) / width)

    im = (0.35 * (soft(head) - soft(brain, 0.02))  # skull and scalp
          + 0.55 * soft(brain, 0.02)  # grey matter
          + 0.30 * soft(white, 0.03)  # white matter on top of grey
          - 0.60 * soft(vent, 0.05))  # ventricles
    texture = _smooth_noise(gen, 12, dims, device)[0]
    fine = _smooth_noise(gen, 48, dims, device)[0]
    im = im * (1.0 + 0.15 * texture + 0.10 * fine)
    im = im + 0.01 * torch.randn(tuple(dims), generator=gen, device=device)
    return im.contiguous(), (brain < 1.0).contiguous()


def smooth_warp(gen: torch.Generator, im: torch.Tensor) -> torch.Tensor:
    """``im`` warped by a smooth random displacement of at most
    ``MAX_WARP_VOX`` voxels along each axis (border padding)."""
    dims = tuple(im.shape)
    disp = _smooth_noise(gen, 5, dims, device=im.device, channels=3)  # (3, D, H, W) x, y, z
    disp = MAX_WARP_VOX * torch.tanh(disp)
    scale = torch.tensor([2.0 / (dims[2] - 1), 2.0 / (dims[1] - 1), 2.0 / (dims[0] - 1)],
                         device=im.device)
    grid = _grid(dims, im.device) + disp.permute(1, 2, 3, 0) * scale
    return F.grid_sample(im[None, None], grid[None], mode="bilinear", padding_mode="border",
                         align_corners=True)[0, 0].contiguous()


def phantom_pairs(gen: torch.Generator, n_pairs: int, dims, device) -> list:
    """``n_pairs`` subjects as ``(fixed, moving)`` dicts of ``im`` and
    ``mask``: the phantom, and the phantom under a smooth random warp (the
    moving image keeps the fixed mask, as a skull-stripped pair would)."""
    pairs = []
    for _ in range(n_pairs):
        im, mask = brain_phantom(gen, dims, device)
        moving = smooth_warp(gen, im)
        pairs.append(({"im": im, "mask": mask}, {"im": moving, "mask": mask}))
    return pairs
