"""Synthetic image pairs (numpy; port of the sphere generators of
``ir_sgmcmc_tpu/data/synthetic.py``, kept here so the port and its GPU
smoke run load nothing of the JAX package).  Same arrays for the same
arguments, which a test checks."""

from __future__ import annotations

import numpy as np


def sphere(shape, centre, radius, value=1.0, soft=True):
    zz, yy, xx = np.meshgrid(*(np.arange(s, dtype=np.float32) for s in shape), indexing="ij")
    d2 = (zz - centre[0]) ** 2 + (yy - centre[1]) ** 2 + (xx - centre[2]) ** 2
    if soft:
        return value * np.exp(-d2 / (2.0 * (radius / 2.0) ** 2)).astype(np.float32)
    return (d2 < radius**2).astype(np.float32) * value


def sphere_pair(shape=(16, 16, 16), offset=(0.0, 0.0, 2.0), radius=None, seed=0):
    """Fixed/moving dicts (``im``, ``mask``, ``seg``): a textured soft sphere
    and its copy rolled by ``offset`` voxels."""
    shape = tuple(shape)
    radius = radius if radius is not None else shape[0] / 4.0
    c = np.asarray(shape, np.float32) / 2.0
    rng = np.random.default_rng(seed)

    im = sphere(shape, c, radius)
    texture = rng.standard_normal(shape).astype(np.float32)
    for ax in range(3):
        texture = (np.roll(texture, 1, ax) + texture + np.roll(texture, -1, ax)) / 3.0
    im = im * (1.0 + 0.3 * texture) + 0.02 * rng.standard_normal(shape).astype(np.float32)
    seg = sphere(shape, c, radius * 0.8, soft=False).astype(np.int16)
    mask = np.ones(shape, dtype=bool)
    fixed = {"im": im.astype(np.float32), "mask": mask, "seg": seg}

    shift = [int(round(o)) for o in np.asarray(offset, np.float32)]
    moving = {
        "im": np.roll(im, shift, axis=(0, 1, 2)).astype(np.float32),
        "mask": mask,
        "seg": np.roll(seg, shift, axis=(0, 1, 2)),
    }
    return fixed, moving
