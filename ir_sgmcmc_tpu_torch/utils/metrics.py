"""Registration quality metrics (port of ``ir_sgmcmc_tpu/utils/metrics.py``).

* :func:`dice` runs in torch on the tensors' device, over all structures at
  once and any leading batch axes.
* The average symmetric surface distance is host work (numpy +
  ``scipy.ndimage``): 6-connectivity surface voxels and an exact Euclidean
  distance transform, ``(Σ_a d(a,B) + Σ_b d(b,A)) / (|A| + |B|)``.

Also the 15-structure subcortical label map and a pandas-free
:class:`MetricTracker`.
"""

from __future__ import annotations

import numpy as np
import torch

STRUCTURES = {
    "left_thalamus": 10, "left_caudate": 11, "left_putamen": 12,
    "left_pallidum": 13, "brain_stem": 16, "left_hippocampus": 17,
    "left_amygdala": 18, "left_accumbens": 26, "right_thalamus": 49,
    "right_caudate": 50, "right_putamen": 51, "right_pallidum": 52,
    "right_hippocampus": 53, "right_amygdala": 54, "right_accumbens": 58,
}


def dice(seg_fixed: torch.Tensor, seg_moving: torch.Tensor, labels) -> torch.Tensor:
    """Per-label Dice of two integer segmentations ``(…, D, H, W)`` (leading
    axes broadcast): ``(…, len(labels))`` float32.  An empty union gives 0."""
    vox = (-3, -2, -1)
    out = []
    for label in labels:
        a = seg_fixed == label
        b = seg_moving == label
        inter = torch.sum(a & b, dim=vox)
        denom = torch.sum(a, dim=vox) + torch.sum(b, dim=vox)
        ratio = 2.0 * inter.to(torch.float32) / denom.to(torch.float32)
        out.append(torch.where(denom > 0, ratio, torch.zeros_like(ratio)))
    return torch.stack(out, dim=-1)


def _surface(binary: np.ndarray) -> np.ndarray:
    """6-connectivity surface voxels (voxels with a background face-neighbour)."""
    b = binary.astype(bool)
    interior = b.copy()
    for ax in range(3):
        interior &= np.roll(b, 1, axis=ax) & np.roll(b, -1, axis=ax)
        # voxels on the volume border are surface if set
        sl_lo = [slice(None)] * 3
        sl_hi = [slice(None)] * 3
        sl_lo[ax] = 0
        sl_hi[ax] = -1
        interior[tuple(sl_lo)] = False
        interior[tuple(sl_hi)] = False
    return b & ~interior


def _edt(binary: np.ndarray, spacing) -> np.ndarray:
    """Exact Euclidean distance (in physical units) to the set ``binary``."""
    from scipy import ndimage

    if not binary.any():
        return np.full(binary.shape, np.inf, np.float32)
    return ndimage.distance_transform_edt(~binary, sampling=spacing).astype(np.float32)


def average_surface_distance(seg_fixed, seg_moving, label, spacing=(1.0, 1.0, 1.0)) -> float:
    """Average symmetric Hausdorff distance between label contours.

    The distance transforms run on the union bounding box of the two
    surfaces: the EDT to a set is exact at any point of a crop that holds
    the whole set, and both query sets lie in the box.
    """
    a = _surface(np.asarray(seg_fixed) == label)
    b = _surface(np.asarray(seg_moving) == label)
    if not a.any() or not b.any():
        return float("inf")
    idx = np.nonzero(a | b)
    sl = tuple(slice(int(i.min()), int(i.max()) + 1) for i in idx)
    a, b = a[sl], b[sl]
    da = _edt(a, spacing)
    db = _edt(b, spacing)
    return float((db[a].sum() + da[b].sum()) / (a.sum() + b.sum()))


def calc_metrics(seg_fixed, seg_moving, structures=STRUCTURES, spacing=(1.0, 1.0, 1.0)):
    """(ASD, DSC) numpy arrays of shape ``(no_samples, len(structures))``
    for ``(D, H, W)`` or batched ``(N, D, H, W)`` segmentations."""
    sf = np.asarray(seg_fixed)
    sm = np.asarray(seg_moving)
    if sf.ndim == 3:
        sf, sm = sf[None], sm[None]
    n = sm.shape[0]
    if sf.shape[0] == 1 and n > 1:
        sf = np.broadcast_to(sf, sm.shape)

    dsc = dice(torch.as_tensor(np.ascontiguousarray(sf)), torch.as_tensor(sm),
               list(structures.values())).numpy()
    asd = np.zeros((n, len(structures)))
    for i in range(n):
        for j, label in enumerate(structures.values()):
            asd[i, j] = average_surface_distance(sf[i], sm[i], label, spacing)
    return asd, dsc


class MetricTracker:
    """Streaming totals/averages per key, optional writer push."""

    def __init__(self, *keys, writer=None):
        self.writer = writer
        self._totals = {k: 0.0 for k in keys}
        self._counts = {k: 0 for k in keys}

    def reset(self):
        for k in self._totals:
            self._totals[k] = 0.0
            self._counts[k] = 0

    def update(self, key, value, n=1):
        value = float(value)
        if self.writer is not None:
            self.writer.add_scalar(key, value)
        self._totals[key] = self._totals.get(key, 0.0) + value * n
        self._counts[key] = self._counts.get(key, 0) + n

    def avg(self, key):
        c = self._counts.get(key, 0)
        return self._totals.get(key, 0.0) / c if c else 0.0

    def result(self):
        return {k: self.avg(k) for k in self._totals}
