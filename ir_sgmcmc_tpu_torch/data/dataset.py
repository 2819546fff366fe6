"""Image-pair datasets (numpy, host side; port of
``ir_sgmcmc_tpu/data/dataset.py``, same arrays for the same inputs).

* :class:`NiftiPairDataset`: ``data_dir/{*.nii.gz, masks/*.nii.gz,
  segs/*.nii.gz}``, paired all-to-one (file 0 is the fixed volume);
  volumes are transposed to (x, y, z), padded to a cube with the volume
  minimum, then resized to ``dims`` (trilinear with align_corners=True for
  images, nearest for masks and segmentations); ``im_spacing`` = max
  (original shape) / dims; an ``idx_to_id.json`` manifest goes into the run
  directory.
* :class:`SyntheticPairDataset`: the sphere pairs of ``synthetic.py``.

Variational parameters start as mu = 0, log var = 2 log(sigma_v_init),
u = u_v_init on the full grid, or on the B-spline control grid when a
control point spacing ``cps`` is given (the SVFFD model).  Arrays move to
the device once, in the trainer.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..ops.bspline import control_grid_size
from ..utils.nifti import read_nifti
from .synthetic import sphere_pair


def _field_dims(dims: tuple, cps) -> tuple:
    """The sampled state's grid: the control grid with ``cps``, else ``dims``."""
    return control_grid_size(dims, cps) if cps is not None else dims


def _resize_trilinear(vol: np.ndarray, dims) -> np.ndarray:
    """Trilinear resize with torch align_corners=True convention."""
    src = vol.astype(np.float32)
    out_sh = tuple(dims)
    coords = []
    for s_in, s_out in zip(src.shape, out_sh):
        if s_out == 1:
            c = np.zeros(1, np.float32)
        else:
            c = np.arange(s_out, dtype=np.float32) * (s_in - 1) / (s_out - 1)
        coords.append(c)
    cz, cy, cx = np.meshgrid(*coords, indexing="ij")

    z0 = np.floor(cz).astype(np.int32)
    y0 = np.floor(cy).astype(np.int32)
    x0 = np.floor(cx).astype(np.int32)
    z1 = np.minimum(z0 + 1, src.shape[0] - 1)
    y1 = np.minimum(y0 + 1, src.shape[1] - 1)
    x1 = np.minimum(x0 + 1, src.shape[2] - 1)
    fz, fy, fx = cz - z0, cy - y0, cx - x0

    def g(zi, yi, xi):
        return src[zi, yi, xi]

    c00 = g(z0, y0, x0) * (1 - fx) + g(z0, y0, x1) * fx
    c01 = g(z0, y1, x0) * (1 - fx) + g(z0, y1, x1) * fx
    c10 = g(z1, y0, x0) * (1 - fx) + g(z1, y0, x1) * fx
    c11 = g(z1, y1, x0) * (1 - fx) + g(z1, y1, x1) * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def _resize_nearest(vol: np.ndarray, dims) -> np.ndarray:
    """Nearest resize with torch ``F.interpolate(mode='nearest')`` indexing
    (source index = floor(i_out * in/out))."""
    idx = []
    for s_in, s_out in zip(vol.shape, dims):
        idx.append(np.minimum((np.arange(s_out) * (s_in / s_out)).astype(np.int64), s_in - 1))
    return vol[np.ix_(*idx)]


def _pad_to_cube(arr: np.ndarray) -> np.ndarray:
    side = max(arr.shape)
    pad = [(side - s) // 2 for s in arr.shape]
    padding = [(p, side - s - p) for p, s in zip(pad, arr.shape)]
    return np.pad(arr, padding, mode="minimum")


def _init_q_v(field_dims, sigma_v_init: float, u_v_init: float) -> dict:
    shape = (3,) + tuple(field_dims)
    return {
        "mu": np.zeros(shape, np.float32),
        "log_var": np.full(shape, 2.0 * np.log(sigma_v_init), np.float32),
        "u": np.full(shape, u_v_init, np.float32),
    }


class NiftiPairDataset:
    """All-to-one registration pairs from a directory of NIfTI volumes."""

    structures = None  # the trainer falls back to the 15 subcortical labels

    def __init__(self, dims, data_dir, save_dir=None, sigma_v_init=0.5,
                 u_v_init=0.1, cps=None):
        self.dims = tuple(int(d) for d in dims)
        self.data_dir = Path(data_dir)
        self.sigma_v_init = float(sigma_v_init)
        self.u_v_init = float(u_v_init)
        self.field_dims = _field_dims(self.dims, cps)
        self.im_spacing = None

        ims = self._filenames(self.data_dir)
        masks = self._filenames(self.data_dir / "masks")
        segs = self._filenames(self.data_dir / "segs")
        self.triples = [
            {"im": str(i), "mask": str(m), "seg": str(s)}
            for i, m, s in zip(ims, masks, segs)
        ]
        if len(self.triples) < 2:
            raise ValueError(f"{data_dir}: need >= 2 volumes for a registration pair")

        if save_dir is not None:
            manifest = Path(save_dir) / "idx_to_id.json"
            manifest.write_text(json.dumps(dict(enumerate(self.triples)), indent=4, sort_keys=True))

    @staticmethod
    def _filenames(p: Path):
        files = sorted(f for f in Path(p).iterdir() if f.is_file()) if Path(p).is_dir() else []
        if not files:
            raise FileNotFoundError(f"no volumes found under {p}")
        return files

    def __len__(self):
        return len(self.triples) - 1

    def _load(self, path: str) -> np.ndarray:
        arr, _ = read_nifti(path)
        arr = np.transpose(np.squeeze(arr), (2, 1, 0))  # (z,y,x) -> (x,y,z)
        if self.im_spacing is None:
            self.im_spacing = float(max(arr.shape)) / np.asarray(self.dims, np.float32)
        return _pad_to_cube(arr)

    def _get_image(self, path: str) -> np.ndarray:
        return _resize_trilinear(self._load(path), self.dims).astype(np.float32)

    def _get_mask(self, path: str) -> np.ndarray:
        return _resize_nearest(self._load(path), self.dims).astype(bool)

    def _get_seg(self, path: str) -> np.ndarray:
        return _resize_nearest(self._load(path), self.dims).astype(np.int16)

    def _triple(self, i: int) -> dict:
        t = self.triples[i]
        return {
            "im": self._get_image(t["im"]),
            "mask": self._get_mask(t["mask"]),
            "seg": self._get_seg(t["seg"]),
        }

    def init_q_v(self) -> dict:
        return _init_q_v(self.field_dims, self.sigma_v_init, self.u_v_init)

    def __getitem__(self, idx: int):
        """(fixed, moving, var_params_q_v): moving is volume ``idx + 1``."""
        return self._triple(0), self._triple(idx + 1), self.init_q_v()


class SyntheticPairDataset:
    """Sphere-pair dataset for runs without data (tests, demos, the smoke
    run), selected by the config type ``SyntheticDataLoader``."""

    structures = {"sphere": 1}

    def __init__(self, dims, save_dir=None, sigma_v_init=0.5, u_v_init=0.1,
                 cps=None, offset=None, seed=0, no_pairs=1, **_):
        self.dims = tuple(int(d) for d in dims)
        self.sigma_v_init = float(sigma_v_init)
        self.u_v_init = float(u_v_init)
        self.field_dims = _field_dims(self.dims, cps)
        self.offset = offset if offset is not None else (0.0, 0.0, max(1.0, self.dims[0] / 16.0))
        self.seed = seed
        # no_pairs > 1: distinct pairs (per-index texture seed + rolled offset axis)
        self.no_pairs = int(no_pairs)
        self.im_spacing = np.ones(3, np.float32)

    def __len__(self):
        return self.no_pairs

    def init_q_v(self) -> dict:
        return _init_q_v(self.field_dims, self.sigma_v_init, self.u_v_init)

    def __getitem__(self, idx: int):
        off = np.roll(np.asarray(self.offset, np.float32), idx % 3)
        fixed, moving = sphere_pair(self.dims, offset=tuple(off.tolist()),
                                    seed=self.seed + idx)
        return fixed, moving, self.init_q_v()


def make_dataset(kind: str, **kwargs):
    """Config factory (type names mirror the reference's data loaders)."""
    if kind in ("BiobankDataLoader", "NiftiPairDataset"):
        kwargs.pop("offset", None)
        kwargs.pop("seed", None)
        return NiftiPairDataset(**kwargs)
    if kind in ("SyntheticDataLoader", "SyntheticPairDataset"):
        kwargs.pop("data_dir", None)
        return SyntheticPairDataset(**kwargs)
    raise ValueError(f"unknown data loader type: {kind}")
