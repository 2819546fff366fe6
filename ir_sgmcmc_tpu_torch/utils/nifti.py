"""Self-contained NIfTI-1 reader/writer (numpy; port of
``ir_sgmcmc_tpu/utils/nifti.py``, kept here so the port loads nothing of the
JAX package).

The 348-byte header, float32/int16/uint8/int32/float64 payloads, and
transparent ``.nii`` / ``.nii.gz`` handling.  Only the fields the framework
touches are honoured (dim, datatype, pixdim, scl, vox_offset); affines are
written as scaled identities.  A file written by either package reads back
bitwise in the other (a test checks it).
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

# (numpy dtype, nifti datatype code, bits)
_DTYPES = {
    np.dtype(np.uint8): (2, 8),
    np.dtype(np.int16): (4, 16),
    np.dtype(np.int32): (8, 32),
    np.dtype(np.float32): (16, 32),
    np.dtype(np.float64): (64, 64),
}
_CODES = {code: dt for dt, (code, _) in _DTYPES.items()}


def _open(path, mode):
    p = str(path)
    if p.endswith(".gz"):
        # compresslevel 1 (nibabel's default) is ~7x faster than gzip's 9 on
        # float volumes; sample saving runs every save period
        return gzip.open(p, mode, compresslevel=1) if "w" in mode else gzip.open(p, mode)
    return open(p, mode)


def write_nifti(path, array: np.ndarray, spacing=(1.0, 1.0, 1.0)) -> None:
    """Write a 3D (or 4D, vector-last) array as NIfTI-1, stored in
    Fortran axis order: ``array[x, y, z(, t)]``."""
    arr = np.asarray(array)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    if arr.dtype not in _DTYPES:
        arr = arr.astype(np.float32)
    code, bits = _DTYPES[arr.dtype]

    ndim = arr.ndim
    dim = [ndim] + list(arr.shape) + [1] * (7 - ndim)
    pixdim = ([1.0] + list(spacing[:3]) + [1.0] * 4)[:8]

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)  # sizeof_hdr
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)  # datatype
    struct.pack_into("<h", hdr, 72, bits)  # bitpix
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    # sform: scaled identity
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<4f", hdr, 280, spacing[0], 0, 0, 0)  # srow_x
    struct.pack_into("<4f", hdr, 296, 0, spacing[1], 0, 0)  # srow_y
    struct.pack_into("<4f", hdr, 312, 0, 0, spacing[2], 0)  # srow_z
    hdr[344:348] = b"n+1\x00"

    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # extension flag
        f.write(np.asfortranarray(arr).tobytes(order="F"))


def read_nifti(path):
    """Read a NIfTI-1 file -> ``(array, spacing)``; ``.nii`` or ``.nii.gz``."""
    with _open(path, "rb") as f:
        raw = f.read()
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    if sizeof_hdr != 348:
        raise ValueError(f"{path}: not a little-endian NIfTI-1 file")
    dim = struct.unpack_from("<8h", raw, 40)
    code = struct.unpack_from("<h", raw, 70)[0]
    pixdim = struct.unpack_from("<8f", raw, 76)
    vox_offset = int(struct.unpack_from("<f", raw, 108)[0])
    slope = struct.unpack_from("<f", raw, 112)[0]
    inter = struct.unpack_from("<f", raw, 116)[0]

    ndim = dim[0]
    shape = tuple(dim[1 : 1 + ndim])
    dtype = _CODES.get(code)
    if dtype is None:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {code}")

    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=vox_offset)
    arr = data.reshape(shape, order="F")
    if slope not in (0.0, 1.0) or inter != 0.0:
        arr = arr * slope + inter
    spacing = tuple(float(p) for p in pixdim[1:4])
    return np.array(arr), spacing
