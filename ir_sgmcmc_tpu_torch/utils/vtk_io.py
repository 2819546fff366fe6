"""Legacy VTK structured-points I/O for vector fields (numpy; port of
``ir_sgmcmc_tpu/utils/vtk_io.py``): binary, big-endian, one POINT_DATA
vector array named ``field``.  The header is the JAX package's byte for
byte, so files written by either package are identical."""

from __future__ import annotations

import numpy as np


def write_vtk_field(path, field: np.ndarray, spacing=(1.0, 1.0, 1.0)) -> None:
    """Write a ``(3, D, H, W)`` vector field (channel 0 = x/W axis), points
    x-fastest as VTK's structured points order them."""
    assert field.ndim == 4 and field.shape[0] == 3, field.shape
    D, H, W = field.shape[1:]
    vecs = np.moveaxis(field.astype(">f4"), 0, -1).reshape(-1, 3)

    header = (
        "# vtk DataFile Version 3.0\n"
        "ir-sgmcmc-tpu field\n"
        "BINARY\n"
        "DATASET STRUCTURED_POINTS\n"
        f"DIMENSIONS {W} {H} {D}\n"
        "ORIGIN 0 0 0\n"
        f"SPACING {spacing[0]} {spacing[1]} {spacing[2]}\n"
        f"POINT_DATA {D * H * W}\n"
        "VECTORS field float\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(vecs.tobytes())
        f.write(b"\n")


def read_vtk_field(path) -> np.ndarray:
    """Read a field written by :func:`write_vtk_field` -> ``(3, D, H, W)``."""
    with open(path, "rb") as f:
        raw = f.read()
    head_end = raw.index(b"VECTORS field float\n") + len(b"VECTORS field float\n")
    header = raw[:head_end].decode("ascii", errors="replace")
    dims_line = next(ln for ln in header.splitlines() if ln.startswith("DIMENSIONS"))
    W, H, D = (int(t) for t in dims_line.split()[1:4])
    n = D * H * W
    vecs = np.frombuffer(raw, dtype=">f4", count=n * 3, offset=head_end)
    field = vecs.reshape(D, H, W, 3).astype(np.float32)
    return np.moveaxis(field, -1, 0)
