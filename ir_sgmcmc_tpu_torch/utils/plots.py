"""Debug plots: velocity/displacement quivers and deformed grids (port of
``ir_sgmcmc_tpu/utils/plots.py``), returned as matplotlib figures on the
Agg backend.  matplotlib is imported when a plot is drawn, never when this
module is imported.
"""

from __future__ import annotations

import numpy as np

from .figures import _plt


def plot_2d(field: np.ndarray, stride: int = 1, title: str = ""):
    """Quiver plot of a 2D vector field ``(2, H, W)``."""
    plt = _plt()
    field = np.asarray(field)
    u, v = field[0, ::stride, ::stride], field[1, ::stride, ::stride]
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.quiver(u, v, angles="xy", scale_units="xy")
    ax.set_aspect("equal")
    ax.set_title(title or "2D field")
    fig.tight_layout()
    return fig


def plot_3d(field: np.ndarray, stride: int = 4, title: str = ""):
    """3D quiver of a ``(3, D, H, W)`` field, subsampled by ``stride``."""
    plt = _plt()
    field = np.asarray(field)
    _, D, H, W = field.shape
    zz, yy, xx = np.meshgrid(np.arange(0, D, stride), np.arange(0, H, stride),
                             np.arange(0, W, stride), indexing="ij")
    fx = field[0, ::stride, ::stride, ::stride]
    fy = field[1, ::stride, ::stride, ::stride]
    fz = field[2, ::stride, ::stride, ::stride]
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    ax.quiver(xx, yy, zz, fx, fy, fz, length=1.0, normalize=False)
    ax.set_title(title or "3D field")
    fig.tight_layout()
    return fig


def plot_grid(transformation: np.ndarray, stride: int = 2, axis: int = 0,
              title: str = ""):
    """Deformed-grid plot of the mid-slice of a ``(3, D, H, W)``
    transformation (normalised coordinates)."""
    plt = _plt()
    t = np.asarray(transformation)
    mid = t.shape[1 + axis] // 2
    sl = [slice(None)] * 4
    sl[1 + axis] = mid
    plane = t[tuple(sl)]  # (3, A, B)
    # pick the two in-plane channels: channel 0=x(W), 1=y(H), 2=z(D)
    chans = [c for c in (0, 1, 2) if (2 - c) != axis]
    gx, gy = plane[chans[0]], plane[chans[1]]

    fig, ax = plt.subplots(figsize=(6, 6))
    for i in range(0, gx.shape[0], stride):
        ax.plot(gx[i, :], gy[i, :], "b-", lw=0.5)
    for j in range(0, gx.shape[1], stride):
        ax.plot(gx[:, j], gy[:, j], "b-", lw=0.5)
    ax.set_aspect("equal")
    ax.set_title(title or "deformed grid")
    fig.tight_layout()
    return fig
