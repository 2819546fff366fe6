"""Cubic B-spline FFD: control grid -> dense field (port of
``ir_sgmcmc_tpu/ops/bspline.py``).

The dense field is the tensor-product B-spline interpolation of the
control-point parameters, three separable strided transposed 1D
convolutions.  Each is a contraction of one axis with a precomputed
``(n_in, n_out)`` spreading matrix, built once on the host in numpy.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def cubic_bspline_value(x: float) -> float:
    """The 1D cubic B-spline basis at ``x``."""
    t = abs(x)
    if t >= 2.0:
        return 0.0
    if t < 1.0:
        return 2.0 / 3.0 + (0.5 * t - 1.0) * t * t
    return -((t - 2.0) ** 3) / 6.0


def bspline_kernel_1d(stride: int) -> np.ndarray:
    """The ``4*stride - 1``-tap sampled cubic B-spline kernel."""
    n = 4 * stride - 1
    radius = n // 2
    return np.array(
        [cubic_bspline_value((i - radius) / stride) for i in range(n)], dtype=np.float32
    )


def transposed_conv_matrix(n_in: int, stride: int, crop_lo: int, n_out: int) -> np.ndarray:
    """Dense ``(n_in, n_out)`` matrix of a strided transposed 1D convolution
    (``conv_transpose1d(x, kernel, stride, padding=(k-1)//2)``) cropped to
    ``[crop_lo : crop_lo + n_out]``."""
    kernel = bspline_kernel_1d(stride)
    k = len(kernel)
    pad = (k - 1) // 2
    full = (n_in - 1) * stride + k - 2 * pad  # conv_transpose1d's output size
    M = np.zeros((n_in, full), dtype=np.float32)
    for i in range(n_in):
        for j in range(k):
            o = i * stride + j - pad
            if 0 <= o < full:
                M[i, o] += kernel[j]
    M = M[:, crop_lo : crop_lo + n_out]
    if M.shape != (n_in, n_out):
        raise ValueError(f"spreading matrix {M.shape}, expected {(n_in, n_out)}")
    return M


def control_grid_size(dims, cps) -> tuple:
    """Control grid size for an image of shape ``dims`` and spacing ``cps``:
    ``ceil((S-1)/c) + 3`` points per axis."""
    return tuple(int(math.ceil((s - 1) / c) + 1 + 2) for s, c in zip(dims, cps))


class CubicBSplineFFD3D:
    """The spreading matrices of one (control grid, image grid) pair.

    :param dims: dense spatial shape ``(D, H, W)``.
    :param cps: control point spacing per axis ``(sD, sH, sW)``.

    The matrices live on the host in float32 and are copied once to each
    device and dtype the spread is called with.
    """

    def __init__(self, dims, cps):
        self.dims = tuple(int(d) for d in dims)
        self.cps = tuple(int(c) for c in cps)
        self.control_dims = control_grid_size(self.dims, self.cps)
        # cropped at [stride : stride + dim] after the transposed convolution
        self.mats = [
            torch.from_numpy(transposed_conv_matrix(n_in, s, s, n_out))
            for n_in, s, n_out in zip(self.control_dims, self.cps, self.dims)
        ]
        self._on_device = {}

    def matrices(self, device, dtype=torch.float32) -> list:
        key = (torch.device(device), dtype)
        if key not in self._on_device:
            self._on_device[key] = [m.to(device=key[0], dtype=dtype) for m in self.mats]
        return self._on_device[key]

    def __call__(self, cp: torch.Tensor) -> torch.Tensor:
        """``(…, 3, cD, cH, cW)`` control parameters -> ``(…, 3, D, H, W)``
        dense field, over any leading (chain or antithetic) axes."""
        Md, Mh, Mw = self.matrices(cp.device, cp.dtype)
        out = torch.einsum("...dhw,dD->...Dhw", cp, Md)
        out = torch.einsum("...dhw,hH->...dHw", out, Mh)
        return torch.einsum("...dhw,wW->...dhW", out, Mw)
