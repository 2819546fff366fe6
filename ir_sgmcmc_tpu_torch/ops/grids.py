"""Grid and coordinate primitives (port of ``ir_sgmcmc_tpu/ops/grids.py``).

Vector fields are channel-first ``(…, 3, D, H, W)``: channel 0 is x (W
axis), 1 is y (H axis), 2 is z (D axis).  Normalised coordinates live in
``[-1, 1]`` with ``align_corners=True`` semantics.
"""

from __future__ import annotations

import torch

from .._device import resolve_device


def identity_grid(shape, device=None) -> torch.Tensor:
    """Normalised identity grid ``(3, D, H, W)``; channel 0 varies along W.
    On ``device`` (default: the CUDA card)."""
    D, H, W = shape
    device = resolve_device(device)

    def axis_coords(n: int, axis: int) -> torch.Tensor:
        if n == 1:
            return torch.full((D, H, W), -1.0, dtype=torch.float32, device=device)
        i = torch.arange(n, dtype=torch.float32, device=device)
        view = [1, 1, 1]
        view[axis] = n
        c = 2.0 * i / (n - 1) - 1.0
        return c.reshape(view).expand(D, H, W)

    return torch.stack([axis_coords(W, 2), axis_coords(H, 1),
                        axis_coords(D, 0)], dim=0)


def _axis_scale(field: torch.Tensor, numerator: bool) -> torch.Tensor:
    D, H, W = field.shape[-3:]
    sizes = torch.tensor([W, H, D], dtype=torch.float32, device=field.device)
    scale = 2.0 / (sizes - 1.0) if numerator else (sizes - 1.0) / 2.0
    return scale.reshape(3, 1, 1, 1)


def voxel_to_normalised(field: torch.Tensor) -> torch.Tensor:
    """Scale channel c by ``2 / (size_c - 1)`` (``(…, 3, D, H, W)``)."""
    return field * _axis_scale(field, True)


def normalised_to_voxel(field: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`voxel_to_normalised`."""
    return field * _axis_scale(field, False)


def det_jacobian(jac: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of a ``(…, 3, 3, D, H, W)`` field Jacobian."""
    a, b, c = jac[..., 0, 0, :, :, :], jac[..., 0, 1, :, :, :], jac[..., 0, 2, :, :, :]
    d, e, f = jac[..., 1, 0, :, :, :], jac[..., 1, 1, :, :, :], jac[..., 1, 2, :, :, :]
    g, h, i = jac[..., 2, 0, :, :, :], jac[..., 2, 1, :, :, :], jac[..., 2, 2, :, :, :]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def inv_jacobian(jac: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate / det) inverse of a ``(…, 3, 3, D, H, W)`` field
    Jacobian, per voxel.  Determinants within 1e-6 of zero are floored to
    ±1e-6 (by their sign, zero counting as positive)."""
    a, b, c = jac[..., 0, 0, :, :, :], jac[..., 0, 1, :, :, :], jac[..., 0, 2, :, :, :]
    d, e, f = jac[..., 1, 0, :, :, :], jac[..., 1, 1, :, :, :], jac[..., 1, 2, :, :, :]
    g, h, i = jac[..., 2, 0, :, :, :], jac[..., 2, 1, :, :, :], jac[..., 2, 2, :, :, :]
    det = det_jacobian(jac)
    floor = torch.where(det < 0, torch.full_like(det, -1e-6), torch.full_like(det, 1e-6))
    det = torch.where(torch.abs(det) < 1e-6, floor, det)
    rows = [[e * i - f * h, c * h - b * i, b * f - c * e],
            [f * g - d * i, a * i - c * g, c * d - a * f],
            [d * h - e * g, b * g - a * h, a * e - b * d]]
    cof = torch.stack([torch.stack(r, dim=-4) for r in rows], dim=-5)
    return cof / det[..., None, None, :, :, :]


def count_non_diffeomorphic(det_J: torch.Tensor) -> torch.Tensor:
    """Voxels with a non-positive Jacobian determinant, ``det ≤ 0``, per
    leading index: the NaN-or-``-inf`` count of ``log det J``.  The trainer's
    evaluation counts this; the engine's ``count_folds`` counts ``det < 0``
    (the NaN count alone), as the JAX package does at each site."""
    return torch.sum(det_J <= 0.0, dim=(-3, -2, -1))
