"""Forward chain shared by the VI and MCMC phases, main-path subset (port of
``ir_sgmcmc_tpu/engine/vi.py``): ``count_folds``, the ``post`` noise scheme
of ``forward_sample``, the detached GMM Adam step and the VD factor.

Everything is batched over a leading chain axis: ``v (C, 3, D, H, W)``,
residuals ``(C, D, H, W)``, GMM params ``(C, K)``; counts are ``(C,)``.
The VI step itself is ROADMAP A9.
"""

from __future__ import annotations

import math

import torch

from ..ops.grids import det_jacobian, voxel_to_normalised
from ..ops.resample import block_residual_overflow, grid_sample, warp_block_gather
from ..ops.stencil import gradient
from ..optim.adam_decay import apply_updates
from .bundle import ModelBundle


def count_folds(transformation: torch.Tensor) -> torch.Tensor:
    """Voxels with ``det J < 0`` (the reference's NaN count of log|J|)."""
    jac = gradient(transformation, normalised_spacing=True)
    return torch.sum(det_jacobian(jac) < 0.0, dim=(-3, -2, -1))


def forward_sample(bundle: ModelBundle, fixed: dict, moving: dict,
                   v_unsmoothed: torch.Tensor, noise: torch.Tensor) -> dict:
    """Smooth -> integrate -> ONE warp of the moving image at ``T + noise``
    -> LCC residuals, for the 'post' noise scheme.

    ``noise`` is the ``U(-alpha, alpha)`` voxel noise, ``(C, 3, D, H, W)``.
    At dims >= 64 that divide by the block size the warp is the block-gather
    warp (kernels B3/B4 on the card), with its overflow counted into
    ``sat``/``sat_resid``; below, it is ``grid_sample``.
    """
    tr = bundle.transformation
    if bundle.uniform_noise_alpha is None or bundle.noise_scheme != "post":
        raise NotImplementedError(
            "only the 'post' uniform-noise scheme is ported (ROADMAP A12)")
    v = bundle.smooth(v_unsmoothed)
    transformation, displacement, _ = tr.integrate(v)
    alpha = bundle.uniform_noise_alpha
    block = int(bundle.block_size)
    zero = torch.zeros(displacement.shape[:-4], dtype=torch.int64,
                       device=displacement.device)
    anchor_sat = zero
    if bundle.block_warp and all(s % block == 0 and s >= 8 * block
                                 for s in bundle.dims):
        d_total = displacement + noise
        radius = int(bundle.block_radius)
        bound = int(-(-float(tr.max_disp + alpha) // 1))
        n = d_total.shape[0]
        vol = moving["im"].expand((n, 1) + tuple(bundle.dims)).contiguous()
        warped = warp_block_gather(vol, d_total, bound, radius, block)[:, 0]
        anchor_sat = block_residual_overflow(d_total.detach(), bound, radius, block)
    else:
        t = transformation + voxel_to_normalised(noise)
        warped = grid_sample(moving["im"], t)
    ndv = count_folds(transformation.detach())
    residuals = bundle.gmm.residual_map(fixed["im"], warped)
    clamp_bound = float(tr.displacement_clamp_bound)
    if math.isinf(clamp_bound):
        sat = zero
    else:
        d = displacement.detach()
        sat = torch.sum(torch.any(torch.abs(d) >= clamp_bound, dim=-4), dim=(-3, -2, -1))
    return {
        "v": v,
        "transformation": transformation,
        "displacement": displacement,
        "warped": warped,
        "residuals": residuals,
        "ndv": ndv,
        "sat": sat + anchor_sat,
        "sat_resid": anchor_sat,
    }


def gmm_adam_step(bundle: ModelBundle, opt, gmm: dict, opt_gmm, residuals,
                  mask, alpha):
    """One detached GMM Adam step per chain (reference trainer.py:68-77)."""
    res_d = residuals.detach()
    with torch.enable_grad():
        p = {k: v.detach().requires_grad_(True) for k, v in gmm.items()}
        loss = bundle.gmm.masked_nll(p, res_d, mask) * alpha - bundle.gmm_prior_terms(p)
        keys = list(p)
        grads = torch.autograd.grad(loss.sum(), [p[k] for k in keys])
    updates, opt_gmm = opt.update(dict(zip(keys, grads)), opt_gmm)
    gmm = {k: v.detach() for k, v in gmm.items()}
    return apply_updates(gmm, updates), opt_gmm


def vd_alpha(bundle: ModelBundle, gmm: dict, residuals, mask) -> torch.Tensor:
    """Virtual-decimation factor per chain (1 when VD is off)."""
    if not bundle.virtual_decimation:
        return torch.ones(residuals.shape[:-3], dtype=torch.float32,
                          device=residuals.device)
    return bundle.gmm.vd_alpha(gmm, residuals.detach(), mask)
