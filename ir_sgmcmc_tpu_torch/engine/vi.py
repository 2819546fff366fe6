"""Variational inference and the forward chain it shares with SG-MCMC
(port of ``ir_sgmcmc_tpu/engine/vi.py``).

* :func:`forward_sample` — smooth -> integrate -> warp -> LCC residuals, on
  the ``"post"`` scheme (one block-gather warp at ``T + noise``) or the
  ``"pre"`` scheme (the image rides the integration cascade, then a jitter
  warp by the uniform noise).
* :func:`make_vi_step` / :func:`make_vi_chunk` / :func:`gmm_warmup` — the
  VI iteration: the two antithetic q(v) samples go through ONE batch-2
  forward chain, then two detached GMM Adam steps run in turn on one GMM.

Chain-batched tensors carry a leading axis: ``v (C, 3, D, H, W)``,
residuals ``(C, D, H, W)``; counts are ``(C,)``.  GMM parameters are
``(K,)`` in VI and ``(C, K)`` per chain in SG-MCMC.

Randomness: a state carries the two 32-bit words of a key (``(2,)`` int64
on the host) and a step count; :func:`key_generator` seeds one
``torch.Generator`` on the device from both, so a state fully determines
its draws (torch's, not threefry's).  Tests inject the JAX draws instead.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..models.entropy import entropy_analytic, entropy_sample
from ..models.gmm import GMM
from ..models.reg_loss import RegLossL2, RegLossLogNormal
from ..models.sampler import sample_q_v, uniform_voxel_noise
from ..ops.grids import det_jacobian, voxel_to_normalised
from ..ops.resample import (block_residual_overflow, grid_sample, grid_sample_each,
                            warp_block_gather, warp_bounded)
from ..ops.stencil import gradient
from ..optim.adam_decay import AdamDecayState, apply_updates
from .bundle import ModelBundle

_GOLDEN = 0x9E3779B97F4A7C15
_SALT = 0xBF58476D1CE4E5B9


def key_generator(words, step: int, device, salt: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from two key words, a step count and
    an optional salt (distinct streams for distinct uses of one step)."""
    k0, k1 = (int(w) for w in words)
    seed = ((k0 << 32) | k1) ^ (step * _GOLDEN) ^ (salt * _SALT)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & 0xFFFFFFFFFFFFFFFF)
    return gen


def count_folds(transformation: torch.Tensor) -> torch.Tensor:
    """Voxels with ``det J < 0`` (the reference's NaN count of log|J|)."""
    jac = gradient(transformation, normalised_spacing=True)
    return torch.sum(det_jacobian(jac) < 0.0, dim=(-3, -2, -1))


def forward_sample(bundle: ModelBundle, fixed: dict, moving: dict,
                   v_unsmoothed: torch.Tensor, noise: torch.Tensor | None,
                   anchor: dict | None = None, per_row: bool = False) -> dict:
    """Smooth -> integrate (+ warp) -> LCC residuals, over a leading batch.

    ``v_unsmoothed`` lives on ``bundle.field_dims`` (the control grid for
    SVFFD, whose integration spreads it to the dense grid); ``noise`` is the
    ``U(-alpha, alpha)`` voxel noise ``(C, 3, D, H, W)`` on the dense grid
    (unused, and may be None, when ``uniform_noise_alpha`` is None).  The
    images of ``fixed`` and ``moving`` are ``(D, H, W)``, shared by the
    batch, or with ``per_row`` ``(C, D, H, W)``, one per row (the
    pair-stacked chunks of ``engine/pairs.py``).

    * ``"post"`` with a noise magnitude: integrate without the image, then
      ONE warp of the moving image at ``T + noise``.  At dims >= 64 that
      divide by the block size it is the block-gather warp (kernels B3/B4
      on the card), its overflow counted into ``sat``/``sat_resid``; below,
      ``grid_sample``.
    * otherwise (``"pre"``, or no noise magnitude under either scheme): the
      moving image rides the integration cascade (``SVF3D.integrate(v,
      im)``, kernels B5-B7), then a jitter warp by ``noise`` at radius
      ``max(1, ceil(alpha))`` when ``alpha`` is set.
    * a model without ``integrate`` (``BSplineFFD3D``) or with
      ``use_gather``, under either scheme: ``transformation(v)``, the noise
      added on the normalised grid, one ``grid_sample`` of the image.

    ``sat`` counts voxels whose displacement reaches the bound where the
    path clamps: ``displacement_clamp_bound`` on ``"post"``,
    ``image_clamp_bound`` on the cascade, none on the gather path.  The
    anchored residual warp is not ported (ROADMAP rule).
    """
    if anchor is not None:
        raise NotImplementedError(
            "the anchored residual warp of forward_sample is not ported (ROADMAP "
            "'Rules of the port', Not ported)")
    tr = bundle.transformation
    alpha = bundle.uniform_noise_alpha
    gather = not hasattr(tr, "integrate") or getattr(tr, "use_gather", False)
    post_noise = alpha is not None and bundle.noise_scheme == "post"
    im = moving["im"]
    if per_row and im.ndim != 4:
        raise ValueError(f"per-row images are (C, D, H, W), got {tuple(im.shape)}")
    v = bundle.smooth(v_unsmoothed)
    zero = torch.zeros(v.shape[:-4], dtype=torch.int64, device=v.device)
    anchor_sat = zero

    def sample(t):
        return grid_sample_each(im[:, None], t)[:, 0] if per_row else grid_sample(im, t)

    if gather:
        transformation, displacement = tr(v)
        t = transformation
        if alpha is not None:
            t = t + voxel_to_normalised(noise)
        warped = sample(t)
        clamp_bound = math.inf  # no warp of this path clamps
    elif post_noise:
        transformation, displacement, _ = tr.integrate(v)
        block = int(bundle.block_size)
        if bundle.block_warp and all(s % block == 0 and s >= 8 * block
                                     for s in bundle.dims):
            d_total = displacement + noise
            radius = int(bundle.block_radius)
            bound = int(-(-float(tr.max_disp + alpha) // 1))
            n = d_total.shape[0]
            vol = (im[:, None] if per_row else im.expand((n, 1) + tuple(bundle.dims)))
            vol = vol.contiguous()
            warped = warp_block_gather(vol, d_total, bound, radius, block)[:, 0]
            anchor_sat = block_residual_overflow(d_total.detach(), bound, radius, block)
        else:
            warped = sample(transformation + voxel_to_normalised(noise))
        clamp_bound = float(tr.displacement_clamp_bound)
    else:
        if per_row:  # each row's image rides the cascade as its one channel
            transformation, displacement, warped = tr.integrate(v, im=im[:, None],
                                                                per_row=True)
            warped = warped[:, 0]
        else:
            transformation, displacement, warped = tr.integrate(v, im=im)
        if alpha is not None:
            # the radius covers the magnitude: alpha > 1 is not cut to ±1
            radius = max(1, math.ceil(float(alpha)))
            warped = warp_bounded(warped[:, None], noise, radius)[:, 0]
        clamp_bound = float(tr.image_clamp_bound)
    ndv = count_folds(transformation.detach())
    residuals = bundle.gmm.residual_map(fixed["im"], warped)
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


# ---- the VI iteration ------------------------------------------------------------

class VIState(NamedTuple):
    """``q_v`` fields are ``(3, D, H, W)``; ``gmm`` ``(K,)``; ``reg`` scalars."""

    q_v: dict
    gmm: dict
    reg: dict
    opt_q_v: AdamDecayState
    opt_gmm: AdamDecayState
    opt_reg: AdamDecayState
    key: torch.Tensor  # (2,) int64 key words, on the host
    step: int


def _draws(bundle: ModelBundle, q_v: dict, gen: torch.Generator, batch: int):
    """``(eps, x, unif)`` for one q(v) draw and ``batch`` forward chains."""
    mu = q_v["mu"]
    eps = torch.randn(mu.shape, generator=gen, dtype=mu.dtype, device=mu.device)
    x = torch.randn((), generator=gen, dtype=mu.dtype, device=mu.device)
    unif = None
    if bundle.uniform_noise_alpha is not None:
        unif = uniform_voxel_noise(gen, (batch, 3) + tuple(bundle.dims),
                                   float(bundle.uniform_noise_alpha), mu.device)
    return eps, x, unif


def _step_draws(bundle: ModelBundle, state: VIState, pairs: bool):
    """A step's ``(eps, x, unif)`` from the state's key words and step; for
    a pair-stacked state each pair's own draws, stacked."""
    dev = state.q_v["mu"].device
    if not pairs:
        return _draws(bundle, state.q_v, key_generator(state.key, state.step, dev), 2)
    per_pair = [_draws(bundle, {k: t[i] for k, t in state.q_v.items()},
                       key_generator(state.key[i], int(state.step[i]), dev), 2)
                for i in range(state.key.shape[0])]
    return tuple(None if parts[0] is None else torch.stack(parts) for parts in zip(*per_pair))


def make_vi_step(bundle: ModelBundle, opt_q_v, opt_gmm, opt_reg, fixed: dict,
                 moving: dict, remat: bool = False, pairs: bool = False):
    """Build ``step(state, noise=None) -> (state, metrics)``, one VI iteration.

    The antithetic pair ``mu ± delta`` runs as ONE batch of 2 through
    :func:`forward_sample` (each kernel launch serves both); then, per
    sample in turn, a detached GMM Adam step on its residuals and its data
    term under the updated GMM (reference trainer.py:68-77, :99-101).  The
    gradient of the ELBO loss updates ``q_v`` (and ``reg`` when learnable).

    ``noise``: optional ``(eps, x, unif)`` — the q(v) draw's field normal
    ``(3, *field_dims)`` and scalar normal, and the two chains' uniform noise
    ``(2, 3, D, H, W)`` (None without a noise magnitude).  Without it they
    come from :func:`key_generator` at ``(state.key, state.step)``.

    ``remat=True`` runs the two antithetic chains in turn, each under
    ``torch.utils.checkpoint``: the backward recomputes one chain's forward
    (smoothing, integration, warp, LCC, regulariser) at a time instead of
    holding both chains' activations.  Same draws, same GMM update order,
    same gradients; only the activation schedule changes.

    ``pairs=True``, pair-stacked (images ``(P, D, H, W)`` in ``fixed`` and
    ``moving``, a leading ``(P,)`` axis on every leaf of the state, ``step``
    and the key words included; ``engine/pairs.py``): the P pairs' antithetic samples
    run as ONE batch of 2P (sample ``s`` of pair ``i`` at row ``s·P + i``),
    each pair with its own q(v), GMM, reg and Adam states, and its two GMM
    steps batched over the pairs; losses and metrics are per pair.  Pair
    ``i`` draws from its own key and step, so it takes the draws of its
    single-pair run; ``noise`` is then each pair's ``(eps, x, unif)``
    stacked on a leading ``(P,)`` axis.  Remat runs the 2P rows in turn.
    """
    reg_loss = bundle.reg_loss
    learnable_reg = reg_loss.learnable and len(reg_loss.param_names) > 0
    mask = fixed["mask"]
    q_keys = ("mu", "log_var", "u")

    def rows(t):
        """A per-pair tensor on the forward chain's 2P rows (single pair:
        as it is, broadcast over the two samples)."""
        return torch.cat([t, t]) if pairs else t

    fixed_rows, moving_rows = fixed, moving
    if pairs:
        fixed_rows = {**fixed, "im": rows(fixed["im"])}
        moving_rows = {**moving, "im": rows(moving["im"])}

    def chain_forward(v, unif, reg_p, sl=slice(None)):
        """Per-chain residuals, reg terms and counters of ``v (n, 3, …)``,
        rows ``sl`` of the forward chain."""
        fixed_sl, moving_sl = fixed_rows, moving_rows
        if pairs:
            fixed_sl = {**fixed_rows, "im": fixed_rows["im"][sl]}
            moving_sl = {**moving_rows, "im": moving_rows["im"][sl]}
        out = forward_sample(bundle, fixed_sl, moving_sl, v, unif, per_row=pairs)
        reg, log_y = reg_loss(reg_p, out["v"])
        return out["residuals"], reg, log_y, out["ndv"], out["sat"], out["sat_resid"]

    def forward(v, unif, reg_p):
        reg_rows = {k: rows(t) for k, t in reg_p.items()}
        if not remat:
            return chain_forward(v, unif, reg_rows)
        keys = list(reg_rows)

        def one(sl, v_i, unif_i, *reg_vals):
            return chain_forward(v_i, unif_i, dict(zip(keys, reg_vals)), sl)

        outs = [checkpoint(one, slice(i, i + 1), v[i:i + 1],
                           None if unif is None else unif[i:i + 1],
                           *(t[i:i + 1] if pairs else t for t in reg_rows.values()),
                           use_reentrant=False)
                for i in range(v.shape[0])]
        return tuple(torch.cat(parts) for parts in zip(*outs))

    def loss_fn(q_v, reg_p, gmm, opt_gmm_state, eps, x, unif):
        lead = tuple(q_v["mu"].shape[:-4])  # (P,) pair-stacked, else ()
        if pairs:
            x = x.reshape(lead + (1,) * 4)
        s1, s2 = sample_q_v(None, q_v, antithetic=True, eps=eps, x=x)
        v = torch.stack([s1, s2])
        outs = forward(v.reshape((-1,) + tuple(v.shape[-4:])), unif, reg_p)
        # per sample, then per pair: (2, *lead, …)
        residuals, regs, log_ys, ndv, sat, sat_resid = (
            t.reshape((2,) + lead + tuple(t.shape[1:])) for t in outs)
        ents = entropy_sample(v, q_v["mu"], q_v["log_var"], q_v["u"])

        datas, alphas = [], []
        for i in range(2):
            res = residuals[i]
            a = vd_alpha(bundle, gmm, res, mask)
            gmm, opt_gmm_state = gmm_adam_step(bundle, opt_gmm, gmm, opt_gmm_state,
                                               res, mask, a)
            datas.append(bundle.gmm.masked_nll(gmm, res, mask) * a)
            alphas.append(a)

        data_term = 0.5 * (datas[0] + datas[1]) - bundle.gmm_prior_terms(gmm)
        reg_term = 0.5 * (regs[0] + regs[1])
        if learnable_reg and isinstance(reg_loss, RegLossLogNormal):
            reg_term = reg_term - 0.5 * (bundle.reg_loc_prior(log_ys[0])
                                         + bundle.reg_loc_prior(log_ys[1]))
            reg_term = reg_term - bundle.reg_scale_prior(reg_p["log_scale"])
        elif learnable_reg and isinstance(reg_loss, RegLossL2):
            reg_term = reg_term - bundle.reg_w_reg_prior(reg_p["log_w_reg"])
        entropy_term = 0.5 * (ents[0] + ents[1]) + entropy_analytic(q_v["log_var"], q_v["u"])
        loss = data_term + reg_term - entropy_term
        metrics = {
            "data_term": data_term, "reg_term": reg_term,
            "entropy_term": entropy_term, "total_loss": loss,
            "vd_alpha": alphas[0], "reg_energy": torch.exp(log_ys[0]),
            "ndv": ndv[0], "sat": sat[0], "sat_resid": sat_resid[0],
        }
        return loss, gmm, opt_gmm_state, metrics

    def step(state: VIState, noise=None):
        if noise is None:
            noise = _step_draws(bundle, state, pairs)
        eps, x, unif = noise
        if pairs and unif is not None:  # (P, 2, …) -> the rows s·P + i
            unif = unif.transpose(0, 1).reshape((-1,) + tuple(unif.shape[2:]))
        with torch.enable_grad():
            q_v = {k: state.q_v[k].detach().requires_grad_(True) for k in q_keys}
            reg_keys = list(state.reg)
            reg_p = {k: state.reg[k].detach().requires_grad_(learnable_reg)
                     for k in reg_keys}
            loss, gmm, opt_gmm_state, metrics = loss_fn(
                q_v, reg_p, state.gmm, state.opt_gmm, eps, x, unif)
            wrt = [q_v[k] for k in q_keys]
            if learnable_reg:
                wrt += [reg_p[k] for k in reg_keys]
            grads = torch.autograd.grad(loss.sum(), wrt)

        upd, opt_q_v_state = opt_q_v.update(dict(zip(q_keys, grads[:3])), state.opt_q_v)
        q_v_new = apply_updates({k: state.q_v[k].detach() for k in q_keys}, upd)
        reg_new, opt_reg_state = state.reg, state.opt_reg
        if learnable_reg:
            upd, opt_reg_state = opt_reg.update(dict(zip(reg_keys, grads[3:])),
                                                state.opt_reg)
            reg_new = apply_updates({k: t.detach() for k, t in state.reg.items()}, upd)

        metrics = {k: t.detach() for k, t in metrics.items()}
        # largest voxel-wise L2-norm change per variational parameter
        for name in q_keys:
            old_n = torch.linalg.vector_norm(state.q_v[name], dim=-4)
            new_n = torch.linalg.vector_norm(q_v_new[name], dim=-4)
            metrics[f"max_update_{name}"] = torch.amax(torch.abs(new_n - old_n),
                                                       dim=(-3, -2, -1))
        metrics["gmm_scales"] = GMM.scales(gmm)
        metrics["gmm_proportions"] = GMM.proportions(gmm)
        new_state = VIState(q_v=q_v_new, gmm=gmm, reg=reg_new, opt_q_v=opt_q_v_state,
                            opt_gmm=opt_gmm_state, opt_reg=opt_reg_state,
                            key=state.key, step=state.step + 1)
        return new_state, metrics

    return step


def make_vi_chunk(step_fn, chunk: int):
    """``run(state) -> (state, metrics)``: ``chunk`` VI steps as a Python
    loop; metrics are stacked ``(chunk, …)``."""

    def run(state: VIState):
        per_step = []
        for _ in range(chunk):
            state, metrics = step_fn(state)
            per_step.append(metrics)
        return state, {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    return run


def gmm_warmup(bundle: ModelBundle, opt_gmm, state: VIState, fixed: dict,
               moving: dict, no_steps: int = 25, noise=None) -> VIState:
    """Data-driven GMM init and warm-up (reference trainer.py:529-547).

    Draws one q(v) sample, computes its residuals, spreads the component
    scales over the residual std-dev, then takes ``no_steps`` detached Adam
    steps.  ``noise``: optional ``(eps, x, unif)`` with ``unif (1, 3, D, H,
    W)``; without it the draws come from a salted :func:`key_generator`,
    and the returned state carries a fresh key from the same generator (the
    JAX package splits its key here likewise).
    """
    key = state.key
    if noise is None:
        gen = key_generator(state.key, state.step, state.q_v["mu"].device, salt=1)
        noise = _draws(bundle, state.q_v, gen, 1)
        key = torch.randint(0, 2 ** 32, (2,), generator=gen, dtype=torch.int64,
                            device=gen.device).cpu()
    eps, x, unif = noise
    with torch.no_grad():
        v = sample_q_v(None, state.q_v, eps=eps, x=x)
        res = forward_sample(bundle, fixed, moving, v[None], unif)["residuals"][0]
    mask = fixed["mask"]
    n = torch.sum(mask)
    mean = torch.sum(torch.where(mask, res, torch.zeros_like(res))) / n
    var = torch.sum(torch.where(mask, (res - mean) ** 2, torch.zeros_like(res))) / (n - 1)
    gmm = bundle.gmm.init_scales_from_residual_std(state.gmm, torch.sqrt(var))
    alpha = vd_alpha(bundle, gmm, res, mask)
    opt_state = state.opt_gmm
    for _ in range(no_steps):
        gmm, opt_state = gmm_adam_step(bundle, opt_gmm, gmm, opt_state, res, mask, alpha)
    return state._replace(gmm=gmm, opt_gmm=opt_state, key=key)
