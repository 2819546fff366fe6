"""SG-MCMC engine: preconditioned SGLD over a batch of chains (port of
``ir_sgmcmc_tpu/engine/mcmc.py``).

    v'     = v + sqrt(2 tau) * sigma * eps
    v_next = v' - tau * sigma² * grad U(v')

Chains are the leading axis of every tensor; one transition launches each
kernel once for all chains.  GMM and regularisation parameters are per
chain, as in the JAX engine's default, or one shared set
(``param_mode="shared"``, the reference's semantics).

Randomness: each chain carries the two 32-bit words of a key
(``MCMCState.key``, ``(C, 2)`` int64 on the host).  A transition seeds one
``torch.Generator`` on the state's device per chain from its key and the
step count, so a state (and its conversion from the JAX package) fully
determines the run; the draws are torch's, not threefry's.  Tests inject
the JAX draws through ``noise=(eps, unif)`` instead.  Cutting the chains
over a device mesh (``make_mcmc_chunk(chain_mesh=...)``) therefore keeps
every chain's stream.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve_device
from ..parallel.mesh import Sharded, gather, run_in_turns
from ..models.gmm import GMM
from ..models.reg_loss import RegLossL2, RegLossLogNormal
from ..models.sampler import langevin_noise, sample_q_v, uniform_voxel_noise
from ..ops._layout import OneDevice
from ..ops.grids import inv_jacobian
from ..ops.resample import grid_sample
from ..optim.adam_decay import AdamDecayState, apply_updates
from ..utils.spans import (BOOKKEEPING, INTEGRATE, LIKELIHOOD, MCMC_STEP, REGULARISER, SMOOTH,
                           UPDATE, WARP, span)
from .bundle import ModelBundle
from .vi import _ONE_CARD, forward_sample, gmm_adam_step, key_generator, vd_alpha


class WelfordState(NamedTuple):
    count: torch.Tensor  # (C,)
    mean: torch.Tensor  # (C, 3, D, H, W)
    m2: torch.Tensor


def welford_init(no_chains: int, shape, device=None) -> WelfordState:
    """Zero accumulators on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    z = torch.zeros((no_chains,) + tuple(shape), dtype=torch.float32, device=device)
    return WelfordState(torch.zeros((no_chains,), dtype=torch.float32, device=device),
                        z, z.clone())


def welford_update(w: WelfordState, x: torch.Tensor, weight: float) -> WelfordState:
    """Weighted (0/1-gated) Welford update; ``weight`` gates thinning."""
    count = w.count + weight
    safe = _bcast(torch.clamp(count, min=1.0), x)
    delta = x - w.mean
    mean = w.mean + weight * delta / safe
    m2 = w.m2 + weight * delta * (x - mean)
    return WelfordState(count, mean, m2)


def welford_finalize(w: WelfordState):
    """``(mean, std)`` with the sample (ddof=1) normalisation."""
    var = w.m2 / torch.clamp(w.count - 1.0, min=1.0)
    return w.mean, torch.sqrt(var)


def welford_merge(ws: WelfordState) -> WelfordState:
    """Merge per-chain accumulators (leading axis) by Chan's parallel rule."""
    acc = WelfordState(ws.count[0], ws.mean[0], ws.m2[0])
    for i in range(1, ws.count.shape[0]):
        b = WelfordState(ws.count[i], ws.mean[i], ws.m2[i])
        n = acc.count + b.count
        safe = torch.clamp(n, min=1.0)
        delta = b.mean - acc.mean
        mean = acc.mean + delta * b.count / safe
        m2 = acc.m2 + b.m2 + delta ** 2 * acc.count * b.count / safe
        acc = WelfordState(n, mean, m2)
    return acc


def _bcast(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return s.reshape(tuple(s.shape) + (1,) * (like.ndim - s.ndim))


class MCMCState(NamedTuple):
    """Every tensor carries a leading ``(C,)`` chain axis, except ``step``
    and, in the shared parameter mode, the GMM/reg leaves and their
    optimizer states."""

    v: torch.Tensor  # (C, 3, *field_dims)
    sigma: torch.Tensor  # (C, 3, *field_dims) SGLD preconditioner
    gmm: dict
    reg: dict
    opt_gmm: AdamDecayState
    opt_reg: AdamDecayState
    welford: WelfordState
    key: torch.Tensor  # (C, 2) int64 key words, on the host
    step: int


def init_chains(bundle: ModelBundle, generator: torch.Generator, no_chains: int,
                mode: str, q_v: dict | None, gmm: dict, reg: dict,
                opt_gmm, opt_reg, device=None, param_mode: str = "per_chain") -> MCMCState:
    """SGLD state init (reference trainer.py:586-611).

    ``mode``: ``'VI'`` (per-chain q(v) draws, sigma from the VI log-var),
    ``'identity'`` (zeros, sigma 1) or ``'noise'`` (standard normal, sigma
    1).  ``generator`` draws the initial state and the chains' keys; it
    must live on ``device`` (default: the CUDA card).  ``v`` and ``sigma``
    live on ``bundle.field_dims`` (the control grid for SVFFD), the Welford
    accumulators on the dense ``bundle.dims``.  ``param_mode``:
    ``"per_chain"`` replicates the GMM/reg parameters per chain,
    ``"shared"`` keeps one set.
    """
    device = resolve_device(device)
    shape =(no_chains, 3) + tuple(bundle.field_dims)
    if mode == "VI":
        if q_v is None:
            raise ValueError("MCMC_init='VI' requires fitted q(v) params")
        q_v = {k: t.to(device) for k, t in q_v.items()}
        v = torch.stack([sample_q_v(generator, q_v) for _ in range(no_chains)])
        sigma = torch.exp(0.5 * q_v["log_var"]).expand(shape).contiguous()
    elif mode == "identity":
        v = torch.zeros(shape, dtype=torch.float32, device=device)
        sigma = torch.ones(shape, dtype=torch.float32, device=device)
    elif mode == "noise":
        v = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        sigma = torch.ones(shape, dtype=torch.float32, device=device)
    else:
        raise ValueError(f"unknown MCMC init mode: {mode}")

    if param_mode == "shared":
        batch = ()

        def rep(t):
            return t.to(device).clone()
    elif param_mode == "per_chain":
        batch = (no_chains,)

        def rep(t):
            return t.to(device).expand((no_chains,) + tuple(t.shape)).clone()
    else:
        raise ValueError(f"unknown MCMC_params: {param_mode!r}")

    gmm_c = {k: rep(t) for k, t in gmm.items()}
    reg_c = {k: rep(t) for k, t in reg.items()}
    words = torch.randint(0, 2 ** 32, (no_chains, 2), generator=generator,
                          dtype=torch.int64, device=device).cpu()
    return MCMCState(
        v=v, sigma=sigma, gmm=gmm_c, reg=reg_c,
        opt_gmm=opt_gmm.init(gmm_c, batch),
        opt_reg=opt_reg.init(reg_c, batch),
        welford=welford_init(no_chains, (3,) + tuple(bundle.dims), device),
        key=words, step=0)


def _chain_noise(bundle: ModelBundle, state: MCMCState, device=None):
    """Per-chain ``(eps, unif)`` of the whole field from generators seeded by
    (key, step) on ``device`` (default: the state's): ``eps`` on
    ``bundle.field_dims``, ``unif`` on the dense ``bundle.dims`` (None
    without a noise magnitude).  A spatially sharded row draws it on each
    slab's device and keeps the slab."""
    C, alpha = state.v.shape[0], bundle.uniform_noise_alpha
    dev = state.v.device if device is None else device
    eps = (torch.empty_like(state.v) if device is None  # a whole state: its own layout
           else torch.empty((C, 3) + tuple(bundle.field_dims), dtype=state.v.dtype, device=dev))
    unif = None if alpha is None else torch.empty((C, 3) + tuple(bundle.dims), device=dev)
    for c in range(C):
        gen = key_generator(state.key[c], state.step, dev)
        eps[c] = torch.randn(eps.shape[1:], generator=gen, device=dev)
        if unif is not None:
            unif[c] = uniform_voxel_noise(gen, (3,) + tuple(bundle.dims), alpha, dev)
    return eps, unif


def _reg_terms(bundle: ModelBundle, reg_p: dict, v_smooth, layout: OneDevice = _ONE_CARD):
    """Per-chain reg energies' losses and ``log y``, and the hyperprior
    terms: the loc prior per chain, the scale (or weight) prior once per
    parameter set."""
    reg_loss = bundle.reg_loss
    reg, log_y = reg_loss(reg_p, v_smooth, layout)
    prior = torch.zeros_like(reg)
    per_set = 0.0
    if reg_loss.learnable and isinstance(reg_loss, RegLossLogNormal):
        prior = bundle.reg_loc_prior(log_y)
        per_set = bundle.reg_scale_prior(reg_p["log_scale"])
    elif reg_loss.learnable and isinstance(reg_loss, RegLossL2):
        per_set = bundle.reg_w_reg_prior(reg_p["log_w_reg"])
    return reg, log_y, prior, per_set


def make_chain_anchor(bundle: ModelBundle, moving: dict, anchor_mode: str = "taylor",
                      layout: OneDevice = _ONE_CARD):
    """``anchor(v) -> dict``: the chains' anchor for anchored residual
    warping (JAX ``make_chain_anchor``), made once per re-anchoring block
    from the chains' unsmoothed ``v (C, 3, *field_dims)``, with no gradient:
    ``W0 = moving ∘ T0`` (``grid_sample``) ``(C, D, H, W)``, the
    displacement ``d0 (C, 3, D, H, W)``, the frame map ``Jinv = (I +
    ∇d0)⁻¹`` clipped to ±3 ``(C, 3, 3, D, H, W)`` (a near-folded anchor
    voxel would otherwise put ~1/det factors into the residual map), and in
    the ``"taylor"`` mode ``GW0 = ∇W0 (C, 3, D, H, W)``.  The integration
    runs forward only (kernels B1 on the main path).  ``layout``: the
    forward chain's."""
    if anchor_mode not in ("taylor", "blend"):
        raise ValueError(f"anchor_mode must be 'taylor' or 'blend', got {anchor_mode!r}")
    L = layout

    def anchor(v_unsmoothed: torch.Tensor) -> dict:
        with torch.no_grad():
            with span(SMOOTH):
                v = L.smooth(bundle, v_unsmoothed)
            with span(INTEGRATE):
                transformation, d0, _ = L.integrate(bundle.transformation, v)
            with span(WARP):
                w0 = L.map(grid_sample, moving["im"], transformation)
                eye = L.map(_eye3, d0)
                out = {"W0": w0, "d0": d0,
                       "Jinv": torch.clamp(inv_jacobian(eye + L.gradient(d0)), -3.0, 3.0)}
                if anchor_mode == "taylor":
                    out["GW0"] = L.gradient(w0.unsqueeze(-4))[:, 0]
        return out

    return anchor


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).reshape(3, 3, 1, 1, 1)


def _potential(bundle: ModelBundle, opt_gmm, mask, out: dict, reg_p: dict, gmm: dict,
               opt_gmm_state, shared: bool = False, layout: OneDevice = _ONE_CARD) -> tuple:
    """The potential of the chains' forward chain ``out`` and its aux: the
    detached GMM Adam step(s), the data and reg terms and their hyperpriors
    (``shared``: :func:`make_sgld_transition_shared`'s)."""
    res = out["residuals"]
    with span(LIKELIHOOD):
        if shared:
            # one GMM, C sequential detached Adam steps: chain c's data
            # term sees the GMM after its own step
            datas, alphas = [], []
            for c in range(res.shape[0]):
                a = vd_alpha(bundle, gmm, res[c], mask, layout)
                gmm, opt_gmm_state = gmm_adam_step(bundle, opt_gmm, gmm, opt_gmm_state,
                                                   res[c], mask, a, layout)
                datas.append(bundle.gmm.masked_nll(gmm, res[c], mask, layout) * a)
                alphas.append(a)
            data_c, alpha = torch.stack(datas), torch.stack(alphas)
            data_total = data_c.sum() - bundle.gmm_prior_terms(gmm)
        else:
            alpha = vd_alpha(bundle, gmm, res, mask, layout)
            gmm, opt_gmm_state = gmm_adam_step(bundle, opt_gmm, gmm, opt_gmm_state,
                                               res, mask, alpha, layout)
            data_c = bundle.gmm.masked_nll(gmm, res, mask, layout) * alpha
            data_c = data_c - bundle.gmm_prior_terms(gmm)
            data_total = data_c
    with span(REGULARISER):
        reg, log_y, loc_prior, per_set = _reg_terms(bundle, reg_p, out["v"], layout)
        reg_c = reg if shared else reg - loc_prior - per_set
        # shared: the hyperpriors enter once per transition
        reg_total = (reg.sum() - loc_prior.sum() - per_set) if shared else reg_c
    with span(BOOKKEEPING):
        aux = {"gmm": gmm, "opt_gmm": opt_gmm_state, "data_term": data_c,
               "reg_term": reg_c, "vd_alpha": alpha,
               "reg_energy": torch.exp(log_y), "ndv": out["ndv"],
               "sat": out["sat"], "sat_resid": out["sat_resid"],
               "displacement": out["displacement"]}
    with span(UPDATE):
        return data_total + reg_total, aux


def _transition_metrics(aux: dict, chains: int, shared: bool = False) -> dict:
    """A transition's metrics from :func:`_potential`'s aux."""
    metrics = {k: aux[k].detach() for k in (
        "data_term", "reg_term", "vd_alpha", "reg_energy", "ndv", "sat", "sat_resid")}
    for name, f in (("gmm_scales", GMM.scales), ("gmm_proportions", GMM.proportions)):
        val = f(aux["gmm"])
        metrics[name] = val.expand((chains,) + tuple(val.shape)) if shared else val
    return metrics


def make_sgld_transition(bundle: ModelBundle, opt_gmm, opt_reg, tau: float,
                         fixed: dict, moving: dict, param_mode: str = "per_chain",
                         per_row: bool = False, anchor_radius: int = 2):
    """Build ``transition(state, collect_weight, noise=None, anchor=None) ->
    (state, metrics)`` over all chains of ``state``.

    ``noise``: optional ``(eps, unif)`` — the standard-normal Langevin draw
    ``(C, 3, *field_dims)`` and the ``U(-alpha, alpha)`` voxel noise ``(C, 3,
    D, H, W)``.  Without it they come from the chains' generators.  The
    returned state keeps ``step``; :func:`make_mcmc_chunk` advances it.

    ``param_mode``: ``"per_chain"`` (every chain its own GMM/reg set and
    optimizer states, leading ``(C,)`` axis) or ``"shared"`` (the
    reference's semantics, :func:`make_sgld_transition_shared`).

    ``per_row``: the images of ``fixed`` and ``moving`` are ``(C, D, H,
    W)``, one per chain (the folded pairs of ``engine/pairs.py``), not one
    ``(D, H, W)`` pair shared by the chains.

    ``anchor``: the chains' anchor (:func:`make_chain_anchor`); the image
    warp is then the anchored residual warp at ``anchor_radius``
    (``engine.vi.forward_sample``).
    """
    if param_mode not in ("per_chain", "shared"):
        raise ValueError(f"unknown MCMC_params: {param_mode!r}")
    shared = param_mode == "shared"
    mask = fixed["mask"]

    def potential(v_noised, reg_p, gmm, opt_gmm_state, unif, anchor):
        # the forward chain does not read the GMM, so it runs as one batch
        # over the chains in either mode
        out = forward_sample(bundle, fixed, moving, v_noised, unif, anchor=anchor,
                             per_row=per_row, anchor_radius=anchor_radius)
        return _potential(bundle, opt_gmm, mask, out, reg_p, gmm, opt_gmm_state, shared)

    learnable_reg = bundle.reg_loss.learnable and len(bundle.reg_loss.param_names) > 0

    def transition(state: MCMCState, collect_weight: float, noise=None, anchor=None):
        with span(UPDATE):
            if noise is None:
                noise = _chain_noise(bundle, state)
            eps, unif = noise
        with torch.enable_grad():
            with span(UPDATE):
                v_noised = (state.v + langevin_noise(None, state.sigma, tau, eps)
                            ).detach().requires_grad_(True)
            reg_keys = list(state.reg)
            reg_p = {k: state.reg[k].detach().requires_grad_(learnable_reg)
                     for k in reg_keys}
            loss, aux = potential(v_noised, reg_p, state.gmm, state.opt_gmm, unif, anchor)
            wrt = [v_noised] + ([reg_p[k] for k in reg_keys] if learnable_reg else [])
            with span(UPDATE):
                grads = torch.autograd.grad(loss.sum(), wrt)
        with span(UPDATE):
            g_v = grads[0]
            v_next = v_noised.detach() - tau * state.sigma ** 2 * g_v

            reg_new, opt_reg_state = state.reg, state.opt_reg
            if learnable_reg:
                # shared: one step on the gradient summed over the chains
                upd, opt_reg_state = opt_reg.update(dict(zip(reg_keys, grads[1:])),
                                                    state.opt_reg)
                reg_new = apply_updates({k: t.detach() for k, t in state.reg.items()}, upd)

        with span(BOOKKEEPING):
            disp = aux["displacement"].detach()
            new_state = state._replace(
                v=v_next, gmm=aux["gmm"], reg=reg_new, opt_gmm=aux["opt_gmm"],
                opt_reg=opt_reg_state,
                welford=welford_update(state.welford, disp, collect_weight))
            metrics = _transition_metrics(aux, state.v.shape[0], shared)
        return new_state, metrics

    return transition


def make_sgld_transition_shared(bundle: ModelBundle, opt_gmm, opt_reg, tau: float,
                                fixed: dict, moving: dict):
    """The reference's transition over ALL chains with one SHARED GMM/reg
    parameter set: the GMM takes ``C`` sequential detached Adam steps per
    transition, chain ``c``'s data term under the GMM after its own step;
    the reg parameters one Adam step on the gradient summed over the
    chains; the hyperpriors enter once per transition.  The state's GMM and
    reg leaves and their optimizer states carry no chain axis
    (``init_chains(..., param_mode="shared")``)."""
    return make_sgld_transition(bundle, opt_gmm, opt_reg, tau, fixed, moving,
                                param_mode="shared")


def make_mcmc_chunk(bundle: ModelBundle, opt_gmm, opt_reg, tau: float,
                    fixed: dict, moving: dict, chunk: int, burn_in: int,
                    thin: int, param_mode: str = "per_chain", per_row: bool = False,
                    chain_mesh=None, anchored: bool = False, anchor_radius: int = 2,
                    anchor_mode: str = "taylor", anchor_period: int = 25):
    """``run(state, noise=None) -> (state, metrics)``: ``chunk`` SGLD
    transitions over all chains as a Python loop; metrics are stacked
    ``(chunk, C, …)``.  ``noise``: ``chunk`` ``(eps, unif)`` draws (see
    :func:`make_sgld_transition`) in place of the chains' own.

    Thinned displacement samples feed the per-chain Welford accumulators
    once past ``burn_in`` (every ``thin`` steps).  ``param_mode`` and
    ``per_row``: see :func:`make_sgld_transition`.

    ``anchored``: anchored residual warping (``trainer.mcmc_anchor``, off
    by default; the JAX package records it as a negative result).  Every
    ``min(max(anchor_period, 1), chunk)`` transitions from the chunk's start,
    the chains are re-anchored (:func:`make_chain_anchor` in ``anchor_mode``)
    and the transitions warp the anchored image by the residual at
    ``anchor_radius``; a chunk the period does not divide ends with a shorter
    block.  Off, silently, as in the JAX package, under ``param_mode
    "shared"``, the ``"pre"`` scheme, a model without ``integrate`` and
    ``use_gather``: those chunks run the per-step exact warp.

    ``chain_mesh``: a ``('chain',)`` mesh (``parallel.make_mesh``); ``run``
    then takes and returns a chain-sharded state
    (``parallel.shard_chain_state``) and each device runs the transition on
    its own chains, with the images copied to it once.  The devices take
    turns at every transition, so no card's launch queue fills while
    another waits, and nothing in a chunk waits on a device, so the cards
    run at once.  Every chain draws its own stream (its key words and the
    step), so the chains follow the trajectories of the unsharded run.  The
    metrics come back gathered on the mesh's first device.  Per-chain
    parameter sets only, as in the JAX engine (a shared set steps every
    chain in turn); each device anchors its own chains.

    Spatially sharded (``fixed`` and ``moving`` placed by
    ``parallel.shard_images_spatial`` over a ``('chain', 'space')`` mesh):
    ``run(state, noise=None)`` takes and returns a
    ``parallel.shard_state_spatial`` state, each row of the ``'space'``
    axis running its chains' transition cut along D over its devices
    (``parallel/spatial.py``; per-chain sets, every option of the dense ``SVF3D``).
    ``noise``: ``chunk`` whole ``(eps, unif)`` draws over all chains.
    Each row anchors its own chains.
    """
    tr = bundle.transformation
    anchored = (bool(anchored) and param_mode != "shared" and bundle.noise_scheme == "post"
                and hasattr(tr, "integrate") and not getattr(tr, "use_gather", False))
    if anchored and per_row:
        raise ValueError("an anchored chunk takes one image pair (the trainer registers "
                         "the pairs of an anchored run in turn)")
    period = min(max(int(anchor_period), 1), chunk)
    if isinstance(fixed, Sharded):
        from ..parallel.spatial import make_mcmc_chunk_sharded

        if param_mode != "per_chain" or per_row or chain_mesh is not None:
            raise ValueError("a spatially sharded chunk takes per-chain sets, one image pair "
                             "and no chain_mesh")
        return make_mcmc_chunk_sharded(bundle, opt_gmm, opt_reg, tau, fixed, moving, chunk,
                                       burn_in, thin, anchored=anchored,
                                       anchor_radius=anchor_radius, anchor_mode=anchor_mode,
                                       anchor_period=period)
    if chain_mesh is None:
        transition = make_sgld_transition(bundle, opt_gmm, opt_reg, tau, fixed, moving,
                                          param_mode, per_row, anchor_radius)
        anchor_fn = make_chain_anchor(bundle, moving, anchor_mode) if anchored else None

        def run(state: MCMCState, noise=None):
            step = _sgld_step(transition, burn_in, thin, anchor_fn, period, noise)
            (state,), (metrics,) = run_in_turns([step], [state], chunk)
            return state, metrics

        return run
    if param_mode != "per_chain":
        raise ValueError("a chain mesh needs per-chain GMM/reg sets (MCMC_params 'per_chain')")
    devices = chain_mesh.device_list

    def on(images: dict, i: int, dev) -> dict:
        # per-row images are cut with the chains, shared ones copied
        n = len(devices)
        return {k: (t.chunk(n)[i] if per_row else t).to(dev) for k, t in images.items()}

    images = [(on(fixed, i, dev), on(moving, i, dev)) for i, dev in enumerate(devices)]
    transitions = [make_sgld_transition(bundle, opt_gmm, opt_reg, tau, f, m, param_mode,
                                        per_row, anchor_radius) for f, m in images]
    # each device anchors its own chains
    anchor_fns = [make_chain_anchor(bundle, m, anchor_mode) if anchored else None
                  for _, m in images]

    def run(state: Sharded):
        steps = [_sgld_step(t, burn_in, thin, a, period)
                 for t, a in zip(transitions, anchor_fns)]
        shards, metrics = run_in_turns(steps, list(state), chunk)
        dev0 = devices[0]
        return Sharded(shards, state.mesh, state.cuts), {
            k: torch.cat([m[k].to(dev0) for m in metrics], dim=1) for k in metrics[0]}

    return run


def _sgld_weight(n: int, burn_in: int, thin: int) -> float:
    """The Welford weight of transition ``n`` (1-based): 1 for a thinned
    sample past ``burn_in``, else 0."""
    return 1.0 if n > burn_in and (n - burn_in) % thin == 0 else 0.0


def _sgld_step(transition, burn_in: int, thin: int, anchor_fn=None, period: int = 1,
               noise=None):
    """``state -> (state, metrics)``: one transition, its thinned sample fed
    to the Welford accumulators once past ``burn_in``.  With ``anchor_fn``,
    the chains are re-anchored before the first step and every ``period``
    steps after it (one step per chunk's run: build it per run).  ``noise``:
    the steps' draws, in order."""
    feed = None if noise is None else iter(noise)
    taken, anchor = [0], [None]

    def step(state: MCMCState):
        with span(MCMC_STEP):
            if anchor_fn is not None and taken[0] % period == 0:
                anchor[0] = anchor_fn(state.v)
            taken[0] += 1
            n = state.step + 1
            state, metrics = transition(state, _sgld_weight(n, burn_in, thin),
                                        noise=None if feed is None else next(feed),
                                        anchor=anchor[0])
            return state._replace(step=n), metrics

    return step


def posterior_statistics(state):
    """Pooled posterior mean/std of the displacement over all chains; a
    chain- or space-sharded state is gathered first (on the mesh's first
    device)."""
    if isinstance(state, Sharded):
        state = gather(state)
    return welford_finalize(welford_merge(state.welford))

