"""Pair-stacked SG-MCMC transitions and VI steps of the port against the JAX
package's pair-stacked chunks (``ir_sgmcmc_tpu/engine/pairs.py``, on a
one-device pair mesh), on the same inputs: each pair's own images, GMM and
chains, and JAX's own draws injected into the port.

* The transition folds P = 2 pairs x C = 2 chains into the P·C rows of
  ``make_sgld_transition(per_row=True)`` with ``fold_chains`` and
  ``chain_rows``, the layout ``make_pair_mcmc_chunk`` runs: at 64³ on "post"
  the image warp is the block-gather warp with a per-row moving volume, at
  32³ on "pre" the image rides the integration cascade as each row's one
  channel.
* The VI step runs ``make_vi_step(pairs=True)`` on 2 pairs at 32³ on either
  scheme: one batch of 2P rows with per-pair q(v), GMM, reg and Adam states.

Each pair's rows are held to the tolerances of the single-pair tests, for
the reasons given there: ``test_transition_matches_jax``
(tests/test_torch_engine.py) and ``test_vi_step_matches_jax``
(tests/test_torch_vi.py); the one exception, the transition's Adam moments
on "post", is stated in its test.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ir_sgmcmc_tpu.data import sphere_pair
from ir_sgmcmc_tpu.engine import ModelBundle as JBundle
from ir_sgmcmc_tpu.engine import init_chains as j_init_chains
from ir_sgmcmc_tpu.engine.pairs import make_pair_mcmc_chunk as j_pair_mcmc_chunk
from ir_sgmcmc_tpu.engine.pairs import make_pair_mesh
from ir_sgmcmc_tpu.engine.pairs import make_pair_vi_chunk as j_pair_vi_chunk
from ir_sgmcmc_tpu.engine.pairs import stack_trees as j_stack
from ir_sgmcmc_tpu.engine.vi import VIState as JVIState
from ir_sgmcmc_tpu.engine.vi import gmm_warmup as j_gmm_warmup
from ir_sgmcmc_tpu.models import (GMM, SVF3D, DirichletPrior, LogEnergyExpGammaPrior,
                                  LogScaleNormalPrior, langevin_noise)
from ir_sgmcmc_tpu.models.reg_loss import RegLossLogNormal
from ir_sgmcmc_tpu.optim import adam_decay
from ir_sgmcmc_tpu_torch import engine as teng
from ir_sgmcmc_tpu_torch import models as tmod
from ir_sgmcmc_tpu_torch.convert import (mcmc_state_from_numpy, mcmc_state_to_numpy,
                                         vi_state_from_numpy)
from ir_sgmcmc_tpu_torch.engine.mcmc import make_sgld_transition
from ir_sgmcmc_tpu_torch.engine.pairs import (chain_rows, fold_chains, stack_trees,
                                              unfold_chains, unstack_tree)
from ir_sgmcmc_tpu_torch.models.sampler import langevin_noise as t_langevin
from ir_sgmcmc_tpu_torch.optim import adam_decay as t_adam

ALPHA = 0.1
PAIRS, CHAINS = 2, 2
OFFSETS = ((0.0, 0.0, 4.0), (0.0, 3.0, 1.0))
LR_Q = {"mu": 0.01, "log_var": 0.01, "u": 0.01}
LR_GMM = {"log_std": 0.2, "logits": 0.2}
LR_REG = {"loc": 0.01, "log_scale": 0.01}


def _bundles(dims, scheme):
    """``bench.py:_make_bundle_and_pair`` in both packages."""
    dof = 3.0 * math.prod(dims)
    common = dict(dims=dims, sobolev_s=3, sobolev_lambda=0.5, uniform_noise_alpha=ALPHA,
                  noise_scheme=scheme, virtual_decimation=True)
    jb = JBundle(gmm=GMM(4, 1), scale_prior=LogScaleNormalPrior(0.0, 2.3),
                 proportion_prior=DirichletPrior(4, 0.5),
                 reg_loss=RegLossLogNormal(w_reg=1.4, dims=dims, learnable=True),
                 reg_loc_prior=LogEnergyExpGammaPrior(w_reg=1.4, dof=dof),
                 reg_scale_prior=LogScaleNormalPrior(loc=2.8, scale=5.0),
                 transformation=SVF3D(dims, no_steps=12), **common)
    tb = teng.ModelBundle(
        gmm=tmod.GMM(4, 1), scale_prior=tmod.LogScaleNormalPrior(0.0, 2.3),
        proportion_prior=tmod.DirichletPrior(4, 0.5),
        reg_loss=tmod.RegLossLogNormal(w_reg=1.4, dims=dims, learnable=True),
        reg_loc_prior=tmod.LogEnergyExpGammaPrior(w_reg=1.4, dof=dof),
        reg_scale_prior=tmod.LogScaleNormalPrior(loc=2.8, scale=5.0),
        transformation=tmod.SVF3D(dims, no_steps=12), **common)
    return jb, tb


def _pair_images(dims):
    """Each pair's own sphere pair, pair-stacked: ``(jax (fixed, moving),
    port (fixed, moving))`` and the JAX pairs one by one."""
    pairs = [sphere_pair(dims, offset=o, seed=i) for i, o in enumerate(OFFSETS)]
    stacked = [{k: np.stack([p[s][k] for p in pairs]) for k in pairs[0][s]} for s in (0, 1)]
    j_st = tuple({k: jnp.asarray(v) for k, v in d.items()} for d in stacked)
    t_st = tuple({k: torch.as_tensor(v) for k, v in d.items()} for d in stacked)
    singles = [tuple({k: jnp.asarray(v) for k, v in d.items()} for d in p) for p in pairs]
    return j_st, t_st, singles


def _np(tree):
    """Copies: the JAX chunks donate their input state."""
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _warm_gmm(jb, i):
    """A GMM as the trainer's warm-up leaves it (spread scales, unequal
    logits), different for each pair."""
    gmm = jb.gmm.init_scales_from_residual_std(jb.gmm.init_params(), 1.0 + 0.1 * i)
    gmm["logits"] = jnp.asarray([0.3, -0.2, 0.1, -0.4], jnp.float32) * (1 + i)
    return gmm


def _chain_draws(keys, dims, sigma, tau):
    """A transition's own draws per chain: ``split(key, 3)`` -> the Langevin
    noise from the second key, the uniform noise from the third."""
    eps, noise, unif = [], [], []
    for c in range(keys.shape[0]):
        _, k_noise, k_unif = jax.random.split(jnp.asarray(keys[c]), 3)
        eps.append(np.asarray(jax.random.normal(k_noise, (3,) + dims, jnp.float32)))
        noise.append(np.asarray(langevin_noise(k_noise, jnp.asarray(sigma[c]), tau)))
        unif.append(np.asarray(jax.random.uniform(k_unif, (3,) + dims, jnp.float32,
                                                  -ALPHA, ALPHA)))
    return np.stack(eps), np.stack(noise), np.stack(unif)


@pytest.mark.parametrize("dims,tau,scheme", [
    pytest.param((64, 64, 64), 1e-5, "post", id="post-64-1e-05"),
    pytest.param((32, 32, 32), 1e-2, "pre", id="pre-32-0.01"),
])
def test_pair_transition_matches_jax_pair_chunk(dims, tau, scheme):
    """One pair-stacked transition of 2 pairs x 2 chains; each pair's rows
    against JAX's pair-stacked chunk, at ``test_transition_matches_jax``'s
    tolerances: σ²∇U read back from ``v_next`` within 1e-3 RMS and 2% of
    its maximum above the rounding floor, loss terms 1e-4 relative,
    counters equal, the GMM/reg parameters 1e-5, the Welford means 1e-4.
    The Adam moments are held to 3e-4 relative on both schemes, the single
    test's bound for "pre": the GMM gradient is a sum over the volume that
    XLA accumulates in f32, and ``nu ∝ g²`` doubles its relative error.  At
    64³ on "post" one moment element in some runs of the JAX pair chunk came
    out 1.3e-4 to 1.45e-4 off, varying from run to run of the same inputs."""
    moment_rtol = 3e-4
    jb, tb = _bundles(dims, scheme)
    (jf, jm), (tf, tm), _ = _pair_images(dims)
    og, orr = adam_decay(0.2, 1e-3), adam_decay(LR_REG, 1e-3)
    states_j = [j_init_chains(jb, jax.random.PRNGKey(10 + i), no_chains=CHAINS, mode="noise",
                              q_v=None, gmm=_warm_gmm(jb, i), reg=jb.reg_loss.init_params(),
                              opt_gmm=og, opt_reg=orr) for i in range(PAIRS)]
    trees = [_np(s) for s in states_j]
    run = j_pair_mcmc_chunk(jb, og, orr, tau, jf, jm, chunk=1, burn_in=0, thin=1,
                            mesh=make_pair_mesh(PAIRS, 1))
    new_j, met_j = run(j_stack(states_j))
    new_j, met_j = _np(new_j), {k: np.asarray(v) for k, v in met_j.items()}

    draws = [_chain_draws(t.key, dims, t.sigma, tau) for t in trees]
    eps = torch.as_tensor(np.concatenate([d[0] for d in draws]))
    unif = torch.as_tensor(np.concatenate([d[2] for d in draws]))
    state_t = stack_trees([mcmc_state_from_numpy(t, device="cpu") for t in trees])
    folded = fold_chains(state_t)
    trans = make_sgld_transition(tb, t_adam(0.2, 1e-3), t_adam(LR_REG, 1e-3), tau,
                                 chain_rows(tf, CHAINS), chain_rows(tm, CHAINS), per_row=True)
    new_t, met_t = trans(folded, 1.0, noise=(eps, unif))
    new_t = unfold_chains(new_t, PAIRS)
    met_t = {k: m.reshape((PAIRS, CHAINS) + tuple(m.shape[1:])) for k, m in met_t.items()}
    vp_all = (folded.v + t_langevin(None, folded.sigma, tau, eps)).reshape(
        (PAIRS, CHAINS) + tuple(folded.v.shape[1:])).numpy()

    for i, (tree, (_, noise_j, _)) in enumerate(zip(trees, draws)):
        ref = jax.tree.map(lambda x: x[i], new_j)
        vp_j, vp_t = tree.v + noise_j, vp_all[i]
        np.testing.assert_allclose(vp_t, vp_j, atol=1e-6)  # same draw, same v'
        q_j = (vp_j - ref.v) / tau
        dq = (vp_t - new_t.v[i].numpy()) / tau - q_j
        floor = 8 * np.finfo(np.float32).eps * np.abs(vp_j).max() / tau
        rms = np.sqrt(np.mean(dq ** 2)), np.sqrt(np.mean(q_j ** 2))
        assert rms[0] <= floor / 8 + 1e-3 * rms[1], (i, rms)
        assert np.abs(dq).max() <= floor + 2e-2 * np.abs(q_j).max(), i
        for k in ("ndv", "sat", "sat_resid"):
            np.testing.assert_array_equal(met_t[k][i].numpy(), met_j[k][i, 0], err_msg=k)
        for k in ("data_term", "reg_term", "vd_alpha", "reg_energy"):
            np.testing.assert_allclose(met_t[k][i].numpy(), met_j[k][i, 0], rtol=1e-4,
                                       err_msg=k)
        got = mcmc_state_to_numpy(unstack_tree(new_t, i))
        for group in ("gmm", "reg"):
            for k, v in getattr(ref, group).items():
                np.testing.assert_allclose(got[group][k], v, atol=1e-6, rtol=1e-5)
        for opt in ("opt_gmm", "opt_reg"):
            js = getattr(ref, opt)
            np.testing.assert_array_equal(got[opt]["step"], js.step)
            for part in ("mu", "nu"):
                for k, v in getattr(js, part).items():
                    np.testing.assert_allclose(got[opt][part][k], v, atol=1e-6,
                                               rtol=moment_rtol, err_msg=f"{opt}.{part}.{k}")
        np.testing.assert_allclose(got["welford"]["mean"], ref.welford.mean, atol=1e-4)
        np.testing.assert_array_equal(got["welford"]["count"], ref.welford.count)


def _q_v0(dims, seed):
    """A q(v) with a smooth mean of a few voxels, different for each pair."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3,) + dims).astype(np.float32)
    for _ in range(6):
        for ax in (-3, -2, -1):
            x = (np.roll(x, 1, ax) + x + np.roll(x, -1, ax)) / 3.0
    shape = (3,) + dims
    return {"mu": (x * (6.0 / np.abs(x).max())).astype(np.float32),
            "log_var": np.full(shape, 2.0 * np.log(np.float32(0.5)), np.float32),
            "u": np.full(shape, 0.1, np.float32)}


def _vi_draws(key, dims):
    """A VI step's draws from its key: ``split(key, 4)`` -> the q(v) draw's
    field and scalar normals from the second, the two chains' uniform noise
    from the third and fourth."""
    _, k1, k2, k3 = jax.random.split(key, 4)
    k_eps, k_x = jax.random.split(k1)
    unif = [np.asarray(jax.random.uniform(k, (3,) + dims, jnp.float32, -ALPHA, ALPHA))
            for k in (k2, k3)]
    return (np.asarray(jax.random.normal(k_eps, (3,) + dims, jnp.float32)),
            np.asarray(jax.random.normal(k_x, (), jnp.float32)), np.stack(unif))


def _entropy_f64(q_v: dict, eps, x) -> float:
    """The VI step's entropy term in float64 from its inputs."""
    mu, log_var, u = (np.asarray(q_v[k], np.float64) for k in ("mu", "log_var", "u"))
    sigma = np.exp(0.5 * log_var)
    delta = eps * sigma + float(x) * u
    un = u / sigma
    quad = [0.5 * (np.sum((s / sigma) ** 2) - np.sum(s / sigma * un) ** 2 / (1 + np.sum(un ** 2)))
            for s in (delta, -delta)]
    return 0.5 * (quad[0] + quad[1]) + 0.5 * (np.log1p(np.sum(un ** 2)) + np.sum(log_var))


@pytest.mark.parametrize("scheme", ["post", "pre"])
def test_pair_vi_step_matches_jax_pair_chunk(scheme):
    """One pair-stacked VI step of 2 pairs at 32³ from each pair's warmed-up
    JAX state, with each pair's JAX draws; each pair against JAX's
    pair-stacked chunk, at ``test_vi_step_matches_jax``'s tolerances: loss
    terms 1e-4 relative, counters equal, the port's entropy term at 1e-6 of
    its float64 value (JAX's within 2e-3 of its ``Σ log σ²``), the q(v)
    gradient within 1e-3 RMS (3e-3 for ``u``) and 2% of its maximum, the
    updated q(v) 1e-6 where the gradient clears the noise, the GMM as
    ``_assert_gmm_close`` (log-std and log-proportions 1e-4, logits 1e-3,
    Adam moments 3e-3 of their maximum), the reg parameters 1e-5."""
    dims = (32, 32, 32)
    jb, tb = _bundles(dims, scheme)
    (jf, jm), (tf, tm), singles = _pair_images(dims)
    oq, og, orr = adam_decay(LR_Q, 1e-3), adam_decay(LR_GMM, 1e-3), adam_decay(LR_REG, 1e-3)
    warms = []
    for i, (f, m) in enumerate(singles):
        q_v = {k: jnp.asarray(v) for k, v in _q_v0(dims, i).items()}
        s0 = JVIState(q_v=q_v, gmm=jb.gmm.init_params(), reg=jb.reg_loss.init_params(),
                      opt_q_v=oq.init(q_v), opt_gmm=og.init(jb.gmm.init_params()),
                      opt_reg=orr.init(jb.reg_loss.init_params()),
                      key=jax.random.PRNGKey(30 + i), step=jnp.zeros((), jnp.int32))
        warms.append(_np(j_gmm_warmup(jb, og, s0, f, m)))
    draws = [_vi_draws(jnp.asarray(w.key), dims) for w in warms]
    run = j_pair_vi_chunk(jb, oq, og, orr, jf, jm, chunk=1, mesh=make_pair_mesh(PAIRS, 1))
    new_j, met_j = run(j_stack([jax.tree.map(jnp.asarray, w) for w in warms]))
    new_j, met_j = _np(new_j), {k: np.asarray(v) for k, v in met_j.items()}

    step = teng.make_vi_step(tb, t_adam(LR_Q, 1e-3), t_adam(LR_GMM, 1e-3),
                             t_adam(LR_REG, 1e-3), tf, tm, pairs=True)
    state = stack_trees([vi_state_from_numpy(w, device="cpu") for w in warms])
    noise = tuple(torch.as_tensor(np.stack([d[j] for d in draws])) for j in range(3))
    new, met = step(state, noise=noise)

    for i, warm in enumerate(warms):
        ref = jax.tree.map(lambda x: x[i], new_j)
        mj = {k: v[i, 0] for k, v in met_j.items()}
        for k in ("ndv", "sat", "sat_resid"):
            np.testing.assert_array_equal(met[k][i].numpy(), mj[k], err_msg=k)
        for k in ("data_term", "reg_term", "vd_alpha", "reg_energy"):
            np.testing.assert_allclose(met[k][i].numpy(), mj[k], rtol=1e-4, err_msg=k)
        ent64 = _entropy_f64(warm.q_v, *draws[i][:2])
        np.testing.assert_allclose(float(met["entropy_term"][i]), ent64, rtol=1e-6)
        log_var_sum = float(np.sum(np.asarray(warm.q_v["log_var"], np.float64)))
        assert abs(float(mj["entropy_term"]) - ent64) <= 2e-3 * 0.5 * abs(log_var_sum)
        np.testing.assert_allclose(float(met["total_loss"][i]),
                                   float(mj["total_loss"]) + float(mj["entropy_term"]) - ent64,
                                   rtol=1e-4)
        for k in ("gmm_scales", "gmm_proportions"):
            np.testing.assert_allclose(met[k][i].numpy(), mj[k], atol=1e-5, rtol=1e-5)
        got = unstack_tree(new, i)
        for name in ("mu", "log_var", "u"):
            np.testing.assert_allclose(met[f"max_update_{name}"][i].numpy(),
                                       mj[f"max_update_{name}"], rtol=1e-3, atol=1e-6)
            g_t = got.opt_q_v.mu[name].numpy() / 0.1
            g_j = np.asarray(ref.opt_q_v.mu[name]) / 0.1
            dg = g_t - g_j
            rms, rms_j = np.sqrt(np.mean(dg ** 2)), np.sqrt(np.mean(g_j ** 2))
            assert rms <= (3e-3 if name == "u" else 1e-3) * rms_j, (i, name, rms, rms_j)
            assert np.abs(dg).max() <= 2e-2 * np.abs(g_j).max(), (i, name)
            clear = np.abs(g_j) > 1e-3 * np.abs(g_j).max()
            np.testing.assert_allclose(got.q_v[name].numpy()[clear],
                                       np.asarray(ref.q_v[name])[clear], atol=1e-6,
                                       err_msg=name)
        np.testing.assert_allclose(got.gmm["log_std"].numpy(), ref.gmm["log_std"], rtol=1e-4,
                                   atol=1e-6)
        lp = tmod.GMM.log_proportions(got.gmm).numpy()
        lp_ref = np.asarray(GMM.log_proportions({k: jnp.asarray(v)
                                                 for k, v in ref.gmm.items()}))
        np.testing.assert_allclose(lp, lp_ref, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got.gmm["logits"].numpy(), ref.gmm["logits"], atol=1e-3)
        np.testing.assert_array_equal(got.opt_gmm.step.numpy(), ref.opt_gmm.step)
        for part in ("mu", "nu"):
            for k, v in getattr(ref.opt_gmm, part).items():
                np.testing.assert_allclose(getattr(got.opt_gmm, part)[k].numpy(), v,
                                           atol=3e-3 * np.abs(v).max(), err_msg=f"{part}.{k}")
        for k, v in ref.reg.items():
            np.testing.assert_allclose(got.reg[k].numpy(), v, atol=1e-5, rtol=1e-5, err_msg=k)
        for part in ("mu", "nu"):
            for k, v in getattr(ref.opt_reg, part).items():
                np.testing.assert_allclose(getattr(got.opt_reg, part)[k].numpy(), v,
                                           atol=1e-6, rtol=1e-4, err_msg=f"opt_reg.{part}.{k}")
    assert new.step.tolist() == np.asarray(new_j.step).tolist()
