"""PyTorch port vs the JAX package: whole SG-MCMC transitions, the state
conversion, the Welford accumulators, and the port's independence of JAX.

The transition test builds the JAX state with ``init_chains``, converts it
with ``ir_sgmcmc_tpu_torch.convert``, re-derives JAX's noise from the chain
keys exactly as ``engine/mcmc.py:263-264`` and ``engine/vi.py:157-159`` draw
it, and injects that noise into the port.  The card-only checks are in
tests/test_torch_cuda.py (the GPU host has no JAX).
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ir_sgmcmc_tpu.data import sphere_pair
from ir_sgmcmc_tpu.engine import ModelBundle as JBundle
from ir_sgmcmc_tpu.engine import init_chains as j_init_chains
from ir_sgmcmc_tpu.engine import make_mcmc_chunk as j_make_chunk
from ir_sgmcmc_tpu.engine.mcmc import MCMCState as JState
from ir_sgmcmc_tpu.engine.mcmc import WelfordState as JWelford
from ir_sgmcmc_tpu.engine.mcmc import welford_finalize as j_wfin
from ir_sgmcmc_tpu.engine.mcmc import welford_merge as j_wmerge
from ir_sgmcmc_tpu.engine.mcmc import welford_update as j_wupd
from ir_sgmcmc_tpu.engine.vi import forward_sample as j_forward_sample
from ir_sgmcmc_tpu.models import (GMM, SVF3D, DirichletPrior, LogEnergyExpGammaPrior,
                                  LogScaleNormalPrior, langevin_noise)
from ir_sgmcmc_tpu.models.reg_loss import RegLossLogNormal
from ir_sgmcmc_tpu.optim import adam_decay
from ir_sgmcmc_tpu.optim.adam_decay import AdamDecayState as JAdam
from ir_sgmcmc_tpu_torch import engine as teng
from ir_sgmcmc_tpu_torch import models as tmod
from ir_sgmcmc_tpu_torch.convert import mcmc_state_from_numpy, mcmc_state_to_numpy
from ir_sgmcmc_tpu_torch.engine import mcmc as tmcmc
from ir_sgmcmc_tpu_torch.engine.vi import forward_sample as t_forward_sample
from ir_sgmcmc_tpu_torch.models.sampler import langevin_noise as t_langevin
from ir_sgmcmc_tpu_torch.optim import adam_decay as t_adam

REPO = Path(__file__).resolve().parents[1]
ALPHA = 0.1


def _jax_problem(dims, scheme="post"):
    """``bench.py:_make_bundle_and_pair`` (the 'post' noise scheme unless
    given)."""
    dof = 3.0 * math.prod(dims)
    bundle = JBundle(
        dims=dims, gmm=GMM(4, 1), scale_prior=LogScaleNormalPrior(0.0, 2.3),
        proportion_prior=DirichletPrior(4, 0.5),
        reg_loss=RegLossLogNormal(w_reg=1.4, dims=dims, learnable=True),
        reg_loc_prior=LogEnergyExpGammaPrior(w_reg=1.4, dof=dof),
        reg_scale_prior=LogScaleNormalPrior(loc=2.8, scale=5.0),
        transformation=SVF3D(dims, no_steps=12), sobolev_s=3, sobolev_lambda=0.5,
        uniform_noise_alpha=ALPHA, noise_scheme=scheme, virtual_decimation=True)
    fixed, moving = sphere_pair(dims, offset=(0.0, 0.0, 4.0))
    return (bundle, {k: jnp.asarray(v) for k, v in fixed.items()},
            {k: jnp.asarray(v) for k, v in moving.items()},
            adam_decay(0.2, 1e-3), adam_decay({"loc": 0.01, "log_scale": 0.01}, 1e-3))


def _port_problem(dims, device="cpu", scheme="post"):
    dof = 3.0 * math.prod(dims)
    bundle = teng.ModelBundle(
        dims=dims, gmm=tmod.GMM(4, 1), scale_prior=tmod.LogScaleNormalPrior(0.0, 2.3),
        proportion_prior=tmod.DirichletPrior(4, 0.5),
        reg_loss=tmod.RegLossLogNormal(w_reg=1.4, dims=dims, learnable=True),
        reg_loc_prior=tmod.LogEnergyExpGammaPrior(w_reg=1.4, dof=dof),
        reg_scale_prior=tmod.LogScaleNormalPrior(loc=2.8, scale=5.0),
        transformation=tmod.SVF3D(dims, no_steps=12), sobolev_s=3, sobolev_lambda=0.5,
        uniform_noise_alpha=ALPHA, noise_scheme=scheme, virtual_decimation=True)
    fixed, moving = sphere_pair(dims, offset=(0.0, 0.0, 4.0))
    return (bundle, {k: torch.as_tensor(v, device=device) for k, v in fixed.items()},
            {k: torch.as_tensor(v, device=device) for k, v in moving.items()},
            t_adam(0.2, 1e-3), t_adam({"loc": 0.01, "log_scale": 0.01}, 1e-3))


def _jax_state(dims, chains=2, seed=0, scheme="post"):
    """``init_chains`` from GMM parameters as the trainer's warm-up leaves
    them (scales spread over the residual std, unequal logits).  The
    untrained init (all components identical) has an exactly zero logits
    gradient, whose f32 rounding noise Adam's normalisation turns into a
    step of up to ±lr in either package: not a comparable quantity."""
    bundle, fixed, moving, og, orr = _jax_problem(dims, scheme)
    gmm = bundle.gmm.init_scales_from_residual_std(bundle.gmm.init_params(), 1.0)
    gmm["logits"] = jnp.asarray([0.3, -0.2, 0.1, -0.4], jnp.float32)
    state = j_init_chains(bundle, jax.random.PRNGKey(seed), no_chains=chains,
                          mode="noise", q_v=None, gmm=gmm,
                          reg=bundle.reg_loss.init_params(), opt_gmm=og, opt_reg=orr)
    return bundle, fixed, moving, og, orr, state


def _jax_draws(keys, dims, sigma, tau):
    """The transition's own draws: ``split(key, 3)`` -> Langevin noise from
    the second key, the uniform noise (post-warp or jitter) from the third."""
    eps, noise, unif = [], [], []
    for c in range(keys.shape[0]):
        _, k_noise, k_unif = jax.random.split(jnp.asarray(keys[c]), 3)
        eps.append(np.asarray(jax.random.normal(k_noise, (3,) + dims, jnp.float32)))
        noise.append(np.asarray(langevin_noise(k_noise, jnp.asarray(sigma[c]), tau)))
        unif.append(np.asarray(jax.random.uniform(k_unif, (3,) + dims, jnp.float32,
                                                  -ALPHA, ALPHA)))
    return np.stack(eps), np.stack(noise), np.stack(unif)


def _np_tree(state):
    """Copies: the JAX chunk donates its input state, so a zero-copy view
    of it may read the chunk's outputs once the chunk has run."""
    return jax.tree.map(lambda x: np.array(x, copy=True), state)


@pytest.mark.parametrize("dims,tau,scheme", [
    pytest.param((64, 64, 64), 1e-5, "post", id="dims0-1e-05"),
    pytest.param((32, 32, 32), 1e-2, "post", id="dims1-0.01"),
    pytest.param((32, 32, 32), 1e-2, "pre", id="pre-32-0.01"),
])
def test_transition_matches_jax(dims, tau, scheme):
    """One 2-chain transition.  At 64³ the image warp is the block-gather
    warp (the B3/B4 path); at 32³ it is ``grid_sample``; on "pre" the image
    rides the integration cascade and a jitter warp (B5-B7).

    Tolerances, and why:

    * ``q = (v' - v_next)/tau = σ²∇U`` is read back from ``v_next``, which is
      rounded at the scale of ``v'``: a floor of a few ulps of ``max|v'|``
      over ``tau`` (0.47 at tau 1e-5; hence the second case at tau 1e-2,
      floor 5e-4).  Above the floor, ``∇U`` is a sum of large cancelling LCC
      terms (``|∂L/∂T|`` reaches ~1e4 where the local std is small) that
      leaves an absolute f32 error scaled by the terms, not by each element:
      the RMS error must stay within 1e-3 of the RMS gradient (measured
      ~2e-4), and no element may be off by more than 2% of ``max|q|``
      (measured 1e-3; 1.3e-2 once at an isolated voxel, under another XLA
      CPU compilation of the JAX side).
    * Loss terms and the energy are f32 sums over 10⁵-10⁶ voxels: 1e-4
      relative.  XLA's CPU reduction of the 786k squares of the energy at
      64³ reads 8e-5 low against a float64 sum (the port's: 1e-7).
    * Fold and saturation counters must be equal.
    * Adam moments: 1e-4 relative; on "pre" 3e-4, where the GMM gradient
      (a sum over 32³ voxels that XLA accumulates in f32) lands one ``nu``
      element (``∝ g²``, twice g's relative error) 1.1e-4 off.
    """
    moment_rtol = 3e-4 if scheme == "pre" else 1e-4
    bundle, fixed, moving, og, orr, state_j = _jax_state(dims, scheme=scheme)
    tree = _np_tree(state_j)
    state_t = mcmc_state_from_numpy(tree, device="cpu")
    eps, noise_j, unif = _jax_draws(tree.key, dims, tree.sigma, tau)

    run = j_make_chunk(bundle, og, orr, tau, fixed, moving, chunk=1, burn_in=0, thin=1)
    new_j, met_j = run(state_j)
    new_j = _np_tree(new_j)
    met_j = {k: np.asarray(v)[0] for k, v in met_j.items()}

    tb, tf, tm, tog, torr = _port_problem(dims, scheme=scheme)
    trans = tmcmc.make_sgld_transition(tb, tog, torr, tau, tf, tm)
    new_t, met_t = trans(state_t, 1.0, noise=(torch.as_tensor(eps), torch.as_tensor(unif)))

    vp_j = tree.v + noise_j
    vp_t = (state_t.v + t_langevin(None, state_t.sigma, tau, torch.as_tensor(eps))).numpy()
    np.testing.assert_allclose(vp_t, vp_j, atol=1e-6)  # same draw, same v'
    q_j = (vp_j - new_j.v) / tau
    q_t = (vp_t - new_t.v.numpy()) / tau
    floor = 8 * np.finfo(np.float32).eps * np.abs(vp_j).max() / tau
    dq = q_t - q_j
    rms = np.sqrt(np.mean(dq ** 2)), np.sqrt(np.mean(q_j ** 2))
    assert rms[0] <= floor / 8 + 1e-3 * rms[1], rms
    assert np.abs(dq).max() <= floor + 2e-2 * np.abs(q_j).max()

    for k in ("ndv", "sat", "sat_resid"):
        np.testing.assert_array_equal(met_t[k].numpy(), met_j[k])
    for k in ("data_term", "reg_term", "vd_alpha", "reg_energy"):
        np.testing.assert_allclose(met_t[k].numpy(), met_j[k], rtol=1e-4)
    got = mcmc_state_to_numpy(new_t)
    for group in ("gmm", "reg"):
        for k, v in getattr(new_j, group).items():
            np.testing.assert_allclose(got[group][k], v, atol=1e-6, rtol=1e-5)
    for opt in ("opt_gmm", "opt_reg"):
        js = getattr(new_j, opt)
        np.testing.assert_array_equal(got[opt]["step"], js.step)
        for part in ("mu", "nu"):
            for k, v in getattr(js, part).items():
                np.testing.assert_allclose(got[opt][part][k], v, atol=1e-6, rtol=moment_rtol)
    np.testing.assert_allclose(got["welford"]["mean"], new_j.welford.mean, atol=1e-4)
    np.testing.assert_array_equal(got["welford"]["count"], new_j.welford.count)


def test_forward_sample_counters_match_jax():
    """The 'post' forward chain at 64³ on a velocity large and rough enough
    to fold (``ndv``), to overflow the block residual (``sat_resid``) and to
    saturate the displacement at the composition bound (``sat`` beyond
    ``sat_resid``), with JAX's own uniform draw.  Counters must be equal;
    the displacement and warp agree to f32 rounding of values up to ~8,
    the LCC residuals to 1e-4 (they divide by local stds)."""
    dims = (64, 64, 64)
    jb, jf, jm, _, _ = _jax_problem(dims)
    tb, tf, tm, _, _ = _port_problem(dims)
    rng = np.random.default_rng(2)
    v = rng.standard_normal((3,) + dims).astype(np.float32)
    for _ in range(4):
        for ax in (1, 2, 3):
            v = (np.roll(v, 1, ax) + v + np.roll(v, -1, ax)) / 3.0
    v = (v * (12.0 / np.abs(v).max())).astype(np.float32)
    key = jax.random.PRNGKey(2)
    unif = np.array(jax.random.uniform(key, (3,) + dims, jnp.float32, -ALPHA, ALPHA))
    out_j = jax.jit(lambda vv, k: j_forward_sample(jb, jf, jm, vv, k))(jnp.asarray(v), key)
    with torch.no_grad():
        out_t = t_forward_sample(tb, tf, tm, torch.as_tensor(v)[None],
                                 torch.as_tensor(unif)[None])
    counts = {k: int(out_j[k]) for k in ("ndv", "sat", "sat_resid")}
    assert counts["ndv"] > 0 and counts["sat"] > counts["sat_resid"] > 0, counts
    for k, n in counts.items():
        assert int(out_t[k][0]) == n, (k, int(out_t[k][0]), n)
    np.testing.assert_allclose(out_t["displacement"][0].numpy(),
                               np.asarray(out_j["displacement"]), atol=1e-5)
    np.testing.assert_allclose(out_t["warped"][0].numpy(), np.asarray(out_j["warped"]),
                               atol=1e-5)
    np.testing.assert_allclose(out_t["residuals"][0].numpy(),
                               np.asarray(out_j["residuals"]), atol=1e-4)


def _plain(x):
    """NamedTuples and dicts as nested dicts of numpy arrays."""
    if hasattr(x, "_asdict"):
        x = x._asdict()
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return np.asarray(x)


def _assert_same(a, b, path="state"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
        return
    np.testing.assert_array_equal(b, a, err_msg=path)
    assert a.dtype == b.dtype and a.shape == b.shape, path


def test_convert_round_trip():
    *_, state_j = _jax_state((16, 16, 16))
    tree = _np_tree(state_j)
    back = mcmc_state_to_numpy(mcmc_state_from_numpy(tree, device="cpu"))
    _assert_same(_plain(tree), back)
    # the numpy tree rebuilds a JAX state of the same structure
    rebuilt = JState(**{**back, "opt_gmm": JAdam(**back["opt_gmm"]),
                        "opt_reg": JAdam(**back["opt_reg"]),
                        "welford": JWelford(**back["welford"])})
    assert jax.tree.structure(rebuilt) == jax.tree.structure(state_j)


def test_welford_matches_jax():
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32) for _ in range(5)]
    ws = [1.0, 0.0, 1.0, 1.0, 1.0]
    wj = jax.vmap(lambda _: JWelford(jnp.zeros(()), jnp.zeros((3, 4, 4, 4)),
                                     jnp.zeros((3, 4, 4, 4))))(jnp.arange(2))
    wt = tmcmc.welford_init(2, (3, 4, 4, 4), device="cpu")
    for x, w in zip(xs, ws):
        wj = jax.vmap(j_wupd, in_axes=(0, 0, None))(wj, x, w)
        wt = tmcmc.welford_update(wt, torch.as_tensor(x), w)
    mj, sj = j_wfin(j_wmerge(wj))
    mt, st = tmcmc.welford_finalize(tmcmc.welford_merge(wt))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)


def test_mcmc_chunk_runs_and_collects():
    """The port's chunk on its own draws: counters advance, thinning gates
    the Welford count, and the posterior statistics come out finite."""
    dims = (16, 16, 16)
    b, f, m, og, orr = _port_problem(dims)
    state = teng.init_chains(b, torch.Generator().manual_seed(0), 2, "noise", None,
                             b.gmm.init_params("cpu"), b.reg_loss.init_params("cpu"), og, orr,
                             device="cpu")
    run = teng.make_mcmc_chunk(b, og, orr, 1e-5, f, m, chunk=4, burn_in=1, thin=2)
    state, met = run(state)
    assert state.step == 4
    assert met["data_term"].shape == (4, 2)
    np.testing.assert_array_equal(state.welford.count.numpy(), [1.0, 1.0])  # step 3
    mean, std = teng.posterior_statistics(state)
    assert mean.shape == (3,) + dims and torch.isfinite(std).all()
    # the same state and step draw the same noise: the run is reproducible
    s0 = teng.init_chains(b, torch.Generator().manual_seed(0), 2, "noise", None,
                          b.gmm.init_params("cpu"), b.reg_loss.init_params("cpu"), og, orr,
                          device="cpu")
    s1, _ = run(s0)
    assert torch.equal(s1.v, state.v)


@pytest.mark.parametrize("mode", ["identity", "VI"])
def test_init_chains_modes(mode):
    """'identity': zero velocity, unit preconditioner; 'VI': per-chain
    draws from q(v) with the preconditioner sigma = exp(log_var / 2)."""
    dims = (8, 8, 8)
    b, _, _, og, orr = _port_problem(dims)
    q_v = {"mu": torch.full((3,) + dims, 0.5), "log_var": torch.full((3,) + dims, -2.0),
           "u": torch.full((3,) + dims, 0.1)}
    s = teng.init_chains(b, torch.Generator().manual_seed(3), 3, mode, q_v,
                         b.gmm.init_params("cpu"), b.reg_loss.init_params("cpu"), og, orr,
                         device="cpu")
    assert s.v.shape == s.sigma.shape == (3, 3) + dims and s.key.shape == (3, 2)
    assert s.gmm["log_std"].shape == (3, 4) and s.opt_gmm.step.shape == (3,)
    if mode == "identity":
        assert torch.equal(s.v, torch.zeros_like(s.v)) and torch.equal(s.sigma, torch.ones_like(s.v))
    else:
        torch.testing.assert_close(s.sigma, torch.full_like(s.v, math.exp(-1.0)))
        assert not torch.equal(s.v[0], s.v[1])  # independent draws per chain
        assert abs(float(s.v.mean()) - 0.5) < 0.1
    with pytest.raises(ValueError):
        teng.init_chains(b, torch.Generator(), 2, "VI", None, b.gmm.init_params("cpu"),
                         b.reg_loss.init_params("cpu"), og, orr, device="cpu")


def test_port_never_imports_jax():
    """Import the port, run a 16³ transition, and find no JAX module loaded."""
    code = (
        "import sys, torch\n"
        "from ir_sgmcmc_tpu_torch.data import sphere_pair\n"
        "from ir_sgmcmc_tpu_torch import engine, models, convert\n"
        "from ir_sgmcmc_tpu_torch.optim import adam_decay\n"
        "dims = (16, 16, 16)\n"
        "b = engine.ModelBundle(dims=dims, gmm=models.GMM(4, 1),\n"
        "    scale_prior=models.LogScaleNormalPrior(0.0, 2.3),\n"
        "    proportion_prior=models.DirichletPrior(4, 0.5),\n"
        "    reg_loss=models.RegLossLogNormal(w_reg=1.4, dims=dims, learnable=True),\n"
        "    reg_loc_prior=models.LogEnergyExpGammaPrior(w_reg=1.4, dof=3.0 * 16 ** 3),\n"
        "    reg_scale_prior=models.LogScaleNormalPrior(loc=2.8, scale=5.0),\n"
        "    transformation=models.SVF3D(dims))\n"
        "f, m = sphere_pair(dims)\n"
        "f = {k: torch.as_tensor(v) for k, v in f.items()}\n"
        "m = {k: torch.as_tensor(v) for k, v in m.items()}\n"
        "og, orr = adam_decay(0.2, 1e-3), adam_decay({'loc': .01, 'log_scale': .01}, 1e-3)\n"
        "s = engine.init_chains(b, torch.Generator().manual_seed(0), 2, 'noise', None,\n"
        "    b.gmm.init_params('cpu'), b.reg_loss.init_params('cpu'), og, orr,\n"
        "    device='cpu')\n"
        "s, met = engine.make_mcmc_chunk(b, og, orr, 1e-5, f, m, 1, 0, 1)(s)\n"
        "assert torch.isfinite(met['data_term']).all()\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib',\n"
        "    'ir_sgmcmc_tpu.')) or k == 'ir_sgmcmc_tpu')\n"
        "print('LOADED', bad)\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout
