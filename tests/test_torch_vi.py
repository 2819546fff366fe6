"""PyTorch port vs the JAX package: the VI step and its pieces — the
antithetic q(v) draw, both entropy terms, the ``"pre"`` forward chain, the
GMM warm-up, one whole VI iteration on either noise scheme, and the
``VIState`` conversion.

Both packages run on the CPU at 32³ or smaller.  The JAX side draws its
own noise from its keys; the tests re-derive those draws exactly as
``engine/vi.py:351`` (``split(key, 4)``), ``models/sampler.py:26-29``
(``split(k1)`` -> field normal, scalar normal) and ``engine/vi.py:141,158``
(the uniform noise) take them, and inject them into the port.
"""

import math

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

import jax
import jax.numpy as jnp

from ir_sgmcmc_tpu.data import sphere_pair
from ir_sgmcmc_tpu.engine import ModelBundle as JBundle
from ir_sgmcmc_tpu.engine.vi import VIState as JVIState
from ir_sgmcmc_tpu.engine.vi import forward_sample as j_forward_sample
from ir_sgmcmc_tpu.engine.vi import gmm_warmup as j_gmm_warmup
from ir_sgmcmc_tpu.engine.vi import make_vi_step as j_make_vi_step
from ir_sgmcmc_tpu.models import GMM, SVF3D, DirichletPrior, LogEnergyExpGammaPrior, LogScaleNormalPrior
from ir_sgmcmc_tpu.models.entropy import entropy_analytic as j_ent_analytic
from ir_sgmcmc_tpu.models.entropy import entropy_sample as j_ent_sample
from ir_sgmcmc_tpu.models.reg_loss import RegLossLogNormal
from ir_sgmcmc_tpu.models.sampler import sample_q_v as j_sample_q_v
from ir_sgmcmc_tpu.optim import adam_decay
from ir_sgmcmc_tpu.optim.adam_decay import AdamDecayState as JAdam
from ir_sgmcmc_tpu_torch import engine as teng
from ir_sgmcmc_tpu_torch import models as tmod
from ir_sgmcmc_tpu_torch.convert import vi_state_from_numpy, vi_state_to_numpy
from ir_sgmcmc_tpu_torch.models.entropy import entropy_analytic, entropy_sample
from ir_sgmcmc_tpu_torch.models.sampler import sample_q_v
from ir_sgmcmc_tpu_torch.optim import adam_decay as t_adam

ALPHA = 0.1
DIMS = (32, 32, 32)
LR_Q = {"mu": 0.01, "log_var": 0.01, "u": 0.01}
LR_GMM = {"log_std": 0.2, "logits": 0.2}
LR_REG = {"loc": 0.01, "log_scale": 0.01}


def _smooth(rng, shape, peak, passes=6):
    x = rng.standard_normal(shape).astype(np.float32)
    for _ in range(passes):
        for ax in (-3, -2, -1):
            x = (np.roll(x, 1, ax) + x + np.roll(x, -1, ax)) / 3.0
    return (x * (peak / np.abs(x).max())).astype(np.float32)


def _bundles(dims, scheme, alpha=ALPHA):
    """``bench.py:_make_bundle_and_pair`` in both packages."""
    dof = 3.0 * math.prod(dims)
    common = dict(dims=dims, sobolev_s=3, sobolev_lambda=0.5, uniform_noise_alpha=alpha,
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
    fixed, moving = sphere_pair(dims, offset=(0.0, 0.0, 4.0))
    jimg = tuple({k: jnp.asarray(v) for k, v in d.items()} for d in (fixed, moving))
    timg = tuple({k: torch.as_tensor(v) for k, v in d.items()} for d in (fixed, moving))
    return jb, tb, jimg, timg


def _q_v0(dims, seed=0):
    """measure_vi's q(v) init (bench.py:336-341) with a smooth mean of a few
    voxels, so that the displacement moves the image."""
    rng = np.random.default_rng(seed)
    shape = (3,) + dims
    return {"mu": _smooth(rng, shape, 6.0),
            "log_var": np.full(shape, 2.0 * np.log(np.float32(0.5)), np.float32),
            "u": np.full(shape, 0.1, np.float32)}


def _jax_state(jb, dims, seed=0):
    """The JAX ``VIState`` and its optimizers ``(opt_q_v, opt_gmm, opt_reg)``."""
    q_v = {k: jnp.asarray(v) for k, v in _q_v0(dims, seed).items()}
    oq, og, orr = adam_decay(LR_Q, 1e-3), adam_decay(LR_GMM, 1e-3), adam_decay(LR_REG, 1e-3)
    state = JVIState(q_v=q_v, gmm=jb.gmm.init_params(), reg=jb.reg_loss.init_params(),
                     opt_q_v=oq.init(q_v), opt_gmm=og.init(jb.gmm.init_params()),
                     opt_reg=orr.init(jb.reg_loss.init_params()),
                     key=jax.random.PRNGKey(seed), step=jnp.zeros((), jnp.int32))
    return state, (oq, og, orr)


def _uniform(key, dims, alpha=ALPHA):
    return np.asarray(jax.random.uniform(key, (3,) + dims, jnp.float32, -alpha, alpha))


def _q_draw(key, dims):
    """``sample_q_v``'s own draws from ``key`` (sampler.py:26-29)."""
    k_eps, k_x = jax.random.split(key)
    return (np.asarray(jax.random.normal(k_eps, (3,) + dims, jnp.float32)),
            np.asarray(jax.random.normal(k_x, (), jnp.float32)))


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


# ---- q(v) draws and entropies -------------------------------------------------

def test_sample_q_v_antithetic_and_entropies_match_jax():
    dims = (6, 7, 8)
    rng = np.random.default_rng(3)
    q_v = {"mu": rng.standard_normal((3,) + dims).astype(np.float32),
           "log_var": (rng.standard_normal((3,) + dims) * 0.3 - 1.0).astype(np.float32),
           "u": (rng.standard_normal((3,) + dims) * 0.1).astype(np.float32)}
    key = jax.random.PRNGKey(5)
    s1_j, s2_j = j_sample_q_v(key, q_v, antithetic=True)
    eps, x = _q_draw(key, dims)
    tq = {k: torch.as_tensor(v) for k, v in q_v.items()}
    s1, s2 = sample_q_v(None, tq, antithetic=True, eps=torch.tensor(eps), x=torch.tensor(x))
    np.testing.assert_allclose(s1.numpy(), np.asarray(s1_j), atol=1e-6)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s2_j), atol=1e-6)
    np.testing.assert_allclose((s1 + s2).numpy() / 2, q_v["mu"], atol=1e-6)
    # the generator path draws eps, then x, and is reproducible
    a = sample_q_v(torch.Generator().manual_seed(1), tq)
    b = sample_q_v(torch.Generator().manual_seed(1), tq, antithetic=True)[0]
    assert torch.equal(a, b)

    # entropies: unbatched and with a leading batch; sums over ~1000 voxels
    samples = np.stack([np.asarray(s1_j), np.asarray(s2_j)])
    np.testing.assert_allclose(
        entropy_analytic(tq["log_var"], tq["u"]).numpy(),
        np.asarray(j_ent_analytic(q_v["log_var"], q_v["u"])), rtol=1e-6)
    ref = j_ent_sample(samples, q_v["mu"], q_v["log_var"], q_v["u"])
    got = entropy_sample(torch.as_tensor(samples), tq["mu"], tq["log_var"], tq["u"])
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    np.testing.assert_allclose(
        entropy_sample(torch.as_tensor(samples[0]), tq["mu"], tq["log_var"], tq["u"]).numpy(),
        np.asarray(ref)[0], rtol=1e-5)

    jb, tb, _, _ = _bundles(dims, "pre")
    q_j, q_t = jb.init_q_v(0.5, 0.1), tb.init_q_v(0.5, 0.1, device="cpu")
    for k in q_j:
        np.testing.assert_allclose(q_t[k].numpy(), np.asarray(q_j[k]), rtol=1e-7)


# ---- the "pre" forward chain -------------------------------------------------------

@pytest.mark.parametrize("alpha", [ALPHA, None])
def test_forward_sample_pre_matches_jax(alpha):
    """The cascade branch at 32³ on a velocity large and rough enough to fold
    (``ndv``) and to reach the image cascade's clamp bound (``sat``), with
    JAX's own jitter draw.  ``alpha=None`` takes the same branch with no
    jitter, under the "post" scheme too.  Counters must be equal; the
    warped image agrees to 1e-4 (values in [0, 1] after 9 warps), the LCC
    residuals to 1e-3 (they divide by local stds down to ~0.03 here)."""
    dims = DIMS
    scheme = "pre" if alpha is not None else "post"
    jb, tb, (jf, jm), (tf, tm) = _bundles(dims, scheme, alpha)
    rng = np.random.default_rng(4)
    v = np.stack([_smooth(rng, (3,) + dims, 24.0, passes=3) for _ in range(2)])
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    out_j = jax.jit(jax.vmap(lambda vv, k: j_forward_sample(jb, jf, jm, vv, k)))(
        jnp.asarray(v), keys)
    unif = None
    if alpha is not None:
        unif = torch.as_tensor(np.stack([_uniform(k, dims) for k in keys]))
    with torch.no_grad():
        out_t = teng.forward_sample(tb, tf, tm, torch.as_tensor(v), unif)
    counts = {k: np.asarray(out_j[k]) for k in ("ndv", "sat", "sat_resid")}
    assert counts["ndv"].min() > 0 and counts["sat"].min() > 0, counts
    for k, n in counts.items():
        np.testing.assert_array_equal(out_t[k].numpy(), n, err_msg=k)
    np.testing.assert_allclose(out_t["displacement"].numpy(),
                               np.asarray(out_j["displacement"]), atol=1e-4)
    np.testing.assert_allclose(out_t["warped"].numpy(), np.asarray(out_j["warped"]),
                               atol=1e-4)
    np.testing.assert_allclose(out_t["residuals"].numpy(), np.asarray(out_j["residuals"]),
                               atol=1e-3)


# ---- GMM warm-up and the VI step -----------------------------------------------------

@pytest.fixture(scope="module", params=["pre", "post"])
def vi_case(request):
    """One JAX VI setup per scheme: the warmed-up state, one VI step from
    it, and every draw the two took."""
    scheme = request.param
    dims = DIMS
    jb, tb, (jf, jm), timg = _bundles(dims, scheme)
    state0, (oq, og, orr) = _jax_state(jb, dims)
    warm = j_gmm_warmup(jb, og, state0, jf, jm)
    _, k_s, k_n = jax.random.split(state0.key, 3)
    warm_draws = (*_q_draw(k_s, dims), _uniform(k_n, dims)[None])
    new, met = jax.jit(j_make_vi_step(jb, oq, og, orr, jf, jm))(warm)
    _, k1, k2, k3 = jax.random.split(warm.key, 4)
    step_draws = (*_q_draw(k1, dims), np.stack([_uniform(k2, dims), _uniform(k3, dims)]))
    return {"scheme": scheme, "tb": tb, "timg": timg, "state0": _np(state0),
            "warm": _np(warm), "warm_draws": warm_draws, "new": _np(new),
            "met": {k: np.asarray(v) for k, v in met.items()}, "step_draws": step_draws}


def _port_opts():
    return t_adam(LR_Q, 1e-3), t_adam(LR_GMM, 1e-3), t_adam(LR_REG, 1e-3)


def _inject(draws):
    return tuple(torch.tensor(a) for a in draws)


def _assert_gmm_close(got: dict, ref: dict, opt_got=None, opt_ref=None):
    """``log_std`` and the log-proportions to 1e-4 relative: the JAX
    warm-up's 25 jitted Adam steps at lr 0.2 carry XLA's f32 sums of the
    NLL gradient over 32³ voxels (measured 7.7e-5 relative against the
    port; the same steps unjitted agree to 5e-6).  The logits themselves
    only to 1e-3: softmax ignores their common shift, whose gradient sums
    to zero, so Adam's normalisation turns the rounding of that zero into
    steps (measured drift 6.4e-4).  The Adam moments, sums over 32³ voxels
    of same-signed terms that XLA accumulates in f32, to 3e-3 of their
    largest element (measured 1.4e-3)."""
    np.testing.assert_allclose(got["log_std"].numpy(), ref["log_std"], rtol=1e-4, atol=1e-6)
    lp = tmod.GMM.log_proportions(got).numpy()
    lp_ref = np.asarray(GMM.log_proportions({k: jnp.asarray(v) for k, v in ref.items()}))
    np.testing.assert_allclose(lp, lp_ref, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["logits"].numpy(), ref["logits"], atol=1e-3)
    if opt_got is not None:
        np.testing.assert_array_equal(opt_got.step.numpy(), opt_ref.step)
        for part in ("mu", "nu"):
            for k, v in getattr(opt_ref, part).items():
                np.testing.assert_allclose(getattr(opt_got, part)[k].numpy(), v,
                                           atol=3e-3 * np.abs(v).max(), err_msg=f"{part}.{k}")


def test_gmm_warmup_matches_jax(vi_case):
    """Scales spread over the residual std, then 25 detached Adam steps at
    lr 0.2 (tolerances: :func:`_assert_gmm_close`)."""
    tb, (tf, tm) = vi_case["tb"], vi_case["timg"]
    oq, og, orr = _port_opts()
    state = vi_state_from_numpy(vi_case["state0"], device="cpu")
    warm = teng.gmm_warmup(tb, og, state, tf, tm, noise=_inject(vi_case["warm_draws"]))
    ref = vi_case["warm"]
    _assert_gmm_close(warm.gmm, ref.gmm, warm.opt_gmm, ref.opt_gmm)
    assert int(warm.opt_gmm.step) == 25


def _entropy_f64(q_v: dict, eps, x) -> float:
    """The VI step's entropy term in float64 from its inputs."""
    mu, log_var, u = (np.asarray(q_v[k], np.float64) for k in ("mu", "log_var", "u"))
    sigma = np.exp(0.5 * log_var)
    delta = eps * sigma + float(x) * u
    un = u / sigma
    quad = [0.5 * (np.sum((s / sigma) ** 2) - np.sum(s / sigma * un) ** 2 / (1 + np.sum(un ** 2)))
            for s in (delta, -delta)]
    return 0.5 * (quad[0] + quad[1]) + 0.5 * (np.log1p(np.sum(un ** 2)) + np.sum(log_var))


def test_vi_step_matches_jax(vi_case):
    """One VI iteration from the warmed-up JAX state, with JAX's draws.

    Tolerances, and why:

    * Loss terms, the VD factor and the energy are f32 sums over 32³
      voxels: 1e-4 relative.  Fold and saturation counters must be equal.
    * The entropy term holds ``0.5 Σ log σ²`` over 98,304 equal values,
      which XLA's CPU reduction sums 1e-3 low (-136146.4 against -136278.3
      in float64; torch's sum is within 3e-2).  So the port's entropy term
      is held to its float64 value at 1e-6, the JAX one to it within 2e-3
      of that sum's size, and the total loss compared with the JAX total
      minus JAX's entropy error.
    * The q(v) gradient, read back from Adam's first moment (``0.1·g`` after
      one step), is a sum of cancelling LCC terms: its RMS error must stay
      within 1e-3 of its RMS and no element may be off by more than 2% of
      its maximum (the transition test's rule).  For ``u`` the RMS bound is
      3e-3: its gradient scales with the entropy's rank-1 sums
      ``Σ (u/σ)²`` over 98,304 equal values, which XLA sums as the
      ``Σ log σ²`` above (measured 2.0e-3).
    * The updated ``q_v`` is ``q - lr·g/(|g| + 1e-8)`` on the first Adam
      step: ``±lr`` wherever ``|g|`` clears the rounding noise, so it must
      agree to 1e-6 wherever ``|g|`` exceeds 1e-3 of its maximum.
    * The GMM as :func:`_assert_gmm_close`; the regulariser parameters and
      the other Adam moments to 1e-5.
    """
    tb, (tf, tm) = vi_case["tb"], vi_case["timg"]
    oq, og, orr = _port_opts()
    warm = vi_state_from_numpy(vi_case["warm"], device="cpu")
    step = teng.make_vi_step(tb, oq, og, orr, tf, tm)
    new, met = step(warm, noise=_inject(vi_case["step_draws"]))
    ref, met_j = vi_case["new"], vi_case["met"]

    for k in ("ndv", "sat", "sat_resid"):
        np.testing.assert_array_equal(met[k].numpy(), met_j[k], err_msg=k)
    for k in ("data_term", "reg_term", "vd_alpha", "reg_energy"):
        np.testing.assert_allclose(met[k].numpy(), met_j[k], rtol=1e-4, err_msg=k)
    ent64 = _entropy_f64(vi_case["warm"].q_v, *vi_case["step_draws"][:2])
    np.testing.assert_allclose(float(met["entropy_term"]), ent64, rtol=1e-6)
    log_var_sum = float(np.sum(np.asarray(vi_case["warm"].q_v["log_var"], np.float64)))
    assert abs(float(met_j["entropy_term"]) - ent64) <= 2e-3 * 0.5 * abs(log_var_sum)
    np.testing.assert_allclose(float(met["total_loss"]),
                               float(met_j["total_loss"]) + float(met_j["entropy_term"]) - ent64,
                               rtol=1e-4)
    for k in ("gmm_scales", "gmm_proportions"):
        np.testing.assert_allclose(met[k].numpy(), met_j[k], atol=1e-5, rtol=1e-5)
    for name in ("mu", "log_var", "u"):
        np.testing.assert_allclose(met[f"max_update_{name}"].numpy(),
                                   met_j[f"max_update_{name}"], rtol=1e-3, atol=1e-6)
        g_t = new.opt_q_v.mu[name].numpy() / 0.1
        g_j = np.asarray(ref.opt_q_v.mu[name]) / 0.1
        dg = g_t - g_j
        rms, rms_j = np.sqrt(np.mean(dg ** 2)), np.sqrt(np.mean(g_j ** 2))
        assert rms <= (3e-3 if name == "u" else 1e-3) * rms_j, (name, rms, rms_j)
        assert np.abs(dg).max() <= 2e-2 * np.abs(g_j).max(), name
        clear = np.abs(g_j) > 1e-3 * np.abs(g_j).max()
        np.testing.assert_allclose(new.q_v[name].numpy()[clear],
                                   np.asarray(ref.q_v[name])[clear], atol=1e-6, err_msg=name)
    _assert_gmm_close(new.gmm, ref.gmm, new.opt_gmm, ref.opt_gmm)
    for k, v in ref.reg.items():
        np.testing.assert_allclose(new.reg[k].numpy(), v, atol=1e-5, rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(new.opt_reg.step.numpy(), ref.opt_reg.step)
    for part in ("mu", "nu"):
        for k, v in getattr(ref.opt_reg, part).items():
            np.testing.assert_allclose(getattr(new.opt_reg, part)[k].numpy(), v, atol=1e-6,
                                       rtol=1e-4, err_msg=f"opt_reg.{part}.{k}")
    assert new.step == int(ref.step) == 1


def test_vi_state_convert_round_trip():
    jb, _, _, _ = _bundles((8, 8, 8), "pre")
    state, _ = _jax_state(jb, (8, 8, 8))
    tree = _np(state)
    back = vi_state_to_numpy(vi_state_from_numpy(tree, device="cpu"))
    flat_ref, treedef = jax.tree.flatten(tree)
    rebuilt = JVIState(**{**back, **{k: JAdam(**back[k])
                                     for k in ("opt_q_v", "opt_gmm", "opt_reg")}})
    flat_back, treedef_back = jax.tree.flatten(rebuilt)
    assert treedef_back == treedef
    for a, b in zip(flat_ref, flat_back):
        np.testing.assert_array_equal(b, a)
        assert np.asarray(a).dtype == np.asarray(b).dtype and np.shape(a) == np.shape(b)


def test_vi_chunk_runs_on_its_own_draws():
    """The port's warm-up and chunk with draws from its generators: the
    step advances, the metrics stack per step, the run is reproducible,
    and the warm-up hands the chunk a fresh key."""
    dims = (16, 16, 16)
    _, tb, _, (tf, tm) = _bundles(dims, "pre")
    oq, og, orr = _port_opts()
    q_v = tb.init_q_v(0.5, 0.1, device="cpu")

    def start():
        gmm, reg = tb.gmm.init_params("cpu"), tb.reg_loss.init_params("cpu")
        return teng.VIState(q_v=q_v, gmm=gmm, reg=reg, opt_q_v=oq.init(q_v),
                            opt_gmm=og.init(gmm), opt_reg=orr.init(reg),
                            key=torch.tensor([0, 7]), step=0)

    run = teng.make_vi_chunk(teng.make_vi_step(tb, oq, og, orr, tf, tm), 3)
    warm = teng.gmm_warmup(tb, og, start(), tf, tm)
    assert not torch.equal(warm.key, start().key)
    state, met = run(warm)
    assert state.step == 3 and met["total_loss"].shape == (3,)
    assert met["gmm_scales"].shape == (3, 4)
    assert torch.isfinite(met["total_loss"]).all()
    assert not torch.equal(state.q_v["mu"], q_v["mu"])
    again, _ = run(teng.gmm_warmup(tb, og, start(), tf, tm))
    assert torch.equal(again.q_v["mu"], state.q_v["mu"])
