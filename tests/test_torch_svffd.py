"""PyTorch port vs the JAX package: the SVFFD control-grid model of
experiment 5 on the CPU.

* the B-spline host code (1D kernels, spreading matrices, control grid
  size) and the spread with its gradient;
* ``BSplineFFD3D`` as a displacement model and ``SVFFD3D.integrate``;
* one SVFFD transition at 64³ (the block-gather warp) and one SVFFD VI
  step at 32³, with JAX's draws injected;
* the experiment-5 micro-runs through the port's trainer, and SVFFD
  checkpoints resumed across the packages both ways.

The JAX side runs unjitted or jitted on the CPU as its own suite does;
each tolerance is stated where it is not a plain elementwise 1e-5.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

import jax
import jax.numpy as jnp

from ir_sgmcmc_tpu.config import Config as JConfig
from ir_sgmcmc_tpu.data import sphere_pair
from ir_sgmcmc_tpu.data.dataset import SyntheticPairDataset as JSynthetic
from ir_sgmcmc_tpu.engine import ModelBundle as JBundle
from ir_sgmcmc_tpu.engine import init_chains as j_init_chains
from ir_sgmcmc_tpu.engine import make_mcmc_chunk as j_make_chunk
from ir_sgmcmc_tpu.engine.vi import VIState as JVIState
from ir_sgmcmc_tpu.engine.vi import make_vi_step as j_make_vi_step
from ir_sgmcmc_tpu.models import (GMM, DirichletPrior, LogEnergyExpGammaPrior,
                                  LogScaleNormalPrior, langevin_noise)
from ir_sgmcmc_tpu.models.reg_loss import RegLossLogNormal
from ir_sgmcmc_tpu.models.transformation import BSplineFFD3D as JFFD
from ir_sgmcmc_tpu.models.transformation import SVFFD3D as JSVFFD
from ir_sgmcmc_tpu.ops import bspline as jbs
from ir_sgmcmc_tpu.optim import adam_decay
from ir_sgmcmc_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from ir_sgmcmc_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from ir_sgmcmc_tpu_torch import engine as teng
from ir_sgmcmc_tpu_torch import models as tmod
from ir_sgmcmc_tpu_torch.config import Config
from ir_sgmcmc_tpu_torch.convert import (mcmc_state_from_numpy, mcmc_state_to_numpy,
                                         vi_state_from_numpy)
from ir_sgmcmc_tpu_torch.engine import mcmc as tmcmc
from ir_sgmcmc_tpu_torch.models.sampler import langevin_noise as t_langevin
from ir_sgmcmc_tpu_torch.ops import bspline as tbs
from ir_sgmcmc_tpu_torch.ops.grids import identity_grid
from ir_sgmcmc_tpu_torch.optim import adam_decay as t_adam
from ir_sgmcmc_tpu_torch.trainer import Trainer
from ir_sgmcmc_tpu_torch.utils.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parents[1]
EXP5 = {cps: REPO / f"configs/experiment5/config_SVFFD_{cps}.json" for cps in (2, 4)}
ALPHA = 0.1


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float32))


def _close(port, ref, atol, rtol=0.0, msg=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_allclose(port, np.asarray(ref), atol=atol, rtol=rtol, err_msg=msg)


def _smooth(rng, shape, peak, passes=2):
    x = rng.standard_normal(shape).astype(np.float32)
    for _ in range(passes):
        for ax in (-3, -2, -1):
            x = (np.roll(x, 1, ax) + x + np.roll(x, -1, ax)) / 3.0
    return (x * (peak / np.abs(x).max())).astype(np.float32)


# ---- B-spline host code and the spread --------------------------------------------

@pytest.mark.parametrize("stride", [1, 2, 3, 4])
def test_bspline_host_code_matches_jax(stride):
    """The 1D kernel and each axis's spreading matrix (numpy in both
    packages): exactly equal, for the control grid of several image sizes."""
    np.testing.assert_array_equal(tbs.bspline_kernel_1d(stride), jbs.bspline_kernel_1d(stride))
    for x in (-2.5, -1.2, -0.3, 0.0, 0.7, 1.9):
        assert tbs.cubic_bspline_value(x) == jbs.cubic_bspline_value(x)
    for n_out in (1, 7, 12, 33, 128):
        n_in = tbs.control_grid_size((n_out,), (stride,))[0]
        assert n_in == jbs.control_grid_size((n_out,), (stride,))[0]
        np.testing.assert_array_equal(tbs.transposed_conv_matrix(n_in, stride, stride, n_out),
                                      jbs.transposed_conv_matrix(n_in, stride, stride, n_out))


def test_control_grid_size_matches_jax():
    """The reference's formula ``ceil((S-1)/c) + 3``: 67 and 35 per axis at
    128³ for cps 2 and 4."""
    assert tbs.control_grid_size((128, 128, 128), (2, 2, 2)) == (67, 67, 67)
    assert tbs.control_grid_size((128, 128, 128), (4, 4, 4)) == (35, 35, 35)
    for dims, cps in (((64, 48, 20), (2, 3, 4)), ((12, 12, 12), (4, 4, 4)), ((5, 9, 1), (1, 2, 3))):
        assert tbs.control_grid_size(dims, cps) == jbs.control_grid_size(dims, cps)


@pytest.mark.parametrize("cps", [(2, 2, 2), (4, 4, 4), (2, 3, 4)])
def test_bspline_spread_matches_jax(cps):
    """The spread over a leading batch of 2 and its gradient.  Each output
    sums at most 4³ products of O(1) terms per axis pass, in another order
    than JAX's ``einsum`` on the CPU: 1e-5 absolute plus 1e-5 relative.
    Uniform control points spread to 1 in the interior (partition of
    unity)."""
    dims = (12, 16, 20)
    jffd, tffd = jbs.CubicBSplineFFD3D(dims, cps), tbs.CubicBSplineFFD3D(dims, cps)
    assert tffd.control_dims == jffd.control_dims
    rng = np.random.default_rng(1)
    cp = rng.standard_normal((2, 3) + tffd.control_dims).astype(np.float32)
    g = rng.standard_normal((2, 3) + dims).astype(np.float32)
    dense_j, vjp = jax.vjp(jax.vmap(jffd), jnp.asarray(cp))
    x = _t(cp).requires_grad_(True)
    dense_t = tffd(x)
    assert dense_t.shape == (2, 3) + dims
    _close(dense_t, dense_j, 1e-5, 1e-5)
    (gx,) = torch.autograd.grad(dense_t, x, _t(g))
    _close(gx, vjp(jnp.asarray(g))[0], 1e-5, 1e-5)
    ones = tffd(torch.ones((3,) + tffd.control_dims))
    _close(ones[:, 2:-2, 2:-2, 2:-2], np.ones((3, 8, 12, 16)), 1e-5)


def test_bspline_ffd_standalone_matches_jax():
    """``Cubic_B_spline_FFD_3D`` is a displacement model: ``(transformation,
    displacement)`` as JAX's, the identity at zero control points and a
    1-voxel displacement in the interior at unit ones."""
    dims, cps = (12, 12, 12), (4, 4, 4)
    t = tmod.make_transformation("Cubic_B_spline_FFD_3D", dims, cps=cps)
    j = JFFD(dims, cps)
    assert isinstance(t, tmod.BSplineFFD3D) and t.control_dims == j.control_dims
    assert not hasattr(t, "integrate")
    cp = np.random.default_rng(2).standard_normal((3,) + t.control_dims).astype(np.float32)
    tr_t, disp_t = t(_t(cp)[None])
    tr_j, disp_j = j(jnp.asarray(cp))
    _close(disp_t[0], disp_j, 1e-5, 1e-5)
    _close(tr_t[0], tr_j, 1e-6, 1e-5)
    tr0, disp0 = t(torch.zeros((1, 3) + t.control_dims))
    _close(tr0[0], identity_grid(dims, device="cpu"), 1e-6)
    _close(disp0, np.zeros((1, 3) + dims), 1e-6)
    _, disp1 = t(torch.ones((1, 3) + t.control_dims))
    _close(disp1[0, :, 3:-3, 3:-3, 3:-3], np.ones((3, 6, 6, 6)), 1e-3)


@pytest.mark.parametrize("cps", [2, 4])
def test_svffd_integrate_matches_jax_32(cps):
    """Spread, then 9 Taylor squarings and 7 split compositions, over 2
    samples at 32³, with dense displacements of several voxels.  The
    tolerances of ``test_svf_integrate_matches_jax_32`` (1e-4 on
    displacements of ~8 voxels after 16 compounding f32 steps); the
    gradient, which also passes the spread's transposes, 1e-4 absolute
    plus 1e-4 relative."""
    dims = (32, 32, 32)
    j = JSVFFD(dims, (cps,) * 3)
    t = tmod.make_transformation("SVFFD_3D", dims, cps=(cps,) * 3)
    assert isinstance(t, tmod.SVFFD3D)
    for a in ("max_disp", "displacement_clamp_bound", "image_clamp_bound", "use_gather",
              "control_dims"):
        assert getattr(t, a) == getattr(j, a), a
    rng = np.random.default_rng(cps)
    cp = _smooth(rng, (2, 3) + t.control_dims, 10.0)
    g = rng.standard_normal((2, 3) + dims).astype(np.float32)

    def jfun(c):
        tr, disp, _ = j.integrate(c)
        return tr, disp

    (tr_j, disp_j), vjp = jax.vjp(jax.vmap(jfun), jnp.asarray(cp))
    x = _t(cp).requires_grad_(True)
    tr_t, disp_t, warped = t.integrate(x)
    assert warped is None
    assert float(np.abs(np.asarray(disp_j)).max()) > 1.0
    _close(disp_t, disp_j, 1e-4)
    _close(tr_t, tr_j, 1e-5)
    (gx,) = torch.autograd.grad(disp_t, x, _t(g))
    _close(gx, vjp((jnp.zeros_like(tr_j), jnp.asarray(g)))[0], 1e-4, 1e-4)


# ---- one transition and one VI step --------------------------------------------------

def _bundles(dims, cps, scheme="post"):
    """``bench.py --model svffd``'s model (Sobolev s 2) in both packages,
    with the sphere pair."""
    dof = 3.0 * math.prod(dims)
    common = dict(dims=dims, sobolev_s=2, sobolev_lambda=0.5, uniform_noise_alpha=ALPHA,
                  noise_scheme=scheme, virtual_decimation=True, block_radius=3)
    jb = JBundle(gmm=GMM(4, 1), scale_prior=LogScaleNormalPrior(0.0, 2.3),
                 proportion_prior=DirichletPrior(4, 0.5),
                 reg_loss=RegLossLogNormal(w_reg=1.4, dims=dims, learnable=True),
                 reg_loc_prior=LogEnergyExpGammaPrior(w_reg=1.4, dof=dof),
                 reg_scale_prior=LogScaleNormalPrior(loc=2.8, scale=5.0),
                 transformation=JSVFFD(dims, (cps,) * 3, no_steps=12), **common)
    tb = teng.ModelBundle(
        gmm=tmod.GMM(4, 1), scale_prior=tmod.LogScaleNormalPrior(0.0, 2.3),
        proportion_prior=tmod.DirichletPrior(4, 0.5),
        reg_loss=tmod.RegLossLogNormal(w_reg=1.4, dims=dims, learnable=True),
        reg_loc_prior=tmod.LogEnergyExpGammaPrior(w_reg=1.4, dof=dof),
        reg_scale_prior=tmod.LogScaleNormalPrior(loc=2.8, scale=5.0),
        transformation=tmod.SVFFD3D(dims, (cps,) * 3, no_steps=12), **common)
    assert tb.field_dims == jb.field_dims == tbs.control_grid_size(dims, (cps,) * 3)
    fixed, moving = sphere_pair(dims, offset=(0.0, 0.0, 4.0))
    jimg = tuple({k: jnp.asarray(v) for k, v in d.items()} for d in (fixed, moving))
    timg = tuple({k: torch.as_tensor(v) for k, v in d.items()} for d in (fixed, moving))
    return jb, tb, jimg, timg


def _np_tree(state):
    return jax.tree.map(lambda x: np.array(x, copy=True), state)


def test_svffd_transition_matches_jax_64():
    """One 2-chain SVFFD transition at 64³, cps 2 (a 35³ control grid), on
    "post": the dense field warps the image by the block-gather warp (the
    B3/B4 path, radius 3).  JAX's Langevin draw (on the control grid) and
    uniform draw (on the dense grid) are re-derived from its chain keys
    and injected.  Tolerances of
    ``tests/test_torch_engine.py::test_transition_matches_jax``: ``σ²∇U``
    within 1e-3 RMS of its RMS above the ulp floor of ``v'/tau`` and 2% of
    its maximum elementwise; loss terms 1e-4 relative; counters equal;
    the GMM and reg parameters 1e-5, their Adam moments 1e-4 relative."""
    dims, tau = (64, 64, 64), 1e-2
    jb, tb, (jf, jm), (tf, tm) = _bundles(dims, 2)
    og, orr = adam_decay(0.2, 1e-3), adam_decay({"loc": 0.01, "log_scale": 0.01}, 1e-3)
    gmm = jb.gmm.init_scales_from_residual_std(jb.gmm.init_params(), 1.0)
    gmm["logits"] = jnp.asarray([0.3, -0.2, 0.1, -0.4], jnp.float32)
    state_j = j_init_chains(jb, jax.random.PRNGKey(4), no_chains=2, mode="noise", q_v=None,
                            gmm=gmm, reg=jb.reg_loss.init_params(), opt_gmm=og, opt_reg=orr)
    tree = _np_tree(state_j)
    assert tree.v.shape == (2, 3, 35, 35, 35) and tree.welford.mean.shape == (2, 3) + dims
    eps, noise_j, unif = [], [], []
    for c in range(2):
        _, k_noise, k_unif = jax.random.split(jnp.asarray(tree.key[c]), 3)
        eps.append(np.asarray(jax.random.normal(k_noise, tree.v.shape[1:], jnp.float32)))
        noise_j.append(np.asarray(langevin_noise(k_noise, jnp.asarray(tree.sigma[c]), tau)))
        unif.append(np.asarray(jax.random.uniform(k_unif, (3,) + dims, jnp.float32,
                                                  -ALPHA, ALPHA)))
    eps, noise_j, unif = np.stack(eps), np.stack(noise_j), np.stack(unif)

    new_j, met_j = j_make_chunk(jb, og, orr, tau, jf, jm, chunk=1, burn_in=0, thin=1)(state_j)
    new_j = _np_tree(new_j)
    met_j = {k: np.asarray(v)[0] for k, v in met_j.items()}

    state_t = mcmc_state_from_numpy(tree, device="cpu")
    trans = tmcmc.make_sgld_transition(tb, t_adam(0.2, 1e-3),
                                       t_adam({"loc": 0.01, "log_scale": 0.01}, 1e-3),
                                       tau, tf, tm)
    new_t, met_t = trans(state_t, 1.0, noise=(_t(eps), _t(unif)))

    vp_j = tree.v + noise_j
    vp_t = (state_t.v + t_langevin(None, state_t.sigma, tau, _t(eps))).numpy()
    np.testing.assert_allclose(vp_t, vp_j, atol=1e-6)
    q_j = (vp_j - new_j.v) / tau
    q_t = (vp_t - new_t.v.numpy()) / tau
    floor = 8 * np.finfo(np.float32).eps * np.abs(vp_j).max() / tau
    dq = q_t - q_j
    rms = np.sqrt(np.mean(dq ** 2)), np.sqrt(np.mean(q_j ** 2))
    assert rms[0] <= floor / 8 + 1e-3 * rms[1], rms
    assert np.abs(dq).max() <= floor + 2e-2 * np.abs(q_j).max()

    for k in ("ndv", "sat", "sat_resid"):
        np.testing.assert_array_equal(met_t[k].numpy(), met_j[k], err_msg=k)
    for k in ("data_term", "reg_term", "vd_alpha", "reg_energy"):
        np.testing.assert_allclose(met_t[k].numpy(), met_j[k], rtol=1e-4, err_msg=k)
    got = mcmc_state_to_numpy(new_t)
    for group in ("gmm", "reg"):
        for k, v in getattr(new_j, group).items():
            np.testing.assert_allclose(got[group][k], v, atol=1e-6, rtol=1e-5)
    for opt in ("opt_gmm", "opt_reg"):
        js = getattr(new_j, opt)
        for part in ("mu", "nu"):
            for k, v in getattr(js, part).items():
                np.testing.assert_allclose(got[opt][part][k], v, atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(got["welford"]["mean"], new_j.welford.mean, atol=1e-4)


def test_svffd_vi_step_matches_jax_32():
    """One SVFFD VI step at 32³, cps 4 (a 12³ control grid), on "post"
    (``grid_sample`` below 64³), from a warm GMM, with JAX's q(v) draw (on
    the control grid) and uniform draws (on the dense grid) injected.
    Loss terms 1e-4 relative but the entropy term, whose ``Σ log σ²`` XLA
    sums in f32: both are held within 1e-4 of the float64 sum's size; the
    q(v) gradient (Adam's first moment / 0.1) within 1e-3 RMS of its RMS
    and 2% of its maximum; the GMM scales and proportions 1e-4."""
    dims = (32, 32, 32)
    jb, tb, (jf, jm), (tf, tm) = _bundles(dims, 4)
    cdims = tb.field_dims
    rng = np.random.default_rng(5)
    q_v = {"mu": _smooth(rng, (3,) + cdims, 3.0),
           "log_var": np.full((3,) + cdims, 2.0 * np.log(np.float32(0.5)), np.float32),
           "u": np.full((3,) + cdims, 0.1, np.float32)}
    lrs = ({"mu": 0.01, "log_var": 0.01, "u": 0.01}, {"log_std": 0.2, "logits": 0.2},
           {"loc": 0.01, "log_scale": 0.01})
    oq, og, orr = (adam_decay(lr, 1e-3) for lr in lrs)
    gmm = jb.gmm.init_scales_from_residual_std(jb.gmm.init_params(), 1.0)
    gmm["logits"] = jnp.asarray([0.3, -0.2, 0.1, -0.4], jnp.float32)
    jq = {k: jnp.asarray(v) for k, v in q_v.items()}
    state = JVIState(q_v=jq, gmm=gmm, reg=jb.reg_loss.init_params(), opt_q_v=oq.init(jq),
                     opt_gmm=og.init(gmm), opt_reg=orr.init(jb.reg_loss.init_params()),
                     key=jax.random.PRNGKey(6), step=jnp.zeros((), jnp.int32))
    tree = _np_tree(state)
    new_j, met_j = jax.jit(j_make_vi_step(jb, oq, og, orr, jf, jm))(state)
    _, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(6), 4)
    k_eps, k_x = jax.random.split(k1)
    draws = (np.asarray(jax.random.normal(k_eps, (3,) + cdims, jnp.float32)),
             np.asarray(jax.random.normal(k_x, (), jnp.float32)),
             np.stack([np.asarray(jax.random.uniform(k, (3,) + dims, jnp.float32, -ALPHA, ALPHA))
                       for k in (k2, k3)]))

    t_opts = tuple(t_adam(lr, 1e-3) for lr in lrs)
    step = teng.make_vi_step(tb, *t_opts, tf, tm)
    new_t, met_t = step(vi_state_from_numpy(tree, device="cpu"),
                        noise=tuple(torch.tensor(a) for a in draws))
    for k in ("ndv", "sat", "sat_resid"):
        np.testing.assert_array_equal(met_t[k].numpy(), np.asarray(met_j[k]), err_msg=k)
    for k in ("data_term", "reg_term", "vd_alpha", "reg_energy"):
        np.testing.assert_allclose(met_t[k].numpy(), np.asarray(met_j[k]), rtol=1e-4, err_msg=k)
    log_var_sum = abs(float(np.sum(q_v["log_var"], dtype=np.float64)))
    for k in ("entropy_term", "total_loss"):
        assert abs(float(met_t[k]) - float(met_j[k])) <= 1e-4 * log_var_sum, k
    for name in ("mu", "log_var", "u"):
        g_t = new_t.opt_q_v.mu[name].numpy() / 0.1
        g_j = np.asarray(new_j.opt_q_v.mu[name]) / 0.1
        assert g_t.shape == (3,) + cdims
        dg = g_t - g_j
        assert np.sqrt(np.mean(dg ** 2)) <= 1e-3 * np.sqrt(np.mean(g_j ** 2)), name
        assert np.abs(dg).max() <= 2e-2 * np.abs(g_j).max(), name
    for k in ("gmm_scales", "gmm_proportions"):
        np.testing.assert_allclose(met_t[k].numpy(), np.asarray(met_j[k]), rtol=1e-4)


# ---- experiment 5 through the trainer, and checkpoints across packages ----------------

def _micro(path, tmp_path, dims=12, **trainer_overrides):
    """Experiment 5 shrunk to a synthetic micro-run (``_micro`` of
    ``tests/test_configs.py``)."""
    cfg = json.loads(Path(path).read_text())
    cfg["data_loader"] = {"type": "SyntheticDataLoader",
                          "args": {"dims": [dims] * 3, "sigma_v_init": 0.5, "u_v_init": 0.1}}
    cfg["transformation_module"]["args"].update(no_steps=6, max_disp=4)
    cfg["trainer"].update(
        save_dir=str(tmp_path), no_iters_VI=6, log_period_VI=6, no_samples_VI_test=2,
        no_chains=2, no_iters_burn_in=2, no_samples_MCMC=4, log_period_MCMC=4,
        speed_test_iters=2, tensorboard=False)
    cfg["trainer"].update(trainer_overrides)
    return cfg


@pytest.mark.parametrize("cps", [2, 4])
def test_experiment5_svffd_micro_run(tmp_path, cps):
    """Twin of ``tests/test_configs.py::test_experiment5_svffd_micro_run``:
    the SVFFD config through both phases of the port's trainer at 12³; its
    checkpoints hold control-grid leaves and dense Welford accumulators."""
    config = Config(_micro(EXP5[cps], tmp_path), run_id="test")
    assert type(config.build_bundle().transformation).__name__ == "SVFFD3D"
    s = Trainer(config, device="cpu").run()[0]
    assert "mcmc_aborted" not in s
    assert s["vi_samples_per_sec"] > 0 and s["mcmc_samples_per_sec"] > 0
    assert np.isfinite(s["vi_test_mean_dsc"]) and np.isfinite(s["mcmc_mean_dsc"])
    cdims = tbs.control_grid_size((12,) * 3, (cps,) * 3)
    with np.load(config.save_dirs["models"] / "mcmc_latest.npz") as f:
        assert f["leaf::.v"].shape == (2, 3) + cdims
        assert f["leaf::.welford.mean"].shape == (2, 3, 12, 12, 12)
    with np.load(config.save_dirs["models"] / "vi_latest.npz") as f:
        assert f["leaf::.q_v['mu']"].shape == (3,) + cdims


@pytest.mark.parametrize("phase", ["VI", "MCMC"])
def test_svffd_checkpoint_resumes_across_packages(tmp_path, phase):
    """An SVFFD ``vi_latest.npz`` / ``mcmc_latest.npz`` written by the JAX
    package (at step 4 / transition 4) resumes in the port's trainer, which
    runs on to step 6 / transition 6 and writes its own checkpoint; the JAX
    package loads that one into its SVFFD state, control-grid leaves and
    all."""
    cfg = _micro(EXP5[2], tmp_path, no_iters_VI=6, log_period_VI=2, no_samples_VI_test=0,
                 log_period_MCMC=2, speed_test_iters=1, VI=phase == "VI",
                 MCMC=phase == "MCMC", MCMC_init="noise")
    jc = JConfig(json.loads(json.dumps(cfg)), run_id="jax")
    jb = jc.build_bundle()
    oq, og, orr = jc.build_optimizers(jb)
    _, _, q_v0 = JSynthetic((12, 12, 12), cps=(2, 2, 2))[0]
    q_v = {k: jnp.asarray(v) for k, v in q_v0.items()}
    assert q_v["mu"].shape == (3, 9, 9, 9)
    gmm, reg = jb.gmm.init_params(), jb.reg_loss.init_params()
    if phase == "VI":
        state = JVIState(q_v=q_v, gmm=gmm, reg=reg, opt_q_v=oq.init(q_v),
                         opt_gmm=og.init(gmm), opt_reg=orr.init(reg),
                         key=jax.random.PRNGKey(3), step=jnp.asarray(4, jnp.int32))
        meta = {"phase": "VI", "phase_done": 0, "vi_iters": 4, "config": "experiment5"}
        name, count, final = "vi_latest.npz", "vi_iters", 6
    else:
        state = j_init_chains(jb, jax.random.PRNGKey(3), 2, "noise", None, gmm, reg, og, orr)
        state = state._replace(step=jnp.asarray(4, jnp.int32))
        meta = {"phase": "MCMC", "phase_done": 1, "mcmc_steps": 4, "block_radius": 2,
                "config": "experiment5"}
        name, count, final = "mcmc_latest.npz", "mcmc_steps", 6
    j_save_checkpoint(tmp_path / name, state, meta)

    tc = Config(json.loads(json.dumps(cfg)), run_id="port")
    s = Trainer(tc, device="cpu", resume=str(tmp_path / name)).run()[0]
    assert "mcmc_aborted" not in s
    restored, got = j_load_checkpoint(tc.save_dirs["models"] / name,
                                      jax.tree.map(np.zeros_like, state))
    assert got[count] == final and int(restored.step) == final
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(restored))
    # and the port loads the JAX checkpoint into its own template
    template = (vi_state_from_numpy if phase == "VI" else mcmc_state_from_numpy)(
        jax.tree.map(np.zeros_like, _np_tree(state)), device="cpu")
    mine, _ = load_checkpoint(tmp_path / name, template)
    leaf = mine.q_v["mu"] if phase == "VI" else mine.v
    assert tuple(leaf.shape[-3:]) == (9, 9, 9)
