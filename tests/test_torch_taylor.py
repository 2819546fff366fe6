"""The pure Taylor composition form (``taylor_compositions: "taylor"``) of
the port against the JAX package, on the CPU.

* ``ops.stencil.taylor_compose_step`` forward and VJP against JAX's
  ``custom_vjp`` (atol 1e-5), one field and a batch of two;
* ``SVF3D``'s and ``SVFFD3D``'s plan under ``"taylor"`` (split point,
  squarings, compositions, image compositions, Taylor squarings, both
  clamp bounds) against JAX's at several ``(max_disp, taylor_threshold,
  no_steps)``, among them a fallback to ``"warp"`` and ``m = N // K > 1``;
* ``SVF3D.integrate`` with and without the image (the grouped ψ-cascade,
  ``m = 2``), forward and the velocity's gradient, atol 1e-5;
* the sharded composition (``parallel.taylor_compose_sharded``) on 2 and 4
  CPU slabs against the unsharded step, and the spatially sharded MCMC
  chunk on ``"post"`` and VI step on ``"pre"`` on 2 and 4 slabs against
  the JAX package's unsharded chunk and step with JAX's draws
  (``tests/test_torch_spatial.py``'s problem and tolerances);
* the nearest-neighbour ``grid_sample`` at NaN points (a folded chain's
  segmentation warp) against JAX's;
* the trainer on the demo config at 12³ with ``"taylor"``: it runs to its
  summary, a finished posterior or a guard's abort (the JAX package records
  the form as unstable end-to-end).
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

from ir_sgmcmc_tpu.models.transformation import SVF3D as JSVF3D
from ir_sgmcmc_tpu.models.transformation import SVFFD3D as JSVFFD3D
from ir_sgmcmc_tpu.ops import resample as jresample
from ir_sgmcmc_tpu.ops import stencil as jstencil
from ir_sgmcmc_tpu_torch.config import Config
from ir_sgmcmc_tpu_torch.models.transformation import SVF3D, SVFFD3D
from ir_sgmcmc_tpu_torch.ops import stencil as tstencil
from ir_sgmcmc_tpu_torch.parallel import gather, make_mesh, taylor_compose_sharded
from ir_sgmcmc_tpu_torch.trainer import Trainer

CPU = torch.device("cpu")
DEMO = Path(__file__).parent.parent / "configs/demo/config_synthetic.json"
ATOL = 1e-5


def _smooth(rng, shape, peak, passes=3):
    x = rng.standard_normal(shape).astype(np.float32)
    for _ in range(passes):
        for ax in (-3, -2, -1):
            x = (np.roll(x, 1, ax) + x + np.roll(x, -1, ax)) / 3.0
    return (x * (peak / np.abs(x).max())).astype(np.float32)


def _jax_vjp(fn, xs, g):
    jresample.set_pallas_mode(False)
    try:
        out, vjp = jax.vjp(fn, *[jnp.asarray(x) for x in xs])
        return np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(g))]
    finally:
        jresample.set_pallas_mode(None)


def _torch_vjp(fn, xs, g):
    xs = [torch.tensor(x, requires_grad=True) for x in xs]
    out = fn(*xs)
    grads = torch.autograd.grad((out * torch.as_tensor(g)).sum(), xs)
    return out.detach().numpy(), [t.numpy() for t in grads]


# ---- the composition step ---------------------------------------------------------

@pytest.mark.parametrize("lead", [(), (2,)], ids=["one", "batch2"])
def test_taylor_compose_step_matches_jax(lead):
    """Forward and both cotangents of the analytic VJP, at sub-voxel
    offsets ``u`` and a displacement ``d`` of a few voxels (the JAX
    function on each field of a batch in turn)."""
    rng = np.random.default_rng(0)
    dims = (12, 10, 14)
    d = _smooth(rng, lead + (3,) + dims, 3.0)
    u = _smooth(rng, lead + (3,) + dims, 0.5)
    g = rng.standard_normal(lead + (3,) + dims).astype(np.float32)
    out, (gd, gu) = _torch_vjp(tstencil.taylor_compose_step, [d, u], g)
    rows = [(d, u, g)] if not lead else list(zip(d, u, g))
    refs = [_jax_vjp(jstencil.taylor_compose_step, [di, ui], gi) for di, ui, gi in rows]
    ref_out = np.stack([r[0] for r in refs]).reshape(out.shape)
    np.testing.assert_allclose(out, ref_out, atol=ATOL)
    np.testing.assert_allclose(gd, np.stack([r[1][0] for r in refs]).reshape(gd.shape),
                               atol=ATOL)
    np.testing.assert_allclose(gu, np.stack([r[1][1] for r in refs]).reshape(gu.shape),
                               atol=ATOL)


# ---- the plan ---------------------------------------------------------------------

PLANS = [
    {"max_disp": 8, "taylor_threshold": 0.5, "no_steps": 12},  # the bench model: e 4, K 8
    {"max_disp": 4, "taylor_threshold": 0.5, "no_steps": 8},  # e 3, K 4, m 2
    {"max_disp": 8, "taylor_threshold": 1.0, "no_steps": 12},  # taylor_comp1: e 3, m 1
    {"max_disp": 4, "taylor_threshold": 0.5, "no_steps": 2},  # e > no_steps: "warp"
    {"max_disp": 4, "taylor_threshold": 0.0, "no_steps": 8},  # Taylor off: "warp"
    {"max_disp": 16, "taylor_threshold": 0.25, "no_steps": 10},
]
PLAN_ATTRS = ("composition_form", "taylor_compositions", "no_squarings", "no_compositions",
              "no_image_compositions", "no_taylor", "displacement_clamp_bound",
              "image_clamp_bound")


@pytest.mark.parametrize("kw", PLANS, ids=lambda kw: "-".join(str(v) for v in kw.values()))
@pytest.mark.parametrize("form", ["taylor", True])
def test_taylor_plan_matches_jax(kw, form):
    dims = (16, 16, 16)
    j = JSVF3D(dims, taylor_compositions=form, **kw)
    t = SVF3D(dims, taylor_compositions=form, **kw)
    for name in PLAN_ATTRS:
        assert getattr(t, name) == getattr(j, name), name
    jf = JSVFFD3D(dims, (2, 2, 2), taylor_compositions=form, **kw)
    tf = SVFFD3D(dims, (2, 2, 2), taylor_compositions=form, **kw)
    for name in PLAN_ATTRS:
        assert getattr(tf.svf, name) == getattr(jf.svf, name), name
    assert tf.displacement_clamp_bound == jf.displacement_clamp_bound
    assert tf.image_clamp_bound == jf.image_clamp_bound


def test_taylor_plan_groups_the_image_warps():
    """``max_disp`` 4, threshold 0.5, 8 steps: ``e = 3``, ``K = 4`` image
    warps, one every ``m = 2`` compositions, and no clamp of the
    displacement."""
    t = SVF3D((16, 16, 16), no_steps=8, max_disp=4, taylor_compositions="taylor")
    assert (t.composition_form, t.no_compositions, t.no_image_compositions) == ("taylor", 8, 4)
    assert t.no_compositions // t.no_image_compositions == 2
    assert t.displacement_clamp_bound == float("inf") and t.image_clamp_bound == 4.0


# ---- the integration --------------------------------------------------------------

@pytest.mark.parametrize("with_image", [False, True], ids=["field", "image"])
def test_taylor_integrate_matches_jax(with_image):
    """``integrate`` at ``m = 2`` (max_disp 4, 8 steps): the displacement
    and, with the image, the grouped ψ-cascade's warped image, and the
    gradient of both in ``v``, atol 1e-5."""
    dims = (16, 12, 14)
    rng = np.random.default_rng(1)
    v = _smooth(rng, (3,) + dims, 3.0)
    im = _smooth(rng, dims, 1.0, passes=1)
    gd = rng.standard_normal((3,) + dims).astype(np.float32)
    gi = rng.standard_normal(dims).astype(np.float32)
    j = JSVF3D(dims, no_steps=8, max_disp=4, taylor_compositions="taylor")
    t = SVF3D(dims, no_steps=8, max_disp=4, taylor_compositions="taylor")

    def jfn(vv):
        _, d, w = j.integrate(vv, im=jnp.asarray(im) if with_image else None)
        return jnp.sum(d * gd) + (jnp.sum(w * gi) if with_image else 0.0), (d, w)

    jresample.set_pallas_mode(False)
    try:
        (_, (dj, wj)), gvj = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(v))
    finally:
        jresample.set_pallas_mode(None)
    vt = torch.tensor(v[None], requires_grad=True)
    _, dt, wt = t.integrate(vt, im=torch.as_tensor(im) if with_image else None)
    loss = torch.sum(dt[0] * torch.as_tensor(gd))
    if with_image:
        loss = loss + torch.sum(wt[0] * torch.as_tensor(gi))
        np.testing.assert_allclose(wt[0].detach().numpy(), np.asarray(wj), atol=ATOL)
    else:
        assert wt is None
    np.testing.assert_allclose(dt[0].detach().numpy(), np.asarray(dj), atol=ATOL)
    (gvt,) = torch.autograd.grad(loss, vt)
    np.testing.assert_allclose(gvt[0].numpy(), np.asarray(gvj), atol=ATOL)


# ---- the sharded steps ------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_taylor_compose_sharded(n):
    """Each slab's planes are the unsharded step's, forward and gradient."""
    rng = np.random.default_rng(2)
    d = _smooth(rng, (2, 3, 16, 8, 8), 3.0)
    u = _smooth(rng, (2, 3, 16, 8, 8), 0.5)
    g = rng.standard_normal(d.shape).astype(np.float32)
    mesh = make_mesh(n, axes=("space",), devices=[CPU] * n)
    got = _torch_vjp(lambda a, b: gather(taylor_compose_sharded(a, b, mesh)), [d, u], g)
    ref = _torch_vjp(tstencil.taylor_compose_step, [d, u], g)
    for a, b in zip([got[0]] + got[1], [ref[0]] + ref[1]):
        np.testing.assert_allclose(a, b, atol=ATOL)


DIMS = (16, 8, 8)  # tests/test_parallel.py's
ALPHA = 0.1


def _bundles(scheme):
    """tests/test_torch_spatial.py's problem with the "taylor" form."""
    from ir_sgmcmc_tpu.engine.bundle import ModelBundle as JBundle
    from ir_sgmcmc_tpu.models import GMM as JG
    from ir_sgmcmc_tpu.models import DirichletPrior as JDir
    from ir_sgmcmc_tpu.models import LogScaleNormalPrior as JLSN
    from ir_sgmcmc_tpu.models.reg_loss import RegLossL2 as JL2
    from ir_sgmcmc_tpu_torch.engine import ModelBundle
    from ir_sgmcmc_tpu_torch.models import DirichletPrior, LogScaleNormalPrior
    from ir_sgmcmc_tpu_torch.models.gmm import GMM
    from ir_sgmcmc_tpu_torch.models.reg_loss import RegLossL2

    common = dict(dims=DIMS, sobolev_s=1, uniform_noise_alpha=ALPHA, virtual_decimation=True,
                  noise_scheme=scheme)
    svf = dict(no_steps=4, max_disp=4, taylor_compositions="taylor")
    jb = JBundle(gmm=JG(2, 1), scale_prior=JLSN(0.0, 2.3), proportion_prior=JDir(2, 0.5),
                 reg_loss=JL2(w_reg=1.0, dims=DIMS), transformation=JSVF3D(DIMS, **svf),
                 **common)
    tb = ModelBundle(gmm=GMM(2, 1), scale_prior=LogScaleNormalPrior(0.0, 2.3),
                     proportion_prior=DirichletPrior(2, 0.5),
                     reg_loss=RegLossL2(w_reg=1.0, dims=DIMS),
                     transformation=SVF3D(DIMS, **svf), **common)
    return jb, tb


def _images():
    from ir_sgmcmc_tpu.data import sphere_pair

    fixed, moving = sphere_pair(DIMS, offset=(0, 0, 1))
    return (tuple({k: jnp.asarray(v) for k, v in x.items()} for x in (fixed, moving)),
            tuple({k: torch.as_tensor(np.asarray(v)) for k, v in x.items()}
                  for x in (fixed, moving)))


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


@functools.lru_cache(maxsize=1)
def _jax_mcmc():
    """JAX's unsharded 3-transition chunk on "post" from its state, with its
    draws: the initial state, the draws, ``v`` and the data term."""
    from ir_sgmcmc_tpu.engine import init_chains as j_init
    from ir_sgmcmc_tpu.engine import make_mcmc_chunk as j_chunk
    from ir_sgmcmc_tpu.optim import adam_decay as j_adam

    jb, _ = _bundles("post")
    (jf, jm), _ = _images()
    state_j = j_init(jb, jax.random.PRNGKey(0), no_chains=2, mode="noise", q_v=None,
                     gmm=jb.gmm.init_params(), reg=jb.reg_loss.init_params(),
                     opt_gmm=j_adam(0.2), opt_reg=j_adam(0.01))
    tree = _np(state_j)
    draws, keys = [], tree.key
    for _ in range(3):
        eps, unif, nxt = [], [], []
        for c in range(2):
            k, k_noise, k_unif = jax.random.split(jnp.asarray(keys[c]), 3)
            eps.append(np.asarray(jax.random.normal(k_noise, (3,) + DIMS, jnp.float32)))
            unif.append(np.asarray(jax.random.uniform(k_unif, (3,) + DIMS, jnp.float32,
                                                      -ALPHA, ALPHA)))
            nxt.append(np.asarray(k))
        draws.append((np.stack(eps), np.stack(unif)))
        keys = np.stack(nxt)
    new_j, met_j = j_chunk(jb, j_adam(0.2), j_adam(0.01), tau=1e-4, fixed=jf, moving=jm,
                           chunk=3, burn_in=0, thin=1)(state_j)
    return tree, draws, np.asarray(new_j.v), np.asarray(met_j["data_term"])


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_taylor_mcmc_chunk_matches_jax_unsharded(n):
    """3 transitions on ``"post"`` over a ``(1, n)`` ``('chain', 'space')``
    mesh of CPU shards against the JAX package's unsharded chunk with its draws: ``v``
    to atol 1e-5, the data term to rtol 1e-4."""
    from ir_sgmcmc_tpu_torch.convert import mcmc_state_from_numpy
    from ir_sgmcmc_tpu_torch.engine import make_mcmc_chunk
    from ir_sgmcmc_tpu_torch.optim import adam_decay
    from ir_sgmcmc_tpu_torch.parallel import shard_images_spatial, shard_state_spatial

    tree, draws, v_j, data_j = _jax_mcmc()
    _, tb = _bundles("post")
    _, (tf, tm) = _images()
    mesh = make_mesh((1, n), axes=("chain", "space"), devices=[CPU] * n)
    state = shard_state_spatial(mcmc_state_from_numpy(tree, device="cpu"), mesh, 2, DIMS[0])
    run = make_mcmc_chunk(tb, adam_decay(0.2), adam_decay(0.01), 1e-4,
                          shard_images_spatial(tf, mesh, DIMS[0]),
                          shard_images_spatial(tm, mesh, DIMS[0]), chunk=3, burn_in=0, thin=1)
    out, met = run(state, noise=[tuple(torch.as_tensor(a) for a in d) for d in draws])
    np.testing.assert_allclose(met["data_term"].numpy(), data_j, rtol=1e-4)
    np.testing.assert_allclose(gather(out).v.numpy(), v_j, atol=1e-5)


@functools.lru_cache(maxsize=1)
def _jax_vi():
    """JAX's unsharded 3-step VI chunk on ``"pre"``, with its draws."""
    from ir_sgmcmc_tpu.engine import VIState as JVIState
    from ir_sgmcmc_tpu.engine import make_vi_chunk as j_vi_chunk
    from ir_sgmcmc_tpu.engine import make_vi_step as j_vi_step
    from ir_sgmcmc_tpu.optim import adam_decay as j_adam

    jb, _ = _bundles("pre")
    (jf, jm), _ = _images()
    q_v = {"mu": jnp.zeros((3,) + DIMS, jnp.float32),
           "log_var": jnp.full((3,) + DIMS, -2.0, jnp.float32),
           "u": jnp.full((3,) + DIMS, 0.1, jnp.float32)}
    oq, og, orr = j_adam(1e-2), j_adam(0.2), j_adam(0.01)
    state_j = JVIState(q_v=q_v, gmm=jb.gmm.init_params(), reg=jb.reg_loss.init_params(),
                       opt_q_v=oq.init(q_v), opt_gmm=og.init(jb.gmm.init_params()),
                       opt_reg=orr.init(jb.reg_loss.init_params()), key=jax.random.PRNGKey(5),
                       step=jnp.zeros((), jnp.int32))
    tree = _np(state_j)
    draws, key = [], jnp.asarray(tree.key)
    for _ in range(3):
        key, k1, k2, k3 = jax.random.split(key, 4)
        k_eps, k_x = jax.random.split(k1)
        draws.append(tuple(np.array(a) for a in (
            jax.random.normal(k_eps, (3,) + DIMS, jnp.float32),
            jax.random.normal(k_x, (), jnp.float32),
            jnp.stack([jax.random.uniform(k, (3,) + DIMS, jnp.float32, -ALPHA, ALPHA)
                       for k in (k2, k3)]))))
    new_j, met_j = j_vi_chunk(j_vi_step(jb, oq, og, orr, jf, jm), chunk=3)(state_j)
    return tree, draws, np.asarray(new_j.q_v["mu"]), np.asarray(met_j["total_loss"])


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_taylor_pre_vi_step_matches_jax_unsharded(n):
    """3 VI steps on ``"pre"`` (the image rides the compositions as one warp
    every ``m`` Taylor steps) over ``n`` CPU shards against the JAX
    package's unsharded chunk with its draws: ``mu`` to atol 1e-5, the
    total loss to rtol 1e-4."""
    from ir_sgmcmc_tpu_torch.convert import vi_state_from_numpy
    from ir_sgmcmc_tpu_torch.engine import make_vi_chunk, make_vi_step
    from ir_sgmcmc_tpu_torch.optim import adam_decay
    from ir_sgmcmc_tpu_torch.parallel import shard_images_spatial, shard_tree_spatial

    tree, draws, mu_j, loss_j = _jax_vi()
    _, tb = _bundles("pre")
    _, (tf, tm) = _images()
    mesh = make_mesh(n, axes=("space",), devices=[CPU] * n)
    state = shard_tree_spatial(vi_state_from_numpy(tree, device="cpu"), mesh, DIMS[0])
    step = make_vi_step(tb, adam_decay(1e-2), adam_decay(0.2), adam_decay(0.01),
                        shard_images_spatial(tf, mesh, DIMS[0]),
                        shard_images_spatial(tm, mesh, DIMS[0]))
    out, met = make_vi_chunk(step, 3)(
        state, noise=[tuple(torch.as_tensor(a) for a in d) for d in draws])
    np.testing.assert_allclose(met["total_loss"].numpy(), loss_j, rtol=1e-4)
    np.testing.assert_allclose(gather(out).q_v["mu"].numpy(), mu_j, atol=1e-5)


# ---- a fault the "taylor" form found ------------------------------------------------

def test_nearest_sample_at_nan_points_matches_jax():
    """A chain that folds under the "taylor" form hands the trainer's
    segmentation warp NaN points (the demo config at 16³, MCMC).  The
    nearest-neighbour ``grid_sample`` takes index 0 where a coordinate is
    NaN, as XLA's float-to-int conversion does in the JAX package, instead
    of raising on an out-of-range index."""
    from ir_sgmcmc_tpu.ops.resample import grid_sample as j_grid_sample
    from ir_sgmcmc_tpu.ops.resample import grid_sample_2d as j_grid_sample_2d
    from ir_sgmcmc_tpu_torch.ops.resample import grid_sample, grid_sample_2d

    rng = np.random.default_rng(3)
    vol = rng.integers(0, 5, (6, 5, 7)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (3, 6, 5, 7)).astype(np.float32)
    grid[0, 1, 2, 3] = grid[1, 2, 2, 2] = grid[2, 3, 4, 5] = np.nan
    grid[:, 0, 0, 0] = np.nan
    got = grid_sample(torch.as_tensor(vol), torch.as_tensor(grid), mode="nearest")
    ref = j_grid_sample(jnp.asarray(vol), jnp.asarray(grid), mode="nearest")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got2 = grid_sample_2d(torch.as_tensor(vol[0]), torch.as_tensor(grid[:2, 0]), mode="nearest")
    ref2 = j_grid_sample_2d(jnp.asarray(vol[0]), jnp.asarray(grid[:2, 0]), mode="nearest")
    np.testing.assert_array_equal(got2.numpy(), np.asarray(ref2))


# ---- the trainer ------------------------------------------------------------------

def test_trainer_runs_the_taylor_form(tmp_path):
    """The demo config at 12³ with ``taylor_compositions: "taylor"`` on one
    device: both phases run through the "taylor" integrator and the run
    ends in a summary, with a finite VI-test Dice and either an MCMC Dice
    or a guard's abort (the form is unstable end-to-end in the JAX
    package too)."""
    c = json.loads(DEMO.read_text())
    c["data_loader"]["args"]["dims"] = [12, 12, 12]
    c["transformation_module"]["args"] = {"no_steps": 6, "max_disp": 4,
                                          "taylor_compositions": "taylor"}
    c["trainer"].update(save_dir=str(tmp_path), no_iters_VI=8, log_period_VI=4,
                        no_samples_VI_test=2, no_chains=2, no_iters_burn_in=3,
                        no_samples_MCMC=5, log_period_MCMC=4, speed_test_iters=2,
                        tensorboard=False)
    t = Trainer(Config(c, run_id="t"), device="cpu")
    assert t.bundle.transformation.composition_form == "taylor"
    s = t.run()[0]
    assert np.isfinite(s["vi_test_mean_dsc"])
    assert np.isfinite(s["mcmc_mean_dsc"]) if "mcmc_aborted" not in s else s["mcmc_aborted"]
