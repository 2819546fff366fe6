"""Anchored residual warping in SG-MCMC (``trainer.mcmc_anchor``) of the
port against the JAX package, on the CPU.

* ``ops.grids.inv_jacobian`` with its determinant floor;
* ``engine.mcmc.make_chain_anchor`` in the ``"taylor"`` and ``"blend"``
  modes (``W0``, ``d0``, ``Jinv``, ``GW0``) against JAX's, vmapped over two
  chains;
* the anchored ``engine.vi.forward_sample`` with JAX's uniform draw: the
  warp, the residuals and the counters ``sat`` and ``sat_resid`` equal to
  JAX's, and ``tests/test_engine.py``'s anchored checks (exact at the
  anchor, closer to the exact warp off it than a frozen anchor, the clamp
  counted in ``sat``);
* an anchored chunk of 7 transitions at ``anchor_period`` 3 (two blocks of
  3 and a trailing block of 1) over 2 chains against JAX's
  ``make_mcmc_chunk(anchored=True)`` with JAX's draws, in both modes, at
  ``tests/test_torch_spatial.py``'s tolerances (``v`` atol 1e-5, the data
  term rtol 1e-4, the counters equal); the same chunk on the chain mesh
  (each device anchors its own chains) and spatially sharded on 2 and 4
  CPU slabs;
* the ``"blend"`` mode's warp takes no gradient in ``W0`` (its forward and
  displacement gradient once per transition, the transposed blend never);
* the JAX engine's four silent fallbacks (``MCMC_params: "shared"``, the
  ``"pre"`` scheme, a model without ``integrate``, ``use_gather``): the
  anchored chunk is the unanchored one;
* the trainer with ``mcmc_anchor``: both phases at 12³, the saturation
  guard's anchored-radius cause, no block-radius escalation, and under
  ``pair_parallel`` the JAX trainer's warning and the pairs in turn.
"""

import dataclasses
import functools
import json
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

from ir_sgmcmc_tpu.engine.mcmc import make_chain_anchor as j_make_chain_anchor
from ir_sgmcmc_tpu.engine.vi import forward_sample as j_forward_sample
from ir_sgmcmc_tpu.ops.grids import inv_jacobian as j_inv_jacobian
from ir_sgmcmc_tpu.ops.resample import grid_sample as j_grid_sample
from ir_sgmcmc_tpu_torch.config import Config
from ir_sgmcmc_tpu_torch.engine import init_chains, make_mcmc_chunk
from ir_sgmcmc_tpu_torch.engine.mcmc import make_chain_anchor
from ir_sgmcmc_tpu_torch.engine.vi import forward_sample
from ir_sgmcmc_tpu_torch.ops.grids import inv_jacobian
from ir_sgmcmc_tpu_torch.ops.resample import grid_sample
from ir_sgmcmc_tpu_torch.optim import adam_decay
from ir_sgmcmc_tpu_torch.parallel import gather, make_mesh
from ir_sgmcmc_tpu_torch.trainer import Trainer

CPU = torch.device("cpu")
DEMO = Path(__file__).parent.parent / "configs/demo/config_synthetic.json"
DIMS = (12, 12, 12)  # tests/test_engine.py's
MODES = ["taylor", "blend"]


def _bundles(dims=DIMS, noise=None, vd=False, sobolev_s=2, reg=None, **svf):
    """tests/test_engine.py's ``_make_bundle`` in both packages, on "post"
    (``reg``: the L2 reg loss's keywords; default not learnable)."""
    from ir_sgmcmc_tpu.engine import ModelBundle as JBundle
    from ir_sgmcmc_tpu.models import GMM as JGMM
    from ir_sgmcmc_tpu.models import SVF3D as JSVF3D
    from ir_sgmcmc_tpu.models import DirichletPrior as JDir
    from ir_sgmcmc_tpu.models import LogScaleNormalPrior as JLSN
    from ir_sgmcmc_tpu.models.reg_loss import RegLossL2 as JL2
    from ir_sgmcmc_tpu_torch.engine import ModelBundle
    from ir_sgmcmc_tpu_torch.models import GMM, SVF3D, DirichletPrior, LogScaleNormalPrior
    from ir_sgmcmc_tpu_torch.models.reg_loss import RegLossL2

    common = dict(dims=dims, sobolev_s=sobolev_s, sobolev_lambda=0.5,
                  uniform_noise_alpha=noise, virtual_decimation=vd, noise_scheme="post")
    reg = {"learnable": False} if reg is None else reg
    jb = JBundle(gmm=JGMM(2, 1), scale_prior=JLSN(0.0, 2.3), proportion_prior=JDir(2, 0.5),
                 reg_loss=JL2(w_reg=1.0, dims=dims, **reg),
                 transformation=JSVF3D(dims, **svf), **common)
    tb = ModelBundle(gmm=GMM(2, 1), scale_prior=LogScaleNormalPrior(0.0, 2.3),
                     proportion_prior=DirichletPrior(2, 0.5),
                     reg_loss=RegLossL2(w_reg=1.0, dims=dims, **reg),
                     transformation=SVF3D(dims, **svf), **common)
    return jb, tb


def _images(dims=DIMS, offset=(0.0, 0.0, 2.0)):
    from ir_sgmcmc_tpu.data import sphere_pair

    fixed, moving = sphere_pair(dims, offset=offset)
    return (tuple({k: jnp.asarray(v) for k, v in x.items()} for x in (fixed, moving)),
            tuple({k: torch.as_tensor(np.asarray(v)) for k, v in x.items()}
                  for x in (fixed, moving)))


def _smooth(rng, shape, peak, passes=3):
    x = rng.standard_normal(shape).astype(np.float32)
    for _ in range(passes):
        for ax in (-3, -2, -1):
            x = (np.roll(x, 1, ax) + x + np.roll(x, -1, ax)) / 3.0
    return (x * (peak / np.abs(x).max())).astype(np.float32)


# ---- the frame map ----------------------------------------------------------------

def test_inv_jacobian_floor_matches_jax():
    """The adjugate over the determinant, with determinants within 1e-6 of
    zero floored to ±1e-6 by their sign (zero counting as positive): a
    regular voxel, an exactly singular one, and determinants of ±5e-7."""
    rng = np.random.default_rng(0)
    jac = (np.eye(3, dtype=np.float32)[:, :, None, None, None]
           + 0.2 * rng.standard_normal((3, 3, 2, 2, 2)).astype(np.float32))
    jac[:, :, 0, 0, 1] = [[1, 2, 3], [2, 4, 6], [0, 1, 1]]  # det 0
    jac[:, :, 0, 1, 0] = np.diag([5e-7, 1.0, 1.0])
    jac[:, :, 1, 0, 0] = np.diag([-5e-7, 1.0, 1.0])
    got = inv_jacobian(torch.as_tensor(jac)).numpy()
    ref = np.asarray(j_inv_jacobian(jnp.asarray(jac)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert got[0, 0, 0, 1, 0] == pytest.approx(1e6) and got[0, 0, 1, 0, 0] == pytest.approx(-1e6)


# ---- the anchor and the anchored forward chain -------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_make_chain_anchor_matches_jax(mode):
    """Two chains' anchors against JAX's vmapped ``make_chain_anchor``: the
    image sampled at ``T0`` (``grid_sample``), ``d0``, ``Jinv`` clipped to
    ±3 and, in the ``"taylor"`` mode only, ``∇W0``; none needs a gradient."""
    jb, tb = _bundles()
    (_, jm), (_, tm) = _images()
    v0 = _smooth(np.random.default_rng(1), (2, 3) + DIMS, 2.0)
    ref = jax.vmap(j_make_chain_anchor(jb, jm, mode))(jnp.asarray(v0))
    got = make_chain_anchor(tb, tm, mode)(torch.as_tensor(v0))
    assert sorted(got) == sorted(ref) == sorted(["W0", "d0", "Jinv"]
                                                + (["GW0"] if mode == "taylor" else []))
    for k, t in got.items():
        assert not t.requires_grad
        r = np.asarray(ref[k])
        np.testing.assert_allclose(t.numpy(), r.reshape(t.shape), atol=1e-5, err_msg=k)
    assert float(got["Jinv"].abs().max()) <= 3.0


@pytest.mark.parametrize("mode", MODES)
def test_anchored_forward_sample_matches_jax(mode):
    """One chain off its anchor by up to 1.5 voxels, anchor radius 1, with
    JAX's own uniform draw: the warped image and the residuals agree, and so
    do ``sat`` and ``sat_resid`` (a share of the voxels clamp, not all)."""
    jb, tb = _bundles(noise=0.2)
    (jf, jm), (tf, tm) = _images()
    rng = np.random.default_rng(2)
    v0 = _smooth(rng, (3,) + DIMS, 1.0)
    v1 = v0 + _smooth(rng, (3,) + DIMS, 1.5, passes=2)
    key = jax.random.PRNGKey(4)
    unif = np.array(jax.random.uniform(key, (3,) + DIMS, jnp.float32, -0.2, 0.2))
    ja = j_make_chain_anchor(jb, jm, mode)(jnp.asarray(v0))
    out_j = jax.jit(lambda v, k, a: j_forward_sample(jb, jf, jm, v, k, anchor=a,
                                                     anchor_radius=1))(jnp.asarray(v1), key, ja)
    ta = make_chain_anchor(tb, tm, mode)(torch.as_tensor(v0)[None])
    with torch.no_grad():
        out_t = forward_sample(tb, tf, tm, torch.as_tensor(v1)[None],
                               torch.as_tensor(unif)[None], anchor=ta, anchor_radius=1)
    n = int(out_j["sat_resid"])
    assert 0 < n < np.prod(DIMS), n
    for k in ("sat", "sat_resid", "ndv"):
        assert int(out_t[k][0]) == int(out_j[k]), k
    np.testing.assert_allclose(out_t["warped"][0].numpy(), np.asarray(out_j["warped"]),
                               atol=1e-5)
    np.testing.assert_allclose(out_t["residuals"][0].numpy(), np.asarray(out_j["residuals"]),
                               atol=1e-4)


def test_anchored_forward_tracks_the_exact_warp():
    """``tests/test_engine.py::test_anchored_forward_matches_exact_post_warp``
    on the port: at the anchor the warp is the single gather warp; a
    0.3-voxel step off it tracks the exact warp several times closer than a
    frozen anchor (blend 0.4x, Taylor 0.55x of its mean error)."""
    _, tb = _bundles()
    (_, _), (tf, tm) = _images()
    v0 = torch.as_tensor(0.5 * np.random.default_rng(1).standard_normal((1, 3) + DIMS),
                         dtype=torch.float32)
    tr = tb.transformation
    exact0 = grid_sample(tm["im"], tr.integrate(tb.smooth(v0))[0])
    v1 = v0 + 0.3
    exact1 = grid_sample(tm["im"], tr.integrate(tb.smooth(v1))[0])
    with torch.no_grad():
        for mode, ratio in (("blend", 0.4), ("taylor", 0.55)):
            anchor = make_chain_anchor(tb, tm, mode)(v0)
            out0 = forward_sample(tb, tf, tm, v0, None, anchor=anchor)
            torch.testing.assert_close(out0["warped"], exact0, atol=1e-5, rtol=0)
            out1 = forward_sample(tb, tf, tm, v1, None, anchor=anchor)
            err_anchored = (out1["warped"] - exact1).abs()
            err_frozen = (out0["warped"] - exact1).abs()
            assert err_anchored.mean() < ratio * err_frozen.mean(), mode
            assert err_anchored.max() < 0.2, mode


def test_anchored_residual_saturation_surfaces_in_sat():
    """``tests/test_engine.py``'s clamp check, counts held to JAX's: a
    3-voxel translation off a zero anchor clamps most voxels at radius 1
    and none at radius 4."""
    jb, tb = _bundles()
    (jf, jm), (tf, tm) = _images()
    v0 = np.zeros((3,) + DIMS, np.float32)
    v_far = np.full((3,) + DIMS, 3.0, np.float32)
    ja = j_make_chain_anchor(jb, jm)(jnp.asarray(v0))
    ta = make_chain_anchor(tb, tm)(torch.as_tensor(v0)[None])
    key = jax.random.PRNGKey(5)
    for radius in (1, 4):
        out_j = j_forward_sample(jb, jf, jm, jnp.asarray(v_far), key, anchor=ja,
                                 anchor_radius=radius)
        with torch.no_grad():
            out_t = forward_sample(tb, tf, tm, torch.as_tensor(v_far)[None], None, anchor=ta,
                                   anchor_radius=radius)
        assert int(out_t["sat"][0]) == int(out_j["sat"])
        assert int(out_t["sat_resid"][0]) == int(out_j["sat_resid"])
        if radius == 1:
            assert int(out_t["sat"][0]) > 0.5 * np.prod(DIMS)
        else:
            assert int(out_t["sat"][0]) == 0


# ---- the anchored chunk -------------------------------------------------------------

CHUNK_DIMS = (16, 8, 8)  # tests/test_parallel.py's
ALPHA = 0.1
STEPS, PERIOD = 7, 3


def _chunk_bundles():
    """tests/test_torch_spatial.py's problem (the L2 reg's defaults, VD)."""
    return _bundles(CHUNK_DIMS, noise=ALPHA, vd=True, sobolev_s=1, reg={}, no_steps=4,
                    max_disp=4)


@functools.lru_cache(maxsize=2)
def _jax_chunk(mode):
    """JAX's anchored chunk of STEPS transitions at anchor_period PERIOD
    over 2 chains, with its draws: the initial state, the draws, ``v``, the
    data term and the counters."""
    from ir_sgmcmc_tpu.engine import init_chains as j_init
    from ir_sgmcmc_tpu.engine import make_mcmc_chunk as j_chunk
    from ir_sgmcmc_tpu.optim import adam_decay as j_adam

    jb, _ = _chunk_bundles()
    (jf, jm), _ = _images(CHUNK_DIMS, (0, 0, 1))
    state_j = j_init(jb, jax.random.PRNGKey(0), no_chains=2, mode="noise", q_v=None,
                     gmm=jb.gmm.init_params(), reg=jb.reg_loss.init_params(),
                     opt_gmm=j_adam(0.2), opt_reg=j_adam(0.01))
    tree = jax.tree.map(lambda x: np.array(x, copy=True), state_j)
    draws, keys = [], tree.key
    for _ in range(STEPS):
        eps, unif, nxt = [], [], []
        for c in range(2):
            k, k_noise, k_unif = jax.random.split(jnp.asarray(keys[c]), 3)
            eps.append(np.asarray(jax.random.normal(k_noise, (3,) + CHUNK_DIMS, jnp.float32)))
            unif.append(np.asarray(jax.random.uniform(k_unif, (3,) + CHUNK_DIMS, jnp.float32,
                                                      -ALPHA, ALPHA)))
            nxt.append(np.asarray(k))
        draws.append((np.stack(eps), np.stack(unif)))
        keys = np.stack(nxt)
    new_j, met_j = j_chunk(jb, j_adam(0.2), j_adam(0.01), tau=1e-4, fixed=jf, moving=jm,
                           chunk=STEPS, burn_in=0, thin=1, anchored=True, anchor_radius=2,
                           anchor_mode=mode, anchor_period=PERIOD)(state_j)
    return tree, draws, np.asarray(new_j.v), {k: np.asarray(met_j[k]) for k in
                                              ("data_term", "sat", "sat_resid")}


def _torch_draws(draws):
    return [tuple(torch.as_tensor(a) for a in d) for d in draws]


def _check_chunk(v, met, ref_v, ref_met):
    np.testing.assert_allclose(met["data_term"].numpy(), ref_met["data_term"], rtol=1e-4)
    for k in ("sat", "sat_resid"):
        np.testing.assert_array_equal(met[k].numpy(), ref_met[k])
    np.testing.assert_allclose(v, ref_v, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_anchored_chunk_matches_jax(mode):
    """7 transitions, re-anchored at steps 0, 3 and 6 (two blocks and a
    trailing block), on one device and on a chain mesh of two CPU devices,
    each anchoring its own chain."""
    from ir_sgmcmc_tpu_torch.convert import mcmc_state_from_numpy
    from ir_sgmcmc_tpu_torch.parallel import shard_chain_state

    tree, draws, v_j, met_j = _jax_chunk(mode)
    _, tb = _chunk_bundles()
    _, (tf, tm) = _images(CHUNK_DIMS, (0, 0, 1))
    kw = dict(chunk=STEPS, burn_in=0, thin=1, anchored=True, anchor_radius=2,
              anchor_mode=mode, anchor_period=PERIOD)
    run = make_mcmc_chunk(tb, adam_decay(0.2), adam_decay(0.01), 1e-4, tf, tm, **kw)
    out, met = run(mcmc_state_from_numpy(tree, device="cpu"), noise=_torch_draws(draws))
    assert out.step == STEPS and met["data_term"].shape == (STEPS, 2)
    _check_chunk(out.v.numpy(), met, v_j, met_j)

    # the chain mesh draws each chain's own stream: equal to the unsharded
    # run on the same streams
    mesh = make_mesh(2, devices=[CPU, CPU])
    state = mcmc_state_from_numpy(tree, device="cpu")
    one, met_one = make_mcmc_chunk(tb, adam_decay(0.2), adam_decay(0.01), 1e-4, tf, tm,
                                   **kw)(state)
    two, met_two = make_mcmc_chunk(tb, adam_decay(0.2), adam_decay(0.01), 1e-4, tf, tm,
                                   chain_mesh=mesh, **kw)(shard_chain_state(state, mesh, 2))
    torch.testing.assert_close(gather(two).v, one.v, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(met_two["data_term"], met_one["data_term"], atol=0, rtol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_spatial_anchored_chunk_matches_jax_unsharded(mode, n):
    """The same chunk over a ``(1, n)`` ``('chain', 'space')`` mesh of CPU
    shards (each row anchoring its chains: ``W0`` from the whole image at
    each slab's points, ``Jinv`` and ``GW0`` by the sharded gradient, the
    "blend" mode by the halo warp at radius 2) against JAX's unsharded
    chunk."""
    from ir_sgmcmc_tpu_torch.convert import mcmc_state_from_numpy
    from ir_sgmcmc_tpu_torch.parallel import shard_images_spatial, shard_state_spatial

    tree, draws, v_j, met_j = _jax_chunk(mode)
    _, tb = _chunk_bundles()
    _, (tf, tm) = _images(CHUNK_DIMS, (0, 0, 1))
    mesh = make_mesh((1, n), axes=("chain", "space"), devices=[CPU] * n)
    state = shard_state_spatial(mcmc_state_from_numpy(tree, device="cpu"), mesh, 2,
                                CHUNK_DIMS[0])
    run = make_mcmc_chunk(tb, adam_decay(0.2), adam_decay(0.01), 1e-4,
                          shard_images_spatial(tf, mesh, CHUNK_DIMS[0]),
                          shard_images_spatial(tm, mesh, CHUNK_DIMS[0]), chunk=STEPS, burn_in=0,
                          thin=1, anchored=True, anchor_radius=2, anchor_mode=mode,
                          anchor_period=PERIOD)
    out, met = run(state, noise=_torch_draws(draws))
    _check_chunk(gather(out).v.numpy(), met, v_j, met_j)


def test_blend_anchor_takes_no_volume_gradient(monkeypatch):
    """The "blend" mode's warp of the anchored image runs forward and its
    displacement gradient once per transition, and never the transposed
    blend: ``W0`` carries no gradient, so autograd does not ask for one
    (on the card: B5 and B6 at the anchor radius, no B7)."""
    from ir_sgmcmc_tpu_torch.ops import resample

    calls = {"warp_bounded_fwd": 0, "warp_bounded_dgrad": 0, "warp_bounded_tblend": 0}
    for name in calls:
        def counted(*args, _f=getattr(resample._wb, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*args, **kw)

        monkeypatch.setattr(resample._wb, name, counted)
    _, tb = _bundles(noise=ALPHA)
    _, (tf, tm) = _images()
    og, orr = adam_decay(0.2), adam_decay(0.01)
    state = init_chains(tb, torch.Generator().manual_seed(3), 2, "noise", None,
                        tb.gmm.init_params("cpu"), tb.reg_loss.init_params("cpu"), og, orr,
                        device="cpu")
    make_mcmc_chunk(tb, og, orr, 1e-4, tf, tm, chunk=3, burn_in=0, thin=1, anchored=True,
                    anchor_mode="blend", anchor_period=2)(state)
    assert calls == {"warp_bounded_fwd": 3, "warp_bounded_dgrad": 3, "warp_bounded_tblend": 0}


FALLBACKS = ["shared", "pre", "no_integrate", "use_gather"]


@pytest.mark.parametrize("case", FALLBACKS)
def test_anchoring_falls_back_silently(case):
    """Where the JAX engine turns anchoring off (one shared GMM/reg set, the
    "pre" scheme, a model without ``integrate``, ``use_gather``), the
    anchored chunk runs the unanchored one: the same states and metrics."""
    from ir_sgmcmc_tpu_torch.models import BSplineFFD3D, SVF3D

    _, tb = _bundles((12, 12, 12), noise=ALPHA, no_steps=4, max_disp=4)
    _, (tf, tm) = _images()
    param_mode = "shared" if case == "shared" else "per_chain"
    if case == "pre":
        tb = dataclasses.replace(tb, noise_scheme="pre")
    elif case == "no_integrate":
        tb = dataclasses.replace(tb, transformation=BSplineFFD3D(DIMS, (4, 4, 4)))
    elif case == "use_gather":
        tb = dataclasses.replace(tb, transformation=SVF3D(DIMS, no_steps=4, use_gather=True))
    og, orr = adam_decay(0.2), adam_decay(0.01)
    outs = []
    for anchored in (False, True):
        state = init_chains(tb, torch.Generator().manual_seed(3), 2, "noise", None,
                            tb.gmm.init_params("cpu"), tb.reg_loss.init_params("cpu"), og, orr,
                            device="cpu", param_mode=param_mode)
        outs.append(make_mcmc_chunk(tb, og, orr, 1e-4, tf, tm, chunk=3, burn_in=0, thin=1,
                                    param_mode=param_mode, anchored=anchored,
                                    anchor_mode="blend", anchor_period=1)(state))
    (a, ma), (b, mb) = outs
    assert torch.equal(a.v, b.v)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


# ---- the trainer --------------------------------------------------------------------

def _demo(tmp_path, **trainer):
    c = json.loads(DEMO.read_text())
    c["data_loader"]["args"]["dims"] = [12, 12, 12]
    c["transformation_module"]["args"] = {"no_steps": 4, "max_disp": 4}
    c["trainer"].update(save_dir=str(tmp_path), no_iters_VI=6, log_period_VI=3,
                        no_samples_VI_test=2, no_chains=2, no_iters_burn_in=2,
                        no_samples_MCMC=4, log_period_MCMC=3, speed_test_iters=2,
                        tensorboard=False, seed=7, mcmc_anchor=True, anchor_period=2,
                        distribute=False)
    c["trainer"].update(trainer)
    return Config(c, run_id="t")


@pytest.mark.parametrize("mode", MODES)
def test_trainer_runs_anchored(tmp_path, caplog, mode):
    """``mcmc_anchor: true`` on one device: both phases run to a finite
    Dice; the saturation guard names the anchored-residual radius as the
    cause in MCMC (the block warp's radius in VI), and the block radius is
    never escalated under anchoring."""
    t = Trainer(_demo(tmp_path, anchor_mode=mode), device="cpu")
    s = t.run()[0]
    assert "mcmc_aborted" not in s
    assert np.isfinite(s["vi_test_mean_dsc"]) and np.isfinite(s["mcmc_mean_dsc"])
    with caplog.at_level(logging.WARNING):
        t._check_saturation(1, 1, 10, "MCMC")
        t._check_saturation(1, 1, 10, "VI")
    mcmc_msg, vi_msg = [r.message for r in caplog.records][-2:]
    assert "anchored-residual radius (2)" in mcmc_msg and "trainer.anchor_radius" in mcmc_msg
    assert "block_warp.radius" in vi_msg
    with pytest.raises(Exception) as err:
        t._check_saturation(10 ** 6, 10 ** 6, 10, "MCMC")
    assert t._escalated_radius(err.value, True) is None


def test_trainer_anchored_pairs_run_in_turn(tmp_path, caplog):
    """Under ``pair_parallel`` with ``mcmc_anchor`` the trainer warns and
    registers the pairs in turn, as the JAX trainer does
    (``ir_sgmcmc_tpu/trainer.py:147-162``): one summary per pair, each with
    its own speed test."""
    config = _demo(tmp_path, pair_parallel=True)
    config.cfg["data_loader"]["args"]["no_pairs"] = 2
    with caplog.at_level(logging.WARNING):
        s = Trainer(Config(config.cfg, run_id="p"), device="cpu").run()
    assert any("mcmc_anchor=true is not supported" in r.message
               and "registering pairs sequentially" in r.message for r in caplog.records)
    assert len(s) == 2 and all("mcmc_samples_per_sec" in x for x in s)
    assert not any("mcmc_aggregate_samples_per_sec" in x for x in s)
