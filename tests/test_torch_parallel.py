"""The port's multi-device layer (``ir_sgmcmc_tpu_torch/parallel``, the chain
mesh of ``make_mcmc_chunk``, the pair mesh of ``engine/pairs.py`` and the
trainer's ``distribute``) on the CPU, over meshes that name the CPU several
times (virtual shards, as the conftest's 8 virtual CPU devices are for the
JAX package).

Tolerances: the halo ops within 1e-5 of the port's unsharded ops and of the
JAX package's sharded functions (``pallas_mode="off"`` on 4 of the 8 CPU
devices), tests/test_parallel.py's 1e-5; B7Z's plain version within 1e-6 of
JAX's ``_local_tblend_zpad`` (the same sums in another order).  The
sharded chunks and the distributed trainer run every chain (or pair) on the
same per-row arithmetic in batches of another size: integer leaves and
counts are held equal, float leaves within rtol 1e-5 plus atol 1e-7 (a
reduction over a batch of another size may round differently: 3e-11 seen
on a 16³ chain state), Dice within 1e-6.

JAX's ``warp_bounded_sharded`` is, under ``shard_map``, its
``_exchange_halo_d``, ``_local_warp_fwd``, ``_local_dgrad``,
``_local_tblend_zpad`` and ``_exchange_tblend_z``
(``ir_sgmcmc_tpu/parallel/halo.py:188-215``).  Jitting its whole VJP
compiles for minutes on the CPU (the JAX suite marks its own gradient test
slow), so the warp's JAX reference here composes those same pieces: the two
exchanges under ``shard_map`` over 4 CPU devices, the per-shard pieces
eagerly on each shard.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

from ir_sgmcmc_tpu.engine.pairs import pair_device_count as jax_pair_device_count
from ir_sgmcmc_tpu.parallel import gradient_d_sharded as jax_gradient_d_sharded
from ir_sgmcmc_tpu.parallel import separable_conv3d_sharded as jax_conv_sharded
from ir_sgmcmc_tpu.parallel.halo import (_exchange_halo_d, _exchange_tblend_z, _local_dgrad,
                                         _local_tblend_zpad, _local_warp_fwd)
from ir_sgmcmc_tpu_torch.config import Config
from ir_sgmcmc_tpu_torch.data import sphere_pair
from ir_sgmcmc_tpu_torch.engine import (ModelBundle, init_chains, make_mcmc_chunk,
                                        make_pair_mesh, pair_device_count,
                                        posterior_statistics, shard_pairs)
from ir_sgmcmc_tpu_torch.engine.pairs import (make_pair_mcmc_chunk, make_pair_vi_chunk,
                                              stack_trees)
from ir_sgmcmc_tpu_torch.engine.vi import VIState, gmm_warmup
from ir_sgmcmc_tpu_torch.kernels import warp_bounded as twb
from ir_sgmcmc_tpu_torch.models import (GMM, SVF3D, DirichletPrior, LogEnergyExpGammaPrior,
                                        LogScaleNormalPrior, RegLossLogNormal)
from ir_sgmcmc_tpu_torch.ops.resample import warp_bounded
from ir_sgmcmc_tpu_torch.ops.stencil import gradient, separable_conv3d
from ir_sgmcmc_tpu_torch.optim import adam_decay
from ir_sgmcmc_tpu_torch.parallel import (Sharded, gather, gradient_d_sharded, make_mesh,
                                          replicate, separable_conv3d_sharded,
                                          shard_chain_state, shard_state_spatial,
                                          warp_bounded_sharded)
from ir_sgmcmc_tpu_torch.trainer import Trainer

CPU = torch.device("cpu")
DEMO = Path(__file__).parent.parent / "configs/demo/config_synthetic.json"


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float32))


def _space(n=4):
    return make_mesh(n, axes=("space",), devices=[CPU] * n)


def _jax_space(n=4):
    return jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("space",))


# ---- mesh and placement -------------------------------------------------------------

@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 8])
def test_pair_device_count_matches_jax(n_devices):
    """The largest device count that tiles the pairs, as the JAX rule."""
    for n_pairs in (1, 2, 3, 4, 5, 6, 8, 12):
        assert pair_device_count(n_pairs, n_devices) == jax_pair_device_count(n_pairs, n_devices)
    mesh = make_pair_mesh(6, devices=[CPU] * n_devices)
    assert mesh.shape == {"pair": jax_pair_device_count(6, n_devices)}


def test_placement_rules_and_gather():
    """The JAX module's rules: chain-major leaves cut over 'chain', fields
    along D over 'space', the rest (and the host key words' device) kept;
    gather is the inverse."""
    mesh = make_mesh((2, 2), axes=("chain", "space"), devices=[CPU] * 4)
    assert mesh.shape == {"chain": 2, "space": 2} and mesh.rows("space") == [[0, 1], [2, 3]]
    tree = {"v": torch.arange(4 * 3 * 8 * 2 * 2.0).reshape(4, 3, 8, 2, 2),
            "g": torch.arange(4.0), "s": torch.tensor(5.0)}
    placed = shard_state_spatial(tree, mesh, no_chains=4, field_depth=8)
    assert isinstance(placed, Sharded) and len(placed) == 4
    assert placed[3]["v"].shape == (2, 3, 4, 2, 2) and placed[1]["g"].shape == (2,)
    torch.testing.assert_close(placed[3]["v"], tree["v"][2:, :, 4:], rtol=0, atol=0)
    back = gather(placed)
    for k in tree:
        assert torch.equal(back[k], tree[k])
    assert all(torch.equal(t["s"], tree["s"]) for t in replicate(tree, mesh))
    with pytest.raises(ValueError):
        shard_chain_state(tree, make_mesh(3, devices=[CPU] * 3), no_chains=4)


# ---- halo ops -----------------------------------------------------------------------

def test_halo_conv_and_gradient_match_unsharded_and_jax():
    """``separable_conv3d_sharded`` and ``gradient_d_sharded`` on 4 shards
    against the port's unsharded ops and the JAX package's sharded ones."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 16, 8, 8)).astype(np.float32)
    kernel = np.array([0.1, 0.25, 0.3, 0.25, 0.1], np.float32)
    mesh, jmesh = _space(), _jax_space()
    conv = gather(separable_conv3d_sharded(_t(x), _t(kernel), mesh))
    np.testing.assert_allclose(conv.numpy(), separable_conv3d(_t(x), _t(kernel)).numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(
        conv.numpy(), np.asarray(jax_conv_sharded(jnp.asarray(x), jnp.asarray(kernel), jmesh)),
        atol=1e-5)
    grad = gather(gradient_d_sharded(_t(x), mesh))
    assert torch.equal(grad, gradient(_t(x))[:, 2])
    np.testing.assert_allclose(grad.numpy(), np.asarray(jax_gradient_d_sharded(x, jmesh)),
                               atol=1e-6)


def _jax_sharded_warp(vol, disp, g, radius, n=4):
    """The JAX package's ``warp_bounded_sharded`` forward and analytic VJP
    (``pallas_mode="off"``), from its own pieces: the halo and z-row
    exchanges under ``shard_map`` over ``n`` CPU devices, the per-shard
    blend, dgrad and z-pad transpose blend on each shard."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    mesh = _jax_space(n)
    spec = P(*((None,) * (vol.ndim - 3)), "space", None, None)

    def over_mesh(fn, x):
        return np.asarray(shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec)(x))

    vh = over_mesh(lambda x: _exchange_halo_d(x, radius, "space"), vol)
    dl = vol.shape[-3] // n
    hl = dl + 2 * radius
    out, g_disp, acc = [], [], []
    for i in range(n):
        v_i = vh[..., i * hl:(i + 1) * hl, :, :]
        d_i, g_i = disp[:, i * dl:(i + 1) * dl], g[..., i * dl:(i + 1) * dl, :, :]
        out.append(np.asarray(_local_warp_fwd(v_i, d_i, radius, "off")))
        g_disp.append(np.asarray(_local_dgrad(v_i, d_i, g_i, radius, "off")))
        acc.append(np.asarray(_local_tblend_zpad(d_i, g_i, radius, "off")))
    g_vol = over_mesh(lambda a: _exchange_tblend_z(a, radius, "space"),
                      np.concatenate(acc, axis=-3))
    return np.concatenate(out, axis=-3), g_vol, np.concatenate(g_disp, axis=-3)


@pytest.mark.parametrize("radius,chan", [(1, None), (2, 3)])
def test_warp_bounded_sharded_matches_unsharded_and_jax(radius, chan):
    """The halo-exchanged warp over 4 shards: forward, ``g_vol`` and
    ``g_disp`` against the port's unsharded ``warp_bounded`` and the JAX
    package's ``warp_bounded_sharded`` (analytic backward, XLA per shard)."""
    rng = np.random.default_rng(11 + radius)
    dims = (16, 8, 12)
    vshape = ((chan,) if chan else ()) + dims
    vol = rng.standard_normal(vshape).astype(np.float32)
    disp = ((rng.random((3,) + dims) * 2 - 1) * radius * 1.2).astype(np.float32)
    probe = rng.standard_normal(vshape).astype(np.float32)

    v, d = _t(vol).requires_grad_(True), _t(disp).requires_grad_(True)
    out = gather(warp_bounded_sharded(v, d, radius, _space()))
    g_vol, g_disp = torch.autograd.grad((out * _t(probe)).sum(), [v, d])

    v1, d1 = _t(vol).requires_grad_(True), _t(disp).requires_grad_(True)
    ref = warp_bounded(v1.reshape((1, chan or 1) + dims), d1[None], radius).reshape(vshape)
    r_vol, r_disp = torch.autograd.grad((ref * _t(probe)).sum(), [v1, d1])
    for got, want in ((out, ref), (g_vol, r_vol), (g_disp, r_disp)):
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-5)

    for got, want in zip((out, g_vol, g_disp), _jax_sharded_warp(vol, disp, probe, radius)):
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)


def test_warp_bounded_sharded_needs_two_radii_per_shard():
    vol, disp = torch.zeros((16, 4, 4)), torch.zeros((3, 16, 4, 4))
    with pytest.raises(ValueError, match="2\\*radius"):
        warp_bounded_sharded(vol, disp, 3, _space())
    warp_bounded_sharded(vol, disp, 2, _space())  # 4 planes per shard suffice at R 2


@pytest.mark.parametrize("radius,chan,dims", [(1, 1, (4, 6, 9)), (2, 3, (5, 7, 6)),
                                              (3, 2, (2, 3, 5))])
def test_tblend_zpad_plain_matches_jax(radius, chan, dims):
    """B7Z's plain version, ``(B, C, D + 2R, H, W)`` with y/x folded and the
    z pad planes unfolded, against the JAX package's ``_local_tblend_zpad``
    (its XLA form); its z fold is B7's plain version."""
    rng = np.random.default_rng(40 + radius)
    disp = ((rng.random((3,) + dims) * 2 - 1) * radius * 1.4).astype(np.float32)
    disp.reshape(-1)[::7] = np.round(disp.reshape(-1)[::7])
    g = rng.standard_normal((chan,) + dims).astype(np.float32)
    got = twb.warp_bounded_tblend_zpad_plain(_t(disp)[None], _t(g)[None], radius)[0]
    assert got.shape == (chan, dims[0] + 2 * radius) + dims[1:]
    want = np.asarray(_local_tblend_zpad(jnp.asarray(disp), jnp.asarray(g), radius, "off"))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert torch.equal(twb.warp_bounded_tblend(_t(disp)[None], _t(g)[None], radius, z_pad=True),
                       got[None])
    np.testing.assert_allclose(
        twb.fold_edge(got, radius, axes=(-3,)).numpy(),
        twb.warp_bounded_tblend_plain(_t(disp)[None], _t(g)[None], radius)[0].numpy(), atol=1e-6)


# ---- the chain and pair meshes -------------------------------------------------------

DIMS = (8, 8, 8)


def _bundle():
    dof = 3.0 * float(np.prod(DIMS))
    return ModelBundle(
        dims=DIMS, gmm=GMM(4, 1), scale_prior=LogScaleNormalPrior(0.0, 2.3),
        proportion_prior=DirichletPrior(4, 0.5),
        reg_loss=RegLossLogNormal(w_reg=1.4, dims=DIMS, learnable=True),
        reg_loc_prior=LogEnergyExpGammaPrior(w_reg=1.4, dof=dof),
        reg_scale_prior=LogScaleNormalPrior(loc=2.8, scale=5.0),
        transformation=SVF3D(DIMS, no_steps=4, max_disp=4), sobolev_s=1,
        uniform_noise_alpha=0.1, noise_scheme="post", virtual_decimation=True)


def _images(offset=(0.0, 0.0, 1.0), seed=0):
    f, m = sphere_pair(DIMS, offset=offset, seed=seed)
    return ({k: torch.as_tensor(v) for k, v in f.items()},
            {k: torch.as_tensor(v) for k, v in m.items()})


def _chains(bundle, opt_gmm, opt_reg, n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return init_chains(bundle, gen, n, "noise", None, bundle.gmm.init_params(CPU),
                       bundle.reg_loss.init_params(CPU), opt_gmm, opt_reg, device=CPU)


def _close(a, b, what=""):
    """Equal integers, floats within rtol 1e-5 plus atol 1e-7."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    if np.issubdtype(a.dtype, np.floating):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, tuple):
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    elif isinstance(a, torch.Tensor):
        _close(a.numpy(), b.numpy())
    else:
        assert a == b


def test_chain_sharded_chunk_matches_unsharded():
    """4 chains over a 2-shard chain mesh: every chain keeps its stream
    (key words and step), so the state, the metrics and the pooled
    posterior equal the unsharded chunk's."""
    bundle = _bundle()
    fixed, moving = _images()
    opt_gmm, opt_reg = adam_decay(0.2, 1e-3), adam_decay({"loc": 0.01, "log_scale": 0.01}, 1e-3)
    state = _chains(bundle, opt_gmm, opt_reg, 4)
    plain, m_plain = make_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-4, fixed, moving, chunk=3,
                                     burn_in=1, thin=1)(state)
    mesh = make_mesh(2, devices=[CPU, CPU])
    sharded = shard_chain_state(state, mesh, no_chains=4)
    assert [s.v.shape[0] for s in sharded] == [2, 2] and sharded[1].key.shape == (2, 2)
    out, m_shard = make_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-4, fixed, moving, chunk=3,
                                   burn_in=1, thin=1, chain_mesh=mesh)(sharded)
    assert isinstance(out, Sharded) and all(s.step == 3 for s in out)
    _assert_trees_equal(gather(out), plain)
    _assert_trees_equal(m_shard, m_plain)
    for a, b in zip(posterior_statistics(out), posterior_statistics(plain)):
        _close(a.numpy(), b.numpy())


def _pair_states(bundle, opt_q_v, opt_gmm, opt_reg, n_pairs):
    images, states = [], []
    for i in range(n_pairs):
        fixed, moving = _images((0.0, float(i % 2), 1.0), seed=i)
        mu = torch.zeros((3,) + DIMS)
        q_v = {"mu": mu, "log_var": torch.full_like(mu, -4.0), "u": torch.full_like(mu, 1e-3)}
        gmm, reg = bundle.gmm.init_params(CPU), bundle.reg_loss.init_params(CPU)
        st = VIState(q_v=q_v, gmm=gmm, reg=reg, opt_q_v=opt_q_v.init(q_v),
                     opt_gmm=opt_gmm.init(gmm), opt_reg=opt_reg.init(reg),
                     key=torch.tensor([0, 11 + i], dtype=torch.int64), step=0)
        states.append(gmm_warmup(bundle, opt_gmm, st, fixed, moving))
        images.append((fixed, moving))
    fixed_st = stack_trees([f for f, _ in images])
    moving_st = stack_trees([m for _, m in images])
    return stack_trees(states), fixed_st, moving_st


def test_pair_chunks_over_a_pair_mesh_match_one_device():
    """4 pairs over a 2-shard pair mesh (2 pairs per device, in batches of
    1 on each): the pair-stacked VI and MCMC chunks equal their one-device
    runs, and the state comes back pair-sharded."""
    bundle = _bundle()
    opt_q_v = adam_decay({"mu": 1e-2, "log_var": 1e-2, "u": 1e-2}, 1e-3)
    opt_gmm, opt_reg = adam_decay(0.2, 1e-3), adam_decay({"loc": 0.01, "log_scale": 0.01}, 1e-3)
    state, fixed_st, moving_st = _pair_states(bundle, opt_q_v, opt_gmm, opt_reg, 4)
    mesh = make_pair_mesh(4, devices=[CPU, CPU])
    assert mesh.shape == {"pair": 2}

    one, m_one = make_pair_vi_chunk(bundle, opt_q_v, opt_gmm, opt_reg, fixed_st, moving_st,
                                    chunk=2)(state)
    two, m_two = make_pair_vi_chunk(bundle, opt_q_v, opt_gmm, opt_reg, fixed_st, moving_st,
                                    chunk=2, group=1, mesh=mesh)(shard_pairs(state, mesh))
    assert isinstance(two, Sharded) and [int(s.step.shape[0]) for s in two] == [2, 2]
    _assert_trees_equal(gather(two), one)
    _assert_trees_equal(m_two, m_one)

    chains = stack_trees([_chains(bundle, opt_gmm, opt_reg, 2, seed=i) for i in range(4)])
    one, m_one = make_pair_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-4, fixed_st, moving_st,
                                      chunk=2, burn_in=0, thin=1)(chains)
    two, m_two = make_pair_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-4,
                                      shard_pairs(fixed_st, mesh), shard_pairs(moving_st, mesh),
                                      chunk=2, burn_in=0, thin=1, mesh=mesh)(
        shard_pairs(chains, mesh))
    _assert_trees_equal(gather(two), one)
    _assert_trees_equal(m_two, m_one)


# ---- the trainer ------------------------------------------------------------------

def _cfg(where, **trainer):
    """tests/test_parallel.py's demo settings at 12³."""
    c = json.loads(DEMO.read_text())
    c["data_loader"]["args"]["dims"] = [12, 12, 12]
    c["transformation_module"]["args"] = {"no_steps": 4, "max_disp": 4}
    c["trainer"].update(
        save_dir=str(where), VI=True, no_iters_VI=6, log_period_VI=3,
        no_samples_VI_test=2, MCMC=True, MCMC_init="VI", no_chains=2,
        no_iters_burn_in=2, no_samples_MCMC=4, log_period_MCMC=3,
        speed_test_iters=2, tensorboard=False, seed=7)
    c["trainer"].update(trainer)
    return Config(c, run_id="t")


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "__meta__"}


def test_trainer_distributes_over_two_devices(tmp_path):
    """``devices=[cpu, cpu]`` with ``distribute: true``: the chains over a
    ('chain',) mesh and the VI-test draws over a ('draw',) mesh.  VI runs
    on the first device and equals the one-device run's checkpoint; the
    chains follow their own streams, so the MCMC checkpoint (gathered to
    the one-device format) and the MCMC Dice equal the one-device run's
    (to the stated tolerances).
    The two-device checkpoint resumes in a one-device trainer, and the
    one-device one in a two-device trainer (re-sharded), to equal
    checkpoints; ``distribute: false`` uses no mesh, and with ``distribute``
    unset the chains stay on the first device."""
    one = Trainer(_cfg(tmp_path / "one"), devices=[CPU])
    s_one = one.run()[0]
    two = Trainer(_cfg(tmp_path / "two", distribute=True), devices=[CPU, CPU])
    s_two = two.run()[0]
    assert two._mcmc_mesh.shape == {"chain": 2} and two._draw_mesh.shape == {"draw": 2}
    assert one._mcmc_mesh is None and one._draw_mesh is None
    run = {k: Path(tmp_path / k / "demo_synthetic/t/models") for k in ("one", "two")}
    for name in ("vi_latest.npz", "mcmc_latest.npz"):
        a, b = _npz(run["one"] / name), _npz(run["two"] / name)
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], f"{name} {k}")
    assert abs(s_two["mcmc_mean_dsc"] - s_one["mcmc_mean_dsc"]) < 1e-6
    assert s_two["dsc_before"] == s_one["dsc_before"]
    assert np.isfinite(s_two["vi_test_mean_dsc"])

    resumed = {}
    for name, devices, ck in (("r1", [CPU], "two"), ("r2", [CPU, CPU], "one")):
        t = Trainer(_cfg(tmp_path / name, VI=False, no_samples_MCMC=7, distribute=True),
                    devices=devices, resume=str(run[ck] / "mcmc_latest.npz"))
        resumed[name] = t.run()[0]
        assert (t._mcmc_mesh is None) == (len(devices) == 1)
    assert abs(resumed["r1"]["mcmc_mean_dsc"] - resumed["r2"]["mcmc_mean_dsc"]) < 1e-6
    a, b = (_npz(tmp_path / k / "demo_synthetic/t/models/mcmc_latest.npz") for k in ("r1", "r2"))
    for k in a:
        _close(a[k], b[k], k)
    off = Trainer(_cfg(tmp_path / "off", distribute=False, MCMC=False), devices=[CPU, CPU])
    off.run()
    assert off._mcmc_mesh is None and off._draw_mesh is None
    unset = Trainer(_cfg(tmp_path / "unset", VI=False, no_samples_MCMC=2), devices=[CPU, CPU])
    unset.run()
    assert unset._mcmc_mesh is None and unset.distribute and not unset.distribute_chains


def test_trainer_pairs_over_a_pair_mesh(tmp_path):
    """``pair_parallel`` with 2 pairs over ``[cpu, cpu]``: a ('pair',) mesh
    of 2, each pair's Dice before registration and after MCMC and the
    pair-stacked checkpoint (gathered in the one-device format) equal to
    the one-device run's (not the VI-test Dice: device 1 draws its own
    stream)."""
    def run(where, devices):
        c = _cfg(where, pair_parallel=True)
        c["data_loader"]["args"]["no_pairs"] = 2
        t = Trainer(c, devices=devices)
        return t, t.run()

    t1, s_one = run(tmp_path / "p1", [CPU])
    t2, s_two = run(tmp_path / "p2", [CPU, CPU])
    assert t1._pair_mesh is None and t2._pair_mesh.shape == {"pair": 2}
    for a, b in zip(s_one, s_two):
        for k in ("dsc_before", "mcmc_mean_dsc"):
            assert abs(a[k] - b[k]) < 1e-6, k
    ck = {k: _npz(tmp_path / k / "demo_synthetic/t/models/mcmc_latest.npz") for k in ("p1", "p2")}
    for k in ck["p1"]:
        _close(ck["p1"][k], ck["p2"][k], k)


def test_trainer_refuses_the_spatially_sharded_steps(tmp_path):
    """An explicit ``spatial_shards`` or ``vi_spatial_shards`` above 1 that
    cuts a step along D over several devices engages the sharded step (its
    mesh), and so it does under ``noise_scheme: "pre"``, which it once
    refused (tests/test_torch_spatial.py runs each option through the
    trainer); on one device it changes nothing."""
    t = Trainer(_cfg(tmp_path / "a", spatial_shards=2, VI=False, no_samples_MCMC=2),
                devices=[CPU, CPU])
    t.run()
    assert t._mcmc_mesh.shape == {"chain": 1, "space": 2}
    t = Trainer(_cfg(tmp_path / "b", vi_spatial_shards=2, MCMC=False, no_samples_VI_test=0),
                devices=[CPU, CPU])
    t.run()
    assert t._vi_mesh.shape == {"space": 2}
    pre = _cfg(tmp_path / "c", spatial_shards=2, vi_spatial_shards=2, no_samples_MCMC=2)
    pre.cfg["trainer"]["uniform_noise"]["scheme"] = "pre"
    pre.cfg["trainer"]["uniform_noise"]["enabled"] = True
    t = Trainer(pre, devices=[CPU, CPU])
    t.run()
    assert t._mcmc_mesh.shape == {"chain": 1, "space": 2}
    assert t._vi_mesh.shape == {"space": 2}
    one = Trainer(_cfg(tmp_path / "d", spatial_shards=2, vi_spatial_shards=2), devices=[CPU])
    assert one._mcmc_spatial_shards() == one._vi_spatial_shards() == 1
