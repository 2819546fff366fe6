"""The port's spatially sharded steps (``ir_sgmcmc_tpu_torch/parallel/spatial.py``
and the sharded ops of ``parallel/halo.py``) on the CPU, over meshes that
name the CPU several times (virtual shards).

* Each sharded op on 2 and 4 slabs against the port's unsharded op and the
  JAX package's (unsharded, ``pallas_mode`` off), forward and gradient, at
  tests/test_parallel.py's atol 1e-5: the Taylor squaring (the volume's
  last plane included), the split composition, the block-gather warp
  (called directly at 64³: it engages only at dims >= 64), the box filter,
  the lag-1 sums and ``sum_sharded``.
* The halo exchange's autograd is its transpose (a dot-product test).
* The z-halo modes of B1-B4 (plain versions) on slabs concatenate to the
  default modes on the whole volume.
* The forward chain over 2 slabs (``spatial.forward_slabs``) against
  ``vi.forward_sample`` on the whole field, on each image path; the slab
  container (``halo._Slabs``) refuses the tensor attributes it does not
  apply slab by slab.
* The sharded MCMC chunk on a ``(2, 2)`` ``('chain', 'space')`` mesh and
  the sharded VI chunk on 4 slabs against the JAX package's UNSHARDED
  chunks at tests/test_parallel.py's problems (dims ``(16, 8, 8)``, 3
  steps), with JAX's draws injected: ``v`` / ``mu`` to atol 1e-5, the data
  term / total loss to rtol 1e-4 (``test_parallel.py:164-296``).  JAX's
  own sharded chunks are not compiled here: ``test_parallel.py`` holds them
  equal to the unsharded ones.  The draws are re-derived from the JAX
  keys as ``engine/mcmc.py:263`` (``split(key, 3)``) and
  ``engine/vi.py:351`` (``split(key, 4)``) take them.
* The trainer with ``spatial_shards: 2`` and ``vi_spatial_shards: 2`` over
  ``[cpu, cpu]`` against one device: MCMC Dice within 1e-4
  (``test_parallel.py:455-497``), a checkpoint the one-device trainer
  resumes, and the trainer engaging both meshes under each option
  (tests/test_torch_spatial_options.py holds each option's steps to JAX's).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

from ir_sgmcmc_tpu.models.gmm import GMM as JGMM
from ir_sgmcmc_tpu.ops import resample as jresample
from ir_sgmcmc_tpu.ops import stencil as jstencil
from ir_sgmcmc_tpu_torch.config import Config
from ir_sgmcmc_tpu_torch.kernels import block_warp as bw
from ir_sgmcmc_tpu_torch.kernels import split_warp as sw
from ir_sgmcmc_tpu_torch.models.gmm import GMM
from ir_sgmcmc_tpu_torch.ops import resample as tresample
from ir_sgmcmc_tpu_torch.ops import stencil as tstencil
from ir_sgmcmc_tpu_torch.parallel import (box_filter3d_sharded, gather, lag1_sums_sharded,
                                          make_mesh, split_compose_sharded, sum_sharded,
                                          taylor_squaring_sharded, warp_block_gather_sharded,
                                          block_residual_overflow_sharded)
from ir_sgmcmc_tpu_torch.parallel.halo import _exchange_halo_d
from ir_sgmcmc_tpu_torch import selftest as st
from ir_sgmcmc_tpu_torch.trainer import Trainer

CPU = torch.device("cpu")
DEMO = Path(__file__).parent.parent / "configs/demo/config_synthetic.json"
ATOL = 1e-5  # tests/test_parallel.py's


def _space(n):
    return make_mesh(n, axes=("space",), devices=[CPU] * n)


def _smooth(rng, shape, peak, passes=3):
    x = rng.standard_normal(shape).astype(np.float32)
    for _ in range(passes):
        for ax in (-3, -2, -1):
            x = (np.roll(x, 1, ax) + x + np.roll(x, -1, ax)) / 3.0
    return (x * (peak / np.abs(x).max())).astype(np.float32)


class _PallasOff:
    def __enter__(self):
        jresample.set_pallas_mode(False)

    def __exit__(self, *exc):
        jresample.set_pallas_mode(None)


def _torch_vjp(fn, xs, g):
    """``fn(*xs)`` and the gradient of ``<fn(*xs), g>`` in each of ``xs``."""
    xs = [torch.tensor(x, requires_grad=True) for x in xs]
    out = fn(*xs)
    return out.detach().numpy(), [t.numpy() for t in torch.autograd.grad((out * g).sum(), xs)]


def _jax_vjp(fn, xs, g):
    with _PallasOff():
        out, vjp = jax.vjp(fn, *[jnp.asarray(x) for x in xs])
        return np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(g.numpy()))]


def _check_all(got, port, jax_ref, atol=ATOL):
    """The sharded op's output and gradients against the port's unsharded
    op's and the JAX package's."""
    for a, b, c in zip([got[0]] + got[1], [port[0]] + port[1], [jax_ref[0]] + jax_ref[1]):
        np.testing.assert_allclose(a, b, atol=atol)
        np.testing.assert_allclose(a, c, atol=atol)


# ---- the sharded ops ------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_taylor_squaring_sharded(n):
    """With the global last plane, where the forward difference repeats the
    previous one: each slab but the last closes on its neighbour's first
    plane, and the kept planes are the unsharded step's to the bit (the
    gradient adds the halo plane's share in another order).  The JAX step
    is per field (``vmap`` over the batch)."""
    rng = np.random.default_rng(n)
    d = _smooth(rng, (2, 3, 16, 8, 8), 0.4)
    g = torch.as_tensor(rng.standard_normal(d.shape).astype(np.float32))
    mesh = _space(n)
    got = _torch_vjp(lambda x: gather(taylor_squaring_sharded(x, mesh)), [d], g)
    port = _torch_vjp(tstencil.taylor_squaring_step, [d], g)
    _check_all(got, port, _jax_vjp(jax.vmap(jstencil.taylor_squaring_step), [d], g))
    assert np.array_equal(got[0], port[0])


@pytest.mark.parametrize("n", [2, 4])
def test_split_compose_sharded(n):
    """B1Z/B2Z's plain versions on each slab with a one-plane halo, the
    halo's gradient folded back by the exchange's autograd (JAX: ``vmap``
    over the batch)."""
    gen = torch.Generator().manual_seed(n)
    d, u, g = (t.numpy() for t in st.split_operands(gen, (2, 3, 16, 8, 8)))
    mesh = _space(n)
    g = torch.as_tensor(g)
    got = _torch_vjp(lambda a, b: gather(split_compose_sharded(a, b, mesh)), [d, u], g)
    port = _torch_vjp(tstencil.split_compose_step, [d, u], g)
    _check_all(got, port, _jax_vjp(jax.vmap(jstencil.split_compose_step), [d, u], g))
    assert np.array_equal(got[0], port[0])


@pytest.mark.parametrize("n", [2, 4])
def test_block_warp_sharded(n):
    """The block-gather warp at 64³ (bound 9, R 2, block 8) from each
    slab's window of the volume (B3Z/B4Z's plain versions), and its
    overflow count, against the unsharded warp; block means saturated
    next to the slabs' ends reach into the window's halo."""
    rng = np.random.default_rng(20 + n)
    shape = (2, 1, 64, 64, 64)
    vol = rng.standard_normal(shape).astype(np.float32)
    disp = _smooth(rng, (2, 3) + shape[2:], 9.5, passes=2)
    g = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    mesh = _space(n)
    got = _torch_vjp(lambda d: gather(warp_block_gather_sharded(torch.as_tensor(vol), d, 9, mesh)),
                     [disp], g)
    port = _torch_vjp(lambda d: tresample.warp_block_gather(torch.as_tensor(vol), d, 9),
                      [disp], g)
    ref = _jax_vjp(jax.vmap(lambda v, d: jresample.warp_block_gather(v, d, 9),
                            in_axes=(0, 0)), [vol, disp], g)
    ref = (ref[0], ref[1][1:])  # the volume is a constant: its cotangent is dropped
    _check_all(got, port, ref)
    over = block_residual_overflow_sharded(torch.as_tensor(disp), 9, mesh)
    assert torch.equal(over, tresample.block_residual_overflow(torch.as_tensor(disp), 9))
    np.testing.assert_array_equal(over.numpy(), np.asarray(
        jax.vmap(lambda d: jresample.block_residual_overflow(d, 9))(jnp.asarray(disp))))
    assert int(over.sum()) > 0  # the field overflows somewhere


@pytest.mark.parametrize("n", [2, 4])
def test_box_filter_lag1_and_sum_sharded(n):
    """The LCC box filter (radius 1 and 2), the VD factor's lag-1 sums (the
    VD factor formed from them against the JAX package's) and
    ``sum_sharded``."""
    rng = np.random.default_rng(30 + n)
    x = rng.standard_normal((2, 16, 8, 8)).astype(np.float32)
    mask = rng.random((16, 8, 8)) > 0.3
    mesh = _space(n)
    g = torch.as_tensor(rng.standard_normal(x.shape).astype(np.float32))
    for r in (1, 2):
        got = _torch_vjp(lambda a: gather(box_filter3d_sharded(a, r, mesh)), [x], g)
        port = _torch_vjp(lambda a: tstencil.box_filter3d(a, r), [x], g)
        _check_all(got, port, _jax_vjp(lambda a: jstencil.box_filter3d(a, r), [x], g), atol=1e-4)
        assert np.array_equal(got[0], port[0])
    t = torch.as_tensor(np.where(mask, x, 0.0).astype(np.float32))
    sums = lag1_sums_sharded(t, mesh)
    x64 = np.where(mask, x, 0.0).astype(np.float64)
    for axis, s in zip((-1, -2, -3), sums):
        n1 = x64.shape[axis]
        ref = np.sum(np.take(x64, range(n1 - 1), axis) * np.take(x64, range(1, n1), axis),
                     axis=(-3, -2, -1))
        np.testing.assert_allclose(s.numpy(), ref, rtol=1e-5)
    total = sum_sharded(t, mesh)
    np.testing.assert_allclose(total.numpy(), x64.sum(axis=(-3, -2, -1)), rtol=1e-5)
    n_mask = sum_sharded(torch.as_tensor(mask), mesh)
    vd = GMM.vd_factor_from_sums(n_mask, sum_sharded(t ** 2, mesh), *sums)
    np.testing.assert_allclose(vd.numpy(), GMM.vd_factor(torch.as_tensor(x),
                                                         torch.as_tensor(mask)).numpy(), rtol=1e-5)
    np.testing.assert_allclose(vd.numpy(), np.asarray(JGMM.vd_factor(jnp.asarray(x),
                                                                     jnp.asarray(mask))),
                               rtol=1e-5)


@pytest.mark.parametrize("n,r", [(2, 1), (4, 1), (4, 2)])
def test_halo_exchange_autograd_is_its_transpose(n, r):
    """``<E x, y> = <x, Eᵀ y>`` for the halo exchange ``E`` (neighbours'
    planes, the edge plane repeated at the two ends), with ``Eᵀ`` from
    autograd; and ``Eᵀ`` folds each halo plane onto the plane it copies."""
    rng = np.random.default_rng(40 + n + r)
    xs = [torch.tensor(rng.standard_normal((2, 4, 3, 5)), dtype=torch.float64,
                       requires_grad=True) for _ in range(n)]
    ex = _exchange_halo_d(xs, r)
    ys = [torch.as_tensor(rng.standard_normal(tuple(e.shape)), dtype=torch.float64) for e in ex]
    lhs = sum(float((e.detach() * y).sum()) for e, y in zip(ex, ys))
    et_y = torch.autograd.grad(sum((e * y).sum() for e, y in zip(ex, ys)), xs)
    rhs = sum(float((x * t).sum()) for x, t in zip(xs, et_y))
    assert abs(lhs - rhs) <= 1e-12 * max(1.0, abs(lhs))
    # the transpose by hand: own planes, neighbours' halos, edge folds
    for i, (x, t) in enumerate(zip(xs, et_y)):
        ref = ys[i][:, r:-r].clone()
        if i > 0:
            ref[:, :r] += ys[i - 1][:, -r:]
        else:
            ref[:, :1] += ys[i][:, :r].sum(dim=1, keepdim=True)
        if i < n - 1:
            ref[:, -r:] += ys[i + 1][:, :r]
        else:
            ref[:, -1:] += ys[i][:, -r:].sum(dim=1, keepdim=True)
        torch.testing.assert_close(t, ref, rtol=0, atol=1e-12)


def _replicate_pad_z(t, h):
    return torch.nn.functional.pad(t, (0, 0, 0, 0, h, h), mode="replicate")


@pytest.mark.parametrize("n", [2, 4])
def test_zhalo_plain_versions_concatenate_to_the_default_modes(n):
    """B1Z/B2Z and B3Z/B4Z (plain versions) on the slabs of a volume, each
    given its real neighbour planes (edge planes repeated at the two ends),
    concatenate to B1/B2 and B3/B4 on the whole volume; B2Z's halo rows,
    folded onto their owners, complete B2's gradient.  The same for
    B1Z-bf16/B2Z-bf16 against B1-bf16/B2-bf16's functions."""
    gen = torch.Generator().manual_seed(50 + n)
    d, u, g = st.split_operands(gen, (2, 3, 16, 8, 12))
    dp, up = _replicate_pad_z(d, 1), _replicate_pad_z(u, 1)
    dl = 16 // n
    outs, gd, gu = [], torch.zeros_like(dp), torch.zeros_like(up)
    for z0 in range(0, 16, dl):
        d_h, u_h = dp[:, :, z0:z0 + dl + 2], up[:, :, z0:z0 + dl + 2]
        outs.append(sw.split_compose_zhalo_plain(d_h, u_h))
        a, b = sw.split_compose_zhalo_vjp_plain(d_h, u_h, g[:, :, z0:z0 + dl])
        gd[:, :, z0:z0 + dl + 2] += a
        gu[:, :, z0:z0 + dl + 2] += b

    def fold(t):
        f = t[:, :, 1:-1].clone()
        f[:, :, :1] += t[:, :, :1]
        f[:, :, -1:] += t[:, :, -1:]
        return f

    torch.testing.assert_close(torch.cat(outs, 2), sw.split_compose_plain(d, u), rtol=0, atol=0)
    gd_ref, gu_ref = sw.split_compose_vjp_plain(d, u, g)
    torch.testing.assert_close(fold(gd), gd_ref, rtol=0, atol=2e-5)
    torch.testing.assert_close(fold(gu), gu_ref, rtol=0, atol=2e-5)
    # the bf16 modes (B1Z-bf16/B2Z-bf16's plain versions: f32 arithmetic,
    # each output rounded once): the forward bitwise; B2Z-bf16's own outputs
    # (without the direct term's +g), folded in f32, against B2-bf16's
    # function unrounded, within the 2e-5 above plus the two roundings of a
    # halo plane's shares (2u of the largest element)
    d16, u16, g16 = (t.to(torch.bfloat16) for t in (d, u, g))
    dp16, up16 = (_replicate_pad_z(t.float(), 1).to(torch.bfloat16) for t in (d16, u16))
    outs, gd, gu = [], torch.zeros(dp16.shape), torch.zeros(up16.shape)
    for z0 in range(0, 16, dl):
        d_h, u_h = dp16[:, :, z0:z0 + dl + 2], up16[:, :, z0:z0 + dl + 2]
        outs.append(sw.split_compose_zhalo_plain(d_h, u_h))
        a, b = sw.split_warp_vjp_zhalo_plain(d_h, u_h, g16[:, :, z0:z0 + dl])
        assert outs[-1].dtype == a.dtype == b.dtype == torch.bfloat16
        gd[:, :, z0:z0 + dl + 2] += a.float()
        gu[:, :, z0:z0 + dl + 2] += b.float()
    assert torch.equal(torch.cat(outs, 2).view(torch.int16),
                       sw.split_compose_plain(d16, u16).view(torch.int16))
    for got, ref in zip((fold(gd), fold(gu)),
                        sw.split_warp_vjp_plain(d16.float(), u16.float(), g16.float())):
        atol = 2e-5 + 2 * 2.0 ** -8 * float(ref.abs().max())
        torch.testing.assert_close(got, ref, rtol=0, atol=atol)

    vol, r, m, gv = st.block_operands(gen, (2, 1, 64, 16, 24), 9, 2, saturate=True)
    h = 12
    vp, dl = _replicate_pad_z(vol, h), 64 // n
    fw, dg = [], []
    for z0 in range(0, 64, dl):
        window, sl, ms = vp[:, :, z0:z0 + dl + 2 * h], slice(z0, z0 + dl), m[:, :, z0 // 8:(z0 + dl) // 8]
        fw.append(bw.block_warp_plain(window, r[:, :, sl], ms, 8, h))
        dg.append(bw.block_warp_dgrad_plain(window, r[:, :, sl], ms, gv[:, :, sl], 8, h))
    torch.testing.assert_close(torch.cat(fw, 2), bw.block_warp_plain(vol, r, m), rtol=0, atol=0)
    torch.testing.assert_close(torch.cat(dg, 2), bw.block_warp_dgrad_plain(vol, r, m, gv),
                               rtol=0, atol=0)


# ---- the sharded chunks against the JAX package's unsharded chunks ------------------------

DIMS = (16, 8, 8)  # tests/test_parallel.py's
ALPHA = 0.1


def _bundles():
    """tests/test_parallel.py's problem in both packages."""
    from ir_sgmcmc_tpu.engine.bundle import ModelBundle as JBundle
    from ir_sgmcmc_tpu.models import GMM as JG
    from ir_sgmcmc_tpu.models import SVF3D as JSVF
    from ir_sgmcmc_tpu.models import DirichletPrior as JDir
    from ir_sgmcmc_tpu.models import LogScaleNormalPrior as JLSN
    from ir_sgmcmc_tpu.models.reg_loss import RegLossL2 as JL2
    from ir_sgmcmc_tpu_torch.engine import ModelBundle
    from ir_sgmcmc_tpu_torch.models import SVF3D, DirichletPrior, LogScaleNormalPrior
    from ir_sgmcmc_tpu_torch.models.reg_loss import RegLossL2

    common = dict(dims=DIMS, sobolev_s=1, uniform_noise_alpha=ALPHA, virtual_decimation=True)
    jb = JBundle(gmm=JG(2, 1), scale_prior=JLSN(0.0, 2.3), proportion_prior=JDir(2, 0.5),
                 reg_loss=JL2(w_reg=1.0, dims=DIMS),
                 transformation=JSVF(DIMS, no_steps=4, max_disp=4), **common)
    tb = ModelBundle(gmm=GMM(2, 1), scale_prior=LogScaleNormalPrior(0.0, 2.3),
                     proportion_prior=DirichletPrior(2, 0.5), reg_loss=RegLossL2(w_reg=1.0, dims=DIMS),
                     transformation=SVF3D(DIMS, no_steps=4, max_disp=4), **common)
    return jb, tb


def _images():
    from ir_sgmcmc_tpu.data import sphere_pair

    fixed, moving = sphere_pair(DIMS, offset=(0, 0, 1))
    return (tuple({k: jnp.asarray(v) for k, v in x.items()} for x in (fixed, moving)),
            tuple({k: torch.as_tensor(np.asarray(v)) for k, v in x.items()}
                  for x in (fixed, moving)))


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def test_spatial_mcmc_chunk_matches_jax_unsharded():
    """tests/test_parallel.py:164-222's problem: 2 chains, 3 transitions at
    tau 1e-4, the port's chunk over a ``(2, 2)`` ``('chain', 'space')``
    mesh of CPU shards against the JAX package's unsharded chunk, with
    JAX's Langevin and uniform draws: ``v`` to atol 1e-5, the data term
    to rtol 1e-4."""
    from ir_sgmcmc_tpu.engine import init_chains as j_init
    from ir_sgmcmc_tpu.engine import make_mcmc_chunk as j_chunk
    from ir_sgmcmc_tpu.optim import adam_decay as j_adam
    from ir_sgmcmc_tpu_torch.convert import mcmc_state_from_numpy
    from ir_sgmcmc_tpu_torch.engine import make_mcmc_chunk
    from ir_sgmcmc_tpu_torch.optim import adam_decay
    from ir_sgmcmc_tpu_torch.parallel import shard_images_spatial, shard_state_spatial

    jb, tb = _bundles()
    (jf, jm), (tf, tm) = _images()
    state_j = j_init(jb, jax.random.PRNGKey(0), no_chains=2, mode="noise", q_v=None,
                     gmm=jb.gmm.init_params(), reg=jb.reg_loss.init_params(),
                     opt_gmm=j_adam(0.2), opt_reg=j_adam(0.01))
    tree = _np(state_j)
    noise, keys = [], tree.key
    for _ in range(3):
        eps, unif, nxt = [], [], []
        for c in range(2):
            k, k_noise, k_unif = jax.random.split(jnp.asarray(keys[c]), 3)
            eps.append(np.asarray(jax.random.normal(k_noise, (3,) + DIMS, jnp.float32)))
            unif.append(np.asarray(jax.random.uniform(k_unif, (3,) + DIMS, jnp.float32,
                                                      -ALPHA, ALPHA)))
            nxt.append(np.asarray(k))
        noise.append((torch.as_tensor(np.stack(eps)), torch.as_tensor(np.stack(unif))))
        keys = np.stack(nxt)
    new_j, met_j = j_chunk(jb, j_adam(0.2), j_adam(0.01), tau=1e-4, fixed=jf, moving=jm,
                           chunk=3, burn_in=0, thin=1)(state_j)
    v_j, data_j = np.asarray(new_j.v), np.asarray(met_j["data_term"])

    mesh = make_mesh((2, 2), axes=("chain", "space"), devices=[CPU] * 4)
    state = shard_state_spatial(mcmc_state_from_numpy(tree, device="cpu"), mesh, 2, DIMS[0])
    run = make_mcmc_chunk(tb, adam_decay(0.2), adam_decay(0.01), 1e-4,
                          shard_images_spatial(tf, mesh, DIMS[0]),
                          shard_images_spatial(tm, mesh, DIMS[0]), chunk=3, burn_in=0, thin=1)
    out, met = run(state, noise=noise)
    assert len(out) == 4 and tuple(out[3].v.shape) == (1, 3, 8, 8, 8)
    np.testing.assert_allclose(met["data_term"].numpy(), data_j, rtol=1e-4)
    np.testing.assert_allclose(gather(out).v.numpy(), v_j, atol=1e-5)


def test_spatial_vi_chunk_matches_jax_unsharded():
    """tests/test_parallel.py:225-296's problem: 3 VI steps from ``mu`` 0,
    ``log_var`` -2, ``u`` 0.1, the port's step over 4 CPU shards against
    the JAX package's unsharded chunk, with JAX's q(v) and uniform draws:
    ``mu`` to atol 1e-5, the total loss to rtol 1e-4."""
    from ir_sgmcmc_tpu.engine import VIState as JVIState
    from ir_sgmcmc_tpu.engine import make_vi_chunk as j_vi_chunk
    from ir_sgmcmc_tpu.engine import make_vi_step as j_vi_step
    from ir_sgmcmc_tpu.optim import adam_decay as j_adam
    from ir_sgmcmc_tpu_torch.convert import vi_state_from_numpy
    from ir_sgmcmc_tpu_torch.engine import make_vi_chunk, make_vi_step
    from ir_sgmcmc_tpu_torch.optim import adam_decay
    from ir_sgmcmc_tpu_torch.parallel import shard_images_spatial, shard_tree_spatial

    jb, tb = _bundles()
    (jf, jm), (tf, tm) = _images()
    q_v = {"mu": jnp.zeros((3,) + DIMS, jnp.float32),
           "log_var": jnp.full((3,) + DIMS, -2.0, jnp.float32),
           "u": jnp.full((3,) + DIMS, 0.1, jnp.float32)}
    oq, og, orr = j_adam(1e-2), j_adam(0.2), j_adam(0.01)
    state_j = JVIState(q_v=q_v, gmm=jb.gmm.init_params(), reg=jb.reg_loss.init_params(),
                       opt_q_v=oq.init(q_v), opt_gmm=og.init(jb.gmm.init_params()),
                       opt_reg=orr.init(jb.reg_loss.init_params()), key=jax.random.PRNGKey(5),
                       step=jnp.zeros((), jnp.int32))
    tree = _np(state_j)
    noise, key = [], jnp.asarray(tree.key)
    for _ in range(3):
        key, k1, k2, k3 = jax.random.split(key, 4)
        k_eps, k_x = jax.random.split(k1)
        noise.append(tuple(torch.as_tensor(np.array(a)) for a in (
            jax.random.normal(k_eps, (3,) + DIMS, jnp.float32),
            jax.random.normal(k_x, (), jnp.float32),
            jnp.stack([jax.random.uniform(k, (3,) + DIMS, jnp.float32, -ALPHA, ALPHA)
                       for k in (k2, k3)]))))
    new_j, met_j = j_vi_chunk(j_vi_step(jb, oq, og, orr, jf, jm), chunk=3)(state_j)

    mesh = _space(4)
    state = shard_tree_spatial(vi_state_from_numpy(tree, device="cpu"), mesh, DIMS[0])
    step = make_vi_step(tb, adam_decay(1e-2), adam_decay(0.2), adam_decay(0.01),
                        shard_images_spatial(tf, mesh, DIMS[0]),
                        shard_images_spatial(tm, mesh, DIMS[0]))
    out, met = make_vi_chunk(step, 3)(state, noise=noise)
    assert len(out) == 4 and tuple(out[0].q_v["mu"].shape) == (3, 4, 8, 8)
    np.testing.assert_allclose(met["total_loss"].numpy(), np.asarray(met_j["total_loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(gather(out).q_v["mu"].numpy(), np.asarray(new_j.q_v["mu"]),
                               atol=1e-5)
    assert out[0].step == 3


# ---- one forward chain for both layouts -----------------------------------------------

# (image path, composition form): every image path on "split", the other
# forms on the cascade; "block" is the block-gather warp, which engages at 64³
LAYOUT_CASES = [("block", "split"), ("grid", "split"), ("cascade", "split"),
                ("gather", "split"), ("anchor_taylor", "split"), ("anchor_blend", "split"),
                ("cascade", "taylor"), ("cascade", "warp")]


@pytest.mark.parametrize("path,form", LAYOUT_CASES)
def test_forward_slabs_match_forward_sample(path, form):
    """``spatial.forward_slabs`` over 2 CPU slabs, its slabs concatenated
    along D, against ``vi.forward_sample`` on the whole field, both runs of
    the one forward chain: the fields within 1e-6, the fold and saturation
    counts equal.  The anchored paths take an anchor built by
    ``make_chain_anchor`` on each layout from the same field."""
    from ir_sgmcmc_tpu_torch.engine import ModelBundle
    from ir_sgmcmc_tpu_torch.engine.mcmc import make_chain_anchor
    from ir_sgmcmc_tpu_torch.engine.vi import forward_sample
    from ir_sgmcmc_tpu_torch.models import SVF3D, DirichletPrior, LogScaleNormalPrior
    from ir_sgmcmc_tpu_torch.models.reg_loss import RegLossL2
    from ir_sgmcmc_tpu_torch.parallel import shard_images_spatial
    from ir_sgmcmc_tpu_torch.parallel import spatial
    from ir_sgmcmc_tpu_torch.parallel.halo import _Slabs

    dims = (64, 64, 64) if path == "block" else (16, 8, 8)
    svf = dict(no_steps=4, max_disp=4, taylor_compositions=form, use_gather=path == "gather")
    bundle = ModelBundle(dims=dims, gmm=GMM(2, 1), scale_prior=LogScaleNormalPrior(0.0, 2.3),
                         proportion_prior=DirichletPrior(2, 0.5),
                         reg_loss=RegLossL2(w_reg=1.0, dims=dims),
                         transformation=SVF3D(dims, **svf), sobolev_s=1,
                         uniform_noise_alpha=ALPHA,
                         noise_scheme="pre" if path == "cascade" else "post")
    anchored = path.startswith("anchor")
    assert spatial.image_path(bundle, anchored) == ("anchor" if anchored else path)
    rng = np.random.default_rng(len(path))
    fixed, moving = ({"im": torch.as_tensor(_smooth(rng, dims, 1.0) + 1.0),
                      "mask": torch.ones(dims, dtype=torch.bool)} for _ in range(2))
    v, v0 = (torch.as_tensor(_smooth(rng, (2, 3) + dims, 6.0)) for _ in range(2))
    unif = torch.as_tensor(rng.uniform(-ALPHA, ALPHA, (2, 3) + dims).astype(np.float32))
    mesh = _space(2)
    row = spatial._rows(bundle, mesh, 2)[0]
    images = spatial._Images(bundle, shard_images_spatial(fixed, mesh, dims[0]),
                             shard_images_spatial(moving, mesh, dims[0]), row, moving, anchored)

    def cut(t):
        return [row.cut(t, k) for k in range(row.n)]

    anchor = anchor_slabs = None
    if anchored:
        mode = path.split("_")[1]
        anchor = make_chain_anchor(bundle, moving, mode)(v0)
        anchor_slabs = make_chain_anchor(bundle, images.moving, mode, row)(_Slabs(cut(v0)))
    whole = forward_sample(bundle, fixed, moving, v, unif, anchor=anchor)
    slabs = spatial.forward_slabs(bundle, images, cut(v), cut(unif), anchor_slabs)
    for k in ("v", "transformation", "displacement", "warped", "residuals"):
        torch.testing.assert_close(torch.cat(slabs[k], dim=-3), whole[k], atol=1e-6, rtol=0,
                                   msg=k)
    for k in ("ndv", "sat", "sat_resid"):
        assert torch.equal(slabs[k], whole[k]), k


@pytest.mark.parametrize("name", ["requires_grad", "is_cuda", "T", "sum", "mean", "amax"])
def test_slabs_refuse_tensor_attributes_they_do_not_apply(name):
    """``halo._Slabs`` applies the tensor methods the shared chain calls
    slab by slab and refuses every other attribute: a property read as a
    method would be truthy, and a reduction over D would give per-slab
    partial results where the layout's ``total`` must add them."""
    from ir_sgmcmc_tpu_torch.parallel.halo import _Slabs

    parts = [torch.arange(4.0).reshape(1, 4, 1, 1) + k for k in range(2)]
    x = _Slabs(parts)
    with pytest.raises(AttributeError):
        getattr(x, name)
    y = (x.detach().unsqueeze(0) * 2.0 + 1.0).float()
    assert [tuple(p.shape) for p in y.parts] == [(1, 1, 4, 1, 1)] * 2
    for p, q in zip(y.parts, parts):
        assert torch.equal(p[0], q * 2.0 + 1.0)
    assert torch.equal(torch.cat(torch.sum(x, dim=(-3, -2, -1)).parts),
                       torch.tensor([6.0, 10.0]))


# ---- the trainer -----------------------------------------------------------------------

def _cfg(where, **trainer):
    """tests/test_parallel.py's demo settings at 12³, with VI."""
    c = json.loads(DEMO.read_text())
    c["data_loader"]["args"]["dims"] = [12, 12, 12]
    c["transformation_module"]["args"] = {"no_steps": 4, "max_disp": 4}
    c["trainer"].update(
        save_dir=str(where), VI=True, no_iters_VI=6, log_period_VI=3,
        no_samples_VI_test=2, MCMC=True, MCMC_init="VI", no_chains=2,
        no_iters_burn_in=2, no_samples_MCMC=4, log_period_MCMC=3,
        speed_test_iters=2, tensorboard=False, seed=3)
    c["trainer"].update(trainer)
    return c


def test_trainer_spatial_shards_match_one_device(tmp_path):
    """``spatial_shards: 2`` and ``vi_spatial_shards: 2`` over ``[cpu, cpu]``
    cut both steps along D (a ``(1, 2)`` ``('chain', 'space')`` mesh and a
    ``('space',)`` mesh of 2): the MCMC Dice within 1e-4 of the one-device
    run (tests/test_parallel.py:455-497), the posterior fields written, and
    the MCMC checkpoint (gathered to the one-device format) resumed by a
    one-device trainer."""
    t_sp = Trainer(Config(_cfg(tmp_path / "sp", spatial_shards=2, vi_spatial_shards=2),
                          run_id="t"), devices=[CPU, CPU])
    s_sp = t_sp.run()[0]
    assert t_sp._mcmc_mesh.shape == {"chain": 1, "space": 2}
    assert t_sp._vi_mesh.shape == {"space": 2}
    t_one = Trainer(Config(_cfg(tmp_path / "one"), run_id="t"), devices=[CPU])
    s_one = t_one.run()[0]
    assert t_one._mcmc_mesh is None and t_one._vi_mesh is None
    assert abs(s_sp["mcmc_mean_dsc"] - s_one["mcmc_mean_dsc"]) < 1e-4
    assert abs(s_sp["vi_test_mean_dsc"] - s_one["vi_test_mean_dsc"]) < 1e-4
    assert "mcmc_aborted" not in s_sp
    fields = tmp_path / "sp/demo_synthetic/t/fields"
    assert (fields / "MCMC_displacement_mean.vtk").exists()
    ck = tmp_path / "sp/demo_synthetic/t/models/mcmc_latest.npz"
    resumed = Trainer(Config(_cfg(tmp_path / "r", VI=False, no_samples_MCMC=7), run_id="t"),
                      devices=[CPU], resume=str(ck)).run()[0]
    assert np.isfinite(resumed["mcmc_mean_dsc"])


@pytest.mark.parametrize("option", ["pre", "warp", "use_gather", "bfloat16", "fourier"])
def test_trainer_refuses_the_options_left(tmp_path, option):
    """Under ``spatial_shards`` and ``vi_spatial_shards`` 2 on two devices,
    the trainer takes each option (it refuses none of them): it cuts both
    steps along D (a ``(1, 2)`` ``('chain', 'space')`` mesh and a
    ``('space',)`` mesh of 2) and runs to a finite MCMC Dice; on one device
    the same config builds.  tests/test_torch_spatial_options.py holds each
    option's sharded steps to the JAX package's."""
    c = _cfg(tmp_path / option, spatial_shards=2, vi_spatial_shards=2)
    args = c["transformation_module"]["args"]
    if option == "pre":
        c["trainer"]["uniform_noise"] = {"enabled": True, "magnitude": 0.1, "scheme": "pre"}
    elif option == "warp":
        args["taylor_compositions"] = "warp"
    elif option == "use_gather":
        args["use_gather"] = True
    elif option == "bfloat16":
        args["compute_dtype"] = "bfloat16"
    else:
        c["reg_loss"]["args"]["diff_op"] = "Fourier1stDerivativeOperator"
    t = Trainer(Config(c, run_id="t"), devices=[CPU, CPU])
    s = t.run()[0]
    assert t._mcmc_mesh.shape == {"chain": 1, "space": 2}
    assert t._vi_mesh.shape == {"space": 2}
    assert np.isfinite(s["mcmc_mean_dsc"]) and "mcmc_aborted" not in s
    one = Trainer(Config(c, run_id="t"), devices=[CPU])
    assert one._mcmc_spatial_shards() == one._vi_spatial_shards() == 1
