"""The port's spatially sharded steps (``ir_sgmcmc_tpu_torch/parallel/spatial.py``)
under every option of the dense ``SVF3D``, on the CPU, over meshes that
name the CPU several times (virtual shards).

* For each option (``noise_scheme: "pre"``, no uniform noise,
  ``taylor_compositions: "warp"``, ``use_gather``, ``compute_dtype:
  "bfloat16"``, the ``Fourier1stDerivativeOperator`` energy) the sharded
  MCMC chunk (2 chains, 3 transitions at tau 1e-4) on a ``(1, 2)``
  ``('chain', 'space')`` mesh and the sharded VI step on 2 slabs (4 for
  ``"pre"``) against the JAX package's UNSHARDED chunk and steps, with
  JAX's draws injected, at tests/test_torch_spatial.py's problem (dims
  ``(16, 8, 8)``, ``no_steps`` 4, ``max_disp`` 4).  float32: ``v`` / ``mu``
  to atol 1e-5, the data term / total loss to rtol 1e-4, as that file
  states.  bfloat16, with the bounds of tests/test_torch_bf16.py (``u =
  2^-8``): the loss terms within ``u`` relative, and ``σ²∇U`` (MCMC: one
  transition at tau 1e-2) or the q(v) gradient (VI: Adam's first moment
  after one step) at most 1.1 times as far from JAX's float32 step in RMS
  as JAX's bf16 step is.  The draws are re-derived from the JAX keys as
  ``engine/mcmc.py:263`` (``split(key, 3)``) and ``engine/vi.py:351``
  (``split(key, 4)``) take them.
* The sharded ops the options add: the Fourier energy (the all-to-all of
  the slabs' spectra) and its gradient against ``ops/fourier.py`` on the
  whole field, the all-gather's autograd (each slab gets its share of
  every copy's gradient), the bf16 Taylor squaring and split composition
  on slabs against the unsharded bf16 ops (the Taylor planes to the bit),
  the ``"pre"`` noise warp's slab-size check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

from ir_sgmcmc_tpu_torch.models.reg_loss import RegLoss
from ir_sgmcmc_tpu_torch.ops import stencil as tstencil
from ir_sgmcmc_tpu_torch.parallel import (fourier_energy_sharded, gather, make_mesh,
                                          shard_images_spatial, shard_state_spatial,
                                          shard_tree_spatial, split_compose_sharded,
                                          taylor_squaring_sharded)
from ir_sgmcmc_tpu_torch.parallel import spatial
from ir_sgmcmc_tpu_torch.parallel.halo import allgather_slabs
from ir_sgmcmc_tpu_torch import selftest as st

CPU = torch.device("cpu")
DIMS = (16, 8, 8)  # tests/test_torch_spatial.py's (tests/test_parallel.py's)
ALPHA = 0.1
U = 2.0 ** -8  # bf16 unit roundoff
OPTIONS = ("pre", "no_noise", "warp", "use_gather", "bfloat16", "fourier")


def _space(n):
    return make_mesh(n, axes=("space",), devices=[CPU] * n)


def _shards(option):
    return 4 if option == "pre" else 2


def _rms(x):
    return float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))


def _bundles(option, compute_dtype=None):
    """tests/test_torch_spatial.py's problem in both packages with
    ``option`` set (``compute_dtype`` overrides the option's dtype)."""
    from ir_sgmcmc_tpu.engine.bundle import ModelBundle as JBundle
    from ir_sgmcmc_tpu.models import GMM as JG
    from ir_sgmcmc_tpu.models import SVF3D as JSVF
    from ir_sgmcmc_tpu.models import DirichletPrior as JDir
    from ir_sgmcmc_tpu.models import LogScaleNormalPrior as JLSN
    from ir_sgmcmc_tpu.models.reg_loss import RegLossL2 as JL2
    from ir_sgmcmc_tpu_torch.engine import ModelBundle
    from ir_sgmcmc_tpu_torch.models import GMM, SVF3D, DirichletPrior, LogScaleNormalPrior
    from ir_sgmcmc_tpu_torch.models.reg_loss import RegLossL2

    svf = dict(no_steps=4, max_disp=4)
    common = dict(dims=DIMS, sobolev_s=1, uniform_noise_alpha=ALPHA, virtual_decimation=True)
    diff_op = "GradientOperator"
    if option == "pre":
        common["noise_scheme"] = "pre"
    elif option == "no_noise":
        common["uniform_noise_alpha"] = None
    elif option == "warp":
        svf["taylor_compositions"] = "warp"
    elif option == "use_gather":
        svf["use_gather"] = True
    elif option == "bfloat16":
        svf["compute_dtype"] = "bfloat16"
    elif option == "fourier":
        diff_op = "Fourier1stDerivativeOperator"
    if compute_dtype is not None:
        svf["compute_dtype"] = compute_dtype
    jb = JBundle(gmm=JG(2, 1), scale_prior=JLSN(0.0, 2.3), proportion_prior=JDir(2, 0.5),
                 reg_loss=JL2(w_reg=1.0, dims=DIMS, diff_op=diff_op),
                 transformation=JSVF(DIMS, **svf), **common)
    tb = ModelBundle(gmm=GMM(2, 1), scale_prior=LogScaleNormalPrior(0.0, 2.3),
                     proportion_prior=DirichletPrior(2, 0.5),
                     reg_loss=RegLossL2(w_reg=1.0, dims=DIMS, diff_op=diff_op),
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


# ---- the sharded MCMC chunk ----------------------------------------------------------

def _mcmc_jax(jb, chunk, tau=1e-4):
    """JAX's unsharded chunk from its initial state, its draws re-derived:
    ``(state as numpy, new state, metrics, per-transition (eps, unif))``."""
    from ir_sgmcmc_tpu.engine import init_chains as j_init
    from ir_sgmcmc_tpu.engine import make_mcmc_chunk as j_chunk
    from ir_sgmcmc_tpu.optim import adam_decay as j_adam

    (jf, jm), _ = _images()
    state_j = j_init(jb, jax.random.PRNGKey(0), no_chains=2, mode="noise", q_v=None,
                     gmm=jb.gmm.init_params(), reg=jb.reg_loss.init_params(),
                     opt_gmm=j_adam(0.2), opt_reg=j_adam(0.01))
    tree = _np(state_j)
    noise, keys = [], tree.key
    for _ in range(chunk):
        eps, unif, nxt = [], [], []
        for c in range(2):
            k, k_noise, k_unif = jax.random.split(jnp.asarray(keys[c]), 3)
            eps.append(np.asarray(jax.random.normal(k_noise, (3,) + DIMS, jnp.float32)))
            unif.append(np.asarray(jax.random.uniform(k_unif, (3,) + DIMS, jnp.float32,
                                                      -ALPHA, ALPHA)))
            nxt.append(np.asarray(k))
        no_unif = jb.uniform_noise_alpha is None
        noise.append((torch.as_tensor(np.stack(eps)),
                      None if no_unif else torch.as_tensor(np.stack(unif))))
        keys = np.stack(nxt)
    new_j, met_j = j_chunk(jb, j_adam(0.2), j_adam(0.01), tau=tau, fixed=jf, moving=jm,
                           chunk=chunk, burn_in=0, thin=1)(state_j)
    return tree, _np(new_j), {k: np.asarray(v) for k, v in met_j.items()}, noise


def _mcmc_port(tb, tree, noise, n, chunk, tau=1e-4):
    from ir_sgmcmc_tpu_torch.convert import mcmc_state_from_numpy
    from ir_sgmcmc_tpu_torch.engine import make_mcmc_chunk
    from ir_sgmcmc_tpu_torch.optim import adam_decay

    _, (tf, tm) = _images()
    mesh = make_mesh((1, n), axes=("chain", "space"), devices=[CPU] * n)
    state = shard_state_spatial(mcmc_state_from_numpy(tree, device="cpu"), mesh, 2, DIMS[0])
    run = make_mcmc_chunk(tb, adam_decay(0.2), adam_decay(0.01), tau,
                          shard_images_spatial(tf, mesh, DIMS[0]),
                          shard_images_spatial(tm, mesh, DIMS[0]), chunk=chunk, burn_in=0,
                          thin=1)
    out, met = run(state, noise=noise)
    assert len(out) == n and tuple(out[n - 1].v.shape) == (2, 3, DIMS[0] // n) + DIMS[1:]
    return gather(out), met


@pytest.mark.parametrize("option", OPTIONS)
def test_spatial_mcmc_chunk_option_matches_jax_unsharded(option):
    """2 chains over 2 slabs (4 for ``"pre"``) against JAX's unsharded
    chunk with its draws.  float32: 3 transitions at tau 1e-4, ``v`` to
    atol 1e-5, the data term to rtol 1e-4, the fold and saturation counts
    equal.  bfloat16: one transition at tau 1e-2, as
    tests/test_torch_bf16.py::test_transition_bf16_matches_jax takes it:
    the data and reg terms and ``vd_alpha`` within ``u`` relative, and
    ``σ²∇U = (v_noised - v') / tau`` different from JAX's float32 one but
    at most 1.1 times as far from it in RMS as JAX's bf16 one is (0.58x
    here); the chain state stays float32.  That test's other bound, the
    distance to JAX's bf16 step within JAX's own bf16 drift, does not hold
    at this problem for the unsharded step either (1.10x, the sharded step
    1.09x) and is not taken: see the VI test."""
    n = _shards(option)
    jb, tb = _bundles(option)
    assert spatial.unported(tb) is None
    if option != "bfloat16":
        tree, new_j, met_j, noise = _mcmc_jax(jb, 3)
        whole, met = _mcmc_port(tb, tree, noise, n, 3)
        np.testing.assert_allclose(met["data_term"].numpy(), met_j["data_term"], rtol=1e-4)
        np.testing.assert_allclose(whole.v.numpy(), new_j.v, atol=1e-5)
        for k in ("ndv", "sat"):
            np.testing.assert_array_equal(met[k].numpy(), met_j[k], err_msg=k)
        return
    tau = 1e-2
    tree, new_j, met_j, noise = _mcmc_jax(jb, 1, tau)
    _, new_j32, _, _ = _mcmc_jax(_bundles(option, compute_dtype="float32")[0], 1, tau)
    whole, met = _mcmc_port(tb, tree, noise, n, 1, tau)
    assert whole.v.dtype == torch.float32
    for k in ("data_term", "reg_term", "vd_alpha"):
        np.testing.assert_allclose(met[k].numpy(), met_j[k], rtol=U, err_msg=k)
    # v' = v_noised - tau σ²∇U from the same v_noised (float64: v' - v')
    v_n = tree.v.astype(np.float64)  # v_noised - v: cancels in every difference below
    q_t, q_j, q_j32 = ((v_n - x.astype(np.float64)) / tau
                       for x in (whole.v.numpy(), new_j.v, new_j32.v))
    assert 0.0 < _rms(q_t - q_j32) <= 1.1 * _rms(q_j - q_j32)


# ---- the sharded VI step -------------------------------------------------------------

def _vi_jax(jb, steps):
    """JAX's unsharded VI steps from ``mu`` 0, ``log_var`` -2, ``u`` 0.1 with
    its draws re-derived: ``(state as numpy, new state, metrics, draws)``."""
    from ir_sgmcmc_tpu.engine import VIState as JVIState
    from ir_sgmcmc_tpu.engine import make_vi_chunk as j_vi_chunk
    from ir_sgmcmc_tpu.engine import make_vi_step as j_vi_step
    from ir_sgmcmc_tpu.optim import adam_decay as j_adam

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
    noise, key = [], jnp.asarray(tree.key)
    for _ in range(steps):
        key, k1, k2, k3 = jax.random.split(key, 4)
        k_eps, k_x = jax.random.split(k1)
        unif = None
        if jb.uniform_noise_alpha is not None:
            unif = torch.as_tensor(np.array(jnp.stack([
                jax.random.uniform(k, (3,) + DIMS, jnp.float32, -ALPHA, ALPHA)
                for k in (k2, k3)])))
        noise.append((torch.as_tensor(np.array(jax.random.normal(k_eps, (3,) + DIMS,
                                                                 jnp.float32))),
                      torch.as_tensor(np.array(jax.random.normal(k_x, (), jnp.float32))), unif))
    new_j, met_j = j_vi_chunk(j_vi_step(jb, oq, og, orr, jf, jm), chunk=steps)(state_j)
    return tree, _np(new_j), {k: np.asarray(v) for k, v in met_j.items()}, noise


def _vi_port(tb, tree, noise, n, steps):
    from ir_sgmcmc_tpu_torch.convert import vi_state_from_numpy
    from ir_sgmcmc_tpu_torch.engine import make_vi_chunk, make_vi_step
    from ir_sgmcmc_tpu_torch.optim import adam_decay

    _, (tf, tm) = _images()
    mesh = _space(n)
    state = shard_tree_spatial(vi_state_from_numpy(tree, device="cpu"), mesh, DIMS[0])
    step = make_vi_step(tb, adam_decay(1e-2), adam_decay(0.2), adam_decay(0.01),
                        shard_images_spatial(tf, mesh, DIMS[0]),
                        shard_images_spatial(tm, mesh, DIMS[0]))
    out, met = make_vi_chunk(step, steps)(state, noise=noise)
    assert len(out) == n and out[0].step == steps
    return gather(out), met


@pytest.mark.parametrize("option", OPTIONS)
def test_spatial_vi_step_option_matches_jax_unsharded(option):
    """The antithetic pair over 2 slabs (4 for ``"pre"``) against JAX's
    unsharded steps with its draws.  float32: 3 steps, ``mu`` to atol 1e-5
    and the total loss to rtol 1e-4.  bfloat16: one step (Adam turns a
    gradient's sign at a rounding into a step of ±lr, so ``mu`` is compared
    through its gradient): the loss terms within ``u`` relative, and the
    q(v) gradient (Adam's first moment, ``0.1·g``) different from JAX's
    float32 one but at most 1.1 times as far from it in RMS as JAX's bf16
    one is (the second bound of test_transition_bf16_matches_jax).  The
    port's plain bf16 compositions compute in f32 and round once, where
    XLA's bf16 rounds after every operation, so the port's step lies closer
    to JAX's float32 step than JAX's bf16 does (0.14x here, the sharded and
    the unsharded step alike): the first bound of that test, the distance
    to JAX's bf16 step within JAX's own bf16 drift, sits at its edge here
    for the unsharded step too (1.003x) and is not taken."""
    n = _shards(option)
    jb, tb = _bundles(option)
    if option != "bfloat16":
        tree, new_j, met_j, noise = _vi_jax(jb, 3)
        whole, met = _vi_port(tb, tree, noise, n, 3)
        np.testing.assert_allclose(met["total_loss"].numpy(), met_j["total_loss"], rtol=1e-4)
        np.testing.assert_allclose(whole.q_v["mu"].numpy(), new_j.q_v["mu"], atol=1e-5)
        return
    tree, new_j, met_j, noise = _vi_jax(jb, 1)
    _, new_j32, _, _ = _vi_jax(_bundles(option, compute_dtype="float32")[0], 1)
    whole, met = _vi_port(tb, tree, noise, n, 1)
    assert all(t.dtype == torch.float32 for t in whole.q_v.values())
    for k in ("data_term", "reg_term", "entropy_term", "total_loss"):
        np.testing.assert_allclose(met[k].numpy(), met_j[k], rtol=U, err_msg=k)
    for name in ("mu", "log_var", "u"):
        m_t = whole.opt_q_v.mu[name].numpy()
        m_j, m_j32 = new_j.opt_q_v.mu[name], new_j32.opt_q_v.mu[name]
        assert 0.0 < _rms(m_t - m_j32) <= 1.1 * _rms(m_j - m_j32), name


# ---- the sharded ops the options add -------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_fourier_energy_sharded_matches_the_whole_field(n):
    """``Σ ‖|ω| v̂‖²`` from the slabs' spectra (2D FFTs, an all-to-all along
    H, FFTs along D, Parseval) against ``RegLoss.energy`` with the Fourier
    operator on the whole field (``ops/fourier.py``), and its gradient:
    rtol 1e-5 (the two sum the same spectrum in another order; ``|ω|²``
    against ``|ω|`` squared)."""
    rng = np.random.default_rng(60 + n)
    x = rng.standard_normal((2, 3) + DIMS).astype(np.float32)
    ref_op = RegLoss("Fourier1stDerivativeOperator")
    got = torch.tensor(x, requires_grad=True)
    ref = torch.tensor(x, requires_grad=True)
    e_got = fourier_energy_sharded(got, _space(n))
    e_ref = ref_op.energy(ref)
    torch.testing.assert_close(e_got, e_ref, rtol=1e-5, atol=0)
    w = torch.tensor([0.7, -1.3])
    g_got, = torch.autograd.grad((e_got * w).sum(), got)
    g_ref, = torch.autograd.grad((e_ref * w).sum(), ref)
    torch.testing.assert_close(g_got, g_ref, rtol=1e-5, atol=1e-5 * float(g_ref.abs().max()))


@pytest.mark.parametrize("n", [2, 4])
def test_allgather_slabs_autograd_returns_each_slab_its_share(n):
    """Each shard's copy of the whole field is the slabs concatenated, and
    the gradient of ``Σ_k <copy_k, y_k>`` at slab ``j`` is ``Σ_k`` of the
    planes of ``y_k`` that slab ``j`` fills."""
    rng = np.random.default_rng(70 + n)
    xs = [torch.tensor(rng.standard_normal((2, 4, 3, 5)), dtype=torch.float64,
                       requires_grad=True) for _ in range(n)]
    copies = allgather_slabs(xs)
    whole = torch.cat([x.detach() for x in xs], dim=-3)
    ys = [torch.as_tensor(rng.standard_normal(tuple(whole.shape))) for _ in range(n)]
    for c in copies:
        assert torch.equal(c.detach(), whole)
    grads = torch.autograd.grad(sum((c * y).sum() for c, y in zip(copies, ys)), xs)
    total = sum(ys)
    for j, g in enumerate(grads):
        torch.testing.assert_close(g, total[..., 4 * j:4 * j + 4, :, :], rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [2, 4])
def test_bf16_taylor_and_split_compose_sharded(n):
    """bfloat16 slabs: the Taylor squaring keeps the unsharded bf16 step's
    planes to the bit; the split composition (B1Z/B2Z's plain versions in
    bf16: f32 arithmetic, one rounding) equals the unsharded bf16 step to
    the bit, and its gradients agree within ``2u`` of the gradient's
    largest element: a halo plane's two shares are each rounded to bf16
    before they are added, where one device rounds their sum once."""
    rng = np.random.default_rng(80 + n)
    mesh = _space(n)
    d = torch.as_tensor(rng.standard_normal((2, 3) + DIMS).astype(np.float32) * 0.3)
    d16 = d.to(torch.bfloat16)
    got = gather(taylor_squaring_sharded(d16, mesh))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tstencil.taylor_squaring_step(d16))
    gen = torch.Generator().manual_seed(90 + n)
    a, b, g = st.split_operands(gen, (2, 3) + DIMS, dtype=torch.bfloat16)
    outs = []
    for fn in (lambda x, y: gather(split_compose_sharded(x, y, mesh)),
               tstencil.split_compose_step):
        x, y = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        out = fn(x, y)
        outs.append((out.detach(), *torch.autograd.grad((out.float() * g.float()).sum(),
                                                        (x, y))))
    assert outs[0][0].dtype == torch.bfloat16 and torch.equal(outs[0][0], outs[1][0])
    for s, u in zip(outs[0][1:], outs[1][1:]):
        scale = float(u.float().abs().max())
        torch.testing.assert_close(s.float(), u.float(), rtol=0, atol=2 * U * scale)


def test_pre_noise_warp_needs_2r_planes_per_slab():
    """The ``"pre"`` scheme's noise warp has radius ``max(1, ceil(alpha))``:
    each slab must hold ``2R`` planes, and ``make_vi_step`` says so (alpha 2.5:
    R 3, 6 planes; 16 planes over 4 shards leave 4)."""
    from ir_sgmcmc_tpu_torch.engine import make_vi_step
    from ir_sgmcmc_tpu_torch.optim import adam_decay

    _, tb = _bundles("pre")
    tb.uniform_noise_alpha = 2.5
    _, (tf, tm) = _images()
    mesh = _space(4)
    with pytest.raises(ValueError, match="need 6"):
        make_vi_step(tb, adam_decay(1e-2), adam_decay(0.2), adam_decay(0.01),
                     shard_images_spatial(tf, mesh, DIMS[0]),
                     shard_images_spatial(tm, mesh, DIMS[0]))
    assert spatial.image_path(tb) == "cascade"
    make_vi_step(tb, adam_decay(1e-2), adam_decay(0.2), adam_decay(0.01),
                 *(shard_images_spatial(x, _space(2), DIMS[0]) for x in (tf, tm)))
