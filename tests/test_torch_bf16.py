"""PyTorch port vs the JAX package with ``compute_dtype: "bfloat16"``: the
bf16 modes of the split kernels (B1/B2-bf16), the bf16 integrator, one
bf16 SG-MCMC transition and an SVFFD VI step, on the CPU.

One bf16 rounding of a value ``x`` moves it by at most half a unit in the
last place, and one unit (``ulp(x)``, ``2^-7`` to ``2^-8`` of ``|x|``) is
the spacing of bf16 numbers at ``x``; the unit roundoff is ``u = 2^-8``.
The port's plain bf16 B1/B2 compute in f32 and round each output once, as
the Pallas kernels do, so the two may part by one ulp where the f32 values
straddle a rounding boundary.  Off a TPU the JAX package runs the split
step in XLA in bf16, which rounds after every operation: the integrator
and the transition are held to that path at the JAX suite's bf16 bounds
(tests/test_transformation.py::test_svf_compute_dtype_bf16_matches_f32)
or at bounds stated from ``u`` where each test says so.

At ties (``u = 0`` and ``|u| = 1`` exactly, common after bf16 rounding)
the subgradients of the split step differ by convention: XLA's VJP of
``max``/``min`` takes half of each side, the kernels (the Pallas ones and
the port's) take one side, and the port's plain versions take the
kernels'.  ``test_split_ties_match_pallas`` pins that; the comparisons
with XLA avoid tied offsets.
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
from ir_sgmcmc_tpu.engine import init_chains as j_init_chains
from ir_sgmcmc_tpu.engine import make_mcmc_chunk as j_make_chunk
from ir_sgmcmc_tpu.models import (GMM, SVF3D, DirichletPrior, LogEnergyExpGammaPrior,
                                  LogScaleNormalPrior, langevin_noise)
from ir_sgmcmc_tpu.models.reg_loss import RegLossLogNormal
from ir_sgmcmc_tpu.ops import stencil as jst
from ir_sgmcmc_tpu.ops.pallas_split_warp import split_warp_bwd_pallas, split_warp_pallas
from ir_sgmcmc_tpu.optim import adam_decay
from ir_sgmcmc_tpu_torch import engine as teng
from ir_sgmcmc_tpu_torch import models as tmod
from ir_sgmcmc_tpu_torch.convert import mcmc_state_from_numpy, mcmc_state_to_numpy
from ir_sgmcmc_tpu_torch.engine import mcmc as tmcmc
from ir_sgmcmc_tpu_torch.kernels import split_warp as tsw
from ir_sgmcmc_tpu_torch.models.sampler import langevin_noise as t_langevin
from ir_sgmcmc_tpu_torch.ops import stencil as tst
from ir_sgmcmc_tpu_torch.optim import adam_decay as t_adam

BF16 = torch.bfloat16
U = 2.0 ** -8  # bf16 unit roundoff
ALPHA = 0.1


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _ulp(x):
    """One bf16 unit in the last place at ``|x|`` (f32 array)."""
    a = np.maximum(np.abs(np.asarray(x, np.float32)), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


def _within_ulp(out, ref, mask=None):
    """``|out - ref| <= ulp(max(|out|, |ref|))`` elementwise (on ``mask``)."""
    out = out.float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    if mask is not None:
        out, ref = out[mask], ref[mask]
    diff = np.abs(out - ref)
    bad = diff > _ulp(np.maximum(np.abs(out), np.abs(ref)))
    assert not bad.any(), (int(bad.sum()), float(diff.max()))
    return float(diff.max())


# ---- the bf16 split kernels (B1/B2-bf16) ---------------------------------------------

@pytest.mark.parametrize("scale", [0.9, 1.8])
def test_split_bf16_plain_matches_pallas_interpret(scale):
    """The port's plain bf16 B1/B2 against ``split_warp_pallas`` and
    ``split_warp_bwd_pallas`` on bf16 operands in interpret mode, at the
    JAX suite's shape ``(3, 8, 8, 128)`` (over 2 chains) and operand scales
    (d 2.0, u 0.9, g 1.0; u 1.8 saturates many offsets).  Both compute in
    f32 and round each output once: ``out``, ``ḡ_d`` and ``ū_warp`` within
    one ulp of the larger magnitude (measured: at most 1 ulp, at 2 to 6
    of 49,152 elements), ``ū`` off the tie set ``|u| = 1``.  That is
    within the JAX suite's own bounds (6e-2, 8e-2, 1e-1;
    tests/test_pallas_split_warp.py:102-135), asserted too.  The dispatch
    (``split_compose``, ``split_compose_vjp``) and the autograd Function
    give the same bf16 values, with ``+g`` added in bf16."""
    shape = (2, 3, 8, 8, 128)
    rng = np.random.default_rng(11)
    d, u, g = (_rand(rng, shape, s) for s in (2.0, scale, 1.0))
    jd, ju, jg = (jnp.asarray(x).astype(jnp.bfloat16) for x in (d, u, g))
    td, tu, tg = (torch.as_tensor(x).to(BF16) for x in (d, u, g))

    out_p = jax.vmap(lambda a, b: split_warp_pallas(a, b, add_u=True, interpret=True))(jd, ju)
    gd_p, gu_p = jax.vmap(lambda a, b, c: split_warp_bwd_pallas(a, b, c, interpret=True))(
        jd, ju, jg)
    assert out_p.dtype == gd_p.dtype == gu_p.dtype == jnp.bfloat16
    out_p, gd_p, gu_p = (np.asarray(x, np.float32) for x in (out_p, gd_p, gu_p))

    out = tsw.split_compose_plain(td, tu)
    gd, gu_warp = tsw.split_warp_vjp_plain(td, tu, tg)
    assert out.dtype == gd.dtype == gu_warp.dtype == BF16
    off_ties = np.abs(tu.float().numpy()) != 1.0
    assert (~off_ties).sum() > 0  # bf16 rounding puts offsets on the tie
    errs = (_within_ulp(out, out_p), _within_ulp(gd, gd_p), _within_ulp(gu_warp, gu_p, off_ties))
    assert errs[0] < 6e-2 and errs[1] < 8e-2 and errs[2] < 1e-1, errs

    assert torch.equal(tsw.split_compose(td, tu), out)
    gd_d, gu_d = tsw.split_compose_vjp(td, tu, tg)
    assert gu_d.dtype == BF16 and torch.equal(gd_d, gd) and torch.equal(gu_d, gu_warp + tg)
    dt, ut = td.clone().requires_grad_(True), tu.clone().requires_grad_(True)
    o = tst.split_compose_step(dt, ut)
    assert o.dtype == BF16 and torch.equal(o, out)
    gdt, gut = torch.autograd.grad(o, (dt, ut), tg)
    assert torch.equal(gdt, gd) and torch.equal(gut, gu_d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_ties_match_pallas(dtype):
    """At the ties ``u = 0`` and ``|u| = 1`` (a third of the offsets here)
    the plain VJP takes the kernels' subgradients: the one-sided
    difference ``d(p+1) - d(p)`` at ``u = 0`` and no gradient at
    ``|u| = 1``, equal to the Pallas kernel in interpret mode at the
    tolerances of the untied comparisons (f32: 3e-5 + 1e-4 relative, the
    JAX suite's; bf16: one ulp)."""
    shape = (2, 3, 8, 8, 128)
    rng = np.random.default_rng(12)
    d, u, g = _rand(rng, shape, 2.0), _rand(rng, shape, 0.9), _rand(rng, shape)
    tie = rng.integers(0, 6, shape)
    u = np.where(tie == 0, 0.0, np.where(tie == 1, np.sign(u), u)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jd, ju, jg = (jnp.asarray(x).astype(jdt) for x in (d, u, g))
    gd_p, gu_p = (np.asarray(x, np.float32) for x in jax.vmap(
        lambda a, b, c: split_warp_bwd_pallas(a, b, c, interpret=True))(jd, ju, jg))
    td, tu, tg = (torch.as_tensor(np.array(x, np.float32)).to(getattr(torch, dtype))
                  for x in (jd, ju, jg))
    gd, gu = tsw.split_warp_vjp_plain(td, tu, tg)
    assert int(((tu == 0) | (tu.abs() == 1)).sum()) > gu.numel() // 4
    if dtype == "bfloat16":
        _within_ulp(gd, gd_p)
        _within_ulp(gu, gu_p)
    else:
        np.testing.assert_allclose(gd.numpy(), gd_p, atol=3e-5, rtol=1e-4)
        np.testing.assert_allclose(gu.numpy(), gu_p, atol=3e-5, rtol=1e-4)
        # the f32 autograd path of the plain step takes the same subgradients
        gd_a, gu_a = tsw.split_compose_vjp_plain(td, tu, tg)
        np.testing.assert_allclose(gu_a.numpy(), gu_p + g, atol=3e-5, rtol=1e-4)
        np.testing.assert_allclose(gd_a.numpy(), gd_p, atol=3e-5, rtol=1e-4)


def test_taylor_squaring_bf16_matches_jax():
    """The Taylor squaring step and its Jacobian-free VJP on bf16 operands
    (both packages round after each operation): the forward within one ulp,
    the VJP, a sum of seven rounded terms that partly cancel, within 2u of
    its largest magnitude (measured 0.78u)."""
    rng = np.random.default_rng(4)
    d, g = _rand(rng, (3, 8, 9, 10), 0.3), _rand(rng, (3, 8, 9, 10))
    jd, jg = jnp.asarray(d).astype(jnp.bfloat16), jnp.asarray(g).astype(jnp.bfloat16)
    ref, vjp = jax.vjp(jst.taylor_squaring_step, jd)
    gref = np.asarray(vjp(jg)[0], np.float32)
    x = torch.as_tensor(d).to(BF16).requires_grad_(True)
    out = tst.taylor_squaring_step(x)
    (gx,) = torch.autograd.grad(out, x, torch.as_tensor(g).to(BF16))
    assert out.dtype == gx.dtype == BF16
    _within_ulp(out.detach(), np.asarray(ref, np.float32))
    err = float(np.abs(gx.float().numpy() - gref).max())
    assert err <= 2 * U * np.abs(gref).max(), (err, np.abs(gref).max())


# ---- the bf16 integrator ---------------------------------------------------------------

def _smooth_field(D=16):
    """The smooth field of tests/test_transformation.py::
    test_svf_compute_dtype_bf16_matches_f32."""
    z, y, x = np.meshgrid(*(np.linspace(0, 2 * np.pi, n) for n in (D, D, D)), indexing="ij")
    return np.stack([3.0 * np.sin(z) * np.cos(y), 2.5 * np.sin(x + y),
                     2.0 * np.cos(z) * np.sin(x)]).astype(np.float32)


def _port_disp_grad(t, v):
    x = torch.as_tensor(v)[None].requires_grad_(True)
    _, disp = t(x)
    (g,) = torch.autograd.grad(torch.sin(disp).sum(), x)
    return disp.detach()[0], g[0].numpy()


def _jax_disp_grad(j, v):
    v = jnp.asarray(v)
    return (np.asarray(j(v)[1]),
            np.asarray(jax.grad(lambda a: jnp.sum(jnp.sin(j(a)[1])))(v)))


@pytest.mark.parametrize("form", ["split", "warp"])
@pytest.mark.parametrize("threshold", [0.5, 0.0])
def test_svf_bf16_matches_jax(form, threshold):
    """``SVF3D(..., compute_dtype="bfloat16")`` at 16³, ``max_disp`` 4, on
    the JAX suite's smooth field: 10 bf16 Taylor squarings and, on
    "split", 3 bf16 compositions (B1/B2-bf16's plain versions); at
    ``taylor_threshold`` 0 every squaring is a blend warp, so the only bf16
    step is one rounding of ``v / 2^S`` and the compositions run in f32.
    The JAX suite's bounds: the displacement (f32 on return) within 8e-2
    of JAX's bf16 and of the port's own f32 (measured at most 3.1e-2 and
    3.4e-2), and ``∇_v Σ sin(d)`` within 8e-2 of its maximum of the
    port's f32 (measured 2.3e-2) and of JAX's bf16.  The field is zero on
    whole planes (sin 0), ties where XLA's subgradient of the split step
    differs from the kernels' (module docstring), by 8.2e-2 of the maximum
    in f32 alone: the JAX gradient comparison shifts the field by 1e-3
    voxel off them (measured 1.4e-2)."""
    kw = dict(max_disp=4, taylor_compositions=form, taylor_threshold=threshold)
    v = _smooth_field()
    t16 = tmod.SVF3D((16,) * 3, compute_dtype="bfloat16", **kw)
    j16 = SVF3D((16,) * 3, compute_dtype="bfloat16", **kw)
    assert t16.no_taylor == j16.no_taylor == (10 if threshold else 0)
    d16, g16 = _port_disp_grad(t16, v)
    d32, g32 = _port_disp_grad(tmod.SVF3D((16,) * 3, **kw), v)
    dj16, _ = _jax_disp_grad(j16, v)
    assert d16.dtype == torch.float32
    assert float(np.abs(d16.numpy() - dj16).max()) < 8e-2
    assert float((d16 - d32).abs().max()) < 8e-2
    assert np.abs(g16 - g32).max() < 8e-2 * np.abs(g32).max()

    shifted = v + np.float32(1e-3)
    _, gs16 = _port_disp_grad(t16, shifted)
    _, gjs16 = _jax_disp_grad(j16, shifted)
    assert np.abs(gs16 - gjs16).max() < 8e-2 * np.abs(gjs16).max()


def test_svf_bf16_image_cascade_matches_jax():
    """``integrate(v, im)`` on the split form with bf16 compositions: the
    image rides float32 blend warps by ``ψ`` (JAX ``:330``), so it agrees
    with JAX's to f32 rounding (1e-5) while the displacement is held to
    8e-2; both come back f32."""
    from ir_sgmcmc_tpu_torch.data import sphere_pair as t_sphere_pair

    v = _smooth_field() + np.float32(1e-3)
    im = t_sphere_pair((16,) * 3, offset=(0.0, 0.0, 2.0))[1]["im"]
    kw = dict(max_disp=4, compute_dtype="bfloat16")
    _, dj, wj = SVF3D((16,) * 3, **kw).integrate(jnp.asarray(v), jnp.asarray(im))
    _, dt, wt = tmod.SVF3D((16,) * 3, **kw).integrate(torch.as_tensor(v)[None],
                                                      torch.as_tensor(im))
    assert dt.dtype == wt.dtype == torch.float32
    np.testing.assert_allclose(wt[0].numpy(), np.asarray(wj), atol=1e-5)
    assert float(np.abs(dt[0].numpy() - np.asarray(dj)).max()) < 8e-2


def test_make_transformation_builds_bf16_models():
    """``compute_dtype="bfloat16"`` builds ``SVF3D`` and ``SVFFD3D`` (no
    longer refused); ``None`` and ``"float32"`` stay float32; anything else
    raises for every kind."""
    dims = (8, 8, 8)
    for kind, cps in (("SVF_3D", None), ("SVFFD_3D", (2, 2, 2))):
        m = tmod.make_transformation(kind, dims, cps=cps, compute_dtype="bfloat16")
        svf = getattr(m, "svf", m)
        assert svf.compute_dtype == BF16
        for setting in (None, "float32"):
            m = tmod.make_transformation(kind, dims, cps=cps, compute_dtype=setting)
            assert getattr(m, "svf", m).compute_dtype is None
    for kind in ("SVF_3D", "Cubic_B_spline_FFD_3D"):
        with pytest.raises(ValueError, match="compute_dtype"):
            tmod.make_transformation(kind, dims, cps=(2, 2, 2), compute_dtype="float16")
    # use_gather ignores the setting, as in JAX
    t = tmod.SVF3D(dims, no_steps=4, use_gather=True, compute_dtype="bfloat16")
    assert t(torch.zeros((1, 3) + dims))[1].dtype == torch.float32


# ---- one bf16 transition and an SVFFD VI step ----------------------------------------------

def _bundles(dims, compute_dtype, scheme="post"):
    dof = 3.0 * math.prod(dims)
    common = dict(dims=dims, sobolev_s=3, sobolev_lambda=0.5, uniform_noise_alpha=ALPHA,
                  noise_scheme=scheme, virtual_decimation=True)
    jb = JBundle(gmm=GMM(4, 1), scale_prior=LogScaleNormalPrior(0.0, 2.3),
                 proportion_prior=DirichletPrior(4, 0.5),
                 reg_loss=RegLossLogNormal(w_reg=1.4, dims=dims, learnable=True),
                 reg_loc_prior=LogEnergyExpGammaPrior(w_reg=1.4, dof=dof),
                 reg_scale_prior=LogScaleNormalPrior(loc=2.8, scale=5.0),
                 transformation=SVF3D(dims, no_steps=12, compute_dtype=compute_dtype),
                 **common)
    tb = teng.ModelBundle(
        gmm=tmod.GMM(4, 1), scale_prior=tmod.LogScaleNormalPrior(0.0, 2.3),
        proportion_prior=tmod.DirichletPrior(4, 0.5),
        reg_loss=tmod.RegLossLogNormal(w_reg=1.4, dims=dims, learnable=True),
        reg_loc_prior=tmod.LogEnergyExpGammaPrior(w_reg=1.4, dof=dof),
        reg_scale_prior=tmod.LogScaleNormalPrior(loc=2.8, scale=5.0),
        transformation=tmod.SVF3D(dims, no_steps=12, compute_dtype=compute_dtype), **common)
    fixed, moving = sphere_pair(dims, offset=(0.0, 0.0, 4.0))
    jimg = tuple({k: jnp.asarray(v) for k, v in d.items()} for d in (fixed, moving))
    timg = tuple({k: torch.as_tensor(v) for k, v in d.items()} for d in (fixed, moving))
    return jb, tb, jimg, timg


def _np_tree(state):
    return jax.tree.map(lambda x: np.array(x, copy=True), state)


def _transition(compute_dtype, dims=(32, 32, 32), tau=1e-2):
    """One 2-chain transition in both packages from the same state with
    JAX's draws injected (as tests/test_torch_engine.py does); returns
    ``(v', q_jax, met_jax, new_jax, q_port, met_port, port state as numpy,
    port state)``."""
    jb, tb, (jf, jm), (tf, tm) = _bundles(dims, compute_dtype)
    og, orr = adam_decay(0.2, 1e-3), adam_decay({"loc": 0.01, "log_scale": 0.01}, 1e-3)
    gmm = jb.gmm.init_scales_from_residual_std(jb.gmm.init_params(), 1.0)
    gmm["logits"] = jnp.asarray([0.3, -0.2, 0.1, -0.4], jnp.float32)
    state_j = j_init_chains(jb, jax.random.PRNGKey(0), no_chains=2, mode="noise", q_v=None,
                            gmm=gmm, reg=jb.reg_loss.init_params(), opt_gmm=og, opt_reg=orr)
    tree = _np_tree(state_j)
    eps, noise_j, unif = [], [], []
    for c in range(2):
        _, k_noise, k_unif = jax.random.split(jnp.asarray(tree.key[c]), 3)
        eps.append(np.asarray(jax.random.normal(k_noise, (3,) + dims, jnp.float32)))
        noise_j.append(np.asarray(langevin_noise(k_noise, jnp.asarray(tree.sigma[c]), tau)))
        unif.append(np.asarray(jax.random.uniform(k_unif, (3,) + dims, jnp.float32,
                                                  -ALPHA, ALPHA)))
    new_j, met_j = j_make_chunk(jb, og, orr, tau, jf, jm, chunk=1, burn_in=0, thin=1)(state_j)
    new_j = _np_tree(new_j)
    met_j = {k: np.asarray(v)[0] for k, v in met_j.items()}

    state_t = mcmc_state_from_numpy(tree, device="cpu")
    trans = tmcmc.make_sgld_transition(tb, t_adam(0.2, 1e-3),
                                       t_adam({"loc": 0.01, "log_scale": 0.01}, 1e-3),
                                       tau, tf, tm)
    new_t, met_t = trans(state_t, 1.0, noise=(torch.as_tensor(np.stack(eps)),
                                              torch.as_tensor(np.stack(unif))))
    vp = tree.v + np.stack(noise_j)
    vp_t = (state_t.v + t_langevin(None, state_t.sigma, tau, torch.as_tensor(np.stack(eps))))
    np.testing.assert_allclose(vp_t.numpy(), vp, atol=1e-6)  # same draw, same v'
    return (vp, (vp - new_j.v) / tau, met_j, new_j, (vp - new_t.v.numpy()) / tau, met_t,
            mcmc_state_to_numpy(new_t), new_t)


def _rms(x):
    return float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))


def test_transition_bf16_matches_jax():
    """One 2-chain SG-MCMC transition at 32³ (tau 1e-2, "post") with
    ``compute_dtype`` bf16, against JAX's at bf16 with its draws injected.

    Tolerances from the bf16 unit roundoff ``u = 2^-8``:

    * The displacement is rounded at ``u`` relative through 9 Taylor
      squarings and 7 compositions, at other points in the two packages.
      The loss terms and the energy are sums over the voxels of terms each
      moved by about that much: ``u`` relative (measured 2.9e-3 on the
      data term, 2.7e-3 on ``vd_alpha``).  Fold and saturation counters
      are equal (none here).
    * ``σ²∇U`` is a sum of large cancelling LCC terms: a relative change
      ``u`` of the displacement moves it by ~70u in RMS, as JAX's own bf16
      transition against its f32 one shows on the same draws (RMS 0.28 of
      the gradient's RMS, maximum 1.0 of its maximum).  So the port's bf16
      gradient is held to that scale: its RMS difference from JAX's bf16
      within JAX's own bf16-vs-f32 RMS drift (measured 0.24 against 0.28),
      and the port's bf16 within 1.1 times as far from JAX's f32
      transition as JAX's bf16 is, in RMS (measured 0.24 against 0.28).
    * The GMM's Adam moments are voxel sums of the gradient's terms:
      ``mu`` within u of its maximum (measured 2.6e-3), ``nu`` (``∝ g²``)
      within 2u (5.1e-3).  The reg parameters do not see the displacement:
      1e-5 as at f32.  The Welford mean (the displacement) within the JAX
      suite's 8e-2 for the bf16 displacement (measured 1.2e-2).  The chain
      state and the moments stay float32.
    """
    vp, q_j, met_j, new_j, q_t, met_t, got, new_t = _transition("bfloat16")
    _, q_j32, *_ = _transition(None)
    assert new_t.v.dtype == new_t.sigma.dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in new_t.opt_gmm.mu.values())

    drift = _rms(q_j - q_j32) / _rms(q_j32)
    assert _rms(q_t - q_j) / _rms(q_j) <= drift, (_rms(q_t - q_j) / _rms(q_j), drift)
    assert _rms(q_t - q_j32) <= 1.1 * _rms(q_j - q_j32)

    for k in ("ndv", "sat", "sat_resid"):
        np.testing.assert_array_equal(met_t[k].numpy(), met_j[k], err_msg=k)
    for k in ("data_term", "reg_term", "vd_alpha", "reg_energy"):
        np.testing.assert_allclose(met_t[k].numpy(), met_j[k], rtol=U, err_msg=k)
    for part, tol in (("mu", U), ("nu", 2 * U)):
        for k, v in getattr(new_j.opt_gmm, part).items():
            assert np.abs(got["opt_gmm"][part][k] - v).max() <= tol * np.abs(v).max(), (part, k)
    for k, v in new_j.reg.items():
        np.testing.assert_allclose(got["reg"][k], v, atol=1e-6, rtol=1e-5)
    assert np.abs(got["welford"]["mean"] - new_j.welford.mean).max() < 8e-2


def test_svffd_vi_step_bf16_runs_in_float32_state():
    """One SVFFD VI step at 32³, cps 4 (a 12³ control grid), on "post" with
    ``compute_dtype`` bf16 on the CPU, from the same state and draws as the
    float32 step: float32 outputs and state, the same counters, loss terms
    within u of float32's (measured 1.1e-3), and a q(v) gradient that
    points the same way (cosine above 0.9; measured 0.982 to 0.988)."""
    from ir_sgmcmc_tpu_torch.engine import VIState

    dims = (32, 32, 32)
    rng = np.random.default_rng(5)
    out = {}
    for cd in (None, "bfloat16"):
        dof = 3.0 * math.prod(dims)
        tb = teng.ModelBundle(
            dims=dims, gmm=tmod.GMM(4, 1), scale_prior=tmod.LogScaleNormalPrior(0.0, 2.3),
            proportion_prior=tmod.DirichletPrior(4, 0.5),
            reg_loss=tmod.RegLossLogNormal(w_reg=1.4, dims=dims, learnable=True),
            reg_loc_prior=tmod.LogEnergyExpGammaPrior(w_reg=1.4, dof=dof),
            reg_scale_prior=tmod.LogScaleNormalPrior(loc=2.8, scale=5.0),
            transformation=tmod.SVFFD3D(dims, (4, 4, 4), no_steps=12, compute_dtype=cd),
            sobolev_s=2, sobolev_lambda=0.5, uniform_noise_alpha=ALPHA, noise_scheme="post",
            virtual_decimation=True, block_radius=3)
        cdims = tb.field_dims
        if not out:
            mu = _rand(rng, (3,) + cdims, 1.0)
            draws = (torch.as_tensor(_rand(rng, (3,) + cdims)), torch.tensor(0.3),
                     torch.as_tensor(rng.uniform(-ALPHA, ALPHA, (2, 3) + dims).astype(np.float32)))
        fixed, moving = (
            {k: torch.as_tensor(v) for k, v in d.items()}
            for d in sphere_pair(dims, offset=(0.0, 0.0, 4.0)))
        opts = tuple(t_adam(lr, 1e-3) for lr in ({"mu": 0.01, "log_var": 0.01, "u": 0.01},
                                                  {"log_std": 0.2, "logits": 0.2},
                                                  {"loc": 0.01, "log_scale": 0.01}))
        q_v = tb.init_q_v(0.5, 0.1, "cpu")
        q_v["mu"] = torch.as_tensor(mu)
        gmm = tb.gmm.init_scales_from_residual_std(tb.gmm.init_params("cpu"), 1.0)
        gmm["logits"] = torch.tensor([0.3, -0.2, 0.1, -0.4])
        reg = tb.reg_loss.init_params("cpu")
        state = VIState(q_v=q_v, gmm=gmm, reg=reg, opt_q_v=opts[0].init(q_v),
                        opt_gmm=opts[1].init(gmm), opt_reg=opts[2].init(reg),
                        key=torch.tensor([0, 0]), step=0)
        out[cd] = teng.make_vi_step(tb, *opts, fixed, moving)(state, noise=draws)
    (n32, m32), (n16, m16) = out[None], out["bfloat16"]
    assert all(t.dtype == torch.float32 for t in (*n16.q_v.values(), *n16.opt_q_v.mu.values()))
    for k in ("ndv", "sat", "sat_resid"):
        assert torch.equal(m16[k], m32[k]), k
    for k in ("data_term", "reg_term", "vd_alpha"):
        np.testing.assert_allclose(m16[k].numpy(), m32[k].numpy(), rtol=U, err_msg=k)
    for name, g32 in n32.opt_q_v.mu.items():
        g16 = n16.opt_q_v.mu[name]
        assert torch.isfinite(g16).all(), name
        cos = float((g16 * g32).sum() / (g16.norm() * g32.norm()))
        assert cos > 0.9, (name, cos)


def test_trace_summary_names_the_bf16_kernels(tmp_path, capsys):
    """A profile of a bf16 step groups B1-bf16 and B2-bf16 apart from the
    f32 kernels, and ``--shape B2-bf16=...`` puts B2-bf16's bound beside
    its rows."""
    import json

    from ir_sgmcmc_tpu_torch.scripts import trace_summary

    name = "void (anonymous namespace)::split_{}_kernel<{}>(Geom)"
    events = [{"ph": "X", "cat": "kernel", "name": name.format(k, t), "dur": us}
              for k, t, us in (("fwd", "__nv_bfloat16", 60.0), ("bwd", "__nv_bfloat16", 150.0),
                               ("fwd", "float", 75.0))]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    kinds = trace_summary.group(trace_summary.load_events(path))
    assert {k: r["us"] for k, r in kinds.items()} == {"B1-bf16": 60.0, "B2-bf16": 150.0,
                                                      "B1": 75.0}
    assert kinds["B2-bf16"]["kernels"] == {"split_bwd_kernel<__nv_bfloat16>"}
    trace_summary.main([str(path), "--shape", "B2-bf16=2,3,128,128,128"])
    row = next(ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("void (anonymous namespace)::split_bwd"))
    bound_ms, by = tsw.B2_BF16.bound_ms((2, 3, 128, 128, 128))
    assert f"{100 * 1e3 * bound_ms / 150.0:6.1f}% ({by})" in row
    with pytest.raises(ValueError, match="B1-bf16"):
        trace_summary.parse_shape("B8=2,3,4,4,4")
