"""PyTorch port vs the JAX package: SVF integration, GMM and virtual
decimation, regularisation loss and hyperpriors, Adam-decay, data.

Same numpy inputs in float32 on the CPU through both packages; each
tolerance is stated where it is not a plain elementwise 1e-5.
"""

import math

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

import jax
import jax.numpy as jnp

from ir_sgmcmc_tpu.data import sphere_pair as j_sphere_pair
from ir_sgmcmc_tpu.models import distributions as jdist
from ir_sgmcmc_tpu.models.gmm import GMM as JGMM
from ir_sgmcmc_tpu.models import reg_loss as jreg
from ir_sgmcmc_tpu.models.transformation import SVF3D as JSVF3D
from ir_sgmcmc_tpu.optim import adam_decay as j_adam
from ir_sgmcmc_tpu.optim import reinit_moments as j_reinit
from ir_sgmcmc_tpu_torch.data import sphere_pair as t_sphere_pair
from ir_sgmcmc_tpu_torch.engine import ModelBundle
from ir_sgmcmc_tpu_torch.engine.vi import forward_sample, make_vi_step
from ir_sgmcmc_tpu_torch.models import distributions as tdist
from ir_sgmcmc_tpu_torch.models.gmm import GMM as TGMM
from ir_sgmcmc_tpu_torch.models import reg_loss as treg
from ir_sgmcmc_tpu_torch.models.transformation import SVF3D as TSVF3D
from ir_sgmcmc_tpu_torch.models.transformation import make_transformation
from ir_sgmcmc_tpu_torch.optim import adam_decay as t_adam
from ir_sgmcmc_tpu_torch.optim import apply_updates, reinit_moments as t_reinit


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float32))


def _close(port, ref, atol, rtol=0.0):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_allclose(port, np.asarray(ref), atol=atol, rtol=rtol)


# ---- SVF3D --------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"no_steps": 12}, {"no_steps": 12, "max_disp": 4},
    {"no_steps": 10, "max_disp": 16}, {"no_steps": 12, "max_disp": 1},
])
def test_svf_plan_matches_jax(kw):
    j, t = JSVF3D((32, 32, 32), **kw), TSVF3D((32, 32, 32), **kw)
    for name in ("no_squarings", "no_taylor", "no_compositions", "composition_form",
                 "displacement_clamp_bound", "image_clamp_bound",
                 "no_image_compositions"):
        assert getattr(t, name) == getattr(j, name), name


def test_svf_forms_and_the_anchored_warp_build():
    """Every composition form builds: "warp" and squarings above
    ``taylor_threshold`` (kernels B5-B7), "taylor" (plain stencils), and so
    do ``use_gather``, SVFFD, the B-spline FFD, SVF_2D, the VI step's
    ``remat`` and the anchored residual warp of the forward chain (held to
    the JAX package in tests/test_torch_taylor.py and
    tests/test_torch_anchor.py)."""
    dims = (8, 8, 8)
    assert TSVF3D(dims, taylor_compositions="warp").composition_form == "warp"
    low = TSVF3D(dims, taylor_threshold=0.1)
    assert low.no_squarings > low.no_taylor  # warp squarings
    assert TSVF3D(dims, taylor_compositions="taylor").composition_form == "taylor"
    assert TSVF3D(dims, use_gather=True).use_gather
    assert isinstance(make_transformation("SVF_3D", dims), TSVF3D)
    for kind in ("SVFFD_3D", "Cubic_B_spline_FFD_3D"):
        assert make_transformation(kind, dims, cps=(2, 2, 2)).control_dims == (7, 7, 7)
        with pytest.raises(ValueError, match="cps"):
            make_transformation(kind, dims)
    assert make_transformation("SVF_2D", dims[:2]).dims == dims[:2]
    bundle = ModelBundle(dims=dims, gmm=TGMM(4, 1), scale_prior=tdist.LogScaleNormalPrior(0.0, 2.3),
                         proportion_prior=tdist.DirichletPrior(4, 0.5),
                         reg_loss=treg.RegLossLogNormal(dims=dims), transformation=TSVF3D(dims))
    assert callable(make_vi_step(bundle, None, None, None, {"mask": None}, {}, remat=True))
    zeros = torch.zeros((1, 3) + dims)
    anchor = {"W0": torch.zeros((1,) + dims), "d0": zeros,
              "Jinv": torch.eye(3).reshape(1, 3, 3, 1, 1, 1).expand(1, 3, 3, *dims)}
    im = {"im": torch.zeros(dims), "mask": torch.ones(dims, dtype=torch.bool)}
    out = forward_sample(bundle, im, im, zeros, zeros, anchor=anchor)
    assert out["warped"].shape == (1,) + dims and int(out["sat_resid"][0]) == 0


def _velocity(rng, dims, peak, batch=2, passes=6):
    """A smooth random velocity with the given peak (voxels)."""
    v = _rand(rng, (batch, 3) + dims)
    for _ in range(passes):
        for ax in (2, 3, 4):
            v = (np.roll(v, 1, ax) + v + np.roll(v, -1, ax)) / 3.0
    return (v * (peak / np.abs(v).max())).astype(np.float32)


def test_svf_integrate_matches_jax_32():
    """9 Taylor squarings + 7 split compositions over 2 chains at 32³, with
    displacements of several voxels (some compositions clamp at |u| = 1).

    Tolerance: the displacement reaches ~8 voxels after 16 compounding f32
    steps; 1e-4 absolute is ~100 ulps of 8 — accumulated rounding, not an
    algorithmic difference (which would show at the 1e-2 level)."""
    dims = (32, 32, 32)
    rng = np.random.default_rng(0)
    v = _velocity(rng, dims, 12.0)
    g = _rand(rng, v.shape)
    j, t = JSVF3D(dims), TSVF3D(dims)

    def jfun(vv):
        tr, disp, _ = j.integrate(vv)
        return tr, disp

    (tr_j, disp_j), vjp = jax.vjp(jax.vmap(jfun), jnp.asarray(v))
    x = _t(v).requires_grad_(True)
    tr_t, disp_t, _ = t.integrate(x)
    assert float(np.abs(np.asarray(disp_j)).max()) > 1.0
    _close(disp_t, disp_j, 1e-4)
    _close(tr_t, tr_j, 1e-5)
    (gx,) = torch.autograd.grad(disp_t, x, _t(g))
    gj = vjp((jnp.zeros_like(tr_j), jnp.asarray(g)))[0]
    _close(gx, gj, 1e-4, 1e-4)


_INTEGRATE_CASES = {
    "split_image": ({}, True),
    "warp_image": ({"taylor_compositions": "warp"}, True),
    "warp": ({"taylor_compositions": "warp"}, False),
    "warp_squarings_image": ({"taylor_threshold": 0.1}, True),
}


@pytest.mark.parametrize("case", sorted(_INTEGRATE_CASES))
def test_svf_integrate_forms_match_jax_32(case):
    """``integrate(v, im)`` through the bounded blend warp: the split form's
    image cascade (8 radius-1 image warps beside 7 split steps), the "warp"
    form with and without the fused ``[d | g]`` carry, and 3 warp squarings
    above ``taylor_threshold`` 0.1.  32³ over 2 samples, velocity peak 12
    (some compositions clamp).  Tolerances of
    ``test_svf_integrate_matches_jax_32``; the image (values in [0, 1])
    and its cotangent path are held to the same."""
    kw, with_image = _INTEGRATE_CASES[case]
    dims = (32, 32, 32)
    rng = np.random.default_rng(1)
    v = _velocity(rng, dims, 12.0)
    g_d = _rand(rng, v.shape)
    g_im = _rand(rng, (2,) + dims)
    im = j_sphere_pair(dims, offset=(0.0, 0.0, 4.0))[1]["im"] if with_image else None
    j, t = JSVF3D(dims, **kw), TSVF3D(dims, **kw)
    assert t.no_squarings - t.no_taylor == (3 if "squarings" in case else 0)

    @jax.jit
    def jax_side(vv, gd, gi):
        def f(x):
            _, disp, warped = j.integrate(x, None if im is None else jnp.asarray(im))
            return disp, warped

        (disp, warped), vjp = jax.vjp(jax.vmap(f), vv)
        return disp, warped, vjp((gd, gi if im is not None else None))[0]

    disp_j, warped_j, grad_j = jax_side(v, g_d, g_im)
    x = _t(v).requires_grad_(True)
    _, disp_t, warped_t = t.integrate(x, None if im is None else _t(im))
    assert float(np.abs(np.asarray(disp_j)).max()) > 1.0
    _close(disp_t, disp_j, 1e-4)
    outs, cots = [disp_t], [_t(g_d)]
    if im is not None:
        assert warped_t.shape == (2,) + dims
        _close(warped_t, warped_j, 1e-4)
        outs.append(warped_t)
        cots.append(_t(g_im))
    else:
        assert warped_t is None
    (gx,) = torch.autograd.grad(outs, x, cots)
    _close(gx, grad_j, 1e-4, 1e-4)


# ---- GMM and virtual decimation ------------------------------------------------

def _gmm_case(seed, batch=2, dims=(8, 9, 10), K=4):
    rng = np.random.default_rng(seed)
    params = {"logits": _rand(rng, (batch, K), 0.5),
              "log_std": _rand(rng, (batch, K), 0.5)}
    res = _rand(rng, (batch,) + dims, 1.5)
    mask = rng.random(dims) > 0.2
    return params, res, mask


def _tp(params):
    return {k: _t(v) for k, v in params.items()}


def test_gmm_terms_match_jax():
    params, res, mask = _gmm_case(1)
    jg, tg = JGMM(4, 1), TGMM(4, 1)
    mj = jnp.asarray(mask)
    ref_lp = jax.vmap(lambda p, r: jg.log_pdf(p, r))(params, res)
    _close(tg.log_pdf(_tp(params), _t(res)), ref_lp, 1e-5, 1e-6)
    # sums over ~700 voxels: relative f32 summation error
    ref_nll = jax.vmap(lambda p, r: jg.masked_nll(p, r, mj))(params, res)
    _close(tg.masked_nll(_tp(params), _t(res), torch.as_tensor(mask)), ref_nll, 0.0, 1e-5)
    ref_rs = jax.vmap(lambda p, r: jg.rescale_residuals(p, r, mj))(params, res)
    _close(tg.rescale_residuals(_tp(params), _t(res), torch.as_tensor(mask)), ref_rs,
           1e-5, 1e-5)
    ref_vd = jax.vmap(lambda p, r: jg.vd_alpha(p, r, mj))(params, res)
    _close(tg.vd_alpha(_tp(params), _t(res), torch.as_tensor(mask)), ref_vd, 1e-6, 1e-5)
    _close(TGMM.log_proportions(_tp(params)),
           jax.vmap(JGMM.log_proportions)(params), 1e-6)
    p0 = {k: v[0] for k, v in params.items()}
    _close(tg.init_scales_from_residual_std(_tp(p0), 0.7)["log_std"],
           jg.init_scales_from_residual_std(p0, 0.7)["log_std"], 1e-6)


def test_residual_map_and_vd_factor_match_jax():
    rng = np.random.default_rng(2)
    f, m = _rand(rng, (10, 11, 12)), _rand(rng, (2, 10, 11, 12))
    jg, tg = JGMM(4, 1), TGMM(4, 1)
    ref = jax.vmap(lambda mm: jg.residual_map(jnp.asarray(f), mm))(m)
    # LCC divides by a local std (down to ~0.1 here): 1e-4 absolute
    _close(tg.residual_map(_t(f), _t(m)), ref, 1e-4, 1e-5)
    mask = np.ones((10, 11, 12), bool)
    ref_vd = jax.vmap(lambda r: JGMM.vd_factor(r, jnp.asarray(mask)))(np.asarray(ref))
    _close(TGMM.vd_factor(_t(np.asarray(ref)), torch.as_tensor(mask)), ref_vd, 1e-6, 1e-5)


# ---- regularisation and priors ------------------------------------------------

def test_priors_match_jax():
    rng = np.random.default_rng(3)
    x = _rand(rng, (2, 4))
    _close(tdist.DirichletPrior(4, 0.5)(_t(x)), jdist.DirichletPrior(4, 0.5)(x), 1e-5, 1e-6)
    _close(tdist.LogScaleNormalPrior(0.0, 2.3)(_t(x)),
           jdist.LogScaleNormalPrior(0.0, 2.3)(x), 1e-6, 1e-6)
    dof = 3.0 * 16 ** 3
    le = _t([9.1, 9.3])
    # Gamma(dof/2) log-density: terms of ~1e5 cancel in f32, so the
    # comparison is relative to the terms' size (a few f32 ulps of 1e5)
    _close(tdist.LogEnergyExpGammaPrior(1.4, dof)(le),
           jdist.LogEnergyExpGammaPrior(1.4, dof)(np.asarray(le)), 0.05, 1e-6)
    _close(tdist.expgamma_expectation(0.5 * dof, 0.7),
           jdist.expgamma_expectation(0.5 * dof, 0.7), 1e-5, 1e-6)
    _close(tdist.NormalDistribution(0.3, 1.7)(_t(x)), jdist.NormalDistribution(0.3, 1.7)(x),
           1e-6, 1e-6)
    _close(tdist.NormalDistribution()(_t(x)), jdist.NormalDistribution()(x), 1e-6, 1e-6)
    _close(tdist.LogPrecisionExpGammaPrior()(_t(x)), jdist.LogPrecisionExpGammaPrior()(x),
           1e-5, 1e-6)
    _close(tdist.exp_inverse_gamma_log_pdf(_t(x), 2.5, 0.7),
           jdist.exp_inverse_gamma_log_pdf(x, 2.5, 0.7), 1e-5, 1e-6)


_REG_KINDS = {
    "lognormal": ("RegLossLogNormal", {"w_reg": 1.4, "learnable": True}),
    "l2": ("RegLossL2", {"w_reg": 1.4, "learnable": True}),
    "student": ("RegLossStudent", {"lambda0": 0.5}),
    "lognormal_l2": ("RegLossLogNormalL2", {"w_reg": 1.4}),
    "l2_identity": ("RegLossL2", {"w_reg": 1.4, "diff_op": None}),
}


@pytest.mark.parametrize("kind", sorted(_REG_KINDS))
def test_reg_loss_matches_jax(kind):
    dims = (8, 8, 8)
    rng = np.random.default_rng(4)
    v = _rand(rng, (2, 3) + dims)
    name, kw = _REG_KINDS[kind]
    j = getattr(jreg, name)(dims=dims, **kw)
    t = getattr(treg, name)(dims=dims, **kw)
    pj = j.init_params()
    pt = t.init_params("cpu")
    for k in pj:
        _close(pt[k], pj[k], 1e-6, 1e-6)
    loss_j, logy_j = j(pj, v)
    loss_t, logy_t = t(pt, _t(v))
    _close(logy_t, logy_j, 1e-6, 1e-6)
    # loss ~ (dof/2)·log y ~ 1e4: relative
    _close(loss_t, loss_j, 0.0, 2e-6)


# ---- Adam-decay -----------------------------------------------------------------

def test_adam_decay_matches_jax_per_chain_with_reinit():
    rng = np.random.default_rng(5)
    params = {"loc": _rand(rng, (2,)), "log_scale": _rand(rng, (2,))}
    lr = {"loc": 0.01, "log_scale": 0.03}
    oj, ot = j_adam(lr, 1e-3), t_adam(lr, 1e-3)
    sj = jax.vmap(oj.init)(params)
    st = ot.init(_tp(params), (2,))
    pj, pt = dict(params), _tp(params)
    for i in range(6):
        g = {k: _rand(rng, (2,)) for k in params}
        uj, sj = jax.vmap(oj.update)(g, sj, pj)
        pj = {k: pj[k] + uj[k] for k in pj}
        ut, st = ot.update(_tp(g), st)
        pt = apply_updates(pt, ut)
        if i == 2:
            sj, st = jax.vmap(j_reinit)(sj), t_reinit(st)
    for k in params:
        _close(pt[k], pj[k], 1e-6, 1e-6)
        _close(st.mu[k], sj.mu[k], 1e-6, 1e-6)
        _close(st.nu[k], sj.nu[k], 1e-6, 1e-6)
    np.testing.assert_array_equal(st.step.numpy(), np.asarray(sj.step))
    np.testing.assert_array_equal(st.reinit_step.numpy(), np.asarray(sj.reinit_step))


def test_adam_decay_scalar_lr_unbatched():
    rng = np.random.default_rng(6)
    p = {"logits": _rand(rng, (4,))}
    oj, ot = j_adam(0.2, 1e-3), t_adam(0.2, 1e-3)
    sj, st = oj.init(p), ot.init(_tp(p))
    g = {"logits": _rand(rng, (4,))}
    uj, _ = oj.update(g, sj, p)
    ut, _ = ot.update(_tp(g), st)
    _close(ut["logits"], uj["logits"], 1e-7, 1e-6)


# ---- data ---------------------------------------------------------------------

def test_sphere_pair_is_the_jax_packages():
    fj, mj = j_sphere_pair((16, 16, 16), offset=(0.0, 0.0, 4.0))
    ft, mt = t_sphere_pair((16, 16, 16), offset=(0.0, 0.0, 4.0))
    for a, b in ((fj, ft), (mj, mt)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert math.isclose(float(np.asarray(fj["im"]).std()), float(ft["im"].std()))
