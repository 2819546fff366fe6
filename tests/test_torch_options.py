"""PyTorch port vs the JAX package: the opt-in model and engine options on
the CPU.

* the Fourier operators and the ``Fourier1stDerivativeOperator`` reg loss;
* ``SVF3D(use_gather=True)`` (the gather-based reference integration) and
  its forward chain;
* the inverse Jacobian;
* ``MCMC_params: "shared"``: one transition against JAX's
  ``make_sgld_transition_shared``, and the shared / per-chain agreement of
  ``tests/test_engine.py``;
* ``make_vi_step(remat=True)`` against the batched step and against JAX's
  remat step;
* ``SVF2D`` and the debug plots.

Each tolerance is stated where it is not a plain elementwise 1e-5.
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
from ir_sgmcmc_tpu.engine.vi import VIState as JVIState
from ir_sgmcmc_tpu.engine.vi import forward_sample as j_forward_sample
from ir_sgmcmc_tpu.engine.vi import make_vi_step as j_make_vi_step
from ir_sgmcmc_tpu.models import GMM, DirichletPrior, LogScaleNormalPrior, langevin_noise
from ir_sgmcmc_tpu.models.reg_loss import RegLossL2 as JRegL2
from ir_sgmcmc_tpu.models.transformation import SVF2D as JSVF2D
from ir_sgmcmc_tpu.models.transformation import SVF3D as JSVF3D
from ir_sgmcmc_tpu.ops import fourier as jfourier
from ir_sgmcmc_tpu.ops.grids import inv_jacobian as j_inv_jacobian
from ir_sgmcmc_tpu.optim import adam_decay
from ir_sgmcmc_tpu_torch import engine as teng
from ir_sgmcmc_tpu_torch import models as tmod
from ir_sgmcmc_tpu_torch.convert import (mcmc_state_from_numpy, mcmc_state_to_numpy,
                                         vi_state_from_numpy)
from ir_sgmcmc_tpu_torch.models.reg_loss import RegLossL2
from ir_sgmcmc_tpu_torch.models.sampler import langevin_noise as t_langevin
from ir_sgmcmc_tpu_torch.ops import fourier as tfourier
from ir_sgmcmc_tpu_torch.ops.grids import inv_jacobian
from ir_sgmcmc_tpu_torch.optim import adam_decay as t_adam

ALPHA = 0.1
DIMS = (12, 12, 12)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float32))


def _close(port, ref, atol, rtol=0.0, msg=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_allclose(port, np.asarray(ref), atol=atol, rtol=rtol, err_msg=msg)


def _smooth(rng, shape, peak, passes=3):
    x = rng.standard_normal(shape).astype(np.float32)
    for _ in range(passes):
        for ax in (-3, -2, -1):
            x = (np.roll(x, 1, ax) + x + np.roll(x, -1, ax)) / 3.0
    return (x * (peak / np.abs(x).max())).astype(np.float32)


def _np_tree(state):
    return jax.tree.map(lambda x: np.array(x, copy=True), state)


# ---- Fourier operators ------------------------------------------------------------

def test_fourier_ops_match_jax():
    """Twin of ``tests/test_io_and_data.py::test_fourier_ops`` against the
    JAX functions: |ω| and the Gaussian multiplier on a batch of fields
    (FFT round trips of O(1) values: 1e-5), zero on a constant, and the
    identity backward of ``gaussian_grad_smooth``."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 8, 10, 12)).astype(np.float32)
    _close(tfourier.fourier_derivative_magnitude(_t(x)),
           jfourier.fourier_derivative_magnitude(jnp.asarray(x)), 1e-5)
    _close(tfourier.gaussian_smooth_fft(_t(x), 2.0),
           jfourier.gaussian_smooth_fft(jnp.asarray(x), 2.0), 1e-5)
    _close(tfourier.fourier_derivative_magnitude(torch.ones((1, 8, 8, 8))),
           np.zeros((1, 8, 8, 8)), 1e-5)
    xt = _t(x).requires_grad_(True)
    (g,) = torch.autograd.grad(tfourier.gaussian_grad_smooth(xt, 2.0), xt, _t(x))
    _close(g, x, 0.0)


def test_fourier_reg_loss_matches_jax():
    """``RegLoss_L2`` with ``diff_op: "Fourier1stDerivativeOperator"``, per
    chain of 2 and unbatched: loss, ``log y`` and the field gradient.  The
    energy sums 3·8³ squares of FFT outputs: 1e-5 relative; the gradient
    1e-5 absolute plus 1e-4 relative."""
    dims = (8, 8, 8)
    kw = dict(w_reg=0.7, dims=dims, diff_op="Fourier1stDerivativeOperator")
    j, t = JRegL2(**kw), RegLossL2(**kw)
    pj, pt = j.init_params(), t.init_params("cpu")
    v = np.random.default_rng(0).standard_normal((2, 3) + dims).astype(np.float32)
    (loss_j, ly_j), vjp = jax.vjp(jax.vmap(lambda vv: j(pj, vv)), jnp.asarray(v))
    x = _t(v).requires_grad_(True)
    loss_t, ly_t = t(pt, x)
    _close(loss_t, loss_j, 0.0, 1e-5)
    _close(ly_t, ly_j, 1e-6, 1e-5)
    (gx,) = torch.autograd.grad(loss_t.sum(), x)
    _close(gx, vjp((jnp.ones(2), jnp.zeros(2)))[0], 1e-5, 1e-4)
    one, _ = t(pt, _t(v[0]))
    _close(one, j(pj, jnp.asarray(v[0]))[0], 0.0, 1e-5)
    _, ly0 = t(pt, torch.ones((3,) + dims))
    assert float(torch.exp(ly0)) < 1e-4


# ---- use_gather, the inverse Jacobian, SVF2D ------------------------------------------

def test_use_gather_integrate_matches_jax():
    """``SVF3D(use_gather=True)`` at 16³: ``no_steps`` squarings through
    ``grid_sample`` over 2 samples of a 3-voxel-peak velocity, with the
    image warped once at the end.  f32 values of a few voxels after 8
    compounding gathers: 1e-4.  The gradient of a trilinear gather jumps
    where a sample point crosses a cell face, and a point within an ulp of
    a face takes either side's slope in either package (one element of
    24,576 differs by 1e-3 relative): the RMS error within 1e-4 of the RMS
    gradient and no element off by more than 1% of its maximum.  Without
    an image the warped output is None."""
    dims = (16, 16, 16)
    j, t = JSVF3D(dims, no_steps=8, use_gather=True), tmod.SVF3D(dims, no_steps=8,
                                                                  use_gather=True)
    rng = np.random.default_rng(4)
    v = _smooth(rng, (2, 3) + dims, 3.0)
    g = rng.standard_normal((2, 3) + dims).astype(np.float32)
    im = sphere_pair(dims, offset=(0.0, 0.0, 2.0))[1]["im"]

    def f(vv):
        _, disp, warped = j.integrate(vv, jnp.asarray(im))
        return disp, warped

    (disp_j, warped_j), vjp = jax.vjp(jax.vmap(f), jnp.asarray(v))
    x = _t(v).requires_grad_(True)
    tr_t, disp_t, warped_t = t.integrate(x, _t(im))
    _close(disp_t, disp_j, 1e-4)
    _close(warped_t, warped_j, 1e-4)
    (gx,) = torch.autograd.grad(disp_t, x, _t(g))
    g_j = np.asarray(vjp((jnp.asarray(g), jnp.zeros_like(warped_j)))[0])
    dg = gx.numpy() - g_j
    assert np.sqrt(np.mean(dg ** 2)) <= 1e-4 * np.sqrt(np.mean(g_j ** 2))
    assert np.abs(dg).max() <= 1e-2 * np.abs(g_j).max()
    assert t.integrate(_t(v))[2] is None


def test_use_gather_forward_sample_matches_jax():
    """The forward chain on the gather path (``"post"`` noise added on the
    normalised grid, one ``grid_sample``): warp and residuals as JAX's
    (1e-4: LCC divides by local stds), and it never reports saturation,
    even at a displacement far beyond ``max_disp``."""
    from dataclasses import replace

    dims = DIMS
    jb, tb, (jf, jm), (tf, tm) = _bundles(dims, reg="l2")
    jb = replace(jb, transformation=JSVF3D(dims, no_steps=8, max_disp=2, use_gather=True))
    tb = replace(tb, transformation=tmod.SVF3D(dims, no_steps=8, max_disp=2, use_gather=True))
    v = np.full((3,) + dims, 6.0, np.float32)
    key = jax.random.PRNGKey(1)
    unif = np.asarray(jax.random.uniform(key, (3,) + dims, jnp.float32, -ALPHA, ALPHA))
    out_j = j_forward_sample(jb, jf, jm, jnp.asarray(v), key)
    with torch.no_grad():
        out_t = teng.forward_sample(tb, tf, tm, _t(v)[None], _t(unif)[None])
    for k in ("ndv", "sat", "sat_resid"):
        assert int(out_t[k][0]) == int(out_j[k]) == (int(out_j["ndv"]) if k == "ndv" else 0)
    _close(out_t["warped"][0], out_j["warped"], 1e-4)
    _close(out_t["residuals"][0], out_j["residuals"], 1e-4)


def test_inv_jacobian_matches_jax():
    """Adjugate over determinant per voxel, with and without a leading
    batch; near-singular voxels take the ±1e-6 floor as in JAX.  Away from
    the floor ``J · J⁻¹ = I`` to 1e-4; against JAX 1e-5 relative."""
    rng = np.random.default_rng(3)
    jac = (np.eye(3)[:, :, None, None, None]
           + 0.3 * rng.standard_normal((3, 3, 4, 5, 6))).astype(np.float32)
    jac[:, :, 0, 0, 0] = [[1, 2, 3], [2, 4, 6], [0, 1, 1]]  # det 0
    jac[:, :, 0, 0, 1] = [[1, 0, 0], [0, 1, 0], [0, 0, -1e-7]]  # det -1e-7
    got = inv_jacobian(_t(jac))
    ref = np.asarray(j_inv_jacobian(jnp.asarray(jac)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    batched = inv_jacobian(_t(np.stack([jac, jac])))
    assert torch.equal(batched[1], got)
    eye = np.einsum("ab...,bc...->ac...", jac, got.numpy())[:, :, 1:]
    _close(eye, np.broadcast_to(np.eye(3)[:, :, None, None, None], eye.shape), 1e-4)


def test_svf2d_matches_jax():
    """``SVF_2D`` at 24x20: a constant velocity integrates to a translation
    in the interior, and a smooth random one matches JAX's integration and
    gradient (12 compounding bilinear gathers of values up to 3 pixels:
    1e-4; the gradient 1e-4 absolute plus 1e-4 relative)."""
    dims = (24, 20)
    t = tmod.make_transformation("SVF_2D", dims, no_steps=12)
    j = JSVF2D(dims, no_steps=12)
    const = torch.stack([torch.full(dims, 2.0), torch.full(dims, -1.5)])
    _, disp = t(const)
    _close(disp[0, 6:-6, 6:-6], np.full((12, 8), 2.0), 1e-3)
    _close(disp[1, 6:-6, 6:-6], np.full((12, 8), -1.5), 1e-3)
    rng = np.random.default_rng(8)
    v = rng.standard_normal((2, 2) + dims).astype(np.float32)
    for _ in range(4):
        for ax in (-2, -1):
            v = (np.roll(v, 1, ax) + v + np.roll(v, -1, ax)) / 3.0
    v = (v * (3.0 / np.abs(v).max())).astype(np.float32)
    g = rng.standard_normal(v.shape).astype(np.float32)
    (tr_j, disp_j), vjp = jax.vjp(jax.vmap(j), jnp.asarray(v))
    x = _t(v).requires_grad_(True)
    tr_t, disp_t = t(x)
    _close(disp_t, disp_j, 1e-4)
    _close(tr_t, tr_j, 1e-5)
    (gx,) = torch.autograd.grad(disp_t, x, _t(g))
    _close(gx, vjp((jnp.zeros_like(tr_j), jnp.asarray(g)))[0], 1e-4, 1e-4)


def test_plots_draw_figures():
    """Twin of the plots half of ``tests/test_io_and_data.py::
    test_figures_and_plots_smoke``: each debug plot returns a figure."""
    pytest.importorskip("matplotlib")
    from ir_sgmcmc_tpu_torch.utils import plots

    field = np.random.default_rng(0).standard_normal((3, 8, 8, 8)).astype(np.float32)
    assert plots.plot_2d(field[:2, 4]) is not None
    assert plots.plot_3d(field, stride=4) is not None
    assert plots.plot_grid(field * 0.01 + np.linspace(-1, 1, 8)[None, None, None, :]) is not None


# ---- MCMC_params: "shared" ---------------------------------------------------------

def _bundles(dims, reg="lognormal"):
    """A 12-step SVF model with VD on "post" in both packages; ``reg``:
    the learnable log-normal energy prior or a learnable ``RegLoss_L2``."""
    from ir_sgmcmc_tpu.models import LogEnergyExpGammaPrior
    from ir_sgmcmc_tpu.models.reg_loss import RegLossLogNormal

    dof = 3.0 * math.prod(dims)
    common = dict(dims=dims, sobolev_s=3, sobolev_lambda=0.5, uniform_noise_alpha=ALPHA,
                  noise_scheme="post", virtual_decimation=True)
    if reg == "lognormal":
        jr = dict(reg_loss=RegLossLogNormal(w_reg=1.4, dims=dims, learnable=True),
                  reg_loc_prior=LogEnergyExpGammaPrior(w_reg=1.4, dof=dof),
                  reg_scale_prior=LogScaleNormalPrior(loc=2.8, scale=5.0))
        tr = dict(reg_loss=tmod.RegLossLogNormal(w_reg=1.4, dims=dims, learnable=True),
                  reg_loc_prior=tmod.LogEnergyExpGammaPrior(w_reg=1.4, dof=dof),
                  reg_scale_prior=tmod.LogScaleNormalPrior(loc=2.8, scale=5.0))
    else:
        jr = dict(reg_loss=JRegL2(w_reg=0.2, dims=dims, learnable=False))
        tr = dict(reg_loss=RegLossL2(w_reg=0.2, dims=dims, learnable=False))
    jb = JBundle(gmm=GMM(4, 1), scale_prior=LogScaleNormalPrior(0.0, 2.3),
                 proportion_prior=DirichletPrior(4, 0.5),
                 transformation=JSVF3D(dims, no_steps=12), **jr, **common)
    tb = teng.ModelBundle(gmm=tmod.GMM(4, 1), scale_prior=tmod.LogScaleNormalPrior(0.0, 2.3),
                          proportion_prior=tmod.DirichletPrior(4, 0.5),
                          transformation=tmod.SVF3D(dims, no_steps=12), **tr, **common)
    fixed, moving = sphere_pair(dims, offset=(0.0, 0.0, 2.0))
    jimg = tuple({k: jnp.asarray(v) for k, v in d.items()} for d in (fixed, moving))
    timg = tuple({k: torch.as_tensor(v) for k, v in d.items()} for d in (fixed, moving))
    return jb, tb, jimg, timg


REG_LRS = {"loc": 0.01, "log_scale": 0.01}


def test_shared_transition_matches_jax():
    """One 3-chain transition with ONE shared GMM/reg set against JAX's
    ``make_sgld_transition_shared`` at 16³, with JAX's draws injected: the
    GMM takes 3 sequential Adam steps, the reg parameters one step on the
    summed gradient.  Tolerances of ``test_transition_matches_jax`` (tau
    1e-2): ``σ²∇U`` within 1e-3 RMS and 2% elementwise, per-chain loss
    terms 1e-4 relative, counters equal, parameters 1e-5, moments 1e-4."""
    dims, tau, C = (16, 16, 16), 1e-2, 3
    jb, tb, (jf, jm), (tf, tm) = _bundles(dims)
    og, orr = adam_decay(0.2, 1e-3), adam_decay(REG_LRS, 1e-3)
    gmm = jb.gmm.init_scales_from_residual_std(jb.gmm.init_params(), 1.0)
    gmm["logits"] = jnp.asarray([0.3, -0.2, 0.1, -0.4], jnp.float32)
    state_j = j_init_chains(jb, jax.random.PRNGKey(2), no_chains=C, mode="noise", q_v=None,
                            gmm=gmm, reg=jb.reg_loss.init_params(), opt_gmm=og, opt_reg=orr,
                            param_mode="shared")
    tree = _np_tree(state_j)
    assert tree.gmm["logits"].shape == (4,) and np.shape(tree.opt_gmm.step) == ()
    eps, noise_j, unif = [], [], []
    for c in range(C):
        _, k_noise, k_unif = jax.random.split(jnp.asarray(tree.key[c]), 3)
        eps.append(np.asarray(jax.random.normal(k_noise, (3,) + dims, jnp.float32)))
        noise_j.append(np.asarray(langevin_noise(k_noise, jnp.asarray(tree.sigma[c]), tau)))
        unif.append(np.asarray(jax.random.uniform(k_unif, (3,) + dims, jnp.float32,
                                                  -ALPHA, ALPHA)))
    eps, noise_j, unif = np.stack(eps), np.stack(noise_j), np.stack(unif)
    new_j, met_j = j_make_chunk(jb, og, orr, tau, jf, jm, chunk=1, burn_in=0, thin=1,
                                param_mode="shared")(state_j)
    new_j = _np_tree(new_j)
    met_j = {k: np.asarray(v)[0] for k, v in met_j.items()}

    state_t = mcmc_state_from_numpy(tree, device="cpu")
    trans = teng.make_sgld_transition_shared(tb, t_adam(0.2, 1e-3), t_adam(REG_LRS, 1e-3),
                                             tau, tf, tm)
    new_t, met_t = trans(state_t, 1.0, noise=(_t(eps), _t(unif)))
    vp_j = tree.v + noise_j
    vp_t = (state_t.v + t_langevin(None, state_t.sigma, tau, _t(eps))).numpy()
    q_j, q_t = (vp_j - new_j.v) / tau, (vp_t - new_t.v.numpy()) / tau
    floor = 8 * np.finfo(np.float32).eps * np.abs(vp_j).max() / tau
    dq = q_t - q_j
    assert np.sqrt(np.mean(dq ** 2)) <= floor / 8 + 1e-3 * np.sqrt(np.mean(q_j ** 2))
    assert np.abs(dq).max() <= floor + 2e-2 * np.abs(q_j).max()
    for k in ("ndv", "sat", "sat_resid"):
        np.testing.assert_array_equal(met_t[k].numpy(), met_j[k], err_msg=k)
    for k in ("data_term", "reg_term", "vd_alpha", "reg_energy", "gmm_scales",
              "gmm_proportions"):
        assert met_t[k].shape == met_j[k].shape, k
        np.testing.assert_allclose(met_t[k].numpy(), met_j[k], rtol=1e-4, err_msg=k)
    got = mcmc_state_to_numpy(new_t)
    for group in ("gmm", "reg"):
        for k, v in getattr(new_j, group).items():
            np.testing.assert_allclose(got[group][k], v, atol=1e-6, rtol=1e-5)
    for opt in ("opt_gmm", "opt_reg"):
        js = getattr(new_j, opt)
        np.testing.assert_array_equal(got[opt]["step"], js.step)
        for part in ("mu", "nu"):
            for k, v in getattr(js, part).items():
                np.testing.assert_allclose(got[opt][part][k], v, atol=1e-6, rtol=1e-4)
    assert int(got["opt_gmm"]["step"]) == C and int(got["opt_reg"]["step"]) == 1


def test_shared_vs_per_chain_param_schemes_agree():
    """Twin of ``tests/test_engine.py::test_shared_vs_per_chain_param_schemes_agree``
    in the port, with its tolerances: 40 transitions of 2 chains at 12³
    from the identity, the same draws in both modes; the last data terms
    within 5%, the pooled posterior mean and std within a tenth of their
    scale plus 0.02."""
    _, tb, _, (tf, tm) = _bundles(DIMS, reg="l2")
    og, orr = t_adam(0.2, 0.001), t_adam(0.01, 0.001)
    results = {}
    for mode in ("per_chain", "shared"):
        state = teng.init_chains(tb, torch.Generator().manual_seed(5), 2, "identity", None,
                                 tb.gmm.init_params("cpu"), tb.reg_loss.init_params("cpu"),
                                 og, orr, device="cpu", param_mode=mode)
        chunk = teng.make_mcmc_chunk(tb, og, orr, 5e-4, tf, tm, chunk=40, burn_in=10, thin=1,
                                     param_mode=mode)
        state, metrics = chunk(state)
        mean, std = teng.posterior_statistics(state)
        results[mode] = (mean.numpy(), std.numpy(), metrics["data_term"].numpy())
    (m_pc, s_pc, d_pc), (m_sh, s_sh, d_sh) = results["per_chain"], results["shared"]
    assert np.isfinite(d_sh).all() and np.isfinite(d_pc).all()
    np.testing.assert_allclose(d_pc[-5:].mean(), d_sh[-5:].mean(), rtol=0.05)
    scale = max(float(np.abs(m_pc).max()), 1e-3)
    assert float(np.abs(m_pc - m_sh).max()) < 0.1 * scale + 0.02
    assert float(np.abs(s_pc - s_sh).max()) < 0.1 * float(s_pc.max()) + 0.02


# ---- VI remat -------------------------------------------------------------------

LR_Q = {"mu": 0.01, "log_var": 0.01, "u": 0.01}
LR_GMM = {"log_std": 0.2, "logits": 0.2}


def _vi_state(jb, dims, seed=0):
    rng = np.random.default_rng(seed)
    shape = (3,) + dims
    q_v = {"mu": jnp.asarray(_smooth(rng, shape, 2.0)),
           "log_var": jnp.full(shape, 2.0 * math.log(0.5), jnp.float32),
           "u": jnp.full(shape, 0.1, jnp.float32)}
    oq, og, orr = adam_decay(LR_Q, 1e-3), adam_decay(LR_GMM, 1e-3), adam_decay(REG_LRS, 1e-3)
    gmm = jb.gmm.init_scales_from_residual_std(jb.gmm.init_params(), 1.0)
    gmm["logits"] = jnp.asarray([0.3, -0.2, 0.1, -0.4], jnp.float32)
    state = JVIState(q_v=q_v, gmm=gmm, reg=jb.reg_loss.init_params(), opt_q_v=oq.init(q_v),
                     opt_gmm=og.init(gmm), opt_reg=orr.init(jb.reg_loss.init_params()),
                     key=jax.random.PRNGKey(seed), step=jnp.zeros((), jnp.int32))
    return state, (oq, og, orr)


def _t_opts():
    return t_adam(LR_Q, 1e-3), t_adam(LR_GMM, 1e-3), t_adam(REG_LRS, 1e-3)


def test_vi_remat_step_matches_batched():
    """Twin of ``tests/test_engine.py::test_vi_remat_step_matches_batched``:
    6 VI steps with the chains in turn under ``torch.utils.checkpoint``
    equal the batched steps on the same draws.  The two schedules sum the
    same terms per chain, so the losses agree to 1e-6 relative and q(v) to
    1e-6 (the JAX test's own bounds, 2e-4 and 1e-3, are far looser)."""
    _, tb, _, (tf, tm) = _bundles(DIMS)
    q_v = tb.init_q_v(0.5, 0.1, device="cpu")
    oq, og, orr = _t_opts()
    gmm, reg = tb.gmm.init_params("cpu"), tb.reg_loss.init_params("cpu")
    state = teng.VIState(q_v=q_v, gmm=gmm, reg=reg, opt_q_v=oq.init(q_v),
                         opt_gmm=og.init(gmm), opt_reg=orr.init(reg),
                         key=torch.tensor([0, 7]), step=0)
    state = teng.gmm_warmup(tb, og, state, tf, tm)
    outs = {}
    for remat in (False, True):
        step = teng.make_vi_step(tb, oq, og, orr, tf, tm, remat=remat)
        outs[remat] = teng.make_vi_chunk(step, 6)(state)
    (s_b, m_b), (s_r, m_r) = outs[False], outs[True]
    for k in ("total_loss", "data_term", "reg_term", "entropy_term"):
        np.testing.assert_allclose(m_r[k].numpy(), m_b[k].numpy(), rtol=1e-6, err_msg=k)
    for k in ("ndv", "sat"):
        assert torch.equal(m_r[k], m_b[k]), k
    for name in ("mu", "log_var", "u"):
        np.testing.assert_allclose(s_r.q_v[name].numpy(), s_b.q_v[name].numpy(), atol=1e-6)
    for k in s_b.gmm:
        np.testing.assert_allclose(s_r.gmm[k].numpy(), s_b.gmm[k].numpy(), atol=1e-6)


def test_vi_remat_step_matches_jax_remat():
    """One remat VI step against JAX's ``make_vi_step(remat=True)`` at 16³
    on "post", JAX's draws injected.  Tolerances of
    ``tests/test_torch_vi.py::test_vi_step_matches_jax``: loss terms 1e-4
    relative (the entropy and total within 1e-4 of the ``Σ log σ²`` that
    XLA sums in f32), counters equal, the q(v) gradient within 1e-3 RMS of
    its RMS and 2% of its maximum, the GMM scales and proportions 1e-4."""
    dims = (16, 16, 16)
    jb, tb, (jf, jm), (tf, tm) = _bundles(dims)
    state, (oq, og, orr) = _vi_state(jb, dims, seed=3)
    tree = _np_tree(state)
    new_j, met_j = jax.jit(j_make_vi_step(jb, oq, og, orr, jf, jm, remat=True))(state)
    _, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(3), 4)
    k_eps, k_x = jax.random.split(k1)
    draws = (jax.random.normal(k_eps, (3,) + dims, jnp.float32),
             jax.random.normal(k_x, (), jnp.float32),
             jnp.stack([jax.random.uniform(k, (3,) + dims, jnp.float32, -ALPHA, ALPHA)
                        for k in (k2, k3)]))
    step = teng.make_vi_step(tb, *_t_opts(), tf, tm, remat=True)
    new_t, met_t = step(vi_state_from_numpy(tree, device="cpu"),
                        noise=tuple(_t(a) for a in draws))
    for k in ("ndv", "sat", "sat_resid"):
        np.testing.assert_array_equal(met_t[k].numpy(), np.asarray(met_j[k]), err_msg=k)
    for k in ("data_term", "reg_term", "vd_alpha", "reg_energy", "gmm_scales",
              "gmm_proportions"):
        np.testing.assert_allclose(met_t[k].numpy(), np.asarray(met_j[k]), rtol=1e-4, err_msg=k)
    log_var_sum = abs(float(np.sum(tree.q_v["log_var"], dtype=np.float64)))
    for k in ("entropy_term", "total_loss"):
        assert abs(float(met_t[k]) - float(met_j[k])) <= 1e-4 * log_var_sum, k
    for name in ("mu", "log_var", "u"):
        g_t = new_t.opt_q_v.mu[name].numpy() / 0.1
        g_j = np.asarray(new_j.opt_q_v.mu[name]) / 0.1
        dg = g_t - g_j
        assert np.sqrt(np.mean(dg ** 2)) <= 1e-3 * np.sqrt(np.mean(g_j ** 2)), name
        assert np.abs(dg).max() <= 2e-2 * np.abs(g_j).max(), name
