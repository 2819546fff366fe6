"""PyTorch port vs the JAX package: the remaining public names of
``ir_sgmcmc_tpu.ops`` and ``ir_sgmcmc_tpu.models`` (``log_det_jacobian``,
``field_norm``, ``grid_sample_2d``, ``sgld_step``, ``uniform_field_noise``,
``add_uniform_noise``) and the exports of the port's ``ops``, ``models``
and ``engine`` packages.

Each function has the twin of its JAX test at the JAX test's tolerance,
and a parity check against the JAX function on the same numpy inputs (the
random draws injected) on the CPU.
"""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

import jax
import jax.numpy as jnp

from ir_sgmcmc_tpu.models import sampler as jsamp
from ir_sgmcmc_tpu.ops import grids as jgrids
from ir_sgmcmc_tpu.ops import resample as jres
from ir_sgmcmc_tpu.ops import stencil as jst
from ir_sgmcmc_tpu_torch.models import sampler as tsamp
from ir_sgmcmc_tpu_torch.ops import grids as tgrids
from ir_sgmcmc_tpu_torch.ops import resample as tres
from ir_sgmcmc_tpu_torch.ops import stencil as tst


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float32))


# ---- log_det_jacobian -------------------------------------------------------------

def test_log_det_jacobian_identity_is_zero():
    """Twin of tests/test_stencil.py::test_log_det_J_identity_is_zero."""
    T = tgrids.identity_grid((8, 8, 8), device="cpu")
    np.testing.assert_allclose(tst.log_det_jacobian(T).numpy(), 0.0, atol=1e-5)


def test_log_det_jacobian_uniform_scaling():
    """Twin of tests/test_stencil.py::test_log_det_J_uniform_scaling: det J
    of 2 x identity is 8."""
    T = tgrids.identity_grid((8, 8, 8), device="cpu") * 2.0
    np.testing.assert_allclose(tst.log_det_jacobian(T).numpy(), np.log(8.0), atol=1e-4)


def test_log_det_jacobian_matches_jax_with_folds():
    """A rough field that folds: NaN at the same voxels as the JAX
    function, and the same values elsewhere (1e-5: a determinant of f32
    differences scaled by (n-1)/2); batched inputs are mapped over the
    leading axis."""
    dims = (6, 7, 8)
    rng = np.random.default_rng(0)
    T = np.asarray(jgrids.identity_grid(dims)) + _rand(rng, (2, 3) + dims, 0.15)
    ref = np.asarray(jst.log_det_jacobian(jnp.asarray(T)))
    out = tst.log_det_jacobian(_t(T)).numpy()
    assert out.shape == (2,) + dims
    folded = np.isnan(ref)
    assert 0 < folded.sum() < folded.size
    np.testing.assert_array_equal(np.isnan(out), folded)
    np.testing.assert_allclose(out[~folded], ref[~folded], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tst.log_det_jacobian(_t(T[0])).numpy(), out[0])


def test_svf_translation_is_diffeomorphic():
    """Twin of tests/test_transformation.py::
    test_svf_constant_velocity_is_translation: exp of a constant field is a
    translation by that amount, and log |J| is finite in the interior."""
    from ir_sgmcmc_tpu_torch.models import SVF3D

    v = torch.zeros((1, 3, 16, 16, 16))
    v[:, 0] = 1.5
    T, disp = SVF3D((16, 16, 16))(v)
    np.testing.assert_allclose(disp[0, 0, 4:-4, 4:-4, 4:-4].numpy(), 1.5, atol=1e-3)
    assert torch.isfinite(tst.log_det_jacobian(T)[0, 2:-2, 2:-2, 2:-2]).all()


# ---- field_norm -----------------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True])
def test_field_norm_matches_jax(batched):
    rng = np.random.default_rng(1)
    f = _rand(rng, ((2,) if batched else ()) + (3, 5, 6, 7))
    out = tgrids.field_norm(_t(f)).numpy()
    np.testing.assert_allclose(out, np.asarray(jgrids.field_norm(jnp.asarray(f))),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(out, np.sqrt((f.astype(np.float64) ** 2).sum(-4)), rtol=1e-6)


# ---- grid_sample_2d -------------------------------------------------------------

def test_grid_sample_2d_matches_torch():
    """Twin of tests/test_transformation.py::test_grid_sample_2d_matches_torch
    (the reference's ``F.grid_sample``, bilinear, border, align_corners),
    with a grid beyond the borders."""
    import torch.nn.functional as F

    rng = np.random.default_rng(5)
    im = rng.standard_normal((9, 11)).astype(np.float32)
    grid = (rng.random((2, 7, 8)).astype(np.float32) * 2.4 - 1.2)
    ours = tres.grid_sample_2d(_t(im), _t(grid), mode="linear")
    theirs = F.grid_sample(_t(im)[None, None], _t(np.moveaxis(grid, 0, -1))[None],
                           mode="bilinear", padding_mode="border",
                           align_corners=True)[0, 0]
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=1e-5)


@pytest.mark.parametrize("mode", ["linear", "nearest"])
def test_grid_sample_2d_matches_jax(mode):
    """Both modes, one and several channels, against the JAX function:
    1e-5 (bilinear: a few f32 roundings of O(1) values); nearest picks the
    same voxel (rounded half to even in both)."""
    rng = np.random.default_rng(6)
    im = _rand(rng, (3, 8, 11))
    grid = (rng.random((2, 7, 8)).astype(np.float32) * 2.4 - 1.2)
    grid[:, 0, :4] = np.float32(0.0)  # the centre: y = 3.5, a tie for nearest
    for x in (im, im[0]):
        ref = np.asarray(jres.grid_sample_2d(jnp.asarray(x), jnp.asarray(grid), mode=mode))
        out = tres.grid_sample_2d(_t(x), _t(grid), mode=mode).numpy()
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-5 if mode == "linear" else 0.0)
    with pytest.raises(ValueError, match="mode"):
        tres.grid_sample_2d(_t(im), _t(grid), mode="cubic")


# ---- samplers -------------------------------------------------------------------

@pytest.mark.parametrize("tau,sig", [(0.05, 1.0), (0.05, 0.5)])
def test_sgld_samples_gaussian_stationary_distribution(tau, sig):
    """Twin of tests/test_probabilistic.py::
    test_sgld_samples_gaussian_stationary_distribution at its tolerance
    (rtol 0.08): for ``U(v) = v²/(2 s²)`` the update is the OU
    discretisation ``v_next = (1-a)(v + sqrt(2 tau) sigma eps)``,
    ``a = tau sigma²/s²``, whose stationary variance is ``2 s² (1-a)²/(2-a)``.
    The JAX test runs one chain for 120,000 steps; here 4,000 independent
    chains from one ``torch.Generator`` run 600 steps, and the last 100
    states of each are pooled (1/a = 40 to 160 steps: past 400 steps of
    burn-in a chain has forgotten its start to e^-2.5 or better)."""
    s2 = 2.0
    gen = torch.Generator().manual_seed(0)
    v = torch.zeros(4000)
    sigma = torch.full_like(v, sig)
    samples = []
    for i in range(600):
        v = tsamp.sgld_step(gen, v, sigma, tau, lambda x: x / s2)
        if i >= 500:
            samples.append(v)
    a = tau * sig ** 2 / s2
    expected = 2.0 * s2 * (1.0 - a) ** 2 / (2.0 - a)
    np.testing.assert_allclose(float(torch.stack(samples).var()), expected, rtol=0.08)


def test_sgld_step_matches_jax_with_its_draw():
    """One step from JAX's key with JAX's normal draw injected: equal to
    f32 rounding (the same three products and two sums)."""
    rng = np.random.default_rng(2)
    v, sigma = _rand(rng, (3, 4, 5, 6)), np.abs(_rand(rng, (3, 4, 5, 6))) + 0.1
    key = jax.random.PRNGKey(7)
    tau = 0.03

    def grad_fn(x):
        return 0.5 * x ** 3

    ref = np.asarray(jsamp.sgld_step(key, jnp.asarray(v), jnp.asarray(sigma), tau, grad_fn))
    eps = np.asarray(jax.random.normal(key, v.shape, jnp.float32))
    out = tsamp.sgld_step(None, _t(v), _t(sigma), tau, grad_fn, eps=_t(eps))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-6)


def test_uniform_field_noise_matches_jax():
    """JAX's uniform draw (voxel units) injected: the same normalised field
    (1e-7: one scaling per channel); drawn from a generator, the noise lies
    in ±alpha voxels, on the generator's device, and the normalised noise
    is that draw scaled per channel."""
    dims = (4, 5, 6)
    key, alpha = jax.random.PRNGKey(3), 0.1
    ref = np.asarray(jsamp.uniform_field_noise(key, (2, 3) + dims, alpha))
    draw = np.asarray(jax.random.uniform(key, (2, 3) + dims, jnp.float32, -alpha, alpha))
    out = tsamp.uniform_field_noise(None, (2, 3) + dims, alpha, noise_vox=_t(draw))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-7)

    T = np.asarray(jgrids.identity_grid(dims))
    ref_t = np.asarray(jsamp.add_uniform_noise(key, jnp.asarray(T), alpha))
    draw_t = np.asarray(jax.random.uniform(key, T.shape, jnp.float32, -alpha, alpha))
    got = tsamp.add_uniform_noise(None, _t(T), alpha, noise_vox=_t(draw_t))
    np.testing.assert_allclose(got.numpy(), ref_t, atol=1e-7)

    gen = torch.Generator().manual_seed(4)
    noise = tsamp.uniform_field_noise(gen, (3,) + dims, alpha)
    vox = tgrids.normalised_to_voxel(noise)
    assert noise.device.type == "cpu" and float(vox.abs().max()) <= alpha * (1 + 1e-6)
    gen = torch.Generator().manual_seed(4)
    np.testing.assert_allclose(
        noise.numpy(),
        tgrids.voxel_to_normalised(tsamp.uniform_voxel_noise(gen, (3,) + dims, alpha)).numpy())
    noisy = tsamp.add_uniform_noise(torch.Generator().manual_seed(4), _t(T), alpha)
    np.testing.assert_allclose(noisy.numpy(), T + noise.numpy(), atol=1e-7)


# ---- exports --------------------------------------------------------------------

@pytest.mark.parametrize("package", ["ops", "models", "engine", "parallel"])
def test_exports_cover_the_jax_packages(package):
    """Each package exports what the JAX package's does, the multi-device
    names (``parallel``, the engine's ``make_pair_mesh`` and
    ``shard_pairs``) included."""
    import importlib

    jax_names = set(importlib.import_module(f"ir_sgmcmc_tpu.{package}").__all__)
    port = importlib.import_module(f"ir_sgmcmc_tpu_torch.{package}")
    missing = jax_names - set(port.__all__)
    assert missing == set()
    for name in port.__all__:
        assert getattr(port, name) is not None, name
