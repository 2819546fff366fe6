"""PyTorch port vs the JAX package: grids, stencils, Sobolev, the Taylor
squaring, the split composition (B1/B2), the block-gather warp (B3/B4) and
the bounded blend warp (B5-B7).

Same numpy inputs from a seed go through both packages on the CPU, in
float32.  Where the JAX function reaches a Pallas kernel it runs in
interpret mode, as the JAX suite runs it.  Tolerances are the JAX suite's
own for the kernels (tests/test_pallas_split_warp.py:37,58 and
tests/test_pallas_block_warp.py:66,93, tests/test_pallas_warp.py:30,68);
elementwise stencils are held to 1e-5 (a handful of f32 roundings of O(1)
values).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ir_sgmcmc_tpu.ops import grids as jgrids
from ir_sgmcmc_tpu.ops import resample as jres
from ir_sgmcmc_tpu.ops import sobolev as jsob
from ir_sgmcmc_tpu.ops import stencil as jst
from ir_sgmcmc_tpu.ops.pallas_block_warp import (
    block_warp_dgrad_pallas,
    block_warp_pallas,
    block_warp_pallas_applicable,
)
from ir_sgmcmc_tpu.ops.pallas_split_warp import split_warp_bwd_pallas, split_warp_pallas
from ir_sgmcmc_tpu.ops.pallas_warp import (
    warp_bounded_dgrad_pallas,
    warp_bounded_pallas,
    warp_bounded_tblend_pallas,
)
from ir_sgmcmc_tpu_torch.kernels import block_warp as tbw
from ir_sgmcmc_tpu_torch.kernels import split_warp as tsw
from ir_sgmcmc_tpu_torch.kernels import warp_bounded as twb
from ir_sgmcmc_tpu_torch.ops import grids as tgrids
from ir_sgmcmc_tpu_torch.ops import resample as tres
from ir_sgmcmc_tpu_torch.ops import sobolev as tsob
from ir_sgmcmc_tpu_torch.ops import stencil as tst


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float32))


def _close(port, ref, atol, rtol=0.0):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_allclose(port, np.asarray(ref), atol=atol, rtol=rtol)


# ---- grids ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 6, 7), (1, 4, 9)])
def test_grids_match_jax(shape):
    rng = np.random.default_rng(0)
    _close(tgrids.identity_grid(shape, device="cpu"), jgrids.identity_grid(shape), 1e-6)
    f = _rand(rng, (3,) + shape, 3.0)
    if 1 not in shape:
        _close(tgrids.voxel_to_normalised(_t(f)), jgrids.voxel_to_normalised(f), 1e-6, 1e-6)
    _close(tgrids.normalised_to_voxel(_t(f)), jgrids.normalised_to_voxel(f), 1e-6, 1e-6)
    jac = _rand(rng, (3, 3) + shape)
    _close(tgrids.det_jacobian(_t(jac)), jgrids.det_jacobian(jac), 1e-5, 1e-5)


# ---- stencils -----------------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True])
def test_stencils_match_jax(batched):
    rng = np.random.default_rng(1)
    shape = ((2,) if batched else ()) + (3, 6, 7, 8)
    f = _rand(rng, shape)
    k = np.asarray([0.2, 0.5, 0.3], np.float32)
    for axis in (-3, -2, -1):
        _close(tst.conv1d_axis(_t(f), _t(k), axis), jst.conv1d_axis(f, k, axis), 1e-5)
        _close(tst._fwd_diff_axis(_t(f), axis), jst._fwd_diff_axis(f, axis), 1e-5)
    _close(tst.separable_conv3d(_t(f), _t(k)), jst.separable_conv3d(f, k), 1e-5)
    _close(tst.box_filter3d(_t(f), 1), jst.box_filter3d(f, 1), 1e-5)
    for ns in (False, True):
        ref = (jax.vmap(lambda x: jst.gradient(x, normalised_spacing=ns))(f)
               if batched else jst.gradient(f, normalised_spacing=ns))
        _close(tst.gradient(_t(f), normalised_spacing=ns), ref, 1e-5)
    # the energy sums 9·D·H·W squares: relative f32 summation error
    _close(tst.reg_energy(_t(f)), jst.reg_energy(f), 0.0, 1e-5)


def test_fwd_diff_transpose_is_adjoint():
    rng = np.random.default_rng(2)
    x, y = _t(_rand(rng, (3, 5, 6, 7))), _t(_rand(rng, (3, 5, 6, 7)))
    for axis in (-3, -2, -1):
        lhs = torch.sum(tst._fwd_diff_axis(x, axis) * y)
        rhs = torch.sum(x * tst._fwd_diff_axis_t(y, axis))
        assert abs(float(lhs - rhs)) < 1e-4


def test_sobolev_matches_jax_with_identity_backward():
    for s, lam in ((3, 0.5), (2, 1.0)):
        k_t, ks_t = tsob.sobolev_kernel_1d(s, lam)
        k_j, ks_j = jsob.sobolev_kernel_1d(s, lam)
        np.testing.assert_array_equal(k_t, k_j)
        np.testing.assert_array_equal(ks_t, ks_j)
    rng = np.random.default_rng(3)
    f = _rand(rng, (2, 3, 8, 8, 8))
    kern = tsob.sobolev_kernel_1d(3, 0.5)[0].astype(np.float32)
    x = _t(f).requires_grad_(True)
    out = tsob.sobolev_smooth(x, _t(kern))
    _close(out, jsob.sobolev_smooth(f, jnp.asarray(kern)), 1e-5)
    g = _t(_rand(rng, f.shape))
    (gx,) = torch.autograd.grad(out, x, g)
    assert torch.equal(gx, g)


def test_taylor_squaring_forward_and_vjp_match_jax():
    rng = np.random.default_rng(4)
    d = _rand(rng, (3, 8, 9, 10), 0.3)
    g = _rand(rng, d.shape)
    x = _t(d).requires_grad_(True)
    out = tst.taylor_squaring_step(x)
    ref, vjp = jax.vjp(jst.taylor_squaring_step, jnp.asarray(d))
    _close(out, ref, 1e-5)
    (gx,) = torch.autograd.grad(out, x, _t(g))
    _close(gx, vjp(jnp.asarray(g))[0], 1e-5)
    # batched (leading chain axis) equals the per-chain JAX map
    db = _rand(rng, (2,) + d.shape, 0.3)
    _close(tst.taylor_squaring_step(_t(db)),
           jax.vmap(jst.taylor_squaring_step)(db), 1e-5)


# ---- split composition (B1/B2) -------------------------------------------------

@pytest.mark.parametrize("scale", [0.9, 1.8])
def test_split_compose_matches_jax_pallas_and_xla(scale):
    """Plain B1/B2 against the Pallas kernels (interpret) and the XLA form.

    ``scale`` 1.8 saturates many offsets (|u| > 1, the clamp and its zero
    gradient).  Random normals never hit the ties u = 0 or |u| = 1, where
    autodiff and the kernel convention split the subgradient differently.
    """
    shape = (2, 3, 8, 8, 128)
    rng = np.random.default_rng(5)
    d, u, g = _rand(rng, shape, 2.0), _rand(rng, shape, scale), _rand(rng, shape)

    out = tsw.split_compose(_t(d), _t(u))
    ref_pallas = jax.vmap(lambda a, b: split_warp_pallas(a, b, add_u=True,
                                                         interpret=True))(d, u)
    ref_xla = jax.vmap(jst._split_compose_impl)(d, u)
    _close(out, ref_pallas, 2e-5)
    _close(out, ref_xla, 2e-5)

    gd, gu = tsw.split_compose_vjp(_t(d), _t(u), _t(g))
    gd_p, gu_p = jax.vmap(lambda a, b, c: split_warp_bwd_pallas(
        a, b, c, interpret=True))(d, u, g)
    _close(gd, gd_p, 3e-5, 1e-4)
    _close(gu, gu_p + g, 3e-5, 1e-4)
    gd_x, gu_x = jax.vmap(lambda a, b, c: jax.vjp(jst._split_compose_impl, a, b)[1](c))(d, u, g)
    _close(gd, gd_x, 3e-5, 1e-4)
    _close(gu, gu_x, 3e-5, 1e-4)

    # the autograd Function routes CPU tensors through the same plain pair
    dt, ut = _t(d).requires_grad_(True), _t(u).requires_grad_(True)
    o = tst.split_compose_step(dt, ut)
    assert torch.equal(o, out)
    gdt, gut = torch.autograd.grad(o, (dt, ut), _t(g))
    assert torch.equal(gdt, gd) and torch.equal(gut, gu)


def test_split_compose_cuda_wrappers_reject_cpu_tensors():
    x = torch.zeros((1, 3, 8, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tsw.split_warp_fwd_cuda(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        tsw.split_warp_bwd_cuda(x, x, x)


# ---- block-gather warp (B3/B4) ----------------------------------------------------

def _smooth_disp(shape, magnitude, seed):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((3, 2, 2, 2)).astype(np.float32) * magnitude
    d = jax.image.resize(jnp.asarray(c), (3,) + shape, method="cubic")
    return np.asarray(jnp.clip(d, -magnitude, magnitude))


def _kernel_operands(shape, bound, radius, seed, integer_every=3):
    """vol, the clipped residual (every ``integer_every``-th value rounded to
    an integer) and the block means, from the JAX package's own prep."""
    rng = np.random.default_rng(seed)
    vol = _rand(rng, (1,) + shape)
    disp = _smooth_disp(shape, bound - 0.5, seed)
    _, _, m, r_raw = jres._wbg_prep_pallas(jnp.asarray(vol), jnp.asarray(disp),
                                           bound, radius, 8)
    r_c = np.array(jnp.clip(r_raw, -radius, radius))
    flat = r_c.reshape(-1)
    flat[::integer_every] = np.round(flat[::integer_every])
    return vol, r_c, np.array(m), rng


def test_block_means_match_jax():
    disp = _smooth_disp((16, 16, 128), 8.5, 6) + 0.25
    ref = jres._block_means(jnp.asarray(disp), 8, 9)
    out = tres._block_means(_t(disp)[None], 8, 9)[0]
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("bound,radius", [(9, 2), (6, 1)])
def test_block_warp_kernels_match_jax_pallas(bound, radius):
    """Plain B3/B4 against the Pallas kernels (interpret) at a shape they
    accept, with a third of the residuals exactly integer: there B4's axis
    derivative is 0 by the tap convention."""
    shape = (16, 16, 128)
    assert block_warp_pallas_applicable((1,) + shape, bound, radius, 8)
    vol, r_c, m, rng = _kernel_operands(shape, bound, radius, seed=7)
    g = _rand(rng, (1,) + shape)

    out = tbw.block_warp(_t(vol)[None], _t(r_c)[None], torch.as_tensor(m)[None], radius)
    ref = block_warp_pallas(vol, r_c, m, bound, radius, interpret=True)
    _close(out[0], ref, 1e-5)

    dg = tbw.block_warp_dgrad(_t(vol)[None], _t(r_c)[None], torch.as_tensor(m)[None],
                              _t(g)[None], radius)
    dref = block_warp_dgrad_pallas(vol, r_c, m, g, bound, radius, interpret=True)
    _close(dg[0], dref, 5e-4, 1e-4)
    # integer residual -> zero derivative along that axis
    r0 = r_c[0]
    ints = r0 == np.round(r0)
    assert ints.any() and np.all(dg[0, 0].numpy()[ints] == 0.0)


@pytest.mark.parametrize("pallas", [False, True])
def test_warp_block_gather_matches_jax_with_overflow(pallas):
    """The whole op (block means, clip, B3, B4 and the ``|r| > R`` mask) on a
    field rough enough that some residuals overflow the radius."""
    shape = (16, 16, 128)
    bound, radius = 6, 2
    rng = np.random.default_rng(8)
    vol = _rand(rng, shape)
    disp = _smooth_disp(shape, bound - 1.0, seed=9) + 0.25
    disp = disp + _rand(rng, disp.shape, 0.9)  # in-block roughness
    disp = np.clip(disp, -bound + 0.5, bound - 0.5).astype(np.float32)
    g = _rand(rng, shape)

    jres.set_pallas_mode("interpret" if pallas else False)
    try:
        ref = jres.warp_block_gather(jnp.asarray(vol), jnp.asarray(disp), bound, radius, 8)
        gref = jax.grad(lambda d: jnp.sum(jres.warp_block_gather(
            jnp.asarray(vol), d, bound, radius, 8) * g))(jnp.asarray(disp))
    finally:
        jres.set_pallas_mode(None)
    n_over = int(jres.block_residual_overflow(jnp.asarray(disp), bound, radius, 8))
    assert n_over > 0

    x = _t(disp)[None].requires_grad_(True)
    out = tres.warp_block_gather(_t(vol)[None, None], x, bound, radius, 8)
    _close(out[0, 0], ref, 1e-5)
    (gx,) = torch.autograd.grad(out, x, _t(g)[None, None])
    _close(gx[0], gref, 5e-4, 1e-4)
    assert int(tres.block_residual_overflow(_t(disp)[None], bound, radius, 8)[0]) == n_over


def _tri_np(t):
    return np.maximum(0.0, 1.0 - np.abs(t))


def _dtri_np(t):
    return -np.sign(t) * (np.abs(t) < 1.0)


def _window_form(vol, r, m, g, radius, block=8):
    """B3's and B4's CUDA formulation (their window kernels) in numpy: per block, the ``(block + 2R)³`` source window at origin
    ``p_b + m_b − R`` with each index clamped to the volume, and the taps
    at window points ``l + R + k`` and ``+1``, ``l = p − p_b``,
    ``k = min(floor(r), R − 1)``.  ``vol, g (C, D, H, W)``, ``r (3, D, H,
    W)`` clipped to ±R, ``m (3, nbz, nby, nbx)``.  Returns the warp and
    ``∂(Σ_c g_c·warp_c)/∂r``, summed in the kernel's order."""
    C, D, H, W = vol.shape
    E = block + 2 * radius
    dims = (D, H, W)
    # per block and axis: the clamped source index of each window point
    idx = []
    for a, n in enumerate(dims):  # a: 0 = z, 1 = y, 2 = x
        nb = [1, 1, 1]
        nb[a] = n // block
        p_b = (np.arange(n // block) * block).reshape(nb)
        o = p_b + m[2 - a] - radius  # m's channel 0 is x
        idx.append(np.clip(o[..., None] + np.arange(E), 0, n - 1))
    win = vol[:, idx[0][..., :, None, None], idx[1][..., None, :, None],
              idx[2][..., None, None, :]]  # (C, nbz, nby, nbx, E, E, E)
    p = np.meshgrid(*(np.arange(n) for n in dims), indexing="ij")
    j, w, dw = [], [], []
    for a in range(3):
        ra = r[2 - a]
        k = np.minimum(np.floor(ra), radius - 1)
        ja = p[a] % block + radius + k.astype(np.int64)
        # both taps inside the window: staging it once serves the block
        assert ja.min() >= 0 and ja.max() + 1 <= E - 1
        j.append(ja)
        w.append([_tri_np(ra - (k + s)) for s in (0, 1)])
        dw.append([_dtri_np(ra - (k + s)) for s in (0, 1)])
    bz, by, bx = (q // block for q in p)

    def tap(a, e, f):
        return win[:, bz, by, bx, j[0] + a, j[1] + e, j[2] + f]

    out = np.zeros_like(vol)
    acc = np.zeros((3,) + dims, np.float32)
    for a in (0, 1):
        for e in (0, 1):
            t0, t1 = tap(a, e, 0), tap(a, e, 1)
            out += (w[0][a] * w[1][e]) * (w[2][0] * t0 + w[2][1] * t1)
            sg0, sg1 = np.sum(g * t0, axis=0), np.sum(g * t1, axis=0)
            a_sum = dw[2][0] * sg0 + dw[2][1] * sg1
            b_sum = w[2][0] * sg0 + w[2][1] * sg1
            acc[0] += (w[0][a] * w[1][e]) * a_sum
            acc[1] += (w[0][a] * dw[1][e]) * b_sum
            acc[2] += (dw[0][a] * w[1][e]) * b_sum
    return out, acc


@pytest.mark.parametrize("bound,radius,chan", [
    pytest.param(9, 2, 1, id="9-2"), pytest.param(6, 1, 1, id="6-1"),
    pytest.param(9, 3, 2, id="9-3-c2")])
def test_block_window_form_matches_jax_pallas(bound, radius, chan):
    """B3's and B4's window formulation in numpy against the Pallas kernels
    (interpret) on a field whose block means reach ±bound in the blocks
    next to the z and x borders (their windows clamp), with residuals
    exactly ±R and at integers (the capped lower tap); at R 3 over two
    channels (B3's per-channel sums, B4's channel-first ones)."""
    shape = (16, 16, 128)
    assert block_warp_pallas_applicable((chan,) + shape, bound, radius, 8)
    rng = np.random.default_rng(14 + radius)
    vol = _rand(rng, (chan,) + shape)
    disp = np.array(_smooth_disp(shape, bound - 0.5, 15))
    disp[:, :8] = bound + 0.4
    disp[:, -8:] = -bound - 0.4
    disp[..., -8:] = np.where(disp[..., -8:] < 0, -bound - 0.4, bound + 0.4)
    disp = (disp + _rand(rng, disp.shape, 0.8)).astype(np.float32)
    _, _, m, r_raw = jres._wbg_prep_pallas(jnp.asarray(vol), jnp.asarray(disp), bound, radius, 8)
    m = np.array(m)
    assert np.abs(m).max() == bound
    r_c = np.array(jnp.clip(r_raw, -radius, radius))
    flat = r_c.reshape(-1)
    flat[::7] = np.round(flat[::7])
    flat[1::11] = radius
    flat[2::13] = -radius
    g = _rand(rng, (chan,) + shape)

    out, dg = _window_form(vol, r_c, m, g, radius)
    _close(out, block_warp_pallas(vol, r_c, m, bound, radius, interpret=True), 1e-5)
    _close(dg, block_warp_dgrad_pallas(vol, r_c, m, g, bound, radius, interpret=True), 5e-4, 1e-4)


def _capped_taps(d, p, n, radius):
    """B5's taps along one axis: ``k = min(floor(d~), R − 1)`` and ``k + 1``
    at the border-clamped sources ``clamp(p + k + s)``, with their weights."""
    d = np.clip(d, -radius, radius)
    k = np.minimum(np.floor(d), radius - 1)
    # both taps inside [-R, R]: a ring of the 2R+1 planes around p serves them
    assert k.min() >= -radius and k.max() + 1 <= radius
    return [(np.clip(p + k.astype(np.int64) + s, 0, n - 1), _tri_np(d - (k + s)))
            for s in (0, 1)]


@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("dims", ["thin", "deep", "ragged"])
def test_warp_capped_taps_match_jax_pallas(radius, dims):
    """B5's CUDA formulation (8 taps per voxel at the capped lower tap) in
    numpy against the Pallas kernel (interpret) on dims of 1, 2 and 2R+1
    and a ragged 9 x 10 x 11, with displacements at integers and ±R."""
    dims = {"thin": (1, 2, 2 * radius + 1), "deep": (2 * radius + 1, 1, 2),
            "ragged": (9, 10, 11)}[dims]
    rng = np.random.default_rng(16 + radius)
    vol, disp, _ = _bounded_case(rng, (1, 2) + dims, radius)
    vol, disp = vol[0], disp[0]
    p = np.meshgrid(*(np.arange(n) for n in dims), indexing="ij")
    tz, ty, tx = (_capped_taps(disp[2 - a], p[a], dims[a], radius) for a in range(3))
    out = np.zeros_like(vol)
    for iz, wz in tz:
        for iy, wy in ty:
            out += (wz * wy) * (tx[0][1] * vol[:, iz, iy, tx[0][0]]
                                + tx[1][1] * vol[:, iz, iy, tx[1][0]])
    _close(out, warp_bounded_pallas(vol, disp, radius, interpret=True), 1e-5)


def test_block_warp_cuda_wrappers_reject_cpu_tensors():
    vol = torch.zeros((1, 1, 8, 8, 8))
    r = torch.zeros((1, 3, 8, 8, 8))
    m = torch.zeros((1, 3, 1, 1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tbw.block_warp_cuda(vol, r, m, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tbw.block_warp_dgrad_cuda(vol, r, m, vol, 2)


# ---- bounded blend warp (B5-B7) ---------------------------------------------------

def _bounded_case(rng, shape, radius):
    """Displacements uniform in ±1.4R with every 7th value an integer, every
    11th exactly +R and every 13th -R (the clip, the mask's ``<= R`` and the
    zero derivative at integers)."""
    disp = ((rng.random(shape[:1] + (3,) + shape[2:]) * 2 - 1) * radius * 1.4
            ).astype(np.float32)
    flat = disp.reshape(-1)
    flat[::7] = np.round(flat[::7])
    flat[1::11] = radius
    flat[2::13] = -radius
    return _rand(rng, shape), disp, _rand(rng, shape)


@pytest.mark.parametrize("radius,chan", [(1, 1), (1, 4), (2, 1), (2, 4)])
def test_warp_bounded_matches_jax_xla(radius, chan):
    """Values and both cotangents of ``warp_bounded`` over a batch of 2
    against the JAX package's custom VJP on its XLA path; the displacement
    cotangent is zero wherever ``|d| >= R`` (masked beyond R, a zero
    ``dtri`` sum at R)."""
    rng = np.random.default_rng(11)
    vol, disp, g = _bounded_case(rng, (2, chan, 6, 7, 9), radius)
    jres.set_pallas_mode(False)
    try:
        @jax.jit
        def jax_side(vv, dd, gg):
            out, vjp = jax.vjp(jax.vmap(lambda a, b: jres.warp_bounded(a, b, radius)), vv, dd)
            acc = jax.vmap(lambda b, c: jres._tblend_acc_xla(b, radius, c))(dd, gg)
            dgrads = jax.vmap(lambda a, b, c: jres._bwd_dgrads_xla(a, b, radius, c))(vv, dd, gg)
            return (out, *vjp(gg), acc, jax.vmap(lambda c: jres._fold_edge(c, 1))(gg), dgrads)

        ref, gv_ref, gd_ref, acc_ref, fold_ref, dgrads_ref = jax_side(vol, disp, g)
    finally:
        jres.set_pallas_mode(None)
    v, d = _t(vol).requires_grad_(True), _t(disp).requires_grad_(True)
    out = tres.warp_bounded(v, d, radius)
    gv, gd = torch.autograd.grad(out, (v, d), _t(g))
    _close(out, ref, 1e-5)
    _close(gv, gv_ref, 1e-5)
    _close(gd, gd_ref, 1e-5)
    assert np.all(gd.numpy()[np.abs(disp) >= radius] == 0.0)
    # the plain pieces, one by one
    _close(twb.tblend_acc_plain(_t(disp), _t(g), radius), acc_ref, 1e-5)
    _close(twb.fold_edge(_t(g), 1), fold_ref, 1e-6)
    masked = torch.where(torch.abs(_t(disp)) <= radius,
                         twb.warp_bounded_dgrad_plain(_t(vol), _t(disp), _t(g), radius), 0.0)
    _close(masked, dgrads_ref, 1e-5)


@pytest.mark.parametrize("radius,chan", [(1, 1), (2, 4)])
def test_warp_bounded_kernels_match_jax_pallas(radius, chan):
    """Plain B5/B6/B7 against the Pallas kernels (interpret mode) at a shape
    they accept; B7 against the TPU kernel's accumulator with the caller's
    z/y fold applied, as ``resample.py:485-487`` does."""
    shape = (8, 8, 128)
    rng = np.random.default_rng(12)
    vol, disp, g = _bounded_case(rng, (1, chan) + shape, radius)
    vj = vol[0, 0] if chan == 1 else vol[0]
    gj = g[0, 0] if chan == 1 else g[0]

    def as_port(a):
        return a[None, None] if chan == 1 else a[None]

    out = twb.warp_bounded_fwd(_t(vol), _t(disp), radius)
    _close(out, as_port(np.asarray(warp_bounded_pallas(vj, disp[0], radius, interpret=True))),
           1e-5)
    dg = twb.warp_bounded_dgrad(_t(vol), _t(disp), _t(g), radius)
    _close(dg[0], warp_bounded_dgrad_pallas(vj, disp[0], gj, radius, interpret=True), 1e-5)
    tb = twb.warp_bounded_tblend(_t(disp), _t(g), radius)
    acc = warp_bounded_tblend_pallas(disp[0], gj, radius, interpret=True)
    _close(tb, as_port(np.asarray(jres._fold_edge(acc, radius, axes=(-3, -2)))), 1e-5)
    # integer displacement -> zero derivative along its axis (below R too)
    ints = (disp[0, 0] == np.round(disp[0, 0])) & (np.abs(disp[0, 0]) < radius)
    assert ints.any() and np.all(dg[0, 0].numpy()[ints] == 0.0)


def _folded_weights(d, p, n, radius):
    """B7's per-source folded weights along one axis, ``[..., R + δ]`` for
    ``δ`` in ``[-R, R]``: the taps ``k = min(floor(d~), R-1)`` and ``k+1``,
    each at the border-clamped target ``clamp(p + o) - p``."""
    d = np.clip(d, -radius, radius)
    k = np.minimum(np.floor(d), radius - 1)
    w0 = np.maximum(0.0, 1.0 - np.abs(d - k))
    w1 = np.maximum(0.0, 1.0 - np.abs(d - (k + 1)))
    t0 = np.clip(p + k.astype(np.int64), 0, n - 1) - p
    t1 = np.clip(p + k.astype(np.int64) + 1, 0, n - 1) - p
    # both targets inside [-R, R], and the second at t0 or t0 + 1
    assert t0.min() >= -radius and t1.max() <= radius
    assert np.all((t1 == t0) | (t1 == t0 + 1))
    wf = np.zeros(d.shape + (2 * radius + 1,), np.float32)
    for j, delta in enumerate(range(-radius, radius + 1)):
        wf[..., j] = np.where(t0 == delta, w0, 0.0) + np.where(t1 == delta, w1, 0.0)
    return wf


def _tblend_gather(disp, g, radius):
    """``out(q) = Σ_δ Wf_z(p, δz) Wf_y(p, δy) Wf_x(p, δx) g(p)`` over the
    sources ``p = q - δ`` inside the volume; ``disp (3, D, H, W)``,
    ``g (C, D, H, W)``."""
    dims = g.shape[1:]
    z, y, x = np.meshgrid(*(np.arange(n) for n in dims), indexing="ij")
    wz, wy, wx = (_folded_weights(disp[a], c, n, radius)
                  for a, c, n in ((2, z, dims[0]), (1, y, dims[1]), (0, x, dims[2])))

    def window(n, delta):  # target and source slices of a shift by delta
        m = max(n - abs(delta), 0)
        return slice(max(delta, 0), max(delta, 0) + m), slice(max(-delta, 0), max(-delta, 0) + m)

    out = np.zeros_like(g)
    offsets = range(-radius, radius + 1)
    for iz, dz in enumerate(offsets):
        for iy, dy in enumerate(offsets):
            for ix, dx in enumerate(offsets):
                w = wz[..., iz] * wy[..., iy] * wx[..., ix]
                # weights onto a target outside the volume are zero: the
                # gather over sources inside misses nothing
                tz, sz = window(dims[0], dz)
                ty, sy = window(dims[1], dy)
                tx, sx = window(dims[2], dx)
                inside = np.zeros(dims, bool)
                inside[sz, sy, sx] = True
                assert np.all(w[~inside] == 0.0)
                out[:, tz, ty, tx] += (w * g)[:, sz, sy, sx]
    return out


@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("chan", [1, 4])
@pytest.mark.parametrize("shape", ["thin", "ragged"])
def test_tblend_folded_gather_matches_jax(radius, chan, shape):
    """B7's CUDA formulation (per-source folded weights, a (2R+1)³ gather)
    in numpy against the JAX package's ``_tblend_acc_xla`` + ``_fold_edge``,
    on dims of 1, 2 and 2R+1 (the fold covers more than the volume) and a
    ragged 9 x 10 x 11."""
    dims = (1, 2, 2 * radius + 1) if shape == "thin" else (9, 10, 11)
    rng = np.random.default_rng(13 + radius)
    _, disp, g = _bounded_case(rng, (1, chan) + dims, radius)
    disp, g = disp[0], g[0]
    ref = jres._fold_edge(jres._tblend_acc_xla(jnp.asarray(disp), radius, jnp.asarray(g)),
                          radius)
    _close(_tblend_gather(disp, g, radius), ref, 1e-5)


def test_warp_bounded_cuda_wrappers_reject_cpu_tensors():
    vol = torch.zeros((1, 1, 8, 8, 8))
    disp = torch.zeros((1, 3, 8, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        twb.warp_bounded_fwd_cuda(vol, disp, 1)
    with pytest.raises(ValueError, match="CUDA"):
        twb.warp_bounded_dgrad_cuda(vol, disp, vol, 1)
    with pytest.raises(ValueError, match="CUDA"):
        twb.warp_bounded_tblend_cuda(disp, vol, 1)


# ---- grid_sample ------------------------------------------------------------------

def test_grid_sample_matches_jax_value_and_grad():
    shape = (6, 7, 8)
    rng = np.random.default_rng(10)
    vol = _rand(rng, shape)
    grid = (1.2 * (2.0 * rng.random((2, 3) + shape) - 1.0)).astype(np.float32)
    g = _rand(rng, (2,) + shape)
    ref = jax.vmap(lambda t: jres.grid_sample(jnp.asarray(vol), t))(grid)
    gref = jax.grad(lambda t: jnp.sum(jax.vmap(
        lambda tt: jres.grid_sample(jnp.asarray(vol), tt))(t) * g))(jnp.asarray(grid))
    x = _t(grid).requires_grad_(True)
    out = tres.grid_sample(_t(vol), x)
    _close(out, ref, 1e-5, 1e-5)
    (gx,) = torch.autograd.grad(out, x, _t(g))
    # the coordinate gradient scales by (S-1)/2 per axis: f32 rounding of
    # the un-normalisation shows at ~1e-5 relative
    _close(gx, gref, 1e-4, 1e-4)
