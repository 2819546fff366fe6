"""The z-halo modes of the bounded warp B5 and its displacement gradient B6:
the port's plain versions against the JAX package's, and the slab identity
that the spatially sharded steps of the JAX package rely on.

In z-halo mode the volume is ``(C, D + 2R, H, W)`` and carries ``R`` real
neighbour rows per side in z; a tap at output plane ``z``, offset ``o``
reads plane ``z + R + o`` with no z clamp, and y/x keep their edge
padding.  The JAX forms: the Pallas kernels with ``z_halo=True``
(interpret mode, at a shape they accept: W a multiple of 128), and at
ragged shapes the XLA forms ``parallel/halo.py::_warp_bounded_zhalo`` and
``ops/resample.py::_bwd_dgrads_xla(z_halo=True)``.  Tolerance 1e-5, the
JAX suite's for these kernels (tests/test_pallas_warp.py:30,68).
"""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

from ir_sgmcmc_tpu.ops.pallas_warp import warp_bounded_dgrad_pallas, warp_bounded_pallas
from ir_sgmcmc_tpu.ops.resample import _bwd_dgrads_xla
from ir_sgmcmc_tpu.parallel.halo import _warp_bounded_zhalo
from ir_sgmcmc_tpu_torch.kernels import warp_bounded as twb


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float32))


def _case(rng, chan, dims, radius):
    """vol with its z-halo ``(chan, D + 2R, H, W)``, disp and g at ``dims``;
    displacements uniform in ±1.4R with every 7th an integer, every 11th
    exactly +R and every 13th -R (the clip, the mask's ``<= R`` and the zero
    derivative at integers)."""
    D, H, W = dims
    vol = rng.standard_normal((chan, D + 2 * radius, H, W)).astype(np.float32)
    disp = ((rng.random((3,) + dims) * 2 - 1) * radius * 1.4).astype(np.float32)
    flat = disp.reshape(-1)
    flat[::7] = np.round(flat[::7])
    flat[1::11] = radius
    flat[2::13] = -radius
    g = rng.standard_normal((chan,) + dims).astype(np.float32)
    return vol, disp, g


def _port(vol, disp, g, radius):
    """The port's plain z-halo B5 and masked B6, unbatched."""
    v, d = _t(vol)[None], _t(disp)[None]
    out = twb.warp_bounded_fwd(v, d, radius, z_halo=True)[0]
    dg = twb.warp_bounded_dgrad(v, d, _t(g)[None], radius, z_halo=True)[0]
    return out, torch.where(torch.abs(_t(disp)) <= radius, dg, 0.0)


def _jax_arg(a, chan):
    return a[0] if chan == 1 else a


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("chan", [1, 4])
def test_zhalo_plain_matches_jax_pallas(radius, chan):
    """At a shape the Pallas kernels accept, against ``warp_bounded_pallas``
    and ``warp_bounded_dgrad_pallas`` with ``z_halo=True`` (interpret)."""
    rng = np.random.default_rng(30 + 2 * radius + chan)
    vol, disp, g = _case(rng, chan, (8, 8, 128), radius)
    out, dg = _port(vol, disp, g, radius)
    ref = np.asarray(warp_bounded_pallas(_jax_arg(vol, chan), disp, radius, interpret=True,
                                         z_halo=True))
    np.testing.assert_allclose(out.numpy(), ref.reshape(out.shape), atol=1e-5)
    gd = np.asarray(warp_bounded_dgrad_pallas(_jax_arg(vol, chan), disp, _jax_arg(g, chan),
                                              radius, interpret=True, z_halo=True))
    gd = np.where(np.abs(disp) <= radius, gd, 0.0)
    np.testing.assert_allclose(dg.numpy(), gd, atol=1e-5)


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("chan", [1, 4])
@pytest.mark.parametrize("dims", [(5, 7, 9), (1, 3, 2)])
def test_zhalo_plain_matches_jax_xla(radius, chan, dims):
    """At ragged shapes (one of them a single plane), against the XLA
    forms the JAX package's sharded steps run off the TPU."""
    rng = np.random.default_rng(40 + 2 * radius + chan + dims[0])
    vol, disp, g = _case(rng, chan, dims, radius)
    out, dg = _port(vol, disp, g, radius)
    ref = np.asarray(_warp_bounded_zhalo(_jax_arg(vol, chan), disp, radius))
    np.testing.assert_allclose(out.numpy(), ref.reshape(out.shape), atol=1e-5)
    gd = np.asarray(_bwd_dgrads_xla(_jax_arg(vol, chan), disp, radius, _jax_arg(g, chan),
                                    z_halo=True))
    np.testing.assert_allclose(dg.numpy(), gd, atol=1e-5)


@pytest.mark.parametrize("radius,chan", [(1, 1), (2, 4)])
def test_zhalo_slabs_concatenate_to_the_unsharded_warp(radius, chan):
    """The z-halo outputs of 4 z-slabs, each given its real neighbour rows
    (edge rows past the volume's two ends), concatenate to the unsharded
    B5 and B6 outputs: what the JAX package's halo exchange relies on."""
    rng = np.random.default_rng(50 + radius)
    dims = (16, 6, 10)
    vol = _t(rng.standard_normal((1, chan) + dims))
    disp = _t((rng.random((1, 3) + dims) * 2 - 1) * radius * 1.4)
    g = _t(rng.standard_normal((1, chan) + dims))
    full = twb.warp_bounded_fwd(vol, disp, radius)
    full_dg = twb.warp_bounded_dgrad(vol, disp, g, radius)
    zpad = torch.nn.functional.pad(vol, (0, 0, 0, 0, radius, radius), mode="replicate")
    n = dims[0] // 4
    outs, dgs = [], []
    for s in range(4):
        z0 = s * n
        slab = zpad[:, :, z0:z0 + n + 2 * radius].contiguous()
        d, gs = disp[:, :, z0:z0 + n], g[:, :, z0:z0 + n]
        outs.append(twb.warp_bounded_fwd(slab, d, radius, z_halo=True))
        dgs.append(twb.warp_bounded_dgrad(slab, d, gs, radius, z_halo=True))
    torch.testing.assert_close(torch.cat(outs, dim=2), full, atol=1e-6, rtol=0)
    torch.testing.assert_close(torch.cat(dgs, dim=2), full_dg, atol=1e-6, rtol=0)


def test_zhalo_wrappers_dispatch_by_device():
    """A CPU tensor takes the plain version, whose output has disp's depth;
    the CUDA wrappers refuse it."""
    vol = torch.zeros((1, 1, 8, 4, 4))
    disp = torch.zeros((1, 3, 6, 4, 4))
    assert twb.warp_bounded_fwd(vol, disp, 1, z_halo=True).shape == (1, 1, 6, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        twb.warp_bounded_fwd_cuda(vol, disp, 1, z_halo=True)
    with pytest.raises(ValueError, match="CUDA"):
        twb.warp_bounded_dgrad_cuda(vol, disp, torch.zeros((1, 1, 6, 4, 4)), 1, z_halo=True)
