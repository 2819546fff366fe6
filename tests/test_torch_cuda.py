"""Port kernels on the card: B1-B7 against their plain versions, the
autograd Functions end to end, and the wrappers' operand checks.

Imports only torch and the port, so it runs on a GPU host without JAX:

    python -m pytest tests/test_torch_cuda.py -q

Every test carries the ``cuda`` marker; without a CUDA card it skips
(decided inside the fixture, never at import).  Tolerances are the JAX
suite's for the same kernels.  Offsets avoid exact ties at u = 0 and
|u| = 1, where autograd of the plain step and the kernels take different
subgradients.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _split_inputs(dev, shape=(2, 3, 16, 24, 40)):
    gen = torch.Generator(device=dev).manual_seed(0)
    d = torch.randn(shape, generator=gen, device=dev) * 2.0
    u = torch.randn(shape, generator=gen, device=dev) * 0.9
    u = torch.where(u.abs() == 1, u * 1.001, u)
    u = torch.where(u == 0, torch.full_like(u, 1e-3), u)
    g = torch.randn(shape, generator=gen, device=dev)
    return d, u, g


def _block_inputs(dev, shape=(2, 2, 16, 24, 40), bound=9, radius=2, block=8, saturate=False):
    """vol, r, m, g; every 5th residual an integer.  ``saturate``: block
    means of ±bound in the blocks next to the z and x borders, whose source
    windows clamp, and every 9th residual exactly +R, every 11th -R."""
    from ir_sgmcmc_tpu_torch.kernels import block_warp as bw
    from ir_sgmcmc_tpu_torch.ops.resample import _block_means

    gen = torch.Generator(device=dev).manual_seed(1)
    vol = torch.randn(shape, generator=gen, device=dev)
    disp = torch.randn((shape[0], 3) + shape[2:], generator=gen, device=dev) + 3.0
    if saturate:
        disp[:, :, :block] = bound + 0.4
        disp[:, :, -block:] = -bound - 0.4
        disp[..., -block:] = torch.where(disp[..., -block:] < 0, -bound - 0.4, bound + 0.4)
    m = _block_means(disp, block, bound)
    r = (disp - bw._expand_blocks(m, block).float()).clamp(-radius, radius)
    flat = r.view(-1)
    flat[::5] = torch.round(flat[::5])  # integer residuals
    if saturate:
        flat[1::9] = radius
        flat[2::11] = -radius
    return vol, r, m, torch.randn(shape, generator=gen, device=dev)


# (shape, bound, radius, block, saturate): the path's shape, ragged shapes
# whose dims divide by 8 but are neither cubes nor multiples of the window
# kernels' 32-wide tile, R 3, block 4 (the per-voxel kernels), then R 3 over
# 4 channels (the largest window, 176.6 KB), R 0 (the per-voxel kernels) and
# the SVFFD path's R 3 at 64³
BLOCK_SHAPES = [((2, 2, 16, 24, 40), 9, 2, 8, False), ((2, 1, 128, 128, 128), 9, 2, 8, False),
                ((1, 4, 16, 24, 136), 6, 1, 8, True), ((2, 2, 24, 8, 40), 9, 2, 8, True),
                ((1, 2, 16, 16, 72), 9, 3, 8, True), ((2, 2, 12, 8, 20), 5, 2, 4, True),
                ((1, 4, 16, 16, 64), 9, 3, 8, True), ((2, 2, 16, 24, 40), 9, 0, 8, False),
                ((2, 1, 64, 64, 64), 9, 3, 8, False)]


@pytest.mark.parametrize("shape,slab", [
    ((2, 3, 16, 24, 40), None), ((1, 3, 2, 9, 33), None), ((3, 3, 17, 10, 70), None),
    ((2, 3, 40, 24, 130), None), ((2, 3, 40, 24, 130), (14, 19))])
def test_split_kernels_match_plain(cuda, shape, slab):
    """B1/B2 on shapes that straddle the kernels' 32 x 8 (x, y) tiles and
    16-plane z-chunks; ``slab`` saturates ``u`` beyond ±1 (by 0.5 or more)
    everywhere in those z-planes, where the offset gradient must be 0."""
    from ir_sgmcmc_tpu_torch.kernels import split_warp as sw

    d, u, g = _split_inputs(cuda, shape)
    if slab is not None:
        z = slice(*slab)
        u[:, :, z] = torch.where(u[:, :, z] < 0, -1.5, 1.5) + u[:, :, z]
    torch.testing.assert_close(sw.split_warp_fwd_cuda(d, u), sw.split_compose_plain(d, u),
                               atol=2e-5, rtol=0)
    gd, gu = sw.split_warp_bwd_cuda(d, u, g)
    gd_p, gu_p = sw.split_compose_vjp_plain(d, u, g)
    torch.testing.assert_close(gd, gd_p, atol=3e-5, rtol=1e-4)
    torch.testing.assert_close(gu + g, gu_p, atol=3e-5, rtol=1e-4)
    if slab is not None:
        assert torch.equal(gu[:, :, z], torch.zeros_like(gu[:, :, z]))


@pytest.mark.parametrize("shape,bound,radius,block,saturate", BLOCK_SHAPES)
def test_block_kernels_match_plain(cuda, shape, bound, radius, block, saturate):
    """B3 and B4 against their plain versions; their window kernels at
    block 8 and R 1-3, their per-voxel kernels at block 4 and R 0."""
    from ir_sgmcmc_tpu_torch.kernels import block_warp as bw

    vol, r, m, g = _block_inputs(cuda, shape, bound, radius, block, saturate)
    if saturate:
        assert int(m.abs().max()) == bound
    torch.testing.assert_close(bw.block_warp_cuda(vol, r, m, radius, block),
                               bw.block_warp_plain(vol, r, m, block), atol=1e-5, rtol=0)
    torch.testing.assert_close(bw.block_warp_dgrad_cuda(vol, r, m, g, radius, block),
                               bw.block_warp_dgrad_plain(vol, r, m, g, block),
                               atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("shape,bound,radius,block,saturate", BLOCK_SHAPES[2:4])
def test_block_dgrad_is_deterministic(cuda, shape, bound, radius, block, saturate):
    """Two launches of B4 on the same inputs are bitwise equal."""
    from ir_sgmcmc_tpu_torch.kernels import block_warp as bw

    vol, r, m, g = _block_inputs(cuda, shape, bound, radius, block, saturate)
    first = bw.block_warp_dgrad_cuda(vol, r, m, g, radius, block)
    assert torch.equal(first, bw.block_warp_dgrad_cuda(vol, r, m, g, radius, block))


@pytest.mark.parametrize("shape,bound,radius,block,saturate", BLOCK_SHAPES[2:4])
def test_block_warp_fwd_is_deterministic(cuda, shape, bound, radius, block, saturate):
    """Two launches of B3 on the same inputs are bitwise equal."""
    from ir_sgmcmc_tpu_torch.kernels import block_warp as bw

    vol, r, m, _ = _block_inputs(cuda, shape, bound, radius, block, saturate)
    first = bw.block_warp_cuda(vol, r, m, radius, block)
    assert torch.equal(first, bw.block_warp_cuda(vol, r, m, radius, block))


@pytest.mark.parametrize("radius,block,kernel", [(2, 8, "fwd_window_kernel<2>"),
                                                 (3, 8, "fwd_window_kernel<3>"),
                                                 (0, 8, "block_warp_fwd_kernel"),
                                                 (2, 4, "block_warp_fwd_kernel")])
def test_block_warp_fwd_dispatch(cuda, radius, block, kernel):
    """B3 takes its window kernel at block 8 and R 1-3 and its per-voxel
    kernel otherwise: the one device kernel a launch runs, by name."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from ir_sgmcmc_tpu_torch.kernels import block_warp as bw

    vol, r, m, _ = _block_inputs(cuda, (1, 1, 16, 24, 40), 9, radius, block)
    bw.block_warp_cuda(vol, r, m, radius, block)  # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        bw.block_warp_cuda(vol, r, m, radius, block)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and kernel in names[0], names


def test_autograd_functions_on_card_match_cpu(cuda):
    """``split_compose_step`` and ``warp_block_gather`` (forward and both
    backward kernels, counted) on the card against the same ops on the CPU."""
    from ir_sgmcmc_tpu_torch.kernels import all_kernels
    from ir_sgmcmc_tpu_torch.ops.resample import warp_block_gather
    from ir_sgmcmc_tpu_torch.ops.stencil import split_compose_step

    d, u, g = _split_inputs(cuda)
    vol, _, _, gv = _block_inputs(cuda, shape=(2, 1, 16, 24, 40))
    disp = torch.randn((2, 3, 16, 24, 40), device=cuda) * 0.8 + 2.3
    before = [k.launches for k in all_kernels()]
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        dd, uu, xx = (t.to(dev).requires_grad_(True) for t in (d, u, disp))
        o = split_compose_step(dd, uu)
        w = warp_block_gather(vol.to(dev), xx, 9, 2, 8)
        grads = torch.autograd.grad((o * g.to(dev)).sum() + (w * gv.to(dev)).sum(),
                                    (dd, uu, xx))
        outs[dev.type] = [t.detach().cpu() for t in (o, w, *grads)]
    assert [k.launches - b for k, b in zip(all_kernels(), before)] == [1, 1, 1, 1, 0, 0, 0, 0, 0]
    for got, ref, atol in zip(outs["cuda"], outs["cpu"], (2e-5, 1e-5, 3e-5, 3e-5, 5e-4)):
        torch.testing.assert_close(got, ref, atol=atol, rtol=1e-4)


def _bounded_inputs(dev, shape, radius):
    """Displacements uniform in ±1.4R, every 7th an integer, every 11th
    exactly +R, every 13th -R."""
    gen = torch.Generator(device=dev).manual_seed(2)
    vol = torch.randn(shape, generator=gen, device=dev)
    disp = (torch.rand((shape[0], 3) + shape[2:], generator=gen, device=dev) * 2 - 1) * 1.4 * radius
    flat = disp.view(-1)
    flat[::7] = torch.round(flat[::7])
    flat[1::11] = radius
    flat[2::13] = -radius
    return vol, disp, torch.randn(shape, generator=gen, device=dev)


BOUNDED_SHAPES = [((2, 1, 16, 24, 40), 1), ((2, 4, 9, 10, 11), 2), ((1, 3, 5, 6, 7), 3),
                  ((2, 1, 40, 24, 130), 1), ((1, 2, 17, 10, 70), 2), ((1, 3, 2, 1, 9), 3),
                  ((2, 5, 10, 9, 35), 1), ((1, 2, 9, 12, 40), 4), ((1, 13, 5, 6, 7), 3),
                  ((2, 2, 20, 12, 100), 2), ((1, 1, 18, 9, 64), 3)]


@pytest.mark.parametrize("shape,radius", BOUNDED_SHAPES)
def test_bounded_kernels_match_plain(cuda, shape, radius):
    """B5-B7 against their plain versions; atol 1e-5 (the JAX suite's for
    these kernels) plus rtol 1e-5 for sums of up to 27·C products.

    The shapes straddle the 32 x 8 (x, y) tiles and 16-plane z-chunks of
    B5-B7, have dims of 1 and 2 at R 3 (the fold covers more than the
    volume), 5 channels (two channel chunks of B7), R 4 (B7's run-time-R
    kernel, the per-voxel gathers of B5 and B6) and 13 channels at R 3
    (rings of B5 and B6 over the shared memory: the per-voxel gathers).
    B5 stages 16-byte rows where W % 4 == 0 (widths 40, 100, 64) except in
    the tile that crosses the x-border, and 4-byte points at widths 130,
    70, 11, 35 and 7."""
    from ir_sgmcmc_tpu_torch.kernels import warp_bounded as wb

    vol, disp, g = _bounded_inputs(cuda, shape, radius)
    torch.testing.assert_close(wb.warp_bounded_fwd_cuda(vol, disp, radius),
                               wb.warp_bounded_plain(vol, disp, radius), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(wb.warp_bounded_dgrad_cuda(vol, disp, g, radius),
                               wb.warp_bounded_dgrad_plain(vol, disp, g, radius),
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(wb.warp_bounded_tblend_cuda(disp, g, radius),
                               wb.warp_bounded_tblend_plain(disp, g, radius),
                               atol=1e-5, rtol=1e-5)


# (output shape, radius): the vol is 2R planes deeper
ZHALO_SHAPES = [((2, 1, 16, 24, 40), 1), ((1, 4, 17, 10, 70), 2), ((2, 3, 5, 6, 7), 3),
                ((1, 2, 9, 12, 40), 4), ((1, 13, 5, 6, 7), 3), ((2, 1, 1, 9, 33), 2)]


@pytest.mark.parametrize("shape,radius", ZHALO_SHAPES)
def test_zhalo_kernels_match_plain(cuda, shape, radius):
    """The z-halo modes of B5 and B6 (vol ``2R`` planes deeper, no z clamp)
    against their plain versions, at the tolerance of the default mode:
    the rings at R 1-3 (4-byte staging at widths 70, 7 and 33), the
    per-voxel gathers at R 4 and at 13 channels, one output plane."""
    from ir_sgmcmc_tpu_torch.kernels import warp_bounded as wb

    B, C, D, H, W = shape
    vol, disp, g = _bounded_inputs(cuda, shape, radius)
    vol = torch.randn((B, C, D + 2 * radius, H, W), device=cuda)
    torch.testing.assert_close(wb.warp_bounded_fwd_cuda(vol, disp, radius, z_halo=True),
                               wb.warp_bounded_plain(vol, disp, radius, z_halo=True),
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(wb.warp_bounded_dgrad_cuda(vol, disp, g, radius, z_halo=True),
                               wb.warp_bounded_dgrad_plain(vol, disp, g, radius, z_halo=True),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("radius", [1, 2, 4])
def test_zhalo_slabs_concatenate_on_card(cuda, radius):
    """4 z-slabs through the z-halo kernels, each with its real neighbour
    rows (edge rows at the two ends), concatenate bitwise to the unsharded
    B5 and B6 launches: the same taps of the same values in the same
    order."""
    from ir_sgmcmc_tpu_torch.kernels import warp_bounded as wb

    shape = (2, 1, 32, 24, 40)
    vol, disp, g = _bounded_inputs(cuda, shape, radius)
    zpad = torch.nn.functional.pad(vol, (0, 0, 0, 0, radius, radius), mode="replicate")
    n = shape[2] // 4
    parts = [(zpad[:, :, z:z + n + 2 * radius].contiguous(), disp[:, :, z:z + n].contiguous(),
              g[:, :, z:z + n].contiguous()) for z in range(0, shape[2], n)]
    out = torch.cat([wb.warp_bounded_fwd_cuda(v, d, radius, z_halo=True) for v, d, _ in parts], 2)
    dg = torch.cat([wb.warp_bounded_dgrad_cuda(v, d, gg, radius, z_halo=True)
                    for v, d, gg in parts], 2)
    assert torch.equal(out, wb.warp_bounded_fwd_cuda(vol, disp, radius))
    assert torch.equal(dg, wb.warp_bounded_dgrad_cuda(vol, disp, g, radius))


@pytest.mark.parametrize("shape,radius", [((2, 1, 40, 24, 130), 1), ((1, 4, 17, 10, 70), 2),
                                          ((1, 2, 9, 12, 40), 4)])
def test_bounded_backward_kernels_are_deterministic(cuda, shape, radius):
    """Two launches of B6, and of B7, on the same inputs are bitwise equal
    (both are gathers: no atomics)."""
    from ir_sgmcmc_tpu_torch.kernels import warp_bounded as wb

    vol, disp, g = _bounded_inputs(cuda, shape, radius)
    for run in (lambda: wb.warp_bounded_dgrad_cuda(vol, disp, g, radius),
                lambda: wb.warp_bounded_tblend_cuda(disp, g, radius)):
        first = run()
        assert torch.equal(first, run())


@pytest.mark.parametrize("shape,radius", [((2, 1, 40, 24, 128), 1), ((1, 3, 17, 10, 100), 2)])
def test_warp_bounded_fwd_is_deterministic_on_both_stagings(cuda, shape, radius):
    """Two launches of B5 are bitwise equal, and equal to B5 on a copy of
    vol that is 4 bytes off 16-byte alignment (every point staged by 4
    bytes: the same taps in the same order)."""
    from ir_sgmcmc_tpu_torch.kernels import warp_bounded as wb

    vol, disp, _ = _bounded_inputs(cuda, shape, radius)
    first = wb.warp_bounded_fwd_cuda(vol, disp, radius)
    assert torch.equal(first, wb.warp_bounded_fwd_cuda(vol, disp, radius))
    shifted = torch.empty(vol.numel() + 1, device=cuda)[1:].view(shape)
    shifted.copy_(vol)
    assert shifted.data_ptr() % 16 == 4
    assert torch.equal(first, wb.warp_bounded_fwd_cuda(shifted, disp, radius))


def test_warp_bounded_autograd_on_card_matches_cpu(cuda):
    """``warp_bounded`` forward and both cotangents on the card (B5, B6, B7,
    each counted once) against the same op on the CPU; a constant volume
    asks for no B7 launch."""
    from ir_sgmcmc_tpu_torch.kernels import warp_bounded as wb
    from ir_sgmcmc_tpu_torch.ops.resample import warp_bounded

    vol, disp, g = _bounded_inputs(cuda, (2, 4, 12, 13, 14), 1)
    before = [k.launches for k in (wb.B5, wb.B6, wb.B7)]
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        v, d = (t.to(dev).clone().requires_grad_(True) for t in (vol, disp))
        o = warp_bounded(v, d, 1)
        outs[dev.type] = [t.detach().cpu() for t in (o, *torch.autograd.grad(o, (v, d), g.to(dev)))]
    assert [k.launches - b for k, b in zip((wb.B5, wb.B6, wb.B7), before)] == [1, 1, 1]
    for got, ref in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    d = disp.clone().requires_grad_(True)
    before = wb.B7.launches
    torch.autograd.grad(warp_bounded(vol, d, 1).sum(), d)
    assert wb.B7.launches == before


def test_wrappers_reject_bad_operands(cuda):
    from ir_sgmcmc_tpu_torch.kernels import block_warp as bw
    from ir_sgmcmc_tpu_torch.kernels import split_warp as sw
    from ir_sgmcmc_tpu_torch.kernels import warp_bounded as wb

    d = torch.zeros((1, 3, 8, 8, 8), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sw.split_warp_fwd_cuda(d, d.transpose(-1, -2))
    with pytest.raises(ValueError, match="dtype"):
        sw.split_warp_fwd_cuda(d.double(), d.double())
    with pytest.raises(ValueError, match="C must be 3"):
        sw.split_warp_fwd_cuda(d[:, :2].contiguous(), d)
    m = torch.zeros((1, 3, 1, 1, 1), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        bw.block_warp_cuda(d[:, :1].contiguous(), d, m, 2)
    with pytest.raises(ValueError, match="radius"):
        bw.block_warp_cuda(d[:, :1].contiguous(), d, m.int(), -1)
    with pytest.raises(ValueError, match="shape"):
        wb.warp_bounded_fwd_cuda(d, d[:, :2].contiguous(), 1)
    with pytest.raises(ValueError, match="radius"):
        wb.warp_bounded_tblend_cuda(d, d, 0)
