"""Port kernels on the card: B1-B7 against their plain versions, the
autograd Functions end to end, and the wrappers' operand checks; B1/B2
also in their bf16 modes; the z-halo modes of B1-B7 (B1/B2 in f32 and
bf16), and the spatially sharded chunk on virtual shards of the card.

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


# bf16: the kernel and its plain version each compute in f32 and round once,
# so they part by the f32 difference plus at most one ulp (2^-7 of |x|)
BF16_ATOL = {"fwd": 2e-5, "bwd": 3e-5}
BF16_RTOL = 8e-3


def _bf16_inputs(dev, shape, slab=None, offset=0):
    """``_split_inputs`` in bf16, ``slab`` saturated, each operand a
    contiguous view at storage offset ``offset`` of a larger buffer."""
    from ir_sgmcmc_tpu_torch.selftest import _at_offset

    d, u, g = _split_inputs(dev, shape)
    if slab is not None:
        z = slice(*slab)
        u[:, :, z] = torch.where(u[:, :, z] < 0, -1.5, 1.5) + u[:, :, z]
    return tuple(_at_offset(t.to(torch.bfloat16), offset) for t in (d, u, g))


# the f32 kernels' shapes (W 40: a tile across the x border; 33, 70, 130: W
# not a multiple of 8, 2-byte staging), then W 64 (16-byte staging
# everywhere) and operands 2 bytes past a 16-byte boundary (2-byte staging)
BF16_SPLIT_SHAPES = [((2, 3, 16, 24, 40), None, 0), ((1, 3, 2, 9, 33), None, 0),
                     ((3, 3, 17, 10, 70), None, 0), ((2, 3, 40, 24, 130), None, 0),
                     ((2, 3, 40, 24, 130), (14, 19), 0), ((2, 3, 16, 24, 64), None, 0),
                     ((2, 3, 16, 24, 64), None, 1), ((2, 3, 16, 24, 40), None, 1)]


@pytest.mark.parametrize("shape,slab,offset", BF16_SPLIT_SHAPES)
def test_split_bf16_kernels_match_plain(cuda, shape, slab, offset):
    """B1-bf16/B2-bf16 against their plain versions (f32 arithmetic, one
    rounding) on both staging paths, ties included: bf16 rounding puts
    offsets at ``|u| = 1``, where both take no offset gradient.  In a
    saturated slab the offset gradient is exactly 0."""
    from ir_sgmcmc_tpu_torch.kernels import split_warp as sw

    d, u, g = _bf16_inputs(cuda, shape, slab, offset)
    assert d.storage_offset() == offset and d.is_contiguous()
    out = sw.split_warp_fwd_cuda(d, u)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), sw.split_compose_plain(d, u).float(),
                               atol=BF16_ATOL["fwd"], rtol=BF16_RTOL)
    gd, gu = sw.split_warp_bwd_cuda(d, u, g)
    gd_p, gu_p = sw.split_warp_vjp_plain(d, u, g)
    assert gd.dtype == gu.dtype == torch.bfloat16
    torch.testing.assert_close(gd.float(), gd_p.float(), atol=BF16_ATOL["bwd"], rtol=BF16_RTOL)
    torch.testing.assert_close(gu.float(), gu_p.float(), atol=BF16_ATOL["bwd"], rtol=BF16_RTOL)
    if slab is not None:
        z = slice(*slab)
        assert torch.equal(gu[:, :, z], torch.zeros_like(gu[:, :, z]))
    with pytest.raises(ValueError, match="dtype"):
        sw.split_warp_fwd_cuda(d, u.float())  # mixed dtypes


@pytest.mark.parametrize("shape,offset", [((2, 3, 16, 24, 64), 0), ((2, 3, 16, 24, 40), 0),
                                          ((2, 3, 16, 24, 64), 1)])
def test_split_bf16_kernels_deterministic(cuda, shape, offset):
    """B1-bf16 and B2-bf16 give the same bits run to run on both staging
    paths (no atomics; each output written by one thread)."""
    from ir_sgmcmc_tpu_torch.kernels import split_warp as sw

    d, u, g = _bf16_inputs(cuda, shape, offset=offset)
    first = (sw.split_warp_fwd_cuda(d, u),) + sw.split_warp_bwd_cuda(d, u, g)
    for _ in range(3):
        again = (sw.split_warp_fwd_cuda(d, u),) + sw.split_warp_bwd_cuda(d, u, g)
        for a, b in zip(first, again):
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))


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


@pytest.mark.parametrize("radius,block,h", [(1, 8, 0), (2, 8, 0), (3, 8, 0), (2, 4, 0),
                                             (2, 8, 12)])
def test_block_dgrad_at_tiny_negative_residuals(cuda, radius, block, h):
    """B4 (B4Z with ``h``) where a residual lies within ~2^-25 of 0: below
    0, ``r + 1`` rounds to 1, so the lower tap's ``dtri(r + 1)`` is 0 while
    the upper one's ``dtri(r)`` is +1; above 0, ``r - 1`` rounds to -1 and
    the upper tap's ``dtri`` is 0 while the lower one's is -1.  The kernels
    take both weights as the plain version rounds them (the window kernel
    once took the upper one as minus the lower one, off by a voxel
    difference there).  Residuals of ``±2^-27`` and ``±1e-9``, 4 of every
    6."""
    from ir_sgmcmc_tpu_torch.kernels import block_warp as bw

    shape = (2, 1, 16, 24, 40)
    vol, r, m, g = _block_inputs(cuda, shape, 9, radius, block)
    flat = r.view(-1)
    flat[::6] = -2.0 ** -27
    flat[1::6] = 2.0 ** -27
    flat[3::6] = -1e-9
    flat[4::6] = 1e-9
    if h:
        vol = torch.nn.functional.pad(vol, (0, 0, 0, 0, h, h), mode="replicate")
        out = bw.block_warp_dgrad_zhalo_cuda(vol, r, m, g, radius, h, block)
    else:
        out = bw.block_warp_dgrad_cuda(vol, r, m, g, radius, block)
    torch.testing.assert_close(out, bw.block_warp_dgrad_plain(vol, r, m, g, block, h),
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


@pytest.mark.parametrize("radius,block,kernel", [(2, 8, "fwd_window_kernel<2, false>"),
                                                 (3, 8, "fwd_window_kernel<3, false>"),
                                                 (0, 8, "block_warp_fwd_kernel<false>"),
                                                 (2, 4, "block_warp_fwd_kernel<false>")])
def test_block_warp_fwd_dispatch(cuda, radius, block, kernel):
    """B3 takes its window kernel at block 8 and R 1-3 and its per-voxel
    kernel otherwise: every device kernel that 16 launches run is that one,
    by name.  (One launch alone once left the profiler with no device event
    at all: 16 do not depend on CUPTI catching any single one.)"""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from ir_sgmcmc_tpu_torch.kernels import block_warp as bw

    vol, r, m, _ = _block_inputs(cuda, (1, 1, 16, 24, 40), 9, radius, block)
    bw.block_warp_cuda(vol, r, m, radius, block)  # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(16):
            bw.block_warp_cuda(vol, r, m, radius, block)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert names, "the profiler saw no device event in 16 launches"
    assert all(kernel in n for n in names), sorted(set(names))


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
    assert [k.launches - b for k, b in zip(all_kernels(), before)] == (
        [1, 1, 1, 1] + [0] * (len(before) - 4))
    for got, ref, atol in zip(outs["cuda"], outs["cpu"], (2e-5, 1e-5, 3e-5, 3e-5, 5e-4)):
        torch.testing.assert_close(got, ref, atol=atol, rtol=1e-4)


def test_split_autograd_bf16_on_card_matches_cpu(cuda):
    """``split_compose_step`` on bf16 operands (forward B1-bf16, backward
    B2-bf16, counted) on the card against the same op on the CPU: the
    output and ``ḡ_d`` within the bf16 kernels' tolerance, and ``ḡ_u`` on
    each device exactly its warp part plus ``g``, added in bf16."""
    from ir_sgmcmc_tpu_torch.kernels import split_warp as sw
    from ir_sgmcmc_tpu_torch.ops.stencil import split_compose_step

    d, u, g = (t.to(torch.bfloat16) for t in _split_inputs(cuda))
    before = (sw.B1_BF16.launches, sw.B2_BF16.launches, sw.B1.launches, sw.B2.launches)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        dd, uu = (t.to(dev).requires_grad_(True) for t in (d, u))
        o = split_compose_step(dd, uu)
        grads = torch.autograd.grad(o, (dd, uu), g.to(dev))
        assert all(t.dtype == torch.bfloat16 for t in (o, *grads))
        outs[dev.type] = [t.detach() for t in (o, *grads)]
    after = (sw.B1_BF16.launches, sw.B2_BF16.launches, sw.B1.launches, sw.B2.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 0, 0]
    for got, ref, atol in zip(outs["cuda"][:2], outs["cpu"][:2], (2e-5, 3e-5)):
        torch.testing.assert_close(got.cpu().float(), ref.float(), atol=atol, rtol=BF16_RTOL)
    gu_card = sw.split_warp_bwd_cuda(d, u, g)[1]
    gu_cpu = sw.split_warp_vjp_plain(d.cpu(), u.cpu(), g.cpu())[1]
    assert torch.equal(outs["cuda"][2], gu_card + g)
    assert torch.equal(outs["cpu"][2], gu_cpu + g.cpu())


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


@pytest.mark.parametrize("shape,radius", ZHALO_SHAPES)
def test_tblend_zpad_kernel_matches_plain(cuda, shape, radius):
    """B7's z-pad mode (B7Z: y/x folded, the 2R z pad planes kept, ``(B, C,
    D + 2R, H, W)``) against its plain version, at the default mode's
    tolerance: the tiled kernels at R 1-3 (one and 4-channel chunks, 13
    channels), the run-time-R kernel at R 4, one plane of g; and bitwise
    deterministic."""
    from ir_sgmcmc_tpu_torch.kernels import warp_bounded as wb

    _, disp, g = _bounded_inputs(cuda, shape, radius)
    out = wb.warp_bounded_tblend_cuda(disp, g, radius, z_pad=True)
    assert out.shape == shape[:2] + (shape[2] + 2 * radius,) + shape[3:]
    torch.testing.assert_close(out, wb.warp_bounded_tblend_zpad_plain(disp, g, radius),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(out, wb.warp_bounded_tblend_cuda(disp, g, radius, z_pad=True))


@pytest.mark.parametrize("radius,chan", [(1, 1), (2, 3)])
def test_halo_warp_on_virtual_shards_matches_unsharded(cuda, radius, chan):
    """``parallel.warp_bounded_sharded`` over 4 shards of one card: forward
    and both gradients against the unsharded ``warp_bounded`` (B5-B7) on
    the card, through B5Z, B6Z and B7Z (one launch per shard each)."""
    from ir_sgmcmc_tpu_torch.kernels import warp_bounded as wb
    from ir_sgmcmc_tpu_torch.ops.resample import warp_bounded
    from ir_sgmcmc_tpu_torch.parallel import gather, make_mesh, warp_bounded_sharded

    shape = (1, chan, 32, 24, 40)
    vol, disp, probe = _bounded_inputs(cuda, shape, radius)
    mesh = make_mesh(4, axes=("space",), devices=[cuda] * 4)
    kernels = (wb.B5Z, wb.B6Z, wb.B7Z)
    before = [k.launches for k in kernels]
    v, d = vol[0].clone().requires_grad_(True), disp[0].clone().requires_grad_(True)
    out = gather(warp_bounded_sharded(v, d, radius, mesh))
    g_v, g_d = torch.autograd.grad((out * probe[0]).sum(), [v, d])
    assert [k.launches - b for k, b in zip(kernels, before)] == [4, 4, 4]
    v1, d1 = vol.clone().requires_grad_(True), disp.clone().requires_grad_(True)
    ref = warp_bounded(v1, d1, radius)
    r_v, r_d = torch.autograd.grad((ref * probe).sum(), [v1, d1])
    for got, want in ((out, ref[0]), (g_v, r_v[0]), (g_d, r_d[0])):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


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


@pytest.mark.parametrize("shape", [(2, 3, 17, 24, 130), (1, 3, 4, 9, 33), (2, 3, 32, 16, 64)])
def test_split_zhalo_kernels_match_plain(cuda, shape):
    """B1Z and B2Z (B1/B2 on a slab with one halo plane on each side, no z
    clamp) against their plain versions; B2Z's ``ū`` with the direct
    term's ``+g`` on the interior planes."""
    from ir_sgmcmc_tpu_torch import selftest as st
    from ir_sgmcmc_tpu_torch.kernels import split_warp as sw

    gen = torch.Generator(device=cuda).manual_seed(11)
    d_h, u_h, g = st.split_zhalo_operands(gen, shape)
    torch.testing.assert_close(sw.split_warp_fwd_zhalo_cuda(d_h, u_h),
                               sw.split_compose_zhalo_plain(d_h, u_h), atol=2e-5, rtol=0)
    for got, want in zip(sw.split_compose_zhalo_vjp(d_h, u_h, g),
                         sw.split_compose_zhalo_vjp_plain(d_h, u_h, g)):
        torch.testing.assert_close(got, want, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("shape", [(2, 3, 17, 24, 130), (1, 3, 4, 9, 33), (2, 3, 32, 16, 64),
                                   (2, 3, 33, 24, 40)])
def test_split_zhalo_bf16_kernels_match_plain(cuda, shape):
    """B1Z-bf16 and B2Z-bf16 (the bf16 modes on a slab with one halo plane
    on each side) against their plain versions (f32 arithmetic, one
    rounding), on both staging paths (W 64: 16-byte copies; W 40: a tile
    across the x border; W 33/130: 2-byte loads), each output bf16; and
    bitwise the same run to run."""
    from ir_sgmcmc_tpu_torch import selftest as st
    from ir_sgmcmc_tpu_torch.kernels import split_warp as sw

    gen = torch.Generator(device=cuda).manual_seed(17)
    d_h, u_h, g = st.split_zhalo_operands(gen, shape, torch.bfloat16)
    out = sw.split_warp_fwd_zhalo_cuda(d_h, u_h)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == shape
    torch.testing.assert_close(out.float(), sw.split_compose_zhalo_plain(d_h, u_h).float(),
                               atol=BF16_ATOL["fwd"], rtol=BF16_RTOL)
    got = sw.split_warp_bwd_zhalo_cuda(d_h, u_h, g)
    for a, b in zip(got, sw.split_warp_vjp_zhalo_plain(d_h, u_h, g)):
        assert a.dtype == torch.bfloat16 and a.shape == d_h.shape
        torch.testing.assert_close(a.float(), b.float(), atol=BF16_ATOL["bwd"], rtol=BF16_RTOL)
    again = (sw.split_warp_fwd_zhalo_cuda(d_h, u_h),) + sw.split_warp_bwd_zhalo_cuda(d_h, u_h, g)
    for a, b in zip((out,) + got, again):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("slabs", [2, 4])
def test_split_zhalo_bf16_slabs_concatenate_on_card(cuda, slabs):
    """z-slabs through B1Z-bf16, each with its real neighbour planes,
    concatenate bitwise to B1-bf16 on the whole volume."""
    from ir_sgmcmc_tpu_torch import selftest as st
    from ir_sgmcmc_tpu_torch.kernels import split_warp as sw

    gen = torch.Generator(device=cuda).manual_seed(19)
    d, u, _ = st.split_operands(gen, (2, 3, 64, 24, 64), dtype=torch.bfloat16)
    dp, up = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 1, 1), mode="replicate")
              .to(torch.bfloat16) for t in (d, u))
    n = 64 // slabs
    out = torch.cat([sw.split_warp_fwd_zhalo_cuda(dp[:, :, z:z + n + 2].contiguous(),
                                                  up[:, :, z:z + n + 2].contiguous())
                     for z in range(0, 64, n)], 2)
    assert torch.equal(out.view(torch.int16), sw.split_warp_fwd_cuda(d, u).view(torch.int16))


@pytest.mark.parametrize("shape,bound,radius,block,h", [
    ((2, 1, 16, 24, 40), 9, 2, 8, 12), ((1, 4, 16, 24, 136), 6, 1, 8, 8),
    ((1, 2, 16, 16, 32), 5, 3, 8, 9), ((2, 1, 16, 16, 48), 9, 4, 8, 14),
    ((2, 2, 12, 8, 20), 5, 2, 4, 8)])
def test_block_zhalo_kernels_match_plain(cuda, shape, bound, radius, block, h):
    """B3Z and B4Z (window kernels at block 8, R 1-3; per-voxel kernels at
    R 4 and block 4) against their plain versions, with block means at
    ±bound next to the slab's z ends."""
    from ir_sgmcmc_tpu_torch import selftest as st
    from ir_sgmcmc_tpu_torch.kernels import block_warp as bw

    gen = torch.Generator(device=cuda).manual_seed(12)
    vol_h, r, m, g = st.block_zhalo_operands(gen, shape, bound, radius, block, h)
    torch.testing.assert_close(bw.block_warp_zhalo_cuda(vol_h, r, m, radius, h, block),
                               bw.block_warp_plain(vol_h, r, m, block, h), atol=1e-5, rtol=0)
    torch.testing.assert_close(bw.block_warp_dgrad_zhalo_cuda(vol_h, r, m, g, radius, h, block),
                               bw.block_warp_dgrad_plain(vol_h, r, m, g, block, h),
                               atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("slabs", [2, 4])
def test_split_and_block_zhalo_slabs_concatenate_on_card(cuda, slabs):
    """z-slabs through B1Z and B3Z/B4Z, each with its real neighbour planes
    (edge planes repeated at the two ends), concatenate bitwise to B1 and
    B3/B4 on the whole volume: the same taps of the same values."""
    from ir_sgmcmc_tpu_torch import selftest as st
    from ir_sgmcmc_tpu_torch.kernels import block_warp as bw
    from ir_sgmcmc_tpu_torch.kernels import split_warp as sw

    gen = torch.Generator(device=cuda).manual_seed(13)
    d, u, _ = st.split_operands(gen, (2, 3, 32, 24, 40))
    dp, up = (torch.nn.functional.pad(t, (0, 0, 0, 0, 1, 1), mode="replicate") for t in (d, u))
    n = 32 // slabs
    out = torch.cat([sw.split_warp_fwd_zhalo_cuda(dp[:, :, z:z + n + 2].contiguous(),
                                                  up[:, :, z:z + n + 2].contiguous())
                     for z in range(0, 32, n)], 2)
    assert torch.equal(out, sw.split_warp_fwd_cuda(d, u))
    vol, r, m, g = st.block_operands(gen, (2, 1, 64, 24, 40), 9, 2, saturate=True)
    h, n = 12, 64 // slabs
    vp = torch.nn.functional.pad(vol, (0, 0, 0, 0, h, h), mode="replicate")
    parts = [(vp[:, :, z:z + n + 2 * h].contiguous(), r[:, :, z:z + n].contiguous(),
              m[:, :, z // 8:(z + n) // 8].contiguous(), g[:, :, z:z + n].contiguous())
             for z in range(0, 64, n)]
    fw = torch.cat([bw.block_warp_zhalo_cuda(v, rr, mm, 2, h) for v, rr, mm, _ in parts], 2)
    dg = torch.cat([bw.block_warp_dgrad_zhalo_cuda(v, rr, mm, gg, 2, h)
                    for v, rr, mm, gg in parts], 2)
    assert torch.equal(fw, bw.block_warp_cuda(vol, r, m, 2))
    assert torch.equal(dg, bw.block_warp_dgrad_cuda(vol, r, m, g, 2))


def test_spatial_mcmc_chunk_on_virtual_shards_matches_unsharded(cuda):
    """A 64³ transition of ``bench.py``'s model cut along D over 2 shards of
    one card (a ``(1, 2)`` ``('chain', 'space')`` mesh) against the
    unsharded chunk on the card: B1Z 7, B2Z 7, B3Z 1, B4Z 1 launches per
    shard, B1-B4 none, and the state within 1e-5."""
    import math

    from ir_sgmcmc_tpu_torch.data import sphere_pair
    from ir_sgmcmc_tpu_torch.engine import ModelBundle, init_chains, make_mcmc_chunk
    from ir_sgmcmc_tpu_torch.kernels import all_kernels
    from ir_sgmcmc_tpu_torch.models import (GMM, SVF3D, DirichletPrior, LogEnergyExpGammaPrior,
                                            LogScaleNormalPrior, RegLossLogNormal)
    from ir_sgmcmc_tpu_torch.optim import adam_decay
    from ir_sgmcmc_tpu_torch.parallel import (gather, make_mesh, shard_images_spatial,
                                              shard_state_spatial)

    dims = (64, 64, 64)
    dof = 3.0 * math.prod(dims)
    b = ModelBundle(dims=dims, gmm=GMM(4, 1), scale_prior=LogScaleNormalPrior(0.0, 2.3),
                    proportion_prior=DirichletPrior(4, 0.5),
                    reg_loss=RegLossLogNormal(w_reg=1.4, dims=dims, learnable=True),
                    reg_loc_prior=LogEnergyExpGammaPrior(w_reg=1.4, dof=dof),
                    reg_scale_prior=LogScaleNormalPrior(loc=2.8, scale=5.0),
                    transformation=SVF3D(dims, no_steps=12), sobolev_s=3, sobolev_lambda=0.5,
                    uniform_noise_alpha=0.1, virtual_decimation=True)
    f, m = sphere_pair(dims, offset=(0.0, 0.0, 4.0))
    f = {k: torch.as_tensor(v, device=cuda) for k, v in f.items()}
    m = {k: torch.as_tensor(v, device=cuda) for k, v in m.items()}
    og, orr = adam_decay(0.2, 1e-3), adam_decay({"loc": 0.01, "log_scale": 0.01}, 1e-3)
    state = init_chains(b, torch.Generator(device=cuda).manual_seed(0), 2, "noise", None,
                        b.gmm.init_params(cuda), b.reg_loss.init_params(cuda), og, orr,
                        device=cuda)
    plain, m_plain = make_mcmc_chunk(b, og, orr, 1e-5, f, m, 2, 0, 1)(state)
    mesh = make_mesh((1, 2), axes=("chain", "space"), devices=[cuda, cuda])
    kernels = {k.symbol: k for k in all_kernels()}
    before = {s: k.launches for s, k in kernels.items()}
    out, m_out = make_mcmc_chunk(b, og, orr, 1e-5, shard_images_spatial(f, mesh, 64),
                                 shard_images_spatial(m, mesh, 64), 2, 0, 1)(
        shard_state_spatial(state, mesh, 2, 64))
    moved = {s: k.launches - before[s] for s, k in kernels.items()}
    assert moved["split_warp_fwd_zhalo"] == moved["split_warp_bwd_zhalo"] == 2 * 2 * 7
    assert moved["block_warp_fwd_zhalo"] == moved["block_warp_dgrad_zhalo"] == 2 * 2
    for sym in ("split_warp_fwd", "split_warp_bwd", "block_warp_fwd", "block_warp_dgrad"):
        assert moved[sym] == 0, sym
    whole = gather(out)
    torch.testing.assert_close(whole.v, plain.v, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(m_out["data_term"], m_plain["data_term"], atol=0, rtol=1e-5)


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


def test_selftest_module_passes(cuda):
    """``python -m ir_sgmcmc_tpu_torch.selftest`` exits 0 with a passing
    check of every kernel of ``all_kernels()``."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    from ir_sgmcmc_tpu_torch.kernels import all_kernels

    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-m", "ir_sgmcmc_tpu_torch.selftest"], cwd=str(repo),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] is True and out["platform"] == "gpu"
    checked = {name.split("@")[0].split("(")[0].split(".")[0] for name in out["checks"]}
    assert checked == {k.symbol for k in all_kernels()}
