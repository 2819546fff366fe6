"""What the port counts without a card: each kernel's least work and bound
at the main paths' shapes, and the device on which the entry points that
create state put it.

The byte counts are those of PERF.md's kernel table (each input read once,
each output written once, f32, or bf16 for the bf16 modes of B1/B2 and their z-halo modes); the bound is the larger of bytes over the
H100 SXM's 3.35 TB/s and flops over its 67 TFLOP/s f32 rate.  With no
``device`` argument, state goes to the CUDA card or the call raises: there
is no CPU fallback.  The CPU tests pass ``device="cpu"``.
"""

import pytest
import torch

from ir_sgmcmc_tpu_torch.kernels import all_kernels

N128 = (128, 128, 128)

# symbol: (main operand shape on its path, MB the function must move)
MAIN_PATH = {
    "split_warp_fwd": ((2, 3) + N128, 151),
    "split_warp_bwd": ((2, 3) + N128, 252),
    "block_warp_fwd": ((2, 1) + N128, 84),
    "block_warp_dgrad": ((2, 1) + N128, 134),
    "warp_bounded_fwd": ((2, 1) + N128, 84),
    "warp_bounded_dgrad": ((2, 1) + N128, 134),
    "warp_bounded_tblend": ((2, 1) + N128, 84),
    # the bf16 modes of B1 and B2 (2-byte words): half of f32's bytes
    "split_warp_fwd_bf16": ((2, 3) + N128, 75),
    "split_warp_bwd_bf16": ((2, 3) + N128, 126),
    # the z-halo modes of B5 and B6 at chip_smoke.py's R 1 slab shape: the
    # output's shape (the vol is 2R planes deeper; radius 0 counts none)
    "warp_bounded_fwd_zhalo": ((2, 1) + N128, 84),
    "warp_bounded_dgrad_zhalo": ((2, 1) + N128, 134),
    # B7's z-pad mode at chip_smoke.py's R 1 shape: g's shape (the output
    # is 2R planes deeper; radius 0 counts none)
    "warp_bounded_tblend_zpad": ((2, 1) + N128, 84),
    # the z-halo modes of B1-B4 at a slab of 2 shards of the main path's
    # volume: the output's shape (radius 0 counts no halo plane)
    "split_warp_fwd_zhalo": ((2, 3, 64, 128, 128), 75),
    "split_warp_bwd_zhalo": ((2, 3, 64, 128, 128), 126),
    "block_warp_fwd_zhalo": ((2, 1, 64, 128, 128), 42),
    "block_warp_dgrad_zhalo": ((2, 1, 64, 128, 128), 67),
    # the bf16 z-halo modes of B1 and B2 at the same slab: half of f32's
    "split_warp_fwd_zhalo_bf16": ((2, 3, 64, 128, 128), 38),
    "split_warp_bwd_zhalo_bf16": ((2, 3, 64, 128, 128), 63),
    # the Taylor squaring forward (d in, d' out) and backward (d, g in, ḡ out)
    "taylor_square_fwd": ((2, 3) + N128, 101),
    "taylor_square_bwd": ((2, 3) + N128, 151),
    # the residual map at the pair cells' 8 rows, one fixed image per row:
    # forward (fixed, warped in; res, dm, s out), backward (g, dm, s in; ḡ out)
    "lcn_residual_fwd": ((8, 1) + N128, 336),
    "lcn_residual_bwd": ((8, 1) + N128, 268),
}


def test_kernel_table_covers_every_kernel():
    assert [k.symbol for k in all_kernels()] == list(MAIN_PATH)


@pytest.mark.parametrize("symbol", list(MAIN_PATH))
def test_kernel_bytes_and_bound(symbol):
    kernel = next(k for k in all_kernels() if k.symbol == symbol)
    shape, mb = MAIN_PATH[symbol]
    nbytes = kernel.bytes(shape)
    assert round(nbytes / 1e6) == mb
    ms, by = kernel.bound_ms(shape)
    assert by == "bytes"  # every kernel here is far below the f32 rate's ratio
    assert ms == pytest.approx(1e3 * nbytes / 3.35e12, rel=1e-12)
    assert kernel.flops(shape) / 67e12 < nbytes / 3.35e12 / 5
    # the counts scale with the voxels
    B, C, D, H, W = shape
    assert kernel.bytes((2 * B, C, D, H, W)) == pytest.approx(2 * nbytes, rel=1e-9)


@pytest.mark.parametrize("symbol", ["warp_bounded_fwd_zhalo", "warp_bounded_dgrad_zhalo",
                                    "warp_bounded_tblend_zpad", "block_warp_fwd_zhalo",
                                    "block_warp_dgrad_zhalo", "split_warp_fwd_zhalo",
                                    "split_warp_bwd_zhalo", "split_warp_fwd_zhalo_bf16",
                                    "split_warp_bwd_zhalo_bf16"])
@pytest.mark.parametrize("radius", [1, 2])
def test_zhalo_kernel_bytes_count_the_halo_planes(symbol, radius):
    """A z-halo kernel reads ``2R`` more vol planes than its output has, and
    B7's z-pad mode writes ``2R`` more output planes than g has:
    ``4·B·C·2R·H·W`` bytes beyond the mode without them (B3Z/B4Z: ``R`` is
    the window's halo ``h``).  B1Z reads the halo planes of d and u
    (``4·(C+3)`` bytes per voxel of a plane), and B2Z also writes its two
    gradients there (twice that); their bf16 modes move half of that."""
    from ir_sgmcmc_tpu_torch.kernels import block_warp as bw
    from ir_sgmcmc_tpu_torch.kernels import split_warp as sw
    from ir_sgmcmc_tpu_torch.kernels import warp_bounded as wb

    kernel = next(k for k in all_kernels() if k.symbol == symbol)
    plain = {"warp_bounded_fwd_zhalo": wb.B5, "warp_bounded_dgrad_zhalo": wb.B6,
             "warp_bounded_tblend_zpad": wb.B7, "block_warp_fwd_zhalo": bw.B3,
             "block_warp_dgrad_zhalo": bw.B4, "split_warp_fwd_zhalo": sw.B1,
             "split_warp_bwd_zhalo": sw.B2, "split_warp_fwd_zhalo_bf16": sw.B1_BF16,
             "split_warp_bwd_zhalo_bf16": sw.B2_BF16}[symbol]
    C = 3 if symbol.startswith("split") else 4
    shape = (2, C, 32, 24, 40)
    per_plane_voxel = {"split_warp_fwd_zhalo": 4 * (C + 3),
                       "split_warp_bwd_zhalo": 8 * (C + 3),
                       "split_warp_fwd_zhalo_bf16": 2 * (C + 3),
                       "split_warp_bwd_zhalo_bf16": 4 * (C + 3)}.get(symbol, 4 * C)
    extra = 2 * per_plane_voxel * 2 * radius * 24 * 40
    assert kernel.bytes(shape, radius) == plain.bytes(shape) + extra
    assert plain.bytes(shape, radius) == plain.bytes(shape)  # no halo, no planes
    assert kernel.bound_ms(shape, radius)[0] == pytest.approx(
        1e3 * (plain.bytes(shape) + extra) / 3.35e12, rel=1e-12)


def _c_entries():
    """``{name: [kind of each argument]}`` of every ``extern "C"`` function
    in ``csrc/*.cu``; a kind is ``"pointer"`` or ``"int"``."""
    import re

    from ir_sgmcmc_tpu_torch.kernels import _lib

    entries = {}
    for src in sorted(_lib.CSRC.glob("*.cu")):
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            kinds = []
            for arg in args.split(","):
                decl = " ".join(arg.split())
                assert re.fullmatch(r"(const )?(float|int|void)\*? ?\*? ?\w+", decl), decl
                kinds.append("pointer" if "*" in decl else "int")
            assert name not in entries, f"{name} declared twice"
            entries[name] = kinds
    return entries


def test_ctypes_signatures_match_the_c_entries():
    """Each ``extern "C"`` entry of the sources has its ctypes signature in
    ``_lib._SIGNATURES`` with the same count and kind of arguments (and no
    signature names a missing entry): a mismatch would pass pointers as
    ints, or shift every argument, only on the card."""
    import ctypes

    from ir_sgmcmc_tpu_torch.kernels import _lib

    entries = _c_entries()
    assert set(entries) == set(_lib._SIGNATURES)
    kind = {ctypes.c_void_p: "pointer", ctypes.c_int: "int"}
    for name, kinds in entries.items():
        assert [kind[t] for t in _lib._SIGNATURES[name]] == kinds, name
    # every kernel's entry point is one of them
    assert {k.symbol for k in all_kernels()} <= set(entries)


def _bundle():
    from ir_sgmcmc_tpu_torch.engine import ModelBundle
    from ir_sgmcmc_tpu_torch.models import (GMM, SVF3D, DirichletPrior,
                                            LogScaleNormalPrior, RegLossLogNormal)

    dims = (8, 8, 8)
    return ModelBundle(dims=dims, gmm=GMM(4, 1),
                       scale_prior=LogScaleNormalPrior(0.0, 2.3),
                       proportion_prior=DirichletPrior(4, 0.5),
                       reg_loss=RegLossLogNormal(w_reg=1.4, dims=dims, learnable=True),
                       transformation=SVF3D(dims))


def _init_chains(b, **kw):
    from ir_sgmcmc_tpu_torch.engine import init_chains
    from ir_sgmcmc_tpu_torch.optim import adam_decay

    dev = kw.get("device", "cuda" if torch.cuda.is_available() else "cpu")
    gen = torch.Generator(device=dev).manual_seed(0)
    return init_chains(b, gen, 2, "noise", None, b.gmm.init_params(dev),
                       b.reg_loss.init_params(dev), adam_decay(0.2, 1e-3),
                       adam_decay({"loc": 0.01, "log_scale": 0.01}, 1e-3), **kw).v


def _entry_points():
    """name -> call(**kw) returning one tensor of the state it creates."""
    from ir_sgmcmc_tpu_torch.engine.mcmc import welford_init
    from ir_sgmcmc_tpu_torch.models import RegLossL2
    from ir_sgmcmc_tpu_torch.ops.grids import identity_grid

    return {
        "init_chains": lambda **kw: _init_chains(_bundle(), **kw),
        "welford_init": lambda **kw: welford_init(2, (3, 4, 4, 4), **kw).mean,
        "init_q_v": lambda **kw: _bundle().init_q_v(0.5, 0.1, **kw)["mu"],
        "gmm_init_params": lambda **kw: _bundle().gmm.init_params(**kw)["logits"],
        "reg_lognormal_init_params":
            lambda **kw: _bundle().reg_loss.init_params(**kw)["loc"],
        "reg_l2_init_params":
            lambda **kw: RegLossL2(1.4, dims=(4, 4, 4)).init_params(**kw)["log_w_reg"],
        "identity_grid": lambda **kw: identity_grid((4, 5, 6), **kw),
    }


ENTRY_POINTS = list(_entry_points())


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_state_defaults_to_the_card(name):
    """No device: on the card where there is one, else a RuntimeError that
    says how to ask for the CPU."""
    call = _entry_points()[name]
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_state_on_the_cpu_when_asked(name):
    assert _entry_points()[name](device="cpu").device.type == "cpu"


def test_convert_and_noise_follow_the_device():
    """The state converters take the same default; the uniform noise
    takes its generator's device."""
    import numpy as np

    from ir_sgmcmc_tpu_torch.convert import (mcmc_state_from_numpy, mcmc_state_to_numpy,
                                             vi_state_from_numpy)
    from ir_sgmcmc_tpu_torch.engine import init_chains
    from ir_sgmcmc_tpu_torch.models.sampler import uniform_voxel_noise
    from ir_sgmcmc_tpu_torch.optim import adam_decay

    noise = uniform_voxel_noise(torch.Generator().manual_seed(1), (3, 4, 4, 4), 0.1)
    assert noise.device.type == "cpu" and float(noise.abs().max()) <= 0.1
    b = _bundle()
    state = init_chains(b, torch.Generator().manual_seed(0), 2, "identity", None,
                        b.gmm.init_params("cpu"), b.reg_loss.init_params("cpu"),
                        adam_decay(0.2, 1e-3),
                        adam_decay({"loc": 0.01, "log_scale": 0.01}, 1e-3), device="cpu")
    tree = mcmc_state_to_numpy(state)
    back = mcmc_state_from_numpy(tree, device="cpu")
    assert back.v.device.type == "cpu"
    np.testing.assert_array_equal(back.v.numpy(), tree["v"])
    if not torch.cuda.is_available():
        for convert in (mcmc_state_from_numpy, vi_state_from_numpy):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                convert(tree)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_operands_at_a_storage_offset(dtype):
    """The selftest's B1/B2 operands at ``offset`` 1 (the misaligned entry
    of ``SPLIT_SHAPES``, which takes the bf16 kernels' 2-byte staging) are
    contiguous views 1 element into a larger buffer, with the values of
    the aligned draw, and the plain versions take them."""
    from ir_sgmcmc_tpu_torch import selftest as st
    from ir_sgmcmc_tpu_torch.kernels import split_warp as sw

    shape, slab, offset = next(e for e in st.SPLIT_SHAPES if e[2])
    shape = shape[:2] + (4,) + shape[3:]  # the same (y, x) plane, fewer z-planes
    aligned = st.split_operands(torch.Generator().manual_seed(3), shape, slab, dtype)
    shifted = st.split_operands(torch.Generator().manual_seed(3), shape, slab, dtype, offset)
    for a, s in zip(aligned, shifted):
        assert s.dtype == dtype and s.is_contiguous() and s.storage_offset() == offset
        assert s.untyped_storage().nbytes() == (s.numel() + offset) * s.element_size()
        assert torch.equal(a, s)
    d, u, g = shifted
    assert torch.equal(sw.split_compose_plain(d, u), sw.split_compose_plain(*aligned[:2]))
    for x, y in zip(sw.split_warp_vjp_plain(d, u, g), sw.split_warp_vjp_plain(*aligned)):
        assert torch.equal(x, y)
