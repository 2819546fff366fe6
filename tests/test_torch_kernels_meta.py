"""What the port counts without a card: each kernel's least work and bound
at the main paths' shapes, and the device on which the entry points that
create state put it.

The byte counts are those of PERF.md's kernel table (each input read once,
each output written once, f32); the bound is the larger of bytes over the
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
    # the z-halo modes of B5 and B6 at chip_smoke.py's R 1 slab shape: the
    # output's shape (the vol is 2R planes deeper; radius 0 counts none)
    "warp_bounded_fwd_zhalo": ((2, 1) + N128, 84),
    "warp_bounded_dgrad_zhalo": ((2, 1) + N128, 134),
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


@pytest.mark.parametrize("symbol", ["warp_bounded_fwd_zhalo", "warp_bounded_dgrad_zhalo"])
@pytest.mark.parametrize("radius", [1, 2])
def test_zhalo_kernel_bytes_count_the_halo_planes(symbol, radius):
    """A z-halo kernel reads ``2R`` more vol planes than its output has:
    ``4·B·C·2R·H·W`` bytes beyond the mode without a halo."""
    from ir_sgmcmc_tpu_torch.kernels import warp_bounded as wb

    kernel = next(k for k in all_kernels() if k.symbol == symbol)
    plain = wb.B5 if symbol.startswith("warp_bounded_fwd") else wb.B6
    shape = (2, 4, 32, 24, 40)
    extra = 4 * 2 * 4 * 2 * radius * 24 * 40
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
