"""The harness on the CPU at 64³: the result's keys, the comparison on
sound and broken runs, the check against JAX, the reference's imports, the
frozen counts and the trace reduction."""

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from perfbench import layers, run, trace, work

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 977


def _run(workload, fault=None):
    """The cell at 64³ with 2 pairs (the pair-stacked path, at a size the
    CPU holds)."""
    spec = run.load_cell(workload)
    spec.traffic["pairs"] = 2
    return run.run_cell(spec, SEED, 0.1, False, torch.device("cpu"), dims=(64, 64, 64),
                        fault=fault)


@pytest.mark.parametrize("workload", ["exp5_svffd2_128.mcmc_pairs4", "exp3_svf128.vi_pairs4"])
def test_sound_run_is_correct_and_keeps_the_result_shape(workload):
    out = _run(workload)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checked"
    assert out["correct"] is True, out["checked"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in out["checked"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "tile", "dgrad_tile"])
@pytest.mark.parametrize("workload", ["exp5_svffd2_128.mcmc_pairs4", "exp3_svf128.vi_pairs4"])
def test_a_broken_step_is_not_correct(workload, fault):
    """A step that returns its state unchanged, one whose forward chain
    hands half of the batch the other half's residuals, one whose
    residuals hold a wrong 8³ tile, or one whose block warp's gradient by
    the displacement does, fails a number."""
    out = _run(workload, fault)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checked"].values())


def _remat_run(monkeypatch, fault=None):
    """The 256³ VI cell at 64³ with ``trainer.vi_remat`` on: the rows run
    in turn under recompute, as the cell runs them at its own size.  64³ is
    the least size at which the ``"post"`` warp is the block warp (8 blocks
    along every axis), the cell's warp and the one ``dgrad_tile`` breaks."""
    import ir_sgmcmc_tpu_torch.engine as engine

    seen = []
    real = engine.make_vi_step

    def make_vi_step(*args, **kwargs):
        seen.append(kwargs.get("remat"))
        return real(*args, **kwargs)

    monkeypatch.setattr(engine, "make_vi_step", make_vi_step)
    spec = run.load_cell("exp3_svf256.vi_pair1")
    spec.config["trainer"]["vi_remat"] = True
    out = run.run_cell(spec, SEED, 0.1, False, torch.device("cpu"), dims=(64, 64, 64),
                       fault=fault)
    assert seen == [True]
    return out


@pytest.mark.parametrize("fault", [None, "half_sample", "tile", "dgrad_tile"])
def test_remat_vi_is_correct_and_a_broken_step_is_not(monkeypatch, fault):
    out = _remat_run(monkeypatch, fault)
    assert out["correct"] is (fault is None), out["checked"]


def test_the_half_batch_fault_leaves_one_row_as_it_is(monkeypatch):
    """Under remat every forward call takes one row, and the half-batch
    fault then changes nothing: a cell whose rows run in turn cannot be
    calibrated on it."""
    from ir_sgmcmc_tpu_torch.engine import mcmc, vi

    from perfbench import drive

    def forward(*args, **kwargs):
        return {"residuals": args[0]}

    monkeypatch.setattr(vi, "forward_sample", forward)
    monkeypatch.setattr(mcmc, "forward_sample", forward)
    one, two = torch.randn(1, 4, 8, 8, 8), torch.randn(2, 4, 8, 8, 8)
    with drive.half_batch_fault():
        assert torch.equal(vi.forward_sample(one)["residuals"], one)
        assert not torch.equal(vi.forward_sample(two)["residuals"], two)
    assert vi.forward_sample is forward


def test_the_trim_never_hides_a_non_finite_element():
    import math

    from perfbench import check

    ref = {"v[0]": torch.ones(100_000, dtype=torch.float64)}
    prog = {"v[0]": ref["v[0]"].clone()}
    prog["v[0]"][7] = 1e6  # one element of 1e5: within the trim's share
    assert check._worst(prog, ref)[0] == 0.0
    prog["v[0]"][7] = float("nan")
    assert check._worst(prog, ref) == (math.inf, "v[0]")


@pytest.mark.parametrize("name, flagged", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("ir_sgmcmc_tpu", True), ("ir_sgmcmc_tpu.ops.stencil", True),
    ("ir_sgmcmc_tpu_torch", False), ("ir_sgmcmc_tpu_torch.engine", False), ("jaxtyping", False)])
def test_forbidden_modules_by_whole_top_level_name(monkeypatch, name, flagged):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name in run.forbidden_modules()) is flagged


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.reference, perfbench.check, perfbench.phantom, perfbench.work, "
            "perfbench.trace, perfbench.layers; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('ir_sgmcmc_tpu_torch', 'ir_sgmcmc_tpu', 'jax', 'jaxlib')))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_no_card_no_result(tmp_path):
    """Without a card the run exits non-zero and prints nothing on stdout,
    also from a directory with only the benchmark's files."""
    (tmp_path / "perfbench").mkdir()
    for p in (ROOT / "perfbench").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            dst = tmp_path / p.relative_to(ROOT)
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_bytes(p.read_bytes())
    (tmp_path / "BENCHMARK.json").write_bytes((ROOT / "BENCHMARK.json").read_bytes())
    for cwd in (ROOT, tmp_path):
        proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                               "exp3_svf128.vi_pairs4", "--seed", "1", "--seconds", "1", "--trace", "0"],
                              cwd=cwd, capture_output=True, text=True,
                              env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
        assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.parametrize("kind, shape, bytes_, flops", [
    ("B1", (1, 3, 2, 2, 2), 8 * 4 * 9, 8 * 57),
    ("B2", (1, 3, 2, 2, 2), 8 * 4 * 15, 8 * 117),
    ("B3", (2, 1, 8, 8, 8), 1024 * (4 * 5 + 12 / 512), 1024 * 39),
    ("B4", (2, 1, 8, 8, 8), 1024 * (4 * 8 + 12 / 512), 1024 * 80)])
def test_frozen_kernel_bounds(kind, shape, bytes_, flops):
    want = 1e3 * max(bytes_ / work.HBM_BYTES_PER_S, flops / work.F32_FLOP_PER_S)
    assert work.kernel_bound_ms(kind, shape) == pytest.approx(want, rel=1e-12)
    # the copy agrees with the port's formulas it was taken from
    from ir_sgmcmc_tpu_torch.kernels import block_warp, split_warp

    port = {"B1": split_warp.B1, "B2": split_warp.B2, "B3": block_warp.B3, "B4": block_warp.B4}
    assert port[kind].bound_ms(shape)[0] == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("kind, radius", [("B1Z", 1), ("B2Z", 1), ("B3Z", 12), ("B4Z", 12)])
@pytest.mark.parametrize("shape", [(2, 3, 128, 512, 512), (2, 1, 128, 512, 512),
                                   (2, 3, 16, 64, 64), (1, 1, 64, 256, 256)])
def test_frozen_zhalo_kernel_bounds(kind, radius, shape):
    """The z-halo modes' copies agree with the port's ``Kernel.bound_ms`` at
    a card's slab (experiment 3 at 512³ over 4 cards, and smaller), halo
    planes included."""
    from ir_sgmcmc_tpu_torch.kernels import block_warp, split_warp

    port = {"B1Z": split_warp.B1Z, "B2Z": split_warp.B2Z, "B3Z": block_warp.B3Z,
            "B4Z": block_warp.B4Z}
    want = port[kind].bound_ms(shape, radius)[0]
    assert work.kernel_bound_ms(kind, shape, radius) == pytest.approx(want, rel=1e-12)
    assert work.kernel_bound_ms(kind, shape, radius) > work.kernel_bound_ms(kind, shape)
    trace_kind = kind[:2]
    assert work.launch_bound_ms(trace_kind, shape, 4, 12) == pytest.approx(want, rel=1e-12)
    assert work.launch_bound_ms(trace_kind, shape) == work.kernel_bound_ms(trace_kind, shape)


def test_a_sharded_step_takes_each_cards_slab():
    dims = (512, 512, 512)
    shapes = work.kernel_shapes("mcmc", 2, dims, shards=4)
    assert shapes["B1"] == shapes["B2"] == (2, 3, 128, 512, 512)
    assert shapes["B3"] == shapes["B4"] == (2, 1, 128, 512, 512)
    assert work.kernel_shapes("mcmc", 2, dims) == work.kernel_shapes("mcmc", 2, dims, shards=1)
    spec = run.load_cell("exp3_svf256.mcmc_pair1")
    one, four = (work.least_step_s("mcmc", spec.config, 1, 2, shards=s) for s in (1, 4))
    assert four == (pytest.approx(one[0] / 4, rel=1e-12), one[1])


def test_kernel_shapes_take_the_rows_of_one_launch():
    """One row per launch where VI runs its rows in turn (remat); else every
    row of the forward chain, as the 128³ cells' shapes have always been."""
    dims = (256, 256, 256)
    assert work.rows_per_launch("vi", 1, 1, remat=True) == 1
    assert work.rows_per_launch("vi", 4, 1, remat=True) == 1
    assert work.rows_per_launch("vi", 4, 1, remat=False) == 8
    assert work.rows_per_launch("mcmc", 4, 2, remat=False) == 8
    assert work.rows_per_launch("mcmc", 1, 2, remat=False) == 2
    shapes = work.kernel_shapes("vi", work.rows_per_launch("vi", 1, 1, remat=True), dims)
    assert shapes["B1"] == shapes["B2"] == (1, 3) + dims
    assert shapes["B3"] == shapes["B4"] == (1, 1) + dims
    assert work.kernel_shapes("vi", 8, (128,) * 3)["B1"] == (8, 3, 128, 128, 128)


def test_frozen_step_work():
    spec = run.load_cell("exp3_svf128.mcmc_pairs4")
    cfg = json.loads(json.dumps(spec.config))
    cfg["data_loader"]["args"]["dims"] = [16, 16, 16]
    n = 16 ** 3
    chain = n * (30 * 9 + 60 * 7 + 43 + 22 + 36) + 27 * n
    per_row = 3 * 3 * 7 * 2 * n + 3 * chain + n * (47 + 72)
    assert work.step_work("mcmc", cfg, 4, 2) == (8 * (per_row + 18 * n + 21 * n),
                                                 8 * (4 * 3 * n * 3 + 4 * 3 * n * 4 + 9 * n))
    assert work.step_work("vi", cfg, 1, 2) == (2 * (per_row + 39 * n) + 108 * n,
                                               2 * 9 * 4 * 3 * n + 9 * n)
    assert work.least_step_s("mcmc", spec.config, 4, 2)[1] == "operations"


def _trace():
    device = [("void split_fwd_kernel<float, false>", 0.0, 10.0),
              ("vectorized_elementwise_kernel<4, add>", 10.0, 5.0),
              ("reduce_kernel<128, 4>", 30.0, 10.0)]
    host = [("aten::mul", 1, 0.0, 40.0), ("cudaLaunchKernel", 1, 20.0, 5.0),
            ("autograd::engine", 2, 0.0, 100.0)]
    return trace.Trace(device, host, steps=1, window_s=50e-6)


def test_trace_reduction():
    t = _trace()
    assert t.busy_s() == pytest.approx(25e-6)
    assert dict(t.idle_gaps()) == {"cudaLaunchKernel": pytest.approx(15e-6)}
    b = trace.breakdown(t)
    assert b["device_ops"][0][0].startswith("void split_fwd_kernel")
    assert [g[0] for g in b["idle_gaps"]] == ["cudaLaunchKernel"]


def test_one_card_reads_as_without_the_card():
    """Events that carry their card, on one card, read as before."""
    t = _trace()
    carded = trace.Trace([e + (3,) for e in t.device], t.host, steps=1, window_s=50e-6,
                         cards=[3])
    assert carded.device == t.device and carded.busy_s() == t.busy_s()
    assert carded.idle_gaps() == t.idle_gaps()
    assert trace.breakdown(carded) == trace.breakdown(t)


def test_trace_reduction_per_card():
    """Busy time per card and its mean; idle gaps and the breakdown name the
    card."""
    device = [("void split_fwd_kernel<float, false>", 0.0, 10.0, 0),
              ("reduce_kernel<128, 4>", 30.0, 10.0, 0),
              ("void split_fwd_kernel<float, false>", 5.0, 30.0, 1)]
    host = [("cudaLaunchKernel", 1, 20.0, 5.0)]
    t = trace.Trace(device, host, steps=1, window_s=50e-6, cards=[0, 1])
    assert t.busy_s(0) == pytest.approx(20e-6) and t.busy_s(1) == pytest.approx(30e-6)
    assert t.busy_s() == pytest.approx(25e-6)
    assert t.events_per_card() == {0: 2, 1: 1}
    assert t.idle_gaps("each") == {"cuda:0 cudaLaunchKernel": pytest.approx(20e-6)}
    b = trace.breakdown(t)
    assert b["device_ops"][0] == ["cuda:1 void split_fwd_kernel<float, false>",
                                  pytest.approx(30e-6)]
    assert [g[0] for g in b["idle_gaps"]] == ["cuda:0 cudaLaunchKernel"]
    ctx = SimpleNamespace(phase="mcmc", trace=t, steps=1, untraced_step_s=50e-6,
                          window_peak_bytes=2 ** 30, shapes={"B1": (1, 3, 2, 2, 2)},
                          least_step_s=(1e-6, "operations"), shards=2, window=12)
    assert layers.launches_per_step(ctx, "mcmc") == 3
    assert layers.plain_ops_ms_per_step(ctx, "mcmc") == pytest.approx(5e-3)
    assert layers.device_idle_share(ctx, "mcmc") == pytest.approx(50.0)
    assert layers.kernel_roofline(ctx, "mcmc") == pytest.approx(
        100 * 2 * work.kernel_bound_ms("B1Z", (1, 3, 2, 2, 2), 1) / 40e-3)


def test_readers():
    ctx = SimpleNamespace(phase="mcmc", trace=_trace(), steps=1, untraced_step_s=50e-6,
                          window_peak_bytes=2 ** 30, shapes={"B1": (1, 3, 2, 2, 2)},
                          least_step_s=(1e-6, "operations"))
    assert layers.launches_per_step(ctx, "mcmc") == 3
    assert layers.plain_ops_ms_per_step(ctx, "mcmc") == pytest.approx(15e-3)
    assert layers.kernel_roofline(ctx, "mcmc") == pytest.approx(
        100 * work.kernel_bound_ms("B1", (1, 3, 2, 2, 2)) / 10e-3)
    assert layers.device_idle_share(ctx, "mcmc") == pytest.approx(50.0)
    assert layers.peak_mem_gib(ctx, "mcmc") == 1.0
    assert layers.step_mfu(ctx, "mcmc") == pytest.approx(2.0)
    assert layers.launches_per_step(ctx, "vi") is None
    ctx.shapes = {}
    assert layers.kernel_roofline(ctx, "mcmc") is None  # nothing to read: no 0
