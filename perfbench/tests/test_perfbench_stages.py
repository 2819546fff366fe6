"""The stage readers (``stages.py``): the copy of the port's stage names,
the charging rule on a hand-built Chrome trace, the readers beside the
others, and on the card each cell's traced steps charged to the stages."""

from types import SimpleNamespace

import pytest
import torch

from perfbench import drive, layers, run, stages, trace

MAIN, AUTOGRAD = 101, 202


def _x(name, cat, tid, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "pid": 1, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _fixture(spans=True):
    """One step: a forward kernel in ``integrate``, its backward reached
    through its sequence number, the gradient's seed and an accumulation
    in ``update``, and a memcpy outside every stage."""
    host = [
        _x("ir.mcmc_transition", "user_annotation", MAIN, 0.0, 1000.0),
        _x("ir.integrate", "user_annotation", MAIN, 10.0, 100.0),
        _x("aten::mul", "cpu_op", MAIN, 20.0, 50.0, **{"Sequence number": 7}),
        _x("cudaLaunchKernel", "cuda_runtime", MAIN, 30.0, 5.0, correlation=1),
        _x("ir.update", "user_annotation", MAIN, 200.0, 500.0),
        _x("aten::ones_like", "cpu_op", MAIN, 210.0, 10.0, **{"Sequence number": 9}),
        _x("cudaLaunchKernel", "cuda_runtime", MAIN, 212.0, 3.0, correlation=2),
        _x("autograd::engine::evaluate_function: MulBackward0", "cpu_op", AUTOGRAD, 300.0,
           50.0, **{"Sequence number": 7}),
        _x("MulBackward0", "cpu_op", AUTOGRAD, 301.0, 40.0, **{"Sequence number": 7}),
        _x("cudaLaunchKernel", "cuda_runtime", AUTOGRAD, 310.0, 5.0, correlation=3),
        _x("cudaLaunchKernel", "cuda_runtime", AUTOGRAD, 400.0, 5.0, correlation=4),
        _x("cudaMemcpyAsync", "cuda_runtime", MAIN, 800.0, 5.0, correlation=5),
    ]
    if not spans:
        host = [e for e in host if not e["name"].startswith(stages.PREFIX)]
    device = [
        _x("void mul_kernel", "kernel", "stream 7", 1000.0, 10.0, correlation=1),
        _x("void fill_kernel", "kernel", "stream 7", 1020.0, 2.0, correlation=2),
        _x("void mul_backward_kernel", "kernel", "stream 7", 1030.0, 20.0, correlation=3),
        _x("void add_kernel", "kernel", "stream 7", 1060.0, 4.0, correlation=4),
        _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", "stream 7", 1070.0, 1.0,
           correlation=5),
        {"ph": "f", "name": "fwdbwd", "cat": "fwdbwd", "id": 7, "ts": 301.0},
    ]
    return host + device


def test_the_stage_names_are_the_ports():
    from ir_sgmcmc_tpu_torch.utils import spans

    assert stages.STAGES == spans.STAGES and stages.PREFIX == spans.PREFIX


def test_the_charging_rule():
    out = stages.charge(_fixture())
    got = {s: tuple(v) for s, v in out["stages"].items() if v[1]}
    # the backward kernel goes to its forward op's stage, though it ran in
    # the update span; the seed and the accumulation to update
    assert got == {"integrate": (30.0, 2), "update": (6.0, 2)}
    assert tuple(out["unstaged"]) == (1.0, 1)
    assert out["total_us"] == 37.0
    assert sum(us for us, _ in out["stages"].values()) + out["unstaged"][0] == out["total_us"]
    # the gaps' middles (1015, 1026, 1055, 1067) fall outside every stage span
    assert out["idle_s"] == {"_no_host_event_": pytest.approx(34e-6)}


def test_a_recompute_is_charged_to_its_own_spans():
    """Under remat a backward node recomputes checkpointed forward code,
    which opens its stage spans again on the autograd thread: its launches
    go to those spans (and to ``recompute``), the node's own launches to
    its forward op's stage, and the autograd thread's launches outside any
    node and span to the span around them on the main thread."""
    host = [
        _x("ir.vi_step", "user_annotation", MAIN, 0.0, 1000.0),
        _x("ir.warp", "user_annotation", MAIN, 10.0, 100.0),
        _x("aten::grid_sampler_3d", "cpu_op", MAIN, 20.0, 50.0, **{"Sequence number": 7}),
        _x("cudaLaunchKernel", "cuda_runtime", MAIN, 30.0, 5.0, correlation=1),
        _x("ir.update", "user_annotation", MAIN, 200.0, 700.0),
        _x("autograd::engine::evaluate_function: GridSampler3DBackward0", "cpu_op", AUTOGRAD,
           300.0, 100.0, **{"Sequence number": 7}),
        _x("ir.integrate", "user_annotation", AUTOGRAD, 305.0, 40.0),
        _x("aten::mul", "cpu_op", AUTOGRAD, 310.0, 20.0, **{"Sequence number": 30}),
        _x("cudaLaunchKernel", "cuda_runtime", AUTOGRAD, 315.0, 5.0, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", AUTOGRAD, 360.0, 5.0, correlation=3),
        _x("cudaLaunchKernel", "cuda_runtime", AUTOGRAD, 500.0, 5.0, correlation=4),
    ]
    device = [
        _x("void grid_sampler_3d_kernel", "kernel", "stream 7", 1000.0, 10.0, correlation=1),
        _x("void mul_kernel", "kernel", "stream 7", 1020.0, 7.0, correlation=2),
        _x("void grid_sampler_3d_backward_kernel", "kernel", "stream 7", 1030.0, 20.0,
           correlation=3),
        _x("void add_kernel", "kernel", "stream 7", 1060.0, 4.0, correlation=4),
    ]
    out = stages.charge(host + device)
    got = {s: tuple(v) for s, v in out["stages"].items() if v[1]}
    assert got == {"warp": (30.0, 2), "integrate": (7.0, 1), "update": (4.0, 1)}
    assert tuple(out["recompute"]) == (7.0, 1) and tuple(out["unstaged"]) == (0.0, 0)
    # without spans on the autograd thread nothing counts as a recompute
    assert tuple(stages.charge(_fixture())["recompute"]) == (0.0, 0)


def test_a_program_without_spans_reads_none():
    out = stages.charge(_fixture(spans=False))
    assert all(count == 0 for _, count in out["stages"].values())
    ctx = SimpleNamespace(phase="mcmc", trace=None, steps=1,
                          stages=dict(out, steps=1))
    assert all(stages.ms_per_step(ctx, "mcmc", s) is None for s in stages.STAGES)


def _trace():
    device = [("void split_fwd_kernel<float, false>", 0.0, 10.0),
              ("vectorized_elementwise_kernel<4, add>", 10.0, 5.0),
              ("reduce_kernel<128, 4>", 30.0, 10.0)]
    host = [("aten::mul", 1, 0.0, 40.0), ("cudaLaunchKernel", 1, 20.0, 5.0),
            ("autograd::engine", 2, 0.0, 100.0)]
    return trace.Trace(device, host, steps=1, window_s=50e-6)


def test_the_readers_beside_the_others():
    """The stage readers read their own profile and leave the run's trace,
    and what the other readers make of it, as they were."""
    ctx = SimpleNamespace(phase="mcmc", trace=_trace(), steps=2, untraced_step_s=50e-6,
                          window_peak_bytes=2 ** 30, shapes={}, least_step_s=(1e-6, "operations"))
    readers = (layers.launches_per_step, layers.plain_ops_ms_per_step,
               layers.device_idle_share, layers.peak_mem_gib, layers.step_mfu)
    before = [r(ctx, "mcmc") for r in readers]
    device_before = list(ctx.trace.device)
    ctx.stages = dict(stages.charge(_fixture()), steps=2)
    assert stages.ms_per_step(ctx, "mcmc", "integrate") == pytest.approx(30e-3 / 2)
    assert stages.ms_per_step(ctx, "mcmc", "update") == pytest.approx(6e-3 / 2)
    assert stages.ms_per_step(ctx, "mcmc", "smooth") is None  # launched nothing: no 0
    assert stages.ms_per_step(ctx, "vi", "integrate") is None
    assert [r(ctx, "mcmc") for r in readers] == before
    assert ctx.trace.device == device_before


def test_no_run_no_stages():
    """Outside ``run.run_cell`` there is no entry to profile: None."""
    ctx = SimpleNamespace(phase="vi", trace=_trace(), steps=1)
    assert stages.ms_per_step(ctx, "vi", "warp") is None
    assert ctx.stages is None


def test_every_stage_has_its_reader():
    spec = run.load_cell("exp3_svf128.mcmc_pairs4")
    names = {m["name"] for m in spec.per_layer}
    assert {f"{s}_ms_per_step.mcmc" for s in stages.STAGES} <= names
    for s in stages.STAGES:
        read = run.load_reader(spec.readers[f"{s}_ms_per_step.mcmc"])
        ctx = SimpleNamespace(phase="mcmc", trace=None, steps=1,
                              stages=dict(stages.charge(_fixture()), steps=1))
        want = {"integrate": 30e-3, "update": 6e-3}.get(s)
        assert read(ctx) == (pytest.approx(want) if want else None)


CELLS = ["exp3_svf128.mcmc_pairs4", "exp5_svffd2_128.mcmc_pairs4", "exp3_svf128.vi_pairs4",
         "exp3_svf256.mcmc_pair1", "exp3_svf256.vi_pair1"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_step_is_charged_to_the_stages(cuda, workload):
    """At the cell's size: one traced step charges at least 98% of the
    device time to the stages, and the stages and the unstaged rest add up
    to the trace's total."""
    spec = run.load_cell(workload)
    cfg = drive.configured(spec.config, spec.traffic)
    from perfbench import reference

    dims = tuple(cfg["data_loader"]["args"]["dims"])
    inputs = drive.Inputs(3400000011, spec.traffic, dims, reference.Model(cfg, cuda).field_dims,
                          cuda)
    program = drive.Program(cfg, spec.traffic, inputs, cuda)
    if program.phase == "vi":
        program.gmm_warmup()
    for _ in range(3):
        program.call()
    events = stages.record(program.call, 1, cuda)
    out = stages.charge(events)
    staged = sum(us for us, _ in out["stages"].values())
    assert staged + out["unstaged"][0] == pytest.approx(out["total_us"], rel=1e-9)
    by_name = sum(e["dur"] for e in events
                  if e.get("ph") == "X" and e.get("cat") in trace.DEVICE_CATS)
    assert out["total_us"] == pytest.approx(by_name, rel=1e-9)
    assert staged >= 0.98 * out["total_us"], out
    assert all(count > 0 for _, count in out["stages"].values()), out["stages"]
