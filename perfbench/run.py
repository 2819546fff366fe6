"""One run of one benchmark cell of ``ir_sgmcmc_tpu_torch`` on the CUDA card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is a ``workloads`` entry of ``BENCHMARK.json``; its files are
found by name: ``perfbench/configs/<config>.json`` (the reference's
experiment config as it is run), ``perfbench/traffic/<traffic>.json`` (the
mix: phase, pairs, chains, noise scheme, burn-in and thin, the start),
``perfbench/limits/<workload>.json`` (the comparison's limits) and, with
``--trace 1``, ``perfbench/metrics/<metric>.py`` for each per-layer
metric the cell reports.

A run sets up (inputs from the seed, the program's objects, the cell's
first steps through the window's own call, which build and warm every
kernel), then calls that entry back to back for ``--seconds`` (a closed
loop, as the trainer runs), then with ``--trace 1`` profiles a few more
calls, and last compares the first steps with the plain reference
(``check.py``).  Stage times go to stderr; the last line of stdout is the
result's JSON object.  Without a CUDA card, with fewer cards than the cell
asks for, or if JAX or the JAX package was loaded, it exits non-zero and
prints no result.

A cell whose configuration cuts its step along D over ``s`` cards
(``drive.spatial_shards``) asks for ``s`` chips and runs on ``cuda:0 …
cuda:s-1``: after each call the first card's stream waits for every other
card before it records the call's mark, the window's closing synchronise
covers every card, the memory peak is the fullest card's, and the
reference runs its rows in turn on the cell's cards.
"""

from __future__ import annotations

import time

T0 = time.monotonic()  # process start, as near as a script can take it

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ir_sgmcmc_tpu")
# kernel caches of the program at fixed paths inside the checkout
CACHE = ROOT / ".perfbench_cache"


def stage(msg: str) -> None:
    print(f"[perfbench +{time.monotonic() - T0:8.3f}s] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    jaxlib's, flax's or the JAX package's, compared whole."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def load_cell(workload: str, bench_path: Path = ROOT / "BENCHMARK.json") -> SimpleNamespace:
    """The cell's entry and its files, found by name; refuses a cell whose
    chips are not the devices its configuration cuts the step over, and a
    sharded cell of more than one pair."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from perfbench import drive

    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {bench_path.name}: {sorted(cells)}")
    cell = cells[workload]
    base = bench_path.parent / "perfbench"
    config_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    limits_path = base / "limits" / f"{workload}.json"

    def applies(metric) -> bool:
        return workload in metric.get("workloads", [workload])

    config = json.loads((bench_path.parent / config_entry["file"]).read_text())
    traffic = json.loads((base / "traffic" / f"{cell['traffic']}.json").read_text())
    shards = drive.spatial_shards(drive.configured(config, traffic), traffic["phase"])
    if int(cell["chips"]) != shards:
        raise SystemExit(f"{workload} asks for {cell['chips']} chip(s); its configuration cuts "
                         f"{traffic['phase']} over {shards}")
    if shards > 1 and int(traffic["pairs"]) != 1:
        raise SystemExit(f"{workload}: a spatially sharded step takes one image pair, the "
                         f"traffic has {traffic['pairs']}")
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    reported = {m["name"] for m in e2e}
    # a metric without a list of cells is reported wherever the metric it moves is
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return SimpleNamespace(
        bench=bench, cell=cell, name=workload, config=config, traffic=traffic, shards=shards,
        limits=json.loads(limits_path.read_text()) if limits_path.exists() else {},
        end_to_end=e2e, per_layer=per_layer,
        readers={m["name"]: base / "metrics" / f"{m['name']}.py" for m in per_layer})


def load_reader(path: Path):
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _quantile(values, q: float) -> float:
    """Linear interpolation between order statistics."""
    s = sorted(values)
    pos = q * (len(s) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def run_cell(spec: SimpleNamespace, seed: int, seconds: float, traced: bool, devices,
             dims=None, fault=None, compute_dtype=None, tf32=False) -> dict:
    """One run of the cell; returns the result object (``device`` as
    ``torch.device``).  ``devices``: the cell's device, or a list of one
    for each shard of its step, the main one first (a list may repeat a
    device: virtual shards).  The configurations state float32 with TF32
    off, and the run holds the program to it.  ``dims``, ``fault``, ``compute_dtype`` and ``tf32`` are
    for the harness's own tests and the calibration of the limits."""
    import torch

    from perfbench import check, drive, trace, work

    devices = list(devices) if isinstance(devices, (list, tuple)) else [devices]
    device = devices[0]
    cuda = device.type == "cuda"
    cards = list(dict.fromkeys(devices))  # each device once, the first first
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(tf32)

    def sync():
        if cuda:
            for card in cards:
                torch.cuda.synchronize(card)

    def peaks(what: str) -> int:
        """The fullest card's memory peak; each card's on stderr."""
        if not cuda:
            return 0
        each = [torch.cuda.max_memory_allocated(card) for card in cards]
        stage(f"{what}: memory peak per card (GiB) "
              + ", ".join(f"{c}: {b / 2 ** 30:.3f}" for c, b in zip(cards, each)))
        return max(each)

    def join():
        """The first card's stream waits for the work queued on the others."""
        for card in cards[1:]:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(card))
            torch.cuda.current_stream(cards[0]).wait_event(done)

    traffic = spec.traffic
    cfg = drive.configured(spec.config, traffic, dims, compute_dtype)
    import ir_sgmcmc_tpu_torch  # noqa: F401
    stage("import: the program")
    if cuda:
        from ir_sgmcmc_tpu_torch.kernels import _lib

        _lib.load_library()
        stage(f"library: the kernels loaded (build {_lib.build_seconds:.3f}s)")
    from perfbench import reference

    model_dims = tuple(cfg["data_loader"]["args"]["dims"])
    ref_model = reference.Model(cfg, device)
    inputs = drive.Inputs(seed, traffic, model_dims, ref_model.field_dims, device)
    sync()
    stage(f"inputs: {len(inputs.pairs)} phantom pair(s) at {model_dims}")
    program = drive.Program(cfg, traffic, inputs, devices, fault=fault)
    if program.mesh is not None and inputs.v0 is not None:
        inputs.v0 = inputs.v0.cpu()  # placed: the reference's copy waits on the host
    sync()
    stage("bundle: the program's model, optimisers, state and entry"
          + (f" (VI remat {'on' if program.remat else 'off'})" if program.phase == "vi" else "")
          + (f" over {program.mesh}" if program.mesh is not None else ""))
    record = check.Record()
    record.leaves0 = program.leaves()
    if program.phase == "vi":
        program.gmm_warmup()
        sync()
        stage("gmm warm-up")
    for k in range(int(traffic["check_steps"])):
        record.losses.append(program.call())
        if k == 0:
            record.moments1, record.leaves1 = program.first_moments(), program.leaves()
        sync()
        stage(f"warm step {k + 1}")
    record.leaves_end = program.leaves()
    setup_s = time.monotonic() - T0
    setup_peak = peaks("set-up")

    # the window: the entry called back to back, every call between two events
    steps_per_call = int(traffic["steps_per_call"])
    if cuda:
        for card in cards:
            torch.cuda.reset_peak_memory_stats(card)
        marks = [torch.cuda.Event(enable_timing=True)]
        marks[0].record()
    calls = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        program.call()
        calls += 1
        if cuda:
            join()
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
    sync()
    wall = time.perf_counter() - t0
    window_peak = peaks("window")
    per_call_ms = ([a.elapsed_time(b) for a, b in zip(marks, marks[1:])] if cuda else
                   [1e3 * wall / calls] * calls)
    steps = calls * steps_per_call
    stage(f"window: {steps} steps in {wall:.3f}s")

    rows_per_step = (int(traffic["pairs"]) * int(traffic.get("chains", 1))
                     if program.phase == "mcmc" else int(traffic["pairs"]))
    finite = program.finite_rows()
    failed = int(steps * rows_per_step * (1.0 - float(finite.float().mean())))
    measured = {
        "setup_s": (setup_s, "s"),
        "mcmc_samples_per_s": (rows_per_step * steps / wall, "samples/s"),
        "mcmc_transition_ms_p95": (_quantile([t / steps_per_call for t in per_call_ms], 0.95), "ms"),
        "vi_iters_per_s": (rows_per_step * steps / wall, "iters/s"),
    }
    result_device = {"platform": "gpu" if cuda else "cpu",
                     "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                     "count": len(cards), "memory_peak_bytes": max(setup_peak, window_peak)}
    out = {"correct": False, "attempted": steps * rows_per_step, "failed": failed, "metrics": {}}

    if traced:
        rec = trace.record(program.call, int(traffic["trace_steps"]), cards)
        stage(f"trace: {rec.steps} calls, {len(rec.device)} device events")
        for card, n in sorted(rec.events_per_card().items()):
            stage(f"trace: card {card}: {n / (rec.steps * steps_per_call):.1f} events/step, "
                  f"busy {rec.busy_s(card):.6f}s of {rec.window_s:.6f}s")
        pairs, chains = int(traffic["pairs"]), int(traffic.get("chains", 1))
        rows = work.rows_per_launch(program.phase, pairs, chains, program.remat)
        shards = len(devices)
        least = work.least_step_s(program.phase, cfg, pairs, chains, len(cards))
        stage(f"step_mfu: the step's least time {least[0] * 1e3:.4f} ms, bound by {least[1]}")
        ctx = SimpleNamespace(phase=program.phase, trace=rec, steps=rec.steps * steps_per_call,
                              untraced_step_s=wall / steps, window_peak_bytes=window_peak,
                              shapes=work.kernel_shapes(program.phase, rows, model_dims, shards),
                              least_step_s=least, shards=shards,
                              window=ref_model.block_bound + ref_model.block_radius + 1)
        for m in spec.per_layer:
            value = load_reader(spec.readers[m["name"]])(ctx)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result_device.update(busy_s=rec.busy_s(), window_s=rec.window_s)
        out["breakdown"] = trace.breakdown(rec)
    else:
        for m in spec.end_to_end:
            value, unit = measured[m["name"]]
            out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    out["device"] = result_device

    # the comparison, after the peak is read and the program's state freed
    del program
    if cuda:
        torch.cuda.empty_cache()  # every card's
        for card in cards:
            torch.cuda.reset_peak_memory_stats(card)
    t_check = time.monotonic()
    found = check.numbers(spec.traffic["phase"], cfg, traffic, inputs, record, devices)
    sync()
    stage(f"check: the reference in {time.monotonic() - t_check:.3f}s; worst at {found['_where']}")
    peaks("check: the reference")
    out["where"] = found["_where"]
    out["correct"], out["checked"] = check.judge(found, spec.limits)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    spec = load_cell(args.workload)
    import torch

    stage(f"import: torch {torch.__version__}")
    if not torch.cuda.is_available():
        print("perfbench: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(spec.cell["chips"]):
        print(f"perfbench: {args.workload} needs {spec.cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(spec.shards)]
    torch.cuda.set_device(devices[0])
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), devices)
    loaded = forbidden_modules()
    if loaded:
        print(f"perfbench: forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    for name, c in out["checked"].items():
        print(f"perfbench: {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"perfbench: correct {out['correct']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
