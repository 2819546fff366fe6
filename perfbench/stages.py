"""Device time per stage of the program's step, read from the program's own
stage spans: the ``record_function`` ranges the port opens while a
profiler records (``ir_sgmcmc_tpu_torch/utils/spans.py``), on the same
clock and in the same trace as the device's kernels.

The charging rule, for each kernel, memcpy and memset of the traced steps:

1. its ``correlation`` leads to the CUDA runtime (or driver) call that
   launched it;
2. a launch inside an ``autograd::engine::evaluate_function`` event on its
   own thread belongs to the stage of the forward op that carries the
   event's ``Sequence number``: every stage holds its own backward.  This
   is checked first, since the backward runs inside the ``update`` span;
3. otherwise the launch belongs to the innermost stage span around it on
   its own thread or, on a thread without stage spans (the autograd
   engine's), to the innermost one around its time on any thread: the
   ``grad`` call's seed and accumulation kernels fall in ``update``;
4. anything else is unstaged.

The ``Trace`` that ``run.py`` hands the readers keeps no correlation ids,
thread ids of launches or event args, so :func:`of_run` profiles the run's
own entry once more, after the run's trace (the readers are called from
``run.run_cell``, whose ``program`` it calls), and keeps the whole Chrome
trace.  A program without stage spans (a tree before them) reads None in
every stage.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
from collections import defaultdict

import torch

from . import trace

# a copy of the port's ``utils/spans.py`` names (a test holds it equal)
PREFIX = "ir."
STAGES = ("smooth", "integrate", "warp", "likelihood", "regulariser", "update", "bookkeeping")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
EVALUATE = "autograd::engine::evaluate_function"


def _seq(e):
    return (e.get("args") or {}).get("Sequence number")


def _innermost(intervals, times) -> list:
    """For each time, the innermost of the nested ``(start, end, payload)``
    intervals that holds it (ends included), or None."""
    ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    out = [None] * len(times)
    stack, i = [], 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while i < len(ivs) and ivs[i][0] <= t:
            stack.append(ivs[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[k] = stack[-1] if stack else None
    return out


class _Spans:
    """Stage spans per thread, asked for the stage around times on one
    thread, with any thread's spans for a thread that has none."""

    def __init__(self, events):
        self.by_tid = defaultdict(list)
        self.host = []  # as ``trace.Trace`` holds host events
        for e in events:
            name = e["name"]
            if e.get("cat") == "user_annotation" and name.startswith(PREFIX) \
                    and name[len(PREFIX):] in STAGES:
                stage = name[len(PREFIX):]
                self.by_tid[e.get("tid")].append((e["ts"], e["ts"] + e["dur"], stage))
                self.host.append((stage, e.get("tid"), e["ts"], e["dur"]))

    def at(self, tid, times) -> list:
        tids = [tid] if tid in self.by_tid else list(self.by_tid)
        found = [_innermost(self.by_tid[t], times) for t in tids]
        out = []
        for hits in zip(*found) if found else [()] * len(times):
            live = [h for h in hits if h is not None]
            out.append(max(live, key=lambda h: h[0])[2] if live else None)
        return out


def charge(events) -> dict:
    """The device events of a Chrome trace (``export_chrome_trace``'s
    ``traceEvents``) charged to the stages: ``{"stages": {stage: [us,
    events]}, "unstaged": [us, events], "total_us": …, "idle_s": {stage:
    s}}``, ``idle_s`` the device's idle gaps by the innermost stage span
    around each gap's middle (``trace.Trace.idle_gaps`` over the stage
    spans alone; ``_no_host_event_`` outside them)."""
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    spans = _Spans(events)
    host = defaultdict(list)  # tid -> host events
    launches = {}
    device = []
    for e in events:
        cat, args = e.get("cat"), e.get("args") or {}
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = e
        if cat == "cpu_op":
            host[e.get("tid")].append(e)

    # evaluate_function events per thread; the forward ops (every op with a
    # sequence number but a node's own call inside its evaluate_function),
    # in time order, each with its stage: that of the backward node it ran
    # in (a backward that builds a graph of its own), else its span's
    evaluates, ops = {}, []
    for tid, evs in host.items():
        ev_iv = [(e["ts"], e["ts"] + e["dur"], e) for e in evs if e["name"].startswith(EVALUATE)]
        evaluates[tid] = ev_iv
        seq_ops = [e for e in evs if _seq(e) is not None and not e["name"].startswith(EVALUATE)]
        times = [e["ts"] for e in seq_ops]
        for e, ev, stage in zip(seq_ops, _innermost(ev_iv, times), spans.at(tid, times)):
            if ev is None or _seq(ev[2]) != _seq(e):
                ops.append((e["ts"], _seq(e), ev, stage))
    forward = defaultdict(list)  # sequence number -> [(time, stage)]

    def linked(ev):
        """The stage of the forward op behind a backward event: the latest
        op with its sequence number that began before it."""
        found = forward.get(_seq(ev))
        if not found:
            return None
        i = bisect.bisect_right([t for t, _ in found], ev["ts"]) - 1
        return found[i][1] if i >= 0 else None

    for t, seq, ev, stage in sorted(ops, key=lambda x: x[0]):
        forward[seq].append((t, (linked(ev[2]) if ev is not None else None) or stage))

    stage_of = [None] * len(device)
    by_tid = defaultdict(list)  # tid -> [(device index, launch time)]
    for k, e in enumerate(device):
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is not None:
            by_tid[launch.get("tid")].append((k, launch["ts"]))
    for tid, hits in by_tid.items():
        times = [t for _, t in hits]
        inside = _innermost(evaluates.get(tid, []), times)
        around = spans.at(tid, times)
        for (k, _), ev, stage in zip(hits, inside, around):
            stage_of[k] = (linked(ev[2]) if ev is not None else None) or stage

    timeline = trace.Trace([(e["name"], e["ts"], e["dur"]) for e in device], spans.host, 1, 0.0)
    out = {"stages": {s: [0.0, 0] for s in STAGES}, "unstaged": [0.0, 0],
           "total_us": sum(e["dur"] for e in device), "idle_s": dict(timeline.idle_gaps())}
    for e, stage in zip(device, stage_of):
        acc = out["stages"][stage] if stage is not None else out["unstaged"]
        acc[0] += e["dur"]
        acc[1] += 1
    return out


def record(call, steps: int, device) -> list:
    """The Chrome trace's events of ``steps`` profiled calls, after one
    profiled warm-up call that is not kept (``trace.record``'s schedule)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                           else [])
    sched = schedule(wait=0, warmup=1, active=steps, repeat=1)
    with profile(activities=activities, schedule=sched) as prof:
        call()
        sync()
        prof.step()
        for _ in range(steps):
            call()
        sync()
        prof.step()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            data = json.load(fh)
    finally:
        os.unlink(path)
    return data["traceEvents"] if isinstance(data, dict) else data


def _run_entry():
    """``(program, device)`` of the ``run.run_cell`` call that is reading
    its metrics, or None outside one."""
    frame = sys._getframe(1)
    while frame is not None:
        if frame.f_code.co_name == "run_cell" and "program" in frame.f_locals:
            return frame.f_locals["program"], frame.f_locals["device"]
        frame = frame.f_back
    return None


def of_run(ctx):
    """The run's steps charged to the stages (:func:`charge`, with
    ``steps``), profiled once per run and kept on ``ctx``; None where the
    run has no trace or no program to profile."""
    if "stages" not in vars(ctx):
        entry = _run_entry() if ctx.trace is not None else None
        ctx.stages = None
        if entry is not None:
            program, device = entry
            ctx.stages = dict(charge(record(program.call, ctx.trace.steps, device)),
                              steps=ctx.steps)
            _report(ctx.stages)
    return ctx.stages


def _report(charged) -> None:
    """Each stage's device ms, events and idle ms per step, on stderr."""
    n = charged["steps"]
    rows = list(charged["stages"].items()) + [("unstaged", charged["unstaged"])]
    total = charged["total_us"] or 1.0
    for name, (us, count) in rows:
        idle = charged["idle_s"].get("_no_host_event_" if name == "unstaged" else name, 0.0)
        print(f"[perfbench stages] {name}: {us * 1e-3 / n:.4f} ms/step "
              f"({100.0 * us / total:.2f}%), {count / n:.1f} events/step, "
              f"idle {idle * 1e3 / n:.4f} ms/step", file=sys.stderr, flush=True)


def ms_per_step(ctx, phase: str, stage: str):
    """Device ms per step charged to ``stage``; None where the stage
    launched nothing or the run has nothing to read."""
    if ctx.phase != phase:
        return None
    charged = of_run(ctx)
    if charged is None:
        return None
    us, count = charged["stages"][stage]
    return us * 1e-3 / charged["steps"] if count else None
