"""A profiler trace of a few steps, reduced to what the per-layer readers
and the result's ``breakdown`` need.

The grouping of device events by kind is a copy of the ``KINDS`` table of
the port's ``scripts/trace_summary.py``: the pattern in the kernel's name
and its kind, the first match winning.

Every device event keeps the index of the card it ran on.  Busy time and
idle gaps are each card's own, and the trace's busy time is their mean over
the cards the run used; with more than one card the breakdown names the
card of each entry.  On one card every number is as it was without the
index.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import torch

KINDS = (("tblend_", "B7"), ("dgrad_tile", "B6"), ("dgrad_gather", "B6"),
         ("fwd_window", "B3"), ("fwd_tile", "B5"), ("warp_bounded_fwd", "B5"),
         ("split_fwd_kernel<__nv_bfloat16", "B1-bf16"), ("split_bwd_kernel<__nv_bfloat16", "B2-bf16"),
         ("split_fwd", "B1"),
         ("split_bwd", "B2"), ("block_warp_fwd", "B3"), ("dgrad_window", "B4"),
         ("block_warp_dgrad", "B4"), ("direct_copy", "copies"), ("CatArray", "copies"),
         ("Memcpy", "copies"), ("Memset", "copies"), ("reduce_kernel", "reductions"),
         ("gemm", "matmul"), ("xmma", "matmul"), ("elementwise", "elementwise"))
PLAIN = ("elementwise", "copies", "reductions")  # PyTorch's own kernels
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def kind_of(name: str) -> str:
    return next((k for pat, k in KINDS if pat in name), "other")


class Trace:
    """Device events ``(name, start_us, dur_us)`` of ``steps`` steps, the
    card of each (``card``, in the same order; ``cards``, every card the
    run used), the host events beside them, and the traced window's length.
    A device event may carry its card as a fourth item; without it, card
    0."""

    def __init__(self, device_events, host_events, steps: int, window_s: float, cards=None):
        events = sorted(device_events, key=lambda e: e[1])
        self.device = [tuple(e[:3]) for e in events]
        self.card = [int(e[3]) if len(e) > 3 else 0 for e in events]
        self.cards = sorted(set(cards) if cards is not None else set(self.card) or {0})
        if len(self.cards) == 1:  # one card: every event is that card's
            self.card = self.cards * len(events)
        self.host = host_events
        self.steps = steps
        self.window_s = window_s

    def events_per_card(self) -> dict:
        return {c: self.card.count(c) for c in self.cards}

    def busy_intervals(self, card=None) -> list:
        """The merged busy intervals of ``card`` (default: the first card)."""
        card = self.cards[0] if card is None else card
        merged = []
        for (_, t, d), c in zip(self.device, self.card):
            if c != card:
                continue
            if merged and t <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t + d)
            else:
                merged.append([t, t + d])
        return merged

    def busy_s(self, card=None) -> float:
        """Seconds in which an operation ran on ``card``; without one, the
        mean over the cards."""
        if card is not None or len(self.cards) == 1:
            return sum(b - a for a, b in self.busy_intervals(card)) * 1e-6
        return sum(self.busy_s(c) for c in self.cards) / len(self.cards)

    def by_name(self) -> dict:
        out = defaultdict(lambda: [0.0, 0])
        for name, _, d in self.device:
            out[name][0] += d * 1e-6
            out[name][1] += 1
        return out

    def idle_gaps(self, card=None) -> dict:
        """Seconds of device idle between device events, by the innermost
        host operation running at the middle of each gap (over every host
        thread, the one that began last); on one card, ``card`` (default:
        the first), or with ``card="each"`` every card's, named ``cuda:<card>
        <operation>``."""
        if card == "each":
            return {f"cuda:{c} {name}": s for c in self.cards
                    for name, s in self.idle_gaps(c).items()}
        merged = self.busy_intervals(card)
        gaps = sorted(((a + b) / 2.0, b - a) for (_, a), (b, _) in zip(merged, merged[1:])
                      if b > a)
        by_thread = defaultdict(list)
        for name, tid, t, d in self.host:
            by_thread[tid].append((t, t + d, name))
        for evs in by_thread.values():
            evs.sort(key=lambda e: (e[0], -e[1]))
        cursor = {tid: 0 for tid in by_thread}
        stacks = {tid: [] for tid in by_thread}
        out = defaultdict(float)
        for mid, length in gaps:
            best = None
            for tid, evs in by_thread.items():
                i, stack = cursor[tid], stacks[tid]
                while i < len(evs) and evs[i][0] <= mid:
                    stack.append(evs[i])
                    i += 1
                cursor[tid] = i
                live = [e for e in stack if e[1] > mid]
                stacks[tid] = live
                if live and (best is None or live[-1][0] > best[0]):
                    best = live[-1]
            out[best[2] if best else "_no_host_event_"] += length * 1e-6
        return out


def _sync(devices) -> None:
    for d in devices:
        torch.cuda.synchronize(d)


def event_card(e: dict) -> int:
    """The card of a device event of the Chrome trace: its ``device``
    argument, else its process id (the profiler's device lane)."""
    args = e.get("args") or {}
    card = args.get("device", e.get("pid"))
    return card if isinstance(card, int) else 0


def record(call, steps: int, devices) -> Trace:
    """Profile ``steps`` calls (after one profiled warm-up call that is not
    kept) on ``devices`` (one, or a list of the run's cards) and reduce the
    Chrome trace."""
    from torch.profiler import ProfilerActivity, profile, schedule

    devices = list(devices) if isinstance(devices, (list, tuple)) else [devices]
    sched = schedule(wait=0, warmup=1, active=steps, repeat=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], schedule=sched) as prof:
        call()
        _sync(devices)
        prof.step()
        t0 = time.perf_counter()
        for _ in range(steps):
            call()
        _sync(devices)
        window_s = time.perf_counter() - t0
        prof.step()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            data = json.load(fh)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    device_events, host_events = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            device_events.append((e["name"], float(e["ts"]), float(e["dur"]), event_card(e)))
        elif cat in HOST_CATS and not e["name"].startswith("ProfilerStep"):
            host_events.append((e["name"], e.get("tid"), float(e["ts"]), float(e["dur"])))
    return Trace(device_events, host_events, steps, window_s,
                 cards=[d.index or 0 for d in devices])


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps; with more than one card, each named ``cuda:<card> …``."""
    if len(trace.cards) == 1:
        by_name = {n: s for n, (s, _) in trace.by_name().items()}
        idle = trace.idle_gaps()
    else:
        by_name = defaultdict(float)
        for (name, _, d), c in zip(trace.device, trace.card):
            by_name[f"cuda:{c} {name}"] += d * 1e-6
        idle = trace.idle_gaps("each")
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
    gaps = sorted(idle.items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [[n[:96], s] for n, s in ops], "idle_gaps": [[n[:96], s] for n, s in gaps]}
