"""The readers behind the per-layer metrics.  Each file under ``metrics/``
names one metric and calls one of these with its phase; a reader returns
None where the run has nothing for it to read (the harness then leaves
the metric out), never a 0 in place of a share.

``ctx`` (built by ``run.py`` in a ``--trace 1`` run) holds ``phase``,
``trace`` (:class:`trace.Trace`), ``steps`` (the steps the trace covers),
``untraced_step_s`` (the wall time per step of the untraced window that
ran just before the trace, in the same process), ``window_peak_bytes``
(the untraced window's peak, the fullest card's), ``shapes`` (each
hand-written kernel's main operand, :func:`work.kernel_shapes`: a card's
slab on a sharded step), ``least_step_s`` (:func:`work.least_step_s`) and,
where the step is cut along D, ``shards`` and ``window`` (the block warp's
halo planes, :func:`work.launch_bound_ms`).

Over several cards: launches are counted over all of them (one thread
issues every card's), device times are the mean over the cards, and the
idle share is the mean of each card's.
"""

from __future__ import annotations

from . import trace as tr
from .work import launch_bound_ms


def _ours(ctx, phase: str) -> bool:
    return ctx.phase == phase and ctx.trace is not None and bool(ctx.trace.device)


def launches_per_step(ctx, phase: str):
    """Device kernels, memcpys and memsets per step, on all cards."""
    if not _ours(ctx, phase):
        return None
    return len(ctx.trace.device) / ctx.steps


def plain_ops_ms_per_step(ctx, phase: str):
    """Device milliseconds per step of PyTorch's own elementwise, copy and
    reduction kernels (per card)."""
    if not _ours(ctx, phase):
        return None
    us = sum(d for name, _, d in ctx.trace.device if tr.kind_of(name) in tr.PLAIN)
    return us * 1e-3 / ctx.steps / len(ctx.trace.cards)


def kernel_roofline(ctx, phase: str):
    """The hand-written kernels' least time at their shapes over their
    measured device time, in %."""
    if not _ours(ctx, phase):
        return None
    shards, window = getattr(ctx, "shards", 1), getattr(ctx, "window", 0)
    least = measured = 0.0
    for name, _, d in ctx.trace.device:
        kind = tr.kind_of(name)
        if kind in ctx.shapes:
            least += launch_bound_ms(kind, ctx.shapes[kind], shards, window)
            measured += d * 1e-3
    return 100.0 * least / measured if measured else None


def device_idle_share(ctx, phase: str):
    """One minus the device's busy time per step (from the trace) over the
    untraced wall time per step, in %: the mean of each card's."""
    if not _ours(ctx, phase) or not ctx.untraced_step_s:
        return None
    busy = ctx.trace.busy_s() / ctx.steps
    return 100.0 * (1.0 - busy / ctx.untraced_step_s)


def peak_mem_gib(ctx, phase: str):
    """The device memory peak over the untraced window, in GiB (the
    fullest card's)."""
    if ctx.phase != phase or not ctx.window_peak_bytes:
        return None
    return ctx.window_peak_bytes / 2 ** 30


def step_mfu(ctx, phase: str):
    """The step's least time (:func:`work.least_step_s`) over its untraced
    wall time, in %."""
    if ctx.phase != phase or not ctx.untraced_step_s:
        return None
    return 100.0 * ctx.least_step_s[0] / ctx.untraced_step_s
