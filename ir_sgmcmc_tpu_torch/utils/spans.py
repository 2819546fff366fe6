"""Stage spans: named ranges on the torch profiler's timeline.

``with span(name): ...`` is ``torch.profiler.record_function(name)`` while
a torch profiler records (``torch.profiler.profile``, ``bench.py --trace``,
a benchmark's traced run) and one shared no-op context otherwise, so a run
without a profiler pays one flag read per span.  A ``record_function``
range is a ``user_annotation`` event of the profiler's own session, on the
clock of the device events beside it: every kernel the range launches can
be charged to it through its launch's correlation id.

The engine's steps run inside one step span each (:data:`MCMC_STEP`,
:data:`VI_STEP`), and their work inside the stage spans of :data:`STAGES`:

* ``smooth``: the Sobolev smoothing of the sampled field;
* ``integrate``: scaling and squaring, the compositions, SVFFD's spread;
* ``warp``: the moving image's warp (block, bounded, anchored, grid_sample);
* ``likelihood``: LCC residuals, VD, the GMM's NLL, priors and Adam step;
* ``regulariser``: the reg energy, its hyperpriors and (VI) the entropy;
* ``update``: the draws, the loss, the ``autograd.grad`` call and the
  optimiser steps;
* ``bookkeeping``: fold and saturation counts, Welford, metrics, and the
  pair-stacked chunks' per-call rows and reshapes.

Backward kernels run inside the ``update`` span (the ``grad`` call); a
reader charges each to the stage of the forward op that made its autograd
node, by the op's sequence number in the trace.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

PREFIX = "ir."
STAGES = ("smooth", "integrate", "warp", "likelihood", "regulariser", "update", "bookkeeping")
SMOOTH, INTEGRATE, WARP, LIKELIHOOD, REGULARISER, UPDATE, BOOKKEEPING = (
    PREFIX + s for s in STAGES)
MCMC_STEP = PREFIX + "mcmc_transition"
VI_STEP = PREFIX + "vi_step"

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a torch profiler
    records, else a no-op context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
