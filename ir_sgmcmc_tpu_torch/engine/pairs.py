"""Pair-parallel registration (port of ``ir_sgmcmc_tpu/engine/pairs.py``).

A study registers a population of image pairs, each with its own model
parameters, optimizer moments, chains and Welford accumulators.  The JAX
package stacks P pairs on a new leading axis, shards that axis over a
``('pair',)`` device mesh and runs each device's pairs in turn under
``lax.map``.  The pair-stacked states here have the JAX layout: a leading
``(P,)`` axis on every leaf, ``step`` (int32, on the host) and the key
words included, so a pair-stacked checkpoint of either package resumes in
the other.

One card runs the pairs as one batch instead of in turn, since a
transition or VI step costs about as many kernel launches for P pairs as
for one:

* SG-MCMC: the P pairs' C chains fold into one chain batch of P·C rows
  (pair ``i``'s chain ``c`` at row ``i·C + c``, :func:`fold_chains`) with
  per-row images (:func:`chain_rows`), and the single-pair transition runs
  once per step.  Every chain keeps its own key words, so pair ``i`` draws
  exactly the streams of its own run.  The only mode is ``MCMC_params:
  "per_chain"``: a shared GMM takes its chains' Adam steps in sequence,
  and the trainer registers such pairs in turn.
* VI: one batch of 2P through the forward chain, each pair with its own
  q(v), GMM, reg and Adam states (``make_vi_step(pairs=True)``).

A batch of P pairs peaks at about P times one pair's memory (the JAX
package's ``lax.map`` holds one pair's working set).  So both chunks take
``group``: the pairs run in batches of at most that many, in turn, which
with ``group=1`` is ``lax.map``'s schedule.  The trainer sizes it from one
pair's measured peak against the card's free memory.

Over several devices the pairs are cut over a ``('pair',)`` mesh
(:func:`make_pair_mesh`, :func:`shard_pairs`, the JAX module's rule: the
largest device count that tiles the pairs).  With ``mesh=`` the chunks take
and return a pair-sharded state, and each device runs its own pairs as one
card does (folded chain rows, batches of ``group``), the devices in turn at
every step so that all of them stay busy.
"""

from __future__ import annotations

import torch

from .._device import resolve_devices
from ..parallel.mesh import Mesh, Sharded, place, run_in_turns
from .mcmc import MCMCState, make_mcmc_chunk
from .vi import VIState, make_vi_chunk, make_vi_step

__all__ = ["stack_trees", "unstack_tree", "take_pairs", "fold_chains", "unfold_chains",
           "chain_rows", "pair_device_count", "make_pair_mesh", "shard_pairs",
           "make_pair_vi_chunk", "make_pair_mcmc_chunk"]


def _map(fn, tree):
    """``fn`` over the tensor leaves of dicts and named tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, t) for k, t in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, t) for t in tree))
    return None if tree is None else fn(tree)


def stack_trees(trees: list):
    """Stack congruent trees (dicts, named tuples, tensors and the states'
    int step counts) along a new leading pair axis; an int becomes an int32
    tensor on the host."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(stack_trees([getattr(t, f) for t in trees])
                             for f in first._fields))
    if isinstance(first, int):
        return torch.tensor(trees, dtype=torch.int32)
    return torch.stack(list(trees))


def unstack_tree(tree, i: int):
    """Pair ``i`` of a pair-stacked tree; a state's ``step`` comes back as
    an int."""
    out = _map(lambda t: t[i], tree)
    if isinstance(out, (VIState, MCMCState)):
        out = out._replace(step=int(out.step))
    return out


def take_pairs(tree, sl: slice):
    """Pairs ``sl`` of a pair-stacked tree."""
    return _map(lambda t: t[sl], tree)


def _cat(trees: list):
    """Concatenate pair-stacked trees along the pair axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _cat([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_cat([getattr(t, f) for t in trees]) for f in first._fields))
    return torch.cat(trees)


def pair_device_count(n_pairs: int, n_devices: int | None = None) -> int:
    """Largest device count that evenly tiles ``n_pairs`` (default: over
    every visible CUDA card)."""
    if n_devices is None:
        n_devices = len(resolve_devices())
    d = min(int(n_pairs), int(n_devices))
    while n_pairs % d:
        d -= 1
    return d


def make_pair_mesh(n_pairs: int, n_devices: int | None = None, devices=None) -> Mesh:
    """A ``('pair',)`` mesh over the first :func:`pair_device_count` devices
    of ``devices`` (default: every visible CUDA card)."""
    devices = resolve_devices(devices)
    d = pair_device_count(n_pairs, len(devices) if n_devices is None else n_devices)
    return Mesh(devices[:d], ("pair",))


def shard_pairs(tree, mesh: Mesh) -> Sharded:
    """Place a pair-stacked tree: every leaf is cut along its leading pair
    axis over ``'pair'`` (the host leaves, key words and steps, too)."""
    return place(tree, mesh, lambda x: [(0, "pair")])


def _over_mesh(build, mesh: Mesh, chunk: int, state, fixed_st, moving_st):
    """``chunk`` steps of one-card runners ``build(fixed, moving) -> run(state)
    -> (state, metrics (P_i, 1, …))``, one per device of ``mesh`` on its own
    pairs, the devices in turn at every step.  Returns the pair-sharded
    state and the metrics ``(P, chunk, …)`` on the mesh's first device."""
    state, fixed, moving = (t if isinstance(t, Sharded) else shard_pairs(t, mesh)
                            for t in (state, fixed_st, moving_st))
    local, metrics = run_in_turns([build(f, m) for f, m in zip(fixed, moving)], list(state),
                                  chunk)
    dev0 = mesh.device_list[0]
    # per device (chunk, P_i, 1, …) -> (P_i, chunk, …)
    return Sharded(local, mesh, state.cuts), {
        k: torch.cat([m[k].squeeze(2).transpose(0, 1).to(dev0) for m in metrics])
        for k in metrics[0]}


def _in_groups(run, group: int | None):
    """Lift ``run(state, fixed, moving) -> (state, metrics)`` on pair-stacked
    operands (metrics with a leading pair axis) to batches of at most
    ``group`` pairs in turn (None: all pairs in one batch)."""

    def run_all(state, fixed_st: dict, moving_st: dict):
        n_pairs = int(state.step.shape[0])
        g = n_pairs if group is None else max(1, min(int(group), n_pairs))
        if g == n_pairs:
            return run(state, fixed_st, moving_st)
        parts = [run(*(take_pairs(t, slice(i, i + g)) for t in (state, fixed_st, moving_st)))
                 for i in range(0, n_pairs, g)]
        states, metrics = zip(*parts)
        return _cat(list(states)), {k: torch.cat([m[k] for m in metrics]) for k in metrics[0]}

    return run_all


def _single_step(state) -> int:
    steps = set(state.step.tolist())
    if len(steps) != 1:
        raise ValueError(f"pair-stacked state has pairs at different steps {sorted(steps)}")
    return steps.pop()


def fold_chains(state: MCMCState) -> MCMCState:
    """A pair-stacked chain state (leaves ``(P, C, …)``, ``step (P,)``, all
    pairs at one step) as one chain batch of P·C rows, pair ``i``'s chain
    ``c`` at row ``i·C + c``, with an int ``step``.  Only per-chain GMM/reg
    sets fold: a shared set (``MCMC_params: "shared"``) steps its chains in
    sequence and has no row of its own to fold."""
    if tuple(state.opt_gmm.step.shape) != tuple(state.v.shape[:2]):
        raise ValueError("pair-stacked chains need per-chain GMM/reg sets (MCMC_params "
                         "'per_chain'): a shared set steps its chains in sequence")
    step = _single_step(state)
    folded = _map(lambda t: t.reshape((-1,) + tuple(t.shape[2:])), state._replace(step=None))
    return folded._replace(step=step)


def unfold_chains(state: MCMCState, n_pairs: int) -> MCMCState:
    """The inverse of :func:`fold_chains`."""
    out = _map(lambda t: t.reshape((n_pairs, -1) + tuple(t.shape[1:])),
               state._replace(step=None))
    return out._replace(step=torch.full((n_pairs,), state.step, dtype=torch.int32))


def chain_rows(images: dict, no_chains: int) -> dict:
    """The image and mask of pair-stacked images ``(P, D, H, W)`` on the P·C
    folded chain rows (what the transition reads)."""
    return {k: images[k].repeat_interleave(no_chains, dim=0)
            for k in ("im", "mask") if k in images}


def make_pair_vi_chunk(bundle, opt_q_v, opt_gmm, opt_reg, fixed_st: dict, moving_st: dict,
                       chunk: int, remat: bool = False, group: int | None = None,
                       mesh: Mesh | None = None):
    """``run(state) -> (state, metrics)``: ``chunk`` VI steps of a
    pair-stacked ``VIState`` on pair-stacked images ``(P, D, H, W)``, in
    batches of at most ``group`` pairs; metrics ``(P, chunk, …)``.  With a
    pair ``mesh``, the state (and the images, unless given sharded) are
    pair-sharded and each device runs its own pairs."""
    if mesh is not None:
        def build(f, m):
            return make_pair_vi_chunk(bundle, opt_q_v, opt_gmm, opt_reg, f, m, 1, remat, group)

        return lambda state: _over_mesh(build, mesh, chunk, state, fixed_st, moving_st)

    def run(state: VIState, fixed: dict, moving: dict):
        step = make_vi_step(bundle, opt_q_v, opt_gmm, opt_reg, fixed, moving, remat=remat,
                            pairs=True)
        state, metrics = make_vi_chunk(step, chunk)(state)
        return state, {k: m.transpose(0, 1) for k, m in metrics.items()}

    run_all = _in_groups(run, group)
    return lambda state: run_all(state, fixed_st, moving_st)


def make_pair_mcmc_chunk(bundle, opt_gmm, opt_reg, tau: float, fixed_st: dict,
                         moving_st: dict, chunk: int, burn_in: int, thin: int,
                         group: int | None = None, mesh: Mesh | None = None):
    """``run(state) -> (state, metrics)``: ``chunk`` SGLD transitions of a
    pair-stacked per-chain ``MCMCState`` (leaves ``(P, C, …)``, ``step
    (P,)``, all pairs at one step) on pair-stacked images ``(P, D, H, W)``,
    in batches of at most ``group`` pairs; metrics ``(P, chunk, C, …)``.
    With a pair ``mesh``, as :func:`make_pair_vi_chunk`."""
    if mesh is not None:
        def build(f, m):
            return make_pair_mcmc_chunk(bundle, opt_gmm, opt_reg, tau, f, m, 1, burn_in, thin,
                                        group)

        return lambda state: _over_mesh(build, mesh, chunk, state, fixed_st, moving_st)

    def run(state: MCMCState, fixed: dict, moving: dict):
        n_pairs, no_chains = state.v.shape[:2]
        folded, metrics = make_mcmc_chunk(
            bundle, opt_gmm, opt_reg, tau, chain_rows(fixed, no_chains),
            chain_rows(moving, no_chains), chunk, burn_in, thin,
            per_row=True)(fold_chains(state))
        return unfold_chains(folded, n_pairs), {
            k: m.reshape((chunk, n_pairs, no_chains) + tuple(m.shape[2:])).transpose(0, 1)
            for k, m in metrics.items()}

    run_all = _in_groups(run, group)
    return lambda state: run_all(state, fixed_st, moving_st)
