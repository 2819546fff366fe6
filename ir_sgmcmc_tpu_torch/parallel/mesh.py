"""Device meshes and the placement of state over them (port of
``ir_sgmcmc_tpu/parallel/mesh.py``).

The JAX package places arrays on a ``jax.sharding.Mesh`` and runs one
program per device under ``shard_map``, from one controlling process.  The
port keeps that model: one Python process drives every device of a
:class:`Mesh`, and all host-side logic (the trainer's guards, rollback,
checkpoints and writer thread) stays in that process.  CUDA launches are
asynchronous, so the cards of a mesh overlap while the one thread issues
their work in turn.  There is no ``torch.distributed``: it would need one
process per card and a rank-aware trainer.

A placed tree is a :class:`Sharded`: a list of per-device trees in mesh
order (the device at mesh index ``(i, j, …)`` at the row-major position),
each holding that device's cut of every leaf; a placed tensor is a list of
per-device slabs.  :func:`gather` is the inverse: the whole tree on one
device.  The leaves follow the JAX module's rules: chain-major leaves cut
over ``'chain'``, fields cut along D over ``'space'``, the rest replicated.
The engine states' key words and step counts stay on the host, as
everywhere in the port (they are cut, not moved).

A mesh may name one device more than once: ``[cuda:0] * 4`` runs four
virtual shards on one card, ``[cpu] * 4`` four on the CPU, as
``--xla_force_host_platform_device_count`` gives JAX virtual devices.  One
card, and the CPU, thus drive every line of this layer.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from .._device import resolve_devices
from ..utils.spans import BOOKKEEPING, span


class Mesh:
    """Named axes over an array of ``torch.device``\\ s (the counterpart of
    ``jax.sharding.Mesh``).

    :param devices: a nested sequence (or array) of devices, one axis per
        name.
    :param axis_names: the axes' names, outermost first.
    """

    def __init__(self, devices, axis_names):
        shape = np.shape(np.asarray(devices, dtype=object))
        flat = [torch.device(d) for d in np.asarray(devices, dtype=object).reshape(-1)]
        self.axis_names = tuple(axis_names)
        if len(shape) != len(self.axis_names):
            raise ValueError(f"a mesh of shape {shape} needs {len(shape)} axis names, got "
                             f"{self.axis_names}")
        self.devices = np.empty(len(flat), dtype=object)
        self.devices[:] = flat
        self.devices = self.devices.reshape(shape)

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> list:
        """The devices in mesh order."""
        return list(self.devices.reshape(-1))

    def count(self, device) -> int:
        """How many shards of the mesh ``device`` holds."""
        return sum(d == torch.device(device) for d in self.device_list)

    def rows(self, axis_name: str) -> list:
        """The flat (mesh-order) indices of the devices along ``axis_name``,
        one list per position on the other axes."""
        ax = self.axis_names.index(axis_name)
        flat = np.arange(self.size).reshape(self.devices.shape)
        return np.moveaxis(flat, ax, -1).reshape(-1, self.devices.shape[ax]).tolist()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.device_list]})"


class Sharded(list):
    """A tree placed over ``mesh``: the per-device trees, in mesh order.

    ``cuts`` lists, for each tensor leaf in traversal order (dict values,
    named-tuple fields), the ``((dim, axis name), …)`` it is cut along; an
    empty tuple is a replicated leaf."""

    def __init__(self, trees, mesh: Mesh, cuts: list):
        super().__init__(trees)
        self.mesh = mesh
        self.cuts = list(cuts)


def _map(fn, tree, host: bool = False):
    """``fn(leaf, host)`` over the tensor leaves of dicts, named tuples and
    tuples; ``host`` is True for the key words and step of an engine state
    (a named tuple with a ``key`` field), which stay on the host."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, host) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        engine = "key" in tree._fields
        return type(tree)(*(_map(fn, getattr(tree, f), host or (engine and f in ("key", "step")))
                            for f in tree._fields))
    if isinstance(tree, tuple):
        return tuple(_map(fn, v, host) for v in tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree, host)
    return tree


def place(tree, mesh: Mesh, cut) -> Sharded:
    """One tree per device of ``mesh``: ``cut(leaf)`` names the ``((dim,
    axis), …)`` a leaf is cut along (each dim divides evenly), the rest is
    copied; device leaves go to the shard's device, host leaves stay."""
    cuts = []
    _map(lambda x, host: cuts.append(tuple(cut(x))), tree)
    trees = []
    for idx in np.ndindex(mesh.devices.shape):
        dev, at = mesh.devices[idx], dict(zip(mesh.axis_names, idx))
        leaf = iter(cuts)

        def put(x, host, dev=dev, at=at, leaf=leaf):
            for dim, axis in next(leaf):
                n = mesh.shape[axis]
                size = x.shape[dim] // n
                x = x.narrow(dim, at[axis] * size, size).contiguous()
            return x if host else x.to(dev)

        trees.append(_map(put, tree))
    return Sharded(trees, mesh, cuts)


def gather(sharded: Sharded, device=None):
    """The inverse of a placement: the whole tree on ``device`` (default:
    the mesh's first device; host leaves stay on the host).  Cut leaves are
    concatenated in mesh order; a replicated leaf is the first device's."""
    mesh = sharded.mesh
    device = mesh.device_list[0] if device is None else torch.device(device)
    shape, names = mesh.devices.shape, mesh.axis_names
    per_shard = []
    for t in sharded:
        leaves = []
        _map(lambda x, host: leaves.append(x), t)
        per_shard.append(leaves)

    def assemble(j, dims, host, idx=()):
        k = len(idx)
        if k == len(shape):
            x = per_shard[int(np.ravel_multi_index(idx, shape))][j]
            return x if host else x.to(device)
        if names[k] not in dims:
            return assemble(j, dims, host, idx + (0,))
        return torch.cat([assemble(j, dims, host, idx + (i,)) for i in range(shape[k])],
                         dim=dims[names[k]])

    order = itertools.count()

    def one(x, host):
        j = next(order)
        return assemble(j, {axis: dim for dim, axis in sharded.cuts[j]}, host)

    return _map(one, sharded[0])



def run_in_turns(steps: list, states: list, n: int):
    """``n`` rounds of ``steps[i](states[i]) -> (state, metrics)``, one step
    per device and the devices in turn in every round, so that no card's
    launch queue fills while another waits.  Returns the states and, per
    device, the metrics stacked over the rounds (``{name: (n, …)}``)."""
    states, per_step = list(states), [[] for _ in steps]
    for _ in range(n):
        for i, step in enumerate(steps):
            states[i], metrics = step(states[i])
            per_step[i].append(metrics)
    with span(BOOKKEEPING):
        return states, [{k: torch.stack([m[k] for m in ms]) for k in ms[0]} for ms in per_step]

def make_mesh(n_devices=None, axes=("chain",), devices=None) -> Mesh:
    """A 1D or 2D mesh over the first devices of ``devices`` (default: every
    visible CUDA card; it raises without one).

    ``axes=('chain',)`` puts ``n_devices`` (default: all) devices on the
    chain axis; ``axes=('chain', 'space')`` with ``n_devices=(c, s)`` builds
    a 2D mesh.  ``devices`` may repeat a device (virtual shards)."""
    devices = resolve_devices(devices)
    if isinstance(n_devices, tuple):
        shape = tuple(int(n) for n in n_devices)
    else:
        n = len(devices) if n_devices is None else int(n_devices)
        shape = (n,) + (1,) * (len(axes) - 1)
    total = math.prod(shape)
    if total > len(devices):
        raise ValueError(f"a mesh of shape {shape} needs {total} devices, got {len(devices)}")
    return Mesh(np.asarray(devices[:total], dtype=object).reshape(shape), axes)


def shard_chain_state(state, mesh: Mesh, no_chains: int) -> Sharded:
    """Place a chain-major state: leaves with a leading ``no_chains`` axis
    are cut over ``'chain'``, everything else is replicated."""
    n = mesh.shape["chain"]
    if no_chains % n:
        raise ValueError(f"{no_chains} chains do not divide over {n} devices")
    return place(state, mesh, lambda x: [(0, "chain")] if x.ndim > 0 and x.shape[0] == no_chains
                  else [])


def replicate(tree, mesh: Mesh) -> Sharded:
    """A copy of ``tree`` on every device of ``mesh``."""
    return place(tree, mesh, lambda x: [])


def shard_state_spatial(state, mesh: Mesh, no_chains: int, field_depth: int) -> Sharded:
    """Chain x space placement of a chain-major state: field leaves ``(C, …,
    D, H, W)`` with ``D == field_depth`` cut over ``('chain', …, 'space',
    None, None)``, other chain-major leaves over ``'chain'`` only, the rest
    replicated."""
    n_space = mesh.shape["space"]

    def cut(x):
        if x.ndim > 0 and x.shape[0] == no_chains:
            if x.ndim >= 4 and x.shape[-3] == field_depth and field_depth % n_space == 0:
                return [(0, "chain"), (x.ndim - 3, "space")]
            return [(0, "chain")]
        return []

    return place(state, mesh, cut)


def shard_tree_spatial(tree, mesh: Mesh, field_depth: int, axis_name: str = "space") -> Sharded:
    """Spatial-only placement (no chain axis): every leaf ``(…, D, H, W)``
    with ``D == field_depth`` is cut along D over ``axis_name``; the rest is
    replicated."""
    n_space = mesh.shape[axis_name]
    return place(tree, mesh, lambda x: [(x.ndim - 3, axis_name)]
                  if x.ndim >= 3 and x.shape[-3] == field_depth and field_depth % n_space == 0
                  else [])


def shard_images_spatial(tree, mesh: Mesh, field_depth: int) -> Sharded:
    """An image-pair dict: ``(…, D, H, W)`` volumes cut along D over
    ``'space'`` (replicated over ``'chain'``); the rest replicated."""
    return shard_tree_spatial(tree, mesh, field_depth, "space")


def halo_images_spatial(tree, mesh: Mesh, field_depth: int, h: int,
                        axis_name: str = "space") -> Sharded:
    """Each shard's window of the volumes of ``tree``: every leaf ``(…, D,
    H, W)`` with ``D == field_depth`` as the shard's D-slab over
    ``axis_name`` and ``h`` planes on each side, taken from the planes its
    neighbours own (as many shards away as ``h`` reaches), the edge plane
    repeated past the volume's two ends; the rest replicated.  The window
    is what the block-gather warp of a slab reads (its taps reach ``h``
    planes past the slab: ``parallel.halo.warp_block_gather_slabs``).  A
    placement that :func:`gather` does not invert (the windows overlap);
    ``halo`` holds ``h``."""
    n_space = mesh.shape[axis_name]
    if field_depth % n_space:
        raise ValueError(f"depth {field_depth} does not divide over {n_space} shards")
    size, ax = field_depth // n_space, mesh.axis_names.index(axis_name)
    cuts, trees = [], []

    def window(x, i):
        lo, hi = i * size - h, (i + 1) * size + h
        parts = []
        if lo < 0:
            parts.append(x.narrow(-3, 0, 1).expand(*x.shape[:-3], -lo, *x.shape[-2:]))
        parts.append(x.narrow(-3, max(lo, 0), min(hi, field_depth) - max(lo, 0)))
        if hi > field_depth:
            parts.append(x.narrow(-3, field_depth - 1, 1).expand(
                *x.shape[:-3], hi - field_depth, *x.shape[-2:]))
        return torch.cat(parts, dim=-3)

    _map(lambda x, host: cuts.append(()), tree)
    for idx in np.ndindex(mesh.devices.shape):
        dev = mesh.devices[idx]

        def put(x, host, dev=dev, i=idx[ax]):
            if x.ndim >= 3 and x.shape[-3] == field_depth:
                x = window(x, i)
            return x if host else x.to(dev).contiguous()

        trees.append(_map(put, tree))
    placed = Sharded(trees, mesh, cuts)
    placed.halo = int(h)
    return placed
