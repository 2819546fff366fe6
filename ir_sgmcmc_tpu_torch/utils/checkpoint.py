"""Checkpoint / resume in the JAX package's ``.npz`` format v2 (port of
``ir_sgmcmc_tpu/utils/checkpoint.py``).

A checkpoint holds one ``leaf::<path>`` entry per leaf of the state and a
``__meta__`` JSON record (format version, phase, step, config name).
``<path>`` is the string ``jax.tree_util.keystr`` gives for the same leaf of
the JAX package's state: ``.field`` for a named-tuple field, ``['key']``
for a dict entry, ``[i]`` for a list or tuple item, so ``.q_v['mu']`` or
``.opt_gmm.step``.  Leaves are stored with the JAX package's dtypes: the
port holds a state's key words as int64 tensors and its ``step`` as a
Python int, which are stored as uint32 and int32.  So a ``vi_latest.npz``
or ``mcmc_latest.npz`` written by either package resumes in the other.

Loading needs a template state of the same structure (build the initial
state, then load into it): every leaf comes back with the template leaf's
type, dtype and device.  Missing or unexpected paths and shape mismatches
are rejected; round-1 checkpoints (positional ``leaf_%05d`` entries, in
the JAX flattening order) load through the v1 fallback.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

FORMAT_VERSION = 2
_META_KEY = "__meta__"
_LEAF_PREFIX = "leaf::"


def _children(node):
    """``[(key string, child)]`` of an inner node in the JAX flattening order
    (dict keys sorted), or None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def _flatten(node, prefix: str = "") -> list:
    kids = _children(node)
    if kids is None:
        return [(prefix, node)]
    return [item for k, c in kids for item in _flatten(c, prefix + k)]


def _rebuild(node, leaves: dict, prefix: str = ""):
    if isinstance(node, dict):  # keeps the template's key order
        return {k: _rebuild(c, leaves, f"{prefix}[{k!r}]") for k, c in node.items()}
    kids = _children(node)
    if kids is None:
        return leaves[prefix]
    values = [_rebuild(c, leaves, prefix + k) for k, c in kids]
    if hasattr(node, "_fields"):
        return type(node)(*values)
    return type(node)(values)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        arr = leaf.detach().cpu().numpy()
        # int64 tensors of a port state are key words: uint32 in the JAX state
        return arr.astype(np.uint32) if arr.dtype == np.int64 else arr
    if isinstance(leaf, (bool, np.bool_)):
        return np.asarray(leaf)
    if isinstance(leaf, int):  # a port state's step count: int32 in JAX
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _shape(leaf) -> tuple:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    return tuple(np.shape(leaf))


def _like(arr: np.ndarray, tpl):
    """``arr`` as the template leaf's type, dtype and device."""
    if isinstance(tpl, torch.Tensor):
        np_dtype = torch.empty((), dtype=tpl.dtype).numpy().dtype
        return torch.as_tensor(arr.astype(np_dtype), device=tpl.device)
    if isinstance(tpl, (bool, np.bool_)):
        return bool(arr)
    if isinstance(tpl, int):
        return int(arr)
    return arr.astype(np.asarray(tpl).dtype, copy=False)


def _path_keys(state) -> tuple[list[str], list]:
    """Flatten ``state`` with one ``keystr``-style key per leaf."""
    pairs = _flatten(state)
    keys = [k for k, _ in pairs]
    if len(set(keys)) != len(keys):
        raise ValueError("state has duplicate path keys")
    return keys, [leaf for _, leaf in pairs]


def save_checkpoint(path, state, meta: dict | None = None) -> None:
    """Serialise ``state`` (named tuples, dicts, lists of tensors, arrays and
    ints) + ``meta`` to ``path``, atomically."""
    keys, leaves = _path_keys(state)
    payload = {_LEAF_PREFIX + k: _to_numpy(leaf) for k, leaf in zip(keys, leaves)}
    meta = dict(meta or {})
    meta.setdefault("format_version", FORMAT_VERSION)
    payload[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    tmp.replace(path)


def peek_meta(path) -> dict:
    """Read only the metadata record of a checkpoint (cheap dispatch)."""
    with np.load(path) as archive:
        if _META_KEY in archive:
            return json.loads(bytes(archive[_META_KEY]).decode())
    return {}


def load_checkpoint(path, like):
    """Load a checkpoint into the structure of the template state ``like``.

    :return: ``(state, meta)``: ``state`` has the structure of ``like``.
    :raises ValueError: when the stored leaf paths don't exactly cover the
        template's (missing / unexpected keys listed), or any shape differs.
    """
    with np.load(path) as archive:
        meta = (json.loads(bytes(archive[_META_KEY]).decode())
                if _META_KEY in archive else {})
        stored_keys = [k for k in archive.files if k.startswith(_LEAF_PREFIX)]
        if not stored_keys and any(k.startswith("leaf_") for k in archive.files):
            return _load_v1(path, archive, meta, like)

        template_keys, template_leaves = _path_keys(like)
        have = {k[len(_LEAF_PREFIX):] for k in stored_keys}
        missing = sorted(set(template_keys) - have)
        unexpected = sorted(have - set(template_keys))
        if missing or unexpected:
            raise ValueError(
                f"{path}: checkpoint does not match the template state "
                f"pytree — missing keys {missing[:8]}, "
                f"unexpected keys {unexpected[:8]}"
            )
        leaves = {}
        for k, tpl in zip(template_keys, template_leaves):
            arr = archive[_LEAF_PREFIX + k]
            if tuple(arr.shape) != _shape(tpl):
                raise ValueError(
                    f"{path}: leaf {k!r} shape mismatch "
                    f"{arr.shape} vs template {_shape(tpl)}"
                )
            leaves[k] = _like(arr, tpl)
    return _rebuild(like, leaves), meta


def _load_v1(path, archive, meta, like):
    """Positional v1 (``leaf_%05d``) fallback for round-1 checkpoints."""
    template_keys, template_leaves = _path_keys(like)
    n = len(template_leaves)
    n_stored = len([k for k in archive.files if k.startswith("leaf_")])
    if n_stored != n:
        raise ValueError(
            f"{path}: v1 checkpoint has a different number of leaves than "
            f"the template state ({n_stored} vs {n})"
        )
    leaves = {}
    for i, (k, tpl) in enumerate(zip(template_keys, template_leaves)):
        arr = archive[f"leaf_{i:05d}"]
        if tuple(arr.shape) != _shape(tpl):
            raise ValueError(
                f"{path}: leaf shape mismatch {arr.shape} vs template "
                f"{_shape(tpl)}"
            )
        leaves[k] = _like(arr, tpl)
    return _rebuild(like, leaves), meta
