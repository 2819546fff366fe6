"""VI and chain states to and from the JAX package's as numpy arrays.

The JAX side is ``jax.tree.map(np.asarray, state)`` for an
``ir_sgmcmc_tpu.engine.MCMCState`` in either parameter mode (fields
``v, sigma, gmm, reg, opt_gmm, opt_reg, welford, key, step``) or an
``ir_sgmcmc_tpu.engine.vi.VIState`` (fields ``q_v, gmm, reg, opt_q_v,
opt_gmm, opt_reg, key, step``): named tuples (or plain dicts), the
optimizer states with ``step, reinit_step, mu, nu`` and the Welford state
with ``count, mean, m2``.  The ``*_to_numpy`` functions return the same
structure as plain dicts, so ``MCMCState(**d)`` or ``VIState(**d)`` (with
the nested states rebuilt likewise) restores it.  Shapes pass through as
they are: the SVFFD model's ``v``, ``sigma`` and q(v) leaves live on its
control grid, the Welford accumulators on the image grid.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .engine.mcmc import MCMCState, WelfordState
from .engine.vi import VIState
from .optim.adam_decay import AdamDecayState


def _fields(x) -> dict:
    return x._asdict() if hasattr(x, "_asdict") else dict(x)


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a, copy=True), dtype=dtype, device=device)


def _adam_from(tree, device) -> AdamDecayState:
    f = _fields(tree)
    return AdamDecayState(
        step=_t(f["step"], device, torch.int32),
        reinit_step=_t(f["reinit_step"], device, torch.int32),
        mu=_f32(f["mu"], device),
        nu=_f32(f["nu"], device))


def _f32(tree: dict, device) -> dict:
    return {k: _t(v, device, torch.float32) for k, v in tree.items()}


def _key_from(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def mcmc_state_from_numpy(tree, device=None) -> MCMCState:
    """Port state from the JAX package's state as numpy arrays, on
    ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    f = _fields(tree)
    w = _fields(f["welford"])
    return MCMCState(
        v=_t(f["v"], device, torch.float32),
        sigma=_t(f["sigma"], device, torch.float32),
        gmm=_f32(f["gmm"], device),
        reg=_f32(f["reg"], device),
        opt_gmm=_adam_from(f["opt_gmm"], device),
        opt_reg=_adam_from(f["opt_reg"], device),
        welford=WelfordState(*(_t(w[k], device, torch.float32)
                               for k in ("count", "mean", "m2"))),
        key=_key_from(f["key"]),
        step=int(np.asarray(f["step"])))


def vi_state_from_numpy(tree, device=None) -> VIState:
    """Port VI state from the JAX package's ``VIState`` as numpy arrays, on
    ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    f = _fields(tree)
    return VIState(
        q_v=_f32(f["q_v"], device),
        gmm=_f32(f["gmm"], device),
        reg=_f32(f["reg"], device),
        opt_q_v=_adam_from(f["opt_q_v"], device),
        opt_gmm=_adam_from(f["opt_gmm"], device),
        opt_reg=_adam_from(f["opt_reg"], device),
        key=_key_from(f["key"]),
        step=int(np.asarray(f["step"])))


def _np(t: torch.Tensor, dtype=np.float32) -> np.ndarray:
    return t.detach().cpu().numpy().astype(dtype)


def _adam_to(s: AdamDecayState) -> dict:
    return {"step": _np(s.step, np.int32), "reinit_step": _np(s.reinit_step, np.int32),
            "mu": _np_tree(s.mu), "nu": _np_tree(s.nu)}


def _np_tree(tree: dict) -> dict:
    return {k: _np(v) for k, v in tree.items()}


def mcmc_state_to_numpy(state: MCMCState) -> dict:
    """The JAX package's state layout as nested dicts of numpy arrays."""
    return {
        "v": _np(state.v),
        "sigma": _np(state.sigma),
        "gmm": _np_tree(state.gmm),
        "reg": _np_tree(state.reg),
        "opt_gmm": _adam_to(state.opt_gmm),
        "opt_reg": _adam_to(state.opt_reg),
        "welford": {"count": _np(state.welford.count),
                    "mean": _np(state.welford.mean),
                    "m2": _np(state.welford.m2)},
        "key": state.key.numpy().astype(np.uint32),
        "step": np.int32(state.step),
    }


def vi_state_to_numpy(state: VIState) -> dict:
    """The JAX package's ``VIState`` layout as nested dicts of numpy arrays."""
    return {
        "q_v": _np_tree(state.q_v),
        "gmm": _np_tree(state.gmm),
        "reg": _np_tree(state.reg),
        "opt_q_v": _adam_to(state.opt_q_v),
        "opt_gmm": _adam_to(state.opt_gmm),
        "opt_reg": _adam_to(state.opt_reg),
        "key": state.key.numpy().astype(np.uint32),
        "step": np.int32(state.step),
    }
