"""Chain state to and from the JAX package's ``MCMCState`` as numpy arrays.

The JAX side is ``jax.tree.map(np.asarray, state)`` for an
``ir_sgmcmc_tpu.engine.MCMCState`` in the per-chain parameter mode: named
tuples (or plain dicts) with fields ``v, sigma, gmm, reg, opt_gmm,
opt_reg, welford, key, step``, the optimizer states with ``step,
reinit_step, mu, nu`` and the Welford state with ``count, mean, m2``.
:func:`mcmc_state_to_numpy` returns the same structure as plain dicts, so
``MCMCState(**d)`` (with the nested states rebuilt likewise) restores it.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine.mcmc import MCMCState, WelfordState
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
        mu={k: _t(v, device, torch.float32) for k, v in f["mu"].items()},
        nu={k: _t(v, device, torch.float32) for k, v in f["nu"].items()})


def mcmc_state_from_numpy(tree, device=None) -> MCMCState:
    """Port state from the JAX package's state as numpy arrays."""
    f = _fields(tree)
    w = _fields(f["welford"])
    return MCMCState(
        v=_t(f["v"], device, torch.float32),
        sigma=_t(f["sigma"], device, torch.float32),
        gmm={k: _t(v, device, torch.float32) for k, v in f["gmm"].items()},
        reg={k: _t(v, device, torch.float32) for k, v in f["reg"].items()},
        opt_gmm=_adam_from(f["opt_gmm"], device),
        opt_reg=_adam_from(f["opt_reg"], device),
        welford=WelfordState(*(_t(w[k], device, torch.float32)
                               for k in ("count", "mean", "m2"))),
        key=torch.as_tensor(np.asarray(f["key"]).astype(np.int64)),
        step=int(np.asarray(f["step"])))


def _np(t: torch.Tensor, dtype=np.float32) -> np.ndarray:
    return t.detach().cpu().numpy().astype(dtype)


def _adam_to(s: AdamDecayState) -> dict:
    return {"step": _np(s.step, np.int32), "reinit_step": _np(s.reinit_step, np.int32),
            "mu": {k: _np(v) for k, v in s.mu.items()},
            "nu": {k: _np(v) for k, v in s.nu.items()}}


def mcmc_state_to_numpy(state: MCMCState) -> dict:
    """The JAX package's state layout as nested dicts of numpy arrays."""
    return {
        "v": _np(state.v),
        "sigma": _np(state.sigma),
        "gmm": {k: _np(v) for k, v in state.gmm.items()},
        "reg": {k: _np(v) for k, v in state.reg.items()},
        "opt_gmm": _adam_to(state.opt_gmm),
        "opt_reg": _adam_to(state.opt_reg),
        "welford": {"count": _np(state.welford.count),
                    "mean": _np(state.welford.mean),
                    "m2": _np(state.welford.m2)},
        "key": state.key.numpy().astype(np.uint32),
        "step": np.int32(state.step),
    }
