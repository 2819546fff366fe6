"""Adam with per-step learning-rate decay, per-leaf learning rates and
re-initialisable moments (port of ``ir_sgmcmc_tpu/optim/adam_decay.py``).

    clr = lr / (1 + step * lr_decay)          # step counted before increment
    t   = (step + 1) - reinit_step            # bias correction restarts on reinit
    m   = b1 m + (1 - b1) g
    v   = b2 v + (1 - b2) g²
    p  -= clr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)

Parameters, gradients and moments are dicts of tensors.  ``step`` and
``reinit_step`` are int32 tensors: scalars for one parameter set, or
``(C,)`` for per-chain sets whose leaves carry a leading ``(C,)`` axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AdamDecayState(NamedTuple):
    step: torch.Tensor  # int32, completed steps
    reinit_step: torch.Tensor  # int32, step of the last moment reset
    mu: dict
    nu: dict


def _like(s: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-set scalar/``(C,)`` tensor against a leaf."""
    return s.reshape(tuple(s.shape) + (1,) * (leaf.ndim - s.ndim))


class AdamDecay:
    """The transform: ``init(params)`` and ``update(grads, state)``.

    ``lr`` is a float or a dict of floats keyed like the params.
    """

    def __init__(self, lr, lr_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr = lr
        self.lr_decay = float(lr_decay)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)

    def init(self, params: dict, batch_shape=()) -> AdamDecayState:
        device = next(iter(params.values())).device if params else None
        zero = torch.zeros(tuple(batch_shape), dtype=torch.int32, device=device)
        return AdamDecayState(
            step=zero, reinit_step=zero.clone(),
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()})

    def update(self, grads: dict, state: AdamDecayState):
        """Return ``(updates, new_state)``; apply with :func:`apply_updates`."""
        b1, b2 = self.b1, self.b2
        step = state.step
        new_step = step + 1
        t = (new_step - state.reinit_step).to(torch.float32)
        mu = {k: b1 * state.mu[k] + (1.0 - b1) * g for k, g in grads.items()}
        nu = {k: b2 * state.nu[k] + (1.0 - b2) * g * g for k, g in grads.items()}
        # filled on the device, not copied from the host (which would wait)
        bc1 = 1.0 - torch.pow(torch.full((), b1, dtype=torch.float32, device=t.device), t)
        bc2 = 1.0 - torch.pow(torch.full((), b2, dtype=torch.float32, device=t.device), t)
        decay = 1.0 + step.to(torch.float32) * self.lr_decay
        updates = {}
        for k in grads:
            lr = self.lr if isinstance(self.lr, (int, float)) else self.lr[k]
            m, v = mu[k], nu[k]
            clr = float(lr) / _like(decay, m)
            updates[k] = -(clr / _like(bc1, m)) * m / (
                torch.sqrt(v) / torch.sqrt(_like(bc2, m)) + self.eps)
        return updates, AdamDecayState(new_step, state.reinit_step, mu, nu)


def adam_decay(lr, lr_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8) -> AdamDecay:
    return AdamDecay(lr, lr_decay, b1, b2, eps)


def apply_updates(params: dict, updates: dict) -> dict:
    return {k: params[k] + updates[k] for k in params}


def reinit_moments(state: AdamDecayState) -> AdamDecayState:
    """Zero the moments and restart bias correction at the current step."""
    return AdamDecayState(
        step=state.step, reinit_step=state.step.clone(),
        mu={k: torch.zeros_like(v) for k, v in state.mu.items()},
        nu={k: torch.zeros_like(v) for k, v in state.nu.items()})
