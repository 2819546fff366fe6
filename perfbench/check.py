"""The comparison that decides ``correct``.

Set-up drives the program's own state through its first ``check_steps``
steps with the window's own call; :class:`Record` keeps what those steps
left.  Once the window has closed and the program's state is freed, the
plain reference (``reference.py``) runs the same steps from the same
inputs, one chain (SG-MCMC) or one pair (VI) at a time, and three numbers
are compared, each with its limit (``limits/<workload>.json``):

* ``loss_gap``: the largest gap over the steps and rows between the
  program's loss (an SG-MCMC chain's potential, a VI pair's negative
  ELBO) and the reference's, over the reference's.
* ``grad_gap``: the first step's gradient of every leaf, as its optimiser
  got it, worked out from the program's state after one step (SGLD:
  ``(v0 + sqrt(2 tau) eps - v1) / tau`` at preconditioner 1; Adam: the
  first moment over ``1 - b1``).  The largest gap between the program's
  norm and the reference's, over the reference's norm of that leaf or of
  the median leaf, whichever is larger.
* ``change_gap``: the same for every leaf's change over the steps, the
  posterior mean accumulator counted as a leaf.

Two kinds of element move by round-off alone, and are left out of both
norms of a leaf, the program's and the reference's alike:

* the ``TRIM`` share of a leaf's elements where the program and the
  reference differ most.  The trilinear warp's gradient jumps where a
  sample position crosses a voxel plane; where the two sides' positions
  differ by an ulp across one, a few dozen elements of a leaf take the
  other slope (a kink crossing), while a fault or a lower precision moves
  every element.  The share is chosen by the gap itself, so a fault that
  reaches no more elements than a kink crossing does passes as one; such
  a fault also reads, untrimmed, within what kink crossings read in sound
  runs, so no limit on the untrimmed number would see it either.  A leaf
  with a non-finite element is never trimmed: its gap is infinite;
* for the change, the elements whose reference gradient in the first step
  is under ``ROUNDOFF`` times the leaf's RMS gradient (VI's antithetic
  pair cancels the regulariser's gradient exactly where the data term has
  none, and Adam then steps by the sign of the round-off), and whole
  leaves whose reference gradient is under ``ROUNDOFF`` times the median
  leaf's.

A leaf is one row's tensor: ``v[3]`` is chain 3's field.

A step cut over several devices has its rows run by the reference in turn,
row ``r`` on the ``r``-th of the cell's cards (cyclically), each leaf
compared on the card that holds the reference's; the program's copies come
from the host.  On any card the reference runs under recompute
(``reference.Model``'s ``recompute``) where its plain step's estimated peak
for one row (:func:`recompute_on`) would not leave room on the card.
"""

from __future__ import annotations

import math

import torch

from . import reference as ref

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
TRIM = 1e-4  # share of a leaf's elements taken as kink crossings
ROUNDOFF = 1e-3  # gradient, relative to its leaf's (or the median leaf's), left to round-off
# The plain reference's peak per voxel of one warped sample: 22.0 GiB for a
# chain of experiment 3 at 256³ on the H100 (PERF.md §6); a VI row warps two.
PLAIN_BYTES_PER_VOXEL = 22.0 * 2 ** 30 / 256 ** 3
ROOM = 0.75  # the share of a card's memory the plain reference may take


class Record:
    """The program's state before its first step (``leaves0``), its
    optimisers' first moments and leaves after it (``moments1``,
    ``leaves1``), its leaves after the last (``leaves_end``) and the loss
    of each step and row (``losses``, ``(steps, rows)``)."""

    def __init__(self):
        self.leaves0 = self.leaves1 = self.moments1 = self.leaves_end = None
        self.losses = []


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _kept(p: torch.Tensor, r: torch.Tensor, mask=None, trim: float = TRIM) -> tuple:
    """``p`` and ``r`` flattened, without the elements ``mask`` leaves out
    and the ``trim`` share where they differ most."""
    p, r = p.flatten(), r.flatten()
    if mask is not None:
        p, r = p[mask.flatten()], r[mask.flatten()]
    k = int(p.numel() * trim)
    if k:
        keep = torch.ones(p.shape, dtype=torch.bool, device=p.device)
        keep[torch.topk((p - r).abs(), k).indices] = False
        p, r = p[keep], r[keep]
    return p, r


def _worst(prog: dict, refs: dict, keep=None, masks=None, trim: float = TRIM) -> tuple:
    """The largest ``|‖p‖ - ‖r‖| / max(‖r‖, median ‖r‖)`` over the leaves
    of ``keep`` (default: all), each leaf without the elements
    :func:`_kept` leaves out, and its leaf; each on the reference leaf's
    device."""
    masks = masks or {}
    norms = {k: _norm(r) for k, r in refs.items()}
    median = sorted(norms.values())[len(norms) // 2]
    worst, where = 0.0, None
    for k in (keep if keep is not None else refs):
        pk = prog[k].to(refs[k].device)
        if not bool(torch.isfinite(pk).all()):
            return math.inf, k
        p, r = _kept(pk, refs[k], masks.get(k), trim)
        gap = abs(_norm(p) - _norm(r)) / max(_norm(r), median, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, where = gap, k
    return worst, where


def card_bytes(device) -> int | None:
    """The memory of ``device`` where it is a card, else None."""
    device = torch.device(device)
    return torch.cuda.get_device_properties(device).total_memory if device.type == "cuda" else None


def recompute_on(phase: str, cfg: dict, device) -> bool:
    """Whether the reference runs under recompute on ``device``: where its
    plain step's estimated peak for one row (``PLAIN_BYTES_PER_VOXEL`` per
    voxel and warped sample) is over ``ROOM`` of the card's memory; never
    off a card."""
    total = card_bytes(device)
    if total is None:
        return False
    samples = 2 if phase == "vi" else 1
    voxels = math.prod(int(n) for n in cfg["data_loader"]["args"]["dims"])
    return samples * voxels * PLAIN_BYTES_PER_VOXEL > ROOM * total


def reference_run(phase: str, cfg: dict, traffic: dict, inputs, devices) -> tuple:
    """The reference's steps for every row, in turn (one dict per row), and
    its model.  ``devices``: the run's device, or the shards' devices of a
    step cut over several (row ``r`` runs on the ``r``-th distinct one,
    cyclically)."""
    devices = list(devices) if isinstance(devices, (list, tuple)) else [devices]
    cards = list(dict.fromkeys(devices))
    models = {d: ref.Model(cfg, d, recompute=recompute_on(phase, cfg, d)) for d in cards}
    steps = int(traffic["check_steps"])
    out = []
    for i, pair in enumerate(inputs.pairs):
        rows = inputs.v0.shape[1] if phase == "mcmc" else 1
        for c in range(rows):
            dev = cards[len(out) % len(cards)]
            fixed, moving = ({k: t.to(dev) for k, t in im.items()} for im in pair)
            if phase == "mcmc":
                out.append(ref.mcmc_chain(models[dev], fixed, moving, inputs.v0[i, c].to(dev),
                                          inputs.keys[i, c].tolist(), steps))
            else:
                out.append(ref.vi_pair(models[dev], fixed, moving, inputs.keys[i].tolist(),
                                       steps, int(traffic["gmm_warmup_steps"])))
            del fixed, moving
    return out, models[cards[0]]


def numbers(phase: str, cfg: dict, traffic: dict, inputs, record: Record, devices) -> dict:
    """The three numbers of the comparison, and where each is worst."""
    refs, model = reference_run(phase, cfg, traffic, inputs, devices)
    rows = len(refs)
    prog_losses = torch.stack([l.reshape(-1) for l in record.losses]).double().cpu()
    ref_losses = torch.stack([r["losses"].cpu() for r in refs], dim=1).double()
    loss_gaps = (prog_losses - ref_losses).abs() / ref_losses.abs().clamp_min(1e-30)

    g_prog, g_ref, d_prog, d_ref = {}, {}, {}, {}
    for k, t in record.moments1.items():
        for r, row in enumerate(t):
            g_prog[f"{k}[{r}]"] = row / (1.0 - ref.B1_ADAM)
    if phase == "mcmc":
        for r in range(rows):
            i, c = divmod(r, inputs.v0.shape[1])
            dev = refs[r]["first"]["v"].device
            eps = ref.mcmc_noise(model, inputs.keys[i, c].tolist(), 0, dev)
            v0, v1 = record.leaves0["v"][r].to(dev), record.leaves1["v"][r].to(dev)
            g_prog[f"v[{r}]"] = (v0 + math.sqrt(2.0 * model.tau) * eps - v1) / model.tau
    for r, res in enumerate(refs):
        for k, g in res["first"].items():
            g_ref[f"{k}[{r}]"] = g
        for k, t in res["leaves"].items():
            start = record.leaves0[k][r].to(t.device)
            d_ref[f"{k}[{r}]"] = t - start
            d_prog[f"{k}[{r}]"] = record.leaves_end[k][r].to(t.device) - start
    grad_gap, grad_at = _worst(g_prog, g_ref)
    norms = {k: _norm(g) for k, g in g_ref.items()}
    median = sorted(norms.values())[len(norms) // 2]
    still = {k for k, n in norms.items() if n < ROUNDOFF * median}
    masks = {k: g.abs() >= ROUNDOFF * norms[k] / math.sqrt(g.numel()) for k, g in g_ref.items()
             if k in d_ref}
    change_gap, change_at = _worst(d_prog, d_ref, [k for k in d_ref if k not in still], masks)
    return {
        "loss_gap": float(loss_gaps.max()) if torch.isfinite(loss_gaps).all() else math.inf,
        "grad_gap": grad_gap,
        "change_gap": change_gap,
        "_where": {"loss_gap": [int(x) for x in divmod(int(loss_gaps.argmax()), rows)],
                   "grad_gap": grad_at, "change_gap": change_at, "left_out": sorted(still),
                   # the two gaps with every element kept, for the record
                   "untrimmed": {"grad_gap": _worst(g_prog, g_ref, trim=0.0)[0],
                                 "change_gap": _worst(d_prog, d_ref, list(d_ref), trim=0.0)[0]}},
    }


def judge(found: dict, limits: dict) -> tuple:
    """``(correct, checked)``: every number finite and within its limit
    (a missing limit fails), and each number beside its limit."""
    checked = {k: {"value": found[k], "limit": limits.get(k)} for k in NUMBERS}
    ok = all(c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checked.values())
    return ok, checked
