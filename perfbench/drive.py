"""The system under test for one cell: the port's config layer, its states
and the chunk entries the trainer runs, built from the cell's files.

Everything else the benchmark needs from the program is read here too:
the states' leaves as rows (one row per chain, or per VI pair) for the
comparison, and the per-step loss from the metrics each call returns.
"""

from __future__ import annotations

import copy
import math
from contextlib import contextmanager

import torch

from . import phantom


class Inputs:
    """What the benchmark makes from the seed and hands to both sides: the
    phantom pairs, each chain's start ``v0`` and every row's key words."""

    def __init__(self, seed: int, traffic: dict, dims, field_dims, device):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        self.pairs = phantom.phantom_pairs(gen, int(traffic["pairs"]), dims, device)
        n_pairs = len(self.pairs)
        if traffic["phase"] == "mcmc":
            if traffic["start"] != "noise":
                raise ValueError(f"no MCMC start {traffic['start']!r} (the cells start from noise)")
            chains = int(traffic["chains"])
            self.v0 = torch.randn((n_pairs, chains, 3) + tuple(field_dims), generator=gen,
                                  device=device)
            self.keys = torch.randint(0, 2 ** 32, (n_pairs, chains, 2), generator=gen,
                                      dtype=torch.int64, device=device).cpu()
        else:
            if traffic["start"] != "config":
                raise ValueError(f"no VI start {traffic['start']!r} (q(v) starts as configured)")
            self.v0 = None
            self.keys = torch.randint(0, 2 ** 32, (n_pairs, 2), generator=gen,
                                      dtype=torch.int64, device=device).cpu()


def configured(config: dict, traffic: dict, dims=None, compute_dtype=None) -> dict:
    """The configuration as the program and the reference read it: the
    traffic's noise scheme, the cell's sizes (a test may ask for smaller
    ones) and, for the precision control, the program's own bfloat16
    integrator."""
    cfg = copy.deepcopy(config)
    cfg["trainer"].setdefault("uniform_noise", {})["scheme"] = traffic["noise_scheme"]
    if dims is not None:
        cfg["data_loader"]["args"]["dims"] = [int(n) for n in dims]
    if compute_dtype is not None:
        cfg["transformation_module"]["args"]["compute_dtype"] = compute_dtype
    return cfg


def vi_remat(cfg: dict) -> bool:
    """Whether VI runs its antithetic rows in turn under recompute: the
    configuration's ``trainer.vi_remat``, where ``"auto"`` (the default) is
    the trainer's rule, a dense float32 field of at least 100 MiB.  A copy
    of ``Trainer``'s rule (a test holds it equal)."""
    remat = cfg["trainer"].get("vi_remat", "auto")
    if remat == "auto":
        remat = 3 * 4 * math.prod(int(n) for n in cfg["data_loader"]["args"]["dims"]) \
            >= 100 * 1024 * 1024
    return bool(remat)


@contextmanager
def half_batch_fault():
    """A planted fault: the forward chain hands the second half of its
    batch the first half's residuals, as if half of the batch were left
    out and the rest stood in for it.  Where the rows run one at a time
    (VI under remat) each call's batch is one row and the fault changes
    nothing; those cells are calibrated on :func:`half_sample_fault`
    instead."""
    from ir_sgmcmc_tpu_torch.engine import mcmc, vi

    real = vi.forward_sample

    def faulty(*args, **kwargs):
        out = real(*args, **kwargs)
        res = out["residuals"]
        h = res.shape[0] // 2
        out["residuals"] = torch.cat([res[:h], res[:h]] if res.shape[0] % 2 == 0
                                     else [res[:h + 1], res[:h]])
        return out

    vi.forward_sample = mcmc.forward_sample = faulty
    try:
        yield
    finally:
        vi.forward_sample = mcmc.forward_sample = real


@contextmanager
def half_sample_fault():
    """A planted fault of VI: the antithetic pair's second sample is the
    first, as if the second half of the batch were left out and the mean
    taken over the rest.  It acts on the samples before the forward chain,
    so it also holds where the rows run one at a time (remat)."""
    from ir_sgmcmc_tpu_torch.engine import vi

    real = vi.sample_q_v

    def faulty(*args, antithetic=False, **kwargs):
        out = real(*args, antithetic=antithetic, **kwargs)
        return (out[0], out[0]) if antithetic else out

    vi.sample_q_v = faulty
    try:
        yield
    finally:
        vi.sample_q_v = real


@contextmanager
def tile_fault(size: int = 8):
    """A planted fault confined to one ``size``³ tile of every row: the
    residuals of the tile at the volume's centre are its neighbour's along
    W, as if a tiled kernel wrote one tile in the wrong place."""
    from ir_sgmcmc_tpu_torch.engine import mcmc, vi

    real = vi.forward_sample

    def faulty(*args, **kwargs):
        out = real(*args, **kwargs)
        out["residuals"] = _tile(out["residuals"], size)
        return out

    vi.forward_sample = mcmc.forward_sample = faulty
    try:
        yield
    finally:
        vi.forward_sample = mcmc.forward_sample = real


def _tile(t: torch.Tensor, size: int) -> torch.Tensor:
    """``t`` with the ``size``³ tile at its volume's centre holding its
    neighbour's values along W."""
    t = t.clone()
    z, y, x = (n // 2 // size * size for n in t.shape[-3:])
    t[..., z:z + size, y:y + size, x:x + size] = t[..., z:z + size, y:y + size, x + size:x + 2 * size]
    return t


class _TileGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, size):
        ctx.size = size
        return d.view_as(d)

    @staticmethod
    def backward(ctx, g):
        return _tile(g, ctx.size), None


@contextmanager
def dgrad_tile_fault(size: int = 8):
    """A planted fault confined to one ``size``³ tile of the block warp's
    gradient by the displacement (kernel B4's output on the card): the
    tile at the volume's centre holds its neighbour's.  The forward pass,
    and so every loss of the first step, is untouched."""
    from ir_sgmcmc_tpu_torch.engine import vi

    real = vi.warp_block_gather

    def faulty(vol, d, *args, **kwargs):
        return real(vol, _TileGrad.apply(d, size), *args, **kwargs)

    vi.warp_block_gather = faulty
    try:
        yield
    finally:
        vi.warp_block_gather = real


FAULTS = {"half": half_batch_fault, "half_sample": half_sample_fault, "tile": tile_fault,
          "tile4": lambda: tile_fault(4), "dgrad_tile": dgrad_tile_fault,
          "dgrad_tile4": lambda: dgrad_tile_fault(4)}


class Program:
    """One cell's program objects: ``state`` and ``call()``, one call of the
    entry the window drives (``steps_per_call`` steps).  VI is built with
    the trainer's remat (:func:`vi_remat`); ``remat`` says which."""

    def __init__(self, cfg: dict, traffic: dict, inputs: Inputs, device, fault=None):
        from ir_sgmcmc_tpu_torch.config import Config

        config = Config(cfg, make_dirs=False)
        self.loader_args = cfg["data_loader"]["args"]
        self.bundle = bundle = config.build_bundle()
        self.opt_q_v, self.opt_gmm, self.opt_reg = config.build_optimizers(bundle)
        self.tau = config.tau
        self.phase = traffic["phase"]
        self.n_pairs = len(inputs.pairs)
        self.fault = fault
        self.remat = self.phase == "vi" and vi_remat(cfg)
        chunk = int(traffic["steps_per_call"])
        fixeds = [f for f, _ in inputs.pairs]
        movings = [m for _, m in inputs.pairs]
        if self.phase == "mcmc":
            self._build_mcmc(traffic, inputs, fixeds, movings, chunk, device)
        elif self.phase == "vi":
            self._build_vi(traffic, inputs, fixeds, movings, chunk, device)
        else:
            raise ValueError(f"unknown phase {self.phase!r}")

    def _build_mcmc(self, traffic, inputs, fixeds, movings, chunk, device):
        from ir_sgmcmc_tpu_torch.engine import init_chains, make_mcmc_chunk
        from ir_sgmcmc_tpu_torch.engine.pairs import make_pair_mcmc_chunk, stack_trees

        b = self.bundle
        states = []
        for i in range(self.n_pairs):
            s = init_chains(b, torch.Generator(device=device), int(traffic["chains"]), "identity",
                            None, b.gmm.init_params(device), b.reg_loss.init_params(device),
                            self.opt_gmm, self.opt_reg, device=device)
            states.append(s._replace(v=inputs.v0[i].clone(), key=inputs.keys[i].clone()))
        burn_in, thin = int(traffic["burn_in"]), int(traffic["thin"])
        if self.n_pairs == 1:
            self.state = states[0]
            run = make_mcmc_chunk(b, self.opt_gmm, self.opt_reg, self.tau, fixeds[0], movings[0],
                                  chunk=chunk, burn_in=burn_in, thin=thin)
            self._lead = 1
        else:
            self.state = stack_trees(states)
            run = make_pair_mcmc_chunk(b, self.opt_gmm, self.opt_reg, self.tau,
                                       stack_trees(fixeds), stack_trees(movings), chunk=chunk,
                                       burn_in=burn_in, thin=thin)
            self._lead = 2
        self._run = run

    def _build_vi(self, traffic, inputs, fixeds, movings, chunk, device):
        from ir_sgmcmc_tpu_torch.engine import VIState, make_vi_chunk, make_vi_step
        from ir_sgmcmc_tpu_torch.engine.pairs import make_pair_vi_chunk, stack_trees

        b = self.bundle
        sigma_v = float(self.loader_args["sigma_v_init"])
        u_v = float(self.loader_args["u_v_init"])
        states = []
        for i in range(self.n_pairs):
            q_v = b.init_q_v(sigma_v, u_v, device)
            gmm, reg = b.gmm.init_params(device), b.reg_loss.init_params(device)
            s = VIState(q_v=q_v, gmm=gmm, reg=reg, opt_q_v=self.opt_q_v.init(q_v),
                        opt_gmm=self.opt_gmm.init(gmm), opt_reg=self.opt_reg.init(reg),
                        key=inputs.keys[i].clone(), step=0)
            states.append(s)
        self.warmup_steps = int(traffic["gmm_warmup_steps"])
        self._warmup_args = (states, fixeds, movings)
        if self.n_pairs == 1:
            self._run = make_vi_chunk(make_vi_step(b, self.opt_q_v, self.opt_gmm, self.opt_reg,
                                                   fixeds[0], movings[0], remat=self.remat),
                                      chunk)
            self._lead = 0
        else:
            self._run = make_pair_vi_chunk(b, self.opt_q_v, self.opt_gmm, self.opt_reg,
                                           stack_trees(fixeds), stack_trees(movings), chunk,
                                           remat=self.remat)
            self._lead = 1
        self.state = states[0] if self.n_pairs == 1 else stack_trees(states)

    def gmm_warmup(self):
        """The VI cells' GMM warm-up, pair by pair, as the trainer runs it."""
        from ir_sgmcmc_tpu_torch.engine import gmm_warmup
        from ir_sgmcmc_tpu_torch.engine.pairs import stack_trees

        states, fixeds, movings = self._warmup_args
        warm = [gmm_warmup(self.bundle, self.opt_gmm, s, f, m, no_steps=self.warmup_steps)
                for s, f, m in zip(states, fixeds, movings)]
        self.state = warm[0] if self.n_pairs == 1 else stack_trees(warm)

    def call(self):
        """One call of the window's entry; returns the per-step loss of
        every row, ``(steps_per_call, rows)``."""
        if self.fault in FAULTS:
            with FAULTS[self.fault]():
                new, metrics = self._run(self.state)
        else:
            new, metrics = self._run(self.state)
        if self.fault != "unchanged":
            self.state = new
        return self.losses(metrics)

    def losses(self, metrics) -> torch.Tensor:
        if self.phase == "mcmc":
            loss = metrics["data_term"] + metrics["reg_term"]  # (chunk, C) or (P, chunk, C)
            if self._lead == 2:
                loss = loss.transpose(0, 1)
            return loss.reshape(loss.shape[0], -1)
        loss = metrics["total_loss"]  # (chunk,) or (P, chunk)
        return loss.reshape(-1, 1) if self._lead == 0 else loss.transpose(0, 1)

    # ---- the state as rows, for the comparison
    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        if self._lead == 0:
            return t.unsqueeze(0)
        if self._lead == 2:
            return t.reshape((-1,) + tuple(t.shape[2:]))
        return t

    def leaves(self) -> dict:
        """The parameters the steps move, and (SG-MCMC) the posterior mean
        accumulator, as ``(rows, …)`` copies."""
        s = self.state
        if self.phase == "mcmc":
            out = {"v": s.v, "welford.mean": s.welford.mean}
        else:
            out = {f"q.{k}": t for k, t in s.q_v.items()}
        out.update({f"gmm.{k}": t for k, t in s.gmm.items()})
        if self.bundle.reg_loss.learnable:
            out.update({f"reg.{k}": t for k, t in s.reg.items()})
        return {k: self._rows(t).detach().clone() for k, t in out.items()}

    def first_moments(self) -> dict:
        """Adam's first moments of the optimisers, as rows (after one step
        from zero they are ``(1 - b1)`` times the gradient)."""
        s = self.state
        out = {}
        if self.phase == "mcmc":
            out.update({f"gmm.{k}": t for k, t in s.opt_gmm.mu.items()})
        else:
            out.update({f"q.{k}": t for k, t in s.opt_q_v.mu.items()})
        if self.bundle.reg_loss.learnable:
            out.update({f"reg.{k}": t for k, t in s.opt_reg.mu.items()})
        return {k: self._rows(t).detach().clone() for k, t in out.items()}

    def finite_rows(self) -> torch.Tensor:
        """Whether each row's sampled field is finite."""
        t = self.state.v if self.phase == "mcmc" else self.state.q_v["mu"]
        t = self._rows(t)
        return torch.isfinite(t.reshape(t.shape[0], -1)).all(dim=1)
