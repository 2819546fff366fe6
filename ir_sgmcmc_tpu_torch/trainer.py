"""Two-phase VI -> SG-MCMC registration trainer (port of
``ir_sgmcmc_tpu/trainer.py``).

The engines run the hot loops; the host only:

* moves each image pair to the device once,
* runs VI and SG-MCMC chunks sized to the logging period,
* evaluates registration quality (Dice on the device, ASD on the host's
  writer thread) at log time,
* enforces the diffeomorphism guard (abort when a chain folds at more than
  ``non_diffeomorphic_tolerance`` of the voxels) and the saturation guard,
  with block-radius auto-escalation,
* writes scalars, NIfTI/VTK artifacts and time-gated checkpoints in the
  JAX package's formats.

Phases per pair: data -> GMM warm-up -> [VI -> VI test] -> [MCMC].  The
order of host work is the JAX trainer's, and with it the guards' semantics:
an MCMC period is processed after the next chunk has been dispatched, so a
guard fires one period after the chunk that tripped it, and the saved
posterior rolls back to the newest period that passed every guard.

Devices: the trainer runs on the CUDA card unless ``device="cpu"`` is
passed, and raises without a card.  The engines are functional (no state
tensor is updated in place), so a state handed to the writer thread needs
no copy.

Random streams: the JAX trainer draws from three threefry streams, the VI
key ``PRNGKey(seed + pair)``, ``fold_in(key, 101)`` for the VI test and
``fold_in(key, 202)`` for the chain init.  The port's VI state carries the
same two key words; the VI test and the chain init draw from torch
generators seeded from the VI state's key words with the salts 101 and 202
(``engine.vi.key_generator``).  A run therefore equals the JAX package's
in distribution, not bitwise, as the engines do.

Every transformation model of the JAX package runs: the dense SVF, SVFFD
(whose VI and chain states live on the control grid while evaluation,
Welford accumulators and artifacts stay on the dense grid), the B-spline
FFD and ``use_gather``.  ``MCMC_params: "shared"`` runs the reference's
shared GMM/reg set; ``vi_remat`` (``"auto"``: on from a dense field of
100 MB, about 204³, of one pair) runs VI's antithetic chains in turn with
recompute.  ``pair_parallel: true`` over several pairs registers them as
one batch (``engine/pairs.py``; :meth:`Trainer._run_pairs_parallel`).  Not
ported: ``mcmc_anchor: true`` raises ``NotImplementedError`` (ROADMAP
rule).  ``distribute``, ``spatial_shards`` and ``vi_spatial_shards`` are
accepted and, on one card, change nothing, as in the JAX trainer on one
device.  There is no kernel fallback: a kernel that fails to build or
launch raises.

``Trainer.timings`` accumulates wall seconds per span of host work (the
engines' chunks, evaluation, period processing, artifact writes, the
writer thread's work under ``writer/``), for the account of where a
phase's time goes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time

import numpy as np
import torch

from ._device import resolve_device
from .config import Config
from .engine import (VIState, gmm_warmup, init_chains, make_mcmc_chunk, make_vi_chunk,
                     make_vi_step, posterior_statistics)
from .engine.mcmc import welford_finalize, welford_init, welford_update
from .engine.pairs import (make_pair_mcmc_chunk, make_pair_vi_chunk, stack_trees, take_pairs,
                           unstack_tree)
from .engine.vi import key_generator
from .models.sampler import sample_q_v
from .ops.grids import count_non_diffeomorphic, det_jacobian
from .ops.resample import warp
from .ops.stencil import gradient
from .utils import savers
from .utils.checkpoint import load_checkpoint, peek_meta, save_checkpoint
from .utils.metrics import MetricTracker, calc_metrics, dice


class TrainerAbort(RuntimeError):
    """Base for runtime-guard aborts of a sampling phase."""


class NonDiffeomorphicAbort(TrainerAbort):
    """Raised when a sampled transformation folds at > ``tol`` of voxels."""


class DisplacementSaturationAbort(TrainerAbort):
    """Raised when displacements saturate a warp limit at > ``tol`` of
    voxels: the clamp silently corrupts the posterior there."""


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tensors(tree):
    """The tensor leaves of dicts and named tuples."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _host(tree: dict) -> dict:
    return {k: _numpy(v) for k, v in tree.items()}


def _last(metrics_stacked: dict) -> dict:
    """Final-step slice of stacked per-step chunk metrics."""
    return {k: v[-1] for k, v in metrics_stacked.items()}


def _first(batched: dict) -> dict:
    return {k: v[0] for k, v in batched.items()}


class _Fetch:
    """Device-to-host copies of small tensors, started when constructed and
    awaited by :meth:`get`.

    The JAX trainer reads a finished period's metrics after dispatching the
    next chunk, and XLA's per-buffer readiness lets that read return before
    the new chunk ends.  One CUDA stream would queue a plain ``.cpu()``
    behind the new chunk, so the copies are queued (into pinned memory)
    before it, and the read waits on their event alone."""

    def __init__(self, tensors: dict):
        self._host = {k: t.detach().to("cpu", non_blocking=True) for k, t in tensors.items()}
        self._event = None
        if any(t.is_cuda for t in tensors.values()):
            self._event = torch.cuda.Event()
            self._event.record()

    def get(self) -> dict:
        if self._event is not None:
            self._event.synchronize()
        return {k: t.numpy() for k, t in self._host.items()}


class Trainer:
    def __init__(self, config: Config, dataset=None, resume: str | None = None, device=None):
        self.config = config
        self.t_cfg = config["trainer"]
        self.logger = config.logger
        self.writer = config.writer
        self.device = resolve_device(device)
        self.dataset = dataset if dataset is not None else config.build_dataset()
        self.bundle = config.build_bundle()
        self.opt_q_v, self.opt_gmm, self.opt_reg = config.build_optimizers(self.bundle)
        self.resume_path = resume

        self.structures = getattr(self.dataset, "structures", None) or config.structures
        self.spacing = (1.0, 1.0, 1.0)  # refined per pair once a volume is read

        self.run_vi = bool(self.t_cfg.get("VI", False))
        self.run_mcmc = bool(self.t_cfg.get("MCMC", False))
        self.no_iters_vi = int(self.t_cfg.get("no_iters_VI", 0))
        self.no_samples_vi_test = int(self.t_cfg.get("no_samples_VI_test", 0))
        self.no_chains = int(self.t_cfg.get("no_chains", 1))
        self.no_iters_burn_in = int(self.t_cfg.get("no_iters_burn_in", 0))
        self.no_samples_mcmc = int(self.t_cfg.get("no_samples_MCMC", 0))
        self.log_period_vi = int(self.t_cfg.get("log_period_VI", 128))
        self.log_period_mcmc = int(self.t_cfg.get("log_period_MCMC", 1000))
        self.mcmc_init = self.t_cfg.get("MCMC_init", "VI")
        self.mcmc_param_mode = self.t_cfg.get("MCMC_params", "per_chain")
        self.compute_asd = bool(self.t_cfg.get("ASD", True))
        self.ndv_tol = float(self.t_cfg.get("non_diffeomorphic_tolerance", 0.001))
        self.sat_tol = float(self.t_cfg.get("saturation_tolerance", 0.001))
        self.speed_test_iters = int(self.t_cfg.get("speed_test_iters", 100))
        # checkpoints are time-gated (phase ends always checkpoint); artifact
        # saving has its own period, by default every log period
        self.ckpt_period_s = float(self.t_cfg.get("checkpoint_period_s", 300.0))
        self.save_period_mcmc = int(
            self.t_cfg.get("save_period_MCMC", self.log_period_mcmc))
        self._last_ckpt_t = float("-inf")
        remat = self.t_cfg.get("vi_remat", "auto")
        if remat == "auto":  # the JAX rule: a dense field of at least 100 MB
            remat = 3 * 4 * int(np.prod(self.bundle.dims)) >= 100 * 1024 * 1024
        self.vi_remat = bool(remat)
        self._refuse_unported()
        self.timings: dict = {}
        self._timings_lock = threading.Lock()  # the writer thread adds to it too
        self.pair_groups: list = []  # pairs per batch, per pair-stacked phase on the card

        keys = ["data_term", "reg_term", "entropy_term", "total_loss", "vd_alpha",
                "reg_energy", "ndv", "sat"]
        self.tracker = MetricTracker(*keys, writer=self.writer)
        self.writer.add_text("config", json.dumps(config.cfg, indent=2, default=str))

    def _refuse_unported(self) -> None:
        if self.run_mcmc and bool(self.t_cfg.get("mcmc_anchor", False)):
            raise NotImplementedError(
                "mcmc_anchor=true (anchored residual warping) is not ported "
                "(ROADMAP 'Rules of the port', Not ported)")

    # ------------------------------------------------------------- timing
    def _add_time(self, name: str, seconds: float) -> None:
        with self._timings_lock:
            self.timings[name] = self.timings.get(name, 0.0) + seconds

    def _timed(self, name: str, fn):
        """``fn`` with its wall time added to ``timings[name]`` (for closures
        run on the writer thread)."""

        def run():
            t0 = time.perf_counter()
            try:
                fn()
            finally:
                self._add_time(name, time.perf_counter() - t0)

        return run

    # ------------------------------------------------------------------ run
    def run(self):
        """Register every pair in the dataset; returns per-pair summaries."""
        if bool(self.t_cfg.get("pair_parallel", False)) and len(self.dataset) > 1:
            if self.mcmc_param_mode == "per_chain":
                summaries = self._run_pairs_parallel()
                self.writer.close()
                return summaries
            self.logger.warning(
                "pair_parallel requested but MCMC_params='shared' (sequential GMM "
                "updates) is not supported in the pair-stacked chunks — registering "
                "pairs sequentially")
        summaries = [self._run_pair(i) for i in range(len(self.dataset))]
        self.writer.close()
        return summaries

    def _save_dirs_for(self, pair_idx: int) -> dict:
        """Pair 0 keeps the run's artifact tree; later pairs get their own
        subtree so multi-pair runs never overwrite each other's outputs."""
        base = dict(self.config.save_dirs)
        if pair_idx == 0:
            return base
        dirs = {
            k: (p if k == "dir" else p.parent / f"pair_{pair_idx}" / p.name)
            for k, p in base.items()
        }
        for k, p in dirs.items():
            if k != "dir":
                p.mkdir(parents=True, exist_ok=True)
        return dirs

    def _to_device(self, arrays: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.device) for k, v in arrays.items()}

    def _initial_state(self, q_v0: dict, pair_idx: int) -> VIState:
        """q(v), GMM and reg parameters with fresh optimizers; the key words
        are ``PRNGKey(seed + pair_idx)``'s."""
        q_v = self._to_device(q_v0)
        gmm = self.bundle.gmm.init_params(self.device)
        reg = self.bundle.reg_loss.init_params(self.device)
        seed = int(self.t_cfg.get("seed", 0)) + pair_idx
        return VIState(
            q_v=q_v, gmm=gmm, reg=reg,
            opt_q_v=self.opt_q_v.init(q_v),
            opt_gmm=self.opt_gmm.init(gmm),
            opt_reg=self.opt_reg.init(reg),
            key=torch.tensor([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=torch.int64),
            step=0,
        )

    # ------------------------------------------------------ pair-parallel
    def _run_pairs_parallel(self) -> list:
        """Register ALL dataset pairs pair-stacked (``engine/pairs.py``).

        Each pair keeps its own parameters, chains and accumulators, so the
        VI and MCMC phases run pair-stacked: one kernel launch serves every
        pair of a batch, and the batch holds as many pairs as the card's
        free memory does (:meth:`_pair_group`; on the CPU all of them).  Host-side evaluation, artifact saving and the VI test stay
        per pair, on unstacked state after each phase.  As in the JAX
        trainer, by design: guards fire on the worst pair and abort the
        whole batch (the same data aborts its sequential run too); the
        per-sample MCMC dumps are replaced by phase-end artifacts; and
        checkpoints hold the pair-stacked state (in the JAX layout), record
        the pair count and resume only into a run of as many pairs.
        """
        n_pairs = len(self.dataset)
        self.logger.info("pair-parallel: %d pairs on %s", n_pairs, self.device)
        if self.dataset.im_spacing is not None:
            sp = np.ravel(np.asarray(self.dataset.im_spacing, np.float32))
            self.spacing = tuple(np.resize(sp, 3).tolist())

        pair_dirs = [self._save_dirs_for(i) for i in range(n_pairs)]
        fixeds, movings, states = [], [], []
        for i in range(n_pairs):
            fixed_np, moving_np, q_v0 = self.dataset[i]
            fixed, moving = self._to_device(fixed_np), self._to_device(moving_np)
            if fixeds and any(fixed[k].shape != fixeds[0][k].shape for k in fixed):
                raise ValueError(
                    f"pair {i} has a different volume shape than pair 0 — "
                    f"pair_parallel stacks pairs and needs equal dims "
                    f"(the loader's pad-to-cube dims setting)")
            savers.save_fixed_im(pair_dirs[i], self.spacing, fixed_np["im"])
            savers.save_moving_im(pair_dirs[i], self.spacing, moving_np["im"])
            savers.save_fixed_mask(pair_dirs[i], self.spacing, fixed_np["mask"])
            savers.save_moving_mask(pair_dirs[i], self.spacing, moving_np["mask"])
            states.append(gmm_warmup(self.bundle, self.opt_gmm,
                                     self._initial_state(q_v0, i), fixed, moving))
            fixeds.append(fixed)
            movings.append(moving)

        summaries = [{"pair": i} for i in range(n_pairs)]
        labels = list(self.structures.values())
        for i in range(n_pairs):
            dsc0 = dice(fixeds[i]["seg"], movings[i]["seg"], labels)
            summaries[i]["dsc_before"] = float(dsc0.mean())
            self.logger.info("pair %d: pre-registration mean Dice %.4f",
                             i, summaries[i]["dsc_before"])

        # a pair-stacked checkpoint records its pair count; anything else (a
        # count mismatch, a sequential per-pair checkpoint) is refused
        vi_resume = mcmc_resume = None
        if self.resume_path:
            meta = peek_meta(self.resume_path)
            ck_pairs = int(meta.get("pair_parallel", 0) or 0)
            if ck_pairs != n_pairs:
                raise ValueError(
                    f"{self.resume_path}: checkpoint holds "
                    f"{ck_pairs if ck_pairs else 'non-pair-stacked'} pair(s) but this "
                    f"run registers {n_pairs} — resume needs the same dataset and "
                    f"pair_parallel setting")
            phase = meta.get("phase")
            if phase == "VI":
                vi_resume = self.resume_path
            elif phase == "MCMC":
                mcmc_resume = self.resume_path
            else:
                raise ValueError(f"{self.resume_path}: checkpoint metadata names neither "
                                 f"the VI nor the MCMC phase (meta={meta})")

        fixed_st, moving_st = stack_trees(fixeds), stack_trees(movings)
        if self.run_vi and self.no_iters_vi > 0 and mcmc_resume is None:
            state_st, vi_time = self._run_pair_vi_phase(fixed_st, moving_st,
                                                        stack_trees(states), vi_resume)
            states = [unstack_tree(state_st, i) for i in range(n_pairs)]
            for i in range(n_pairs):
                summaries[i]["vi_time_s"] = vi_time
                with self._pair_view(i, pair_dirs[i]):
                    summaries[i].update(self._test_vi(fixeds[i], movings[i], states[i]))
        if self.run_mcmc:
            results = self._run_pair_mcmc_phase(fixeds, movings, fixed_st, moving_st, states,
                                                pair_dirs, mcmc_resume)
            for s, r in zip(summaries, results):
                s.update(r)
        return summaries

    @contextlib.contextmanager
    def _pair_view(self, i: int, dirs: dict):
        """Artifacts into pair ``i``'s tree and scalars under ``pair{i}/``
        (pair 0 keeps the run's own) inside the ``with`` block."""
        self.save_dirs = dirs
        self.writer.prefix = f"pair{i}/" if i else ""
        try:
            yield
        finally:
            self.writer.prefix = ""

    def _pair_group(self, chunk, state, fixed_st: dict, moving_st: dict) -> int | None:
        """Pairs per batch of the pair-stacked chunks ``chunk(n, group=None,
        images=(fixed, moving))``.  On the CPU all of them (None).  On the
        card, as many as its free memory holds at one pair's peak, measured
        on one step of pair 0 whose result is dropped, after room for two
        more copies of the pair-stacked ``state`` (the groups' outputs, and
        their concatenation, beside the input).  The card's peak-memory
        counter is reset for the measurement."""
        n_pairs = int(state.step.shape[0])
        if self.device.type != "cuda" or n_pairs == 1:
            return None
        dev, one = self.device, slice(0, 1)
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        chunk(1, images=(take_pairs(fixed_st, one), take_pairs(moving_st, one)))(
            take_pairs(state, one))
        torch.cuda.synchronize(dev)
        peak = max(1, torch.cuda.max_memory_allocated(dev) - base)
        state_bytes = sum(t.numel() * t.element_size() for t in _tensors(state) if t.is_cuda)
        free, _ = torch.cuda.mem_get_info(dev)
        room = (free + torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
                - 2 * state_bytes)
        group = max(1, min(n_pairs, int(0.9 * room) // peak))
        self.logger.info("pair-parallel: one pair peaks at %.3f GiB, %.3f GiB free: %d of %d "
                         "pairs per batch", peak / 2**30, room / 2**30, group, n_pairs)
        self.pair_groups.append(group)
        return group

    def _run_pair_vi_phase(self, fixed_st, moving_st, state_st: VIState, resume=None):
        """The pair-stacked VI loop: per-pair scalars, the saturation guard
        on the worst pair, checkpoints with meta ``pair_parallel``.
        Returns ``(state, wall seconds)``."""
        n_pairs = int(state_st.step.shape[0])
        done = 0
        if resume:
            state_st, meta = load_checkpoint(resume, state_st)
            done = int(meta.get("vi_iters", 0))
            self.logger.info("resumed pair-stacked VI from %s at %s", resume, meta)
        cap = int(self.t_cfg.get("max_device_chunk", 200))

        def chunk(n, group=None, images=(fixed_st, moving_st)):
            return make_pair_vi_chunk(self.bundle, self.opt_q_v, self.opt_gmm, self.opt_reg,
                                      *images, chunk=n, remat=self.vi_remat, group=group)

        group = (self._pair_group(chunk, state_st, fixed_st, moving_st)
                 if done < self.no_iters_vi else None)
        log_period = max(1, min(self.log_period_vi, self.no_iters_vi))
        t0 = time.perf_counter()
        try:
            while done < self.no_iters_vi:
                this = min(log_period, self.no_iters_vi - done)
                t_a = time.perf_counter()
                while this > 0:
                    n = min(cap, this)
                    state_st, ms = chunk(n, group)(state_st)
                    this -= n
                    done += n
                last = _host({k: v[:, -1] for k, v in ms.items()})  # (P, …) per pair
                self._add_time("pairs/vi_steps", time.perf_counter() - t_a)
                self.writer.set_step(done)
                for i in range(n_pairs):
                    self.writer.prefix = f"pair{i}/" if i else ""
                    for k in ("data_term", "reg_term", "entropy_term", "total_loss",
                              "vd_alpha", "reg_energy", "ndv", "sat"):
                        self.writer.add_scalar(f"VI/{k}", float(last[k][i]))
                self.writer.prefix = ""
                self._check_guards(last, done, "VI")
                self.logger.info("VI %d/%d loss %s ndv %s (per pair)", done, self.no_iters_vi,
                                 np.array2string(last["total_loss"], precision=1),
                                 last["ndv"])
                self._maybe_checkpoint(self.config.save_dirs["models"] / "vi_latest.npz",
                                       state_st, self._ckpt_meta("VI", done, n_pairs),
                                       force=done >= self.no_iters_vi)
        finally:
            savers.flush()
        vi_time = time.perf_counter() - t0
        self.logger.info("VI phase took %.1fs for %d pairs (%.2f aggregate iters/sec)",
                         vi_time, n_pairs, n_pairs * self.no_iters_vi / vi_time)
        return state_st, vi_time

    def _run_pair_mcmc_phase(self, fixeds, movings, fixed_st, moving_st, states, pair_dirs,
                             resume=None) -> list:
        """The pair-stacked SG-MCMC loop: chains initialised per pair from
        each pair's VI key (salt 202, as the sequential path), the fold and
        saturation guards on the worst pair, block-radius auto-escalation
        that resumes every pair from the last clean period, checkpoints with
        meta ``pair_parallel``, then each pair's posterior, evaluation and
        phase-end samples.  Returns one summary update per pair."""
        n_pairs = len(states)
        total = self.no_iters_burn_in + self.no_samples_mcmc
        mcmc_st = stack_trees([init_chains(
            self.bundle, key_generator(s.key, s.step, self.device, salt=202),
            no_chains=self.no_chains, mode=self.mcmc_init,
            q_v=s.q_v if self.mcmc_init == "VI" else None, gmm=s.gmm, reg=s.reg,
            opt_gmm=self.opt_gmm, opt_reg=self.opt_reg, device=self.device)
            for s in states])
        done = 0
        if resume:
            mcmc_st, meta = load_checkpoint(resume, mcmc_st)
            self.logger.info("resumed pair-stacked MCMC from %s at %s", resume, meta)
            done = int(meta.get("mcmc_steps", 0))
            self._restore_radius(meta)
        cap = int(self.t_cfg.get("max_device_chunk", 200))
        thin = int(self.t_cfg.get("mcmc_thin", 1))

        def chunk(n, group=None, images=(fixed_st, moving_st)):
            """Built from ``self.bundle`` as it stands (an escalated radius
            at once)."""
            return make_pair_mcmc_chunk(self.bundle, self.opt_gmm, self.opt_reg,
                                        self.config.tau, *images, chunk=n,
                                        burn_in=self.no_iters_burn_in, thin=thin, group=group)

        group = self._pair_group(chunk, mcmc_st, fixed_st, moving_st) if done < total else None

        def run_steps(mcmc_st, n):
            """``n`` transitions in chunks of at most ``cap``."""
            ms = None
            while n > 0:
                this = min(cap, n)
                mcmc_st, ms = chunk(this, group)(mcmc_st)
                n -= this
            return mcmc_st, ms

        last_good = None  # (done, state) of the newest clean period
        escalations = []
        log_period = max(1, min(self.log_period_mcmc, total))
        t0 = time.perf_counter()
        aborted = None
        try:
            while done < total:
                this = min(log_period, total - done)
                try:
                    t_a = time.perf_counter()
                    mcmc_st, ms = run_steps(mcmc_st, this)
                    done += this
                    last = _host({k: v[:, -1] for k, v in ms.items()})  # (P, C, …)
                    self._add_time("pairs/mcmc_chunks", time.perf_counter() - t_a)
                    self.writer.set_step(done)
                    for i in range(n_pairs):
                        self.writer.prefix = f"pair{i}/" if i else ""
                        self._write_chain_scalars({k: v[i] for k, v in last.items()})
                    self.writer.prefix = ""
                    self._check_guards(last, done, "MCMC", " (worst pair)")
                except DisplacementSaturationAbort as e:
                    new_r = self._escalated_radius(e, last_good is not None)
                    if new_r is None:
                        raise
                    done, mcmc_st = last_good
                    escalations.append(self._escalate(e, new_r, done, " (pair-parallel, all "
                                                                     "pairs)"))
                    continue
                last_good = (done, mcmc_st)  # the engines never update in place
                self.logger.info("MCMC %d/%d data %s ndv_max %d (pairs x chains)", done,
                                 total, np.array2string(last["data_term"], precision=1),
                                 int(last["ndv"].max()))
                self._maybe_checkpoint(self.config.save_dirs["models"] / "mcmc_latest.npz",
                                       mcmc_st, self._ckpt_meta("MCMC", done, n_pairs),
                                       force=done >= total)
        except TrainerAbort as e:
            self.logger.error("MCMC aborted: %s", e)
            aborted = str(e)
        finally:
            mcmc_time = time.perf_counter() - t0
            savers.flush()

        agg = n_pairs * self.no_chains * done / mcmc_time if done else 0.0
        self.logger.info("MCMC phase: %d steps x %d pairs x %d chains in %.1fs "
                         "(%.2f aggregate samples/sec)", done, n_pairs, self.no_chains,
                         mcmc_time, agg)
        results = []
        t_e = time.perf_counter()
        for i in range(n_pairs):
            r = {"mcmc_time_s": mcmc_time, "mcmc_aggregate_samples_per_sec": agg}
            if escalations:
                r["block_radius_escalations"] = list(escalations)
            results.append(r)
            if aborted is not None:
                r["mcmc_aborted"] = aborted
                continue
            mcmc_i = unstack_tree(mcmc_st, i)
            with self._pair_view(i, pair_dirs[i]):
                if float(mcmc_i.welford.count.sum()) > 1:
                    mean, std = posterior_statistics(mcmc_i)
                    savers.save_displacement_mean_and_std_dev(
                        self.save_dirs, self.spacing, mean, std, fixeds[i]["mask"], "MCMC")
                outs = self._make_eval(fixeds[i], movings[i])(mcmc_i.v)
                fixed_seg_np = _numpy(fixeds[i]["seg"])
                dscs = []
                for c in range(self.no_chains):
                    out_c = {k: v[c] for k, v in outs.items()}
                    dscs.append(self._log_seg_metrics(fixed_seg_np, out_c, "MCMC", chain=c))
                    self._submit_sample(done - self.no_iters_burn_in, out_c, "MCMC", chain=c)
                r["mcmc_mean_dsc"] = float(np.mean(dscs))
        savers.flush()
        self._add_time("pairs/mcmc_artifacts", time.perf_counter() - t_e)
        return results

    def _run_pair(self, pair_idx: int) -> dict:
        self.save_dirs = self._save_dirs_for(pair_idx)

        fixed_np, moving_np, q_v0 = self.dataset[pair_idx]
        if self.dataset.im_spacing is not None:
            sp = np.ravel(np.asarray(self.dataset.im_spacing, np.float32))
            self.spacing = tuple(np.resize(sp, 3).tolist())
        fixed = self._to_device(fixed_np)
        moving = self._to_device(moving_np)

        savers.save_fixed_im(self.save_dirs, self.spacing, fixed_np["im"])
        savers.save_moving_im(self.save_dirs, self.spacing, moving_np["im"])
        savers.save_fixed_mask(self.save_dirs, self.spacing, fixed_np["mask"])
        savers.save_moving_mask(self.save_dirs, self.spacing, moving_np["mask"])

        state = self._initial_state(q_v0, pair_idx)

        resume_meta = {}
        self._mcmc_resume = None
        # resume applies to pair 0 only: a checkpoint holds one pair's state
        resume_path = self.resume_path if pair_idx == 0 else None
        if resume_path:
            meta = peek_meta(resume_path)
            phase = meta.get("phase")
            if phase is None and "phase_done" in meta:  # round-1 checkpoints
                phase = "MCMC" if int(meta["phase_done"]) >= 1 else "VI"
            if phase == "VI":
                state, resume_meta = load_checkpoint(resume_path, state)
                self.logger.info("resumed from %s at %s", resume_path, resume_meta)
            elif phase == "MCMC":
                # the MCMC phase loads it into the chain-state template
                self._mcmc_resume = resume_path
                resume_meta = {"phase_done": 1}
                state = gmm_warmup(self.bundle, self.opt_gmm, state, fixed, moving)
            else:
                raise ValueError(
                    f"{resume_path}: checkpoint metadata names neither the "
                    f"VI nor the MCMC phase (meta={meta}); refusing to guess"
                )
        else:
            # GMM warm-up: data-driven scale init + 25 detached Adam steps
            state = gmm_warmup(self.bundle, self.opt_gmm, state, fixed, moving)

        summary = {"pair": pair_idx}
        baseline_dsc = dice(fixed["seg"], moving["seg"], list(self.structures.values()))
        summary["dsc_before"] = float(baseline_dsc.mean())
        self.logger.info("pair %d: pre-registration mean Dice %.4f",
                         pair_idx, summary["dsc_before"])

        if self.run_vi and int(resume_meta.get("phase_done", -1)) < 1:
            t0 = time.perf_counter()
            state = self._run_vi_phase(fixed, moving, state,
                                       start=int(resume_meta.get("vi_iters", 0)))
            summary["vi_time_s"] = time.perf_counter() - t0
            self.logger.info("VI phase took %.1fs", summary["vi_time_s"])
            summary.update(self._test_vi(fixed, moving, state))

        if self.run_mcmc:
            summary.update(self._run_mcmc_phase(fixed, moving, state))

        return summary

    # ---------------------------------------------------------- evaluation
    def _transform(self, v, im):
        """``(transformation, displacement, im warped)`` of smoothed ``v``: the
        model's integration with the image, or, for a model without one
        (``BSplineFFD3D``), its transformation and a trilinear warp."""
        tr = self.bundle.transformation
        if hasattr(tr, "integrate"):
            return tr.integrate(v, im=im)
        transformation, displacement = tr(v)
        return transformation, displacement, warp(im, transformation, method="linear")

    def _make_eval(self, fixed, moving):
        """Sample evaluation over a leading batch: ``v_unsmoothed (B, 3, D,
        H, W)`` -> warped image and segmentation, log|J|, displacement,
        Dice ``(B, L)``, the ``det ≤ 0`` count ``(B,)`` and residuals."""
        bundle = self.bundle
        labels = list(self.structures.values())

        def eval_v(v_unsmoothed):
            with torch.no_grad():
                v = bundle.smooth(v_unsmoothed)
                # the image rides the integration cascade; the segmentation
                # needs nearest-neighbour semantics and keeps the gather
                transformation, displacement, im_warped = self._transform(v, moving["im"])
                seg_warped = warp(moving["seg"], transformation, method="nearest")
                det = det_jacobian(gradient(transformation, normalised_spacing=True))
                log_det = torch.log(torch.clamp(det, min=0.0))  # -inf/nan where folded
                return {
                    "im_warped": im_warped,
                    "seg_warped": seg_warped,
                    "displacement": displacement,
                    "log_det_J": log_det,
                    "dsc": dice(fixed["seg"], seg_warped, labels),
                    "ndv": count_non_diffeomorphic(det),
                    "residuals": bundle.gmm.residual_map(fixed["im"], im_warped),
                }

        return eval_v

    def _log_seg_metrics(self, fixed_np, out, prefix: str, chain=None,
                         defer_asd: bool = False):
        """Per-structure Dice and the EDT-based ASD; ``defer_asd=True`` runs
        the ASD (the warped segmentation's fetch and the host EDT) on the
        writer thread under a step-bound writer view."""
        tag = f"{prefix}" + (f"/chain_{chain}" if chain is not None else "")
        dsc = _numpy(out["dsc"])
        for name, val in zip(self.structures, dsc):
            self.writer.add_scalar(f"DSC/{tag}/{name}", float(val))
        self.writer.add_scalar(f"DSC/{tag}/mean", float(dsc.mean()))
        if self.compute_asd:
            wb = self.writer.at_step()
            seg_w = out["seg_warped"]

            def _asd_work(wb=wb, fixed_np=fixed_np, seg_w=seg_w, tag=tag):
                asd, _ = calc_metrics(fixed_np, _numpy(seg_w), self.structures, self.spacing)
                finite = np.isfinite(asd[0])
                for name, val in zip(self.structures, asd[0]):
                    wb.add_scalar(f"ASD/{tag}/{name}", float(val))
                if finite.any():
                    wb.add_scalar(f"ASD/{tag}/mean", float(asd[0][finite].mean()))

            if defer_asd:
                savers.submit(self._timed("writer/asd", _asd_work))
            else:
                self._timed("asd", _asd_work)()
        return float(dsc.mean())

    def _maybe_checkpoint(self, path, state, meta, force: bool = False) -> None:
        """Time-gated checkpoint, written on the writer thread: at most every
        ``checkpoint_period_s``, and always at phase ends."""
        now = time.perf_counter()
        if not force and now - self._last_ckpt_t < self.ckpt_period_s:
            return
        savers.submit(self._timed("writer/checkpoint",
                                  lambda: save_checkpoint(path, state, meta)))
        self._last_ckpt_t = time.perf_counter()

    def _submit_sample(self, sample_no, out, model: str, chain=None) -> None:
        """Queue one sample's artifacts (float16 copies made on the device now,
        fetched and written on the writer thread)."""
        im16 = out["im_warped"].to(torch.float16)
        disp16 = out["displacement"].to(torch.float16)
        ldj16 = out["log_det_J"].to(torch.float16)
        sd = self.save_dirs
        savers.submit(self._timed("writer/samples", lambda: savers.save_sample(
            sd, self.spacing, sample_no, im16, disp16, ldj16, model, chain_no=chain)))

    def _check_saturation(self, sat: int, sat_resid: int, step: int,
                          phase: str) -> None:
        """Displacement-saturation guard: warn on any clamped voxels, abort
        above ``saturation_tolerance``.

        ``sat - sat_resid`` voxels hit the integrator's displacement clamp
        bound (lever: ``max_disp``); ``sat_resid`` voxels exceed the
        block-gather warp's in-block residual radius (lever:
        ``block_warp.radius``), a bound on the field's in-block variation
        that raising ``max_disp`` does not move."""
        if sat <= 0:
            return
        no_voxels = float(np.prod(self.bundle.dims))
        max_disp = getattr(self.bundle.transformation, "max_disp", None)
        bound_n = max(0, int(sat) - int(sat_resid))
        causes = []
        if bound_n > 0:
            causes.append(
                f"{bound_n} voxels clamp at the displacement bound "
                f"(max_disp={max_disp}) — raise "
                f"transformation_module.args.max_disp")
        if sat_resid > 0:
            causes.append(
                f"{sat_resid} voxels exceed the block-gather warp's "
                f"in-block residual radius (trainer.block_warp."
                f"radius={self.bundle.block_radius}, "
                f"block={self.bundle.block_size}) — this bounds the "
                f"displacement's in-block VARIATION, so raising "
                f"max_disp does not help; raise "
                f"trainer.block_warp.radius (the MCMC phase escalates it "
                f"itself up to 4)")
        msg = (
            f"{phase} step {step}: displacement saturates a warp limit at "
            f"{sat} voxels ({sat / no_voxels:.2%}) — results are clamped "
            f"there: " + "; ".join(causes)
        )
        if sat > self.sat_tol * no_voxels:
            err = DisplacementSaturationAbort(msg)
            # structured counters for the MCMC loop's auto-recovery
            err.sat = int(sat)
            err.sat_resid = int(sat_resid)
            raise err
        self.logger.warning(msg)

    def _check_guards(self, last: dict, step: int, phase: str, where: str = "") -> None:
        """The saturation guard and, in MCMC, the fold guard on the worst
        row of a period's last metrics (a chain, or a pair)."""
        self._check_saturation(int(last["sat"].max()), int(last["sat_resid"].max()), step,
                               phase)
        no_voxels = float(np.prod(self.bundle.dims))
        worst = int(last["ndv"].max())
        if phase == "MCMC" and worst > self.ndv_tol * no_voxels:
            raise NonDiffeomorphicAbort(
                f"chain transformation folded at {worst} voxels "
                f"(> {self.ndv_tol:.1%} of {int(no_voxels)}) at step {step}{where}")

    def _escalated_radius(self, e: DisplacementSaturationAbort, have_clean: bool):
        """The block radius to resume with after the saturation abort ``e``,
        or None: only an in-block residual overflow of the "post"
        block-gather warp escalates, up to 4, with auto-escalation on and a
        clean period to resume from."""
        b = self.bundle
        auto = bool(self.t_cfg.get("block_warp", {}).get("auto_escalate", True))
        resid_binding = getattr(e, "sat_resid", 0) > self.sat_tol * float(np.prod(b.dims))
        if (auto and resid_binding and have_clean and b.block_radius < 4
                and b.noise_scheme == "post" and b.block_warp
                and not getattr(b.transformation, "use_gather", False)):
            return b.block_radius + 1
        return None

    def _escalate(self, e, new_r: int, step: int, what: str = "") -> dict:
        """Raise the block radius to ``new_r`` (the chunks are rebuilt from
        ``self.bundle``); the record for the summary."""
        self.logger.warning(
            "MCMC auto-recovery%s: %s — escalating trainer.block_warp.radius %d -> %d and "
            "resuming from the last clean period (step %d)", what, e,
            self.bundle.block_radius, new_r, step)
        self.bundle = dataclasses.replace(self.bundle, block_radius=new_r)
        return {"step": step, "radius": new_r}

    def _restore_radius(self, meta: dict) -> None:
        """Checkpoints record the (possibly auto-escalated) block radius."""
        ck_radius = int(meta.get("block_radius", 0) or 0)
        if ck_radius > int(self.bundle.block_radius):
            self.logger.info("resume: restoring escalated trainer.block_warp.radius %d from "
                             "the checkpoint (configured: %d)",
                             ck_radius, self.bundle.block_radius)
            self.bundle = dataclasses.replace(self.bundle, block_radius=ck_radius)

    def _ckpt_meta(self, phase: str, done: int, n_pairs: int = 0) -> dict:
        """A checkpoint's meta: the phase, its steps, the current block
        radius (MCMC; restored on resume), the pair count of a pair-stacked
        state."""
        if phase == "VI":
            meta = {"phase": "VI", "phase_done": 0, "vi_iters": done}
        else:
            meta = {"phase": "MCMC", "phase_done": 1, "mcmc_steps": done,
                    "block_radius": int(self.bundle.block_radius)}
        if n_pairs:
            meta["pair_parallel"] = n_pairs
        meta["config"] = self.config.name
        return meta

    def _write_chain_scalars(self, last: dict) -> None:
        """One pair's per-chain MCMC scalars (leaves ``(C,)``)."""
        for k in ("data_term", "reg_term", "vd_alpha", "reg_energy", "ndv", "sat"):
            for c in range(self.no_chains):
                self.writer.add_scalar(f"MCMC/{k}/chain_{c}", float(last[k][c]))

    # ------------------------------------------------------------ VI phase
    def _run_vi_phase(self, fixed, moving, state: VIState, start: int = 0) -> VIState:
        if self.vi_remat:
            self.logger.info("VI remat on: sequential antithetic chains")
        step_fn = make_vi_step(self.bundle, self.opt_q_v, self.opt_gmm, self.opt_reg,
                               fixed, moving, remat=self.vi_remat)
        eval_fn = self._make_eval(fixed, moving)
        fixed_seg_np = _numpy(fixed["seg"])
        cap = int(self.t_cfg.get("max_device_chunk", 200))

        def run_steps(state, n):
            ms = None
            while n > 0:
                this = min(cap, n)
                state, ms = make_vi_chunk(step_fn, this)(state)
                n -= this
            return state, ms

        log_period = max(1, min(self.log_period_vi, self.no_iters_vi))
        done = start
        try:
            while done < self.no_iters_vi:
                this = min(log_period, self.no_iters_vi - done)
                t0 = time.perf_counter()
                state, ms = run_steps(state, this)
                done += this
                last = _host(_last(ms))
                t1 = time.perf_counter()
                self._add_time("vi/steps", t1 - t0)

                self.writer.set_step(done)
                for k in ("data_term", "reg_term", "entropy_term", "total_loss",
                          "vd_alpha", "reg_energy", "ndv", "sat"):
                    self.tracker.update(k, float(last[k]))
                self._check_guards(last, done, "VI")
                for i, (s, p) in enumerate(zip(np.atleast_1d(last["gmm_scales"]),
                                               np.atleast_1d(last["gmm_proportions"]))):
                    self.writer.add_scalar(f"GMM/scale_{i}", float(s))
                    self.writer.add_scalar(f"GMM/proportion_{i}", float(p))
                for name in ("mu", "log_var", "u"):
                    self.writer.add_scalar(f"VI/max_update_{name}",
                                           float(last[f"max_update_{name}"]))

                out = _first(eval_fn(state.q_v["mu"][None]))
                mean_dsc = self._log_seg_metrics(fixed_seg_np, out, "VI", defer_asd=True)
                if self.writer.has_figures:
                    self._submit_vi_figures(out, state, last, fixed, moving)
                self.logger.info(
                    "VI %d/%d loss %.1f data %.1f reg %.1f entropy %.1f dice %.4f ndv %d",
                    done, self.no_iters_vi, float(last["total_loss"]),
                    float(last["data_term"]), float(last["reg_term"]),
                    float(last["entropy_term"]), mean_dsc, int(last["ndv"]),
                )
                self._maybe_checkpoint(self.save_dirs["models"] / "vi_latest.npz", state,
                                       self._ckpt_meta("VI", done),
                                       force=done >= self.no_iters_vi)
                self._add_time("vi/eval+log", time.perf_counter() - t1)
                self.logger.debug("VI period %d: steps %.2fs eval+log %.2fs", done,
                                  t1 - t0, time.perf_counter() - t1)
        finally:
            # queued checkpoint/artifact writes land even on a guard abort
            t0 = time.perf_counter()
            savers.flush()
            self._add_time("vi/flush", time.perf_counter() - t0)
        return state

    def _submit_vi_figures(self, out, state: VIState, last: dict, fixed, moving) -> None:
        """Residual histogram, image and field grids, rendered on the writer
        thread from float16 device copies (only when figures are recorded)."""
        from .utils import figures

        fixed_mask_np = _numpy(fixed["mask"])
        fixed_im_np = _numpy(fixed["im"]).astype(np.float32)
        moving_im_np = _numpy(moving["im"]).astype(np.float32)
        wb = self.writer.at_step()
        f16 = {
            "res": out["residuals"].to(torch.float16),
            "imw": out["im_warped"].to(torch.float16),
            "disp": out["displacement"].to(torch.float16),
            "mu": state.q_v["mu"].to(torch.float16),
            "sig": torch.exp(0.5 * state.q_v["log_var"]).to(torch.float16),
            "u": state.q_v["u"].to(torch.float16),
        }
        log_props = np.log(np.asarray(last["gmm_proportions"]))
        log_scales = np.log(np.asarray(last["gmm_scales"]))

        def _vi_figs():
            a = {k: _numpy(t).astype(np.float32) for k, t in f16.items()}
            wb.add_figure("VI/residual_hist", figures.residual_histogram(
                a["res"], fixed_mask_np, log_props, log_scales))
            wb.add_figure("VI/images", figures.image_grid({
                "fixed": fixed_im_np, "moving": moving_im_np, "warped(mu)": a["imw"]}))
            wb.add_figure("VI/fields", figures.field_norm_grid({
                "mu": a["mu"], "sigma": a["sig"], "u": a["u"], "displacement": a["disp"]}))

        savers.submit(_vi_figs, droppable=True)

    def _test_vi(self, fixed, moving, state: VIState) -> dict:
        """Posterior draws and their evaluation, the posterior-mean
        artifacts, and the sampling speed test."""
        if self.no_samples_vi_test <= 0:
            return {}
        t_start = time.perf_counter()
        bundle = self.bundle
        eval_fn = self._make_eval(fixed, moving)
        fixed_seg_np = _numpy(fixed["seg"])

        gen = key_generator(state.key, state.step, self.device, salt=101)
        welford = welford_init(1, (3,) + tuple(bundle.dims), self.device)
        dscs = []
        save_every = max(1, self.no_samples_vi_test // 10)
        for i in range(self.no_samples_vi_test):
            out = _first(eval_fn(sample_q_v(gen, state.q_v)[None]))
            welford = welford_update(welford, out["displacement"][None], 1.0)
            self.writer.set_step(i)
            dscs.append(self._log_seg_metrics(fixed_seg_np, out, "VI_test"))
            if i % save_every == 0:
                self._submit_sample(i, out, "VI")
        t_draws = time.perf_counter()
        self._add_time("vi_test/draws", t_draws - t_start)

        # posterior mean transform (mu directly)
        out_mu = _first(eval_fn(state.q_v["mu"][None]))
        savers.save_variational_posterior_mean(
            self.save_dirs, self.spacing, out_mu["im_warped"], out_mu["displacement"])
        mean, std = welford_finalize(welford)
        savers.save_displacement_mean_and_std_dev(
            self.save_dirs, self.spacing, mean[0], std[0], fixed["mask"], "VI")
        if self.writer.has_figures:
            from .utils import figures

            self.writer.add_figure("VI_test/posterior",
                                   figures.mean_std_grid(_numpy(mean[0]), _numpy(std[0])))
        t_post = time.perf_counter()
        self._add_time("vi_test/posterior", t_post - t_draws)

        # sampling speed test: sample -> smooth -> integrate -> warp im + seg
        def draw():
            v = bundle.smooth(sample_q_v(gen, state.q_v)[None])
            transformation, _, im_w = self._transform(v, moving["im"])
            seg_w = warp(moving["seg"], transformation, method="nearest")
            return torch.mean(im_w), torch.sum(seg_w)

        with torch.no_grad():
            float(draw()[0])  # warm-up draw and host sync
            t0 = time.perf_counter()
            outs = [draw()[0] for _ in range(self.speed_test_iters)]
            float(torch.stack(outs).sum())
            dt = time.perf_counter() - t0
        sps = self.speed_test_iters / dt
        self.logger.info("VI sampling speed: %.2f samples/sec", sps)
        self._add_time("vi_test/speed_test", time.perf_counter() - t_post)

        t0 = time.perf_counter()
        savers.flush()
        self._add_time("vi_test/flush", time.perf_counter() - t0)
        return {
            "vi_test_mean_dsc": float(np.mean(dscs)) if dscs else float("nan"),
            "vi_samples_per_sec": sps,
        }

    # ---------------------------------------------------------- MCMC phase
    def _run_mcmc_phase(self, fixed, moving, vi_state: VIState) -> dict:
        bundle = self.bundle
        tau = self.config.tau
        total = self.no_iters_burn_in + self.no_samples_mcmc

        mcmc = init_chains(
            bundle,
            key_generator(vi_state.key, vi_state.step, self.device, salt=202),
            no_chains=self.no_chains,
            mode=self.mcmc_init,
            q_v=vi_state.q_v if self.mcmc_init == "VI" else None,
            gmm=vi_state.gmm,
            reg=vi_state.reg,
            opt_gmm=self.opt_gmm,
            opt_reg=self.opt_reg,
            device=self.device,
            param_mode=self.mcmc_param_mode,
        )

        mcmc_resume = getattr(self, "_mcmc_resume", None)
        if mcmc_resume:
            # a structural mismatch here is a user error (dims, chain count)
            mcmc, resume_meta = load_checkpoint(mcmc_resume, mcmc)
            self.logger.info("resumed MCMC from %s at %s", mcmc_resume, resume_meta)
            self._restore_radius(resume_meta)

        cap = int(self.t_cfg.get("max_device_chunk", 200))
        thin = int(self.t_cfg.get("mcmc_thin", 1))

        def run_steps(mcmc, n):
            """Advance ``n`` transitions in chunks of at most ``cap``; the
            chunk is built from ``self.bundle`` as it stands (an escalated
            radius takes effect at once)."""
            ms = None
            while n > 0:
                this = min(cap, n)
                mcmc, ms = make_mcmc_chunk(
                    self.bundle, self.opt_gmm, self.opt_reg, tau, fixed, moving, chunk=this,
                    burn_in=self.no_iters_burn_in, thin=thin,
                    param_mode=self.mcmc_param_mode)(mcmc)
                n -= this
            return mcmc, ms

        eval_fn = self._make_eval(fixed, moving)
        fixed_seg_np = _numpy(fixed["seg"])

        log_period = max(1, min(self.log_period_mcmc, total))
        summary = {}
        done = int(mcmc.step)
        t0 = time.perf_counter()

        def process(done_at, fetch, outs, state):
            """Host-side work for one completed log period, called after the
            next chunk has been dispatched: the guards fire one period after
            the chunk that tripped them."""
            t_p0 = time.perf_counter()
            last = fetch.get()
            t_p1 = time.perf_counter()
            self.writer.set_step(done_at)
            self._write_chain_scalars(last)
            # the saturation guard, and the fold guard on the worst chain
            self._check_guards(last, done_at, "MCMC")

            if done_at >= total:
                # final-period quality at the same trajectory point every
                # run reaches (the speed test advances the chains further)
                summary["mcmc_mean_dsc"] = float(last["dsc"].mean())
            t_p2 = time.perf_counter()
            post_burn_in = done_at > self.no_iters_burn_in
            save_now = (post_burn_in and
                        ((done_at - self.no_iters_burn_in) % self.save_period_mcmc
                         < log_period or done_at >= total))
            for c in range(self.no_chains):
                out_c = {k: v[c] for k, v in outs.items()}
                out_c["dsc"] = last["dsc"][c]
                self._log_seg_metrics(fixed_seg_np, out_c, "MCMC", chain=c, defer_asd=True)
                if save_now:
                    self._submit_sample(done_at - self.no_iters_burn_in, out_c, "MCMC", chain=c)
                    if self.writer.has_figures:
                        self._submit_sample_figure(out_c, c)
            t_p3 = time.perf_counter()
            self.logger.debug(
                "MCMC process %d: fetch-last %.2fs scalars+guards %.2fs "
                "chains %.2fs", done_at, t_p1 - t_p0, t_p2 - t_p1, t_p3 - t_p2)
            self.logger.info(
                "MCMC %d/%d data %s reg %s ndv %s",
                done_at, total,
                np.array2string(last["data_term"], precision=1),
                np.array2string(last["reg_term"], precision=1),
                last["ndv"],
            )
            self._maybe_checkpoint(self.save_dirs["models"] / "mcmc_latest.npz", state,
                                   self._ckpt_meta("MCMC", done_at), force=done_at >= total)
            self._add_time("mcmc/process", time.perf_counter() - t_p0)

        pending = None
        last_good = None  # state of the newest period that passed the guards
        skip_posterior = False
        # block-residual auto-recovery: on a saturation abort whose binding
        # counter is the in-block residual one, raise the radius (cap 4) and
        # resume from the last clean period; the escalated radius goes into
        # the checkpoint meta and is restored on resume
        try:
            while True:
                try:
                    while done < total:
                        this = min(log_period, total - done)
                        t_a = time.perf_counter()
                        mcmc, ms = run_steps(mcmc, this)
                        done += this
                        t_b = time.perf_counter()
                        ev = eval_fn(mcmc.v)
                        nxt = (done, _Fetch({**_last(ms), "dsc": ev["dsc"]}), ev, mcmc)
                        t_c = time.perf_counter()
                        self._add_time("mcmc/chunks", t_b - t_a)
                        self._add_time("mcmc/eval", t_c - t_b)
                        if pending is not None:
                            process(*pending)
                            last_good = pending[3]
                        else:
                            # first period: nothing to overlap yet, so a
                            # blocking read costs nothing
                            nxt[1].get()
                            self.logger.debug("MCMC first period: chunk+eval wall %.2fs",
                                              time.perf_counter() - t_a)
                        self.logger.debug(
                            "MCMC period %d: dispatch %.2fs eval-dispatch "
                            "%.2fs process %.2fs", done, t_b - t_a,
                            t_c - t_b, time.perf_counter() - t_c)
                        pending = nxt
                    if pending is not None:  # None when resuming a finished phase
                        process(*pending)
                        last_good = pending[3]
                        pending = None
                    break
                except DisplacementSaturationAbort as e:
                    new_r = self._escalated_radius(e, last_good is not None)
                    if new_r is None:
                        raise
                    resume_step = int(last_good.step)
                    summary.setdefault("block_radius_escalations", []).append(
                        self._escalate(e, new_r, resume_step))
                    mcmc = last_good
                    done = resume_step
                    pending = None
        except TrainerAbort as e:
            self.logger.error("MCMC aborted: %s", e)
            summary["mcmc_aborted"] = str(e)
            # the live state is one chunk past the period whose guard fired:
            # the saved posterior rolls back to the newest clean period, and
            # with none at all it is not saved
            mcmc = last_good if last_good is not None else mcmc
            if last_good is None:
                summary["mcmc_no_clean_period"] = True
                skip_posterior = True
        finally:
            summary["mcmc_time_s"] = time.perf_counter() - t0
            t_f = time.perf_counter()
            if not skip_posterior and float(mcmc.welford.count.sum()) > 1:
                mean, std = posterior_statistics(mcmc)
                savers.save_displacement_mean_and_std_dev(
                    self.save_dirs, self.spacing, mean, std, fixed["mask"], "MCMC")
            t_g = time.perf_counter()
            savers.flush()  # all queued sample dumps + checkpoints on disk
            self._add_time("mcmc/posterior", t_g - t_f)
            self._add_time("mcmc/flush", time.perf_counter() - t_g)

        if "mcmc_aborted" not in summary:
            # the speed test times transitions alone, after one warm-up
            # transition; the chains are past burn-in, so it runs the same
            # sampling path
            t_s = time.perf_counter()
            iters = self.speed_test_iters
            mcmc, _ = run_steps(mcmc, 1)
            float(torch.sum(mcmc.v))
            t1 = time.perf_counter()
            mcmc, _ = run_steps(mcmc, iters)
            float(torch.sum(mcmc.v))
            dt = time.perf_counter() - t1
            sps = self.no_chains * iters / dt
            self.logger.info("MCMC sampling speed: %.2f samples/sec", sps)
            summary["mcmc_samples_per_sec"] = sps
            self._add_time("mcmc/speed_test", time.perf_counter() - t_s)
        return summary

    def _submit_sample_figure(self, out_c, chain: int) -> None:
        from .utils import figures

        wb = self.writer.at_step()
        im16 = out_c["im_warped"].to(torch.float16)
        dp16 = out_c["displacement"].to(torch.float16)
        ld16 = out_c["log_det_J"].to(torch.float16)

        def _sample_fig():
            wb.add_figure(f"MCMC/sample/chain_{chain}", figures.sample_grid(
                _numpy(im16).astype(np.float32), _numpy(dp16).astype(np.float32),
                _numpy(ld16).astype(np.float32), chain_no=chain))

        savers.submit(_sample_fig, droppable=True)
