#!/usr/bin/env python3
"""Where the trainer's time goes beyond the engines' loops: a probe on one
CUDA card, beside the smoke run (``chip_smoke.py``).

    python3 chip_probe_trainer.py

1. The smoke run's trainer phase (the demo config through the CLI at 128³,
   2 chains, 20 VI steps, 4 VI-test draws, 10 + 20 transitions, speed
   tests of 10) in three variants, two rounds in turns:
   - ``default``: as ``chip_smoke.py`` runs it;
   - ``no ASD``: ``trainer;ASD=false`` (no surface distances on the
     writer thread);
   - ``one period``: the log periods set to the phases' lengths (one VI
     and one MCMC period: no mid-phase evaluation, ASD, samples or
     checkpoint on the writer thread while the steps run).
   Each prints the phases' wall times, the trainer's host-time spans
   (``Trainer.timings``) and the wall time of each logged period.
2. Ten SG-MCMC transitions at 128³ x 2 chains (``make_mcmc_chunk``, the
   smoke run's phase-3 problem), alone and while another thread runs one
   job of the trainer's writer thread: ``save_checkpoint`` of the chain
   state (about 200 MB), the ASD of a 128³ segmentation pair, one sample
   dump (``save_sample``: two gzip NIfTI and one VTK), and, as a control,
   ``time.sleep``.  Two rounds in turns; prints the transitions' wall time
   beside the job's.

Prints the card's name and power limit; exits non-zero without CUDA.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import logging
import re
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

import chip_smoke as smoke

VARIANTS = {
    "default": (),
    "no ASD": ("trainer;ASD=false",),
    "one period": ("trainer;log_period_VI=20", "trainer;log_period_MCMC=30"),
}
ROUNDS = 2


class _Periods(logging.Handler):
    """Collects the trainer's per-period debug lines (root logger)."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        msg = record.getMessage()
        if re.match(r"(VI|MCMC) period \d+:", msg):
            self.lines.append(msg)


def trainer_variants(dev) -> None:
    handler = _Periods()
    logging.getLogger().addHandler(handler)
    try:
        for rnd in range(ROUNDS):
            for name, extra in VARIANTS.items():
                handler.lines.clear()
                rec = smoke.phase_trainer(dev, extra)
                s = rec["summary"]
                print(f"variant {name!r} round {rnd}: wall {rec['wall_s']:.3f} s, phases "
                      f"{json.dumps({k: round(v, 3) for k, v in rec['phase_s'].items()})}, "
                      f"VI {rec['vi_iters_per_sec_in_phase']:.3f} iters/sec in the phase, "
                      f"MCMC loop {rec['mcmc_samples_per_sec_in_phase']:.3f} samples/sec "
                      f"(mcmc_time_s {s['mcmc_time_s']:.3f}), speed tests "
                      f"{s['mcmc_samples_per_sec']:.3f} samples/sec, "
                      f"{s['vi_samples_per_sec']:.3f} VI draws/sec", flush=True)
                print(f"variant {name!r} round {rnd}: host_s "
                      f"{json.dumps({k: round(v, 3) for k, v in rec['host_s'].items()})}",
                      flush=True)
                print(f"variant {name!r} round {rnd}: periods {handler.lines}", flush=True)
    finally:
        logging.getLogger().removeHandler(handler)


def contention(dev) -> None:
    from ir_sgmcmc_tpu_torch.engine import make_mcmc_chunk
    from ir_sgmcmc_tpu_torch.utils import savers
    from ir_sgmcmc_tpu_torch.utils.checkpoint import save_checkpoint
    from ir_sgmcmc_tpu_torch.utils.metrics import calc_metrics

    bundle, fixed, moving, opt_gmm, opt_reg = smoke._problem(smoke.DIMS, dev)
    state = smoke._init(bundle, opt_gmm, opt_reg, dev)
    run = make_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-5, fixed, moving, chunk=smoke.TIMED,
                          burn_in=0, thin=1)
    state, _ = run(state)  # warm-up
    seg_f, seg_m = fixed["seg"].cpu().numpy(), moving["seg"].cpu().numpy()
    im16 = moving["im"].to(torch.float16)
    disp16 = state.v[0].to(torch.float16)

    with tempfile.TemporaryDirectory() as tmp:
        dirs = {"samples": Path(tmp)}
        jobs = {
            "idle": None,
            "sleep 1 s": lambda: time.sleep(1.0),
            "save_checkpoint": lambda: save_checkpoint(Path(tmp) / "c.npz", state, {}),
            "ASD": lambda: calc_metrics(seg_f, seg_m, {"sphere": 1}),
            "save_sample": lambda: savers.save_sample(dirs, (1.0, 1.0, 1.0), 0, im16,
                                                      disp16, im16, "MCMC"),
        }
        for rnd in range(ROUNDS):
            for name, job in jobs.items():
                torch.cuda.synchronize()
                done = {}

                def work(job=job):
                    t = time.perf_counter()
                    job()
                    done["s"] = time.perf_counter() - t

                thread = threading.Thread(target=work) if job else None
                t0 = time.perf_counter()
                if thread:
                    thread.start()
                state, _ = run(state)
                torch.cuda.synchronize()
                steps = time.perf_counter() - t0
                if thread:
                    thread.join(timeout=120)
                    if thread.is_alive():
                        raise RuntimeError(f"contention: {name} did not finish")
                job_s = f"{done['s']:.3f} s" if thread else "none"
                print(f"contention round {rnd}: {smoke.TIMED} transitions "
                      f"{steps:.3f} s ({smoke.CHAINS * smoke.TIMED / steps:.3f} samples/sec) "
                      f"beside {name!r} (job {job_s})", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_probe_trainer: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = smoke._smi()
    print(f"device: {torch.cuda.get_device_name(0)} ({smi}), torch {torch.__version__}",
          flush=True)
    contention(dev)
    trainer_variants(dev)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
