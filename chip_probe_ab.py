#!/usr/bin/env python3
"""This tree against another checkout of the repository (a parent commit)
on one CUDA card, in turns (parent, this tree, this tree, parent per
round), each run a process of its own that builds its tree's kernels.

    git archive <parent> | tar -x -C .chipcheck/parent    # .chipcheck/ is git-ignored
    python3 chip_probe_ab.py .chipcheck/parent [--rounds 2]

Each run times, after one warm-up step, 3 runs of 10 SG-MCMC transitions
of the smoke run's phase-3 problem (128³, 2 chains, "post") and 3 runs of
10 VI steps on "post" (GMM warm-up first), host clock around
device-synchronised runs.  Prints the card's name and power limit, one
``ab:`` JSON line per run, then one ``ab_summary:`` line with each tree's
medians.  Imports nothing of JAX; exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def rate(tree: str) -> dict:
    """Samples/sec and VI iters/sec of the tree ``tree`` (run in-process:
    its ``chip_smoke.py`` and package come first on the path)."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from ir_sgmcmc_tpu_torch.engine import (gmm_warmup, make_mcmc_chunk, make_vi_chunk,
                                            make_vi_step)
    from ir_sgmcmc_tpu_torch.kernels import _lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _lib.load_library()
    dev = torch.device("cuda", 0)

    def timed(run, state, per_run):
        out = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = run(state)
            torch.cuda.synchronize()
            out.append(per_run / (time.perf_counter() - t0))
        return out

    bundle, fixed, moving, og, orr = cs._problem(cs.DIMS, dev)
    state = cs._init(bundle, og, orr, dev)
    state, _ = make_mcmc_chunk(bundle, og, orr, 1e-5, fixed, moving, chunk=1, burn_in=0,
                               thin=1)(state)
    mcmc = timed(make_mcmc_chunk(bundle, og, orr, 1e-5, fixed, moving, chunk=10, burn_in=0,
                                 thin=1), state, cs.CHAINS * 10)
    b, f, m, (oq, og2, orr2), vs = cs._vi_problem(cs.DIMS, dev, "post")
    step = make_vi_step(b, oq, og2, orr2, f, m)
    vs, _ = make_vi_chunk(step, 1)(gmm_warmup(b, og2, vs, f, m))
    vi = timed(make_vi_chunk(step, 10), vs, 10)
    return {"tree": tree, "mcmc_samples_per_sec": mcmc, "vi_iters_per_sec": vi}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("parent", nargs="?", help="the other checkout's root")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--rate", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_probe_ab: needs a CUDA card", file=sys.stderr)
        return 1
    if args.rate is not None:
        print("ab:", json.dumps(rate(args.rate)), flush=True)
        return 0
    if args.parent is None:
        parser.error("the parent checkout is required")
    here = str(Path(__file__).resolve().parent)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    runs = []
    for _ in range(args.rounds):
        for tree in (args.parent, here, here, args.parent):
            out = subprocess.run([sys.executable, __file__, "--rate", tree], capture_output=True,
                                 text=True, check=True, cwd=here).stdout
            line = next(ln for ln in out.splitlines() if ln.startswith("ab: "))
            print(line, flush=True)
            runs.append(json.loads(line[4:]))
    summary = {}
    for name, tree in (("parent", args.parent), ("this", here)):
        mine = [r for r in runs if r["tree"] == tree]
        summary[name] = {k: statistics.median(x for r in mine for x in r[k])
                         for k in ("mcmc_samples_per_sec", "vi_iters_per_sec")}
    print("ab_summary:", json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
