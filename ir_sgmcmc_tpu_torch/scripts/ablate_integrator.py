"""Seed-replicated ablation of the SVF integrator's stages (the port's
``scripts/ablate_integrator.py``).

Runs the canonical 128³ quality protocol (``quality_eval``) for each stage
over several trainer seeds (the ground-truth deformation fixed), each in a
fresh subprocess, and appends one JSON line per run with the JAX driver's
keys, so ``scripts/summarize_ablation.py`` reads the output of either::

    python -m ir_sgmcmc_tpu_torch.scripts.ablate_integrator --out ablation.jsonl \\
        [--seeds 0 1 2] [--stages split taylor warp gather] [--dims 128]
    python scripts/summarize_ablation.py ablation.jsonl --markdown

A run that fails (or times out) writes an ``error`` row with the tail of its
stderr; a rerun retries only the cells without a good row.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

STAGES = {
    # the default integrator: Taylor-form sub-voxel squarings, then the
    # compositions as dimensionally split per-axis lerps (kernels B1/B2)
    "split": ["--taylor-compositions", "split"],
    # Taylor squarings + radius-1 blend-warp compositions (B5-B7)
    "taylor": ["--taylor-compositions", "off"],
    # the all-blend integrator (no Taylor anywhere)
    "warp": ["--taylor-threshold", "0", "--taylor-compositions", "off"],
    # the exact integration: 12 grid_sample squarings; capped chunks keep
    # the host reads of the slower steps frequent
    "gather": ["--use-gather", "--max-device-chunk", "50"],
    # the composition phase as Taylor stencils at the split's step count
    # (threshold 1.0 keeps e): unstable end-to-end, kept for the record (the
    # JAX rows abort on the saturation guard)
    "taylor_comp1": ["--taylor-compositions", "on", "--taylor-threshold", "1.0"],
    # anchored residual warping in SG-MCMC on "post", in the default
    # "taylor" mode and in the "blend" mode (the JAX rows' post_anchored_*
    # stages): a negative result, kept for the record
    "post_anchored": ["--noise-scheme", "post", "--anchor"],
    "post_anchored_blend": ["--noise-scheme", "post", "--anchor", "--anchor-mode", "blend"],
    # the split default with the squarings and the compositions in bfloat16
    # (kernels B1/B2-bf16); the JAX script's two names for it (its
    # split_bf16 rows predate its bf16 compositions)
    "split_bf16": ["--taylor-compositions", "split", "--compute-dtype", "bfloat16"],
    "split_bf16comp": ["--taylor-compositions", "split", "--compute-dtype", "bfloat16"],
}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="ablation.jsonl")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--stages", nargs="+", default=["split", "taylor", "warp", "gather"],
                   choices=list(STAGES))
    p.add_argument("--dims", type=int, default=128)
    p.add_argument("--magnitude", type=float, default=6.0)
    p.add_argument("--vi-iters", type=int, default=384)
    p.add_argument("--burn-in", type=int, default=300)
    p.add_argument("--samples", type=int, default=700)
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="device (default: the CUDA card)")
    args = p.parse_args(argv)

    out_path = Path(args.out)
    done = set()
    if out_path.exists():
        for line in out_path.read_text().splitlines():
            try:
                r = json.loads(line)
                if not r.get("error"):
                    done.add((r["stage"], r["trainer_seed"]))
            except (json.JSONDecodeError, KeyError):
                pass

    for stage in args.stages:
        for seed in args.seeds:
            if (stage, seed) in done:
                print(f"skip {stage} seed {seed} (already in {out_path})", file=sys.stderr)
                continue
            cmd = [sys.executable, "-m", "ir_sgmcmc_tpu_torch.scripts.quality_eval",
                   "--dims", str(args.dims), "--magnitude", str(args.magnitude),
                   "--vi-iters", str(args.vi_iters), "--burn-in", str(args.burn_in),
                   "--samples", str(args.samples), "--seed", "0",
                   "--trainer-seed", str(seed)] + STAGES[stage]
            if args.device is not None:
                cmd += ["--device", args.device]
            t0 = time.time()
            print(f"== {stage} seed {seed}: {' '.join(cmd[1:])}", file=sys.stderr, flush=True)
            try:
                proc = subprocess.run(cmd, cwd=str(REPO), capture_output=True, text=True,
                                      timeout=7200)
            except subprocess.TimeoutExpired as e:
                # one over-budget run must not end the sweep: its error row
                # makes a rerun retry only this cell
                rec = {"stage": stage, "trainer_seed": seed, "error": True,
                       "stderr_tail": f"timeout after {e.timeout}s"}
                proc = None
            if proc is not None and proc.returncode != 0:
                rec = {"stage": stage, "trainer_seed": seed, "error": True,
                       "stderr_tail": proc.stderr[-1500:]}
            elif proc is not None:
                try:
                    rec = json.loads(proc.stdout.strip().splitlines()[-1])
                except (json.JSONDecodeError, IndexError):
                    rec = {"stage": stage, "trainer_seed": seed, "error": True,
                           "stderr_tail": "rc=0 but no JSON on stdout: " + proc.stdout[-500:]}
                rec["stage"] = stage
            rec["wall_s"] = round(time.time() - t0, 1)
            with out_path.open("a") as f:
                f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
