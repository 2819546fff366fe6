"""Readings of the comparison's numbers, from which ``limits/`` are set.

    python3 perfbench/calibrate.py --workload <name> --seeds 1 2 3 ... \\
        [--variant sound|control|tf32|unchanged|half|half_sample|tile|tile4|dgrad_tile|
                   dgrad_tile4|seam] [--out FILE]

Runs the cell's set-up and first steps (the window's own call), a short
window, and the comparison, for each seed in turn in one process, and
prints one JSON line per seed with the three numbers and where each is
worst.  ``sound`` is the program as configured; ``control`` the program
with its own bfloat16 integrator (``compute_dtype: "bfloat16"``), the
nearest precision below the configured float32; ``tf32`` the program
with TF32 switched on for its matmuls and convolutions (the configured
float32 states it off); ``unchanged`` the program with each call's new
state thrown away; the others the planted faults of ``drive.FAULTS`` (the
half batch, by the residuals or by VI's antithetic samples; one 8³ or 4³
tile of the residuals, or of the block warp's gradient by the displacement
alone; on a step cut over several cards, one slab's halo from the wrong
neighbour, ``seam``).  A sharded cell runs on its cards.  The benchmark's
own runs never run these.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import drive, run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variant", default="sound",
                   choices=("sound", "control", "tf32", "unchanged") + tuple(drive.FAULTS))
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default=None, help="also append the lines to this file")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    spec = run.load_cell(args.workload)
    if torch.cuda.device_count() < spec.shards:
        print(f"calibrate: {args.workload} needs {spec.shards} cards", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(spec.shards)]
    for seed in args.seeds:
        fault = None if args.variant in ("sound", "control", "tf32") else args.variant
        out = run.run_cell(spec, seed, args.seconds, False, devices, fault=fault,
                           compute_dtype="bfloat16" if args.variant == "control" else None,
                           tf32=args.variant == "tf32")
        line = json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed,
                           **{k: c["value"] for k, c in out["checked"].items()},
                           "where": out["where"],
                           "metrics": {k: m["value"] for k, m in out["metrics"].items()}})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
