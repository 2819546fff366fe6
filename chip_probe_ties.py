#!/usr/bin/env python3
"""What B4's exact dtri weights at ties cost: a probe on one CUDA card,
beside the smoke run (``chip_smoke.py``).

    python3 chip_probe_ties.py

B4's window kernel (``block_warp_dgrad`` at block 8, R 1-3) takes its taps'
dtri weights as the plain version rounds them: where a residual is within
2^-25 of 0, ``r + 1`` rounds to 1 (or ``r - 1`` to -1) and only one tap has
a weight (``dtri_q``/``dtri_w`` in ``csrc/block_warp.cu``).  This probe
builds ``csrc/block_warp.cu`` twice, in parallel: as it is (``exact``), and
with the upper tap's weight taken as minus the lower one's (``shortcut``:
one float per axis and no select, which misses the plain version at
ties).  It prints each build's registers and spills of the window kernels,
checks both against the plain version at the SG-MCMC path's shape (vol and
g ``(2, 1, 128³)``, bound 9) at R 2 and R 3 and on the same operands with
every 97th residual set to ±2^-27 or ±1e-9 (where ``exact`` must agree and
``shortcut`` is expected not to), and times both in turns (shortcut,
exact, exact, shortcut) with CUDA events.  Prints the card's name and
power limit, exits non-zero without CUDA or when ``exact`` disagrees.
Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

SHAPE = (2, 1, 128, 128, 128)
BOUND, BLOCK = 9, 8
REPS = 2

# the shortcut form: (source line, its replacement)
SHORTCUT = (
    ("    for (int a = 0; a < 3; ++a) q[a] = dtri_q(rc[a], q[a]);",
     "    for (int a = 0; a < 3; ++a) q[a] = dtri(q[a]);"),
    ("        const float dwz = dtri_w(q[2], wz, a), dwy = dtri_w(q[1], wy, e);",
     "        const float dwz = a ? -q[2] : q[2], dwy = e ? -q[1] : q[1];"),
    ("        const float a_sum = fabsf(q[0]) > 1.5f ? 0.5f * q[0] * b_sum"
     " : q[0] * sg0 + -q[0] * sg1;",
     "        const float a_sum = q[0] * sg0 + -q[0] * sg1;"),
)


def _build() -> dict:
    """``{"exact": CDLL, "shortcut": CDLL}``, built in parallel; prints the
    window kernels' registers and spills of each."""
    from ir_sgmcmc_tpu_torch.kernels import _lib

    src = (_lib.CSRC / "block_warp.cu").read_text()
    short = src
    for old, new in SHORTCUT:
        if short.count(old) != 1:
            raise RuntimeError(f"block_warp.cu no longer has the line {old.strip()!r}")
        short = short.replace(old, new)
    procs = {}
    for name, text in (("exact", src), ("shortcut", short)):
        work = _lib.BUILD_DIR / f"probe_ties_{name}"
        work.mkdir(parents=True, exist_ok=True)
        (work / "block_warp.cu").write_text(text)
        (work / "cp_async.cuh").write_text((_lib.CSRC / "cp_async.cuh").read_text())
        cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-o", str(work / "lib.so"),
               str(work / "block_warp.cu")]
        procs[name] = (work, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (work, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        for row in _lib.ptxas_summary(log):
            if "window_kernel" in row:
                print(f"ptxas {name}: {row}", flush=True)
        lib = ctypes.CDLL(str(work / "lib.so"))
        lib.block_warp_dgrad.argtypes = _lib._SIGNATURES["block_warp_dgrad"]
        lib.block_warp_dgrad.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _time_ms(fn, reps: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_probe_ties: needs a CUDA card", file=sys.stderr)
        return 1
    from ir_sgmcmc_tpu_torch import selftest as st
    from ir_sgmcmc_tpu_torch.kernels import block_warp as bw

    libs = _build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    exact_ok = True
    runs = {}
    for R in (2, 3):
        vol, r, m, g = st.block_operands(gen, SHAPE, BOUND, R)
        ties = r.clone()
        flat = ties.view(-1)
        for i, v in enumerate((-2.0 ** -27, 2.0 ** -27, -1e-9, 1e-9)):
            flat[i::4 * 97] = v
        for name, lib in libs.items():
            for what, rr in (("path", r), ("ties", ties)):
                out = torch.empty_like(rr)

                def run(lib=lib, rr=rr, out=out, R=R):
                    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
                    err = lib.block_warp_dgrad(*(ctypes.c_void_p(t.data_ptr())
                                                 for t in (vol, rr, m, g, out)),
                                               *SHAPE, BLOCK, R, stream)
                    if err:
                        raise RuntimeError(f"block_warp_dgrad ({name}): cudaError {err}")

                run()
                ref = bw.block_warp_dgrad_plain(vol, rr, m, g)
                bad = int(((out - ref).abs() > 5e-4 + 1e-4 * ref.abs()).sum())
                print(f"probe B4 R {R} {name} {what}: {bad} outputs off the plain version "
                      f"(max abs err {float((out - ref).abs().max()):.3e})", flush=True)
                exact_ok &= name != "exact" or bad == 0
                if what == "path":
                    runs[(R, name)] = run
    times = {k: [] for k in runs}
    order = [k for k in runs if k[1] == "shortcut"] + [k for k in runs if k[1] == "exact"]
    for rep in range(REPS):
        for k in order + order[::-1]:
            times[k].append(_time_ms(runs[k]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    for (R, name), ts in times.items():
        bound, _ = bw.B4.bound_ms(SHAPE, R)
        mean = sum(ts) / len(ts)
        print(f"probe B4 R {R} {name}: {mean:.4f} ms ({', '.join(f'{t:.4f}' for t in ts)}), "
              f"{100 * bound / mean:.1f}% of its bound {bound:.4f} ms", flush=True)
    print(smi)
    if not exact_ok:
        print("chip_probe_ties: the exact form disagrees with the plain version",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
