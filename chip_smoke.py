#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``ir_sgmcmc_tpu_torch``) on one card
(phases 12(d) and 13(d) also on a second card, and 13(d) on four, where the
host has them).

    python3 chip_smoke.py


Phases, each of which raises on failure (exit code != 0):

1. the card's name and power limit; build the CUDA kernels from
   ``ir_sgmcmc_tpu_torch/csrc`` (nvcc, sm_90a) and report the build time;
2. each kernel B1-B7 against its plain PyTorch version on the card, at the
   main paths' shapes (B1/B2 also at two ragged shapes, one with ``u``
   saturated in a z-slab; B3/B4 also at two ragged shapes with block means
   saturated at ±bound next to the borders, at R 1 and 2, and at the
   SVFFD path's ``(2, 1, 128³)`` R 3, all four shapes through B3's and
   B4's window kernels (block 8, R 1-3; the per-voxel
   kernels they keep for other shapes are checked by
   ``tests/test_torch_cuda.py``); B5-B7 also at a
   general 4-channel, radius-2 shape, two shapes that straddle the tiles
   and z-chunks of B5-B7, dims of 1 and 2 at radius 3, and radius 4), with the
   stated tolerance; the kernel's and the plain version's times, the
   kernel's bound (``Kernel.bound_ms``: bytes over the H100
   SXM's HBM bandwidth or flops over its f32 rate, whichever is larger)
   and, for B3-B7, the time of the one PyTorch call that computes the same
   function (``F.grid_sample`` or ``aten.grid_sampler_3d_backward``),
   checked once against the kernel away from ties; then the z-halo modes
   of B5 and B6 (vol ``2R`` planes deeper, no z clamp) at ``(2, 1, 128³)``
   R 1 and a ragged 4-channel R 2 shape (the ring kernels) and at R 4 (the
   per-voxel kernels), timed at the first with their library calls, and
   the slab identity: 4 z-slabs of a 128³ volume, each with its real
   neighbour rows, concatenate to the unsharded B5 and B6 outputs; B7's
   z-pad mode (B7Z, y/x folded, the 2R z pad planes kept) at the same
   three shapes, timed and held to its library call at the first; the
   z-halo modes of B1/B2 (B1Z/B2Z: d and u one plane deeper on each side)
   and of B3/B4 (B3Z/B4Z: the vol a window h planes deeper) at the
   selftest's ``SPLIT_ZHALO_SHAPES`` and ``BLOCK_ZHALO_SHAPES``, timed at
   the spatial path's per-shard shapes (2 shards of 128³: d_h ``(2, 3,
   66, 128, 128)``, the window ``(2, 1, 88, 128, 128)`` at R 2, h 12),
   B3Z/B4Z held to ``grid_sample`` on the window and its grid gradient;
   and the bf16 z-halo modes of B1/B2 (B1Z-bf16/B2Z-bf16) at the same
   split shapes in bf16, to one bf16 ulp, timed at d_h ``(2, 3, 66, 128,
   128)``;
3. the SG-MCMC path: one SGLD transition over 2 chains at 128³ (the
   ``bench.py`` configuration, "post" noise), 1 warm-up and 10 timed
   transitions through ``init_chains`` -> ``make_mcmc_chunk``; the launch
   counters must move by exactly B1 7, B2 7, B3 1, B4 1 per transition;
   then 5 more transitions under ``torch.profiler``, printed as device
   kernel time by kind (the hand-written kernels by name: B3 as
   ``fwd_window_kernel<2, false>``);
4. the same transition at 64³ with fixed noise on the card and on the CPU
   (plain versions) must agree;
5. the VI path: ``bench.py --phase vi``'s problem at 128³ on the "pre"
   noise scheme, GMM warm-up, 1 warm-up and 10 timed VI steps through
   ``make_vi_step`` -> ``make_vi_chunk``; the counters must move by
   exactly B1 7, B5 9, B6 8, B7 8 (and B2-B4 0) per step; then 5 more
   steps under ``torch.profiler``, printed as in phase 3;
6. one VI step at 64³ with fixed draws on the card and on the CPU must
   agree;
7. the trainer: the port's CLI (``ir_sgmcmc_tpu_torch.run.main``) on
   ``configs/demo/config_synthetic.json`` at 128³ (2 chains, 20 VI steps,
   4 VI-test draws, 10 + 20 transitions, speed tests of 10), in-process;
   no abort, finite VI-test and MCMC Dice no worse than the pair's Dice
   before registration less 0.05, the artifacts of
   ``tests/test_trainer.py::test_trainer_end_to_end``, B1-B5 launched and
   B6/B7 not, and both checkpoints loaded back on the card into the port's
   states; it prints one ``trainer:`` line with the summary, each phase's
   wall time and launches (GMM warm-up, VI, VI test, MCMC) and the peak
   memory;
8. the SVFFD model of experiment 5 (cps 2, a 67³ control grid, block
   radius 3, "post"): (a) 1 + 10 transitions over 2 chains and GMM warm-up
   + 1 + 10 VI steps at 128³, each with B1 7, B2 7, B3 1, B4 1 (B5-B7 0)
   launches per step asserted, a profile of 5 more transitions, and the
   block-residual overflow of the same states at radius 2; (b) a 64³
   transition and a 64³ VI step at cps 2 and 4, card against CPU, and a
   64³ ``remat`` VI step against the batched one on the card; (c)
   ``configs/experiment5/config_SVFFD_2.json`` through the CLI in-process at
   128³ on the synthetic pair with block radius 3, cut as in phase 7, with
   phase 7's checks and a ``svffd_trainer:`` line;
9. pair-parallel registration (``engine/pairs.py``): (a) 1 + 10
   pair-stacked transitions at 128³, 4 pairs x 2 chains, and GMM warm-up
   + 1 + 10 pair-stacked VI steps on "post" (beside one pair's), each with
   B1 7, B2 7, B3 1, B4 1 launches per step asserted, the aggregate rate
   beside phase 3's single pair, the peak memory and a profile of 5 more
   steps; (b) at 64³ with 2 pairs, each pair's rows of a pair-stacked
   transition and VI step against its own run on the card, as one batch
   and in batches of 1 pair; (c) the demo config through the CLI at 128³
   with ``no_pairs`` 4 and ``pair_parallel: true``, cut as in phase 7: no
   abort, each pair's Dice no worse than its ``dsc_before`` less 0.05, each
   pair's artifact tree, the pair-stacked checkpoint (meta
   ``pair_parallel`` 4) loaded back on the card, and a ``pairs_trainer:``
   line (with the pairs per batch that the trainer sized from the card's
   free memory);
10. the quality tools: (a) ``ir_sgmcmc_tpu_torch.selftest`` in-process,
   every kernel of ``all_kernels()`` in each variant against its plain
   version (a ``selftest:`` line); (b) ``svf_pair`` at 64³ made on the
   card against the one made on the CPU; (c) the port's ``quality_eval``
   in-process at 128³ (magnitude 6, VI 128, burn-in 100, samples 200, 2
   chains, seed 0): no abort, Dice after MCMC above Dice before, relative
   displacement error below 1, finite calibration, B1-B5 launched, and a
   ``quality:`` line with the report, the wall time and the launches; (d)
   the same with ``--phantom brain`` at 64³: 15 per-structure rows with
   finite Dice and a finite mean ASD, and a ``quality_brain:`` line;
11. the bfloat16 integrator (``compute_dtype: "bfloat16"``): (a) B1-bf16
   and B2-bf16 against their plain versions at B1/B2's shapes in bf16,
   timed at ``(2, 3, 128³)`` with their bounds; (b) 1 + 10 transitions of
   phase 3's path in bf16, with B1-bf16 7, B2-bf16 7, B3 1, B4 1 and f32
   B1/B2 0 launches per transition asserted, the rate beside phase 3's,
   the peak memory, a profile of 5 more and the device's idle share, and
   1 + 10 transitions of phase 8's SVFFD model in bf16 (the same
   launches asserted); (c)
   the same for GMM warm-up + 1 + 10 VI steps on "post", beside the same
   steps in float32; (d) a 64³ bf16 transition, card against CPU;
12. the multi-device layer (``ir_sgmcmc_tpu_torch/parallel``), on virtual
   shards of the card: (a) ``separable_conv3d_sharded``,
   ``gradient_d_sharded`` and ``warp_bounded_sharded`` (forward and both
   gradients, 1 channel R 1 and 3 channels R 2) over a ``('space',)`` mesh
   of 4 shards at 128³ against the unsharded ops (B5-B7), with B5Z, B6Z
   and B7Z launched once per shard and warp in each direction, then each
   of the three on every shard's own (haloed) operands against its plain
   version (a ``halo:`` line); (b) phase 3's 10 transitions through
   ``make_mcmc_chunk(chain_mesh=...)`` over 2 shards against the unsharded
   chunk (bitwise or not, and the error), one chunk under
   ``torch.cuda.set_sync_debug_mode("error")``, and both samples/sec (a
   ``chain_mesh:`` line); (c) the demo config through the CLI with
   ``--devices`` naming the card twice and ``distribute: true``, cut as
   in phase 7, then with 4
   pairs over a 2-shard pair mesh, each summary beside the one-device run's
   (``distributed_trainer:`` and ``distributed_pairs_trainer:`` lines);
   (d) with two cards or more, the selftest on every card, (a) and (b)
   again on real cards, and the demo config over ``cuda:0,cuda:1`` beside
   phase 7's one-card run (a ``trainer_2cards:`` line), else one line
   saying they were not run;
13. the spatially sharded steps (``parallel/spatial.py``), on 2 virtual
   shards of the card: (a) phase 3's 10 transitions through
   ``make_mcmc_chunk`` on a ``(1, 2)`` ``('chain', 'space')`` mesh against
   the unsharded chunk from the same state and draws (B1Z 7, B2Z 7, B3Z 1,
   B4Z 1 launches per transition and shard, B1-B4 none; state and data
   term within atol 1e-5 plus rtol 1e-5, bitwise or not; one chunk under
   ``torch.cuda.set_sync_debug_mode("error")``; both samples/sec and each
   card's peak memory); (b) VI on "post" (GMM warm-up, 10 steps) over a
   ``('space',)`` mesh of 2 against the unsharded steps (the same
   launches; the total loss within rtol 1e-4 and one step's q(v) gradient
   within 1e-4 of its largest element; ``mu`` after the 10 steps printed);
   a ``spatial:`` line; (c) the demo config through the CLI with
   ``--devices`` naming the card twice and ``spatial_shards`` and
   ``vi_spatial_shards`` 2, cut as in phase 7, with phase 7's checks and
   its Dice beside the one-device run's (a ``spatial_trainer:`` line);
   (d) with two cards or more, (a)-(c) and (e) over two real cards, and
   with four (a)-(b) at 4 shards over four, else one line saying they were
   not run; (e) each other option of the dense model at 128³ on 2 virtual
   shards against the unsharded step: MCMC with ``taylor_compositions:
   "warp"`` (B5Z-B7Z 7, B3Z 1, B4Z 1 per transition and shard),
   ``use_gather`` (no hand-written kernel), ``compute_dtype: "bfloat16"``
   (B1Z-bf16 7, B2Z-bf16 7, B3Z 1, B4Z 1) and the Fourier energy (13(a)'s
   kernels), VI on ``"pre"`` (B1Z 7, B5Z 9, B6Z 8, B7Z 8), with 13(a)-(b)'s
   checks, both rates and each card's peak memory (a ``spatial_options:``
   line);
14. the benchmark entry (``python -m ir_sgmcmc_tpu_torch.bench``): (a) run
   from the repository's root with no argument, a subprocess: rc 0, one
   JSON line with the canonical metric and keys, finite rates, and B1 7,
   B2 7, B3 1, B4 1 launches per step in both phases; (c) B1-B4 against
   their plain versions at the 256³ benchmark's shapes, at phase 2's
   tolerances, timed; (b) ``bench.main`` in process on ``--phase vi
   --noise-scheme pre``, ``--compute-dtype bfloat16``,
   ``--taylor-compositions off``, ``--use-gather``, ``--model svffd``,
   ``--dims 256`` and ``--dims 256 --phase vi`` (remat), each line printed
   and its launches per step held to its table (``BENCH_RUNS``; the 256³
   runs at one timed chunk); (d) the 256³ MCMC run with ``--trace``, the
   trace grouped by ``scripts/trace_summary.py``, which must find B1-B4 at
   their launches;
15. anchored residual warping (``mcmc_anchor``) and the ``"taylor"``
   compositions: (a) anchored MCMC at 128³ x 2 chains on "post" (the
   bench model), in the ``"taylor"`` and ``"blend"`` modes, re-anchored
   every ANCHOR_PERIOD transitions at the anchor radius ANCHOR_RADIUS: one
   warm-up and TIMED transitions, B1 7 per transition and 7 per
   re-anchoring, B2 7, and in the ``"blend"`` mode B5 1 and B6 1 at R 2
   (B3/B4 and B7 0) asserted, finite data terms, ``sat_resid`` reported,
   the rate beside phase 3's; (b) a 64³ anchored transition in each mode,
   card against CPU; (c) ``taylor_compositions: "taylor"`` (e 4, K 8): one
   warm-up and TIMED transitions on "post" (B3 1, B4 1, nothing else) and
   GMM warm-up, one warm-up and TIMED VI steps on "pre" (B5 9, B6 8, B7
   8), then a 64³ transition and VI step card against CPU; (d) the demo
   config through the CLI in-process at 128³ with ``mcmc_anchor: true``,
   phase 7's cuts: no crash, the summary keys, and any saturation warning
   or abort naming ``anchor_radius``; (e) 13(e)'s pattern for anchored
   MCMC in both modes and for ``"taylor"`` (MCMC on "post", VI on "pre")
   on 2 virtual shards against the unsharded step; one ``phase_15:``
   line with the rates, peaks and launches.  Phase 2 also holds B5 and B6
   at the anchored path's ``(2, 1, 128³)`` R 2 to their plain versions,
   timed, with their library calls.

The operand builders, shape tables and tolerances of phase 2 are the
selftest's (``ir_sgmcmc_tpu_torch/selftest.py``); every profile is a
Chrome trace grouped by ``ir_sgmcmc_tpu_torch/scripts/trace_summary.py``.
Each path's counters are set to 0 just before its timed run (the
trainer's: its whole CLI run) and read just after.  Then one JSON line of
kernel results (B3 and B4 once per radius: ``block_warp_fwd`` at R 2 with
the dense paths' launches and phase 14's (``--model svffd`` at radius 2
too), ``block_warp_fwd_r3`` at R 3 with phase 8's and 11's SVFFD
paths'; B5 and B6 once per radius: ``warp_bounded_fwd`` at R 1 with
every path's but the anchored ``"blend"`` ones, ``warp_bounded_fwd_r2``
with phase 15's anchored ``"blend"`` paths'; the bf16 modes of B1/B2
with phase 11's launches; the z-halo modes of B5/B6 and the z-pad mode
of B7 with phase 12's, 13(e)'s and 15(e)'s, those of B1-B4 with phase
13's and 15(e)'s, the bf16 z-halo modes of B1/B2 with 13(e)'s: no kernel
may have 0), the ``nvidia-smi`` name/power line, and the final status
line.  Imports nothing of JAX.
Exits non-zero, with no result, when CUDA is unavailable.  TF32 is off for
matmuls and cuDNN.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

DIMS = (128, 128, 128)
CHAINS = 2
TIMED = 10
SMALL = (64, 64, 64)
SVFFD_CPS = 2  # experiment 5's config_SVFFD_2.json: a 67³ control grid at 128³
SVFFD_RADIUS = 3  # configs/README.md, "SVFFD at high resolution"
ANCHOR_RADIUS = 2  # the trainer's default anchor_radius (phase 15)
ANCHOR_PERIOD = 5  # phase 15's re-anchoring period: twice in TIMED transitions


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _err(out, ref, atol: float, rtol: float, name: str, **inputs) -> float:
    """Max abs error; raises where ``|out-ref| > atol + rtol·|ref|``, naming
    the first offending indices and the ``inputs`` there."""
    diff = (out - ref).abs()
    bad = diff > atol + rtol * ref.abs()
    if not torch.isfinite(out).all() or bool(bad.any()):
        idx = bad.nonzero()[:4].tolist()
        at = [{"index": i, "out": float(out[tuple(i)]), "ref": float(ref[tuple(i)]),
               **{k: v[tuple(i)].tolist() if v.ndim == out.ndim else None
                  for k, v in inputs.items()}} for i in idx]
        raise AssertionError(f"{name}: {int(bad.sum())} elements off the plain "
                             f"version (max abs err {float(diff.max()):.3e}, "
                             f"atol {atol}, rtol {rtol}); first: {at}")
    return float(diff.max())


def _problem(dims, device, noise_scheme="post", cps=None, compute_dtype=None, **svf):
    """``bench.py``'s model and pair (``ir_sgmcmc_tpu_torch.bench``), with its
    MCMC optimizers.  With ``cps``, the SVFFD model of phases 8 and 11:
    experiment 5's control grid of spacing ``cps`` and its Sobolev s 2
    (``configs/experiment5``) with block radius 3 (configs/README.md), on
    ``bench.py``'s likelihood and regulariser; not ``bench.py --model
    svffd``'s model, which keeps s 3 and radius 2.  ``compute_dtype`` and
    ``svf`` (``taylor_compositions``): the integrator's."""
    import dataclasses

    from ir_sgmcmc_tpu_torch.bench import make_bundle_and_pair
    from ir_sgmcmc_tpu_torch.optim import adam_decay

    bundle, fixed, moving = make_bundle_and_pair(
        noise_scheme, dims, "svf" if cps is None else "svffd", cps, device,
        compute_dtype=compute_dtype, **svf)
    if cps is not None:
        bundle = dataclasses.replace(bundle, sobolev_s=2, block_radius=SVFFD_RADIUS)
    opt_gmm = adam_decay(0.2, 1e-3)
    opt_reg = adam_decay({"loc": 0.01, "log_scale": 0.01}, 1e-3)
    return bundle, fixed, moving, opt_gmm, opt_reg


def _init(bundle, opt_gmm, opt_reg, device, seed=0):
    from ir_sgmcmc_tpu_torch.engine import init_chains

    gen = torch.Generator(device=device).manual_seed(seed)
    return init_chains(bundle, gen, CHAINS, "noise", None,
                       bundle.gmm.init_params(device),
                       bundle.reg_loss.init_params(device),
                       opt_gmm, opt_reg, device=device)


# The library calls are checked against the kernels at this tolerance: they
# sample at normalised coordinates, whose f32 rounding moves a point by up
# to ~1e-5 voxel at 128, times value differences of a few units.
LIB_ATOL, LIB_RTOL = 1e-3, 1e-3


def _row(kernel, shape, err, atol, rtol, ms, plain_ms, library_ms=None, radius=None,
         halo=None) -> dict:
    """A kernel's result; ``halo``: the z-halo planes on each side that its
    bound counts (B1Z-B4Z; B5Z-B7Z count ``radius``)."""
    return {"kernel": kernel, "shape": shape, "err": err, "atol": atol, "rtol": rtol,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "radius": radius,
            "halo": halo}


def _bound(r) -> tuple:
    """A row's ``Kernel.bound_ms``: a z-halo kernel's bound counts its halo
    planes."""
    return r["kernel"].bound_ms(r["shape"], r["halo"] if r["halo"] is not None
                                else r["radius"] or 0)


def _grid(disp):
    """``grid_sample``'s ``(B, D, H, W, 3)`` normalised sample points at
    identity + ``disp`` (voxels, ``(B, 3, D, H, W)``, channel 0 = x)."""
    from ir_sgmcmc_tpu_torch.ops.grids import identity_grid, voxel_to_normalised

    pts = identity_grid(tuple(disp.shape[-3:]), device=disp.device) + voxel_to_normalised(disp)
    return pts.permute(0, 2, 3, 4, 1).contiguous()


def _grid_grad_voxels(gg):
    """A grid gradient per normalised unit, ``(B, D, H, W, 3)``, as one per
    voxel, ``(B, 3, D, H, W)``: × 2/(n-1) along each axis."""
    D, H, W = gg.shape[1:4]
    scale = torch.tensor([2.0 / (W - 1), 2.0 / (H - 1), 2.0 / (D - 1)], device=gg.device)
    return (gg * scale).permute(0, 4, 1, 2, 3).contiguous()


def _off_ties(disp, eps: float = 1e-3):
    """Points whose displacement is more than ``eps`` from an integer on
    every axis, where a grid gradient is the same from either side."""
    far = ((disp - torch.round(disp)).abs() > eps).all(dim=1, keepdim=True)
    return far.expand_as(disp)


def _library_ms(name: str, call, ref, mask=None) -> float:
    """Check ``call()`` once against the kernel's ``ref`` (on ``mask``),
    then time the call alone."""
    out = call()
    if mask is not None:
        out, ref = out[mask], ref[mask]
    _err(out, ref, LIB_ATOL, LIB_RTOL, f"library call of {name}")
    return _time_ms(call)


def _grid_sample(vol, grid):
    return torch.nn.functional.grid_sample(vol, grid, mode="bilinear", padding_mode="border",
                                           align_corners=True)


def _grid_sample_grads(g, vol, grid, mask):
    """``aten.grid_sampler_3d_backward`` (bilinear, border, align_corners)
    with ``output_mask``: [input, grid]."""
    return torch.ops.aten.grid_sampler_3d_backward(g, vol, grid, 0, 1, True, mask)


def _split_rows(gen, dtype) -> list:
    """B1 and B2, or with ``dtype`` bf16 their bf16 modes, against their
    plain versions on the selftest's ``SPLIT_SHAPES`` (f32: ``ū`` with the
    ``+g`` of the direct term; bf16: ``ū_warp`` as B2-bf16 returns it, ties
    at ``|u| = 1`` included, where both take no offset gradient); the
    saturated slab's offset gradient exactly 0; timed at the main path's
    ``(2, 3, 128³)``."""
    from ir_sgmcmc_tpu_torch import selftest as st
    from ir_sgmcmc_tpu_torch.kernels import split_warp as sw

    bf16 = dtype == torch.bfloat16
    fwd, bwd = (sw.B1_BF16, sw.B2_BF16) if bf16 else (sw.B1, sw.B2)
    plain_vjp = sw.split_warp_vjp_plain if bf16 else sw.split_compose_vjp_plain
    names = ("B1-bf16", "B2-bf16") if bf16 else ("B1", "B2")
    errs = {fwd: 0.0, bwd: 0.0}
    tol = {k: st.TOL[k.symbol] for k in (fwd, bwd)}
    for shape, slab, offset in st.SPLIT_SHAPES:
        d, u, g = st.split_operands(gen, shape, slab, dtype, offset)
        out = sw.split_warp_fwd_cuda(d, u)
        if out.dtype != dtype:
            raise AssertionError(f"{names[0]} {shape}: output dtype {out.dtype}")
        errs[fwd] = max(errs[fwd], _err(out.float(), sw.split_compose_plain(d, u).float(),
                                        *tol[fwd], f"{names[0]} {shape}"))
        gd_k, gu_k = sw.split_warp_bwd_cuda(d, u, g)
        gd_p, gu_p = plain_vjp(d, u, g)
        gu_c = gu_k if bf16 else gu_k + g
        errs[bwd] = max(errs[bwd], _err(gd_k.float(), gd_p.float(), *tol[bwd],
                                        f"{names[1]} gd {shape}"),
                        _err(gu_c.float(), gu_p.float(), *tol[bwd], f"{names[1]} gu {shape}",
                             u=u.float(), d=d.float()))
        if slab is not None and bool(gu_k[:, :, slice(*slab)].any()):
            raise AssertionError(f"{names[1]} {shape}: offset gradient where |u| > 1")
        if shape[2:] == DIMS:  # timed at the main path's shape
            times = {fwd: (_time_ms(lambda: sw.split_warp_fwd_cuda(d, u)),
                           _time_ms(lambda: sw.split_compose_plain(d, u))),
                     bwd: (_time_ms(lambda: sw.split_warp_bwd_cuda(d, u, g)),
                           _time_ms(lambda: plain_vjp(d, u, g)))}
    return [_row(k, st.SPLIT_SHAPES[0][0], errs[k], *tol[k], *times[k]) for k in (fwd, bwd)]


def phase_kernels(dev) -> list:
    """B1-B4 against their plain versions at the main path's shapes and at
    ragged ones; B3/B4 against their library calls."""
    from ir_sgmcmc_tpu_torch import selftest as st
    from ir_sgmcmc_tpu_torch.kernels import block_warp as bw

    gen = torch.Generator(device=dev).manual_seed(1234)
    tol = {k: st.TOL[k.symbol] for k in (bw.B3, bw.B4)}
    rows = _split_rows(gen, torch.float32)

    errs = {bw.B3: 0.0, bw.B4: 0.0}
    for shape, bound, radius in st.BLOCK_SHAPES:
        main = shape == (CHAINS, 1) + DIMS
        vol, r, m, gv = st.block_operands(gen, shape, bound, radius, saturate=not main)
        out = bw.block_warp_cuda(vol, r, m, radius)
        e3 = _err(out, bw.block_warp_plain(vol, r, m), *tol[bw.B3],
                  f"B3 {shape} bound {bound} R {radius}")
        dout = bw.block_warp_dgrad_cuda(vol, r, m, gv, radius)
        e4 = _err(dout, bw.block_warp_dgrad_plain(vol, r, m, gv), *tol[bw.B4],
                  f"B4 {shape} bound {bound} R {radius}")
        if radius != SVFFD_RADIUS or not main:
            errs[bw.B3], errs[bw.B4] = max(errs[bw.B3], e3), max(errs[bw.B4], e4)
        if not main:
            continue
        # timed, and held to the library calls, at the paths' shapes: R 2
        # (the dense model) and R 3 (SVFFD at 128³)
        at = bw._expand_blocks(m, 8).float() + r
        grid = _grid(at)
        lib3 = _library_ms("B3", lambda: _grid_sample(vol, grid), out)
        lib4 = _library_ms("B4", lambda: _grid_grad_voxels(
            _grid_sample_grads(gv, vol, grid, [False, True])[1]), dout, _off_ties(at))
        rows += [
            _row(bw.B3, shape, e3, *tol[bw.B3],
                 _time_ms(lambda: bw.block_warp_cuda(vol, r, m, radius)),
                 _time_ms(lambda: bw.block_warp_plain(vol, r, m)), lib3, radius),
            _row(bw.B4, shape, e4, *tol[bw.B4],
                 _time_ms(lambda: bw.block_warp_dgrad_cuda(vol, r, m, gv, radius)),
                 _time_ms(lambda: bw.block_warp_dgrad_plain(vol, r, m, gv)), lib4, radius)]
    for row in rows:
        if row.get("radius") not in (None, SVFFD_RADIUS):
            row["err"] = errs[row["kernel"]]  # the worst over every non-SVFFD shape
    _print_rows(rows)
    return rows


def _print_rows(rows) -> None:
    for r in rows:
        k = r["kernel"]
        bound, by = _bound(r)
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        at_r = "" if r["radius"] is None else f" R {r['radius']}"
        at_r += "" if r["halo"] is None else f" h {r['halo']}"
        print(f"kernel {k.symbol} {tuple(r['shape'])}{at_r}: max_abs_err {r['err']:.3e} (atol "
              f"{r['atol']}, rtol {r['rtol']}) kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {bound:.4f} ms ({by}; "
              f"{100 * bound / r['ms']:.1f}% of it), library {lib}", flush=True)


def phase_blend_kernels(dev) -> list:
    """B5-B7 against their plain versions on the card: at the VI path's
    ``(2, 1, 128³)``, R 1 (timed), a general ``(2, 4, 64³)``, R 2, two
    shapes that straddle B6's and B7's 32 x 8 tiles and 16-plane z-chunks,
    dims of 1 and 2 at R 3, and R 4 (the per-voxel gathers).

    The kernels and the plain versions evaluate ``tri`` and ``dtri`` by
    the same expressions at the same points, so no tie (integer ``d``,
    ``|d| = R``) needs avoiding: both take the zero subgradient there.
    Tolerance atol 1e-5 (the JAX suite's for these kernels) plus rtol 1e-5
    for the sums of up to 27·C products at C = 4."""
    from ir_sgmcmc_tpu_torch import selftest as st
    from ir_sgmcmc_tpu_torch.kernels import warp_bounded as wb

    gen = torch.Generator(device=dev).manual_seed(4321)
    atol, rtol = st.TOL[wb.B5.symbol]
    errs = {wb.B5: 0.0, wb.B6: 0.0, wb.B7: 0.0}
    timed = {}
    for shape, R in st.BOUNDED_SHAPES:
        main = shape == st.BOUNDED_SHAPES[0][0]
        vol, disp, g = st.bounded_operands(gen, shape, R)
        calls = {
            wb.B5: (lambda: wb.warp_bounded_fwd_cuda(vol, disp, R),
                    lambda: wb.warp_bounded_plain(vol, disp, R)),
            wb.B6: (lambda: wb.warp_bounded_dgrad_cuda(vol, disp, g, R),
                    lambda: wb.warp_bounded_dgrad_plain(vol, disp, g, R)),
            wb.B7: (lambda: wb.warp_bounded_tblend_cuda(disp, g, R),
                    lambda: wb.warp_bounded_tblend_plain(disp, g, R)),
        }
        for k, (kern, plain) in calls.items():
            err = _err(kern(), plain(), atol, rtol, f"{k.symbol} {shape} R {R}",
                       disp=disp if k is wb.B6 else torch.zeros(0))
            errs[k] = max(errs[k], err)
            if main:
                timed[k] = (shape, _time_ms(kern), _time_ms(plain))
        if main:
            # the library calls at the VI path's shape: grid at id + clip(d, ±R)
            at = disp.clamp(-R, R)
            grid = _grid(at)
            library = {
                wb.B5: (lambda: _grid_sample(vol, grid), None),
                wb.B6: (lambda: _grid_grad_voxels(
                    _grid_sample_grads(g, vol, grid, [False, True])[1]), _off_ties(at)),
                wb.B7: (lambda: _grid_sample_grads(g, vol, grid, [True, False])[0], None),
            }
            for k, (call, mask) in library.items():
                timed[k] += (_library_ms(k.symbol, call, calls[k][0](), mask),)
    rows = [_row(k, timed[k][0], errs[k], atol, rtol, *timed[k][1:])
            for k in (wb.B5, wb.B6, wb.B7)]
    _print_rows(rows)
    return rows


ZHALO_SLABS = 4


def phase_zhalo_kernels(dev) -> list:
    """The z-halo modes of B5 and B6 (vol ``2R`` planes deeper than disp,
    no z clamp) and the z-pad mode of B7 (B7Z: output ``2R`` planes deeper
    than g, y/x folded, z not) against their plain versions at
    ``ZHALO_SHAPES``, with the tolerance of the default mode; timed, bounded
    and held to the library calls at ``(2, 1, 128³)`` R 1 (B7Z's: the input
    gradient of ``grid_sample`` on a vol ``2R`` planes deeper, sampled at
    ``zhalo_grid``, whose points never reach its z border: y and x fold, z
    does not).  Then the slab identity that the JAX
    package's sharded steps rely on (``parallel/halo.py``): the z-halo
    outputs of 4 z-slabs of a 128³ volume, each given its real neighbour
    rows (edge rows at the two ends), concatenate to the unsharded B5 and
    B6 outputs."""
    from ir_sgmcmc_tpu_torch import selftest as st
    from ir_sgmcmc_tpu_torch.kernels import warp_bounded as wb

    gen = torch.Generator(device=dev).manual_seed(5678)
    atol, rtol = st.TOL[wb.B5Z.symbol]
    errs = {wb.B5Z: 0.0, wb.B6Z: 0.0, wb.B7Z: 0.0}
    timed = {}
    for shape, R in st.ZHALO_SHAPES:
        B, C, D, H, W = shape
        _, disp, g = st.bounded_operands(gen, shape, R)
        vol = torch.randn((B, C, D + 2 * R, H, W), generator=gen, device=dev)
        calls = {
            wb.B5Z: (lambda: wb.warp_bounded_fwd_cuda(vol, disp, R, z_halo=True),
                     lambda: wb.warp_bounded_plain(vol, disp, R, z_halo=True)),
            wb.B6Z: (lambda: wb.warp_bounded_dgrad_cuda(vol, disp, g, R, z_halo=True),
                     lambda: wb.warp_bounded_dgrad_plain(vol, disp, g, R, z_halo=True)),
            wb.B7Z: (lambda: wb.warp_bounded_tblend_cuda(disp, g, R, z_pad=True),
                     lambda: wb.warp_bounded_tblend_zpad_plain(disp, g, R)),
        }
        for k, (kern, plain) in calls.items():
            errs[k] = max(errs[k], _err(kern(), plain(), atol, rtol, f"{k.symbol} {shape} R {R}"))
        if shape != st.ZHALO_SHAPES[0][0]:
            continue
        grid = st.zhalo_grid(disp, R)
        at = disp.clamp(-R, R)
        scale = torch.tensor([2.0 / (W - 1), 2.0 / (H - 1), 2.0 / (D + 2 * R - 1)], device=dev)
        library = {
            wb.B5Z: (lambda: _grid_sample(vol, grid), None),
            wb.B6Z: (lambda: (_grid_sample_grads(g, vol, grid, [False, True])[1] * scale
                              ).permute(0, 4, 1, 2, 3).contiguous(), _off_ties(at)),
            wb.B7Z: (lambda: _grid_sample_grads(g, vol, grid, [True, False])[0], None),
        }
        for k, (kern, plain) in calls.items():
            call, mask = library[k]
            timed[k] = (shape, _time_ms(kern), _time_ms(plain),
                        _library_ms(k.symbol, call, kern(), mask))
    rows = [_row(k, timed[k][0], errs[k], atol, rtol, *timed[k][1:], radius=st.ZHALO_SHAPES[0][1])
            for k in (wb.B5Z, wb.B6Z, wb.B7Z)]
    _print_rows(rows)

    # the slab identity at 128³, R 1 and 2
    for R in (1, 2):
        vol, disp, g = st.bounded_operands(gen, (CHAINS, 1) + DIMS, R)
        zpad = torch.nn.functional.pad(vol, (0, 0, 0, 0, R, R), mode="replicate")
        n = DIMS[0] // ZHALO_SLABS
        outs, dgs = [], []
        for z0 in range(0, DIMS[0], n):
            slab = zpad[:, :, z0:z0 + n + 2 * R].contiguous()
            d, gs = disp[:, :, z0:z0 + n].contiguous(), g[:, :, z0:z0 + n].contiguous()
            outs.append(wb.warp_bounded_fwd_cuda(slab, d, R, z_halo=True))
            dgs.append(wb.warp_bounded_dgrad_cuda(slab, d, gs, R, z_halo=True))
        out, dg = torch.cat(outs, dim=2), torch.cat(dgs, dim=2)
        full, full_dg = (wb.warp_bounded_fwd_cuda(vol, disp, R),
                         wb.warp_bounded_dgrad_cuda(vol, disp, g, R))
        e5 = _err(out, full, atol, rtol, f"z-halo slabs of B5 R {R}")
        e6 = _err(dg, full_dg, atol, rtol, f"z-halo slabs of B6 R {R}")
        print(f"zhalo: {ZHALO_SLABS} z-slabs of {(CHAINS, 1) + DIMS} R {R} with their "
              f"neighbour rows concatenate to the unsharded B5 (max abs err {e5:.3e}, bitwise "
              f"{torch.equal(out, full)}) and B6 (max abs err {e6:.3e}, bitwise "
              f"{torch.equal(dg, full_dg)})", flush=True)
    return rows


def _window_grid(at, h: int):
    """``grid_sample``'s normalised points in a slab's window ``(D + 2h, H,
    W)`` at identity + ``at`` (voxels, ``(B, 3, D, H, W)``), z shifted by
    the halo."""
    B, _, D, H, W = at.shape
    z, y, x = torch.meshgrid(*(torch.arange(n, device=at.device, dtype=torch.float32)
                               for n in (D, H, W)), indexing="ij")
    return torch.stack([(x + at[:, 0]) * (2.0 / (W - 1)) - 1.0,
                        (y + at[:, 1]) * (2.0 / (H - 1)) - 1.0,
                        (z + h + at[:, 2]) * (2.0 / (D + 2 * h - 1)) - 1.0], dim=-1)


def phase_spatial_kernels(dev) -> list:
    """The z-halo modes of B1-B4 (B1Z/B2Z: d and u one plane deeper on each
    side; B3Z/B4Z: the vol a window ``h`` planes deeper) against their plain
    versions at the selftest's ``SPLIT_ZHALO_SHAPES`` and
    ``BLOCK_ZHALO_SHAPES``, with the tolerances of the default modes;
    timed and bounded at the spatial path's per-shard shapes (2 shards of
    128³: d_h ``(2, 3, 66, 128, 128)``; the window ``(2, 1, 64 + 2·12, 128,
    128)`` at R 2).  B3Z and B4Z are held to their library calls
    (``grid_sample`` on the window, and its grid gradient, whose points
    never reach the window's z ends); no PyTorch call computes the split
    step (B1Z/B2Z: none).  Then the bf16 z-halo modes B1Z-bf16/B2Z-bf16 at
    the same shapes in bf16, to one bf16 ulp (the bf16 modes' tolerance),
    timed at the first."""
    from ir_sgmcmc_tpu_torch import selftest as st
    from ir_sgmcmc_tpu_torch.kernels import block_warp as bw
    from ir_sgmcmc_tpu_torch.kernels import split_warp as sw

    gen = torch.Generator(device=dev).manual_seed(8765)
    tol = {k: st.TOL[k.symbol] for k in (sw.B1Z, sw.B2Z, bw.B3Z, bw.B4Z)}
    errs, timed = dict.fromkeys(tol, 0.0), {}
    for shape in st.SPLIT_ZHALO_SHAPES:
        d_h, u_h, g = st.split_zhalo_operands(gen, shape)
        errs[sw.B1Z] = max(errs[sw.B1Z], _err(sw.split_warp_fwd_zhalo_cuda(d_h, u_h),
                                              sw.split_compose_zhalo_plain(d_h, u_h),
                                              *tol[sw.B1Z], f"B1Z {shape}"))
        for what, a, b in zip(("gd", "gu"), sw.split_compose_zhalo_vjp(d_h, u_h, g),
                              sw.split_compose_zhalo_vjp_plain(d_h, u_h, g)):
            errs[sw.B2Z] = max(errs[sw.B2Z], _err(a, b, *tol[sw.B2Z], f"B2Z {what} {shape}"))
        if shape == st.SPLIT_ZHALO_SHAPES[0]:
            timed[sw.B1Z] = (shape, _time_ms(lambda: sw.split_warp_fwd_zhalo_cuda(d_h, u_h)),
                             _time_ms(lambda: sw.split_compose_zhalo_plain(d_h, u_h)), None)
            timed[sw.B2Z] = (shape, _time_ms(lambda: sw.split_warp_bwd_zhalo_cuda(d_h, u_h, g)),
                             _time_ms(lambda: sw.split_warp_vjp_zhalo_plain(d_h, u_h, g)), None)
    for shape, bound, R, block, h in st.BLOCK_ZHALO_SHAPES:
        vol_h, r, m, g = st.block_zhalo_operands(gen, shape, bound, R, block, h)
        out = bw.block_warp_zhalo_cuda(vol_h, r, m, R, h, block)
        dout = bw.block_warp_dgrad_zhalo_cuda(vol_h, r, m, g, R, h, block)
        errs[bw.B3Z] = max(errs[bw.B3Z], _err(out, bw.block_warp_plain(vol_h, r, m, block, h),
                                              *tol[bw.B3Z], f"B3Z {shape} R {R} h {h}"))
        errs[bw.B4Z] = max(errs[bw.B4Z], _err(
            dout, bw.block_warp_dgrad_plain(vol_h, r, m, g, block, h), *tol[bw.B4Z],
            f"B4Z {shape} R {R} h {h}"))
        if shape != st.BLOCK_ZHALO_SHAPES[0][0]:
            continue
        at = bw._expand_blocks(m, block).float() + r
        grid = _window_grid(at, h)
        Dv, H, W = vol_h.shape[2:]
        scale = torch.tensor([2.0 / (W - 1), 2.0 / (H - 1), 2.0 / (Dv - 1)], device=dev)
        lib3 = _library_ms("B3Z", lambda: _grid_sample(vol_h, grid), out)
        lib4 = _library_ms("B4Z", lambda: (_grid_sample_grads(g, vol_h, grid, [False, True])[1]
                                           * scale).permute(0, 4, 1, 2, 3).contiguous(),
                           dout, _off_ties(at))
        timed[bw.B3Z] = (shape, _time_ms(lambda: bw.block_warp_zhalo_cuda(vol_h, r, m, R, h)),
                         _time_ms(lambda: bw.block_warp_plain(vol_h, r, m, block, h)), lib3, R, h)
        timed[bw.B4Z] = (shape, _time_ms(lambda: bw.block_warp_dgrad_zhalo_cuda(vol_h, r, m, g,
                                                                               R, h)),
                         _time_ms(lambda: bw.block_warp_dgrad_plain(vol_h, r, m, g, block, h)),
                         lib4, R, h)
    # B1Z-bf16/B2Z-bf16: B2Z-bf16's own outputs (no +g), as the bf16 rows of
    # phase 11 hold B2-bf16's, at the tolerances of the bf16 modes
    for k in (sw.B1Z_BF16, sw.B2Z_BF16):
        tol[k], errs[k] = st.TOL[k.symbol], 0.0
    for shape in st.SPLIT_ZHALO_SHAPES:
        d_h, u_h, g = st.split_zhalo_operands(gen, shape, torch.bfloat16)
        out = sw.split_warp_fwd_zhalo_cuda(d_h, u_h)
        if out.dtype != torch.bfloat16:
            raise AssertionError(f"B1Z-bf16 {shape}: output dtype {out.dtype}")
        errs[sw.B1Z_BF16] = max(errs[sw.B1Z_BF16], _err(
            out.float(), sw.split_compose_zhalo_plain(d_h, u_h).float(), *tol[sw.B1Z_BF16],
            f"B1Z-bf16 {shape}"))
        for what, a, b in zip(("gd", "gu"), sw.split_warp_bwd_zhalo_cuda(d_h, u_h, g),
                              sw.split_warp_vjp_zhalo_plain(d_h, u_h, g)):
            errs[sw.B2Z_BF16] = max(errs[sw.B2Z_BF16], _err(
                a.float(), b.float(), *tol[sw.B2Z_BF16], f"B2Z-bf16 {what} {shape}",
                u=u_h.float(), d=d_h.float()))
        if shape == st.SPLIT_ZHALO_SHAPES[0]:
            timed[sw.B1Z_BF16] = (shape, _time_ms(lambda: sw.split_warp_fwd_zhalo_cuda(d_h, u_h)),
                                  _time_ms(lambda: sw.split_compose_zhalo_plain(d_h, u_h)), None)
            timed[sw.B2Z_BF16] = (shape,
                                  _time_ms(lambda: sw.split_warp_bwd_zhalo_cuda(d_h, u_h, g)),
                                  _time_ms(lambda: sw.split_warp_vjp_zhalo_plain(d_h, u_h, g)),
                                  None)
    rows = [_row(k, timed[k][0], errs[k], *tol[k], *timed[k][1:4], halo=1)
            for k in (sw.B1Z, sw.B2Z)]
    rows += [_row(k, timed[k][0], errs[k], *tol[k], *timed[k][1:4], radius=timed[k][4],
                  halo=timed[k][5]) for k in (bw.B3Z, bw.B4Z)]
    rows += [_row(k, timed[k][0], errs[k], *tol[k], *timed[k][1:4], halo=1)
             for k in (sw.B1Z_BF16, sw.B2Z_BF16)]
    _print_rows(rows)
    return rows


# launches per transition, and per VI step on "post", of the dense and SVFFD
# models alike: the integration's 7 split compositions forward and backward
# and one block-gather warp
POST_PER_STEP = {"split_warp_fwd": 7, "split_warp_bwd": 7, "block_warp_fwd": 1,
                  "block_warp_dgrad": 1, "warp_bounded_fwd": 0, "warp_bounded_dgrad": 0,
                  "warp_bounded_tblend": 0, "split_warp_fwd_bf16": 0,
                  "split_warp_bwd_bf16": 0, "warp_bounded_fwd_zhalo": 0,
                  "warp_bounded_dgrad_zhalo": 0, "warp_bounded_tblend_zpad": 0,
                  "split_warp_fwd_zhalo": 0, "split_warp_bwd_zhalo": 0,
                  "block_warp_fwd_zhalo": 0, "block_warp_dgrad_zhalo": 0,
                  "split_warp_fwd_zhalo_bf16": 0, "split_warp_bwd_zhalo_bf16": 0}
# the z-halo modes of B5/B6 and the z-pad mode of B7: the halo-exchanged
# warp (parallel/halo.py) alone calls them, on the halo phase's path
ZHALO = ("warp_bounded_fwd_zhalo", "warp_bounded_dgrad_zhalo", "warp_bounded_tblend_zpad")
# the bf16 modes of B1/B2 run only with compute_dtype bf16 (phase 11)
BF16 = ("split_warp_fwd_bf16", "split_warp_bwd_bf16")
# the z-halo modes of B1-B4: the spatially sharded steps alone call them (phase 13)
SPATIAL = ("split_warp_fwd_zhalo", "split_warp_bwd_zhalo", "block_warp_fwd_zhalo",
           "block_warp_dgrad_zhalo")
# the bf16 z-halo modes of B1/B2: the sharded steps with compute_dtype bf16
# alone call them (phase 13's options)
SPATIAL_BF16 = ("split_warp_fwd_zhalo_bf16", "split_warp_bwd_zhalo_bf16")
# kernels that the f32 CLI and quality runs must not launch
NOT_ON_F32_RUNS = (("warp_bounded_dgrad", "warp_bounded_tblend") + ZHALO + BF16 + SPATIAL
                   + SPATIAL_BF16)


def _timed_run(run, state, steps: int, what: str, per_step: dict):
    """``run(state)`` of ``steps`` steps with every counter set to 0 just
    before and read just after; asserts ``per_step`` launches per step.
    Returns ``(state, metrics, seconds, launches, peak bytes)``."""
    from ir_sgmcmc_tpu_torch.kernels import all_kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    state, metrics = run(state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in kernels}
    for sym, per in per_step.items():
        if launches[sym] != per * steps:
            raise AssertionError(f"{what}: {sym} launched {launches[sym]} times in {steps} "
                                 f"steps, expected {per * steps}")
    return state, metrics, seconds, launches, torch.cuda.max_memory_allocated()


def phase_slice(dev) -> tuple:
    """1 warm-up + TIMED transitions at 128³ x 2 chains on the card, then a
    profile of 5 more; returns the launch counts of the timed run and its
    samples/sec."""
    from ir_sgmcmc_tpu_torch.engine import make_mcmc_chunk

    bundle, fixed, moving, opt_gmm, opt_reg = _problem(DIMS, dev)
    print(f"slice: {DIMS} x {CHAINS} chains, no_taylor "
          f"{bundle.transformation.no_taylor}, compositions "
          f"{bundle.transformation.no_compositions}", flush=True)
    state = _init(bundle, opt_gmm, opt_reg, dev)
    warm = make_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-5, fixed, moving,
                           chunk=1, burn_in=0, thin=1)
    timed = make_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-5, fixed, moving,
                            chunk=TIMED, burn_in=0, thin=1)
    state, _ = warm(state)
    state, metrics, seconds, launches, peak = _timed_run(timed, state, TIMED, "slice",
                                                         POST_PER_STEP)
    for name in ("data_term", "reg_term", "vd_alpha"):
        if not torch.isfinite(metrics[name]).all():
            raise AssertionError(f"slice: non-finite {name}: {metrics[name]}")
    if not torch.isfinite(state.v).all():
        raise AssertionError("slice: non-finite chain state")
    last = {k: metrics[k][-1].tolist() for k in
            ("data_term", "reg_term", "vd_alpha", "ndv", "sat", "sat_resid")}
    rate = CHAINS * TIMED / seconds
    print(f"slice: last transition {json.dumps(last)}", flush=True)
    print(f"slice: launches {json.dumps(launches)} over {TIMED} transitions",
          flush=True)
    print(f"slice: {rate:.3f} samples/sec ({CHAINS} chains x {TIMED} "
          f"transitions in {seconds:.3f} s), peak memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB)", flush=True)
    _profile(make_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-5, fixed, moving,
                             chunk=5, burn_in=0, thin=1), state, 5, "transitions")
    return launches, rate


def _field_dims(dims, cps):
    from ir_sgmcmc_tpu_torch.ops.bspline import control_grid_size

    return tuple(dims) if cps is None else control_grid_size(dims, (cps,) * 3)


def _reference_transition(device, cps=None, compute_dtype=None, anchor_mode=None,
                          **svf) -> dict:
    """One 64³ transition (tau 1e-5) on ``device`` from a fixed state and
    fixed noise, the GMM warm: ``σ²∇U`` read back from v_next (``q``), the
    ulp floor of v' / tau, the loss terms and the counters, on the CPU.
    ``anchor_mode``: anchored at ANCHOR_RADIUS, the chains anchored at the
    state; ``svf``: the integrator's options."""
    from ir_sgmcmc_tpu_torch.engine import make_sgld_transition
    from ir_sgmcmc_tpu_torch.engine.mcmc import make_chain_anchor
    from ir_sgmcmc_tpu_torch.models.sampler import langevin_noise

    tau = 1e-5
    rng = np.random.default_rng(7)
    eps = rng.standard_normal((CHAINS, 3) + _field_dims(SMALL, cps)).astype(np.float32)
    unif = rng.uniform(-0.1, 0.1, (CHAINS, 3) + SMALL).astype(np.float32)
    bundle, fixed, moving, opt_gmm, opt_reg = _problem(SMALL, device, cps=cps,
                                                       compute_dtype=compute_dtype, **svf)
    state = _init(bundle, opt_gmm, opt_reg, torch.device("cpu"))
    gmm = bundle.gmm.init_scales_from_residual_std(bundle.gmm.init_params("cpu"), 1.0)
    gmm["logits"] = torch.tensor([0.3, -0.2, 0.1, -0.4])
    state = _to(state._replace(gmm={k: t.expand(CHAINS, -1).clone()
                                    for k, t in gmm.items()}), device)
    eps, unif = (torch.as_tensor(a, device=device) for a in (eps, unif))
    tr = make_sgld_transition(bundle, opt_gmm, opt_reg, tau, fixed, moving,
                              anchor_radius=ANCHOR_RADIUS)
    anchor = (None if anchor_mode is None
              else make_chain_anchor(bundle, moving, anchor_mode)(state.v))
    new, met = tr(state, 1.0, noise=(eps, unif), anchor=anchor)
    v_noised = state.v + langevin_noise(None, state.sigma, tau, eps)
    return {"q": ((v_noised - new.v) / tau).cpu(),
            "floor": 8 * float(torch.finfo(torch.float32).eps * v_noised.abs().max()) / tau,
            "v_dtype": new.v.dtype,
            **{k: met[k].cpu() for k in ("data_term", "reg_term", "vd_alpha",
                                         "ndv", "sat", "sat_resid")}}


def phase_reference(dev, cps=None, anchor_mode=None, **svf) -> None:
    """One 64³ transition with fixed noise: card (kernels) vs CPU (plain);
    with ``cps``, of the SVFFD model (the state on its control grid); with
    ``anchor_mode``, anchored (phase 15(b)); ``svf``: the integrator's
    options (phase 15(c): ``taylor_compositions``).

    The GMM starts as the trainer's warm-up leaves it (spread scales,
    unequal logits): with all components identical the logits gradient is
    exactly zero and Adam would turn its rounding noise into a full step.
    Tolerances as in tests/test_torch_engine.py: loss terms 1e-4 relative;
    σ²∇U (read back from v_next) within 1e-3 RMS of its RMS above the
    ulp floor of v' / tau, and no element off by 2% of its maximum.
    """
    cpu, gpu = (_reference_transition(device, cps, anchor_mode=anchor_mode, **svf)
                for device in (torch.device("cpu"), dev))
    for k in ("ndv", "sat", "sat_resid"):
        if not torch.equal(cpu[k], gpu[k]):
            raise AssertionError(f"reference: {k} {gpu[k]} on the card, {cpu[k]} on the CPU")
    for k in ("data_term", "reg_term", "vd_alpha"):
        _err(gpu[k], cpu[k], 0.0, 1e-4, f"reference {k}")
    dq = gpu["q"] - cpu["q"]
    rms, rms_q = float(dq.pow(2).mean().sqrt()), float(cpu["q"].pow(2).mean().sqrt())
    if rms > cpu["floor"] / 8 + 1e-3 * rms_q:
        raise AssertionError(f"reference: RMS error of σ²∇U {rms:.3e} vs RMS {rms_q:.3e}")
    err = _err(gpu["q"], cpu["q"], cpu["floor"] + 2e-2 * float(cpu["q"].abs().max()),
               0.0, "reference σ²∇U")
    what = "" if cps is None else f" (SVFFD, cps {cps})"
    what += "" if anchor_mode is None else f" (anchored, {anchor_mode} mode)"
    what += "".join(f" ({k} {v})" for k, v in svf.items())
    print(f"reference: 64³ transition{what}, card vs CPU agree: loss terms within 1e-4, "
          f"σ²∇U RMS error {rms:.3e} (RMS {rms_q:.3e}), max abs err {err:.3e}",
          flush=True)


def _vi_problem(dims, device, scheme="pre", cps=None, compute_dtype=None, **svf):
    """``bench.py:measure_vi`` (on the "pre" scheme unless given; with
    ``cps``, the SVFFD model; ``compute_dtype`` and ``svf`` the
    integrator's): the bundle, images, the experiment-1 optimizers and the
    initial ``VIState``."""
    from ir_sgmcmc_tpu_torch.engine import VIState
    from ir_sgmcmc_tpu_torch.optim import adam_decay

    bundle, fixed, moving, _, opt_reg = _problem(dims, device, scheme, cps, compute_dtype,
                                                 **svf)
    opt_q_v = adam_decay({"mu": 0.01, "log_var": 0.01, "u": 0.01}, 1e-3)
    opt_gmm = adam_decay({"log_std": 0.2, "logits": 0.2}, 1e-3)
    q_v = bundle.init_q_v(0.5, 0.1, device)
    gmm, reg = bundle.gmm.init_params(device), bundle.reg_loss.init_params(device)
    state = VIState(q_v=q_v, gmm=gmm, reg=reg, opt_q_v=opt_q_v.init(q_v),
                    opt_gmm=opt_gmm.init(gmm), opt_reg=opt_reg.init(reg),
                    key=torch.tensor([0, 0]), step=0)
    return bundle, fixed, moving, (opt_q_v, opt_gmm, opt_reg), state


VI_PER_STEP = {"split_warp_fwd": 7, "split_warp_bwd": 0, "block_warp_fwd": 0,
               "block_warp_dgrad": 0, "warp_bounded_fwd": 9, "warp_bounded_dgrad": 8,
               "warp_bounded_tblend": 8, "split_warp_fwd_bf16": 0, "split_warp_bwd_bf16": 0,
               "warp_bounded_fwd_zhalo": 0, "warp_bounded_dgrad_zhalo": 0,
               "warp_bounded_tblend_zpad": 0}


def phase_vi(dev) -> dict:
    """GMM warm-up, 1 warm-up and TIMED VI steps at 128³ on "pre", then a
    profile of 5 more; returns the launch counts of the timed run."""
    from ir_sgmcmc_tpu_torch.engine import gmm_warmup, make_vi_chunk, make_vi_step

    bundle, fixed, moving, (oq, og, orr), state = _vi_problem(DIMS, dev)
    tr = bundle.transformation
    print(f"vi: {DIMS} 'pre', no_taylor {tr.no_taylor}, compositions "
          f"{tr.no_compositions}, image warps {tr.no_image_compositions}", flush=True)
    step = make_vi_step(bundle, oq, og, orr, fixed, moving)
    state = gmm_warmup(bundle, og, state, fixed, moving)
    state, _ = make_vi_chunk(step, 1)(state)
    state, metrics, seconds, launches, peak = _timed_run(
        make_vi_chunk(step, TIMED), state, TIMED, "vi", VI_PER_STEP)
    for name in ("data_term", "reg_term", "entropy_term", "total_loss", "vd_alpha"):
        if not torch.isfinite(metrics[name]).all():
            raise AssertionError(f"vi: non-finite {name}: {metrics[name]}")
    if not all(torch.isfinite(t).all() for t in state.q_v.values()):
        raise AssertionError("vi: non-finite q(v)")
    last = {k: metrics[k][-1].tolist() for k in
            ("data_term", "reg_term", "entropy_term", "total_loss", "vd_alpha", "ndv",
             "sat", "max_update_mu")}
    print(f"vi: last step {json.dumps(last)}", flush=True)
    print(f"vi: launches {json.dumps(launches)} over {TIMED} steps", flush=True)
    print(f"vi: {TIMED / seconds:.3f} iters/sec ({TIMED} steps in {seconds:.3f} s), "
          f"peak memory {peak} bytes ({peak / 2**30:.3f} GiB)", flush=True)
    _profile(make_vi_chunk(step, 5), state, 5, "VI steps")
    return launches


def _sat_resid_at(bundle, fixed, moving, v, radius: int, seed: int) -> list:
    """The block-residual overflow count per chain of the fields ``v`` at
    block radius ``radius`` (one forward chain, fresh uniform noise)."""
    import dataclasses

    from ir_sgmcmc_tpu_torch.engine import forward_sample
    from ir_sgmcmc_tpu_torch.models.sampler import uniform_voxel_noise

    gen = torch.Generator(device=v.device).manual_seed(seed)
    unif = uniform_voxel_noise(gen, (v.shape[0], 3) + tuple(bundle.dims),
                               float(bundle.uniform_noise_alpha), v.device)
    with torch.no_grad():
        out = forward_sample(dataclasses.replace(bundle, block_radius=radius), fixed, moving,
                             v, unif)
    return out["sat_resid"].tolist()


def phase_svffd(dev) -> dict:
    """The SVFFD model of experiment 5 at 128³ (cps 2: a 67³ control grid;
    block radius 3) on "post": 1 warm-up and TIMED transitions over 2
    chains, GMM warm-up then 1 warm-up and TIMED VI steps, each with the
    launch counts asserted (B1 7, B2 7, B3 1, B4 1, B5-B7 0 per step), a
    profile of 5 more transitions, and the block-residual overflow of the
    same states at radius 2.  Returns the launch counts of both timed runs."""
    from ir_sgmcmc_tpu_torch.engine import (gmm_warmup, make_mcmc_chunk, make_vi_chunk,
                                            make_vi_step)
    from ir_sgmcmc_tpu_torch.engine.vi import _draws, key_generator
    from ir_sgmcmc_tpu_torch.models.sampler import sample_q_v

    bundle, fixed, moving, opt_gmm, opt_reg = _problem(DIMS, dev, cps=SVFFD_CPS)
    print(f"svffd: {DIMS} cps {SVFFD_CPS}, control grid {bundle.field_dims}, block radius "
          f"{bundle.block_radius}, 'post'", flush=True)
    state = _init(bundle, opt_gmm, opt_reg, dev)
    state, _ = make_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-5, fixed, moving,
                               chunk=1, burn_in=0, thin=1)(state)
    timed = make_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-5, fixed, moving,
                            chunk=TIMED, burn_in=0, thin=1)
    state, metrics, seconds, mcmc_launches, peak = _timed_run(
        timed, state, TIMED, "svffd mcmc", POST_PER_STEP)
    for name in ("data_term", "reg_term", "vd_alpha"):
        if not torch.isfinite(metrics[name]).all():
            raise AssertionError(f"svffd mcmc: non-finite {name}: {metrics[name]}")
    if not torch.isfinite(state.v).all():
        raise AssertionError("svffd mcmc: non-finite chain state")
    last = {k: metrics[k][-1].tolist() for k in
            ("data_term", "reg_term", "vd_alpha", "ndv", "sat", "sat_resid")}
    print(f"svffd mcmc: last transition {json.dumps(last)}; sat_resid at radius 2 "
          f"{_sat_resid_at(bundle, fixed, moving, state.v, 2, 1)}", flush=True)
    print(f"svffd mcmc: launches {json.dumps(mcmc_launches)} over {TIMED} transitions",
          flush=True)
    print(f"svffd mcmc: {CHAINS * TIMED / seconds:.3f} samples/sec ({CHAINS} chains x "
          f"{TIMED} transitions in {seconds:.3f} s), peak memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB)", flush=True)
    _profile(make_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-5, fixed, moving,
                             chunk=5, burn_in=0, thin=1), state, 5, "SVFFD transitions")

    bundle, fixed, moving, (oq, og, orr), vstate = _vi_problem(DIMS, dev, "post", SVFFD_CPS)
    step = make_vi_step(bundle, oq, og, orr, fixed, moving)
    vstate = gmm_warmup(bundle, og, vstate, fixed, moving)
    vstate, _ = make_vi_chunk(step, 1)(vstate)
    vstate, metrics, seconds, vi_launches, peak = _timed_run(
        make_vi_chunk(step, TIMED), vstate, TIMED, "svffd vi", POST_PER_STEP)
    for name in ("data_term", "reg_term", "entropy_term", "total_loss", "vd_alpha"):
        if not torch.isfinite(metrics[name]).all():
            raise AssertionError(f"svffd vi: non-finite {name}: {metrics[name]}")
    if not all(torch.isfinite(t).all() for t in vstate.q_v.values()):
        raise AssertionError("svffd vi: non-finite q(v)")
    eps, x, _ = _draws(bundle, vstate.q_v, key_generator(vstate.key, vstate.step, dev), 2)
    pair = torch.stack(sample_q_v(None, vstate.q_v, antithetic=True, eps=eps, x=x))
    last = {k: metrics[k][-1].tolist() for k in
            ("data_term", "reg_term", "entropy_term", "total_loss", "vd_alpha", "ndv",
             "sat", "sat_resid")}
    print(f"svffd vi: last step {json.dumps(last)}; sat_resid of the next antithetic "
          f"pair at radius 2 {_sat_resid_at(bundle, fixed, moving, pair, 2, 2)}, at "
          f"radius 3 {_sat_resid_at(bundle, fixed, moving, pair, 3, 2)}", flush=True)
    print(f"svffd vi: launches {json.dumps(vi_launches)} over {TIMED} steps", flush=True)
    print(f"svffd vi: {TIMED / seconds:.3f} iters/sec ({TIMED} steps in {seconds:.3f} s), "
          f"peak memory {peak} bytes ({peak / 2**30:.3f} GiB)", flush=True)
    return {"svffd_mcmc": mcmc_launches, "svffd_vi": vi_launches}


def _profile(run, state, steps: int, what: str) -> dict:
    """Device kernel time per step by kind over one run of ``steps`` steps:
    the device events of the run's Chrome trace, grouped as
    ``scripts/trace_summary.py`` groups them; returns the groups."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from ir_sgmcmc_tpu_torch.scripts import trace_summary

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(state)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(str(Path(tmp) / "trace.json"))
        kinds = trace_summary.group(trace_summary.load_events(Path(tmp) / "trace.json"))
    if not kinds:
        raise AssertionError(f"profile of {what}: no device events in the trace")
    for line in trace_summary.kind_lines(kinds, steps, what):
        print(f"profile: {line}", flush=True)
    return kinds


def phase_vi_reference(dev, cps=None, **svf) -> None:
    """One 64³ VI step with fixed draws: card (kernels) vs CPU (plain); on
    "pre", or with ``cps`` of the SVFFD model on "post" (the B3/B4 path);
    ``svf``: the integrator's options (phase 15(c)).

    The GMM starts warm (spread scales, unequal logits), as in phase 4.
    Tolerances as in tests/test_torch_vi.py: loss terms 1e-4 relative,
    counters equal; the q(v) gradient (Adam's first moment / 0.1) within
    1e-3 RMS of its RMS and 2% of its maximum elementwise, plus, for SVFFD,
    twice the distance of the CPU's float32 gradient from its float64
    evaluation (RMS and maximum).  That floor is float32's own error on
    this input: the warp's slope jumps where a sample point crosses a cell
    face, and a point within rounding of a face lands on either side in
    two float32 evaluations.
    """
    from ir_sgmcmc_tpu_torch.engine import make_vi_step

    rng = np.random.default_rng(11)
    eps_np = rng.standard_normal((3,) + _field_dims(SMALL, cps)).astype(np.float32)
    x_np = np.float32(rng.standard_normal())
    unif_np = rng.uniform(-0.1, 0.1, (2, 3) + SMALL).astype(np.float32)
    scheme = "pre" if cps is None else "post"
    cpu = torch.device("cpu")
    runs = [("cpu", cpu, torch.float32), ("cuda", dev, torch.float32)]
    if cps is not None:
        runs.append(("cpu64", cpu, torch.float64))
    results = {}
    for name, device, dtype in runs:
        bundle, fixed, moving, (oq, og, orr), state = _vi_problem(SMALL, device, scheme, cps,
                                                                  **svf)
        gmm = bundle.gmm.init_scales_from_residual_std(bundle.gmm.init_params("cpu"), 1.0)
        gmm["logits"] = torch.tensor([0.3, -0.2, 0.1, -0.4])
        state = _to(state._replace(gmm=gmm), device, dtype)
        fixed, moving = _to_tree(fixed, device, dtype), _to_tree(moving, device, dtype)
        noise = tuple(torch.as_tensor(a, device=device, dtype=dtype)
                      for a in (eps_np, x_np, unif_np))
        new, met = make_vi_step(bundle, oq, og, orr, fixed, moving)(state, noise=noise)
        results[name] = {
            "g": {k: (new.opt_q_v.mu[k] / 0.1).cpu().double() for k in new.opt_q_v.mu},
            **{k: met[k].cpu() for k in ("data_term", "reg_term", "entropy_term",
                                         "total_loss", "vd_alpha", "ndv", "sat")}}
    cpu, gpu = results["cpu"], results["cuda"]
    for k in ("ndv", "sat"):
        if not torch.equal(cpu[k], gpu[k]):
            raise AssertionError(f"vi reference: {k} {gpu[k]} on the card, {cpu[k]} on the CPU")
    for k in ("data_term", "reg_term", "entropy_term", "total_loss", "vd_alpha"):
        _err(gpu[k], cpu[k], 0.0, 1e-4, f"vi reference {k}")
    worst, floors = 0.0, {}
    for k, ref in cpu["g"].items():
        f32 = ref - results["cpu64"]["g"][k] if "cpu64" in results else torch.zeros_like(ref)
        floor_rms, floor_max = float(f32.pow(2).mean().sqrt()), float(f32.abs().max())
        d = gpu["g"][k] - ref
        rms, rms_ref = float(d.pow(2).mean().sqrt()), float(ref.pow(2).mean().sqrt())
        if rms > 1e-3 * rms_ref + 2 * floor_rms:
            raise AssertionError(f"vi reference: RMS error of the {k} gradient {rms:.3e} "
                                 f"vs RMS {rms_ref:.3e} (float32 floor {floor_rms:.3e})")
        _err(gpu["g"][k], ref, 2e-2 * float(ref.abs().max()) + 2 * floor_max, 0.0,
             f"vi reference grad {k}")
        worst = max(worst, rms / rms_ref)
        floors[k] = (floor_rms / rms_ref, floor_max / float(ref.abs().max()))
    what = "" if cps is None else f" (SVFFD, cps {cps}, 'post')"
    what += "".join(f" ({k} {v})" for k, v in svf.items())
    floor = "" if cps is None else (
        "; float32 vs float64 on the CPU (RMS, max, relative): "
        + ", ".join(f"{k} {r:.3e} {m:.3e}" for k, (r, m) in floors.items()))
    print(f"vi reference: 64³ VI step{what}, card vs CPU agree: loss terms within 1e-4, "
          f"q(v) gradient RMS error at most {worst:.3e} of its RMS{floor}", flush=True)


def phase_vi_remat(dev) -> None:
    """One 64³ SVFFD VI step with ``remat=True`` (the antithetic chains in
    turn under ``torch.utils.checkpoint``) against the batched step on the
    card, from the same state and draws.  The recompute relaunches B1-B4,
    whose outputs depend only on their inputs, so both steps sum the same
    terms, though a chain's reductions over the voxels may take another
    order at batch 1 than at batch 2: loss terms within 1e-5 relative,
    counters equal, the q(v) gradient within 1e-4 RMS of its RMS.  Prints
    each step's peak memory."""
    from ir_sgmcmc_tpu_torch.engine import make_vi_step

    rng = np.random.default_rng(13)
    noise = tuple(torch.as_tensor(a, device=dev) for a in (
        rng.standard_normal((3,) + _field_dims(SMALL, SVFFD_CPS)).astype(np.float32),
        np.float32(rng.standard_normal()),
        rng.uniform(-0.1, 0.1, (2, 3) + SMALL).astype(np.float32)))
    bundle, fixed, moving, (oq, og, orr), state = _vi_problem(SMALL, dev, "post", SVFFD_CPS)
    gmm = bundle.gmm.init_scales_from_residual_std(bundle.gmm.init_params("cpu"), 1.0)
    gmm["logits"] = torch.tensor([0.3, -0.2, 0.1, -0.4])
    state = _to(state._replace(gmm=gmm), dev)
    out = {}
    for remat in (False, True):
        step = make_vi_step(bundle, oq, og, orr, fixed, moving, remat=remat)
        step(state, noise=noise)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        new, met = step(state, noise=noise)
        torch.cuda.synchronize()
        out[remat] = (new, met, torch.cuda.max_memory_allocated())
    (nb, mb, pb), (nr, mr, pr) = out[False], out[True]
    for k in ("ndv", "sat", "sat_resid"):
        if not torch.equal(mb[k], mr[k]):
            raise AssertionError(f"vi remat: {k} {mr[k]} against the batched {mb[k]}")
    for k in ("data_term", "reg_term", "entropy_term", "total_loss", "vd_alpha"):
        _err(mr[k], mb[k], 0.0, 1e-5, f"vi remat {k}")
    worst = 0.0
    for k, ref in nb.opt_q_v.mu.items():
        d = nr.opt_q_v.mu[k] - ref
        rel = float(d.pow(2).mean().sqrt()) / float(ref.pow(2).mean().sqrt())
        if rel > 1e-4:
            raise AssertionError(f"vi remat: RMS error of the {k} gradient {rel:.3e} of its RMS")
        worst = max(worst, rel)
    print(f"vi remat: 64³ SVFFD VI step, remat equals the batched step on the card "
          f"(loss terms within 1e-5, q(v) gradient RMS error at most {worst:.3e} of its "
          f"RMS); peak memory batched {pb} bytes ({pb / 2**30:.3f} GiB), remat {pr} "
          f"bytes ({pr / 2**30:.3f} GiB)", flush=True)


TRAINER_OVERRIDES = (
    "data_loader;args;dims=[128,128,128]",
    "trainer;no_iters_VI=20", "trainer;log_period_VI=10", "trainer;no_samples_VI_test=4",
    "trainer;speed_test_iters=10", "trainer;no_chains=2", "trainer;no_iters_burn_in=10",
    "trainer;no_samples_MCMC=20", "trainer;log_period_MCMC=10",
)
TRAINER_ARTIFACTS = ("images/im_fixed.nii.gz", "fields/VI_displacement_mean.vtk",
                     "fields/MCMC_displacement_std_dev.vtk", "models/vi_latest.npz",
                     "models/mcmc_latest.npz", "samples/VI/sample_*_im_warped.nii.gz",
                     "samples/MCMC/chain_*_im_warped.nii.gz")
# each pair's tree in a pair-parallel run: no checkpoints (one pair-stacked
# file, in pair 0's tree)
PAIR_ARTIFACTS = TRAINER_ARTIFACTS[:3] + TRAINER_ARTIFACTS[5:]


SVFFD_OVERRIDES = ('data_loader;type="SyntheticDataLoader"',
                   f'trainer;block_warp={{"radius": {SVFFD_RADIUS}}}',
                   "trainer;tensorboard=false")


@contextlib.contextmanager
def _cli_run(tag: str, config: str, extra, phase_methods: dict, argv_extra=(),
             not_launched=NOT_ON_F32_RUNS, judge: bool = True):
    """The port's CLI in-process on ``config`` at 128³ (``TRAINER_OVERRIDES``
    and ``extra``; ``argv_extra``: more CLI arguments, such as
    ``--devices``), in a temporary save directory that lives as long as the
    ``with`` block.  Each trainer method of ``phase_methods`` (``{phase:
    name}``; ``"warm-up"`` is the engine's ``gmm_warmup``) is timed (with a
    device sync at its ends) and its launches counted by a wrapper that is
    removed after.  Every counter is set to 0 just before the run and read
    just after: the kernels of ``not_launched`` must read 0, every other
    kernel more.  ``judge``: no summary may report an MCMC abort, and every
    Dice must be no worse than ``dsc_before`` less 0.05 (off: the caller
    judges).  Yields ``{"summaries", "trainer", "wall_s", "launches",
    "phases", "peak_bytes", "run_dir"}``."""
    import tempfile

    from ir_sgmcmc_tpu_torch import run
    from ir_sgmcmc_tpu_torch import trainer as tr
    from ir_sgmcmc_tpu_torch.kernels import all_kernels

    kernels = all_kernels()
    phases, seen = {}, []

    def counts():
        return {k.symbol: k.launches for k in kernels}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            c0, t0 = counts(), time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                p = phases.setdefault(name, {"s": 0.0, "launches": dict.fromkeys(c0, 0),
                                             "peak_bytes": 0})
                p["s"] += time.perf_counter() - t0
                # the pair path resets the peak counter to size its batches
                p["peak_bytes"] = max(p["peak_bytes"], torch.cuda.max_memory_allocated())
                for sym, n in counts().items():
                    p["launches"][sym] += n - c0[sym]
        return wrapper

    def keep(fn):
        def wrapper(self, *args, **kwargs):
            seen.append(self)
            return fn(self, *args, **kwargs)
        return wrapper

    patches = [(tr, "gmm_warmup", timed("warm-up", tr.gmm_warmup)),
               (tr.Trainer, "run", keep(tr.Trainer.run))]
    patches += [(tr.Trainer, method, timed(name, getattr(tr.Trainer, method)))
                for name, method in phase_methods.items()]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["-c", str(root / config), "--run-id", "smoke",
                "-o", f"trainer;save_dir={json.dumps(tmp)}", *argv_extra]
        for o in TRAINER_OVERRIDES + tuple(extra):
            argv += ["-o", o]
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            summaries = run.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = counts()
        finally:
            for obj, name, fn in saved:
                setattr(obj, name, fn)
        t = seen[0]
        for s in summaries if judge else ():
            if "mcmc_aborted" in s:
                raise AssertionError(f"{tag}: MCMC aborted: {s['mcmc_aborted']}")
            for key in ("vi_test_mean_dsc", "mcmc_mean_dsc"):
                if not (math.isfinite(s[key]) and s[key] >= s["dsc_before"] - 0.05):
                    raise AssertionError(f"{tag}: pair {s['pair']} {key} {s[key]} against "
                                         f"dsc_before {s['dsc_before']} (bar: 0.05 below it)")
        bad = [sym for sym, n in launches.items() if (n == 0) != (sym in not_launched)]
        if bad:
            raise AssertionError(f"{tag}: launches {launches}: the kernels of {not_launched} "
                                 f"must not run, every other must ({bad})")
        peak = max([torch.cuda.max_memory_allocated()]
                   + [p["peak_bytes"] for p in phases.values()])
        yield {"summaries": summaries, "trainer": t, "wall_s": wall, "launches": launches,
               "phases": phases, "peak_bytes": peak,
               "run_dir": Path(tmp) / t.config.name / "smoke"}


def _check_on_card(tag: str, name: str, x, grid) -> None:
    if not (x.is_cuda and bool(torch.isfinite(x).all()) and tuple(x.shape[-3:]) == tuple(grid)):
        raise AssertionError(f"{tag}: checkpoint {name} {tuple(x.shape)} not finite on the "
                             f"card on the grid {tuple(grid)}")


def phase_trainer(dev, extra=(), config="configs/demo/config_synthetic.json",
                  tag="trainer") -> dict:
    """A config (the demo one unless given) through the port's CLI at 128³
    (``extra``: more overrides), with its phases timed (``_cli_run``): no
    abort, finite Dice no worse than ``dsc_before`` less 0.05, the
    end-to-end test's artifacts, and both checkpoints loaded back on the
    card.  Returns the record it prints on a line that starts with ``tag``,
    with the launch counts of the whole run."""
    from ir_sgmcmc_tpu_torch.engine import init_chains
    from ir_sgmcmc_tpu_torch.utils.checkpoint import load_checkpoint

    methods = {"VI": "_run_vi_phase", "VI test": "_test_vi", "MCMC": "_run_mcmc_phase"}
    with _cli_run(tag, config, extra, methods) as r:
        s, t, run_dir = r["summaries"][0], r["trainer"], r["run_dir"]
        missing = [a for a in TRAINER_ARTIFACTS if not list(run_dir.glob(a))]
        if missing:
            raise AssertionError(f"{tag}: artifacts missing under {run_dir}: {missing}")

        # both checkpoints back into the port's states on the card
        b, q_v0 = t.bundle, t.dataset[0][2]
        vi, vi_meta = load_checkpoint(run_dir / "models/vi_latest.npz",
                                      t._initial_state(q_v0, 0))
        gen = torch.Generator(device=dev).manual_seed(0)
        chains = init_chains(b, gen, t.no_chains, "identity", None, b.gmm.init_params(dev),
                             b.reg_loss.init_params(dev), t.opt_gmm, t.opt_reg, device=dev)
        mc, mc_meta = load_checkpoint(run_dir / "models/mcmc_latest.npz", chains)
        if vi_meta.get("vi_iters") != 20 or mc_meta.get("mcmc_steps") != 30:
            raise AssertionError(f"{tag}: checkpoint meta {vi_meta}, {mc_meta}")
        # the state on the model's grid (SVFFD: the control grid), the
        # posterior accumulators on the image grid
        for name, x, grid in (("q_v mu", vi.q_v["mu"], b.field_dims),
                              ("chain v", mc.v, b.field_dims),
                              ("welford mean", mc.welford.mean, b.dims)):
            _check_on_card(tag, name, x, grid)
        if vi.step != 20 or mc.step != 30:
            raise AssertionError(f"{tag}: checkpoint steps {vi.step}, {mc.step}")

    phases = r["phases"]
    record = {
        "summary": s, "wall_s": r["wall_s"],
        "phase_s": {name: p["s"] for name, p in phases.items()},
        "phase_launches": {name: p["launches"] for name, p in phases.items()},
        "launches": r["launches"],
        "vi_iters_per_sec_in_phase": 20 / phases["VI"]["s"],
        "mcmc_samples_per_sec_in_phase": t.no_chains * 30 / s["mcmc_time_s"],
        "peak_bytes": r["peak_bytes"],
    }
    print(f"{tag}: {json.dumps(record, default=float)}", flush=True)
    return record


# ---- phase 9: pair-parallel registration -------------------------------------------

PAIRS = 4
# distinct pairs: each its own offset and texture seed
PAIR_OFFSETS = ((0.0, 0.0, 4.0), (0.0, 4.0, 0.0), (4.0, 0.0, 0.0), (0.0, 3.0, 3.0))


def _pair_images(dims, device, n: int):
    """``n`` distinct sphere pairs: the per-pair ``(fixed, moving)`` dicts and
    the pair-stacked ``fixed``, ``moving``."""
    from ir_sgmcmc_tpu_torch.data import sphere_pair
    from ir_sgmcmc_tpu_torch.engine.pairs import stack_trees

    images = []
    for i, off in enumerate(PAIR_OFFSETS[:n]):
        fixed, moving = sphere_pair(dims, offset=off, seed=i)
        images.append(tuple({k: torch.as_tensor(v, device=device) for k, v in d.items()}
                            for d in (fixed, moving)))
    return images, stack_trees([f for f, _ in images]), stack_trees([m for _, m in images])


def _warm_gmm(bundle, i: int) -> dict:
    """A GMM as the trainer's warm-up leaves it (spread scales, unequal
    logits), a little different for each pair."""
    gmm = bundle.gmm.init_scales_from_residual_std(bundle.gmm.init_params("cpu"), 1.0 + 0.1 * i)
    gmm["logits"] = torch.tensor([0.3, -0.2, 0.1, -0.4]) * (1 + 0.5 * i)
    return gmm


def phase_pairs(dev, single_rate: float) -> dict:
    """9(a): 1 warm-up and TIMED pair-stacked transitions at 128³, PAIRS
    pairs x 2 chains ("post"), then the pair-stacked VI step on "post"
    (GMM warm-up per pair, 1 warm-up and TIMED steps) beside a single
    pair's VI steps on the same problem; each with B1 7, B2 7, B3 1, B4 1
    launches per step asserted, the aggregate rate, the peak memory and a
    profile of 5 more steps.  Returns the launch counts of both pair runs."""
    from ir_sgmcmc_tpu_torch.engine import gmm_warmup, make_vi_chunk, make_vi_step
    from ir_sgmcmc_tpu_torch.engine.pairs import (make_pair_mcmc_chunk, make_pair_vi_chunk,
                                                  stack_trees)

    bundle, _, _, opt_gmm, opt_reg = _problem(DIMS, dev)
    images, fixed_st, moving_st = _pair_images(DIMS, dev, PAIRS)
    print(f"pairs: {PAIRS} pairs x {CHAINS} chains at {DIMS}, 'post', offsets "
          f"{list(PAIR_OFFSETS[:PAIRS])}", flush=True)

    def chunk(n):
        return make_pair_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-5, fixed_st, moving_st,
                                    chunk=n, burn_in=0, thin=1)

    state = stack_trees([_init(bundle, opt_gmm, opt_reg, dev, seed=i) for i in range(PAIRS)])
    state, _ = chunk(1)(state)
    state, metrics, seconds, mcmc_launches, peak = _timed_run(
        chunk(TIMED), state, TIMED, "pairs mcmc", POST_PER_STEP)
    for name in ("data_term", "reg_term", "vd_alpha"):
        if not (metrics[name].shape[:3] == (PAIRS, TIMED, CHAINS)
                and torch.isfinite(metrics[name]).all()):
            raise AssertionError(f"pairs mcmc: {name} {tuple(metrics[name].shape)} not "
                                 f"finite (P, chunk, C)")
    if not torch.isfinite(state.v).all():
        raise AssertionError("pairs mcmc: non-finite chain state")
    rate = PAIRS * CHAINS * TIMED / seconds
    print(f"pairs mcmc: launches {json.dumps(mcmc_launches)} over {TIMED} transitions",
          flush=True)
    print(f"pairs mcmc: {rate:.3f} aggregate samples/sec ({PAIRS} pairs x {CHAINS} chains x "
          f"{TIMED} transitions in {seconds:.3f} s) against phase 3's single pair "
          f"{single_rate:.3f} samples/sec ({rate / single_rate:.3f}x); peak memory {peak} "
          f"bytes ({peak / 2**30:.3f} GiB)", flush=True)
    _profile(chunk(5), state, 5, "pair-stacked transitions")
    del state

    bundle, _, _, (oq, og, orr), vstate = _vi_problem(DIMS, dev, "post")
    states = [gmm_warmup(bundle, og, vstate._replace(key=torch.tensor([0, i])), f, m)
              for i, (f, m) in enumerate(images)]
    step0 = make_vi_step(bundle, oq, og, orr, *images[0])
    s0, _ = make_vi_chunk(step0, 1)(states[0])
    _, _, single_s, _, single_peak = _timed_run(make_vi_chunk(step0, TIMED), s0, TIMED,
                                                "pairs vi (one pair)", POST_PER_STEP)

    def vchunk(n):
        return make_pair_vi_chunk(bundle, oq, og, orr, fixed_st, moving_st, n)

    vstate, _ = vchunk(1)(stack_trees(states))
    vstate, metrics, seconds, vi_launches, peak = _timed_run(
        vchunk(TIMED), vstate, TIMED, "pairs vi", POST_PER_STEP)
    for name in ("data_term", "reg_term", "entropy_term", "total_loss", "vd_alpha"):
        if not (metrics[name].shape[:2] == (PAIRS, TIMED)
                and torch.isfinite(metrics[name]).all()):
            raise AssertionError(f"pairs vi: {name} {tuple(metrics[name].shape)} not finite "
                                 f"(P, chunk)")
    print(f"pairs vi: launches {json.dumps(vi_launches)} over {TIMED} steps", flush=True)
    print(f"pairs vi: {PAIRS * TIMED / seconds:.3f} aggregate iters/sec ({PAIRS} pairs x "
          f"{TIMED} steps in {seconds:.3f} s), peak memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB); one pair alone {TIMED / single_s:.3f} iters/sec, peak "
          f"{single_peak} bytes ({single_peak / 2**30:.3f} GiB)", flush=True)
    _profile(vchunk(5), vstate, 5, "pair-stacked VI steps")
    return {"pairs_mcmc": mcmc_launches, "pairs_vi": vi_launches}


def phase_pairs_reference(dev) -> None:
    """9(b): at 64³ with 2 pairs, each pair's rows of one pair-stacked
    transition and one pair-stacked VI step equal that pair's single-pair
    run on the card, from the same states and keys: counters equal, loss
    terms within 1e-4 relative, σ²∇U within phase 4's bounds and the q(v)
    gradient within phase 6's.  Both as one batch of the 2 pairs and in
    batches of 1 pair in turn (the trainer's schedule when the card holds
    fewer pairs than the study has)."""
    from ir_sgmcmc_tpu_torch.engine import make_mcmc_chunk, make_vi_chunk, make_vi_step
    from ir_sgmcmc_tpu_torch.engine.mcmc import _chain_noise
    from ir_sgmcmc_tpu_torch.engine.pairs import (make_pair_mcmc_chunk, make_pair_vi_chunk,
                                                  stack_trees, unstack_tree)
    from ir_sgmcmc_tpu_torch.models.sampler import langevin_noise

    tau, n = 1e-5, 2
    bundle, _, _, opt_gmm, opt_reg = _problem(SMALL, dev)
    images, fixed_st, moving_st = _pair_images(SMALL, dev, n)
    states = []
    for i in range(n):
        s = _init(bundle, opt_gmm, opt_reg, dev, seed=i)
        gmm = {k: t.to(dev).expand(CHAINS, -1).clone() for k, t in _warm_gmm(bundle, i).items()}
        states.append(s._replace(gmm=gmm))
    runs = [(group, *make_pair_mcmc_chunk(bundle, opt_gmm, opt_reg, tau, fixed_st, moving_st, 1,
                                          0, 1, group=group)(stack_trees(states)))
            for group in (None, 1)]
    worst = 0.0
    for (group, pair, pm), (i, (f, m)) in itertools.product(runs, enumerate(images)):
        ref, rm = make_mcmc_chunk(bundle, opt_gmm, opt_reg, tau, f, m, 1, 0, 1)(states[i])
        got = unstack_tree(pair, i)
        who = f"{i} (batches of {group or n})"
        for k in ("ndv", "sat", "sat_resid"):
            if not torch.equal(pm[k][i], rm[k]):
                raise AssertionError(f"pairs reference: pair {who} {k} {pm[k][i]} vs {rm[k]}")
        for k in ("data_term", "reg_term", "vd_alpha"):
            _err(pm[k][i], rm[k], 0.0, 1e-4, f"pairs reference pair {who} {k}")
        eps, _ = _chain_noise(states[i], bundle.uniform_noise_alpha, bundle.dims)
        v_noised = states[i].v + langevin_noise(None, states[i].sigma, tau, eps)
        q = (v_noised - ref.v) / tau
        floor = 8 * float(torch.finfo(torch.float32).eps * v_noised.abs().max()) / tau
        dq = (got.v - ref.v) / tau
        rms, rms_q = float(dq.pow(2).mean().sqrt()), float(q.pow(2).mean().sqrt())
        if rms > floor / 8 + 1e-3 * rms_q:
            raise AssertionError(f"pairs reference: pair {who} σ²∇U RMS error {rms:.3e} "
                                 f"(RMS {rms_q:.3e})")
        _err(got.v / tau, ref.v / tau, floor + 2e-2 * float(q.abs().max()), 0.0,
             f"pairs reference pair {who} σ²∇U")
        worst = max(worst, rms / rms_q)

    bundle, _, _, (oq, og, orr), vstate = _vi_problem(SMALL, dev, "post")
    states = [vstate._replace(gmm={k: t.to(dev) for k, t in _warm_gmm(bundle, i).items()},
                              key=torch.tensor([3, i])) for i in range(n)]
    runs = [(group, *make_pair_vi_chunk(bundle, oq, og, orr, fixed_st, moving_st, 1,
                                        group=group)(stack_trees(states)))
            for group in (None, 1)]
    worst_vi = 0.0
    for (group, pair, pm), (i, (f, m)) in itertools.product(runs, enumerate(images)):
        ref, rm = make_vi_chunk(make_vi_step(bundle, oq, og, orr, f, m), 1)(states[i])
        got = unstack_tree(pair, i)
        who = f"{i} (batches of {group or n})"
        for k in ("ndv", "sat"):
            if not torch.equal(pm[k][i], rm[k]):
                raise AssertionError(f"pairs vi reference: pair {who} {k} {pm[k][i]} vs {rm[k]}")
        for k in ("data_term", "reg_term", "entropy_term", "total_loss", "vd_alpha"):
            _err(pm[k][i], rm[k], 0.0, 1e-4, f"pairs vi reference pair {who} {k}")
        for k, g_ref in ref.opt_q_v.mu.items():
            g_ref, g = g_ref / 0.1, got.opt_q_v.mu[k] / 0.1
            rms, rms_ref = float((g - g_ref).pow(2).mean().sqrt()), float(g_ref.pow(2).mean().sqrt())
            if rms > 1e-3 * rms_ref:
                raise AssertionError(f"pairs vi reference: pair {who} {k} gradient RMS error "
                                     f"{rms:.3e} (RMS {rms_ref:.3e})")
            _err(g, g_ref, 2e-2 * float(g_ref.abs().max()), 0.0,
                 f"pairs vi reference pair {who} grad {k}")
            worst_vi = max(worst_vi, rms / rms_ref)
    print(f"pairs reference: 64³, {n} pairs in one batch and in batches of 1: each pair's "
          f"rows of a pair-stacked transition and VI step equal its own run on the card "
          f"(loss terms within 1e-4, counters "
          f"equal; σ²∇U RMS error at most {worst:.3e} of its RMS, q(v) gradient "
          f"{worst_vi:.3e})", flush=True)


PAIRS_TRAINER_OVERRIDES = (f"data_loader;args;no_pairs={PAIRS}", "trainer;pair_parallel=true")


def phase_pairs_trainer(dev) -> dict:
    """9(c): the demo config through the CLI at 128³ with PAIRS pairs and
    ``pair_parallel: true``, phase 7's cuts: no abort, each pair's Dice no
    worse than its ``dsc_before`` less 0.05, each pair's artifact tree
    (``pair_<i>/`` beside pair 0's), and ``mcmc_latest.npz`` with meta
    ``pair_parallel`` PAIRS loaded back into pair-stacked states on the
    card.  Prints one ``pairs_trainer:`` line with the aggregate rates, each
    phase's wall time and launches, and the peak memory."""
    from ir_sgmcmc_tpu_torch.engine import init_chains
    from ir_sgmcmc_tpu_torch.engine.pairs import stack_trees
    from ir_sgmcmc_tpu_torch.utils.checkpoint import load_checkpoint

    tag = "pairs_trainer"
    methods = {"VI": "_run_pair_vi_phase", "VI test": "_test_vi",
               "MCMC": "_run_pair_mcmc_phase"}
    with _cli_run(tag, "configs/demo/config_synthetic.json", PAIRS_TRAINER_OVERRIDES,
                  methods) as r:
        summaries, t, run_dir = r["summaries"], r["trainer"], r["run_dir"]
        if len(summaries) != PAIRS:
            raise AssertionError(f"{tag}: {len(summaries)} summaries for {PAIRS} pairs")
        for i in range(PAIRS):
            tree = run_dir if i == 0 else run_dir / f"pair_{i}"
            missing = [a for a in PAIR_ARTIFACTS if not list(tree.glob(a))]
            if missing:
                raise AssertionError(f"{tag}: pair {i}: artifacts missing under {tree}: "
                                     f"{missing}")
        b = t.bundle
        gen = torch.Generator(device=dev).manual_seed(0)
        template = stack_trees([init_chains(
            b, gen, t.no_chains, "identity", None, b.gmm.init_params(dev),
            b.reg_loss.init_params(dev), t.opt_gmm, t.opt_reg, device=dev)
            for _ in range(PAIRS)])
        mc, meta = load_checkpoint(run_dir / "models/mcmc_latest.npz", template)
        if meta.get("pair_parallel") != PAIRS or meta.get("mcmc_steps") != 30:
            raise AssertionError(f"{tag}: checkpoint meta {meta}")
        if mc.step.tolist() != [30] * PAIRS or tuple(mc.v.shape[:2]) != (PAIRS, t.no_chains):
            raise AssertionError(f"{tag}: checkpoint steps {mc.step.tolist()}, chains "
                                 f"{tuple(mc.v.shape)}")
        for name, x, grid in (("chain v", mc.v, b.field_dims),
                              ("welford mean", mc.welford.mean, b.dims)):
            _check_on_card(tag, name, x, grid)

    phases = r["phases"]
    s0 = summaries[0]
    record = {
        "pairs": PAIRS, "wall_s": r["wall_s"],
        "dsc": [{k: s[k] for k in ("dsc_before", "vi_test_mean_dsc", "mcmc_mean_dsc")}
                for s in summaries],
        "vi_time_s": s0["vi_time_s"], "mcmc_time_s": s0["mcmc_time_s"],
        "vi_aggregate_iters_per_sec": PAIRS * 20 / s0["vi_time_s"],
        "mcmc_aggregate_samples_per_sec": s0["mcmc_aggregate_samples_per_sec"],
        "phase_s": {name: p["s"] for name, p in phases.items()},
        "phase_launches": {name: p["launches"] for name, p in phases.items()},
        "launches": r["launches"], "peak_bytes": r["peak_bytes"],
        "pairs_per_batch": t.pair_groups,
    }
    print(f"{tag}: {json.dumps(record, default=float)}", flush=True)
    return record


# ---- phase 10: the quality tools ---------------------------------------------------

QUALITY_ARGS = ("--dims", "128", "--magnitude", "6", "--vi-iters", "128", "--burn-in", "100",
                "--samples", "200", "--chains", "2", "--seed", "0")
QUALITY_BRAIN_ARGS = ("--dims", "64", "--magnitude", "4", "--vi-iters", "128", "--burn-in", "100",
                      "--samples", "200", "--chains", "2", "--seed", "0", "--phantom", "brain")


def phase_selftest(dev) -> None:
    """10(a): ``ir_sgmcmc_tpu_torch.selftest`` in-process: every kernel of
    ``all_kernels()`` in each of its variants against its plain version."""
    from ir_sgmcmc_tpu_torch import selftest

    t0 = time.perf_counter()
    result = selftest.run_selftest(dev, log=False)
    seconds = time.perf_counter() - t0
    if not result["ok"]:
        raise AssertionError(f"selftest failed: {json.dumps(result['checks'])}")
    worst = {}
    for name, err in result["checks"].items():
        sym = re.match(r"[a-z0-9_]+", name).group(0)
        worst[sym] = max(worst.get(sym, 0.0), err)
    print(f"selftest: {len(result['checks'])} checks passed in {seconds:.2f} s; worst max abs "
          f"err per kernel {json.dumps(worst)}", flush=True)


def phase_phantom(dev) -> None:
    """10(b): ``svf_pair`` at 64³ made on the card against the one made on
    the CPU: the moving volumes equal, the fixed image within 1e-5 abs, at
    most 0.01% of the seg voxels different (nearest-neighbour ties), and
    ``disp_gt`` within float32's resolution of the integration's sample
    points: each of its 12 ``grid_sample`` squarings samples at normalised
    coordinates, whose float32 spacing near ±1 is (n − 1)/2 · 2⁻²³ voxels,
    so two float32 evaluations may part by that much per squaring
    (12 · 31.5 · 2⁻²³ = 4.5e-5 voxels at 64³).  Both are also printed
    against a float64 integration of the same velocity on the CPU."""
    from ir_sgmcmc_tpu_torch.data import svf_pair
    from ir_sgmcmc_tpu_torch.data import synthetic
    from ir_sgmcmc_tpu_torch.models import SVF3D

    (f_gpu, m_gpu, d_gpu), (f_cpu, m_cpu, d_cpu) = (
        svf_pair(SMALL, magnitude=4.0, seed=0, device=d) for d in (dev, "cpu"))
    rng = np.random.default_rng(0)  # svf_pair's draws, replayed
    synthetic._textured_sphere(rng, SMALL, SMALL[0] / 4.0)
    v = torch.as_tensor(synthetic._smooth_velocity(rng, SMALL, 4.0), dtype=torch.float64)
    d64 = SVF3D(SMALL, no_steps=12, use_gather=True)(v[None])[1][0].numpy()
    for k in m_cpu:
        if not np.array_equal(m_gpu[k], m_cpu[k]):
            raise AssertionError(f"phantom: moving {k} differs between card and CPU")
    e_im = float(np.abs(f_gpu["im"] - f_cpu["im"]).max())
    e_disp = float(np.abs(d_gpu - d_cpu).max())
    disp_tol = 12 * (SMALL[0] - 1) / 2 * 2.0 ** -23
    seg = int((f_gpu["seg"] != f_cpu["seg"]).sum())
    if e_im > 1e-5 or e_disp > disp_tol or seg > 1e-4 * f_cpu["seg"].size:
        raise AssertionError(f"phantom: card vs CPU fixed im {e_im:.3e} (bound 1e-5), disp_gt "
                             f"{e_disp:.3e} (bound {disp_tol:.3e}), seg voxels differ {seg}")
    print(f"phantom: svf_pair {SMALL} on the card vs the CPU: fixed im max abs err {e_im:.3e}, "
          f"disp_gt {e_disp:.3e} (bound {disp_tol:.3e}; against float64 on the CPU: card "
          f"{float(np.abs(d_gpu - d64).max()):.3e}, CPU {float(np.abs(d_cpu - d64).max()):.3e}), "
          f"seg voxels differ {seg} of {f_cpu['seg'].size}", flush=True)


def phase_quality(dev, args, tag: str) -> dict:
    """10(c)/(d): the port's ``quality_eval`` in-process with ``args`` on the
    card, every counter set to 0 just before and read just after: no abort,
    Dice after MCMC above Dice before, relative displacement error below 1,
    finite calibration, B1-B5 launched (B6/B7 and the z-halo modes not);
    with ``--phantom brain`` 15 per-structure rows with finite Dice and a
    finite mean ASD.  Prints a ``tag:`` line with the report, the wall time
    and the launches; returns the launches."""
    import tempfile

    from ir_sgmcmc_tpu_torch.kernels import all_kernels
    from ir_sgmcmc_tpu_torch.scripts import quality_eval

    kernels = all_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # its report line: the tag line has it
            report = quality_eval.main(list(args) + ["--out-dir", tmp])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.symbol: k.launches for k in kernels}
    if report["aborted"] is not None:
        raise AssertionError(f"{tag}: MCMC aborted: {report['aborted']}")
    if not (report["dsc_mcmc"] > report["dsc_before"] and report["disp_err_rel"] < 1
            and math.isfinite(report["uncertainty_calibration_corr"])):
        raise AssertionError(f"{tag}: dsc_mcmc {report['dsc_mcmc']} (before "
                             f"{report['dsc_before']}), disp_err_rel {report['disp_err_rel']}, "
                             f"calibration {report['uncertainty_calibration_corr']}")
    bad = [sym for sym, n in launches.items() if (n == 0) != (sym in NOT_ON_F32_RUNS)]
    if bad:
        raise AssertionError(f"{tag}: launches {launches}: B1-B5 must run, B6/B7, the bf16 "
                             f"modes and the z-halo modes must not ({bad})")
    if "--phantom" in args:
        rows = report.get("per_structure", {})
        if len(rows) != 15 or not all(math.isfinite(r["dsc"]) for r in rows.values()) \
                or not math.isfinite(report["mean_asd"]):
            raise AssertionError(f"{tag}: per-structure rows {rows}, mean ASD "
                                 f"{report.get('mean_asd')}")
    print(f"{tag}: {json.dumps({'report': report, 'wall_s': wall, 'launches': launches})}",
          flush=True)
    return launches


# ---- phase 11: the bf16 integrator -----------------------------------------------

# launches per transition, and per VI step on "post", with compute_dtype bf16:
# the 7 split compositions forward and backward in their bf16 modes
BF16_PER_STEP = dict(POST_PER_STEP, split_warp_fwd=0, split_warp_bwd=0,
                     split_warp_fwd_bf16=7, split_warp_bwd_bf16=7)
BF16_U = 2.0 ** -8  # the unit roundoff of bf16


def phase_bf16_kernels(dev) -> list:
    """11(a): B1-bf16 and B2-bf16 against their plain versions (f32
    arithmetic, one rounding) on the selftest's ``SPLIT_SHAPES`` in bf16,
    timed at the main path's ``(2, 3, 128³)`` beside the plain versions and
    the bounds.  Tolerance: the f32 kernels' atol plus one bf16 ulp
    (``selftest.TOL``)."""
    rows = _split_rows(torch.Generator(device=dev).manual_seed(1235), torch.bfloat16)
    _print_rows(rows)
    return rows


def _idle_line(tag: str, kinds: dict, steps: int, wall_s_per_step: float) -> None:
    busy = sum(r["us"] for r in kinds.values()) / 1e3 / steps
    wall = 1e3 * wall_s_per_step
    print(f"{tag}: device busy {busy:.3f} ms (profiled) of {wall:.3f} ms of wall time per "
          f"step (timed run): idle share {1.0 - busy / wall:.3f}", flush=True)


def phase_bf16(dev, f32_rate: float) -> dict:
    """11(b)/(c): the main path with ``compute_dtype`` bf16: 1 warm-up and
    TIMED transitions at 128³ x 2 chains ("post"), the same for phase 8's
    SVFFD model (cps 2, block radius 3), then GMM warm-up, 1 warm-up and
    TIMED VI steps on "post" (beside the same VI steps in float32), each
    with B1-bf16 7, B2-bf16 7, B3 1, B4 1 and f32 B1/B2 0 launches per
    step asserted, float32 chain state and q(v), the rate beside
    float32's, the peak memory, and for the dense runs a profile of 5 more
    steps and the device's idle share.  Returns the launch counts of the
    three timed runs."""
    from ir_sgmcmc_tpu_torch.engine import (gmm_warmup, make_mcmc_chunk, make_vi_chunk,
                                            make_vi_step)

    bundle, fixed, moving, opt_gmm, opt_reg = _problem(DIMS, dev, compute_dtype="bfloat16")
    tr = bundle.transformation
    print(f"bf16: {DIMS} x {CHAINS} chains, 'post', compute_dtype {tr.compute_dtype}, no_taylor "
          f"{tr.no_taylor}, compositions {tr.no_compositions}", flush=True)

    def chunk(n):
        return make_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-5, fixed, moving, chunk=n,
                               burn_in=0, thin=1)

    state, _ = chunk(1)(_init(bundle, opt_gmm, opt_reg, dev))
    state, metrics, seconds, mcmc_launches, peak = _timed_run(chunk(TIMED), state, TIMED,
                                                              "bf16 mcmc", BF16_PER_STEP)
    for name in ("data_term", "reg_term", "vd_alpha"):
        if not torch.isfinite(metrics[name]).all():
            raise AssertionError(f"bf16 mcmc: non-finite {name}: {metrics[name]}")
    if state.v.dtype != torch.float32 or not torch.isfinite(state.v).all():
        raise AssertionError(f"bf16 mcmc: chain state {state.v.dtype}, finite "
                             f"{bool(torch.isfinite(state.v).all())}")
    rate = CHAINS * TIMED / seconds
    last = {k: metrics[k][-1].tolist() for k in
            ("data_term", "reg_term", "vd_alpha", "ndv", "sat", "sat_resid")}
    print(f"bf16 mcmc: last transition {json.dumps(last)}", flush=True)
    print(f"bf16 mcmc: launches {json.dumps(mcmc_launches)} over {TIMED} transitions",
          flush=True)
    print(f"bf16 mcmc: {rate:.3f} samples/sec ({CHAINS} chains x {TIMED} transitions in "
          f"{seconds:.3f} s) against phase 3's float32 {f32_rate:.3f} samples/sec "
          f"({rate / f32_rate:.3f}x); peak memory {peak} bytes ({peak / 2**30:.3f} GiB)",
          flush=True)
    kinds = _profile(chunk(5), state, 5, "bf16 transitions")
    _idle_line("bf16 mcmc", kinds, 5, seconds / TIMED)
    del state

    # the SVFFD model of phase 8 in bf16: the same launches per transition
    bundle, fixed, moving, opt_gmm, opt_reg = _problem(DIMS, dev, cps=SVFFD_CPS,
                                                       compute_dtype="bfloat16")
    svffd = make_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-5, fixed, moving, chunk=TIMED,
                            burn_in=0, thin=1)
    state, _ = make_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-5, fixed, moving, chunk=1,
                               burn_in=0, thin=1)(_init(bundle, opt_gmm, opt_reg, dev))
    state, metrics, seconds, svffd_launches, peak = _timed_run(svffd, state, TIMED,
                                                               "bf16 svffd mcmc", BF16_PER_STEP)
    if not (torch.isfinite(metrics["data_term"]).all() and torch.isfinite(state.v).all()):
        raise AssertionError("bf16 svffd mcmc: non-finite data term or chain state")
    print(f"bf16 svffd mcmc: cps {SVFFD_CPS}, launches {json.dumps(svffd_launches)} over "
          f"{TIMED} transitions; {CHAINS * TIMED / seconds:.3f} samples/sec, peak memory "
          f"{peak} bytes ({peak / 2**30:.3f} GiB)", flush=True)
    del state

    vi = {}
    for cd in (None, "bfloat16"):
        bundle, fixed, moving, (oq, og, orr), vstate = _vi_problem(DIMS, dev, "post",
                                                                   compute_dtype=cd)
        step = make_vi_step(bundle, oq, og, orr, fixed, moving)
        vstate = gmm_warmup(bundle, og, vstate, fixed, moving)
        vstate, _ = make_vi_chunk(step, 1)(vstate)
        what = "bf16 vi" if cd else "f32 vi (post)"
        vstate, metrics, seconds, launches, peak = _timed_run(
            make_vi_chunk(step, TIMED), vstate, TIMED, what,
            BF16_PER_STEP if cd else POST_PER_STEP)
        for name in ("data_term", "reg_term", "entropy_term", "total_loss", "vd_alpha"):
            if not torch.isfinite(metrics[name]).all():
                raise AssertionError(f"{what}: non-finite {name}: {metrics[name]}")
        if not all(t.dtype == torch.float32 and torch.isfinite(t).all()
                   for t in vstate.q_v.values()):
            raise AssertionError(f"{what}: q(v) not finite float32")
        vi[cd] = (TIMED / seconds, peak, launches, step, vstate, seconds)
    rate16, peak16, vi_launches, step, vstate, seconds = vi["bfloat16"]
    print(f"bf16 vi: launches {json.dumps(vi_launches)} over {TIMED} steps", flush=True)
    print(f"bf16 vi: {rate16:.3f} iters/sec against float32's {vi[None][0]:.3f} on the same "
          f"'post' problem ({rate16 / vi[None][0]:.3f}x); peak memory {peak16} bytes "
          f"({peak16 / 2**30:.3f} GiB), float32 {vi[None][1]} bytes "
          f"({vi[None][1] / 2**30:.3f} GiB)", flush=True)
    kinds = _profile(make_vi_chunk(step, 5), vstate, 5, "bf16 VI steps")
    _idle_line("bf16 vi", kinds, 5, seconds / TIMED)
    # the SVFFD path's name starts with "svffd": its B3/B4 launches are R 3's
    return {"bf16_mcmc": mcmc_launches, "bf16_vi": vi_launches,
            "svffd_bf16_mcmc": svffd_launches}


def phase_bf16_reference(dev) -> None:
    """11(d): one 64³ bf16 transition with fixed noise, card (B1/B2-bf16)
    against CPU (their plain versions), as phase 4.  The two round the
    compositions' f32 values once each, and differ only where an f32 value
    lands within its rounding error of a bf16 rounding boundary, one ulp
    there.  So: counters equal, loss terms within the unit roundoff u =
    2^-8 relative, and ``σ²∇U`` within a tenth of what bf16 itself moves
    it on the card (the bf16 transition against the float32 one, same
    state and noise): RMS error at most 0.1 of that drift's RMS above
    the ulp floor, and no element off by more than the floor plus 0.1 of
    the drift's maximum.  The chain state stays float32."""
    cpu16 = _reference_transition(torch.device("cpu"), compute_dtype="bfloat16")
    gpu16 = _reference_transition(dev, compute_dtype="bfloat16")
    gpu32 = _reference_transition(dev)
    if not cpu16["v_dtype"] == gpu16["v_dtype"] == torch.float32:
        raise AssertionError(f"bf16 reference: chain state {gpu16['v_dtype']}")
    for k in ("ndv", "sat", "sat_resid"):
        if not torch.equal(cpu16[k], gpu16[k]):
            raise AssertionError(f"bf16 reference: {k} {gpu16[k]} on the card, {cpu16[k]} "
                                 f"on the CPU")
    for k in ("data_term", "reg_term", "vd_alpha"):
        _err(gpu16[k], cpu16[k], 0.0, BF16_U, f"bf16 reference {k}")
    drift = gpu16["q"] - gpu32["q"]
    dq = gpu16["q"] - cpu16["q"]

    def rms(x):
        return float(x.double().pow(2).mean().sqrt())

    floor = cpu16["floor"]
    if rms(dq) > floor / 8 + 0.1 * rms(drift):
        raise AssertionError(f"bf16 reference: RMS error of σ²∇U {rms(dq):.3e} against the bf16 "
                             f"drift's RMS {rms(drift):.3e}")
    err = _err(gpu16["q"], cpu16["q"], floor + 0.1 * float(drift.abs().max()), 0.0,
               "bf16 reference σ²∇U")
    loss = max(float(((gpu16[k] - cpu16[k]) / cpu16[k]).abs().max())
               for k in ("data_term", "vd_alpha"))
    print(f"bf16 reference: 64³ bf16 transition, card vs CPU agree: counters equal, loss terms "
          f"within {loss:.3e} relative (bound 2^-8), σ²∇U RMS error {rms(dq):.3e}, max abs err "
          f"{err:.3e}; bf16 against float32 on the card moves σ²∇U by RMS {rms(drift):.3e} "
          f"(RMS of σ²∇U {rms(gpu32['q']):.3e}), max {float(drift.abs().max()):.3e}",
          flush=True)


# ---- phase 12: the multi-device layer ----------------------------------------------

HALO_SHARDS = 4
# (channels, radius) of the halo phase's warps at 128³
HALO_WARPS = ((1, 1), (3, 2))
# each warp launches its z-halo/z-pad kernel once per shard in each direction
HALO_LAUNCHES = {sym: HALO_SHARDS * len(HALO_WARPS) for sym in ZHALO}


def _sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def phase_halo(devices, tag: str = "halo") -> dict:
    """12(a): the spatially sharded ops of ``parallel/halo.py`` over a
    ``('space',)`` mesh of HALO_SHARDS shards on ``devices`` (a device may
    repeat) at 128³: ``separable_conv3d_sharded`` (the Sobolev kernel, s 3)
    and ``gradient_d_sharded`` on a 3-channel field, and
    ``warp_bounded_sharded`` forward and both gradients at 1 channel R 1 and
    3 channels R 2, each against its unsharded op on the first device (the
    warp: ``warp_bounded``, B5-B7); B5Z, B6Z and B7Z launch once per shard
    and warp in each direction, and nothing else.  Then B5Z, B6Z and B7Z
    once more on each shard's own operands, at the shapes the sharded warp
    gives them (its halo-exchanged vol, its slabs of disp and of the
    cotangent), against their plain versions.  Tolerance atol 1e-5 plus
    rtol 1e-5 (B7's, and the selftest's for the three), each check also
    saying whether it is bitwise.  Returns the launch counts of the
    sharded run."""
    from ir_sgmcmc_tpu_torch import selftest as st
    from ir_sgmcmc_tpu_torch.kernels import all_kernels
    from ir_sgmcmc_tpu_torch.kernels import warp_bounded as wb
    from ir_sgmcmc_tpu_torch.ops.resample import warp_bounded
    from ir_sgmcmc_tpu_torch.ops.sobolev import sobolev_kernel_1d
    from ir_sgmcmc_tpu_torch.ops.stencil import gradient, separable_conv3d
    from ir_sgmcmc_tpu_torch.parallel import (gather, gradient_d_sharded, make_mesh,
                                              separable_conv3d_sharded, warp_bounded_sharded)

    dev = devices[0]
    mesh = make_mesh(HALO_SHARDS, axes=("space",), devices=devices)
    gen = torch.Generator(device=dev).manual_seed(97)
    field = torch.randn((3,) + DIMS, generator=gen, device=dev)
    kernel = torch.as_tensor(sobolev_kernel_1d(3, 0.5)[0], dtype=torch.float32, device=dev)
    refs = {"conv": separable_conv3d(field, kernel), "gradient_d": gradient(field)[:, 2]}
    cases = []
    for C, R in HALO_WARPS:
        vol, disp, g = (t[0] for t in st.bounded_operands(gen, (1, C) + DIMS, R))
        v, d = vol.clone().requires_grad_(True), disp.clone().requires_grad_(True)
        ref = warp_bounded(v[None], d[None], R)[0]
        r_v, r_d = torch.autograd.grad((ref * g).sum(), [v, d])
        cases.append((C, R, vol, disp, g, (ref.detach(), r_v, r_d)))

    def sharded_warp(vol, disp, g, R):
        v, d = vol.clone().requires_grad_(True), disp.clone().requires_grad_(True)
        out = gather(warp_bounded_sharded(v, d, R, mesh))
        return (out.detach(),) + torch.autograd.grad((out * g).sum(), [v, d])

    kernels = all_kernels()
    _sync_all()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    got = {"conv": gather(separable_conv3d_sharded(field, kernel, mesh)),
           "gradient_d": gather(gradient_d_sharded(field, mesh))}
    warps = [sharded_warp(vol, disp, g, R) for _, R, vol, disp, g, _ in cases]
    _sync_all()
    seconds = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in kernels}
    want = {sym: HALO_LAUNCHES.get(sym, 0) for sym in launches}
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected {want}")
    checks = {}
    for name in ("conv", "gradient_d"):
        checks[name] = (_err(got[name], refs[name], 1e-5, 1e-5, f"{tag} {name}"),
                        torch.equal(got[name], refs[name]))
    for (C, R, vol, disp, g, ref), out in zip(cases, warps):
        for what, a, b in zip(("out", "g_vol", "g_disp"), out, ref):
            checks[f"warp C {C} R {R} {what}"] = (
                _err(a, b, 1e-5, 1e-5, f"{tag} warp C {C} R {R} {what}"), torch.equal(a, b))
    # each shard's kernels at the shapes of the path, against their plain versions
    shard_errs, n = {}, DIMS[0] // HALO_SHARDS
    for C, R, vol, disp, g, _ in cases:
        # shard i's vol: its planes and R neighbour planes on each side, the
        # edge plane repeated at the two ends
        zpad = torch.nn.functional.pad(vol[None], (0, 0, 0, 0, R, R), mode="replicate")

        def cut(t, deeper=0):
            return [t[:, :, i * n:(i + 1) * n + deeper].to(dv).contiguous()
                    for i, dv in enumerate(mesh.device_list)]

        for i, (vh, d, gs) in enumerate(zip(cut(zpad, 2 * R), cut(disp[None]), cut(g[None]))):
            for k, kern, plain in (
                    (wb.B5Z, lambda: wb.warp_bounded_fwd_cuda(vh, d, R, z_halo=True),
                     lambda: wb.warp_bounded_plain(vh, d, R, z_halo=True)),
                    (wb.B6Z, lambda: wb.warp_bounded_dgrad_cuda(vh, d, gs, R, z_halo=True),
                     lambda: wb.warp_bounded_dgrad_plain(vh, d, gs, R, z_halo=True)),
                    (wb.B7Z, lambda: wb.warp_bounded_tblend_cuda(d, gs, R, z_pad=True),
                     lambda: wb.warp_bounded_tblend_zpad_plain(d, gs, R))):
                a, b = kern(), plain()
                key = f"{k.symbol} vol {tuple(vh.shape)} R {R}"
                e = _err(a, b, *st.TOL[k.symbol], f"{tag} shard {i} {key}")
                old = shard_errs.get(key, (0.0, True))
                shard_errs[key] = (max(old[0], e), old[1] and torch.equal(a, b))
    # fwd + bwd of the first warp, sharded against unsharded, in turns
    C, R, vol, disp, g, _ = cases[0]

    def unsharded():
        v, d = vol.clone().requires_grad_(True), disp.clone().requires_grad_(True)
        torch.autograd.grad((warp_bounded(v[None], d[None], R)[0] * g).sum(), [v, d])

    walls = {}
    for name, fn in (("unsharded", unsharded), ("sharded", lambda: sharded_warp(vol, disp, g, R)),
                     ("sharded", lambda: sharded_warp(vol, disp, g, R)), ("unsharded", unsharded)):
        fn()
        _sync_all()
        t1 = time.perf_counter()
        for _ in range(5):
            fn()
        _sync_all()
        walls.setdefault(name, []).append(1e3 * (time.perf_counter() - t1) / 5)
    record = {"devices": [str(d) for d in mesh.device_list], "shape": list(DIMS),
              "checks": {k: {"max_abs_err": e, "bitwise": b} for k, (e, b) in checks.items()},
              "shard_kernels_vs_plain": {k: {"max_abs_err": e, "bitwise": b}
                                         for k, (e, b) in shard_errs.items()},
              "launches": {k: v for k, v in launches.items() if v}, "seconds": seconds,
              "warp_fwd_bwd_ms": walls}
    print(f"{tag}: {json.dumps(record)}", flush=True)
    return launches


def phase_chain_mesh(devices, tag: str = "chain_mesh") -> dict:
    """12(b): phase 3's problem (128³, 2 chains, "post") through
    ``make_mcmc_chunk(chain_mesh=...)`` over a ``('chain',)`` mesh of
    ``devices`` (a device may repeat), TIMED transitions after one warm-up
    transition, against the unsharded chunk from the same state: B1 7, B2 7,
    B3 1, B4 1 launches per transition and shard, the state gathered back
    against the unsharded one (bitwise, or within atol 1e-5 plus rtol 1e-5
    with the error printed), and one more chunk under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync inside a
    chunk).  Prints the samples/sec of both runs: on one card the gap is
    the cost of issuing every shard's launches from the one thread.
    Returns the launch counts of the sharded run."""
    from ir_sgmcmc_tpu_torch.engine import make_mcmc_chunk
    from ir_sgmcmc_tpu_torch.kernels import all_kernels
    from ir_sgmcmc_tpu_torch.parallel import gather, make_mesh, shard_chain_state

    dev = devices[0]
    mesh = make_mesh(len(devices), axes=("chain",), devices=devices)
    bundle, fixed, moving, opt_gmm, opt_reg = _problem(DIMS, dev)

    def chunk(n, chain_mesh=None):
        return make_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-5, fixed, moving, chunk=n,
                               burn_in=0, thin=1, chain_mesh=chain_mesh)

    state, _ = chunk(1)(_init(bundle, opt_gmm, opt_reg, dev))
    shards = shard_chain_state(state, mesh, CHAINS)
    chunk(1, mesh)(shards)  # warm-up of the sharded path (its result is dropped)
    kernels = all_kernels()
    _sync_all()
    t0 = time.perf_counter()
    plain, m_plain = chunk(TIMED)(state)
    _sync_all()
    t_plain = time.perf_counter() - t0
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out, m_sharded = chunk(TIMED, mesh)(shards)
    _sync_all()
    t_sharded = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in kernels}
    for sym, per in POST_PER_STEP.items():
        if launches[sym] != per * TIMED * len(devices):
            raise AssertionError(f"{tag}: {sym} launched {launches[sym]} times, expected "
                                 f"{per * TIMED * len(devices)}")
    whole = gather(out)
    checks = {}
    for name, a, b in (("v", whole.v, plain.v), ("welford mean", whole.welford.mean,
                                                   plain.welford.mean),
                       ("data_term", m_sharded["data_term"], m_plain["data_term"])):
        checks[name] = {"max_abs_err": _err(a, b, 1e-5, 1e-5, f"{tag} {name}"),
                        "bitwise": torch.equal(a, b)}
    one = chunk(1, mesh)
    torch.cuda.set_sync_debug_mode("error")
    try:
        one(out)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _sync_all()
    rates = {"unsharded": CHAINS * TIMED / t_plain, "sharded": CHAINS * TIMED / t_sharded}
    print(f"{tag}: {json.dumps({'devices': [str(d) for d in mesh.device_list], 'checks': checks, 'samples_per_sec': rates, 'sync_debug_error_chunk': 'passed'})}",
          flush=True)
    print(f"{tag}: {CHAINS} chains x {TIMED} transitions: unsharded {rates['unsharded']:.3f} "
          f"samples/sec, over {len(devices)} shards {rates['sharded']:.3f} samples/sec "
          f"({rates['sharded'] / rates['unsharded']:.3f}x)", flush=True)
    return launches


# the trainer shards chains over devices only where this is set explicitly
DISTRIBUTE_CHAINS = ("trainer;distribute=true",)


def phase_distributed_trainer(dev, single: dict, pairs_single: dict) -> dict:
    """12(c): the demo config through the CLI with ``--devices`` naming the
    card twice and ``distribute: true``, cut as in phase 7 (the chains over
    a 2-shard ``('chain',)`` mesh, the VI-test draws over a ``('draw',)``
    mesh), and again with
    PAIRS pairs and ``pair_parallel`` (a 2-shard ``('pair',)`` mesh), with
    phase 7's and 9(c)'s checks; prints each summary beside the one-device
    run's.  Returns the launch counts of both runs."""
    argv = ("--devices", f"{dev},{dev}")
    methods = {"VI": "_run_vi_phase", "VI test": "_test_vi", "MCMC": "_run_mcmc_phase"}
    paths = {}
    with _cli_run("distributed_trainer", "configs/demo/config_synthetic.json",
                  DISTRIBUTE_CHAINS, methods, argv) as r:
        t, s = r["trainer"], r["summaries"][0]
        if t._mcmc_mesh.shape != {"chain": 2} or t._draw_mesh.shape != {"draw": 2}:
            raise AssertionError(f"distributed_trainer: meshes {t._mcmc_mesh}, {t._draw_mesh}")
        missing = [a for a in TRAINER_ARTIFACTS if not list(r["run_dir"].glob(a))]
        if missing:
            raise AssertionError(f"distributed_trainer: artifacts missing: {missing}")
        paths["distributed_trainer"] = r["launches"]
    print(f"distributed_trainer: {json.dumps({'summary': s, 'one_device': single['summary'], 'wall_s': r['wall_s'], 'one_device_wall_s': single['wall_s'], 'peak_bytes': r['peak_bytes']}, default=float)}",
          flush=True)
    methods = {"VI": "_run_pair_vi_phase", "VI test": "_test_vi",
               "MCMC": "_run_pair_mcmc_phase"}
    with _cli_run("distributed_pairs_trainer", "configs/demo/config_synthetic.json",
                  PAIRS_TRAINER_OVERRIDES, methods, argv) as r:
        t, summaries = r["trainer"], r["summaries"]
        if t._pair_mesh is None or t._pair_mesh.shape != {"pair": 2}:
            raise AssertionError(f"distributed_pairs_trainer: pair mesh {t._pair_mesh}")
        if len(summaries) != PAIRS:
            raise AssertionError(f"distributed_pairs_trainer: {len(summaries)} summaries")
        paths["distributed_pairs_trainer"] = r["launches"]
    record = {"dsc": [{k: x[k] for k in ("dsc_before", "vi_test_mean_dsc", "mcmc_mean_dsc")}
                      for x in summaries],
              "one_device_dsc": pairs_single["dsc"],
              "mcmc_aggregate_samples_per_sec": summaries[0]["mcmc_aggregate_samples_per_sec"],
              "one_device_mcmc_aggregate_samples_per_sec":
                  pairs_single["mcmc_aggregate_samples_per_sec"],
              "pairs_per_batch": t.pair_groups, "wall_s": r["wall_s"],
              "one_device_wall_s": pairs_single["wall_s"], "peak_bytes": r["peak_bytes"]}
    print(f"distributed_pairs_trainer: {json.dumps(record, default=float)}", flush=True)
    return paths


def phase_multi_card(n_cards: int, single: dict) -> dict:
    """12(d): with two cards or more, the selftest on every card (each
    kernel's shared-memory opt-in is per card), 12(a) and 12(b) again on
    real cards (the halo shards cycling over the cards, the chains over
    two), and the demo config through the CLI over ``cuda:0,cuda:1`` with
    ``distribute: true``, its summary beside phase 7's one-card run
    (``single``).  Returns the launch counts of each path."""
    from ir_sgmcmc_tpu_torch import selftest

    cards = [torch.device("cuda", i) for i in range(n_cards)]
    for card in cards:
        r = selftest.run_selftest(card, log=False)
        if not r["ok"]:
            raise AssertionError(f"selftest on {card}: {r['checks']}")
        print(f"multi_card: selftest on {card}: {len(r['checks'])} checks pass", flush=True)
    paths = {"halo_cards": phase_halo([cards[i % n_cards] for i in range(HALO_SHARDS)],
                                      "halo_cards"),
             "chain_mesh_cards": phase_chain_mesh(cards[:CHAINS], "chain_mesh_cards")}
    with _cli_run("trainer_2cards", "configs/demo/config_synthetic.json", DISTRIBUTE_CHAINS,
                  {"MCMC": "_run_mcmc_phase"}, ("--devices", "cuda:0,cuda:1")) as r:
        t = r["trainer"]
        if t._mcmc_mesh.shape != {"chain": 2} or t._draw_mesh.shape != {"draw": 2}:
            raise AssertionError(f"trainer_2cards: meshes {t._mcmc_mesh}, {t._draw_mesh}")
        paths["trainer_2cards"] = r["launches"]
    print(f"trainer_2cards: {json.dumps({'summary': r['summaries'][0], 'one_card': single['summary'], 'wall_s': r['wall_s'], 'one_card_wall_s': single['wall_s']}, default=float)}",
          flush=True)
    return paths


# ---- phase 13: the spatially sharded steps -------------------------------------------

SPATIAL_SHARDS = 2
# launches per step of the sharded "post" step on each shard: its slab's 7
# split compositions forward and backward and one block-gather warp
SPATIAL_PER_SHARD = {"split_warp_fwd_zhalo": 7, "split_warp_bwd_zhalo": 7,
                     "block_warp_fwd_zhalo": 1, "block_warp_dgrad_zhalo": 1}
# the sharded steps' tolerance against the unsharded ones on the card: the
# same per-voxel arithmetic, global sums added in another order
SPATIAL_ATOL, SPATIAL_RTOL = 1e-5, 1e-5
# VI's gradient (Adam's first moment) against the unsharded step's, as a
# share of its largest element
VI_MOMENT_REL = 1e-4


def _spatial_per_step(shards: int) -> dict:
    return {**dict.fromkeys(POST_PER_STEP, 0),
            **{sym: n * shards for sym, n in SPATIAL_PER_SHARD.items()}}


def _timed_on(devices, run, state, steps: int, what: str, per_step: dict):
    """:func:`_timed_run` over several devices: every card synchronised and
    its peak counter reset; returns ``(state, metrics, seconds, launches,
    {device: peak bytes})``."""
    from ir_sgmcmc_tpu_torch.kernels import all_kernels

    cards = sorted({torch.device(d) for d in devices}, key=str)
    _sync_all()
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    state, metrics = run(state)
    _sync_all()
    seconds = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in kernels}
    for sym, per in per_step.items():
        if launches[sym] != per * steps:
            raise AssertionError(f"{what}: {sym} launched {launches[sym]} times in {steps} "
                                 f"steps, expected {per * steps}")
    return state, metrics, seconds, launches, {str(d): torch.cuda.max_memory_allocated(d)
                                               for d in cards}


def _close(tag: str, checks: dict) -> dict:
    """Each ``(sharded, unsharded)`` pair within SPATIAL_ATOL + SPATIAL_RTOL,
    with its error and whether it is bitwise."""
    return {name: {"max_abs_err": _err(a, b, SPATIAL_ATOL, SPATIAL_RTOL, f"{tag} {name}"),
                   "bitwise": torch.equal(a, b)} for name, (a, b) in checks.items()}


def phase_spatial(devices, tag: str = "spatial") -> dict:
    """13(a)-(b): the spatially sharded steps over ``devices`` (a device may
    repeat: virtual shards), against the unsharded steps on the first.
    (a) phase 3's problem (128³, 2 chains, "post") through
    ``make_mcmc_chunk`` on a ``(1, n)`` ``('chain', 'space')`` mesh, TIMED
    transitions after one warm-up each: B1Z 7, B2Z 7, B3Z 1, B4Z 1 launches
    per transition and shard and B1-B4 none, the state and the data term
    against the unsharded chunk's from the same state and draws (atol
    1e-5 plus rtol 1e-5), one chunk under
    ``torch.cuda.set_sync_debug_mode("error")``, both samples/sec and each
    card's peak memory; (b) the same for VI on "post" (GMM warm-up, TIMED
    steps) through ``make_vi_step`` over a ``('space',)`` mesh: the total
    loss of every step within rtol 1e-4 and the q(v) gradient of one step
    (Adam's first moment) within 1e-4 of its largest element of the
    unsharded step's; ``mu`` after the TIMED steps is printed, not held
    (Adam turns the rounding of near-zero gradients into steps of ±lr).
    Prints a ``tag:`` line; returns the launch counts of the two sharded
    runs."""
    from ir_sgmcmc_tpu_torch.engine import gmm_warmup, make_mcmc_chunk, make_vi_chunk, make_vi_step
    from ir_sgmcmc_tpu_torch.parallel import (gather, make_mesh, shard_images_spatial,
                                              shard_state_spatial, shard_tree_spatial)

    dev, n, depth = devices[0], len(devices), DIMS[0]
    per_step = _spatial_per_step(n)
    mesh = make_mesh((1, n), axes=("chain", "space"), devices=devices)
    bundle, fixed, moving, opt_gmm, opt_reg = _problem(DIMS, dev)
    fixed_s, moving_s = (shard_images_spatial(x, mesh, depth) for x in (fixed, moving))

    def chunk(k, sharded=False):
        return make_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-5, fixed_s if sharded else fixed,
                               moving_s if sharded else moving, chunk=k, burn_in=0, thin=1)

    state, _ = chunk(1)(_init(bundle, opt_gmm, opt_reg, dev))
    shards = shard_state_spatial(state, mesh, CHAINS, depth)
    chunk(1, True)(shards)  # warm-up of the sharded path (its result is dropped)
    plain, m_plain, t_plain, _, peak_plain = _timed_on(
        [dev], chunk(TIMED), state, TIMED, f"{tag} unsharded", POST_PER_STEP)
    out, m_sh, t_sh, mcmc_launches, peak_sh = _timed_on(
        devices, chunk(TIMED, True), shards, TIMED, f"{tag} sharded", per_step)
    whole = gather(out)
    mcmc_checks = _close(f"{tag} mcmc", {
        "v": (whole.v, plain.v), "welford mean": (whole.welford.mean, plain.welford.mean),
        "data_term": (m_sh["data_term"], m_plain["data_term"])})
    one = chunk(1, True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        one(out)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _sync_all()

    vb, vfixed, vmoving, (oq, og, orr), vstate = _vi_problem(DIMS, dev, "post")
    vmesh = make_mesh((n,), axes=("space",), devices=devices)
    step = make_vi_step(vb, oq, og, orr, vfixed, vmoving)
    step_s = make_vi_step(vb, oq, og, orr, *(shard_images_spatial(x, vmesh, depth)
                                            for x in (vfixed, vmoving)))
    vstate, _ = make_vi_chunk(step, 1)(gmm_warmup(vb, og, vstate, vfixed, vmoving))
    vshards = shard_tree_spatial(vstate, vmesh, depth)
    make_vi_chunk(step_s, 1)(vshards)  # warm-up, dropped
    vplain, vm_plain, tv_plain, _, vpeak_plain = _timed_on(
        [dev], make_vi_chunk(step, TIMED), vstate, TIMED, f"{tag} vi unsharded", POST_PER_STEP)
    vout, vm_sh, tv_sh, vi_launches, vpeak_sh = _timed_on(
        devices, make_vi_chunk(step_s, TIMED), vshards, TIMED, f"{tag} vi sharded", per_step)
    # Adam normalises each voxel's gradient, so where it is near 0 the
    # rounding of the global sums (added over slabs in another order) flips
    # a step of ±lr: q(v) is compared through its gradient, the first
    # moment after one step from the same state (0.1·g), and the losses
    m_u = make_vi_chunk(step, 1)(vstate)[0].opt_q_v.mu
    m_s = gather(make_vi_chunk(step_s, 1)(vshards)[0]).opt_q_v.mu
    vi_checks = {}
    for name in ("mu", "log_var", "u"):
        scale = float(m_u[name].abs().max())
        vi_checks[f"first moment {name}"] = {
            "max_abs_err": _err(m_s[name], m_u[name], VI_MOMENT_REL * scale, 0.0,
                                f"{tag} vi first moment {name}"),
            "bitwise": torch.equal(m_s[name], m_u[name]), "max_abs": scale}
    vi_checks["total_loss"] = {
        "max_abs_err": _err(vm_sh["total_loss"], vm_plain["total_loss"], 0.0, 1e-4,
                            f"{tag} vi total_loss"),
        "bitwise": torch.equal(vm_sh["total_loss"], vm_plain["total_loss"])}
    mu_diff = (gather(vout).q_v["mu"] - vplain.q_v["mu"]).abs()
    vi_checks[f"mu after {TIMED} steps (not asserted)"] = {
        "max_abs_err": float(mu_diff.max()),
        "elements_beyond_1e-5": int((mu_diff > 1e-5).sum()), "elements": mu_diff.numel()}
    record = {
        "devices": [str(d) for d in devices], "shape": list(DIMS), "chains": CHAINS,
        "tolerance": {"atol": SPATIAL_ATOL, "rtol": SPATIAL_RTOL},
        "mcmc": {"checks": mcmc_checks,
                 "samples_per_sec": {"unsharded": CHAINS * TIMED / t_plain,
                                     "sharded": CHAINS * TIMED / t_sh},
                 "peak_bytes": {"unsharded": peak_plain, "sharded_per_card": peak_sh},
                 "sync_debug_error_chunk": "passed"},
        "vi": {"checks": vi_checks,
               "iters_per_sec": {"unsharded": TIMED / tv_plain, "sharded": TIMED / tv_sh},
               "peak_bytes": {"unsharded": vpeak_plain, "sharded_per_card": vpeak_sh}},
        "launches_per_step": {sym: mcmc_launches[sym] // TIMED for sym in SPATIAL_PER_SHARD}}
    print(f"{tag}: {json.dumps(record)}", flush=True)
    r_m, r_v = record["mcmc"]["samples_per_sec"], record["vi"]["iters_per_sec"]
    print(f"{tag}: over {n} shards {[str(d) for d in devices]}: MCMC {r_m['sharded']:.3f} "
          f"samples/sec against {r_m['unsharded']:.3f} unsharded "
          f"({r_m['sharded'] / r_m['unsharded']:.3f}x), VI {r_v['sharded']:.3f} iters/sec "
          f"against {r_v['unsharded']:.3f} ({r_v['sharded'] / r_v['unsharded']:.3f}x)",
          flush=True)
    return {f"{tag}_mcmc": mcmc_launches, f"{tag}_vi": vi_launches}


# the options of the dense SVF3D beside phase 13(a)-(b)'s "post"/"split"/f32/
# gradient-energy path, each through the sharded MCMC chunk ("pre": the
# sharded VI step, the scheme bench.py times VI on), and the launches per
# step on each shard: "pre" integrates with the image riding the
# compositions (B1Z 7; B5Z 8 image warps and the noise warp; their
# backward B6Z 8, B7Z 8; the compositions feed only the counts, so no
# B2Z), "warp" composes by 3-channel halo warps (B5Z-B7Z 7) before the
# block-gather warp, use_gather runs grid_sample only, bf16 the bf16
# z-halo modes of B1/B2, the Fourier energy phase 13(a)'s kernels
SPATIAL_OPTIONS = {
    "pre": {"split_warp_fwd_zhalo": 7, "warp_bounded_fwd_zhalo": 9,
            "warp_bounded_dgrad_zhalo": 8, "warp_bounded_tblend_zpad": 8},
    "warp": {"warp_bounded_fwd_zhalo": 7, "warp_bounded_dgrad_zhalo": 7,
             "warp_bounded_tblend_zpad": 7, "block_warp_fwd_zhalo": 1,
             "block_warp_dgrad_zhalo": 1},
    "use_gather": {},
    "bfloat16": {"split_warp_fwd_zhalo_bf16": 7, "split_warp_bwd_zhalo_bf16": 7,
                 "block_warp_fwd_zhalo": 1, "block_warp_dgrad_zhalo": 1},
    "fourier": SPATIAL_PER_SHARD,
}
# each z-halo (z-pad) mode's default mode: what the unsharded step launches
_DEFAULT_MODE = {"split_warp_fwd_zhalo": "split_warp_fwd", "split_warp_bwd_zhalo": "split_warp_bwd",
                 "block_warp_fwd_zhalo": "block_warp_fwd",
                 "block_warp_dgrad_zhalo": "block_warp_dgrad",
                 "warp_bounded_fwd_zhalo": "warp_bounded_fwd",
                 "warp_bounded_dgrad_zhalo": "warp_bounded_dgrad",
                 "warp_bounded_tblend_zpad": "warp_bounded_tblend",
                 "split_warp_fwd_zhalo_bf16": "split_warp_fwd_bf16",
                 "split_warp_bwd_zhalo_bf16": "split_warp_bwd_bf16"}


def _option_bundle(bundle, option: str):
    """``bundle`` (``_bundle``'s, on the scheme and dtype of ``option``) with
    the option's integrator or energy."""
    from ir_sgmcmc_tpu_torch.models import SVF3D, RegLossLogNormal

    if option == "warp":
        bundle.transformation = SVF3D(DIMS, no_steps=12, taylor_compositions="warp")
    elif option == "use_gather":
        bundle.transformation = SVF3D(DIMS, no_steps=12, use_gather=True)
    elif option == "fourier":
        bundle.reg_loss = RegLossLogNormal(w_reg=1.4, diff_op="Fourier1stDerivativeOperator",
                                           dims=DIMS, learnable=True)
    return bundle


def phase_spatial_options(devices, tag: str = "spatial_options") -> dict:
    """13(e): each option of ``SPATIAL_OPTIONS`` at 128³ through the sharded
    step over ``devices`` (a device may repeat) against the unsharded step
    on the first: MCMC (2 chains) on a ``(1, n)`` ``('chain', 'space')``
    mesh, or for ``"pre"`` VI (GMM warm-up) on a ``('space',)`` mesh, one
    warm-up and TIMED steps each, the launches per step asserted on both
    (the sharded ones per shard; every other kernel 0), the checks of
    13(a)-(b) (MCMC: state and data term within atol 1e-5 plus rtol 1e-5;
    with bf16 ``compute_dtype`` ``v`` so, the displacement's mean within
    2^-8 of its largest element and the data term within 2^-8 relative;
    VI: every step's total loss within rtol 1e-4 and one step's q(v)
    gradient within 1e-4 of its largest element),
    both rates and each card's peak memory.  Prints a ``tag:`` line;
    returns the launch counts of each sharded run."""
    from ir_sgmcmc_tpu_torch.engine import gmm_warmup, make_mcmc_chunk, make_vi_chunk, make_vi_step
    from ir_sgmcmc_tpu_torch.parallel import (gather, make_mesh, shard_images_spatial,
                                              shard_state_spatial, shard_tree_spatial)

    dev, n, depth = devices[0], len(devices), DIMS[0]
    zeros = dict.fromkeys(POST_PER_STEP, 0)
    record, paths = {}, {}
    t_start = time.perf_counter()
    for option, per_shard in SPATIAL_OPTIONS.items():
        cd = "bfloat16" if option == "bfloat16" else None
        scheme = "pre" if option == "pre" else "post"
        plain_per = {**zeros, **{_DEFAULT_MODE[k]: v for k, v in per_shard.items()}}
        sharded_per = {**zeros, **{k: v * n for k, v in per_shard.items()}}
        what = f"{tag} {option}"
        if option != "pre":
            mesh = make_mesh((1, n), axes=("chain", "space"), devices=devices)
            bundle, fixed, moving, opt_gmm, opt_reg = _problem(DIMS, dev, scheme,
                                                               compute_dtype=cd)
            bundle = _option_bundle(bundle, option)
            fixed_s, moving_s = (shard_images_spatial(x, mesh, depth) for x in (fixed, moving))

            def chunk(k, sharded=False):
                return make_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-5,
                                       fixed_s if sharded else fixed,
                                       moving_s if sharded else moving, chunk=k, burn_in=0,
                                       thin=1)

            state, _ = chunk(1)(_init(bundle, opt_gmm, opt_reg, dev))
            shards = shard_state_spatial(state, mesh, CHAINS, depth)
            chunk(1, True)(shards)  # warm-up of the sharded path (dropped)
            plain, m_plain, t_plain, _, peak_plain = _timed_on(
                [dev], chunk(TIMED), state, TIMED, f"{what} unsharded", plain_per)
            out, m_sh, t_sh, launches, peak_sh = _timed_on(
                devices, chunk(TIMED, True), shards, TIMED, f"{what} sharded", sharded_per)
            whole = gather(out)
            checks = _close(what, {"v": (whole.v, plain.v)})
            pairs = {"welford mean": (whole.welford.mean, plain.welford.mean),
                     "data_term": (m_sh["data_term"], m_plain["data_term"])}
            if cd is None:
                checks.update(_close(what, pairs))
            else:
                # bf16: the sharded gradient rounds a halo plane's two
                # shares apart, so the chain states part by f32 roundings
                # (v above) that flip a bf16 rounding of the displacement
                # here and there: it is held to one unit roundoff of its
                # largest element, the data term to one relative
                a, b = pairs["welford mean"]
                checks["welford mean"] = {
                    "max_abs_err": _err(a, b, BF16_U * float(b.abs().max()), 0.0,
                                        f"{what} welford mean"), "bitwise": torch.equal(a, b)}
                a, b = pairs["data_term"]
                checks["data_term"] = {"max_abs_err": _err(a, b, 0.0, BF16_U,
                                                           f"{what} data_term"),
                                       "bitwise": torch.equal(a, b)}
            rates = {"unsharded": CHAINS * TIMED / t_plain, "sharded": CHAINS * TIMED / t_sh}
            unit = "samples/sec"
        else:
            vmesh = make_mesh((n,), axes=("space",), devices=devices)
            vb, vfixed, vmoving, (oq, og, orr), vstate = _vi_problem(DIMS, dev, scheme)
            step = make_vi_step(vb, oq, og, orr, vfixed, vmoving)
            step_s = make_vi_step(vb, oq, og, orr, *(shard_images_spatial(x, vmesh, depth)
                                                    for x in (vfixed, vmoving)))
            vstate, _ = make_vi_chunk(step, 1)(gmm_warmup(vb, og, vstate, vfixed, vmoving))
            vshards = shard_tree_spatial(vstate, vmesh, depth)
            make_vi_chunk(step_s, 1)(vshards)  # warm-up, dropped
            _, m_plain, t_plain, _, peak_plain = _timed_on(
                [dev], make_vi_chunk(step, TIMED), vstate, TIMED, f"{what} unsharded", plain_per)
            _, m_sh, t_sh, launches, peak_sh = _timed_on(
                devices, make_vi_chunk(step_s, TIMED), vshards, TIMED, f"{what} sharded",
                sharded_per)
            m_u = make_vi_chunk(step, 1)(vstate)[0].opt_q_v.mu
            m_s = gather(make_vi_chunk(step_s, 1)(vshards)[0]).opt_q_v.mu
            checks = {}
            for name in ("mu", "log_var", "u"):
                scale = float(m_u[name].abs().max())
                checks[f"first moment {name}"] = {
                    "max_abs_err": _err(m_s[name], m_u[name], VI_MOMENT_REL * scale, 0.0,
                                        f"{what} first moment {name}"),
                    "bitwise": torch.equal(m_s[name], m_u[name]), "max_abs": scale}
            checks["total_loss"] = {
                "max_abs_err": _err(m_sh["total_loss"], m_plain["total_loss"], 0.0, 1e-4,
                                    f"{what} total_loss"),
                "bitwise": torch.equal(m_sh["total_loss"], m_plain["total_loss"])}
            rates = {"unsharded": TIMED / t_plain, "sharded": TIMED / t_sh}
            unit = "iters/sec"
        record[option] = {"step": "vi" if option == "pre" else "mcmc", "checks": checks,
                          unit.replace("/", "_per_"): rates,
                          "peak_bytes": {"unsharded": peak_plain, "sharded_per_card": peak_sh},
                          "launches_per_step": {k: launches[k] // TIMED for k in per_shard}}
        paths[f"{tag}_{option}"] = launches
        print(f"{what}: over {n} shards {rates['sharded']:.3f} {unit} against "
              f"{rates['unsharded']:.3f} unsharded ({rates['sharded'] / rates['unsharded']:.3f}x);"
              f" peak {max(peak_sh.values()) / 2**30:.3f} GiB per card, unsharded "
              f"{max(peak_plain.values()) / 2**30:.3f} GiB", flush=True)
        _sync_all()
    wall = time.perf_counter() - t_start
    print(f"{tag}: {json.dumps({'devices': [str(d) for d in devices], 'shape': list(DIMS), 'options': record, 'wall_s': wall})}",
          flush=True)
    return paths


# the sharded trainer runs no default-mode B2 or B4 (every training step is
# cut; B3 serves the GMM warm-up's one forward chain), nor the blend warp's
# backward, the halo warp or the bf16 modes
NOT_ON_SPATIAL_RUNS = (("split_warp_bwd", "block_warp_dgrad")
                       + tuple(s for s in NOT_ON_F32_RUNS if s not in SPATIAL))


def phase_spatial_trainer(devices, single: dict, tag: str = "spatial_trainer") -> dict:
    """13(c): the demo config through the CLI with ``--devices`` naming
    ``devices``, ``spatial_shards`` and ``vi_spatial_shards`` at their
    count, cut as in phase 7 (a ``(1, n)`` ``('chain', 'space')`` mesh for
    MCMC, a ``('space',)`` mesh of n for VI), with phase 7's checks but the
    checkpoints; the MCMC and VI-test Dice beside the one-device run's
    (``single``).  Returns the launch counts of the run."""
    n = len(devices)
    extra = (f"trainer;spatial_shards={n}", f"trainer;vi_spatial_shards={n}")
    methods = {"VI": "_run_vi_phase", "VI test": "_test_vi", "MCMC": "_run_mcmc_phase"}
    with _cli_run(tag, "configs/demo/config_synthetic.json", extra, methods,
                  ("--devices", ",".join(str(d) for d in devices)), NOT_ON_SPATIAL_RUNS) as r:
        t, s = r["trainer"], r["summaries"][0]
        if t._mcmc_mesh.shape != {"chain": 1, "space": n} or t._vi_mesh.shape != {"space": n}:
            raise AssertionError(f"{tag}: meshes {t._mcmc_mesh}, {t._vi_mesh}")
        missing = [a for a in TRAINER_ARTIFACTS if not list(r["run_dir"].glob(a))]
        if missing:
            raise AssertionError(f"{tag}: artifacts missing: {missing}")
    keys = ("dsc_before", "vi_test_mean_dsc", "mcmc_mean_dsc", "mcmc_samples_per_sec",
            "vi_samples_per_sec")
    record = {"devices": [str(d) for d in devices], "summary": {k: s[k] for k in keys},
              "one_device": {k: single["summary"][k] for k in keys},
              "mcmc_dsc_diff": s["mcmc_mean_dsc"] - single["summary"]["mcmc_mean_dsc"],
              "wall_s": r["wall_s"], "one_device_wall_s": single["wall_s"],
              "phase_s": {name: p["s"] for name, p in r["phases"].items()},
              "peak_bytes": r["peak_bytes"]}
    print(f"{tag}: {json.dumps(record, default=float)}", flush=True)
    return {tag: r["launches"]}


def phase_spatial_cards(n_cards: int, single: dict) -> dict:
    """13(d): with two cards or more, 13(a)-(c) over two real cards, and
    with four, 13(a)-(b) at 4 shards over four.  Returns the launch counts
    of each path."""
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    paths = phase_spatial(cards[:2], "spatial_2cards")
    paths.update(phase_spatial_options(cards[:2], "spatial_options_2cards"))
    paths.update(phase_spatial_trainer(cards[:2], single, "spatial_trainer_2cards"))
    if n_cards >= 4:
        paths.update(phase_spatial(cards[:4], "spatial_4cards"))
    else:
        print(f"spatial_4cards: {n_cards} cards: 13(a)-(b) at 4 shards over 4 cards not run",
              flush=True)
    return paths


# ---- phase 14: the benchmark entry -------------------------------------------------

BIG = (256, 256, 256)
# launches per step of the benchmark's variants beside POST_PER_STEP,
# VI_PER_STEP and BF16_PER_STEP (a symbol not named: 0), from SVF3D's
# forms: taylor_compositions "off" composes by radius-1 blend warps (B5 7,
# their backward B6 7 and B7 7) before the block-gather warp; use_gather
# integrates and warps by grid_sample alone; remat (VI at 256³) runs the
# two antithetic chains in turn and recomputes each one's forward in the
# backward (B1 2 x 2 x 7, B2 2 x 7, B3 2 x 2, B4 2)
OFF_PER_STEP = {"warp_bounded_fwd": 7, "warp_bounded_dgrad": 7, "warp_bounded_tblend": 7,
                "block_warp_fwd": 1, "block_warp_dgrad": 1}
GATHER_PER_STEP = {}
REMAT_PER_STEP = {"split_warp_fwd": 28, "split_warp_bwd": 14, "block_warp_fwd": 4,
                  "block_warp_dgrad": 2}
# the canonical line's keys in their order: bench.py's but its Pallas
# fallback and VI error tags, then the port's; vs_baseline (after
# noise_scheme) and baseline_* (after vi_compile_warm_s) come only with a
# cached torch-CPU anchor
CANONICAL_KEYS = ("metric", "value", "unit", "noise_scheme", "spread_rel", "timed_chunks_s",
                  "compile_warm_s", "vi_iters_per_sec", "vi_spread_rel", "vi_compile_warm_s",
                  "backend", "device", "power_limit", "build_s", "peak_mem_bytes",
                  "vi_peak_mem_bytes", "launches_per_step", "vi_launches_per_step")
# 14(b): (tag, argv, the launch table of each phase the line times); the
# 256³ runs time one chunk, the MCMC one also traced (14(d))
BENCH_RUNS = (("vi_pre", ("--phase", "vi", "--noise-scheme", "pre"), (VI_PER_STEP,)),
              ("bf16", ("--compute-dtype", "bfloat16"), (BF16_PER_STEP,) * 2),
              ("off", ("--taylor-compositions", "off"), (OFF_PER_STEP,) * 2),
              ("use_gather", ("--use-gather",), (GATHER_PER_STEP,) * 2),
              ("svffd", ("--model", "svffd"), (POST_PER_STEP,)),
              ("256", ("--dims", "256"), (POST_PER_STEP,)),
              ("256_vi", ("--dims", "256", "--phase", "vi"), (REMAT_PER_STEP,)))


def _check_bench_line(tag: str, line: dict, tables) -> None:
    """Finite positive rates, and each timed phase's launches per step equal
    to its table."""
    from ir_sgmcmc_tpu_torch.kernels import all_kernels

    rates = [line["value"]] + ([line["vi_iters_per_sec"]] if len(tables) == 2 else [])
    if not all(math.isfinite(x) and x > 0 for x in rates):
        raise AssertionError(f"bench {tag}: rates {rates}")
    for key, table in zip(("launches_per_step", "vi_launches_per_step"), tables):
        got, want = line[key], {s: n for s, n in table.items() if n}
        if any(got.get(k.symbol, 0) != want.get(k.symbol, 0) for k in all_kernels()):
            raise AssertionError(f"bench {tag}: {key} {got}, expected {want}")


def phase_bench_canonical(dev) -> dict:
    """14(a): ``python -m ir_sgmcmc_tpu_torch.bench`` from the repository's
    root with no argument: rc 0, one JSON line with the canonical metric and
    keys, finite rates, both phases at POST_PER_STEP's launches."""
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ir_sgmcmc_tpu_torch.bench"], cwd=str(root),
                          capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    out = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(out) != 1:
        raise AssertionError(f"bench: rc {proc.returncode}, {len(out)} stdout lines; stderr "
                             f"{proc.stderr[-3000:]}")
    line = json.loads(out[0])
    keys = [k for k in line if k != "vs_baseline" and not k.startswith("baseline_")]
    if line["metric"] != "sgmcmc_samples_per_sec_128cubed_2chains" or keys != list(
            CANONICAL_KEYS):
        raise AssertionError(f"bench: metric {line['metric']}, keys {list(line)}")
    if line["backend"] != "torch-cuda" or line["device"] != torch.cuda.get_device_name(dev):
        raise AssertionError(f"bench: backend {line['backend']}, device {line['device']}")
    _check_bench_line("canonical", line, (POST_PER_STEP,) * 2)
    print(f"bench canonical ({seconds:.1f} s, a subprocess): {out[0]}", flush=True)
    return line


def _bench_in_process(tag: str, argv) -> tuple:
    """``bench.main(argv)`` with every counter set to 0 just before and read
    just after; its line printed with a tag.  Returns the line and the
    launches."""
    from ir_sgmcmc_tpu_torch import bench
    from ir_sgmcmc_tpu_torch.kernels import all_kernels

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        line = bench.main(list(argv))
    printed = buf.getvalue().strip().splitlines()
    if len(printed) != 1 or json.loads(printed[0]) != line:
        raise AssertionError(f"bench {tag}: printed {printed}")
    print(f"bench {tag} ({time.perf_counter() - t0:.1f} s): {printed[0]}", flush=True)
    return line, {k.symbol: k.launches for k in kernels}


def phase_bench(dev) -> dict:
    """14(b)-(d): each variant of BENCH_RUNS through ``bench.main`` in
    process (the 256³ ones at one timed chunk), its line checked against its
    launch tables; the 256³ MCMC run traced (``--trace``) and the trace
    read by ``scripts/trace_summary.py``, which must find B1-B4 at their
    launches.  Returns each run's launches."""
    import tempfile

    from ir_sgmcmc_tpu_torch import bench
    from ir_sgmcmc_tpu_torch.scripts import trace_summary

    paths = {}
    repeats = bench.TIMED_REPEATS
    with tempfile.TemporaryDirectory() as tmp:
        for tag, argv, tables in BENCH_RUNS:
            bench.TIMED_REPEATS = 1 if "256" in argv else repeats
            if tag == "256":
                argv += ("--trace", tmp)
            line, paths[f"bench_{tag}"] = _bench_in_process(tag, argv)
            _check_bench_line(tag, line, tables)
        bench.TIMED_REPEATS = repeats
        buf = io.StringIO()
        shapes = [f"B1={CHAINS},3,{','.join(map(str, BIG))}",
                  f"B2={CHAINS},3,{','.join(map(str, BIG))}",
                  f"B3={CHAINS},1,{','.join(map(str, BIG))}:2",
                  f"B4={CHAINS},1,{','.join(map(str, BIG))}:2"]
        with contextlib.redirect_stdout(buf):
            kinds = trace_summary.summarise(Path(tmp) / "trace.json", bench.TIMED_STEPS, shapes)
    for ln in buf.getvalue().splitlines():
        print(f"profile bench 256: {ln}", flush=True)
    for kind, sym in (("B1", "split_warp_fwd"), ("B2", "split_warp_bwd"),
                      ("B3", "block_warp_fwd"), ("B4", "block_warp_dgrad")):
        want = POST_PER_STEP[sym] * bench.TIMED_STEPS
        if kind not in kinds or kinds[kind]["launches"] != want:
            raise AssertionError(f"bench trace: {kind} {kinds.get(kind)}, expected {want} "
                                 f"launches")
    return paths


def phase_bench_kernels(dev) -> list:
    """14(c): B1-B4 against their plain versions at the 256³ benchmark's
    shapes (B1/B2 ``(2, 3, 256³)``, B3/B4 vol ``(2, 1, 256³)`` bound 9 R 2),
    at phase 2's tolerances, timed; printed, not in the kernels line."""
    from ir_sgmcmc_tpu_torch import selftest as st
    from ir_sgmcmc_tpu_torch.kernels import block_warp as bw
    from ir_sgmcmc_tpu_torch.kernels import split_warp as sw

    gen = torch.Generator(device=dev).manual_seed(256)
    tol = {k: st.TOL[k.symbol] for k in (sw.B1, sw.B2, bw.B3, bw.B4)}
    shape = (CHAINS, 3) + BIG
    d, u, g = st.split_operands(gen, shape)
    e1 = _err(sw.split_warp_fwd_cuda(d, u), sw.split_compose_plain(d, u), *tol[sw.B1],
              f"B1 {shape}")
    gd_k, gu_k = sw.split_warp_bwd_cuda(d, u, g)
    gd_p, gu_p = sw.split_compose_vjp_plain(d, u, g)
    e2 = max(_err(gd_k, gd_p, *tol[sw.B2], f"B2 gd {shape}"),
             _err(gu_k + g, gu_p, *tol[sw.B2], f"B2 gu {shape}"))
    rows = [_row(sw.B1, shape, e1, *tol[sw.B1],
                 _time_ms(lambda: sw.split_warp_fwd_cuda(d, u)),
                 _time_ms(lambda: sw.split_compose_plain(d, u))),
            _row(sw.B2, shape, e2, *tol[sw.B2],
                 _time_ms(lambda: sw.split_warp_bwd_cuda(d, u, g)),
                 _time_ms(lambda: sw.split_compose_vjp_plain(d, u, g)))]
    del d, u, g, gd_k, gu_k, gd_p, gu_p
    shape = (CHAINS, 1) + BIG
    vol, r, m, gv = st.block_operands(gen, shape, 9, 2)
    e3 = _err(bw.block_warp_cuda(vol, r, m, 2), bw.block_warp_plain(vol, r, m), *tol[bw.B3],
              f"B3 {shape}")
    e4 = _err(bw.block_warp_dgrad_cuda(vol, r, m, gv, 2),
              bw.block_warp_dgrad_plain(vol, r, m, gv), *tol[bw.B4], f"B4 {shape}")
    rows += [_row(bw.B3, shape, e3, *tol[bw.B3],
                  _time_ms(lambda: bw.block_warp_cuda(vol, r, m, 2)),
                  _time_ms(lambda: bw.block_warp_plain(vol, r, m)), radius=2),
             _row(bw.B4, shape, e4, *tol[bw.B4],
                  _time_ms(lambda: bw.block_warp_dgrad_cuda(vol, r, m, gv, 2)),
                  _time_ms(lambda: bw.block_warp_dgrad_plain(vol, r, m, gv)), radius=2)]
    _print_rows(rows)
    return rows


# ---- phase 15: anchored residual warping and the Taylor-form compositions -------------

# launches per transition of anchored SG-MCMC on "post": the integration's 7
# split compositions forward and backward, no block-gather warp (the
# anchored image replaces it), and in the "blend" mode one bounded warp of
# W0 at the anchor radius and its displacement gradient (W0 carries no
# gradient: no B7); each re-anchoring integrates forward once more (B1 7)
ANCHOR_PER_STEP = {
    "taylor": {"split_warp_fwd": 7, "split_warp_bwd": 7},
    "blend": {"split_warp_fwd": 7, "split_warp_bwd": 7, "warp_bounded_fwd": 1,
              "warp_bounded_dgrad": 1}}
ANCHOR_PER_ANCHOR = {"split_warp_fwd": 7}
# the "taylor" compositions compose by plain stencils: on "post" one
# block-gather warp per transition (B3 1, B4 1), on "pre" the image's
# grouped cascade, K = 8 radius-1 warps at e = 4, and the noise warp (B5 9;
# their backward B6 8, B7 8), as VI_PER_STEP's but no B1
TAYLOR_POST = {"block_warp_fwd": 1, "block_warp_dgrad": 1}
TAYLOR_PRE = {"warp_bounded_fwd": 9, "warp_bounded_dgrad": 8, "warp_bounded_tblend": 8}


def _expected(per_step: dict, steps: int, anchors: int = 0, per_anchor=None,
              per_shard: int = 1, zhalo: bool = False) -> dict:
    """Every kernel's launches in ``steps`` steps with ``anchors``
    re-anchorings (``per_anchor`` each), on each of ``per_shard`` shards,
    in the z-halo modes when ``zhalo``; every kernel not named: 0."""
    from ir_sgmcmc_tpu_torch.kernels import all_kernels

    zmode = {v: k for k, v in _DEFAULT_MODE.items()}
    out = {k.symbol: 0 for k in all_kernels()}
    for table, n in ((per_step, steps), (per_anchor or {}, anchors)):
        for sym, count in table.items():
            out[zmode[sym] if zhalo else sym] += count * n * per_shard
    return out


def _check_launches(launches: dict, expected: dict, what: str) -> None:
    bad = {k: (launches[k], n) for k, n in expected.items() if launches[k] != n}
    if bad:
        raise AssertionError(f"{what}: launches (got, expected) {bad}")


def phase_anchor_kernels(dev) -> list:
    """B5 and B6 at the anchored "blend" path's shape, ``(2, 1, 128³)`` at
    the anchor radius 2, against their plain versions at phase 2's
    tolerance, timed, bounded and held to their library calls (B6's away
    from ties)."""
    from ir_sgmcmc_tpu_torch import selftest as st
    from ir_sgmcmc_tpu_torch.kernels import warp_bounded as wb

    gen = torch.Generator(device=dev).manual_seed(2024)
    atol, rtol = st.TOL[wb.B5.symbol]
    shape, R = (CHAINS, 1) + DIMS, ANCHOR_RADIUS
    vol, disp, g = st.bounded_operands(gen, shape, R)
    calls = {wb.B5: (lambda: wb.warp_bounded_fwd_cuda(vol, disp, R),
                     lambda: wb.warp_bounded_plain(vol, disp, R)),
             wb.B6: (lambda: wb.warp_bounded_dgrad_cuda(vol, disp, g, R),
                     lambda: wb.warp_bounded_dgrad_plain(vol, disp, g, R))}
    at = disp.clamp(-R, R)
    grid = _grid(at)
    library = {wb.B5: (lambda: _grid_sample(vol, grid), None),
               wb.B6: (lambda: _grid_grad_voxels(
                   _grid_sample_grads(g, vol, grid, [False, True])[1]), _off_ties(at))}
    rows = []
    for k, (kern, plain) in calls.items():
        err = _err(kern(), plain(), atol, rtol, f"{k.symbol} {shape} R {R}",
                   disp=disp if k is wb.B6 else torch.zeros(0))
        lib = _library_ms(k.symbol, library[k][0], kern(), library[k][1])
        rows.append(_row(k, shape, err, atol, rtol, _time_ms(kern), _time_ms(plain), lib, R))
    _print_rows(rows)
    return rows


def phase_anchor(dev, slice_rate: float) -> tuple:
    """15(a): anchored SG-MCMC at 128³ x 2 chains on "post" (the bench
    model), in each mode, re-anchored every ANCHOR_PERIOD transitions: one
    warm-up and TIMED transitions, the launches of ``ANCHOR_PER_STEP`` per
    transition and ``ANCHOR_PER_ANCHOR`` per re-anchoring asserted (every
    other kernel 0), finite data terms and chain states, ``sat_resid``
    reported; the rate beside phase 3's unanchored ``slice_rate``, the peak
    memory.  Returns ``(paths, record)``."""
    from ir_sgmcmc_tpu_torch.engine import make_mcmc_chunk

    paths, record = {}, {}
    for mode in ("taylor", "blend"):
        bundle, fixed, moving, opt_gmm, opt_reg = _problem(DIMS, dev)

        def chunk(k):
            return make_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-5, fixed, moving, chunk=k,
                                   burn_in=0, thin=1, anchored=True,
                                   anchor_radius=ANCHOR_RADIUS, anchor_mode=mode,
                                   anchor_period=ANCHOR_PERIOD)

        state, _ = chunk(1)(_init(bundle, opt_gmm, opt_reg, dev))
        state, metrics, seconds, launches, peak = _timed_run(chunk(TIMED), state, TIMED,
                                                             f"anchor {mode}", {})
        anchors = -(-TIMED // ANCHOR_PERIOD)
        _check_launches(launches, _expected(ANCHOR_PER_STEP[mode], TIMED, anchors,
                                            ANCHOR_PER_ANCHOR), f"anchor {mode}")
        for name in ("data_term", "reg_term", "vd_alpha"):
            if not torch.isfinite(metrics[name]).all():
                raise AssertionError(f"anchor {mode}: non-finite {name}: {metrics[name]}")
        if not torch.isfinite(state.v).all():
            raise AssertionError(f"anchor {mode}: non-finite chain state")
        sat_resid = metrics["sat_resid"]
        if sat_resid.shape != (TIMED, CHAINS) or bool((sat_resid < 0).any()):
            raise AssertionError(f"anchor {mode}: sat_resid {sat_resid}")
        rate = CHAINS * TIMED / seconds
        record[mode] = {"samples_per_sec": rate, "unanchored_samples_per_sec": slice_rate,
                        "peak_bytes": peak, "anchors": anchors,
                        "launches": {k: n for k, n in launches.items() if n},
                        "last": {k: metrics[k][-1].tolist() for k in
                                 ("data_term", "reg_term", "ndv", "sat", "sat_resid")}}
        paths[f"anchor_{mode}"] = launches
        print(f"anchor: {mode} mode, period {ANCHOR_PERIOD}, radius {ANCHOR_RADIUS}: "
              f"{rate:.3f} samples/sec ({CHAINS} chains x {TIMED} transitions in "
              f"{seconds:.3f} s) against {slice_rate:.3f} unanchored (phase 3; "
              f"{rate / slice_rate:.3f}x), peak {peak / 2**30:.3f} GiB, sat_resid "
              f"{sat_resid[-1].tolist()}", flush=True)
    return paths, record


def phase_taylor(dev) -> tuple:
    """15(c): ``taylor_compositions: "taylor"`` at 128³ on the bench model (e
    4, K 8): one warm-up and TIMED transitions on "post" (``TAYLOR_POST``
    launches per transition, every other kernel 0) and GMM warm-up, one
    warm-up and TIMED VI steps on "pre" (``TAYLOR_PRE``); finite losses,
    rates and peaks.  Returns ``(paths, record)``."""
    from ir_sgmcmc_tpu_torch.engine import gmm_warmup, make_mcmc_chunk, make_vi_chunk, make_vi_step

    svf = {"taylor_compositions": "taylor"}
    bundle, fixed, moving, opt_gmm, opt_reg = _problem(DIMS, dev, **svf)
    tr = bundle.transformation
    if (tr.composition_form, tr.no_compositions, tr.no_image_compositions) != ("taylor", 16, 8):
        raise AssertionError(f"taylor: plan {tr.composition_form} N {tr.no_compositions} "
                             f"K {tr.no_image_compositions}")

    def chunk(k):
        return make_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-5, fixed, moving, chunk=k,
                               burn_in=0, thin=1)

    state, _ = chunk(1)(_init(bundle, opt_gmm, opt_reg, dev))
    state, metrics, seconds, mcmc_launches, peak = _timed_run(chunk(TIMED), state, TIMED,
                                                              "taylor mcmc", {})
    _check_launches(mcmc_launches, _expected(TAYLOR_POST, TIMED), "taylor mcmc")
    vb, vfixed, vmoving, (oq, og, orr), vstate = _vi_problem(DIMS, dev, "pre", **svf)
    step = make_vi_step(vb, oq, og, orr, vfixed, vmoving)
    vstate, _ = make_vi_chunk(step, 1)(gmm_warmup(vb, og, vstate, vfixed, vmoving))
    vstate, vmetrics, vseconds, vi_launches, vpeak = _timed_run(
        make_vi_chunk(step, TIMED), vstate, TIMED, "taylor vi", {})
    _check_launches(vi_launches, _expected(TAYLOR_PRE, TIMED), "taylor vi")
    for name, m in (("data_term", metrics), ("reg_term", metrics), ("total_loss", vmetrics)):
        if not torch.isfinite(m[name]).all():
            raise AssertionError(f"taylor: non-finite {name}: {m[name]}")
    record = {"mcmc_samples_per_sec": CHAINS * TIMED / seconds, "mcmc_peak_bytes": peak,
              "vi_iters_per_sec": TIMED / vseconds, "vi_peak_bytes": vpeak,
              "mcmc_last": {k: metrics[k][-1].tolist() for k in ("data_term", "ndv", "sat")},
              "vi_last": {k: vmetrics[k][-1].tolist() for k in ("total_loss", "ndv", "sat")}}
    print(f"taylor: 'taylor' compositions at {DIMS}: MCMC ('post') "
          f"{record['mcmc_samples_per_sec']:.3f} samples/sec, peak {peak / 2**30:.3f} GiB; VI "
          f"('pre') {record['vi_iters_per_sec']:.3f} iters/sec, peak {vpeak / 2**30:.3f} GiB",
          flush=True)
    return {"taylor_mcmc": mcmc_launches, "taylor_vi": vi_launches}, record


def phase_anchor_trainer(dev) -> tuple:
    """15(d): the demo config through the CLI in-process at 128³ with
    ``mcmc_anchor: true``, phase 7's cuts: no crash, the one-device summary
    keys, and a saturation warning or abort, where one comes, naming
    ``anchor_radius``.  Dice is printed, not held (anchored MCMC is a
    negative result of the JAX package).  Returns ``(paths, record)``."""
    import logging

    class Seen(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.messages = []

        def emit(self, rec):
            self.messages.append(rec.getMessage())

    seen = Seen()
    log = logging.getLogger()  # the trainer's logger propagates here (its own handlers
    log.addHandler(seen)       # are replaced when the CLI builds its config)
    methods = {"VI": "_run_vi_phase", "VI test": "_test_vi", "MCMC": "_run_mcmc_phase"}
    try:
        with _cli_run("anchor_trainer", "configs/demo/config_synthetic.json",
                      ("trainer;mcmc_anchor=true",), methods, judge=False) as r:
            s, t = r["summaries"][0], r["trainer"]
    finally:
        log.removeHandler(seen)
    if not t.mcmc_anchor:
        raise AssertionError("anchor_trainer: mcmc_anchor is off")
    keys = ["pair", "dsc_before", "vi_time_s", "vi_test_mean_dsc", "vi_samples_per_sec",
            "mcmc_time_s"] + (["mcmc_aborted"] if "mcmc_aborted" in s
                              else ["mcmc_mean_dsc", "mcmc_samples_per_sec"])
    missing = [k for k in keys if k not in s]
    if missing:
        raise AssertionError(f"anchor_trainer: summary {s} lacks {missing}")
    sat = [m for m in seen.messages + [s.get("mcmc_aborted", "")]
           if "saturates" in m and m.startswith("MCMC")]
    if any("anchor_radius" not in m for m in sat):
        raise AssertionError(f"anchor_trainer: a saturation message without anchor_radius: "
                             f"{sat}")
    record = {"summary": s, "wall_s": r["wall_s"], "saturation_messages": sat,
              "phase_s": {name: p["s"] for name, p in r["phases"].items()},
              "peak_bytes": r["peak_bytes"]}
    print(f"anchor_trainer: {json.dumps(record, default=float)}", flush=True)
    return {"anchor_trainer": r["launches"]}, record


# 15(e): (option, scheme, the problem's integrator options, anchor mode or
# None, the sharded step's launches per step, per re-anchoring) on each shard
ANCHOR_SPATIAL = (
    ("anchor_taylor", "post", {}, "taylor", ANCHOR_PER_STEP["taylor"], ANCHOR_PER_ANCHOR),
    ("anchor_blend", "post", {}, "blend", ANCHOR_PER_STEP["blend"], ANCHOR_PER_ANCHOR),
    ("taylor_post", "post", {"taylor_compositions": "taylor"}, None, TAYLOR_POST, {}),
    ("taylor_pre", "pre", {"taylor_compositions": "taylor"}, None, TAYLOR_PRE, {}),
)


def phase_anchor_spatial(devices, tag: str = "anchor_spatial") -> tuple:
    """15(e): phase 13(e)'s pattern for anchored MCMC (both modes) and the
    "taylor" compositions (MCMC on "post", VI on "pre") at 128³ on
    ``devices`` (virtual shards) against the unsharded step on the first:
    one warm-up and TIMED steps each, the launches asserted on both (the
    sharded ones per shard in the z-halo modes, with each row's
    re-anchorings), the checks of 13(a)-(b), both rates and each card's
    peak.  Returns ``(paths, record)``."""
    from ir_sgmcmc_tpu_torch.engine import gmm_warmup, make_mcmc_chunk, make_vi_chunk, make_vi_step
    from ir_sgmcmc_tpu_torch.parallel import (gather, make_mesh, shard_images_spatial,
                                              shard_state_spatial, shard_tree_spatial)

    dev, n, depth = devices[0], len(devices), DIMS[0]
    record, paths = {}, {}
    for option, scheme, svf, mode, per_step, per_anchor in ANCHOR_SPATIAL:
        what = f"{tag} {option}"
        anchors = 0 if mode is None else -(-TIMED // ANCHOR_PERIOD)
        plain_exp = _expected(per_step, TIMED, anchors, per_anchor)
        sharded_exp = _expected(per_step, TIMED, anchors, per_anchor, n, zhalo=True)
        if scheme == "post":
            mesh = make_mesh((1, n), axes=("chain", "space"), devices=devices)
            bundle, fixed, moving, opt_gmm, opt_reg = _problem(DIMS, dev, scheme, **svf)
            fixed_s, moving_s = (shard_images_spatial(x, mesh, depth) for x in (fixed, moving))
            kw = ({} if mode is None else
                  dict(anchored=True, anchor_radius=ANCHOR_RADIUS, anchor_mode=mode,
                       anchor_period=ANCHOR_PERIOD))

            def chunk(k, sharded=False):
                return make_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-5,
                                       fixed_s if sharded else fixed,
                                       moving_s if sharded else moving, chunk=k, burn_in=0,
                                       thin=1, **kw)

            state, _ = chunk(1)(_init(bundle, opt_gmm, opt_reg, dev))
            shards = shard_state_spatial(state, mesh, CHAINS, depth)
            chunk(1, True)(shards)  # warm-up of the sharded path (dropped)
            plain, m_plain, t_plain, plain_launches, peak_plain = _timed_on(
                [dev], chunk(TIMED), state, TIMED, f"{what} unsharded", {})
            out, m_sh, t_sh, launches, peak_sh = _timed_on(
                devices, chunk(TIMED, True), shards, TIMED, f"{what} sharded", {})
            whole = gather(out)
            checks = _close(what, {
                "v": (whole.v, plain.v), "welford mean": (whole.welford.mean, plain.welford.mean),
                "data_term": (m_sh["data_term"], m_plain["data_term"])})
            for k in ("sat", "sat_resid"):
                if not torch.equal(m_sh[k], m_plain[k]):
                    raise AssertionError(f"{what}: {k} {m_sh[k]} sharded, {m_plain[k]} not")
            rates = {"unsharded": CHAINS * TIMED / t_plain, "sharded": CHAINS * TIMED / t_sh}
            unit = "samples/sec"
        else:
            vmesh = make_mesh((n,), axes=("space",), devices=devices)
            vb, vfixed, vmoving, (oq, og, orr), vstate = _vi_problem(DIMS, dev, scheme, **svf)
            step = make_vi_step(vb, oq, og, orr, vfixed, vmoving)
            step_s = make_vi_step(vb, oq, og, orr, *(shard_images_spatial(x, vmesh, depth)
                                                    for x in (vfixed, vmoving)))
            vstate, _ = make_vi_chunk(step, 1)(gmm_warmup(vb, og, vstate, vfixed, vmoving))
            vshards = shard_tree_spatial(vstate, vmesh, depth)
            make_vi_chunk(step_s, 1)(vshards)  # warm-up, dropped
            _, m_plain, t_plain, plain_launches, peak_plain = _timed_on(
                [dev], make_vi_chunk(step, TIMED), vstate, TIMED, f"{what} unsharded", {})
            _, m_sh, t_sh, launches, peak_sh = _timed_on(
                devices, make_vi_chunk(step_s, TIMED), vshards, TIMED, f"{what} sharded", {})
            m_u = make_vi_chunk(step, 1)(vstate)[0].opt_q_v.mu
            m_s = gather(make_vi_chunk(step_s, 1)(vshards)[0]).opt_q_v.mu
            checks = {}
            for name in ("mu", "log_var", "u"):
                scale = float(m_u[name].abs().max())
                checks[f"first moment {name}"] = {
                    "max_abs_err": _err(m_s[name], m_u[name], VI_MOMENT_REL * scale, 0.0,
                                        f"{what} first moment {name}"),
                    "bitwise": torch.equal(m_s[name], m_u[name]), "max_abs": scale}
            checks["total_loss"] = {
                "max_abs_err": _err(m_sh["total_loss"], m_plain["total_loss"], 0.0, 1e-4,
                                    f"{what} total_loss"),
                "bitwise": torch.equal(m_sh["total_loss"], m_plain["total_loss"])}
            rates = {"unsharded": TIMED / t_plain, "sharded": TIMED / t_sh}
            unit = "iters/sec"
        _check_launches(plain_launches, plain_exp, f"{what} unsharded")
        _check_launches(launches, sharded_exp, f"{what} sharded")
        record[option] = {"checks": checks, unit.replace("/", "_per_"): rates,
                          "peak_bytes": {"unsharded": peak_plain, "sharded_per_card": peak_sh},
                          "launches": {k: v for k, v in launches.items() if v}}
        paths[f"{tag}_{option}"] = launches
        print(f"{what}: over {n} shards {rates['sharded']:.3f} {unit} against "
              f"{rates['unsharded']:.3f} unsharded ({rates['sharded'] / rates['unsharded']:.3f}x);"
              f" peak {max(peak_sh.values()) / 2**30:.3f} GiB per card, unsharded "
              f"{max(peak_plain.values()) / 2**30:.3f} GiB", flush=True)
        _sync_all()
    return paths, record


def _to_tree(x, device, dtype=None):
    """Tensors of a nested dict / named tuple on ``device``; floating ones
    also cast to ``dtype`` when given."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype if dtype is not None and x.is_floating_point()
                    else x.dtype)
    if isinstance(x, dict):
        return {k: _to_tree(v, device, dtype) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_tree(v, device, dtype) for v in x))
    return x


def _to(state, device, dtype=None):
    """A chain or VI state on ``device`` (the host-side key and step stay)."""
    return state._replace(**{f: _to_tree(getattr(state, f), device, dtype)
                             for f in state._fields if f not in ("key", "step")})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    if not (Path(__file__).resolve().parent / "ir_sgmcmc_tpu_torch").is_dir():
        print("chip_smoke: no ir_sgmcmc_tpu_torch package beside this script; run it "
              "from the root of the repository", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ir_sgmcmc_tpu_torch.kernels import _lib

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = _smi()
    print(f"device: {kind} ({smi}), torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    _lib.load_library()
    print(f"build: {_lib.build_seconds:.2f} s (nvcc, sm_90a) -> {_lib.BUILD_DIR}",
          flush=True)
    log = _lib.BUILD_DIR / "nvcc.log"
    for ln in _lib.ptxas_summary(log.read_text()) if log.exists() else []:
        print(f"ptxas: {ln}", flush=True)

    rows = (phase_kernels(dev) + phase_blend_kernels(dev) + phase_zhalo_kernels(dev)
            + phase_spatial_kernels(dev) + phase_anchor_kernels(dev))
    paths = {}
    paths["mcmc"], slice_rate = phase_slice(dev)
    phase_reference(dev)
    paths["vi"] = phase_vi(dev)
    phase_vi_reference(dev)
    trainer_rec = phase_trainer(dev)
    paths["trainer"] = trainer_rec["launches"]
    paths.update(phase_svffd(dev))
    for cps in (SVFFD_CPS, 4):
        phase_reference(dev, cps)
        phase_vi_reference(dev, cps)
    phase_vi_remat(dev)
    paths["svffd_trainer"] = phase_trainer(
        dev, SVFFD_OVERRIDES, "configs/experiment5/config_SVFFD_2.json",
        "svffd_trainer")["launches"]
    paths.update(phase_pairs(dev, slice_rate))
    phase_pairs_reference(dev)
    pairs_rec = phase_pairs_trainer(dev)
    paths["pairs_trainer"] = pairs_rec["launches"]
    phase_selftest(dev)
    phase_phantom(dev)
    paths["quality"] = phase_quality(dev, QUALITY_ARGS, "quality")
    paths["quality_brain"] = phase_quality(dev, QUALITY_BRAIN_ARGS, "quality_brain")
    rows += phase_bf16_kernels(dev)
    paths.update(phase_bf16(dev, slice_rate))
    phase_bf16_reference(dev)
    paths["halo"] = phase_halo([dev] * HALO_SHARDS)
    paths["chain_mesh"] = phase_chain_mesh([dev] * CHAINS)
    paths.update(phase_distributed_trainer(dev, trainer_rec, pairs_rec))
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        paths.update(phase_multi_card(n_cards, trainer_rec))
    else:
        print("multi_card: one card: 12(d) (the selftest on every card, 12(a)-(b) and the demo "
              "config on two real cards) not run", flush=True)
    paths.update(phase_spatial([dev] * SPATIAL_SHARDS))
    paths.update(phase_spatial_options([dev] * SPATIAL_SHARDS))
    paths.update(phase_spatial_trainer([dev] * SPATIAL_SHARDS, trainer_rec))
    if n_cards >= 2:
        paths.update(phase_spatial_cards(n_cards, trainer_rec))
    else:
        print("spatial_cards: one card: 13(d) (the spatial steps and the demo config over real "
              "cards) not run", flush=True)
    phase_bench_canonical(dev)
    phase_bench_kernels(dev)
    paths.update(phase_bench(dev))
    t15, p15 = time.perf_counter(), {}
    anchor_paths, p15["anchor"] = phase_anchor(dev, slice_rate)
    paths.update(anchor_paths)
    for mode in ("taylor", "blend"):
        phase_reference(dev, anchor_mode=mode)
    taylor_paths, p15["taylor"] = phase_taylor(dev)
    paths.update(taylor_paths)
    phase_reference(dev, taylor_compositions="taylor")
    phase_vi_reference(dev, taylor_compositions="taylor")
    trainer_paths, p15["anchor_trainer"] = phase_anchor_trainer(dev)
    paths.update(trainer_paths)
    spatial_paths, p15["spatial"] = phase_anchor_spatial([dev] * SPATIAL_SHARDS)
    paths.update(spatial_paths)
    p15["wall_s"] = time.perf_counter() - t15
    print(f"phase_15: {json.dumps(p15, default=float)}", flush=True)

    kernels = []
    for r in rows:
        k = r["kernel"]
        bound, by = _bound(r)
        # B3/B4 have a row per radius: R 3 counts the SVFFD paths' launches
        # (block radius 3), R 2 the others'; B5/B6 too: R 2 counts the
        # anchored "blend" paths' (the anchor radius), R 1 the others'; every
        # other kernel every path's
        per_radius = r["radius"] is not None and not k.z_halo
        if k.symbol in ("warp_bounded_fwd", "warp_bounded_dgrad"):
            anchored = r["radius"] == ANCHOR_RADIUS
            on = [p for name, p in paths.items() if ("anchor_blend" in name) == anchored]
            name = f"{k.symbol}_r{ANCHOR_RADIUS}" if anchored else k.symbol
        else:
            on = [p for name, p in paths.items()
                  if not per_radius or (r["radius"] == SVFFD_RADIUS) == name.startswith("svffd")]
            name = (k.symbol if not per_radius or r["radius"] == 2
                    else f"{k.symbol}_r{r['radius']}")
        kernels.append({"name": name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces,
                        "launches": sum(p[k.symbol] for p in on),
                        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": bound, "bound_by": by, "library_ms": r["library_ms"]})
    unlaunched = [r["name"] for r in kernels if r["launches"] == 0]
    if unlaunched:
        raise AssertionError(f"kernels never launched on a main path: {unlaunched}")
    if not all(math.isfinite(r["ms"]) for r in kernels):
        raise AssertionError("kernel timing failed")
    print(f"smoke: all phases in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
