#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``ir_sgmcmc_tpu_torch``) on one card.

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
   and z-chunks of B5-B7, and dims of 1 and 2 at radius 3), with the
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
   neighbour rows, concatenate to the unsharded B5 and B6 outputs;
3. the SG-MCMC path: one SGLD transition over 2 chains at 128³ (the
   ``bench.py`` configuration, "post" noise), 1 warm-up and 10 timed
   transitions through ``init_chains`` -> ``make_mcmc_chunk``; the launch
   counters must move by exactly B1 7, B2 7, B3 1, B4 1 per transition;
   then 5 more transitions under ``torch.profiler``, printed as device
   kernel time by kind (the hand-written kernels by name: B3 as
   ``fwd_window_kernel<2>``);
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
   wall time and launches (GMM warm-up, VI, VI test, MCMC), the trainer's
   own host-time breakdown (``Trainer.timings``) and the peak memory;
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
   free memory).

Each path's counters are set to 0 just before its timed run (the
trainer's: its whole CLI run) and read just after.  Then one JSON line of
kernel results (B3 and B4 once per radius: ``block_warp_fwd`` at R 2 with
the dense paths' launches, ``block_warp_fwd_r3`` at R 3 with the SVFFD
paths'; the z-halo modes with 0 launches: their only callers, the
spatially sharded steps, need several devices), the ``nvidia-smi``
name/power line, and the final status line.  Imports nothing of JAX.
Exits non-zero, with no result, when CUDA is unavailable.  TF32 is off for
matmuls and cuDNN.
"""

from __future__ import annotations

import contextlib
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


def _bundle(dims, noise_scheme="post", cps=None):
    """``bench.py``'s model; with ``cps``, ``bench.py --model svffd``'s
    (the experiment-5 SVFFD model on a control grid of spacing ``cps``,
    Sobolev s 2, block radius 3)."""
    from ir_sgmcmc_tpu_torch.engine import ModelBundle
    from ir_sgmcmc_tpu_torch.models import (GMM, SVF3D, SVFFD3D, DirichletPrior,
                                            LogEnergyExpGammaPrior,
                                            LogScaleNormalPrior, RegLossLogNormal)

    dof = 3.0 * dims[0] * dims[1] * dims[2]
    if cps is not None:
        model = dict(transformation=SVFFD3D(dims, (cps,) * 3, no_steps=12), sobolev_s=2,
                     block_radius=SVFFD_RADIUS)
    else:
        model = dict(transformation=SVF3D(dims, no_steps=12), sobolev_s=3)
    return ModelBundle(
        dims=dims, gmm=GMM(4, 1),
        scale_prior=LogScaleNormalPrior(0.0, 2.3),
        proportion_prior=DirichletPrior(4, 0.5),
        reg_loss=RegLossLogNormal(w_reg=1.4, dims=dims, learnable=True),
        reg_loc_prior=LogEnergyExpGammaPrior(w_reg=1.4, dof=dof),
        reg_scale_prior=LogScaleNormalPrior(loc=2.8, scale=5.0),
        sobolev_lambda=0.5, uniform_noise_alpha=0.1,
        noise_scheme=noise_scheme, virtual_decimation=True, **model)


def _problem(dims, device, noise_scheme="post", cps=None):
    from ir_sgmcmc_tpu_torch.data import sphere_pair
    from ir_sgmcmc_tpu_torch.optim import adam_decay

    bundle = _bundle(dims, noise_scheme, cps)
    fixed, moving = sphere_pair(dims, offset=(0.0, 0.0, 4.0))
    fixed = {k: torch.as_tensor(v, device=device) for k, v in fixed.items()}
    moving = {k: torch.as_tensor(v, device=device) for k, v in moving.items()}
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


def _row(kernel, shape, err, atol, rtol, ms, plain_ms, library_ms=None, radius=None) -> dict:
    return {"kernel": kernel, "shape": shape, "err": err, "atol": atol, "rtol": rtol,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "radius": radius}


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


def _split_operands(gen, shape, slab=None):
    """d, u, g for B1/B2; no exact ties at u = 0 or |u| = 1, where autograd
    of the plain step and the kernel take different (equally valid)
    subgradients.  ``slab``: z-planes where u is saturated beyond ±1."""
    dev = gen.device
    d = torch.randn(shape, generator=gen, device=dev) * 2.0
    u = torch.randn(shape, generator=gen, device=dev) * 0.9
    u = torch.where(u.abs() == 1, u * 1.001, u)
    u = torch.where(u == 0, torch.full_like(u, 1e-3), u)
    if slab is not None:
        z = slice(*slab)
        u[:, :, z] = torch.where(u[:, :, z] < 0, -1.5, 1.5) + u[:, :, z]
    return d, u, torch.randn(shape, generator=gen, device=dev)


SPLIT_SHAPES = (((CHAINS, 3) + DIMS, None), ((1, 3, 2, 9, 33), None),
                ((2, 3, 40, 24, 130), (14, 19)))

# (shape, bound, radius) of the block warp: the dense path's (bound 9, R 2,
# block 8), ragged shapes whose dims divide by 8 but are neither cubes nor
# multiples of the window kernels' 32-wide tile, and the SVFFD path's
# (bound 9, R 3); all four take B3's and B4's window kernels
# (fwd_window_kernel<R>, dgrad_window_kernel<R>)
BLOCK_SHAPES = (((CHAINS, 1) + DIMS, 9, 2), ((1, 4, 16, 24, 136), 6, 1), ((2, 2, 24, 8, 40), 9, 2),
                ((CHAINS, 1) + DIMS, 9, SVFFD_RADIUS))


def _block_operands(gen, shape, bound, radius, saturate=False, block=8):
    """vol, r, m, g for B3/B4: a smooth displacement (trilinear upsampling
    of a coarse random field), its block means and clipped residual, every
    7th residual an integer.  ``saturate``: the blocks next to the z and x
    borders get means of ±bound, whose windows clamp at the border; the
    field gets in-block roughness, and every 11th residual is exactly +R,
    every 13th -R."""
    from ir_sgmcmc_tpu_torch.kernels import block_warp as bw
    from ir_sgmcmc_tpu_torch.ops.resample import _block_means

    dev = gen.device
    B, C, D, H, W = shape
    vol = torch.randn(shape, generator=gen, device=dev)
    coarse = torch.randn((B, 3, 3, 3, 3), generator=gen, device=dev) * (bound - 1.0)
    disp = torch.nn.functional.interpolate(coarse, size=(D, H, W), mode="trilinear",
                                           align_corners=True)
    disp = disp.clamp(-(bound - 0.5), bound - 0.5)
    if saturate:
        disp[:, :, :block] = bound + 0.4
        disp[:, :, -block:] = -bound - 0.4
        disp[..., -block:] = torch.where(disp[..., -block:] < 0, -bound - 0.4, bound + 0.4)
        disp += torch.randn(disp.shape, generator=gen, device=dev) * 0.8
    m = _block_means(disp, block, bound)
    r = (disp - bw._expand_blocks(m, block).float()).clamp(-radius, radius)
    flat = r.view(-1)
    flat[::7] = torch.round(flat[::7])
    if saturate:
        flat[1::11] = radius
        flat[2::13] = -radius
    return vol, r.contiguous(), m, torch.randn(shape, generator=gen, device=dev)


def phase_kernels(dev) -> list:
    """B1-B4 against their plain versions at the main path's shapes and at
    ragged ones; B3/B4 against their library calls."""
    from ir_sgmcmc_tpu_torch.kernels import block_warp as bw
    from ir_sgmcmc_tpu_torch.kernels import split_warp as sw

    gen = torch.Generator(device=dev).manual_seed(1234)
    errs = {sw.B1: 0.0, sw.B2: 0.0}
    for shape, slab in SPLIT_SHAPES:
        d, u, g = _split_operands(gen, shape, slab)
        errs[sw.B1] = max(errs[sw.B1], _err(sw.split_warp_fwd_cuda(d, u),
                                            sw.split_compose_plain(d, u),
                                            2e-5, 0.0, f"B1 {shape}"))
        gd_k, gu_k = sw.split_warp_bwd_cuda(d, u, g)
        gd_p, gu_p = sw.split_compose_vjp_plain(d, u, g)
        errs[sw.B2] = max(errs[sw.B2], _err(gd_k, gd_p, 3e-5, 1e-4, f"B2 gd {shape}"),
                          _err(gu_k + g, gu_p, 3e-5, 1e-4, f"B2 gu {shape}", u=u, d=d))
        if slab is not None and bool(gu_k[:, :, slice(*slab)].any()):
            raise AssertionError(f"B2 {shape}: offset gradient where |u| > 1")
        if shape[2:] == DIMS:  # timed at the main path's shape
            times = {sw.B1: (_time_ms(lambda: sw.split_warp_fwd_cuda(d, u)),
                             _time_ms(lambda: sw.split_compose_plain(d, u))),
                     sw.B2: (_time_ms(lambda: sw.split_warp_bwd_cuda(d, u, g)),
                             _time_ms(lambda: sw.split_compose_vjp_plain(d, u, g)))}
    rows = [_row(sw.B1, SPLIT_SHAPES[0][0], errs[sw.B1], 2e-5, 0.0, *times[sw.B1]),
            _row(sw.B2, SPLIT_SHAPES[0][0], errs[sw.B2], 3e-5, 1e-4, *times[sw.B2])]

    errs = {bw.B3: 0.0, bw.B4: 0.0}
    tol = {bw.B3: (1e-5, 0.0), bw.B4: (5e-4, 1e-4)}
    for shape, bound, radius in BLOCK_SHAPES:
        main = shape == (CHAINS, 1) + DIMS
        vol, r, m, gv = _block_operands(gen, shape, bound, radius, saturate=not main)
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
        bound, by = k.bound_ms(r["shape"], r["radius"] or 0)
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        at_r = "" if r["radius"] is None else f" R {r['radius']}"
        print(f"kernel {k.symbol} {tuple(r['shape'])}{at_r}: max_abs_err {r['err']:.3e} (atol "
              f"{r['atol']}, rtol {r['rtol']}) kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {bound:.4f} ms ({by}; "
              f"{100 * bound / r['ms']:.1f}% of it), library {lib}", flush=True)


def _bounded_operands(gen, shape, R):
    """vol, disp, g for the bounded warp: ``disp`` uniform in ±1.4R with
    every 7th value an integer, every 11th exactly +R and every 13th -R."""
    dev = gen.device
    B, C = shape[:2]
    vol = torch.randn(shape, generator=gen, device=dev)
    disp = (torch.rand((B, 3) + shape[2:], generator=gen, device=dev) * 2 - 1) * (1.4 * R)
    flat = disp.view(-1)
    flat[::7] = torch.round(flat[::7])
    flat[1::11] = float(R)
    flat[2::13] = -float(R)
    return vol, disp, torch.randn(shape, generator=gen, device=dev)


BOUNDED_SHAPES = (((CHAINS, 1) + DIMS, 1), ((CHAINS, 4) + SMALL, 2), ((2, 1, 40, 24, 130), 1),
                  ((1, 2, 17, 10, 70), 2), ((1, 3, 2, 1, 9), 3))


def phase_blend_kernels(dev) -> list:
    """B5-B7 against their plain versions on the card: at the VI path's
    ``(2, 1, 128³)``, R 1 (timed), a general ``(2, 4, 64³)``, R 2, two
    shapes that straddle B6's and B7's 32 x 8 tiles and 16-plane z-chunks,
    and dims of 1 and 2 at R 3.

    The kernels and the plain versions evaluate ``tri`` and ``dtri`` by
    the same expressions at the same points, so no tie (integer ``d``,
    ``|d| = R``) needs avoiding: both take the zero subgradient there.
    Tolerance atol 1e-5 (the JAX suite's for these kernels) plus rtol 1e-5
    for the sums of up to 27·C products at C = 4."""
    from ir_sgmcmc_tpu_torch.kernels import warp_bounded as wb

    gen = torch.Generator(device=dev).manual_seed(4321)
    atol, rtol = 1e-5, 1e-5
    errs = {wb.B5: 0.0, wb.B6: 0.0, wb.B7: 0.0}
    timed = {}
    for shape, R in BOUNDED_SHAPES:
        main = shape == BOUNDED_SHAPES[0][0]
        vol, disp, g = _bounded_operands(gen, shape, R)
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


# (output shape, radius) of the z-halo modes; the vol is 2R planes deeper:
# the ring kernels at R 1 (timed) and at a ragged 4-channel R 2, the
# per-voxel kernels at R 4
ZHALO_SHAPES = (((CHAINS, 1) + DIMS, 1), ((1, 4, 17, 10, 70), 2), ((1, 2, 9, 12, 40), 4))
ZHALO_SLABS = 4


def _zhalo_grid(disp, R: int):
    """``grid_sample``'s normalised points in a z-haloed vol ``(D + 2R, H,
    W)`` at identity + ``clip(disp, ±R)``, z shifted by the halo."""
    B, _, D, H, W = disp.shape
    d = disp.clamp(-R, R)
    z, y, x = torch.meshgrid(*(torch.arange(n, device=disp.device, dtype=torch.float32)
                               for n in (D, H, W)), indexing="ij")
    return torch.stack([(x + d[:, 0]) * (2.0 / (W - 1)) - 1.0,
                        (y + d[:, 1]) * (2.0 / (H - 1)) - 1.0,
                        (z + R + d[:, 2]) * (2.0 / (D + 2 * R - 1)) - 1.0], dim=-1)


def phase_zhalo_kernels(dev) -> list:
    """The z-halo modes of B5 and B6 (vol ``2R`` planes deeper than disp,
    no z clamp) against their plain versions at ``ZHALO_SHAPES``, with the
    tolerance of the default mode; timed, bounded and held to the library
    calls at ``(2, 1, 128³)`` R 1.  Then the slab identity that the JAX
    package's sharded steps rely on (``parallel/halo.py``): the z-halo
    outputs of 4 z-slabs of a 128³ volume, each given its real neighbour
    rows (edge rows at the two ends), concatenate to the unsharded B5 and
    B6 outputs."""
    from ir_sgmcmc_tpu_torch.kernels import warp_bounded as wb

    gen = torch.Generator(device=dev).manual_seed(5678)
    atol, rtol = 1e-5, 1e-5
    errs = {wb.B5Z: 0.0, wb.B6Z: 0.0}
    timed = {}
    for shape, R in ZHALO_SHAPES:
        B, C, D, H, W = shape
        _, disp, g = _bounded_operands(gen, shape, R)
        vol = torch.randn((B, C, D + 2 * R, H, W), generator=gen, device=dev)
        calls = {
            wb.B5Z: (lambda: wb.warp_bounded_fwd_cuda(vol, disp, R, z_halo=True),
                     lambda: wb.warp_bounded_plain(vol, disp, R, z_halo=True)),
            wb.B6Z: (lambda: wb.warp_bounded_dgrad_cuda(vol, disp, g, R, z_halo=True),
                     lambda: wb.warp_bounded_dgrad_plain(vol, disp, g, R, z_halo=True)),
        }
        for k, (kern, plain) in calls.items():
            errs[k] = max(errs[k], _err(kern(), plain(), atol, rtol, f"{k.symbol} {shape} R {R}"))
        if shape != ZHALO_SHAPES[0][0]:
            continue
        grid = _zhalo_grid(disp, R)
        at = disp.clamp(-R, R)
        scale = torch.tensor([2.0 / (W - 1), 2.0 / (H - 1), 2.0 / (D + 2 * R - 1)], device=dev)
        library = {
            wb.B5Z: (lambda: _grid_sample(vol, grid), None),
            wb.B6Z: (lambda: (_grid_sample_grads(g, vol, grid, [False, True])[1] * scale
                              ).permute(0, 4, 1, 2, 3).contiguous(), _off_ties(at)),
        }
        for k, (kern, plain) in calls.items():
            call, mask = library[k]
            timed[k] = (shape, _time_ms(kern), _time_ms(plain),
                        _library_ms(k.symbol, call, kern(), mask))
    rows = [_row(k, timed[k][0], errs[k], atol, rtol, *timed[k][1:], radius=ZHALO_SHAPES[0][1])
            for k in (wb.B5Z, wb.B6Z)]
    _print_rows(rows)

    # the slab identity at 128³, R 1 and 2
    for R in (1, 2):
        vol, disp, g = _bounded_operands(gen, (CHAINS, 1) + DIMS, R)
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


# launches per transition, and per VI step on "post", of the dense and SVFFD
# models alike: the integration's 7 split compositions forward and backward
# and one block-gather warp
POST_PER_STEP = {"split_warp_fwd": 7, "split_warp_bwd": 7, "block_warp_fwd": 1,
                  "block_warp_dgrad": 1, "warp_bounded_fwd": 0, "warp_bounded_dgrad": 0,
                  "warp_bounded_tblend": 0, "warp_bounded_fwd_zhalo": 0,
                  "warp_bounded_dgrad_zhalo": 0}
# the z-halo modes' only callers are the JAX package's spatially sharded
# steps, which one card does not run: no path of this script launches them
ZHALO = ("warp_bounded_fwd_zhalo", "warp_bounded_dgrad_zhalo")


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


def phase_reference(dev, cps=None) -> None:
    """One 64³ transition with fixed noise: card (kernels) vs CPU (plain);
    with ``cps``, of the SVFFD model (the state on its control grid).

    The GMM starts as the trainer's warm-up leaves it (spread scales,
    unequal logits): with all components identical the logits gradient is
    exactly zero and Adam would turn its rounding noise into a full step.
    Tolerances as in tests/test_torch_engine.py: loss terms 1e-4 relative;
    σ²∇U (read back from v_next) within 1e-3 RMS of its RMS above the
    ulp floor of v' / tau, and no element off by 2% of its maximum.
    """
    from ir_sgmcmc_tpu_torch.engine import make_sgld_transition
    from ir_sgmcmc_tpu_torch.models.sampler import langevin_noise

    tau = 1e-5
    results = {}
    rng = np.random.default_rng(7)
    eps_np = rng.standard_normal((CHAINS, 3) + _field_dims(SMALL, cps)).astype(np.float32)
    unif_np = rng.uniform(-0.1, 0.1, (CHAINS, 3) + SMALL).astype(np.float32)
    for device in (torch.device("cpu"), dev):
        bundle, fixed, moving, opt_gmm, opt_reg = _problem(SMALL, device, cps=cps)
        state = _init(bundle, opt_gmm, opt_reg, torch.device("cpu"))
        gmm = bundle.gmm.init_scales_from_residual_std(bundle.gmm.init_params("cpu"), 1.0)
        gmm["logits"] = torch.tensor([0.3, -0.2, 0.1, -0.4])
        state = _to(state._replace(gmm={k: t.expand(CHAINS, -1).clone()
                                        for k, t in gmm.items()}), device)
        eps = torch.as_tensor(eps_np, device=device)
        unif = torch.as_tensor(unif_np, device=device)
        tr = make_sgld_transition(bundle, opt_gmm, opt_reg, tau, fixed, moving)
        new, met = tr(state, 1.0, noise=(eps, unif))
        v_noised = state.v + langevin_noise(None, state.sigma, tau, eps)
        results[device.type] = {
            "q": ((v_noised - new.v) / tau).cpu(),
            "floor": 8 * float(torch.finfo(torch.float32).eps
                               * v_noised.abs().max()) / tau,
            **{k: met[k].cpu() for k in ("data_term", "reg_term", "vd_alpha",
                                         "ndv", "sat", "sat_resid")}}
    cpu, gpu = results["cpu"], results["cuda"]
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
    print(f"reference: 64³ transition{what}, card vs CPU agree: loss terms within 1e-4, "
          f"σ²∇U RMS error {rms:.3e} (RMS {rms_q:.3e}), max abs err {err:.3e}",
          flush=True)


def _vi_problem(dims, device, scheme="pre", cps=None):
    """``bench.py:measure_vi`` (on the "pre" scheme unless given; with
    ``cps``, the SVFFD model): the bundle, images, the experiment-1
    optimizers and the initial ``VIState``."""
    from ir_sgmcmc_tpu_torch.engine import VIState
    from ir_sgmcmc_tpu_torch.optim import adam_decay

    bundle, fixed, moving, _, opt_reg = _problem(dims, device, scheme, cps)
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
               "warp_bounded_tblend": 8, "warp_bounded_fwd_zhalo": 0,
               "warp_bounded_dgrad_zhalo": 0}


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


_KINDS = (("tblend_", "B7"), ("dgrad_tile", "B6"), ("dgrad_gather", "B6"),
          ("fwd_window", "B3"), ("fwd_tile", "B5"), ("warp_bounded_fwd", "B5"), ("split_fwd", "B1"),
          ("split_bwd", "B2"), ("block_warp_fwd", "B3"), ("dgrad_window", "B4"),
          ("block_warp_dgrad", "B4"), ("direct_copy", "copies"), ("CatArray", "copies"),
          ("Memcpy", "copies"), ("Memset", "copies"), ("reduce_kernel", "reductions"),
          ("gemm", "matmul"), ("xmma", "matmul"), ("elementwise", "elementwise"))


def _profile(run, state, steps: int, what: str) -> None:
    """Device kernel time per step by kind over one run of ``steps`` steps
    (device events only: the host-side rows would count kernels twice)."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(state)
        torch.cuda.synchronize()
    kinds, names = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        kind = next((k for pat, k in _KINDS if pat in e.key), "other")
        t, n = kinds.get(kind, (0.0, 0))
        kinds[kind] = (t + e.device_time_total, n + e.count)
        if kind.startswith("B"):  # a hand-written kernel: name it
            names.setdefault(kind, set()).update(re.findall(r"\w+_kernel(?:<[^>]*>)?", e.key))
    total = sum(t for t, _ in kinds.values())
    print(f"profile: {steps} {what}, device kernel time {total / 1e3 / steps:.3f} ms "
          f"per step over {sum(n for _, n in kinds.values()) / steps:.0f} launches",
          flush=True)
    for kind, (t, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        print(f"profile: {kind:12s} {t / 1e3 / steps:8.3f} ms per step "
              f"{100 * t / total:6.2f}% {n / steps:7.1f} launches per step "
              f"{' '.join(sorted(names.get(kind, ())))}".rstrip(), flush=True)


def phase_vi_reference(dev, cps=None) -> None:
    """One 64³ VI step with fixed draws: card (kernels) vs CPU (plain); on
    "pre", or with ``cps`` of the SVFFD model on "post" (the B3/B4 path).

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
        bundle, fixed, moving, (oq, og, orr), state = _vi_problem(SMALL, device, scheme, cps)
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
def _cli_run(tag: str, config: str, extra, phase_methods: dict):
    """The port's CLI in-process on ``config`` at 128³ (``TRAINER_OVERRIDES``
    and ``extra``), in a temporary save directory that lives as long as the
    ``with`` block.  Each trainer method of ``phase_methods`` (``{phase:
    name}``; ``"warm-up"`` is the engine's ``gmm_warmup``) is timed (with a
    device sync at its ends) and its launches counted by a wrapper that is
    removed after.  Every counter is set to 0 just before the run and read
    just after.  Yields ``{"summaries", "trainer", "wall_s", "launches",
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
                "-o", f"trainer;save_dir={json.dumps(tmp)}"]
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
        for s in summaries:
            if "mcmc_aborted" in s:
                raise AssertionError(f"{tag}: MCMC aborted: {s['mcmc_aborted']}")
            for key in ("vi_test_mean_dsc", "mcmc_mean_dsc"):
                if not (math.isfinite(s[key]) and s[key] >= s["dsc_before"] - 0.05):
                    raise AssertionError(f"{tag}: pair {s['pair']} {key} {s[key]} against "
                                         f"dsc_before {s['dsc_before']} (bar: 0.05 below it)")
        bad = [sym for sym, n in launches.items()
               if (n == 0) != (sym in ("warp_bounded_dgrad", "warp_bounded_tblend") + ZHALO)]
        if bad:
            raise AssertionError(f"{tag}: launches {launches}: B1-B5 must run, B6/B7 and "
                                 f"the z-halo modes must not ({bad})")
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
        "host_s": t.timings, "peak_bytes": r["peak_bytes"],
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
        "launches": r["launches"], "host_s": t.timings, "peak_bytes": r["peak_bytes"],
        "pairs_per_batch": t.pair_groups,
    }
    print(f"{tag}: {json.dumps(record, default=float)}", flush=True)
    return record


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

    rows = phase_kernels(dev) + phase_blend_kernels(dev) + phase_zhalo_kernels(dev)
    paths = {}
    paths["mcmc"], slice_rate = phase_slice(dev)
    phase_reference(dev)
    paths["vi"] = phase_vi(dev)
    phase_vi_reference(dev)
    paths["trainer"] = phase_trainer(dev)["launches"]
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
    paths["pairs_trainer"] = phase_pairs_trainer(dev)["launches"]

    kernels = []
    for r in rows:
        k = r["kernel"]
        bound, by = k.bound_ms(r["shape"], r["radius"] or 0)
        # B3/B4 have a row per radius: R 3 counts the SVFFD paths' launches
        # (block radius 3), R 2 the others'; every other kernel every path's
        per_radius = r["radius"] is not None and not k.z_halo
        on = [p for name, p in paths.items()
              if not per_radius or (r["radius"] == SVFFD_RADIUS) == name.startswith("svffd")]
        name = k.symbol if not per_radius or r["radius"] == 2 else f"{k.symbol}_r{r['radius']}"
        kernels.append({"name": name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces,
                        "launches": sum(p[k.symbol] for p in on),
                        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": bound, "bound_by": by, "library_ms": r["library_ms"]})
    unlaunched = [r["name"] for r in kernels if r["launches"] == 0 and r["name"] not in ZHALO]
    if unlaunched:
        raise AssertionError(f"kernels never launched on a main path: {unlaunched}")
    print(f"zhalo: {', '.join(ZHALO)} launched "
          f"{[sum(p[z] for p in paths.values()) for z in ZHALO]} times on the paths: their "
          f"only callers, the spatially sharded steps, need several devices", flush=True)
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
