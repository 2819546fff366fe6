#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``ir_sgmcmc_tpu_torch``) on one card.

    python3 chip_smoke.py


Phases, each of which raises on failure (exit code != 0):

1. the card's name and power limit; build the CUDA kernels from
   ``ir_sgmcmc_tpu_torch/csrc`` (nvcc, sm_90a) and report the build time;
2. each kernel B1-B7 against its plain PyTorch version on the card, at the
   main paths' shapes (B1/B2 also at two ragged shapes, one with ``u``
   saturated in a z-slab; B3/B4 also at two ragged shapes with block means
   saturated at ±bound next to the borders, at R 1 and 2, all three shapes
   through B3's and B4's window kernels (block 8, R 1-3; the per-voxel
   kernels they keep for other shapes are checked by
   ``tests/test_torch_cuda.py``); B5-B7 also at a
   general 4-channel, radius-2 shape, two shapes that straddle the tiles
   and z-chunks of B5-B7, and dims of 1 and 2 at radius 3), with the
   stated tolerance; the kernel's and the plain version's times, the
   kernel's bound (``Kernel.bound_ms``: bytes over the H100
   SXM's HBM bandwidth or flops over its f32 rate, whichever is larger)
   and, for B3-B7, the time of the one PyTorch call that computes the same
   function (``F.grid_sample`` or ``aten.grid_sampler_3d_backward``),
   checked once against the kernel away from ties;
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
   own host-time breakdown (``Trainer.timings``) and the peak memory.

Each path's counters are set to 0 just before its timed run (the
trainer's: its whole CLI run) and read just after.  Then one JSON line of kernel results, the ``nvidia-smi``
name/power line, and the final status line.  Imports nothing of JAX.
Exits non-zero, with no result, when CUDA is unavailable.  TF32 is off for
matmuls and cuDNN.
"""

from __future__ import annotations

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


def _bundle(dims, noise_scheme="post"):
    from ir_sgmcmc_tpu_torch.engine import ModelBundle
    from ir_sgmcmc_tpu_torch.models import (GMM, SVF3D, DirichletPrior,
                                            LogEnergyExpGammaPrior,
                                            LogScaleNormalPrior, RegLossLogNormal)

    dof = 3.0 * dims[0] * dims[1] * dims[2]
    return ModelBundle(
        dims=dims, gmm=GMM(4, 1),
        scale_prior=LogScaleNormalPrior(0.0, 2.3),
        proportion_prior=DirichletPrior(4, 0.5),
        reg_loss=RegLossLogNormal(w_reg=1.4, dims=dims, learnable=True),
        reg_loc_prior=LogEnergyExpGammaPrior(w_reg=1.4, dof=dof),
        reg_scale_prior=LogScaleNormalPrior(loc=2.8, scale=5.0),
        transformation=SVF3D(dims, no_steps=12),
        sobolev_s=3, sobolev_lambda=0.5, uniform_noise_alpha=0.1,
        noise_scheme=noise_scheme, virtual_decimation=True)


def _problem(dims, device, noise_scheme="post"):
    from ir_sgmcmc_tpu_torch.data import sphere_pair
    from ir_sgmcmc_tpu_torch.optim import adam_decay

    bundle = _bundle(dims, noise_scheme)
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


def _row(kernel, shape, err, atol, rtol, ms, plain_ms, library_ms=None) -> dict:
    return {"kernel": kernel, "shape": shape, "err": err, "atol": atol, "rtol": rtol,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms}


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

# (shape, bound, radius) of the block warp: the path's (bound 9, R 2,
# block 8), then ragged shapes whose dims divide by 8 but are neither cubes
# nor multiples of the window kernels' 32-wide tile; all three take B3's and
# B4's window kernels (fwd_window_kernel<R>, dgrad_window_kernel<R>)
BLOCK_SHAPES = (((CHAINS, 1) + DIMS, 9, 2), ((1, 4, 16, 24, 136), 6, 1), ((2, 2, 24, 8, 40), 9, 2))


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
    for shape, bound, radius in BLOCK_SHAPES:
        vol, r, m, gv = _block_operands(gen, shape, bound, radius,
                                        saturate=shape != BLOCK_SHAPES[0][0])
        out = bw.block_warp_cuda(vol, r, m, radius)
        errs[bw.B3] = max(errs[bw.B3], _err(out, bw.block_warp_plain(vol, r, m), 1e-5, 0.0,
                                            f"B3 {shape} bound {bound} R {radius}"))
        dout = bw.block_warp_dgrad_cuda(vol, r, m, gv, radius)
        errs[bw.B4] = max(errs[bw.B4], _err(dout, bw.block_warp_dgrad_plain(vol, r, m, gv),
                                            5e-4, 1e-4, f"B4 {shape} bound {bound} R {radius}"))
        if shape != BLOCK_SHAPES[0][0]:
            continue
        # timed, and held to the library calls, at the path's shape
        at = bw._expand_blocks(m, 8).float() + r
        grid = _grid(at)
        lib3 = _library_ms("B3", lambda: _grid_sample(vol, grid), out)
        lib4 = _library_ms("B4", lambda: _grid_grad_voxels(
            _grid_sample_grads(gv, vol, grid, [False, True])[1]), dout, _off_ties(at))
        timed = [(bw.B3, _time_ms(lambda: bw.block_warp_cuda(vol, r, m, radius)),
                  _time_ms(lambda: bw.block_warp_plain(vol, r, m)), lib3),
                 (bw.B4, _time_ms(lambda: bw.block_warp_dgrad_cuda(vol, r, m, gv, radius)),
                  _time_ms(lambda: bw.block_warp_dgrad_plain(vol, r, m, gv)), lib4)]
    tol = {bw.B3: (1e-5, 0.0), bw.B4: (5e-4, 1e-4)}
    rows += [_row(k, BLOCK_SHAPES[0][0], errs[k], *tol[k], *t) for k, *t in timed]
    _print_rows(rows)
    return rows


def _print_rows(rows) -> None:
    for r in rows:
        k = r["kernel"]
        bound, by = k.bound_ms(r["shape"])
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"kernel {k.symbol} {tuple(r['shape'])}: max_abs_err {r['err']:.3e} (atol "
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


def phase_slice(dev) -> dict:
    """1 warm-up + TIMED transitions at 128³ x 2 chains on the card, then a
    profile of 5 more; returns the launch counts of the timed run."""
    from ir_sgmcmc_tpu_torch.engine import make_mcmc_chunk
    from ir_sgmcmc_tpu_torch.kernels import all_kernels

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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    state, metrics = timed(state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in kernels}
    for name in ("data_term", "reg_term", "vd_alpha"):
        if not torch.isfinite(metrics[name]).all():
            raise AssertionError(f"slice: non-finite {name}: {metrics[name]}")
    if not torch.isfinite(state.v).all():
        raise AssertionError("slice: non-finite chain state")
    expected = {"split_warp_fwd": 7, "split_warp_bwd": 7,
                "block_warp_fwd": 1, "block_warp_dgrad": 1}
    for sym, per in expected.items():
        if launches[sym] != per * TIMED:
            raise AssertionError(f"slice: {sym} launched {launches[sym]} times "
                                 f"in {TIMED} transitions, expected {per * TIMED}")
    last = {k: metrics[k][-1].tolist() for k in
            ("data_term", "reg_term", "vd_alpha", "ndv", "sat", "sat_resid")}
    rate = CHAINS * TIMED / seconds
    peak = torch.cuda.max_memory_allocated()
    print(f"slice: last transition {json.dumps(last)}", flush=True)
    print(f"slice: launches {json.dumps(launches)} over {TIMED} transitions",
          flush=True)
    print(f"slice: {rate:.3f} samples/sec ({CHAINS} chains x {TIMED} "
          f"transitions in {seconds:.3f} s), peak memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB)", flush=True)
    _profile(make_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-5, fixed, moving,
                             chunk=5, burn_in=0, thin=1), state, 5, "transitions")
    return launches


def phase_reference(dev) -> None:
    """One 64³ transition with fixed noise: card (kernels) vs CPU (plain).

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
    shape = (CHAINS, 3) + SMALL
    eps_np = rng.standard_normal(shape).astype(np.float32)
    unif_np = rng.uniform(-0.1, 0.1, shape).astype(np.float32)
    for device in (torch.device("cpu"), dev):
        bundle, fixed, moving, opt_gmm, opt_reg = _problem(SMALL, device)
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
    print(f"reference: 64³ transition, card vs CPU agree: loss terms within 1e-4, "
          f"σ²∇U RMS error {rms:.3e} (RMS {rms_q:.3e}), max abs err {err:.3e}",
          flush=True)


def _vi_problem(dims, device):
    """``bench.py:measure_vi`` on the "pre" scheme: the bundle, images,
    the experiment-1 optimizers and the initial ``VIState``."""
    from ir_sgmcmc_tpu_torch.engine import VIState
    from ir_sgmcmc_tpu_torch.optim import adam_decay

    bundle, fixed, moving, _, opt_reg = _problem(dims, device, "pre")
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
               "warp_bounded_tblend": 8}


def phase_vi(dev) -> dict:
    """GMM warm-up, 1 warm-up and TIMED VI steps at 128³ on "pre", then a
    profile of 5 more; returns the launch counts of the timed run."""
    from ir_sgmcmc_tpu_torch.engine import gmm_warmup, make_vi_chunk, make_vi_step
    from ir_sgmcmc_tpu_torch.kernels import all_kernels

    bundle, fixed, moving, (oq, og, orr), state = _vi_problem(DIMS, dev)
    tr = bundle.transformation
    print(f"vi: {DIMS} 'pre', no_taylor {tr.no_taylor}, compositions "
          f"{tr.no_compositions}, image warps {tr.no_image_compositions}", flush=True)
    step = make_vi_step(bundle, oq, og, orr, fixed, moving)
    state = gmm_warmup(bundle, og, state, fixed, moving)
    state, _ = make_vi_chunk(step, 1)(state)
    timed = make_vi_chunk(step, TIMED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    state, metrics = timed(state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    for name in ("data_term", "reg_term", "entropy_term", "total_loss", "vd_alpha"):
        if not torch.isfinite(metrics[name]).all():
            raise AssertionError(f"vi: non-finite {name}: {metrics[name]}")
    if not all(torch.isfinite(t).all() for t in state.q_v.values()):
        raise AssertionError("vi: non-finite q(v)")
    for sym, per in VI_PER_STEP.items():
        if launches[sym] != per * TIMED:
            raise AssertionError(f"vi: {sym} launched {launches[sym]} times in {TIMED} "
                                 f"steps, expected {per * TIMED}")
    last = {k: metrics[k][-1].tolist() for k in
            ("data_term", "reg_term", "entropy_term", "total_loss", "vd_alpha", "ndv",
             "sat", "max_update_mu")}
    print(f"vi: last step {json.dumps(last)}", flush=True)
    print(f"vi: launches {json.dumps(launches)} over {TIMED} steps", flush=True)
    print(f"vi: {TIMED / seconds:.3f} iters/sec ({TIMED} steps in {seconds:.3f} s), "
          f"peak memory {peak} bytes ({peak / 2**30:.3f} GiB)", flush=True)
    _profile(make_vi_chunk(step, 5), state, 5, "VI steps")
    return launches


_KINDS = (("tblend_", "B7"), ("dgrad_tile", "B6"), ("dgrad_gather", "B6"),
          ("fwd_window", "B3"), ("fwd_tile", "B5"), ("warp_bounded_fwd", "B5"), ("split_fwd", "B1"),
          ("split_bwd", "B2"), ("block_warp_fwd", "B3"), ("dgrad_window", "B4"),
          ("block_warp_dgrad", "B4"), ("direct_copy", "copies"), ("CatArray", "copies"),
          ("Memcpy", "copies"), ("Memset", "copies"), ("reduce_kernel", "reductions"),
          ("elementwise", "elementwise"))


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


def phase_vi_reference(dev) -> None:
    """One 64³ VI step with fixed draws: card (kernels) vs CPU (plain).

    The GMM starts warm (spread scales, unequal logits), as in phase 4.
    Tolerances as in tests/test_torch_vi.py: loss terms 1e-4 relative,
    counters equal; the q(v) gradient (Adam's first moment / 0.1) within
    1e-3 RMS of its RMS and 2% of its maximum elementwise.
    """
    from ir_sgmcmc_tpu_torch.engine import make_vi_step

    rng = np.random.default_rng(11)
    eps_np = rng.standard_normal((3,) + SMALL).astype(np.float32)
    x_np = np.float32(rng.standard_normal())
    unif_np = rng.uniform(-0.1, 0.1, (2, 3) + SMALL).astype(np.float32)
    results = {}
    for device in (torch.device("cpu"), dev):
        bundle, fixed, moving, (oq, og, orr), state = _vi_problem(SMALL, device)
        gmm = bundle.gmm.init_scales_from_residual_std(bundle.gmm.init_params("cpu"), 1.0)
        gmm["logits"] = torch.tensor([0.3, -0.2, 0.1, -0.4])
        state = state._replace(gmm={k: t.to(device) for k, t in gmm.items()})
        noise = tuple(torch.as_tensor(a, device=device) for a in (eps_np, x_np, unif_np))
        new, met = make_vi_step(bundle, oq, og, orr, fixed, moving)(state, noise=noise)
        results[device.type] = {
            "g": {k: (new.opt_q_v.mu[k] / 0.1).cpu() for k in new.opt_q_v.mu},
            **{k: met[k].cpu() for k in ("data_term", "reg_term", "entropy_term",
                                         "total_loss", "vd_alpha", "ndv", "sat")}}
    cpu, gpu = results["cpu"], results["cuda"]
    for k in ("ndv", "sat"):
        if not torch.equal(cpu[k], gpu[k]):
            raise AssertionError(f"vi reference: {k} {gpu[k]} on the card, {cpu[k]} on the CPU")
    for k in ("data_term", "reg_term", "entropy_term", "total_loss", "vd_alpha"):
        _err(gpu[k], cpu[k], 0.0, 1e-4, f"vi reference {k}")
    worst = 0.0
    for k, ref in cpu["g"].items():
        d = gpu["g"][k] - ref
        rms, rms_ref = float(d.pow(2).mean().sqrt()), float(ref.pow(2).mean().sqrt())
        if rms > 1e-3 * rms_ref:
            raise AssertionError(f"vi reference: RMS error of the {k} gradient {rms:.3e} "
                                 f"vs RMS {rms_ref:.3e}")
        _err(gpu["g"][k], ref, 2e-2 * float(ref.abs().max()), 0.0, f"vi reference grad {k}")
        worst = max(worst, rms / rms_ref)
    print(f"vi reference: 64³ VI step, card vs CPU agree: loss terms within 1e-4, "
          f"q(v) gradient RMS error at most {worst:.3e} of its RMS", flush=True)


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


def phase_trainer(dev, extra=()) -> dict:
    """The demo config through the port's CLI at 128³ (``extra``: more
    overrides); returns the record it prints, with the launch counts of the
    whole run.  Each trainer phase is timed (with a device sync at its
    ends) and its launches counted by wrappers that this function installs
    around the trainer's phase methods and removes after."""
    import tempfile

    from ir_sgmcmc_tpu_torch import run
    from ir_sgmcmc_tpu_torch import trainer as tr
    from ir_sgmcmc_tpu_torch.engine import init_chains
    from ir_sgmcmc_tpu_torch.kernels import all_kernels
    from ir_sgmcmc_tpu_torch.utils.checkpoint import load_checkpoint

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
                p = phases.setdefault(name, {"s": 0.0, "launches": dict.fromkeys(c0, 0)})
                p["s"] += time.perf_counter() - t0
                for sym, n in counts().items():
                    p["launches"][sym] += n - c0[sym]
        return wrapper

    def keep(fn):
        def wrapper(self, *args, **kwargs):
            seen.append(self)
            return fn(self, *args, **kwargs)
        return wrapper

    patches = [(tr, "gmm_warmup", timed("warm-up", tr.gmm_warmup)),
               (tr.Trainer, "_run_vi_phase", timed("VI", tr.Trainer._run_vi_phase)),
               (tr.Trainer, "_test_vi", timed("VI test", tr.Trainer._test_vi)),
               (tr.Trainer, "_run_mcmc_phase", timed("MCMC", tr.Trainer._run_mcmc_phase)),
               (tr.Trainer, "run", keep(tr.Trainer.run))]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["-c", str(root / "configs/demo/config_synthetic.json"), "--run-id", "smoke",
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
        peak = torch.cuda.max_memory_allocated()
        s, t = summaries[0], seen[0]
        if "mcmc_aborted" in s:
            raise AssertionError(f"trainer: MCMC aborted: {s['mcmc_aborted']}")
        for key in ("vi_test_mean_dsc", "mcmc_mean_dsc"):
            if not (math.isfinite(s[key]) and s[key] >= s["dsc_before"] - 0.05):
                raise AssertionError(f"trainer: {key} {s[key]} against dsc_before "
                                     f"{s['dsc_before']} (bar: 0.05 below it)")
        run_dir = Path(tmp) / "demo_synthetic" / "smoke"
        missing = [a for a in TRAINER_ARTIFACTS if not list(run_dir.glob(a))]
        if missing:
            raise AssertionError(f"trainer: artifacts missing under {run_dir}: {missing}")
        bad = [sym for sym, n in launches.items()
               if (n == 0) != (sym in ("warp_bounded_dgrad", "warp_bounded_tblend"))]
        if bad:
            raise AssertionError(f"trainer: launches {launches}: B1-B5 must run and B6/B7 "
                                 f"must not ({bad})")

        # both checkpoints back into the port's states on the card
        b, q_v0 = t.bundle, t.dataset[0][2]
        vi, vi_meta = load_checkpoint(run_dir / "models/vi_latest.npz",
                                      t._initial_state(q_v0, 0))
        gen = torch.Generator(device=dev).manual_seed(0)
        chains = init_chains(b, gen, t.no_chains, "identity", None, b.gmm.init_params(dev),
                             b.reg_loss.init_params(dev), t.opt_gmm, t.opt_reg, device=dev)
        mc, mc_meta = load_checkpoint(run_dir / "models/mcmc_latest.npz", chains)
        if vi_meta.get("vi_iters") != 20 or mc_meta.get("mcmc_steps") != 30:
            raise AssertionError(f"trainer: checkpoint meta {vi_meta}, {mc_meta}")
        for name, x in (("q_v mu", vi.q_v["mu"]), ("chain v", mc.v),
                        ("welford mean", mc.welford.mean)):
            if not (x.is_cuda and bool(torch.isfinite(x).all())):
                raise AssertionError(f"trainer: checkpoint {name} not finite on the card")
        if vi.step != 20 or mc.step != 30:
            raise AssertionError(f"trainer: checkpoint steps {vi.step}, {mc.step}")

    record = {
        "summary": s, "wall_s": wall,
        "phase_s": {name: p["s"] for name, p in phases.items()},
        "phase_launches": {name: p["launches"] for name, p in phases.items()},
        "launches": launches,
        "vi_iters_per_sec_in_phase": 20 / phases["VI"]["s"],
        "mcmc_samples_per_sec_in_phase": t.no_chains * 30 / s["mcmc_time_s"],
        "host_s": t.timings, "peak_bytes": peak,
    }
    print(f"trainer: {json.dumps(record, default=float)}", flush=True)
    return record


def _to(state, device):
    def mv(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, dict):
            return {k: mv(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(mv(v) for v in x))
        return x

    return state._replace(**{f: mv(getattr(state, f)) for f in state._fields
                             if f not in ("key", "step")})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    if not (Path(__file__).resolve().parent / "ir_sgmcmc_tpu_torch").is_dir():
        print("chip_smoke: no ir_sgmcmc_tpu_torch package beside this script; run it "
              "from the root of the repository", file=sys.stderr)
        return 1
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

    rows = phase_kernels(dev) + phase_blend_kernels(dev)
    paths = {"mcmc": phase_slice(dev)}
    phase_reference(dev)
    paths["vi"] = phase_vi(dev)
    phase_vi_reference(dev)
    paths["trainer"] = phase_trainer(dev)["launches"]

    kernels = []
    for r in rows:
        k = r["kernel"]
        bound, by = k.bound_ms(r["shape"])
        kernels.append({"name": k.symbol, "route": "cuda", "source": k.source,
                        "replaces": k.replaces,
                        "launches": sum(p[k.symbol] for p in paths.values()),
                        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": bound, "bound_by": by, "library_ms": r["library_ms"]})
    unlaunched = [r["name"] for r in kernels if r["launches"] == 0]
    if unlaunched:
        raise AssertionError(f"kernels never launched on a main path: {unlaunched}")
    if not all(math.isfinite(r["ms"]) for r in kernels):
        raise AssertionError("kernel timing failed")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
