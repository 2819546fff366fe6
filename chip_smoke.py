#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``ir_sgmcmc_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. the card's name and power limit; build the CUDA kernels from
   ``ir_sgmcmc_tpu_torch/csrc`` (nvcc, sm_90a) and report the build time;
2. each kernel B1-B4 against its plain PyTorch version on the card, at the
   main path's shapes, with the stated tolerance, and both times;
3. the main path: one SGLD transition over 2 chains at 128³ (the
   ``bench.py`` configuration), 1 warm-up and 10 timed transitions through
   ``init_chains`` -> ``make_mcmc_chunk``; the launch counters must move by
   exactly B1 7, B2 7, B3 1, B4 1 per transition;
4. the same transition at 64³ with fixed noise on the card and on the CPU
   (plain versions) must agree.

Then one JSON line of kernel results, the ``nvidia-smi`` name/power line,
and the final status line.  Imports nothing of JAX.  Exits non-zero, with
no result, when CUDA is unavailable.  TF32 is off for matmuls and cuDNN.
"""

from __future__ import annotations

import json
import math
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


def _bundle(dims):
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
        noise_scheme="post", virtual_decimation=True)


def _problem(dims, device):
    from ir_sgmcmc_tpu_torch.data import sphere_pair
    from ir_sgmcmc_tpu_torch.optim import adam_decay

    bundle = _bundle(dims)
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


def phase_kernels(dev) -> list:
    """B1-B4 against their plain versions at the main path's shapes."""
    from ir_sgmcmc_tpu_torch.kernels import block_warp as bw
    from ir_sgmcmc_tpu_torch.kernels import split_warp as sw
    from ir_sgmcmc_tpu_torch.ops.resample import _block_means

    gen = torch.Generator(device=dev).manual_seed(1234)
    shape = (CHAINS, 3) + DIMS

    def randn(shp, scale=1.0):
        return torch.randn(shp, generator=gen, device=dev) * scale

    rows = []
    d, u, g = randn(shape, 2.0), randn(shape, 0.9), randn(shape)
    # no exact ties at u = 0 or |u| = 1, where autograd of the plain step
    # and the kernel take different (equally valid) subgradients
    u = torch.where(u.abs() == 1, u * 1.001, u)
    u = torch.where(u == 0, torch.full_like(u, 1e-3), u)
    err = _err(sw.split_warp_fwd_cuda(d, u), sw.split_compose_plain(d, u),
               2e-5, 0.0, "B1")
    rows.append((sw.B1, err, 2e-5, 0.0,
                 _time_ms(lambda: sw.split_warp_fwd_cuda(d, u)),
                 _time_ms(lambda: sw.split_compose_plain(d, u))))
    gd_k, gu_k = sw.split_warp_bwd_cuda(d, u, g)
    gd_p, gu_p = sw.split_compose_vjp_plain(d, u, g)
    err = max(_err(gd_k, gd_p, 3e-5, 1e-4, "B2 gd"),
              _err(gu_k + g, gu_p, 3e-5, 1e-4, "B2 gu", u=u, d=d))
    rows.append((sw.B2, err, 3e-5, 1e-4,
                 _time_ms(lambda: sw.split_warp_bwd_cuda(d, u, g)),
                 _time_ms(lambda: sw.split_compose_vjp_plain(d, u, g))))

    # block warp at the path's bound 9 / radius 2 / block 8: a smooth
    # displacement (trilinear upsampling of a coarse random field) with
    # every 7th residual set to an integer (the zero-derivative convention)
    bound, radius, block = 9, 2, 8
    vol = randn((CHAINS, 1) + DIMS)
    coarse = randn((CHAINS, 3, 3, 3, 3), bound - 1.0)
    disp = torch.nn.functional.interpolate(coarse, size=DIMS, mode="trilinear",
                                           align_corners=True)
    disp = disp.clamp(-(bound - 0.5), bound - 0.5)
    m = _block_means(disp, block, bound)
    r = (disp - bw._expand_blocks(m, block).float()).clamp(-radius, radius)
    flat = r.view(-1)
    flat[::7] = torch.round(flat[::7])
    r = r.contiguous()
    gv = randn((CHAINS, 1) + DIMS)
    err = _err(bw.block_warp_cuda(vol, r, m), bw.block_warp_plain(vol, r, m),
               1e-5, 0.0, "B3")
    rows.append((bw.B3, err, 1e-5, 0.0,
                 _time_ms(lambda: bw.block_warp_cuda(vol, r, m)),
                 _time_ms(lambda: bw.block_warp_plain(vol, r, m))))
    err = _err(bw.block_warp_dgrad_cuda(vol, r, m, gv),
               bw.block_warp_dgrad_plain(vol, r, m, gv), 5e-4, 1e-4, "B4")
    rows.append((bw.B4, err, 5e-4, 1e-4,
                 _time_ms(lambda: bw.block_warp_dgrad_cuda(vol, r, m, gv)),
                 _time_ms(lambda: bw.block_warp_dgrad_plain(vol, r, m, gv))))
    for k, err, atol, rtol, ms, plain_ms in rows:
        print(f"kernel {k.symbol}: max_abs_err {err:.3e} (atol {atol}, rtol "
              f"{rtol}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    return rows


def phase_slice(dev) -> dict:
    """1 warm-up + TIMED transitions at 128³ x 2 chains on the card; returns
    the launch counts of the timed run."""
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
        gmm = bundle.gmm.init_scales_from_residual_std(bundle.gmm.init_params(), 1.0)
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
    ptxas = [ln.strip() for ln in (_lib.BUILD_DIR / "nvcc.log").read_text().splitlines()
             if "registers" in ln] if (_lib.BUILD_DIR / "nvcc.log").exists() else []
    for ln in ptxas:
        print(f"ptxas: {ln}", flush=True)

    rows = phase_kernels(dev)
    launches = phase_slice(dev)
    phase_reference(dev)

    kernels = [{"name": k.symbol, "route": "cuda", "source": k.source,
                "replaces": k.replaces, "launches": launches[k.symbol],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
               for k, err, _, _, ms, plain_ms in rows]
    if not all(math.isfinite(r["ms"]) for r in kernels):
        raise AssertionError("kernel timing failed")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
