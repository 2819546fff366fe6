"""Benchmark of the port: SG-MCMC sampling throughput at 128³ (experiment-1
scale), and the VI iteration rate.

    python -m ir_sgmcmc_tpu_torch.bench                  # canonical: MCMC, then VI
    python -m ir_sgmcmc_tpu_torch.bench --phase vi --noise-scheme pre
    python -m ir_sgmcmc_tpu_torch.bench --dims 256       # non-canonical MCMC line
    python -m ir_sgmcmc_tpu_torch.bench --device cpu --dims 16

The root ``bench.py`` (which times the JAX package) with the same flags,
the same defaults and the same three JSON line forms (the canonical line,
the non-canonical MCMC line and the VI line, with its ``metric`` names and
keys in its order), plus ``--device``: the run is on the CUDA card unless
``--device cpu`` is given, and raises without one.  The model and pair are
``bench.py``'s (:func:`make_bundle_and_pair`): 2 chains, GMM K=4, Sobolev
s=3, uniform noise 0.1 on the ``"post"`` scheme, virtual decimation, the
learnable log-normal regulariser, on the synthetic sphere pair.

* ``value``: chains x transitions / sec over ``TIMED_REPEATS`` chunks of
  ``TIMED_STEPS`` transitions after one warm chunk of the same length,
  each chunk between two device synchronisations.
* ``vi_iters_per_sec``: the same for chunks of ``VI_TIMED_STEPS`` VI
  iterations after the GMM warm-up (remat from a dense field of 100 MiB,
  so at 256³ and not at 128³, as ``bench.py`` rules).
* ``vs_baseline``: the speedup over the torch-CPU transition of
  ``scripts/torch_baseline.py``, read from ``.bench_baseline.json`` under
  ``bench.py``'s protocol check; ``--refresh-baseline`` measures it (a CPU
  subprocess, about 7 minutes at 128³).  Without a valid cache and without
  the flag the canonical line omits ``vs_baseline`` and the ``baseline_*``
  keys and says why on stderr.

Each line adds ``backend`` (``"torch-cuda"`` or ``"torch-cpu"``),
``device`` (the card's name), ``power_limit`` (``nvidia-smi``'s),
``build_s`` (the kernels' ``nvcc`` build in this process, the port's cold
compile), ``peak_mem_bytes`` (the peak over the timed chunks) and
``launches_per_step`` (hand-written kernel launches per transition or VI
step, by symbol); the canonical line also ``vi_peak_mem_bytes`` and
``vi_launches_per_step``.

Not ported: ``bench.py``'s Pallas fallback (a kernel that fails to build
or launch ends the run non-zero), its ``vi_error`` tag (a failed VI phase
ends the canonical run non-zero), its VI sidecar ``.bench_vi_cache.json``
and its JAX compilation cache (the port's cold start is the ``nvcc`` build,
reported as ``build_s``); ``--unroll`` (JAX's scan unroll) is accepted and
has no effect.  ``--anchor`` (with ``--anchor-radius``) runs the MCMC
chunks with anchored residual warping, as ``bench.py`` does (the JAX
engine's defaults: the ``"taylor"`` mode, re-anchored every 25 transitions,
so once per chunk); ``--taylor-compositions on`` integrates with the pure
Taylor compositions.  Both are kept for the record, as in the JAX package.

Every stage is stamped to stderr with its elapsed time, a 30 s heartbeat
repeats the current one, and ``--budget SECONDS`` (default 1500 or
``$BENCH_BUDGET_S``) cuts the timed repeats down to one chunk rather than
produce nothing.  ``--trace DIR`` writes a ``torch.profiler`` Chrome trace
of one more timed chunk to ``DIR/trace.json`` after the JSON line
(``python -m ir_sgmcmc_tpu_torch.scripts.trace_summary DIR/trace.json
--steps 20`` groups it).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

from ._device import resolve_device

DIMS = (128, 128, 128)  # override with --dims N (cube)
CHAINS = 2
TIMED_STEPS = 20
VI_TIMED_STEPS = 20
TIMED_REPEATS = 3

REPO = Path(__file__).resolve().parents[1]
BASELINE_CACHE = REPO / ".bench_baseline.json"

# ---- stage stamps, heartbeat and budget (stderr only) ---------------------------

_T0 = [time.monotonic()]
_STAGE = ["startup"]
_DEADLINE = [float("inf")]  # monotonic deadline, set from --budget
_HEARTBEAT = []


def _stage(msg: str) -> None:
    _STAGE[0] = msg
    print(f"[bench +{time.monotonic() - _T0[0]:7.1f}s] {msg}", file=sys.stderr, flush=True)


def _heartbeat() -> None:
    while True:
        time.sleep(30)
        print(f"[bench +{time.monotonic() - _T0[0]:7.1f}s] ... still in: {_STAGE[0]}",
              file=sys.stderr, flush=True)


def _remaining() -> float:
    return _DEADLINE[0] - time.monotonic()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---- the torch-CPU anchor --------------------------------------------------------

def read_baseline() -> dict | None:
    """The cached anchor if it meets ``bench.py``'s protocol (a median over
    at least 20 timed transitions), else None."""
    if not BASELINE_CACHE.exists():
        return None
    cached = json.loads(BASELINE_CACHE.read_text())
    if ("samples_per_sec" in cached and "median_s" in cached
            and cached.get("timed_transitions", 0) >= 20):
        _stage(f"torch anchor: cache hit ({BASELINE_CACHE.name})")
        return cached
    return None


def measure_torch_baseline() -> dict:
    """``scripts/torch_baseline.py::run_baseline`` in a CPU subprocess,
    refused when noisy, written to ``.bench_baseline.json``."""
    if _remaining() < 600:
        raise RuntimeError("torch-CPU anchor: --budget leaves <600 s; run "
                           "`python -m ir_sgmcmc_tpu_torch.bench --refresh-baseline` unbounded")
    _stage("torch anchor: measuring (subprocess, >=20 transitions)")
    out = subprocess.run(
        [sys.executable, "-c", "import json; from scripts.torch_baseline import run_baseline; "
                               "print(json.dumps(run_baseline()))"],
        cwd=str(REPO), env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=7200)
    if out.returncode != 0:
        print(out.stderr[-2000:], file=sys.stderr)
        raise RuntimeError("torch baseline failed")
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    if stats["spread_rel"] > 0.2:
        raise RuntimeError(
            f"torch-CPU anchor too noisy: IQR/median = {stats['spread_rel']:.2f} > 0.20 over "
            f"{stats['timed_transitions']} transitions; re-run when the host is quiet")
    stats["dims"] = list(DIMS)
    BASELINE_CACHE.write_text(json.dumps(stats))
    return stats


# ---- the problem -----------------------------------------------------------------

def make_bundle_and_pair(noise_scheme="post", dims=None, model="svf", cps=2, device=None,
                         **svf_kwargs):
    """``bench.py``'s experiment-1 model and synthetic pair, on ``device``
    (default: the CUDA card): ``(bundle, fixed, moving)``.

    ``svf_kwargs`` go to the transformation (``taylor_threshold``,
    ``taylor_compositions``, ``use_gather``, ``compute_dtype``).  ``model``
    ``"svffd"`` is experiment 5's control-grid model at spacing ``cps``
    with ``bench.py``'s Sobolev s 3 and the default block radius 2."""
    from .data import sphere_pair
    from .engine import ModelBundle
    from .models import (GMM, SVF3D, SVFFD3D, DirichletPrior, LogEnergyExpGammaPrior,
                         LogScaleNormalPrior, RegLossLogNormal)

    device = resolve_device(device)
    dims = DIMS if dims is None else tuple(dims)
    if model == "svffd":
        transformation = SVFFD3D(dims, cps=[int(cps)] * 3, no_steps=12, **svf_kwargs)
    else:
        transformation = SVF3D(dims, no_steps=12, **svf_kwargs)
    dof = 3.0 * dims[0] * dims[1] * dims[2]
    bundle = ModelBundle(
        dims=dims,
        gmm=GMM(4, 1),
        scale_prior=LogScaleNormalPrior(0.0, 2.3),
        proportion_prior=DirichletPrior(4, 0.5),
        reg_loss=RegLossLogNormal(w_reg=1.4, dims=dims, learnable=True),
        reg_loc_prior=LogEnergyExpGammaPrior(w_reg=1.4, dof=dof),
        reg_scale_prior=LogScaleNormalPrior(loc=2.8, scale=5.0),
        transformation=transformation,
        sobolev_s=3,
        sobolev_lambda=0.5,
        uniform_noise_alpha=0.1,
        noise_scheme=noise_scheme,
        virtual_decimation=True,
    )
    fixed, moving = sphere_pair(dims, offset=(0.0, 0.0, 4.0))
    fixed = {k: torch.as_tensor(v, device=device) for k, v in fixed.items()}
    moving = {k: torch.as_tensor(v, device=device) for k, v in moving.items()}
    return bundle, fixed, moving


def vi_remat(dims) -> bool:
    """``bench.py``'s (and ``trainer.vi_remat``'s) rule: the antithetic
    chains in turn once a dense f32 field reaches 100 MiB."""
    return 3 * 4 * math.prod(dims) >= 100 * 1024 * 1024


# ---- timing ----------------------------------------------------------------------

def _launch_counts() -> dict:
    from .kernels import all_kernels

    return {k.symbol: k.launches for k in all_kernels()}


def _timed_chunks(run, state, device, steps: int, tag: str):
    """Warm ``run`` once, then time ``TIMED_REPEATS`` calls (fewer when the
    budget runs short), each between two device synchronisations.  Returns
    ``(state, stats)``: the rate's inputs, the peak memory over the timed
    chunks and the hand-written kernels' launches per step."""
    _stage(f"{tag}warm: one {steps}-step chunk (the kernels built at first launch)")
    t0 = time.perf_counter()
    state, _ = run(state)
    _sync(device)
    warm_s = time.perf_counter() - t0
    _stage(f"{tag}warm done in {warm_s:.1f}s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = _launch_counts()
    times = []
    for i in range(TIMED_REPEATS):
        t0 = time.perf_counter()
        state, _ = run(state)
        _sync(device)
        times.append(time.perf_counter() - t0)
        _stage(f"{tag}timed chunk {i + 1}/{TIMED_REPEATS}: {times[-1]:.3f}s")
        # degrade under a driver budget: one chunk is a valid measurement
        if _remaining() < 2.5 * times[-1]:
            _stage(f"budget nearly exhausted ({_remaining():.0f}s left): stopping after "
                   f"{len(times)} chunk(s)")
            break
    n = len(times) * steps
    launches = {}
    for sym, count in _launch_counts().items():
        per = (count - before[sym]) / n
        if per:
            launches[sym] = int(per) if per == int(per) else per
    mean = sum(times) / len(times)
    return state, {
        "mean_s": mean,
        "per_chunk_s": [round(t, 3) for t in times],
        "spread_rel": (max(times) - min(times)) / mean,
        "warm_s": round(warm_s, 1),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda"
        else None,
        "launches_per_step": launches,
    }


def _capture_trace(trace_dir: str, run, state, device) -> None:
    """A ``torch.profiler`` Chrome trace of one more chunk at
    ``trace_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    _stage(f"profiler trace -> {trace_dir}")
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=activities) as prof:
        run(state)
        _sync(device)
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(trace_dir) / "trace.json"))


def measure_mcmc(device, trace_dir: str | None = None, noise_scheme="post", dims=None,
                 chains=None, model="svf", cps=2, anchored=False, anchor_radius=2,
                 **svf_kwargs) -> dict:
    """``bench.py``'s ``measure_tpu``: 2 chains from noise (seed 0) through
    ``init_chains`` -> ``make_mcmc_chunk`` (tau 1e-5, chunks of
    ``TIMED_STEPS``; ``anchored`` at ``anchor_radius``)."""
    from .engine import init_chains, make_mcmc_chunk
    from .optim import adam_decay

    chains = CHAINS if chains is None else chains
    _stage(f"device: {device}")
    bundle, fixed, moving = make_bundle_and_pair(noise_scheme, dims, model, cps, device,
                                                 **svf_kwargs)
    opt_gmm = adam_decay(0.2, 0.001)
    opt_reg = adam_decay({"loc": 0.01, "log_scale": 0.01}, 0.001)
    state = init_chains(bundle, torch.Generator(device=device).manual_seed(0), chains,
                        "noise", None, bundle.gmm.init_params(device),
                        bundle.reg_loss.init_params(device), opt_gmm, opt_reg, device=device)
    timed = make_mcmc_chunk(bundle, opt_gmm, opt_reg, 1e-5, fixed, moving, chunk=TIMED_STEPS,
                            burn_in=0, thin=1, anchored=anchored, anchor_radius=anchor_radius)
    state, stats = _timed_chunks(timed, state, device, TIMED_STEPS, "")
    stats["samples_per_sec"] = chains * TIMED_STEPS / stats.pop("mean_s")
    stats["_trace"] = ((lambda: _capture_trace(trace_dir, timed, state, device))
                       if trace_dir else None)
    return stats


def measure_vi(device, trace_dir: str | None = None, noise_scheme="post", dims=None,
               model="svf", cps=2, **svf_kwargs) -> dict:
    """``bench.py``'s ``measure_vi``: q(v) from ``mu`` 0, ``sigma`` 0.5 and
    ``u`` 0.1, the experiment-1 optimizer groups, the GMM warm-up, then
    chunks of ``VI_TIMED_STEPS`` iterations (remat by :func:`vi_remat`)."""
    from .engine import VIState, gmm_warmup, make_vi_chunk, make_vi_step
    from .optim import adam_decay

    bundle, fixed, moving = make_bundle_and_pair(noise_scheme, dims, model, cps, device,
                                                 **svf_kwargs)
    opt_q_v = adam_decay({"mu": 0.01, "log_var": 0.01, "u": 0.01}, 0.001)
    opt_gmm = adam_decay({"log_std": 0.2, "logits": 0.2}, 0.001)
    opt_reg = adam_decay({"loc": 0.01, "log_scale": 0.01}, 0.001)
    q_v = bundle.init_q_v(0.5, 0.1, device)
    gmm, reg = bundle.gmm.init_params(device), bundle.reg_loss.init_params(device)
    state = VIState(q_v=q_v, gmm=gmm, reg=reg, opt_q_v=opt_q_v.init(q_v),
                    opt_gmm=opt_gmm.init(gmm), opt_reg=opt_reg.init(reg),
                    key=torch.tensor([0, 0]), step=0)  # JAX's PRNGKey(0) words
    state = gmm_warmup(bundle, opt_gmm, state, fixed, moving)
    remat = vi_remat(bundle.dims)
    _stage(f"VI: remat {'on' if remat else 'off'}")
    timed = make_vi_chunk(make_vi_step(bundle, opt_q_v, opt_gmm, opt_reg, fixed, moving,
                                       remat=remat), VI_TIMED_STEPS)
    state, stats = _timed_chunks(timed, state, device, VI_TIMED_STEPS, "VI ")
    stats["iters_per_sec"] = VI_TIMED_STEPS / stats.pop("mean_s")
    stats["_trace"] = ((lambda: _capture_trace(trace_dir, timed, state, device))
                       if trace_dir else None)
    return stats


# ---- the entry point -------------------------------------------------------------

def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="ir-sgmcmc-tpu benchmark (PyTorch port)")
    parser.add_argument("--refresh-baseline", action="store_true",
                        help="re-measure the torch-CPU anchor (ignore cache)")
    parser.add_argument("--trace", default=None, metavar="DIR",
                        help="write a torch.profiler trace of one timed chunk to DIR/trace.json")
    parser.add_argument("--phase", choices=["mcmc", "vi"], default="mcmc",
                        help="which phase's hot loop to time (default: the headline SG-MCMC "
                             "transition; 'vi' times the full VI iteration instead)")
    parser.add_argument("--unroll", default=None, metavar="N",
                        help="the JAX package's integration-scan unroll factor; no effect "
                             "here (the port's integration is a Python loop)")
    parser.add_argument("--taylor-threshold", type=float, default=None)
    parser.add_argument("--taylor-compositions", choices=["on", "off", "split"], default=None,
                        help="composition-phase step: 'split' = dimensionally-split per-axis "
                             "lerps (B1/B2), 'off' = radius-1 warp kernels (B5-B7), 'on' = "
                             "pure Taylor stencils (unstable end-to-end, kept for the "
                             "record); default: 'split'")
    parser.add_argument("--use-gather", action="store_true")
    parser.add_argument("--compute-dtype", default=None, choices=["float32", "bfloat16"],
                        help="squaring-phase compute dtype (SVF3D compute_dtype; default f32)")
    parser.add_argument("--noise-scheme", choices=["pre", "post"], default="post",
                        help="'post' = reference-exact transformation noise (single-warp "
                             "image path, the block-gather warp)")
    parser.add_argument("--anchor", action="store_true",
                        help="with --noise-scheme post: experimental anchored residual "
                             "warping in the MCMC chunks (a known quality regression)")
    parser.add_argument("--anchor-radius", type=int, default=2)
    parser.add_argument("--chains", type=int, default=None, help="chain count (default 2)")
    parser.add_argument("--model", choices=["svf", "svffd"], default="svf",
                        help="transformation model (svffd = experiment-5's control-grid "
                             "model; non-canonical metric, no torch anchor)")
    parser.add_argument("--cps", type=int, default=2,
                        help="SVFFD control point spacing (voxels)")
    parser.add_argument("--dims", type=int, default=None, metavar="N",
                        help="cube edge length (default 128); the torch-CPU anchor and "
                             "vs_baseline are only reported at the canonical 128")
    parser.add_argument("--budget", type=float,
                        default=float(os.environ.get("BENCH_BUDGET_S", 1500)),
                        metavar="SECONDS",
                        help="soft wall-clock budget (default 1500 or $BENCH_BUDGET_S): timed "
                             "repeats degrade to 1 and the JSON line is emitted the moment a "
                             "valid measurement exists")
    parser.add_argument("--device", default=None, choices=("cuda", "cpu"),
                        help="the device (default: the CUDA card; raises without one)")
    return parser


def _host_fields(device: torch.device) -> dict:
    """``backend``, ``device``, ``power_limit`` and ``build_s``."""
    if device.type != "cuda":
        return {"backend": "torch-cpu", "device": "cpu", "power_limit": None, "build_s": None}
    from .kernels import _lib

    index = device.index if device.index is not None else torch.cuda.current_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", f"--id={index}"],
                         capture_output=True, text=True, timeout=60, check=True)
    return {"backend": "torch-cuda", "device": torch.cuda.get_device_name(device),
            "power_limit": smi.stdout.strip().split(",")[-1].strip(),
            "build_s": _lib.build_seconds}


def _emit(line: dict) -> dict:
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> dict:
    """Run the benchmark; prints its JSON line and returns it."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    _T0[0] = time.monotonic()
    _DEADLINE[0] = _T0[0] + args.budget
    if not _HEARTBEAT:
        _HEARTBEAT.append(threading.Thread(target=_heartbeat, daemon=True))
        _HEARTBEAT[0].start()
    _stage(f"bench start (budget {args.budget:.0f}s, phase={args.phase}, device={device})")
    if device.type == "cuda":
        from .kernels import _lib

        _stage("building the CUDA kernels (nvcc, sm_90a; cached per source hash)")
        _lib.load_library()
        _stage(f"kernels ready: build {_lib.build_seconds:.1f}s")

    svf_kwargs = {}
    if args.taylor_threshold is not None:
        svf_kwargs["taylor_threshold"] = args.taylor_threshold
    if args.taylor_compositions is not None:
        svf_kwargs["taylor_compositions"] = {"on": True, "off": False,
                                             "split": "split"}[args.taylor_compositions]
    if args.use_gather:
        svf_kwargs["use_gather"] = True
    if args.compute_dtype is not None:
        svf_kwargs["compute_dtype"] = args.compute_dtype
    mtag = "" if args.model == "svf" else f"_svffd{args.cps}"
    dims = None if args.dims is None else (args.dims,) * 3

    if args.phase == "vi":
        vi = measure_vi(device, trace_dir=args.trace, noise_scheme=args.noise_scheme,
                        dims=dims, model=args.model, cps=args.cps, **svf_kwargs)
        trace = vi.pop("_trace")
        line = _emit({
            "metric": f"vi_iters_per_sec_{args.dims or DIMS[0]}cubed{mtag}",
            "value": round(vi["iters_per_sec"], 3),
            "unit": "iters/sec",
            "spread_rel": round(vi["spread_rel"], 4),
            "timed_chunks_s": vi["per_chunk_s"],
            "compile_warm_s": vi["warm_s"],
            **_host_fields(device),
            "peak_mem_bytes": vi["peak_mem_bytes"],
            "launches_per_step": vi["launches_per_step"],
        })
        if trace:
            trace()
        return line

    nch = CHAINS if args.chains is None else args.chains
    if (dims is not None and dims != DIMS) or args.model != "svf":
        # non-canonical scale: no torch anchor, the raw device throughput
        mc = measure_mcmc(device, trace_dir=args.trace, noise_scheme=args.noise_scheme,
                          dims=dims, chains=args.chains, model=args.model, cps=args.cps,
                          anchored=args.anchor, anchor_radius=args.anchor_radius,
                          **svf_kwargs)
        trace = mc.pop("_trace")
        line = _emit({
            "metric": f"sgmcmc_samples_per_sec_{args.dims or DIMS[0]}cubed_{nch}chains{mtag}",
            "value": round(mc["samples_per_sec"], 3),
            "unit": "samples/sec",
            "noise_scheme": args.noise_scheme,
            "spread_rel": round(mc["spread_rel"], 4),
            "timed_chunks_s": mc["per_chunk_s"],
            "compile_warm_s": mc["warm_s"],
            **_host_fields(device),
            "peak_mem_bytes": mc["peak_mem_bytes"],
            "launches_per_step": mc["launches_per_step"],
        })
        if trace:
            trace()
        return line

    baseline = measure_torch_baseline() if args.refresh_baseline else read_baseline()
    if baseline is None:
        _stage(f"no valid {BASELINE_CACHE.name} (a median over >=20 torch-CPU transitions): "
               f"the line omits vs_baseline and baseline_*; --refresh-baseline measures it "
               f"(about 7 minutes of CPU at 128³)")
    mc = measure_mcmc(device, trace_dir=args.trace, noise_scheme=args.noise_scheme,
                      chains=args.chains, anchored=args.anchor,
                      anchor_radius=args.anchor_radius, **svf_kwargs)
    trace = mc.pop("_trace")
    vi_fields, vi = {}, None
    if _remaining() > 240:
        vi = measure_vi(device, noise_scheme=args.noise_scheme, **svf_kwargs)
        vi_fields = {
            "vi_iters_per_sec": round(vi["iters_per_sec"], 3),
            "vi_spread_rel": round(vi["spread_rel"], 4),
            "vi_compile_warm_s": vi["warm_s"],
        }
    else:
        _stage(f"skipping VI phase ({_remaining():.0f}s left < 240)")
    base_fields = {}
    if baseline is not None:
        base_fields = {
            "baseline_samples_per_sec": round(baseline["samples_per_sec"], 5),
            "baseline_timed_transitions": baseline.get("timed_transitions"),
            "baseline_median_s": baseline.get("median_s"),
            "baseline_iqr_s": baseline.get("iqr_s"),
            "baseline_spread_rel": round(baseline.get("spread_rel", 0.0), 4),
        }
    line = _emit({
        "metric": f"sgmcmc_samples_per_sec_{DIMS[0]}cubed_{nch}chains",
        "value": round(mc["samples_per_sec"], 3),
        "unit": "samples/sec",
        "noise_scheme": args.noise_scheme,
        **({"vs_baseline": round(mc["samples_per_sec"] / baseline["samples_per_sec"], 2)}
           if baseline is not None else {}),
        "spread_rel": round(mc["spread_rel"], 4),
        "timed_chunks_s": mc["per_chunk_s"],
        "compile_warm_s": mc["warm_s"],
        **vi_fields,
        **base_fields,
        **_host_fields(device),
        "peak_mem_bytes": mc["peak_mem_bytes"],
        **({"vi_peak_mem_bytes": vi["peak_mem_bytes"]} if vi is not None else {}),
        "launches_per_step": mc["launches_per_step"],
        **({"vi_launches_per_step": vi["launches_per_step"]} if vi is not None else {}),
    })
    if trace:
        trace()
    return line


if __name__ == "__main__":
    main()
