"""End-to-end registration quality against a KNOWN deformation (the port's
``scripts/quality_eval.py``: the same flags, plus ``--device``, and the same
report keys in the same order).

Builds a synthetic pair whose fixed volume is the moving volume warped by a
known random smooth diffeomorphism (``data.svf_pair``, or with
``--phantom brain`` the 15-structure ``data.brain_phantom_pair``), runs the
full two-phase pipeline through the ``Trainer`` (the path of
``python -m ir_sgmcmc_tpu_torch.run``), and reports:

* Dice of the warped segmentation (before, VI test, MCMC),
* displacement error against the ground-truth field (mean and p95, voxels,
  inside the mask),
* uncertainty calibration: the Pearson correlation between the per-voxel
  posterior std-dev and the actual displacement error,
* with ``--phantom brain``, per-structure Dice and ASD of the
  posterior-mean registration.

The report is printed as one JSON line and written to
``<out-dir>/report.json``.  Usage::

    # on the CPU, small
    python -m ir_sgmcmc_tpu_torch.scripts.quality_eval --device cpu \\
        --dims 32 --magnitude 3 --vi-iters 64 --burn-in 50 --samples 150
    # on the card, the canonical protocol
    python -m ir_sgmcmc_tpu_torch.scripts.quality_eval --dims 128 \\
        --magnitude 6 --vi-iters 384 --burn-in 300 --samples 700

``--taylor-compositions on`` (the pure Taylor compositions) and anchored
MCMC (``--anchor`` with ``--noise-scheme post``, and its ``--anchor-*``
keys) run as in the JAX package, which keeps both for the record; the JAX
script has no ``--anchor`` (its rows of anchored runs predate the default's
change to off), the port's sets ``trainer.mcmc_anchor``.
``--compute-dtype bfloat16`` integrates as the JAX package does with that
setting (kernels B1/B2-bf16 on the card).
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]


class _PairDataset:
    """One in-memory pair as a dataset."""

    def __init__(self, fixed, moving, q_v0, structures, spacing):
        self._item = (fixed, moving, q_v0)
        self.im_spacing = spacing
        self.structures = structures

    def __len__(self):
        return 1

    def __getitem__(self, idx):
        return self._item


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="registration quality against a known deformation")
    p.add_argument("--dims", type=int, default=32)
    p.add_argument("--magnitude", type=float, default=3.0,
                   help="peak GT displacement (voxels)")
    p.add_argument("--vi-iters", type=int, default=64)
    p.add_argument("--burn-in", type=int, default=50)
    p.add_argument("--samples", type=int, default=150)
    p.add_argument("--chains", type=int, default=2)
    p.add_argument("--max-disp", type=int, default=8)
    p.add_argument("--mcmc-init", choices=["VI", "identity", "noise"], default="VI",
                   help="'identity'/'noise' run the experiment-4 MCMC-only cold start "
                        "(no VI phase, configs/experiment4/*.json)")
    p.add_argument("--model", choices=["svf", "svffd"], default="svf",
                   help="transformation model: dense SVF (experiment-1 default) or the "
                        "B-spline-parameterised SVFFD (experiment 5)")
    p.add_argument("--cps", type=int, default=2,
                   help="SVFFD control point spacing (voxels; experiment 5 ships 2 and 4)")
    p.add_argument("--seed", type=int, default=0,
                   help="GT-deformation seed (and trainer seed unless --trainer-seed is given)")
    p.add_argument("--trainer-seed", type=int, default=None,
                   help="trainer RNG seed, decoupled from the GT seed so seed replication "
                        "varies only the inference noise")
    p.add_argument("--taylor-threshold", type=float, default=0.5,
                   help="SVF integrator: max |u| (voxels) for Taylor-form squarings; 0 "
                        "disables Taylor (all squarings warp)")
    p.add_argument("--use-gather", action="store_true",
                   help="SVF integrator: exact gather-based squaring (grid_sample "
                        "self-composition)")
    p.add_argument("--taylor-compositions", choices=["on", "off", "split"], default=None,
                   help="composition-phase step: 'split' = dimensionally split per-axis "
                        "lerps, 'off' = radius-1 warps, 'on' = Taylor stencils "
                        "(unstable end-to-end, kept for the record)")
    p.add_argument("--compute-dtype", default=None, choices=["float32", "bfloat16"],
                   help="SVF integrator compute dtype of the squarings and the split "
                        "compositions (default float32; bfloat16 halves the split kernels' "
                        "memory traffic)")
    p.add_argument("--noise-scheme", choices=["pre", "post"], default=None,
                   help="uniform transformation-noise scheme: 'post' = displacement-only "
                        "cascade and one exact warp at T + noise, 'pre' = the bounded "
                        "blend-warp path (default from the config)")
    p.add_argument("--anchor", action="store_true",
                   help="with --noise-scheme post: trainer.mcmc_anchor = true, anchored "
                        "residual warping in the MCMC loop (a known quality regression)")
    p.add_argument("--no-anchor", action="store_true",
                   help="trainer.mcmc_anchor = false: the per-sample exact warp")
    p.add_argument("--anchor-radius", type=int, default=None)
    p.add_argument("--block-radius", type=int, default=None,
                   help="'post' scheme block-gather warp: in-block residual radius "
                        "(voxels; default 2), the bound on the displacement's in-block "
                        "variation that the saturation guard's block-residual overflow "
                        "counts against")
    p.add_argument("--anchor-mode", choices=["taylor", "blend"], default=None)
    p.add_argument("--anchor-period", type=int, default=None)
    p.add_argument("--thin", type=int, default=None,
                   help="posterior-accumulator thinning (trainer.mcmc_thin; default 1 = "
                        "every post-burn-in sample feeds the Welford accumulators)")
    p.add_argument("--noise-alpha", type=float, default=None,
                   help="uniform transformation-noise magnitude (default 0.1)")
    p.add_argument("--save-period", type=int, default=None,
                   help="trainer.save_period_MCMC: sample-artifact dump period (default "
                        "the log period)")
    p.add_argument("--max-device-chunk", type=int, default=None,
                   help="trainer.max_device_chunk: the most steps between two host reads "
                        "of the step metrics (default 200)")
    p.add_argument("--phantom", choices=["sphere", "brain"], default="sphere",
                   help="'brain' = the 15-structure anisotropic-spacing phantom; "
                        "per-structure Dice/ASD rows are added to the report")
    p.add_argument("--out-dir", default=None,
                   help="run tree and report.json (default: a new temporary directory)")
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="device (default: the CUDA card)")
    return p


def _config(args, dims, out_dir: str, trainer_seed: int) -> dict:
    """The demo config with the protocol's settings."""
    cfg = json.loads((REPO / "configs/demo/config_synthetic.json").read_text())
    cfg["data_loader"]["args"]["dims"] = list(dims)
    cfg["transformation_module"]["args"] = {
        "max_disp": args.max_disp,
        "taylor_threshold": args.taylor_threshold,
        "use_gather": args.use_gather,
    }
    if args.model == "svffd":
        cfg["transformation_module"]["type"] = "SVFFD_3D"
        cfg["transformation_module"]["args"]["cps"] = [args.cps] * 3
    if args.taylor_compositions is not None:
        cfg["transformation_module"]["args"]["taylor_compositions"] = {
            "on": True, "off": False, "split": "split"}[args.taylor_compositions]
    if args.compute_dtype is not None:
        cfg["transformation_module"]["args"]["compute_dtype"] = args.compute_dtype
    t = cfg["trainer"]
    t.update(
        save_dir=out_dir,
        VI=args.mcmc_init == "VI", MCMC=True, MCMC_init=args.mcmc_init,
        no_iters_VI=args.vi_iters,
        log_period_VI=max(16, args.vi_iters // 4),
        no_samples_VI_test=4,
        no_chains=args.chains,
        no_iters_burn_in=args.burn_in,
        no_samples_MCMC=args.samples,
        log_period_MCMC=max(25, (args.burn_in + args.samples) // 8),
        speed_test_iters=10,
        tensorboard=False,
        seed=trainer_seed,
    )
    if args.max_device_chunk is not None:
        t["max_device_chunk"] = args.max_device_chunk
    if args.save_period is not None:
        t["save_period_MCMC"] = args.save_period
    if args.noise_scheme is not None:
        t.setdefault("uniform_noise", {})["scheme"] = args.noise_scheme
    if args.anchor:
        t["mcmc_anchor"] = True
    if args.no_anchor:
        t["mcmc_anchor"] = False
    if args.anchor_radius is not None:
        t["anchor_radius"] = args.anchor_radius
    if args.block_radius is not None:
        t.setdefault("block_warp", {})["radius"] = args.block_radius
    if args.anchor_mode is not None:
        t["anchor_mode"] = args.anchor_mode
    if args.anchor_period is not None:
        t["anchor_period"] = args.anchor_period
    if args.thin is not None:
        t["mcmc_thin"] = args.thin
    if args.noise_alpha is not None:
        t.setdefault("uniform_noise", {})["magnitude"] = args.noise_alpha
    return cfg


def _per_structure(mean, fixed, moving, structures, spacing, dims) -> tuple[dict, float]:
    """Per-structure Dice/ASD of the posterior-mean registration (the moving
    seg warped by nearest neighbour at ``id + mean``) beside the pair's
    before registration, and the mean ASD over the finite structures."""
    import torch

    from ..ops.grids import identity_grid, voxel_to_normalised
    from ..ops.resample import warp
    from ..utils.metrics import calc_metrics

    T_mean = identity_grid(dims, device="cpu") + voxel_to_normalised(torch.as_tensor(mean))
    seg_w = warp(torch.as_tensor(moving["seg"]), T_mean, method="nearest").numpy()
    asd, dsc = calc_metrics(fixed["seg"], seg_w, structures, spacing)
    asd0, dsc0 = calc_metrics(fixed["seg"], moving["seg"], structures, spacing)
    rows = {name: {"dsc_before": round(float(dsc0[0][i]), 4),
                   "dsc": round(float(dsc[0][i]), 4),
                   "asd_before": round(float(asd0[0][i]), 3),
                   "asd": round(float(asd[0][i]), 3)}
            for i, name in enumerate(structures)}
    return rows, round(float(np.mean(asd[0][np.isfinite(asd[0])])), 3)


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)

    from .._device import resolve_device
    from ..config import Config
    from ..data.synthetic import brain_phantom_pair, svf_pair
    from ..trainer import Trainer
    from ..utils.vtk_io import read_vtk_field

    device = resolve_device(args.device)
    dims = (args.dims,) * 3
    spacing = (1.0, 1.0, 1.0)
    structures = {"sphere": 1}
    if args.phantom == "brain":
        fixed, moving, disp_gt, spacing, structures = brain_phantom_pair(
            dims, magnitude=args.magnitude, seed=args.seed, device=device)
    else:
        fixed, moving, disp_gt = svf_pair(dims, magnitude=args.magnitude, seed=args.seed,
                                          device=device)

    out_dir = args.out_dir or tempfile.mkdtemp(prefix="quality_eval_")
    trainer_seed = args.seed if args.trainer_seed is None else args.trainer_seed
    cfg = _config(args, dims, out_dir, trainer_seed)
    config = Config(cfg, run_id="quality")

    la = cfg["data_loader"]["args"]
    # q(v) lives on the control grid for SVFFD, on the voxel grid for SVF
    if args.model == "svffd":
        from ..ops.bspline import control_grid_size

        q_dims = tuple(control_grid_size(dims, [args.cps] * 3))
    else:
        q_dims = dims
    q_v0 = {
        "mu": np.zeros((3,) + q_dims, np.float32),
        "log_var": np.full((3,) + q_dims, 2.0 * np.log(la["sigma_v_init"]), np.float32),
        "u": np.full((3,) + q_dims, la["u_v_init"], np.float32),
    }
    ds = _PairDataset(fixed, moving, q_v0, structures, spacing)
    summary = Trainer(config, dataset=ds, device=device).run()[0]

    mask = fixed["mask"]
    gt_mag = np.sqrt((disp_gt**2).sum(axis=0))[mask]
    mean_path = config.dir / "fields/MCMC_displacement_mean.vtk"
    if mean_path.exists():
        mean = read_vtk_field(mean_path)
        std = read_vtk_field(config.dir / "fields/MCMC_displacement_std_dev.vtk")
        err = mean - disp_gt  # (3, D, H, W) voxel units
        err_mag = np.sqrt((err**2).sum(axis=0))[mask]
        std_mag = np.sqrt((std**2).sum(axis=0))[mask]
        # calibration: does the posterior std-dev rank where the error is?
        calib = float(np.corrcoef(std_mag, err_mag)[0, 1])
        calib_ch = float(np.corrcoef(np.abs(err)[:, mask].ravel(),
                                     std[:, mask].ravel())[0, 1])
    else:
        # a guard abort before any post-burn-in sample leaves no posterior
        # statistics: report the abort instead of failing on the artifact
        mean = None
        err_mag = std_mag = np.full_like(gt_mag, np.nan)
        calib = calib_ch = float("nan")

    report = {
        "dims": args.dims,
        "mcmc_init": args.mcmc_init,
        "model": args.model,
        "cps": args.cps if args.model == "svffd" else None,
        "phantom": args.phantom,
        "seed": args.seed,
        "trainer_seed": trainer_seed,
        "taylor_threshold": args.taylor_threshold,
        "use_gather": args.use_gather,
        "taylor_compositions": args.taylor_compositions,
        "compute_dtype": args.compute_dtype,
        "block_radius": args.block_radius,
        "gt_peak_disp_vox": round(float(gt_mag.max()), 3),
        "dsc_before": round(summary.get("dsc_before", float("nan")), 4),
        "dsc_vi": round(summary.get("vi_test_mean_dsc", float("nan")), 4),
        "dsc_mcmc": round(summary.get("mcmc_mean_dsc", float("nan")), 4),
        "disp_err_mean_vox": round(float(err_mag.mean()), 4),
        "disp_err_p95_vox": round(float(np.percentile(err_mag, 95)), 4),
        "disp_err_rel": round(float(err_mag.mean() / max(gt_mag.mean(), 1e-6)), 4),
        "uncertainty_calibration_corr": round(calib, 4),
        "uncertainty_calibration_corr_per_channel": round(calib_ch, 4),
        "mcmc_samples_per_sec": round(summary.get("mcmc_samples_per_sec", float("nan")), 3),
        "aborted": summary.get("mcmc_aborted"),
        "run_dir": str(config.dir),
    }
    if args.phantom == "brain" and mean is not None:
        report["per_structure"], report["mean_asd"] = _per_structure(
            mean, fixed, moving, structures, spacing, dims)

    line = json.dumps(report)
    (Path(out_dir) / "report.json").write_text(line + "\n")
    print(line, flush=True)
    return report


if __name__ == "__main__":
    main()
