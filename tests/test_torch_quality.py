"""The port's quality tools against the JAX package's, on the CPU.

* ``data.svf_pair`` and ``data.brain_phantom_pair``: the same numpy draws,
  integrated and warped by each package, give the same pair to float32
  rounding (the fixed image and ``disp_gt`` within 1e-5 abs); the moving
  volumes and the labels are equal (no nearest-neighbour tie moved a
  voxel at these sizes: 0 seg and 0 mask voxels differ).
* ``scripts.quality_eval``: a tiny run reports the JAX script's keys in its
  order, improves Dice, and with ``--phantom brain`` adds the 15
  per-structure rows.
* ``scripts/torch_head_to_head.py --compare`` on run directories written
  from known arrays: correlation, RMSE, ratio and verdicts as computed by
  hand here.
* ``selftest.main()`` without a card prints ``ok: false`` and exits 2;
  ``scripts.ablate_integrator`` runs the ``taylor_comp1`` stage to a report row;
  ``scripts.trace_summary`` groups a Chrome trace's device events.
"""

import ast
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

from ir_sgmcmc_tpu.data import synthetic as jsyn
from ir_sgmcmc_tpu_torch.data import synthetic as tsyn

REPO = Path(__file__).resolve().parents[1]
TINY = ["--magnitude", "2", "--vi-iters", "8", "--burn-in", "4", "--samples", "8",
        "--device", "cpu"]


def _assert_same_pair(jax_pair, port_pair):
    (fj, mj), (ft, mt) = jax_pair, port_pair
    for k in mj:
        assert mt[k].dtype == mj[k].dtype and np.array_equal(mt[k], mj[k]), k
    np.testing.assert_allclose(ft["im"], fj["im"], atol=1e-5, rtol=0)
    for k in ("seg", "mask"):
        assert ft[k].dtype == fj[k].dtype
        assert int((ft[k] != fj[k]).sum()) == 0, k


@pytest.mark.parametrize("n", [16, 24])
def test_svf_pair_matches_jax(n):
    fj, mj, dj = jsyn.svf_pair((n,) * 3, magnitude=4.0, seed=3)
    ft, mt, dt = tsyn.svf_pair((n,) * 3, magnitude=4.0, seed=3, device="cpu")
    _assert_same_pair((fj, mj), (ft, mt))
    assert dt.shape == dj.shape == (3, n, n, n) and dt.dtype == np.float32
    np.testing.assert_allclose(dt, dj, atol=1e-5, rtol=0)


def test_brain_phantom_pair_matches_jax():
    spacing = (1.0, 1.1, 0.9)
    fj, mj, dj, sj, structj = jsyn.brain_phantom_pair((32,) * 3, seed=1, spacing=spacing)
    ft, mt, dt, st, structt = tsyn.brain_phantom_pair((32,) * 3, seed=1, spacing=spacing,
                                                       device="cpu")
    _assert_same_pair((fj, mj), (ft, mt))
    np.testing.assert_allclose(dt, dj, atol=1e-5, rtol=0)
    assert st == sj == spacing and structt == structj and len(structt) == 15


def _jax_report_keys() -> list:
    """The keys of ``scripts/quality_eval.py``'s report dict, in order."""
    tree = ast.parse((REPO / "scripts/quality_eval.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [getattr(t, "id", None) for t in node.targets] == ["report"]):
            return [k.value for k in node.value.keys]
    raise AssertionError("no report dict in scripts/quality_eval.py")


@pytest.mark.parametrize("phantom", ["sphere", "brain"])
def test_quality_eval_cpu(tmp_path, phantom):
    from ir_sgmcmc_tpu_torch.scripts import quality_eval

    report = quality_eval.main(["--dims", "16", "--phantom", phantom, *TINY,
                                "--out-dir", str(tmp_path)])
    keys = _jax_report_keys()
    if phantom == "brain":
        keys += ["per_structure", "mean_asd"]  # the JAX script adds these two
        assert len(report["per_structure"]) == 15 and math.isfinite(report["mean_asd"])
    assert list(report) == keys
    assert report["aborted"] is None and report["phantom"] == phantom
    assert report["dsc_mcmc"] >= report["dsc_before"] - 0.05
    assert json.loads((tmp_path / "report.json").read_text()) == report
    assert (Path(report["run_dir"]) / "fields/MCMC_displacement_std_dev.vtk").exists()


def _h2h():
    spec = importlib.util.spec_from_file_location("torch_head_to_head",
                                                  REPO / "scripts/torch_head_to_head.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_head_to_head_compare_rows(tmp_path, capsys):
    """``--rows``: the scalar verdicts on two ablation files' rows of one
    stage each (error rows and other stages skipped): Dice and calibration
    within their floors pass, a displacement error 0.2 voxels worse
    fails, and the exit code says so."""
    h2h = _h2h()
    keys = ("dsc_mcmc", "disp_err_mean_vox", "disp_err_p95_vox", "uncertainty_calibration_corr")
    rows = {"jax": [("s", 0, (0.974, 0.80, 2.56, 0.476)), ("s", 1, (0.975, 0.81, 2.57, 0.484)),
                    ("other", 0, (0.5, 9.0, 9.0, 0.0))],
            "torch": [("t", 0, (0.9743, 1.0, 2.56, 0.483)), ("t", 1, (0.9745, 1.0, 2.56, 0.482))]}
    paths = {}
    for side, side_rows in rows.items():
        lines = [json.dumps({"stage": st, "trainer_seed": seed, "mcmc_samples_per_sec": 1.0,
                             **dict(zip(keys, vals))}) for st, seed, vals in side_rows]
        lines.append(json.dumps({"stage": "s" if side == "jax" else "t", "trainer_seed": 2,
                                 "error": True, "stderr_tail": "x"}))
        paths[side] = tmp_path / f"{side}.jsonl"
        paths[side].write_text("\n".join(lines) + "\n")
    result = h2h.compare_rows(paths["jax"], "s", paths["torch"], "t")
    assert result["trainer_seeds"] == {"jax": [0, 1], "torch": [0, 1]}
    v = result["verdicts"]
    assert v["dsc_mcmc"]["pass"] and v["uncertainty_calibration_corr"]["pass"]
    assert not v["disp_err_mean_vox"]["pass"] and not result["ok"]
    assert v["dsc_mcmc"]["bound"] == 0.005
    assert abs(v["disp_err_mean_vox"]["delta"] - 0.195) < 1e-9
    assert h2h.main(["--rows", str(paths["jax"]), "s", str(paths["torch"]), "t"]) == 1
    assert json.loads(capsys.readouterr().out.strip())["ok"] is False
    with pytest.raises(ValueError, match="no good row"):
        h2h.compare_rows(paths["jax"], "missing", paths["torch"], "t")


def test_head_to_head_compare(tmp_path):
    """Two seeds per package from known arrays; the port's displacement
    error is 0.2 voxels worse, beyond its bound, so that verdict fails and
    the exit code is 1; the others pass."""
    from ir_sgmcmc_tpu_torch.utils.vtk_io import write_vtk_field

    h2h = _h2h()
    n, magnitude = 8, 2.0
    _, _, disp_gt = tsyn.svf_pair((n,) * 3, magnitude=magnitude, seed=0, device="cpu")
    peak = round(float(np.sqrt((disp_gt ** 2).sum(axis=0)).max()), 3)
    rng = np.random.default_rng(5)
    metrics = {"jax": {"dsc_mcmc": [0.97, 0.98], "disp_err_mean_vox": [0.8, 0.8],
                       "disp_err_p95_vox": [2.0, 2.1], "uncertainty_calibration_corr": [0.45, 0.5]},
               "torch": {"dsc_mcmc": [0.975, 0.985], "disp_err_mean_vox": [1.0, 1.0],
                         "disp_err_p95_vox": [2.2, 2.2],
                         "uncertainty_calibration_corr": [0.47, 0.49]}}
    base = rng.standard_normal((3, n, n, n)).astype(np.float32)
    dirs, fields = {}, {}
    for side, scale in (("jax", 1.0), ("torch", 1.2)):
        for seed in (0, 1):
            d = tmp_path / f"{side}_s{seed}"
            mean = (base + 0.1 * rng.standard_normal(base.shape)).astype(np.float32)
            std = (scale * (0.5 + rng.random(base.shape))).astype(np.float32)
            (d / "demo_synthetic/quality/fields").mkdir(parents=True)
            write_vtk_field(d / "demo_synthetic/quality/fields/MCMC_displacement_mean.vtk", mean)
            write_vtk_field(d / "demo_synthetic/quality/fields/MCMC_displacement_std_dev.vtk", std)
            report = {"dims": n, "phantom": "sphere", "seed": 0, "trainer_seed": seed,
                      "gt_peak_disp_vox": peak, "wall_s": 1.0,
                      **{k: v[seed] for k, v in metrics[side].items()}}
            (d / "report.json").write_text(json.dumps(report))
            dirs.setdefault(side, []).append(d)
            fields.setdefault(side, []).append((mean, std))

    out = tmp_path / "h2h.json"
    rc = h2h.main(["--compare", *map(str, dirs["jax"]), "--torch", *map(str, dirs["torch"]),
                   "--magnitude", str(magnitude), "--out", str(out)])
    res = json.loads(out.read_text())
    assert rc == 1 and res["ok"] is False

    mj = np.mean([m for m, _ in fields["jax"]], axis=0).ravel()
    mt = np.mean([m for m, _ in fields["torch"]], axis=0).ravel()
    sj = np.mean([s for _, s in fields["jax"]], axis=0).ravel()
    st = np.mean([s for _, s in fields["torch"]], axis=0).ravel()
    assert res["posterior_mean"]["corr"] == pytest.approx(np.corrcoef(mj, mt)[0, 1], abs=1e-9)
    assert res["posterior_mean"]["rmse_vox"] == pytest.approx(
        math.sqrt(float(((mt - mj) ** 2).mean())), rel=1e-6)
    ratio = float(np.median(st / sj))
    assert res["posterior_std"]["median_ratio_torch_over_jax"] == pytest.approx(ratio, rel=1e-6)
    log_hs = sum((max(v) - min(v)) / 2 for v in (
        [math.log(float(np.median(s))) for _, s in fields[side]] for side in ("jax", "torch")))
    v = res["verdicts"]
    assert v["posterior_std_ratio"]["bound"] == pytest.approx(max(2 * log_hs, math.log(1.1)))
    assert v["posterior_std_ratio"]["pass"] == (abs(math.log(ratio))
                                                <= v["posterior_std_ratio"]["bound"])
    assert v["posterior_mean_corr"]["pass"] is True  # ~0.99 against 0.98
    assert v["dsc_mcmc"] == {"delta": pytest.approx(0.005), "bound": pytest.approx(0.02),
                             "pass": True}
    assert v["disp_err_mean_vox"] == {"delta": pytest.approx(0.2), "bound": pytest.approx(0.05),
                                      "pass": False}
    assert v["uncertainty_calibration_corr"]["bound"] == pytest.approx(0.07)
    assert v["uncertainty_calibration_corr"]["pass"] is True
    assert res["metrics"]["disp_err_p95_vox"]["torch"]["mean"] == pytest.approx(2.2)
    assert "disp_err_p95_vox" not in v  # reported, without a verdict
    # the two packages' pairs, regenerated: the same to float32 rounding
    assert res["pair"]["disp_gt_max_abs_diff"] <= 1e-5
    assert res["pair"]["seg_voxels_differ"] == 0
    with pytest.raises(ValueError, match="magnitude"):
        h2h._pairs({"dims": n, "phantom": "sphere", "seed": 0, "gt_peak_disp_vox": peak},
                   magnitude + 1.0)


def test_selftest_without_card_exits_2(monkeypatch, capsys):
    from ir_sgmcmc_tpu_torch import selftest

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert selftest.main() == 2
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] is False and "error" in out
    with pytest.raises(ValueError, match="CUDA"):
        selftest.run_selftest("cpu")


def test_ablation_taylor_comp1_stage_runs(tmp_path):
    """The JAX script's ``taylor_comp1`` stage (Taylor compositions at
    threshold 1.0) runs its ``quality_eval`` subprocess to a report row, not
    an error row, whether its MCMC phase finishes or a guard aborts it (the
    JAX package's rows at 128³ abort)."""
    from ir_sgmcmc_tpu_torch.scripts import ablate_integrator

    out = tmp_path / "ablation.jsonl"
    ablate_integrator.main(["--out", str(out), "--stages", "taylor_comp1", "--seeds", "0",
                            "--dims", "8", "--vi-iters", "4", "--burn-in", "2", "--samples",
                            "4", "--device", "cpu"])
    (row,) = [json.loads(x) for x in out.read_text().splitlines()]
    assert row["stage"] == "taylor_comp1" and "error" not in row, row
    assert row["taylor_compositions"] == "on" and row["taylor_threshold"] == 1.0


def test_trace_summary_groups_device_events(tmp_path, capsys):
    from ir_sgmcmc_tpu_torch.kernels.split_warp import B1
    from ir_sgmcmc_tpu_torch.scripts import trace_summary

    events = [
        {"ph": "X", "cat": "kernel", "name": "void split_fwd_kernel<16>(Geom)", "dur": 70.0},
        {"ph": "X", "cat": "kernel", "name": "void split_fwd_kernel<16>(Geom)", "dur": 80.0},
        {"ph": "X", "cat": "kernel", "name": "void fwd_window_kernel<2>(float const*)", "dur": 40.0},
        {"ph": "X", "cat": "kernel", "name": "void at::vectorized_elementwise_kernel<4>()",
         "dur": 11.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)", "dur": 5.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 500.0},  # host: not counted
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    kinds = trace_summary.group(trace_summary.load_events(path))
    assert {k: (r["us"], r["launches"]) for k, r in kinds.items()} == {
        "B1": (150.0, 2), "B3": (40.0, 1), "elementwise": (11.0, 1), "copies": (5.0, 1)}
    assert kinds["B3"]["kernels"] == {"fwd_window_kernel<2>"}
    trace_summary.main([str(path), "--steps", "2", "--shape", "B1=2,3,128,128,128"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("2 steps, device kernel time 0.103 ms per step over 2 launches")
    b1 = next(line for line in out if line.startswith("void split_fwd_kernel<16>"))
    bound_ms, by = B1.bound_ms((2, 3, 128, 128, 128))
    assert f"{100 * 1e3 * bound_ms / 75.0:6.1f}% ({by})" in b1
