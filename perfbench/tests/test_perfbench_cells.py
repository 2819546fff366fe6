"""Every cell's files are found by name, a new cell is files and entries
alone, and ``BENCHMARK.json`` keeps to the shape of its contract."""

import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(workload):
    spec = run.load_cell(workload)
    assert spec.traffic["phase"] in ("mcmc", "vi")
    # whole blocks of the block warp along every axis
    assert all(n % 8 == 0 for n in spec.config["data_loader"]["args"]["dims"])
    assert set(spec.limits) >= {"loss_gap", "grad_gap", "change_gap"}
    assert spec.per_layer and all(spec.readers[m["name"]].exists() for m in spec.per_layer)
    for m in spec.per_layer:
        assert callable(run.load_reader(spec.readers[m["name"]]))
    reported = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert all(m["moves"] in reported for m in spec.per_layer)


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("workloads", "end_to_end", "per_layer", "configs"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_a_new_cell_is_files_and_entries(tmp_path):
    """A later change adds a traffic mix, a cell, its limits and a per-layer
    metric as new files and entries, and the harness finds them."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    mix = json.loads((tmp_path / "perfbench/traffic/mcmc_pairs4.json").read_text())
    mix["pairs"] = 2
    (tmp_path / "perfbench/traffic/mcmc_pairs2.json").write_text(json.dumps(mix))
    (tmp_path / "perfbench/limits/exp3_svf128.mcmc_pairs2.json").write_text(
        json.dumps({"loss_gap": 1e-6, "grad_gap": 1e-5, "change_gap": 1e-5}))
    (tmp_path / "perfbench/metrics/window_steps.mcmc.py").write_text(
        "def read(ctx):\n    return ctx.steps if ctx.phase == 'mcmc' else None\n")
    bench["workloads"].append({"name": "exp3_svf128.mcmc_pairs2", "config": "exp3_svf128",
                               "traffic": "mcmc_pairs2", "chips": 1, "why": "two pairs"})
    for m in bench["end_to_end"]:
        if m["name"] in ("mcmc_samples_per_s", "mcmc_transition_ms_p95"):
            m["workloads"].append("exp3_svf128.mcmc_pairs2")
    bench["per_layer"].append({"name": "window_steps.mcmc", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "engine",
                               "moves": "mcmc_samples_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = run.load_cell("exp3_svf128.mcmc_pairs2", tmp_path / "BENCHMARK.json")
    assert spec.traffic["pairs"] == 2 and spec.limits["loss_gap"] == 1e-6
    names = {m["name"] for m in spec.per_layer}
    # the metrics that list no cells come with the phase; a kernel roofline
    # lists the cells whose kernels' shapes it knows
    assert {"window_steps.mcmc", "launches_per_step.mcmc", "step_mfu.mcmc"} <= names
    assert "kernel_roofline.mcmc" not in names and "launches_per_step.vi" not in names
    assert {m["name"] for m in spec.end_to_end} == {"setup_s", "mcmc_samples_per_s",
                                                    "mcmc_transition_ms_p95"}
    read = run.load_reader(spec.readers["window_steps.mcmc"])
    assert read(type("Ctx", (), {"steps": 7, "phase": "mcmc"})) == 7
    # every existing cell still finds its own files beside the new one
    for w in BENCH["workloads"]:
        assert run.load_cell(w["name"], tmp_path / "BENCHMARK.json").name == w["name"]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_the_traffic_sets_the_noise_scheme(workload):
    """The traffic's noise scheme is the one the program and the reference
    read; the reference refuses a scheme it does not follow."""
    import torch

    from perfbench import drive, reference

    spec = run.load_cell(workload)
    cfg = drive.configured(spec.config, spec.traffic)
    assert cfg["trainer"]["uniform_noise"]["scheme"] == spec.traffic["noise_scheme"] == "post"
    pre = drive.configured(spec.config, dict(spec.traffic, noise_scheme="pre"), dims=(16,) * 3)
    assert pre["trainer"]["uniform_noise"]["scheme"] == "pre"
    with pytest.raises(ValueError, match="post"):
        reference.Model(pre, torch.device("cpu"))


def _published(entry) -> dict:
    """The reference's published configuration the entry's ``source``
    names, from the repository's copy of the reference's ``configs/``."""
    return json.loads((ROOT / entry["source"].split("/blob/master/", 1)[1]).read_text())


@pytest.mark.parametrize("entry", BENCH["configs"], ids=[c["name"] for c in BENCH["configs"]])
def test_a_changed_volume_says_why(entry):
    """A configuration whose ``dims`` differ from its source's lists the
    loader among the keys it changed and says why under ``assumed``."""
    config = json.loads((ROOT / entry["file"]).read_text())
    dims = config["data_loader"]["args"]["dims"]
    assert config["reduced"] == entry["reduced"]
    if dims == _published(entry)["data_loader"]["args"]["dims"]:
        assert "data_loader" not in entry["reduced"]
        return
    assert "data_loader" in entry["reduced"]
    said = " ".join(str(v) for v in config["assumed"].values())
    assert (f"{dims[0]}^3" if len(set(dims)) == 1 else "x".join(map(str, dims))) in said


def test_exp3_at_256_is_exp3_at_128_but_the_volume():
    small = json.loads((ROOT / "perfbench/configs/exp3_svf128.json").read_text())
    large = json.loads((ROOT / "perfbench/configs/exp3_svf256.json").read_text())
    assert large["data_loader"]["args"].pop("dims") == [256, 256, 256]
    assert small["data_loader"]["args"].pop("dims") == [128, 128, 128]
    assert large["assumed"].pop("data") != small["assumed"].pop("data")
    assert large.pop("reduced") == small.pop("reduced") + ["data_loader"]
    assert large == small


@pytest.mark.parametrize("dims, remat", [
    ((128, 128, 128), "auto"), ((205, 205, 205), "auto"), ((206, 206, 206), "auto"),
    ((256, 256, 256), "auto"), ((208, 256, 256), "auto"), ((256, 256, 256), False),
    ((128, 128, 128), True)])
def test_the_remat_rule_is_the_trainers(tmp_path, monkeypatch, dims, remat):
    """``drive.vi_remat`` decides as ``Trainer`` does: the trainer is built
    at 12³ with its model's ``dims`` read as ``dims``."""
    from ir_sgmcmc_tpu_torch.config import Config
    from ir_sgmcmc_tpu_torch.trainer import Trainer

    from perfbench import drive

    cfg = json.loads((ROOT / "configs/demo/config_synthetic.json").read_text())
    cfg["data_loader"]["args"]["dims"] = [12, 12, 12]
    cfg["transformation_module"]["args"] = {"no_steps": 6, "max_disp": 4}
    cfg["trainer"].update(save_dir=str(tmp_path), tensorboard=False)
    if remat != "auto":
        cfg["trainer"]["vi_remat"] = remat
    config = Config(cfg, run_id="remat")
    build = config.build_bundle

    class Seen:
        def __init__(self, bundle):
            self._bundle = bundle

        def __getattr__(self, name):
            return dims if name == "dims" else getattr(self._bundle, name)

    monkeypatch.setattr(config, "build_bundle", lambda: Seen(build()))
    trainer = Trainer(config, device="cpu")
    harness = json.loads(json.dumps(cfg))
    harness["data_loader"]["args"]["dims"] = list(dims)
    assert drive.vi_remat(harness) is trainer.vi_remat
    if remat == "auto":
        assert trainer.vi_remat is (dims[0] >= 206)
