"""The harness over a step cut along D: the cells of experiment 3 with the
trainer's ``distribute`` and ``spatial_shards`` (``vi_spatial_shards``) 4,
on the CPU over four virtual shards (``[cpu] * 4``, which the port's mesh
allows) at 64³: 16 planes a slab, whole blocks of the block warp."""

import copy
import json
import shutil
from pathlib import Path

import pytest
import torch

from perfbench import check, drive, reference, run

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 1979
CPU = torch.device("cpu")
DIMS = (64, 64, 64)
CELLS = {"mcmc": "exp3_svf256.mcmc_pair1", "vi": "exp3_svf256.vi_pair1"}


def _spec(phase: str, shards: int = 4):
    spec = run.load_cell(CELLS[phase])
    spec.config["trainer"].update(distribute=True, spatial_shards=shards,
                                  vi_spatial_shards=shards)
    return spec


def _run(phase: str, fault=None, shards: int = 4):
    return run.run_cell(_spec(phase, shards), SEED, 0.1, False, [CPU] * shards, dims=DIMS,
                        fault=fault)


def _program(phase: str, shards: int):
    """The cell's program from the seed after its first three steps: the
    per-step losses and its leaves."""
    spec = _spec(phase, shards)
    cfg = drive.configured(spec.config, spec.traffic, DIMS)
    inputs = drive.Inputs(SEED, spec.traffic, DIMS, reference.Model(cfg, CPU).field_dims, CPU)
    program = drive.Program(cfg, spec.traffic, inputs, [CPU] * shards)
    assert (program.mesh is None) is (shards == 1)
    if program.phase == "vi":
        program.gmm_warmup()
    losses = torch.cat([program.call() for _ in range(3)])
    return losses, program.leaves()


@pytest.mark.parametrize("phase", ["mcmc", "vi"])
def test_sharded_program_agrees_with_one_device(phase):
    """Sharded sums add in another order: every step's loss within PR 14's
    4.8e-7 of the one-device run's.  The SG-MCMC leaves' norms agree as
    closely; VI's q(v) moves under Adam by the sign of round-off where its
    gradient is nought, which the comparison leaves out and so does not
    hold here (``test_sharded_run_is_correct`` holds it)."""
    one, leaves_one = _program(phase, 1)
    four, leaves_four = _program(phase, 4)
    assert float(((four - one).abs() / one.abs()).max()) <= 4.8e-7
    assert leaves_four.keys() == leaves_one.keys()
    for k in leaves_one:
        assert leaves_four[k].shape == leaves_one[k].shape and leaves_four[k].device == CPU
    if phase == "mcmc":
        assert check._worst(leaves_four, leaves_one, trim=0.0)[0] <= 4.8e-7


@pytest.mark.parametrize("phase", ["mcmc", "vi"])
def test_sharded_run_is_correct(phase):
    out = _run(phase)
    assert out["correct"] is True, out["checked"]
    assert out["failed"] == 0 and set(out["metrics"]) >= {"setup_s"}
    assert out["device"]["count"] == 1  # four virtual shards of one device


@pytest.mark.parametrize("phase, fault", [
    ("mcmc", "unchanged"), ("mcmc", "half"), ("mcmc", "tile"), ("mcmc", "dgrad_tile"),
    ("mcmc", "seam"), ("vi", "half_sample"), ("vi", "tile"), ("vi", "seam")])
def test_a_broken_sharded_step_is_not_correct(phase, fault):
    """Each planted fault reaches the sharded step through its own
    functions and fails a number; ``seam``, a slab's halo from the wrong
    neighbour, is the sharding's own failure."""
    out = _run(phase, fault)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checked"].values()), out["checked"]


def test_the_seam_fault_leaves_one_device_as_it_is():
    """One device exchanges no halo: its run under ``seam`` is bitwise the
    sound run."""
    spec = run.load_cell(CELLS["mcmc"])
    cfg = drive.configured(spec.config, spec.traffic, DIMS)
    out = []
    for fault in (None, "seam"):
        inputs = drive.Inputs(SEED, spec.traffic, DIMS, DIMS, CPU)
        program = drive.Program(cfg, spec.traffic, inputs, CPU, fault=fault)
        program.call()
        out.append(program.leaves())
    assert all(torch.equal(out[0][k], out[1][k]) for k in out[0])


def test_one_device_list_is_the_one_device_run():
    """``[device]`` is the run on ``device``: one card's cells take the path
    they took before the sharded one existed."""
    spec = run.load_cell(CELLS["mcmc"])
    a = run.run_cell(spec, SEED, 0.1, False, CPU, dims=DIMS)
    b = run.run_cell(spec, SEED, 0.1, False, [CPU], dims=DIMS)
    assert a["checked"] == b["checked"] and a["where"] == b["where"]


def _trainer_config(tmp_path, phase: str, dims, **trainer) -> dict:
    """Experiment 3's configuration as the cells run it, on the synthetic
    loader at ``dims`` so that the trainer builds its own data."""
    spec = run.load_cell(CELLS[phase])
    cfg = drive.configured(spec.config, spec.traffic)
    args = cfg["data_loader"]["args"]
    cfg["data_loader"] = {"type": "SyntheticDataLoader",
                          "args": {"dims": list(dims), "sigma_v_init": args["sigma_v_init"],
                                   "u_v_init": args["u_v_init"]}}
    cfg["trainer"].update(save_dir=str(tmp_path), tensorboard=False, **trainer)
    return cfg


@pytest.mark.parametrize("phase, dims, model, trainer", [
    ("mcmc", (64, 64, 64), "SVF", dict(distribute=True, spatial_shards=4)),
    ("mcmc", (64, 64, 64), "SVF", dict(spatial_shards=2)),
    ("mcmc", (64, 64, 64), "SVF", dict(distribute=False, spatial_shards=4)),
    ("mcmc", (64, 64, 64), "SVF", dict(distribute=True, spatial_shards=4,
                                      MCMC_params="shared")),
    ("mcmc", (80, 64, 64), "SVF", dict(distribute=True, spatial_shards=4)),  # 20-plane slabs
    ("mcmc", (66, 64, 64), "SVF", dict(distribute=True, spatial_shards=4)),  # D not in 4
    ("mcmc", (40, 64, 64), "SVF", dict(distribute=True, spatial_shards=4)),  # no block warp
    ("mcmc", (64, 64, 64), "SVFFD", dict(distribute=True, spatial_shards=4)),
    ("mcmc", (64, 64, 64), "SVF", dict(distribute=True, spatial_shards=1)),
    ("vi", (64, 64, 64), "SVF", dict(distribute=True, vi_spatial_shards=4)),
    ("vi", (64, 64, 64), "SVF", dict(distribute=True, vi_spatial_shards="auto")),
    ("vi", (64, 64, 64), "SVF", dict(distribute=False, vi_spatial_shards=4)),
    ("vi", (80, 64, 64), "SVF", dict(distribute=True, vi_spatial_shards=4)),
    ("vi", (64, 64, 64), "SVFFD", dict(distribute=True, vi_spatial_shards=2)),
])
def test_the_shards_rule_is_the_trainers(tmp_path, phase, dims, model, trainer):
    """``drive.spatial_shards`` decides as ``Trainer`` does when the trainer
    is given as many devices (virtual, on the CPU) as the configuration asks
    for."""
    from ir_sgmcmc_tpu_torch.config import Config
    from ir_sgmcmc_tpu_torch.trainer import Trainer

    cfg = _trainer_config(tmp_path, phase, dims, **trainer)
    if model == "SVFFD":
        cfg["transformation_module"] = {"type": "SVFFD_3D", "args": {"cps": [2, 2, 2]}}
    asked = trainer.get("spatial_shards" if phase == "mcmc" else "vi_spatial_shards", 1)
    devices = [CPU] * (asked if isinstance(asked, int) and asked > 1 else 1)
    t = Trainer(Config(json.loads(json.dumps(cfg)), run_id="shards"), devices=devices)
    want = t._mcmc_spatial_shards() if phase == "mcmc" else t._vi_spatial_shards()
    assert drive.spatial_shards(cfg, phase) == want
    assert drive.spatial_shards(cfg, phase, t.bundle) == want


@pytest.mark.parametrize("chips, pairs, refused", [(1, 1, True), (4, 1, False), (4, 2, True)])
def test_a_sharded_cell_asks_for_its_cards_and_one_pair(tmp_path, chips, pairs, refused):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "perfbench/configs/exp3_svf256.json").read_text())
    cfg["trainer"].update(distribute=True, spatial_shards=4)
    (tmp_path / "perfbench/configs/space4.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "perfbench/traffic/mcmc_pair1.json").read_text())
    mix["pairs"] = pairs
    (tmp_path / "perfbench/traffic/mix.json").write_text(json.dumps(mix))
    bench["configs"].append({"name": "space4", "source": "x", "file": "perfbench/configs/space4.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "space4.mix", "config": "space4", "traffic": "mix",
                               "chips": chips, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    if refused:
        with pytest.raises(SystemExit):
            run.load_cell("space4.mix", tmp_path / "BENCHMARK.json")
    else:
        assert run.load_cell("space4.mix", tmp_path / "BENCHMARK.json").shards == 4
    for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]:
        assert run.load_cell(w["name"]).shards == w["chips"] == 1


@pytest.mark.parametrize("phase", ["mcmc", "vi"])
def test_the_recompute_reference_is_the_plain_one_bitwise(phase):
    spec = run.load_cell(CELLS[phase])
    cfg = drive.configured(spec.config, spec.traffic, DIMS)
    inputs = drive.Inputs(SEED, spec.traffic, DIMS, DIMS, CPU)
    out = []
    for recompute in (False, True):
        model = reference.Model(cfg, CPU, recompute=recompute)
        fixed, moving = inputs.pairs[0]
        if phase == "mcmc":
            out.append(reference.mcmc_chain(model, fixed, moving, inputs.v0[0, 0],
                                             inputs.keys[0, 0].tolist(), 2))
        else:
            out.append(reference.vi_pair(model, fixed, moving, inputs.keys[0].tolist(), 2, 5))
    plain, again = out
    assert torch.equal(plain["losses"], again["losses"])
    for part in ("first", "leaves"):
        assert plain[part].keys() == again[part].keys()
        assert all(torch.equal(plain[part][k], again[part][k]) for k in plain[part])


def test_the_reference_rows_take_turns_over_the_cards(monkeypatch):
    """Row ``r`` runs on the ``r``-th card, under recompute where its plain
    step would leave no room on that card (here: a card of 1 MiB)."""
    seen = []

    def chain(model, fixed, moving, v0, words, steps):
        seen.append((model.device, model.recompute, v0.device, fixed["im"].device))
        return {}

    monkeypatch.setattr(reference, "mcmc_chain", chain)
    monkeypatch.setattr(check, "card_bytes",
                        lambda d: 2 ** 20 if torch.device(d).type == "meta" else None)
    spec = run.load_cell(CELLS["mcmc"])
    cfg = drive.configured(spec.config, spec.traffic, (16, 16, 16))
    inputs = drive.Inputs(SEED, spec.traffic, (16,) * 3, (16,) * 3, CPU)
    meta = torch.device("meta")
    check.reference_run("mcmc", cfg, spec.traffic, copy.copy(inputs), [CPU, meta, meta, CPU])
    assert [(s[0], s[1]) for s in seen] == [(CPU, False), (meta, True)]
    assert all(s[0] == s[2] == s[3] for s in seen)
    seen.clear()
    check.reference_run("mcmc", cfg, spec.traffic, inputs, CPU)
    assert [(s[0], s[1]) for s in seen] == [(CPU, False), (CPU, False)]


@pytest.mark.parametrize("phase, side, card_gib, recompute", [
    ("mcmc", 128, 79.19, False), ("mcmc", 256, 79.19, False), ("vi", 256, 79.19, False),
    ("mcmc", 512, 79.19, True), ("vi", 512, 79.19, True), ("mcmc", 256, 24.0, True),
    ("vi", 256, 40.0, True), ("mcmc", 512, None, False)])
def test_the_reference_recomputes_where_its_plain_step_leaves_no_room(monkeypatch, phase, side,
                                                                      card_gib, recompute):
    """The cells' 128³ and 256³ rows run plain on an 80 GB card (79.19 GiB),
    512³ rows under recompute; a smaller card recomputes sooner, the CPU
    never."""
    monkeypatch.setattr(check, "card_bytes",
                        lambda d: None if card_gib is None else int(card_gib * 2 ** 30))
    spec = run.load_cell(CELLS[phase])
    cfg = drive.configured(spec.config, spec.traffic, (side,) * 3)
    assert check.recompute_on(phase, cfg, CPU) is recompute
