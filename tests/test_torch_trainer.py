"""The port's trainer, config and CLI end to end on the CPU: a twin of each
test of ``tests/test_trainer.py`` at the same 12³ settings (the JAX
trainer's Pallas fallback has none: the port has no kernel fallback), the
CLI, and the opt-in options (``mcmc_anchor`` among them) run end to end.

Imports nothing of JAX, so it also runs on a host without it.
"""

import collections
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

from ir_sgmcmc_tpu_torch.config import Config
from ir_sgmcmc_tpu_torch.engine import VIState
from ir_sgmcmc_tpu_torch.trainer import DisplacementSaturationAbort, Trainer
from ir_sgmcmc_tpu_torch.utils.checkpoint import load_checkpoint, peek_meta, save_checkpoint

REPO = Path(__file__).parent.parent
DEMO = REPO / "configs/demo/config_synthetic.json"


def _demo_cfg(tmp_path, **trainer_overrides):
    cfg = json.loads(DEMO.read_text())
    cfg["data_loader"]["args"]["dims"] = [12, 12, 12]
    cfg["transformation_module"]["args"] = {"no_steps": 6, "max_disp": 4}
    cfg["trainer"].update(
        save_dir=str(tmp_path),
        no_iters_VI=8,
        log_period_VI=4,
        no_samples_VI_test=3,
        no_chains=2,
        no_iters_burn_in=3,
        no_samples_MCMC=5,
        log_period_MCMC=4,
        speed_test_iters=2,
        tensorboard=False,
    )
    cfg["trainer"].update(trainer_overrides)
    return Config(cfg, run_id="test")


def _trainer(config, **kw):
    return Trainer(config, device="cpu", **kw)


def _vi_state(trainer, mu: float) -> VIState:
    """A VI state centred on a constant ``mu`` with (nearly) zero spread."""
    _, _, q_v0 = trainer.dataset[0]
    shape = np.asarray(q_v0["mu"]).shape
    q_v = {"mu": torch.full(shape, mu), "log_var": torch.full(shape, -20.0),
           "u": torch.zeros(shape)}
    b = trainer.bundle
    gmm, reg = b.gmm.init_params("cpu"), b.reg_loss.init_params("cpu")
    return VIState(q_v=q_v, gmm=gmm, reg=reg, opt_q_v=trainer.opt_q_v.init(q_v),
                   opt_gmm=trainer.opt_gmm.init(gmm), opt_reg=trainer.opt_reg.init(reg),
                   key=torch.tensor([0, 0]), step=0)


def _pair(trainer):
    fixed_np, moving_np, _ = trainer.dataset[0]
    return trainer._to_device(fixed_np), trainer._to_device(moving_np)


def test_trainer_end_to_end(tmp_path):
    config = _demo_cfg(tmp_path)
    summaries = _trainer(config).run()

    assert len(summaries) == 1
    s = summaries[0]
    assert np.isfinite(s["vi_time_s"])
    assert s["vi_samples_per_sec"] > 0
    assert s["mcmc_samples_per_sec"] > 0
    assert "mcmc_aborted" not in s
    # registration should not damage alignment on a translated sphere
    assert s["vi_test_mean_dsc"] >= s["dsc_before"] - 0.05
    assert s["mcmc_mean_dsc"] >= s["dsc_before"] - 0.05

    run_dir = config.dir
    assert (run_dir / "images/im_fixed.nii.gz").exists()
    assert (run_dir / "fields/VI_displacement_mean.vtk").exists()
    assert (run_dir / "fields/MCMC_displacement_std_dev.vtk").exists()
    assert (run_dir / "models/vi_latest.npz").exists()
    assert (run_dir / "models/mcmc_latest.npz").exists()
    assert list((run_dir / "samples/VI").glob("sample_*_im_warped.nii.gz"))
    assert list((run_dir / "samples/MCMC").glob("chain_*_im_warped.nii.gz"))


def test_trainer_mcmc_cold_start(tmp_path):
    config = _demo_cfg(tmp_path, VI=False, MCMC=True, MCMC_init="noise",
                       no_samples_MCMC=4, no_iters_burn_in=2)
    summaries = _trainer(config).run()
    assert summaries[0]["mcmc_samples_per_sec"] > 0


def test_checkpoint_roundtrip(tmp_path):
    state = {
        "a": np.arange(6, dtype=np.float32).reshape(2, 3),
        "b": {"c": np.ones(4, np.int32)},
    }
    path = tmp_path / "ckpt.npz"
    save_checkpoint(path, state, {"phase_done": 1, "step": 42})
    like = {"a": np.zeros((2, 3), np.float32), "b": {"c": np.zeros(4, np.int32)}}
    restored, meta = load_checkpoint(path, like)
    assert meta["phase_done"] == 1 and meta["step"] == 42
    assert meta["format_version"] == 2
    np.testing.assert_array_equal(restored["a"], state["a"])
    np.testing.assert_array_equal(restored["b"]["c"], state["b"]["c"])

    bad = {"a": np.zeros((3, 2), np.float32), "b": {"c": np.zeros(4, np.int32)}}
    with pytest.raises(ValueError):
        load_checkpoint(path, bad)

    # torch leaves come back on the template's dtype and device
    t_like = {"a": torch.zeros((2, 3)), "b": {"c": torch.zeros(4, dtype=torch.int32)}}
    t_restored, _ = load_checkpoint(path, t_like)
    assert t_restored["b"]["c"].dtype == torch.int32
    np.testing.assert_array_equal(t_restored["a"].numpy(), state["a"])


def test_checkpoint_rejects_renamed_or_reordered_leaves(tmp_path):
    """Leaves are keyed by path: a template whose leaf names differ is
    rejected even when every shape coincides."""
    state = {"mu": np.zeros((3, 4), np.float32), "u": np.ones((3, 4), np.float32)}
    path = tmp_path / "ckpt.npz"
    save_checkpoint(path, state, {"phase": "VI"})

    renamed = {"mu_v": np.zeros((3, 4), np.float32), "u": np.ones((3, 4), np.float32)}
    with pytest.raises(ValueError, match="missing keys"):
        load_checkpoint(path, renamed)

    # named-tuple field reorder: each field gets ITS value back
    A = collections.namedtuple("A", ["mu", "u"])
    B = collections.namedtuple("B", ["u", "mu"])
    save_checkpoint(path, A(np.zeros((2, 2), np.float32), np.ones((2, 2), np.float32)))
    restored, _ = load_checkpoint(path, B(np.zeros((2, 2)), np.zeros((2, 2))))
    np.testing.assert_array_equal(restored.mu, np.zeros((2, 2)))
    np.testing.assert_array_equal(restored.u, np.ones((2, 2)))


def test_resume_unknown_phase_rejected(tmp_path):
    """A checkpoint whose metadata names no phase is refused, not guessed."""
    ckpt = tmp_path / "mystery.npz"
    save_checkpoint(ckpt, {"x": np.zeros(3, np.float32)}, {})
    config = _demo_cfg(tmp_path / "run", MCMC=False, no_samples_VI_test=0)
    with pytest.raises(ValueError, match="neither the VI nor the MCMC phase"):
        _trainer(config, resume=str(ckpt)).run()


def test_vi_resume(tmp_path):
    config = _demo_cfg(tmp_path, MCMC=False, no_samples_VI_test=0)
    _trainer(config).run()
    ckpt = config.save_dirs["models"] / "vi_latest.npz"
    assert ckpt.exists()
    assert peek_meta(ckpt)["vi_iters"] == 8

    config2 = _demo_cfg(tmp_path / "resumed")
    config2.cfg["trainer"]["MCMC"] = False
    config2.cfg["trainer"]["no_samples_VI_test"] = 0
    summaries = _trainer(config2, resume=str(ckpt)).run()
    # resumed at vi_iters=8 == no_iters_VI, so the VI loop is a no-op
    assert summaries[0]["vi_time_s"] < 30.0


def test_mcmc_saturation_guard(tmp_path):
    """Displacements beyond the bounded warp's ``max_disp`` trip the
    saturation abort instead of silently clamping."""
    config = _demo_cfg(tmp_path, VI=False, MCMC=True, MCMC_init="VI",
                       no_iters_burn_in=0, no_samples_MCMC=2,
                       log_period_MCMC=1, no_samples_VI_test=0,
                       speed_test_iters=1)
    config.cfg["transformation_module"]["args"] = {"no_steps": 6, "max_disp": 2}
    trainer = _trainer(config)
    trainer.save_dirs = config.save_dirs
    fixed, moving = _pair(trainer)
    # a posterior centred on a 6-voxel translation: far beyond max_disp=2,
    # fold-free (the diffeo guard stays quiet), but clamped by the warp
    summary = trainer._run_mcmc_phase(fixed, moving, _vi_state(trainer, 6.0))
    assert "saturat" in summary.get("mcmc_aborted", "")
    assert "mcmc_mean_dsc" not in summary  # no quality report after an abort


def test_mcmc_block_residual_auto_escalation(tmp_path):
    """A saturation abort whose binding counter is the block-residual one
    raises block_warp.radius, resumes from the last clean period, and the
    phase completes."""
    config = _demo_cfg(tmp_path, VI=False, MCMC=True, MCMC_init="VI",
                       no_iters_burn_in=0, no_samples_MCMC=4,
                       log_period_MCMC=1, no_samples_VI_test=0,
                       speed_test_iters=1)
    trainer = _trainer(config)
    trainer.save_dirs = config.save_dirs

    real_check = trainer._check_saturation
    fired = {"n": 0}

    def fake_check(sat, sat_resid, step, phase):
        # force ONE block-residual abort once a clean period exists
        if phase == "MCMC" and step >= 2 and fired["n"] == 0:
            fired["n"] = 1
            err = DisplacementSaturationAbort("forced block-residual overflow")
            err.sat = err.sat_resid = 10_000_000
            raise err
        return real_check(sat, sat_resid, step, phase)

    trainer._check_saturation = fake_check
    fixed, moving = _pair(trainer)
    summary = trainer._run_mcmc_phase(fixed, moving, _vi_state(trainer, 0.0))
    assert "mcmc_aborted" not in summary
    assert fired["n"] == 1
    esc = summary["block_radius_escalations"]
    assert esc and esc[0]["radius"] == 3
    assert trainer.bundle.block_radius == 3
    assert "mcmc_mean_dsc" in summary  # the phase ran to completion


def test_saturation_guard_names_the_binding_lever(tmp_path):
    """The guard names the lever of the counter that tripped: the
    displacement clamp bound (max_disp) or the block-gather warp's in-block
    residual radius (block_warp.radius), which max_disp does not move."""
    trainer = _trainer(_demo_cfg(tmp_path))

    with pytest.raises(DisplacementSaturationAbort) as e:
        trainer._check_saturation(sat=10_000, sat_resid=0, step=1, phase="MCMC")
    assert "max_disp" in str(e.value)
    assert "block_warp.radius" not in str(e.value)

    with pytest.raises(DisplacementSaturationAbort) as e:
        trainer._check_saturation(sat=10_000, sat_resid=10_000, step=1, phase="MCMC")
    msg = str(e.value)
    assert "block_warp.radius" in msg and "in-block" in msg
    assert "raising max_disp does not help" in msg


def test_config_overrides(tmp_path):
    config = Config.from_file(
        DEMO, overrides={"trainer;no_iters_VI": 7, "trainer;save_dir": str(tmp_path)},
        make_dirs=False,
    )
    assert config["trainer"]["no_iters_VI"] == 7
    with pytest.raises(KeyError, match="no such key 'nope'"):
        Config.from_file(DEMO, overrides={"nope;x": 1}, make_dirs=False)


def test_multi_pair_artifact_isolation(tmp_path):
    """Two moving volumes -> two pairs; artifacts land in separate trees."""
    from ir_sgmcmc_tpu_torch.utils.nifti import write_nifti

    rng = np.random.default_rng(0)
    data = tmp_path / "data"
    (data / "masks").mkdir(parents=True)
    (data / "segs").mkdir()
    for i in range(3):
        write_nifti(data / f"s{i}.nii.gz", rng.random((10, 10, 10)).astype(np.float32))
        write_nifti(data / "masks" / f"s{i}.nii.gz", np.ones((10, 10, 10), np.uint8))
        write_nifti(data / "segs" / f"s{i}.nii.gz",
                    (rng.random((10, 10, 10)) > 0.5).astype(np.int16))

    config = _demo_cfg(tmp_path / "runs", MCMC=False, no_iters_VI=2,
                       log_period_VI=2, no_samples_VI_test=0)
    config.cfg["data_loader"] = {
        "type": "BiobankDataLoader",
        "args": {"data_dir": str(data), "dims": [8, 8, 8],
                 "sigma_v_init": 0.5, "u_v_init": 0.1},
    }
    trainer = _trainer(config)
    trainer.structures = {"fg": 1}  # seg labels are binary here
    summaries = trainer.run()
    assert len(summaries) == 2
    assert (config.dir / "images/im_fixed.nii.gz").exists()
    assert (config.dir / "pair_1/images/im_fixed.nii.gz").exists()


def _mcmc_only(tmp_path, **kw):
    """MCMC from noise; the fold tolerance is raised for the tiny volume
    (at 12³ the default 0.1% is under 2 voxels)."""
    args = dict(VI=False, MCMC=True, MCMC_init="noise", no_iters_burn_in=2,
                no_samples_MCMC=6, log_period_MCMC=4, no_samples_VI_test=0,
                non_diffeomorphic_tolerance=0.005)
    args.update(kw)
    return _demo_cfg(tmp_path, **args)


def test_mcmc_checkpoint_resume(tmp_path):
    """Resuming from an MCMC-phase checkpoint restores the chain state."""
    config = _mcmc_only(tmp_path)
    _trainer(config).run()
    ckpt = config.save_dirs["models"] / "mcmc_latest.npz"
    assert ckpt.exists()

    summaries = _trainer(_mcmc_only(tmp_path / "resumed"), resume=str(ckpt)).run()
    # resumed at step 8 == burn_in + samples: the sampling loop is a no-op,
    # only the final statistics and speed test run
    assert summaries[0]["mcmc_samples_per_sec"] > 0


def test_checkpoint_time_gating_and_save_period(tmp_path):
    """Mid-phase checkpoints respect checkpoint_period_s (phase ends always
    write), and save_period_MCMC decouples the artifact dumps from the
    metric log period."""
    config = _demo_cfg(tmp_path, no_iters_burn_in=0, no_samples_MCMC=8,
                       log_period_MCMC=2, save_period_MCMC=4,
                       checkpoint_period_s=10_000.0)
    summaries = _trainer(config).run()
    assert "mcmc_aborted" not in summaries[0]

    run_dir = config.dir
    assert (run_dir / "models/vi_latest.npz").exists()
    mcmc_ckpt = run_dir / "models/mcmc_latest.npz"
    assert mcmc_ckpt.exists()
    assert peek_meta(mcmc_ckpt)["mcmc_steps"] == 8

    # artifacts only at multiples of save_period (4, 8) + the final period
    steps = sorted({
        int(p.name.split("_")[3])
        for p in (run_dir / "samples/MCMC").glob("chain_*_im_warped.nii.gz")
    })
    assert steps == [4, 8], steps


def test_mcmc_resume_restores_escalated_radius(tmp_path):
    """A checkpoint whose meta records an escalated block_warp.radius
    resumes at that radius."""
    config = _mcmc_only(tmp_path)
    _trainer(config).run()
    ckpt = config.save_dirs["models"] / "mcmc_latest.npz"
    assert peek_meta(ckpt).get("block_radius") == 2

    # simulate a run that escalated to radius 3 before checkpointing
    with np.load(ckpt) as a:
        payload = {k: a[k] for k in a.files}
    meta = json.loads(bytes(payload["__meta__"]).decode())
    meta["block_radius"] = 3
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    esc = tmp_path / "escalated.npz"
    with open(esc, "wb") as f:
        np.savez(f, **payload)

    # resume with MORE samples so the loop advances and writes its own
    # checkpoint, which must carry the radius forward
    config2 = _mcmc_only(tmp_path / "resumed", no_samples_MCMC=10)
    t2 = _trainer(config2, resume=str(esc))
    t2.run()
    assert t2.bundle.block_radius == 3
    assert peek_meta(config2.save_dirs["models"] / "mcmc_latest.npz").get("block_radius") == 3


def test_cli_runs_on_cpu(tmp_path):
    from ir_sgmcmc_tpu_torch.run import main

    summaries = main([
        "-c", str(DEMO), "--device", "cpu", "--run-id", "cli",
        "-o", "data_loader;args;dims=[12,12,12]",
        "-o", 'transformation_module;args={"no_steps": 6, "max_disp": 4}',
        "-o", f"trainer;save_dir={json.dumps(str(tmp_path))}",
        "-o", "trainer;no_iters_VI=4", "-o", "trainer;log_period_VI=4",
        "-o", "trainer;no_samples_VI_test=2", "-o", "trainer;no_iters_burn_in=2",
        "-o", "trainer;no_samples_MCMC=4", "-o", "trainer;log_period_MCMC=3",
        "-o", "trainer;speed_test_iters=1",
    ])
    s = summaries[0]
    assert "mcmc_aborted" not in s
    assert s["mcmc_mean_dsc"] >= s["dsc_before"] - 0.05
    run_dir = tmp_path / "demo_synthetic" / "cli"
    assert peek_meta(run_dir / "models/mcmc_latest.npz")["mcmc_steps"] == 6
    assert json.loads((run_dir / "config.json").read_text())["trainer"]["no_iters_VI"] == 4


def _apply(config, change: dict):
    for block, args in change.items():
        if block == "trainer":
            config.cfg["trainer"].update(args)
        else:
            config.cfg[block] = args
    return config


PORTED = {
    "mcmc_anchor": {"trainer": {"mcmc_anchor": True}},
    "svffd": {"transformation_module": {"type": "SVFFD_3D", "args": {"cps": [2, 2, 2]}}},
    "bspline_ffd": {"transformation_module": {"type": "Cubic_B_spline_FFD_3D",
                                              "args": {"cps": [4, 4, 4]}}},
    "shared_params": {"trainer": {"MCMC_params": "shared"}},
    "bfloat16": {"transformation_module": {"type": "SVF_3D",
                                           "args": {"compute_dtype": "bfloat16"}}},
    "vi_remat": {"trainer": {"vi_remat": True}},
    "use_gather": {"transformation_module": {"type": "SVF_3D",
                                             "args": {"no_steps": 6, "use_gather": True}}},
    "fourier_diff_op": {"reg_loss": {"type": "RegLoss_LogNormal",
                                     "args": {"diff_op": "Fourier1stDerivativeOperator",
                                              "w_reg": 1.4, "learnable": True}}},
}


@pytest.mark.parametrize("option", sorted(PORTED))
def test_ported_options_run(tmp_path, option):
    """The options that used to raise run both phases of the demo config at
    12³: no abort, finite Dice after VI and MCMC, both rates, and the
    checkpoints' chain state on the model's own grid."""
    config = _apply(_demo_cfg(tmp_path), PORTED[option])
    t = _trainer(config)
    assert t.vi_remat == (option == "vi_remat")
    s = t.run()[0]
    assert "mcmc_aborted" not in s
    assert np.isfinite(s["vi_test_mean_dsc"]) and np.isfinite(s["mcmc_mean_dsc"])
    assert s["vi_samples_per_sec"] > 0 and s["mcmc_samples_per_sec"] > 0
    with np.load(config.save_dirs["models"] / "mcmc_latest.npz") as f:
        assert f["leaf::.v"].shape == (2, 3) + tuple(t.bundle.field_dims)
        shared = option == "shared_params"
        assert f["leaf::.gmm['logits']"].shape == ((4,) if shared else (2, 4))


def test_trainer_and_cli_default_to_the_card(tmp_path):
    """No device: the card where there is one, else a RuntimeError that
    says how to ask for the CPU (there is no CPU fallback)."""
    from ir_sgmcmc_tpu_torch.run import main

    config = _demo_cfg(tmp_path)
    if torch.cuda.is_available():
        assert Trainer(config).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Trainer(config)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        main(["-c", str(DEMO), "-o", f"trainer;save_dir={json.dumps(str(tmp_path))}"])


def test_default_path_imports_no_jax_matplotlib_or_tensorboard():
    """The CLI, trainer and config import neither the JAX package nor JAX,
    and nothing of matplotlib or tensorboard, which only figure recording
    needs (a fresh interpreter, so other tests' imports do not count)."""
    import subprocess
    import sys

    code = ("import sys, ir_sgmcmc_tpu_torch.run, ir_sgmcmc_tpu_torch.trainer, "
            "ir_sgmcmc_tpu_torch.config, ir_sgmcmc_tpu_torch.utils; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'ir_sgmcmc_tpu', 'matplotlib', 'tensorboard'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, check=True).stdout.strip()
    assert out == "[]", out
