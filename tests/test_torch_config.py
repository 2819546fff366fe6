"""The port's config, datasets, metrics, evaluation, nearest warp and
checkpoints against the JAX package, on the CPU.

* every bundled config (15 dense-SVF, 2 SVFFD) builds the JAX bundle's
  hyperparameters in the port, the SVFFD ones with their control grid;
* micro-run twins of ``tests/test_configs.py``'s experiment 1-4 runs;
* datasets, NIfTI/VTK files, Dice and ASD, the trainer's sample evaluation
  and ``warp(method="nearest")`` against the JAX functions;
* checkpoints written by either package load in the other, and a JAX
  checkpoint of each phase resumes in the port's trainer;
* which fold counter each site uses (``det ≤ 0`` in the evaluation,
  ``det < 0`` in ``forward_sample``), on a field with exact zeros.

The JAX side builds configs, evaluates one sample at 16³ and saves states;
it runs no JAX trainer.
"""

import gzip
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

import jax
import jax.numpy as jnp

from ir_sgmcmc_tpu.config import Config as JConfig
from ir_sgmcmc_tpu.data.dataset import NiftiPairDataset as JNifti
from ir_sgmcmc_tpu.data.dataset import SyntheticPairDataset as JSynthetic
from ir_sgmcmc_tpu.engine.mcmc import MCMCState as JMCMCState
from ir_sgmcmc_tpu.engine.mcmc import WelfordState as JWelford
from ir_sgmcmc_tpu.engine.vi import VIState as JVIState
from ir_sgmcmc_tpu.engine.vi import count_folds as j_count_folds
from ir_sgmcmc_tpu.engine.vi import forward_sample as j_forward_sample
from ir_sgmcmc_tpu.ops.grids import count_non_diffeomorphic as j_count_non_diffeo
from ir_sgmcmc_tpu.ops.grids import det_jacobian as j_det
from ir_sgmcmc_tpu.ops.resample import warp as j_warp
from ir_sgmcmc_tpu.ops.stencil import gradient as j_gradient
from ir_sgmcmc_tpu.optim.adam_decay import AdamDecayState as JAdam
from ir_sgmcmc_tpu.trainer import Trainer as JTrainer
from ir_sgmcmc_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from ir_sgmcmc_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from ir_sgmcmc_tpu.utils.metrics import calc_metrics as j_calc_metrics
from ir_sgmcmc_tpu.utils.metrics import dice as j_dice
from ir_sgmcmc_tpu.utils.nifti import read_nifti as j_read_nifti
from ir_sgmcmc_tpu.utils.nifti import write_nifti as j_write_nifti
from ir_sgmcmc_tpu.utils.vtk_io import write_vtk_field as j_write_vtk
from ir_sgmcmc_tpu_torch import convert
from ir_sgmcmc_tpu_torch.config import Config
from ir_sgmcmc_tpu_torch.data.dataset import NiftiPairDataset, SyntheticPairDataset
from ir_sgmcmc_tpu_torch.engine.vi import count_folds, forward_sample
from ir_sgmcmc_tpu_torch.ops.grids import count_non_diffeomorphic, det_jacobian, identity_grid
from ir_sgmcmc_tpu_torch.ops.resample import warp
from ir_sgmcmc_tpu_torch.ops.stencil import gradient
from ir_sgmcmc_tpu_torch.trainer import Trainer
from ir_sgmcmc_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from ir_sgmcmc_tpu_torch.utils.metrics import STRUCTURES, calc_metrics, dice
from ir_sgmcmc_tpu_torch.utils.nifti import read_nifti, write_nifti
from ir_sgmcmc_tpu_torch.utils.vtk_io import read_vtk_field, write_vtk_field

REPO = Path(__file__).parent.parent
CONFIGS = sorted((REPO / "configs").rglob("*.json"))
DEMO = REPO / "configs/demo/config_synthetic.json"


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---- (a) every bundled config -----------------------------------------------------

def _same_attrs(j, t, what: str):
    """Every attribute of the JAX object equals the port object's."""
    for k, jv in vars(j).items():
        assert hasattr(t, k), f"{what}: the port lacks {k!r}"
        np.testing.assert_array_equal(_np(getattr(t, k)), _np(jv), err_msg=f"{what}.{k}")


def _same_updates(j_opt, t_opt, params: dict, seed: int):
    """Three Adam updates on the same gradients agree: the per-leaf lrs and
    the decay are the same (float32 arithmetic, rtol 1e-6)."""
    rng = np.random.default_rng(seed)
    j_state = j_opt.init({k: jnp.asarray(v) for k, v in params.items()})
    t_state = t_opt.init({k: torch.tensor(v) for k, v in params.items()})
    for _ in range(3):
        g = {k: rng.standard_normal(np.shape(v)).astype(np.float32) for k, v in params.items()}
        j_upd, j_state = j_opt.update({k: jnp.asarray(v) for k, v in g.items()}, j_state)
        t_upd, t_state = t_opt.update({k: torch.as_tensor(v) for k, v in g.items()}, t_state)
        for k in params:
            np.testing.assert_allclose(t_upd[k].numpy(), np.asarray(j_upd[k]), rtol=1e-6,
                                       atol=0, err_msg=k)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: str(p.relative_to(REPO / "configs")))
def test_bundled_config_matches_jax(path):
    """Parse + full build per config, every hyperparameter equal to the JAX
    bundle's; the Sobolev 1-D kernel to atol 1e-7 (two float32 solves),
    digamma-derived values to one float32 ulp."""
    jc = JConfig.from_file(path, make_dirs=False)
    tc = Config.from_file(path, make_dirs=False)
    assert tc.dims == jc.dims and tc.dof == jc.dof and tc.tau == jc.tau > 0
    jb = jc.build_bundle()
    tb = tc.build_bundle()
    assert type(tb.transformation).__name__ == type(jb.transformation).__name__
    jt, tt = jb.transformation, tb.transformation
    if tc.cps is not None:
        assert type(jb.transformation).__name__ == "SVFFD3D"
        for a in ("cps", "control_dims", "max_disp", "use_gather", "displacement_clamp_bound",
                  "image_clamp_bound"):
            assert getattr(tt, a) == getattr(jt, a), a
        assert tb.field_dims == jb.field_dims == tuple(jt.control_dims)
        jt, tt = jt.svf, tt.svf

    for a in ("dims", "field_dims", "sobolev_s", "sobolev_lambda", "uniform_noise_alpha",
              "noise_scheme", "block_warp", "block_radius", "block_size",
              "virtual_decimation"):
        assert getattr(tb, a) == getattr(jb, a), a
    np.testing.assert_allclose(tb._sobolev_kernel.numpy(), np.asarray(jb._sobolev_kernel),
                               rtol=0, atol=1e-7)
    assert tb.gmm.no_components == 4
    _same_attrs(jb.gmm, tb.gmm, "gmm")
    for name in ("scale_prior", "proportion_prior", "reg_loc_prior", "reg_scale_prior",
                 "reg_w_reg_prior"):
        j, t = getattr(jb, name), getattr(tb, name)
        assert (j is None) == (t is None), name
        if j is not None:
            assert type(t).__name__ == type(j).__name__, name
            _same_attrs(j, t, name)
            if hasattr(j, "expectation"):
                np.testing.assert_array_max_ulp(_np(t.expectation()), _np(j.expectation()),
                                                maxulp=1)
    assert type(tb.reg_loss).__name__ == type(jb.reg_loss).__name__
    _same_attrs(jb.reg_loss, tb.reg_loss, "reg_loss")
    for a in ("no_steps", "max_disp", "use_gather", "taylor_threshold", "composition_form",
              "no_squarings", "no_taylor", "no_compositions", "no_image_compositions",
              "displacement_clamp_bound", "image_clamp_bound"):
        assert getattr(tt, a) == getattr(jt, a), a

    # the initial GMM and reg parameters: exact but for float32 digamma,
    # which torch and XLA round differently by one ulp at some arguments
    # (the loc prior's expectation and the log-normal loss's initial loc)
    for j_p, t_p in ((jb.gmm.init_params(), tb.gmm.init_params("cpu")),
                     (jb.reg_loss.init_params(), tb.reg_loss.init_params("cpu"))):
        assert sorted(j_p) == sorted(t_p)
        for k in j_p:
            if k in ("loc", "log_scale"):
                np.testing.assert_array_max_ulp(t_p[k].numpy(), np.asarray(j_p[k]), maxulp=1)
            else:
                np.testing.assert_array_equal(t_p[k].numpy(), np.asarray(j_p[k]), err_msg=k)

    j_opts, t_opts = jc.build_optimizers(jb), tc.build_optimizers(tb)
    q_v = {k: np.zeros((3, 2, 2, 2), np.float32) for k in ("mu", "log_var", "u")}
    reg = {k: np.asarray(v) for k, v in jb.reg_loss.init_params().items()} or {"x": np.zeros(2)}
    gmm = {k: np.asarray(v) for k, v in jb.gmm.init_params().items()}
    for i, params in enumerate((q_v, gmm, reg)):
        _same_updates(j_opts[i], t_opts[i], params, seed=i)


# ---- (b) micro-run twins of tests/test_configs.py -----------------------------------

def _micro(path, tmp_path, **trainer_overrides):
    """A bundled config shrunk to a synthetic 12³ micro-run."""
    cfg = json.loads(Path(path).read_text())
    cfg["data_loader"] = {
        "type": "SyntheticDataLoader",
        "args": {"dims": [12, 12, 12], "sigma_v_init": 0.5, "u_v_init": 0.1},
    }
    cfg["transformation_module"]["args"].update(no_steps=6, max_disp=4)
    cfg["trainer"].update(
        save_dir=str(tmp_path), no_iters_VI=6, log_period_VI=6, no_samples_VI_test=2,
        no_chains=2, no_iters_burn_in=2, no_samples_MCMC=4, log_period_MCMC=4,
        speed_test_iters=2, tensorboard=False,
    )
    cfg["trainer"].update(trainer_overrides)
    return Config(cfg, run_id="test")


def _run_ok(config):
    s = Trainer(config, device="cpu").run()[0]
    assert "mcmc_aborted" not in s
    return s


def test_experiment1_micro_run(tmp_path):
    # VI-only, learnable log-normal regulariser, Sobolev gradients, VD
    s = _run_ok(_micro(REPO / "configs/experiment1/config.json", tmp_path))
    assert s["vi_samples_per_sec"] > 0
    assert "mcmc_samples_per_sec" not in s


def test_experiment2_micro_run(tmp_path):
    s = _run_ok(_micro(REPO / "configs/experiment2/M1/config2.json", tmp_path))
    assert s["vi_samples_per_sec"] > 0


def test_experiment3_vi_only_micro_run(tmp_path):
    config = _micro(REPO / "configs/experiment3/config_VI.json", tmp_path)
    assert config["trainer"]["MCMC"] is False
    s = _run_ok(config)
    assert s["vi_samples_per_sec"] > 0
    assert "mcmc_samples_per_sec" not in s


@pytest.mark.parametrize("mode", ["identity", "noise"])
def test_experiment4_cold_start_micro_run(tmp_path, mode):
    # MCMC-only cold starts at the identity / at prior noise
    config = _micro(REPO / f"configs/experiment4/config_{mode}.json", tmp_path)
    assert config["trainer"]["VI"] is False
    assert config["trainer"]["MCMC_init"] == mode
    s = _run_ok(config)
    assert "vi_samples_per_sec" not in s
    assert s["mcmc_samples_per_sec"] > 0
    assert np.isfinite(s["mcmc_mean_dsc"])


# ---- (c) datasets and files --------------------------------------------------------

def _same_pair(j_item, t_item):
    for jd, td in zip(j_item, t_item):
        assert sorted(jd) == sorted(td)
        for k in jd:
            assert td[k].dtype == jd[k].dtype, k
            np.testing.assert_array_equal(td[k], jd[k], err_msg=k)


def test_synthetic_dataset_matches_jax():
    j, t = JSynthetic((16, 16, 16), no_pairs=3), SyntheticPairDataset((16, 16, 16), no_pairs=3)
    assert len(t) == len(j) == 3 and t.structures == j.structures
    for i in range(3):
        _same_pair(j[i], t[i])
    np.testing.assert_array_equal(t.im_spacing, j.im_spacing)


def test_nifti_dataset_matches_jax(tmp_path):
    """Volumes written by the JAX writer at an odd, non-cubic shape load to
    the same arrays, spacing and manifest."""
    rng = np.random.default_rng(5)
    data = tmp_path / "data"
    (data / "masks").mkdir(parents=True)
    (data / "segs").mkdir()
    shape = (11, 9, 13)
    labels = np.asarray([0] + list(STRUCTURES.values()), np.int16)
    for i in range(3):
        j_write_nifti(data / f"s{i}.nii.gz", rng.random(shape).astype(np.float32) * 100,
                      spacing=(1.2, 1.0, 0.8))
        j_write_nifti(data / "masks" / f"s{i}.nii.gz", (rng.random(shape) > 0.2).astype(np.uint8))
        j_write_nifti(data / "segs" / f"s{i}.nii.gz", rng.choice(labels, shape))
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    j = JNifti((10, 10, 10), data, save_dir=tmp_path / "j")
    t = NiftiPairDataset((10, 10, 10), data, save_dir=tmp_path / "t")
    assert len(t) == len(j) == 2
    for i in range(2):
        _same_pair(j[i], t[i])
    np.testing.assert_array_equal(t.im_spacing, j.im_spacing)
    assert (tmp_path / "t/idx_to_id.json").read_text() == (tmp_path / "j/idx_to_id.json").read_text()


def test_nifti_and_vtk_files_match_jax(tmp_path):
    """Files written by either package read back bitwise in the other; VTK
    files and the decompressed NIfTI streams are byte-identical."""
    rng = np.random.default_rng(6)
    vol = rng.standard_normal((7, 5, 9)).astype(np.float32)
    seg = rng.integers(0, 60, (7, 5, 9)).astype(np.int16)
    field = rng.standard_normal((3, 4, 5, 6)).astype(np.float32)
    for name, arr in (("vol", vol), ("seg", seg)):
        j_write_nifti(tmp_path / f"j_{name}.nii.gz", arr, (1.5, 1.0, 2.0))
        write_nifti(tmp_path / f"t_{name}.nii.gz", arr, (1.5, 1.0, 2.0))
        for a, b in ((read_nifti(tmp_path / f"j_{name}.nii.gz"), arr),
                     (j_read_nifti(tmp_path / f"t_{name}.nii.gz"), arr)):
            assert a[0].dtype == b.dtype and a[1] == (1.5, 1.0, 2.0)
            np.testing.assert_array_equal(a[0], b)
        assert (gzip.open(tmp_path / f"j_{name}.nii.gz").read()
                == gzip.open(tmp_path / f"t_{name}.nii.gz").read())
    j_write_vtk(tmp_path / "j.vtk", field, (1.0, 2.0, 3.0))
    write_vtk_field(tmp_path / "t.vtk", field, (1.0, 2.0, 3.0))
    assert (tmp_path / "j.vtk").read_bytes() == (tmp_path / "t.vtk").read_bytes()
    np.testing.assert_array_equal(read_vtk_field(tmp_path / "j.vtk"), field)


# ---- (d) metrics -------------------------------------------------------------------

def test_dice_matches_jax():
    """Exact, batched and not; a label absent from both volumes gives 0."""
    rng = np.random.default_rng(7)
    labels = [10, 11, 12, 49, 99]
    a = rng.choice(np.asarray([0, 10, 11, 12, 49], np.int16), (3, 16, 16, 16))
    b = rng.choice(np.asarray([0, 10, 11, 12], np.int16), (3, 16, 16, 16))
    for x, y in ((a[0], b[0]), (a, b)):
        got = dice(torch.as_tensor(x), torch.as_tensor(y), labels).numpy()
        want = np.asarray(j_dice(jnp.asarray(x), jnp.asarray(y), labels))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert (got[..., -1] == 0).all()


def test_calc_metrics_matches_jax():
    """Dice exactly, ASD to 1e-6, for one pair and a batch of three against
    one fixed volume."""
    rng = np.random.default_rng(8)
    zz, yy, xx = np.meshgrid(*(np.arange(20),) * 3, indexing="ij")
    structures = {"a": 10, "b": 17, "c": 53}

    def seg(shift):
        s = np.zeros((20, 20, 20), np.int16)
        s[(zz - 6 - shift) ** 2 + (yy - 7) ** 2 + (xx - 8) ** 2 < 16] = 10
        s[(zz - 13) ** 2 + (yy - 12 + shift) ** 2 + (xx - 11) ** 2 < 9] = 17
        s[rng.random(s.shape) > 0.995] = 53
        return s

    fixed = seg(0)
    moving = np.stack([seg(s) for s in (0, 1, 2)])
    for f, m in ((fixed, moving[1]), (fixed[None], moving)):
        asd, dsc = calc_metrics(f, m, structures, (1.0, 1.5, 0.8))
        j_asd, j_dsc = j_calc_metrics(f, m, structures, (1.0, 1.5, 0.8))
        np.testing.assert_array_equal(dsc, np.asarray(j_dsc))
        np.testing.assert_allclose(asd, j_asd, rtol=0, atol=1e-6)


# ---- (e) the trainer's sample evaluation ---------------------------------------------

def _smooth_field(rng, shape, peak, passes=3):
    x = rng.standard_normal(shape).astype(np.float32)
    for _ in range(passes):
        for ax in (-3, -2, -1):
            x = (np.roll(x, 1, ax) + x + np.roll(x, -1, ax)) / 3.0
    return (x * (peak / np.abs(x).max())).astype(np.float32)


def _demo_configs(tmp_path, dims):
    cfg = json.loads(DEMO.read_text())
    cfg["data_loader"]["args"]["dims"] = list(dims)
    cfg["transformation_module"]["args"] = {"no_steps": 8, "max_disp": 4}
    cfg["trainer"]["save_dir"] = str(tmp_path)
    return (JConfig(json.loads(json.dumps(cfg)), run_id="jax"),
            Config(json.loads(json.dumps(cfg)), run_id="port"))


def test_eval_matches_jax(tmp_path):
    """``Trainer._make_eval`` in both packages on the same seeded ``v`` at
    16³ (a rough field that folds somewhere).  Tolerances: the warped
    image, displacement and residuals atol 1e-5; log|J| with the same
    -inf/NaN set, and where finite its det = exp(log|J|) to atol and rtol 1e-4 (the
    log amplifies the displacement's 1e-5 near a fold); the det ≤ 0 count and Dice
    exact; the warped segmentation exact except at most 8 voxels, where a
    sample point lies within 1e-4 voxel of a rounding tie."""
    jc, tc = _demo_configs(tmp_path, (16, 16, 16))
    jt, tt = JTrainer(jc), Trainer(tc, device="cpu")
    fixed_np, moving_np, _ = tt.dataset[0]
    v = _smooth_field(np.random.default_rng(9), (3, 16, 16, 16), 14.0, passes=2)

    j_out = jt._make_eval({k: jnp.asarray(a) for k, a in fixed_np.items()},
                          {k: jnp.asarray(a) for k, a in moving_np.items()})(jnp.asarray(v))
    t_out = tt._make_eval(tt._to_device(fixed_np), tt._to_device(moving_np))(
        torch.as_tensor(v)[None])
    j_out = {k: np.asarray(a) for k, a in j_out.items()}
    t_out = {k: a[0].numpy() for k, a in t_out.items()}

    for k in ("im_warped", "displacement", "residuals"):
        np.testing.assert_allclose(t_out[k], j_out[k], rtol=0, atol=1e-5, err_msg=k)
    ld_t, ld_j = t_out["log_det_J"], j_out["log_det_J"]
    assert int(t_out["ndv"]) == int(j_out["ndv"]) > 0
    np.testing.assert_array_equal(np.isfinite(ld_t), np.isfinite(ld_j))
    np.testing.assert_array_equal(np.isneginf(ld_t), np.isneginf(ld_j))
    fin = np.isfinite(ld_j)
    np.testing.assert_allclose(np.exp(ld_t[fin]), np.exp(ld_j[fin]), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(t_out["dsc"], j_out["dsc"])

    assert t_out["seg_warped"].dtype == j_out["seg_warped"].dtype == np.int16
    off = t_out["seg_warped"] != j_out["seg_warped"]
    assert off.sum() <= 8, int(off.sum())
    if off.any():  # only at rounding ties of the sample point
        pts = (j_out["displacement"] + np.stack(np.meshgrid(
            *(np.arange(16),) * 3, indexing="ij")[::-1]))[:, off]
        assert (np.abs(np.abs(pts - np.floor(pts)) - 0.5) < 1e-4).any(axis=0).all()


# ---- (f) the nearest warp ------------------------------------------------------------

def test_warp_nearest_matches_jax():
    """int16 and bool volumes, with sample points placed exactly on rounding
    ties (half-voxel offsets) and beyond the border: equal everywhere."""
    rng = np.random.default_rng(10)
    dims = (12, 10, 14)
    grid = identity_grid(dims, device="cpu").numpy()
    disp = rng.uniform(-3, 3, (3,) + dims).astype(np.float32)
    disp[:, ::3] = np.round(disp[:, ::3]) + 0.5  # ties
    scale = (2.0 / (np.asarray([14, 10, 12], np.float32) - 1.0)).reshape(3, 1, 1, 1)
    t = (grid + disp * scale).astype(np.float32)
    seg = rng.integers(0, 60, dims).astype(np.int16)
    mask = rng.random(dims) > 0.5
    for vol in (seg, mask):
        got = warp(torch.as_tensor(vol), torch.as_tensor(t), method="nearest").numpy()
        want = np.asarray(j_warp(jnp.asarray(vol), jnp.asarray(t), method="nearest"))
        assert got.dtype == want.dtype == vol.dtype
        np.testing.assert_array_equal(got, want)
    lin = warp(torch.as_tensor(seg), torch.as_tensor(t)).numpy()
    np.testing.assert_allclose(lin, np.asarray(j_warp(jnp.asarray(seg), jnp.asarray(t))),
                               rtol=0, atol=1e-4)


# ---- (g) checkpoints across packages ---------------------------------------------------

def _adam(rng, params: dict, batch=()):
    return JAdam(step=np.asarray(rng.integers(0, 50, batch), np.int32),
                 reinit_step=np.asarray(rng.integers(0, 5, batch), np.int32),
                 mu={k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()},
                 nu={k: rng.random(v.shape).astype(np.float32) for k, v in params.items()})


def _jax_tree(kind: str, rng):
    """A JAX-layout VIState or MCMCState of seeded numpy arrays."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    if kind == "vi":
        q_v = {k: f(3, 4, 5, 6) for k in ("mu", "log_var", "u")}
        gmm, reg = {"logits": f(4), "log_std": f(4)}, {"loc": f(), "log_scale": f()}
        return JVIState(q_v=q_v, gmm=gmm, reg=reg, opt_q_v=_adam(rng, q_v),
                        opt_gmm=_adam(rng, gmm), opt_reg=_adam(rng, reg),
                        key=rng.integers(0, 2 ** 32, 2, dtype=np.uint32),
                        step=np.int32(17))
    C = 2
    gmm, reg = {"logits": f(C, 4), "log_std": f(C, 4)}, {"loc": f(C), "log_scale": f(C)}
    return JMCMCState(v=f(C, 3, 4, 5, 6), sigma=f(C, 3, 4, 5, 6), gmm=gmm, reg=reg,
                      opt_gmm=_adam(rng, gmm, (C,)), opt_reg=_adam(rng, reg, (C,)),
                      welford=JWelford(count=f(C), mean=f(C, 3, 4, 5, 6), m2=f(C, 3, 4, 5, 6)),
                      key=rng.integers(0, 2 ** 32, (C, 2), dtype=np.uint32),
                      step=np.int32(30))


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
        return
    if hasattr(a, "_fields"):
        for k in a._fields:
            _assert_trees_equal(getattr(a, k), getattr(b, k) if hasattr(b, "_fields") else b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["vi", "mcmc"])
def test_checkpoints_cross_packages(tmp_path, kind):
    """JAX save -> port load equals ``convert`` of the same tree; port save
    -> JAX load into a JAX template gives the same leaves, dtypes and meta."""
    from_np = convert.vi_state_from_numpy if kind == "vi" else convert.mcmc_state_from_numpy
    to_np = convert.vi_state_to_numpy if kind == "vi" else convert.mcmc_state_to_numpy
    tree = _jax_tree(kind, np.random.default_rng(11))
    meta = {"phase": "VI" if kind == "vi" else "MCMC", "vi_iters": 20, "mcmc_steps": 30,
            "block_radius": 3, "config": "demo"}

    j_save_checkpoint(tmp_path / "j.npz", tree, meta)
    template = from_np(jax.tree.map(np.zeros_like, tree), device="cpu")
    state, got_meta = load_checkpoint(tmp_path / "j.npz", template)
    assert got_meta == {**meta, "format_version": 2}
    assert type(state) is type(template) and isinstance(state.step, int)
    _assert_trees_equal(to_np(state), to_np(from_np(tree, device="cpu")))

    save_checkpoint(tmp_path / "t.npz", from_np(tree, device="cpu"), meta)
    restored, j_meta = j_load_checkpoint(tmp_path / "t.npz", jax.tree.map(np.zeros_like, tree))
    assert j_meta == {**meta, "format_version": 2}
    _assert_trees_equal(jax.tree.map(np.asarray, restored), tree)
    with np.load(tmp_path / "t.npz") as t_files, np.load(tmp_path / "j.npz") as j_files:
        assert sorted(t_files.files) == sorted(j_files.files)


# ---- fold counters per site -----------------------------------------------------------

def test_fold_counters_per_site(tmp_path):
    """The evaluation counts det ≤ 0 and ``forward_sample`` counts det < 0,
    in both packages, on a transformation whose determinant is exactly 0 on
    two columns of voxels and negative on a third."""
    dims = (12, 12, 12)
    T = identity_grid(dims, device="cpu").numpy()
    T[0, :, :, 3:6] = T[0, :, :, 3:4]  # x constant: det = 0 at x = 3, 4
    T[0, :, :, 8] = T[0, :, :, 7] - 0.05  # x decreasing: det < 0 at x = 7
    plane = dims[0] * dims[1]

    det_t = det_jacobian(gradient(torch.as_tensor(T), normalised_spacing=True))
    det_j = j_det(j_gradient(jnp.asarray(T), normalised_spacing=True))
    assert int((det_t == 0).sum()) == 2 * plane
    assert int(count_non_diffeomorphic(det_t)) == int(j_count_non_diffeo(det_j)) == 3 * plane
    assert int(count_folds(torch.as_tensor(T))) == int(j_count_folds(jnp.asarray(T))) == plane

    # the sites: the integration returns T whatever v is
    jc, tc = _demo_configs(tmp_path, dims)
    jc.cfg["trainer"]["uniform_noise"] = {"enabled": False}
    tc.cfg["trainer"]["uniform_noise"] = {"enabled": False}
    jt, tt = JTrainer(jc), Trainer(tc, device="cpu")
    fixed_np, moving_np, _ = tt.dataset[0]
    jf, jm = ({k: jnp.asarray(a) for k, a in d.items()} for d in (fixed_np, moving_np))
    tf, tm = tt._to_device(fixed_np), tt._to_device(moving_np)
    zero = np.zeros((3,) + dims, np.float32)

    def j_integrate(v, im=None):
        return jnp.asarray(T), jnp.zeros_like(v), jnp.zeros_like(jm["im"])

    def t_integrate(v, im=None):
        n = v.shape[0]
        return (torch.as_tensor(T).expand(n, -1, -1, -1, -1), torch.zeros_like(v),
                torch.zeros((n,) + dims))

    jt.bundle.transformation.integrate = j_integrate
    tt.bundle.transformation.integrate = t_integrate
    assert int(jt._make_eval(jf, jm)(jnp.asarray(zero))["ndv"]) == 3 * plane
    assert int(tt._make_eval(tf, tm)(torch.as_tensor(zero)[None])["ndv"][0]) == 3 * plane
    assert int(j_forward_sample(jt.bundle, jf, jm, jnp.asarray(zero), None)["ndv"]) == plane
    assert int(forward_sample(tt.bundle, tf, tm, torch.as_tensor(zero)[None], None)["ndv"][0]) \
        == plane


@pytest.mark.parametrize("phase", ["VI", "MCMC"])
def test_jax_checkpoint_resumes_in_the_port_trainer(tmp_path, phase):
    """A ``vi_latest.npz`` / ``mcmc_latest.npz`` written by the JAX package
    (at step 8 / transition 4) resumes in the port's trainer, which runs on
    to step 10 / transition 6 and writes its own checkpoint, which the JAX
    package loads into its state at that step."""
    from ir_sgmcmc_tpu.engine import init_chains as j_init_chains

    cfg = json.loads(DEMO.read_text())
    cfg["data_loader"]["args"]["dims"] = [12, 12, 12]
    cfg["transformation_module"]["args"] = {"no_steps": 6, "max_disp": 4}
    cfg["trainer"].update(save_dir=str(tmp_path), no_iters_VI=10, log_period_VI=2,
                          no_samples_VI_test=0, no_chains=2, no_iters_burn_in=2,
                          no_samples_MCMC=4, log_period_MCMC=2, speed_test_iters=1,
                          non_diffeomorphic_tolerance=0.005,
                          VI=phase == "VI", MCMC=phase == "MCMC", MCMC_init="noise")
    jc = JConfig(json.loads(json.dumps(cfg)), run_id="jax")
    jb = jc.build_bundle()
    og, orr = jc.build_optimizers(jb)[1:]
    _, _, q_v0 = JSynthetic((12, 12, 12))[0]
    q_v = {k: jnp.asarray(v) for k, v in q_v0.items()}
    gmm, reg = jb.gmm.init_params(), jb.reg_loss.init_params()
    if phase == "VI":
        state = JVIState(q_v=q_v, gmm=gmm, reg=reg, opt_q_v=jc.build_optimizers(jb)[0].init(q_v),
                         opt_gmm=og.init(gmm), opt_reg=orr.init(reg),
                         key=jax.random.PRNGKey(3), step=jnp.asarray(8, jnp.int32))
        meta = {"phase": "VI", "phase_done": 0, "vi_iters": 8, "config": "demo_synthetic"}
        name, count = "vi_latest.npz", ("vi_iters", 10)
    else:
        state = j_init_chains(jb, jax.random.PRNGKey(3), 2, "noise", None, gmm, reg, og, orr)
        state = state._replace(step=jnp.asarray(4, jnp.int32))
        meta = {"phase": "MCMC", "phase_done": 1, "mcmc_steps": 4, "block_radius": 2,
                "config": "demo_synthetic"}
        name, count = "mcmc_latest.npz", ("mcmc_steps", 6)
    j_save_checkpoint(tmp_path / name, state, meta)

    tc = Config(json.loads(json.dumps(cfg)), run_id="port")
    s = Trainer(tc, device="cpu", resume=str(tmp_path / name)).run()[0]
    assert "mcmc_aborted" not in s
    restored, got = j_load_checkpoint(tc.save_dirs["models"] / name,
                                      jax.tree.map(np.zeros_like, state))
    assert got[count[0]] == count[1]
    assert int(restored.step) == (10 if phase == "VI" else 6)
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(restored))
