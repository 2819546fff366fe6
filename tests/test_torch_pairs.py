"""Pair-parallel registration in the port (``engine/pairs.py`` and the
trainer's pair-stacked path) on the CPU, at 12³: each pair of a
pair-stacked chunk equals its own single-pair run, batches of fewer pairs
equal one batch of all, the pair-stacked trainer equals the sequential one
per pair, and pair-stacked checkpoints resume, across packages too.  Twins
of tests/test_parallel.py:741-899.  The pair-stacked steps against the JAX
package's pair chunks: tests/test_torch_pairs_jax.py.

Tolerances: the chunks within 1e-5 (one batch of P·C or 2P rows against
batches of C or 2: the same per-row arithmetic, reductions of another
batch size), the trainer's Dice within 1e-3 (the JAX suite's).
"""

import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

from ir_sgmcmc_tpu_torch.config import Config
from ir_sgmcmc_tpu_torch.data import sphere_pair
from ir_sgmcmc_tpu_torch.engine import (ModelBundle, VIState, init_chains, make_mcmc_chunk,
                                        make_vi_chunk, make_vi_step)
from ir_sgmcmc_tpu_torch.engine.pairs import (make_pair_mcmc_chunk, make_pair_vi_chunk,
                                              stack_trees, unstack_tree)
from ir_sgmcmc_tpu_torch.models import (GMM, SVF3D, DirichletPrior, LogEnergyExpGammaPrior,
                                        LogScaleNormalPrior, RegLossLogNormal)
from ir_sgmcmc_tpu_torch.optim import adam_decay
from ir_sgmcmc_tpu_torch.trainer import Trainer
from ir_sgmcmc_tpu_torch.utils.checkpoint import peek_meta

REPO = Path(__file__).parent.parent
DEMO = REPO / "configs/demo/config_synthetic.json"
DIMS = (12, 12, 12)
OFFSETS = ((0.0, 0.0, 2.0), (0.0, 1.0, 0.0), (1.0, 0.0, 1.0))
CPU = torch.device("cpu")


def _bundle(scheme="post"):
    dof = 3.0 * float(np.prod(DIMS))
    return ModelBundle(
        dims=DIMS, gmm=GMM(4, 1), scale_prior=LogScaleNormalPrior(0.0, 2.3),
        proportion_prior=DirichletPrior(4, 0.5),
        reg_loss=RegLossLogNormal(w_reg=1.4, dims=DIMS, learnable=True),
        reg_loc_prior=LogEnergyExpGammaPrior(w_reg=1.4, dof=dof),
        reg_scale_prior=LogScaleNormalPrior(loc=2.8, scale=5.0),
        transformation=SVF3D(DIMS, no_steps=6, max_disp=4), sobolev_s=3,
        uniform_noise_alpha=0.1, noise_scheme=scheme, virtual_decimation=True)


def _images(n):
    pairs = [sphere_pair(DIMS, offset=o, seed=i) for i, o in enumerate(OFFSETS[:n])]
    return [({k: torch.as_tensor(v) for k, v in f.items()},
             {k: torch.as_tensor(v) for k, v in m.items()}) for f, m in pairs]


def _stacked_images(images):
    return (stack_trees([f for f, _ in images]), stack_trees([m for _, m in images]))


OPT_GMM = adam_decay(0.2, 1e-3)
OPT_REG = adam_decay({"loc": 0.01, "log_scale": 0.01}, 1e-3)
OPT_Q_V = adam_decay({"mu": 0.01, "log_var": 0.01, "u": 0.01}, 1e-3)


def _chains(bundle, i):
    """Pair ``i``'s 2 chains from noise, with a warm GMM (spread scales,
    unequal logits: from identical components Adam would turn rounding
    noise into full steps)."""
    gmm = bundle.gmm.init_scales_from_residual_std(bundle.gmm.init_params(CPU), 1.0 + 0.1 * i)
    gmm["logits"] = torch.tensor([0.3, -0.2, 0.1, -0.4]) * (1 + i)
    return init_chains(bundle, torch.Generator().manual_seed(20 + i), 2, "noise", None, gmm,
                       bundle.reg_loss.init_params(CPU), OPT_GMM, OPT_REG, device=CPU)


def _vi_state(bundle, i):
    q_v = bundle.init_q_v(0.5, 0.1, CPU)
    q_v["mu"] = torch.randn(q_v["mu"].shape, generator=torch.Generator().manual_seed(i)) * 0.5
    gmm = bundle.gmm.init_scales_from_residual_std(bundle.gmm.init_params(CPU), 1.0 + 0.1 * i)
    gmm["logits"] = torch.tensor([0.3, -0.2, 0.1, -0.4]) * (1 + i)
    reg = bundle.reg_loss.init_params(CPU)
    return VIState(q_v=q_v, gmm=gmm, reg=reg, opt_q_v=OPT_Q_V.init(q_v),
                   opt_gmm=OPT_GMM.init(gmm), opt_reg=OPT_REG.init(reg),
                   key=torch.tensor([7, 50 + i]), step=0)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{prefix}[{k}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields for x in _leaves(getattr(tree, f), f"{prefix}.{f}")]
    return [(prefix, tree)]


def _assert_trees_close(got, ref, atol=1e-5, rtol=1e-5):
    got, ref = _leaves(got), _leaves(ref)
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        if isinstance(b, torch.Tensor):
            torch.testing.assert_close(a, b, atol=atol, rtol=rtol, msg=path,
                                       check_dtype=True, check_device=True)
        else:
            assert a == b, path


def test_stack_and_unstack_roundtrip():
    """``stack_trees`` puts a leading pair axis on every leaf, the step and
    key words included (int32 on the host, the JAX layout), and
    ``unstack_tree`` gives each pair's state back as it was."""
    bundle = _bundle()
    for states in ([_vi_state(bundle, i) for i in range(3)],
                   [_chains(bundle, i)._replace(step=4) for i in range(3)]):
        st = stack_trees(states)
        assert st.step.dtype == torch.int32 and st.step.tolist() == [states[0].step] * 3
        assert st.key.shape == (3,) + tuple(states[0].key.shape)
        for path, leaf in _leaves(st):
            assert leaf.shape[0] == 3, path
        for i, s in enumerate(states):
            back = unstack_tree(st, i)
            assert isinstance(back.step, int)
            for (path, a), (_, b) in zip(_leaves(back), _leaves(s)):
                assert torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b, path


def test_pair_mcmc_chunk_equals_each_pairs_own_chunk():
    """P = 3 pairs x C = 2 chains, 3 transitions (one past burn-in feeds the
    Welford accumulators): each pair's rows of the pair-stacked chunk equal
    its single-pair chunk, state and metrics, within 1e-5."""
    bundle = _bundle()
    images = _images(3)
    fixed_st, moving_st = _stacked_images(images)
    states = [_chains(bundle, i) for i in range(3)]
    st, ms = make_pair_mcmc_chunk(bundle, OPT_GMM, OPT_REG, 1e-4, fixed_st, moving_st,
                                  chunk=3, burn_in=2, thin=1)(stack_trees(states))
    assert st.step.tolist() == [3, 3, 3]
    for i, (fixed, moving) in enumerate(images):
        ref, ref_ms = make_mcmc_chunk(bundle, OPT_GMM, OPT_REG, 1e-4, fixed, moving, chunk=3,
                                      burn_in=2, thin=1)(states[i])
        _assert_trees_close(unstack_tree(st, i), ref)
        for k, m in ref_ms.items():
            torch.testing.assert_close(ms[k][i], m, atol=1e-5, rtol=1e-5, msg=k)
    assert float(st.welford.count.sum()) == 3 * 2  # pair by pair: one sample per chain


@pytest.mark.parametrize("scheme,remat", [("post", False), ("pre", False), ("post", True)])
def test_pair_vi_chunk_equals_each_pairs_own_chunk(scheme, remat):
    """P = 3 pairs, 3 VI steps on either noise scheme (and with remat):
    each pair of the pair-stacked chunk, drawing from its own key and step,
    equals its single-pair chunk, state and metrics, within 1e-5."""
    bundle = _bundle(scheme)
    images = _images(3)
    fixed_st, moving_st = _stacked_images(images)
    states = [_vi_state(bundle, i) for i in range(3)]
    st, ms = make_pair_vi_chunk(bundle, OPT_Q_V, OPT_GMM, OPT_REG, fixed_st, moving_st,
                                chunk=3, remat=remat)(stack_trees(states))
    assert st.step.tolist() == [3, 3, 3]
    for i, (fixed, moving) in enumerate(images):
        step = make_vi_step(bundle, OPT_Q_V, OPT_GMM, OPT_REG, fixed, moving, remat=remat)
        ref, ref_ms = make_vi_chunk(step, 3)(states[i])
        _assert_trees_close(unstack_tree(st, i), ref)
        for k, m in ref_ms.items():
            torch.testing.assert_close(ms[k][i], m, atol=1e-5, rtol=1e-5, msg=k)


@pytest.mark.parametrize("kind,group", [("mcmc", 1), ("mcmc", 2), ("vi", 1), ("vi", 2)])
def test_pair_chunks_in_groups_equal_one_batch(kind, group):
    """P = 3 pairs run in batches of ``group`` pairs in turn (the schedule a
    card too small for all of them takes; 1 is ``lax.map``'s) equal the
    one batch of all 3, state and metrics, within 1e-5."""
    bundle = _bundle()
    fixed_st, moving_st = _stacked_images(_images(3))
    if kind == "mcmc":
        st = stack_trees([_chains(bundle, i) for i in range(3)])

        def chunk(g):
            return make_pair_mcmc_chunk(bundle, OPT_GMM, OPT_REG, 1e-4, fixed_st, moving_st,
                                        chunk=2, burn_in=1, thin=1, group=g)
    else:
        st = stack_trees([_vi_state(bundle, i) for i in range(3)])

        def chunk(g):
            return make_pair_vi_chunk(bundle, OPT_Q_V, OPT_GMM, OPT_REG, fixed_st, moving_st,
                                      chunk=2, group=g)
    ref, ref_ms = chunk(None)(st)
    got, ms = chunk(group)(st)
    _assert_trees_close(got, ref)
    assert ms.keys() == ref_ms.keys()
    for k, m in ref_ms.items():
        torch.testing.assert_close(ms[k], m, atol=1e-5, rtol=1e-5, msg=k)


def test_per_row_images_need_their_rank():
    """Whether images are per row is said, not guessed from their rank: a
    per-row forward chain or integration refuses images of the shared
    rank."""
    from ir_sgmcmc_tpu_torch.engine import forward_sample

    bundle = _bundle("pre")
    fixed, moving = _images(1)[0]
    v = torch.zeros((2, 3) + DIMS)
    with pytest.raises(ValueError, match="per-row"):
        forward_sample(bundle, fixed, moving, v, torch.zeros((2, 3) + DIMS), per_row=True)
    with pytest.raises(ValueError, match="per-row"):
        bundle.transformation.integrate(v, im=moving["im"][None], per_row=True)
    rows = {k: t.expand((2,) + DIMS) for k, t in moving.items()}
    out = forward_sample(bundle, {k: t.expand((2,) + DIMS) for k, t in fixed.items()}, rows,
                         v, torch.zeros((2, 3) + DIMS), per_row=True)
    shared = forward_sample(bundle, fixed, moving, v, torch.zeros((2, 3) + DIMS))
    torch.testing.assert_close(out["residuals"], shared["residuals"], atol=1e-6, rtol=1e-6)


def test_pair_mcmc_chunk_refuses_shared_params_and_ragged_steps():
    """Chains with one shared GMM/reg set, or pairs at different steps, do
    not fold into one chain batch."""
    bundle = _bundle()
    fixed_st, moving_st = _stacked_images(_images(2))
    gmm = bundle.gmm.init_params(CPU)
    shared = [init_chains(bundle, torch.Generator().manual_seed(i), 2, "noise", None, gmm,
                          bundle.reg_loss.init_params(CPU), OPT_GMM, OPT_REG, device=CPU,
                          param_mode="shared") for i in range(2)]
    with pytest.raises(ValueError, match="per_chain"):
        make_pair_mcmc_chunk(bundle, OPT_GMM, OPT_REG, 1e-4, fixed_st, moving_st, 1, 0,
                             1)(stack_trees(shared))
    st = stack_trees([_chains(bundle, 0), _chains(bundle, 1)._replace(step=2)])
    with pytest.raises(ValueError, match="different steps"):
        make_pair_mcmc_chunk(bundle, OPT_GMM, OPT_REG, 1e-4, fixed_st, moving_st, 1, 0, 1)(st)


# ---- the trainer's pair-stacked path --------------------------------------------

def _cfg(where, pair_parallel=True, no_pairs=4, **trainer):
    """tests/test_parallel.py's demo settings at 12³."""
    c = json.loads(DEMO.read_text())
    c["data_loader"]["args"]["dims"] = [12, 12, 12]
    c["data_loader"]["args"]["no_pairs"] = no_pairs
    c["transformation_module"]["args"] = {"no_steps": 4, "max_disp": 4}
    c["trainer"].update(
        save_dir=str(where), VI=True, no_iters_VI=6, log_period_VI=3,
        no_samples_VI_test=2, MCMC=True, MCMC_init="VI", no_chains=2,
        no_iters_burn_in=2, no_samples_MCMC=4, log_period_MCMC=3,
        speed_test_iters=2, tensorboard=False, seed=7, pair_parallel=pair_parallel,
        distribute=False)
    c["trainer"].update(trainer)
    return Config(c, run_id="t")


def test_trainer_pair_parallel_matches_sequential(tmp_path):
    """``pair_parallel: true`` registers 4 synthetic pairs as one batch:
    per pair the same Dice before registration, VI-test and MCMC Dice within
    1e-3 of the sequential run's, each pair's artifacts in its own tree,
    and an aggregate rate."""
    s_pp = Trainer(_cfg(tmp_path / "pp"), device="cpu").run()
    assert len(s_pp) == 4
    assert all("mcmc_aborted" not in s for s in s_pp)
    assert s_pp[0]["mcmc_aggregate_samples_per_sec"] > 0
    assert all(s["vi_time_s"] == s_pp[0]["vi_time_s"] > 0 for s in s_pp)
    s_seq = Trainer(_cfg(tmp_path / "seq", False), device="cpu").run()
    for pp, seq in zip(s_pp, s_seq):
        assert pp["dsc_before"] == seq["dsc_before"]
        assert abs(pp["mcmc_mean_dsc"] - seq["mcmc_mean_dsc"]) < 1e-3
        assert abs(pp["vi_test_mean_dsc"] - seq["vi_test_mean_dsc"]) < 1e-3
    root = tmp_path / "pp/demo_synthetic/t"
    assert (root / "fields/MCMC_displacement_mean.vtk").exists()
    for i in range(1, 4):
        assert (root / f"pair_{i}/fields/MCMC_displacement_mean.vtk").exists()
        assert list((root / f"pair_{i}/samples/MCMC").glob("chain_1_*_im_warped.nii.gz"))


def test_trainer_pair_parallel_in_groups_matches_sequential(tmp_path, monkeypatch):
    """Where the card holds fewer pairs than the study has, the trainer
    runs them in batches in turn: 3 pairs in batches of 2 (the size the
    card's free memory would set) give each pair its sequential run's Dice
    within 1e-3 and one pair-stacked checkpoint of all 3."""
    sizes = []

    def two(self, chunk, state, fixed_st, moving_st):
        sizes.append(int(state.step.shape[0]))
        return 2

    monkeypatch.setattr(Trainer, "_pair_group", two)
    config = _cfg(tmp_path / "pp", no_pairs=3)
    s_pp = Trainer(config, device="cpu").run()
    assert sizes == [3, 3]  # the VI and MCMC phases
    assert all("mcmc_aborted" not in s for s in s_pp)
    s_seq = Trainer(_cfg(tmp_path / "seq", False, no_pairs=3), device="cpu").run()
    for pp, seq in zip(s_pp, s_seq):
        assert pp["dsc_before"] == seq["dsc_before"]
        assert abs(pp["mcmc_mean_dsc"] - seq["mcmc_mean_dsc"]) < 1e-3
        assert abs(pp["vi_test_mean_dsc"] - seq["vi_test_mean_dsc"]) < 1e-3
    ckpt = config.save_dirs["models"] / "mcmc_latest.npz"
    assert peek_meta(ckpt)["pair_parallel"] == 3
    with np.load(ckpt) as f:
        assert f["leaf::.v"].shape == (3, 2, 3) + DIMS


def test_trainer_pair_parallel_resume(tmp_path):
    """A pair-stacked MCMC checkpoint (meta ``pair_parallel`` 2 and the
    block radius) resumes every pair, as a no-op at a completed step count;
    a resume into 3 pairs, or from a sequential checkpoint, is refused."""
    config = _cfg(tmp_path / "a", no_pairs=2, no_iters_VI=4, log_period_VI=2)
    s1 = Trainer(config, device="cpu").run()
    assert len(s1) == 2 and all("mcmc_aborted" not in s for s in s1)
    ckpt = config.save_dirs["models"] / "mcmc_latest.npz"
    meta = peek_meta(ckpt)
    assert meta.get("pair_parallel") == 2 and meta.get("block_radius") == 2
    with np.load(ckpt) as f:
        assert f["leaf::.v"].shape == (2, 2, 3) + DIMS
        assert f["leaf::.step"].dtype == np.int32 and f["leaf::.step"].tolist() == [6, 6]
        assert f["leaf::.key"].shape == (2, 2, 2) and f["leaf::.key"].dtype == np.uint32
    vi_meta = peek_meta(config.save_dirs["models"] / "vi_latest.npz")
    assert vi_meta["pair_parallel"] == 2 and vi_meta["vi_iters"] == 4

    config2 = _cfg(tmp_path / "b", no_pairs=2)
    s2 = Trainer(config2, device="cpu", resume=str(ckpt)).run()
    assert len(s2) == 2 and all("mcmc_aborted" not in s for s in s2)
    assert (config2.dir / "fields/MCMC_displacement_mean.vtk").exists()
    for a, b in zip(s1, s2):  # the same final chains, evaluated again
        assert abs(a["mcmc_mean_dsc"] - b["mcmc_mean_dsc"]) < 1e-6

    with pytest.raises(ValueError, match="pair"):
        Trainer(_cfg(tmp_path / "c", no_pairs=3), device="cpu", resume=str(ckpt)).run()
    seq = _cfg(tmp_path / "d", False, no_pairs=2)
    Trainer(seq, device="cpu").run()
    with pytest.raises(ValueError, match="non-pair-stacked"):
        Trainer(_cfg(tmp_path / "e", no_pairs=2), device="cpu",
                resume=str(seq.save_dirs["models"] / "mcmc_latest.npz")).run()


def test_trainer_pair_parallel_vi_resume(tmp_path):
    """A pair-stacked VI checkpoint resumes the VI loop where it stopped:
    the resumed run's per-pair VI-test Dice equals the uninterrupted one's."""
    full = Trainer(_cfg(tmp_path / "full", no_pairs=2, MCMC=False), device="cpu").run()
    half = _cfg(tmp_path / "half", no_pairs=2, MCMC=False, no_iters_VI=3)
    Trainer(half, device="cpu").run()
    ckpt = half.save_dirs["models"] / "vi_latest.npz"
    assert peek_meta(ckpt)["vi_iters"] == 3
    resumed = Trainer(_cfg(tmp_path / "res", no_pairs=2, MCMC=False), device="cpu",
                      resume=str(ckpt)).run()
    for a, b in zip(full, resumed):
        assert abs(a["vi_test_mean_dsc"] - b["vi_test_mean_dsc"]) < 1e-6


def test_trainer_pair_parallel_escalates_the_block_radius(tmp_path):
    """A block-residual saturation abort of the worst pair raises
    ``block_warp.radius`` and resumes every pair from the last clean
    period; the escalated radius goes into the checkpoint."""
    config = _cfg(tmp_path, no_pairs=2, VI=False, MCMC_init="noise", no_iters_burn_in=0,
                  no_samples_MCMC=4, log_period_MCMC=1, no_samples_VI_test=0,
                  non_diffeomorphic_tolerance=0.05)
    t = Trainer(config, device="cpu")
    real_check, fired = t._check_saturation, []

    def fake_check(sat, sat_resid, step, phase):
        if phase == "MCMC" and step >= 2 and not fired:
            fired.append(step)
            from ir_sgmcmc_tpu_torch.trainer import DisplacementSaturationAbort

            err = DisplacementSaturationAbort("forced block-residual overflow")
            err.sat = err.sat_resid = 10_000_000
            raise err
        return real_check(sat, sat_resid, step, phase)

    t._check_saturation = fake_check
    s = t.run()
    assert fired and all("mcmc_aborted" not in x for x in s)
    assert s[0]["block_radius_escalations"] == [{"step": 1, "radius": 3}]
    assert t.bundle.block_radius == 3
    assert peek_meta(config.save_dirs["models"] / "mcmc_latest.npz")["block_radius"] == 3


def test_trainer_pair_parallel_refuses_unequal_dims(tmp_path):
    """Pairs of different volume shapes cannot be stacked."""
    config = _cfg(tmp_path, no_pairs=2)
    data = config.build_dataset()

    class Uneven:
        im_spacing, structures = data.im_spacing, getattr(data, "structures", None)

        def __len__(self):
            return len(data)

        def __getitem__(self, i):
            fixed, moving, q_v = data[i]
            if i == 1:
                fixed = {k: v[:-1] for k, v in fixed.items()}
            return fixed, moving, q_v

    with pytest.raises(ValueError, match="equal dims"):
        Trainer(config, dataset=Uneven(), device="cpu").run()


def test_shared_params_fall_back_to_sequential_pairs(tmp_path, caplog):
    """``MCMC_params: "shared"`` has no pair-stacked form: the trainer warns
    and registers the pairs in turn, as the JAX trainer does."""
    config = _cfg(tmp_path, no_pairs=2, MCMC_params="shared", no_iters_VI=2, log_period_VI=2)
    with caplog.at_level(logging.WARNING):
        s = Trainer(config, device="cpu").run()
    assert any("registering pairs sequentially" in r.message for r in caplog.records)
    assert len(s) == 2 and all("mcmc_samples_per_sec" in x for x in s)
    assert not any("mcmc_aggregate_samples_per_sec" in x for x in s)
    assert "pair_parallel" not in peek_meta(config.save_dirs["models"] / "mcmc_latest.npz")


# ---- checkpoints across the two packages ------------------------------------------

def _jax_cfg(where):
    from ir_sgmcmc_tpu.config import Config as JConfig

    c = json.loads(DEMO.read_text())
    c["data_loader"]["args"]["dims"] = [12, 12, 12]
    c["data_loader"]["args"]["no_pairs"] = 2
    c["transformation_module"]["args"] = {"no_steps": 4, "max_disp": 4}
    c["trainer"].update(
        save_dir=str(where), VI=False, MCMC=True, MCMC_init="noise", no_chains=2,
        no_iters_burn_in=1, no_samples_MCMC=2, log_period_MCMC=3, no_samples_VI_test=0,
        speed_test_iters=1, tensorboard=False, seed=7, pair_parallel=True, distribute=False,
        ASD=False)
    return c, JConfig(c, run_id="j")


def test_jax_pair_checkpoint_resumes_in_the_port(tmp_path):
    """A pair-stacked MCMC checkpoint written by the JAX trainer resumes in
    the port's trainer: every leaf loads (key words, int32 steps, the
    ``(P, C, …)`` chains), the completed loop is a no-op, and the port's
    evaluation of the JAX chains gives each pair the JAX run's Dice."""
    from ir_sgmcmc_tpu.trainer import Trainer as JTrainer

    c, jconfig = _jax_cfg(tmp_path / "jax")
    s_jax = JTrainer(jconfig).run()
    ckpt = jconfig.save_dirs["models"] / "mcmc_latest.npz"
    assert peek_meta(ckpt)["pair_parallel"] == 2
    c["trainer"]["save_dir"] = str(tmp_path / "port")
    s = Trainer(Config(c, run_id="p"), device="cpu", resume=str(ckpt)).run()
    assert len(s) == 2 and all("mcmc_aborted" not in x for x in s)
    for a, b in zip(s, s_jax):
        assert abs(a["mcmc_mean_dsc"] - b["mcmc_mean_dsc"]) < 1e-3


def test_port_pair_checkpoint_loads_into_the_jax_template(tmp_path):
    """A pair-stacked MCMC checkpoint written by the port's trainer loads
    into the template the JAX trainer builds (its ``init_chains`` per pair,
    stacked), leaf for leaf."""
    import jax

    from ir_sgmcmc_tpu.engine import init_chains as j_init_chains
    from ir_sgmcmc_tpu.engine.pairs import stack_trees as j_stack
    from ir_sgmcmc_tpu.utils.checkpoint import load_checkpoint as j_load

    c, jconfig = _jax_cfg(tmp_path / "jax")
    c["trainer"]["save_dir"] = str(tmp_path / "port")
    config = Config(c, run_id="p")
    Trainer(config, device="cpu").run()
    ckpt = config.save_dirs["models"] / "mcmc_latest.npz"
    bundle = jconfig.build_bundle()
    _, opt_gmm, opt_reg = jconfig.build_optimizers(bundle)
    template = j_stack([j_init_chains(bundle, jax.random.PRNGKey(i), 2, "noise", None,
                                      bundle.gmm.init_params(), bundle.reg_loss.init_params(),
                                      opt_gmm, opt_reg) for i in range(2)])
    state, meta = j_load(ckpt, template)
    assert meta["pair_parallel"] == 2 and meta["mcmc_steps"] == 3
    assert np.asarray(state.step).tolist() == [3, 3]
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    with np.load(ckpt) as f:
        assert len(leaves) == len([k for k in f.files if k.startswith("leaf::")])
        for path, leaf in leaves:
            np.testing.assert_array_equal(np.asarray(leaf),
                                          f["leaf::" + jax.tree_util.keystr(path)])
