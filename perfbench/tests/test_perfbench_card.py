"""On the card, at each cell's own size: the sound program is correct, and
the control (the program's own bfloat16 integrator, the precision below
the configured float32) is not, nor, where a matmul is on the path (the
B-spline spread), the program with TF32 switched on.  ``python -m pytest
perfbench/tests -q -m cuda`` on the H100; skips without a card."""

import pytest

from perfbench import run

CELLS = ["exp3_svf128.mcmc_pairs4", "exp5_svffd2_128.mcmc_pairs4", "exp3_svf128.vi_pairs4",
         "exp3_svf256.mcmc_pair1", "exp3_svf256.vi_pair1"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_sound_correct_control_not(cuda, workload):
    spec = run.load_cell(workload)
    for seed in (3400000001, 3400000002, 3400000003):
        assert run.run_cell(spec, seed, 0.5, False, cuda)["correct"] is True
        control = run.run_cell(spec, seed, 0.5, False, cuda, compute_dtype="bfloat16")
        assert control["correct"] is False, control["checked"]


@pytest.mark.cuda
def test_tf32_is_not_correct(cuda):
    spec = run.load_cell("exp5_svffd2_128.mcmc_pairs4")
    for seed in (3400000001, 3400000002, 3400000003):
        out = run.run_cell(spec, seed, 0.5, False, cuda, tf32=True)
        assert out["correct"] is False, out["checked"]


@pytest.mark.cuda
def test_remat_vi_launches_as_the_trainer_does(cuda):
    """At 256³ VI runs its two rows in turn under recompute: per step T1,
    B1 and B3 run twice for each row (its forward and its recompute), the
    backward kernels T2, B2 and B4 once."""
    from collections import Counter

    from perfbench import drive, reference, trace

    spec = run.load_cell("exp3_svf256.vi_pair1")
    cfg = drive.configured(spec.config, spec.traffic)
    dims = tuple(cfg["data_loader"]["args"]["dims"])
    inputs = drive.Inputs(3400000021, spec.traffic, dims, reference.Model(cfg, cuda).field_dims,
                          cuda)
    program = drive.Program(cfg, spec.traffic, inputs, cuda)
    assert program.remat
    program.gmm_warmup()
    for _ in range(2):
        program.call()
    rec = trace.record(program.call, 2, cuda)
    names = [name for name, _, _ in rec.device]
    count = Counter(trace.kind_of(n) for n in names)
    count.update(T1=sum("taylor_sq_fwd" in n for n in names),
                 T2=sum("taylor_sq_bwd" in n for n in names))
    per_step = {k: count[k] / rec.steps for k in ("T1", "T2", "B1", "B2", "B3", "B4")}
    assert per_step == {"T1": 36, "T2": 18, "B1": 28, "B2": 14, "B3": 4, "B4": 2}


@pytest.mark.cuda
def test_sharded_program_on_two_cards(cuda):
    """Experiment 3 at 128³ with its SG-MCMC cut along D over two cards
    (``distribute``, ``spatial_shards`` 2): the sound run is correct and
    counts both cards, the ``seam`` fault is not correct.  Skips with fewer
    than 2 cards."""
    import torch

    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards")
    spec = run.load_cell("exp3_svf128.mcmc_pairs4")
    spec.config["trainer"].update(distribute=True, spatial_shards=2)
    spec.traffic["pairs"] = 1
    devices = [torch.device("cuda", 0), torch.device("cuda", 1)]
    out = run.run_cell(spec, 3400000031, 0.5, False, devices)
    assert out["correct"] is True, out["checked"]
    assert out["device"]["count"] == 2
    seam = run.run_cell(spec, 3400000031, 0.5, False, devices, fault="seam")
    assert seam["correct"] is False, seam["checked"]
