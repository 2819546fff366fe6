"""On the card, at each cell's own size: the sound program is correct, and
the control (the program's own bfloat16 integrator, the precision below
the configured float32) is not, nor, where a matmul is on the path (the
B-spline spread), the program with TF32 switched on.  ``python -m pytest
perfbench/tests -q -m cuda`` on the H100; skips without a card."""

import pytest

from perfbench import run

CELLS = ["exp3_svf128.mcmc_pairs4", "exp5_svffd2_128.mcmc_pairs4", "exp3_svf128.vi_pairs4"]


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
