"""The port's stage spans (``utils/spans.py``) on the CPU, at 16³: no
``record_function`` without a profiler; under one, a pair-stacked SG-MCMC
transition and VI step each open every stage span inside their step span
and no other ``ir.`` span, every backward node links by its sequence number
to a forward op inside a stage; and a profiled run's states equal an
unprofiled run's bit for bit."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

from ir_sgmcmc_tpu_torch.data import sphere_pair
from ir_sgmcmc_tpu_torch.engine import ModelBundle, VIState, init_chains
from ir_sgmcmc_tpu_torch.engine.pairs import make_pair_mcmc_chunk, make_pair_vi_chunk, stack_trees
from ir_sgmcmc_tpu_torch.models import (GMM, SVF3D, DirichletPrior, LogEnergyExpGammaPrior,
                                        LogScaleNormalPrior, RegLossLogNormal)
from ir_sgmcmc_tpu_torch.optim import adam_decay
from ir_sgmcmc_tpu_torch.utils import spans

DIMS = (16, 16, 16)
CPU = torch.device("cpu")
OPT_GMM = adam_decay(0.2, 1e-3)
OPT_REG = adam_decay({"loc": 0.01, "log_scale": 0.01}, 1e-3)
OPT_Q_V = adam_decay({"mu": 0.01, "log_var": 0.01, "u": 0.01}, 1e-3)
EVALUATE = "autograd::engine::evaluate_function"
STEP = {"mcmc": spans.MCMC_STEP, "vi": spans.VI_STEP}


def _bundle():
    dof = 3.0 * float(np.prod(DIMS))
    return ModelBundle(
        dims=DIMS, gmm=GMM(4, 1), scale_prior=LogScaleNormalPrior(0.0, 2.3),
        proportion_prior=DirichletPrior(4, 0.5),
        reg_loss=RegLossLogNormal(w_reg=1.4, dims=DIMS, learnable=True),
        reg_loc_prior=LogEnergyExpGammaPrior(w_reg=1.4, dof=dof),
        reg_scale_prior=LogScaleNormalPrior(loc=2.8, scale=5.0),
        transformation=SVF3D(DIMS, no_steps=6, max_disp=4), sobolev_s=3,
        uniform_noise_alpha=0.1, noise_scheme="post", virtual_decimation=True)


def _warm_gmm(bundle, i):
    gmm = bundle.gmm.init_scales_from_residual_std(bundle.gmm.init_params(CPU), 1.0 + 0.1 * i)
    gmm["logits"] = torch.tensor([0.3, -0.2, 0.1, -0.4]) * (1 + i)
    return gmm


def _run(phase):
    """``(call, state)``: one pair-stacked step of 2 pairs per call."""
    bundle = _bundle()
    pairs = [sphere_pair(DIMS, offset=(0.0, 1.0, float(i)), seed=i) for i in range(2)]
    fixed = stack_trees([{k: torch.as_tensor(v) for k, v in f.items()} for f, _ in pairs])
    moving = stack_trees([{k: torch.as_tensor(v) for k, v in m.items()} for _, m in pairs])
    if phase == "mcmc":
        state = stack_trees([init_chains(bundle, torch.Generator().manual_seed(20 + i), 2,
                                         "noise", None, _warm_gmm(bundle, i),
                                         bundle.reg_loss.init_params(CPU), OPT_GMM, OPT_REG,
                                         device=CPU) for i in range(2)])
        return make_pair_mcmc_chunk(bundle, OPT_GMM, OPT_REG, 0.1, fixed, moving, chunk=1,
                                    burn_in=0, thin=1), state
    states = []
    for i in range(2):
        q_v = bundle.init_q_v(0.5, 0.1, CPU)
        gmm, reg = _warm_gmm(bundle, i), bundle.reg_loss.init_params(CPU)
        states.append(VIState(q_v=q_v, gmm=gmm, reg=reg, opt_q_v=OPT_Q_V.init(q_v),
                              opt_gmm=OPT_GMM.init(gmm), opt_reg=OPT_REG.init(reg),
                              key=torch.tensor([7, 50 + i]), step=0))
    return make_pair_vi_chunk(bundle, OPT_Q_V, OPT_GMM, OPT_REG, fixed, moving, chunk=1), \
        stack_trees(states)


def _traced(phase, tmp_path):
    """The Chrome trace's complete events of one profiled call."""
    call, state = _run(phase)
    state, _ = call(state)  # the first step outside the profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call(state)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and "dur" in e]


def _inside(e, outer) -> bool:
    return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"] + 1e-3


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with spans.span(spans.INTEGRATE) as a, spans.span(spans.UPDATE) as b:
        assert a is None and b is None
    assert spans.span(spans.SMOOTH) is spans.span(spans.MCMC_STEP)
    call, state = _run("mcmc")
    call(state)  # a whole step, every span of it


def test_span_names():
    assert spans.STAGES == ("smooth", "integrate", "warp", "likelihood", "regulariser",
                            "update", "bookkeeping")
    names = [spans.SMOOTH, spans.INTEGRATE, spans.WARP, spans.LIKELIHOOD, spans.REGULARISER,
             spans.UPDATE, spans.BOOKKEEPING]
    assert names == [spans.PREFIX + s for s in spans.STAGES]
    assert all(not n.startswith("aten::") for n in names + [spans.MCMC_STEP, spans.VI_STEP])


@pytest.mark.parametrize("phase", ["mcmc", "vi"])
def test_every_stage_under_the_step_span(phase, tmp_path):
    events = _traced(phase, tmp_path)
    ours = [e for e in events if e["name"].startswith(spans.PREFIX)]
    stages = {spans.PREFIX + s for s in spans.STAGES}
    assert {e["name"] for e in ours} <= stages | {STEP[phase]}
    steps = [e for e in ours if e["name"] == STEP[phase]]
    assert len(steps) == 1
    nested = {e["name"] for e in ours if e["name"] in stages and _inside(e, steps[0])}
    assert nested == stages


@pytest.mark.parametrize("phase", ["mcmc", "vi"])
def test_backward_links_to_a_staged_forward_op(phase, tmp_path):
    """Each backward node's ``evaluate_function`` event carries the
    sequence number of a forward op that ran inside a stage span: the
    latest op with that number before it (ops that make no node carry the
    number of the next one that does; a leaf's ``AccumulateGrad`` carries
    none)."""
    events = _traced(phase, tmp_path)
    stage_spans = [e for e in events if e["name"] in {spans.PREFIX + s for s in spans.STAGES}]
    evaluates = [e for e in events if e["name"].startswith(EVALUATE)]
    forward = {}
    for e in events:
        seq = (e.get("args") or {}).get("Sequence number")
        # not an evaluate_function event nor the node's own call inside it
        if seq is not None and e.get("cat") == "cpu_op" and not e["name"].startswith(EVALUATE) \
                and not any(_inside(e, ev) and ev["args"].get("Sequence number") == seq
                            for ev in evaluates):
            forward.setdefault(seq, []).append(e)
    linked = 0
    for ev in evaluates:
        seq = (ev.get("args") or {}).get("Sequence number")
        if seq is None:
            assert ev["name"].endswith("AccumulateGrad"), ev["name"]
            continue
        ops = sorted((op for op in forward.get(seq, []) if op["ts"] <= ev["ts"]),
                     key=lambda op: op["ts"])
        assert ops, ev["name"]
        assert any(_inside(ops[-1], s) for s in stage_spans), (ev["name"], ops[-1]["name"])
        linked += 1
    assert linked > 50


@pytest.mark.parametrize("phase", ["mcmc", "vi"])
def test_profiled_states_equal_unprofiled(phase):
    def three(profiled):
        call, state = _run(phase)
        for _ in range(3):
            if profiled:
                with profile(activities=[ProfilerActivity.CPU]):
                    state, _ = call(state)
            else:
                state, _ = call(state)
        return state

    got, ref = three(True), three(False)
    flat_got, flat_ref = [], []
    for tree, flat in ((got, flat_got), (ref, flat_ref)):
        stack = [tree]
        while stack:
            t = stack.pop()
            if isinstance(t, dict):
                stack.extend(t[k] for k in sorted(t))
            elif isinstance(t, tuple):
                stack.extend(t)
            elif isinstance(t, torch.Tensor):
                flat.append(t)
    assert len(flat_got) == len(flat_ref) > 10
    for a, b in zip(flat_got, flat_ref):
        assert torch.equal(a, b)
