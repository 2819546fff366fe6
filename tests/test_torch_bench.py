"""The port's benchmark entry (``python -m ir_sgmcmc_tpu_torch.bench``)
against the root ``bench.py``, on the CPU.

* ``make_bundle_and_pair`` builds ``bench.py::_make_bundle_and_pair``'s
  problem: every bundle field, the transformation's options and the sphere
  pair (bitwise), for the dense and SVFFD models under the flags the
  benchmark forwards (``use_gather``, ``compute_dtype``,
  ``taylor_compositions``, ``taylor_threshold``), at 16³;
* ``main`` at ``--device cpu`` prints one JSON line per phase whose keys are
  those of the matching ``json.dumps({...})`` literal of ``bench.py`` (read
  with ``ast``), less the keys that are not ported, plus the port's own,
  in order: the VI line, the non-canonical MCMC line, and the canonical
  line with and without a cached torch-CPU anchor;
* ``--taylor-compositions on`` and ``--anchor`` (kept for the record, as
  in ``bench.py``) run and print the non-canonical MCMC line; without CUDA
  and without ``--device``, ``main`` raises.
"""

import ast
import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

from ir_sgmcmc_tpu_torch import bench

REPO = Path(__file__).resolve().parents[1]
SMALL = (16, 16, 16)

# bench.py's keys that the port does not emit, and the keys it adds per line
NOT_PORTED = {"pallas_fallback", "vi_error", "vi_cached_same_head"}
HOST = ["backend", "device", "power_limit", "build_s", "peak_mem_bytes"]
ADDED = {"mcmc": HOST + ["launches_per_step"], "vi": HOST + ["launches_per_step"],
         "canonical": HOST + ["vi_peak_mem_bytes", "launches_per_step",
                              "vi_launches_per_step"]}


def _root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- the model -----------------------------------------------------------------

def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_attrs(j, t, what: str):
    """Every attribute of the JAX object equals the port object's."""
    assert type(t).__name__ == type(j).__name__, what
    for k, jv in vars(j).items():
        assert hasattr(t, k), f"{what}: the port lacks {k!r}"
        np.testing.assert_array_equal(_np(getattr(t, k)), _np(jv), err_msg=f"{what}.{k}")


def _dtype_name(dt):
    return None if dt is None else str(dt).replace("torch.", "")


def _same_transformation(jt, tt):
    assert type(tt).__name__ == type(jt).__name__
    if type(jt).__name__ == "SVFFD3D":
        for a in ("dims", "cps", "control_dims", "max_disp", "use_gather",
                  "displacement_clamp_bound", "image_clamp_bound"):
            assert getattr(tt, a) == getattr(jt, a), a
        jt, tt = jt.svf, tt.svf
    for a in ("dims", "no_steps", "max_disp", "use_gather", "taylor_threshold",
              "composition_form", "taylor_compositions", "no_squarings", "no_taylor",
              "no_compositions", "no_image_compositions", "displacement_clamp_bound",
              "image_clamp_bound"):
        assert getattr(tt, a) == getattr(jt, a), a
    assert _dtype_name(tt.compute_dtype) == _dtype_name(jt.compute_dtype)


@pytest.mark.parametrize("model,kwargs", [
    ("svf", {}), ("svf", {"use_gather": True}), ("svf", {"compute_dtype": "bfloat16"}),
    ("svf", {"compute_dtype": "float32"}), ("svf", {"taylor_compositions": False}),
    ("svf", {"taylor_compositions": "split", "taylor_threshold": 0.25}),
    ("svffd", {}), ("svffd", {"use_gather": True}), ("svffd", {"compute_dtype": "bfloat16"}),
    ("svffd", {"taylor_compositions": False})],
    ids=lambda v: v if isinstance(v, str) else "-".join(f"{k}={x}" for k, x in v.items()))
def test_bundle_and_pair_match_root_bench(model, kwargs):
    jb, jf, jm = _root_bench()._make_bundle_and_pair("post", dims=SMALL, model=model, cps=2,
                                                     **kwargs)
    tb, tf, tm = bench.make_bundle_and_pair("post", SMALL, model, 2, "cpu", **kwargs)
    names = [f.name for f in dataclasses.fields(jb)]
    assert names == [f.name for f in dataclasses.fields(tb)]
    for name in names:
        j, t = getattr(jb, name), getattr(tb, name)
        if name == "transformation":
            _same_transformation(j, t)
        elif name == "_sobolev_kernel":  # two float32 solves
            np.testing.assert_allclose(_np(t), _np(j), rtol=0, atol=1e-7)
        elif hasattr(j, "__dict__"):  # the GMM, priors and the reg loss
            _same_attrs(j, t, name)
        else:
            assert t == j and (j is None) == (t is None), name
    assert tb.field_dims == tuple(jb.field_dims)
    for jd, td in ((jf, tf), (jm, tm)):
        assert sorted(jd) == sorted(td)
        for k in jd:
            assert td[k].device.type == "cpu"
            a, b = np.asarray(jd[k]), td[k].numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), k


# ---- the lines -------------------------------------------------------------------

def _expand(tree, node) -> list:
    """The keys of a dict literal, its ``**`` entries resolved: a
    conditional's dict, or every dict literal assigned to the name."""
    keys = []
    for k, v in zip(node.keys, node.values):
        if k is not None:
            keys.append(k.value)
        elif isinstance(v, ast.IfExp):
            keys += _expand(tree, v.body)
        else:
            for a in ast.walk(tree):
                if (isinstance(a, ast.Assign) and isinstance(a.value, ast.Dict)
                        and [getattr(t, "id", None) for t in a.targets] == [v.id]):
                    keys += [x for x in _expand(tree, a.value) if x not in keys]
    return keys


def _root_lines() -> dict:
    """``{kind: keys}`` of ``bench.py``'s three printed ``json.dumps({...})``
    literals: ``"canonical"`` (a constant metric), ``"vi"`` and ``"mcmc"``."""
    tree = ast.parse((REPO / "bench.py").read_text())
    lines = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "print"
                and node.args and isinstance(node.args[0], ast.Call)
                and isinstance(node.args[0].args[0], ast.Dict)):
            d = node.args[0].args[0]
            metric = d.values[[k.value for k in d.keys if k is not None].index("metric")]
            if isinstance(metric, ast.Constant):
                kind = "canonical"
            else:
                kind = "vi" if metric.values[0].value.startswith("vi_") else "mcmc"
            lines[kind] = _expand(tree, d)
    assert sorted(lines) == ["canonical", "mcmc", "vi"]
    return lines


@pytest.fixture
def small_bench(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "TIMED_STEPS", 2)
    monkeypatch.setattr(bench, "VI_TIMED_STEPS", 2)
    monkeypatch.setattr(bench, "TIMED_REPEATS", 1)
    monkeypatch.setattr(bench, "BASELINE_CACHE", tmp_path / ".bench_baseline.json")
    return bench


@pytest.mark.parametrize("kind,argv,cached", [
    ("vi", ["--phase", "vi", "--dims", "16"], False),
    ("vi", ["--phase", "vi", "--dims", "16", "--noise-scheme", "pre", "--model", "svffd"], False),
    ("mcmc", ["--dims", "16"], False),
    ("canonical", [], False),
    ("canonical", [], True)])
def test_lines_have_root_bench_keys(small_bench, monkeypatch, capsys, kind, argv, cached):
    """One JSON line per run, with ``bench.py``'s keys of that line in its
    order (less the ones not ported, plus the port's); the canonical run at
    16³ (``DIMS`` patched), with no anchor cached (no ``vs_baseline`` nor
    ``baseline_*``) and with one."""
    anchor = {"samples_per_sec": 0.1, "median_s": 20.0, "iqr_s": 1.0, "spread_rel": 0.05,
              "timed_transitions": 20}
    if cached:
        small_bench.BASELINE_CACHE.write_text(json.dumps(anchor))
    if kind == "canonical":
        monkeypatch.setattr(bench, "DIMS", SMALL)
    line = bench.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line

    keys = [k for k in _root_lines()[kind] if k not in NOT_PORTED]
    if kind == "canonical" and not cached:
        keys = [k for k in keys if k != "vs_baseline" and not k.startswith("baseline_")]
    assert list(line) == keys + ADDED[kind]
    rate = line["value"]
    assert math.isfinite(rate) and rate > 0 and line["timed_chunks_s"] and len(
        line["timed_chunks_s"]) == 1
    assert line["backend"] == "torch-cpu" and line["launches_per_step"] == {}
    model = "_svffd2" if "svffd" in argv else ""
    if kind == "vi":
        assert line["metric"] == f"vi_iters_per_sec_16cubed{model}"
    else:
        assert line["metric"] == "sgmcmc_samples_per_sec_16cubed_2chains"
    if kind == "canonical":
        assert math.isfinite(line["vi_iters_per_sec"]) and line["vi_iters_per_sec"] > 0
        if cached:
            assert line["vs_baseline"] == round(rate / anchor["samples_per_sec"], 2)
            assert line["baseline_timed_transitions"] == 20


def test_trace_is_readable(small_bench, tmp_path, capsys):
    """``--trace DIR`` writes a Chrome trace of one more chunk after the
    line, which ``scripts.trace_summary`` reads (on the CPU it holds no
    device event)."""
    from ir_sgmcmc_tpu_torch.scripts import trace_summary

    bench.main(["--device", "cpu", "--dims", "16", "--trace", str(tmp_path / "tr")])
    assert len(capsys.readouterr().out.strip().splitlines()) == 1
    assert (tmp_path / "tr/trace.json").exists()
    assert trace_summary.load_events(tmp_path / "tr/trace.json") == []


def test_vi_remat_rule():
    """Remat from a dense f32 field of 100 MiB: off at 128³, on at 256³."""
    assert not bench.vi_remat((128,) * 3) and bench.vi_remat((256,) * 3)


# ---- the record-keeping flags -------------------------------------------------------

@pytest.mark.parametrize("argv", [["--taylor-compositions", "on"],
                                  ["--anchor", "--anchor-radius", "3"]])
def test_taylor_and_anchor_flags_run(small_bench, monkeypatch, capsys, argv):
    """``--taylor-compositions on`` and ``--anchor`` run at 16³ and print
    ``bench.py``'s non-canonical MCMC line, its keys in its order; the
    flags reach the model and the chunk (the "taylor" form; an anchored
    chunk at the given radius)."""
    from ir_sgmcmc_tpu_torch import engine

    seen = {}
    real = engine.make_mcmc_chunk

    def spy(bundle, *args, **kw):
        seen.update(form=bundle.transformation.composition_form, **kw)
        return real(bundle, *args, **kw)

    monkeypatch.setattr(engine, "make_mcmc_chunk", spy)
    line = bench.main(["--device", "cpu", "--dims", "16", *argv])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    keys = [k for k in _root_lines()["mcmc"] if k not in NOT_PORTED]
    assert list(line) == keys + ADDED["mcmc"]
    assert math.isfinite(line["value"]) and line["value"] > 0
    if "--anchor" in argv:
        assert seen["anchored"] is True and seen["anchor_radius"] == 3
        assert seen["form"] == "split"
    else:
        assert seen["anchored"] is False and seen["form"] == "taylor"


def test_no_cuda_without_device_raises(small_bench, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--dims", "16"])
