"""Whole runs of the harness on the CPU (the `torch` engine's twins on
tiny configurations): the result line's keys, the modules loaded, the
refusals of run.py, and `correct` turning false under each fault the
cells can have."""
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.conftest import ROOT

RUN_AND_SHOW = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
from portbench import harness
lines = [harness.run_cell(c, 2**31 + 9, 0.3, t, t_process=0.0,
                          device="cpu", engine="torch", root={tiny!r})
         for c, t in (("osm.count", False), ("osm.range", True))]
print(json.dumps({{"lines": lines,
                  "modules": sorted({{m.split(".")[0]
                                     for m in sys.modules}})}}))
"""


def test_lines_have_the_contract_keys_and_no_jax_is_loaded(tiny_root):
    out = subprocess.run(
        [sys.executable, "-c", RUN_AND_SHOW.format(
            src=str(ROOT / "src"), root=str(ROOT), tiny=str(tiny_root))],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    plain, traced = got["lines"]
    assert list(plain) == [*harness.CONTRACT_KEYS, "checks"]
    assert list(traced) == [*harness.CONTRACT_KEYS, "breakdown", "checks"]
    assert set(plain["metrics"]) == {"qps", "call_p95_ms", "setup_s"}
    assert plain["correct"] is True and traced["correct"] is True
    assert set(traced["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes", "busy_s",
                                     "window_s"}
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in plain["checks"].values():
        assert set(c) == {"value", "limit"}
    assert "repro_torch" in got["modules"]
    assert not set(got["modules"]) & {"jax", "jaxlib", "flax", "repro"}


def test_run_py_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "osm.count", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_run_py_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "osm.count", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def _altered_count(fn):
    def wrapped(*a, **kw):
        cnt = fn(*a, **kw)
        return cnt + (torch.arange(len(cnt), device=cnt.device) == 0)
    return wrapped


def _dropped_id(fn):
    def wrapped(*a, **kw):
        ids, n_hits = fn(*a, **kw)
        ids = ids.clone()
        ids[:, 0] = -1
        return ids, n_hits
    return wrapped


def _half_left_out(run):
    def wrapped(self, Ls, Us, *a, **kw):
        out = run(self, Ls, Us, *a, **kw)
        half = len(Ls) // 2
        if isinstance(out[0], list):           # run_range: rows a window
            out[0][half:] = [r[:0] for r in out[0][half:]]
        else:
            out[0][half:] = 0
        return out
    return wrapped


@pytest.mark.parametrize("cell,fault", [
    ("osm.count", "answer_altered"), ("osm.count", "half_left_out"),
    ("osm.range", "answer_altered"), ("osm.range", "half_left_out")])
def test_a_fault_in_the_timed_path_is_not_correct(tiny_root, monkeypatch,
                                                   cell, fault):
    from repro_torch.api.engines import TorchEngine
    from repro_torch.core import serve
    if fault == "answer_altered":
        if cell.endswith("count"):
            monkeypatch.setattr(serve, "window_filter_paged",
                                _altered_count(serve.window_filter_paged))
        else:
            monkeypatch.setattr(serve, "window_match_paged",
                                _dropped_id(serve.window_match_paged))
    else:
        for name in ("run", "run_range"):
            monkeypatch.setattr(TorchEngine, name,
                                _half_left_out(getattr(TorchEngine, name)))
    line = harness.run_cell(cell, 17, 0.2, False, t_process=0.0,
                            device="cpu", engine="torch", root=tiny_root)
    assert line["correct"] is False
    assert max(c["value"] for c in line["checks"].values()) > 0


def test_forbidden_modules_are_compared_by_whole_top_level_names():
    from portbench.conftest import FORBIDDEN_MODULES as look
    names = ["jax.numpy", "jaxlib", "repro_torch.api", "repro.core", "flaxen",
             "numpy", "reprox"]
    assert look(names) == ["jax", "jaxlib", "repro"]
    assert look(["repro_torch", "torch"]) == []


def test_a_run_that_loaded_jax_prints_no_result(tiny_root, monkeypatch):
    monkeypatch.setattr(harness, "forbidden_modules", lambda: ["jax"])
    with pytest.raises(harness.CellError, match="jax"):
        harness.run_cell("osm.count", 5, 0.2, False, t_process=0.0,
                         device="cpu", engine="torch", root=tiny_root)


def test_reservoir_is_seeded_and_uniform():
    picks = []
    for seed in range(200):
        r = harness.Reservoir(4, seed)
        for i in range(40):
            r.offer(i)
        picks += r.items
    again = harness.Reservoir(4, 7)
    for i in range(40):
        again.offer(i)
    first = harness.Reservoir(4, 7)
    for i in range(40):
        first.offer(i)
    assert again.items == first.items
    counts = np.bincount(picks, minlength=40)
    assert counts.min() > 5 and counts.max() < 40
