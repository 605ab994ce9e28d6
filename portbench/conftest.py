"""Fixtures of the benchmark's CPU tests: a checkout-shaped directory
whose BENCHMARK.json holds the real cells on tiny configurations (20,000
rows, the `torch` engine's plain twins, small SMBO budgets, 128-window
calls), so that a whole run takes seconds on the CPU."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import harness  # noqa: E402

FORBIDDEN_MODULES = harness.forbidden_modules   # before the stand-in below

TINY_ROWS = 20_000


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips elsewhere")


def make_tiny_root(dest: Path, engine: str = "torch") -> Path:
    """A copy of BENCHMARK.json and portbench's data files, metric readers
    and query kinds, with every configuration cut to TINY_ROWS rows on
    `engine`, and every mix to three 128-window calls."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = dest / "portbench"
    for folder in ("metrics", "kinds"):
        shutil.copytree(ROOT / "portbench" / folder, pb / folder,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (pb / "configs").mkdir(parents=True)
    (pb / "traffic").mkdir()
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        extra = dict(cfg["smbo"].get("extra") or {}, evals_per_iter=2,
                     n_init=3)
        cfg.update(rows=TINY_ROWS, engine=engine,
                   engine_config={"q_chunk": 64},
                   smbo={"seed": 0, "train_windows": 16, "sample": 2000,
                         "iters": 1, "extra": extra})
        (dest / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        src = ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
        t = json.loads(src.read_text())
        # 1e-5 of 20,000 rows is no row: tiny windows take at least 2e-3
        t.update(windows_a_call=128, pool_calls=3, probes=32,
                 checked_calls=2, traced_calls=2,
                 selectivity=max(t["selectivity"], 2e-3))
        (pb / "traffic" / src.name).write_text(json.dumps(t))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


@pytest.fixture(autouse=True)
def no_module_check_in_process(monkeypatch):
    """A test worker that ran the JAX package's tests holds `jax` and
    `repro`: in-process runs skip the harness's look at the loaded
    modules, which `test_portbench_run.py` checks in a fresh process and
    by itself."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
