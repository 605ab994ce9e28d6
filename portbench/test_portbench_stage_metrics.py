"""The per-layer metrics that read the program's stage spans: each reader
on a hand-made trace, and every one of them reported by a traced CPU run
of each cell that lists it."""
import dataclasses
import json

import pytest

from portbench import harness
from portbench.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

# metric -> the span it sums
STAGE_METRICS = {
    "split_host_us_per_query": "serve.split",
    "prune_host_us_per_query": "serve.prune",
    "device_wait_us_per_query": "executor.device_wait",
    "escalation_us_per_query": "executor.escalate",
    "row_resolve_us_per_query": "serve.resolve_rows",
    "row_order_us_per_query": "executor.order_rows",
}


@dataclasses.dataclass
class S:
    name: str
    t0_ns: int
    dur_ns: int
    depth: int


def traced(spans):
    """Two traced calls of two windows each, with `spans`."""
    return harness.Traced(card="NVIDIA H100 80GB HBM3", calls=2, queries=4,
                          window_ns=20_000, lo_ns=0, hi_ns=20_000, events=[],
                          busy_ns=0, spans=spans, calls_made=[],
                          call_ns=[9000, 9000], mbrs=None, sizes=None)


def call_tree(stage):
    """Each call's root and executor spans, with two `stage` spans of 3
    and 5 us in the first call and none in the second."""
    return [S("database.query", 0, 9000, 0),
            S("executor.execute", 100, 8800, 1),
            S(stage, 200, 3000, 3), S(stage, 4000, 5000, 3),
            S("database.query", 10_000, 9000, 0),
            S("executor.execute", 10_100, 8800, 1)]


@pytest.mark.parametrize("name", sorted(STAGE_METRICS))
def test_stage_reader_sums_its_spans_per_window(name):
    read = harness.load_metric(name).read
    span = STAGE_METRICS[name]
    assert read(traced(call_tree(span))) == pytest.approx(8000 / 1e3 / 4)
    # the calls' roots without the stage's spans (another stage's only):
    # no rung ran, 0, for the ladder's metric; nothing for the others
    bare = call_tree("serve.kernel")
    assert read(traced(bare)) == (0.0 if name == "escalation_us_per_query"
                                  else None)
    # a program without the stage spans: `executor.execute` alone
    assert read(traced([s for s in bare if s.name == "executor.execute"])) \
        is None


def test_stage_metrics_list_every_cell_that_runs_their_stage():
    """Each stage metric lists every cell, or (with KINDS) every cell
    whose mix holds one of its kinds."""
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    cells = [harness.load_cell(w["name"]) for w in BENCH["workloads"]]
    for name in STAGE_METRICS:
        m = entries[name]
        assert (m["source"], m["unit"], m["moves"]) == (
            "program_span", "us/query", "qps")
        kinds = getattr(harness.load_metric(name), "KINDS", None)
        assert m["workloads"] == [c.name for c in cells
                                  if kinds is None or set(kinds) & set(
                                      c.traffic["kinds"])]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_traced_run_reports_every_stage_metric_of_its_cell(tiny_root,
                                                           cell):
    """A traced run on the CPU reports each stage metric its cell lists,
    each a number (above 0 but for the ladder's, which no rung may
    need)."""
    line = harness.run_cell(cell, 2**31 + 17, 0.2, True, t_process=0.0,
                            device="cpu", engine="torch", root=tiny_root)
    assert line["correct"] is True
    want = {m["name"] for m in BENCH["per_layer"]
            if m["name"] in STAGE_METRICS and cell in m["workloads"]}
    assert want and want <= set(line["metrics"])
    for name in want:
        v = line["metrics"][name]
        assert v["unit"] == "us/query" and v["value"] >= 0
    for name in want - {"escalation_us_per_query"}:
        assert line["metrics"][name]["value"] > 0
