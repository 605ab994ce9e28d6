"""Every configuration, cell and metric of BENCHMARK.json loads by name,
agrees with its file, and a new cell needs only new files and entries."""
import json
import re

import numpy as np
import pytest

from portbench import harness
from portbench.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_has_the_contract_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_loads_and_agrees(conf):
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert cfg["name"] == conf["name"]
    assert cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"]
    assert cfg["K"] == min(32, 64 // cfg["d"])
    assert cfg["rows"] < cfg["source_rows"]
    assert set(conf["reduced"]) <= set(cfg)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads_by_name(cell):
    c = harness.load_cell(cell["name"])
    assert c.config["name"] == cell["config"]
    assert c.traffic["name"] == cell["traffic"]
    assert c.chips == cell["chips"] == 1
    assert {m["name"] for m in c.end_to_end} == {
        m["name"] for m in BENCH["end_to_end"]
        if cell["name"] in m.get("workloads", [cell["name"]])}
    assert {"qps", "setup_s"} <= {m["name"] for m in c.end_to_end}
    assert ("call_p95_ms" in {m["name"] for m in c.end_to_end}) == (
        cell["name"] != "nyc.range")
    assert c.per_layer, "every cell reports a per-layer metric"
    assert set(c.kinds) == set(c.traffic["kinds"])
    for k, mod in c.kinds.items():
        assert mod.NAME == k and callable(mod.make_query)
    for m in c.per_layer:
        mod = harness.load_metric(m["name"])
        assert set(getattr(mod, "KINDS", c.kinds)) & set(c.kinds)


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_agrees_with_benchmark_json(metric):
    mod = harness.load_metric(metric["name"])
    assert (mod.NAME, mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER,
            mod.MOVES) == (metric["name"], metric["unit"], metric["better"],
                           metric["source"], metric["layer"],
                           metric["moves"])
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_a_new_cell_needs_only_new_files_and_entries(tmp_path):
    """A throwaway configuration, mix, metric and cell, added as files
    and entries beside copies of the existing ones, run on the CPU."""
    from portbench.conftest import make_tiny_root
    root = make_tiny_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/osm-10m.json").read_text())
    cfg.update(name="stock-tiny", generator="stock", d=4, K=16,
               curve="global")
    (root / "portbench/configs/stock-tiny.json").write_text(json.dumps(cfg))
    mix = json.loads(
        (root / "portbench/traffic/count.q1024.sel1e-3.json").read_text())
    mix.update(name="count.q64.sel1e-2", windows_a_call=64,
               selectivity=0.01, kinds={"count": 1.0})
    (root / "portbench/traffic/count.q64.sel1e-2.json").write_text(
        json.dumps(mix))
    (root / "portbench/metrics/windows_per_call.py").write_text(
        'NAME = "windows_per_call"\nUNIT = "windows"\nBETTER = "higher"\n'
        'SOURCE = "program_counter"\nLAYER = "facade and executor"\n'
        'MOVES = "qps"\nKINDS = ("count",)\n\n\ndef read(t):\n'
        '    return t.queries / t.calls\n')
    bench["configs"].append({"name": "stock-tiny", "source": "x",
                             "file": "portbench/configs/stock-tiny.json",
                             "reduced": ["rows"], "why": "x"})
    bench["workloads"].append({"name": "stock.count", "config": "stock-tiny",
                               "traffic": "count.q64.sel1e-2", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "windows_per_call",
                               "unit": "windows", "better": "higher",
                               "source": "program_counter",
                               "layer": "facade and executor",
                               "moves": "qps",
                               "workloads": ["stock.count"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line = harness.run_cell("stock.count", 3, 0.2, True, t_process=0.0,
                            device="cpu", engine="torch", root=root)
    assert line["correct"] is True
    assert line["metrics"]["windows_per_call"]["value"] == 64


@pytest.mark.parametrize("cell", ["osm.range", "osm.count"])
def test_pool_is_one_set_for_every_seed(tiny_root, cell):
    """The pool is drawn over the reference rows, whatever the run's seed:
    two seeds get the same calls (and the run's rows differ)."""
    c = harness.load_cell(cell, tiny_root)
    sets = [harness.set_up(c, s, "cpu", "torch") for s in (1, 2)]
    for (ka, La, Ua), (kb, Lb, Ub) in zip(sets[0].pool, sets[1].pool):
        assert ka == kb and np.array_equal(La, Lb) and np.array_equal(Ua, Ub)
    assert not np.array_equal(sets[0].data[:100], sets[1].data[:100])


@pytest.mark.parametrize("shares,n", [({"count": 1.0}, 8),
                                      ({"count": 3, "range": 1}, 8),
                                      ({"a": 0.45, "b": 0.2, "c": 0.35}, 20)])
def test_call_kinds_follow_the_shares_interleaved(shares, n):
    kinds = harness.call_kinds(shares, n)
    total = sum(shares.values())
    assert len(kinds) == n
    for k, v in shares.items():
        assert abs(kinds.count(k) - v / total * n) < 1
    # every kind shows in the first half of the calls
    assert set(kinds[:n // 2 + 1]) == set(shares)


def test_a_mix_of_kinds_needs_only_a_traffic_file(tmp_path):
    """Count and Range in one mix: a new traffic file and a cell entry,
    run on the CPU, each call checked by its kind."""
    from portbench.conftest import make_tiny_root
    root = make_tiny_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    mix = json.loads(
        (root / "portbench/traffic/count.q1024.sel1e-3.json").read_text())
    mix.update(name="mixed.q128", kinds={"count": 0.5, "range": 0.5},
               pool_calls=4, checked_calls=4, traced_calls=4)
    (root / "portbench/traffic/mixed.q128.json").write_text(json.dumps(mix))
    bench["workloads"].append({"name": "osm.mixed", "config": "osm-10m",
                               "traffic": "mixed.q128", "chips": 1,
                               "why": "x"})
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("osm.mixed")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line = harness.run_cell("osm.mixed", 4, 0.2, True, t_process=0.0,
                            device="cpu", engine="torch", root=root)
    assert line["correct"] is True
    assert {"wrong_counts", "wrong_row_sets"} <= set(line["checks"])
    assert line["checks"]["wrong_row_sets"]["value"] == 0
