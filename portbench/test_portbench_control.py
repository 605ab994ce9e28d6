"""The controls at a size a test run holds: the lossy reference in the
program's place and the program without its exactness net both come out
wrong, where the sound run of the same calls is right."""
import json

import pytest

from portbench import control


@pytest.mark.parametrize("cell,config", [("nyc.count", "nyc-10m"),
                                         ("nyc.range", "nyc-10m")])
def test_controls_fail_where_the_sound_run_passes(tiny_root, cell, config):
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    if cell not in {w["name"] for w in bench["workloads"]}:
        # the Range mix on nyc's configuration: bfloat16 (K 21) is the
        # control that fails at a test's size
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": "range.q256.sel1e-5",
                                   "chips": 1, "why": "x"})
        (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    path = tiny_root / "portbench" / "configs" / f"{config}.json"
    cfg = json.loads(path.read_text())
    cfg["engine_config"]["max_cand"] = 2      # first passes overflow here
    path.write_text(json.dumps(cfg))
    r = control.readings(cell, 2**31 + 3, 0.2, device="cpu", engine="torch",
                         root=tiny_root)
    wrong = "wrong_counts" if cell.endswith("count") else "wrong_row_sets"
    assert r["first_pass_overflowed"] > 0
    assert all(v == 0 for v in r["sound"].values())
    assert r["lossy"][wrong] > 0
    assert r["no_escalation"][wrong] > 0
    assert r["no_escalation"]["inexact_answers"] > 0
