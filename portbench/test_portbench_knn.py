"""The kNN cell on the CPU: the plain reference (`ref/knn.py`) against
`Database.query(Knn)` on the `cpu` and `torch` engines, its lossy
control, the kind's settings against the configuration's, a whole tiny
run of `osm.knn` with its controls, and the cell's three readers on a
hand-made trace."""
import dataclasses
import json
import types

import numpy as np
import pytest

from portbench import control, harness
from portbench.conftest import ROOT
from portbench.gen import synth
from portbench.ref.knn import nearest
from portbench.ref.window import WindowReference

KIND = harness.load_kind("knn")
ROWS = 20_000

# two rows whose exact squared distances to (0, 0) differ by one, both
# above 2^53 (float64 rounds them to one value), the farther one first in
# lexicographic order: only the exact pass puts NEAR before FAR
FAR = (2**28 - 1, 2**27 + 1)
NEAR = (2**28, 2**27 - 1)
# twelve offsets at squared distance 25: a tie set that k 10 cuts
TIES = [(5, 0), (-5, 0), (0, 5), (0, -5)] + [
    (a * x, b * y) for x, y in ((3, 4), (4, 3)) for a in (1, -1)
    for b in (1, -1)]


def _scene(name: str):
    """Seeded rows with a forced tie set around an off-row centre (and
    at K 32 the NEAR/FAR pair beside an emptied corner), and centres on
    rows, off rows, at the domain's corners and on the ties."""
    K = synth.default_K(3 if name == "nyc" else 2)
    top = 2**K - 1
    data = synth.make_dataset(name, ROWS, 11).astype(np.int64)
    d = data.shape[1]
    tie_c = np.clip(data[100] + 1000, 1000, top - 1000)
    ties = np.array([tie_c + np.array(o + (0,) * (d - 2)) for o in TIES]
                    + [tie_c + np.eye(d, dtype=np.int64)[-1] * 5])
    extra = [ties]
    data = data[((data - tie_c) ** 2).sum(axis=1) > 50**2]
    if K == 32:
        data = data[~(data < 2**29).all(axis=1)]     # nothing near (0, 0)
        extra.append(np.array([FAR, NEAR]))
    data = np.unique(np.concatenate([data] + extra), axis=0)
    data = data[np.random.default_rng(3).permutation(len(data))]
    corners = np.array([[0] * d, [top] * d, [0] * (d - 1) + [top],
                        [top] + [0] * (d - 1)])
    centres = np.concatenate([data[:6], data[6:10] + 7, tie_c[None],
                              corners]).astype(np.uint64)
    return data.astype(np.uint64), centres, K


@pytest.fixture(scope="module", params=["osm", "nyc"])
def served(request):
    """The scene and a Database fitted on it with its `cpu` and `torch`
    engines."""
    from repro_torch.api import Database, EngineConfig
    data, centres, K = _scene(request.param)
    db = Database.fit(data, None, K=K, learn=False, device="cpu")
    db.engine("torch", EngineConfig(q_chunk=16))
    return data, centres, K, db


@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("engine", ["cpu", "torch"])
def test_reference_equals_the_program(served, engine, k):
    from repro_torch.api import Knn
    data, centres, K, db = served
    res = db.query(Knn(centres, k=k, metric="l2"), engine=engine)
    assert res.engine == engine
    want = nearest(WindowReference(data), centres, k)
    got = KIND.program(res, len(centres))
    assert KIND.wrong(got, want) == 0
    assert all(len(r) == k and len(dd) == k for r, dd in want)
    far = [w[1][-1] for w in want]
    if K == 32:                 # the corners' distances pass 2^53
        assert max(far) > 2.0**53
    # a small block size changes nothing
    assert KIND.wrong(nearest(WindowReference(data), centres, k,
                              block_elems=len(data) * 3), want) == 0


def test_ties_and_exact_distances_above_float64(served):
    data, centres, K, _ = served
    ref = WindowReference(data)
    tie_c = centres[10]
    rows, dists = nearest(ref, tie_c[None], 10)[0]
    assert (dists == 25).all()
    ties = [tuple(r) for r in data.astype(np.int64)
            if ((r - tie_c.astype(np.int64)) ** 2).sum() == 25]
    assert len(ties) > 10
    assert [tuple(r) for r in rows.astype(np.int64)] == sorted(ties)[:10]
    if K == 32:
        rows, dists = nearest(ref, np.zeros((1, 2), np.uint64), 2)[0]
        assert [tuple(r) for r in rows.tolist()] == [NEAR, FAR]
        assert dists[0] == dists[1] == float(NEAR[0]**2 + NEAR[1]**2)


def test_lossy_control_picks_other_rows():
    """Rows a float32 rounding (K 32) cannot tell apart: the control ties
    them and takes the lexicographically first, not the nearest."""
    base = 2**32 - 4096
    data = np.array([[base, base], [base + 1, base], [base + 2, base]],
                    dtype=np.uint64)
    centre = np.array([[base + 2, base]], dtype=np.uint64)
    rows, dists = nearest(WindowReference(data), centre, 1)[0]
    assert rows.tolist() == [[base + 2, base]] and dists.tolist() == [0.0]
    lossy = nearest(WindowReference(data, lossy_K=32), centre, 1)
    assert lossy[0][0].tolist() == [[base, base]]
    assert KIND.wrong(lossy, [(rows, dists)]) == 1


def test_kind_settings_are_the_configuration_s():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}["osm.knn"]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert cfg["knn"] == {"k": KIND.K_NEAREST, "metric": KIND.METRIC}
    mix = harness.load_cell("osm.knn").traffic
    q = KIND.make_query(np.zeros((3, 2), np.uint64),
                        np.full((3, 2), 9, np.uint64))
    assert (q.k, q.metric) == (cfg["knn"]["k"], cfg["knn"]["metric"])
    assert q.centers.tolist() == [[4, 4]] * 3
    assert mix["kinds"] == {"knn": 1.0} and mix["windows_a_call"] == 256


def test_kind_refuses_a_result_without_the_box_fields(monkeypatch):
    """A program whose KnnResult lacks the fields the harness reads fails
    at the first call, before the window."""
    from repro_torch.api import result

    @dataclasses.dataclass
    class Bare:
        neighbors: object
    kind = harness.load_kind("knn")
    monkeypatch.setattr(result, "KnnResult", Bare)
    with pytest.raises(RuntimeError, match="box_rows"):
        kind.make_query(np.zeros((1, 2), np.uint64),
                        np.ones((1, 2), np.uint64))


def test_tiny_run_is_correct_and_its_controls_read_as_designed(tiny_root):
    line = harness.run_cell("osm.knn", 2**31 + 29, 0.2, False,
                            t_process=0.0, device="cpu", engine="torch",
                            root=tiny_root)
    assert line["correct"] is True
    assert set(line["checks"]) == {"wrong_neighbors", "inexact_answers",
                                   "calls_off_engine"}
    path = tiny_root / "portbench" / "configs" / "osm-10m-knn.json"
    cfg = json.loads(path.read_text())
    cfg["engine_config"]["max_cand"] = 1      # first passes overflow here
    path.write_text(json.dumps(cfg))
    r = control.readings("osm.knn", 2**31 + 3, 0.2, device="cpu",
                         engine="torch", root=tiny_root)
    assert r["first_pass_overflowed"] > 0
    assert all(v == 0 for v in r["sound"].values())
    assert r["lossy"]["wrong_neighbors"] > 0
    # the planner forces the CPU net for kNN: without the ladder the net
    # still answers exactly
    assert all(v == 0 for v in r["no_escalation"].values())


@dataclasses.dataclass
class S:
    name: str
    t0_ns: int
    dur_ns: int
    depth: int


def _traced(spans=(), made=()):
    return harness.Traced(card="NVIDIA H100 80GB HBM3", calls=2, queries=4,
                          window_ns=20_000, lo_ns=0, hi_ns=20_000, events=[],
                          busy_ns=0, spans=list(spans),
                          calls_made=list(made), call_ns=[9000, 9000],
                          mbrs=None, sizes=None)


@pytest.mark.parametrize("name,span", [
    ("knn_seed_us_per_query", "executor.knn_seed"),
    ("knn_refine_us_per_query", "executor.knn_refine")])
def test_stage_readers_sum_their_spans_per_centre(name, span):
    read = harness.load_metric(name).read
    spans = [S("executor.execute", 0, 9000, 1), S(span, 100, 3000, 2),
             S(span, 10_100, 5000, 2), S("executor.knn_other", 0, 50, 2)]
    assert read(_traced(spans)) == pytest.approx(8000 / 1e3 / 4)
    assert read(_traced(spans[:1])) is None


def test_box_rows_reader_divides_by_the_neighbours_returned():
    read = harness.load_metric("knn_box_rows_per_neighbor").read

    def res(box_rows, n):
        return types.SimpleNamespace(box_rows=np.array(box_rows),
                                     neighbors=np.zeros((n, 2)))
    made = [("knn", None, None, res([12, 20], 20)),
            ("knn", None, None, res([30, 10], 20))]
    assert read(_traced(made=made)) == pytest.approx(72 / 40)
    # a count call is not read; a program without box_rows reads nothing
    count = types.SimpleNamespace(counts=np.zeros(2))
    assert read(_traced(made=made + [("count", None, None, count)])) == \
        pytest.approx(72 / 40)
    parent = types.SimpleNamespace(neighbors=np.zeros((20, 2)))
    assert read(_traced(made=[("knn", None, None, parent)])) is None
    assert read(_traced()) is None
