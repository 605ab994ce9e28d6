"""One run of one cell: set-up, a closed loop of one caller through
`Database.query`, the check against the plain reference, and the result
line.

Everything that belongs to one configuration, traffic mix, query kind or
per-layer metric is a file of its own, found by the name `BENCHMARK.json`
or the mix gives:

  configs/<config>.json   the deployment: generator, rows, layout seed,
                          K, curve family, SMBO budget, engine and
                          EngineConfig
  traffic/<traffic>.json  the mix: query kinds and their shares of the
                          calls, windows a call, calls in the pool,
                          selectivity, skew share, probes
  kinds/<kind>.py         a query kind: the program's query object, its
                          answers and the reference's, and how they are
                          compared
  metrics/<metric>.py     a per-layer metric's reader (`read(traced)`)

A run (`run_cell`):

 1. `set_up`: draws the deployment's reference rows (its layout seed) on
    the device, and the run's rows from the seed on their grid; draws the
    mix's pool of calls once, over the reference rows; learns the
    deployment's curve on a sample of the reference rows (the
    configuration's SMBO seed), fits the `Database` on the run's rows with
    it and attaches the configuration's engine; warms every call of the
    pool once;
 2. trace 0: calls `Database.query` back to back for `seconds`, each call
    ending with its answer on the host, the pool's calls in a seeded
    order; trace 1: a bounded number of calls under the profiler with the
    program's spans on;
 3. reads the peak memory, checks that no JAX module was loaded, frees
    the program's state and holds a seeded sample of the calls' answers
    against the reference (`ref/window.py`, by each call's kind).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent                  # the checkout: BENCHMARK.json, src/
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CONTRACT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


class CellError(Exception):
    """The run cannot give a result (no card, a missing file, JAX loaded)."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    kinds: dict            # kind name -> its module (kinds/<kind>.py)
    end_to_end: list       # BENCHMARK.json entries this cell reports
    per_layer: list


def _json(path: Path) -> dict:
    if not path.is_file():
        raise CellError(f"missing file {path}")
    return json.loads(path.read_text())


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its configuration
    and traffic files and the metrics it reports."""
    bench = _json(Path(root) / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json; have "
                        f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(Path(root) / conf["file"])
    traffic = _json(Path(root) / BENCH_DIR.name / "traffic"
                    / f"{w['traffic']}.json")

    def mine(m):
        return name in m.get("workloads", [name])

    kinds = {k: load_kind(k, root) for k in traffic["kinds"]}
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, kinds=kinds,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def _module(folder: str, name: str, root: Path):
    path = Path(root) / BENCH_DIR.name / folder / f"{name}.py"
    if not path.is_file():
        raise CellError(f"missing file {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str, root: Path = ROOT):
    """The reader module of per-layer metric `name`."""
    return _module("metrics", name, root)


def load_kind(name: str, root: Path = ROOT):
    """The module of query kind `name`."""
    return _module("kinds", name, root)


def forbidden_modules(names=None) -> list:
    """Top-level names among `names` (default: the loaded modules) that
    are JAX's or the JAX package's (compared whole: `repro_torch` is not
    `repro`)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def p95(values) -> float:
    """The 95th percentile (numpy's linear interpolation)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


class Reservoir:
    """A seeded uniform sample of `size` items from a stream of unknown
    length (Algorithm R)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng(seed)
        self.items = []
        self.seen = 0

    def offer(self, item) -> None:
        if self.seen < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1


# ---------------------------------------------------------------------------
# set-up
# ---------------------------------------------------------------------------


# every mix's pool of calls is drawn from this seed over the deployment's
# reference rows: one set of calls, whatever the run's seed
WINDOWS_SEED = 5


def _windows(data, n: int, seed: int, traffic: dict, K: int, device):
    """`n` windows of the mix over `data`, scaled to its selectivity."""
    from .gen.workload import make_workload, scale_to_selectivity
    Ls, Us = make_workload(data, n, seed, width_scale=traffic["width_scale"],
                           skew_frac=traffic["skew_frac"], K=K)
    return scale_to_selectivity(data, Ls, Us, traffic["selectivity"], K=K,
                                probes=min(n, traffic["probes"]),
                                device=device)


def deployment(cell: Cell, device):
    """The configuration's rows (`gen.synth.Deployment`): its reference
    rows on the device, drawn from its layout seed, and its grid."""
    from .gen.synth import Deployment
    c = cell.config
    dep = Deployment(c["generator"], int(c["rows"]),
                     int(c.get("layout_seed", 0)), device)
    if (dep.rows.shape[1], dep.K) != (int(c["d"]), int(c["K"])):
        raise CellError(f"config {c['name']}: d {c['d']} K {c['K']} do not "
                        f"match the generator's rows {tuple(dep.rows.shape)}")
    return dep


def call_kinds(shares: dict, n: int) -> list:
    """The kind of each of `n` calls: each kind's share of them (rounded,
    the remainder to the largest shares), interleaved so that any run of
    calls holds the kinds in about their shares."""
    names = list(shares)
    total = float(sum(shares.values()))
    want = {k: shares[k] / total * n for k in names}
    counts = {k: int(want[k]) for k in names}
    for k in sorted(names, key=lambda k: counts[k] - want[k])[
            :n - sum(counts.values())]:
        counts[k] += 1
    slots = sorted(((j + 0.5) / counts[k], i, k)
                   for i, k in enumerate(names) for j in range(counts[k]))
    return [k for _, _, k in slots]


def make_pool(cell: Cell, ref) -> list:
    """The mix's calls, [(kind, Ls, Us), ...]: `pool_calls` calls of
    `windows_a_call` windows drawn once from WINDOWS_SEED over the
    reference rows `ref`, each call of one kind."""
    t = cell.traffic
    q, n = int(t["windows_a_call"]), int(t["pool_calls"])
    Ls, Us = _windows(ref, q * n, WINDOWS_SEED, t, int(cell.config["K"]),
                      ref.device)
    return [(k, Ls[i * q:(i + 1) * q], Us[i * q:(i + 1) * q])
            for i, k in enumerate(call_kinds(t["kinds"], n))]


def fit(cell: Cell, data, ref, device, engine: str = None):
    """The deployment's curve, learned by `Database.fit` (SMBO with the
    configuration's family and budget) on `smbo.sample` rows of the
    reference rows `ref`, then `Database.fit` on the run's rows with that
    curve pinned, and the configuration's engine attached.

    The training windows are the cell's mix over the reference sample:
    the curve is a setting of the deployment, the same in every run.
    Learned from each run's own rows, it came out one of several curves
    whose work differed twofold."""
    import torch

    from repro_torch.api import Database, EngineConfig
    c, s = cell.config, cell.config["smbo"]
    K, fit_seed = int(c["K"]), int(s["seed"])
    pick = np.random.default_rng(fit_seed).choice(
        len(ref), int(s["sample"]), replace=False)
    sample = ref[torch.from_numpy(np.sort(pick)).to(ref.device)]
    sample = sample.cpu().numpy().astype(np.uint64)
    train = _windows(sample, int(s["train_windows"]), fit_seed + 1,
                     cell.traffic, K, device)
    learned = Database.fit(sample, train, K=K, curve=c["curve"],
                           sample=int(s["sample"]), pool=s.get("pool"),
                           iters=s.get("iters"), smbo=s.get("extra"),
                           seed=fit_seed, device=device)
    db = Database.fit(data, train, K=K, curve=learned.curve, device=device)
    db.engine(engine or c["engine"], EngineConfig(**c["engine_config"]))
    return db


def query(cell: Cell, call):
    """The program's query object of one pool call (kind, Ls, Us)."""
    kind, Ls, Us = call
    return cell.kinds[kind].make_query(Ls, Us)


def warm(cell: Cell, db, pool) -> None:
    """Every call of the pool once, so that every (query fn, shape) the
    window launches has launched.  (Stopping at the first pass of 16
    calls that launched no new shape left up to 4 new shapes to every
    window.)"""
    for call in pool:
        db.query(query(cell, call))


@dataclasses.dataclass
class SetUp:
    db: object
    data: np.ndarray       # the run's rows
    pool: list             # [(kind, Ls, Us), ...]
    stages: list           # (stage, perf_counter at its end)


def set_up(cell: Cell, seed: int, device, engine: str = None,
           t_process: float = None) -> SetUp:
    """Rows, pool, fit and warm-up of one run (module docstring, step 1)."""
    stages = [("start", time.perf_counter() if t_process is None
               else t_process), ("import", time.perf_counter())]
    dep = deployment(cell, device)
    data = dep.rows_of(seed)
    pool = make_pool(cell, dep.rows)
    stages.append(("inputs", time.perf_counter()))
    db = fit(cell, data, dep.rows, device, engine)
    del dep
    stages.append(("fit", time.perf_counter()))
    warm(cell, db, pool)
    stages.append(("warm", time.perf_counter()))
    return SetUp(db=db, data=data, pool=pool, stages=stages)


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------


def call_order(n_pool: int, seed: int):
    """The pool's calls, each cycle in a new seeded order."""
    rng = np.random.default_rng(seed)
    while True:
        yield from rng.permutation(n_pool).tolist()


def timed_window(cell: Cell, db, pool, seconds: float, keep: Reservoir,
                 order_seed: int):
    """Calls back to back until `seconds` have passed; each call's wall
    time and a reservoir of (pool index, result).  Returns (latencies,
    completed windows, failed windows, elapsed s)."""
    order = call_order(len(pool), order_seed)
    lat, done, failed = [], 0, 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    t1 = t_start
    while t1 < deadline:
        b = next(order)
        t0 = time.perf_counter()
        try:
            res = db.query(query(cell, pool[b]))
        except Exception:         # a failing call is counted and shown
            traceback.print_exc(file=sys.stderr)
            res = None
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        if res is None:
            failed += len(pool[b][1])
        else:
            done += len(pool[b][1])
            keep.offer((b, res))
    return lat, done, failed, t1 - t_start


@dataclasses.dataclass
class Traced:
    """What the per-layer readers read from a `--trace 1` window."""
    card: str
    calls: int
    queries: int
    window_ns: int
    lo_ns: int
    hi_ns: int
    events: list            # trace.DeviceEvent on the perf-counter clock
    busy_ns: int
    spans: list             # repro_torch.obs Span records in the window
    calls_made: list        # (kind, Ls, Us, result) a traced call
    call_ns: list           # each traced call's wall time
    mbrs: object            # (P, d, 2) int64 page boxes on the device
    sizes: object           # (P,) int64 page rows on the device


def traced_window(cell: Cell, db, pool, n_calls: int, keep: Reservoir,
                  order_seed: int, card: str, device) -> Traced:
    """`n_calls` calls of the pool under the profiler, the program's spans
    on (its device calls fenced)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import obs

    from . import trace
    order = call_order(len(pool), order_seed)
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    starts, ends, made = [], [], []
    obs.reset()
    obs.enable()
    try:
        with profile(activities=acts) as prof:
            for _ in range(n_calls):
                b = next(order)
                h0 = time.perf_counter_ns()
                with record_function(trace.CALL_RANGE):
                    res = db.query(query(cell, pool[b]))
                starts.append(h0)
                ends.append(time.perf_counter_ns())
                made.append((*pool[b], res))
                keep.offer((b, res))
        spans = obs.tracer.snapshot()
    finally:
        obs.disable()
        obs.reset()
    lo, hi = starts[0], ends[-1]
    events = trace.read_profile(prof, starts)
    idx = db.index
    mbrs = torch.from_numpy(idx.mbrs.astype(np.int64)).to(device)
    sizes = torch.from_numpy(np.diff(idx.starts).astype(np.int64)).to(device)
    return Traced(card=card, calls=n_calls,
                  queries=sum(len(c[1]) for c in made), window_ns=hi - lo,
                  lo_ns=lo, hi_ns=hi, events=events,
                  busy_ns=trace.busy_ns(events, lo, hi),
                  spans=[s for s in spans if s.t0_ns < hi and
                         s.t0_ns + s.dur_ns > lo],
                  calls_made=made,
                  call_ns=[e - s for s, e in zip(starts, ends)],
                  mbrs=mbrs, sizes=sizes)


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------


def check_answers(cell: Cell, data, pool, kept: list, engine: str,
                  device, lossy: bool = False) -> tuple:
    """The sampled calls' answers held against the plain reference, each
    by its kind's module (or, `lossy`, the reference put in their place:
    the control).  Returns ({name: {"value", "limit"}}, windows checked)."""
    from .ref.window import WindowReference
    ref = WindowReference(data, device=device)
    ctl = WindowReference(data, device=device,
                          lossy_K=int(cell.config["K"])) if lossy else None
    wrong = {m.CHECK: 0 for m in cell.kinds.values()}
    off_engine, inexact, checked = 0, 0, 0
    for b, res in kept:
        kind, Ls, Us = pool[b]
        m = cell.kinds[kind]
        checked += len(Ls)
        off_engine += res.engine != engine
        inexact += int(np.count_nonzero(res.residual_overflow))
        got = m.reference(ctl, Ls, Us) if ctl else m.program(res, len(Ls))
        wrong[m.CHECK] += m.wrong(got, m.reference(ref, Ls, Us))
    checks = {k: {"value": v, "limit": 0} for k, v in wrong.items()}
    checks.update(inexact_answers={"value": inexact, "limit": 0},
                  calls_off_engine={"value": off_engine, "limit": 0})
    return checks, checked


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------


def device_info(device) -> dict:
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    dev))}
    return {"platform": dev.type, "kind": dev.type, "count": 1,
            "memory_peak_bytes": 0}


def free_device(device) -> None:
    """Free what was dropped: set-up's frozen objects included (the
    Database's cycles hold its device arrays)."""
    import torch
    gc.unfreeze()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_cell(name: str, seed: int, seconds: float, trace_on: bool, *,
             t_process: float, device="cuda", engine: str = None,
             root: Path = ROOT, log=sys.stderr) -> dict:
    """One run; returns the result line's object.  `device` and `engine`
    other than the card's are for the CPU tests of the harness."""
    cell = load_cell(name, root)
    engine = engine or cell.config["engine"]
    t = cell.traffic
    su = set_up(cell, seed, device, engine, t_process)
    db, data, pool, stages = su.db, su.data, su.pool, su.stages
    del su
    gc.collect()
    gc.freeze()          # set-up's objects out of the collector's way
    print("set-up: " + ", ".join(
        f"{a} {t1 - t0:.3f} s" for (_, t0), (a, t1) in zip(stages,
                                                          stages[1:]))
        + f"; {len(data)} rows, {db.num_pages} pages, {len(pool)} "
        f"warm-up calls", file=log, flush=True)
    compiles = db.executor.cache.compiles
    keep = Reservoir(int(t["checked_calls"]), seed + 3)
    card = device_info(device)["kind"]
    metrics = {}
    if trace_on:
        traced = traced_window(cell, db, pool, int(t["traced_calls"]),
                               keep, seed + 4, card, device)
        attempted, failed = traced.queries, 0
    else:
        setup_s = time.perf_counter() - t_process
        lat, done, failed, elapsed = timed_window(cell, db, pool, seconds,
                                                  keep, seed + 4)
        attempted = done + failed
        metrics = {"qps": done / elapsed, "call_p95_ms": p95(lat) * 1e3,
                   "setup_s": setup_s}
        print(f"window: {len(lat)} calls, {attempted} windows, "
              f"{elapsed:.3f} s, median call {np.median(lat) * 1e3:.3f} ms",
              file=log, flush=True)
    print(f"new query fn shapes inside the window: "
          f"{db.executor.cache.compiles - compiles}", file=log, flush=True)
    bad = forbidden_modules()
    if bad:
        raise CellError(f"modules of JAX or the JAX package were loaded: "
                        f"{bad}")
    dev_info = device_info(device)
    out = {}
    if trace_on:
        from . import trace as trace_mod
        for m in cell.per_layer:
            v = load_metric(m["name"], root).read(traced)
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info["busy_s"] = traced.busy_ns / 1e9
        dev_info["window_s"] = traced.window_ns / 1e9
        bd = trace_mod.breakdown(traced.events, traced.spans, traced.lo_ns,
                                 traced.hi_ns)
        del traced
    else:
        out = {m["name"]: {"value": metrics[m["name"]], "unit": m["unit"]}
               for m in cell.end_to_end}
    kept = keep.items
    del db, keep
    free_device(device)
    t0 = time.perf_counter()
    checks, checked = check_answers(cell, data, pool, kept, engine, device)
    print(f"check: {len(kept)} calls, {checked} windows against the "
          f"reference in {time.perf_counter() - t0:.3f} s", file=log)
    for k, v in checks.items():
        print(f"{k} {v['value']} limit {v['limit']}", file=log)
    log.flush()
    line = {"correct": failed == 0 and all(
                v["value"] <= v["limit"] for v in checks.values()),
            "attempted": attempted, "failed": failed, "metrics": out,
            "device": dev_info}
    if trace_on:
        line["breakdown"] = bd
    line["checks"] = checks
    return line
