"""Readings that set the limits of `correct`, at a cell's own size.

    python3 portbench/control.py --workload osm.count --seeds 11,12,13 \
        --seconds 3

For each seed, one process builds the cell as `run.py` does, runs a
short timed window, and holds the sampled calls' answers against the
plain reference three ways:

  sound          the program as the configuration states it;
  lossy          the control: the reference put in the program's place,
                 with every coordinate and bound rounded to the float type
                 below the configuration's K-bit integers (`ref/window.py`);
  no_escalation  the program's own path that drops the exactness net:
                 the same calls again with `escalate` and `cpu_fallback`
                 off.

One JSON line a seed.  The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(name: str, seed: int, seconds: float, *, device="cuda",
             engine: str = None, root: Path = ROOT) -> dict:
    """The sound, lossy and no-escalation checks of one seed."""
    from repro_torch.api import EngineConfig

    from portbench import harness
    cell = harness.load_cell(name, root)
    engine = engine or cell.config["engine"]
    su = harness.set_up(cell, seed, device, engine)
    db, data, pool = su.db, su.data, su.pool
    del su
    keep = harness.Reservoir(int(cell.traffic["checked_calls"]), seed + 3)
    lat, done, failed, elapsed = harness.timed_window(
        cell, db, pool, seconds, keep, seed + 4)
    kept = keep.items
    db.engine(engine, EngineConfig(**cell.config["engine_config"],
                                   escalate=False, cpu_fallback=False))
    bare = [(b, db.query(harness.query(cell, pool[b]))) for b, _ in kept]
    first_pass = sum(int(r.overflowed.astype(bool).sum()) for _, r in bare)
    del db
    harness.free_device(device)
    out = {"workload": name, "seed": seed, "calls": len(lat),
           "failed": failed, "checked_calls": len(kept),
           "first_pass_overflowed": first_pass}
    for label, answers, lossy in (("sound", kept, False),
                                  ("lossy", kept, True),
                                  ("no_escalation", bare, False)):
        checks, checked = harness.check_answers(cell, data, pool, answers,
                                                engine, device, lossy=lossy)
        out[label] = {k: v["value"] for k, v in checks.items()}
        out["checked_windows"] = checked
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        r = readings(args.workload, int(s), args.seconds)
        r["process_s"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
