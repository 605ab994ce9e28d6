"""Re-run the analysis over a dry run's saved op logs (<dir>/ops/*.ops.json.gz)
and any saved HLO (<dir>/hlo/*.hlo.gz), and patch the per-cell JSON records
with the current ceilings and MODEL_FLOPS — no step is run again.

    PYTHONPATH=src python -m repro_torch.launch.reanalyze --dir results/dryrun_torch
"""
from __future__ import annotations

import argparse
import glob
import gzip
import json
import os

from ..configs.base import SHAPES
from ..configs.registry import ARCHS, get_arch
from ..dist import roofline as rl
from ..dist.hlo_analysis import analyze_hlo_text, analyze_op_log


def _costs(dirname: str):
    """(record base name, cost dict) for every saved op log and HLO."""
    for path in sorted(glob.glob(os.path.join(dirname, "ops",
                                              "*.ops.json.gz"))):
        with gzip.open(path, "rt") as f:
            rows = json.load(f)["ops"]
        yield os.path.basename(path)[:-len(".ops.json.gz")], \
            analyze_op_log(rows)
    for path in sorted(glob.glob(os.path.join(dirname, "hlo",
                                              "*.hlo.gz"))):
        with gzip.open(path, "rt") as f:
            text = f.read()
        yield os.path.basename(path)[:-len(".hlo.gz")], \
            analyze_hlo_text(text)


def reanalyze(dirname: str):
    for base, la in _costs(dirname):
        jf = os.path.join(dirname, base + ".json")
        if not os.path.exists(jf):
            continue
        with open(jf) as f:
            rec = json.load(f)
        flops = float(la["flops"])
        nbytes = float(la["bytes"])
        wire = float(la["wire_bytes"])
        terms = {"compute": flops / rl.PEAK_FLOPS,
                 "memory": nbytes / rl.HBM_BW,
                 "collective": wire / rl.LINK_BW}
        ro = rec.get("roofline", {})
        ro.update(flops_per_device=flops, bytes_per_device=nbytes,
                  wire_bytes_per_device=wire,
                  compute_s=terms["compute"], memory_s=terms["memory"],
                  collective_s=terms["collective"],
                  dominant=max(terms, key=terms.get),
                  collectives=la["collectives"])
        ro.setdefault("memory_stats", {})["bytes_unfused_upper_bound"] = \
            float(la["bytes_unfused"])
        rec["roofline"] = ro
        if rec.get("arch") in ARCHS and rec.get("shape") in SHAPES:
            cfg = get_arch(rec["arch"])
            chips = rec.get("chips", 1)
            mf = rl.model_flops(cfg, SHAPES[rec["shape"]])
            rec["model_flops_total"] = mf
            rec["model_flops_per_chip"] = mf / chips
            rec["useful_flops_ratio"] = (mf / chips) / max(flops, 1.0)
        with open(jf, "w") as f:
            json.dump(rec, f, indent=1)
        print("reanalyzed", base)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    reanalyze(args.dir)


if __name__ == "__main__":
    main()
