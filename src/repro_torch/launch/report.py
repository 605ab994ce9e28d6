"""Aggregate the dry run's per-cell JSON records into roofline tables, one
per mesh label found in them (``1x1`` while the port's dry run is 1x1).

    PYTHONPATH=src python -m repro_torch.launch.report [--dir results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(dirname: str):
    recs = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def fmt_table(recs, mesh: str):
    rows = []
    head = ("| arch | shape | status | flops/dev | bytes/dev | wire/dev | "
            "compute s | memory s | coll s | dominant | MODEL/HLO | "
            "temp GiB |")
    sep = "|" + "---|" * 12
    rows.append(head)
    rows.append(sep)
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        if r["status"] == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | skipped ({r['reason'][:40]}...) "
                        + "| – " * 9 + "|")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | FAILED "
                        + "| – " * 9 + "|")
            continue
        ro = r["roofline"]
        temp = ro.get("memory_stats", {}).get("temp_size_in_bytes", 0) / 2**30
        rows.append(
            "| {a} | {s} | ok | {f:.2e} | {b:.2e} | {w:.2e} | {c:.4g} | "
            "{m:.4g} | {co:.4g} | **{dom}** | {ur:.2f} | {t:.1f} |".format(
                a=r["arch"], s=r["shape"], f=ro["flops_per_device"],
                b=ro["bytes_per_device"], w=ro["wire_bytes_per_device"],
                c=ro["compute_s"], m=ro["memory_s"], co=ro["collective_s"],
                dom=ro["dominant"], ur=r.get("useful_flops_ratio", 0),
                t=temp))
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    ok = sum(r["status"] == "ok" for r in recs)
    sk = sum(r["status"] == "skipped" for r in recs)
    fail = sum(r["status"] == "failed" for r in recs)
    print(f"records: {len(recs)} ok={ok} skipped={sk} failed={fail}\n")
    for mesh in sorted({r.get("mesh") for r in recs if r.get("mesh")}):
        print(f"### mesh {mesh} (roofline table)\n")
        print(fmt_table(recs, mesh))
        print()


if __name__ == "__main__":
    main()
