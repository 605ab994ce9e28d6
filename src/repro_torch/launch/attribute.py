"""Attribute roofline terms to ops (hillclimb profiling tool).

    PYTHONPATH=src python -m repro_torch.launch.attribute \\
        --ops results/dryrun_torch/ops/<cell>.ops.json.gz \\
        [--kind traffic|flops|wire] [--top 15]
    PYTHONPATH=src python -m repro_torch.launch.attribute \\
        --hlo <cell>.hlo.gz [--kind traffic|flops|wire] [--top 15]

``--ops`` ranks the rows of a port step's op log (`launch.dryrun`); each
row is one (op, input shapes, source line) with its count, so a row's
source line stands where the reference prints the HLO ``op_name``.
``--hlo`` ranks the ops of HLO text as the reference's tool does, on the
port's analyzer (trip counts from ``known_trip_count`` too), and prints
each op's ``op_name`` metadata.
"""
from __future__ import annotations

import argparse
import gzip
import json
import re

from ..dist.hlo_analysis import (HloAnalyzer, _CALL_ATTR_RE, _COLLECTIVES,
                                 _FUSED_ANCHORS, _NO_TRAFFIC, _shape_bytes)

_UNITS = {"traffic": (1e9, "GB"), "wire": (1e9, "GB"),
          "flops": (1e12, "TFLOP")}


def attribute(text: str, kind: str = "traffic", top: int = 15):
    an = HloAnalyzer(text)
    # re-read raw lines to recover metadata op_name
    comps_raw = {}
    cur = None
    for line in text.splitlines():
        if cur is None:
            m = re.match(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(.*\{\s*$", line)
            if m:
                cur = m.group(2)
                comps_raw[cur] = []
            continue
        if line.startswith("}"):
            cur = None
            continue
        comps_raw[cur].append(line)

    meta_of = {}
    for cname, lines in comps_raw.items():
        for line in lines:
            mm = re.match(r"^\s+(?:ROOT\s+)?%?([\w.\-]+)\s*=", line)
            if mm:
                md = re.search(r'op_name="([^"]*)"', line)
                meta_of[mm.group(1)] = md.group(1) if md else "?"

    rows = []

    def walk(comp, mult):
        for op in an.comps.get(comp, []):
            oc = op.opcode
            if oc == "while":
                cm = re.search(r"condition=%?([\w.\-]+)", op.rest)
                bm = re.search(r"body=%?([\w.\-]+)", op.rest)
                trip = an._trip_count(cm.group(1), op) if cm else 1
                walk(bm.group(1), mult * trip)
                continue
            if oc == "call":
                m = _CALL_ATTR_RE.search(op.rest)
                if m:
                    walk(m.group(1), mult)
                continue
            if oc in _NO_TRAFFIC:
                continue
            if kind == "wire":
                base = oc[:-6] if oc.endswith("-start") else oc
                if base not in _COLLECTIVES:
                    continue
                nbytes = max(an._operand_bytes(op), _shape_bytes(op.shape))
                g = an._group_size(op)
                w = 2 * nbytes * (g - 1) / g if base == "all-reduce" else (
                    nbytes if base == "collective-permute"
                    else nbytes * (g - 1) / g)
                rows.append((w * mult, base, op.shape[:48],
                             meta_of.get(op.name, "?")[:100]))
            elif kind == "flops":
                if oc == "dot":
                    f = an._dot_flops(op)
                elif oc == "convolution":
                    f = an._conv_flops(op)
                elif oc == "fusion":
                    m = _CALL_ATTR_RE.search(op.rest)
                    f = an._comp_cost(m.group(1))[0] if m else 0.0
                else:
                    continue
                if f:
                    rows.append((f * mult, oc, op.shape[:48],
                                 meta_of.get(op.name, "?")[:100]))
            else:
                if not (oc in _FUSED_ANCHORS or oc in _COLLECTIVES
                        or oc.endswith("-start")):
                    continue
                rows.append((an._op_traffic(op) * mult, oc, op.shape[:48],
                             meta_of.get(op.name, "?")[:100]))

    walk(an.entry, 1.0)
    return _print(rows, kind, top)


def attribute_ops(rows: list, kind: str = "traffic", top: int = 15):
    """Rank an op log's rows (`StepCounter.op_log`) by their bytes, flops
    or wire bytes; each printed row carries its count and source line."""
    field = {"traffic": "bytes", "flops": "flops", "wire": "wire"}[kind]
    ranked = [(r[field], f"{r['op']} x{r['count']}",
               str([tuple(s) for s in r["shapes"]])[:48], r["source"])
              for r in rows if r[field]]
    return _print(ranked, kind, top)


def _print(rows, kind: str, top: int):
    rows.sort(key=lambda r: r[0], reverse=True)
    scale, unit = _UNITS[kind]
    total = sum(r[0] for r in rows)
    print(f"total {kind}: {total / scale:.2f} {unit}")
    for v, oc, shape, where in rows[:top]:
        print(f"{v / scale:9.2f} {unit:5s} {oc:34s} {shape:50s} {where}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--hlo", help="gzipped HLO text")
    src.add_argument("--ops", help="gzipped op log of launch.dryrun")
    ap.add_argument("--kind", default="traffic",
                    choices=["traffic", "flops", "wire"])
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    if args.hlo:
        with gzip.open(args.hlo, "rt") as f:
            return attribute(f.read(), args.kind, args.top)
    with gzip.open(args.ops, "rt") as f:
        return attribute_ops(json.load(f)["ops"], args.kind, args.top)


if __name__ == "__main__":
    main()
