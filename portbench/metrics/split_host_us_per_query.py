"""Host time of the split and z-ranges (`core/serve.py` `_chunks`: the
recursive split and the z-range encode, once a device call): the
program's `serve.split` spans, summed over the traced calls, per window
query."""

NAME = "split_host_us_per_query"
UNIT = "us/query"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "serving path"
MOVES = "qps"


def read(t):
    ns = [s.dur_ns for s in t.spans if s.name == "serve.split"]
    if not ns:
        return None
    return sum(ns) / 1e3 / t.queries
