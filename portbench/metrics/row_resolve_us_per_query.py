"""Host time of Range's row resolution (`api/engines.py` `run_range`:
each window's row ids resolved against the host copy of the pages): the
program's `serve.resolve_rows` spans, summed over the traced calls, per
window query."""

NAME = "row_resolve_us_per_query"
UNIT = "us/query"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "serving path"
MOVES = "qps"
KINDS = ("range",)


def read(t):
    ns = [s.dur_ns for s in t.spans if s.name == "serve.resolve_rows"]
    if not ns:
        return None
    return sum(ns) / 1e3 / t.queries
