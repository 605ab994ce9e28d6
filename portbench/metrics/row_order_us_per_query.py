"""Host time of Range's row order (`api/exec/executor.py`: each window's
rows sorted lexicographically, then concatenated): the program's
`executor.order_rows` spans, summed over the traced calls, per window
query."""

NAME = "row_order_us_per_query"
UNIT = "us/query"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "facade and executor"
MOVES = "qps"
KINDS = ("range",)


def read(t):
    ns = [s.dur_ns for s in t.spans if s.name == "executor.order_rows"]
    if not ns:
        return None
    return sum(ns) / 1e3 / t.queries
