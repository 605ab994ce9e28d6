"""Host time of kNN's refine (`api/exec/executor.py` `_exec_knn`: each
centre's box rows ranked by exact integer distance, `core/query.py`
`knn_select`, then the result's concatenation): the program's
`executor.knn_refine` spans, summed over the traced calls, per centre."""

NAME = "knn_refine_us_per_query"
UNIT = "us/query"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "facade and executor"
MOVES = "qps"
KINDS = ("knn",)


def read(t):
    ns = [s.dur_ns for s in t.spans if s.name == "executor.knn_refine"]
    if not ns:
        return None
    return sum(ns) / 1e3 / t.queries
