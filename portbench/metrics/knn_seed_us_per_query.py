"""Host time of kNN's seed (`api/exec/executor.py` `_exec_knn`: the page
rings around each centre's curve address over the host copy of the
packed arrays, `core/serve.py` `knn_seed_radius`, and each centre's
covering box): the program's `executor.knn_seed` spans, summed over the
traced calls, per centre."""

NAME = "knn_seed_us_per_query"
UNIT = "us/query"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "serving path"
MOVES = "qps"
KINDS = ("knn",)


def read(t):
    ns = [s.dur_ns for s in t.spans if s.name == "executor.knn_seed"]
    if not ns:
        return None
    return sum(ns) / 1e3 / t.queries
