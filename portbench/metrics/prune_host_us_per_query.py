"""Host time of the prune (`core/serve.py`: the z-range and box tests, the
containment shortcut and the top-C compaction, once a chunk): the
program's `serve.prune` spans, summed over the traced calls, per window
query.  The host enqueues these torch ops; the device runs behind it."""

NAME = "prune_host_us_per_query"
UNIT = "us/query"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "serving path"
MOVES = "qps"


def read(t):
    ns = [s.dur_ns for s in t.spans if s.name == "serve.prune"]
    if not ns:
        return None
    return sum(ns) / 1e3 / t.queries
