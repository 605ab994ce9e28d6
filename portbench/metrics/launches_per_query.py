"""Device operations (kernels, copies, fills) the profiler recorded in
the traced window, per window query."""

NAME = "launches_per_query"
UNIT = "launches/query"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "serving path"
MOVES = "qps"


def read(t):
    n = sum(1 for e in t.events if t.lo_ns <= e.t0_ns < t.hi_ns)
    if not n:
        return None
    return n / t.queries
