"""Microseconds in which some device operation ran in the traced window
(the union of the profiler's device events), per window query."""

NAME = "device_busy_us_per_query"
UNIT = "us/query"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "serving path"
MOVES = "qps"


def read(t):
    if not t.busy_ns:
        return None
    return t.busy_ns / 1e3 / t.queries
