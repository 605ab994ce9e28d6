"""Host time blocked on the device (`executor.device_wait`: the fence
around each query fn's outputs, on only while spans are), summed over the
traced calls, per window query."""

NAME = "device_wait_us_per_query"
UNIT = "us/query"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "serving path"
MOVES = "qps"


def read(t):
    ns = [s.dur_ns for s in t.spans if s.name == "executor.device_wait"]
    if not ns:
        return None
    return sum(ns) / 1e3 / t.queries
