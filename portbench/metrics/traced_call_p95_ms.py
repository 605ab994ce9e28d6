"""The 95th percentile (numpy's linear interpolation) of the traced
calls' wall times, each from `Database.query` to its answer on the host,
under the profiler with the program's spans on."""
import numpy as np

NAME = "traced_call_p95_ms"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "facade and executor"
MOVES = "qps"


def read(t):
    if not t.call_ns:
        return None
    return float(np.percentile(np.asarray(t.call_ns, dtype=np.float64),
                               95)) / 1e6
