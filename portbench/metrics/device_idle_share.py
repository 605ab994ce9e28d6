"""Share of the traced window in which no device operation ran:
1 - busy / window, the window from the first traced call's start to the
last one's end on the host's clock."""

NAME = "device_idle_share"
UNIT = "ratio"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "qps"


def read(t):
    if not t.busy_ns or not t.window_ns:
        return None
    return 1.0 - t.busy_ns / t.window_ns
