"""Count's filter kernel against its roofline: the least time of the
traced calls' filter work (`roofline.filter_bytes`, counted from the
windows and the page boxes, at the card's HBM peak) over the profiler's
time of the kernels named in KERNEL, in percent.  Only the traced calls
of the kinds in KINDS count."""

import re

from portbench import roofline

NAME = "window_filter_roofline"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "window kernels"
MOVES = "qps"
KINDS = ("count",)
# the ring kernel's count instantiation, window_ring_kernel<D, 0>
KERNEL = re.compile(r"window_ring_kernel<-?\d+, ?0>")


def read(t):
    peak = roofline.hbm_bytes_per_s(t.card)
    ns = sum(e.dur_ns for e in t.events
             if t.lo_ns <= e.t0_ns < t.hi_ns and KERNEL.search(e.name))
    calls = [(Ls, Us) for k, Ls, Us, _ in t.calls_made if k in KINDS]
    if peak is None or not ns or not calls:
        return None
    nbytes = sum(roofline.filter_bytes(t.mbrs, t.sizes, Ls, Us)
                 for Ls, Us in calls)
    return 100.0 * nbytes / peak / (ns / 1e9)
