"""Range's match kernels against their roofline: the least time of the
traced calls' match work (`roofline.match_bytes`, counted from the
windows, the page boxes and the rows the call returned, at the card's HBM
peak) over the profiler's time of the kernels named in KERNEL, in
percent.  Only the traced calls of the kinds in KINDS count."""

import re

from portbench import roofline

NAME = "window_match_roofline"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "window kernels"
MOVES = "qps"
KINDS = ("range",)
# the ring kernel's hit-word instantiation, window_ring_kernel<D, 1>, and
# the id pass
KERNEL = re.compile(r"window_ring_kernel<-?\d+, ?1>|window_match_ids_kernel")


def read(t):
    peak = roofline.hbm_bytes_per_s(t.card)
    ns = sum(e.dur_ns for e in t.events
             if t.lo_ns <= e.t0_ns < t.hi_ns and KERNEL.search(e.name))
    calls = [(Ls, Us, r) for k, Ls, Us, r in t.calls_made if k in KINDS]
    if peak is None or not ns or not calls:
        return None
    nbytes = sum(roofline.match_bytes(t.mbrs, t.sizes, Ls, Us,
                                      int(r.offsets[-1]))
                 for Ls, Us, r in calls)
    return 100.0 * nbytes / peak / (ns / 1e9)
