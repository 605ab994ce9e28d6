"""Reading a traced window: the profiler's device events on the host's
`perf_counter_ns` clock, their busy time, the idle gaps between them and
the program's open span at each gap.

The profiler stamps its events in Unix-epoch nanoseconds; the program's
spans (`repro_torch.obs`) and the harness use `perf_counter_ns`.  Each
traced call runs inside a `record_function` range whose perf-counter
start the harness notes, so the offset between the clocks is the median,
over the calls, of the range's profiler start less its perf-counter start
(a few microseconds of error, far below the gaps it names).
"""
from __future__ import annotations

import dataclasses
import statistics

CALL_RANGE = "portbench.call"


@dataclasses.dataclass
class DeviceEvent:
    name: str
    t0_ns: int      # perf_counter_ns clock
    dur_ns: int

    @property
    def t1_ns(self) -> int:
        return self.t0_ns + self.dur_ns


def read_profile(prof, call_starts_ns: list) -> list:
    """The device events of a `torch.profiler.profile` run (kernels,
    copies, fills; not the device copies of `record_function` ranges),
    sorted by start, on the perf-counter clock.
    `call_starts_ns`: the perf-counter start of each `CALL_RANGE`."""
    from torch.autograd import DeviceType
    marks, device = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            if e.name() == CALL_RANGE:
                marks.append(e.start_ns())
        elif e.name() != CALL_RANGE and not e.is_user_annotation():
            # (a range's copy on the device is no device work)
            device.append((e.name(), e.start_ns(), e.duration_ns()))
    marks.sort()
    if len(marks) != len(call_starts_ns):
        raise RuntimeError(f"the profiler recorded {len(marks)} "
                           f"{CALL_RANGE} ranges for "
                           f"{len(call_starts_ns)} calls")
    offset = statistics.median(m - h for m, h in zip(marks, call_starts_ns))
    events = [DeviceEvent(n, int(t - offset), int(d)) for n, t, d in device]
    events.sort(key=lambda e: e.t0_ns)
    return events


def busy_ns(events: list, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) in which at least one event ran."""
    total, end = 0, lo
    for e in events:
        a, b = max(e.t0_ns, end), min(e.t1_ns, hi)
        if b > a:
            total += b - a
        end = max(end, min(e.t1_ns, hi))
    return total


def idle_gaps(events: list, lo: int, hi: int) -> list:
    """(start, end) of each stretch of [lo, hi) in which no event ran."""
    gaps, end = [], lo
    for e in events:
        if e.t0_ns > end and end < hi:
            gaps.append((end, min(e.t0_ns, hi)))
        end = max(end, e.t1_ns)
    if end < hi:
        gaps.append((end, hi))
    return gaps


def innermost_span(spans: list, t_ns: int) -> str:
    """The name of the deepest span open at `t_ns`, or "no span"."""
    best, depth = "no span", -1
    for s in spans:
        if s.t0_ns <= t_ns < s.t0_ns + s.dur_ns and s.depth > depth:
            best, depth = s.name, s.depth
    return best


def breakdown(events: list, spans: list, lo: int, hi: int,
              n: int = 10) -> dict:
    """The device operations that took most time, summed by name, and the
    longest idle gaps, each named by the span open on the host at its
    middle: [[name, seconds], ...], at most `n` of each."""
    by_name = {}
    for e in events:
        if e.t1_ns > lo and e.t0_ns < hi:
            by_name[e.name] = by_name.get(e.name, 0) + e.dur_ns
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(idle_gaps(events, lo, hi), key=lambda g: g[0] - g[1])[:n]
    return {"device_ops": [[k[:120], v / 1e9] for k, v in ops],
            "idle_gaps": [[innermost_span(spans, (a + b) // 2), (b - a) / 1e9]
                          for a, b in gaps]}
