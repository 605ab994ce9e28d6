"""The metric arithmetic on hand-checked cases: p95 over all calls, busy
time and idle gaps from device events, the gaps' spans, the roofline
bytes from page boxes, and each reader on a hand-made trace."""
import dataclasses

import numpy as np
import pytest
import torch

from portbench import harness, roofline, trace
from portbench.trace import DeviceEvent


def test_p95_is_over_every_call():
    lat = list(range(1, 101))          # 100 calls of 1..100 ms
    assert harness.p95(lat) == pytest.approx(95.05)
    assert harness.p95([5.0] * 19 + [100.0]) == pytest.approx(9.75)


def test_busy_and_idle_gaps():
    ev = [DeviceEvent("a", 10, 10), DeviceEvent("b", 15, 10),
          DeviceEvent("c", 40, 5), DeviceEvent("d", 90, 20)]
    assert trace.busy_ns(ev, 0, 100) == 15 + 5 + 10
    assert trace.idle_gaps(ev, 0, 100) == [(0, 10), (25, 40), (45, 90)]
    assert trace.busy_ns(ev, 12, 42) == 13 + 2


@dataclasses.dataclass
class S:
    name: str
    t0_ns: int
    dur_ns: int
    depth: int


def test_gaps_are_named_by_the_innermost_open_span():
    spans = [S("executor.execute", 0, 100, 0),
             S("executor.cpu_net", 30, 20, 1)]
    ev = [DeviceEvent("k1", 5, 10), DeviceEvent("k2", 55, 40)]
    bd = trace.breakdown(ev, spans, 0, 120)
    assert bd["device_ops"] == [["k2", 40e-9], ["k1", 10e-9]]
    assert bd["idle_gaps"][0] == ["executor.cpu_net", 40e-9]
    assert ["no span", 25e-9] in bd["idle_gaps"]
    assert trace.innermost_span(spans, 110) == "no span"


def test_roofline_bytes_from_page_boxes():
    # four 2-d pages; one window meets pages 0 and 1, holds page 0
    mbrs = torch.tensor([[[0, 9], [0, 9]], [[10, 19], [0, 9]],
                         [[20, 29], [0, 9]], [[0, 9], [50, 59]]])
    sizes = torch.tensor([100, 200, 300, 400])
    Ls = np.array([[0, 0]], dtype=np.uint64)
    Us = np.array([[12, 9]], dtype=np.uint64)
    meets, partial = roofline.page_masks(mbrs, Ls, Us)
    assert meets.tolist() == [True, True, False, False]
    assert partial.tolist() == [False, True, False, False]
    # Count: page 1's 200 rows x 2 coords + the window, 4 bytes each,
    # and one 4-byte count
    assert roofline.filter_bytes(mbrs, sizes, Ls, Us) == \
        (200 * 2 + 4) * 4 + 4
    # Range: pages 0 and 1, the window, 7 row ids and a count
    assert roofline.match_bytes(mbrs, sizes, Ls, Us, 7) == \
        (300 * 2 + 4) * 4 + 8 * 4
    # a page partial for one window and inside another is read once
    Ls2 = np.array([[0, 0], [10, 0]], dtype=np.uint64)
    Us2 = np.array([[12, 9], [19, 9]], dtype=np.uint64)
    assert roofline.filter_bytes(mbrs, sizes, Ls2, Us2) == \
        (200 * 2 + 8) * 4 + 8
    assert roofline.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.hbm_bytes_per_s("cpu") is None


class R:
    def __init__(self, over, rows):
        self.overflowed = np.array(over)
        self.offsets = np.array([0, rows])


def traced(kind="count"):
    mbrs = torch.tensor([[[0, 9], [0, 9]], [[10, 19], [0, 9]]])
    Ls = np.array([[0, 0], [5, 5]], dtype=np.uint64)
    Us = np.array([[12, 9], [6, 6]], dtype=np.uint64)
    ev = [DeviceEvent("void window_ring_kernel<2, 0>(Args, int)", 100,
                      1000),
          DeviceEvent("void window_ring_kernel<2, 1>(Args, int)", 1100,
                      500),
          DeviceEvent("window_match_ids_kernel", 1600, 500),
          DeviceEvent("elementwise", 3000, 1000)]
    spans = [S("executor.execute", 0, 8000, 0),
             S("executor.device_call", 50, 5000, 1)]
    return harness.Traced(card="NVIDIA H100 80GB HBM3", calls=2,
                          queries=4, window_ns=10_000, lo_ns=0,
                          hi_ns=10_000, events=ev,
                          busy_ns=trace.busy_ns(ev, 0, 10_000),
                          spans=spans,
                          calls_made=[(kind, Ls, Us, R([1, 0], 5)),
                                      (kind, Ls, Us, R([0, 0], 5))],
                          call_ns=[6000, 4000],
                          mbrs=mbrs, sizes=torch.tensor([100, 200]))


def test_readers_on_a_hand_made_trace():
    t = traced()

    def read(name, tt=t):
        return harness.load_metric(name).read(tt)

    assert read("facade_host_ms") == pytest.approx(3000 / 1e6 / 2)
    assert read("first_pass_overflow_share") == pytest.approx(1 / 4)
    assert read("launches_per_query") == pytest.approx(4 / 4)
    assert read("device_busy_us_per_query") == pytest.approx(3.0 / 4)
    assert read("device_idle_share") == pytest.approx(1 - 3000 / 10_000)
    # numpy's linear p95 of 4,000 and 6,000 ns
    assert read("traced_call_p95_ms") == pytest.approx(5900 / 1e6)
    # page 1 is partial for the first window, page 0 for the second
    nbytes = 2 * ((300 * 2 + 2 * 2 * 2) * 4 + 2 * 4)
    assert read("window_filter_roofline") == pytest.approx(
        100 * nbytes / 3.35e12 / 1e-6)
    assert read("window_match_roofline") is None      # a Count trace
    r = traced("range")
    nbytes = 2 * ((300 * 2 + 2 * 2 * 2) * 4 + (5 + 2) * 4)
    assert read("window_match_roofline", r) == pytest.approx(
        100 * nbytes / 3.35e12 / 1e-6)
    assert read("window_filter_roofline", r) is None
    r.card = "cpu"
    assert read("window_match_roofline", r) is None
