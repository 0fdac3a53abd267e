"""Each metric reader on canned readings, and the span arithmetic they
rest on."""

import pytest

from perfbench import trace
from perfbench.manifest import load, reader

# Two threads' spans on a microsecond clock: a witness span with a
# nested BFS block on thread 1, a stream span on thread 2 overlapping
# the witness.
SPANS = [
    (1, 0.0, 600_000.0, "wgl.witness"),
    (1, 100_000.0, 200_000.0, "wgl.witness.chunk"),
    (1, 400_000.0, 500_000.0, "wgl.bfs.block"),
    (2, 550_000.0, 900_000.0, "wgl.stream"),
    (2, 600_000.0, 700_000.0, "wgl.batched.block"),
]


def ctx(**kw):
    base = {
        "setup_s": 12.5,
        "window": {"seconds": 2.0, "checks": 4, "client_ops": 400_000},
        "device_name": "NVIDIA H100 80GB HBM3",
        "counts": {"counters": {"host_syncs": 5600, "stream_passes": 8,
                                "stream_restarts": 120},
                   "launches": {"witness_sweep": 1960,
                                "witness_sweep[register]": 1960}},
        "spans": SPANS, "spans_dropped": 0,
        "profile": {"busy_s": 0.1, "window_s": 1.6,
                    "kernel_s": {"void witness_sweep_kernel<1, 1, 3>": 0.02,
                                 "combine_groups_kernel": 0.005,
                                 "Memcpy DtoH": 0.01}},
        "sweep": {"bytes": 50_000_000, "launches": 500,
                  "profiled_launches": 500},
    }
    base.update(kw)
    return base


def read(name, c):
    cell = load("register-100k")
    return reader(cell, name).read(c)


def test_layer_time_is_self_time_over_threads():
    assert trace.layer_time(SPANS, {"wgl.witness"},
                            {"wgl.bfs.block", "wgl.stream"}) == \
        pytest.approx(0.45)
    assert trace.layer_time(SPANS, {"wgl.stream"}, {"wgl.batched.block"}) \
        == pytest.approx(0.25)


def test_innermost_and_gap_names():
    pieces = trace.innermost(SPANS)
    assert pieces[0] == (0.0, 100_000.0, "wgl.witness")
    assert (100_000.0, 200_000.0, "wgl.witness.chunk") in pieces
    gaps = trace.name_gaps([(150_000.0, 450_000.0), (950_000.0, 1e6)],
                           SPANS, "outside")
    assert gaps == pytest.approx({"wgl.witness.chunk": 0.05,
                                  "wgl.witness": 0.2, "wgl.bfs.block": 0.05,
                                  "outside": 0.05})


def test_union_and_intersect():
    u = trace.union([(5, 7), (0, 2), (1, 3), (6, 6)])
    assert u == [(0, 3), (5, 7)]
    assert trace.intersect(u, [(2, 6)]) == [(2, 3), (5, 6)]
    assert trace.length(u) == 5


def test_end_to_end_readers():
    assert read("ops_per_s", ctx()) == pytest.approx(200_000.0)
    assert read("setup_s", ctx()) == 12.5
    w = {"seconds": 2.0, "checks": 0, "client_ops": 0}
    assert read("ops_per_s", ctx(window=w)) is None


def test_counter_readers():
    c = ctx()
    assert read("host_syncs_per_kop", c) == pytest.approx(14.0)
    assert read("sweep_launches_per_kop", c) == pytest.approx(4.9)
    assert read("stream_restarts_per_check", c) == pytest.approx(30.0)
    none = ctx(counts={"counters": {}, "launches": {}})
    assert read("stream_restarts_per_check", none) is None
    assert read("host_syncs_per_kop", none) == 0.0


def test_span_readers():
    c = ctx()
    assert read("witness_share", c) == pytest.approx(22.5)
    assert read("stream_share", c) == pytest.approx(12.5)
    assert read("witness_share", ctx(spans_dropped=3)) is None
    assert read("stream_share", ctx(spans=SPANS[:3])) is None


def test_profile_readers():
    c = ctx()
    assert read("device_idle_share", c) == pytest.approx(93.75)
    # 50 MB at 3.35 TB/s over 25 ms of sweep kernels.
    assert read("sweep_roofline", c) == pytest.approx(
        100 * 50e6 / 3.35e12 / 0.025)
    assert read("device_idle_share", ctx(profile=None)) is None
    off = ctx(sweep={"bytes": 1, "launches": 500, "profiled_launches": 499})
    assert read("sweep_roofline", off) is None
    assert read("sweep_roofline", ctx(device_name="cpu")) is None
