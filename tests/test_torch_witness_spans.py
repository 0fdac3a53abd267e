"""Where the witness chunk's host time goes, and the check's front end,
on the CPU; and the benchmark's readers of them.

With telemetry on, the witness search (ops/wgl_witness.py) times each
chunk's block tables in a `wgl.witness.table` span, and adds the host's
nanoseconds in its sweeps and its chain searches, less the device reads
inside them, to `device.counters["sweep_ns"]` and `["chain_ns"]`;
`device.host` adds each read's wait to `["sync_ns"]`.  `pack_history`
and `check_refute` record `ingest.pack` and `checker.refute` spans.
`device.counters["chain_rounds"]` counts the chain searches' rounds,
always.  The readers are `perfbench/metrics/<name>.py`.
"""

import copy
import gc
import time

import pytest
import torch

from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch import telemetry
from jepsen_tpu_torch.checker import Linearizable
from jepsen_tpu_torch.history.packed import pack_history
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.ops.wgl_witness import (
    CHAIN_DEPTH,
    TRANSFER_MODES,
    check_wgl_witness,
)
from jepsen_tpu_torch.telemetry import profile
from jepsen_tpu_torch.utils.histgen import random_register_history

from perfbench import manifest, run

#: The spans this file holds the port to.
NEW_SPANS = ("wgl.witness.table", "ingest.pack", "checker.refute")
#: The host nanoseconds `device.counters` gains with telemetry on.
NS = ("sweep_ns", "chain_ns", "sync_ns")
#: Cases of tests/test_wgl_witness.py's `test_witness_parity_valid`
#: whose searches die and run chain rounds: (n, info rate, procs, seed).
CASES = [(2048, 0.1, 8, 5), (1024, 0.5, 8, 6)]


@pytest.fixture(scope="module")
def pm():
    return cas_register().packed()


@pytest.fixture
def tele():
    """Telemetry on and empty for the test; off and empty after it."""
    was = telemetry.enabled()
    telemetry.enable(True)
    telemetry.reset()
    yield
    telemetry.enable(was)
    telemetry.reset()


def _spans() -> list:
    """(name, thread, start us, end us) of every recorded span."""
    return [(e["name"], e["tid"], e["ts"], e["ts"] + e["dur"])
            for e in telemetry.chrome_trace()["traceEvents"]
            if e.get("ph") == "X"]


def _delta(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in _device.counters.items()
            if v != before.get(k, 0)}


def _witness(pm, case, transfer="full"):
    """The search on one case at small blocks (several chunks) ->
    (result, the device.counters it added)."""
    n, info, procs, seed = case
    packed = pack_history(random_register_history(
        n, procs=procs, info_rate=info, seed=seed), pm.encode)
    before = dict(_device.counters)
    res = check_wgl_witness(packed, pm, bars_per_block=64,
                            blocks_per_call=4, transfer=transfer,
                            device="cpu")
    return res, _delta(before)


@pytest.mark.parametrize("transfer", TRANSFER_MODES)
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c[0]}-s{c[3]}")
def test_table_spans_lie_inside_a_chunk_and_the_rounds_count(pm, tele, case,
                                                             transfer):
    t0 = time.perf_counter_ns()
    res, delta = _witness(pm, case, transfer)
    wall = time.perf_counter_ns() - t0
    assert res is not None and res.valid is True
    spans = _spans()
    chunks = [s for s in spans if s[0] == "wgl.witness.chunk"]
    tables = [s for s in spans if s[0] == "wgl.witness.table"]
    assert len(chunks) > 1 and tables
    for _, tid, a, b in tables:
        assert any(t == tid and ca - 1e-3 <= a and b <= cb + 1e-3
                   for _, t, ca, cb in chunks)
    searches = delta.get("heavy_rounds", 0)
    assert searches > 0
    assert searches <= delta["chain_rounds"] <= CHAIN_DEPTH * searches
    # No read waits on a card here; the sweeps and searches take time,
    # and all of it inside the check.
    assert "sync_ns" not in delta
    assert 0 < delta["sweep_ns"] and 0 < delta["chain_ns"]
    assert delta["sweep_ns"] + delta["chain_ns"] < wall


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c[0]}-s{c[3]}")
def test_the_witness_records_no_span_per_sweep_or_search(pm, tele, case):
    """The benchmark names each idle gap of the card by scanning every
    span piece of a check: a span per sweep or per search would make
    that scan thousands of times longer.  The chunk's spans stay one
    table and one chunk span per chunk."""
    _, delta = _witness(pm, case)
    spans = _spans()
    chunks = sum(s[0] == "wgl.witness.chunk" for s in spans)
    assert sum(s[0] == "wgl.witness.table" for s in spans) == chunks
    assert len(spans) <= 2 * chunks + 3 < delta["heavy_rounds"]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c[0]}-s{c[3]}")
def test_off_records_nothing_and_changes_nothing(pm, tele, case):
    telemetry.enable(False)
    off, off_delta = _witness(pm, case)
    s = telemetry.summary()
    assert s["spans"] == {} and s["trace_events"] == 0
    assert not set(NS) & set(off_delta)
    telemetry.enable(True)
    on, on_delta = _witness(pm, case)
    assert telemetry.summary()["trace_events"] > 0
    assert (off.valid, off.configs_explored) == (on.valid,
                                                 on.configs_explored)
    assert off_delta == {k: v for k, v in on_delta.items() if k not in NS}


class _CardValue:
    """A stand-in for a tensor on the card: `device.host` reads only
    its `.device.type` and `.tolist()`, here after `wait_s`."""

    class device:
        type = "cuda"

    def __init__(self, wait_s: float = 0.0):
        self.wait_s = wait_s

    def tolist(self):
        time.sleep(self.wait_s)
        return [7]


def test_host_adds_each_counted_wait_and_no_cpu_read(tele):
    before = dict(_device.counters)
    for _ in range(3):
        assert _device.host(_CardValue(0.002)) == [7]
    assert _device.host(torch.tensor([1, 2])) == [1, 2]
    d = _delta(before)
    assert d["host_syncs"] == 3
    assert d["sync_ns"] >= 3 * 2_000_000
    assert _spans() == []


def test_host_off_counts_the_sync_and_times_nothing():
    was = telemetry.enabled()
    telemetry.enable(False)
    try:
        before = dict(_device.counters)
        assert _device.host(_CardValue()) == [7]
        assert _delta(before) == {"host_syncs": 1}
    finally:
        telemetry.enable(was)


def test_timed_leaves_out_the_reads_inside_it(tele):
    before = dict(_device.counters)
    t0 = time.perf_counter_ns()
    with _device.timed("test_ns"):
        _device.host(_CardValue(0.02))
        time.sleep(0.01)
    wall = time.perf_counter_ns() - t0
    d = _delta(before)
    assert d["sync_ns"] >= 20_000_000
    assert 10_000_000 <= d["test_ns"] <= wall - d["sync_ns"]
    _device.counters.pop("test_ns")


def test_timed_off_is_one_shared_no_op():
    was = telemetry.enabled()
    telemetry.enable(False)
    try:
        assert _device.timed("a_ns") is _device.timed("b_ns")
        before = dict(_device.counters)
        with _device.timed("a_ns"):
            pass
        assert _delta(before) == {}
    finally:
        telemetry.enable(was)


def test_front_end_spans_hold_pack_and_screen(pm, tele):
    h = random_register_history(400, procs=4, info_rate=0.05, seed=5)
    assert Linearizable(cas_register(), device="cpu").check(
        {}, h, {})["valid"] is True
    spans = _spans()
    assert {"ingest.pack", "checker.refute"} <= {s[0] for s in spans}
    packs = [s for s in spans if s[0] == "ingest.pack"]
    for _, tid, a, b in (s for s in spans if s[0] == "ingest.finish"):
        assert any(t == tid and pa - 1e-3 <= a and b <= pb + 1e-3
                   for _, t, pa, pb in packs)


@pytest.mark.parametrize("name", NEW_SPANS)
def test_no_new_span_counts_as_execute_or_compile(name):
    """`telemetry/profile.py` adds spans ending `.chunk` / `.block` to a
    pass's execute_s and `.compile` to its compile_s: none of these may,
    or the chunk's time would count twice."""
    assert not name.endswith(profile.EXECUTE_SUFFIXES
                             + profile.COMPILE_SUFFIXES)


def test_a_pass_record_counts_the_chunk_once(pm, tele):
    """The pass record's execute_s is the chunk spans' time alone, the
    table spans nested in them not added."""
    packed = pack_history(random_register_history(
        2048, procs=8, info_rate=0.1, seed=5), pm.encode)
    with profile.capture("witness", device="cpu") as rec:
        check_wgl_witness(packed, pm, bars_per_block=64, blocks_per_call=4,
                          device="cpu")
    chunk_s = telemetry.summary()["spans"]["wgl.witness.chunk"]["total_s"]
    assert rec.record()["timing"]["execute_s"] == pytest.approx(
        chunk_s, abs=2e-6)


# ------------------------------------------------------------ the readers

# Spans on a microsecond clock over a 2 s window: two chunks on thread
# 1, each with a table; the front end on thread 2.
SPANS = [
    (1, 0.0, 600_000.0, "wgl.witness.chunk"),
    (1, 0.0, 50_000.0, "wgl.witness.table"),
    (1, 700_000.0, 1_000_000.0, "wgl.witness.chunk"),
    (1, 700_000.0, 750_000.0, "wgl.witness.table"),
    (2, 1_200_000.0, 1_500_000.0, "ingest.pack"),
    (2, 1_400_000.0, 1_450_000.0, "ingest.finish"),
    (2, 1_500_000.0, 1_600_000.0, "checker.refute"),
]
READERS = ("chain_share", "chain_rounds_per_kop", "sweep_share",
           "table_share", "sync_wait_share", "pack_share", "screen_share")
SPAN_READERS = ("table_share", "pack_share", "screen_share")
COUNTER_READERS = ("chain_share", "chain_rounds_per_kop", "sweep_share",
                   "sync_wait_share")
COUNTERS = {"host_syncs": 5600, "heavy_rounds": 1000, "chain_rounds": 3000,
            "chain_ns": 1_000_000_000, "sweep_ns": 150_000_000,
            "sync_ns": 130_000_000}


def _ctx(**kw):
    base = {
        "setup_s": 12.5,
        "window": {"seconds": 2.0, "checks": 4, "client_ops": 400_000},
        "device_name": "NVIDIA H100 80GB HBM3",
        "counts": {"counters": COUNTERS,
                   "launches": {"witness_sweep": 1960}},
        "spans": SPANS, "spans_dropped": 0,
        "profile": {"busy_s": 0.1, "window_s": 1.6, "kernel_s": {},
                    "gaps_s": {"wgl.witness.chunk": 1.4},
                    "spans_dropped": 0},
    }
    base.update(kw)
    return base


def _read(name, c):
    return manifest.reader(manifest.load("register-100k"), name).read(c)


def test_every_reader_is_listed_for_the_cell():
    cell = manifest.load("register-100k")
    listed = {m["name"]: m for m in cell.per_layer}
    for name in READERS:
        assert listed[name]["moves"] == "ops_per_s"
        assert listed[name]["source"] == ("program_span"
                                          if name in SPAN_READERS
                                          else "program_counter")
        assert (cell.home / "metrics" / f"{name}.py").is_file()


@pytest.mark.parametrize("name, want", [
    ("chain_share", 50.0),
    ("sweep_share", 7.5),
    ("sync_wait_share", 6.5),
    ("chain_rounds_per_kop", 7.5),
    ("table_share", 5.0),
    # ingest.finish lies inside ingest.pack: 300 ms.
    ("pack_share", 15.0),
    ("screen_share", 5.0),
])
def test_reader_values(name, want):
    assert _read(name, _ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_on_an_empty_window(name):
    empty = {"seconds": 0.0, "checks": 0, "client_ops": 0}
    assert _read(name, _ctx(window=empty)) is None


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_read_nothing_on_dropped_or_absent_spans(name):
    assert _read(name, _ctx(spans_dropped=3)) is None
    # The parent's program has none of these spans: nothing, no error.
    old = [s for s in SPANS if s[3] == "wgl.witness.chunk"]
    assert _read(name, _ctx(spans=old)) is None


@pytest.mark.parametrize("name", COUNTER_READERS)
def test_counter_readers_read_nothing_without_their_counter(name):
    # The parent's program keeps none of these counters.
    old = {"counters": {"host_syncs": 5600, "heavy_rounds": 1000},
           "launches": {"witness_sweep": 1960}}
    assert _read(name, _ctx(counts=old)) is None


def test_a_traced_host_run_reads_the_new_metrics():
    """The harness's window on the CPU at a small size, traced: each
    new reader reads, but `sync_wait_share` (no read waits on a card
    here)."""
    cell = copy.deepcopy(manifest.load("register-100k"))
    cell.config["history"]["ops_per_key"] = 1500
    cell.traffic["pool"] = 2
    was = telemetry.enabled()
    try:
        out = run.run(cell, run.host_entry(cell), 2**31 + 21, 0.3,
                      trace=True)
    finally:
        gc.unfreeze()  # the window freezes its pool
        telemetry.enable(was)
        telemetry.reset()
    assert out["correct"] is True
    m = out["metrics"]
    for name in READERS:
        if name != "sync_wait_share":
            assert m[name]["value"] > 0, name
    assert "sync_wait_share" not in m
    assert m["chain_share"]["value"] + m["sweep_share"]["value"] < 100
