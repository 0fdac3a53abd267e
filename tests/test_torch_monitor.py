"""The port's standing monitor on the CPU (monitor/loop.py, alerts.py,
telemetry/timeseries.py, web.py's series routes).

tests/test_monitor.py runs through `jepsen_tpu_torch`
(tests/torch_ported.py), but for its four cases that
tests/test_torch_rolling.py already rewrote against the JAX package's
`RollingChecker` (the three discard-parity cases and the rebase
misalignment), which run there and not twice.  Then what the port must
hold on its own:

* `_OpSource` emits the reference's event stream for the same seed;
* `run_monitor` at a small size (2 keys, 1,000 ops) gives the
  reference's per-key verdicts and summary counts;
* `AlertRouter` delivers the reference's events, as equal JSON;
* a device fault in the rolling checker ends `jepsen monitor --device
  cpu` with EXIT_ERROR, the summary written and naming the fault, and
  no verdict; without a card `jepsen monitor` exits 254 before its
  first op.
"""

import json

import pytest
import torch

import torch_ported

from jepsen_tpu_torch import cli
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.ops import wgl_witness
from jepsen_tpu_torch.ops.kernels import KernelLaunchError
from jepsen_tpu_torch.suites import kvdb as pkvdb

MON = torch_ported.load("test_monitor")

#: Rewritten in tests/test_torch_rolling.py (against the JAX checker).
IN_ROLLING = ("test_discard_parity_all_ok", "test_discard_parity_with_info",
              "test_discard_parity_invalid_prefix",
              "test_rebase_dies_on_misalignment")


@pytest.fixture(scope="module")
def pm():
    """test_monitor.py's fixture on the port."""
    return cas_register().packed()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", torch_ported.cases(MON, exclude=IN_ROLLING))
def test_monitor_cases_through_the_port(case, request):
    torch_ported.run(MON, case, request)


def test_monitor_case_list():
    """Every case of test_monitor.py runs here or in
    test_torch_rolling.py."""
    everything = torch_ported.cases(MON)
    assert len(everything) == 18
    assert set(IN_ROLLING) <= set(everything)
    assert len(torch_ported.cases(MON, exclude=IN_ROLLING)) == 14


# -- parity with the JAX package ---------------------------------------------


@pytest.mark.parametrize("seed,info_rate", [(11, 0.0), (5, 0.15), (45100, 0.05)])
def test_op_source_streams_equal_the_reference(seed, info_rate):
    from jepsen_tpu.monitor.loop import _OpSource as RefSource
    from jepsen_tpu_torch.monitor.loop import _OpSource

    ref, port = RefSource(4, 3, seed, info_rate), _OpSource(4, 3, seed,
                                                            info_rate)
    for _ in range(5000):
        (rk, rop), (pk, pop) = ref.next_event(), port.next_event()
        assert rk == pk
        assert rop.to_dict() == pop.to_dict()


def _summary_view(s: dict) -> dict:
    return {
        "verdicts": s["verdicts"], "ok_keys": s["ok_keys"],
        "unknown_keys": s["unknown_keys"], "ops": s["ops"],
        "events": s["events"], "keys": s["keys"],
        "checker": {k: s["checker"][k] for k in (
            "keys", "resident-rows", "discarded-rows", "blocks-done",
            "epoch-restarts")},
    }


@pytest.mark.parametrize("info_rate", [0.0, 0.1])
def test_run_monitor_equals_the_reference(tmp_path, info_rate):
    """2 keys, 1,000 ops through both packages' `run_monitor` with the
    same seed and knobs: equal per-key verdicts, op and event counts and
    the checker's rows, discards, blocks and epochs."""
    from jepsen_tpu.monitor import MonitorConfig as RefConfig
    from jepsen_tpu.monitor import run_monitor as ref_run
    from jepsen_tpu_torch.monitor import MonitorConfig, run_monitor

    kw = dict(rate=1e6, max_ops=1000, duration_s=0.0, cadence_s=30.0,
              keys=2, procs_per_key=3, seed=7, info_rate=info_rate,
              advance_rows=256, bars_per_block=16, blocks_per_call=2)
    ref = ref_run(RefConfig(store_dir=str(tmp_path / "ref"), **kw))
    port = run_monitor(MonitorConfig(store_dir=str(tmp_path / "port"),
                                     device="cpu", **kw))
    assert _summary_view(port) == _summary_view(ref)
    assert port["ops"] >= 1000
    if info_rate == 0.0:
        assert port["ok_keys"] == 2 and port["checker"]["discarded-rows"] > 0
    assert port["device"] == "cpu" and "device_fault" not in port
    on_disk = json.loads((tmp_path / "port" / "monitor-summary.json")
                         .read_text())
    assert on_disk["verdicts"] == port["verdicts"]


def test_alert_router_events_equal_the_reference(tmp_path):
    """The same transitions, ticks and flush through both routers, one
    store with a dossier and a postmortem: the sinks hold equal JSON."""
    from jepsen_tpu.monitor import AlertRouter as RefRouter
    from jepsen_tpu_torch.monitor import AlertRouter

    store = tmp_path / "store"
    (store / "forensics" / "monitor").mkdir(parents=True)
    (store / "forensics" / "monitor" / "d.json").write_text("{}")
    (store / "postmortem.json").write_text("{}")

    def tr(rec, rule, t, value=1.0):
        return {"rec": rec, "rule": rule, "kind": "gauge-above",
                "target": "g", "threshold": 0.5, "value": value, "t": t}

    script = [
        ("route", [tr("firing", "a", 100.0)], 100.0),
        ("route", [tr("firing", "a", 110.0), tr("firing", "b", 110.0)],
         110.0),
        ("tick", {"a": 1, "b": 1}, 150.0),
        ("tick", {"a": 1, "b": 0}, 500.0),
        ("route", [tr("cleared", "b", 510.0, 0.0),
                   tr("cleared", "c", 510.0, 0.0)], 510.0),
        ("route", [{"rec": "bogus", "rule": "x"}], 520.0),
        ("flush", None, 600.0),
    ]
    sinks = {}
    for name, cls in (("ref", RefRouter), ("port", AlertRouter)):
        sink = tmp_path / f"{name}.jsonl"
        r = cls((f"file:{sink}", "pigeon:coop"), store_dir=str(store),
                dedup_s=60.0, renotify_s=300.0)
        for verb, arg, now in script:
            if verb == "route":
                r.route(arg, now=now)
            elif verb == "tick":
                r.tick(arg, now=now)
            else:
                r.flush(now=now)
        assert r.sinks == [f"file:{sink}"]
        sinks[name] = ([json.loads(x) for x in open(sink)],
                       r.status()["rules"])
    assert sinks["port"] == sinks["ref"]
    events, _ = sinks["port"]
    assert [e["rec"] for e in events] == ["firing", "firing", "firing",
                                          "cleared", "shutdown"]


# -- device faults and the card ----------------------------------------------


def _monitor_argv(store_dir, advance_rows):
    return ["monitor", "--device", "cpu", "--store-dir", str(store_dir),
            "--rate", "1000000", "--max-ops", "3000", "--keys", "2",
            "--cadence", "30", "--advance-rows", str(advance_rows)]


@pytest.mark.parametrize("where,advance_rows", [("loop", 256),
                                                ("finish", 100_000)])
def test_a_device_fault_ends_the_monitor_with_exit_error(tmp_path,
                                                         monkeypatch,
                                                         where,
                                                         advance_rows):
    """A kernel fault in the rolling checker, in the loop's advances or
    at the final pump (no advance before it): exit 254, the summary
    written with the fault and no verdict, never an unknown epoch."""
    def sweep(*a, **kw):
        raise KernelLaunchError("witness_sweep: launch")

    monkeypatch.setattr(wgl_witness, "sweep", sweep)
    d = tmp_path / "mon"
    assert pkvdb.main(_monitor_argv(d, advance_rows)) == cli.EXIT_ERROR
    summary = json.loads((d / "monitor-summary.json").read_text())
    assert "KernelLaunchError" in summary["device_fault"]
    assert summary["verdicts"] == {}
    assert summary["unknown_keys"] == 0 and summary["ok_keys"] == 0
    assert summary["checker"]["epoch-restarts"] == 0
    assert summary["ops"] > 0


def test_monitor_exit_codes(tmp_path):
    """0 with every key proven; 2 when an epoch ended unknown (a
    non-linearizable start)."""
    assert pkvdb.main(_monitor_argv(tmp_path / "ok", 256)) == cli.EXIT_VALID
    summary = json.loads((tmp_path / "ok" / "monitor-summary.json")
                         .read_text())
    assert summary["ok_keys"] == 2 and summary["launches"] == {}


def test_monitor_without_a_card_exits_before_any_op(tmp_path,
                                                    monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = tmp_path / "mon"
    assert pkvdb.main(["monitor", "--store-dir", str(d), "--max-ops",
                       "10"]) == cli.EXIT_ERROR
    assert not d.exists()
    from jepsen_tpu_torch.device import DeviceUnavailable
    from jepsen_tpu_torch.monitor import MonitorConfig, run_monitor

    with pytest.raises(DeviceUnavailable):
        run_monitor(MonitorConfig(store_dir=str(d), max_ops=10))
    assert not d.exists()


def test_a_tail_opened_on_a_torn_file_follows_the_restarted_writer(
        tmp_path):
    """The SSE route's tail, opened while a crashed writer's torn tail is
    still on disk: the restarted writer truncates the tear and appends
    over it, and the tail delivers those samples."""
    from jepsen_tpu_torch.telemetry import timeseries

    d = str(tmp_path)
    st = timeseries.SeriesStore(d)
    st.append({"m.t": 1.0}, t=1000.0)
    st.close()
    with open(timeseries.series_path(d, 0), "ab") as f:
        f.write(b"\x00\x17GARBAGE-TORN-TAIL-NOT-A-BLOCK")
    tail = timeseries.SeriesTail(timeseries.series_path(d, 0))
    try:
        assert tail.poll() == []
        st2 = timeseries.SeriesStore(d)
        st2.append({"m.t": 2.0}, t=1001.0)
        st2.append({"m.t": 3.0}, t=1002.0)
        got = tail.poll()
        st2.close()
    finally:
        tail.close()
    assert [p["s"] for p in got] == [{"m.t": 2.0}, {"m.t": 3.0}]
