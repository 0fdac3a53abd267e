"""Core orchestration: the whole-test lifecycle.

The port's copy of `jepsen_tpu/core.py` (the reference's core.clj):
`prepare_test`, `run`, `run_case`, `analyze`, `rerun_analysis` and
`repair`.  The lifecycle:

    prepare (the card resolved) → store dir + logging → save-0 →
    sessions → OS setup → DB cycle → client/nemesis setup →
    interpreter (history streamed to disk, and to the online session
    when one is on) → save-1 → snarf logs → teardown → analyze → save-2

The *test map* is the universal config object.  Keys: name, nodes,
concurrency (int or "3n"), client, nemesis, db, os, net, generator,
checker, model, ssh {dummy? ...}, store-dir, leave-db-running, and the
port's "device" ("cuda", the default, or "cpu"): the device the
checkers and the online session run on.

What differs from the reference:
- `prepare_test` resolves the test's device before anything else, so
  a run meant for the card that finds none raises before its store
  directory exists and before the first op is generated.
- A device fault (`ops.degrade.is_device_fault`: a kernel that did not
  build or launch, a CUDA error, CUDA asked for and missing) raises out
  of `analyze` instead of becoming an "unknown" verdict, and the online
  session's `finish` does not hide one either.
- `rerun_analysis` passes the stored history through the workload's
  "history-reviver" where it has one: the store keeps op values as JSON
  has them (a keyed value as a list), and a workload that ran with
  other values (the north-star workload's KV pairs) turns them back.
- The anomaly forensics of the reference's `analyze` are not ported.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Optional

from . import db as jdb
from . import device as _device
from . import interpreter, oses, store, telemetry
from .checker.core import check_safe
from .control import Session, health, with_sessions
from .history import History
from .nemesis import Nemesis, ledger as fault_ledger, noop as noop_nemesis
from .ops import degrade
from .telemetry import flight, profile, slo
from .utils import real_pmap

log = logging.getLogger(__name__)


def parse_concurrency(spec: Any, n_nodes: int) -> int:
    """int, or "3n" = 3 × node count (cli.clj:150-168)."""
    if isinstance(spec, int):
        return spec
    m = re.fullmatch(r"(\d+)n", str(spec).strip())
    if m:
        return int(m.group(1)) * max(n_nodes, 1)
    return int(spec)


def prepare_test(test: dict) -> dict:
    """Fills defaults: parsed concurrency, noop nemesis
    (core.clj:302-320), and the device, resolved first: "cuda" unless
    the test asks for "cpu", and DeviceUnavailable raised here when
    CUDA is asked for and there is none.  A workload-supplied
    "final-generator" (e.g. a set workload's final read) is phased onto
    client threads after the main generator."""
    test = dict(test)
    test["device"] = str(_device.resolve(test.get("device") or "cuda"))
    test.setdefault("name", "noname")
    test.setdefault("nodes", ["n1", "n2", "n3", "n4", "n5"])
    test["concurrency"] = parse_concurrency(
        test.get("concurrency", "1n"), len(test["nodes"])
    )
    test.setdefault("nemesis", noop_nemesis)
    fg = test.pop("final-generator", None)
    if fg is not None and test.get("generator") is not None:
        from .generator import clients as gen_clients, phases as gen_phases

        test["generator"] = gen_phases(
            test["generator"], gen_clients(fg)
        )
    return test


def setup_nemesis(test: dict) -> Nemesis:
    nem = test.get("nemesis") or noop_nemesis
    return nem.setup(test)


def _with_clients(test: dict, method: str) -> None:
    """Opens a client per node and calls setup/teardown on it
    (core.clj:175-206)."""
    proto = test.get("client")
    if proto is None:
        return

    def one(node: str) -> None:
        c = proto.open(test, node)
        try:
            getattr(c, method)(test)
        finally:
            try:
                c.close(test)
            except Exception:  # noqa: BLE001
                pass

    if method == "teardown":
        # Best-effort: a node the nemesis left dead must not turn a
        # finished run into an error.  Runs over ALL nodes, quarantined
        # included — teardown owes dead nodes an attempt.
        def one_safe(node: str) -> None:
            try:
                one(node)
            except Exception as e:  # noqa: BLE001
                log.warning("client teardown on %s failed: %r", node, e)

        real_pmap(one_safe, test.get("nodes") or [])
    else:
        # Setup fans out over the non-quarantined nodes, collects every
        # per-node failure (real_pmap would hide siblings behind the
        # first), and lets the node-loss policy decide abort vs shrink.
        _ok, failed = health.node_fanout(health.eligible_nodes(test), one)
        health.absorb_failures(test, "client setup", failed)


def run_case(test: dict, history_writer=None) -> History:
    """Client+nemesis setup, then the generator interpreter
    (core.clj:208-213)."""
    nem = setup_nemesis(test)
    test = dict(test)
    test["nemesis"] = nem
    primary: Optional[BaseException] = None
    try:
        with telemetry.span("lifecycle.client-setup"):
            _with_clients(test, "setup")
        with telemetry.span("lifecycle.interpreter"):
            return interpreter.run(test, writer=history_writer)
    except BaseException as e:
        primary = e
        raise
    finally:
        # Teardown failures must not mask the interpreter's primary
        # exception — that's the one that explains the run.  Each phase
        # is isolated; failures are logged + counted, and only surface
        # as the raised error when the run itself succeeded.
        errors: list[tuple[str, BaseException]] = []
        try:
            with telemetry.span("lifecycle.client-teardown"):
                _with_clients(test, "teardown")
        except Exception as e:  # noqa: BLE001
            errors.append(("client", e))
        try:
            nem.teardown(test)
        except Exception as e:  # noqa: BLE001
            errors.append(("nemesis", e))
        for what, e in errors:
            telemetry.count("nemesis.teardown.failed")
            log.warning(
                "%s teardown failed%s: %r", what,
                " (primary exception takes precedence)" if primary else "",
                e,
            )
        if errors and primary is None:
            raise errors[0][1]


def analyze(test: dict, history: History, dir: Optional[str] = None) -> dict:
    """Runs the test's checker over the history (core.clj:215-228).
    `dir` is where artifact-writing checkers put their output; defaults
    to the test's own store dir."""
    checker = test.get("checker")
    if checker is None:
        return {"valid": True, "note": "no checker"}
    # Checker-as-a-service routing: with a daemon address (test map
    # "checkerd", set by --remote, or the JEPSEN_CHECKERD env var) the
    # linearizable pieces of the checker tree ship their work to the
    # shared pool; everything falls back in-process if it's down.
    addr = test.get("checkerd") or os.environ.get("JEPSEN_CHECKERD")
    if addr:
        from .checkerd.client import wrap_remote

        run_id = f"{test.get('name') or 'run'}@{os.getpid()}"
        checker = wrap_remote(checker, str(addr), run_id=run_id)
    # Online checking: close the run's streaming session (drains the
    # last buffer, runs the final proofs, measures verdict lag) BEFORE
    # the checkers run, so they find its verdicts ready to consume.
    sess = test.get("streaming-session")
    if sess is not None and not sess.finished:
        try:
            sess.finish()
        except Exception as e:  # noqa: BLE001 — post-hoc covers the rest
            if degrade.is_device_fault(e):
                raise
            log.warning("streaming session finish failed; checking "
                        "post-hoc", exc_info=True)
    opts: dict[str, Any] = {"history-key": None}
    if dir is not None:
        opts["dir"] = dir
    else:
        try:
            opts["dir"] = store.test_dir(test)
        except ValueError:
            pass
    # The analyze span anchors cross-process nesting: its span id
    # becomes the parent of every span done FOR this run elsewhere
    # (checkerd cohorts, streaming commits), carried by the trace
    # context the wire protocol propagates.
    analyze_sid = telemetry.new_span_id()
    telemetry.set_parent_span(analyze_sid)
    try:
        with telemetry.span("lifecycle.analyze", span_id=analyze_sid,
                            trace_id=telemetry.trace_id()):
            results = check_safe(checker, test, history, opts)
    finally:
        telemetry.set_parent_span(None)
    # Surface robustness events (op timeouts, blown checker budgets,
    # degradation-ladder steps) next to the verdicts they shaped, so a
    # report reader can tell a clean "valid" from a degraded one.
    res_counters = telemetry.resilience_counters()
    resil: dict[str, Any] = dict(res_counters)
    hm = health.monitor_of(test)
    if hm is not None and hm.active:
        # Per-node availability timeline — only once any failure signal
        # fired, so a healthy run's results are byte-identical to a run
        # without the monitor.
        resil["nodes"] = hm.summary()
    if resil and isinstance(results, dict):
        results.setdefault("resilience", resil)
    if sess is not None and isinstance(results, dict):
        results.setdefault("streaming", sess.stats())
    return results


def log_results(results: dict) -> None:
    """core.clj:230-243."""
    valid = results.get("valid")
    if valid is True:
        log.info("Everything looks good! ヽ('ー`)ノ")
    elif valid == "unknown":
        log.warning("Errors occurred during analysis; validity unknown")
    else:
        log.warning("Analysis invalid! (ﾉಥ益ಥ）ﾉ ┻━┻")


def run(test: dict) -> dict:
    """The full lifecycle (core.clj:322-412).  Returns the test map with
    "history" and "results" added.

    With JEPSEN_TELEMETRY=1 the run is a telemetry scope: the registry
    is reset on entry (scoped — fleet counters like nemesis.search.*
    survive, telemetry/__init__.py FLEET_COUNTER_PREFIXES), every
    lifecycle phase is spanned, and on exit telemetry.json +
    trace.json land in the run's store dir with the top-5 spans
    logged.  The scope also seeds the run's trace context (adopting
    test["trace-parent"] when a search loop or parent run propagated
    one), points the per-pass profile store and the flight recorder at
    the store dir, and dumps a postmortem when the run crashes."""
    telemetry.scoped_reset()
    telemetry.seed_trace(test.get("trace-parent"))
    flight.reset()
    with telemetry.span("lifecycle.prepare"):
        test = prepare_test(test)
        test = store.make_test_dir(test)
    run_dir = store.test_dir(test)
    profile.set_store(run_dir)
    flight.set_dir(run_dir)
    slo.set_dir(run_dir)
    try:
        return _run_prepared(test)
    except BaseException as e:
        flight.note("run-crashed", error=f"{type(e).__name__}: {e}",
                    test=test.get("name"))
        flight.dump("run-crashed")
        raise
    finally:
        # Export in a finally: a crashed run is exactly the one whose
        # phase profile matters.
        if telemetry.enabled():
            telemetry.export(run_dir)
            telemetry.log_top_spans(log)
        profile.set_store(None)
        flight.set_dir(None)
        slo.set_dir(None)


def _run_prepared(test: dict) -> dict:
    """The lifecycle after prepare — wrapped so `run` can export
    telemetry for crashed runs too."""
    with telemetry.span("lifecycle.run", test=test.get("name")):
        handler = store.start_logging(test)
        try:
            with store.Store(test) as st:
                st.save_0(test)
                hw = st.history_writer()
                # The fault ledger journals every nemesis intent into
                # the store dir (lazily — fault-free runs never create
                # the file), so a killed control process leaves a
                # durable record of what is still broken on the nodes.
                test["fault-ledger"] = fault_ledger.FaultLedger(
                    fault_ledger.ledger_path(store.test_dir(test))
                )
                # The node health monitor is passive until the first
                # failure signal: no thread, no probes, no overhead on
                # a healthy run (same lazy contract as the ledger).
                test["node-health"] = health.HealthMonitor(test)
                # Online checking (--streaming / JEPSEN_STREAMING): tee
                # the journal into a checking session that proves keys
                # WHILE the run generates them (streaming/).
                writer = hw.append
                from .streaming import maybe_session, streaming_enabled
                if streaming_enabled(test):
                    sess = maybe_session(test, device=test["device"])
                    if sess is not None:
                        test["streaming-session"] = sess

                        def writer(op, _hw=hw.append, _sess=sess):
                            _hw(op)  # durability first, checking second
                            _sess.feed(op)
                with with_sessions(test):
                    try:
                        with telemetry.span("lifecycle.os-setup"):
                            oses.setup(test)
                        with telemetry.span("lifecycle.db-cycle"):
                            jdb.cycle(test)
                        history = run_case(test, history_writer=writer)
                        test["history"] = history
                        with telemetry.span("lifecycle.save"):
                            st.save_1(test, history)
                    finally:
                        # Whatever happened — OS/DB setup crash, client bug
                        # mid-run — seal any partial history so the file
                        # stays readable for `analyze`.
                        try:
                            hw.close()
                        except Exception as e:  # noqa: BLE001
                            log.warning("history seal failed: %r", e)
                        # Snarf logs even when the run throws — failing runs
                        # are exactly the ones whose logs matter
                        # (core.clj:142-158 with-log-snarfing).
                        if test.get("db") is not None:
                            try:
                                with telemetry.span("lifecycle.snarf"):
                                    jdb.snarf_logs(test, store.test_dir(test))
                            except Exception as e:  # noqa: BLE001
                                log.warning("log snarfing failed: %r", e)
                        if not test.get("leave-db-running"):
                            try:
                                jdb.teardown(test)
                            except Exception as e:  # noqa: BLE001
                                log.warning("db teardown failed: %r", e)
                            else:
                                # A completed DB teardown kills every
                                # daemon: db-kill/db-pause faults can't
                                # outlive it, and their compensator
                                # (restart a binary teardown just
                                # removed) must not be replayed by a
                                # later `repair`.
                                led = test.get("fault-ledger")
                                if (led is not None
                                        and test.get("db") is not None
                                        and os.path.exists(led.path)):
                                    for tag in ("db-kill", "db-pause"):
                                        led.heal_matching(
                                            tag=tag, by="db-teardown"
                                        )
                        try:
                            oses.teardown(test)
                        except Exception as e:  # noqa: BLE001
                            log.warning("os teardown failed: %r", e)
                        # Residue sweep: only when faults were actually
                        # journaled (fault-free runs skip it entirely),
                        # while sessions are still open — its
                        # nemesis.residue.* counters then land in the
                        # results' resilience block.
                        led = test.get("fault-ledger")
                        if led is not None and os.path.exists(led.path):
                            try:
                                with telemetry.span(
                                    "lifecycle.residue-sweep"
                                ):
                                    residue = fault_ledger.probe_residue(
                                        test, ledger=led
                                    )
                                if not residue["clean"]:
                                    log.warning(
                                        "fault residue after teardown: "
                                        "%s — run `jepsen repair %s`",
                                        residue, store.test_dir(test),
                                    )
                            except Exception as e:  # noqa: BLE001
                                log.warning("residue sweep failed: %r", e)
                results = analyze(test, test["history"])
                test["results"] = results
                with telemetry.span("lifecycle.save"):
                    st.save_2(results)
                log_results(results)
        finally:
            hm = test.pop("node-health", None)
            if hm is not None:
                try:
                    hm.stop()
                except Exception:  # noqa: BLE001
                    pass
            led = test.pop("fault-ledger", None)
            if led is not None:
                try:
                    led.close()
                except Exception:  # noqa: BLE001
                    pass
            store.stop_logging(handler)
    return test


def rerun_analysis(test_dir: str, test: dict) -> dict:
    """Re-runs checkers over a stored history — the `analyze` CLI
    subcommand (cli.clj:402-441).  `test` supplies live objects
    (checker, model); the stored test map fills the rest."""
    tf = store.load(test_dir)
    try:
        stored = tf.test or {}
        # The stored map is the record of the run; the caller's map only
        # contributes live objects (checker/model/client...) and keys the
        # stored run never had — CLI defaults must not clobber the
        # recorded nodes/concurrency/etc.
        merged = {**test, **stored}
        for k in store.NONSERIALIZABLE_KEYS:
            if k in test:
                merged[k] = test[k]
        # `analyze --remote` must beat whatever address (or absence)
        # the original run recorded.
        if "checkerd" in test:
            merged["checkerd"] = test["checkerd"]
        history = tf.history()
        reviver = merged.get("history-reviver")
        if reviver is not None:
            history = reviver(history)
        # Artifacts go next to the file actually being analyzed, not a
        # path recomputed from CLI options.
        artifact_dir = (
            test_dir if os.path.isdir(test_dir) else os.path.dirname(tf.path)
        )
        results = analyze(merged, history, dir=artifact_dir)
        with store.format.Handle(
            tf.path
        ) as h:  # append fresh results to the same file
            h.save_results(results)
        merged["history"] = history
        merged["results"] = results
        return merged
    finally:
        tf.close()


def repair(test_dir: str, test: Optional[dict] = None) -> dict:
    """Recovers a crashed run's cluster: loads the fault ledger from
    `test_dir`, reopens sessions, replays outstanding compensators
    newest-first (reverse injection order), journals a healed record
    for each success, and finishes with a residue probe sweep — the
    `jepsen repair` CLI subcommand.

    `test` supplies live objects the stored map cannot carry (remote,
    ssh opts, db for db-start/db-resume compensators); the stored test
    map fills nodes and the rest.  Session opening is per-node
    best-effort — one unreachable node is reported in "unreachable",
    not fatal, and healing proceeds on the rest.

    Returns {"outstanding": n, "healed": [ids], "failed": {id: result},
    "unreachable": {node: err}, "residue": sweep, "clean": bool}.
    Running repair on a clean dir (or twice) is a no-op."""
    path = fault_ledger.ledger_path(test_dir)
    outstanding = fault_ledger.outstanding_entries(
        fault_ledger.read_records(path)
    )

    stored: dict = {}
    tf_path = os.path.join(test_dir, store.TEST_FILE)
    if os.path.exists(tf_path):
        tf = store.load(test_dir)
        try:
            stored = tf.test or {}
        finally:
            tf.close()
    test = test or {}
    merged = {**test, **stored}
    for k in store.NONSERIALIZABLE_KEYS:
        if k in test:
            merged[k] = test[k]

    report: dict[str, Any] = {
        "ledger": path,
        "outstanding": len(outstanding),
        "healed": [],
        "failed": {},
        "unreachable": {},
    }
    if not outstanding:
        log.info("repair %s: ledger clean, nothing to do", test_dir)
        report["residue"] = {"clean": True, "outstanding": 0, "nodes": {}}
        report["clean"] = True
        return report

    sessions: dict[str, Session] = {}
    for node in merged.get("nodes") or []:
        try:
            sessions[node] = Session.connect(merged, node)
        except Exception as e:  # noqa: BLE001 — heal the reachable rest
            log.warning("repair: cannot reach %s: %r", node, e)
            report["unreachable"][node] = f"{type(e).__name__}: {e}"
    merged["sessions"] = sessions

    # Reopening truncates any torn tail the dying writer left, so the
    # healed records land in a valid file.
    led = fault_ledger.FaultLedger(path)
    try:
        for entry in outstanding:
            res = fault_ledger.run_compensator(merged, entry)
            if res["ok"]:
                led.healed(entry["id"], by="repair")
                report["healed"].append(entry["id"])
                log.info(
                    "repair: healed entry %s (%s/%s)", entry["id"],
                    entry.get("fault"), entry.get("tag") or "-",
                )
            else:
                report["failed"][entry["id"]] = res
                log.warning(
                    "repair: entry %s (%s/%s) NOT healed: %s",
                    entry["id"], entry.get("fault"),
                    entry.get("tag") or "-",
                    res.get("error") or res.get("nodes"),
                )
        report["residue"] = fault_ledger.probe_residue(merged, ledger=led)
    finally:
        led.close()
        for s in sessions.values():
            try:
                s.disconnect()
            except Exception:  # noqa: BLE001
                pass
        merged.pop("sessions", None)
    report["clean"] = (
        report["residue"]["clean"]
        and not report["failed"]
        and not report["unreachable"]
    )
    return report
