"""Anomaly forensics: every invalid verdict ships a dossier.

The reference framework never leaves a bad verdict bare — checkers
render reports, knossos draws why each linearization path dies, and the
timeline shows the offending window (PAPER.md §0 step 5).  This module
is that assembly step for us: after `core.analyze` merges the checker
tree's results, `assemble` walks them for anomalies (any `valid` of
False or "unknown", per key or whole-history), and builds one
self-contained bundle per anomaly under ``store/<run>/forensics/<key>/``:

  * ``counterexample.json`` / ``.txt`` — the *minimal* counterexample
    subhistory: the per-key history delta-debugged host-side with the
    generic two-pass greedy shrinker (nemesis/search.py) using
    the exact CPU engine as the oracle, so the shrunk history is
    re-proven non-linearizable before it is written.  The JSON is
    deliberately timestamp-free: a remote (checkerd) verdict and an
    in-process one over the same history produce byte-identical files.
  * ``linear.svg`` — the linviz death chart for the violating window,
    drawn from the oracle's own WGL result over the minimal history.
  * ``timeline.html`` — the per-key timeline with the crashed op
    highlighted.
  * ``death.json`` — the WGL death state: the per-key result verbatim
    (deepest configs, refutation certificates, which degradation-ladder
    tier produced the verdict and why, checkerd RESULT meta when the
    verdict came from the daemon).
  * ``profiles.json`` / ``trace-slice.json`` — the per-pass cost
    records and Chrome-trace slice for the passes that decided it
    (filtered to this run's trace id / checking categories).
  * ``flight.json`` — the flight-recorder ring as of assembly.
  * ``nemesis.json`` — fault windows from the durable ledger that
    overlapped the violating ops' invoke→return intervals (advisory:
    correlation, not causation).

Each dossier carries a stable **anomaly signature** — a short hash over
the semantic content of the violation (key, verdict, crashed op,
refutation screens) and *not* over which tier found it — which the
coverage-guided nemesis search consumes as a fitness dimension
(`nemesis.search.signature` adds ``x:<sig>`` features), so the fuzzer
is rewarded for finding *new kinds* of anomalies, not re-finding one.

Everything here is fail-open side output: a forensics failure must
never change the verdict it documents.

The port's copy of `jepsen_tpu/forensics.py`.  What differs: every
fail-open catch re-raises a device fault (`ops.degrade.is_device_fault`:
a kernel that did not build or launch, a CUDA error, CUDA asked for and
missing), as the port's `core.analyze` does; only other errors are
logged.  The shrink oracle is the exact host engine, so forensics takes
no device: the verdict it documents came from the checkers' device.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from datetime import datetime
from typing import Any, Optional

from . import telemetry
from .history.core import History
from .history.packed import pack_history
from .ops import degrade
from .telemetry import flight, profile
from .utils import sanitize_path_part

log = logging.getLogger(__name__)

#: Subdirectory of a run's store dir holding one dir per anomaly.
FORENSICS_DIR = "forensics"

#: Dossier budget per run: anomalies beyond it are counted and listed
#: in the summary but get no bundle (a pathological run can fail every
#: key; the first few dossiers carry all the signal).
MAX_DOSSIERS = 16

#: Shrinker budget: oracle calls per anomaly (two greedy passes), and
#: the exact engine's per-call wall-clock budget.  The oracle runs on
#: an already-refuted per-key history, so calls are typically fast.
SHRINK_MAX_ATTEMPTS = 64
ORACLE_TIME_LIMIT_S = 10.0
ORACLE_MAX_CONFIGS = 2_000_000

#: Span-name prefixes that belong in the dossier's trace slice.
TRACE_PREFIXES = ("checker", "wgl", "checkerd", "lifecycle", "stream",
                  "settle")


def _fail_open(e: BaseException) -> None:
    """Re-raises a device fault; any other error is the caller's to
    log and step past."""
    if degrade.is_device_fault(e):
        raise e


# ---------------------------------------------------------------------------
# Anomaly discovery: walk the merged checker-results tree
# ---------------------------------------------------------------------------


_BAD = (False, "unknown")

#: Result keys that are attachments, not child checker results.
_SKIP_KEYS = frozenset((
    "resilience", "streaming", "forensics", "checkerd", "degradations",
    "results", "final-configs", "failures", "crashed-op", "key-results",
))


def _is_linearizable_result(node: dict) -> bool:
    """A leaf verdict from the linearizable checker (any tier)."""
    return "algorithm" in node or "final-configs" in node or (
        "configs-explored" in node
    )


def find_anomalies(results: Any, depth: int = 0) -> list[dict]:
    """Every bad verdict in a merged results tree, flattened to
    ``{"key", "result", "path"}`` entries.  Recognizes the independent
    checker's per-key shape (``results`` dict + ``key-count``), plain
    linearizable leaves, and Compose's named sub-dicts; bounded depth
    so a hostile results value cannot recurse forever."""
    out: list[dict] = []
    if not isinstance(results, dict) or depth > 6:
        return out
    if "key-count" in results and isinstance(results.get("results"), dict):
        for k, r in results["results"].items():
            if isinstance(r, dict) and r.get("valid") in _BAD:
                out.append({"key": k, "result": r, "path": "independent"})
        return out
    if results.get("valid") in _BAD and _is_linearizable_result(results):
        out.append({"key": None, "result": results, "path": "linearizable"})
        return out
    # Compose-style: named children that are themselves result dicts.
    for name, child in results.items():
        if name in _SKIP_KEYS or not isinstance(child, dict):
            continue
        if "valid" not in child:
            continue
        for entry in find_anomalies(child, depth + 1):
            entry["path"] = f"{name}.{entry['path']}"
            out.append(entry)
    return out


def _find_model(checker: Any, test: Optional[dict] = None) -> Any:
    """The model behind a checker tree: unwraps RemoteChecker.base,
    IndependentChecker.base, Compose children, down to a Linearizable's
    ``.model``; falls back to test["model"]."""
    seen: set[int] = set()
    stack = [checker]
    while stack:
        c = stack.pop()
        if c is None or id(c) in seen:
            continue
        seen.add(id(c))
        model = getattr(c, "model", None)
        if model is not None:
            return model
        for attr in ("base", "inner"):
            stack.append(getattr(c, attr, None))
        kids = getattr(c, "checkers", None)
        if isinstance(kids, dict):
            stack.extend(kids.values())
        elif isinstance(kids, (list, tuple)):
            stack.extend(kids)
    return (test or {}).get("model")


# ---------------------------------------------------------------------------
# Minimal counterexample: delta-debug with the exact CPU oracle
# ---------------------------------------------------------------------------


def _op_units(history: History) -> list[tuple]:
    """Groups a history into shrinkable units: one (invoke, completion)
    pair per finished op, a bare (invoke,) for unfinished ones.  Units
    are what the shrinker drops whole — removing an invocation but not
    its completion would fabricate histories no run could produce."""
    units: list[tuple] = []
    open_unit: dict[Any, int] = {}  # process -> index into units
    for op in history:
        if op.is_invoke:
            open_unit[op.process] = len(units)
            units.append((op,))
        else:
            i = open_unit.pop(op.process, None)
            if i is not None:
                units[i] = units[i] + (op,)
            # A completion with no pending invoke (trimmed window):
            # not a unit on its own; drop it from shrinking.
    return units


def _rebuild(units: tuple) -> History:
    ops = sorted((op for u in units for op in u), key=lambda o: o.index)
    return History(ops, reindex=False)


def _simplify_unit(unit: tuple):
    """Second shrink pass: forget an ok completion, making the op
    indeterminate.  That only ever *relaxes* the history (an
    indeterminate op may linearize anywhere or nowhere), so a history
    still refuted afterwards is a strictly stronger counterexample."""
    if len(unit) == 2 and unit[1].is_ok:
        return (unit[0],)
    return None


def minimize(history: History, model: Any, *,
             max_attempts: int = SHRINK_MAX_ATTEMPTS) -> Optional[dict]:
    """Delta-debugs `history` down to a minimal subhistory the exact
    CPU engine still refutes.  Returns ``{"history", "packed", "pm",
    "result", "original-op-count", "op-count", "attempts",
    "algorithm"}`` or None (with a logged reason) when the original is
    not oracle-refutable — e.g. the bad verdict was "unknown", or the
    model has no packed form."""
    from .checker.wgl_cpu import check_wgl_cpu
    from .checker.wgl_event import check_wgl_event
    from .nemesis.search import greedy_shrink

    try:
        pm = model.packed()
    except (NotImplementedError, AttributeError):
        log.info("forensics: model %r has no packed form; skipping "
                 "counterexample minimization", type(model).__name__)
        return None

    def oracle(h: History):
        """(WGLResult, packed, engine) via the exact host search —
        called directly (not through a Checker) so the shrinker's
        oracle is the engine itself, with a hard per-call budget."""
        packed = pack_history(h, pm.encode)
        if packed.n > packed.n_ok:
            res = check_wgl_event(
                packed, pm, max_configs=ORACLE_MAX_CONFIGS,
                time_limit_s=ORACLE_TIME_LIMIT_S)
            return res, packed, "event"
        res = check_wgl_cpu(
            packed, pm, max_configs=ORACLE_MAX_CONFIGS,
            time_limit_s=ORACLE_TIME_LIMIT_S)
        return res, packed, "wgl"

    try:
        res0, _, _ = oracle(history)
    except Exception as e:  # noqa: BLE001 — pack/encode may raise
        _fail_open(e)
        log.info("forensics: oracle failed on original history: %r", e)
        return None
    if res0.valid is not False:
        # An "unknown" or budget-blown verdict has no refutation to
        # shrink toward; the dossier still ships the death state.
        log.info("forensics: original history not refuted by exact "
                 "engine (valid=%r); no counterexample", res0.valid)
        return None

    units = _op_units(history)
    original_ops = len(history)

    def interesting(h: History) -> bool:
        try:
            res, _, _ = oracle(h)
        except Exception as e:  # noqa: BLE001 — a bad candidate is boring
            _fail_open(e)
            return False
        return res.valid is False

    with profile.capture("forensics-shrink", ops=original_ops,
                         units=len(units)) as cap:
        kept, attempts = greedy_shrink(
            units, _rebuild, interesting,
            simplify=_simplify_unit, max_attempts=max_attempts)
        cap.knob(max_attempts=max_attempts)
        cap.feature(attempts=attempts, kept_units=len(kept))
        minimal = _rebuild(kept)
        # One final oracle run over the artifact itself: the re-proof
        # the dossier's claims rest on, and the WGLResult linviz draws.
        res, packed, engine = oracle(minimal)
        if res.valid is not False:  # pragma: no cover — shrink invariant
            telemetry.count("forensics.shrink-failed")
            log.warning("forensics: shrunk history no longer refuted; "
                        "falling back to the original")
            minimal = history
            res, packed, engine = oracle(history)
        cap.outcome = res.valid
    telemetry.count("forensics.shrink-attempts", attempts)
    return {
        "history": minimal,
        "packed": packed,
        "pm": pm,
        "result": res,
        "original-op-count": original_ops,
        "op-count": len(minimal),
        "attempts": attempts,
        "algorithm": engine,
    }


# ---------------------------------------------------------------------------
# Anomaly signature: semantic content, not the tier that found it
# ---------------------------------------------------------------------------


def anomaly_signature(key: Any, result: dict,
                      crashed_desc: Optional[str] = None) -> str:
    """A short stable hash of *what* went wrong: the key, the verdict,
    the op the search died on, and any refutation screens — and
    deliberately NOT the algorithm/tier, so the same anomaly found by
    the streaming witness and the settle cohort maps to one coverage
    feature."""
    screens = sorted({
        c.get("screen") for c in result.get("final-configs") or ()
        if isinstance(c, dict) and c.get("screen")
    })
    if crashed_desc is None:
        crashed = result.get("crashed-op")
        if isinstance(crashed, dict):
            crashed_desc = crashed.get("op")
    payload = json.dumps({
        "key": repr(key),
        "valid": result.get("valid"),
        "crashed": crashed_desc,
        "screens": screens,
    }, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:12]


def window_fingerprint(sig: Any) -> str:
    """A short stable hash of a live fault window's coverage signature
    (nemesis.search.signature's feature frozenset): the label the
    monitor's fault-timeline panel and window dossiers carry, so two
    windows with the same observable outcome share one name."""
    payload = json.dumps(sorted(str(f) for f in sig or ()))
    return hashlib.sha256(payload.encode()).hexdigest()[:12]


# ---------------------------------------------------------------------------
# Nemesis correlation: fault windows vs violating op intervals
# ---------------------------------------------------------------------------


def _wall_anchor(test: dict) -> Optional[float]:
    """Wall-clock epoch of the run's t=0 (op times are ns since test
    start; the store stamps start-time with local time_str)."""
    st = (test or {}).get("start-time")
    if not st:
        return None
    try:
        return datetime.strptime(st, "%Y%m%dT%H%M%S.%f").timestamp()
    except ValueError:
        return None


def nemesis_correlation(test: dict, history: History,
                        directory: Optional[str] = None) -> dict:
    """Fault windows from the durable ledger that overlapped any of
    `history`'s invoke→return wall-clock intervals.  Advisory by
    design: an overlapping partition is the first suspect, not a
    conviction."""
    from .nemesis import ledger as fault_ledger

    d = directory
    if d is None:
        try:
            from . import store
            d = store.test_dir(test)
        except (ValueError, KeyError):
            return {"windows": [], "note": "no store dir"}
    path = fault_ledger.ledger_path(d)
    records = fault_ledger.read_records(path)
    if not records:
        return {"windows": [], "note": "no fault ledger"}
    anchor = _wall_anchor(test)
    if anchor is None:
        return {"windows": [], "note": "no start-time anchor"}

    healed_t = {r["id"]: r.get("t") for r in records
                if r.get("rec") == "healed"}
    windows = []
    for r in records:
        if r.get("rec") != "intent":
            continue
        windows.append({
            "id": r.get("id"),
            "fault": r.get("fault"),
            "nodes": r.get("nodes") or [],
            "params": r.get("params") or {},
            "t0": r.get("t"),
            "t1": healed_t.get(r.get("id")),  # None = never healed
        })

    intervals = []
    for inv, comp in _invoke_return_pairs(history):
        t0 = anchor + inv.time / 1e9
        t1 = anchor + comp.time / 1e9 if comp is not None else None
        intervals.append((t0, t1, inv))

    overlapping = []
    for w in windows:
        w0 = w["t0"] or 0.0
        w1 = w["t1"]
        hits = []
        for t0, t1, inv in intervals:
            lo = max(w0, t0)
            hi = min(w1 if w1 is not None else float("inf"),
                     t1 if t1 is not None else float("inf"))
            if lo <= hi:
                hits.append({"index": inv.index, "process": inv.process,
                             "f": str(inv.f)})
        if hits:
            overlapping.append({**w, "overlapping-ops": hits[:32],
                                "overlap-count": len(hits)})
    return {
        "windows": overlapping,
        "window-count": len(windows),
        "note": "advisory: fault windows overlapping violating ops' "
                "invoke-to-return wall intervals",
    }


def _invoke_return_pairs(history: History):
    pending: dict[Any, Any] = {}
    for op in history:
        if op.is_invoke:
            pending[op.process] = op
        else:
            inv = pending.pop(op.process, None)
            if inv is not None:
                yield inv, op
    for inv in pending.values():
        yield inv, None


# ---------------------------------------------------------------------------
# The dossier bundle
# ---------------------------------------------------------------------------


def _safe_key_dir(key: Any, used: set) -> str:
    safe = sanitize_path_part(key if key is not None else "history")[:80]
    if safe in used:
        digest = hashlib.sha1(repr(key).encode()).hexdigest()[:10]
        safe = f"{safe[:69]}-{digest}"
    used.add(safe)
    return safe


def _write_json(path: str, obj: Any, *, sort_keys: bool = True) -> int:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=sort_keys, default=repr)
        f.write("\n")
    return os.path.getsize(path)


def _trace_slice() -> list[dict]:
    try:
        trace = telemetry.chrome_trace()
    except Exception:  # noqa: BLE001 — trace is optional context
        return []
    evs = trace.get("traceEvents") or []
    return [e for e in evs
            if str(e.get("name", "")).startswith(TRACE_PREFIXES)]


def _profile_records() -> list[dict]:
    path = profile.store_path()
    if not path:
        return []
    tid = telemetry.trace_id()
    recs = profile.read(path)
    mine = [r for r in recs if r.get("trace_id") == tid]
    return mine if mine else recs[-64:]


def build_dossier(test: dict, key: Any, entry: dict, history: History,
                  directory: str, model: Any = None) -> Optional[dict]:
    """Assembles one anomaly's bundle under `directory` (the dossier
    dir itself, already unique per key).  Returns the summary dict for
    the manifest / results attachment, or None on failure."""
    result = entry["result"]
    os.makedirs(directory, exist_ok=True)
    files: dict[str, int] = {}
    summary: dict[str, Any] = {
        "key": repr(key) if key is not None else None,
        "verdict": result.get("valid"),
        "path": entry.get("path"),
        "dir": directory,
    }

    # 1. Minimal counterexample (refuted verdicts with a model only).
    mini = None
    if model is not None and result.get("valid") is False:
        try:
            mini = minimize(history, model)
        except Exception as e:  # noqa: BLE001 — fail-open
            _fail_open(e)
            telemetry.count("forensics.shrink-failed")
            log.warning("forensics: minimization failed for key %r",
                        key, exc_info=True)
    crashed_desc = None
    if mini is not None:
        res, packed, pm = mini["result"], mini["packed"], mini["pm"]
        a = res.crashed_at
        if a is not None and pm.describe_op is not None:
            crashed_desc = pm.describe_op(
                int(packed.f[a]), int(packed.a0[a]), int(packed.a1[a]))
        sig = anomaly_signature(key, result, crashed_desc)
        # Timestamp-free by contract: a checkerd verdict and an
        # in-process one over the same history write identical bytes.
        counterexample = {
            "key": repr(key) if key is not None else None,
            "signature": sig,
            "verdict": False,
            "original-op-count": mini["original-op-count"],
            "op-count": mini["op-count"],
            "attempts": mini["attempts"],
            "oracle": {
                "algorithm": mini["algorithm"],
                "configs-explored": int(res.configs_explored),
                "crashed-op": {
                    "history-index": (int(packed.src_index[a])
                                      if a is not None else None),
                    "op": crashed_desc,
                },
            },
            "ops": [o.to_dict() for o in mini["history"]],
        }
        p = os.path.join(directory, "counterexample.json")
        files["counterexample.json"] = _write_json(p, counterexample)
        with open(os.path.join(directory, "counterexample.txt"), "w",
                  errors="replace") as f:
            for o in mini["history"]:
                f.write(str(o) + "\n")
        files["counterexample.txt"] = os.path.getsize(
            os.path.join(directory, "counterexample.txt"))
        summary.update({
            "original-op-count": mini["original-op-count"],
            "op-count": mini["op-count"],
            "shrink-attempts": mini["attempts"],
        })
        # 2. The linviz death chart over the minimal history.
        try:
            from .checker.linviz import render_analysis
            svg = render_analysis(
                packed, pm, res, os.path.join(directory, "linear.svg"))
            if svg:
                files["linear.svg"] = os.path.getsize(svg)
        except Exception as e:  # noqa: BLE001
            _fail_open(e)
            log.warning("forensics: linviz render failed", exc_info=True)
    else:
        sig = anomaly_signature(key, result)

    summary["signature"] = sig

    # 3. Timeline of the per-key history, crashed op highlighted.
    try:
        from .checker import timeline as tl
        crashed = result.get("crashed-op") or {}
        highlight = crashed.get("history-index")
        if mini is not None:
            ce = counterexample["oracle"]["crashed-op"]
            highlight = ce.get("history-index", highlight)
        html_doc = tl.render(test, history, highlight=highlight)
        with open(os.path.join(directory, "timeline.html"), "w") as f:
            f.write(html_doc)
        files["timeline.html"] = os.path.getsize(
            os.path.join(directory, "timeline.html"))
    except Exception as e:  # noqa: BLE001
        _fail_open(e)
        log.warning("forensics: timeline render failed", exc_info=True)

    # 4. Death state: the verdict verbatim, plus how it was reached.
    death = {
        "result": result,
        "degradations": result.get("degradations"),
        "checkerd": result.get("checkerd"),
    }
    files["death.json"] = _write_json(
        os.path.join(directory, "death.json"), death)

    # 5-7. Cost records, trace slice, flight ring.
    files["profiles.json"] = _write_json(
        os.path.join(directory, "profiles.json"), _profile_records())
    files["trace-slice.json"] = _write_json(
        os.path.join(directory, "trace-slice.json"), _trace_slice())
    files["flight.json"] = _write_json(
        os.path.join(directory, "flight.json"), flight.events())

    # 8. Nemesis correlation over the (minimal, else full) history.
    try:
        corr = nemesis_correlation(
            test, mini["history"] if mini is not None else history)
    except Exception as e:  # noqa: BLE001
        _fail_open(e)
        corr = {"windows": [], "note": "correlation failed"}
    files["nemesis.json"] = _write_json(
        os.path.join(directory, "nemesis.json"), corr)
    if corr.get("windows"):
        summary["nemesis-windows"] = len(corr["windows"])

    # 9. Manifest last: its presence marks a complete dossier.  The
    # only timestamps in the bundle live here.
    manifest = dict(summary)
    manifest["files"] = files
    manifest["created-at"] = datetime.now().isoformat(timespec="seconds")
    _write_json(os.path.join(directory, "dossier.json"), manifest)
    return summary


def assemble(test: dict, results: dict, history: History,
             directory: str, checker: Any = None) -> Optional[dict]:
    """The analyze-time entry point: finds every anomaly in `results`,
    builds capped dossiers under ``<directory>/forensics/``, and
    returns the summary block `core.analyze` attaches as
    ``results["forensics"]`` (None when the run is clean)."""
    anomalies = find_anomalies(results)
    if not anomalies:
        return None
    telemetry.count("forensics.anomalies", len(anomalies))
    root = os.path.join(directory, FORENSICS_DIR)
    model = _find_model(checker, test)

    from .parallel.independent import subhistories
    subs = None
    dossiers: list[dict] = []
    skipped = 0
    used: set = set()
    with telemetry.span("forensics.assemble", anomalies=len(anomalies)):
        for entry in anomalies:
            if len(dossiers) >= MAX_DOSSIERS:
                skipped += 1
                continue
            key = entry["key"]
            if key is None:
                sub = history
            else:
                if subs is None:
                    sub = None
                    try:
                        subs = subhistories(history)
                    except Exception as e:  # noqa: BLE001
                        _fail_open(e)
                        subs = {}
                sub = subs.get(key)
                if sub is None:
                    skipped += 1
                    continue
            d = os.path.join(root, _safe_key_dir(key, used))
            try:
                summary = build_dossier(test, key, entry, sub, d,
                                        model=model)
            except Exception as e:  # noqa: BLE001 — fail-open per anomaly
                _fail_open(e)
                log.warning("forensics: dossier for key %r failed",
                            key, exc_info=True)
                summary = None
            if summary is not None:
                dossiers.append(summary)
                telemetry.count("forensics.dossiers")
                flight.note("forensics-dossier", key=repr(key),
                            signature=summary.get("signature"),
                            dir=d)
    if skipped:
        telemetry.count("forensics.skipped", skipped)
    return {
        "dir": root,
        "dossiers": dossiers,
        "anomaly-count": len(anomalies),
        "skipped": skipped,
    }
