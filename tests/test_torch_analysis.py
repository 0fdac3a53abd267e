"""The port's jepsenlint (jepsen_tpu_torch/analysis/) on the CPU.

* Every case of tests/test_analysis.py through the port
  (tests/torch_ported.py), but those `NOT_PORTED` names, each with the
  test below that replaces it.  The rewritten file lints its fixtures
  as `jepsen_tpu_torch/...` paths, which the port's rules scan.
* Parity: each kept rule's fixture linted by both packages gives the
  same findings (rule, severity, symbol, message; paths mapped, and the
  declared-namespace list the port's table changes).
* Torch fixtures for the translated device rules, the counters doc
  (doc/counters_torch.md), the port's own tree clean against its
  baseline, and the standalone entry point with nothing but the
  standard library importable.
"""

import os
import re
import subprocess
import sys
import textwrap

import pytest

from jepsen_tpu.analysis.core import lint_source as ref_lint_source
from jepsen_tpu_torch.analysis import core
from jepsen_tpu_torch.analysis.core import (RUNTIME_BUDGET_S, lint_source,
                                            load_modules, run_lint)
from jepsen_tpu_torch.analysis.rules import RULES, protocol

import torch_ported

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTED = torch_ported.load("test_analysis")

#: The cases of tests/test_analysis.py the port does not run, with the
#: reason and the test here that replaces each.
NOT_PORTED = {
    # The port traces no function (no torch.compile, torch.jit or CUDA
    # graph capture), so it drops device.host-sync-in-jit and
    # device.np-in-jit; test_dropped_jit_rules checks they are gone.
    "test_device_host_sync_in_jit_fires",
    # Reads the JAX package's doc/counters.md; the port's table is
    # doc/counters_torch.md (test_counters_doc_drift below).
    "test_counters_doc_drift",
}


@pytest.mark.parametrize("case", torch_ported.cases(PORTED, NOT_PORTED))
def test_analysis_cases_through_the_port(case, request):
    torch_ported.run(PORTED, case, request)


def test_not_ported_names_real_cases():
    names = set(torch_ported.cases(PORTED))
    assert NOT_PORTED <= names
    assert len(names - NOT_PORTED) == 52
    # The slow whole-repo gate is the one slow case; its twins are below.
    assert torch_ported.cases(PORTED, slow=True) == ["test_lint_repo_clean"]


def test_dropped_jit_rules():
    assert "device.host-sync-in-jit" not in RULES
    assert "device.np-in-jit" not in RULES
    found = lint_source(textwrap.dedent("""
        import jax
        import numpy as np

        @jax.jit
        def f(x):
            return np.sum(x).item()
    """))
    assert not {f.rule for f in found} & {"device.host-sync-in-jit",
                                         "device.np-in-jit"}


# --------------------------------------------------------------------------
# parity with the JAX package's analyser
# --------------------------------------------------------------------------

_LEDGER = """
def run_compensator(ctype, entry):
    if ctype == "known-undo":
        return
    raise ValueError(ctype)
"""

#: (name, rel, source, extra sources): every kept rule firing, and
#: clean counterparts, as tests/test_analysis.py writes them.
FIXTURES = [
    ("narrowing", "fixture.py", """
        import numpy as np

        def pack(ts):
            return ts.astype(np.int32)

        def pack2(ts):
            if ts.max() >= np.iinfo(np.int32).max:
                raise OverflowError("ts exceeds int32")
            return ts.astype(np.int16)

        def pack3(ts):
            return np.minimum(ts, 5).astype(np.uint8)
    """, {}),
    ("lock-order", "fixture.py", """
        import threading

        A = threading.Lock()
        B = threading.Lock()

        def one():
            with A:
                with B:
                    pass

        def two():
            with B:
                with A:
                    pass
    """, {}),
    ("thread-attr", "fixture.py", """
        import threading

        class Feed:
            def __init__(self):
                self.t = threading.Thread(target=self._loop)

            def _loop(self):
                self.n = 1

            def snapshot(self):
                return self.n
    """, {}),
    ("guarded-by", "fixture.py", """
        import threading

        class Router:
            def __init__(self):
                self._lock = threading.Lock()
                self._tickets = {}  # guarded-by: self._lock

            def get(self, t):
                return self._tickets.get(t)

        class Worker:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0
                threading.Thread(target=self._run, daemon=True).start()

            def _run(self):
                with self._lock:
                    self._n += 1

            def peek(self):
                return self._n
    """, {}),
    ("intent", "nemesis/fixture.py", """
        from . import ledger as fault_ledger

        class Nem:
            def invoke(self, test, op):
                self.sess.kill_daemon("db")
                fault_ledger.intent(test, "process")
                return op

            def heal(self, test, op):
                self.net.heal(test)
                return op
    """, {}),
    ("compensator", "nemesis/fixture.py", """
        def arm(test, led):
            led.intent(test, "process",
                       compensator={"type": "bogus-undo"})
            led.intent(test, "process",
                       compensator={"type": "known-undo"})
    """, {"nemesis/ledger.py": _LEDGER}),
    ("counters", "fixture.py", """
        from . import telemetry

        def work():
            telemetry.count("bogusns.thing")
            telemetry.count("wgl.fixture-ok")
            telemetry.span(f"nowhere.{work}")
    """, {}),
    ("fleet-prefix", "checkerd/fixture.py", """
        from .. import telemetry

        def work():
            telemetry.count("wgl.not-fleet")
            telemetry.count("checkerd.fine")
    """, {"telemetry/__init__.py":
          'FLEET_COUNTER_PREFIXES = ("checkerd.", "ingest.")\n'}),
    ("bypass", "fixture.py", """
        def run(checker, test, history):
            return checker.check(test, history, {})
    """, {}),
    ("teardown", "fixture.py", """
        class Thing:
            def teardown(self):
                try:
                    self.release()
                except Exception:
                    pass

            def close(self):
                try:
                    self.sock.close()
                except OSError:
                    pass
    """, {}),
    ("fsync", "fixture.py", """
        import os

        BLOCK_CHUNK = 3

        class Journal:
            def put(self, rec):
                self.writer.append(BLOCK_CHUNK, rec)
                self.writer.flush()

        class Server:
            def handle(self, sock, rec):
                self.writer.append(BLOCK_CHUNK, rec)
                sock.sendall(b"ok")
                self.writer.sync()

        def log(rec):
            with open("events.jsonl", "a") as f:
                f.write(rec)

        def log2(rec):
            with open("events2.jsonl", "a") as f:
                f.write(rec)
                f.flush()
                os.fsync(f.fileno())
    """, {}),
    ("torn-tail", "fixture.py", """
        def scan(f):
            rec = _read_block(f)
            return rec["t"]

        def scan2(f):
            rec = _read_block(f)
            if rec is None:
                return None
            return rec["t"]
    """, {}),
    ("checkpoint", "fixture.py", """
        import json

        def save(state):
            with open("state.json", "w") as f:
                json.dump(state, f)

        def load():
            with open("state.json") as f:
                return json.load(f)
    """, {}),
    ("block-ids", "fixture.py", """
        BLOCK_A = 1
        BLOCK_B = 1
        BLOCK_C = 7
    """, {"checkerd/protocol.py": "F_HELLO = 7\n"}),
    ("capture", "ops/fixture.py", """
        from ..telemetry import profile

        def search(xs):
            with profile.capture("witness"):
                for x in xs:
                    x.item()
    """, {}),
]


def _norm(text: str) -> str:
    """A message with its package paths and namespace list made
    comparable: the port's paths are the reference's under
    jepsen_tpu_torch/, and its declared namespaces differ (protocol.py
    says how)."""
    text = re.sub(r"\bjepsen_tpu\b(?!_torch)", "jepsen_tpu_torch", text)
    text = text.replace("doc/counters_torch.md ", "doc/counters.md ")
    text = re.sub(r"declared namespaces \([^)]*\)",
                  "declared namespaces (...)", text)
    return text


def _keys(findings):
    return sorted((f.rule, f.severity, f.symbol, _norm(f.message))
                  for f in findings)


@pytest.mark.parametrize("name,rel,src,extra", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_kept_rules_match_the_reference(name, rel, src, extra):
    src = textwrap.dedent(src)
    want = ref_lint_source(
        src, rel="jepsen_tpu/" + rel,
        extra={"jepsen_tpu/" + k: v for k, v in extra.items()})
    got = lint_source(
        src, rel="jepsen_tpu_torch/" + rel,
        extra={"jepsen_tpu_torch/" + k: v for k, v in extra.items()})
    # The jit rules are the only ones the port drops.
    want = [f for f in want if f.rule not in ("device.host-sync-in-jit",
                                              "device.np-in-jit")]
    assert want, name
    assert _keys(got) == _keys(want)


# --------------------------------------------------------------------------
# torch fixtures for the translated device rules
# --------------------------------------------------------------------------


def _rules(findings, rule=None):
    rules = [f.rule for f in findings]
    return rules if rule is None else [r for r in rules if r == rule]


@pytest.mark.parametrize("body,fires", [
    ("return x.to(torch.int32)", True),
    ("return x.to(dtype=torch.int16)", True),
    ("return x.to(x.device, torch.uint8)", True),
    ("return x.int()", True),
    ("return x.to(torch.int64)", False),
    ("return x.to(torch.float32)", False),
    ("return torch.clamp(x, max=INF).to(torch.int32)", False),
    ("return x.clamp(max=INF).to(torch.int32)", False),
    ("return torch.minimum(x, y).to(torch.int32)", False),
    ("return (x > 0).to(torch.int32)", False),
    ("return torch.searchsorted(x, y).to(torch.int32)", False),
    ("if int(x.max()) >= INF:\n"
     "        raise OverflowError('exceeds int32')\n"
     "    return x.to(torch.int32)", False),
])
def test_torch_narrowing(body, fires):
    src = ("import torch\n\nINF = 2**31 - 1\n\n\n"
           f"def pack(x, y=None):\n    {body}\n")
    found = _rules(lint_source(src), "device.unguarded-narrowing")
    assert bool(found) == fires


_CAPTURE = """
import torch

from .. import device as _device
from ..telemetry import profile


def search(xs, dev):
    with profile.capture("witness", device=dev):
        for x in xs:
            {sync}
"""


@pytest.mark.parametrize("sync,fires", [
    ("x.item()", True),
    ("x.tolist()", True),
    ("x.cpu()", True),
    ("x.numpy()", True),
    ("_device.host(x)", True),
    ("torch.cuda.synchronize()", True),
    ("y = x + 1", False),
    ("x.sum()", False),
])
def test_torch_host_sync_in_capture(sync, fires):
    found = lint_source(_CAPTURE.format(sync=sync),
                        rel="jepsen_tpu_torch/ops/fixture.py")
    assert bool(_rules(found, "device.host-sync-in-capture")) == fires


def test_host_sync_outside_a_loop_is_clean():
    found = lint_source(textwrap.dedent("""
        from ..telemetry import profile

        def search(x, dev):
            with profile.capture("witness", device=dev):
                return x.item()
    """), rel="jepsen_tpu_torch/ops/fixture.py")
    assert not _rules(found, "device.host-sync-in-capture")


_KERNELS_SRC = """
launches = {}


def witness_sweep(model, bars):
    launches["witness_sweep"] += 1


def sweep_lib():
    return None
"""


def _uncaptured(src, rel="jepsen_tpu_torch/ops/fixture.py", extra=None):
    found = lint_source(textwrap.dedent(src), rel=rel, extra=extra)
    return sorted(f.symbol for f in found
                  if f.rule == "device.uncaptured-device-call")


def test_kernel_launch_outside_a_capture_fires():
    src = """
        from . import kernels

        def sweep(bars):
            return kernels.witness_sweep(1, bars)
    """
    assert _uncaptured(src) == ["sweep"]
    # kernels.py in the batch names its wrappers: the launch still fires.
    assert _uncaptured(src, extra={
        "jepsen_tpu_torch/ops/kernels.py": _KERNELS_SRC}) == ["sweep"]


def test_kernel_launch_reached_only_under_a_capture_is_clean():
    assert _uncaptured("""
        from . import kernels
        from ..telemetry import profile

        def sweep(bars):
            return kernels.witness_sweep(1, bars)

        def check(bars, dev):
            with profile.capture("witness", device=dev):
                return sweep(bars)
    """) == []


@pytest.mark.parametrize("call,fires", [
    ("torch.cuda.synchronize()", True),
    ("_device.host(x)", True),
    ("x.cuda()", True),
    ("kernels.sweep_lib()", False),   # builds, launches nothing
    ("x.sum()", False),
])
def test_device_markers(call, fires):
    src = f"""
        import torch

        from . import kernels
        from .. import device as _device

        def step(x):
            return {call}
    """
    assert (_uncaptured(src, extra={
        "jepsen_tpu_torch/ops/kernels.py": _KERNELS_SRC}) == ["step"]) \
        == fires


def test_markers_outside_ops_and_streaming_are_not_flagged():
    assert _uncaptured("""
        import torch

        def step(x):
            torch.cuda.synchronize()
    """, rel="jepsen_tpu_torch/checker/fixture.py") == []


# --------------------------------------------------------------------------
# the port's tree, its counters doc, its entry points
# --------------------------------------------------------------------------


def test_counters_doc_drift():
    modules = load_modules(REPO)
    live = {e["name"] for e in protocol.scan_counters(modules)}
    with open(os.path.join(REPO, core.COUNTERS_DOC),
              encoding="utf-8") as f:
        documented = protocol.doc_counter_names(f.read())
    assert documented == live, (
        f"{core.COUNTERS_DOC} is stale — regenerate with "
        "`python -m jepsen_tpu_torch.analysis --write-counters`"
    )


def _check_repo_report(report):
    assert report.clean, [f.to_dict() for f in report.findings]
    assert not report.stale_baseline
    assert report.files > 100
    return report


def test_port_tree_is_clean_against_its_baseline():
    report = _check_repo_report(run_lint(REPO))
    baseline = core.load_baseline(core.baseline_path(REPO))
    assert len(report.baselined) == len(baseline)
    for e in baseline.values():
        just = e.get("justification") or ""
        assert just and "UNREVIEWED" not in just, e


@pytest.mark.slow
def test_port_tree_is_clean_within_its_budget():
    report = _check_repo_report(run_lint(REPO))
    assert report.duration_s < RUNTIME_BUDGET_S


def test_scan_set_and_defaults_are_the_ports():
    assert core.baseline_path("/r") == "/r/jepsen_tpu_torch/lint_baseline.json"
    assert core.SCAN_ROOTS == ("jepsen_tpu_torch", "chip_smoke.py")
    rels = {m.rel for m in load_modules(REPO)}
    assert "chip_smoke.py" in rels
    assert all(r == "chip_smoke.py" or r.startswith("jepsen_tpu_torch/")
               for r in rels)
    assert core.find_root(os.path.join(REPO, "jepsen_tpu_torch", "ops")) \
        == REPO


_BLOCKED = """
import runpy, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "numpy", "jax", "jaxlib",
                                  "jepsen_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.argv = ["jepsenlint"] + sys.argv[1:]
runpy.run_module("jepsen_tpu_torch.analysis", run_name="__main__")
"""


def _fixture_root(tmp_path, dirty: bool) -> str:
    pkg = tmp_path / "jepsen_tpu_torch"
    pkg.mkdir()
    body = ("    return x.to(torch.int32)\n" if dirty
            else "    return x.to(torch.int64)\n")
    (pkg / "fixture.py").write_text("import torch\n\n\ndef f(x):\n" + body)
    return str(tmp_path)


@pytest.mark.parametrize("dirty", [False, True])
def test_standalone_entry_needs_the_standard_library_alone(tmp_path, dirty):
    root = _fixture_root(tmp_path, dirty)
    store = tmp_path / "store"
    store.mkdir()
    r = subprocess.run(
        [sys.executable, "-c", _BLOCKED, "--root", root, "--json",
         "--lint-store-dir", str(store)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == (1 if dirty else 0), r.stderr
    assert '"clean": %s' % ("false" if dirty else "true") in r.stdout
    assert core.read_store_summary(str(store))["unbaselined"] == int(dirty)


def test_cli_lint_subcommand(tmp_path, capsys):
    from jepsen_tpu_torch import cli

    parser = cli.single_test_cmd(lambda opts: {})
    root = _fixture_root(tmp_path, dirty=True)
    assert cli.run(parser, ["lint", "--root", root,
                            "--lint-store-dir", str(tmp_path)]) == 1
    assert "device.unguarded-narrowing" in capsys.readouterr().out
    assert core.read_store_summary(str(tmp_path))["unbaselined"] == 1
