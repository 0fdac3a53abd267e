"""The device ladder and the checker: the port's `check_wgl_device` and
`Linearizable` against the JAX package's on the same histories
(verdict and result label parity; for the BFS the bar is the verdict:
its float32 dedup hashes are summed in another order than XLA's, so
when the beam overflows other children may fill it),
the import guard, and the no-CUDA behaviour of the entry points."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from jepsen_tpu.checker.linearizable import Linearizable as RefLinearizable
from jepsen_tpu.history.core import Op as RefOp
from jepsen_tpu.history.core import history as ref_history
from jepsen_tpu.history.packed import pack_history as ref_pack
from jepsen_tpu.models import cas_register as ref_cas_register
from jepsen_tpu.ops.wgl import check_wgl_device as ref_check_wgl_device
from jepsen_tpu.utils.histgen import random_register_history as ref_gen
from jepsen_tpu_torch.checker import Linearizable
from jepsen_tpu_torch.history.core import Op, history
from jepsen_tpu_torch.history.packed import pack_history
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.ops import degrade, wgl, wgl_witness
from jepsen_tpu_torch.ops.kernels import KernelLaunchError
from jepsen_tpu_torch.ops.wgl import check_wgl_device, nonzero_static
from jepsen_tpu_torch.ops.wgl_witness import check_wgl_witness
from jepsen_tpu_torch.utils.histgen import random_register_history

# Two concurrent writes, then reads of 1 and then 2: not linearizable
# (w2 must precede the read of 1), yet no refutation screen fires —
# the verdict has to come from the frontier BFS.
BFS_INVALID = [
    dict(type="invoke", f="write", value=1, process=0),
    dict(type="invoke", f="write", value=2, process=1),
    dict(type="ok", f="write", value=1, process=0),
    dict(type="ok", f="write", value=2, process=1),
    dict(type="invoke", f="read", value=None, process=2),
    dict(type="ok", f="read", value=1, process=2),
    dict(type="invoke", f="read", value=None, process=2),
    dict(type="ok", f="read", value=2, process=2),
]


@pytest.fixture(autouse=True)
def _one_thread():
    """The parity cases run the CPU device search under a checker
    budget: one torch thread.  With the default eight, six test workers
    oversubscribe the cores, and the port's 96-op invalid check took
    128.9 s under the tier-1 run's load (past its 120 s budget, so
    "unknown" where the reference said False) against ~1-2 s alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: One model per package for the device-search tests: the JAX package
#: caches compiled programs by the model's step function.  Both sides
#: pack the same histories in the same order, so the interners agree.
REF_PM, PM = ref_cas_register().packed(), cas_register().packed()


def _gen(n, info, procs, seed, bad=False):
    kw = dict(procs=procs, info_rate=info, seed=seed, bad=bad)
    return ref_gen(n, **kw), random_register_history(n, **kw)


def _lit(ops):
    return (ref_history([RefOp(**o) for o in ops]),
            history([Op(**o) for o in ops]))


HISTORIES = {
    "valid": lambda: _gen(200, 0.1, 6, 31),
    "valid-cas": lambda: _gen(200, 0.0, 4, 32),
    "invalid-end": lambda: _gen(96, 0.05, 4, 13, bad=True),
    "bfs-invalid": lambda: _lit(BFS_INVALID),
}


@pytest.mark.parametrize("name", sorted(HISTORIES))
@pytest.mark.parametrize("witness", [True, False])
def test_check_wgl_device_parity(name, witness):
    ref_h, h = HISTORIES[name]()
    a = ref_check_wgl_device(ref_pack(ref_h, REF_PM.encode), REF_PM,
                             witness=witness, time_limit_s=120)
    b = check_wgl_device(pack_history(h, PM.encode), PM, witness=witness,
                         time_limit_s=120, device="cpu")
    assert a.valid == b.valid
    assert b.valid == (name.startswith("valid"))


def test_check_wgl_device_beam_doubling():
    """A start beam too narrow for the frontier must retry wider and
    reach the same verdict (small beams are bucketed to 256, so use a
    wide concurrent history)."""
    ref_h, h = _gen(120, 0.3, 16, 7, bad=True)
    a = ref_check_wgl_device(ref_pack(ref_h, REF_PM.encode), REF_PM,
                             witness=False, beam=256, max_beam=1024)
    b = check_wgl_device(pack_history(h, PM.encode), PM, witness=False,
                         beam=256, max_beam=1024, device="cpu")
    assert a.valid == b.valid


@pytest.mark.parametrize("name,want_valid,want_algorithm", [
    ("valid", True, "wgl-tpu"),
    ("invalid-end", False, "refute-screen"),
    ("bfs-invalid", False, "wgl-tpu+cpu-report"),
])
@pytest.mark.parametrize("algorithm", ["wgl-tpu", "competition"])
def test_linearizable_parity(name, want_valid, want_algorithm, algorithm):
    ref_h, h = HISTORIES[name]()
    a = RefLinearizable(ref_cas_register(), algorithm).check({}, ref_h, {})
    b = Linearizable(cas_register(), algorithm, device="cpu").check({}, h, {})
    assert (b["valid"], b["algorithm"]) == (a["valid"], a["algorithm"])
    assert (b["valid"], b["algorithm"]) == (want_valid, want_algorithm)
    if want_valid is False:
        assert b.get("crashed-op") == a.get("crashed-op")


@pytest.mark.parametrize("algorithm", ["wgl", "event"])
def test_linearizable_cpu_engines_parity(algorithm):
    for name in ("valid", "bfs-invalid"):
        ref_h, h = HISTORIES[name]()
        a = RefLinearizable(ref_cas_register(), algorithm).check({}, ref_h, {})
        b = Linearizable(cas_register(), algorithm,
                         device="cpu").check({}, h, {})
        assert (b["valid"], b["algorithm"]) == (a["valid"], a["algorithm"])


def test_linearizable_rejects_unknown_algorithm():
    with pytest.raises(ValueError, match="algorithm"):
        Linearizable(cas_register(), "no-such-engine")


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pm = cas_register().packed()
    h = random_register_history(64, procs=4, info_rate=0.0, seed=1)
    packed = pack_history(h, pm.encode)
    with pytest.raises(RuntimeError, match="CUDA"):
        check_wgl_witness(packed, pm)
    with pytest.raises(RuntimeError, match="CUDA"):
        check_wgl_device(packed, pm)
    with pytest.raises(RuntimeError, match="CUDA"):
        Linearizable(cas_register()).check({}, h, {})
    # The CPU runs only when asked for.
    assert Linearizable(cas_register(), device="cpu").check(
        {}, h, {})["valid"] is True


def test_resource_errors():
    assert degrade.is_resource_error(torch.cuda.OutOfMemoryError("x"))
    assert degrade.is_resource_error(
        RuntimeError("CUDA error: out of memory"))
    assert degrade.is_resource_error(MemoryError())
    assert not degrade.is_resource_error(
        RuntimeError("witness_sweep launch failed: invalid argument (1)"))
    with degrade.capture() as outer:
        with degrade.capture() as inner:
            degrade.record("dispatch", "retry-halved", MemoryError("m"))
        assert inner == [{"tier": "dispatch", "action": "retry-halved",
                          "error": "MemoryError: m"}]
    assert outer == inner


def test_kernel_launch_error_is_never_a_resource_error():
    """CUDA names cudaErrorMemoryAllocation "out of memory", and a sticky
    error from an earlier call can read the same: a failed launch must
    still fail the run, not step down the ladder."""
    e = KernelLaunchError("witness_sweep launch failed: out of memory (2)")
    assert not degrade.is_resource_error(e)


def test_kernel_launch_error_propagates_through_the_checker(monkeypatch):
    def failing_sweep(*a, **kw):
        raise KernelLaunchError(
            "witness_sweep launch failed: out of memory (2)")

    monkeypatch.setattr(wgl_witness, "sweep", failing_sweep)
    _, h = HISTORIES["valid"]()
    with pytest.raises(KernelLaunchError):
        Linearizable(cas_register(), device="cpu").check({}, h, {})


def test_resource_error_retries_halved_on_the_device_then_raises(
        monkeypatch):
    """One out-of-memory error retries the device search at half size on
    the same device; a second raises instead of settling the verdict on
    the CPU engines."""
    real = wgl.check_wgl_device
    calls = []

    def once(packed, pm, **kw):
        calls.append((kw["beam"], kw["device"]))
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real(packed, pm, **kw)

    monkeypatch.setattr(wgl, "check_wgl_device", once)
    _, h = HISTORIES["valid"]()
    out = Linearizable(cas_register(), device="cpu").check({}, h, {})
    assert (out["valid"], out["algorithm"]) == (True, "wgl-tpu")
    assert [s["action"] for s in out["degradations"]] == ["retry-halved"]
    assert calls == [(1024, torch.device("cpu")), (512, torch.device("cpu"))]

    def always(packed, pm, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(wgl, "check_wgl_device", always)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        Linearizable(cas_register(), device="cpu").check({}, h, {})


@pytest.mark.parametrize("size", [1, 5, 8, 20])
def test_nonzero_static_pads_like_jnp(size):
    import jax.numpy as jnp
    import numpy as np

    mask = np.random.default_rng(size).random(12) < 0.4
    want = np.asarray(jnp.nonzero(mask, size=size, fill_value=0)[0])
    got = nonzero_static(torch.from_numpy(mask), size, 0)
    assert np.array_equal(got.numpy(), want)


def test_import_guard_no_jax_no_reference_package():
    """Importing every module of the port, and loading its ssh and scp
    shims and its tools/port_fault_matrix.py and tools/port_soak.py,
    with jax blocked loads neither jax nor any jepsen_tpu module."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib"):
                    raise ImportError("jax is blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import jepsen_tpu_torch
        names = set()
        for m in pkgutil.walk_packages(jepsen_tpu_torch.__path__,
                                       "jepsen_tpu_torch."):
            importlib.import_module(m.name)
            names.add(m.name)
        want = {"jepsen_tpu_torch." + n for n in (
            "ops.packing", "telemetry", "telemetry.profile", "store.format",
            "plan",
            "plan.ir", "plan.costmodel", "plan.cache", "plan.executor",
            "plan.compiler", "telemetry.flight", "telemetry.slo",
            "telemetry.timeseries", "telemetry.roofline", "checkerd",
            "checkerd.protocol", "checkerd.journal", "checkerd.overload",
            "checkerd.scheduler", "checkerd.server", "checkerd.client",
            "checkerd.__main__", "utils", "generator", "generator.context",
            "generator.core", "generator.independent", "generator.testkit",
            "client", "net", "control", "control.core", "control.remotes",
            "control.health", "db", "oses", "nemesis", "nemesis.core",
            "nemesis.ledger", "interpreter", "store", "checker.core",
            "checker.timeline", "core", "cli", "workloads",
            "workloads.linearizable_register", "workloads.append",
            "workloads.__main__", "control.util", "nemesis.faults",
            "nemesis.combined", "nemesis.membership", "demo", "suites",
            "suites._common", "suites.kvdb", "suites.logd", "suites.txnd",
            "suites.repkv", "suites.electd", "forensics", "checker.linviz",
            "nemesis.search", "fs_cache", "reconnect", "faketime", "lazyfs",
            "checker.clock", "checker.perf", "history.fold", "codec",
            "report", "control.minissh", "control.minissh.transport",
            "control.minissh.scp", "control.minissh.client",
            "control.minissh.server", "control.netns", "streaming.remote",
            "checkerd.router", "nemesis.selfchaos", "monitor",
            "monitor.rolling", "monitor.alerts", "monitor.retention",
            "monitor.loop", "monitor.live", "monitor.fleet", "web",
            "repl")}
        assert want <= names, sorted(want - names)
        # The ssh and scp shims, loaded as modules (not run).
        import os, runpy
        from jepsen_tpu_torch.control import minissh
        for shim in ("ssh", "scp"):
            g = runpy.run_path(os.path.join(minissh.BIN_DIR, shim),
                               run_name="shim")
            assert callable(g["main"]), shim
        # The port's robustness tools, loaded as modules (not run).
        for tool in ("port_fault_matrix", "port_soak"):
            g = runpy.run_path(os.path.join("tools", tool + ".py"),
                               run_name="tool")
            assert callable(g["main"]), tool
        bad = sorted(n for n in sys.modules
                     if n.split(".")[0] in ("jax", "jaxlib", "jepsen_tpu"))
        assert not bad, bad
        print("ok")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
