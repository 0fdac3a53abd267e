"""libfaketime wrappers: per-node clock rates for DB binaries.

Equivalent of jepsen/src/jepsen/faketime.clj (:24-47):
instead of skewing the system clock (clock nemesis), wrap a DB binary
in a shell script that runs it under `faketime` with an initial offset
and a rate multiplier, so different nodes experience time passing at
different speeds.  `wrap` moves the real binary aside idempotently;
`unwrap` restores it.
"""

from __future__ import annotations

import logging
import random
from typing import Optional

from .control import Session

log = logging.getLogger(__name__)

#: Suffix for the displaced original binary (faketime.clj:37-47).
REAL_SUFFIX = ".no-faketime"


def script(cmd: str, init_offset: float = 0, rate: float = 1.0) -> str:
    """A sh script invoking cmd under faketime (faketime.clj:24-35)."""
    sign = "-" if init_offset < 0 else "+"
    return (
        "#!/bin/bash\n"
        f'faketime -m -f "{sign}{abs(int(init_offset))}s x{float(rate)}" '
        f'{cmd} "$@"\n'
    )


def install(sess: Session) -> None:
    """Installs the faketime binary (the reference builds a patched
    0.9.6 fork; distribution packages are fine for the rate/offset
    features we use)."""
    with sess.su():
        sess.exec_star(
            "env", "DEBIAN_FRONTEND=noninteractive",
            "apt-get", "install", "-y", "faketime",
        )


def _exists(sess: Session, path: str) -> bool:
    return sess.exec_star("test", "-e", path).get("exit") == 0


def wrap(sess: Session, cmd: str, init_offset: float = 0,
         rate: float = 1.0) -> None:
    """Replaces `cmd` with a faketime wrapper, moving the original to
    cmd.no-faketime.  Idempotent (faketime.clj:37-47): re-wrapping just
    rewrites the wrapper script."""
    real = cmd + REAL_SUFFIX
    if not _exists(sess, real):
        sess.exec("mv", cmd, real)
    sess.exec("tee", cmd, stdin=script(real, init_offset, rate))
    sess.exec("chmod", "a+x", cmd)


def unwrap(sess: Session, cmd: str) -> None:
    """Restores the original binary if wrapped (faketime.clj:49-55)."""
    real = cmd + REAL_SUFFIX
    if _exists(sess, real):
        sess.exec("mv", real, cmd)


def rand_factor(factor: float, rng: Optional[random.Random] = None) -> float:
    """A rate drawn around 1 such that max/min = factor
    (faketime.clj:57-66)."""
    rng = rng or random
    hi = 2 / (1 + 1 / factor)
    lo = hi / factor
    return lo + rng.random() * (hi - lo)


def available(sess: Session) -> bool:
    """Whether the faketime binary exists on a node.  Dummy remotes
    return empty output for everything, which reads as absent — the
    nemesis then skips the node cleanly."""
    res = sess.exec_star("sh", "-c", "command -v faketime >/dev/null "
                                     "2>&1 && echo yes")
    return "yes" in (res.get("out") or "")


def faketime_package(opts: dict) -> Optional[dict]:
    """Nemesis package ({"faults": {"faketime", ...}}): wraps the DB
    binary named by opts["faketime"]["binary"] so its processes see
    time passing at a different rate per node, and unwraps it on heal.
    Capability-guarded twice: without a configured binary the package
    is skipped entirely (returns None), and a node without the
    faketime executable is skipped at invoke time.

    The wrap takes effect when the DB next (re)starts the binary —
    compose it with the kill fault for a mid-run rate change.  Every
    wrap journals a fault-ledger intent whose ``faketime-unwrap``
    compensator is data-replayable, so `jepsen repair` can restore the
    displaced binary after a control-plane crash."""
    faults = opts.get("faults") or set()
    if "faketime" not in faults:
        return None
    fopts = opts.get("faketime") or {}
    cmd = fopts.get("binary")
    if not cmd:
        return None
    from .control import on_nodes
    from .generator.core import cycle, sleep as gen_sleep
    from .history import Op
    from .nemesis import ledger as fault_ledger
    from .nemesis.core import Nemesis
    from .nemesis.faults import _pick_nodes

    factor = float(fopts.get("factor", 5.0))

    class FaketimeNemesis(Nemesis):
        def invoke(self, test: dict, op: Op) -> Op:
            if op.f == "start-faketime":
                v = op.value if isinstance(op.value, dict) else {}
                nodes = _pick_nodes(test, v.get("nodes"))
                rate = float(v.get("rate") or rand_factor(factor))
                fault_ledger.intent(
                    test, "process", nodes=[str(n) for n in nodes],
                    params={"f": "faketime", "cmd": cmd, "rate": rate},
                    compensator={"type": "faketime-unwrap", "cmd": cmd,
                                 "nodes": [str(n) for n in nodes]},
                    tag="faketime",
                )

                def act(sess: Session, node: str):
                    if not available(sess):
                        return "skipped: no faketime binary"
                    with sess.su():
                        wrap(sess, cmd, rate=rate)
                    return {"wrapped": cmd, "rate": rate}

                return op.replace(value=on_nodes(test, act, nodes))
            if op.f == "stop-faketime":
                if fault_ledger.heal_guard():
                    return op.replace(value="heal abandoned")

                def undo(sess: Session, node: str):
                    with sess.su():
                        unwrap(sess, cmd)
                    return "unwrapped"

                nodes = _pick_nodes(test, op.value)
                res = on_nodes(test, undo, nodes)
                fault_ledger.healed(test, tag="faketime")
                return op.replace(value=res)
            raise ValueError(f"unknown faketime f {op.f!r}")

        def teardown(self, test: dict) -> None:
            if fault_ledger.heal_guard():
                return
            try:
                on_nodes(
                    test,
                    lambda sess, node: unwrap(sess, cmd),
                    list((test.get("sessions") or {}).keys()),
                )
                fault_ledger.healed(test, tag="faketime", by="teardown")
            except Exception:  # noqa: BLE001 — ledger keeps the record
                log.warning("faketime teardown unwrap failed; entries "
                            "stay outstanding for jepsen repair",
                            exc_info=True)

        def fs(self) -> set:
            return {"start-faketime", "stop-faketime"}

    interval = opts.get("interval", 10.0)
    return {
        "nemesis": FaketimeNemesis(),
        "generator": cycle([
            gen_sleep(interval),
            {"type": "info", "f": "start-faketime", "value": None},
            gen_sleep(interval),
            {"type": "info", "f": "stop-faketime", "value": None},
        ]),
        "final-generator": {"type": "info", "f": "stop-faketime",
                            "value": None},
        "perf": [{"name": "faketime", "start": {"start-faketime"},
                  "stop": {"stop-faketime"}}],
    }
