"""Jepsen turned on its own checker fleet: self-chaos for checkerd.

The port's copy of `jepsen_tpu/nemesis/selfchaos.py`.  Its fleet's
daemons are the port's (`python -m jepsen_tpu_torch.checkerd.server`),
each checking on the fleet's `device`: the fleet resolves it once in
this process (`device.resolve`, "cuda" by default) and hands the
resolved name to every child as `--device`, so a child never picks a
device of its own, and one that cannot reach its card raises at start.
On the card the fleet builds the sweep kernel before its first child
starts, so the children load one library instead of each compiling
it.  Each child's output goes to `<workdir>/<name>.log`; a child that
exits while the fleet counts it up is reported by `dead_children()`,
and `run_chaos` counts a fault it could not inject or heal as a
violation instead of logging it.

The nemesis-search machinery (nemesis/search.py) fuzzes *databases
under test*; this module points the same discipline at the verification
infrastructure itself.  A **chaos schedule** — a seeded, timed sequence
of fault events against a router + N-daemon fleet — is compiled
deterministically (`compile_schedule`), injected against live child
processes while multi-tenant load runs (`run_chaos`), and the fleet's
own behavior is recorded as a Jepsen history (`ChaosHistory`) whose
invariants `check_invariants` verifies:

  * **exactly-one-verdict** — every acked TICKET eventually yields a
    verdict, and every verdict observed for a ticket is byte-identical
    (journal replays and router failovers may recompute it, but per-key
    verdicts are deterministic, so the digests must agree);
  * **honest sheds** — an admission refusal is a structured F_SHED with
    a positive retry-after, never a hang and never an ERROR-shaped
    silent drop;
  * **fairness** — a whale tenant saturating its queue must not push a
    light tenant's queue-wait p95 beyond the DRR starvation bound.

Fault families (each deterministic given the schedule seed):

  * ``daemon-kill``   — SIGKILL a daemon; restart on its --queue
                        journal after `duration` (replay must cover
                        every acked ticket).
  * ``daemon-pause``  — SIGSTOP / SIGCONT (a slow, not dead, peer).
  * ``router-kill``   — SIGKILL the router; restart on its journal.
  * ``partition``     — the daemon's FlakyProxy drops connections.
  * ``slow-peer``     — the proxy delays every forwarded chunk.
  * ``journal-tear``  — garbage appended to a (killed) daemon's queue
                        file; reopen must truncate the torn tail.
  * ``disk-full``     — journal appends fail with ENOSPC via the
                        ``JEPSEN_QUEUE_FAULT`` file: indirection
                        (checkerd/journal.py) — degraded durability,
                        never a crash.
  * ``brownout``      — a forced brownout level via the
                        ``JEPSEN_BROWNOUT_FORCE`` file: indirection
                        (checkerd/overload.py) — optional plan passes
                        drop, verdicts stay sound.

Chaos telemetry lives in the ``chaos.*`` namespace (declared in
analysis/rules/protocol.py).  ``tools/chaos_smoke.py`` wires a small
schedule into CI.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import random
import signal
import socket
import socketserver
import subprocess
import sys
import threading
import time
from typing import Any, Optional, Sequence

from .. import device as _device
from .. import telemetry
from .ledger import FaultLedger

log = logging.getLogger(__name__)

#: Every injectable fault family.  `daemon-*`, `partition`, `slow-peer`
#: and `journal-tear`/`disk-full` target one daemon; `router-kill`
#: targets the router; `brownout` targets one daemon's controller.
FAMILIES = (
    "daemon-kill",
    "daemon-pause",
    "router-kill",
    "partition",
    "slow-peer",
    "journal-tear",
    "disk-full",
    "brownout",
)

#: Faults that require the target daemon to be down while they apply
#: (tearing a live daemon's journal races its own appends).
_NEEDS_DOWN = frozenset({"journal-tear"})


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChaosFault:
    """One timed fault: inject at `t`, heal at `t + duration_s`.
    `target` is a daemon index, or -1 for the router.  `salt` seeds the
    event's private RNG (Random(schedule.seed ^ salt)), the same
    determinism contract as nemesis-search events."""

    family: str
    t: float
    duration_s: float
    target: int
    salt: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """A seeded fault timeline against an n-daemon fleet."""

    seed: int
    duration_s: float
    faults: tuple

    def to_dict(self) -> dict:
        return {
            "seed": self.seed,
            "duration-s": self.duration_s,
            "faults": [f.to_dict() for f in self.faults],
        }


def compile_schedule(
    seed: int,
    *,
    n_daemons: int,
    duration_s: float = 20.0,
    n_faults: int = 4,
    families: Sequence[str] = FAMILIES,
) -> ChaosSchedule:
    """Compiles a deterministic schedule: same seed, same timeline.
    Fault times land in the middle 70% of the window so load exists on
    both sides of every injection; durations are bounded so every fault
    heals before the run ends."""
    rng = random.Random(seed)
    faults = []
    for _ in range(n_faults):
        family = rng.choice(list(families))
        t = rng.uniform(0.15, 0.7) * duration_s
        dur = rng.uniform(0.1, 0.25) * duration_s
        if family == "router-kill":
            target = -1
        else:
            target = rng.randrange(max(1, n_daemons))
        faults.append(ChaosFault(
            family=family, t=round(t, 3), duration_s=round(dur, 3),
            target=target, salt=rng.getrandbits(32),
        ))
    faults.sort(key=lambda f: (f.t, f.salt))
    return ChaosSchedule(seed=seed, duration_s=float(duration_s),
                         faults=tuple(faults))


# ---------------------------------------------------------------------------
# The fleet history + invariants
# ---------------------------------------------------------------------------


def verdict_digest(result: dict) -> str:
    """Canonical digest of a verdict's observable content.  Meta
    (spans, pids, addresses) varies across replays by design; validity
    and per-key results must not."""
    krs = result.get("key-results")
    core = {"valid": result.get("valid"), "key-results": krs}
    blob = json.dumps(core, sort_keys=True, separators=(",", ":"),
                      default=repr)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


class ChaosHistory:
    """Thread-safe record of the fleet's observable behavior: acks,
    verdicts, sheds, errors, fault injections — the Jepsen history the
    invariant checker runs over."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ops: list[dict] = []
        self._t0 = time.monotonic()

    def record(self, type: str, **fields: Any) -> None:  # noqa: A002
        op = {"t": round(time.monotonic() - self._t0, 4), "type": type}
        op.update(fields)
        with self._lock:
            self._ops.append(op)
        telemetry.count(f"chaos.op.{type}")

    def ops(self, type: Optional[str] = None) -> list[dict]:  # noqa: A002
        with self._lock:
            if type is None:
                return list(self._ops)
            return [o for o in self._ops if o["type"] == type]

    def stats(self) -> dict:
        with self._lock:
            kinds: dict[str, int] = {}
            for o in self._ops:
                kinds[o["type"]] = kinds.get(o["type"], 0) + 1
            return {"ops": len(self._ops), "kinds": kinds}


def check_invariants(
    history: ChaosHistory,
    *,
    fairness_bound_s: Optional[float] = None,
    light_tenant: Optional[str] = None,
) -> list[str]:
    """Verifies the fleet invariants over a chaos history; returns a
    list of violation strings (empty = the fleet held).  Counted under
    ``chaos.invariant-violation``."""
    violations: list[str] = []

    acked: dict[str, dict] = {}
    verdicts: dict[str, list[dict]] = {}
    for op in history.ops("ack"):
        t = op.get("ticket")
        if t:
            acked[t] = op
    for op in history.ops("verdict"):
        t = op.get("ticket")
        if t:
            verdicts.setdefault(t, []).append(op)

    # 1. Exactly-one-verdict: every acked ticket produced a verdict...
    for t, op in sorted(acked.items()):
        if t not in verdicts:
            violations.append(
                f"lost-verdict: ticket {t} (tenant "
                f"{op.get('tenant')!r}) was acked at t={op['t']} but "
                f"never yielded a verdict"
            )
    # ...and every verdict observed for a ticket is byte-identical.
    for t, vs in sorted(verdicts.items()):
        digests = {v.get("digest") for v in vs}
        if len(digests) > 1:
            violations.append(
                f"replay-divergence: ticket {t} yielded "
                f"{len(digests)} distinct verdict digests {sorted(digests)}"
            )

    # 2. Honest sheds: structured retry-after, always positive.
    for op in history.ops("shed"):
        ra = op.get("retry_after_s")
        if not isinstance(ra, (int, float)) or ra <= 0:
            violations.append(
                f"dishonest-shed: shed at t={op['t']} (tenant "
                f"{op.get('tenant')!r}) carried retry-after {ra!r}"
            )

    # 3. Fairness: the light tenant's queue-wait p95 under the bound.
    if fairness_bound_s is not None and light_tenant is not None:
        waits = sorted(
            op["wait_s"] for op in history.ops("verdict")
            if op.get("tenant") == light_tenant
            and isinstance(op.get("wait_s"), (int, float))
        )
        if waits:
            import math

            p95 = waits[min(len(waits) - 1,
                            int(math.ceil(0.95 * len(waits))) - 1)]
            if p95 > fairness_bound_s:
                violations.append(
                    f"unfair: light tenant {light_tenant!r} queue-wait "
                    f"p95 {p95:.3f}s exceeds the fairness bound "
                    f"{fairness_bound_s:.3f}s"
                )
    for v in violations:
        telemetry.count("chaos.invariant-violation")
        log.warning("chaos invariant violation: %s", v)
    return violations


# ---------------------------------------------------------------------------
# The socket shim: partitions and slow peers without netns privileges
# ---------------------------------------------------------------------------


class FlakyProxy:
    """A TCP forwarder in front of one daemon.  Modes: ``ok`` forwards
    transparently; ``drop`` refuses new connections and severs live
    ones (a partition); ``slow`` delays every forwarded chunk (a slow
    peer).  The router is pointed at proxy addresses, so flipping a
    mode partitions exactly one router->daemon edge."""

    def __init__(self, backend: str, host: str = "127.0.0.1"):
        self.backend = backend
        self.mode = "ok"
        self.delay_s = 0.0
        self._conns: list[socket.socket] = []
        self._lock = threading.Lock()
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                outer._handle(self.request)

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = _Server((host, 0), _Handler)
        self.addr = "%s:%d" % self._srv.server_address[:2]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="flaky-proxy",
            daemon=True,
        )
        self._thread.start()

    def set_mode(self, mode: str, delay_s: float = 0.0) -> None:
        self.mode = mode
        self.delay_s = delay_s
        telemetry.count(f"chaos.proxy.{mode}")
        if mode == "drop":
            with self._lock:
                conns, self._conns = self._conns, []
            for s in conns:
                try:
                    s.close()
                except OSError:
                    pass

    def _handle(self, client: socket.socket) -> None:
        if self.mode == "drop":
            client.close()
            return
        from ..checkerd.protocol import parse_addr

        try:
            up = socket.create_connection(parse_addr(self.backend),
                                          timeout=5.0)
        except OSError:
            client.close()
            return
        with self._lock:
            self._conns += [client, up]

        def pump(src: socket.socket, dst: socket.socket) -> None:
            try:
                while True:
                    data = src.recv(65536)
                    if not data:
                        break
                    if self.mode == "drop":
                        break
                    if self.mode == "slow" and self.delay_s > 0:
                        time.sleep(self.delay_s)
                    dst.sendall(data)
            except OSError:
                pass
            finally:
                for s in (src, dst):
                    try:
                        s.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    try:
                        s.close()
                    except OSError:
                        pass

        t = threading.Thread(target=pump, args=(up, client), daemon=True)
        t.start()
        pump(client, up)
        t.join(timeout=5.0)

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self.set_mode("drop")


# ---------------------------------------------------------------------------
# The fleet under test: router + N daemons as child processes
# ---------------------------------------------------------------------------


#: The lowest port `_free_port` hands out.
MIN_PORT = 10_000

_ports_lock = threading.Lock()
_ports_given: set[int] = set()


def _ephemeral_low() -> int:
    """The first port of the kernel's ephemeral range (Linux's default
    where the host does not say)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def _free_port() -> int:
    """A port nothing is bound to, below the kernel's ephemeral range.
    A port from bind(0) lies inside that range, so while its child is
    down (a killed daemon) the kernel may give it to any outgoing
    connection on the host as its local port, and the restarted child's
    bind then fails with EADDRINUSE for as long as that socket or its
    TIME_WAIT lives.  Below the range the kernel never picks it.  A port
    is handed out once per process."""
    low = _ephemeral_low()
    rng = random.SystemRandom()
    for _ in range(256 if low > MIN_PORT + 1024 else 0):
        port = rng.randrange(MIN_PORT, low)
        with _ports_lock:
            if port in _ports_given:
                continue
            with socket.socket() as s:
                try:
                    s.bind(("127.0.0.1", port))
                except OSError:
                    continue
            _ports_given.add(port)
            return port
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: How long a child daemon or router may take to listen: a daemon on the
#: card starts its interpreter, imports torch and runs its card check.
START_TIMEOUT_S = 60.0


def _wait_listening(addr: str, timeout_s: float = START_TIMEOUT_S,
                    proc: Optional[subprocess.Popen] = None,
                    log_path: Optional[str] = None) -> None:
    """Waits for `addr` to accept a connection; raises at once if the
    child `proc` exits first (its log's tail in the message)."""
    from ..checkerd.protocol import parse_addr

    host, port = parse_addr(addr)
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(
                f"child for {addr} exited {proc.returncode} before "
                f"listening: {_tail(log_path)}")
        try:
            with socket.create_connection((host, port), timeout=1.0):
                return
        except OSError:
            time.sleep(0.1)
    raise TimeoutError(f"{addr} not listening after {timeout_s}s")


def spawn_child(args: list, env: dict, log_path: str) -> subprocess.Popen:
    """Starts `args` with its output appended to `log_path` and no
    stdin."""
    with open(log_path, "ab") as out:
        return subprocess.Popen(args, env=env, stdout=out,
                                stderr=subprocess.STDOUT,
                                stdin=subprocess.DEVNULL)


def stop_children(procs: list, timeout_s: float = 10.0) -> None:
    """SIGTERMs every child in `procs`, then SIGKILLs each one that has
    not exited within `timeout_s`."""
    for p in procs:
        try:
            p.terminate()
        except OSError as e:
            log.debug("terminate of pid %s failed: %r", p.pid, e)
    for p in procs:
        try:
            p.wait(timeout=timeout_s)
        except (subprocess.TimeoutExpired, OSError):
            try:
                p.kill()
                p.wait(timeout=timeout_s)
            except (subprocess.TimeoutExpired, OSError) as e:
                log.debug("kill of pid %s failed: %r", p.pid, e)


def _tail(path: Optional[str], n: int = 2000) -> str:
    if not path:
        return ""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - n))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


class ChaosFleet:
    """A router + N checkerd daemons, each a child process on its own
    --queue journal, each daemon fronted by a FlakyProxy the router
    dials through.  All fault injectors live here so a schedule event
    maps to one method call."""

    def __init__(self, n_daemons: int, workdir: str, *,
                 tenant_weights: Optional[dict[str, float]] = None,
                 batch_window_s: float = 0.02,
                 metrics: bool = False,
                 device: Any = "cuda"):
        #: The daemons' device, resolved here and passed to every child
        #: by name (raises DeviceUnavailable for "cuda" without a card).
        self.device = str(_device.resolve(device))
        self.workdir = workdir
        self.n = n_daemons
        self.batch_window_s = batch_window_s
        self.tenant_weights = dict(tenant_weights or {})
        os.makedirs(workdir, exist_ok=True)
        self.daemon_ports = [_free_port() for _ in range(n_daemons)]
        self.metrics_ports = [_free_port() if metrics else -1
                              for _ in range(n_daemons)]
        self.router_port = _free_port()
        self.daemons: list[Optional[subprocess.Popen]] = [None] * n_daemons
        self.paused = [False] * n_daemons
        self.router: Optional[subprocess.Popen] = None
        self.proxies: list[FlakyProxy] = []
        for i in range(n_daemons):
            self.proxies.append(
                FlakyProxy(f"127.0.0.1:{self.daemon_ports[i]}"))
        # Same intent/healed ledger discipline as the real nemesis: a
        # crashed chaos harness leaves an auditable record of which
        # faults are still outstanding (a SIGSTOPped daemon, a dropped
        # proxy edge) instead of a mystery-wedged fleet.
        self.ledger = FaultLedger(os.path.join(workdir, "chaos.ledger"))
        self._ledger_ids: dict[tuple[str, int, int], int] = {}

    # -- paths & env ---------------------------------------------------------

    def daemon_addr(self, i: int) -> str:
        return f"127.0.0.1:{self.daemon_ports[i]}"

    @property
    def router_addr(self) -> str:
        return f"127.0.0.1:{self.router_port}"

    def _queue_path(self, i: int) -> str:
        return os.path.join(self.workdir, f"d{i}.queue")

    def _diskfull_path(self, i: int) -> str:
        return os.path.join(self.workdir, f"d{i}.diskfull")

    def _brownout_path(self, i: int) -> str:
        return os.path.join(self.workdir, f"d{i}.brownout")

    def _log_path(self, name: str) -> str:
        return os.path.join(self.workdir, f"{name}.log")

    def _daemon_env(self, i: int) -> dict:
        from ..checkerd import journal, overload

        env = dict(os.environ)
        env[journal.FAULT_ENV] = "file:" + self._diskfull_path(i)
        env[overload.FORCE_ENV] = "file:" + self._brownout_path(i)
        return env

    def _spawn(self, args: list, env: dict, name: str) -> subprocess.Popen:
        return spawn_child(args, env, self._log_path(name))

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self.device.startswith("cuda"):
            # One build in this process before any child starts: the
            # children then load the built library (kernels.py writes
            # it by an atomic rename) instead of each compiling it.
            from ..ops import kernels

            kernels.sweep_lib()
        # The daemons start together (each imports torch and checks its
        # card), then the router.
        for i in range(self.n):
            self.start_daemon(i, wait=False)
        for i in range(self.n):
            self._wait_daemon(i)
        self.start_router()

    def start_daemon(self, i: int, wait: bool = True) -> None:
        args = [
            sys.executable, "-m", "jepsen_tpu_torch.checkerd.server",
            "--host", "127.0.0.1", "--port", str(self.daemon_ports[i]),
            "--device", self.device,
            "--batch-window", str(self.batch_window_s),
            "--metrics-port", str(self.metrics_ports[i]),
            "--queue", self._queue_path(i),
        ]
        for t, w in sorted(self.tenant_weights.items()):
            args += ["--tenant-weight", f"{t}={w}"]
        self.daemons[i] = self._spawn(args, self._daemon_env(i), f"d{i}")
        self.paused[i] = False
        if wait:
            self._wait_daemon(i)

    def _wait_daemon(self, i: int) -> None:
        _wait_listening(self.daemon_addr(i), proc=self.daemons[i],
                        log_path=self._log_path(f"d{i}"))

    def start_router(self) -> None:
        args = [
            sys.executable, "-m", "jepsen_tpu_torch.checkerd.router",
            "--host", "127.0.0.1", "--port", str(self.router_port),
            "--metrics-port", "-1",
            "--probe-interval", "0.5",
            "--queue", os.path.join(self.workdir, "router.queue"),
        ]
        for p in self.proxies:
            args += ["--daemon", p.addr]
        self.router = self._spawn(args, dict(os.environ), "router")
        _wait_listening(self.router_addr, proc=self.router,
                        log_path=self._log_path("router"))

    def dead_children(self) -> list[str]:
        """The children that exited while the fleet counts them up (a
        daemon or router the harness killed is not counted up), each
        with its exit code and log tail."""
        out = []
        named = [(f"d{i}", p) for i, p in enumerate(self.daemons)]
        named.append(("router", self.router))
        for name, p in named:
            if p is not None and p.poll() is not None:
                out.append(f"{name} exited {p.returncode}: "
                           f"{_tail(self._log_path(name), 600)}")
        return out

    def stop(self) -> None:
        procs = [p for p in self.daemons if p is not None]
        if self.router is not None:
            procs.append(self.router)
        for i, p in enumerate(self.daemons):
            if p is not None and self.paused[i]:
                try:
                    p.send_signal(signal.SIGCONT)
                except OSError as e:
                    log.debug("SIGCONT to daemon %d failed: %r", i, e)
        stop_children(procs)
        for px in self.proxies:
            px.close()
        # Teardown heals everything by construction (every child is
        # dead, every proxy closed) — mark any outstanding intents so a
        # post-run ledger audit shows a clean fleet.
        self.ledger.heal_matching(by="fleet-stop")

    # -- fault injectors -----------------------------------------------------

    def kill_daemon(self, i: int) -> None:
        p = self.daemons[i]
        if p is None:
            return
        telemetry.count("chaos.inject.daemon-kill")
        p.kill()
        p.wait(timeout=10)
        self.daemons[i] = None

    def restart_daemon(self, i: int) -> None:
        if self.daemons[i] is None:
            telemetry.count("chaos.heal.daemon-restart")
            self.start_daemon(i)

    def pause_daemon(self, i: int) -> None:
        p = self.daemons[i]
        if p is None or self.paused[i]:
            return
        telemetry.count("chaos.inject.daemon-pause")
        p.send_signal(signal.SIGSTOP)
        self.paused[i] = True

    def resume_daemon(self, i: int) -> None:
        p = self.daemons[i]
        if p is None or not self.paused[i]:
            return
        telemetry.count("chaos.heal.daemon-resume")
        p.send_signal(signal.SIGCONT)
        self.paused[i] = False

    def kill_router(self) -> None:
        if self.router is None:
            return
        telemetry.count("chaos.inject.router-kill")
        self.router.kill()
        self.router.wait(timeout=10)
        self.router = None

    def restart_router(self) -> None:
        if self.router is None:
            telemetry.count("chaos.heal.router-restart")
            self.start_router()

    def partition(self, i: int) -> None:
        telemetry.count("chaos.inject.partition")
        self.proxies[i].set_mode("drop")

    def slow_peer(self, i: int, delay_s: float = 0.05) -> None:
        telemetry.count("chaos.inject.slow-peer")
        self.proxies[i].set_mode("slow", delay_s=delay_s)

    def heal_proxy(self, i: int) -> None:
        telemetry.count("chaos.heal.proxy")
        self.proxies[i].set_mode("ok")

    def tear_journal(self, i: int) -> None:
        """Appends a torn frame to the daemon's queue journal.  Only
        meaningful while the daemon is down (its reopen must truncate);
        a live daemon is killed first — the schedule compiler pairs
        this family with a restart heal."""
        if self.daemons[i] is not None:
            self.kill_daemon(i)
        telemetry.count("chaos.inject.journal-tear")
        try:
            with open(self._queue_path(i), "ab") as f:
                f.write(b"\x13\x00\x00\x00torn-by-selfchaos")
        except OSError as e:
            log.warning("journal tear on daemon %d failed: %r", i, e)

    def set_disk_full(self, i: int, on: bool) -> None:
        telemetry.count("chaos.inject.disk-full" if on
                        else "chaos.heal.disk-full")
        path = self._diskfull_path(i)
        if on:
            with open(path, "w", encoding="utf-8") as f:
                f.write("enospc")
        else:
            try:
                os.unlink(path)
            except OSError:
                pass

    def set_brownout(self, i: int, level: int) -> None:
        telemetry.count("chaos.inject.brownout" if level
                        else "chaos.heal.brownout")
        path = self._brownout_path(i)
        if level:
            with open(path, "w", encoding="utf-8") as f:
                f.write(str(int(level)))
        else:
            try:
                os.unlink(path)
            except OSError:
                pass

    # -- schedule application ------------------------------------------------

    def inject(self, fault: ChaosFault,
               rng: Optional[random.Random] = None) -> None:
        if fault.family not in FAMILIES:
            raise ValueError(f"unknown chaos family {fault.family!r}")
        rng = rng or random.Random(fault.salt)
        # Journal intent BEFORE touching the fleet: the append+fsync
        # must land first so a crash between journal and injection errs
        # toward a spurious (idempotent) heal replay, never a stranded
        # fault — the same contract as nemesis/faults.py.
        eid = self.ledger.intent(
            fault.family,
            nodes=["router" if fault.target < 0 else f"d{fault.target}"],
            params={"t": round(fault.t, 3),
                    "duration-s": round(fault.duration_s, 3)},
            compensator={"type": f"chaos-heal:{fault.family}",
                         "target": fault.target},
            tag=f"salt-{fault.salt}",
        )
        self._ledger_ids[(fault.family, fault.target, fault.salt)] = eid
        i = fault.target
        if fault.family == "daemon-kill":
            self.kill_daemon(i)
        elif fault.family == "daemon-pause":
            self.pause_daemon(i)
        elif fault.family == "router-kill":
            self.kill_router()
        elif fault.family == "partition":
            self.partition(i)
        elif fault.family == "slow-peer":
            self.slow_peer(i, delay_s=rng.uniform(0.02, 0.1))
        elif fault.family == "journal-tear":
            self.tear_journal(i)
        elif fault.family == "disk-full":
            self.set_disk_full(i, True)
        elif fault.family == "brownout":
            self.set_brownout(i, 1 + rng.randrange(2))
        else:
            raise ValueError(f"unknown chaos family {fault.family!r}")

    def heal(self, fault: ChaosFault) -> None:
        i = fault.target
        if fault.family in ("daemon-kill", "journal-tear"):
            self.restart_daemon(i)
        elif fault.family == "daemon-pause":
            self.resume_daemon(i)
        elif fault.family == "router-kill":
            self.restart_router()
        elif fault.family in ("partition", "slow-peer"):
            self.heal_proxy(i)
        elif fault.family == "disk-full":
            self.set_disk_full(i, False)
        elif fault.family == "brownout":
            self.set_brownout(i, 0)
        # Healed lands AFTER the compensator succeeds, never before.
        eid = self._ledger_ids.pop(
            (fault.family, fault.target, fault.salt), None)
        if eid is not None:
            self.ledger.healed(eid, by="chaos-heal")


# ---------------------------------------------------------------------------
# Multi-tenant load
# ---------------------------------------------------------------------------


def _register_ops(rng: random.Random, n_pairs: int) -> list[dict]:
    """A valid single-key register history as op dicts (write x, read
    x) — always linearizable, so every verdict is deterministic-valid
    and replay digests are comparable."""
    ops = []
    i = 0
    for _ in range(n_pairs):
        v = rng.randrange(1000)
        for f, typ, val in (("write", "invoke", v), ("write", "ok", v),
                            ("read", "invoke", None), ("read", "ok", v)):
            ops.append({"index": i, "time": i, "type": typ,
                        "process": 0, "f": f, "value": val})
            i += 1
    return ops


class TenantLoad(threading.Thread):
    """One tenant's closed-loop submit/poll worker against the router.
    Each iteration submits a small register history with a deadline,
    records ack/shed, polls to the verdict, and records its digest and
    queue wait into the shared ChaosHistory."""

    def __init__(self, tenant: str, router_addr: str,
                 history: ChaosHistory, stop: threading.Event, *,
                 seed: int, n_keys: int = 2, pairs_per_key: int = 4,
                 deadline_s: float = 30.0, think_s: float = 0.05):
        super().__init__(name=f"load-{tenant}", daemon=True)
        self.tenant = tenant
        self.router_addr = router_addr
        self.history = history
        self.stop_evt = stop
        self.rng = random.Random(seed)
        self.n_keys = n_keys
        self.pairs_per_key = pairs_per_key
        self.deadline_s = deadline_s
        self.think_s = think_s
        self.submitted = 0

    def run(self) -> None:
        from ..checkerd.client import (
            CheckerdClient,
            RemoteUnavailable,
            ShedByServer,
        )

        spec = {"type": "register", "value": None}
        while not self.stop_evt.is_set():
            subs = [_register_ops(self.rng, self.pairs_per_key)
                    for _ in range(self.n_keys)]
            run = f"{self.tenant}-{self.submitted}"
            self.submitted += 1
            t_submit = time.monotonic()
            try:
                with CheckerdClient(self.router_addr,
                                    connect_timeout=2.0,
                                    io_timeout=30.0) as c:
                    try:
                        ticket = c.submit_ops(
                            run, spec, subs, tenant=self.tenant,
                            deadline_s=self.deadline_s,
                        )
                    except ShedByServer as e:
                        self.history.record(
                            "shed", tenant=self.tenant, run=run,
                            retry_after_s=e.retry_after_s,
                            reason=e.shed.reason,
                        )
                        self.stop_evt.wait(
                            min(e.retry_after_s, 0.5))
                        continue
                    self.history.record("ack", tenant=self.tenant,
                                        run=run, ticket=ticket)
                    self._poll(c, ticket, t_submit)
            except RemoteUnavailable as e:
                self.history.record("error", tenant=self.tenant,
                                    run=run, error=str(e))
                self.stop_evt.wait(0.2)
            self.stop_evt.wait(self.think_s)

    def _poll(self, c: Any, ticket: str, t_submit: float) -> None:
        """Polls on the submitting connection until RESULT; on a dead
        connection, re-polls the router on fresh connections — an acked
        ticket is chased until the harness stops, because losing it IS
        the bug we're hunting."""
        from ..checkerd.client import CheckerdClient, RemoteUnavailable
        from ..checkerd.protocol import F_PENDING, F_RESULT

        own: Optional[Any] = None  # replacement client we must close
        try:
            while not self.stop_evt.is_set():
                try:
                    ftype, payload = c.poll(ticket)
                except RemoteUnavailable:
                    if own is not None:
                        own.close()
                        own = None
                    try:
                        c = own = CheckerdClient(self.router_addr,
                                                 connect_timeout=2.0,
                                                 io_timeout=30.0)
                    except RemoteUnavailable:
                        self.stop_evt.wait(0.3)
                    continue
                if ftype == F_RESULT:
                    self.history.record(
                        "verdict", tenant=self.tenant, ticket=ticket,
                        digest=verdict_digest(payload),
                        valid=payload.get("valid"),
                        wait_s=round(time.monotonic() - t_submit, 4),
                    )
                    return
                if ftype != F_PENDING:
                    self.history.record("error", tenant=self.tenant,
                                        ticket=ticket,
                                        error=f"frame {ftype}")
                    return
                self.stop_evt.wait(0.05)
        finally:
            if own is not None:
                own.close()


def chase_outstanding(history: ChaosHistory, router_addr: str,
                      timeout_s: float = 30.0) -> None:
    """After the load stops, polls every acked-but-unverdicted ticket
    until it resolves or the timeout expires — the exactly-one-verdict
    invariant is about *eventual* delivery through faults, so the
    harness gives the healed fleet a bounded grace window."""
    from ..checkerd.client import CheckerdClient, RemoteUnavailable
    from ..checkerd.protocol import F_PENDING, F_RESULT

    outstanding = {
        op["ticket"]: op for op in history.ops("ack")
        if op.get("ticket")
    }
    for op in history.ops("verdict"):
        outstanding.pop(op.get("ticket"), None)
    t0 = time.monotonic()
    while outstanding and time.monotonic() - t0 < timeout_s:
        for ticket, op in list(outstanding.items()):
            try:
                with CheckerdClient(router_addr, connect_timeout=2.0,
                                    io_timeout=10.0) as c:
                    ftype, payload = c.poll(ticket)
            except RemoteUnavailable:
                time.sleep(0.3)
                continue
            if ftype == F_RESULT:
                history.record(
                    "verdict", tenant=op.get("tenant"), ticket=ticket,
                    digest=verdict_digest(payload),
                    valid=payload.get("valid"), wait_s=None,
                )
                del outstanding[ticket]
            elif ftype != F_PENDING:
                # A hard ERROR for an acked ticket is a loss; leave it
                # outstanding so check_invariants flags it.
                time.sleep(0.2)
        time.sleep(0.1)


def replay_check(history: ChaosHistory, router_addr: str,
                 n: int = 3) -> list[str]:
    """Re-polls the last n verdicts on fresh connections and compares
    digests — replayed results must be byte-identical to what clients
    first observed (router journal + result TTL make this answerable)."""
    from ..checkerd.client import CheckerdClient, RemoteUnavailable
    from ..checkerd.protocol import F_RESULT

    divergent: list[str] = []
    seen = history.ops("verdict")[-n:]
    for op in seen:
        ticket = op.get("ticket")
        if not ticket:
            continue
        try:
            with CheckerdClient(router_addr, connect_timeout=2.0,
                                io_timeout=10.0) as c:
                ftype, payload = c.poll(ticket)
        except RemoteUnavailable:
            continue
        if ftype != F_RESULT:
            continue
        d = verdict_digest(payload)
        history.record("verdict", tenant=op.get("tenant"),
                       ticket=ticket, digest=d,
                       valid=payload.get("valid"), wait_s=None)
        if d != op.get("digest"):
            divergent.append(ticket)
    return divergent


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------


def run_chaos(
    schedule: ChaosSchedule,
    *,
    n_daemons: int = 2,
    workdir: str,
    tenants: Sequence[str] = ("alpha", "beta", "gamma"),
    tenant_weights: Optional[dict[str, float]] = None,
    whale: Optional[str] = None,
    light: Optional[str] = None,
    fairness_bound_s: Optional[float] = None,
    settle_s: float = 10.0,
    device: Any = "cuda",
) -> dict:
    """Runs one chaos schedule against a fresh fleet on `device` under
    multi-tenant load; returns the outcome dict (history stats,
    violations, fault log).  The whale tenant (when named) submits
    bigger histories with no think time — the saturation source the
    fairness invariant measures against.  A fault the fleet could not
    inject or heal, and a child that died on its own, are violations."""
    telemetry.count("chaos.run")
    fleet = ChaosFleet(n_daemons, workdir,
                       tenant_weights=tenant_weights, device=device)
    fault_errors: list[str] = []
    history = ChaosHistory()
    stop = threading.Event()
    loads: list[TenantLoad] = []
    fault_log: list[dict] = []
    try:
        fleet.start()
        for k, tenant in enumerate(tenants):
            is_whale = tenant == whale
            loads.append(TenantLoad(
                tenant, fleet.router_addr, history, stop,
                seed=schedule.seed ^ (0x9E3779B9 * (k + 1)),
                n_keys=6 if is_whale else 2,
                pairs_per_key=24 if is_whale else 4,
                think_s=0.0 if is_whale else 0.05,
            ))
        for ld in loads:
            ld.start()

        t0 = time.monotonic()
        pending_heals: list[tuple[float, ChaosFault]] = []
        events = list(schedule.faults)
        while time.monotonic() - t0 < schedule.duration_s:
            now = time.monotonic() - t0
            while events and events[0].t <= now:
                f = events.pop(0)
                rng = random.Random(schedule.seed ^ f.salt)
                log.info("chaos inject: %s target=%d t=%.2f",
                         f.family, f.target, now)
                history.record("inject", family=f.family,
                               target=f.target)
                fault_log.append({"family": f.family,
                                  "target": f.target,
                                  "t": round(now, 3)})
                try:
                    fleet.inject(f, rng)
                except Exception as e:  # noqa: BLE001 — keep running
                    log.warning("inject %s failed: %r", f.family, e)
                    fault_errors.append(f"inject {f.family}: {e!r}")
                pending_heals.append((f.t + f.duration_s, f))
                pending_heals.sort(key=lambda e: e[0])
            while pending_heals and pending_heals[0][0] <= now:
                _, f = pending_heals.pop(0)
                log.info("chaos heal: %s target=%d t=%.2f",
                         f.family, f.target, now)
                history.record("heal", family=f.family,
                               target=f.target)
                try:
                    fleet.heal(f)
                except Exception as e:  # noqa: BLE001
                    log.warning("heal %s failed: %r", f.family, e)
                    fault_errors.append(f"heal {f.family}: {e!r}")
            time.sleep(0.02)

        # Heal everything still open, stop the load, then chase every
        # acked ticket to its verdict through the healed fleet.
        for _, f in pending_heals:
            history.record("heal", family=f.family, target=f.target)
            try:
                fleet.heal(f)
            except Exception as e:  # noqa: BLE001
                log.warning("final heal %s failed: %r", f.family, e)
                fault_errors.append(f"final heal {f.family}: {e!r}")
        stop.set()
        for ld in loads:
            ld.join(timeout=30.0)
        stop.clear()
        chase_outstanding(history, fleet.router_addr,
                          timeout_s=settle_s)
        divergent = replay_check(history, fleet.router_addr)
        died = fleet.dead_children()
    finally:
        stop.set()
        fleet.stop()

    violations = check_invariants(
        history, fairness_bound_s=fairness_bound_s, light_tenant=light,
    )
    for t in divergent:
        violations.append(f"replay-divergence: ticket {t} re-polled to "
                          f"a different digest")
    violations += [f"fault-error: {e}" for e in fault_errors]
    violations += [f"child-died: {d}" for d in died]
    st = history.stats()
    return {
        "schedule": schedule.to_dict(),
        "faults-injected": fault_log,
        "history": st,
        "submitted": sum(ld.submitted for ld in loads),
        "violations": violations,
        "valid": not violations,
    }
