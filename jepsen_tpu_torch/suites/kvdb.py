"""End-to-end suite for kvdb, the demo C++ key-value store.

The port's copy of `jepsen_tpu/suites/kvdb.py`.  Its CLI takes the
port's `--device cuda|cpu` (default cuda) in place of `--platform`,
resolves it before the first op, and runs every checker it builds
there; its subcommands are the port's `cli.py`'s: test, test-all,
analyze and repair.

The canonical whole-framework exercise, shaped like the reference's
zookeeper suite (zookeeper/src/jepsen/zookeeper.clj:
DB reify :40-73, client :79-110, test assembly :112-137, CLI main
:139-145): the DB is *compiled from source on the node* through the
control plane (the reference compiles C helpers on nodes the same way,
nemesis/time.clj:21-40), started as a pidfile daemon, killed and
restarted by the nemesis, and talked to over TCP.

Runs against any Remote.  The default local topology maps each logical
node to its own port + data dir on this machine (LocalRemote) — the
single-machine analog of the reference's docker compose cluster
(docker/README.md) — so the whole suite works with zero external
infrastructure.  Point it at real hosts over ssh and the same code
deploys there.
"""

from __future__ import annotations

import os
import random
import socket
import time
from typing import Any, Optional

from .. import client as jc
from .. import db as jdb
from .. import cli as jcli
from .. import demo as _demo
from ..checker import core as chk
from ..checker.linearizable import linearizable
from ..checker.timeline import Timeline
from ..control import Session
from ..control import util as cutil
from ..generator.core import FnGen, mix, repeat, stagger, time_limit, until_ok
from ..generator import nemesis as gen_nemesis
from ..history import FAIL, INFO, OK, Op
from ..models import cas_register
from ..nemesis.combined import nemesis_package

#: Repo-relative source of the system under test.
KVDB_SRC = _demo.source("kvdb")

BASE_PORT = 7400


def _derived_base(test: dict, key: str, fallback: int) -> int:
    """Per-run base port: explicit test[key] wins; else derive
    from the store dir via the shared hashed_base_port formula
    (stable per run, distinct across concurrent runs, below the
    Linux ephemeral range — round 5: two builders sharing a
    BASE_PORT constant convicted a healthy run)."""
    explicit = test.get(key)
    if explicit is not None:
        return explicit
    seed = test.get("store-dir")
    if not seed:
        return fallback
    return cutil.hashed_base_port(seed, fallback)


def node_port(test: dict, node: str) -> int:
    """Local topology: each node gets its own port in a per-run range
    derived from the store dir, so concurrent runs on one machine don't
    collide; real clusters use one port everywhere (test["kvdb-port"])."""
    nodes = test.get("nodes") or []
    if test.get("kvdb-local", True):
        return _derived_base(test, "kvdb-base-port",
                             BASE_PORT) + 1 + nodes.index(node)
    return test.get("kvdb-port", BASE_PORT)


def node_dir(test: dict, node: str) -> str:
    root = test.get("kvdb-dir", "/tmp/jepsen-kvdb")
    return f"{root}/{node}"


class KvdbDB(jdb.DB):
    """Install-from-source lifecycle (zookeeper.clj:40-73 shape)."""

    def _paths(self, test: dict, node: str) -> dict:
        d = node_dir(test, node)
        return {
            "dir": d,
            "src": f"{d}/kvdb.cpp",
            "bin": f"{d}/kvdb",
            "data": f"{d}/data.log",
            "pid": f"{d}/kvdb.pid",
            "log": f"{d}/kvdb.log",
        }

    def setup(self, test: dict, sess: Session, node: str) -> None:
        p = self._paths(test, node)
        sess.exec("mkdir", "-p", p["dir"])
        sess.upload(os.path.abspath(KVDB_SRC), p["src"])
        # Compile on the node, like the reference compiles its C
        # helpers there.
        sess.exec("g++", "-O2", "-pthread", "-o", p["bin"], p["src"])
        # An interrupted earlier run leaks its daemon; a stale server
        # on our port serves foreign data -> false convictions
        # (grepkill! on setup, control/util.clj pattern).
        cutil.grepkill(sess, f"kvdb --port {node_port(test, node)} ")
        # Retry the start+probe cycle: a slow bind or a daemon that
        # died on startup gets two more attempts before db.cycle pays
        # for a full teardown+setup.
        cutil.retrying_daemon_start(
            sess, lambda: self.start(test, sess, node),
            node_port(test, node), await_timeout_s=10, interval_s=0.1,
        )

    def start(self, test: dict, sess: Session, node: str) -> None:
        p = self._paths(test, node)
        args = [
            "--port", str(node_port(test, node)),
            "--data", p["data"],
        ]
        if not test.get("kvdb-local", True):
            args += ["--listen", "0.0.0.0"]
        if test.get("kvdb-fsync", True):
            args.append("--fsync")
        buf = test.get("kvdb-buffer", 0)
        if buf:
            args += ["--buffer", str(buf)]
        cutil.start_daemon(
            sess, p["bin"], *args, pidfile=p["pid"], logfile=p["log"]
        )
        try:
            cutil.await_tcp_port(
                sess, node_port(test, node), timeout_s=10, interval_s=0.05
            )
        except Exception:  # noqa: BLE001 — nemesis may restart a paused
            pass           # node; callers treat readiness as best-effort

    def kill(self, test: dict, sess: Session, node: str) -> None:
        p = self._paths(test, node)
        cutil.stop_daemon(sess, p["pid"], signal="KILL")

    def pause(self, test: dict, sess: Session, node: str) -> None:
        p = self._paths(test, node)
        sess.exec_star("bash", "-c", f"kill -STOP $(cat {p['pid']})")

    def resume(self, test: dict, sess: Session, node: str) -> None:
        p = self._paths(test, node)
        sess.exec_star("bash", "-c", f"kill -CONT $(cat {p['pid']})")

    def teardown(self, test: dict, sess: Session, node: str) -> None:
        p = self._paths(test, node)
        cutil.stop_daemon(sess, p["pid"])
        if not test.get("leave-db-running"):
            sess.exec("rm", "-rf", p["dir"])

    def log_files(self, test: dict, sess: Session, node: str):
        return [self._paths(test, node)["log"]]


class KvdbClient(jc.Client):
    """Line-protocol TCP client (zookeeper.clj:79-110 shape).  Register
    ops: read/write/cas on one key; set ops: add/read over MEMBERS."""

    def __init__(self, register: str = "reg", set_key: str = "s"):
        self.register = register
        self.set_key = set_key
        self.sock: Optional[socket.socket] = None
        self.f: Optional[Any] = None
        self.node: Any = None

    def open(self, test: dict, node: Any) -> "KvdbClient":
        c = type(self)(self.register, self.set_key)
        c.node = node
        port = node_port(test, node)
        if test.get("kvdb-local", True):
            host = "127.0.0.1"
        else:
            # "host:sshport" node names (localhost clusters) dial the
            # host part; the kvdb port is test["kvdb-port"].
            from ..control.core import split_host_port

            host, _ = split_host_port(node)
        c.sock = socket.create_connection((host, port), timeout=2.0)
        c.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        c.f = c.sock.makefile("rw", encoding="utf-8", newline="\n")
        return c

    def _round_trip(self, line: str) -> str:
        self.f.write(line + "\n")
        self.f.flush()
        resp = self.f.readline()
        if not resp:
            raise ConnectionError("kvdb closed the connection")
        return resp.strip()

    def invoke(self, test: dict, op: Op) -> Op:
        try:
            if op.f == "write":
                resp = self._round_trip(f"SET {self.register} {op.value}")
                return op.complete(OK if resp == "OK" else INFO, error=None)
            if op.f == "read":
                resp = self._round_trip(f"GET {self.register}")
                if resp == "NIL":
                    return op.complete(OK, value=None)
                return op.complete(OK, value=int(resp.split(" ", 1)[1]))
            if op.f == "cas":
                old, new = op.value
                resp = self._round_trip(f"CAS {self.register} {old} {new}")
                if resp == "OK":
                    return op.complete(OK)
                if resp in ("FAIL", "NIL"):
                    return op.complete(FAIL)
                return op.complete(INFO, error=resp)
            if op.f == "add":
                resp = self._round_trip(f"ADD {self.set_key} {op.value}")
                return op.complete(OK if resp == "OK" else INFO)
            if op.f == "members":
                resp = self._round_trip(f"MEMBERS {self.set_key}")
                if resp == "NIL":
                    return op.complete(OK, value=[])
                vals = resp.split(" ", 1)[1]
                return op.complete(
                    OK, value=[int(v) for v in vals.split(",") if v]
                )
            raise ValueError(f"unknown f {op.f!r}")
        except (socket.timeout, TimeoutError) as e:
            # Indeterminate: the op may have applied.
            return op.complete(INFO, error=f"timeout: {e}")

    def close(self, test: dict) -> None:
        try:
            if self.sock is not None:
                self.sock.close()
        except OSError:
            pass


class KvdbCounterClient(KvdbClient):
    """Counter ops on one key.  The conviction arm increments the way
    naive clients actually do — GET, think, SET — whose interleavings
    LOSE concurrent updates; `atomic` uses the server's INCR (one
    round trip under the store's mutex), the control group.  The think
    pause is the honest client-side analog of txnd's --think-us: a
    real deployment's window is its read-modify-write latency, ours is
    just made visible."""

    COUNTER_KEY = "ctr"

    def __init__(self, register: str = "reg", set_key: str = "s"):
        super().__init__(register, set_key)
        self.atomic = False
        self.think_s = 0.002

    def open(self, test: dict, node: Any) -> "KvdbCounterClient":
        c = super().open(test, node)
        c.atomic = bool(test.get("kvdb-atomic-incr"))
        c.think_s = test.get("kvdb-rmw-think-s", 0.002)
        return c

    def _racy_rmw(self, delta: int) -> Optional[int]:
        """The naive GET / think / SET increment.  Returns the value
        written, or None when the SET reply was unrecognized (caller
        completes INFO).  The think pause is the honest client-side
        analog of txnd's --think-us — a real deployment's window is
        its read-modify-write latency, ours is just made visible."""
        resp = self._round_trip(f"GET {self.COUNTER_KEY}")
        cur = 0 if resp == "NIL" else int(resp.split(" ", 1)[1])
        if self.think_s:
            time.sleep(self.think_s)
        nxt = cur + delta
        resp = self._round_trip(f"SET {self.COUNTER_KEY} {nxt}")
        return nxt if resp == "OK" else None

    def _atomic_incr(self, delta: int) -> Optional[int]:
        resp = self._round_trip(f"INCR {self.COUNTER_KEY} {delta}")
        return int(resp.split()[1]) if resp.startswith("VAL ") else None

    def invoke(self, test: dict, op: Op) -> Op:
        k = self.COUNTER_KEY
        try:
            if op.f == "read":
                resp = self._round_trip(f"GET {k}")
                v = 0 if resp == "NIL" else int(resp.split(" ", 1)[1])
                return op.complete(OK, value=v)
            if op.f != "add":
                raise ValueError(f"unknown f {op.f!r}")
            incr = self._atomic_incr if self.atomic else self._racy_rmw
            applied = incr(op.value)
            if applied is None:
                return op.complete(INFO, error="unrecognized reply")
            return op.complete(OK)
        except (socket.timeout, TimeoutError) as e:
            return op.complete(INFO, error=f"timeout: {e}")


class KvdbIdClient(KvdbCounterClient):
    """ID generation on one key (checker.clj:710-747's quarry): the
    conviction arm computes its next id with the naive GET+SET round
    trip and returns it — two racers read the same current value and
    hand out the SAME id.  The atomic arm returns INCR's result,
    unique by construction."""

    COUNTER_KEY = "ids"

    def invoke(self, test: dict, op: Op) -> Op:
        if op.f != "generate":
            raise ValueError(f"unknown f {op.f!r}")
        try:
            incr = self._atomic_incr if self.atomic else self._racy_rmw
            new_id = incr(1)
            if new_id is None:
                return op.complete(INFO, error="unrecognized reply")
            return op.complete(OK, value=new_id)
        except (socket.timeout, TimeoutError) as e:
            return op.complete(INFO, error=f"timeout: {e}")


def ids_workload(opts: dict) -> dict:
    """Every acknowledged generate must return a distinct id."""
    return {
        "client": KvdbIdClient(),
        "generator": FnGen(lambda: {"f": "generate"}),
        "checker": chk.compose({
            "unique-ids": chk.UniqueIds(),
            "timeline": Timeline(),
            "stats": chk.Stats(),
        }),
    }


def counter_workload(opts: dict) -> dict:
    """tests in checker.clj:749-819's shape: positive adds + reads;
    the conviction is lost updates dragging reads below the acked
    lower bound."""
    rng = random.Random(opts.get("seed"))
    return {
        "client": KvdbCounterClient(),
        "generator": mix([
            FnGen(lambda: {"f": "read"}),
            FnGen(lambda: {"f": "add", "value": 1 + rng.randrange(5)}),
            FnGen(lambda: {"f": "add", "value": 1 + rng.randrange(5)}),
        ]),
        "checker": chk.compose({
            "counter": chk.CounterChecker(),
            "timeline": Timeline(),
            "stats": chk.Stats(),
        }),
    }


def register_workload(opts: dict) -> dict:
    rng = random.Random(opts.get("seed"))
    return {
        "client": KvdbClient(),
        "model": cas_register(),
        "generator": mix([
            FnGen(lambda: {"f": "read"}),
            FnGen(lambda: {"f": "write", "value": rng.randrange(5)}),
            FnGen(lambda: {"f": "cas",
                           "value": (rng.randrange(5), rng.randrange(5))}),
        ]),
        "checker": chk.compose({
            "linear": linearizable(
                model=cas_register(),
                algorithm=opts.get("algorithm", "cpu"),
                device=opts.get("device", "cuda"),
            ),
            "timeline": Timeline(),
            "stats": chk.Stats(),
        }),
    }


def set_workload(opts: dict) -> dict:
    import itertools

    counter = itertools.count()
    return {
        "client": KvdbClient(),
        "generator": FnGen(lambda: {"f": "add", "value": next(counter)}),
        # repeat: a bare dict is one-shot, and the final read must retry
        # until the restarted DB answers (until-ok, generator.clj:1470).
        "final-generator": time_limit(
            opts.get("final-time-limit", 30.0),
            stagger(0.05, until_ok(repeat({"f": "members"}))),
        ),
        "checker": chk.SetChecker(read_f="members"),
    }


def kvdb_test(opts: dict) -> dict:
    """Test-map assembly (zookeeper.clj:112-137)."""
    workload_name = opts.get("workload", "register")
    wl = {"register": register_workload, "set": set_workload,
          "counter": counter_workload,
          "ids": ids_workload}[workload_name](opts)
    # NB: an explicit empty list means "no faults" — `or` would
    # silently substitute the default (the logd bug, round 3).
    # Counter defaults faultless: its anomaly is the client's RMW
    # race, surfaced by plain concurrency (the txnd pattern) — a kill
    # would add durability loss both arms share, muddying the control.
    default_faults = ([] if workload_name in ("counter", "ids")
                      else ["kill"])
    faults = set(
        opts["faults"] if opts.get("faults") is not None
        else default_faults
    )
    pkg = nemesis_package({
        "faults": faults,
        "interval": opts.get("interval", 3.0),
    })
    generator = time_limit(
        opts.get("time-limit", 20.0),
        gen_nemesis(
            pkg["generator"],
            stagger(1.0 / opts.get("rate", 100), wl["generator"]),
        ),
    )
    # The package's final generator heals everything the nemesis broke
    # (restart killed DBs, drop partitions) before any final reads.
    if pkg.get("final-generator"):
        from ..generator.core import phases

        generator = phases(generator, gen_nemesis(pkg["final-generator"]))
    test = {
        "name": f"kvdb-{workload_name}",
        "db": KvdbDB(),
        "client": wl["client"],
        "nemesis": pkg["nemesis"],
        "generator": generator,
        "checker": wl["checker"],
        "kvdb-fsync": opts.get("fsync", True),
        "kvdb-buffer": opts.get("buffer", 0),
        "kvdb-atomic-incr": bool(opts.get("atomic-incr")),
        "kvdb-rmw-think-s": opts.get("rmw-think-s", 0.002),
    }
    store_root = os.path.abspath(opts.get("store-dir") or "store")
    test["kvdb-dir"] = opts.get("kvdb-dir") or os.path.join(
        store_root, "kvdb-data"
    )
    test["kvdb-base-port"] = cutil.hashed_base_port(store_root,
                                                    BASE_PORT)
    if "model" in wl:
        test["model"] = wl["model"]
    if wl.get("final-generator") is not None:
        test["final-generator"] = wl["final-generator"]
    return test


def live_suite() -> dict:
    """Adapter for `jepsen monitor --suite kvdb` (monitor/live.py):
    the minimal live-target test map (db + nodes + port topology, no
    batch generator/checker — the monitor owns both) plus client/model
    factories.  kvdb is unreplicated, so one node; each monitor key is
    its own register (``mon<k>``) on that instance."""

    def test(opts: dict) -> dict:
        store_root = os.path.abspath(opts.get("store-dir") or "store")
        return jcli.localize_test({
            "name": "kvdb-live",
            "db": KvdbDB(),
            "nodes": ["n1"],
            "kvdb-dir": os.path.join(store_root, "kvdb-data"),
            "kvdb-base-port": cutil.hashed_base_port(store_root,
                                                     BASE_PORT),
            "store-dir": store_root,
        })

    return {
        "name": "kvdb",
        "test": test,
        "client": lambda test, key: KvdbClient(register=f"mon{key}"),
        "node": lambda test, key: test["nodes"][key % len(test["nodes"])],
        "port": node_port,
        "model": cas_register,
        "with_cas": True,
    }


def _extra_opts(p) -> None:
    p.add_argument("--workload", default="register",
                   choices=["register", "set", "counter", "ids"])
    p.add_argument("--atomic-incr", action="store_true",
                   help="counter/ids workloads: use the server's "
                   "atomic INCR (the control group) instead of racy "
                   "GET+SET")
    p.add_argument("--rmw-think-s", type=float, default=0.002)
    p.add_argument("--faults", action="append", default=None,
                   choices=["kill", "pause", "partition"],
                   help="fault types (repeatable; default kill)")
    p.add_argument("--rate", type=float, default=100.0)
    p.add_argument("--no-fsync", dest="fsync", action="store_false")
    p.add_argument("--buffer", type=int, default=0,
                   help="userspace write buffering (bug mode)")
    p.add_argument("--interval", type=float, default=3.0)
    p.add_argument("--algorithm", default="cpu",
                   choices=["cpu", "wgl", "wgl-tpu"],
                   help="linearizability backend for the register workload")


def main(argv=None) -> int:
    """CLI entry (zookeeper.clj:139-145)."""

    def _localize(t: dict, opt_map: dict) -> dict:
        # kvdb is an UNREPLICATED store: N nodes would be N independent
        # registers, which no checker should call one linearizable
        # object.  The suite drives a single instance; the faults that
        # matter are kill -9 + restart (durability) and pause.  The
        # workers still exercise full client concurrency against it.
        t["nodes"] = (opt_map.get("nodes") or ["n1"])[:1]
        return jcli.localize_test(t)

    def suite(opt_map: dict) -> dict:
        return _localize(kvdb_test(opt_map), opt_map)

    def all_suites(opt_map: dict):
        """test-all matrix: both workloads across the fault set
        (cli.clj:501-529 pattern)."""
        for workload in ("register", "set"):
            for faults in (["kill"], ["pause"]):
                o = dict(opt_map, workload=workload, faults=faults)
                t = _localize(kvdb_test(o), o)
                t["name"] = f"kvdb-{workload}-{'-'.join(faults)}"
                yield t
        # Counter and unique-ids pairs: racy-RMW conviction and the
        # atomic control (faultless — the race is the anomaly).
        for workload in ("counter", "ids"):
            for atomic in (False, True):
                # faults=[] explicitly: inheriting e.g. --faults kill
                # from opt_map would add durability loss both arms
                # share and falsely convict the atomic control.
                o = dict(opt_map, workload=workload, faults=[],
                         **{"atomic-incr": atomic})
                t = _localize(kvdb_test(o), o)
                t["name"] = (f"kvdb-{workload}-atomic" if atomic
                             else f"kvdb-{workload}-rmw")
                yield t

    parser = jcli.single_test_cmd(
        suite, name="kvdb", extra_opts=_extra_opts, tests_fn=all_suites
    )
    return jcli.run(parser, argv)


if __name__ == "__main__":
    import sys

    sys.exit(main())
