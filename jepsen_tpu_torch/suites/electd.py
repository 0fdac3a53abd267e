"""electd suite: split-brain leader election against a real system.

The port's copy of `jepsen_tpu/suites/electd.py`.  Its CLI takes the
port's `--device cuda|cpu` (default cuda) in place of `--platform`,
resolves it before the first op, and runs every checker it builds
there; its subcommands are the port's `cli.py`'s: test, test-all,
analyze and repair.

The classic shape of the reference's published findings (the
partition-induced split-brain write loss its suites were built to
catch): jepsen_tpu_torch/demo/electd.cpp elects a leader by
lowest-reachable-id heartbeats with no terms and no fencing.  A
partition isolating the lowest-id node leaves BOTH sides with a
self-believed leader; both acknowledge writes; on heal the higher-id
leader steps down and adopts the survivor's state wholesale, silently
discarding every write it acked during the split.  The linearizability
checker (checker/linearizable.py — the knossos equivalent,
checker.clj:202-233) convicts those acked-then-lost updates.

The control group (--quorum) ignores leadership entirely and runs ABD
majority reads/writes — linearizable by construction — so the SAME
partition schedule that convicts unsafe mode leaves quorum mode valid.
ABD covers read/write registers only (CAS needs consensus, which
electd deliberately lacks), so the quorum workload is rw-only; the
unsafe workload includes CAS.

Second experiment (crash amnesia): ABD's guarantee assumes replicas
remember their state across failures.  Volatile quorum mode under
kill faults reboots replicas empty, so a majority can later miss an
acked write — the checker convicts.  --durable gives each node a
fsync'd write-ahead log (electd --wal) replayed at boot, and the same
kill schedule stays valid.  The experiment matrix:

    unsafe  + partition            -> split-brain conviction
    quorum  + partition            -> valid       (control for #1)
    quorum  + kill                 -> amnesia conviction
    quorum  + kill + --durable     -> valid       (control for #3)

Partitions use ElectdNet: the `Net` protocol over electd's
BLOCK/UNBLOCK admin commands (the suites/repkv.py pattern) — the same
declarative partition packages drive either transport, and the netns
cluster can substitute kernel-enforced routes.
"""

from __future__ import annotations

import os
import socket
from typing import Any

from .. import cli as jcli
from .. import client as jc
from .. import db as jdb
from .. import demo as _demo
from .. import net as jnet
from ..checker import core as chk
from ..checker.linearizable import Linearizable
from ..checker.timeline import Timeline
from ..control import Session
from ..control import util as cutil
from ..generator.core import (
    nemesis as gen_nemesis,
    phases,
    stagger,
    time_limit,
)
from ._common import register_workload_gen
from ..history import FAIL, INFO, OK
from ..models import cas_register
from ..nemesis.combined import nemesis_package

ELECTD_SRC = _demo.source("electd")
BASE_PORT = 7500


def node_index(test: dict, node: str) -> int:
    return (test.get("nodes") or []).index(node)


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
    return _derived_base(test, "electd-base-port",
                         BASE_PORT) + 1 + node_index(test, node)


def node_dir(test: dict, node: str) -> str:
    root = test.get("electd-dir", "/tmp/jepsen-electd")
    return f"{root}/{node}"


def node_host(test: dict, node: str) -> str:
    if test.get("electd-local", True):
        return "127.0.0.1"
    alias = (test.get("node-addresses") or {}).get(node)
    if alias:
        return alias
    from ..control.core import split_host_port

    host, _ = split_host_port(node)
    return host


def _admin_round_trip(test: dict, node: str, line: str,
                      timeout: float = 1.0) -> str:
    with socket.create_connection(
        (node_host(test, node), node_port(test, node)), timeout=timeout
    ) as s:
        f = s.makefile("rw", newline="\n")
        f.write(line + "\n")
        f.flush()
        return (f.readline() or "").strip()


class ElectdDB(jdb.DB):
    """Compile + daemonize one election group member per node."""

    def _paths(self, test: dict, node: str) -> dict:
        d = node_dir(test, node)
        return {
            "dir": d,
            "src": f"{d}/electd.cpp",
            "bin": f"{d}/electd",
            "pid": f"{d}/electd.pid",
            "log": f"{d}/electd.log",
        }

    def setup(self, test: dict, sess: Session, node: str) -> None:
        p = self._paths(test, node)
        sess.exec("mkdir", "-p", p["dir"])
        sess.upload(os.path.abspath(ELECTD_SRC), p["src"])
        sess.exec("g++", "-O2", "-pthread", "-o", p["bin"], p["src"])
        # An interrupted earlier run leaks its daemon; a stale server
        # on our port serves foreign data -> false convictions
        # (grepkill! on setup, control/util.clj pattern).
        cutil.grepkill(sess, f"electd --port {node_port(test, node)} ")
        # Retry the start+probe cycle (see kvdb.py setup).
        cutil.retrying_daemon_start(
            sess, lambda: self.start(test, sess, node),
            node_port(test, node), await_timeout_s=10, interval_s=0.1,
        )

    def start(self, test: dict, sess: Session, node: str) -> None:
        p = self._paths(test, node)
        nodes = test.get("nodes") or []
        me = node_index(test, node)
        peers = ",".join(
            f"{i}@{node_host(test, n)}:{node_port(test, n)}"
            for i, n in enumerate(nodes)
            if n != node
        )
        args = [
            "--id", str(me),
            "--port", str(node_port(test, node)),
            "--peers", peers,
            "--stale-ms", str(test.get("electd-stale-ms", 400)),
        ]
        if not test.get("electd-local", True):
            args += ["--listen", "0.0.0.0"]
        if test.get("electd-quorum"):
            args.append("--quorum")
        if test.get("electd-durable"):
            args += ["--wal", f"{p['dir']}/wal"]
        cutil.start_daemon(
            sess, p["bin"], *args, pidfile=p["pid"], logfile=p["log"]
        )
        try:
            cutil.await_tcp_port(
                sess, node_port(test, node), timeout_s=10, interval_s=0.05
            )
        except Exception:  # noqa: BLE001 — best-effort, like kvdb
            pass

    def kill(self, test: dict, sess: Session, node: str) -> None:
        cutil.stop_daemon(sess, self._paths(test, node)["pid"],
                          signal="KILL")

    def primaries(self, test: dict):
        out = []
        for node in test.get("nodes") or []:
            try:
                if _admin_round_trip(test, node, "ROLE") == "LEADER":
                    out.append(node)
            except OSError:
                continue
        return out

    def teardown(self, test: dict, sess: Session, node: str) -> None:
        p = self._paths(test, node)
        cutil.stop_daemon(sess, p["pid"])
        if not test.get("leave-db-running"):
            sess.exec("rm", "-rf", p["dir"])

    def log_files(self, test: dict, sess: Session, node: str):
        return [self._paths(test, node)["log"]]


class ElectdNet(jnet.Net):
    """The Net protocol over electd's BLOCK/UNBLOCK admin commands."""

    def drop(self, test: dict, src: str, dest: str) -> None:
        _admin_round_trip(test, dest, f"BLOCK {node_index(test, src)}",
                          timeout=2.0)

    def heal(self, test: dict) -> None:
        for node in test.get("nodes") or []:
            try:
                _admin_round_trip(test, node, "UNBLOCK *", timeout=2.0)
            except OSError:
                continue  # killed node: nothing to heal


class ElectdClient(jc.Client):
    """Talks ONLY to its own node — the reference suites' canonical
    topology (client i bound to node i).  A node that does not
    currently claim leadership answers ERR notleader and the op fails
    cleanly; when a partition makes the client's node promote itself,
    this client's writes land on that side's leader.  That bound-
    client traffic is what turns a split brain into acked-then-lost
    updates the checker can convict — a discovery client that chased
    "the" leader cluster-wide would pile every op onto the surviving
    side and hide the bug.

    Completion semantics: a response is definitive (OK -> ok,
    FAIL/NIL/notleader -> fail: the op certainly did not apply).  A
    quorum timeout on a mutation is indeterminate — ABD phase 2 may
    have stored the value on a minority that a later read write-back
    resurrects — so SET/CAS map noquorum and dead connections to
    info, never fail.  Reads have no effect and may fail freely.
    """

    def __init__(self, key: str = "x"):
        self.key = key
        self.sock = None
        self.node: Any = None

    def open(self, test, node):
        c = ElectdClient(self.key)
        c.node = node
        try:
            c.sock = self._dial(test, node)
        except OSError:
            c.sock = None
        return c

    def _dial(self, test, node):
        s = socket.create_connection(
            (node_host(test, node), node_port(test, node)), timeout=2.0
        )
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s.makefile("rw", newline="\n")

    def _round_trip(self, line: str) -> str:
        if self.sock is None:
            raise ConnectionError("no connection")
        self.sock.write(line + "\n")
        self.sock.flush()
        resp = self.sock.readline()
        if not resp:
            raise ConnectionError("electd closed the connection")
        return resp.strip()

    def _req(self, test, line: str, retry: bool) -> str:
        """One request, optionally with a single redial of the SAME
        node (covers a killed-and-restarted server, never another
        node).  Mutations must NOT retry: the first attempt may have
        applied before the connection died, and a resend that answers
        notleader/FAIL would then misclassify an applied op as failed
        — the retry is for reads only, mutations surface the OSError
        so invoke() completes them info."""
        try:
            return self._round_trip(line)
        except OSError:
            if not retry:
                raise
            self.sock = self._dial(test, self.node)
            return self._round_trip(line)

    def invoke(self, test, op):
        mutation = op.f in ("write", "cas")
        try:
            if op.f == "read":
                resp = self._req(test, f"GET {self.key}", retry=True)
            elif op.f == "write":
                resp = self._req(test, f"SET {self.key} {op.value}",
                                 retry=False)
            else:
                old, new = op.value
                resp = self._req(test, f"CAS {self.key} {old} {new}",
                                 retry=False)
        except OSError as e:
            try:
                # Dead socket: leave a fresh connection for the next op
                # (the interpreter reuses this client after an info).
                self.sock = self._dial(test, self.node)
            except OSError:
                self.sock = None
            if mutation:
                return op.complete(INFO, error=str(e))
            return op.complete(FAIL, error=str(e))

        if op.f == "read":
            if resp == "NIL":
                # The EMPTY register is an observation, not ignorance:
                # the model treats a None read as unconstrained (the
                # knossos convention for "value not recorded"), which
                # would let a post-wipe NIL read linearize anywhere.
                # Encoding empty as the sentinel 0 — with the model's
                # initial value 0 and workload values starting at 1 —
                # makes crash amnesia (NIL after an acked write)
                # convictable.
                return op.complete(OK, value=0)
            if resp.startswith("VAL "):
                return op.complete(OK, value=int(resp.split(" ", 1)[1]))
            return op.complete(FAIL, error=resp)
        if resp == "OK":
            return op.complete(OK)
        if resp in ("FAIL", "NIL") or resp == "ERR notleader":
            return op.complete(FAIL, error=resp)
        if mutation:
            # noquorum / unknown: phase 2 may have partially stored.
            return op.complete(INFO, error=resp)
        return op.complete(FAIL, error=resp)

    def close(self, test):
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass


def electd_test(opts: dict) -> dict:
    """Test-map assembly (zookeeper.clj:112-137 shape)."""
    import random

    nodes = (opts.get("nodes") or ["n1", "n2", "n3"])[:5]
    faults = set(
        opts["faults"] if opts.get("faults") is not None
        else ["partition"]
    )
    quorum = bool(opts.get("quorum"))
    if opts.get("durable") and not quorum:
        # The WAL logs the quorum path (local_store); unsafe-mode
        # writes mutate directly and step-down adoption discards
        # entries an append-only log cannot un-write.  Refuse rather
        # than hand out a durability flag that logs nothing.
        raise ValueError("--durable requires --quorum (the WAL covers "
                         "the ABD path; unsafe mode is volatile by "
                         "design)")
    rng = random.Random(opts.get("seed"))
    # ABD is rw-only (CAS needs consensus); CAS exercises the unsafe
    # leader path.
    workload_gen = register_workload_gen(rng, with_cas=not quorum)

    pkg = nemesis_package({
        "faults": faults,
        "interval": opts.get("interval", 3.0),
        # isolate-one partitions: the split-brain trigger is the
        # lowest-id node landing alone, which "one" hits 1/n of the
        # time per cycle.
        "partition": {"targets": opts.get("partition-targets",
                                          ["one", "majority"])},
    })
    generator = time_limit(
        opts.get("time-limit", 15.0),
        gen_nemesis(
            pkg["generator"],
            stagger(1.0 / opts.get("rate", 100), workload_gen()),
        ),
    )
    if pkg.get("final-generator"):
        generator = phases(generator, gen_nemesis(pkg["final-generator"]))

    store_root = os.path.abspath(opts.get("store-dir") or "store")
    return {
        "name": "electd-register",
        "nodes": nodes,
        "db": ElectdDB(),
        "net": ElectdNet(),
        "client": ElectdClient(),
        "nemesis": pkg["nemesis"],
        "generator": generator,
        # Initial value 0 = the sentinel the client reports for NIL
        # reads (see ElectdClient.invoke): an empty register is a
        # checkable observation, not an unconstrained read.
        "model": cas_register(0),
        # The reference's canonical test-map shape composes the safety
        # checker with timeline + stats renders (zookeeper.clj:112-137)
        # so every run leaves a browsable trail, convicted or not.
        "checker": chk.compose({
            "linear": Linearizable(
                algorithm=opts.get("algorithm", "wgl-tpu"),
                time_limit_s=60.0,
                device=opts.get("device", "cuda"),
            ),
            # Server-side evidence the history can't carry
            # (checker.clj:863-905's role): a step-down's wholesale
            # state adoption is the moment split-brain acks become
            # lies, and electd logs it.  Quorum mode never elects, so
            # the control group can't match.
            "log-step-down": chk.LogFilePattern(
                r"STEPPING DOWN .* wholesale", "electd.log"
            ),
            "timeline": Timeline(),
            "stats": chk.Stats(),
        }),
        "electd-quorum": quorum,
        "electd-durable": bool(opts.get("durable")),
        "electd-stale-ms": opts.get("stale-ms", 400),
        "electd-dir": opts.get("electd-dir") or os.path.join(
            store_root, "electd-data"
        ),
        "electd-base-port": cutil.hashed_base_port(store_root, BASE_PORT),
    }


def live_suite() -> dict:
    """Adapter for `jepsen monitor --suite electd` (monitor/live.py).
    Quorum + durable mode: ABD majority reads/writes over a fsync'd
    WAL are linearizable by construction, so the standing verdict
    should stay proven across partitions and kills — the monitor is
    watching for regressions, not demonstrating the known split-brain.
    ABD has no CAS, and values must stay >= 1 (the client reports an
    empty register as the sentinel 0; a written 0 would alias it)."""

    def test(opts: dict) -> dict:
        store_root = os.path.abspath(opts.get("store-dir") or "store")
        return jcli.localize_test({
            "name": "electd-live",
            "nodes": list(opts.get("nodes") or ["n1", "n2", "n3"])[:5],
            "db": ElectdDB(),
            "net": ElectdNet(),
            "electd-quorum": True,
            "electd-durable": True,
            "electd-dir": os.path.join(store_root, "electd-data"),
            "electd-base-port": cutil.hashed_base_port(store_root,
                                                       BASE_PORT),
            "store-dir": store_root,
        })

    return {
        "name": "electd",
        "test": test,
        "client": lambda test, key: ElectdClient(key=f"mon{key}"),
        "node": lambda test, key: test["nodes"][key % len(test["nodes"])],
        "port": node_port,
        "model": lambda: cas_register(0),
        "with_cas": False,
        "values": (1, 6),
    }


def _extra_opts(p) -> None:
    p.add_argument("--faults", action="append", default=None,
                   choices=["partition", "kill"])
    p.add_argument("--rate", type=float, default=100.0)
    p.add_argument("--interval", type=float, default=3.0)
    p.add_argument("--quorum", action="store_true",
                   help="ABD majority reads/writes (the partition "
                        "control group; volatile under kill faults)")
    p.add_argument("--durable", action="store_true",
                   help="fsync'd per-node WAL replayed at boot (the "
                        "kill-fault control group for --quorum)")
    p.add_argument("--stale-ms", type=int, default=400)
    p.add_argument("--algorithm", default="wgl-tpu",
                   choices=["cpu", "wgl", "wgl-tpu"])


def main(argv=None) -> int:
    def suite(opt_map: dict) -> dict:
        return jcli.localize_test(electd_test(opt_map))

    def all_suites(opt_map: dict):
        """test-all: the split-brain conviction run and its ABD quorum
        control group (cli.clj:501-529 pattern)."""
        for quorum in (False, True):
            o = dict(opt_map, quorum=quorum)
            t = jcli.localize_test(electd_test(o))
            t["name"] = ("electd-register-quorum" if quorum
                         else "electd-register-unsafe")
            yield t

    parser = jcli.single_test_cmd(
        suite, name="electd", extra_opts=_extra_opts,
        tests_fn=all_suites,
    )
    return jcli.run(parser, argv)


if __name__ == "__main__":
    import sys

    sys.exit(main())
