"""repkv suite: the framework against a real REPLICATED system.

The port's copy of `jepsen_tpu/suites/repkv.py`.  Its CLI takes the
port's `--device cuda|cpu` (default cuda) in place of `--platform`,
resolves it before the first op, and runs every checker it builds
there; its subcommands are the port's `cli.py`'s: test, test-all,
analyze and repair.

The multi-node analog of suites/kvdb.py, in the reference's canonical
suite shape (zookeeper/src/jepsen/zookeeper.clj:40-145): compile the
C++ primary/backup store (jepsen_tpu_torch/demo/repkv.cpp) on every node, boot
the group, run a register workload where writes go to the primary and
reads go to each client's own node, inject partitions + kills, and
check linearizability on the device.

The interesting physics: repkv's replication is asynchronous (or
"sync until a peer times out" with --sync), so a partitioned backup
serves stale reads — a real, checker-visible linearizability
violation produced by a real distributed system, not a seeded fake.
`--safe-reads` routes reads to the primary too, which restores
linearizability under the same faults (the demo's control group).

Partitions use the suite's RepkvNet: the `Net` protocol implemented
with repkv's BLOCK/UNBLOCK admin commands instead of iptables — the
same declarative partition packages drive either transport.
"""

from __future__ import annotations

import os
import socket
from typing import Any, Optional

from .. import cli as jcli
from .. import demo as _demo
from .. import client as jc
from .. import db as jdb
from .. import net as jnet
from ..checker import core as chk
from ..checker.linearizable import Linearizable
from ..checker.timeline import Timeline
from ..control import Session
from ..control import util as cutil
from ..generator.core import nemesis as gen_nemesis, phases, stagger, time_limit
from ._common import register_workload_gen
from ..history import FAIL, OK, Op
from ..models import cas_register
from ..nemesis.combined import nemesis_package

REPKV_SRC = _demo.source("repkv")
BASE_PORT = 7300


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
    return _derived_base(test, "repkv-base-port",
                         BASE_PORT) + 1 + node_index(test, node)


def node_dir(test: dict, node: str) -> str:
    root = test.get("repkv-dir", "/tmp/jepsen-repkv")
    return f"{root}/{node}"


def primary_node(test: dict) -> str:
    return (test.get("nodes") or ["n1"])[0]


def node_host(test: dict, node: str) -> str:
    """Where clients/peers dial this node: an explicit in-cluster
    address when the topology declares one (netns clusters — the
    net.py node-addresses convention), loopback in the default local
    topology, else the node's host part against real machines
    (test["repkv-local"] = False) — the kvdb-local pattern
    (suites/kvdb.py:150-158)."""
    if test.get("repkv-local", True):
        # Local topology always dials loopback, even when
        # node-addresses exist for a net implementation — in-cluster
        # aliases need not resolve from the control process.
        return "127.0.0.1"
    alias = (test.get("node-addresses") or {}).get(node)
    if alias:
        return alias
    from ..control.core import split_host_port

    host, _ = split_host_port(node)
    return host


class RepkvDB(jdb.DB):
    """Compile + daemonize one group member per node."""

    def _paths(self, test: dict, node: str) -> dict:
        d = node_dir(test, node)
        return {
            "dir": d,
            "src": f"{d}/repkv.cpp",
            "bin": f"{d}/repkv",
            "pid": f"{d}/repkv.pid",
            "log": f"{d}/repkv.log",
        }

    def setup(self, test: dict, sess: Session, node: str) -> None:
        p = self._paths(test, node)
        sess.exec("mkdir", "-p", p["dir"])
        sess.upload(os.path.abspath(REPKV_SRC), p["src"])
        sess.exec("g++", "-O2", "-pthread", "-o", p["bin"], p["src"])
        # An interrupted earlier run leaks its daemon; a stale server
        # on our port serves foreign data -> false convictions
        # (grepkill! on setup, control/util.clj pattern).
        cutil.grepkill(sess, f"repkv --port {node_port(test, node)} ")
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
        ]
        if not test.get("repkv-local", True):
            # Wildcard listen needs a routable advertised address for
            # membership views (what peers dial after failover).
            args += [
                "--listen", "0.0.0.0",
                "--advertise",
                f"{node_host(test, node)}:{node_port(test, node)}",
            ]
        if node == primary_node(test):
            args.append("--primary")
        if test.get("repkv-sync", True):
            args.append("--sync")
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

    def pause(self, test: dict, sess: Session, node: str) -> None:
        p = self._paths(test, node)
        sess.exec_star("bash", "-c", f"kill -STOP $(cat {p['pid']})")

    def resume(self, test: dict, sess: Session, node: str) -> None:
        p = self._paths(test, node)
        sess.exec_star("bash", "-c", f"kill -CONT $(cat {p['pid']})")

    def primaries(self, test: dict):
        """Ask every node its ROLE (db.clj Primary, :35-42)."""
        out = []
        for node in test.get("nodes") or []:
            try:
                if _admin_round_trip(test, node, "ROLE") == "PRIMARY":
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


class RepkvNet(jnet.Net):
    """The Net protocol over repkv's BLOCK/UNBLOCK admin commands:
    partition packages work unchanged, no iptables required."""

    def drop(self, test: dict, src: str, dest: str) -> None:
        _admin_round_trip(test, dest, f"BLOCK {node_index(test, src)}",
                          timeout=2.0)

    def heal(self, test: dict) -> None:
        for node in test.get("nodes") or []:
            try:
                _admin_round_trip(test, node, "UNBLOCK *", timeout=2.0)
            except OSError:
                continue  # killed node: nothing to heal


def _admin_round_trip(test: dict, node: str, line: str,
                      timeout: float = 1.0) -> str:
    with socket.create_connection(
        (node_host(test, node), node_port(test, node)), timeout=timeout
    ) as s:
        f = s.makefile("rw", newline="\n")
        f.write(line + "\n")
        f.flush()
        return (f.readline() or "").strip()


def discover_primary(test: dict) -> str:
    """The first node whose ROLE is PRIMARY, else the static first
    node (clients rediscover after failover)."""
    for node in test.get("nodes") or []:
        try:
            if _admin_round_trip(test, node, "ROLE") == "PRIMARY":
                return node
        except OSError:
            continue
    return primary_node(test)


class RepkvMembership:
    """Failover state machine for the membership nemesis
    (nemesis/membership.py): node views are each node's ROLE; when the
    merged view shows no live primary, propose promoting the first
    live backup; the op resolves once that node reports PRIMARY."""

    def node_view(self, test, session, node):
        try:
            return _admin_round_trip(test, node, "ROLE")
        except OSError:
            return "DOWN"

    def merge_views(self, test):
        return dict(self.node_views)

    def fs(self):
        return {"promote"}

    def setup(self, test):
        return self

    def op(self, test):
        from ..generator.core import PENDING

        view = self.view or {}
        if "PRIMARY" in view.values():
            return PENDING
        backups = [n for n, r in view.items() if r == "BACKUP"]
        if not backups or self.pending:
            return PENDING
        return {"type": "info", "f": "promote", "value": backups[0]}

    def invoke(self, test, op):
        try:
            resp = _admin_round_trip(test, op.value, "PROMOTE")
        except OSError as e:
            resp = f"error: {e}"
        return op.replace(ext=dict(op.ext, resp=resp))

    def resolve(self, test):
        return False

    def resolve_op(self, test, pair):
        inv, _ = pair
        return (self.view or {}).get(inv.value) == "PRIMARY"

    def teardown(self, test):
        pass


class RepkvGrowShrink:
    """Grow/shrink membership state machine over repkv's real
    JOIN/LEAVE (the reference's core membership use,
    nemesis/membership.clj:1-47 + membership/state.clj:20-57): node
    views are each node's VIEW+ROLE response; the merged view is the
    highest view id seen; ops alternate naturally — re-join whichever
    node the group lost, else shrink by removing a live backup.

    The physics this drives (jepsen_tpu_torch/demo/repkv.cpp): a LEAVEd backup is
    never told, keeps its stale view, and serves reads frozen at
    removal time — under unsafe reads the checker convicts those, and
    the stale-read screen (checker/refute.py) names the exact read."""

    def __init__(self, min_members: int = 2):
        self.min_members = min_members

    # -- MembershipState protocol -----------------------------------------

    def setup(self, test):
        return self

    def node_view(self, test, session, node):
        try:
            resp = _admin_round_trip(test, node, "VIEW")
            parts = resp.split()
            if not parts or parts[0] != "VIEW":
                return None
            members = parts[2] if len(parts) > 2 else ""
            role = _admin_round_trip(test, node, "ROLE")
            return {
                "view-id": int(parts[1]),
                "members": tuple(sorted(m for m in members.split(",") if m)),
                "role": role,
            }
        except (OSError, ValueError):
            return None

    def merge_views(self, test):
        best = None
        for v in self.node_views.values():
            if v and (best is None or v["view-id"] > best["view-id"]):
                best = v
        return best

    def fs(self):
        return {"join", "leave"}

    def _member_ids(self, view) -> dict:
        return {
            m.split("@", 1)[0]: m.split("@", 1)[1]
            for m in (view.get("members") or ())
            if m
        }

    def op(self, test):
        from ..generator.core import PENDING

        view = self.view
        if view is None or self.pending:
            return PENDING
        members = self._member_ids(view)
        nodes = test.get("nodes") or []
        all_ids = {str(i): n for i, n in enumerate(nodes)}
        removed = sorted(i for i in all_ids if i not in members)
        if removed:
            i = removed[0]
            node = all_ids[i]
            addr = f"{node_host(test, node)}:{node_port(test, node)}"
            return {"type": "info", "f": "join", "value": (int(i), addr)}
        if len(members) <= self.min_members:
            return PENDING
        primary_ids = {
            str(node_index(test, n))
            for n, v in self.node_views.items()
            if v and v.get("role") == "PRIMARY"
        }
        cands = sorted(i for i in members if i not in primary_ids)
        if not cands:
            return PENDING
        return {"type": "info", "f": "leave", "value": int(cands[-1])}

    def invoke(self, test, op):
        primary = discover_primary(test)
        try:
            if op.f == "join":
                i, addr = op.value
                resp = _admin_round_trip(test, primary,
                                         f"JOIN {i} {addr}", timeout=2.0)
            else:
                resp = _admin_round_trip(test, primary,
                                         f"LEAVE {op.value}", timeout=2.0)
        except OSError as e:
            resp = f"error: {e}"
        return op.replace(ext=dict(op.ext, resp=resp))

    def resolve(self, test):
        return False

    def resolve_op(self, test, pair):
        inv, comp = pair
        resp = (comp.ext or {}).get("resp", "")
        if not resp or resp.startswith("error") or resp.startswith("ERR"):
            # Rejected, unreachable, or the server died mid-round-trip
            # (empty reply): the change never applied, so no future
            # view can confirm it — abandon rather than wedge pending.
            return True
        view = self.view
        if view is None:
            return False
        members = self._member_ids(view)
        if inv.f == "join":
            return str(inv.value[0]) in members
        return str(inv.value) not in members

    def teardown(self, test):
        pass


class RepkvClient(jc.Client):
    """One connection to the client's own node (reads) and one to the
    primary (writes), unless safe-reads routes everything primary-ward.
    Writes rediscover the primary on open (failover support)."""

    def __init__(self, key: str = "x"):
        self.key = key
        self.read_sock = None
        self.write_sock = None
        self.node: Any = None

    def open(self, test, node):
        c = type(self)(self.key)
        c.node = node
        primary = (
            discover_primary(test)
            if test.get("repkv-failover")
            else primary_node(test)
        )
        read_node = (
            primary if test.get("repkv-safe-reads") else node
        )
        c.read_sock = self._dial(test, read_node)
        c.write_sock = self._dial(test, primary)
        return c

    def _dial(self, test, node):
        s = socket.create_connection(
            (node_host(test, node), node_port(test, node)), timeout=2.0
        )
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s.makefile("rw", newline="\n")

    def _round_trip(self, f, line: str) -> str:
        f.write(line + "\n")
        f.flush()
        resp = f.readline()
        if not resp:
            raise ConnectionError("repkv closed the connection")
        return resp.strip()

    def invoke(self, test, op):
        if op.f == "read":
            resp = self._round_trip(self.read_sock, f"GET {self.key}")
            if resp == "NIL":
                return op.complete(OK, value=None)
            return op.complete(OK, value=int(resp.split(" ", 1)[1]))
        if op.f == "write":
            resp = self._round_trip(
                self.write_sock, f"SET {self.key} {op.value}"
            )
            if resp == "OK":
                return op.complete(OK)
            return op.complete(FAIL, error=resp)
        # cas
        old, new = op.value
        resp = self._round_trip(
            self.write_sock, f"CAS {self.key} {old} {new}"
        )
        if resp == "OK":
            return op.complete(OK)
        if resp in ("FAIL", "NIL"):
            return op.complete(FAIL)
        return op.complete(FAIL, error=resp)

    def close(self, test):
        for f in (self.read_sock, self.write_sock):
            try:
                if f is not None:
                    f.close()
            except OSError:
                pass


class RepkvSetClient(RepkvClient):
    """Set face: atomic ADDs at the primary, MEMBERS reads from the
    client's own node.  A partitioned backup's list freezes, so its
    reads omit acknowledged elements — exactly the stale reads the
    set-full checker's per-element lifecycle analysis measures
    (checker.clj:487-612), and convicts when linearizable=True."""

    def __init__(self, key: str = "s"):
        super().__init__(key)

    def invoke(self, test, op):
        if op.f == "add":
            resp = self._round_trip(self.write_sock,
                                    f"ADD {self.key} {op.value}")
            if resp == "OK":
                return op.complete(OK)
            return op.complete(FAIL, error=resp)
        resp = self._round_trip(self.read_sock, f"MEMBERS {self.key}")
        if resp == "NIL":
            return op.complete(OK, value=[])
        vals = resp.split(" ", 1)[1]
        return op.complete(
            OK, value=[int(v) for v in vals.split(",") if v]
        )


def repkv_test(opts: dict) -> dict:
    """Test-map assembly (zookeeper.clj:112-137 shape)."""
    import random

    nodes = (opts.get("nodes") or ["n1", "n2", "n3"])[:5]
    # NB: an explicit empty list means "no faults" — `or` would
    # silently substitute the default (the logd bug, round 3).
    faults = set(
        opts["faults"] if opts.get("faults") is not None
        else ["partition"]
    )
    rng = random.Random(opts.get("seed"))
    workload_name = opts.get("workload", "register")
    if workload_name == "set":
        from ..workloads import register_set

        def workload_gen():
            return register_set.generator(
                full=True, read_fraction=0.5, rng=rng
            )

        client = RepkvSetClient()
        checkers = {
            # linearizable=True: a read invoked after an add completed
            # that omits the element is a violation — which is what
            # unsafe (own-node) reads against lagging replication
            # produce.  The safe-reads control passes the same bar.
            "set-full": chk.SetFull(linearizable=True),
        }
    else:
        workload_gen = register_workload_gen(rng)
        client = RepkvClient()
        checkers = {
            "linear": Linearizable(
                algorithm=opts.get("algorithm", "wgl-tpu"),
                time_limit_s=60.0,
                device=opts.get("device", "cuda"),
            ),
        }

    pkg_opts = {
        "faults": faults,
        "interval": opts.get("interval", 3.0),
        "partition": {"targets": opts.get("partition-targets",
                                          ["one", "majority"])},
    }
    if "membership" in faults:
        # Failover: the membership state machine watches node ROLEs and
        # promotes a live backup whenever the primary disappears.
        pkg_opts["membership"] = {
            "state": RepkvMembership(),
            "view-interval": opts.get("view-interval", 0.5),
        }
    pkg = nemesis_package(pkg_opts)
    if "grow-shrink" in faults:
        # Real JOIN/LEAVE against the process group, composed with
        # whatever other faults run (membership.clj's core use).
        from ..nemesis.combined import compose_packages
        from ..nemesis.membership import membership_package

        gs = membership_package({
            "faults": {"membership"},
            "interval": opts.get("interval", 3.0),
            "membership": {
                "state": RepkvGrowShrink(
                    min_members=opts.get("min-members", 2)
                ),
                "view-interval": opts.get("view-interval", 0.5),
            },
        })
        pkg = compose_packages([pkg, gs])
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
    # Composed with timeline + stats like the reference's canonical
    # test maps (zookeeper.clj:112-137): every run leaves a browsable
    # trail, convicted or not.
    checkers.update({"timeline": Timeline(), "stats": chk.Stats()})
    test = {
        "name": f"repkv-{workload_name}",
        "nodes": nodes,
        "db": RepkvDB(),
        "net": RepkvNet(),
        "client": client,
        "nemesis": pkg["nemesis"],
        "generator": generator,
        "model": cas_register(),
        "checker": chk.compose(checkers),
        "repkv-sync": opts.get("sync", True),
        "repkv-safe-reads": opts.get("safe-reads", False),
        "repkv-failover": "membership" in faults,
        "repkv-dir": opts.get("repkv-dir") or os.path.join(
            store_root, "repkv-data"
        ),
        "repkv-base-port": cutil.hashed_base_port(store_root,
                                                  BASE_PORT),
    }
    if workload_name == "set":
        # set-full needs reads AFTER the last add to witness every
        # element's fate (trailing adds otherwise leave the verdict
        # unknown) — register_set's until-ok final-read
        # (generator.clj:1470).
        from ..workloads import register_set

        test["final-generator"] = time_limit(
            opts.get("final-time-limit", 20.0),
            stagger(0.05, register_set.final_generator()),
        )
    return test


def live_suite() -> dict:
    """Adapter for `jepsen monitor --suite repkv` (monitor/live.py).
    Safe-reads + sync replication — the suite's linearizable control
    configuration — so the standing verdict watches for regressions
    instead of re-demonstrating the known stale-read anomaly."""

    def test(opts: dict) -> dict:
        store_root = os.path.abspath(opts.get("store-dir") or "store")
        return jcli.localize_test({
            "name": "repkv-live",
            "nodes": list(opts.get("nodes") or ["n1", "n2", "n3"])[:5],
            "db": RepkvDB(),
            "net": RepkvNet(),
            "repkv-sync": True,
            "repkv-safe-reads": True,
            "repkv-dir": os.path.join(store_root, "repkv-data"),
            "repkv-base-port": cutil.hashed_base_port(store_root,
                                                      BASE_PORT),
            "store-dir": store_root,
        })

    return {
        "name": "repkv",
        "test": test,
        "client": lambda test, key: RepkvClient(key=f"mon{key}"),
        "node": lambda test, key: test["nodes"][key % len(test["nodes"])],
        "port": node_port,
        "model": cas_register,
        "with_cas": True,
    }


def _extra_opts(p) -> None:
    p.add_argument("--faults", action="append", default=None,
                   choices=["partition", "kill", "pause", "membership",
                            "grow-shrink"])
    p.add_argument("--rate", type=float, default=100.0)
    p.add_argument("--interval", type=float, default=3.0)
    p.add_argument("--workload", default="register",
                   choices=["register", "set"],
                   help="register: linearizable reads/writes/cas; "
                   "set: atomic adds + member reads under the "
                   "set-full lifecycle analysis")
    p.add_argument("--no-sync", dest="sync", action="store_false",
                   help="fully asynchronous replication")
    p.add_argument("--safe-reads", action="store_true",
                   help="route reads to the primary (the control group)")
    p.add_argument("--algorithm", default="wgl-tpu",
                   choices=["cpu", "wgl", "wgl-tpu"])


def main(argv=None) -> int:
    def suite(opt_map: dict) -> dict:
        return jcli.localize_test(repkv_test(opt_map))

    def all_suites(opt_map: dict):
        """test-all: the stale-read conviction run and its safe-reads
        control group (cli.clj:501-529 pattern)."""
        for workload in ("register", "set"):
            for safe in (False, True):
                o = dict(opt_map, workload=workload)
                o["safe-reads"] = safe
                t = jcli.localize_test(repkv_test(o))
                t["name"] = (f"repkv-{workload}-safe-reads" if safe
                             else f"repkv-{workload}-unsafe")
                yield t

    parser = jcli.single_test_cmd(
        suite, name="repkv", extra_opts=_extra_opts,
        tests_fn=all_suites,
    )
    return jcli.run(parser, argv)


if __name__ == "__main__":
    import sys

    sys.exit(main())
