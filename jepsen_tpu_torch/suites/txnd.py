"""txnd suite: the framework against a real TRANSACTIONAL system.

The port's copy of `jepsen_tpu/suites/txnd.py`.  Its CLI takes the
port's `--device cuda|cpu` (default cuda) in place of `--platform`,
resolves it before the first op, and runs every checker it builds
there; its subcommands are the port's `cli.py`'s: test, test-all,
analyze and repair.

The fourth demo system (after kvdb: durability, repkv: replication,
logd: logs) and the one that aims the elle-equivalent transactional
checkers at a real server — the reference project's headline use of
elle against tidb/cockroachdb/yugabyte (SURVEY.md §2.5), in the
canonical zookeeper.clj suite shape.

The physics under test: txnd (jepsen_tpu_torch/demo/txnd.cpp) implements textbook
snapshot isolation — MVCC versions, snapshot reads, first-committer-
wins on write-write conflicts.  SI admits *write skew* (Adya's G2):
two transactions read overlapping keys, write disjoint ones, and both
commit even though no serial order explains them.  No nemesis is
needed; the anomaly is the isolation level itself, surfaced by plain
concurrency.  The rw-register workload (checker/elle/wr.py) with
`sequential_keys=True` convicts it — per-key write order IS realtime
order under first-committer-wins, so the declared-semantics inference
is sound here.  `--serializable` makes txnd validate read sets too
(backward OCC), closing the window: the control group passes under
the identical workload.

A second workload aims one level lower: `--workload bank` runs the
conserved-total transfer test (workloads/bank.py, tests/bank.clj)
against txnd in `--read-committed` mode, where per-statement reads
and blind writes admit read skew and lost updates — reads see totals
that don't add up, and concurrent transfers permanently corrupt the
ledger.  Snapshot isolation is bank's CONTROL group (SI's consistent
snapshots and first-committer-wins preserve the total), which is the
textbook hierarchy in one binary: read committed fails bank, SI
passes bank but fails rw-register, serializable passes both.
"""

from __future__ import annotations

import os
import random
import socket
from typing import Any, Optional

from .. import cli as jcli
from .. import demo as _demo
from .. import client as jc
from .. import db as jdb
from ..checker import core as chk
from ..checker.elle import WrChecker
from ..checker.elle.wr import WrGen
from ..checker.timeline import Timeline
from ..control import Session
from ..control import util as cutil
from ..generator.core import FnGen, clients, stagger, time_limit
from ..generator import nemesis as gen_nemesis
from ..history import FAIL, INFO, OK, Op
from ..nemesis.combined import nemesis_package
from ..workloads import bank

TXND_SRC = _demo.source("txnd")

BASE_PORT = 7550


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
    nodes = test.get("nodes") or []
    if test.get("txnd-local", True):
        return _derived_base(test, "txnd-base-port",
                             BASE_PORT) + 1 + nodes.index(node)
    return test.get("txnd-port", BASE_PORT)


def node_dir(test: dict, node: str) -> str:
    root = test.get("txnd-dir", "/tmp/jepsen-txnd")
    return f"{root}/{node}"


class TxndDB(jdb.DB):
    """Compile-from-source lifecycle (zookeeper.clj:40-73 shape)."""

    def _paths(self, test: dict, node: str) -> dict:
        d = node_dir(test, node)
        return {
            "dir": d,
            "src": f"{d}/txnd.cpp",
            "bin": f"{d}/txnd",
            "pid": f"{d}/txnd.pid",
            "log": f"{d}/txnd.log",
        }

    def setup(self, test: dict, sess: Session, node: str) -> None:
        p = self._paths(test, node)
        sess.exec("mkdir", "-p", p["dir"])
        sess.upload(os.path.abspath(TXND_SRC), p["src"])
        sess.exec("g++", "-O2", "-pthread", "-o", p["bin"], p["src"])
        # An interrupted earlier run leaks its daemon; a stale server
        # on our port serves foreign data -> false convictions
        # (grepkill! on setup, control/util.clj pattern).
        cutil.grepkill(sess, f"txnd --port {node_port(test, node)} ")
        # Retry the start+probe cycle (see kvdb.py setup).
        cutil.retrying_daemon_start(
            sess, lambda: self.start(test, sess, node),
            node_port(test, node), await_timeout_s=10, interval_s=0.1,
        )

    def start(self, test: dict, sess: Session, node: str) -> None:
        p = self._paths(test, node)
        args = ["--port", str(node_port(test, node)),
                "--think-us", str(test.get("txnd-think-us", 2000))]
        if not test.get("txnd-local", True):
            args += ["--listen", "0.0.0.0"]
        if test.get("txnd-serializable"):
            args.append("--serializable")
        if test.get("txnd-read-committed"):
            args.append("--read-committed")
        for key, value in sorted((test.get("txnd-init") or {}).items()):
            args += ["--init", str(key), str(value)]
        cutil.start_daemon(
            sess, p["bin"], *args, pidfile=p["pid"], logfile=p["log"]
        )
        try:
            cutil.await_tcp_port(
                sess, node_port(test, node), timeout_s=10,
                interval_s=0.05,
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

    def teardown(self, test: dict, sess: Session, node: str) -> None:
        p = self._paths(test, node)
        cutil.stop_daemon(sess, p["pid"])
        if not test.get("leave-db-running"):
            sess.exec("rm", "-rf", p["dir"])

    def log_files(self, test: dict, sess: Session, node: str):
        return [self._paths(test, node)["log"]]


class TxndClient(jc.Client):
    """One-shot transactions over the line protocol.  op.value is the
    elle micro-op list [["r", k, None]|["w", k, v], ...]; reads come
    back filled in protocol order."""

    def __init__(self):
        self.sock: Optional[socket.socket] = None
        self.f: Optional[Any] = None

    def open(self, test: dict, node: Any) -> "TxndClient":
        c = type(self)()
        if test.get("txnd-local", True):
            host = "127.0.0.1"
        else:
            from ..control.core import split_host_port

            host, _ = split_host_port(node)
        c.sock = socket.create_connection(
            (host, node_port(test, node)), timeout=5.0
        )
        c.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        c.f = c.sock.makefile("rw", encoding="utf-8", newline="\n")
        return c

    def _roundtrip(self, line: str, op: Op):
        """One request/response cycle with the shared error
        classification: io trouble / truncation -> INFO (outcome
        unknown), server-side rejection before any write applied
        (ABORT/NSF) -> FAIL, anything else unrecognized -> INFO.
        Returns the response string, or a completed Op."""
        try:
            self.f.write(line + "\n")
            self.f.flush()
            resp = self.f.readline()
        except (socket.timeout, TimeoutError, OSError) as e:
            return op.complete(INFO, error=f"io: {e}")
        if not resp:
            return op.complete(INFO, error="connection closed")
        resp = resp.strip()
        if resp in ("ABORT", "NSF"):
            # Rejected before applying anything: definitely did not
            # happen.
            return op.complete(
                FAIL,
                error="insufficient funds" if resp == "NSF" else None,
            )
        if not resp.startswith("OK"):
            return op.complete(INFO, error=resp)
        return resp

    #: Protocol verb for non-read mops; the append subclass swaps it.
    WRITE_VERB = "w"

    def _parse_read(self, raw: str):
        return None if raw == "NIL" else int(raw)

    def invoke(self, test: dict, op: Op) -> Op:
        parts = ["TXN"]
        for mop in op.value or []:
            if mop[0] == "r":
                parts += ["r", f"k{mop[1]}"]
            else:
                parts += [self.WRITE_VERB, f"k{mop[1]}", str(mop[2])]
        resp = self._roundtrip(" ".join(parts), op)
        if isinstance(resp, Op):
            return resp
        reads = resp.split()[1:]
        filled = []
        i = 0
        for mop in op.value or []:
            if mop[0] == "r":
                raw = reads[i] if i < len(reads) else "NIL"
                i += 1
                filled.append(["r", mop[1], self._parse_read(raw)])
            else:
                filled.append(mop)
        return op.complete(OK, value=filled)

    def close(self, test: dict) -> None:
        try:
            if self.sock is not None:
                self.sock.close()
        except OSError:
            pass


class TxndAppendClient(TxndClient):
    """elle list-append mops over the `a` protocol verb: appends ride
    the server's MVCC read-modify-write, reads come back comma-joined
    and are filled into the mop list the AppendChecker consumes."""

    WRITE_VERB = "a"

    def _parse_read(self, raw: str):
        return [] if raw == "NIL" else [int(x) for x in raw.split(",")]


class TxndBankClient(TxndClient):
    """Bank ops over the same line protocol: reads are one TXN over
    every account (snapshot-consistent under SI, per-statement under
    --read-committed); transfers are the server-side TRANSFER
    read-modify-write.  tests/bank.clj's client shape."""

    def invoke(self, test: dict, op: Op) -> Op:
        accounts = test.get("accounts") or []
        if op.f == "read":
            line = " ".join(["TXN"] + [x for a in accounts
                                       for x in ("r", f"a{a}")])
        else:
            t = op.value
            line = f"TRANSFER a{t['from']} a{t['to']} {t['amount']}"
        resp = self._roundtrip(line, op)
        if isinstance(resp, Op):
            return resp
        if op.f != "read":
            return op.complete(OK)
        raw = resp.split()[1:]
        balances = {
            a: int(raw[i])
            for i, a in enumerate(accounts)
            if i < len(raw) and raw[i] != "NIL"
        }
        return op.complete(OK, value=balances)


class TxndRegisterClient(TxndClient):
    """Register face for the standing monitor: one-mop transactions on
    a single key.  A single-statement txn's snapshot is taken at
    begin, so reads observe the latest committed value at invoke time
    — linearizable for one register even under plain SI."""

    def __init__(self, key: str = "m0"):
        super().__init__()
        self.key = key

    def open(self, test: dict, node: Any) -> "TxndRegisterClient":
        c = super().open(test, node)
        c.key = self.key
        return c

    def invoke(self, test: dict, op: Op) -> Op:
        if op.f == "read":
            resp = self._roundtrip(f"TXN r {self.key}", op)
            if isinstance(resp, Op):
                return resp
            reads = resp.split()[1:]
            raw = reads[0] if reads else "NIL"
            return op.complete(OK, value=self._parse_read(raw))
        if op.f != "write":
            raise ValueError(f"unknown f {op.f!r} (no CAS verb on txnd)")
        resp = self._roundtrip(f"TXN w {self.key} {op.value}", op)
        if isinstance(resp, Op):
            return resp
        return op.complete(OK)


def live_suite() -> dict:
    """Adapter for `jepsen monitor --suite txnd` (monitor/live.py).
    Serializable mode (the suite's control group), single node; no
    kill faults — txnd is deliberately memoryless across SIGKILL, so
    the live driver should stick to pause windows."""

    def test(opts: dict) -> dict:
        store_root = os.path.abspath(opts.get("store-dir") or "store")
        return jcli.localize_test({
            "name": "txnd-live",
            "nodes": ["n1"],
            "db": TxndDB(),
            "txnd-serializable": True,
            "txnd-think-us": 0,
            "txnd-dir": os.path.join(store_root, "txnd-data"),
            "txnd-base-port": cutil.hashed_base_port(store_root,
                                                     BASE_PORT),
            "store-dir": store_root,
        })

    from ..models import cas_register

    return {
        "name": "txnd",
        "test": test,
        "client": lambda test, key: TxndRegisterClient(key=f"m{key}"),
        "node": lambda test, key: test["nodes"][key % len(test["nodes"])],
        "port": node_port,
        "model": cas_register,
        "with_cas": False,
        "families": ("pause",),
    }


def txnd_test(opts: dict) -> dict:
    """Test-map assembly (zookeeper.clj:112-137 shape)."""
    nodes = (opts.get("nodes") or ["n1"])[:1]  # single-node system
    faults = set(
        opts["faults"] if opts.get("faults") is not None else []
    )
    workload = opts.get("workload", "wr")
    extra: dict = {}
    if workload == "append":
        from ..checker.elle import AppendChecker, AppendGen

        base_gen = FnGen(AppendGen(
            key_count=opts.get("key-count", 10),
            max_txn_length=opts.get("max-txn-length", 4),
            rng=random.Random(opts.get("seed")),
        ))
        client: jc.Client = TxndAppendClient()
        checkers: dict = {
            "elle-append": AppendChecker(
                opts.get("consistency-model", "serializable"),
                device=opts.get("device", "cuda"),
            ),
        }
        name = "txnd-append"
    elif workload == "long-fork":
        from ..workloads import long_fork

        # Plain r/w mops — TxndClient speaks them as-is.  The
        # conviction target is --read-committed: per-statement reads
        # observe two writers' commits in contradictory orders (the
        # long fork, long_fork.clj:1-60); SI's consistent snapshots
        # forbid it, so the DEFAULT mode is this workload's control.
        base_gen = long_fork.generator(
            opts.get("group-size", 2),
            random.Random(opts.get("seed")),
        )
        client = TxndClient()
        checkers = {"long-fork": long_fork.LongForkChecker()}
        name = "txnd-long-fork"
    elif workload == "bank":
        accounts = list(range(opts.get("accounts", 8)))
        total = opts.get("total-amount", bank.DEFAULT_TOTAL)
        base_gen = bank.generator(
            accounts, rng=random.Random(opts.get("seed"))
        )
        client: jc.Client = TxndBankClient()
        checkers: dict = {"bank": bank.BankChecker()}
        name = "txnd-bank"
        extra = {
            "accounts": accounts,
            "total-amount": total,
            # All funds start on account 0 (tests/bank.clj's shape);
            # seeded server-side before the listener opens, so every
            # read sees a full ledger.
            "txnd-init": {f"a{a}": (total if a == accounts[0] else 0)
                          for a in accounts},
        }
    else:
        base_gen = FnGen(WrGen(
            key_count=opts.get("key-count", 4),
            min_txn_length=2,
            max_txn_length=opts.get("max-txn-length", 4),
            rng=random.Random(opts.get("seed")),
        ))
        client = TxndClient()
        checkers = {
            "elle-wr": WrChecker(
                consistency_model=opts.get("consistency-model",
                                           "serializable"),
                sequential_keys=True,
                device=opts.get("device", "cuda"),
            ),
        }
        name = "txnd-wr"
    workload_gen = stagger(1.0 / opts.get("rate", 150), base_gen)
    if faults:
        pkg = nemesis_package({
            "faults": faults,
            "interval": opts.get("interval", 3.0),
        })
        # Routes the fault schedule to the nemesis process and the
        # workload to client processes only.
        generator = time_limit(
            opts.get("time-limit", 10.0),
            gen_nemesis(pkg["generator"], workload_gen),
        )
        if pkg.get("final-generator"):
            # Heal whatever the last interval broke (resume a paused
            # server) before the run ends — the sibling-suite pattern.
            from ..generator.core import phases

            generator = phases(
                generator, gen_nemesis(pkg["final-generator"])
            )
        nemesis = pkg["nemesis"]
    else:
        from ..nemesis.core import NoopNemesis

        # clients(): without it a bare generator also feeds the
        # nemesis process, which silently info-completes txns.
        generator = time_limit(
            opts.get("time-limit", 10.0), clients(workload_gen)
        )
        nemesis = NoopNemesis()

    store_root = os.path.abspath(opts.get("store-dir") or "store")
    checkers.update({"timeline": Timeline(), "stats": chk.Stats()})
    return {
        "name": name,
        "nodes": nodes,
        "db": TxndDB(),
        "client": client,
        "nemesis": nemesis,
        "generator": generator,
        "checker": chk.compose(checkers),
        "txnd-serializable": bool(opts.get("serializable")),
        "txnd-read-committed": bool(opts.get("read-committed")),
        # Per-workload think default — long-fork needs a wide
        # inter-statement gap (a fork requires one reader's gap to
        # straddle BOTH write commits while another reader lands
        # between them; at 2 ms the straddle never happens in a short
        # run).  The CLI flag leaves it None so this default applies
        # through both entry paths.
        "txnd-think-us": (
            opts.get("think-us")
            if opts.get("think-us") is not None
            else (20000 if workload == "long-fork" else 2000)
        ),
        "txnd-dir": opts.get("txnd-dir") or os.path.join(
            store_root, "txnd-data"
        ),
        "txnd-base-port": cutil.hashed_base_port(store_root, BASE_PORT),
        **extra,
    }


def _extra_opts(p) -> None:
    # NB: no "kill" — txnd keeps all state in memory (no WAL), so a
    # SIGKILL wipes acked transactions and would convict even the
    # serializable control group for a reason that has nothing to do
    # with isolation.  Durability bugs are kvdb/logd's department.
    p.add_argument("--faults", action="append", default=None,
                   choices=["pause"])
    p.add_argument("--rate", type=float, default=150.0)
    p.add_argument("--interval", type=float, default=3.0)
    p.add_argument("--key-count", type=int, default=4)
    p.add_argument("--max-txn-length", type=int, default=4)
    p.add_argument("--think-us", type=int, default=None,
                   help="mean transaction think window in us "
                   "(default 2000; 20000 for --workload long-fork)")
    p.add_argument("--workload", default="wr",
                   choices=["wr", "append", "bank", "long-fork"],
                   help="wr: elle rw-register (write skew); append: "
                   "elle list-append over MVCC lists; bank: "
                   "conserved-total transfers (read skew / lost "
                   "updates under --read-committed); long-fork: "
                   "contradictory read orders under --read-committed")
    p.add_argument("--group-size", type=int, default=2)
    p.add_argument("--accounts", type=int, default=8)
    p.add_argument("--serializable", action="store_true",
                   help="validate read sets at commit (the control "
                   "group: closes the write-skew window)")
    p.add_argument("--read-committed", action="store_true",
                   help="per-statement reads, no commit validation "
                   "(the bank workload's conviction target)")
    p.add_argument("--consistency-model", default="serializable",
                   choices=["serializable", "repeatable-read",
                            "read-committed", "read-uncommitted"])


def main(argv=None) -> int:
    def suite(opt_map: dict) -> dict:
        return jcli.localize_test(txnd_test(opt_map))

    def all_suites(opt_map: dict):
        """test-all: each workload's conviction run and its control
        group (cli.clj:501-529 pattern) — wr convicts SI vs the
        serializable control; bank convicts read committed vs the SI
        control."""
        for workload in ("wr", "append"):
            for serializable in (False, True):
                # Force RC off: a stray --read-committed would
                # otherwise override --serializable in the binary and
                # convict the control group for the wrong reason.
                o = dict(opt_map, workload=workload,
                         serializable=serializable,
                         **{"read-committed": False})
                t = jcli.localize_test(txnd_test(o))
                t["name"] = (f"txnd-{workload}-serializable"
                             if serializable else f"txnd-{workload}-si")
                yield t
        for workload in ("bank", "long-fork"):
            for read_committed in (True, False):
                o = dict(opt_map, workload=workload,
                         serializable=False,
                         **{"read-committed": read_committed})
                t = jcli.localize_test(txnd_test(o))
                t["name"] = (f"txnd-{workload}-read-committed"
                             if read_committed
                             else f"txnd-{workload}-si")
                yield t

    parser = jcli.single_test_cmd(
        suite, name="txnd", extra_opts=_extra_opts,
        tests_fn=all_suites,
    )
    return jcli.run(parser, argv)


if __name__ == "__main__":
    import sys

    sys.exit(main())
