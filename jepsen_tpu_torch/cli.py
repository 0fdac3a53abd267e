"""Command-line entry points.

The port's copy of `jepsen_tpu/cli.py` (the reference's cli.clj): the
standard option set (--nodes, --concurrency "3n", --time-limit,
--test-count, the ssh flags), `single_test_cmd` giving the `test`,
`analyze`, `repair`, `search` and, with a suite, `test-all`
subcommands, and the
exit-code contract: 0 valid, 1 invalid, 2 unknown, 254 errors, 255
usage.

The reference's `--platform cpu|tpu` becomes `--device cuda|cpu`
(default cuda): the device the checkers and the online session run
on.  It is resolved when the test is built, before the first op: a run
that asks for the card where there is none exits 254 with no history
written.  A device fault during analysis (a kernel that failed to
build or launch, a CUDA error, a card that ran out) exits 254 too,
never 2 or 0.  `search` keeps the suite's `--device` in every
iteration's test map, so each iteration is checked on the card; a
device fault ends the search with 254.  `checkerd` runs the checker
daemon on `--device` (cuda by default; no card exits 254) and
`checkerd-router` the federation router in front of daemons.  `serve`
browses a store over HTTP (web.py; host code, no device).  `monitor`
runs the standing loop (monitor/) with its rolling checker on
`--device`, and `fleet run` supervises tenant monitors, each given the
supervisor's resolved `--device`; both exit 254 without the card they
ask for, before the first op or child.  `monitor` exits 0 when every
key is proven, 2 when an epoch ended unknown, 254 on a device fault
(its summary written first).  `lint` runs the port's jepsenlint
(analysis/) over `jepsen_tpu_torch/` and `chip_smoke.py`: exit 0 when
no finding is left outside the baseline, 1 otherwise.

Usage from a test suite:

    def my_test(opts): return {...test map...}
    if __name__ == "__main__":
        sys.exit(cli.run(cli.single_test_cmd(my_test)))
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import traceback
from typing import Any, Callable, Optional, Sequence

from . import core, store
from . import device as _device

EXIT_VALID = 0
EXIT_INVALID = 1
EXIT_UNKNOWN = 2
EXIT_ERROR = 254
EXIT_USAGE = 255

log = logging.getLogger(__name__)


def add_standard_opts(p: argparse.ArgumentParser) -> None:
    """cli.clj:64-111."""
    p.add_argument(
        "--node", "-n", action="append", dest="nodes", metavar="HOST",
        help="node to run against (repeatable)",
    )
    p.add_argument(
        "--nodes", dest="nodes_csv", metavar="HOSTS",
        help="comma-separated node list",
    )
    p.add_argument(
        "--nodes-file", dest="nodes_file", metavar="FILE",
        help="file with one node per line",
    )
    p.add_argument(
        "--concurrency", "-c", default="1n",
        help='number of workers, or "3n" = 3 x node count (default 1n)',
    )
    p.add_argument(
        "--time-limit", type=float, default=60.0,
        help="seconds to run the workload (default 60)",
    )
    p.add_argument(
        "--test-count", type=int, default=1,
        help="how many times to run the test (default 1)",
    )
    p.add_argument("--username", default="root", help="ssh user")
    p.add_argument("--password", default=None, help="ssh password")
    p.add_argument("--private-key-path", default=None)
    p.add_argument("--ssh-port", type=int, default=22)
    p.add_argument(
        "--dummy-ssh", action="store_true",
        help="don't actually connect anywhere (the reference's :dummy?)",
    )
    p.add_argument(
        "--leave-db-running", action="store_true",
        help="skip DB teardown so you can inspect its state",
    )
    p.add_argument("--store-dir", default="store")
    p.add_argument(
        "--seed", type=int, default=None,
        help="RNG seed for reproducible generator schedules",
    )
    p.add_argument(
        "--node-loss-policy", default="abort", metavar="POLICY",
        help='what to do when a node dies at setup: "abort" (default) '
        'or "tolerate[:<min_nodes>]" — quarantine the node and run on '
        "the survivors, aborting only below min_nodes",
    )
    p.add_argument(
        "--remote", default=None, metavar="HOST:PORT",
        help="route linearizable checking through a checkerd daemon "
        "(`jepsen checkerd`); falls back to in-process checking when "
        "the daemon is unreachable",
    )
    p.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where the checkers and the online session run (default "
        "cuda; the run fails before its first op when there is no card)",
    )
    p.add_argument(
        "--streaming", action="store_true",
        help="check the history online, while the run generates it "
        "(streaming/): the verdict lands seconds after the "
        "last op instead of after a full post-hoc pass.  Also enabled "
        "by JEPSEN_STREAMING=1",
    )


def test_opts_to_map(opts: argparse.Namespace) -> dict:
    """Turns parsed options into the partial test map suites merge
    over."""
    nodes = list(opts.nodes or [])
    if opts.nodes_csv:
        nodes += [n for n in opts.nodes_csv.split(",") if n]
    if opts.nodes_file:
        with open(opts.nodes_file) as f:
            nodes += [l.strip() for l in f if l.strip()]
    if not nodes:
        nodes = ["n1", "n2", "n3", "n4", "n5"]  # cli.clj:18 default
    # Suite-specific flags (registered via extra_opts) ride along with
    # dashes for keys, after the standard set.
    consumed = {
        "nodes", "nodes_csv", "nodes_file", "concurrency", "time_limit",
        "test_count", "username", "password", "private_key_path",
        "ssh_port", "dummy_ssh", "leave_db_running", "store_dir", "seed",
        "command", "test_dir", "device", "remote", "streaming",
    }
    extra = {
        k.replace("_", "-"): v
        for k, v in vars(opts).items()
        if k not in consumed and not k.startswith("_")
    }
    out = {
        **extra,
        "nodes": nodes,
        "concurrency": opts.concurrency,
        "time-limit": opts.time_limit,
        "store-dir": opts.store_dir,
        "leave-db-running": bool(opts.leave_db_running),
        "ssh": {
            "username": opts.username,
            "password": opts.password,
            "private-key-path": opts.private_key_path,
            "port": opts.ssh_port,
            "dummy?": bool(opts.dummy_ssh),
        },
        "seed": opts.seed,
        "device": opts.device,
    }
    # "remote" the CLI flag is the checkerd address; test["remote"] is
    # the control-plane Remote object — different keys on purpose.
    # Only set when given, so a suite's own "checkerd" survives.
    if getattr(opts, "remote", None):
        out["checkerd"] = opts.remote
    # Only set when given, so a suite's own "streaming" (or the
    # JEPSEN_STREAMING env var, read at run time) survives.
    if getattr(opts, "streaming", None):
        out["streaming"] = True
    return out


def validity_exit(results: Optional[dict]) -> int:
    v = (results or {}).get("valid")
    if v is True:
        return EXIT_VALID
    if v is False:
        return EXIT_INVALID
    return EXIT_UNKNOWN


def localize_test(t: dict) -> dict:
    """Defaults a suite's test map to the local topology: every node is
    a port and a data directory on this machine, reached through
    LocalRemote (the suite CLIs' shared default).  A test["remote"] of
    the caller's, or --dummy-ssh (which wins in default_remote),
    overrides it."""
    from .control import LocalRemote

    t.setdefault("remote", LocalRemote())
    return t


def single_test_cmd(
    test_fn: Callable[[dict], dict],
    *,
    name: str = "jepsen-tpu",
    extra_opts: Optional[Callable[[argparse.ArgumentParser], None]] = None,
    tests_fn: Optional[Callable[[dict], Sequence[dict]]] = None,
) -> argparse.ArgumentParser:
    """Builds the parser with `test`, `analyze`, `repair`, `search`,
    `serve`, `checkerd`, `checkerd-router`, `lint`, `monitor` and
    `fleet` subcommands (cli.clj:355-441).  `test_fn` maps the CLI
    option map to a test map.  When `tests_fn` (option map -> sequence of test maps) is
    given, a `test-all` subcommand runs the whole suite
    (cli.clj:501-529)."""
    parser = argparse.ArgumentParser(prog=name)
    sub = parser.add_subparsers(dest="command", required=True)

    t = sub.add_parser("test", help="run the test")
    add_standard_opts(t)
    if extra_opts:
        extra_opts(t)
    t.set_defaults(_run=lambda opts: _run_test(test_fn, opts))

    if tests_fn is not None:
        ta = sub.add_parser("test-all", help="run the whole test suite")
        add_standard_opts(ta)
        if extra_opts:
            extra_opts(ta)
        ta.set_defaults(_run=lambda opts: _run_test_all(tests_fn, opts))

    a = sub.add_parser("analyze", help="re-run checkers on a stored test")
    add_standard_opts(a)
    if extra_opts:
        extra_opts(a)
    a.add_argument(
        "test_dir", nargs="?", default=None,
        help="stored test dir (default: latest run)",
    )
    a.set_defaults(_run=lambda opts: _run_analyze(test_fn, opts))

    r = sub.add_parser(
        "repair",
        help="replay a crashed run's outstanding fault compensators",
    )
    add_standard_opts(r)
    if extra_opts:
        extra_opts(r)
    r.add_argument(
        "test_dir", nargs="?", default=None,
        help="stored test dir with a fault ledger (default: latest run)",
    )
    r.set_defaults(_run=lambda opts: _run_repair(test_fn, opts))

    se = sub.add_parser(
        "search",
        help="coverage-guided fault schedule search: breed nemesis "
        "schedules under a wall-clock budget, shrink anything "
        "interesting to a minimal reproducer",
    )
    add_standard_opts(se)
    if extra_opts:
        extra_opts(se)
    se.add_argument(
        "--budget", type=float, default=60.0, metavar="S",
        help="wall-clock seconds to search (default 60)",
    )
    se.add_argument(
        "--search-families", default=None, metavar="F1,F2",
        help="comma-separated fault families to draw from (default: "
        "every family whose compensator is replayable — "
        "partition,kill,pause,packet,clock)",
    )
    se.add_argument(
        "--max-iterations", type=int, default=None,
        help="stop after this many runs even with budget left",
    )
    se.add_argument(
        "--min-nodes", type=int, default=None,
        help="survivable-minimum floor override (default: derived "
        "from --node-loss-policy)",
    )
    se.add_argument(
        "--iteration-deadline", type=float, default=60.0, metavar="S",
        help="per-iteration hang deadline (default 60)",
    )
    se.add_argument(
        "--shrink-attempts", type=int, default=12,
        help="max extra runs spent minimizing one reproducer "
        "(default 12)",
    )
    se.set_defaults(_run=lambda opts: _run_search(test_fn, opts))

    s = sub.add_parser("serve", help="browse stored tests over HTTP")
    s.add_argument("--port", "-p", type=int, default=8080)
    s.add_argument("--host", "-b", default="0.0.0.0")
    s.add_argument("--store-dir", default="store")
    s.set_defaults(_run=_run_serve)

    from .checkerd import DEFAULT_PORT as _CHECKERD_PORT

    cd = sub.add_parser(
        "checkerd",
        help="run the long-lived checker daemon (serves --remote runs)",
    )
    cd.add_argument("--port", "-p", type=int, default=_CHECKERD_PORT)
    cd.add_argument("--host", "-b", default="0.0.0.0")
    cd.add_argument(
        "--batch-window", type=float, default=0.05, metavar="S",
        help="seconds to linger after the first queued request so "
        "concurrent runs merge into one cohort (default 0.05)",
    )
    cd.add_argument(
        "--max-budget", type=float, default=None, metavar="S",
        help="clamp every request's checker budget (pool protection)",
    )
    cd.add_argument(
        "--device", default="cuda",
        help="the torch device the daemon checks on (default cuda; the "
        "daemon exits 254 at start when it has no CUDA card)",
    )
    cd.add_argument(
        "--queue", default=None, metavar="PATH",
        help="crash-safe queue journal (checkerd.queue): a restarted "
        "daemon replays unfinished tickets under their original ids",
    )
    cd.add_argument(
        "--metrics-port", type=int, default=None, metavar="P",
        help="HTTP port for the Prometheus /metrics scrape surface",
    )
    cd.set_defaults(_run=_run_checkerd)

    from .checkerd import ROUTER_PORT as _ROUTER_PORT

    rt = sub.add_parser(
        "checkerd-router",
        help="run the federation router: one --remote address fronting "
        "N checkerd daemons with failover + admission control",
    )
    rt.add_argument("--port", "-p", type=int, default=_ROUTER_PORT)
    rt.add_argument("--host", "-b", default="0.0.0.0")
    rt.add_argument(
        "--daemon", "-d", action="append", default=[], metavar="ADDR",
        help="a daemon address (host:port); repeatable",
    )
    rt.add_argument(
        "--tenant-quota", type=int, default=None, metavar="N",
        help="max in-flight tickets per run name (over it: a "
        "deterministic checkerd.admission-rejected error)",
    )
    rt.add_argument(
        "--max-inflight", type=int, default=None, metavar="N",
        help="max in-flight tickets fleet-wide (bounded queue depth)",
    )
    rt.add_argument(
        "--probe-interval", type=float, default=2.0, metavar="S",
        help="health-probe cadence for suspect/quarantined daemons",
    )
    rt.add_argument(
        "--metrics-port", type=int, default=None, metavar="P",
        help="HTTP port for the router's Prometheus /metrics surface",
    )
    rt.add_argument(
        "--queue", default=None, metavar="PATH",
        help="crash-safe ticket journal: a restarted router keeps "
        "answering polls for every journaled ticket",
    )
    rt.set_defaults(_run=_run_checkerd_router)

    ln = sub.add_parser(
        "lint",
        help="run jepsenlint (AST invariant analysis) over the port",
    )
    from .analysis.core import add_lint_args

    add_lint_args(ln)
    ln.set_defaults(_run=_run_lint)

    mo = sub.add_parser(
        "monitor",
        help="standing continuous verification: paced workload, "
        "rolling-window online checking, durable time-series history, "
        "SLO alert routing",
    )
    mo.add_argument("--store-dir", default="store/monitor",
                    help="durable state root (series files, slo.jsonl, "
                    "forensics, postmortems)")
    mo.add_argument("--rate", type=float, default=1000.0, metavar="OPS",
                    help="target completed ops per second (default 1000)")
    mo.add_argument("--duration", type=float, default=0.0, metavar="S",
                    help="seconds to run; 0 = until interrupted")
    mo.add_argument("--keys", type=int, default=8,
                    help="independent register keys (default 8)")
    mo.add_argument("--procs-per-key", type=int, default=4,
                    help="concurrent worker processes per key (default 4)")
    mo.add_argument("--cadence", type=float, default=5.0, metavar="S",
                    help="sample/evaluate/alert cadence (default 5)")
    mo.add_argument("--sink", action="append", default=[],
                    metavar="SPEC",
                    help="alert sink: file:/path, webhook:URL, or "
                    "exec:/script (repeatable)")
    mo.add_argument("--endpoint", default=None, metavar="ADDR",
                    help="checkerd/router address to tee op windows to "
                    "for independent post-hoc verdicts")
    mo.add_argument("--tenant", default=None, metavar="NAME",
                    help="tenant identity on the checkerd tee (DRR "
                    "fair-queue + shed accounting) and per-tenant "
                    "SLO rules")
    mo.add_argument("--tee-deadline", type=float, default=120.0,
                    metavar="S",
                    help="per-window verdict deadline on the tee; "
                    "sheds back off and retry within it (default 120)")
    mo.add_argument("--tee-window", type=int, default=4096,
                    metavar="OPS",
                    help="op events per teed window (default 4096)")
    mo.add_argument("--serve-port", type=int, default=None, metavar="P",
                    help="embed the web dashboard (/monitor) on this port")
    mo.add_argument("--no-discard", action="store_true",
                    help="retain full history (parity/debug mode; "
                    "memory grows)")
    mo.add_argument("--advance-rows", type=int, default=1024,
                    help="rows between frontier advances (default 1024)")
    mo.add_argument("--bars-per-block", type=int, default=64,
                    help="barriers per frontier block (default 64)")
    mo.add_argument("--inject-slo", type=float, default=0.0, metavar="S",
                    help="fire a synthetic SLO for the first S seconds "
                    "then clear it (smoke/drill)")
    mo.add_argument("--max-ops", type=int, default=None,
                    help="stop after this many completed ops")
    mo.add_argument("--seed", type=int, default=45100)
    mo.add_argument("--info-rate", type=float, default=0.0,
                    help="fraction of ops completing indeterminate")
    mo.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the rolling checker runs (default cuda; "
                    "the monitor exits 254 before its first op when "
                    "there is no card)")
    mo.add_argument("--suite", default=None,
                    choices=["kvdb", "logd", "electd", "txnd", "repkv"],
                    help="live-target mode: drive this suite's real "
                    "daemons with a client pool instead of the "
                    "in-process workload")
    mo.add_argument("--node", action="append", default=[],
                    metavar="NAME", dest="nodes",
                    help="cluster node for --suite (repeatable; "
                    "default: the suite's own node list)")
    mo.add_argument("--live-faults", default=None, metavar="FAMS",
                    help="comma-separated fault families for the live "
                    "nemesis driver (e.g. kill,pause,partition; "
                    "'none' disables; default: suite-safe set)")
    mo.add_argument("--search-dir", default=None, metavar="DIR",
                    help="coverage-search checkpoint dir (search.json; "
                    "default <store-dir>/live/search)")
    mo.add_argument("--window-gap", type=float, default=0.75,
                    metavar="S",
                    help="quiet seconds between fault windows "
                    "(default 0.75)")
    mo.add_argument("--no-supervise", action="store_true",
                    help="don't restart daemons that die outside a "
                    "fault window")
    mo.set_defaults(_run=_run_monitor)

    fl = sub.add_parser(
        "fleet",
        help="supervised multi-tenant standing-verification fleet: "
        "N tenants' live monitors against one checkerd federation, "
        "with crash-safe registry, per-tenant isolation, quotas, "
        "SLOs, and disk retention",
    )
    flsub = fl.add_subparsers(dest="fleet_cmd", required=True)

    def _fleet_common(p: argparse.ArgumentParser) -> None:
        p.add_argument("--dir", default="store/fleet", dest="fleet_dir",
                       help="fleet root (fleet.json registry, "
                       "fleet-status.json, tenants/<name>/store)")

    fr = flsub.add_parser("run", help="run the supervisor")
    _fleet_common(fr)
    fr.add_argument("--endpoint", default=None, metavar="ADDR",
                    help="fleet-wide checkerd/router tee address "
                    "(per-tenant --endpoint overrides)")
    fr.add_argument("--tick", type=float, default=1.0, metavar="S",
                    help="reconcile cadence (default 1)")
    fr.add_argument("--park-after", type=int, default=3, metavar="K",
                    help="crash-loops before a tenant is parked "
                    "(default 3)")
    fr.add_argument("--min-uptime", type=float, default=5.0,
                    metavar="S",
                    help="a child dying sooner counts as a crash-loop "
                    "(default 5)")
    fr.add_argument("--drain-timeout", type=float, default=20.0,
                    metavar="S",
                    help="SIGTERM drain grace before SIGKILL "
                    "(default 20)")
    fr.add_argument("--retention-interval", type=float, default=30.0,
                    metavar="S",
                    help="seconds between retention sweeps "
                    "(default 30)")
    fr.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the tenants' device, resolved here and passed "
                    "to each monitor child (default cuda; exits 254 "
                    "before any child when there is no card)")
    fr.set_defaults(_run=_run_fleet)

    fa = flsub.add_parser("add", help="register a tenant")
    _fleet_common(fa)
    fa.add_argument("--tenant", required=True, metavar="NAME")
    fa.add_argument("--suite", default="kvdb",
                    choices=["kvdb", "logd", "electd", "txnd", "repkv"])
    fa.add_argument("--node", action="append", default=[],
                    metavar="NAME", dest="nodes",
                    help="cluster node owned by this tenant "
                    "(repeatable; must not overlap another tenant's)")
    fa.add_argument("--rate", type=float, default=50.0)
    fa.add_argument("--duration", type=float, default=3600.0,
                    metavar="S",
                    help="epoch length; clean exits restart (default "
                    "3600)")
    fa.add_argument("--keys", type=int, default=2)
    fa.add_argument("--procs-per-key", type=int, default=2)
    fa.add_argument("--cadence", type=float, default=1.0, metavar="S")
    fa.add_argument("--live-faults", default=None, metavar="FAMS")
    fa.add_argument("--sink", action="append", default=[],
                    metavar="SPEC")
    fa.add_argument("--endpoint", default=None, metavar="ADDR",
                    help="tenant-specific tee address")
    fa.add_argument("--weight", type=float, default=1.0,
                    help="DRR fair-queue weight (daemon-side "
                    "--tenant-weight should match)")
    fa.add_argument("--deadline", type=float, default=120.0,
                    metavar="S", help="tee verdict deadline")
    fa.add_argument("--tee-window", type=int, default=4096,
                    metavar="OPS",
                    help="op events per teed window (default 4096)")
    fa.add_argument("--retain-dossiers", type=int, default=64,
                    metavar="N",
                    help="max dossiers kept per sweep (default 64)")
    fa.add_argument("--retain-days", type=float, default=14.0,
                    metavar="D",
                    help="age ceiling for dossiers and rotated series "
                    "(default 14)")
    fa.add_argument("--retain-bytes", type=int, default=None,
                    metavar="B",
                    help="total dossier+series disk budget")
    fa.set_defaults(_run=_run_fleet)

    for verb, h in (("remove", "unregister a tenant"),
                    ("drain", "gracefully stop a tenant (stays "
                     "registered)"),
                    ("resume", "restart a drained or parked tenant"),
                    ("restart", "rolling restart through the SIGTERM "
                     "drain path")):
        fv = flsub.add_parser(verb, help=h)
        _fleet_common(fv)
        fv.add_argument("--tenant", required=True, metavar="NAME")
        fv.set_defaults(_run=_run_fleet)

    fs = flsub.add_parser("status", help="print registry + supervisor "
                          "status")
    _fleet_common(fs)
    fs.set_defaults(_run=_run_fleet)

    return parser


def _build_test(test_fn: Callable[[dict], dict], opts: argparse.Namespace) -> dict:
    opt_map = test_opts_to_map(opts)
    if opt_map.get("seed") is not None:
        from .generator import set_rng_seed

        set_rng_seed(opt_map["seed"])
    # The card first: without one a run that asks for it stops here,
    # before the suite builds a generator or a store directory.
    _device.resolve(opt_map["device"])
    test = test_fn(opt_map)
    # The option map provides defaults; the suite's map wins.
    merged = {**opt_map, **test}
    merged.pop("seed", None)
    return merged


#: INVALID is worse than UNKNOWN is worse than VALID when aggregating
#: exit codes over --test-count runs.
_SEVERITY = {EXIT_VALID: 0, EXIT_UNKNOWN: 1, EXIT_INVALID: 2}


def _run_test(test_fn, opts) -> int:
    worst = EXIT_VALID
    for i in range(opts.test_count):
        if opts.test_count > 1:
            log.info("Test run %d/%d", i + 1, opts.test_count)
        test = core.run(_build_test(test_fn, opts))
        code = validity_exit(test.get("results"))
        print(
            f"==> {test['name']} {test.get('start-time')}: "
            f"valid={test['results'].get('valid')}"
        )
        forens = test["results"].get("forensics")
        if isinstance(forens, dict) and forens.get("dossiers"):
            n = len(forens["dossiers"])
            print(f"    {n} anomaly dossier{'s' if n != 1 else ''}: "
                  f"{forens.get('dir')}")
        if _SEVERITY[code] > _SEVERITY[worst]:
            worst = code
    return worst


def _run_test_all(tests_fn, opts) -> int:
    """Runs a suite of tests, prints the grouped summary, and exits per
    the reference's scheme: 255 if any crashed, 2 if any unknown, 1 if
    any invalid, 0 if all passed (cli.clj:443-529)."""
    opt_map = test_opts_to_map(opts)
    _device.resolve(opt_map["device"])
    if opt_map.get("seed") is not None:
        from .generator import set_rng_seed

        set_rng_seed(opt_map["seed"])
    outcomes: dict[Any, list[str]] = {}
    for i, test in enumerate(tests_fn(opt_map)):
        merged = {**opt_map, **test}
        merged.pop("seed", None)
        label = merged.get("name", f"test-{i}")
        try:
            done = core.run(merged)
            valid = done.get("results", {}).get("valid")
            # Anything that isn't a definite pass/fail buckets as
            # unknown — a None or exotic validity must not read as a
            # passing suite (validity_exit semantics).
            if valid not in (True, False):
                valid = "unknown"
            try:
                where = store.test_dir(done)
            except (ValueError, KeyError):
                where = label
        except Exception:  # noqa: BLE001 — one crash must not stop the suite
            log.warning("Test %s crashed", label, exc_info=True)
            valid = "crashed"
            where = label
        outcomes.setdefault(valid, []).append(str(where))

    print()
    for title, key in [
        ("Successful tests", True),
        ("Indeterminate tests", "unknown"),
        ("Crashed tests", "crashed"),
        ("Failed tests", False),
    ]:
        if outcomes.get(key):
            print(f"\n# {title}\n")
            for path in outcomes[key]:
                print(path)
    print()
    print(len(outcomes.get(True, [])), "successes")
    print(len(outcomes.get("unknown", [])), "unknown")
    print(len(outcomes.get("crashed", [])), "crashed")
    print(len(outcomes.get(False, [])), "failures")

    if outcomes.get("crashed"):
        return EXIT_ERROR + 1  # 255, like the reference's test-all
    if outcomes.get("unknown"):
        return EXIT_UNKNOWN
    if outcomes.get(False):
        return EXIT_INVALID
    return EXIT_VALID


def _run_analyze(test_fn, opts) -> int:
    d = opts.test_dir or store.latest(opts.store_dir)
    if d is None:
        print("no stored test found", file=sys.stderr)
        return EXIT_USAGE
    test = _build_test(test_fn, opts)
    merged = core.rerun_analysis(d, test)
    print(f"==> re-analyzed {d}: valid={merged['results'].get('valid')}")
    return validity_exit(merged.get("results"))


def _run_repair(test_fn, opts) -> int:
    """`jepsen repair [dir]`: heal what a crashed run left behind.
    Exit 0 when the cluster probes clean afterwards, 2 when entries
    could not be healed (residue remains — rerun after fixing access,
    or clean up by hand)."""
    d = opts.test_dir or store.latest(opts.store_dir)
    if d is None:
        print("no stored test found", file=sys.stderr)
        return EXIT_USAGE
    # The suite's test map contributes the live objects repair needs:
    # remote/ssh opts to reopen sessions, db for db-start compensators.
    test = _build_test(test_fn, opts)
    report = core.repair(d, test)
    print(f"==> repair {d}")
    print(
        f"    outstanding={report['outstanding']} "
        f"healed={len(report['healed'])} failed={len(report['failed'])}"
    )
    for eid in report["healed"]:
        print(f"    entry {eid}: healed")
    for eid, res in report["failed"].items():
        print(f"    entry {eid}: FAILED {res.get('error') or res.get('nodes')}")
    for node, err in report["unreachable"].items():
        print(f"    node {node}: unreachable ({err})")
    residue = report.get("residue") or {}
    print(f"    residue clean={residue.get('clean')}")
    return EXIT_VALID if report["clean"] else EXIT_UNKNOWN


def _run_search(test_fn, opts) -> int:
    """`jepsen search`: the coverage-guided fault fuzzer.  Each
    iteration is a full run in its own store dir under
    <store-dir>/<name>-search/runs/; the suite's test map provides the
    cluster, client, checker and device, while the search installs the
    compiled nemesis + scripted generator.  The search dir is stable
    across invocations, so corpus and coverage resume — and the
    leading heal sweep repairs whatever a SIGKILLed predecessor left
    mid-fault."""
    from . import telemetry
    from .nemesis import search as nsearch

    base = _build_test(test_fn, opts)
    name = base.get("name") or "jepsen"
    search_dir = os.path.join(opts.store_dir, f"{name}-search")
    n_nodes = len(base.get("nodes") or [])
    if n_nodes < 2:
        print("search needs >= 2 nodes", file=sys.stderr)
        return EXIT_USAGE
    min_nodes = opts.min_nodes or nsearch.floor_from_test(base)
    families = tuple(
        f.strip() for f in (opts.search_families or "").split(",")
        if f.strip()
    ) or nsearch.DEFAULT_FAMILIES

    runner = nsearch.CoreRunner(
        lambda: _build_test(test_fn, opts), search_dir,
        {
            "iteration-deadline": opts.iteration_deadline,
            "node-loss-policy": base.get("node-loss-policy"),
        },
    )
    was_enabled = telemetry.enabled()
    telemetry.enable(True)
    try:
        out = nsearch.run_search(
            runner,
            search_dir=search_dir,
            n_nodes=n_nodes,
            budget_s=opts.budget,
            seed=opts.seed or 0,
            families=families,
            min_nodes=min_nodes,
            max_iterations=opts.max_iterations,
            shrink_attempts=opts.shrink_attempts,
            repair_template=base,
        )
    finally:
        telemetry.enable(was_enabled)
    stats = out["stats"]
    print(f"==> search {search_dir}")
    print(
        f"    iterations={stats['iterations']} "
        f"coverage={out['coverage']} corpus={out['corpus']} "
        f"interesting={stats['interesting']} cells={len(out['cells'])}"
    )
    for cell in out["cells"]:
        print(
            f"    cell {cell['name']}: {cell['events']} event(s), "
            f"shrunk from {cell['from_events']} in "
            f"{cell['shrink_runs']} runs"
        )
    return EXIT_VALID


def _run_checkerd(opts) -> int:
    """`jepsen checkerd`: the shared checker pool on `--device` (the
    card by default).  Blocks until interrupted; without a card it
    raises at start (exit 254)."""
    from .checkerd.server import serve as serve_checkerd

    serve_checkerd(
        opts.host, opts.port,
        device=opts.device,
        batch_window_s=opts.batch_window,
        max_budget_s=opts.max_budget,
        metrics_port=opts.metrics_port,
        queue_path=opts.queue,
    )
    return EXIT_VALID


def _run_checkerd_router(opts) -> int:
    """`jepsen checkerd-router`: the federation front-end.  Blocks
    until interrupted."""
    from .checkerd.router import serve as serve_router

    if not opts.daemon:
        print("checkerd-router: at least one --daemon ADDR is required")
        return EXIT_UNKNOWN
    serve_router(
        opts.host, opts.port,
        daemons=opts.daemon,
        tenant_quota=opts.tenant_quota,
        max_inflight=opts.max_inflight,
        probe_interval_s=opts.probe_interval,
        metrics_port=opts.metrics_port,
        queue_path=opts.queue,
    )
    return EXIT_VALID


def _run_serve(opts) -> int:
    from .web import serve

    serve(opts.store_dir, host=opts.host, port=opts.port)
    return EXIT_VALID


def _run_lint(opts) -> int:
    """`jepsen lint`: AST invariant analysis (jepsen_tpu_torch/analysis/).
    Exit 0 = no unbaselined findings, 1 = findings — the tier-1 gate."""
    from .analysis.core import main as lint_main

    return lint_main(opts)


def _run_monitor(opts) -> int:
    """`jepsen monitor`: blocks until --duration / --max-ops / SIGINT.
    Exit 0 when every key's verdict stayed proven, 2 when any epoch
    ended unknown (an alert fired for it — unknown is a page, not a
    pass); a device fault raises out of `run_monitor` (254), after the
    summary is written."""
    import threading

    from .monitor import MonitorConfig, run_monitor

    cfg = MonitorConfig(
        store_dir=opts.store_dir,
        device=opts.device,
        rate=opts.rate,
        duration_s=opts.duration,
        keys=opts.keys,
        procs_per_key=opts.procs_per_key,
        cadence_s=opts.cadence,
        seed=opts.seed,
        info_rate=opts.info_rate,
        max_ops=opts.max_ops,
        bars_per_block=opts.bars_per_block,
        advance_rows=opts.advance_rows,
        discard=not opts.no_discard,
        sinks=tuple(opts.sink),
        inject_slo_s=opts.inject_slo,
        endpoint=opts.endpoint,
        tenant=opts.tenant,
        tee_deadline_s=opts.tee_deadline,
        tee_window_ops=opts.tee_window,
        serve_port=opts.serve_port,
        suite=opts.suite,
        nodes=tuple(opts.nodes),
        live_faults=tuple(
            f.strip() for f in (opts.live_faults or "").split(",")
            if f.strip()
        ),
        search_dir=opts.search_dir,
        window_gap_s=opts.window_gap,
        supervise=not opts.no_supervise,
    )
    stop = threading.Event()
    try:
        summary = run_monitor(cfg, stop)
    except KeyboardInterrupt:
        # run_monitor's finally already flushed + wrote the summary.
        print("monitor interrupted; state flushed")
        return EXIT_VALID
    print(
        f"==> monitor: {summary['ops']} ops over "
        f"{summary['duration_s']}s "
        f"({summary['rate_measured']} ops/s), "
        f"{summary['ok_keys']} keys proven, "
        f"{summary['unknown_keys']} unknown; "
        f"series in {opts.store_dir}"
    )
    return EXIT_VALID if summary["unknown_keys"] == 0 else EXIT_UNKNOWN


def _run_fleet(opts: argparse.Namespace) -> int:
    """`jepsen fleet <verb>` — registry mutations are tiny CLI calls
    (safe against a running supervisor via the registry lock); `run`
    is the supervisor itself."""
    import signal
    import threading

    from .monitor.fleet import (FleetRegistry, FleetSupervisor,
                                TenantSpec, read_status)

    root = os.path.abspath(opts.fleet_dir)
    cmd = opts.fleet_cmd
    if cmd == "run":
        sup = FleetSupervisor(
            root, device=opts.device, endpoint=opts.endpoint,
            tick_s=opts.tick,
            park_after=opts.park_after, min_uptime_s=opts.min_uptime,
            drain_timeout_s=opts.drain_timeout,
            retention_interval_s=opts.retention_interval,
        )
        stop = threading.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
        print(f"==> fleet supervisor on {root} "
              f"(endpoint {opts.endpoint or 'in-process'})")
        return sup.run(stop)

    reg = FleetRegistry(root)
    if cmd == "add":
        spec = TenantSpec(
            name=opts.tenant, suite=opts.suite,
            nodes=tuple(opts.nodes), rate=opts.rate,
            duration_s=opts.duration, keys=opts.keys,
            procs_per_key=opts.procs_per_key, cadence_s=opts.cadence,
            live_faults=tuple(
                f.strip() for f in (opts.live_faults or "").split(",")
                if f.strip()),
            sinks=tuple(opts.sink), endpoint=opts.endpoint,
            weight=opts.weight, deadline_s=opts.deadline,
            tee_window_ops=opts.tee_window,
            retain_dossiers=opts.retain_dossiers,
            retain_days=opts.retain_days,
            retain_bytes=opts.retain_bytes,
        )
        try:
            reg.add(spec)
        except ValueError as e:
            print(f"fleet add: {e}")
            return EXIT_USAGE
        print(f"==> tenant {opts.tenant} registered "
              f"(suite {opts.suite}, weight {opts.weight})")
        return EXIT_VALID
    if cmd == "remove":
        reg.remove(opts.tenant)
        print(f"==> tenant {opts.tenant} removed")
        return EXIT_VALID
    if cmd in ("drain", "resume", "restart"):
        try:
            if cmd == "drain":
                reg.set_state(opts.tenant, "drained")
            elif cmd == "resume":
                reg.set_state(opts.tenant, "running")
            else:
                reg.bump_generation(opts.tenant)
        except ValueError as e:
            print(f"fleet {cmd}: {e}")
            return EXIT_USAGE
        print(f"==> tenant {opts.tenant} {cmd} requested")
        return EXIT_VALID
    # status
    tenants = reg.load()
    st = read_status(root)
    live = st.get("tenants") or {}
    print(f"fleet {root}: {len(tenants)} tenant(s)")
    for name, spec in sorted(tenants.items()):
        row = live.get(name) or {}
        print(f"  {name:16s} {spec.state:8s} suite={spec.suite} "
              f"gen={spec.generation} alive={row.get('alive')} "
              f"restarts={row.get('restarts', 0)} "
              f"crash-loops={row.get('crash-loops', 0)} "
              f"disk={row.get('disk-bytes', 0)}")
    return EXIT_VALID


def run(parser: argparse.ArgumentParser,
        argv: Optional[Sequence[str]] = None) -> int:
    """Parses and dispatches; maps outcomes to the exit-code contract
    (cli.clj:127-139): an exception, a device fault or a missing card
    among them, is EXIT_ERROR."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s [%(threadName)s] %(name)s: "
               "%(message)s",
    )
    args = list(sys.argv[1:] if argv is None else argv)
    try:
        opts = parser.parse_args(args)
    except SystemExit as e:
        return EXIT_USAGE if e.code not in (0, None) else 0
    try:
        return opts._run(opts)
    except Exception:  # noqa: BLE001
        traceback.print_exc()
        return EXIT_ERROR
