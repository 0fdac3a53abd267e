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
`checkerd-router` the federation router in front of daemons.  `serve`,
`monitor`, `fleet` and `lint` are not ported: `run` answers each with
the usage exit and the ROADMAP item that brings it
(`NOT_PORTED_COMMANDS`).

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


#: The reference's subcommands the port does not have yet, by the
#: ROADMAP.md Queue A item that brings them.
NOT_PORTED_COMMANDS = {
    "serve": 7,
    "monitor": 7,
    "fleet": 7,
    "lint": 8,
}


def single_test_cmd(
    test_fn: Callable[[dict], dict],
    *,
    name: str = "jepsen-tpu",
    extra_opts: Optional[Callable[[argparse.ArgumentParser], None]] = None,
    tests_fn: Optional[Callable[[dict], Sequence[dict]]] = None,
) -> argparse.ArgumentParser:
    """Builds the parser with `test`, `analyze`, `repair` and `search`
    subcommands (cli.clj:355-441).  `test_fn` maps the CLI option map to a test
    map.  When `tests_fn` (option map -> sequence of test maps) is
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
    if args and args[0] in NOT_PORTED_COMMANDS:
        print(f"{parser.prog}: `{args[0]}` is not ported yet (ROADMAP.md "
              f"Queue A item {NOT_PORTED_COMMANDS[args[0]]})",
              file=sys.stderr)
        return EXIT_USAGE
    try:
        opts = parser.parse_args(args)
    except SystemExit as e:
        return EXIT_USAGE if e.code not in (0, None) else 0
    try:
        return opts._run(opts)
    except Exception:  # noqa: BLE001
        traceback.print_exc()
        return EXIT_ERROR
