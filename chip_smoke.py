#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (jepsen_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc): the witness sweep
kernel is built from jepsen_tpu_torch/csrc/ into build/jepsen_tpu_torch/
at first use.  Exits non-zero, printing no result, when torch sees no
CUDA device or the package is missing.  Twenty phases, each raising
on failure, run in the order 1, 2, 5, 6, 7, 8, 9, 10, 11, 1b, 12, 13, 14,
18, 3, 4, 15, 16, 17, 19, 20 (every CUDA-event timing before the profiler
first runs; phases 15-20, host-clock walls only, after it, since
torch.profiler drops device operations from its windows in a process
that has run a search).  The searches run with the packed member lanes at their default
(`JEPSEN_WGL_PACKED`, on), as users run them.  The
checkers' only route is the compiled plan, so phases 1-8, 10 and 11 run
it; phase 9 reads its own parts (JEPSEN_PLAN=0, memo, faults, records):

1. The sweep kernel against its plain PyTorch version at the bench
   shapes (B = 8, SW = 1, K = 2048, W = the bench history's planned
   window) and at B = 1 and 32: sweep inputs recorded from a witness
   run on the bench history, plus random tables that die mid-block,
   start past 0, or end in padding, and the kernel's 32-barrier batch
   edges (starts 31 and 33, deaths at batch offsets 0 and 31, B = 1),
   recorded and random.  States, alive and death must match exactly.
   Times back-to-back launches of the kernel's wrapper (CUDA events:
   the JSON's `ms`; and the host clock) and the `sweep()` call the main
   path makes (wrapper, kernel, death read: `call_ms`, host clock; and
   CUDA events); sets the kernel's time beside its byte bound and
   beside its step floor (the library's chain probe: one lane's
   dependent per-barrier step with no loads and no vote, times the
   barriers).
2. The main path: `Linearizable(cas_register(), "wgl-tpu").check` on
   the 100k-op, 5%-info, 16-process cas-register history (seed 45100),
   warmed up first; median of 3 wall times, with the kernel's launch
   count, chain-search rounds and host syncs of those runs.
3. Under torch.profiler: the kernel's device time (`device_ms`) and
   the device operations of one `sweep()` call (the kernel and the
   death copy, each launch proven by the wrapper's count and its
   death; the profiler may record fewer, never more or others), then the
   back-to-back timing of phase 1 again; then one profiled device
   search of the main path: the card's busy time and idle share, its
   kernel launches and copies, and the sweep kernel's device time.
   Every host-clock and CUDA-event timing of phases 1 and 2 runs
   before the script first starts torch.profiler, so none is taken in
   a process the profiler has touched; the repeat shows what that
   changes.
4. The invalid path: `check_wgl_device` on a 2k-op history with an
   impossible read — the witness must die, the frontier BFS runs on the
   card, and the verdict (False) must equal the exact CPU engine's.
5. The many-key path, bench.py run_mixed's shape: `IndependentChecker(
   Linearizable(cas_register(), time_limit_s=120))` on 200 keys x 100
   ops (4 processes, 5% :info, seed i for key i, keys 0-29 bad); one
   warm-up (its sweep calls recorded), then a median of 3 with the
   settle memo cleared before each.  Must return valid False with 30
   failures, every per-key verdict equal to the exact CPU engine's.
   Reports ops/s (history length / 2 / median, the reference's metric),
   the keys each tier settled, and per check the stream passes and
   restarts, sweep launches, BFS levels and host syncs.  Then the same
   readings for an all-valid 2,000-key (200k-op) check.
6. The other models: a 120-key x 100-op history each of the mutex, a
   5-register multi-register, the FIFO and the unordered queue (every
   7th key bad, one long key past the ladder's 2,000-op bound), once
   recorded, once counted.  Every per-key verdict equals the exact CPU
   engine's and both of the model's sweep instantiations (plain and
   stream) launched.
1b. Every other sweep instantiation (each model plain and stream, the
   multi-register at 3 and 5 registers) against the plain version,
   exactly, on the calls recorded in phases 5 and 6 and on random tables
   at B = 1 and 32 with RESET barriers and batch-edge starts and
   deaths; then the instantiations of phases 5 and 6 timed on their
   longest recorded call.  Their device time is read in phase 3, and
   each one's registers and spills from the build's -Xptxas -v output.
   Also the batched BFS on each model's cohort recorded in phases 5
   and 6: levels, host syncs and wall time; the mutex cohort's device
   time in phase 3.
   Then the wide cases (`phase_wide`): every instantiation at beams of
   33 and 64 lanes (two 32-lane blocks joined), and the wide
   multi-register (33, 40 and 64 registers, state rows in shared
   memory) plain and stream at B = 1, 8, 32, 33 and 64, on random
   blocks of 2,048 barriers with batch edges and one lane group dead
   from the start, exactly as the plain version; a 120-key history of a
   40-register multi-register through IndependentChecker, every verdict
   the exact CPU engine's; the bench history through the witness at
   beam 64 (valid), and 40 of phase 5's keys at beam 64 against the
   exact engine; the sweeps these checks made, recorded as in phases 5
   and 6, exactly as the plain version; each new instantiation timed on
   its longest recorded call.  Then the lane-group cases
   (`phase_groups`): the register at beams of 96, 128 and 200 lanes
   (ceil(B / 32) blocks joined), and the wide multi-register at 1,723,
   6,891 and 55,133 words (31 and 8 lanes a block; rows in global
   memory) at B = 1, 8 and 33, against the plain version exactly; the
   bench history through the witness at beam 200; 6,891- and
   55,133-register histories through the witness at beam 8 against the
   exact CPU engine; their recorded sweeps; each new layout timed.
7. Online checking (streaming/, monitor/), each sub-phase counted on its
   own: (7a) the bench history replayed in 24 stable-prefix slices
   through FrontierCarry equals one check_wgl_witness at the same block
   knobs (valid, sweep launches, chain rounds); (7b) bench.py
   run_scale_online: a 1M-op random_register_packed stream in 24
   slices, warmed on 50k ops, valid, with its verdict lag and
   lag_fraction; (7c) a producer thread feeds the bench history through
   a StreamingSession and Linearizable takes the "wgl-online" verdict;
   (7d) phase 5's history through a keyed session, then
   IndependentChecker: 30 failures, every verdict the exact CPU
   engine's, 170 keys online; (7e) RollingChecker over a 200k-op stream
   with and without discards: equal verdicts, resident rows bounded.
8. Elle (checker/elle, ops/scc.py): seeded concurrent list-append and
   rw-register runs (`elle_ops`: 10 processes, 5% :info, the reference
   workloads' defaults) through AppendChecker / WrChecker on the card,
   under serializable and strict-serializable, median of 3 each.
   (8a) 1,000 committed list-append transactions: valid, screened at
   V = 1,024, result equal to device="off"; (8b) the same run with a
   G0, a G1c and a G-single injected: invalid, the anomaly types of
   device="off", every cycle extracted on the card (K = 4 layers at
   V = 1,024) a real closed cycle carrying its layer's edge type;
   (8b-chain) as 8b with one G-single whose cycle runs through a ww
   chain of 100 transactions, so the extraction's BFS walks 99 levels;
   (8c) rw-register, valid and with a G-single, as 8a and 8b; (8d) 512
   random graphs of 16-128 vertices through one screen call, flags
   equal host sccs(); (8e) 2,000 transactions, past the screen's 1,024
   vertices: host route, no device call, the verdict of device="off".
   Per check: wall time, host analysis time before the cycle search,
   closure and extraction ms (CUDA events), BFS levels, host syncs.
   Phase 3 profiles the closure, the extraction, one screen call and
   one 8b check.
9. The plan route (plan/, telemetry/): (9a) the bench history through
   Linearizable with JEPSEN_PLAN on, then off (off turns the cost model
   and the memo off, and still runs the plan): equal verdicts, labels,
   sweep launches, chain rounds and host syncs, every check through the
   plan executor, both walls printed; (9b) phase 5's history and the
   2,000-key all-valid one (once each) through IndependentChecker, on
   and off:
   equal per-key
   verdicts and labels, failure count, tiers, stream passes, restarts
   and sweep launches, the wgl.settle.* counters printed; (9c) the
   persistent plan memo in a temp directory: a second check of the
   bench history is a memo hit with no sweep launch, and again after
   the memo is dropped and its journal replayed (a restarted process);
   a new budget misses; (9d) the fault hook on a 2,000-op history:
   JEPSEN_WGL_FAULT=witness retries at half the block shape, falls
   through and the frontier BFS proves the history on the card; "all"
   raises after the halved retry with the card probe's result; (9e)
   telemetry on, a profile store: the records of one bench check and
   one phase 5 check equal the JAX package's (REF_PROFILE), name the
   card, and the Chrome trace loads.
10. The checker daemon (checkerd/, `phase_daemon`), in-process on
   127.0.0.1 on the card with its profile store, plan memo and queue
   journal in a temp dir: (10a) four threads submit a run_mixed-shaped
   history each (200 keys, 30 bad, seeds per run) through
   RemoteChecker into one cohort, every per-key verdict, algorithm and
   configs-explored the in-process check's, with each run's queue wait
   and check time and the daemon's overhead; (10b) the 2,000 valid
   keys as one packed submission; (10c) STATS (devices, chip health,
   the roofline against the H100's peaks, profile records) and a
   /metrics scrape with no SLO rule firing; (10d) a 0.001 s budget:
   unknown, and the next submission right; (10e) a daemon stopped with
   a journaled, unfinished ticket finishes it after a restart, and the
   settled history resubmitted hits the plan memo with no sweep.

11. A Jepsen test run through the port's CLI (`phase_run`): (11a)
   `cli test --dummy-ssh` of the north-star workload
   (linearizable_register, in-memory client) at 600 keys x 100 ops,
   threads-per-key 4, concurrency 32, noop nemesis: valid, every
   per-key verdict the exact CPU engine's on the stored history;
   (11b) 200 keys with a stale-read client on keys 0-29: invalid on
   exactly those keys; (11c) 200 keys with the online session: every
   key "wgl-online", equal to the post-hoc check, with its verdict lag;
   (11d) `cli analyze` of 11a's stored run: 11a's results; (11e)
   list-append at 1,000 transactions: the host search's verdict and
   anomaly types.  Each prints ops, run and analyze seconds, sweeps,
   host syncs and the card; the stored runs of 11a and 11b hold
   independent/<key>/{results.json,history.txt} for every failed key
   and up to 256 passing ones (printed as phase12d).
12. The packed member lanes and the witness checkpoint
   (`phase_packing`): (12a) the uint32 dedup hash on the card against a
   plain numpy uint32 multiply-add, bit for bit, on words with the top
   bit set at 1, 2 and 33 words; (12b) phase 4's history and the bench
   history through `check_wgl_device` with JEPSEN_WGL_PACKED on and
   then off: equal verdicts, sweeps and chain rounds, the BFS levels
   and configs explored printed; phase 6's FIFO cohort through the
   batched BFS the same way: no key decided differently (which keys
   overflow the beam to "unknown" depends on the children each hash
   keeps), and its whole check (settle included) with equal per-key
   verdicts; (12c) a 500k-op `random_register_packed` history:
   one fresh check, then one whose budget expires mid-search with a
   checkpoint directory, then a resume from the file: valid, fewer
   sweeps than the fresh run, the file gone; all three walls printed.
13. The stock workloads through the port's CLI on the card
   (`phase_workloads`): (13a) kafka at suites/logd.py's settings (4
   keys, transactions of up to 4 micro-ops, 1,024 writes a key, 16
   final polls, seed 45100, one worker), 1,000 ops: valid, its
   dependency graph of 600-1,000 vertices screened on the card (B7);
   (13b) the same with lose-acked and duplicate faults at rate 0.02:
   invalid with lost-write and duplicate, and the stored history's
   analysis on the CPU equal to the run's, element for element; (13c)
   200 G1c/G0 pairs of tests/test_kafka.py's cycle (400 vertices), rw
   edges off and on: the cycles extracted on the card (B8), the
   anomaly types of the host search of the same graph; (13d) kafka at
   20,000 ops: past the screen's 1,024 vertices, so the host search,
   as in the JAX package (vertices, route, run and analyze seconds);
   (13e) bank, long-fork, set, rw-register (800 transactions, screened
   on the card), adya-g2, causal, causal-reverse and total-queue with
   their in-memory clients for 3 s each: valid; adya-g2 with its racy
   client: invalid; the generic cycle checker asked for the card (its
   default is the host search) over rw-register's history and 13c's
   rw graph, screened there, its verdicts the host search's.  Each
   prints ops, run and analyze seconds, the graph's vertices and edges,
   the route and the screen's launches; the screen and extraction
   times are CUDA events.
14. The five demo suites against their real C++ servers
   (`phase_suites`): each suite's CLI (`main` of
   jepsen_tpu_torch.suites.*) with `--device cuda`, its server compiled
   with g++ from the checkout and run as daemons on this machine, each
   run on its own store directory and ports.  (14a) kvdb register with
   `--algorithm wgl-tpu` and kill faults: valid, killed at least once,
   the witness sweep (B1) launched, `cli analyze` on the CPU with the
   exact engine the same verdict; (14b) logd kafka without faults,
   1,000 ops: valid, its graph screened on the card (B7); (14c) logd
   kafka with kills and a 400 ms write-behind: the verdict and anomaly
   types of the stored run's CPU analysis; (14d) txnd rw-register under
   snapshot isolation (its elle-wr result the stored run's CPU
   analysis) and serializable (valid, screened on the card); (14e)
   repkv safe reads under partitions: valid, B1 launched; (14f) electd
   quorum under partitions: linearizable, partitioned; electd unsafe
   under partitions: the verdict of the stored run's CPU re-analysis.
   Each prints exit code, ops, verdict, route and the launches of B1,
   B7 and B8, and the phase the control process's uid and sudo; no
   server outlives its run.  Raises without g++.  Phases 11 and 14
   print `forensics_s` beside each run's analyze seconds: the
   `forensics.assemble` span of the dossiers `core.analyze` attaches to
   a bad verdict (forensics.py), read with telemetry on for the
   analysis alone (`AnalysisClock`).
15. Anomaly forensics and `jepsen search` (`phase_search`), the checks
   on the card: (15a) the JAX package's planted-bug search smoke on the
   port: `run_search` (seed 3, partition and kill, 8 shrink runs, a 35 s
   budget, the smoke's 60 cut to pay for phase 19) over a register that loses acknowledged writes only when a
   kill lands inside a partition, each iteration checked by
   `linearizable(cas_register(), "wgl-tpu")` beside the lost-write
   checker: coverage grows over the seed round, the anomaly is found and
   shrunk to at most three events composing both families, every corpus
   entry replays with its stable features, nothing is left for `jepsen
   repair`, every iteration's verdict is the exact CPU engine's on its
   stored history, B1 launched, and every convicting iteration's
   counterexample.json is refuted by the exact engine from the file;
   (15b) phase 11b's shape: 30 anomalies, 16 dossiers with
   counterexample.json, death.json, linear.svg and timeline.html, 14
   skipped, each minimal history shorter than its key's and refuted
   from its JSON, and `cli analyze --device cpu` of the stored run
   writing byte-identical counterexample.json files; (15c) `repkv
   search` against the real servers (two iterations, partition and
   kill): exit 0, each iteration's verdict its stored history's CPU
   re-analysis, no server left.
16. Jepsen against real nodes and the federated checker
   (`phase_remote`), every check on the card: (16a) three loopback
   SSH nodes (the port's minissh servers) and SshCliRemote through the
   port's `ssh`/`scp` shims: an exec and a 1 MiB scp round trip with
   equal checksums, then tests/test_ssh_localhost.py's kvdb run (kill
   faults, 4 s, the C++ server compiled on the node through SSH):
   valid or unknown, its stored history's `cli analyze --device cpu`
   the same per-key verdicts, B1 launched, the SSH and analyze seconds
   printed; (16b) where network namespaces work, the repkv kernel
   partition convicted and its safe-reads control valid, each as its
   CPU re-analysis, else a `{"netns": {"available": false, "why": ...}}`
   line; (16c) two `jepsen checkerd --device cuda` processes behind
   `jepsen checkerd-router`: two concurrent phase-10a runs through the
   router while the daemon holding their tickets is SIGKILLed inside
   its batch window (per-key valid and algorithm the in-process check's,
   a failover counted, the router's /metrics gauges), a journaled
   ticket surviving its daemon's SIGKILL and restart, and a run
   streamed through the router whose feed resumes after its connection
   is cut and a daemon killed (only the tail resent, the in-process
   verdicts), B1 launched in the daemon each time (their STATS);
   (16d) tools/chaos_smoke.py's schedule against a router and two
   daemons on the card: no lost verdict, an honest shed, identical
   replayed digests, the light tenant's p95 within 30 s, the overload
   gauges on /metrics, B1 launched in the daemons.
17. Standing verification (`phase_standing`): `jepsen monitor`,
   `jepsen fleet` and `jepsen serve` of the port.  (17a)
   tools/monitor_smoke.py's phase 2 in this process: `run_monitor` at
   MonitorConfig's default widths, 20,000 ops/s for 6 s, a synthetic
   SLO for 2 s and a file sink: the alert delivered once with its
   dossier and cleared once, every key proven, resident rows under
   25,000, B1 launched; the measured rate, the verdict lag's median and
   p95, and the card's peak allocated bytes.  Then, together: (17b)
   tools/live_monitor_smoke.py with monitor_smoke.py's phase 1: a
   `kvdb monitor --suite kvdb --device cuda` child against the kvdb
   server with kill and pause windows, SIGKILLed between an inject and
   its heal, a torn tail added to its series, and a second monitor on
   the same store (8 s, the smoke's 20 cut) with its dashboard: both
   families injected and healed, the residue swept, the search resumed
   and advanced, the series continuous, /api/series and the SSE stream
   served, exit 0 with every key proven (or 2 where each unknown key's
   frontier died with the witness unable to prove it, as the log
   says), B1 launched in the second monitor; (17c) tools/fleet_smoke.py: a FleetSupervisor over kvdb,
   logd and electd tenants teeing to 16d's router and daemons, kvdb's
   monitor and daemon 0 SIGKILLed, the daemon restarted 2 s later: the
   survivors' series and windows advance with no pre-kill point lost,
   kvdb restarted and its search resumed, no daemon or router dead
   unasked, every tenant under its retention budget, /api/fleet and the
   fleet's and a daemon's /metrics, a shed survivor still advancing, B1
   launched in the surviving daemon and in each tenant; (17d) `kvdb
   serve` on phase 11's store: `/` (11a's row valid), 11a's run page,
   file and zip, and 11e's telemetry page answer 200.
18. The witness's transfer modes and the port's jepsenlint.  (18a)
   `check_wgl_witness(transfer=m)` for "full", "indices" and "device"
   on phase 2's bench history: one warm run counted with telemetry on
   (B1 launches, host syncs, `wgl.h2d-bytes`), then the median of 3
   timed runs; valid in every mode with equal B1 launches.  Phase 4's
   invalid history, at the default block shape and at 64 barriers x 2
   blocks a chunk call, and a 20,000-op valid history at that shape:
   equal verdicts and death ranks across the modes.  (18b) `python -m
   jepsen_tpu_torch.analysis --json` as a subprocess: exit 0, clean
   against jepsen_tpu_torch/lint_baseline.json, no stale entry, under
   10 s by its own clock.
19. The mesh (parallel/mesh.py) on the one card, after every other
   phase, in one process with no process group.  (19a) `checker_mesh
   ({})` is None and `default_mesh()` spans `torch.cuda.device_count()`
   entries: the earlier phases' launch gates stand for the one-card
   path being today's.  (19b) Keys split over a two-entry mesh that
   names the card twice: phase 5's mixed history and a 40-key mutex
   history of phase 6's generator (whose bad keys reach the batched
   BFS) through `IndependentChecker` with the test map's "mesh",
   every per-key verdict the run's without it; phase 5's packed keys
   26-89 (4 bad) through `check_wgl_batched(mesh=)`, verdicts and
   explored counts the unsplit run's; phase 8d's graphs and the four 1,024-vertex
   graphs of 8a-8c (with one more, so the mesh pads) through
   `screen_cycles(mesh=)`, flags the unsplit screen's.  Each shard's
   device, keys and batched levels are printed, with the checks' B1
   launches (the stream tier, before the split).  (19c) The
   frontier-sharded BFS (B5) on the same mesh: phase 4's invalid
   2,000-op history and a valid one through `linearizable()` with
   "search-mesh" (the screen and the witness decide them first), then a
   500-op history of phase 4's generator through `check_wgl_device
   (mesh=)` itself and without the mesh: the verdicts, explored counts
   and BFS levels equal.
   No scaling is measured: both entries are one card.
20. The robustness layer and the differential soak on the card
   (`phase_soak`, tools/port_fault_matrix.py and tools/port_soak.py).
   (20a) The fault matrix's wgl-fault cell (JEPSEN_WGL_FAULT=witness:
   valid, the witness tier the only one degraded, the frontier BFS on
   the card proving the history; "all": `CardExhausted` out of the run
   with the card probe's result ok, the history stored) and its
   hanging-checker cell.  (20b) The fuzz soak's fixed schedule
   (SOAK_SEED_BASE, one round: every family at its smallest size, then
   at its next, to the extra sizes; one valid and one corrupt history
   each) under the SOAK_CAP_S wall cap, checked between histories, each
   history decided by `check_wgl_device` on the card and by the exact
   CPU engine: no mismatch, at least SOAK_MIN_VERDICTS decided verdicts
   of each kind, every family decided SOAK_MIN_FAMILY times, the
   2,600-op cas-register size decided at least once, and B1 launched.
   (20c) One round-5 batch (SOAK_R5_SEED): at least one planted
   violation, each convicted by the exact engine, every True of the
   stream witness the exact engine's, and three keys' witness verdicts
   and death ranks equal in the "full", "indices" and "device"
   transfer modes; B1 launched.

The last lines are the stages line (`{"stages_s": ...}`), the phase-20
JSON line (`{"soak": ...}`: 20a's cells, 20b's trials, decided and
unknown counts by family and size, and 20c's batch, each with its B1
launches and seconds), the phase-19
JSON line (`{"mesh": ...}`: each sub-phase's verdict gates, shards and
seconds), the phase-18
JSON line (`{"transfer": ..., "lint": ...}`: per mode the seconds, H2D
bytes, B1 launches and the gates' verdicts; the lint report's files,
counts and seconds), the phase-17
JSON line (`{"standing": ...}`: per sub-phase gates' readings, seconds
and B1 launches), the phase-16 JSON line (`{"federation": ...}`: per
sub-phase verdicts, seconds and the daemons' B1 launches), the phase-15
JSON line (per sub-phase: iterations,
coverage, cells, convictions and dossiers, B1 sweeps and seconds), the
phase-14 JSON line (per run: exit, ops, verdict,
route, B1 sweeps, B7 screens and B8 extractions, seconds; the card and
the host's privilege), the phase-13 JSON line (per sub-phase: verdicts,
vertices, routes, launches and seconds, and the card), the
device-program JSON line (the closure screen, the extraction and
phase 4's packed BFS level, plain PyTorch: time, launches per check,
bound; the packed level's bound counted from its live rows in one more
untimed run of phase 4's check with telemetry on), the
kernels JSON line (one entry per timed instantiation), the card's name
and power limit from nvidia-smi, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import random
import statistics
import subprocess
import sys
import time

BENCH_OPS, BENCH_PROCS, BENCH_INFO, BENCH_SEED = 100_000, 16, 0.05, 45100


# ---------------------------------------------------------------------------
# Seeded per-key histories of the other models (the tests use them too).
# Each generator returns one key's ops as dicts (type, f, value,
# process); `keyed_history` wraps them into a many-key history of either
# package.  Effects apply at completion, so a history is linearizable
# unless it is bad: a bad key ends with ops that no linearization
# allows, appended after every other op has completed.


def mutex_ops(n_ops: int, seed: int, bad: bool, procs: int = 4,
              info: float = 0.05) -> list:
    """Processes acquire and release one lock.  An acquire of a held
    lock fails; an acquire may end :info (it took the lock or not, by a
    coin); releases are determinate.  Bad: two :ok acquires in a row
    with no release between them."""
    rng = random.Random(seed)
    holder = None
    ops, pending = [], {}
    started = 0
    while started < n_ops or pending:
        p = rng.randrange(procs)
        if p in pending:
            f, as_info = pending.pop(p)
            if f == "acquire":
                if holder is None and (not as_info or rng.random() < 0.5):
                    holder = p
                typ = ("info" if as_info else
                       "ok" if holder == p else "fail")
            else:
                holder = None
                typ = "ok"
            ops.append(dict(type=typ, f=f, value=None, process=p))
        elif started < n_ops:
            f = "release" if holder == p else "acquire"
            pending[p] = (f, f == "acquire" and rng.random() < info)
            ops.append(dict(type="invoke", f=f, value=None, process=p))
            started += 1
    if bad:
        for p in (procs, procs + 1):
            ops += [dict(type="invoke", f="acquire", value=None, process=p),
                    dict(type="ok", f="acquire", value=None, process=p)]
    return ops


def multi_register_ops(n_ops: int, seed: int, bad: bool, n_regs: int = 5,
                       procs: int = 4, info: float = 0.05) -> list:
    """Reads and writes of `n_regs` registers r0.. (all 0 at first),
    values 0-4; a write may end :info (applied by a coin).  Bad: a read
    of a value never written."""
    rng = random.Random(seed)
    vals = [0] * n_regs
    ops, pending = [], {}
    started = 0
    while started < n_ops or pending:
        p = rng.randrange(procs)
        if p in pending:
            f, r, v, as_info = pending.pop(p)
            if f == "write" and (not as_info or rng.random() < 0.5):
                vals[r] = v
            typ = "info" if as_info else "ok"
            value = (f"r{r}", vals[r] if f == "read" else v)
            ops.append(dict(type=typ, f=f, value=value, process=p))
        elif started < n_ops:
            f = rng.choice(["read", "write"])
            r, v = rng.randrange(n_regs), rng.randrange(5)
            pending[p] = (f, r, v, f == "write" and rng.random() < info)
            ops.append(dict(type="invoke", f=f, process=p,
                            value=(f"r{r}", None if f == "read" else v)))
            started += 1
    if bad:
        ops += [dict(type="invoke", f="read", value=("r0", None),
                     process=procs),
                dict(type="ok", f="read", value=("r0", 99), process=procs)]
    return ops


def queue_ops(n_ops: int, seed: int, bad: bool, procs: int = 4,
              info: float = 0.05, cap: int = 20) -> list:
    """Enqueues of distinct values and dequeues of the head (a dequeue
    of an empty queue fails), at most `cap` values queued, so the packed
    queues' 32 slots hold every reachable state; an enqueue may end
    :info (applied by a coin); dequeues are determinate, so the history
    packs.  Valid for the FIFO and the unordered queue alike.  Bad: a
    dequeue of a value never enqueued."""
    rng = random.Random(seed)
    queue: list = []
    ops, pending = [], {}
    started = nxt = 0
    while started < n_ops or pending:
        p = rng.randrange(procs)
        if p in pending:
            f, v, as_info = pending.pop(p)
            if f == "enqueue":
                if not as_info or rng.random() < 0.5:
                    queue.append(v)
                typ = "info" if as_info else "ok"
            elif queue:
                v, typ = queue.pop(0), "ok"
            else:
                typ = "fail"
            ops.append(dict(type=typ, f=f, value=v, process=p))
        elif started < n_ops:
            in_flight = sum(1 for q in pending.values() if q[0] == "enqueue")
            f = ("dequeue" if len(queue) + in_flight >= cap
                 else rng.choice(["enqueue", "dequeue"]))
            v = None
            if f == "enqueue":
                v, nxt = nxt, nxt + 1
            pending[p] = (f, v, f == "enqueue" and rng.random() < info)
            ops.append(dict(type="invoke", f=f, value=v, process=p))
            started += 1
    if bad:
        ops += [dict(type="invoke", f="dequeue", value=None, process=procs),
                dict(type="ok", f="dequeue", value=10**6, process=procs)]
    return ops


def keyed_history(gen, n_keys: int, n_ops: int, bad_keys, *, Op, kv,
                  history, long_key_ops: int = 0, **gen_kw):
    """A many-key history: key "k<i>" carries gen(n_ops, seed=i, bad=i in
    bad_keys, **gen_kw); with `long_key_ops`, one more valid key "long"
    of that many ops with no :info ops (past the ladder's long-key
    bound, and packable: an :info enqueue that never lands counts
    against a packed queue's capacity for good) is appended.  `Op`,
    `kv` and `history` are either package's."""
    ops = []
    keys = [(f"k{i}", n_ops, i, i in bad_keys, gen_kw)
            for i in range(n_keys)]
    if long_key_ops:
        keys.append(("long", long_key_ops, n_keys, False,
                     {**gen_kw, "info": 0.0}))
    for key, n, seed, bad, kw in keys:
        for d in gen(n, seed=seed, bad=bad, **kw):
            ops.append(Op(**{**d, "value": kv(key, d["value"])}))
    return history(ops)


def model_specs() -> list:
    """Phase 6's models: (name, model factory, generator, generator
    kwargs).  The FIFO queue's history has no :info enqueues and three
    processes: with either, the exact CPU engine that every verdict is
    held against runs past its budget on some keys (5M configurations
    on 60-op keys)."""
    from jepsen_tpu_torch import models as M

    return [
        ("mutex", M.mutex, mutex_ops, {}),
        ("multi-register",
         lambda: M.multi_register({f"r{i}": 0 for i in range(5)}),
         multi_register_ops, {}),
        ("fifo-queue", M.fifo_queue, queue_ops, {"procs": 3, "info": 0.0}),
        ("unordered-queue", M.unordered_queue, queue_ops, {}),
    ]


#: Invocations of phase 6's long key per model: past the ladder's 2,000
#: packed ops (a failed acquire packs to nothing, so the mutex needs
#: more), so the models' plain (non-stream) instantiations run too.
LONG_KEY_OPS = {"mutex": 6000}
LONG_KEY_OPS_DEFAULT = 2600


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of `fn` on the card (CUDA events
    around `reps` back-to-back calls, after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int) -> float:
    """Mean milliseconds per call, host clock, synchronized."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def chain_step_ns(torch) -> float:
    """Nanoseconds per barrier of one lane's dependent step chain with
    no loads and no vote (the kernel library's chain probe), from CUDA
    events around probes of N and 2N steps, so the launch cost
    cancels."""
    from jepsen_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    n = 1 << 20
    t_n = cuda_ms(lambda: kernels.sweep_chain_probe(n, dev), reps=5)
    t_2n = cuda_ms(lambda: kernels.sweep_chain_probe(2 * n, dev), reps=5)
    return (t_2n - t_n) * 1e6 / n


def profile_device(torch, fn, reps: int, warm: bool = True) -> dict:
    """{name: (count, microseconds)} of the kernels and copies that
    torch.profiler saw on the card over `reps` calls of `fn` (after a
    warm-up call, unless `warm` is false because the caller ran `fn`
    already).  It records the card's activity alone: nothing here
    reads the host's operators, and recording them made the windows of
    many launches (the batched BFS's ~200,000) about three times
    slower."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    seen = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            n, us = seen.get(e.key, (0, 0.0))
            seen[e.key] = (n + e.count, us + e.self_device_time_total)
    return seen


def phase_kernel(torch, packed, pm, W, seed: int) -> tuple:
    """Kernel vs plain on recorded and random inputs; returns the
    kernel's JSON entry (launches and the profiler's numbers filled in
    later) and the timed cases, for `phase_profile`."""
    import numpy as np

    from jepsen_tpu_torch.ops import kernels, wgl_witness
    from jepsen_tpu_torch.ops.wgl_witness import sweep, sweep_plain
    from jepsen_tpu_torch.telemetry import roofline

    dev = torch.device("cuda")
    step_rows = pm.torch_step_rows
    K = wgl_witness.BARS_PER_BLOCK

    # Record the sweep inputs of one witness run on the bench history.
    recorded = []
    real_sweep = wgl_witness.sweep

    def recording_sweep(pm_, start_k, bars, member, states, alive,
                        init=None):
        out = real_sweep(pm_, start_k, bars, member, states, alive, init)
        recorded.append((start_k, bars, member, states, alive, out[2]))
        return out

    wgl_witness.sweep = recording_sweep
    try:
        res = wgl_witness.check_wgl_witness(packed, pm, device=dev)
    finally:
        wgl_witness.sweep = real_sweep
    if res is None or res.valid is not True:
        raise AssertionError(f"witness on the bench history: {res}")
    log(f"phase1: recorded {len(recorded)} sweep calls from the bench "
        f"witness (W={recorded[0][2].shape[0]}, B={recorded[0][2].shape[1]})")

    def run_kernel(start_k, bars, member, states, alive):
        s, al, d = kernels.witness_sweep(pm.kernel_model, start_k, bars,
                                         member, states, alive)
        return s, al, int(d.item())

    def lane0(r):
        """A recorded input cut to its first beam lane (B = 1)."""
        return (r[0], r[1], r[2][:, :1].contiguous(), r[3][:1], r[4][:1])

    def at_offset(r, off):
        """Recorded call `r` restarted at d - 32 - off (d its death), so
        that d falls at offset `off` of the kernel's second 32-barrier
        batch; the states and alive there are the plain sweep's from the
        recorded start (run on the table cut short at the new start)."""
        start_k, bars, member, states, alive, d = r
        s2 = d - 32 - off
        if not start_k <= s2 < d < bars.shape[1]:
            raise AssertionError(f"recorded sweep {start_k}..{d} is too "
                                 f"short for a death at offset {off}")
        st, al, end = sweep_plain(start_k, bars[:, :s2].contiguous(),
                                  member, states, alive, step_rows)
        if end != s2:
            raise AssertionError(f"recorded sweep died at {end} < {s2}")
        return (s2, bars, member, st.contiguous(), al.contiguous())

    cases = []
    # Recorded: the first call, the longest sweep, calls that start
    # mid-block (after a chain search), the longest death's barrier moved
    # to batch offsets 0 and 31, the first call started at 31 and 33,
    # and lane 0 alone.
    first = recorded[0]
    longest = max(recorded, key=lambda r: min(r[5], r[1].shape[1]) - r[0])
    mid = [r for r in recorded if r[0] > 0][:12]
    for name, r in ([("bench-first", first), ("bench-longest", longest)]
                    + [(f"bench-resume{i}", r) for i, r in enumerate(mid)]):
        cases.append((name, r[:5]))
    dying = max((r for r in recorded if r[5] < K), key=lambda r: r[5] - r[0])
    cases += [(f"bench-death@{off}", at_offset(dying, off))
              for off in (0, 31)]
    cases += [("bench-first-start31", (31,) + first[1:5]),
              ("bench-first-start33", (33,) + first[1:5]),
              ("bench-first-B1", lane0(first)),
              ("bench-longest-B1", lane0(longest))]

    # Random tables at B = 1, 8 and 32 (bit 31 = lane 31).
    rng = np.random.default_rng(seed)
    for B in (1, 8, 32):
        member_np = rng.random((W, B)) < 0.3
        member_np[:, 0] = True  # lane 0 passes: the clean table runs to K
        member = torch.from_numpy(member_np).to(dev)
        states = torch.from_numpy(
            rng.integers(0, 5, size=(B, 1)).astype(np.int32)).to(dev)
        alive_np = rng.random(B) < 0.7
        alive_np[0] = True
        alive = torch.from_numpy(alive_np).to(dev)
        bars = np.zeros((6, K), dtype=np.int32)
        # Columns below W - 1: only the planted barriers name the
        # empty row W - 1, so lane 0 dies nowhere else.
        bars[0] = rng.integers(0, W - 1, size=K)
        bars[1] = np.arange(K)
        bars[2] = 1
        bars[3] = rng.integers(0, 3, size=K)
        bars[4] = rng.integers(0, 5, size=K)
        bars[5] = rng.integers(0, 5, size=K)
        pad_from = K - 300
        bars[2, pad_from:] = 0  # a padding tail: nothing real to die on
        clean_np = bars.copy()
        clean = torch.from_numpy(clean_np).to(dev)
        member_p = member.clone()
        member_p[W - 1] = False
        if B == 32:
            member_p[: W - 1, 31] = True  # the sign bit in every word

        def planted_at(k):
            """The clean table with a read of a value nobody holds at
            barrier k, at a window column with no member bits (lane 0
            must step it too)."""
            b = clean_np.copy()
            b[0, k], b[3, k], b[4, k] = W - 1, 0, 99
            return torch.from_numpy(b).to(dev)

        planted = planted_at(K // 2)
        cases += [
            (f"rand{B}-clean", (0, clean, member, states, alive)),
            (f"rand{B}-death", (0, planted, member_p, states, alive)),
            (f"rand{B}-after-death", (K // 2 + 1, planted, member_p,
                                      states, alive)),
            (f"rand{B}-padding", (pad_from + 5, planted, member_p, states,
                                  alive)),
        ]
        # Batch edges: starts 31 and 33, deaths at batch offsets 0 and 31.
        for start in (31, 33):
            for off in (0, 31):
                cases.append((f"rand{B}-start{start}-death@{off}",
                              (start, planted_at(start + 5 * 32 + off),
                               member_p, states, alive)))

    max_err = 0
    for name, (start_k, bars, member, states, alive) in cases:
        ks, ka, kd = run_kernel(start_k, bars, member, states, alive)
        ps, pa, pd = sweep_plain(start_k, bars, member, states, alive,
                                 step_rows)
        torch.cuda.synchronize()
        max_err = max(max_err, abs(kd - pd),
                      int((ks.long() - ps.long()).abs().max()),
                      int((ka.long() - pa.long()).abs().max()))
        if not (torch.equal(ks, ps) and torch.equal(ka, pa) and kd == pd):
            raise AssertionError(
                f"witness_sweep != sweep_plain on {name}: death {kd} vs "
                f"{pd}, states equal {torch.equal(ks, ps)}, alive equal "
                f"{torch.equal(ka, pa)}")
        want_off = name.rpartition("@")[2] if "@" in name else None
        if want_off is not None and (kd >= K or (kd - start_k) % 32
                                     != int(want_off)):
            raise AssertionError(f"{name}: death {kd} from start {start_k} "
                                 f"is not at batch offset {want_off}")
        log(f"phase1: {name:>24} start={start_k:5d} death={kd:5d} "
            f"B={member.shape[1]:2d} match")

    step_ns = chain_step_ns(torch)
    log(f"phase1: per-lane step floor {step_ns:.4f} ns per barrier "
        f"(dependent register step chain, no loads, no vote)")

    def timed(name):
        """One case's numbers: back-to-back launches of the kernel's
        wrapper (CUDA events and host clock), the sweep() call as the
        main path makes it (wrapper, kernel, death read; host clock and
        CUDA events), the plain version, the byte bound for this input,
        and its barriers times the step floor."""
        start_k, bars, member, states, alive = dict(cases)[name]
        _, _, death = run_kernel(start_k, bars, member, states, alive)
        swept = min(death, K - 1) - start_k + 1

        def kernel():
            kernels.witness_sweep(pm.kernel_model, start_k, bars, member,
                                  states, alive)

        def call():
            return sweep(pm, start_k, bars, member, states, alive)[2]

        ms = cuda_ms(kernel, reps=200)
        ms_host = wall_ms(kernel, reps=200)
        call_ms = wall_ms(call, reps=200)
        call_ms_events = cuda_ms(call, reps=200)
        plain = wall_ms(lambda: sweep_plain(
            start_k, bars, member, states, alive, step_rows), reps=3)
        nbytes = roofline.sweep_bytes(start_k, death, K, bars[0].tolist(),
                                      member.shape[1], states.shape[1])
        bound = nbytes / roofline.H100_BYTES_PER_S * 1e3
        floor = swept * step_ns / 1e6
        log(f"phase1: timing {name}: {swept} barriers, kernel {ms:.6f} ms "
            f"back to back (CUDA events; {ms * 1e6 / swept:.4f} ns/barrier; "
            f"host clock {ms_host:.6f} ms), sweep() call {call_ms:.6f} ms "
            f"host clock / {call_ms_events:.6f} ms events, plain "
            f"{plain:.3f} ms, bound {bound:.9f} ms ({nbytes} B at "
            f"{roofline.H100_BYTES_PER_S:.3g} B/s), step floor "
            f"{floor:.6f} ms")
        return dict(name=name, swept=swept, death=death, ms=ms,
                    ms_host=ms_host, call_ms=call_ms,
                    call_ms_events=call_ms_events,
                    plain=plain, bound=bound, floor=floor, kernel=kernel,
                    call=call)

    # The JSON line reports the longest real sweep of the main path; the
    # full random block (K barriers) is printed beside it.
    timings = [timed("bench-longest"), timed("rand8-clean")]
    t = timings[0]
    log("phase1: library_ms null: no single PyTorch call computes an "
        "early-exit serial sweep")
    entry = {
        "name": "witness_sweep",
        "route": "cuda",
        "source": "jepsen_tpu_torch/csrc/witness_sweep.cu",
        "replaces": "jepsen_tpu/ops/wgl_witness.py:332",
        "launches": 0,
        "max_abs_err": max_err,
        "ms": t["ms"],
        "call_ms": t["call_ms"],
        "plain_ms": t["plain"],
        "bound_ms": t["bound"],
        "bound_by": "bytes",
        "library_ms": None,
        "ms_host": t["ms_host"],
        "call_ms_events": t["call_ms_events"],
        "chain_floor_ms": t["floor"],
        "chain_step_ns": step_ns,
        "barriers_timed": t["swept"],
        "cases_matched": len(cases),
    }
    return entry, timings


def phase_profile(torch, entry: dict, timings: list) -> None:
    """The kernel's device time on each timed case and the device
    operations of one sweep() call, from torch.profiler, added to
    `entry`; then phase 1's first back-to-back timing again, so the log
    shows what a process that has run the profiler pays per launch."""
    for t in timings:
        seen = profile_device(torch, t["kernel"], reps=200)
        n, us = next(v for k, v in seen.items() if "witness_sweep" in k)
        t["device_ms"] = us / n / 1e3
        log(f"profile: {t['name']}: kernel device time "
            f"{t['device_ms']:.6f} ms ({t['device_ms'] * 1e6 / t['swept']:.4f}"
            f" ns/barrier; {t['device_ms'] / t['floor']:.3f}x the step "
            f"floor)")
    # One sweep() call makes two device operations: the kernel and the
    # death copy.  torch.profiler can drop a record from its window
    # (PERF.md §7), so what the call made is proven apart from what the
    # profiler saw: the wrapper counts each launch, and the calls
    # alternate between two cases whose deaths differ, so a call whose
    # kernel did not run would read the other case's death from a
    # reused buffer.  Each kind may then show fewer records than calls
    # (logged, and counted in the entry), never more, and no other
    # operation may show at all.
    reps = 20
    pair = timings[:2]
    if pair[0]["death"] == pair[1]["death"]:
        raise AssertionError(f"the timed cases share death "
                             f"{pair[0]['death']}")
    deaths = []

    def call():
        t = pair[len(deaths) % 2]
        deaths.append((t["call"](), t["death"]))

    from jepsen_tpu_torch.ops import kernels

    before = kernels.launches["witness_sweep"]
    seen = profile_device(torch, call, reps=reps)
    launched = kernels.launches["witness_sweep"] - before
    wrong = [(got, want) for got, want in deaths if got != want]
    if launched != reps + 1 or len(deaths) != reps + 1 or wrong:
        raise AssertionError(
            f"{len(deaths)} sweep() calls (one a warm-up) launched the "
            f"kernel {launched} times; wrong deaths {wrong}")
    kinds = {"kernel": [n for k, (n, _) in seen.items()
                        if "witness_sweep" in k],
             "copy": [n for k, (n, _) in seen.items()
                      if "Memcpy DtoH" in k]}
    other = [k for k in seen
             if "witness_sweep" not in k and "Memcpy DtoH" not in k]
    recorded = {kind: sum(ns) for kind, ns in kinds.items()}
    if other or any(n > reps for n in recorded.values()):
        raise AssertionError(
            f"sweep() made device operations past the kernel and the "
            f"death copy in {reps} calls: {seen}")
    lost = 2 * reps - sum(recorded.values())
    ops_per_call = sum(recorded.values()) / reps
    log(f"profile: sweep() call: {ops_per_call:g} device operations per "
        f"call recorded ({sorted(seen)}); the wrapper counted {launched} "
        f"launches of {len(deaths)} calls, every death right; "
        f"{lost} records lost by the profiler")
    t = timings[0]
    again = cuda_ms(t["kernel"], reps=200)
    log(f"profile: {t['name']}: kernel back to back {again:.6f} ms (CUDA "
        f"events) after torch.profiler ran; {t['ms']:.6f} ms before")
    entry.update(device_ms=t["device_ms"], device_ops_per_call=ops_per_call,
                 profiler_lost_ops=lost, ms_after_profiler=again)


def phase_main(torch, history, n_packed: int) -> dict:
    from jepsen_tpu_torch import device as D
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import kernels
    from jepsen_tpu_torch.utils.histgen import random_register_history

    warm = random_register_history(4096, procs=BENCH_PROCS,
                                   info_rate=BENCH_INFO, seed=7)
    out = Linearizable(cas_register(), "wgl-tpu").check({}, warm, {})
    if out["valid"] is not True:
        raise AssertionError(f"warm-up verdict {out}")
    torch.cuda.synchronize()

    kernels.launches.clear()
    D.counters.clear()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = Linearizable(cas_register(), "wgl-tpu").check({}, history, {})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if out["valid"] is not True or out["algorithm"] != "wgl-tpu":
            raise AssertionError(f"main path verdict {out}")
    launches = kernels.launches["witness_sweep"]
    counts = dict(D.counters)
    if launches <= 0:
        raise AssertionError("main path made no witness_sweep launch")
    med = statistics.median(times)
    r = {
        "wall_s": times,
        "median_s": med,
        "ops_per_s": n_packed / med,
        "sweep_launches": launches,
        "sweep_launches_per_check": launches / 3,
        "heavy_rounds_per_check": counts.get("heavy_rounds", 0) / 3,
        "host_syncs_per_check": counts.get("host_syncs", 0) / 3,
    }
    log("phase2: " + json.dumps(r))
    return r


def breakdown(torch, history) -> dict:
    """Where one main-path check spends its time, stage by stage (host
    clock), and the card's busy time in the device search from
    torch.profiler.  Runs after the counted runs."""
    from jepsen_tpu_torch.checker.refute import check_refute
    from jepsen_tpu_torch.history.packed import pack_history
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops.wgl import check_wgl_device

    pm = cas_register().packed()
    t0 = time.perf_counter()
    packed = pack_history(history, pm.encode)
    t_pack = time.perf_counter() - t0
    t0 = time.perf_counter()
    if check_refute(packed, pm) is not None:
        raise AssertionError("refutation screen fired on a valid history")
    t_refute = time.perf_counter() - t0
    walls = []

    def search():
        t0 = time.perf_counter()
        check_wgl_device(packed, pm, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    # One search before the profiler starts, one under it.
    seen = profile_device(torch, search, reps=1)
    t_device, t_prof = walls
    kernels_us = {k: us for k, (_, us) in seen.items()}
    n_copies = sum(n for k, (n, _) in seen.items()
                   if k.startswith(("Memcpy", "Memset")))
    n_kernels = sum(n for n, _ in seen.values()) - n_copies
    busy_s = sum(kernels_us.values()) / 1e6
    sweep_us = sum(us for k, us in kernels_us.items()
                   if "witness_sweep" in k)
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:8]
    return {
        "pack_s": t_pack,
        "refute_s": t_refute,
        "device_search_s": t_device,
        "profiled_device_search_s": t_prof,
        "device_busy_s": busy_s,
        "device_idle_share": (1.0 - busy_s / t_prof) if busy_s else None,
        "device_kernel_launches_per_check": n_kernels,
        "device_copies_per_check": n_copies,
        "sweep_kernel_us": sweep_us,
        "top_device_kernels_us": top,
    }


def phase_invalid(torch) -> dict:
    from jepsen_tpu_torch import device as D
    from jepsen_tpu_torch.checker.wgl_cpu import check_wgl_cpu
    from jepsen_tpu_torch.history.packed import pack_history
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import kernels
    from jepsen_tpu_torch.ops.wgl import check_wgl_device
    from jepsen_tpu_torch.ops.wgl_witness import check_wgl_witness
    from jepsen_tpu_torch.utils.histgen import random_register_history

    pm = cas_register().packed()
    h = random_register_history(2000, procs=8, info_rate=0.0,
                                seed=BENCH_SEED, bad=True)
    packed = pack_history(h, pm.encode)
    info: dict = {}
    if check_wgl_witness(packed, pm, out_info=info, device="cuda") is not None:
        raise AssertionError("witness found a linearization of a bad history")
    kernels.launches.clear()
    D.counters.clear()
    t0 = time.perf_counter()
    res = check_wgl_device(packed, pm, time_limit_s=300, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    levels = D.counters.get("bfs_levels", 0)
    cpu = check_wgl_cpu(packed, pm)
    if res.valid is not False or cpu.valid is not False or levels <= 0:
        raise AssertionError(
            f"invalid path: device {res.valid} ({res.reason}), cpu "
            f"{cpu.valid}, bfs levels {levels}")
    r = {
        "ops": packed.n,
        "died_at_rank": info.get("died_at_rank"),
        "device_valid": res.valid,
        "cpu_valid": cpu.valid,
        "wall_s": dt,
        "bfs_levels": levels,
        "sweep_launches": kernels.launches["witness_sweep"],
        "host_syncs": D.counters.get("host_syncs", 0),
    }
    r["b9"] = packed_bfs_bound(torch, packed, pm, dev="cuda")
    log("phase4: " + json.dumps(r))
    return r


def packed_bfs_entry(bad: dict) -> dict:
    """The device-program entry of B9 (the packed BFS level, plain
    PyTorch) for the JSON line before the kernels line: phase 4's levels
    and check wall, and the bound its live rows need."""
    import inspect

    from jepsen_tpu_torch.ops import wgl

    b9 = bad["b9"]
    return {"name": "packed_bfs_level", "route": "torch",
            "source": "jepsen_tpu_torch/ops/wgl.py:"
                      f"{inspect.getsourcelines(wgl._expand_level_packed)[1]}",
            "replaces": "jepsen_tpu/ops/wgl.py:145",
            "launches": bad["bfs_levels"], "check_wall_ms": bad["wall_s"] * 1e3,
            "bytes": b9["bytes"], "operations": b9["operations"],
            "bound_ms": b9["bound_ms"], "bound_by": b9["bound_by"],
            "bound_ms_per_level": b9["bound_ms"] / b9["levels"],
            "library_ms": None}


def packed_bfs_bound(torch, packed, pm, dev) -> dict:
    """B9's bound: the same check once more on `dev`, untimed, with
    telemetry on, so each packed BFS level counts the bytes and operations its
    live rows need (roofline.packed_level_cost); the bound is the
    larger of the bytes at the H100's memory rate and the operations at
    its peak rate."""
    from jepsen_tpu_torch import device as D
    from jepsen_tpu_torch import telemetry
    from jepsen_tpu_torch.ops import wgl
    from jepsen_tpu_torch.telemetry import roofline

    names = ("wgl.bfs.packed_bytes", "wgl.bfs.packed_ops")
    was = telemetry.enabled()
    before = [telemetry.counter_value(n) for n in names]
    D.counters.clear()
    telemetry.enable(True)
    try:
        res = wgl.check_wgl_device(packed, pm, time_limit_s=300,
                                   device=dev, packed_lanes=True)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
    finally:
        telemetry.enable(was)
    n_bytes, n_ops = (telemetry.counter_value(n) - b
                      for n, b in zip(names, before))
    levels = D.counters.get("bfs_levels", 0)
    if res.valid is not False or levels <= 0 or n_bytes <= 0:
        raise AssertionError(f"B9 bound run: {res.valid}, {levels} levels, "
                             f"{n_bytes} bytes")
    ms, by = roofline.bound(n_ops, n_bytes)
    return {"levels": levels, "bytes": n_bytes, "operations": n_ops,
            "bound_ms": ms, "bound_by": by}


# ---------------------------------------------------------------------------
# The many-key path (phases 5 and 6) and the sweep kernel's other
# instantiations (phase 1b).

MIXED_KEYS, MIXED_OPS, MIXED_BAD = 200, 100, 30  # bench.py run_mixed
BIG_KEYS = 2000  # the all-valid check: 200k ops
#: Phase 6's keys a model (200 until phase 19's time was paid for).
MODEL_KEYS, MODEL_OPS = 120, 100


def instantiation(pm, beam: int = 1) -> str:
    """The sweep kernel instantiation `pm` runs over `beam` lanes, as
    `kernels.launches` counts it (`kernels.instantiation_name`)."""
    from jepsen_tpu_torch.ops import kernels

    return kernels.instantiation_name(pm.kernel_model, pm.state_width,
                                      pm.stream, beam)


class SweepRecorder:
    """While entered, records the sweep() calls of the checks it wraps,
    per kernel instantiation: the first `first` calls and the longest
    (in barriers swept), inputs cloned, with the death each returned;
    and each model's first batched-BFS call (its packs and arguments)."""

    def __init__(self, first: int = 3):
        self.first = first
        self.calls: dict = {}
        self.longest: dict = {}
        self.batched: dict = {}

    def __enter__(self):
        from jepsen_tpu_torch.ops import wgl_batched, wgl_witness

        self._real = real = wgl_witness.sweep
        self._real_batched = real_batched = wgl_batched.check_wgl_batched

        def recording_batched(packs, pm, **kw):
            self.batched.setdefault(pm.name, (list(packs), pm, kw))
            return real_batched(packs, pm, **kw)

        wgl_batched.check_wgl_batched = recording_batched

        def recording(pm, start_k, bars, member, states, alive, init=None):
            out = real(pm, start_k, bars, member, states, alive, init)
            name = instantiation(pm, member.shape[1])
            span = min(out[2], bars.shape[1] - 1) - start_k
            calls = self.calls.setdefault(name, [])
            best = self.longest.get(name)
            longer = best is None or span > best["span"]
            if len(calls) < self.first or longer:
                call = dict(pm=pm, start_k=start_k, span=span, death=out[2],
                            args=tuple(t.clone() for t in
                                       (bars, member, states, alive)),
                            init=None if init is None else init.clone())
                if len(calls) < self.first:
                    calls.append(call)
                if longer:
                    self.longest[name] = call
            return out

        wgl_witness.sweep = recording
        return self

    def __exit__(self, *exc):
        from jepsen_tpu_torch.ops import wgl_batched, wgl_witness

        wgl_witness.sweep = self._real
        wgl_batched.check_wgl_batched = self._real_batched
        return False


def mixed_history(n_keys: int, n_bad: int, seed0: int = 0):
    """bench.py run_mixed's history: `n_keys` cas-register keys "k<i>"
    of MIXED_OPS ops (4 processes, 5% :info, seed seed0 + i), keys 0 ..
    n_bad - 1 with a planted violation."""
    from jepsen_tpu_torch.history.core import history
    from jepsen_tpu_torch.parallel import kv
    from jepsen_tpu_torch.utils.histgen import random_register_history

    ops = []
    for i in range(n_keys):
        h = random_register_history(MIXED_OPS, procs=4, info_rate=0.05,
                                    seed=seed0 + i, bad=i < n_bad)
        ops += [o.replace(value=kv(f"k{i}", o.value)) for o in h]
    return history(ops)


def check_exact(what: str, make_model, history, res: dict) -> None:
    """Holds every per-key verdict of `res` against the exact CPU
    engine's on that key's subhistory; raises on a difference or on a
    key the exact engine could not decide."""
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.parallel import subhistories

    diff = {}
    for k, h in subhistories(history).items():
        want = Linearizable(make_model(), "cpu", time_limit_s=120,
                            device="cpu").check({}, h, {})["valid"]
        got = res["results"][k]["valid"]
        if want not in (True, False) or got != want:
            diff[k] = (got, want)
    if diff:
        raise AssertionError(f"{what}: per-key verdicts differ from the "
                             f"exact CPU engine's (got, exact): "
                             f"{dict(list(diff.items())[:8])}")


def many_key_run(torch, checker, history, reps: int) -> tuple:
    """`reps` checks of `history` by `checker`, the settle memo cleared
    before each; the counts are set to 0 before the first and read after
    the last -> (last result, readings per check)."""
    from jepsen_tpu_torch import device as D
    from jepsen_tpu_torch.ops import kernels
    from jepsen_tpu_torch.parallel import clear_settle_memo

    kernels.launches.clear()
    D.counters.clear()
    times = []
    for _ in range(reps):
        clear_settle_memo()
        t0 = time.perf_counter()
        res = checker.check({}, history, {})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k: v for k, v in kernels.launches.items()
                if k.startswith("witness_sweep[")}
    counts = dict(D.counters)
    med = statistics.median(times)
    per = {name: counts.get(name, 0) / reps for name in (
        "stream_passes", "stream_restarts", "stream_keys_proven",
        "heavy_rounds", "bfs_levels", "host_syncs")}
    r = {
        "ops": len(history) // 2,
        "keys": res["key-count"],
        "valid": res["valid"],
        "failure_count": res["failure-count"],
        "wall_s": times,
        "median_s": med,
        "ops_per_s": len(history) / 2 / med,
        "tiers": res["tiers"],
        "per_check": {**per, "sweep_launches":
                      kernels.launches["witness_sweep"] / reps},
        "launches": launches,
    }
    return res, r


def phase_mixed(torch, recorder: SweepRecorder) -> dict:
    """Phase 5: bench.py run_mixed's shape on the card, then the
    all-valid 2,000-key check."""
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.parallel import IndependentChecker, \
        clear_settle_memo

    chk = IndependentChecker(Linearizable(cas_register(), time_limit_s=120))
    h = mixed_history(MIXED_KEYS, MIXED_BAD)
    clear_settle_memo()
    with recorder:
        warm = chk.check({}, h, {})  # warm-up: not counted, recorded
    res, r = many_key_run(torch, chk, h, reps=3)
    for out in (warm, res):
        if out["valid"] is not False or out["failure-count"] != MIXED_BAD:
            raise AssertionError(
                f"phase5: valid {out['valid']}, {out['failure-count']} "
                f"failures; want False with {MIXED_BAD}")
    if r["launches"].get("witness_sweep[register+stream]", 0) <= 0:
        raise AssertionError("phase5: the stream instantiation never ran")
    check_exact("phase5", cas_register, h, res)
    log("phase5: mixed " + json.dumps(r))
    big = mixed_history(BIG_KEYS, 0)
    res_b, rb = many_key_run(torch, chk, big, reps=3)
    if res_b["valid"] is not True or res_b["failure-count"]:
        raise AssertionError(f"phase5: all-valid check gave "
                             f"{res_b['valid']} ({res_b['failure-count']} "
                             f"failures)")
    log("phase5: all-valid " + json.dumps(rb))
    return {"mixed": r, "all_valid": rb}


def phase_models(torch, recorder: SweepRecorder) -> dict:
    """Phase 6: a 120-key history of each other model (every 7th key
    bad, plus one long key), once recorded, then once counted; every
    per-key verdict equals the exact CPU engine's, and both of the
    model's instantiations ran."""
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.history.core import Op, history
    from jepsen_tpu_torch.parallel import IndependentChecker, \
        clear_settle_memo, kv

    out = {}
    for name, make, gen, kw in model_specs():
        bad = set(range(0, MODEL_KEYS, 7))
        h = keyed_history(gen, MODEL_KEYS, MODEL_OPS, bad, Op=Op, kv=kv,
                          history=history, long_key_ops=LONG_KEY_OPS.get(
                              name, LONG_KEY_OPS_DEFAULT), **kw)
        chk = IndependentChecker(Linearizable(make(), time_limit_s=120))
        clear_settle_memo()
        with recorder:
            chk.check({}, h, {})
        res, r = many_key_run(torch, chk, h, reps=1)
        for inst in (f"witness_sweep[{name}]",
                     f"witness_sweep[{name}+stream]"):
            if r["launches"].get(inst, 0) <= 0:
                raise AssertionError(f"phase6 {name}: {inst} never launched")
        if res["failure-count"] != len(bad):
            raise AssertionError(f"phase6 {name}: {res['failure-count']} "
                                 f"failures, want {len(bad)}")
        check_exact(f"phase6 {name}", make, h, res)
        log(f"phase6: {name} " + json.dumps(r))
        out[name] = r
    return out


def instance_models() -> list:
    """(label, packed model) of every sweep instantiation phase 1b holds
    against the plain version: each model plain and stream, the
    multi-register at 3 and 5 registers (state buckets 4 and 8).  The
    register's plain instantiation is phase 1's."""
    from jepsen_tpu_torch import models as M
    from jepsen_tpu_torch.ops.wgl_stream import stream_model

    out = []
    for label, make in (
            ("register", M.cas_register), ("mutex", M.mutex),
            ("multi-register/3",
             lambda: M.multi_register({f"r{i}": 0 for i in range(3)})),
            ("multi-register/5",
             lambda: M.multi_register({f"r{i}": 0 for i in range(5)})),
            ("fifo-queue", M.fifo_queue),
            ("unordered-queue", M.unordered_queue)):
        pm = make().packed()
        if label != "register":
            out.append((label, pm))
        out.append((label + "+stream", stream_model(pm)))
    return out


def random_model_tables(pm, rng, B: int, W: int, K: int, kind: str,
                        planted=None) -> tuple:
    """Random sweep inputs for `pm` as numpy (bars (6, K), member (W, B),
    states (B, SW), alive (B,)): its ops, with codes it never packs mixed
    in (an f past release for the mutex, register indices outside the
    real width, 0 for the queues), and for a stream model a RESET every
    7th barrier.  Lane 0 passes every barrier at columns below W - 1
    ("clean": every barrier).  `planted`: the barrier of an op no lane
    survives, at the empty column W - 1 (for the mutex two acquires in a
    row ending there)."""
    import numpy as np

    from jepsen_tpu_torch.ops.wgl_stream import F_RESET

    name = pm.name.partition("+")[0]
    sw = pm.state_width
    member = rng.random((W, B)) < 0.3
    member[:, 0] = True
    member[W - 1] = kind == "clean"
    for lane in (31, 63):
        if lane < B:
            member[: W - 1, lane] = True  # the sign bit of every word
    alive = rng.random(B) < 0.7
    alive[0] = True
    bars = np.zeros((6, K), dtype=np.int32)
    bars[0] = rng.integers(0, W - 1, size=K)
    bars[1] = np.arange(K)
    bars[2] = 1
    if name == "cas-register":
        states = rng.integers(0, 4, (B, sw))
        ops = (rng.integers(0, 3, K), rng.integers(0, 4, K),
               rng.integers(0, 4, K))
        killer = (0, 77, 0)
    elif name == "mutex":
        states = rng.integers(0, 2, (B, sw))
        ops = rng.choice([0, 1, 1, 0, 2], K), np.zeros(K), np.zeros(K)
        killer = (0, 0, 0)
    elif name == "multi-register":
        states = rng.integers(0, 4, (B, sw))
        ops = (rng.integers(0, 2, K),
               rng.choice(list(range(sw)) * 3 + [-1, sw, 31], K),
               rng.integers(0, 4, K))
        killer = (0, 0, 77)
    else:
        states = np.zeros((B, sw), dtype=np.int64)
        for b in range(B):
            # Lanes 0 and 1: an empty and a full queue.
            n = (0, sw)[b] if b < 2 else int(rng.integers(0, sw + 1))
            if name == "fifo-queue":
                states[b, :n] = rng.integers(1, 7, n)
            else:
                states[b, rng.permutation(sw)[:n]] = rng.integers(1, 7, n)
        ops = rng.choice([0, 0, 1], K), rng.integers(0, 7, K), np.zeros(K)
        killer = (1, 99, 0)
    bars[3], bars[4], bars[5] = ops
    if pm.stream:
        bars[3, 3::7] = F_RESET
    if planted is not None:
        for k in ((planted - 1, planted) if name == "mutex" else (planted,)):
            bars[0, k] = W - 1
            bars[3:, k] = killer
    if kind == "padding":
        bars[2, K - 300:] = 0
    return bars, member, states.astype(np.int32), alive


def match_plain(torch, cases) -> dict:
    """Runs each case (label, packed model, start, (bars, member, states,
    alive) on the card, init) through the kernel's wrapper and the plain
    version (on host copies of the inputs: its per-barrier loop on the
    card would cost minutes) and raises unless states, alive and death
    are equal; a label "...@<off>" also needs its death at that batch
    offset.  -> {instantiation: max abs difference (0)}."""
    from jepsen_tpu_torch.ops import kernels
    from jepsen_tpu_torch.ops.wgl_witness import sweep_plain

    max_err = {}
    for label, pm, start_k, args, init in cases:
        ks, ka, kd = kernels.witness_sweep(pm.kernel_model, start_k, *args,
                                           init)
        ks, ka, kd = ks.cpu(), ka.cpu(), int(kd.item())
        ps, pa, pd = sweep_plain(start_k, *(t.cpu() for t in args),
                                 pm.torch_step_rows)
        inst = instantiation(pm, args[1].shape[1])
        max_err[inst] = max(max_err.get(inst, 0), abs(kd - pd),
                            int((ks.long() - ps.long()).abs().max()),
                            int((ka.long() - pa.long()).abs().max()))
        if not (torch.equal(ks, ps) and torch.equal(ka, pa) and kd == pd):
            raise AssertionError(
                f"phase1b: witness_sweep != sweep_plain on {label}: death "
                f"{kd} vs {pd}, states equal {torch.equal(ks, ps)}, alive "
                f"equal {torch.equal(ka, pa)}")
        if ("@" in label and not label.startswith("mutex")
                and (kd - start_k) % 32 != int(label.rpartition("@")[2])):
            raise AssertionError(f"phase1b: {label}: death {kd} from "
                                 f"{start_k} is not at its batch offset")
    return max_err


def recorded_cases(recorder: SweepRecorder) -> list:
    """Phase 1b's cases (label, pm, start_k, (bars, member, states,
    alive), init) from the sweep() calls `recorder` kept: each kept call
    and each instantiation's longest as they ran, and the first one
    restarted at barriers 31 and 33 and cut to lane 0 (past 33 lanes,
    to lanes 0-32 too: a second lane group of one lane)."""
    cases = []
    for name, calls in recorder.calls.items():
        for i, c in enumerate(calls + [recorder.longest[name]]):
            cases.append((f"{name}:recorded{i}", c["pm"], c["start_k"],
                          c["args"], c["init"]))
        c = calls[0]
        bars, member, states, alive = c["args"]
        for start in (31, 33):
            if start < bars.shape[1]:
                cases.append((f"{name}:recorded-start{start}", c["pm"],
                              start, c["args"], c["init"]))
        for b in (1, 33) if member.shape[1] > 33 else (1,):
            cases.append((f"{name}:recorded-B{b}", c["pm"], c["start_k"],
                          (bars, member[:, :b].contiguous(), states[:b],
                           alive[:b]), c["init"]))
    return cases


def phase_instantiations(torch, recorder: SweepRecorder, seed: int) -> list:
    """Phase 1b: every other sweep instantiation against the plain
    version (run on host copies of the inputs), exactly (states, alive,
    death): the calls recorded in
    phases 5 and 6 (and the first of each restarted at 31 and 33 and cut
    to lane 0), and random tables at B = 1 and 32 (the recorded calls
    run at the witness's beam of 8) with RESET barriers for the stream
    models, deaths mid-block and at batch offsets 0 and
    31 from starts 31 and 33, starts after a death and in a padding
    tail.  Then times each instantiation on its longest recorded call ->
    the kernels-line entries of the instantiations phases 5 and 6
    ran."""
    import numpy as np

    from jepsen_tpu_torch.ops.wgl_witness import BARS_PER_BLOCK

    dev = torch.device("cuda")
    K, W = BARS_PER_BLOCK, 64
    rng = np.random.default_rng(seed)

    def to_dev(arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in arrays)

    def init_of(pm):
        return (torch.tensor(pm.init_state, dtype=torch.int32, device=dev)
                if pm.stream else None)

    # (label, pm, start_k, (bars, member, states, alive), init)
    cases = recorded_cases(recorder)
    for label, pm in instance_models():
        for B in (1, 32):
            def tables(kind, planted=None):
                return to_dev(random_model_tables(pm, rng, B, W, K, kind,
                                                  planted))

            death = tables("death", K // 2)
            runs = [("clean", 0, tables("clean")), ("death", 0, death),
                    ("after-death", K // 2 + 1, death),
                    ("padding", K - 295, tables("padding", K // 2))]
            for start in (31, 33):
                for off in (0, 31):
                    runs.append((f"start{start}-death@{off}", start,
                                 tables("death", start + 5 * 32 + off)))
            for kind, start, args in runs:
                cases.append((f"{label}:rand{B}-{kind}", pm, start, args,
                              init_of(pm)))

    max_err = match_plain(torch, cases)
    log(f"phase1b: {len(cases)} cases of {len(max_err)} instantiations "
        f"match sweep_plain exactly ({sorted(max_err)})")

    return timing_entries(torch, recorder.longest, max_err)


#: Each other instantiation's timing: the plain version once on its
#: longest call after one warm-up call (three times until its cost,
#: ~0.1-0.5 s a call over ~40 instantiations, pushed the script past its
#: time budget), and INSTANCE_REPS profiled launches for its device time
#: in phase 3 (200 until the script outgrew its time budget).
INSTANCE_PLAIN_REPS, INSTANCE_REPS = 1, 50
#: Phase 3 profiles the batched BFS of the mutex cohort alone (54
#: levels; the FIFO cohort's 808 levels, ~200,000 launches, made the
#: profiler take ~30 s, cut to pay for phase 19, and profiling every
#: model's took most of 60-110 s).
BATCHED_PROFILED = "mutex"


def timing_entries(torch, longest: dict, max_err: dict) -> list:
    """Times each instantiation on its longest recorded call (CUDA
    events over back-to-back wrapper launches; the plain version on the
    same inputs by the host clock) -> its kernels-line entry, launches
    filled in by the caller."""
    from jepsen_tpu_torch.ops import kernels
    from jepsen_tpu_torch.ops.wgl_witness import sweep_plain
    from jepsen_tpu_torch.telemetry import roofline

    entries = []
    for name, c in sorted(longest.items()):
        pm, start_k, init = c["pm"], c["start_k"], c["init"]
        bars, member, states, alive = c["args"]
        B, sw = member.shape[1], states.shape[1]

        def kernel(pm=pm, start_k=start_k, args=c["args"], init=init):
            kernels.witness_sweep(pm.kernel_model, start_k, *args, init)

        def plain_call(start_k=start_k, args=c["args"], pm=pm):
            return sweep_plain(start_k, *args, pm.torch_step_rows)

        ms = cuda_ms(kernel, reps=200)
        plain_call()  # warm-up: the plain version's first run on the card
        plain = wall_ms(plain_call, reps=INSTANCE_PLAIN_REPS)
        swept = c["span"] + 1
        nbytes = roofline.sweep_cost(start_k, c["death"], bars.shape[1],
                                     bars[0].tolist(), B, sw,
                                     init is not None)["bytes_accessed"]
        entry = {
            "name": name,
            "route": "cuda",
            "source": "jepsen_tpu_torch/csrc/witness_sweep.cu",
            "replaces": "jepsen_tpu/ops/wgl_witness.py:332",
            "launches": 0,
            "max_abs_err": max_err.get(name, 0),
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": nbytes / roofline.H100_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": None,
            "barriers_timed": swept,
            "B": B,
            "sw": sw,
            "_kernel": kernel,
        }
        log(f"phase1b: timing {name}: {swept} barriers B={B} sw={sw}, "
            f"kernel {ms:.6f} ms back to back (CUDA events; "
            f"{ms * 1e6 / swept:.4f} ns/barrier), plain {plain:.3f} ms, "
            f"bound {entry['bound_ms']:.9f} ms ({nbytes} B)")
        entries.append(entry)
    return entries




#: Phase 1b's wide cases: beams past one 32-lane block, multi-register
#: widths past the register-resident instantiations, and the registers
#: of the wide keyed check.
WIDE_BEAMS = (33, 64)
WIDE_WIDTHS = (33, 40, 64)
WIDE_REGS = 40
#: The beam of the wide-beam witness checks, and the keys (phase 5's
#: per-key histories, the first 10 bad) whose beam-64 witness verdicts
#: are held against the exact CPU engine, which cannot decide even a
#: 1,000-op history of the bench generator (16 processes) in 120 s.
WIDE_BEAM_CHECK, WIDE_EXACT_KEYS, WIDE_EXACT_BAD = 64, 40, 10


def wide_models() -> list:
    """(label, packed model) of the wide multi-register instantiation,
    plain and stream, at each of WIDE_WIDTHS registers."""
    from jepsen_tpu_torch import models as M
    from jepsen_tpu_torch.ops.wgl_stream import stream_model

    out = []
    for n in WIDE_WIDTHS:
        pm = M.multi_register({f"r{i}": 0 for i in range(n)}).packed()
        out += [(f"multi-register/{n}", pm),
                (f"multi-register/{n}+stream", stream_model(pm))]
    return out


def wide_cases(torch, seed: int, dev) -> list:
    """Random sweep inputs of phase 1b's wide cases, on `dev`, over
    blocks of the witness's BARS_PER_BLOCK barriers: every
    instantiation of `instance_models` (and the plain register) at
    B = 33 and 64, and the wide multi-register at B = 1, 8 (the
    witness's beam), 32, 33 and 64, with deaths mid-block and at
    batch offsets 0 and 31 from starts 31 and 33, starts after a death
    and in a padding tail; past 32 lanes also one lane group dead from
    the start ("high-dead": lanes 32.. dead; "low-dead": lanes 0-31
    dead, lane 32 alive), so the two groups die at different
    barriers."""
    import numpy as np

    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops.wgl_witness import BARS_PER_BLOCK

    K, W = BARS_PER_BLOCK, 64
    rng = np.random.default_rng(seed)

    def to_dev(arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in arrays)

    def init_of(pm):
        return (torch.tensor(pm.init_state, dtype=torch.int32, device=dev)
                if pm.stream else None)

    def split(tables, kind):
        bars, member, states, alive = (np.array(t) for t in tables)
        if kind == "high-dead":
            alive[32:] = False
        else:
            alive[:32] = False
            alive[32] = True
            member[: W - 1, 32] = True
        return bars, member, states, alive

    cases = []
    models = ([("register", cas_register().packed())] + instance_models(),
              WIDE_BEAMS, False)
    for (labelled, beams, every_start) in (models,
                                           (wide_models(),
                                            (1, 8, 32) + WIDE_BEAMS, True)):
        for label, pm in labelled:
            for B in beams:
                def tables(kind, planted=None):
                    return random_model_tables(pm, rng, B, W, K, kind,
                                               planted)

                death = tables("death", K // 2)
                runs = [("clean", 0, tables("clean")), ("death", 0, death)]
                if every_start:
                    runs += [("after-death", K // 2 + 1, death),
                             ("padding", K - 295, tables("padding", K // 2))]
                    edges = [(31, 0), (31, 31), (33, 0), (33, 31)]
                else:
                    edges = [(33, 31)]
                for start, off in edges:
                    runs.append((f"start{start}-death@{off}", start,
                                 tables("death", start + 5 * 32 + off)))
                if B > 32:
                    runs += [(kind, 0, split(death, kind))
                             for kind in ("high-dead", "low-dead")]
                for kind, start, args in runs:
                    cases.append((f"{label}:rand{B}-{kind}", pm, start,
                                  to_dev(args), init_of(pm)))
    return cases


def phase_wide(torch, packed, dev=None) -> tuple:
    """Phase 1b's wide part: the wide cases (`wide_cases`) against the
    plain version, exactly; a 120-key history of a 40-register
    multi-register (every 7th key bad, one long key) through
    IndependentChecker, every per-key verdict the exact CPU engine's,
    both wide instantiations launched; the bench history through the
    witness at beam 64 (valid, as phase 2 at beam 8), and 40 of phase
    5's per-key histories at beam 64 against the exact engine: every
    valid key proven, no invalid one; then the sweep() calls these
    checks made (`recorded_cases`) against the plain version, exactly.
    -> (the kernels-line entries of the wide instantiations and of the
    two-block beam, the readings)."""
    from jepsen_tpu_torch import models as M
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.history.core import Op, history
    from jepsen_tpu_torch.history.packed import pack_history
    from jepsen_tpu_torch.ops import kernels
    from jepsen_tpu_torch.ops.wgl_witness import check_wgl_witness
    from jepsen_tpu_torch.parallel import IndependentChecker, \
        clear_settle_memo, kv
    from jepsen_tpu_torch.utils.histgen import random_register_history

    dev = torch.device("cuda") if dev is None else torch.device(dev)
    out: dict = {}
    max_err: dict = {}
    if dev.type == "cuda":
        cases = wide_cases(torch, BENCH_SEED, dev)
        t0 = time.perf_counter()
        max_err = match_plain(torch, cases)
        log(f"phase1b: wide: {len(cases)} cases of {sorted(max_err)} match "
            f"sweep_plain exactly ({time.perf_counter() - t0:.3f} s)")

    recorder = SweepRecorder()

    def make():
        return M.multi_register({f"r{i}": 0 for i in range(WIDE_REGS)})

    bad = set(range(0, MODEL_KEYS, 7))
    h = keyed_history(multi_register_ops, MODEL_KEYS, MODEL_OPS, bad, Op=Op,
                      kv=kv, history=history,
                      long_key_ops=LONG_KEY_OPS_DEFAULT, n_regs=WIDE_REGS)
    chk = IndependentChecker(Linearizable(make(), time_limit_s=120,
                                          device=dev), device=dev)
    clear_settle_memo()
    with recorder:
        chk.check({}, h, {})
    res, r = many_key_run(torch, chk, h, reps=1)
    if res["failure-count"] != len(bad):
        raise AssertionError(f"phase1b wide: {res['failure-count']} "
                             f"failures, want {len(bad)}")
    check_exact("phase1b wide", make, h, res)
    launches = dict(r["launches"])
    log(f"phase1b: wide keyed ({WIDE_REGS} registers) " + json.dumps(r))
    out["keyed"] = r

    pm = M.cas_register().packed()
    kernels.launches.clear()
    with recorder:
        t0 = time.perf_counter()
        wide_bench = check_wgl_witness(packed, pm, beam=WIDE_BEAM_CHECK,
                                       device=dev)
        t_bench = time.perf_counter() - t0
    if wide_bench is None or wide_bench.valid is not True:
        raise AssertionError(f"phase1b: beam-{WIDE_BEAM_CHECK} witness on "
                             f"the bench history gave {wide_bench}")
    agree = {True: 0, False: 0}
    for i in range(WIDE_EXACT_KEYS):
        kh = random_register_history(MIXED_OPS, procs=4, info_rate=0.05,
                                     seed=i, bad=i < WIDE_EXACT_BAD)
        got = check_wgl_witness(pack_history(kh, pm.encode), pm,
                                beam=WIDE_BEAM_CHECK, device=dev)
        exact = Linearizable(M.cas_register(), "cpu", time_limit_s=120,
                             device="cpu").check({}, kh, {})["valid"]
        proven = got is not None and got.valid is True
        if exact not in (True, False) or proven is not exact:
            raise AssertionError(
                f"phase1b: key {i}: beam-{WIDE_BEAM_CHECK} witness "
                f"{'proved' if proven else 'did not prove'} it, exact "
                f"engine {exact}")
        agree[exact] += 1
    launches["witness_sweep[beam>32]"] = kernels.launches[
        "witness_sweep[beam>32]"]
    out["beam"] = {"bench_valid": wide_bench.valid, "bench_s": t_bench,
                   "keys_exact": agree,
                   "launches": launches["witness_sweep[beam>32]"]}
    log(f"phase1b: beam {WIDE_BEAM_CHECK} " + json.dumps(out["beam"]))
    if dev.type != "cuda":
        return [], out
    for name in ("witness_sweep[multi-register-wide]",
                 "witness_sweep[multi-register-wide+stream]",
                 "witness_sweep[beam>32]"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"phase1b: {name} never launched")
    cases = recorded_cases(recorder)
    t0 = time.perf_counter()
    for name, err in match_plain(torch, cases).items():
        max_err[name] = max(max_err.get(name, 0), err)
    shapes = sorted({(instantiation(c[1], c[3][1].shape[1]),
                      c[3][1].shape[1], c[3][2].shape[1]) for c in cases})
    log(f"phase1b: wide: {len(cases)} recorded cases (instantiation, B, "
        f"sw: {shapes}) match sweep_plain exactly "
        f"({time.perf_counter() - t0:.3f} s)")
    out["recorded_cases"] = len(cases)
    entries = timing_entries(torch, recorder.longest, max_err)
    for e in entries:
        e["launches"] = launches.get(e["name"], 0)
    return [e for e in entries if e["name"] in launches], out


#: Phase 1b's lane-group cases: beams of G = ceil(B / 32) blocks, and
#: multi-register widths past what 32 lanes' rows in shared memory hold
#: (1,722 words): 1,723 (31 lanes a block), 6,891 (8) and 55,133 (one
#: row does not fit: rows in global memory, 32 lanes a block).
GROUP_BEAMS = (96, 128, 200)
GROUP_WIDTHS = (1723, 6891, 55133)
#: The witness checks of the lane-group path: the bench history at beam
#: 200, and a multi-register history (valid and bad) of (registers,
#: ops) in GROUP_CHECKS through the witness at its beam of 8; the exact
#: CPU engine copies the whole state at each step, so the 55,133-word
#: history is short (at 120 ops it took 80 s on the host).
GROUP_BEAM_CHECK = 200
GROUP_CHECKS = ((6891, 300), (55133, 60))


def group_cases(torch, seed: int, dev) -> list:
    """Random sweep inputs of the lane-group cases, on `dev`: the
    register at B = 96, 128 and 200 over 2,048-barrier blocks (clean,
    a death mid-block, a batch-edge death from start 33, lanes 0-31
    dead with lane 32 passing, and every group but the last dead), and
    the wide multi-register at GROUP_WIDTHS registers, plain and
    stream, at B = 1, 8 and 33 (clean, a death mid-block, and the first
    block's lanes dead), over 2,048 barriers (256 at 55,133 words,
    whose plain version steps 33 rows of 220 KB a barrier)."""
    import numpy as np

    from jepsen_tpu_torch import models as M
    from jepsen_tpu_torch.ops import kernels
    from jepsen_tpu_torch.ops.wgl_stream import stream_model
    from jepsen_tpu_torch.ops.wgl_witness import BARS_PER_BLOCK

    W = 64
    rng = np.random.default_rng(seed)

    def to_dev(arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in arrays)

    def init_of(pm):
        return (torch.tensor(pm.init_state, dtype=torch.int32, device=dev)
                if pm.stream else None)

    def dead_before(tables, first):
        bars, member, states, alive = (np.array(t) for t in tables)
        alive[:first] = False
        alive[first] = True
        member[: W - 1, first] = True
        return bars, member, states, alive

    cases = []
    pm = M.cas_register().packed()
    K = BARS_PER_BLOCK
    for B in GROUP_BEAMS:
        death = random_model_tables(pm, rng, B, W, K, "death", K // 2)
        runs = [("clean", 0, random_model_tables(pm, rng, B, W, K, "clean")),
                ("death", 0, death),
                ("start33-death@31", 33, random_model_tables(
                    pm, rng, B, W, K, "death", 33 + 5 * 32 + 31)),
                ("low-dead", 0, dead_before(death, 32)),
                ("last-alive", 0, dead_before(death, (B - 1) // 32 * 32))]
        for kind, start, args in runs:
            cases.append((f"register:rand{B}-{kind}", pm, start,
                          to_dev(args), None))
    for n in GROUP_WIDTHS:
        base = M.multi_register({f"r{i}": 0 for i in range(n)}).packed()
        K = 256 if n > 6891 else BARS_PER_BLOCK
        for label, wpm in ((f"multi-register/{n}", base),
                           (f"multi-register/{n}+stream",
                            stream_model(base))):
            for B in (1, 8, 33):
                lanes = kernels.sweep_geometry(3, n, B)[0]
                death = random_model_tables(wpm, rng, B, W, K, "death",
                                            K // 2)
                runs = [("clean", 0, random_model_tables(wpm, rng, B, W, K,
                                                         "clean")),
                        ("death", 0, death)]
                if B > lanes:
                    runs.append(("low-dead", 0, dead_before(death, lanes)))
                for kind, start, args in runs:
                    cases.append((f"{label}:rand{B}-{kind}", wpm, start,
                                  to_dev(args), init_of(wpm)))
    return cases


def phase_groups(torch, packed, dev=None) -> tuple:
    """Phase 1b's lane-group part: the lane-group cases (`group_cases`)
    against the plain version, exactly, each with its layout (lanes a
    block, blocks, rows in global memory); the bench history through
    the witness at beam 200 (bucketed up to 256 lanes, 8 blocks; valid,
    as at beam 8); a multi-register
    history, valid and bad, of each GROUP_CHECKS size through the
    witness at beam 8, held
    against the exact CPU engine (the valid one proven, the bad one
    not); the sweep() calls these checks made against the plain
    version, exactly.  -> (the kernels-line entries of the G-group
    join at B = 200 and of the narrow-block and global-row wide
    launches, each timed on its longest recorded call, the readings)."""
    from jepsen_tpu_torch import models as M
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.history.core import Op, history
    from jepsen_tpu_torch.history.packed import pack_history
    from jepsen_tpu_torch.ops import kernels
    from jepsen_tpu_torch.ops.wgl_witness import check_wgl_witness

    dev = torch.device("cuda") if dev is None else torch.device(dev)
    out: dict = {}
    max_err: dict = {}
    if dev.type == "cuda":
        cases = group_cases(torch, BENCH_SEED + 1, dev)
        t0 = time.perf_counter()
        max_err = match_plain(torch, cases)
        layouts = sorted({(c[1].state_width, c[3][1].shape[1],
                           kernels.sweep_geometry(c[1].kernel_model,
                                                  c[1].state_width,
                                                  c[3][1].shape[1]))
                          for c in cases})
        log(f"phase1b: groups: {len(cases)} cases match sweep_plain "
            f"exactly ({time.perf_counter() - t0:.3f} s); (sw, B, (lanes "
            f"a block, blocks, rows global)): {layouts}")
        out["cases"] = len(cases)

    kernels.launches.clear()
    recorders = {"join": SweepRecorder(), "narrow": SweepRecorder(),
                 "global": SweepRecorder()}
    pm = M.cas_register().packed()
    with recorders["join"]:
        t0 = time.perf_counter()
        got = check_wgl_witness(packed, pm, beam=GROUP_BEAM_CHECK,
                                device=dev)
        t_bench = time.perf_counter() - t0
    if got is None or got.valid is not True:
        raise AssertionError(f"phase1b: beam-{GROUP_BEAM_CHECK} witness on "
                             f"the bench history gave {got}")
    out["beam"] = {"beam": GROUP_BEAM_CHECK, "bench_valid": got.valid,
                   "bench_s": t_bench}
    for (n, n_ops), what in zip(GROUP_CHECKS, ("narrow", "global")):
        model = M.multi_register({f"r{i}": 0 for i in range(n)})
        wpm = model.packed()
        for bad in (False, True):
            h = history([Op(**o) for o in multi_register_ops(
                n_ops, seed=n + bad, bad=bad, n_regs=n)])
            with recorders[what]:
                t0 = time.perf_counter()
                r = check_wgl_witness(pack_history(h, wpm.encode), wpm,
                                      device=dev)
                t_check = time.perf_counter() - t0
            exact = Linearizable(model, "cpu", time_limit_s=120,
                                 device="cpu").check({}, h, {})["valid"]
            proven = r is not None and r.valid is True
            if exact is not (not bad) or proven is not exact:
                raise AssertionError(
                    f"phase1b: {n}-register witness "
                    f"{'proved' if proven else 'did not prove'} a "
                    f"{'bad' if bad else 'valid'} history, exact {exact}")
            out[f"{what}/{n}/{'bad' if bad else 'valid'}"] = {
                "proven": proven, "exact": exact, "check_s": t_check}
    launches = {k: v for k, v in kernels.launches.items()
                if k.startswith("witness_sweep[")}
    out["launches"] = launches
    log("phase1b: groups " + json.dumps(out))
    if dev.type != "cuda":
        return [], out
    for name in ("witness_sweep[join]",
                 "witness_sweep[multi-register-wide-narrow]",
                 "witness_sweep[multi-register-wide-global]"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"phase1b: {name} never launched")
    cases = [c for rec in recorders.values() for c in recorded_cases(rec)]
    t0 = time.perf_counter()
    for name, err in match_plain(torch, cases).items():
        max_err[name] = max(max_err.get(name, 0), err)
    log(f"phase1b: groups: {len(cases)} recorded cases match sweep_plain "
        f"exactly ({time.perf_counter() - t0:.3f} s)")
    entries = []
    for what, name in (("join", "witness_sweep[join]"),
                       ("narrow", "witness_sweep[multi-register-wide-narrow]"),
                       ("global", "witness_sweep[multi-register-wide-global]")):
        rec = recorders[what]
        longest = {name: max(rec.longest.values(), key=lambda c: c["span"])}
        (e,) = timing_entries(torch, longest, {name: max(max_err.values())})
        e["launches"] = launches.get(name, 0)
        e["layout"] = kernels.sweep_geometry(
            longest[name]["pm"].kernel_model, e["sw"], e["B"])
        entries.append(e)
    return entries, out


def phase_batched(torch, recorder: SweepRecorder) -> dict:
    """The batched BFS (plain PyTorch; the JAX package's `_make_key_fn`
    under `vmap`) on each model's cohort recorded in phases 5 and 6:
    keys, levels, host syncs and wall time of one call (host clock),
    and a callable for its device time in phase 3."""
    from jepsen_tpu_torch import device as D
    from jepsen_tpu_torch.ops.wgl_batched import check_wgl_batched

    out = {}
    for name, (packs, pm, kw) in sorted(recorder.batched.items()):
        def call(packs=packs, pm=pm, kw=kw):
            return check_wgl_batched(packs, pm, **kw)

        call()  # warm-up
        torch.cuda.synchronize()
        D.counters.clear()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        out[name] = {
            "keys": len(packs),
            "max_ops": max(p.n for p in packs),
            "valid": {str(v): res.valid.count(v) for v in set(res.valid)},
            "levels": D.counters.get("bfs_levels", 0),
            "host_syncs": D.counters.get("host_syncs", 0),
            "wall_s": time.perf_counter() - t0,
            "_call": call,
        }
        log(f"phase1b: batched BFS {name}: " + json.dumps(
            {k: v for k, v in out[name].items() if k != "_call"}))
    return out


# ---------------------------------------------------------------------------
# Online checking (phase 7): the frontier carry, the streaming session and
# the rolling discard.

ONLINE_SLICES = 24  # bench.py run_scale_online's default
#: 7b's scale point: 1M ops (bench.py run_scale_online's 2M, halved to
#: pay for phase 17's time), warmed on 50k.
SCALE_OPS, SCALE_WARM_OPS = 1_000_000, 50_000
ROLLING_OPS = 200_000
#: The live producers feed this many ops, then pause FEED_PAUSE_S.
FEED_BURST, FEED_PAUSE_S = 2048, 0.02


def counted(torch, dev, fn) -> tuple:
    """fn() with the kernel launch counts and `device.counters` set to 0
    just before and read just after -> (result, launches, counters)."""
    from jepsen_tpu_torch import device as D
    from jepsen_tpu_torch.ops import kernels

    kernels.launches.clear()
    D.counters.clear()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, dict(kernels.launches), dict(D.counters)


def need_launches(what: str, dev, launches: dict, name="witness_sweep"):
    """On the card, raise unless `name` launched in the run just read."""
    if dev.type == "cuda" and launches.get(name, 0) <= 0:
        raise AssertionError(f"{what}: no {name} launch on this path")


def prefix(packed, k: int):
    """The witness-only view of the first k rows of `packed`: with the
    stable bound s = inv[k] it is a PackedBuilder snapshot (every row has
    inv < s, every later completion has ret > s), as bench.py
    run_scale_online replays it."""
    import numpy as np

    from jepsen_tpu_torch.history.packed import PackedOps

    z = np.zeros(k, dtype=packed.preds.dtype)
    return PackedOps(inv=packed.inv[:k], ret=packed.ret[:k],
                     process=packed.process[:k], status=packed.status[:k],
                     f=packed.f[:k], a0=packed.a0[:k], a1=packed.a1[:k],
                     src_index=packed.src_index[:k], preds=z, horizon=z)


def replay(fr, packed, slices: int = ONLINE_SLICES):
    """Advances `fr` over `slices` stable prefixes of `packed`, then
    finalizes -> (verdict, seconds to the last advance, seconds in
    all)."""
    n = packed.n
    t0 = time.perf_counter()
    step = max(1, n // slices)
    for k in range(step, n, step):
        fr.advance(prefix(packed, k), int(packed.inv[k]))
    t_last = time.perf_counter()
    valid = fr.finalize(packed)
    return valid, t_last - t0, time.perf_counter() - t0


def feed_live(sess, history) -> float:
    """A producer thread feeds `history` through `sess.feed` in bursts
    of FEED_BURST ops with a pause after each, then the caller's thread
    calls finish() -> seconds the producer took."""
    import threading

    def produce():
        for i, op in enumerate(history):
            sess.feed(op)
            if i % FEED_BURST == FEED_BURST - 1:
                time.sleep(FEED_PAUSE_S)

    t0 = time.perf_counter()
    t = threading.Thread(target=produce, name="producer")
    t.start()
    t.join()
    return time.perf_counter() - t0


def online_carry(torch, dev, pm, packed) -> dict:
    """7a: the bench history in ONLINE_SLICES stable-prefix slices
    through FrontierCarry, then one check_wgl_witness at the same block
    knobs on the same pack: both valid, with equal sweep launches and
    chain rounds."""
    from jepsen_tpu_torch.ops.wgl_witness import check_wgl_witness
    from jepsen_tpu_torch.streaming import FrontierCarry

    fr = FrontierCarry(pm, device=dev)
    (valid, t_adv, t_all), l_on, c_on = counted(
        torch, dev, lambda: replay(fr, packed))
    res, l_one, c_one = counted(torch, dev, lambda: check_wgl_witness(
        packed, pm, bars_per_block=1024, blocks_per_call=8, device=dev))
    r = {
        "ops": packed.n, "valid": valid, "one_shot_valid": res and res.valid,
        "sweep_launches": l_on.get("witness_sweep", 0),
        "one_shot_sweep_launches": l_one.get("witness_sweep", 0),
        "heavy_rounds": c_on.get("heavy_rounds", 0),
        "one_shot_heavy_rounds": c_one.get("heavy_rounds", 0),
        "host_syncs": c_on.get("host_syncs", 0),
        "one_shot_host_syncs": c_one.get("host_syncs", 0),
        "advances": c_on.get("online_advances", 0),
        "chunks": fr.chunks, "blocks": fr.blocks_done, "window": fr._W,
        "advance_s": t_adv, "total_s": t_all,
    }
    log("phase7a: " + json.dumps(r))
    need_launches("phase7a", dev, l_on)
    if not (valid is True and r["one_shot_valid"] is True
            and r["sweep_launches"] == r["one_shot_sweep_launches"]
            and r["heavy_rounds"] == r["one_shot_heavy_rounds"]):
        raise AssertionError("phase7a: the online carry and the one-shot "
                             "witness differ")
    return r


def online_scale(torch, dev, pm, n_ops: int = SCALE_OPS) -> dict:
    """7b: bench.py run_scale_online on the port — a random_register_packed
    stream in ONLINE_SLICES slices, warmed on a 50k-op stream; the
    verdict lag is the time from the last advance (the last op landed)
    to the verdict."""
    from jepsen_tpu_torch.streaming import FrontierCarry
    from jepsen_tpu_torch.utils.histgen import random_register_packed

    warm = random_register_packed(min(SCALE_WARM_OPS, n_ops),
                                  procs=BENCH_PROCS, info_rate=BENCH_INFO,
                                  seed=7, model=pm)
    FrontierCarry(pm, device=dev).finalize(warm)
    t0 = time.perf_counter()
    big = random_register_packed(n_ops, procs=BENCH_PROCS,
                                 info_rate=BENCH_INFO, seed=BENCH_SEED,
                                 model=pm)
    t_gen = time.perf_counter() - t0
    fr = FrontierCarry(pm, device=dev)
    (valid, t_adv, t_all), launches, counts = counted(
        torch, dev, lambda: replay(fr, big))
    lag = t_all - t_adv
    r = {
        "ops": big.n, "valid": valid, "verdict_lag_s": lag,
        "elapsed_s": t_all, "lag_fraction": lag / t_all,
        "ops_per_s": big.n / t_all, "generate_s": t_gen,
        "blocks": fr.blocks_done, "chunks": fr.chunks,
        "frontier_device_s": fr.device_s, "plan_s": fr.plan_s,
        "advances": counts.get("online_advances", 0),
        "sweep_launches": launches.get("witness_sweep", 0),
        "heavy_rounds": counts.get("heavy_rounds", 0),
        "host_syncs": counts.get("host_syncs", 0),
    }
    log("phase7b: " + json.dumps(r))
    need_launches("phase7b", dev, launches)
    if valid is not True:
        raise AssertionError(f"phase7b: frontier gave {valid} "
                             f"({fr.dead_reason})")
    return r


def online_live(torch, dev, history) -> dict:
    """7c: a producer thread feeds the bench history through a
    StreamingSession; Linearizable then takes the online verdict."""
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.streaming import StreamingSession

    def run():
        sess = StreamingSession(cas_register().packed(), device=dev)
        feed_s = feed_live(sess, history)
        stats = sess.finish()
        res = Linearizable(cas_register(), device=dev).check(
            {"streaming-session": sess}, history, {})
        return sess, feed_s, stats, res

    (sess, feed_s, stats, res), launches, counts = counted(torch, dev, run)
    fr = stats.get("frontier", {})
    r = {
        "events": len(history), "feed_s": feed_s,
        "verdict_lag_s": stats["verdict-lag-s"],
        "lag_fraction": stats["verdict-lag-s"] / (
            feed_s + stats["verdict-lag-s"]),
        "swaps": stats["swaps"], "valid": res["valid"],
        "algorithm": res["algorithm"], "broken": stats.get("broken"),
        "frontier_blocks": fr.get("blocks"), "frontier_chunks": fr.get("chunks"),
        "frontier_device_s": fr.get("device-s"), "plan_s": fr.get("plan-s"),
        "advances": counts.get("online_advances", 0),
        "consumed": counts.get("online_consumed", 0),
        "sweep_launches": launches.get("witness_sweep", 0),
        "heavy_rounds": counts.get("heavy_rounds", 0),
        "host_syncs": counts.get("host_syncs", 0),
    }
    log("phase7c: " + json.dumps(r))
    need_launches("phase7c", dev, launches)
    if sess.broken or res["valid"] is not True or \
            res["algorithm"] != "wgl-online":
        raise AssertionError(f"phase7c: session broken {sess.broken}, "
                             f"verdict {res}")
    return r


def online_keyed(torch, dev) -> dict:
    """7d: phase 5's run_mixed history fed to a keyed session by a
    producer thread, then IndependentChecker: 30 failures, every per-key
    verdict the exact CPU engine's, the 170 valid keys taken online.

    The session ingests the history as one batch (its swap threshold is
    past the history's length and its swap interval an hour).  With batches cut by timing, a batch
    holding more bad keys than half its keys would reach the stream's
    restart cap, and its valid keys left undecided are not retried at
    finish (their pack is unchanged: the reference's rule), so the count
    of keys taken online would vary from run to run."""
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.parallel import IndependentChecker, \
        clear_settle_memo
    from jepsen_tpu_torch.streaming import StreamingSession

    h = mixed_history(MIXED_KEYS, MIXED_BAD)
    clear_settle_memo()

    def session():
        sess = StreamingSession(cas_register().packed(),
                                swap_ops=len(h) + 1, swap_interval_s=3600.0,
                                device=dev)
        feed_s = feed_live(sess, h)
        return sess, feed_s, sess.finish()

    (sess, feed_s, stats), l_sess, c_sess = counted(torch, dev, session)
    chk = IndependentChecker(Linearizable(cas_register(), time_limit_s=120,
                                          device=dev), device=dev)
    res, l_chk, c_chk = counted(torch, dev, lambda: chk.check(
        {"streaming-session": sess}, h, {}))
    online = sum(1 for v in res["results"].values()
                 if v.get("algorithm") == "wgl-online")
    r = {
        "events": len(h), "feed_s": feed_s,
        "verdict_lag_s": stats["verdict-lag-s"], "swaps": stats["swaps"],
        "proven_online": stats["proven-online"],
        "rechecks": stats["rechecks"], "valid": res["valid"],
        "failure_count": res["failure-count"], "keys_online": online,
        "tiers": res["tiers"],
        "session_launches": {k: v for k, v in l_sess.items()
                             if k.startswith("witness_sweep")},
        "session_counts": c_sess,
        "check_launches": {k: v for k, v in l_chk.items()
                           if k.startswith("witness_sweep")},
        "check_host_syncs": c_chk.get("host_syncs", 0),
    }
    log("phase7d: " + json.dumps(r))
    need_launches("phase7d", dev, l_sess, "witness_sweep[register+stream]")
    if (sess.broken or res["valid"] is not False
            or res["failure-count"] != MIXED_BAD
            or online != MIXED_KEYS - MIXED_BAD):
        raise AssertionError(
            f"phase7d: broken {sess.broken}, valid {res['valid']}, "
            f"{res['failure-count']} failures, {online} keys online; want "
            f"False, {MIXED_BAD}, {MIXED_KEYS - MIXED_BAD}")
    check_exact("phase7d", cas_register, h, res)
    return r


def online_rolling(torch, dev, n_ops: int = ROLLING_OPS) -> dict:
    """7e: RollingChecker over one key's n_ops-op stream (no :info ops,
    so stable prefixes can go), with and without discards: equal
    verdicts; with discards at least half the rows go and the resident
    rows never reach a quarter of the stream's (they rise and fall with
    the discard points, not with the stream's length)."""
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.monitor import RollingChecker
    from jepsen_tpu_torch.utils.histgen import random_register_history

    stream = random_register_history(n_ops, procs=8, info_rate=0.0,
                                     seed=BENCH_SEED)
    pm = cas_register().packed()
    out = {}
    for discard in (True, False):
        def run():
            rc = RollingChecker(pm, discard=discard, device=dev)
            peak = 0
            t0 = time.perf_counter()
            for i, op in enumerate(stream):
                rc.feed(0, op)
                if i % 1024 == 0:
                    peak = max(peak, rc.resident_rows())
            status = rc.status()
            return rc.finish(), status, peak, time.perf_counter() - t0

        (verdicts, status, peak, wall), launches, counts = counted(
            torch, dev, run)
        need_launches(f"phase7e discard={discard}", dev, launches)
        out["discard" if discard else "keep"] = {
            "verdicts": verdicts, "max_resident_rows": peak,
            "rows": status["discarded-rows"] + status["resident-rows"],
            "discarded_rows": status["discarded-rows"],
            "blocks": status["blocks-done"],
            "epoch_restarts": status["epoch-restarts"], "wall_s": wall,
            "sweep_launches": launches.get("witness_sweep", 0),
            "host_syncs": counts.get("host_syncs", 0),
        }
    log("phase7e: " + json.dumps(out))
    d, k = out["discard"], out["keep"]
    if d["verdicts"] != k["verdicts"] or d["verdicts"] != {0: True}:
        raise AssertionError(f"phase7e: verdicts {d['verdicts']} with "
                             f"discards, {k['verdicts']} without")
    if d["max_resident_rows"] * 4 > d["rows"] or d["discarded_rows"] * 2 < d["rows"]:
        raise AssertionError(f"phase7e: resident rows not bounded: "
                             f"{d['max_resident_rows']} of {d['rows']}")
    return out


def phase_online(torch, pm, packed, history, dev=None,
                 scale_ops: int = SCALE_OPS,
                 rolling_ops: int = ROLLING_OPS) -> dict:
    """Phase 7, online checking on `dev` (the card by default)."""
    dev = torch.device("cuda") if dev is None else torch.device(dev)
    return {
        "carry": online_carry(torch, dev, pm, packed),
        "scale": online_scale(torch, dev, pm, scale_ops),
        "live": online_live(torch, dev, history),
        "keyed": online_keyed(torch, dev),
        "rolling": online_rolling(torch, dev, rolling_ops),
    }


# ---------------------------------------------------------------------------
# Elle (phase 8): list-append and rw-register checking, with the closure
# screen and the witness-cycle extraction on the card.  The history
# generators are shared with the tests.

#: Committed transactions of phase 8's histories: about the most the
#: device path takes (1,000 vertices pad to V = 1,024, the screen's
#: max_device_vertices), and past it for 8e.
ELLE_TXNS, ELLE_BIG_TXNS, ELLE_SEED = 1000, 2000, 45100
ELLE_MODELS = ("serializable", "strict-serializable")
#: 8d: random graphs of 16-128 vertices through one screen call.
SCREEN_GRAPHS = 512
#: The transactions of each anomaly phase 8 injects, as committed (the
#: micro-ops with what the reads returned), on keys no other
#: transaction touches.  They run concurrently, so realtime orders none
#: of them against another.
ELLE_ANOMALIES = {
    "append": {
        # ww both ways: x is 0 (first) then 1 (second); y the reverse.
        "G0": [[["append", "g0-x", 0], ["append", "g0-y", 1]],
               [["append", "g0-y", 0], ["append", "g0-x", 1]],
               [["r", "g0-x", [0, 1]], ["r", "g0-y", [0, 1]]]],
        # wr both ways: each reads the other's append.
        "G1c": [[["append", "g1c-x", 0], ["r", "g1c-y", [0]]],
                [["append", "g1c-y", 0], ["r", "g1c-x", [0]]]],
        # read skew: the first misses the second's x (rw) but reads its
        # y (wr); the third fixes x's order.
        "G-single": [[["r", "gs-x", []], ["r", "gs-y", [0]]],
                     [["append", "gs-x", 0], ["append", "gs-y", 0]],
                     [["r", "gs-x", [0]]]],
    },
    "wr": {
        "G1c": [[["w", "g1c-x", 1], ["r", "g1c-y", 1]],
                [["w", "g1c-y", 1], ["r", "g1c-x", 1]]],
        # the initial x (rw to its writer) beside that writer's y (wr).
        "G-single": [[["r", "gs-x", None], ["r", "gs-y", 1]],
                     [["w", "gs-x", 1], ["w", "gs-y", 1]]],
    },
}
#: Transactions of the long G-single ("G-single-chain"): ELLE_CHAIN
#: appends to one key, put in order by a final read (a chain of ww
#: edges), the last of which missed the first's append to another key
#: (one rw edge back to the first).  Its cycle runs through all of
#: them, so the extraction's BFS walks ELLE_CHAIN - 1 levels.
ELLE_CHAIN = 100
ELLE_ANOMALIES["append"]["G-single-chain"] = (
    [[["append", "lc-x", 0], ["append", "lc-y", 0]]]
    + [[["append", "lc-x", i]] for i in range(1, ELLE_CHAIN - 1)]
    + [[["append", "lc-x", ELLE_CHAIN - 1], ["r", "lc-y", []]]]
    + [[["r", "lc-x", list(range(ELLE_CHAIN))], ["r", "lc-y", [0]]]])


def elle_ops(kind: str, n_txns: int, seed: int, *, inject=()) -> list:
    """One seeded concurrent run of the port's AppendGen ("append") or
    WrGen ("wr") at the reference workloads' defaults (10 keys, 1-4
    micro-ops, 32 appends per key), as op dicts (type, f, value,
    process) in history order, with `n_txns` committed transactions.

    10 workers; a seeded random.Random picks which one moves next:
    an idle worker invokes its generator's next transaction, a busy one
    completes.  A completion applies the transaction atomically to an
    in-memory store, as the reference's InMemoryAppendClient and
    InMemoryWrClient do, and is :ok; with probability 0.05 it is
    :info instead, the transaction applied or not (a seeded coin), and
    the worker goes on under a fresh process.  So the history is strict
    serializable.  Each name in `inject` (a key of ELLE_ANOMALIES[kind])
    adds that anomaly's transactions, spaced evenly through the run:
    all invoked, then all completed :ok, on processes of their own."""
    from collections import defaultdict

    from jepsen_tpu_torch.checker.elle import AppendGen, WrGen

    procs, info = 10, 0.05
    gen = (AppendGen if kind == "append" else WrGen)(rng=random.Random(seed))
    rng = random.Random(seed + 1)
    state: dict = defaultdict(list) if kind == "append" else {}

    def apply(txn):
        out = []
        for f, k, v in txn:
            if f == "append":
                state[k].append(v)
            elif f == "w":
                state[k] = v
            else:
                v = list(state[k]) if kind == "append" else state.get(k)
            out.append([f, k, v])
        return out

    marks = [(i + 1) * n_txns // (len(inject) + 1)
             for i in range(len(inject))]
    todo = list(zip(marks, inject))
    ops: list = []
    pids = list(range(procs))
    next_pid, inject_pid = procs, 1 << 20
    pending: dict = {}
    committed = 0
    while committed < n_txns or pending:
        w = rng.randrange(procs)
        if w in pending:
            txn = pending.pop(w)
            if rng.random() < info:
                if rng.random() < 0.5:
                    apply(txn)
                ops.append({"type": "info", "f": "txn", "value": txn,
                            "process": pids[w]})
                pids[w], next_pid = next_pid, next_pid + 1
                continue
            ops.append({"type": "ok", "f": "txn", "value": apply(txn),
                        "process": pids[w]})
            committed += 1
            while todo and committed >= todo[0][0]:
                txns = ELLE_ANOMALIES[kind][todo.pop(0)[1]]
                for p, txn in enumerate(txns):
                    ops.append({"type": "invoke", "f": "txn",
                                "value": [[f, k, None if f == "r" else v]
                                          for f, k, v in txn],
                                "process": inject_pid + p})
                for p, txn in enumerate(txns):
                    ops.append({"type": "ok", "f": "txn", "value": txn,
                                "process": inject_pid + p})
                inject_pid += len(txns)
        elif committed + len(pending) < n_txns:
            pending[w] = gen()["value"]
            ops.append({"type": "invoke", "f": "txn", "value": pending[w],
                        "process": pids[w]})
    return ops


def random_dep_graphs(n: int, seed: int, DepGraph) -> list:
    """`n` random dependency graphs (either package's DepGraph) of 16-128
    vertices: a random DAG of about 3 edges per vertex with random
    types; in about half of them one edge doubled by a back edge,
    closing a cycle."""
    rng = random.Random(seed)
    graphs = []
    for _ in range(n):
        V = rng.randint(16, 128)
        order = list(range(V))
        rng.shuffle(order)
        g = DepGraph()
        for x in range(V):
            g.add_vertex(x)
        for _ in range(3 * V):
            a, b = sorted(rng.sample(range(V), 2))
            g.add_edge(order[a], order[b], rng.choice(("ww", "wr", "rw")))
        if rng.random() < 0.5:
            a, b = sorted(rng.sample(range(V), 2))
            g.add_edge(order[a], order[b], "ww")
            g.add_edge(order[b], order[a], "rw")
        graphs.append(g)
    return graphs


#: The edge type each layer's cycle must carry (graph.check_cycles).
LAYER_TYPES = {"G0": {"ww"}, "G1c": {"wr"}, "G-single": {"rw"},
               "G2-item": {"rw"}}


def check_device_cycles(g, res: dict) -> int:
    """Raises unless every cycle record in `res` is a closed cycle of
    real edges of `g` that carries its layer's edge type, with its SCC
    size -> the number of records."""
    n = 0
    for recs in res["anomalies"].values():
        for r in recs:
            if not (isinstance(r, dict) and "cycle" in r):
                continue
            c = r["cycle"]
            carried = set()
            for a, b in zip(c, c[1:]):
                if not g.edge_types(a, b):
                    raise AssertionError(f"cycle {c} uses no edge {a}->{b}")
                carried |= g.edge_types(a, b)
            need = LAYER_TYPES.get(r["type"], set())
            if (len(c) < 3 or c[0] != c[-1] or (need and not carried & need)
                    or not isinstance(r["scc-size"], int)
                    or r["scc-size"] < len(c) - 1):
                raise AssertionError(f"bad device cycle record {r}")
            n += 1
    return n


def elle_check(torch, dev, kind: str, model: str, history,
               reps: int) -> tuple:
    """`reps` counted checks of `history` through the port's
    AppendChecker or WrChecker on `dev`, and one with device="off" ->
    (reading, device result, host result, the dependency graph)."""
    from jepsen_tpu_torch.checker.elle import (AppendChecker, WrChecker,
                                               analyze_append, analyze_wr)
    from jepsen_tpu_torch.ops import scc

    make = AppendChecker if kind == "append" else WrChecker
    analyze = analyze_append if kind == "append" else analyze_wr
    host = make(model, device="off").check({}, history, {})
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res, _, counts = counted(
            torch, dev, lambda: make(model, device=dev).check({}, history, {}))
        times.append(time.perf_counter() - t0)
    seen = {}

    def spy(g):
        seen["t"], seen["g"] = time.perf_counter(), g
        return scc.check_cycles_device([g], device=dev)[0]

    t0 = time.perf_counter()
    analyze(history.client_ops(), consistency_model=model, cycle_fn=spy)
    g = seen["g"]
    n_ok = sum(1 for o in history if o.is_ok)
    r = {
        "kind": kind, "model": model, "committed": n_ok,
        "vertices": len(g.vertices),
        "edges": res["edges"], "valid": res["valid"],
        "anomaly_types": res["anomaly-types"],
        "wall_s": times, "median_s": statistics.median(times),
        "txns_per_s": n_ok / statistics.median(times),
        "graph_build_s": seen["t"] - t0,
        "screens": counts.get("scc_screens", 0),
        "extractions": counts.get("scc_extractions", 0),
        "bfs_levels": counts.get("scc_bfs_levels", 0),
        "bfs_graph_levels": counts.get("scc_bfs_graph_levels", 0),
        "host_syncs": counts.get("host_syncs", 0),
    }
    if dev.type == "cuda" and r["screens"]:
        adj = torch.from_numpy(scc.pack_adjacency([g])[0]).to(dev)
        r["screen_shape"] = list(adj.shape)
        r["closure_ms"] = cuda_ms(
            lambda: scc.has_cycle(adj, torch.bfloat16), reps=20)
    if dev.type == "cuda" and r["extractions"]:
        layers = scc.layer_entries(g)
        a_all, a_req, _ = scc.pack_required([x[0] for x in layers],
                                            [x[1] for x in layers])
        A, R = (torch.from_numpy(x).to(dev) for x in (a_all, a_req))
        r["extract_shape"] = list(A.shape)
        r["extract_ms"] = cuda_ms(
            lambda: scc.extract_batch(A, R, torch.bfloat16), reps=5)
    return r, res, host, g


def phase_elle(torch, dev=None) -> dict:
    """Phase 8 on `dev` (the card by default): 8a-8e of the module doc.
    Raises on any failed check."""
    from jepsen_tpu_torch.checker.elle import AppendChecker, DepGraph
    from jepsen_tpu_torch.history.core import Op, history
    from jepsen_tpu_torch.ops import scc
    from jepsen_tpu_torch.telemetry import roofline

    dev = torch.device("cuda") if dev is None else torch.device(dev)
    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    out: dict = {"checks": [], "graphs": {}}
    chain = ELLE_ANOMALIES["append"]["G-single-chain"]
    # (sub-phase, generator, injected anomalies, transactions generated,
    # anomaly types the device result must hold)
    cases = [("8a", "append", (), ELLE_TXNS, set()),
             ("8b", "append", ("G0", "G1c", "G-single"), ELLE_TXNS,
              {"G0", "G1c", "G-single"}),
             ("8b-chain", "append", ("G-single-chain",),
              ELLE_TXNS - len(chain), {"G-single"}),
             ("8c", "wr", (), ELLE_TXNS, set()),
             ("8c", "wr", ("G-single",), ELLE_TXNS, {"G-single"})]
    for sub, kind, inject, n_txns, want in cases:
        h = history([Op(**d) for d in elle_ops(kind, n_txns, ELLE_SEED,
                                                inject=inject)])
        bad = bool(inject)
        for model in ELLE_MODELS:
            r, res, host, g = elle_check(torch, dev, kind, model, h, reps=3)
            r["sub_phase"], r["injected"] = sub, bad
            if r["screens"] != 1 or scc._bucket(len(g.vertices), 8) != 1024:
                raise AssertionError(f"{sub}: not screened at V = 1,024: {r}")
            if not bad:
                if res["valid"] is not True or res != host:
                    raise AssertionError(f"{sub} {model}: {res} != {host}")
                if r["extractions"]:
                    raise AssertionError(f"{sub}: extraction on a valid run")
            else:
                if (res["valid"] is not False
                        or res["anomaly-types"] != host["anomaly-types"]
                        or not want <= set(res["anomaly-types"])):
                    raise AssertionError(
                        f"{sub} {model}: {res['valid']} "
                        f"{res['anomaly-types']} (host "
                        f"{host['anomaly-types']})")
                if r["extractions"] != 1 or len(scc.layer_entries(g)) != 4:
                    raise AssertionError(f"{sub}: not extracted as K = 4 "
                                         f"on the device: {r}")
                r["device_cycles"] = check_device_cycles(g, res)
            if sub == "8b-chain":
                # The G-single closes through every chain transaction,
                # and the BFS walks the chain level by level.
                lens = [len(x["cycle"]) - 1 for x in res["anomalies"]
                        ["G-single"] if "cycle" in x]
                if (lens != [ELLE_CHAIN]
                        or r["bfs_levels"] < ELLE_CHAIN - 1):
                    raise AssertionError(f"8b-chain: cycles of {lens} "
                                         f"transactions, {r}")
            log(f"phase{sub}: " + json.dumps(r))
            out["checks"].append(r)
            out["graphs"].setdefault(sub, g)
            if sub == "8b":
                out["profile_check"] = (h, model)

    if cuda:
        # The library call of the closure: its ceil(log2 V) bmm products
        # alone, at 8a's shape.
        a16 = torch.from_numpy(
            scc.pack_adjacency([out["graphs"]["8a"]])[0]).to(dev).to(
                torch.bfloat16)

        def bmm_steps():
            for _ in range(roofline.closure_steps(a16.shape[-1])):
                torch.bmm(a16, a16)

        out["bmm_ms"] = cuda_ms(bmm_steps, reps=20)
        log(f"phase8a: the closure's "
            f"{roofline.closure_steps(a16.shape[-1])} bare torch.bmm calls "
            f"at {list(a16.shape)}: {out['bmm_ms']:.6f} ms (CUDA events)")

    # 8d: many graphs through one screen call (K > 1).
    graphs = random_dep_graphs(SCREEN_GRAPHS, ELLE_SEED, DepGraph)
    t0 = time.perf_counter()
    flags, _, counts = counted(
        torch, dev, lambda: scc.screen_cycles(graphs, device=dev))
    wall = time.perf_counter() - t0
    want = [bool(g.sccs()) for g in graphs]
    if flags.tolist() != want or counts.get("scc_screens") != 1:
        raise AssertionError("8d: screen flags differ from host sccs()")
    adj = torch.from_numpy(scc.pack_adjacency(graphs)[0]).to(dev)
    d = {"graphs": len(graphs), "cyclic": sum(want),
         "shape": list(adj.shape), "wall_s": wall}
    if not 0.3 < d["cyclic"] / len(graphs) < 0.7:
        raise AssertionError(f"8d: {d['cyclic']} cyclic graphs of "
                             f"{len(graphs)}")
    if cuda:
        d["closure_ms"] = cuda_ms(
            lambda: scc.has_cycle(adj, torch.bfloat16), reps=20)
    log("phase8d: " + json.dumps(d))
    out["screen_batch"] = d

    # 8e: past max_device_vertices, the host route with no device call.
    h = history([Op(**x) for x in elle_ops("append", ELLE_BIG_TXNS,
                                           ELLE_SEED)])
    t0 = time.perf_counter()
    res, _, counts = counted(
        torch, dev, lambda: AppendChecker(device=dev).check({}, h, {}))
    e = {"txns": ELLE_BIG_TXNS, "wall_s": time.perf_counter() - t0,
         "valid": res["valid"], "screens": counts.get("scc_screens", 0),
         "extractions": counts.get("scc_extractions", 0)}
    if (e["screens"] or e["extractions"]
            or res != AppendChecker(device="off").check({}, h, {})
            or res["valid"] is not True):
        raise AssertionError(f"8e: {e}")
    log("phase8e: " + json.dumps(e))
    out["big"] = e
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase8: {out['wall_s']:.3f} s")
    return out


# ---------------------------------------------------------------------------
# The plan route (phase 9): the checkers' only route with its cost model
# and memo allowed and with JEPSEN_PLAN=0, the persistent plan memo, the
# fault hook and the profile records.

#: JEPSEN_PLAN on and off ("on", "off") in the compared checks: one
#: pair each (was three and two pairs: the plan is the port's only
#: route, so the pairs hold equal results, and their walls compare
#: nothing a user chooses between).
PLAN_ORDER = ("on", "off")
#: The 2,000-key all-valid check, one pair.
PLAN_ORDER_BIG = ("on", "off")
#: Phase 9d's valid history: 2,000 ops.
FAULT_OPS = 2000

#: The JAX package's profile records for phase 9e's checks of the bench
#: history and of phase 5's history, on its plan route (packed lanes at
#: their default, on the CPU: pass names, shape features and knobs are
#: counts, whatever the device), as (pass, features, plan).
#: tests/test_torch_telemetry.py holds the two packages' records equal
#: on the same shapes at a smaller size.
REF_PROFILE = {
    "bench": [
        ("witness", {"ok": 71304, "ops": 74614},
         {"bars_per_block": 2048, "blocks_per_call": 32,
          "info_window": 512, "width_hint": 0})],
    "mixed": [
        ("stream", {"keys": 200, "ops": 40364, "passes": 37,
                    "restarts": 30},
         {"bars_per_block": 2048, "blocks_per_call": 32,
          "max_restarts": 100, "packed": True, "segment": 25}),
        ("settle", {"keys": 30, "ops": 2249}, {})],
}


def set_env(name: str, value) -> None:
    """Sets (None: removes) one environment variable."""
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


def plan_runs(torch, dev, check, order) -> dict:
    """check() once per entry of `order` with JEPSEN_PLAN on or off, the
    settle memo cleared and the counts set to 0 just before each, read
    just after -> {"on": [...], "off": [...]} of (result, wall s,
    launches, counters, plan executions).  Each check must run the plan
    executor: it is the only route, whatever JEPSEN_PLAN says."""
    from jepsen_tpu_torch import telemetry
    from jepsen_tpu_torch.parallel import clear_settle_memo

    runs: dict = {"on": [], "off": []}
    try:
        for mode in order:
            set_env("JEPSEN_PLAN", "1" if mode == "on" else "0")
            clear_settle_memo()
            telemetry.reset()
            t0 = time.perf_counter()
            res, launches, counts = counted(torch, dev, check)
            dt = time.perf_counter() - t0
            runs[mode].append((res, dt, launches, counts,
                               telemetry.counter_value("wgl.plan.execute")))
    finally:
        set_env("JEPSEN_PLAN", None)
    for mode, rs in runs.items():
        for r in rs:
            if r[4] < 1:
                raise AssertionError(f"plan {mode}: a check ran no plan")
    return runs


def plan_counts(run) -> dict:
    _, _, launches, counts, _ = run
    return {"sweep_launches": launches.get("witness_sweep", 0),
            **{k: counts.get(k, 0) for k in (
                "heavy_rounds", "host_syncs", "bfs_levels",
                "stream_passes", "stream_restarts")}}


def plan_single(torch, dev, history) -> dict:
    """9a: the bench history through Linearizable with the plan on and
    off, in turns: equal verdicts, labels and counts."""
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.models import cas_register

    runs = plan_runs(torch, dev, lambda: Linearizable(
        cas_register(), "wgl-tpu", device=dev).check({}, history, {}),
        PLAN_ORDER)
    counts = {m: [plan_counts(r) for r in rs] for m, rs in runs.items()}
    labels = {(r[0]["valid"], r[0]["algorithm"]) for rs in runs.values()
              for r in rs}
    r = {"ops": len(history) // 2, "order": list(PLAN_ORDER),
         "median_s": {m: statistics.median(x[1] for x in rs)
                      for m, rs in runs.items()},
         "wall_s": {m: [x[1] for x in rs] for m, rs in runs.items()},
         "verdicts": sorted(labels), "counts": counts["on"][0]}
    log("phase9a: " + json.dumps(r))
    if labels != {(True, "wgl-tpu")} or any(
            c != counts["on"][0] for cs in counts.values() for c in cs):
        raise AssertionError(f"phase9a: plan on and off differ: verdicts "
                             f"{labels}, counts {counts}")
    need_launches("phase9a", dev, runs["on"][0][2])
    return r


def plan_many(torch, dev, what: str, history, order, failures: int) -> dict:
    """9b: one many-key history through IndependentChecker with the plan
    on and off: equal per-key verdicts and labels, failure count, tiers,
    stream passes, restarts and sweep launches."""
    from jepsen_tpu_torch import telemetry
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.parallel import IndependentChecker

    runs = plan_runs(torch, dev, lambda: IndependentChecker(
        Linearizable(cas_register(), time_limit_s=120, device=dev),
        device=dev).check({}, history, {}), order)
    settle = telemetry.settle_counters()
    first = runs["on"][0][0]
    want = {k: (v["valid"], v["algorithm"])
            for k, v in first["results"].items()}
    diff = []
    for mode, rs in runs.items():
        for res, _, _, _, _ in rs:
            got = {k: (v["valid"], v["algorithm"])
                   for k, v in res["results"].items()}
            if (got != want or res["failure-count"] != failures
                    or res["tiers"] != first["tiers"]):
                diff.append((mode, res["failure-count"], res["tiers"]))
    counts = {m: [{k: c[k] for k in ("sweep_launches", "stream_passes",
                                      "stream_restarts")}
                  for c in map(plan_counts, rs)] for m, rs in runs.items()}
    r = {"history": what, "ops": len(history) // 2,
         "order": list(order),
         "median_s": {m: statistics.median(x[1] for x in rs)
                      for m, rs in runs.items()},
         "wall_s": {m: [x[1] for x in rs] for m, rs in runs.items()},
         "failure_count": first["failure-count"], "tiers": first["tiers"],
         "counts": counts["on"][0], "settle_counters": settle}
    log(f"phase9b: {what} " + json.dumps(r))
    if diff or any(c != counts["on"][0] for cs in counts.values()
                   for c in cs):
        raise AssertionError(f"phase9b {what}: plan on and off differ: "
                             f"{diff[:4]}, counts {counts}")
    return r


def plan_memo(torch, dev, history) -> dict:
    """9c: the persistent plan memo in a temp directory: the second check
    of the bench history is a memo hit with no sweep; a fresh process
    state replays it from the journal; a new budget misses."""
    import tempfile

    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.plan import cache as plan_cache

    def check(limit=None):
        t0 = time.perf_counter()
        res, launches, _ = counted(torch, dev, lambda: Linearizable(
            cas_register(), "wgl-tpu", time_limit_s=limit,
            device=dev).check({}, history, {}))
        return (res, launches.get("witness_sweep", 0),
                time.perf_counter() - t0)

    with tempfile.TemporaryDirectory() as d:
        set_env("JEPSEN_PLAN_CACHE", d)
        plan_cache.reset_for_tests()
        try:
            cold = check()
            warm = check()
            plan_cache.reset_for_tests()  # a restarted process
            replay = check()
            loaded = plan_cache.active_memo().loaded
            other = check(limit=600.0)
            st = plan_cache.stats()["memo"]
        finally:
            set_env("JEPSEN_PLAN_CACHE", None)
            plan_cache.reset_for_tests()
    r = {name: {"valid": x[0]["valid"], "algorithm": x[0]["algorithm"],
                "memo_hit": bool(x[0].get("memo-hit")),
                "sweep_launches": x[1], "wall_s": x[2]}
         for name, x in (("cold", cold), ("warm", warm),
                         ("replayed", replay), ("new_budget", other))}
    r["journal_entries_loaded"] = loaded
    r["memo"] = st
    log("phase9c: " + json.dumps(r))
    on_card = dev.type == "cuda"  # the CPU runs the plain sweep
    ok = (not r["cold"]["memo_hit"]
          and (r["cold"]["sweep_launches"] > 0 or not on_card)
          and r["warm"]["memo_hit"] and r["warm"]["sweep_launches"] == 0
          and r["replayed"]["memo_hit"]
          and r["replayed"]["sweep_launches"] == 0 and loaded >= 1
          and not r["new_budget"]["memo_hit"]
          and (r["new_budget"]["sweep_launches"] > 0 or not on_card)
          and {x["valid"] for k, x in r.items() if isinstance(x, dict)
               and "valid" in x} == {True})
    if not ok:
        raise AssertionError(f"phase9c: memo readings {r}")
    return r


def plan_faults(torch, dev) -> dict:
    """9d: the fault hook on the card.  A witness fault sheds the packed
    lanes, retries at half the block shape, falls through, and the
    frontier BFS still proves the history; with every tier faulted the
    check raises after the one halved retry, carrying the card probe's
    result."""
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import degrade
    from jepsen_tpu_torch.utils.histgen import random_register_history

    h = random_register_history(FAULT_OPS, procs=8, info_rate=0.05,
                                seed=BENCH_SEED)
    r: dict = {"ops": FAULT_OPS}
    try:
        set_env(degrade.FAULT_ENV, "witness")
        t0 = time.perf_counter()
        res, launches, counts = counted(torch, dev, lambda: Linearizable(
            cas_register(), device=dev).check({}, h, {}))
        r["witness"] = {
            "valid": res["valid"], "algorithm": res["algorithm"],
            "degradations": [(s["tier"], s["action"])
                             for s in res.get("degradations", ())],
            "bfs_levels": counts.get("bfs_levels", 0),
            "sweep_launches": launches.get("witness_sweep", 0),
            "wall_s": time.perf_counter() - t0}
        set_env(degrade.FAULT_ENV, "all")
        t0 = time.perf_counter()
        try:
            Linearizable(cas_register(), device=dev).check({}, h, {})
        except degrade.CardExhausted as e:
            r["all"] = {"raised": type(e).__name__, "probe": e.probe,
                        "wall_s": time.perf_counter() - t0}
        else:
            raise AssertionError("phase9d: every tier faulted and the "
                                 "check did not raise")
    finally:
        set_env(degrade.FAULT_ENV, None)
    log("phase9d: " + json.dumps(r))
    w = r["witness"]
    if (w["valid"] is not True or w["degradations"] != [
            ("witness", "packed-fallback"), ("witness", "retry-halved"),
            ("witness", "fall-through")]
            or w["bfs_levels"] <= 0):
        raise AssertionError(f"phase9d: witness fault gave {w}")
    if dev.type == "cuda" and not r["all"]["probe"]["ok"]:
        raise AssertionError(f"phase9d: card probe failed: {r['all']}")
    return r


def plan_profiles(torch, dev, history, mixed, kind: str,
                  ref=REF_PROFILE) -> dict:
    """9e: telemetry on and a profile store in a temp directory; one
    check of the bench history and one of phase 5's history.  At full
    size the records' passes, features and knobs equal the reference's;
    each names the card, and the Chrome trace loads.  Then a frontier
    BFS (a 400-op history with an impossible read) and an Elle check
    (300 list-append transactions with a G-single): the witness (sweep
    and chain rounds), stream, bfs and elle records carry non-null cost
    and roofline blocks."""
    import tempfile

    from jepsen_tpu_torch import telemetry
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.checker.elle import AppendChecker
    from jepsen_tpu_torch.history.core import Op
    from jepsen_tpu_torch.history.core import history as make_history
    from jepsen_tpu_torch.history.packed import pack_history
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops.wgl import check_wgl_device
    from jepsen_tpu_torch.parallel import IndependentChecker, \
        clear_settle_memo
    from jepsen_tpu_torch.telemetry import profile
    from jepsen_tpu_torch.utils.histgen import random_register_history

    pm = cas_register().packed()
    bad = pack_history(random_register_history(400, procs=4, info_rate=0.0,
                                               seed=BENCH_SEED, bad=True),
                       pm.encode)
    elle_h = make_history([Op(**d) for d in elle_ops(
        "append", 300, ELLE_SEED, inject=("G-single",))])

    got: dict = {}
    with tempfile.TemporaryDirectory() as d:
        telemetry.enable(True)
        telemetry.reset()
        profile.set_store(d)
        try:
            for name, check in (
                    ("bench", lambda: Linearizable(
                        cas_register(), "wgl-tpu", device=dev).check(
                        {}, history, {})),
                    ("mixed", lambda: IndependentChecker(Linearizable(
                        cas_register(), time_limit_s=120, device=dev),
                        device=dev).check({}, mixed, {})),
                    ("bfs", lambda: check_wgl_device(
                        bad, pm, time_limit_s=120, device=dev)),
                    ("elle", lambda: AppendChecker(
                        "serializable", device=dev).check({}, elle_h, {}))):
                clear_settle_memo()
                n0 = profile.count_records()
                check()
                got[name] = profile.read(profile.store_path())[n0:]
            paths = telemetry.export(d)
            with open(paths[1]) as f:
                trace = json.load(f)
            spans = telemetry.summary()["spans"]
        finally:
            profile.set_store(None)
            telemetry.reset()
            telemetry.enable(False)
    rows = {name: [(x["pass"], x["features"],
                    {k: v for k, v in x["plan"].items() if k != "mesh"})
                   for x in recs] for name, recs in got.items()}
    r = {"records": {name: [dict(zip(("pass", "features", "plan"), row),
                                 timing=x["timing"], device=x["device"],
                                 cost=x["cost"], roofline=x["roofline"])
                            for row, x in zip(rows[name], got[name])]
                     for name in rows},
         "trace_events": len(trace["traceEvents"]),
         "spans": {k: v["count"] for k, v in spans.items()}}
    log("phase9e: " + json.dumps(r))
    # The reference's records are for the full-size histories.
    rows = {name: rows[name] for name in ("bench", "mixed")}
    if len(history) // 2 == BENCH_OPS and rows != ref:
        raise AssertionError(f"phase9e: records {rows} != the "
                             f"reference's {ref}")
    costed = {x["pass"] for recs in got.values() for x in recs
              if x["cost"]["flops"] and x["cost"]["bytes_accessed"]
              and x["roofline"]["peak_flops_per_s"]
              and x["roofline"]["achieved_bytes_per_s"] is not None}
    if not {"witness", "stream", "bfs", "elle"} <= costed:
        raise AssertionError(f"phase9e: passes with cost and roofline "
                             f"blocks: {sorted(costed)}")
    kinds = {x["device"]["device_kind"] for recs in got.values()
             for x in recs}
    if kinds != {kind}:
        raise AssertionError(f"phase9e: records name {kinds}, not {kind}")
    if not any(e["ph"] == "X" for e in trace["traceEvents"]):
        raise AssertionError("phase9e: the Chrome trace holds no span")
    return r


def phase_plan(torch, history, dev=None, mixed_keys: int = MIXED_KEYS,
               big_keys: int = BIG_KEYS) -> dict:
    """Phase 9, the plan route, on `dev` (the card by default)."""
    from jepsen_tpu_torch import telemetry

    dev = torch.device("cuda") if dev is None else torch.device(dev)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)
    mixed = mixed_history(mixed_keys, MIXED_BAD)
    telemetry.enable(True)
    try:
        out = {
            "single": plan_single(torch, dev, history),
            "mixed": plan_many(torch, dev, "mixed", mixed, PLAN_ORDER,
                               MIXED_BAD),
            "all_valid": plan_many(torch, dev, "all-valid",
                                   mixed_history(big_keys, 0),
                                   PLAN_ORDER_BIG, 0),
        }
    finally:
        telemetry.reset()
        telemetry.enable(False)
    out["memo"] = plan_memo(torch, dev, history)
    out["faults"] = plan_faults(torch, dev)
    out["profiles"] = plan_profiles(torch, dev, history, mixed, kind)
    return out


# ---------------------------------------------------------------------------
# The checker daemon (phase 10): checkerd on the card, at a fleet's size.

#: Phase 10: concurrent runs, the daemon's batch window, the seed offset
#: of each run's history (run r: seeds DAEMON_SEED * (r + 1) + key), and
#: the fresh histories of the budget trap and the restart.  The window
#: is 1 s, not a standalone daemon's fraction of one: here the four
#: clients share the daemon's interpreter, so their uploads, the
#: handlers' decoding and the journal's writes take turns under one
#: lock; the runs' commits spread 0.13-0.23 s on the host of an H100
#: 80GB HBM3 at 700 W (PERF.md, PR 7), and more on slower hosts.
DAEMON_RUNS, DAEMON_WINDOW_S, DAEMON_SEED = 4, 1.0, 1000
DAEMON_TRAP_SEED, DAEMON_RESTART_SEED = 9000, 8000
#: Seconds any one daemon round trip may take.
DAEMON_WAIT_S = 300.0


def _key_view(res: dict) -> dict:
    """{key: (valid, algorithm, configs-explored)} of a many-key result."""
    return {str(k): (r.get("valid"), r.get("algorithm"),
                     r.get("configs-explored"))
            for k, r in res["results"].items()}


def _wait_timeout_threads(limit_s: float) -> int:
    """Waits for the worker threads a budget abandoned (utils.timeout)
    to end -> how many there were; raises past `limit_s`."""
    import threading

    from jepsen_tpu_torch.utils import TIMEOUT_THREAD

    t0 = time.monotonic()
    left = [t for t in threading.enumerate() if t.name == TIMEOUT_THREAD]
    for t in left:
        t.join(max(0.0, limit_s - (time.monotonic() - t0)))
        if t.is_alive():
            raise AssertionError(f"phase10: an abandoned cohort thread ran "
                                 f"past {limit_s} s")
    return len(left)


class _Daemon:
    """An in-process checkerd on 127.0.0.1, served from a thread, with
    a `window` s batch window and its profile store, plan memo (unless
    `memo` is false) and queue journal under `tmp`."""

    def __init__(self, dev, tmp, window: float = DAEMON_WINDOW_S,
                 memo: bool = True, **kw):
        import socket
        import threading

        from jepsen_tpu_torch.checkerd.server import make_server

        os.makedirs(tmp, exist_ok=True)
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        self.srv = make_server(
            "127.0.0.1", port, device=dev, batch_window_s=window,
            profile_dir=os.path.join(tmp, "profiles"),
            plan_cache_dir=os.path.join(tmp, "plan-cache") if memo else None,
            queue_path=os.path.join(tmp, "checkerd.queue"), **kw)
        self.addr = f"127.0.0.1:{self.srv.server_address[1]}"
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       name="checkerd-server", daemon=True)
        self.thread.start()

    def stop(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.srv.scheduler.stop()
        self.thread.join(timeout=10)


def daemon_check(torch, dev, h, run: str, addr: str, barrier=None,
                 **test) -> tuple:
    """One cas-register run `h` through RemoteChecker to the daemon at
    `addr` (no in-process fallback) -> (result, client wall).  With a
    `barrier`, concurrent runs upload their ops and then meet before
    COMMIT, so their submissions reach the queue together."""
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.checkerd.client import CheckerdClient, RemoteChecker
    from jepsen_tpu_torch.checkerd.protocol import F_COMMIT
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.parallel import IndependentChecker

    base = IndependentChecker(Linearizable(cas_register(), time_limit_s=120,
                                           device=dev), device=dev)

    class AlignedClient(CheckerdClient):
        def _send(self, ftype, payload):
            if ftype == F_COMMIT and barrier is not None:
                barrier.wait()
            super()._send(ftype, payload)

    class Aligned(RemoteChecker):
        def _attempt(self, addr, test, keys, subs_ops, spec, lin,
                     independent, run, budget, deadline):
            with AlignedClient(addr) as c:
                ticket = c.submit_ops(
                    run, spec, subs_ops, algorithm=lin.algorithm,
                    budget_s=budget, time_limit_s=lin.time_limit_s,
                    deadline_s=deadline)
                return c.wait(ticket, deadline_s=deadline)

    t0 = time.perf_counter()
    res = Aligned(base, addr, run_id=run, fallback=False).check(
        {"name": run, **test}, h, {})
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_daemon(torch, dev=None, keys: int = MIXED_KEYS,
                 big_keys: int = BIG_KEYS, n_bad: int = MIXED_BAD) -> dict:
    """Phase 10: the checker daemon on `dev` (the card by default),
    in-process on 127.0.0.1, with a DAEMON_WINDOW_S batch window and its
    profile store, plan memo and queue journal under a temp dir.

    (10a) DAEMON_RUNS threads each submit a run_mixed-shaped history
    (`keys` keys, `n_bad` bad, seeds per run) through RemoteChecker: one
    cohort (merged-runs = DAEMON_RUNS), each run False with its own 30
    failing keys, every per-key valid / algorithm / configs-explored the
    in-process IndependentChecker's on the same device, the sweep kernel
    launched; (10b) phase 5's `big_keys` valid keys as one packed
    submission: all valid, as many as in-process; (10c) STATS (devices,
    chip-health ok, the roofline against the H100's peaks, profile
    records) and a /metrics scrape with no SLO rule firing; (10d) the
    `big_keys` history under a 0.001 s budget: unknown with
    budget-exceeded, and the submission right after it (while the
    abandoned cohort may still run) correct; (10e) the daemon stopped
    with one ticket journaled and unfinished finishes it after a
    restart, and a settled history resubmitted hits the plan memo with
    no sweep launch.  Raises on any failed check."""
    import shutil
    import tempfile
    import threading
    import urllib.request

    from jepsen_tpu_torch import telemetry
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.checkerd.client import CheckerdClient
    from jepsen_tpu_torch.checkerd.protocol import model_to_spec
    from jepsen_tpu_torch.checkerd.server import make_metrics_server
    from jepsen_tpu_torch.history.packed import pack_history
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import kernels
    from jepsen_tpu_torch.parallel import IndependentChecker, \
        clear_settle_memo, subhistories
    from jepsen_tpu_torch.plan import cache as plan_cache
    from jepsen_tpu_torch.telemetry import flight, profile, roofline, slo

    dev = torch.device("cuda") if dev is None else torch.device(dev)
    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    out: dict = {}

    def in_process(h):
        clear_settle_memo()
        chk = IndependentChecker(Linearizable(cas_register(),
                                              time_limit_s=120, device=dev),
                                 device=dev)
        return chk.check({}, h, {})

    def remote(h, run, addr, barrier=None, **test):
        return daemon_check(torch, dev, h, run, addr, barrier, **test)

    # The in-process verdicts first: the daemon configures the process's
    # plan memo, which would answer these from its journal.
    runs = {f"run{r}": mixed_history(keys, n_bad,
                                     seed0=DAEMON_SEED * (r + 1))
            for r in range(DAEMON_RUNS)}
    want = {run: _key_view(in_process(h)) for run, h in runs.items()}
    big = mixed_history(big_keys, 0)
    big_in = in_process(big)
    trap_h = mixed_history(keys, n_bad, seed0=DAEMON_TRAP_SEED)
    trap_want = _key_view(in_process(trap_h))
    restart_h = mixed_history(keys, n_bad, seed0=DAEMON_RESTART_SEED)
    restart_want = in_process(restart_h)["valid"]

    tmp = tempfile.mkdtemp(prefix="chip-smoke-checkerd-")
    prior = telemetry.enabled()
    telemetry.enable(True)
    d = None
    try:
        clear_settle_memo()
        d = _Daemon(dev, tmp)
        # 10a: DAEMON_RUNS concurrent runs, one cohort.
        got, errors = {}, []
        barrier = threading.Barrier(DAEMON_RUNS, timeout=DAEMON_WAIT_S)

        def submit(run):
            try:
                got[run] = remote(runs[run], run, d.addr, barrier)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"{run}: {e!r}")

        kernels.launches.clear()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=submit, args=(run,))
                   for run in runs]
        for th in threads:
            th.start()
        for th in threads:
            th.join(DAEMON_WAIT_S)
        wall_a = time.perf_counter() - t0
        if errors or len(got) != DAEMON_RUNS:
            raise AssertionError(f"phase10a: {errors or sorted(got)}")
        launched = kernels.launches["witness_sweep"]
        if cuda and launched <= 0:
            raise AssertionError("phase10a: the sweep kernel never launched")
        waits = [res["checkerd"]["queue-wait-s"] for res, _ in got.values()]
        per_run = {"commit_spread_s": max(waits) - min(waits)}
        for run, (res, wall) in sorted(got.items()):
            meta = res["checkerd"]
            failing = sorted(k for k, r in res["results"].items()
                             if r["valid"] is False)
            if (res["valid"] is not False
                    or failing != sorted(f"k{i}" for i in range(n_bad))
                    or meta.get("merged-runs") != DAEMON_RUNS
                    or "fallback" in meta):
                raise AssertionError(
                    f"phase10a {run}: valid {res['valid']}, "
                    f"{len(failing)} failing, merged-runs "
                    f"{meta.get('merged-runs')}, meta keys {sorted(meta)}")
            diff = {k: (v, want[run][k]) for k, v in _key_view(res).items()
                    if v != want[run][k]}
            if diff:
                raise AssertionError(f"phase10a {run}: per-key results "
                                     f"differ from in-process: "
                                     f"{dict(list(diff.items())[:6])}")
            per_run[run] = {"queue_wait_s": meta["queue-wait-s"],
                            "check_s": meta["check-s"],
                            "client_wall_s": wall,
                            "cohort_keys": meta["cohort-keys"]}
        runs_r = [r for r in per_run.values() if isinstance(r, dict)]
        check_s = max(r["check_s"] for r in runs_r)
        overhead = max(r["client_wall_s"] - r["queue_wait_s"] - r["check_s"]
                       for r in runs_r)
        out["10a"] = {"runs": per_run, "wall_s": wall_a,
                      "cohort_check_s": check_s,
                      "overhead_s": overhead,
                      "overhead_fraction": overhead / check_s,
                      "sweep_launches": launched}
        log("phase10a: " + json.dumps(out["10a"]))

        # 10b: the all-valid keys as one packed submission.
        pm = cas_register().packed()
        subs = subhistories(big)
        packs = [pack_history(subs[k], pm.encode) for k in subs]
        kernels.launches.clear()
        t0 = time.perf_counter()
        with CheckerdClient(d.addr, io_timeout=DAEMON_WAIT_S) as c:
            ticket = c.submit_packed("packed", model_to_spec(cas_register()),
                                     packs)
            res = c.wait(ticket, deadline_s=DAEMON_WAIT_S)
        wall_b = time.perf_counter() - t0
        valid_b = sum(1 for kr in res["key-results"] if kr["valid"] is True)
        valid_in = sum(1 for r in big_in["results"].values()
                       if r["valid"] is True)
        if (res["valid"] is not True or valid_b != valid_in != big_keys
                or len(res["key-results"]) != big_keys):
            raise AssertionError(f"phase10b: valid {res['valid']}, "
                                 f"{valid_b} of {len(res['key-results'])} "
                                 f"keys valid, in-process {valid_in}")
        algos: dict = {}
        for kr in res["key-results"]:
            algos[kr.get("algorithm")] = algos.get(kr.get("algorithm"), 0) + 1
        out["10b"] = {"keys": big_keys, "valid_keys": valid_b,
                      "algorithms": algos, "wall_s": wall_b,
                      "check_s": res["checkerd"]["check-s"],
                      "sweep_launches": kernels.launches["witness_sweep"]}
        log("phase10b: " + json.dumps(out["10b"]))

        # 10c: STATS and /metrics.
        with CheckerdClient(d.addr) as c:
            st = c.stats()
        name = torch.cuda.get_device_name(dev) if cuda else "cpu"
        want_dev = ({"count": 1, "platform": "gpu", "kind": name} if cuda
                    else {"count": 1, "platform": "cpu", "kind": "cpu"})
        roof = st.get("roofline") or {}
        knee = roofline.H100_FLOPS_PER_S / roofline.H100_BYTES_PER_S
        costed = {p: r for p, r in roof.items() if r.get("with_cost")}
        if (st["devices"] != want_dev
                or (cuda and st["chip-health"] != "ok")
                or st["profile-records"] <= 0 or not costed
                or (cuda and any(abs(r["knee_intensity"] - knee) > 1e-3
                                 for r in costed.values()))):
            raise AssertionError(
                f"phase10c: devices {st['devices']}, chip-health "
                f"{st['chip-health']}, profile-records "
                f"{st['profile-records']}, roofline {roof}")
        msrv = make_metrics_server(d.srv.scheduler, "127.0.0.1", 0)
        mth = threading.Thread(target=msrv.serve_forever, daemon=True)
        mth.start()
        try:
            url = f"http://127.0.0.1:{msrv.server_address[1]}/metrics"
            with urllib.request.urlopen(url, timeout=DAEMON_WAIT_S) as r:
                body = r.read().decode()
        finally:
            msrv.shutdown()
            msrv.server_close()
            mth.join(timeout=10)
        firing, samples = [], 0
        for line in body.splitlines():
            if not line or line.startswith("#"):
                continue
            sample, value = line.rsplit(" ", 1)
            float(value)
            samples += 1
            if sample.startswith("jepsen_slo_firing") and float(value):
                firing.append(sample)
        if firing or "jepsen_slo_firing" not in body or samples == 0:
            raise AssertionError(f"phase10c: /metrics firing {firing}, "
                                 f"{samples} samples")
        out["10c"] = {"devices": st["devices"],
                      "chip_health": st["chip-health"],
                      "profile_records": st["profile-records"],
                      "profile_by_pass": st["profile-by-pass"],
                      "roofline": roof, "merge_ratio": st["merge-ratio"],
                      "metrics_samples": samples,
                      "utilization": st["utilization"]}
        log("phase10c: " + json.dumps(out["10c"]))

        # 10d: a budget no cohort meets, then the next submission.
        res_d, _ = remote(big, "budget", d.addr, checker_budget=0.001)
        unknown = all(r["valid"] == "unknown"
                      for r in res_d["results"].values())
        if (res_d["valid"] != "unknown" or not unknown
                or not res_d["checkerd"].get("budget-exceeded")):
            raise AssertionError(f"phase10d: budget result "
                                 f"{res_d['valid']}, meta "
                                 f"{sorted(res_d['checkerd'])}")
        clear_settle_memo()
        res_n, wall_n = remote(trap_h, "after-budget", d.addr)
        diff = {k: (v, trap_want[k]) for k, v in _key_view(res_n).items()
                if v != trap_want[k]}
        if diff or res_n["valid"] is not False:
            raise AssertionError(f"phase10d: the submission after the "
                                 f"budget differs: {res_n['valid']}, "
                                 f"{dict(list(diff.items())[:6])}")
        abandoned = _wait_timeout_threads(DAEMON_WAIT_S)
        out["10d"] = {"budget_valid": res_d["valid"],
                      "next_valid": res_n["valid"], "next_wall_s": wall_n,
                      "abandoned_threads": abandoned}
        log("phase10d: " + json.dumps(out["10d"]))

        # 10e: a daemon that dies between TICKET and verdict: its worker
        # stopped, one ticket admitted (journaled), then the daemon.
        sched = d.srv.scheduler
        with sched._cond:
            sched._stop = True
            sched._cond.notify_all()
        sched._thread.join(DAEMON_WAIT_S)
        rsubs = subhistories(restart_h)
        # The submitter stays connected while the daemon goes down (a
        # client that hangs up first abandons its queued ticket).
        waiting = CheckerdClient(d.addr)
        try:
            ticket = waiting.submit_ops(
                "restart", model_to_spec(cas_register()),
                [[o.to_dict() for o in rsubs[k]] for k in rsubs],
                time_limit_s=120)
            unfinished = sched.journal.stats()["unfinished"]
            d.stop()
            d = None
        finally:
            waiting.close()
        plan_cache.reset_for_tests()  # a new process's memo
        clear_settle_memo()
        kernels.launches.clear()
        d = _Daemon(dev, tmp)
        with CheckerdClient(d.addr, io_timeout=DAEMON_WAIT_S) as c:
            res_e = c.wait(ticket, deadline_s=DAEMON_WAIT_S)
        replayed = d.srv.scheduler.stats()["replayed"]
        if unfinished != 1 or replayed != 1 or \
                res_e["valid"] is not restart_want:
            raise AssertionError(f"phase10e: {unfinished} unfinished, "
                                 f"{replayed} replayed, verdict "
                                 f"{res_e['valid']} want {restart_want}")
        # The replayed history again: the plan memo answers (the
        # in-memory settle memo cleared), no sweep.  (A memo key holds
        # the packed values, which a daemon's model interns in first-seen
        # order, so a history hits after a restart only if the restarted
        # daemon meets the values in the same order.)
        clear_settle_memo()
        before = kernels.launches["witness_sweep"]
        memo0 = d.srv.scheduler.stats()["plan"]["cache"]["memo"]["hits"]
        res_m, _ = remote(restart_h, "resubmit", d.addr)
        memo1 = d.srv.scheduler.stats()["plan"]["cache"]["memo"]["hits"]
        swept = kernels.launches["witness_sweep"] - before
        if memo1 <= memo0 or swept != 0 or res_m["valid"] is not \
                restart_want:
            raise AssertionError(f"phase10e: resubmission memo hits "
                                 f"{memo0}->{memo1}, sweeps {swept}, "
                                 f"verdict {res_m['valid']}")
        out["10e"] = {"unfinished": unfinished, "replayed": replayed,
                      "replayed_valid": res_e["valid"],
                      "memo_hits": memo1 - memo0, "resubmit_sweeps": swept}
        log("phase10e: " + json.dumps(out["10e"]))
    finally:
        if d is not None:
            d.stop()
        _wait_timeout_threads(DAEMON_WAIT_S)
        telemetry.enable(prior)
        profile.set_store(None)
        flight.set_dir(None)
        slo.reset()
        plan_cache.configure(None)
        plan_cache.reset_for_tests()
        clear_settle_memo()
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    return out


#: Phase 11: a Jepsen test run through the port's CLI.  The north-star
#: workload (linearizable_register, in-memory client, noop nemesis,
#: dummy remote) at 600 keys x 100 ops (threads-per-key 4,
#: concurrency 32: phase 5's shape at 600 of its 2,000 keys, cut to pay
#: for phases 17 and 19), at 200 keys with a
#: stale-read client on keys 0-29, and at 200 keys with the online
#: session; list-append at 1,000 transactions.
RUN_KEYS, RUN_KEYS_SMALL, RUN_PER_KEY = 600, 200, 100
RUN_THREADS_PER_KEY, RUN_CONCURRENCY, RUN_TIME_LIMIT = 4, 32, 300
RUN_STALE_KEYS = 30
RUN_APPEND_TXNS = 1000


def stale_read_client():
    """The north-star workload's in-memory client, but a read of a key
    below RUN_STALE_KEYS returns a value no write wrote: a test
    fixture, so that phase 11b's run is invalid on exactly those
    keys."""
    from jepsen_tpu_torch.history import OK
    from jepsen_tpu_torch.workloads import linearizable_register as lr

    class StaleRead(lr.InMemoryKVRegisterClient):
        def open(self, test, node):
            return StaleRead(self.state, self.lock)

        def invoke(self, test, op):
            out = super().invoke(test, op)
            k = op.value.key
            if op.f == "read" and k < RUN_STALE_KEYS and out.type == OK:
                out = out.replace(value=type(op.value)(k, 99))
            return out

    return StaleRead()


class AnalysisClock:
    """While entered, each `core.analyze` call is timed (`seconds`, once
    the card's queue has drained) and its `forensics.assemble`
    telemetry span read (`forensics`), one entry a call.  The span
    records only with telemetry on; on for a whole run, telemetry would
    also span every op the interpreter journals, so the clock turns it
    on for the analysis alone."""

    def __init__(self, torch):
        self.torch = torch
        self.seconds, self.forensics = [], []

    def __enter__(self):
        from jepsen_tpu_torch import core, telemetry

        self.core, self.real = core, core.analyze

        def span_s():
            return telemetry.phases("forensics").get("assemble", 0.0)

        def timed(*a, **kw):
            was = telemetry.enabled()
            telemetry.enable(True)
            f0, t0 = span_s(), time.perf_counter()
            try:
                return self.real(*a, **kw)
            finally:
                if self.torch.cuda.is_available():
                    self.torch.cuda.synchronize()
                self.seconds.append(time.perf_counter() - t0)
                self.forensics.append(span_s() - f0)
                telemetry.enable(was)

        core.analyze = timed
        return self

    def __exit__(self, *exc):
        self.core.analyze = self.real


def _run_cli(torch, argv, suite, what: str, smi: str,
             phase: str = "11") -> dict:
    """`cli.run` of `argv` over `suite`, the counts set to 0 just before
    and read just after, the analysis timed apart (`AnalysisClock`) ->
    the readings, with the stored run's directory, results and
    history."""
    from jepsen_tpu_torch import cli, store
    from jepsen_tpu_torch import device as D
    from jepsen_tpu_torch.ops import kernels
    from jepsen_tpu_torch.parallel import clear_settle_memo
    from jepsen_tpu_torch.workloads import _extra_opts

    parser = cli.single_test_cmd(suite, extra_opts=_extra_opts)
    clear_settle_memo()
    kernels.launches.clear()
    D.counters.clear()
    with AnalysisClock(torch) as clock:
        t0 = time.perf_counter()
        code = cli.run(parser, argv)
        wall = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.launches.items()
                if k.startswith("witness_sweep")}
    counts = dict(D.counters)
    root = argv[argv.index("--store-dir") + 1]
    d = store.latest(root)
    tf = store.load(d)
    try:
        results, h = tf.results, tf.history()
    finally:
        tf.close()
    analyze_s = sum(clock.seconds)
    r = {"exit": code, "ops": len(h) // 2, "wall_s": wall,
         "run_s": wall - analyze_s, "analyze_s": analyze_s,
         "ops_per_s": len(h) / 2 / wall, "sweeps": launches.get(
             "witness_sweep", 0), "launches": launches,
         "host_syncs": counts.get("host_syncs", 0),
         "stream_passes": counts.get("stream_passes", 0),
         "forensics_s": sum(clock.forensics), "card": smi}
    log(f"phase{phase}{what}: " + json.dumps(r))
    r.update(dir=d, results=results, history=h)
    return r


def _exact_per_key(history) -> dict:
    """Each key's verdict from the exact CPU engine (`algorithm="cpu"`,
    checker/wgl_cpu.py) on its subhistory of a stored keyed history."""
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.parallel import subhistories
    from jepsen_tpu_torch.utils import bounded_pmap
    from jepsen_tpu_torch.workloads.linearizable_register import revive_kv

    subs = subhistories(revive_kv(history))
    keys = list(subs)
    res = bounded_pmap(lambda k: Linearizable(
        cas_register(), "cpu", time_limit_s=120, device="cpu").check(
            {}, subs[k], {})["valid"], keys)
    return dict(zip(keys, res))


def _per_key(results) -> dict:
    return {int(k): r["valid"] for k, r in results["results"].items()}


def _hold_exact(what: str, run: dict, want_invalid=()) -> None:
    exact = _exact_per_key(run["history"])
    got = _per_key(run["results"])
    diff = {k: (got.get(k), v) for k, v in exact.items() if got.get(k) != v}
    if diff or set(got) != set(exact):
        raise AssertionError(f"phase11{what}: per-key verdicts differ from "
                             f"the exact CPU engine's (got, exact): "
                             f"{dict(list(diff.items())[:8])}")
    bad = sorted(k for k, v in exact.items() if v is not True)
    if bad != sorted(want_invalid):
        raise AssertionError(f"phase11{what}: invalid keys {bad[:40]}, want "
                             f"{sorted(want_invalid)[:40]}")


def phase_run(torch, dev=None, keys: int = RUN_KEYS,
              small: int = RUN_KEYS_SMALL,
              txns: int = RUN_APPEND_TXNS, root=None) -> dict:
    """Phase 11: a Jepsen test run on the card, through the port's CLI
    (`cli test --dummy-ssh`, `cli analyze`) and its normal entry points:
    core.run -> generator -> interpreter -> in-memory client workers ->
    history -> store -> core.analyze -> the checkers on the card.
    (11a) the north-star workload at `keys` keys: EXIT_VALID, every
    per-key verdict the exact CPU engine's on the stored history; (11b)
    at `small` keys with the stale-read client: EXIT_INVALID, exactly
    keys 0-29 invalid, as the exact engine finds them; (11c) at `small`
    keys with the online session (--streaming): every key "wgl-online",
    each verdict the post-hoc check's of the same stored history, and
    the verdict lag; (11d) `cli analyze` of 11a's stored run: 11a's
    results; (11e) list-append at `txns` transactions, with telemetry
    on for the whole run, into 11a's store: the verdict and anomaly types
    of the host search (device="off").  Each prints ops, run and analyze
    seconds, sweeps and host syncs, and the card.  With `root` the
    stores are made there and kept (phase 17d serves 11a's), and
    `out["stored"]` names 11a's and 11e's run directories."""
    import contextlib
    import tempfile

    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.checker.elle import AppendChecker
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.parallel import IndependentChecker, \
        clear_settle_memo
    from jepsen_tpu_torch.workloads import append, test_fn
    from jepsen_tpu_torch.workloads.linearizable_register import revive_kv

    dev = "cuda" if dev is None else str(dev)
    smi = (torch.cuda.get_device_name(0) if dev == "cuda" else "cpu")
    if dev == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    out: dict = {}
    t_phase = time.perf_counter()
    with (contextlib.nullcontext(root) if root is not None else
          tempfile.TemporaryDirectory(prefix="phase11-")) as tmp:
        def argv(cmd, n_keys, sub, *more):
            return [cmd, "--workload", "linearizable-register",
                    "--dummy-ssh", "--device", dev, "--key-count",
                    str(n_keys), "--per-key-limit", str(RUN_PER_KEY),
                    "--threads-per-key", str(RUN_THREADS_PER_KEY),
                    "--concurrency", str(RUN_CONCURRENCY), "--time-limit",
                    str(RUN_TIME_LIMIT), "--seed", str(BENCH_SEED),
                    "--store-dir", os.path.join(tmp, sub), *more]

        a = _run_cli(torch, argv("test", keys, "a"), test_fn, "a", smi)
        if a["exit"] != cli.EXIT_VALID or a["ops"] != keys * RUN_PER_KEY:
            raise AssertionError(f"phase11a: exit {a['exit']}, {a['ops']} "
                                 f"ops")
        _hold_exact("a", a)

        def stale(opts):
            return {**test_fn(opts), "client": stale_read_client()}

        b = _run_cli(torch, argv("test", small, "b"), stale, "b", smi)
        if b["exit"] != cli.EXIT_INVALID:
            raise AssertionError(f"phase11b: exit {b['exit']}")
        _hold_exact("b", b, want_invalid=range(RUN_STALE_KEYS))

        c = _run_cli(torch, argv("test", small, "c", "--streaming"),
                     test_fn, "c", smi)
        algos = {r.get("algorithm") for r in c["results"]["results"].values()}
        clear_settle_memo()
        post = IndependentChecker(Linearizable(cas_register(), device=dev),
                                  streaming=False, device=dev).check(
            {}, revive_kv(c["history"]), {})
        if (c["exit"] != cli.EXIT_VALID or algos != {"wgl-online"}
                or _per_key(c["results"]) != _per_key(post)):
            raise AssertionError(f"phase11c: exit {c['exit']}, algorithms "
                                 f"{algos}, verdicts equal post-hoc "
                                 f"{_per_key(c['results']) == _per_key(post)}")
        stream = c["results"].get("streaming", {})
        log("phase11c: session " + json.dumps(stream, default=str))

        d = _run_cli(torch, argv("analyze", keys, "a"), test_fn, "d", smi)
        if d["exit"] != cli.EXIT_VALID or d["results"]["results"].keys() \
                != a["results"]["results"].keys() or \
                _per_key(d["results"]) != _per_key(a["results"]):
            raise AssertionError(f"phase11d: exit {d['exit']}, results "
                                 f"differ from 11a's")

        def txn_suite(opts):
            wl = append.workload({"seed": BENCH_SEED, "device": dev})
            return {**wl, "generator": gen.clients(gen.limit(
                txns, wl["generator"]))}

        from jepsen_tpu_torch import telemetry

        was = telemetry.enabled()
        telemetry.enable(True)
        try:
            e = _run_cli(torch, ["test", "--dummy-ssh", "--device", dev,
                                 "--concurrency", "10", "--store-dir",
                                 os.path.join(tmp, "a")], txn_suite, "e",
                         smi)
        finally:
            telemetry.enable(was)
        host = AppendChecker("serializable", device="off").check(
            {}, e["history"], {})
        if (e["exit"] != cli.EXIT_VALID or e["ops"] != txns
                or e["results"]["valid"] != host["valid"]
                or e["results"].get("anomaly-types")
                != host.get("anomaly-types")):
            raise AssertionError(f"phase11e: exit {e['exit']}, {e['ops']} "
                                 f"txns, {e['results'].get('valid')} vs host "
                                 f"{host.get('valid')}")
        out["artifacts"] = {k: key_artifacts(r, k)
                            for k, r in (("a", a), ("b", b))}
        if e["dir"] == a["dir"] or not os.path.isfile(
                os.path.join(e["dir"], "telemetry.json")):
            raise AssertionError("phase11e: no telemetry.json in its own "
                                 "run directory")
        out["stored"] = {"root": os.path.join(tmp, "a"), "a": a["dir"],
                         "e": e["dir"], "a_valid": a["results"]["valid"]}
        for k, r in zip("abcde", (a, b, c, d, e)):
            if dev == "cuda" and k != "e" and r["sweeps"] <= 0:
                raise AssertionError(f"phase11{k}: the witness sweep kernel "
                                     f"never launched on the run's path")
            out[k] = {x: r[x] for x in r
                      if x not in ("dir", "results", "history")}
        out["c"]["verdict_lag_s"] = stream.get("verdict-lag-s")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase11: done in {out['wall_s']:.3f} s")
    return out


# ---------------------------------------------------------------------------
# The packed member lanes and the witness checkpoint (phase 12).

#: Phase 12c's one-shot history: 500k ops (half of phase 7b's 1M, so
#: that the script with phase 16 and phase 3's plain warm-ups stays
#: inside its time budget).
CKPT_OPS = 500_000
#: Phase 12a's word counts.
HASH_WORDS = (1, 2, 33)


def key_artifacts(run: dict, what: str) -> dict:
    """12d: the stored run's independent/<key>/ directories: one for
    every key that did not pass and for min(passing, 256) passing keys,
    each with results.json and history.txt."""
    root = os.path.join(run["dir"], "independent")
    dirs = set(os.listdir(root)) if os.path.isdir(root) else set()
    results = run["results"]["results"]
    failed = {str(k) for k, r in results.items() if r["valid"] is not True}
    ok_dirs = len(dirs - failed)
    complete = all(os.path.isfile(os.path.join(root, d, f))
                   for d in dirs for f in ("results.json", "history.txt"))
    r = {"keys": len(results), "failed": len(failed), "dirs": len(dirs),
         "passing_dirs": ok_dirs}
    log(f"phase12d: run 11{what}: " + json.dumps(r))
    if (not failed <= dirs or ok_dirs != min(len(results) - len(failed),
                                             256) or not complete):
        raise AssertionError(f"phase12d: run 11{what}'s key artifacts: {r}")
    return r


def packed_hash(torch, dev) -> dict:
    """12a: `packing.hash_words` on the card against the plain numpy
    uint32 multiply-add (the reference's formula), bit for bit."""
    import numpy as np

    from jepsen_tpu_torch.ops import packing

    rng = np.random.default_rng(BENCH_SEED)
    out = {}
    for wp in HASH_WORDS:
        words = (rng.integers(0, 1 << 32, size=(4096, wp), dtype=np.uint32)
                 | np.uint32(1 << 31))
        consts = packing.hash_consts(wp, 1)
        want = (words * consts).sum(axis=-1, dtype=np.uint32)
        got = packing.hash_words(torch.from_numpy(words.view(np.int32)).to(
            dev), consts).cpu().numpy()
        bad = int((got != want.astype(np.int64)).sum())
        out[wp] = {"rows": len(words), "mismatches": bad}
        if bad:
            raise AssertionError(f"phase12a: {bad} hashes differ at "
                                 f"{wp} words")
    log("phase12a: " + json.dumps(out))
    return out


def packed_modes(torch, dev, what: str, fn) -> dict:
    """fn() with JEPSEN_WGL_PACKED on and then off, each counted ->
    {"on": reading, "off": reading}."""
    out = {}
    try:
        for mode in ("on", "off"):
            set_env("JEPSEN_WGL_PACKED", "1" if mode == "on" else "0")
            t0 = time.perf_counter()
            res, launches, counts = counted(torch, dev, fn)
            out[mode] = {"res": res, "wall_s": time.perf_counter() - t0,
                         "sweeps": launches.get("witness_sweep", 0),
                         "chain_rounds": counts.get("heavy_rounds", 0),
                         "bfs_levels": counts.get("bfs_levels", 0),
                         "host_syncs": counts.get("host_syncs", 0)}
    finally:
        set_env("JEPSEN_WGL_PACKED", None)
    return out


def packed_parity(torch, dev, history, recorder) -> dict:
    """12b: phase 4's history, the bench history and phase 6's FIFO
    cohort with the packed lanes on and off."""
    from jepsen_tpu_torch.history.packed import pack_history
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops.wgl import check_wgl_device
    from jepsen_tpu_torch.ops.wgl_batched import check_wgl_batched
    from jepsen_tpu_torch.utils.histgen import random_register_history

    pm = cas_register().packed()
    out = {}
    for name, h in (("invalid", random_register_history(
            2000, procs=8, info_rate=0.0, seed=BENCH_SEED, bad=True)),
                    ("bench", history)):
        packed = pack_history(h, pm.encode)
        r = packed_modes(torch, dev, name, lambda: check_wgl_device(
            packed, pm, time_limit_s=300, device=dev))
        for m in r.values():
            res = m.pop("res")
            m.update(valid=res.valid, configs_explored=res.configs_explored)
        out[name] = r
        # The explored counts may differ: the two hashes order the
        # children an overflowing level keeps differently.
        keys = ("valid", "sweeps", "chain_rounds")
        if any(r["on"][k] != r["off"][k] for k in keys):
            raise AssertionError(f"phase12b: {name}: packed {r['on']} != "
                                 f"wide {r['off']}")
    want_valid = {"invalid": False, "bench": True}
    for name, v in want_valid.items():
        if out[name]["on"]["valid"] is not v:
            raise AssertionError(f"phase12b: {name} gave "
                                 f"{out[name]['on']['valid']}")
    if out["invalid"]["on"]["bfs_levels"] <= 0:
        raise AssertionError("phase12b: the invalid history ran no BFS")
    name = next(n for n in recorder.batched if "fifo" in n)
    packs, qpm, kw = recorder.batched[name]
    r = packed_modes(torch, dev, name, lambda: check_wgl_batched(
        packs, qpm, **kw))
    on, off = (r[m].pop("res").valid for m in ("on", "off"))
    # A key whose search overflowed max_beam is "unknown" (the exact
    # CPU settle decides it); which keys overflow depends on the
    # children the hashes keep.  A decided key never differs.
    clash = [i for i, (a, b) in enumerate(zip(on, off))
             if "unknown" not in (a, b) and a != b]
    for m, valid in (("on", on), ("off", off)):
        r[m].update(keys=len(packs), valid={str(v): valid.count(v)
                                            for v in set(valid)})
    r["decided_both"] = sum(1 for a, b in zip(on, off)
                            if "unknown" not in (a, b))
    if clash:
        raise AssertionError(f"phase12b: batched {name}: keys {clash} "
                             f"decided differently")
    # The whole check, settle included: equal per-key verdicts.
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.history.core import Op
    from jepsen_tpu_torch.history.core import history as make_history
    from jepsen_tpu_torch.parallel import IndependentChecker, \
        clear_settle_memo, kv

    _, make, gen, gkw = next(m for m in model_specs() if m[0] == name)
    h = keyed_history(gen, MODEL_KEYS, MODEL_OPS,
                      set(range(0, MODEL_KEYS, 7)), Op=Op, kv=kv,
                      history=make_history, long_key_ops=LONG_KEY_OPS.get(
                          name, LONG_KEY_OPS_DEFAULT), **gkw)

    def whole():
        clear_settle_memo()
        return IndependentChecker(Linearizable(
            make(), time_limit_s=120, device=dev), device=dev).check(
                {}, h, {})

    w = packed_modes(torch, dev, name, whole)
    verdicts = {m: {k: x["valid"] for k, x in w[m].pop("res")[
        "results"].items()} for m in ("on", "off")}
    if verdicts["on"] != verdicts["off"]:
        raise AssertionError(f"phase12b: {name} check: per-key verdicts "
                             f"differ with the packed lanes on and off")
    for m in ("on", "off"):
        w[m]["failures"] = sum(1 for v in verdicts[m].values()
                               if v is False)
    r["check"] = w
    out["batched"] = r
    log("phase12b: " + json.dumps(out))
    return out


def packed_resume(torch, dev, n_ops: int = CKPT_OPS) -> dict:
    """12c: an `n_ops` one-shot check: fresh, then with a budget that
    expires mid-search and a checkpoint directory, then resumed."""
    import glob
    import tempfile

    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops.wgl import check_wgl_device
    from jepsen_tpu_torch.ops.wgl_witness import plan_width
    from jepsen_tpu_torch.utils.histgen import random_register_packed

    pm = cas_register().packed()
    packed = random_register_packed(n_ops, procs=BENCH_PROCS,
                                    info_rate=BENCH_INFO, seed=BENCH_SEED,
                                    model=pm)
    width = plan_width(packed)
    out = {"ops": packed.n}
    with tempfile.TemporaryDirectory(prefix="phase12-") as d:
        def run(what, budget, ckpt):
            t0 = time.perf_counter()
            res, launches, counts = counted(torch, dev, lambda: (
                check_wgl_device(packed, pm, time_limit_s=budget,
                                 width_hint=width, checkpoint_dir=ckpt,
                                 device=dev)))
            need_launches(f"phase12c {what}", dev, launches)
            out[what] = {"valid": res.valid, "reason": res.reason,
                         "wall_s": time.perf_counter() - t0,
                         "sweeps": launches.get("witness_sweep", 0),
                         "chain_rounds": counts.get("heavy_rounds", 0),
                         "host_syncs": counts.get("host_syncs", 0),
                         "files": len(glob.glob(os.path.join(
                             d, "wgl-witness-*.ckpt.npz")))}

        run("fresh", None, None)
        run("expired", out["fresh"]["wall_s"] / 3, d)
        run("resumed", None, d)
    log("phase12c: " + json.dumps(out))
    f, e, r = out["fresh"], out["expired"], out["resumed"]
    # The work skipped: sweep launches on the card (chain rounds on the
    # CPU, where the sweep launches no kernel).
    work = "sweeps" if dev.type == "cuda" else "chain_rounds"
    if (f["valid"] is not True or e["valid"] != "unknown"
            or e["files"] != 1 or r["valid"] is not True
            or not 0 < r[work] < f[work] or r["files"] != 0):
        raise AssertionError(f"phase12c: {out}")
    return out


def phase_packing(torch, history, recorder, dev=None,
                  ckpt_ops: int = CKPT_OPS) -> dict:
    """Phase 12 (12a-12c; 12d runs inside phase 11).  `recorder` holds
    phase 6's batched cohorts."""
    dev = torch.device("cuda") if dev is None else torch.device(dev)
    t0 = time.perf_counter()
    out = {"hash": packed_hash(torch, dev),
           "parity": packed_parity(torch, dev, history, recorder),
           "resume": packed_resume(torch, dev, ckpt_ops)}
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase12: done in {out['wall_s']:.3f} s")
    return out


# ---------------------------------------------------------------------------
# The stock workloads (phase 13).

#: suites/logd.py's kafka settings (its one node: one worker).
KAFKA_ARGS = ["--key-count", "4", "--max-txn-length", "4",
              "--max-writes-per-key", "1024", "--final-polls", "16",
              "--seed", str(BENCH_SEED), "--node", "n1", "--concurrency",
              "1"]
#: 13a's and 13b's ops: a dependency graph of 600-1,000 vertices, under
#: the screen's 1,024.
KAFKA_OPS = 1000
KAFKA_VERTICES = (600, 1000)
#: 13d's ops: the size users run, past the screen's 1,024 vertices;
#: its time limit is far past the ~5 s the ops take, so the op count,
#: not the host's speed, ends the run.
KAFKA_BIG_OPS = 20_000
KAFKA_BIG_SECONDS = 60
#: 13c's G1c/G0 pairs: 400 vertices, past the 256 of the device
#: extraction.
KAFKA_CYCLE_PAIRS = 200
#: 13e: seconds per workload (5 until phase 17 needed the time);
#: rw-register's transactions, so that its graph stays under the
#: screen's 1,024 vertices.
WORKLOAD_SECONDS = 3
WR_TXNS = 800
#: 13e's workloads, with the CLI options past the common ones.
OTHER_WORKLOADS = {
    "bank": [], "long-fork": [], "set": [], "rw-register": [],
    "adya-g2": [], "causal": [], "causal-reverse": [],
    "total-queue": [],
}


def kafka_cycle_ops(pairs: int) -> list:
    """Op dicts of `pairs` copies of tests/test_kafka.py's
    test_wr_ww_cycle_detected, each on its own keys: T1 sends x and
    polls y, T2 sends x after it and sends the y T1 polled (ww T1 -> T2,
    wr T2 -> T1: a G1c); every third pair sends x and y in opposite
    orders instead (ww both ways: a G0)."""
    out = []
    for i in range(pairs):
        x, y = f"x{i}", f"y{i}"
        if i % 3 == 2:
            t1 = [["send", x, [0, "a"]], ["send", y, [1, "q"]]]
            t2 = [["send", y, [0, "p"]], ["send", x, [1, "b"]]]
        else:
            t1 = [["send", x, [0, "a"]], ["poll", {y: [[0, "p"]]}]]
            t2 = [["send", x, [1, "b"]], ["send", y, [0, "p"]]]
        out += [{"type": "ok", "f": "txn", "value": t1, "process": 0},
                {"type": "ok", "f": "txn", "value": t2, "process": 1}]
    return out


class GraphSpy:
    """Inside `with`, records the graphs ops/scc.check_cycles_device is
    given (the Kafka and Elle analyses look it up at call time) and the
    seconds each call takes."""

    def __enter__(self):
        from jepsen_tpu_torch.ops import scc

        self.scc, self.real = scc, scc.check_cycles_device
        self.graphs, self.seconds = [], []

        def spy(graphs, **kw):
            t0 = time.perf_counter()
            try:
                return self.real(graphs, **kw)
            finally:
                self.seconds.append(time.perf_counter() - t0)
                self.graphs.extend(graphs)

        scc.check_cycles_device = spy
        return self

    def __exit__(self, *exc):
        self.scc.check_cycles_device = self.real


def _cli_readings(torch, dev, call, store_dir: str, label: str) -> dict:
    """`call()`, a CLI entry point's run that stores under `store_dir`,
    with the counts set to 0 just before and read just after, the
    analysis timed apart, and the graphs the cycle screen was given ->
    the readings, with the stored run's results and history."""
    from jepsen_tpu_torch import store

    with GraphSpy() as spy, AnalysisClock(torch) as clock:
        t0 = time.perf_counter()
        code, launches, counts = counted(torch, dev, call)
        wall = time.perf_counter() - t0
    tf = store.load(store.latest(store_dir))
    try:
        results, h = tf.results, tf.history()
    finally:
        tf.close()
    g = spy.graphs[0] if spy.graphs else None
    r = {"exit": code, "valid": results.get("valid"),
         "anomaly_types": results.get("anomaly-types"),
         "ops": sum(1 for o in h if o.type == "invoke"), "wall_s": wall,
         "run_s": wall - sum(clock.seconds), "analyze_s": sum(clock.seconds),
         "forensics_s": sum(clock.forensics),
         "vertices": len(g.vertices) if g is not None else None,
         "edges": g.n_edges() if g is not None else None,
         "cycle_search_s": sum(spy.seconds),
         "sweeps": launches.get("witness_sweep", 0),
         "screens": counts.get("scc_screens", 0),
         "extractions": counts.get("scc_extractions", 0),
         "route": None if g is None else (
             "device screen" if counts.get("scc_screens", 0) else "host")}
    log(f"{label}: " + json.dumps(r))
    r.update(results=results, history=h, graph=g)
    return r


def _workload_cli(torch, dev, argv, suite, what: str) -> dict:
    """`cli.run` of `argv` over `suite` (phase 13) -> `_cli_readings`."""
    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch.workloads import _extra_opts

    parser = cli.single_test_cmd(suite, extra_opts=_extra_opts)
    return _cli_readings(torch, dev, lambda: cli.run(parser, argv),
                         argv[argv.index("--store-dir") + 1],
                         f"phase13{what}")


def _screen_ms(torch, dev, g) -> float:
    """CUDA-event milliseconds of one closure screen (B7) of `g`."""
    from jepsen_tpu_torch.ops import scc

    adj = torch.from_numpy(scc.pack_adjacency([g])[0]).to(dev)
    return cuda_ms(lambda: scc.has_cycle(adj, torch.bfloat16), reps=20)


def _extract_ms(torch, dev, g) -> float:
    """CUDA-event milliseconds of one batched extraction (B8) of `g`'s
    layers."""
    from jepsen_tpu_torch.ops import scc

    layers = scc.layer_entries(g)
    a_all, a_req, _ = scc.pack_required([x[0] for x in layers],
                                        [x[1] for x in layers])
    A, R = (torch.from_numpy(x).to(dev) for x in (a_all, a_req))
    return cuda_ms(lambda: scc.extract_batch(A, R, torch.bfloat16), reps=5)


def phase_workloads(torch, dev=None, kafka_ops: int = KAFKA_OPS,
                    big_ops: int = KAFKA_BIG_OPS,
                    seconds: float = WORKLOAD_SECONDS) -> dict:
    """Phase 13: the stock workloads through the port's CLI on `dev`
    (the card by default).  (13a) kafka at suites/logd.py's settings,
    `kafka_ops` ops: EXIT_VALID, a graph of 600-1,000 vertices screened
    on the card (B7); (13b) the same with lose-acked and duplicate
    faults at rate 0.02: EXIT_INVALID with lost-write and duplicate, and
    the stored history's analysis on the CPU equal to the run's; (13c)
    a fixture of G1c and G0 pairs (400 vertices), rw edges off and on:
    the cycles extracted on the card (B8), the anomaly types of the
    host search of the same graph; (13d) kafka at `big_ops` ops: past
    1,024 vertices, so the host search, as in the JAX package; (13e)
    bank, long-fork, set, rw-register, adya-g2, causal, causal-reverse
    and total-queue for `seconds` each (rw-register at WR_TXNS
    transactions, screened on the card): EXIT_VALID; adya-g2 with its
    racy client: EXIT_INVALID; the cycle checker on `dev` over
    rw-register's history (realtime and process analyzers: valid) and
    13c's rw graph (cyclic), screened there and equal to the host
    search."""
    import tempfile
    import threading

    from jepsen_tpu_torch import cli, store
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch.checker.elle.graph import check_cycles
    from jepsen_tpu_torch.history.core import Op, history
    from jepsen_tpu_torch.workloads import adya, cycle, kafka, test_fn

    dev = torch.device("cuda") if dev is None else torch.device(dev)
    cuda = dev.type == "cuda"
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
           if cuda else "cpu")
    out: dict = {"card": smi}
    t_phase = time.perf_counter()

    def limited(n: int):
        def suite(opts):
            t = test_fn(opts)
            return {**t, "generator": gen.limit(n, t["generator"])}
        return suite

    with tempfile.TemporaryDirectory(prefix="phase13-") as tmp:
        def argv(name, sub, *more, limit=seconds):
            return ["test", "--workload", name, "--dummy-ssh", "--device",
                    str(dev.type), "--time-limit", str(limit), *more,
                    "--store-dir", os.path.join(tmp, sub)]

        a = _workload_cli(torch, dev, argv("kafka", "a", *KAFKA_ARGS),
                          limited(kafka_ops), "a")
        lo, hi = KAFKA_VERTICES
        if (a["exit"] != cli.EXIT_VALID or not lo <= a["vertices"] <= hi
                or a["route"] != "device screen"):
            raise AssertionError(f"phase13a: exit {a['exit']}, "
                                 f"{a['vertices']} vertices, route "
                                 f"{a['route']}")
        need_launches("phase13a", dev, {"scc_screens": a["screens"]},
                      "scc_screens")
        if cuda:
            a["screen_ms"] = _screen_ms(torch, dev, a["graph"])

        b = _workload_cli(
            torch, dev, argv("kafka", "b", *KAFKA_ARGS, "--faults",
                             "lose-acked,duplicate", "--fault-rate", "0.02"),
            limited(kafka_ops), "b")
        ran = dict(b["results"])
        ran.pop("resilience", None)
        again = json.loads(store.format._encode(kafka.analyze(
            kafka.revive_polls(b["history"]).client_ops(), device="cpu")))
        if (b["exit"] != cli.EXIT_INVALID
                or not {"lost-write", "duplicate"} <= set(b["anomaly_types"])
                or again != ran):
            raise AssertionError(f"phase13b: exit {b['exit']}, types "
                                 f"{b['anomaly_types']}, the CPU analysis "
                                 f"equal: {again == ran}")

        h = history([Op(**d) for d in kafka_cycle_ops(KAFKA_CYCLE_PAIRS)])
        c = {}
        for rw in (False, True):
            with GraphSpy() as spy:
                t0 = time.perf_counter()
                res, _, counts = counted(torch, dev, lambda: kafka.analyze(
                    h, rw_edges=rw, device=dev))
                wall = time.perf_counter() - t0
            g = spy.graphs[0]
            host = sorted({x["type"] for x in check_cycles(g)})
            r = {"rw_edges": rw, "vertices": len(g.vertices),
                 "edges": g.n_edges(), "analyze_s": wall,
                 "anomaly_types": res["anomaly-types"], "host_types": host,
                 "screens": counts.get("scc_screens", 0),
                 "extractions": counts.get("scc_extractions", 0),
                 "bfs_levels": counts.get("scc_bfs_levels", 0)}
            if res["valid"] is not False or res["anomaly-types"] != host:
                raise AssertionError(f"phase13c: {r}")
            need_launches("phase13c", dev,
                          {"scc_extractions": r["extractions"]},
                          "scc_extractions")
            if cuda:
                r["screen_ms"] = _screen_ms(torch, dev, g)
                r["extract_ms"] = _extract_ms(torch, dev, g)
            log("phase13c: " + json.dumps(r))
            c["rw" if rw else "plain"] = r

        d = _workload_cli(torch, dev, argv("kafka", "d", *KAFKA_ARGS,
                                           limit=KAFKA_BIG_SECONDS),
                          limited(big_ops), "d")
        if d["vertices"] is None or d["vertices"] <= 1024 \
                or d["route"] != "host" or d["screens"]:
            raise AssertionError(f"phase13d: {d['vertices']} vertices, "
                                 f"route {d['route']}")

        e = {}
        for name, more in OTHER_WORKLOADS.items():
            suite = limited(WR_TXNS) if name == "rw-register" else test_fn
            r = _workload_cli(torch, dev, argv(name, f"e-{name}",
                                               "--concurrency", "10", *more),
                              suite, f"e {name}")
            if r["exit"] != cli.EXIT_VALID:
                raise AssertionError(f"phase13e {name}: exit {r['exit']}: "
                                     f"{str(r['results'])[:400]}")
            if name == "rw-register":
                need_launches("phase13e rw-register", dev,
                              {"scc_screens": r["screens"]}, "scc_screens")
            e[name] = r

        def racy(opts):
            t = test_fn(opts)
            t["client"] = adya.InMemoryG2Client(
                racy=True, barrier=threading.Barrier(2))
            return {**t, "generator": gen.limit(40, t["generator"])}

        r = _workload_cli(torch, dev, argv("adya-g2", "e-racy",
                                           "--concurrency", "2"),
                          racy, "e adya-g2 racy")
        if r["exit"] != cli.EXIT_INVALID:
            raise AssertionError(f"phase13e racy adya: exit {r['exit']}")
        e["adya-g2 racy"] = r

        # The generic cycle checker asked for the card (its default is
        # "off", the host search, as in the JAX package): rw-register's
        # history through the realtime and process analyzers, screened
        # on the card, and 13c's rw graph, extracted there; each held
        # against the host search of the same graph.
        cyc = {}
        for what, analyzers, hist in (
                ("realtime+process", (cycle.realtime_graph,
                                      cycle.process_graph),
                 e["rw-register"]["history"]),
                ("13c graph", (lambda _h, g=g: g,), h)):
            res, _, counts = counted(torch, dev, lambda: cycle.checker(
                *analyzers, device=dev).check({}, hist, {}))
            host = cycle.checker(*analyzers).check({}, hist, {})
            r = {"vertices": res["vertices"], "edges": res["edges"],
                 "valid": res["valid"], "anomaly_types": res["anomaly-types"],
                 "host_types": host["anomaly-types"],
                 "screens": counts.get("scc_screens", 0),
                 "extractions": counts.get("scc_extractions", 0)}
            if (res["valid"] != host["valid"]
                    or r["anomaly_types"] != r["host_types"]
                    or res["valid"] is not (what == "realtime+process")):
                raise AssertionError(f"phase13e cycle {what}: {r}")
            need_launches(f"phase13e cycle {what}", dev,
                          {"scc_screens": r["screens"]}, "scc_screens")
            log(f"phase13e cycle {what}: " + json.dumps(r))
            cyc[what] = r
        keep = ("exit", "valid", "anomaly_types", "ops", "run_s",
                "analyze_s", "vertices", "edges", "route", "screens",
                "extractions", "cycle_search_s", "screen_ms")
        for k, r in (("a", a), ("b", b), ("d", d)):
            out[k] = {x: r[x] for x in keep if x in r}
        out["b"]["cpu_equal"] = True
        out["c"] = c
        out["e"] = {k: {x: r[x] for x in keep if x in r}
                    for k, r in e.items()}
        out["e"]["cycle"] = cyc
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase13: done in {out['wall_s']:.3f} s")
    return out


# ---------------------------------------------------------------------------
# The demo suites against their real C++ servers (phase 14).

#: Seconds of each phase-14 run (the reference's suite tests' settings,
#: tests/test_{kvdb,logd,txnd,repkv,electd}_suite.py, cut to this; 5-6
#: s before phase 20 took its place).  Every run's first fault falls
#: inside it (nemesis intervals 1.0-1.5 s).
SUITE_SECONDS = 3
#: 14b's op limit: its Kafka graph stays under the screen's 1,024
#: vertices (1,000 ops made 795 in phase 13a).
SUITE_KAFKA_OPS = 1000
#: The replicated suites' nodes (their tests' three).
SUITE_NODES = ["--node", "n1", "--node", "n2", "--node", "n3"]
#: Result keys that are wall-clock readings, which no two analyses
#: share.
TIMINGS = ("elapsed-s",)


def untimed(x):
    """A stored result with its wall-clock readings dropped."""
    if isinstance(x, dict):
        return {k: untimed(v) for k, v in x.items() if k not in TIMINGS}
    if isinstance(x, list):
        return [untimed(v) for v in x]
    return x


def host_privilege() -> dict:
    """The control process's uid and whether `sudo -n true` works: the
    suites' `grepkill` runs under `sudo` (control/util.py), and without
    a working sudo it kills nothing, so a leaked server then lives on
    (phase 14's sweep catches it)."""
    import shutil

    sudo = shutil.which("sudo")
    ok = sudo is not None and subprocess.run(
        [sudo, "-n", "true"], capture_output=True).returncode == 0
    return {"uid": os.getuid(), "sudo": sudo, "sudo_n": ok}


def _servers(tmp: str) -> list:
    """Processes whose command line names `tmp`: the servers a phase-14
    run started from its store directory (their binaries and data live
    there)."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if tmp in cmd:
            out.append(f"{pid}: {cmd.strip()}")
    return out


def _kill_servers(tmp: str) -> list:
    """SIGKILLs every process `_servers(tmp)` names -> their lines."""
    import signal

    left = _servers(tmp)
    for line in left:
        try:
            os.kill(int(line.split(":", 1)[0]), signal.SIGKILL)
        except ProcessLookupError:
            pass
    return left


def phase_suites(torch, dev=None) -> dict:
    """Phase 14: the five demo suites through the port's suite CLIs
    (`main` of jepsen_tpu_torch.suites.*) with `--device` `dev` (the
    card by default), each against its C++ server compiled with g++
    from the checkout and run as daemons on this machine (LocalRemote).
    (14a) kvdb register, `--algorithm wgl-tpu`, kill faults: EXIT_VALID,
    a kill in the history, the witness sweep (B1) launched, and `cli
    analyze --device cpu --algorithm cpu` of the stored run the same
    verdict; (14b) logd kafka, no faults, SUITE_KAFKA_OPS ops at rate
    150: EXIT_VALID, the graph screened on the card (B7); (14c) logd
    kafka with kill faults and a 400 ms write-behind at rate 200: the
    verdict and anomaly types those of `cli analyze --device cpu` of
    the stored run (the conviction printed, not gated); (14d) txnd wr
    under snapshot isolation, then `--serializable`: serializable
    EXIT_VALID and screened on the card (B7); SI's elle-wr result that
    of the stored run's CPU analysis, G2 / G-single printed when
    convicted; (14e) repkv safe reads under partitions: EXIT_VALID, B1
    launched; (14f) electd `--quorum` under partitions at rate 40: the
    linearizability verdict valid, a partition in the history; electd
    unsafe under partitions: the verdict that of the stored run's CPU
    re-analysis (`--device cpu --algorithm cpu`).  Each run takes its
    own store directory (and so its own ports), and no server may
    outlive its run's teardown: the phase raises if one does, and
    SIGKILLs every server it started on any way out.  Raises when g++
    is missing."""
    import shutil
    import tempfile

    from jepsen_tpu_torch import cli, store
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch.suites import electd, kvdb, logd, repkv, txnd

    if shutil.which("g++") is None:
        raise RuntimeError("phase14: no g++: the suites compile their "
                           "servers with it")
    dev = torch.device("cuda") if dev is None else torch.device(dev)
    smi = _smi(dev)
    out: dict = {"card": smi, "host": host_privilege()}
    log("phase14: host " + json.dumps(out["host"]))
    t_phase = time.perf_counter()
    keep = ("exit", "valid", "anomaly_types", "ops", "run_s", "analyze_s",
            "forensics_s", "vertices", "route", "sweeps", "screens",
            "extractions")

    tmp = tempfile.mkdtemp(prefix="phase14-")
    try:
        def run(mod, what, *args, main=None):
            """`mod.main(["test", ...])` (or `main`) on its own store
            directory -> the readings, with the linearizability
            checker's algorithm as the route of a register run and no
            server of the run left."""
            store_dir = os.path.join(tmp, what)
            argv = ["test", "--device", dev.type, "--time-limit",
                    str(SUITE_SECONDS), *args, "--store-dir", store_dir]
            r = _cli_readings(torch, dev, lambda: (main or mod.main)(argv),
                              store_dir, f"phase14{what}")
            left = _servers(store_dir)
            if left:
                raise AssertionError(f"phase14{what}: servers outlived the "
                                     f"run's teardown: {left}")
            lin = r["results"].get("linear")
            if r["route"] is None and isinstance(lin, dict):
                r["route"] = lin.get("algorithm")
            r["dir"] = store.latest(store_dir)
            r["store_dir"] = store_dir
            return r

        def reanalyze(mod, r, *args) -> dict:
            """`mod.main(["analyze", "--device", "cpu", ...])` of r's
            stored run -> its exit code and the results it stored."""
            code = mod.main(["analyze", "--device", "cpu", *args,
                             "--store-dir", r["store_dir"], r["dir"]])
            tf = store.load(r["dir"])
            try:
                res = json.loads(store.format._encode(tf.results))
            finally:
                tf.close()
            return {"exit": code, "results": untimed(res)}

        def stored(r) -> dict:
            return untimed(json.loads(store.format._encode(r["results"])))

        a = run(kvdb, "a", "--algorithm", "wgl-tpu", "--interval", "1.5",
                "--concurrency", "4", "--seed", "11")
        kills = sum(1 for o in a["history"]
                    if o.process == "nemesis" and o.f == "kill")
        cpu = reanalyze(kvdb, a, "--algorithm", "cpu")
        a["kills"], a["cpu_valid"] = kills, cpu["results"]["valid"]
        if (a["exit"] != cli.EXIT_VALID or not kills
                or cpu["exit"] != a["exit"] or a["cpu_valid"] != a["valid"]):
            raise AssertionError(f"phase14a: exit {a['exit']}, {kills} "
                                 f"kills, CPU re-analysis {cpu['exit']} "
                                 f"{a['cpu_valid']}")
        need_launches("phase14a", dev, {"witness_sweep": a["sweeps"]})

        def quiet_kafka(opts):
            t = cli.localize_test(logd.logd_test({**opts, "faults": []}))
            return {**t, "generator": gen.limit(SUITE_KAFKA_OPS,
                                                t["generator"])}

        parser = cli.single_test_cmd(quiet_kafka, name="logd",
                                     extra_opts=logd._extra_opts)
        b = run(logd, "b", "--rate", "150", "--seed", "11",
                main=lambda argv: cli.run(parser, argv))
        if (b["exit"] != cli.EXIT_VALID or b["route"] != "device screen"
                or b["vertices"] > 1024):
            raise AssertionError(f"phase14b: exit {b['exit']}, "
                                 f"{b['vertices']} vertices, route "
                                 f"{b['route']}")
        need_launches("phase14b", dev, {"scc_screens": b["screens"]},
                      "scc_screens")

        c = run(logd, "c", "--faults", "kill", "--flush-ms", "400",
                "--rate", "200", "--interval", "1.2", "--concurrency", "6",
                "--seed", "1")
        cpu = reanalyze(logd, c, "--flush-ms", "400")
        ran = stored(c)
        c["cpu_equal"] = (cpu["results"]["valid"] == ran["valid"]
                          and cpu["results"].get("anomaly-types")
                          == ran.get("anomaly-types"))
        c["kills"] = sum(1 for o in c["history"]
                         if o.process == "nemesis" and o.f == "kill")
        if not c["cpu_equal"] or cpu["exit"] != c["exit"]:
            raise AssertionError(f"phase14c: the card's verdict "
                                 f"{ran['valid']} {ran.get('anomaly-types')}"
                                 f", the CPU analysis "
                                 f"{cpu['results']['valid']} "
                                 f"{cpu['results'].get('anomaly-types')}")
        log(f"phase14c: {c['kills']} kills; convicted: "
            f"{c['valid'] is False}, anomaly types {c['anomaly_types']}")

        txnd_args = ("--concurrency", "8", "--rate", "150", "--key-count",
                     "4", "--seed", "0")
        d_si = run(txnd, "d-si", *txnd_args)
        cpu = reanalyze(txnd, d_si)
        elle = stored(d_si)["elle-wr"]
        d_si["cpu_equal"] = cpu["results"]["elle-wr"] == elle
        d_si["elle_types"] = elle.get("anomaly-types")
        if not d_si["cpu_equal"]:
            raise AssertionError(f"phase14d SI: elle-wr {elle}, the CPU "
                                 f"analysis {cpu['results']['elle-wr']}")
        if elle["valid"] is False:
            log(f"phase14d SI: convicted, {d_si['elle_types']} (G2 / "
                f"G-single: "
                f"{sorted(set(d_si['elle_types']) & {'G2', 'G2-item', 'G-single'})})")
        d_ser = run(txnd, "d-ser", *txnd_args, "--serializable")
        if d_ser["exit"] != cli.EXIT_VALID or d_ser["route"] != "device screen":
            raise AssertionError(f"phase14d serializable: exit "
                                 f"{d_ser['exit']}, route {d_ser['route']}: "
                                 f"{str(d_ser['results'])[:400]}")
        need_launches("phase14d serializable", dev,
                      {"scc_screens": d_ser["screens"]}, "scc_screens")

        e = run(repkv, "e", *SUITE_NODES, "--safe-reads", "--faults",
                "partition", "--concurrency", "6", "--rate", "120",
                "--interval", "1.5")
        if e["exit"] != cli.EXIT_VALID:
            raise AssertionError(f"phase14e: exit {e['exit']}: "
                                 f"{str(e['results'])[:400]}")
        need_launches("phase14e", dev, {"witness_sweep": e["sweeps"]})

        f_q = run(electd, "f-quorum", *SUITE_NODES, "--quorum", "--faults",
                  "partition", "--concurrency", "6", "--rate", "40",
                  "--interval", "1.0")
        f_q["partitions"] = sum(1 for o in f_q["history"]
                                if o.process == "nemesis"
                                and o.f == "start-partition")
        f_q["linear_valid"] = f_q["results"]["linear"]["valid"]
        if f_q["linear_valid"] is not True or not f_q["partitions"]:
            raise AssertionError(f"phase14f quorum: linear "
                                 f"{f_q['results']['linear']}, "
                                 f"{f_q['partitions']} partitions")
        f_u = run(electd, "f-unsafe", *SUITE_NODES, "--faults", "partition",
                  "--concurrency", "6", "--rate", "120", "--interval", "1.0",
                  "--seed", "0")
        cpu = reanalyze(electd, f_u, "--algorithm", "cpu")
        f_u["linear_valid"] = f_u["results"]["linear"]["valid"]
        f_u["cpu_linear_valid"] = cpu["results"]["linear"]["valid"]
        if (f_u["cpu_linear_valid"] != f_u["linear_valid"]
                or cpu["results"]["valid"] != f_u["valid"]):
            raise AssertionError(f"phase14f unsafe: linear "
                                 f"{f_u['linear_valid']}, the CPU "
                                 f"re-analysis {f_u['cpu_linear_valid']}")
        for k, r, more in (("a", a, ("kills", "cpu_valid")),
                           ("b", b, ()), ("c", c, ("kills", "cpu_equal")),
                           ("d_si", d_si, ("cpu_equal", "elle_types")),
                           ("d_serializable", d_ser, ()), ("e", e, ()),
                           ("f_quorum", f_q, ("partitions", "linear_valid")),
                           ("f_unsafe", f_u, ("linear_valid",
                                              "cpu_linear_valid"))):
            out[k] = {x: r[x] for x in keep + more}
    finally:
        left = _kill_servers(tmp)
        shutil.rmtree(tmp, ignore_errors=True)
    if left:
        raise AssertionError(f"phase14: servers left running: {left}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase14: done in {out['wall_s']:.3f} s")
    return out


# ---------------------------------------------------------------------------
# Anomaly forensics and the fault-schedule search (phase 15).

#: 15a: the planted-bug search (the JAX package's
#: tools/nemesis_search_smoke.py): three in-memory nodes, the two
#: families whose composition is the bug, its seed and shrink budget.
SEARCH_NODES = ["n1", "n2", "n3"]
SEARCH_FAMILIES = ("partition", "kill")
SEARCH_SEED = 3
SEARCH_BUDGET_S = 35.0
SEARCH_SHRINK = 8
#: 15b: phase 11b's shape has 30 bad keys; forensics documents
#: MAX_DOSSIERS (16) of them and counts the rest as skipped.
FORENSICS_FILES = ("counterexample.json", "death.json", "linear.svg",
                   "timeline.html")
#: 15c: `repkv search` against the real servers: its two seed runs
#: (partition, kill), one evolved run less than before phase 17.
SEARCH_REPKV_ITERATIONS = 2
SEARCH_REPKV_SHRINK = 2


def amnesia_cluster(dev: str):
    """The planted multi-fault bug of the JAX package's search smoke
    (tools/nemesis_search_smoke.py, with tools/fault_matrix.py's
    `_AtomRegister`, `_MortalRegister` and `_KillableDB`), on the port:
    a register that loses its acknowledged writes only when a process
    kill lands while a partition is open.  Returns the factory of a
    fresh test map per iteration: the amnesia DB, the recording net,
    three dummy nodes, `node-loss-policy` tolerate:1, and a composed
    checker of stats, lost-write and `linearizable(cas_register(),
    "wgl-tpu")` on `dev`, so every iteration checks its register
    history where the run does.

    Three changes to the smoke's fixture.  The cas-register model takes
    a read of None as an unknown return (it constrains nothing), so the
    amnesia rolls the register back to 0, a value the client's first op
    writes, where the smoke's rolls it back to None: linearizability
    then sees the lost writes.  Once stale, the register acknowledges
    writes and keeps none, where the smoke's refuses them: every
    forgetting run then loses a write acknowledged after the wipe, so
    whether it convicts does not hang on a write acknowledged before
    it, which made the smoke's replays race the client threads.  And
    the bug fires whenever the two faults' windows overlap: a
    partition opened while a node is down forgets too, where the
    smoke's needs the kill to come second.  Three client processes, as
    in the smoke."""
    import itertools
    import threading

    from jepsen_tpu_torch import checker as chk
    from jepsen_tpu_torch import client as jc
    from jepsen_tpu_torch import db as jdb
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch import net as jnet
    from jepsen_tpu_torch.history import FAIL, OK
    from jepsen_tpu_torch.models import cas_register

    class AtomRegister(jc.Client):
        """In-memory linearizable register (shared-state client)."""

        def __init__(self, state=None, lock=None):
            self.state = state if state is not None else {"v": None}
            self.lock = lock or threading.Lock()

        def open(self, test, node):
            return AtomRegister(self.state, self.lock)

        def invoke(self, test, op):
            with self.lock:
                if op.f == "write":
                    self.state["v"] = op.value
                    return op.complete(OK)
                if op.f == "read":
                    return op.complete(OK, value=self.state["v"])
                old, new = op.value
                if self.state["v"] == old:
                    self.state["v"] = new
                    return op.complete(OK)
                return op.complete(FAIL)

    class MortalRegister(AtomRegister):
        """A register whose node can die: once `dead[node]` is set,
        opens are refused and in-flight invokes drop the connection."""

        def __init__(self, state=None, lock=None, dead=None, node=None):
            super().__init__(state, lock)
            self.dead = dead if dead is not None else {}
            self.node = node

        def open(self, test, node):
            if self.dead.get(node):
                raise ConnectionRefusedError(f"{node} is dead")
            return MortalRegister(self.state, self.lock, self.dead, node)

        def invoke(self, test, op):
            if self.dead.get(self.node):
                raise ConnectionResetError(f"{self.node} died mid-op")
            return super().invoke(test, op)

    class AmnesiaRegister(MortalRegister):
        """Writes carry strictly increasing values and the register
        refuses any write at or below its value; once the amnesia wipe
        hit it acknowledges every write and keeps none, so the lost
        state stays lost."""

        def open(self, test, node):
            if self.dead.get(node):
                raise ConnectionRefusedError(f"{node} is dead")
            return AmnesiaRegister(self.state, self.lock, self.dead, node)

        def invoke(self, test, op):
            if op.f == "write":
                if self.dead.get(self.node):
                    raise ConnectionResetError(f"{self.node} died mid-op")
                with self.lock:
                    v = self.state["v"]
                    if self.state.get("stale"):
                        return op.complete(OK)
                    if v is not None and op.value <= v:
                        return op.complete(FAIL)
                    self.state["v"] = op.value
                    return op.complete(OK)
            return super().invoke(test, op)

    class KillableDB:
        """kill/start (and pause/resume) toggle the `dead` map the
        register reads."""

        def __init__(self, dead):
            self._base = jdb.NoopDB()
            self.dead = dead

        def __getattr__(self, name):
            return getattr(self._base, name)

        def kill(self, test, sess, node):
            self.dead[node] = True

        def start(self, test, sess, node):
            self.dead[node] = False

        def pause(self, test, sess, node):
            self.dead[node] = True

        def resume(self, test, sess, node):
            self.dead[node] = False

    class AmnesiaDB(KillableDB):
        """The planted bug: a kill inside an open partition, or a
        partition opened while a node is down, rolls the register back
        to its first write and leaves the store stale."""

        def __init__(self, dead, cut, state):
            super().__init__(dead)
            self.cut = cut
            self.state = state

        def forget(self):
            self.state["v"] = 0
            self.state["stale"] = True

        def kill(self, test, sess, node):
            if self.cut.get("active"):
                self.forget()
            super().kill(test, sess, node)

    class RecordingNet(jnet.IptablesNet):
        """The iptables net (its commands no-ops on dummy remotes) that
        keeps the partition-open flag the amnesia DB reads, and opens a
        partition on a down node into the amnesia."""

        def __init__(self, cut, db):
            super().__init__()
            self.cut = cut
            self.db = db

        def drop_all(self, test, grudge):
            self.cut["active"] = True
            if any(self.db.dead.values()):
                self.db.forget()
            super().drop_all(test, grudge)

        def heal(self, test):
            self.cut["active"] = False
            super().heal(test)

    class LostWriteChecker(chk.Checker):
        """A read below the highest write acknowledged before it began
        is a lost acknowledged write (writes only increase)."""

        def check(self, test, history, opts):
            acked_max, floor, lost = None, {}, []
            for i, op in enumerate(history):
                if not op.is_client_op:
                    continue
                if op.f == "write":
                    if op.type == "ok" and (acked_max is None
                                            or op.value > acked_max):
                        acked_max = op.value
                elif op.f == "read":
                    if op.is_invoke:
                        floor[op.process] = acked_max
                    else:
                        fl = floor.pop(op.process, None)
                        if (op.type == "ok" and fl is not None
                                and (op.value is None or op.value < fl)):
                            lost.append(i)
            if lost:
                return {"valid": False, "anomaly-types": ["lost-write"],
                        "lost-reads": lost[:8], "count": len(lost)}
            return {"valid": True, "count": 0}

    def make() -> dict:
        state, lock, dead = {"v": None}, threading.Lock(), {}
        cut = {"active": False}
        counter = itertools.count(1)
        db = AmnesiaDB(dead, cut, state)
        return {
            "name": "search-smoke",
            "nodes": list(SEARCH_NODES),
            "concurrency": 3,
            "ssh": {"dummy?": True},
            "device": dev,
            "net": RecordingNet(cut, db),
            "db": db,
            "client": AmnesiaRegister(state, lock, dead=dead),
            "generator": gen.stagger(0.02, [
                {"f": "write", "value": 0},
                gen.mix([
                    gen.FnGen(lambda: {"f": "read"}),
                    gen.FnGen(lambda: {"f": "write",
                                       "value": next(counter)}),
                ])]),
            "checker": chk.compose({
                "stats": chk.Stats(),
                "lost-write": LostWriteChecker(),
                "linear": chk.linearizable(cas_register(), "wgl-tpu",
                                           device=dev),
            }),
            "node-loss-policy": "tolerate:1",
        }

    return make


def _stable(sig) -> frozenset:
    """A coverage signature without the timing-bucketed `c:` counters
    (the JAX smoke's `_stable`) and without the dossiers' `x:`
    fingerprints: what a replay reproduces exactly.  The smoke's
    checker has no linearizability and so no dossier; here each
    convicting run's dossier fingerprints the counterexample its
    shrink ends on, and with three clients that can hang on how their
    ops interleaved in that run."""
    return frozenset(f for f in sig if not f.startswith(("c:", "x:")))


def _dossier_features(sig) -> frozenset:
    """The `x:` features `_stable` leaves out (15a counts the replays
    whose set changed)."""
    return frozenset(f for f in sig if f.startswith("x:"))


def _exact_linear(history):
    """The exact CPU engine's linearizability verdict on a cas-register
    history (checker/wgl_cpu.py or wgl_event.py)."""
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.models import cas_register

    return Linearizable(cas_register(), "cpu", time_limit_s=120,
                        device="cpu").check({}, history, {})["valid"]


def _refuted_from_json(path: str) -> bool:
    """True when the exact CPU engine refutes the ops of a dossier's
    counterexample.json, read back from the file alone."""
    from jepsen_tpu_torch.history import History, Op

    with open(path) as f:
        ce = json.load(f)
    h = History([Op.from_dict(o) for o in ce["ops"]], reindex=False)
    return _exact_linear(h) is False


def _stored_runs(root: str) -> list:
    """The run directories (<name>/<timestamp>) under a search's runs/."""
    out = []
    for name in sorted(os.listdir(root)):
        if os.path.islink(os.path.join(root, name)):
            continue  # "current", the store's link to the latest run
        for ts in sorted(os.listdir(os.path.join(root, name))):
            d = os.path.join(root, name, ts)
            if ts != "latest" and os.path.isdir(d) and not os.path.islink(d):
                out.append(d)
    return out


def search_planted(torch, dev, tmp: str) -> dict:
    """15a: `run_search` over the amnesia cluster, every iteration
    checked on `dev` (see `phase_search`)."""
    from jepsen_tpu_torch import store, telemetry
    from jepsen_tpu_torch.nemesis import search

    search_dir = os.path.join(tmp, "a")
    runner = search.CoreRunner(amnesia_cluster(dev.type), search_dir,
                               {"iteration-deadline": 30.0})
    was = telemetry.enabled()
    telemetry.enable(True)
    try:
        with AnalysisClock(torch) as clock:
            t0 = time.perf_counter()
            out, launches, _ = counted(torch, dev, lambda: search.run_search(
                runner, search_dir=search_dir, n_nodes=len(SEARCH_NODES),
                budget_s=SEARCH_BUDGET_S, seed=SEARCH_SEED,
                families=SEARCH_FAMILIES, min_nodes=2,
                shrink_attempts=SEARCH_SHRINK))
            search_s = time.perf_counter() - t0
            hist = out["history"]
            seed_round = hist[:len(SEARCH_FAMILIES)]
            covs = [h["coverage"] for h in seed_round]
            if (len(hist) < len(SEARCH_FAMILIES)
                    or any(h["new_features"] <= 0 for h in seed_round)
                    or covs != sorted(set(covs))):
                raise AssertionError(f"phase15a: coverage did not grow over "
                                     f"the seed round: {seed_round}")
            cells = [c for c in out["cells"] if c["reason"] == "anomaly"]
            if not cells:
                raise AssertionError(f"phase15a: no anomaly reproducer in "
                                     f"{len(hist)} iterations; cells "
                                     f"{[c['name'] for c in out['cells']]}")
            cell = search.Schedule.from_json(cells[0]["schedule"])
            if not {"kill", "partition"} <= cell.families or len(
                    cell.events) > 3:
                raise AssertionError(f"phase15a: reproducer "
                                     f"{cells[0]['schedule']}")
            corpus = search.Corpus(os.path.join(search_dir, "corpus"))
            if not corpus.entries:
                raise AssertionError("phase15a: the corpus is empty")
            t0 = time.perf_counter()
            x_changed = 0
            for entry in corpus.entries:
                got = search.replay(entry, runner)
                want = _stable(frozenset(entry["signature"]))
                sig = _stable(search.signature(got))
                x_changed += _dossier_features(search.signature(got)) != (
                    _dossier_features(entry["signature"]))
                if sig != want or search.reasons(got) != list(
                        entry["interesting"]):
                    raise AssertionError(
                        f"phase15a: corpus {entry['id']} replay diverged: "
                        f"missing {sorted(want - sig)}, extra "
                        f"{sorted(sig - want)}")
            replay_s = time.perf_counter() - t0
    finally:
        telemetry.enable(was)
    if search.heal_crashed_iterations(search_dir) != {}:
        raise AssertionError("phase15a: outstanding ledger entries left")
    checked = convicted = dossiers = 0
    for d in _stored_runs(os.path.join(search_dir, "runs")):
        tf = store.load(d)
        try:
            res, h = tf.results, tf.history()
        finally:
            tf.close()
        if not isinstance(res, dict) or "linear" not in res:
            continue
        checked += 1
        exact = _exact_linear(h)
        if res["linear"]["valid"] != exact:
            raise AssertionError(f"phase15a: {d}: the run's linear verdict "
                                 f"{res['linear']['valid']}, the exact CPU "
                                 f"engine's {exact}")
        if exact is False:
            convicted += 1
            fs = (res.get("forensics") or {}).get("dossiers") or []
            cx = [os.path.join(x["dir"], "counterexample.json") for x in fs]
            if not cx or not all(map(_refuted_from_json, cx)):
                raise AssertionError(f"phase15a: {d}: convicted without a "
                                     f"refuted counterexample: {fs}")
            dossiers += len(cx)
    need_launches("phase15a", dev, launches)
    r = {"iterations": out["stats"]["iterations"],
         "coverage": out["coverage"], "corpus": out["corpus"],
         "cells": [c["name"] for c in out["cells"]],
         "reproducer_events": len(cell.events),
         "replayed": len(corpus.entries), "x_changed": x_changed,
         "checked": checked,
         "convicted": convicted, "dossiers": dossiers,
         "sweeps": launches.get("witness_sweep", 0),
         "search_s": search_s, "replay_s": replay_s,
         "forensics_s": sum(clock.forensics)}
    log("phase15a: " + json.dumps(r))
    return r


def forensics_of_a_run(torch, dev, tmp: str, smi: str) -> dict:
    """15b: phase 11b's shape (200 keys, stale reads on keys 0-29)
    checked on `dev`, its dossiers read back (see `phase_search`)."""
    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch.parallel import clear_settle_memo
    from jepsen_tpu_torch.workloads import _extra_opts, test_fn

    def stale(opts):
        return {**test_fn(opts), "client": stale_read_client()}

    argv = ["--workload", "linearizable-register", "--dummy-ssh",
            "--key-count", str(RUN_KEYS_SMALL), "--per-key-limit",
            str(RUN_PER_KEY), "--threads-per-key", str(RUN_THREADS_PER_KEY),
            "--concurrency", str(RUN_CONCURRENCY), "--time-limit",
            str(RUN_TIME_LIMIT), "--seed", str(BENCH_SEED), "--store-dir",
            os.path.join(tmp, "b")]
    b = _run_cli(torch, ["test", "--device", dev.type, *argv], stale, "b",
                 smi, phase="15")
    fz = b["results"].get("forensics") or {}
    ds = fz.get("dossiers") or []
    if (b["exit"] != cli.EXIT_INVALID or fz.get("anomaly-count")
            != RUN_STALE_KEYS or len(ds) != 16 or fz.get("skipped")
            != RUN_STALE_KEYS - 16):
        raise AssertionError(f"phase15b: exit {b['exit']}, forensics "
                             f"{ {k: v for k, v in fz.items() if k != 'dossiers'} }"
                             f", {len(ds)} dossiers")
    before = {}
    for x in ds:
        missing = [f for f in FORENSICS_FILES
                   if not os.path.isfile(os.path.join(x["dir"], f))]
        if missing or not x["op-count"] < x["original-op-count"]:
            raise AssertionError(f"phase15b: dossier {x['key']}: missing "
                                 f"{missing}, {x.get('op-count')} of "
                                 f"{x.get('original-op-count')} ops")
        path = os.path.join(x["dir"], "counterexample.json")
        if not _refuted_from_json(path):
            raise AssertionError(f"phase15b: dossier {x['key']}: its "
                                 f"counterexample is not refuted")
        with open(path, "rb") as f:
            before[path] = f.read()
    # As a fresh `analyze` process would: the run's settle memo would
    # hand every key its group's verdict without the positional
    # certificates (final-configs) the dossier's signature reads.
    clear_settle_memo()
    parser = cli.single_test_cmd(stale, extra_opts=_extra_opts)
    with AnalysisClock(torch) as clock:
        code = cli.run(parser, ["analyze", "--device", "cpu", *argv,
                                b["dir"]])
    same = 0
    for path, data in before.items():
        with open(path, "rb") as f:
            same += f.read() == data
    if code != cli.EXIT_INVALID or same != len(before):
        raise AssertionError(f"phase15b: `analyze --device cpu` exit "
                             f"{code}, {same} of {len(before)} "
                             f"counterexample.json files byte-identical")
    r = {"exit": b["exit"], "anomalies": fz["anomaly-count"],
         "dossiers": len(ds), "skipped": fz["skipped"],
         "op_counts": [[x["op-count"], x["original-op-count"]] for x in ds],
         "analyze_s": b["analyze_s"], "forensics_s": b["forensics_s"],
         "sweeps": b["sweeps"], "cpu_analyze_s": sum(clock.seconds),
         "cpu_forensics_s": sum(clock.forensics), "identical": same}
    log("phase15b: " + json.dumps(r))
    return r


def search_repkv(torch, dev, tmp: str) -> dict:
    """15c: `repkv search` through the suite's CLI against the real
    servers (see `phase_search`)."""
    from jepsen_tpu_torch import cli, store
    from jepsen_tpu_torch.suites import repkv

    store_dir = os.path.join(tmp, "c")
    argv = ["search", "--device", dev.type, *SUITE_NODES,
            "--search-families", "partition,kill", "--max-iterations",
            str(SEARCH_REPKV_ITERATIONS), "--shrink-attempts",
            str(SEARCH_REPKV_SHRINK), "--budget", "120", "--seed", "1",
            "--store-dir", store_dir]
    with AnalysisClock(torch) as clock:
        t0 = time.perf_counter()
        code, launches, _ = counted(torch, dev, lambda: repkv.main(argv))
        wall = time.perf_counter() - t0
    left = _servers(store_dir)
    if left:
        raise AssertionError(f"phase15c: servers outlived the search: "
                             f"{left}")
    sdir = os.path.join(store_dir, "repkv-register-search")
    state_path = os.path.join(sdir, "search.json")
    if code != cli.EXIT_VALID or not os.path.isfile(state_path):
        raise AssertionError(f"phase15c: exit {code}, search.json "
                             f"{os.path.isfile(state_path)}")
    with open(state_path) as f:
        state = json.load(f)
    verdicts = []
    for d in _stored_runs(os.path.join(sdir, "runs")):
        tf = store.load(d)
        try:
            ran = tf.results
        finally:
            tf.close()
        if not isinstance(ran, dict):
            continue
        cpu = repkv.main(["analyze", "--device", "cpu", *SUITE_NODES,
                          "--store-dir", store_dir, d])
        tf = store.load(d)
        try:
            again = tf.results
        finally:
            tf.close()
        verdicts.append([os.path.relpath(d, sdir), ran["valid"],
                         again["valid"]])
        if (again["valid"] != ran["valid"]
                or again["linear"]["valid"] != ran["linear"]["valid"]
                or cpu != cli.validity_exit(ran)):
            raise AssertionError(f"phase15c: {d}: the card's verdict "
                                 f"{ran['valid']}, the CPU re-analysis "
                                 f"{again['valid']} (exit {cpu})")
    if not verdicts:
        raise AssertionError("phase15c: no iteration stored a verdict")
    r = {"exit": code, "iterations": len(state["iterations"]),
         "coverage": state["coverage"], "cells": len(state["cells"]),
         "verdicts": verdicts, "sweeps": launches.get("witness_sweep", 0),
         "wall_s": wall, "forensics_s": sum(clock.forensics)}
    log("phase15c: " + json.dumps(r))
    return r


def phase_search(torch, dev=None) -> dict:
    """Phase 15: anomaly forensics and `jepsen search` with the checks
    on `dev` (the card by default).  (15a) the planted-bug search of
    the JAX package's search smoke on the port: `run_search` (seed 3,
    families partition and kill, shrink_attempts 8, a
    `SEARCH_BUDGET_S` budget) over a register that loses acknowledged writes only when a
    kill lands inside a partition, each iteration's composed checker
    holding `linearizable(cas_register(), "wgl-tpu")` on the card:
    coverage grows over the seed round; the anomaly is found and shrunk
    to at most three events composing kill and partition; every corpus
    entry replays with its stable features and reasons; nothing is
    left for `jepsen repair`; every iteration's linearizability verdict
    is the exact CPU engine's on its stored history; the witness sweep
    (B1) launched; every convicting iteration carries a dossier whose
    counterexample.json the exact CPU engine refutes from the file.
    (15b) phase 11b's shape: 30 anomalies, 16 dossiers (MAX_DOSSIERS),
    14 skipped, each with counterexample.json, death.json, linear.svg
    and timeline.html, each minimal history shorter than its key's and
    refuted from its JSON; `cli analyze --device cpu` of the stored run
    rewrites byte-identical counterexample.json files.  (15c) `repkv
    search` (partition and kill, three nodes) against the real servers:
    exit 0, the search dir written, each iteration's verdict that of
    its stored history's CPU re-analysis, no server left (every server
    the phase started is killed on any way out)."""
    import shutil
    import tempfile

    dev = torch.device("cuda") if dev is None else torch.device(dev)
    smi = _smi(dev)
    out: dict = {"card": smi}
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase15-")
    try:
        out["a"] = search_planted(torch, dev, tmp)
        out["b"] = forensics_of_a_run(torch, dev, tmp, smi)
        if shutil.which("g++") is None:
            raise RuntimeError("phase15c: no g++: repkv compiles its "
                               "servers with it")
        out["c"] = search_repkv(torch, dev, tmp)
    finally:
        left = _kill_servers(tmp)
        shutil.rmtree(tmp, ignore_errors=True)
    if left:
        raise AssertionError(f"phase15: servers left running: {left}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase15: done in {out['wall_s']:.3f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 16: Jepsen against real nodes over SSH, and the federated checker.
# ---------------------------------------------------------------------------

#: 16a: tests/test_ssh_localhost.py's loopback nodes and kvdb settings
#: (its 6 s run cut to 4 to pay for phase 20; the first kill falls at
#: the 2 s interval).
SSH_NODES = 3
SSH_SECONDS, SSH_RATE, SSH_INTERVAL, SSH_CONCURRENCY = 4.0, 50.0, 2.0, 4
#: 16a's scp round trip: this many random bytes.
SSH_SCP_BYTES = 1 << 20
#: 16c: each daemon's batch window, long enough to SIGKILL the daemon
#: holding a ticket inside it; the seeds of 16c's histories.
FED_WINDOW_S = 2.0
FED_SEEDS = (16_000, 17_000)
FED_RESTART_SEED, FED_STREAM_SEED = 18_000, 19_000
FED_WAIT_S = 300.0
#: 16d: tools/chaos_smoke.py's schedule, its 16 s load window cut to 10
#: (the schedule's events fall at fixed fractions of it) to pay for
#: phase 17's time.
CHAOS_SECONDS, CHAOS_BOUND_S = 10.0, 30.0


def _smi(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


class SshCluster:
    """SSH_NODES loopback nodes, each a port minissh server (hostname
    n<i>, its own root directory under `tmp`), one ed25519 key, and the
    port's `ssh`/`scp` shims first on PATH while entered (the card's
    host has no OpenSSH client)."""

    def __init__(self, tmp: str):
        self.tmp = tmp

    def __enter__(self):
        from jepsen_tpu_torch.control import minissh

        os.makedirs(self.tmp, exist_ok=True)
        self.key, blob = minissh.generate_keypair(self.tmp)
        self.servers = []
        for i in range(SSH_NODES):
            root = os.path.join(self.tmp, f"n{i + 1}")
            os.makedirs(root, exist_ok=True)
            self.servers.append(minissh.MiniSshServer(
                authorized_keys=[blob], hostname=f"n{i + 1}",
                root_dir=root).start())
        self.nodes = [f"127.0.0.1:{s.port}" for s in self.servers]
        self.old_path = os.environ["PATH"]
        os.environ["PATH"] = minissh.BIN_DIR + os.pathsep + self.old_path
        return self

    def __exit__(self, *exc):
        os.environ["PATH"] = self.old_path
        for s in self.servers:
            s.stop()

    def ssh_map(self) -> dict:
        """The test keys that reach the nodes: SshCliRemote as root with
        the cluster's key."""
        from jepsen_tpu_torch.control import SshCliRemote

        return {"remote": SshCliRemote(),
                "ssh": {"username": "root", "private-key-path": self.key}}


def ssh_roundtrip(cluster: SshCluster, tmp: str) -> dict:
    """An exec of random bytes (base64 through `cat`) and an scp upload
    and download of SSH_SCP_BYTES random bytes through SshCliRemote and
    the port's shims, each checksum equal -> the seconds of each."""
    import base64
    import hashlib

    from jepsen_tpu_torch.control import with_sessions

    blob = random.Random(16).randbytes(SSH_SCP_BYTES)
    text = base64.b64encode(blob[:4096]).decode()
    src = os.path.join(tmp, "scp-up.bin")
    back = os.path.join(tmp, "scp-back.bin")
    with open(src, "wb") as f:
        f.write(blob)
    test = {"nodes": cluster.nodes, **cluster.ssh_map()}
    out = {}
    with with_sessions(test) as t:
        sess = t["sessions"][test["nodes"][0]]
        t0 = time.perf_counter()
        echoed = sess.exec("cat", stdin=text)
        out["exec_s"] = time.perf_counter() - t0
        if echoed != text or sess.exec("hostname") != "n1":
            raise AssertionError("phase16a: the exec round trip changed "
                                 "its bytes")
        remote = os.path.join(cluster.tmp, "n1", "phase16a-scp.bin")
        t0 = time.perf_counter()
        sess.upload(src, remote)
        out["upload_s"] = time.perf_counter() - t0
        far = sess.exec("sha256sum", remote).split()[0]
        t0 = time.perf_counter()
        sess.download(remote, back)
        out["download_s"] = time.perf_counter() - t0
    with open(back, "rb") as f:
        got = hashlib.sha256(f.read()).hexdigest()
    want = hashlib.sha256(blob).hexdigest()
    if not far == got == want:
        raise AssertionError(f"phase16a: scp checksums differ: sent {want}, "
                             f"on the node {far}, back {got}")
    out["scp_bytes"] = len(blob)
    return out


def _linear_per_key(results: dict) -> dict:
    """{key: valid} of a stored run's linearizability result (one key,
    None, for a single register)."""
    lin = results.get("linear") or results
    if isinstance(lin.get("results"), dict):
        return {str(k): r.get("valid") for k, r in lin["results"].items()}
    return {None: lin.get("valid")}


def ssh_suite(torch, dev, tmp: str) -> dict:
    """(16a) tests/test_ssh_localhost.py's kvdb run on the port: three
    loopback port minissh nodes, SshCliRemote through the port's shims,
    the kvdb C++ server compiled on the node through SSH, register
    workload, kill faults, SSH_SECONDS at SSH_RATE, interval
    SSH_INTERVAL, concurrency SSH_CONCURRENCY, `core.run` on `dev` with
    the witness path (`wgl-tpu`, as phase 14a).  Before it, an exec and
    an scp round trip.  Gates: the verdict the reference test accepts
    (valid or unknown) with the nemesis in the history, the stored run's
    `cli analyze --device cpu` the same per-key verdicts, and on the
    card the witness sweep (B1) launched.  Prints the SSH seconds
    (the DB's build and start, the run, the teardown) and the analyze
    seconds."""
    from jepsen_tpu_torch import core, store
    from jepsen_tpu_torch.nemesis.selfchaos import _free_port
    from jepsen_tpu_torch.parallel import clear_settle_memo
    from jepsen_tpu_torch.suites import kvdb

    out: dict = {}
    with SshCluster(os.path.join(tmp, "nodes")) as cluster:
        out["roundtrip"] = ssh_roundtrip(cluster, tmp)
        store_dir = os.path.join(tmp, "store")
        test = kvdb.kvdb_test({
            "workload": "register", "faults": ["kill"],
            "time-limit": SSH_SECONDS, "rate": SSH_RATE,
            "interval": SSH_INTERVAL, "store-dir": store_dir,
            "nodes": cluster.nodes[:1], "concurrency": SSH_CONCURRENCY,
            "algorithm": "wgl-tpu", "device": dev.type})
        test.update(cluster.ssh_map())
        test.update({
            "nodes": cluster.nodes[:1], "store-dir": store_dir, "kvdb-local": False,
            "kvdb-port": _free_port(), "device": dev.type})
        spent = {"setup": 0.0, "teardown": 0.0}
        db = test["db"]
        for name in spent:
            def timed(*a, _f=getattr(db, name), _n=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _f(*a, **kw)
                finally:
                    spent[_n] += time.perf_counter() - t0
            setattr(db, name, timed)
        clear_settle_memo()
        with AnalysisClock(torch) as clock:
            t0 = time.perf_counter()
            done, launches, _ = counted(torch, dev, lambda: core.run(test))
            wall = time.perf_counter() - t0
    res, h = done["results"], done["history"]
    kills = sum(1 for o in h if o.process == "nemesis")
    if res.get("valid") not in (True, "unknown") or not kills:
        raise AssertionError(f"phase16a: valid {res.get('valid')}, "
                             f"{kills} nemesis ops")
    need_launches("phase16a", dev, launches)
    d = store.latest(store_dir)
    code = kvdb.main(["analyze", "--device", "cpu", "--store-dir", store_dir,
                      d])
    tf = store.load(d)
    try:
        cpu = json.loads(store.format._encode(tf.results))
    finally:
        tf.close()
    ours = _linear_per_key(json.loads(store.format._encode(res)))
    if _linear_per_key(cpu) != ours or code not in (0, 2):
        raise AssertionError(f"phase16a: the CPU re-analysis (exit {code}) "
                             f"differs: {_linear_per_key(cpu)} vs {ours}")
    analyze_s = sum(clock.seconds)
    out.update({
        "valid": res.get("valid"), "ops": len(h) // 2,
        "nemesis_ops": kills, "keys": len(ours),
        "sweeps": launches.get("witness_sweep", 0),
        "ssh_s": {"build_and_start": spent["setup"],
                  "run": wall - spent["setup"] - spent["teardown"]
                  - analyze_s,
                  "teardown": spent["teardown"]},
        "analyze_s": analyze_s, "wall_s": wall, "cpu_exit": code})
    log("phase16a: " + json.dumps(out))
    return out


def _suite_netns(torch, dev, cluster, tmp: str, **opts) -> dict:
    """tests/test_netns_cluster.py's run_suite_netns for repkv on the
    port: the namespace cluster's transport and RouteNet, nodes on their
    in-cluster addresses, the witness path, on `dev`."""
    from jepsen_tpu_torch import core
    from jepsen_tpu_torch.suites import repkv

    o = {"nodes": cluster.nodes, "store-dir": os.path.join(tmp, "store"),
         "time-limit": 10.0, "rate": 120.0, "interval": 1.0,
         "algorithm": "wgl-tpu", "device": dev.type}
    o.update(opts)
    test = repkv.repkv_test(o)
    test.update(cluster.test_overlay())
    test.update({"repkv-local": False, "concurrency": 6,
                 "store-dir": o["store-dir"], "device": dev.type})
    done, launches, _ = counted(torch, dev, lambda: core.run(test))
    done["launches"] = launches
    return done


def netns_partition(torch, dev, tmp: str) -> dict:
    """(16b) Where `netns_available()` holds: the reference's repkv
    kernel partition (blackhole routes inside the namespaces cut
    replication, a backup serves stale reads) convicted on `dev` within
    three attempts, and its safe-reads control valid, each verdict that
    of the stored run's CPU re-analysis.  Elsewhere it says why not (the
    reference's own skip condition)."""
    import shutil

    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.control.netns import NetnsCluster, netns_available
    from jepsen_tpu_torch.suites import repkv

    if shutil.which("ip") is None:
        why = "no `ip` binary (iproute2) on this host"
    elif not netns_available():
        why = ("`ip netns add` or a veth pair was refused (needs root or "
               "CAP_NET_ADMIN)")
    else:
        why = None
    if why is not None:
        out = {"available": False, "why": why}
        print(json.dumps({"netns": out}), flush=True)
        return out

    def cpu_linear(done) -> object:
        sd = done["store-dir"]
        d = store.latest(sd)
        repkv.main(["analyze", "--device", "cpu", "--node", "n1", "--node",
                    "n2", "--node", "n3", "--store-dir", sd, d])
        tf = store.load(d)
        try:
            return tf.results["linear"]["valid"]
        finally:
            tf.close()

    out: dict = {"available": True, "attempts": []}
    convicted = None
    for attempt in range(3):
        c = NetnsCluster(n_nodes=3, tag="jtp%05d" % (time.time_ns() % 90000))
        with c:
            done = _suite_netns(torch, dev, c, os.path.join(tmp, f"a{attempt}"),
                                **{"safe-reads": False,
                                   "faults": ["partition"], "sync": False,
                                   "seed": attempt})
        parts = [o for o in done["history"] if o.process == "nemesis"
                 and o.f == "start-partition" and o.type == "info"]
        valid = done["results"]["linear"]["valid"]
        out["attempts"].append({"valid": valid, "partitions": len(parts),
                                "algorithm": done["results"]["linear"].get(
                                    "algorithm"),
                                "sweeps": done["launches"].get(
                                    "witness_sweep", 0)})
        if not parts:
            raise AssertionError("phase16b: the nemesis never partitioned")
        if valid is False:
            convicted = done
            break
    if convicted is None:
        raise AssertionError(f"phase16b: three kernel-partitioned runs never "
                             f"convicted: {out['attempts']}")
    if cpu_linear(convicted) is not False:
        raise AssertionError("phase16b: the CPU re-analysis did not convict")
    # A stale read the host's refutation screen convicts never reaches
    # the device search (as phase 14f's unsafe electd run); any other
    # conviction went through B1.
    if out["attempts"][-1]["algorithm"] != "refute-screen":
        need_launches("phase16b convicted", dev, convicted["launches"])
    c = NetnsCluster(n_nodes=3, tag="jtc%05d" % (time.time_ns() % 90000))
    with c:
        ctl = _suite_netns(torch, dev, c, os.path.join(tmp, "control"),
                           **{"safe-reads": True, "faults": ["partition"],
                              "sync": True})
    if ctl["results"]["linear"]["valid"] is not True or \
            cpu_linear(ctl) is not True:
        raise AssertionError(f"phase16b: the safe-reads control is not "
                             f"valid: {ctl['results']['linear']}")
    need_launches("phase16b control", dev, ctl["launches"])
    out["control"] = {"valid": True, "sweeps": ctl["launches"].get(
        "witness_sweep", 0)}
    log("phase16b: " + json.dumps(out))
    return out


class _Child:
    """One `jepsen` subcommand process (`python -m
    jepsen_tpu_torch.suites.kvdb <argv>`) listening on `port`, started,
    awaited and stopped by the chaos fleet's helpers, its output in
    `<tmp>/<name>.log`."""

    def __init__(self, name: str, argv: list, port: int, tmp: str):
        self.name, self.argv, self.port = name, argv, port
        self.log = os.path.join(tmp, f"{name}.log")
        self.proc = None

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    def spawn(self) -> "_Child":
        from jepsen_tpu_torch.nemesis.selfchaos import spawn_child

        here = os.path.dirname(os.path.abspath(__file__))
        self.proc = spawn_child(
            [sys.executable, "-m", "jepsen_tpu_torch.suites.kvdb",
             *self.argv], dict(os.environ, PYTHONPATH=here), self.log)
        return self

    def ready(self) -> "_Child":
        """Waits until it listens; raises if it exits first."""
        from jepsen_tpu_torch.nemesis.selfchaos import _wait_listening

        _wait_listening(self.addr, timeout_s=120.0, proc=self.proc,
                        log_path=self.log)
        return self

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def kill(self) -> None:
        self.proc.kill()
        self.proc.wait(timeout=30)

    def stop(self) -> None:
        from jepsen_tpu_torch.nemesis.selfchaos import stop_children

        if self.alive():
            stop_children([self.proc], timeout_s=30.0)


def _valid_algorithm(res: dict) -> dict:
    """{key: (valid, algorithm)} of a many-key result."""
    return {k: v[:2] for k, v in _key_view(res).items()}


def _ticket_view(keys: list, payload: dict) -> dict:
    """`_valid_algorithm` of a daemon's RESULT payload for `keys`."""
    return {str(k): (kr.get("valid"), kr.get("algorithm"))
            for k, kr in zip(keys, payload["key-results"])}


def _daemon_launches(addr: str) -> int:
    from jepsen_tpu_torch.checkerd.client import fetch_stats

    return int(fetch_stats(addr, timeout=10.0).get("launches", {}).get(
        "witness_sweep", 0))


def federation(torch, dev, tmp: str) -> dict:
    """(16c) Two `jepsen checkerd --device <dev>` processes (a `--queue`
    journal and a FED_WINDOW_S batch window each) behind one `jepsen
    checkerd-router` (with its own journal and /metrics).  Two
    concurrent runs of phase 10a's shape go through the router with the
    in-process fallback off; the daemon holding their tickets is
    SIGKILLed inside its batch window: every per-key valid and
    algorithm equals the in-process check on `dev`, the router counts a
    failover, its /metrics shows its gauges, and the surviving daemon
    launched B1.  Then a ticket submitted straight to a daemon, which is
    SIGKILLed with it journaled and unfinished and restarted on the same
    journal and port: the ticket polls to the in-process verdicts, and
    the restarted daemon launched B1.  Then a run streamed through the
    router by a RemoteFeed whose connection is severed while a daemon
    is SIGKILLed: the feed resumes and resends only the tail, and the
    verdicts are the in-process ones.  Every child is stopped on the
    way out, and one that died unasked fails the phase."""
    import socket
    import threading
    import urllib.request

    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.checkerd.client import (CheckerdClient,
                                                  RemoteChecker, fetch_stats)
    from jepsen_tpu_torch.checkerd.protocol import model_to_spec
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.nemesis.selfchaos import _free_port
    from jepsen_tpu_torch.parallel import (IndependentChecker,
                                           clear_settle_memo, subhistories)
    from jepsen_tpu_torch.streaming.remote import RemoteFeed

    def checker():
        return IndependentChecker(Linearizable(cas_register(), time_limit_s=120,
                                               device=dev), device=dev)

    def in_process(h) -> dict:
        clear_settle_memo()
        return _valid_algorithm(checker().check({}, h, {}))

    if dev.type == "cuda":
        # Built once here before any daemon starts, as the chaos fleet
        # does: the children load the library instead of compiling it.
        from jepsen_tpu_torch.ops import kernels

        kernels.sweep_lib()
    runs = {f"fo{i}": mixed_history(MIXED_KEYS, MIXED_BAD, seed0=s)
            for i, s in enumerate(FED_SEEDS)}
    want = {run: in_process(h) for run, h in runs.items()}
    restart_h = mixed_history(MIXED_KEYS, MIXED_BAD, seed0=FED_RESTART_SEED)
    stream_h = mixed_history(MIXED_KEYS, MIXED_BAD, seed0=FED_STREAM_SEED)
    restart_want = in_process(restart_h)
    stream_want = in_process(stream_h)

    def daemon(i: int) -> _Child:
        port = _free_port()
        return _Child(f"d{i}", [
            "checkerd", "--device", dev.type, "--host", "127.0.0.1",
            "--port", str(port), "--batch-window", str(FED_WINDOW_S),
            "--queue", os.path.join(tmp, f"d{i}.queue")], port, tmp)

    ds = [daemon(0).spawn(), daemon(1).spawn()]
    rport, mport = _free_port(), _free_port()
    rt = _Child("router", [
        "checkerd-router", "--host", "127.0.0.1", "--port", str(rport),
        "--probe-interval", "0.2", "--metrics-port", str(mport),
        "--queue", os.path.join(tmp, "router.queue"),
        "--daemon", ds[0].addr, "--daemon", ds[1].addr], rport, tmp).spawn()
    children = ds + [rt]
    out: dict = {}
    t_start = time.perf_counter()
    try:
        for c in children:
            c.ready()
        out["start_s"] = time.perf_counter() - t_start

        # Failover: two concurrent runs, the holding daemon killed.
        got, errors = {}, []

        def submit(run):
            try:
                t0 = time.perf_counter()
                res = RemoteChecker(checker(), rt.addr, run_id=run,
                                    fallback=False).check(
                    {"name": run}, runs[run], {})
                got[run] = (res, time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"{run}: {e!r}")

        threads = [threading.Thread(target=submit, args=(run,))
                   for run in runs]
        for th in threads:
            th.start()
        t0 = time.monotonic()
        while True:
            st = fetch_stats(rt.addr, timeout=10.0)
            if st["inflight"] >= len(runs) and st["affinity"]:
                break
            if time.monotonic() - t0 > FED_WAIT_S or errors:
                raise AssertionError(f"phase16c: the router never placed "
                                     f"both runs: {errors or st}")
            time.sleep(0.05)
        victim_addr = next(iter(st["affinity"].values()))
        victim = next(c for c in ds if c.addr == victim_addr)
        survivor = next(c for c in ds if c is not victim)
        held = fetch_stats(victim.addr, timeout=10.0)["queue-depth"]
        t_kill = time.perf_counter()
        victim.kill()
        for th in threads:
            th.join(FED_WAIT_S)
        if errors or len(got) != len(runs):
            raise AssertionError(f"phase16c: {errors or sorted(got)}")
        for run, (res, _) in got.items():
            if "fallback" in res["checkerd"]:
                raise AssertionError(f"phase16c {run}: fell back in-process")
            diff = {k: (v, want[run][k])
                    for k, v in _valid_algorithm(res).items()
                    if v != want[run][k]}
            if diff or len(want[run]) != len(res["results"]):
                raise AssertionError(
                    f"phase16c {run}: per-key results differ from "
                    f"in-process: {dict(list(diff.items())[:6])}")
        st = fetch_stats(rt.addr, timeout=10.0)
        if st["failovers"] < 1:
            raise AssertionError(f"phase16c: no failover counted: {st}")
        body = urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics",
                                      timeout=10).read().decode()
        gauges = ("jepsen_router_daemons", "jepsen_router_daemons_healthy",
                  "jepsen_router_failovers", "jepsen_router_inflight",
                  "jepsen_router_results")
        missing = [g for g in gauges if g not in body]
        if missing:
            raise AssertionError(f"phase16c: /metrics lacks {missing}")
        survived = _daemon_launches(survivor.addr)
        need_launches("phase16c failover", dev,
                      {"witness_sweep": survived})
        out["failover"] = {
            "runs": {run: {"verdict_s": wall,
                           "queue_wait_s": res["checkerd"].get(
                               "queue-wait-s"),
                           "check_s": res["checkerd"].get("check-s")}
                     for run, (res, wall) in sorted(got.items())},
            "after_kill_s": time.perf_counter() - t_kill,
            "queued_at_kill": held,
            "failovers": st["failovers"], "submits": st["submits"],
            "survivor_sweeps": survived}
        log("phase16c failover: " + json.dumps(out["failover"]))

        # The daemon journal: a ticket killed inside its window.
        victim.spawn()  # back on its journal, in the background
        subs = subhistories(restart_h)
        keys = list(subs)
        lin = Linearizable(cas_register(), time_limit_s=120, device=dev)
        with CheckerdClient(survivor.addr, io_timeout=FED_WAIT_S) as c:
            ticket = c.submit_ops("restart", model_to_spec(cas_register()),
                                  [[o.to_dict() for o in subs[k]]
                                   for k in keys],
                                  algorithm=lin.algorithm,
                                  time_limit_s=lin.time_limit_s)
            # Killed while the submitting connection is open: closing it
            # first lets the daemon abandon the still-queued ticket
            # (abandon-on-disconnect, journaled), which leaves nothing
            # to replay.
            t_kill = time.perf_counter()
            survivor.kill()
        survivor.spawn().ready()
        victim.ready()
        with CheckerdClient(survivor.addr, io_timeout=FED_WAIT_S) as c:
            payload = c.wait(ticket, deadline_s=FED_WAIT_S)
        if _ticket_view(keys, payload) != restart_want:
            raise AssertionError("phase16c: the replayed ticket's verdicts "
                                 "differ from in-process")
        replayed = fetch_stats(survivor.addr, timeout=10.0)["replayed"]
        restarted = _daemon_launches(survivor.addr)
        need_launches("phase16c restart", dev, {"witness_sweep": restarted})
        out["restart"] = {"verdict_s": time.perf_counter() - t_kill,
                          "replayed": replayed, "sweeps": restarted}
        log("phase16c restart: " + json.dumps(out["restart"]))

        # A streamed run: the feed's connection severed and a daemon
        # killed mid-stream; it resumes and resends only the tail.  The
        # router first readmits the restarted daemon.
        t0 = time.monotonic()
        while fetch_stats(rt.addr, timeout=10.0)["health"].get(
                survivor.addr, {}).get("state") == "quarantined":
            if time.monotonic() - t0 > 60:
                raise AssertionError("phase16c: the router never readmitted "
                                     "the restarted daemon")
            time.sleep(0.1)
        subs = subhistories(stream_h)
        keys = list(subs)
        feed = RemoteFeed(rt.addr, run="stream",
                          model_spec=model_to_spec(cas_register()),
                          algorithm=lin.algorithm, budget_s=None,
                          time_limit_s=lin.time_limit_s)
        feed._stop.set()
        feed._wake.set()
        feed._thread.join(timeout=10)
        total = sum(len(subs[k]) for k in keys)
        for k in keys:
            for op in subs[k][:len(subs[k]) // 2]:
                feed.put(k, op)
        feed._flush()
        before = _daemon_launches(survivor.addr)
        time.sleep(0.3)  # the router takes in the head, as in the test
        feed._client.sock.shutdown(socket.SHUT_RDWR)
        victim.kill()
        for k in keys:
            for op in subs[k][len(subs[k]) // 2:]:
                feed.put(k, op)
        t0 = time.perf_counter()
        feed.commit(keys)
        if feed.dead or feed.resumes != 1 or not 0 < feed.ops_resent < total:
            raise AssertionError(f"phase16c stream: {feed.stats()}")
        with CheckerdClient(rt.addr, io_timeout=FED_WAIT_S) as c:
            payload = c.wait(feed.ticket, deadline_s=FED_WAIT_S)
        if _ticket_view(keys, payload) != stream_want:
            raise AssertionError("phase16c: the streamed run's verdicts "
                                 "differ from in-process")
        streamed = _daemon_launches(survivor.addr) - before
        need_launches("phase16c stream", dev, {"witness_sweep": streamed})
        out["stream"] = {"verdict_s": time.perf_counter() - t0,
                         "ops": total, "ops_sent": feed.ops_sent,
                         "ops_resent": feed.ops_resent,
                         "resumes": feed.resumes, "sweeps": streamed}
        log("phase16c stream: " + json.dumps(out["stream"]))
        dead = [c.name for c in (survivor, rt) if not c.alive()]
        if dead:
            raise AssertionError(f"phase16c: {dead} died unasked")
    finally:
        for c in children:
            c.stop()
    return out


def self_chaos(torch, dev, tmp: str, fleet=None) -> dict:
    """(16d) tools/chaos_smoke.py's schedule on the port, against a
    router and two daemons checking on `dev` (the fleet resolves it here
    and passes it to every child): three tenants, one a whale, for
    CHAOS_SECONDS; daemon 0 SIGKILLed at 30%, its journal torn while it
    is down, restarted at 40%; an impossible deadline shed.  Gates:
    every acked ticket polls to a verdict, at least one honest shed with
    a positive retry-after, the replayed verdict digests byte-identical,
    the light tenant's queue-wait p95 within CHAOS_BOUND_S, the
    checkerd.overload.* gauges on the restarted daemon's /metrics, no
    child dead unasked, and on the card B1 launched in the daemons.
    A `fleet` the caller gives (two daemons, metrics on, not started) is
    started here and left running for the caller to stop: `main` hands
    it on to phase 17c."""
    import threading
    import urllib.request

    from jepsen_tpu_torch.checkerd.client import (CheckerdClient,
                                                  RemoteUnavailable,
                                                  ShedByServer)
    from jepsen_tpu_torch.nemesis import selfchaos as sc

    whale, alpha, beta = "whale", "alpha", "beta"
    t_start = time.perf_counter()
    own = fleet is None
    if own:
        fleet = sc.ChaosFleet(2, os.path.join(tmp, "chaos"), metrics=True,
                              device=dev.type)
    history = sc.ChaosHistory()
    stop = threading.Event()
    out: dict = {"device": fleet.device}
    try:
        fleet.start()
        out["start_s"] = time.perf_counter() - t_start
        loads = [sc.TenantLoad(whale, fleet.router_addr, history, stop,
                               seed=101, n_keys=6, pairs_per_key=24,
                               think_s=0.0),
                 sc.TenantLoad(alpha, fleet.router_addr, history, stop,
                               seed=102, n_keys=2, pairs_per_key=4,
                               think_s=0.05),
                 sc.TenantLoad(beta, fleet.router_addr, history, stop,
                               seed=103, n_keys=2, pairs_per_key=4,
                               think_s=0.05)]
        for ld in loads:
            ld.start()
        time.sleep(CHAOS_SECONDS * 0.3)
        history.record("inject", family="daemon-kill", target=0)
        fleet.kill_daemon(0)
        time.sleep(0.5)
        history.record("inject", family="journal-tear", target=0)
        fleet.tear_journal(0)
        time.sleep(CHAOS_SECONDS * 0.1)
        history.record("heal", family="daemon-kill", target=0)
        fleet.restart_daemon(0)
        ops = [[{"index": i, "time": i, "type": t, "process": 0, "f": f,
                 "value": v} for i, (t, f, v) in enumerate(
                    [("invoke", "write", 1), ("ok", "write", 1)] * 40)]
               for _ in range(4)]
        shed = None
        for attempt in range(10):
            try:
                with CheckerdClient(fleet.router_addr, io_timeout=30.0) as c:
                    c.submit_ops(f"impossible-{attempt}",
                                 {"type": "register", "value": None}, ops,
                                 tenant=alpha, deadline_s=1e-6)
            except ShedByServer as e:
                history.record("shed", tenant=alpha,
                               retry_after_s=e.retry_after_s,
                               reason=e.shed.reason)
                shed = {"reason": e.shed.reason,
                        "retry_after_s": e.retry_after_s}
                break
            except RemoteUnavailable:
                time.sleep(0.5)
        if shed is None:
            raise AssertionError("phase16d: no structured shed for an "
                                 "impossible deadline")
        time.sleep(CHAOS_SECONDS * 0.6)
        stop.set()
        for ld in loads:
            ld.join(timeout=60)
        stop.clear()
        sc.chase_outstanding(history, fleet.router_addr, timeout_s=60)
        divergent = sc.replay_check(history, fleet.router_addr, n=5)
        if divergent:
            raise AssertionError(f"phase16d: replay digests diverged: "
                                 f"{divergent}")
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{fleet.metrics_ports[0]}/metrics",
            timeout=10).read().decode()
        missing = [g for g in ("jepsen_checkerd_overload_brownout_level",
                               "jepsen_checkerd_overload_shed_total",
                               "jepsen_checkerd_queue_depth")
                   if g not in body]
        if missing:
            raise AssertionError(f"phase16d: /metrics lacks {missing}")
        sweeps = [_daemon_launches(fleet.daemon_addr(i))
                  for i in range(fleet.n)]
        need_launches("phase16d", dev, {"witness_sweep": sum(sweeps)})
        dead = fleet.dead_children()
        if dead:
            raise AssertionError(f"phase16d: children died unasked: {dead}")
    finally:
        stop.set()
        if own:
            fleet.stop()
    violations = sc.check_invariants(history, fairness_bound_s=CHAOS_BOUND_S,
                                     light_tenant=alpha)
    st = history.stats()
    if violations or not st["kinds"].get("ack"):
        raise AssertionError(f"phase16d: {violations or 'nothing acked'}")
    waits = sorted(op["wait_s"] for op in history.ops("verdict")
                   if op.get("tenant") == alpha
                   and isinstance(op.get("wait_s"), (int, float)))
    out.update({
        "acked": st["kinds"].get("ack", 0),
        "verdicts": st["kinds"].get("verdict", 0),
        "sheds": st["kinds"].get("shed", 0), "shed": shed,
        "submitted": sum(ld.submitted for ld in loads),
        "light_p95_s": waits[max(0, int(len(waits) * 0.95) - 1)]
        if waits else None,
        "bound_s": CHAOS_BOUND_S, "sweeps_by_daemon": sweeps,
        "wall_s": time.perf_counter() - t_start})
    log("phase16d: " + json.dumps(out))
    return out


def _close_dir(tmp: str) -> list:
    """Kills what still runs from `tmp`, removes it -> what was left."""
    import shutil

    left = _kill_servers(tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    return left


def phase_remote(torch, dev=None, fleet=None) -> dict:
    """Phase 16: Jepsen against real nodes and the federated checker,
    every check on `dev` (the card by default): (16a) `ssh_suite`,
    (16b) `netns_partition`, (16c) `federation`, (16d) `self_chaos`
    (on `fleet` when the caller gives one; the caller stops it).
    Each raises on a failed gate; B1's launch counter is read in this
    process (16a, 16b) and in the daemons' STATS (16c, 16d), whose
    counts start at 0 with each process."""
    import tempfile

    dev = torch.device("cuda") if dev is None else torch.device(dev)
    out: dict = {"card": _smi(dev)}
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase16-")
    try:
        for part, fn in (("a", ssh_suite), ("b", netns_partition),
                         ("c", federation), ("d", self_chaos)):
            sub = os.path.join(tmp, part)
            os.makedirs(sub)
            t0 = time.perf_counter()
            out[part] = (fn(torch, dev, sub, fleet) if part == "d"
                         else fn(torch, dev, sub))
            out[part]["phase_s"] = time.perf_counter() - t0
    finally:
        left = _close_dir(tmp)
    if left:
        raise AssertionError(f"phase16: processes left running: {left}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase16: done in {out['wall_s']:.3f} s")
    return out


# ---------------------------------------------------------------------------
# Standing verification (phase 17): `jepsen monitor`, `jepsen fleet` and
# `jepsen serve` on the card.

#: 17a: tools/monitor_smoke.py's phase 2 at MonitorConfig's default
#: widths (8 keys, 4 processes a key, 64 bars a block, 4 blocks a call,
#: beam 8, 1,024 rows between advances): the rate, the run's seconds,
#: the synthetic SLO's seconds, the cadence (the smoke's 0.3 s: at the
#: default 5 s a 6 s run samples once, after the SLO has cleared), and
#: the ceiling the smoke holds `monitor.resident-rows` under.
MON_RATE, MON_SECONDS, MON_INJECT_S, MON_CADENCE_S = 20_000.0, 6.0, 2.0, 0.3
MON_ROWS_CEILING = 25_000
#: 17b: tools/live_monitor_smoke.py's monitor at TenantSpec's defaults,
#: and the resumed monitor's seconds (the smoke's 20, cut to 10, then
#: to 8 to pay for phase 20: a resumed window takes ~3 s).
LIVE_ARGS = ["--suite", "kvdb", "--live-faults", "kill,pause", "--rate",
             "50", "--keys", "2", "--procs-per-key", "2", "--cadence", "1"]
LIVE_RESUME_S = 8.0
LIVE_SERIES = "monitor.ops-per-s"
#: How a frontier's death reads in a monitor's log when the witness
#: could not prove its blocks (at an advance or at the finish).
WITNESS_UNPROVEN = ("frontier died (witness cannot prove)",
                    "frontier empty at finalize")
TORN_TAIL = b"\x00\x17GARBAGE-TORN-TAIL-NOT-A-BLOCK"
#: 17c: tools/fleet_smoke.py's tenants (TenantSpec's widths: rate 50, 2
#: keys, 2 processes a key, 1 s cadence) with the smoke's tee window,
#: deadline and retention, and its supervisor's settings.
FLEET_TENANTS = ("kvdb", "logd", "electd")
FLEET_RETAIN_BYTES = 32 << 20
#: Every wait of phase 17 ends within this many seconds.
STANDING_WAIT_S = 240.0


def _read_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _until(pred, what: str, deadline_s: float = STANDING_WAIT_S,
           proc=None, poll_s: float = 0.2, log_path=None):
    """pred()'s first truthy value; raises past the deadline or when
    `proc` exits first (with the end of its log at `log_path`)."""
    from jepsen_tpu_torch.nemesis.selfchaos import _tail

    deadline = time.monotonic() + deadline_s
    while True:
        v = pred()
        if v:
            return v
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"{what}: the child exited "
                                 f"{proc.returncode} first: "
                                 f"{_tail(log_path)}")
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {deadline_s} s")
        time.sleep(poll_s)


def _http(url: str, timeout: float = 15.0) -> tuple:
    """(status, body bytes) of a GET."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _sse_payload(url: str, deadline_s: float = 30.0) -> dict:
    """The first `data:` payload of an SSE stream, read under a
    deadline."""
    import urllib.request

    deadline = time.monotonic() + deadline_s
    with urllib.request.urlopen(url, timeout=deadline_s) as resp:
        while time.monotonic() < deadline:
            line = resp.readline()
            if line.startswith(b"data:"):
                return json.loads(line[5:].strip())
    raise AssertionError("phase17b: the SSE stream sent no payload")


def _witness_sweeps(launches: dict) -> int:
    return int((launches or {}).get("witness_sweep", 0))


def standing_monitor(torch, dev, tmp: str) -> dict:
    """(17a) `run_monitor` in this process at MonitorConfig's default
    widths, MON_RATE ops/s for MON_SECONDS with the synthetic SLO firing
    for MON_INJECT_S and a file sink.  Gates: the alert reaches the sink
    once (not a renotify) with its dossier and the flight postmortem,
    and clears once; every key proven; `monitor.resident-rows` under
    MON_ROWS_CEILING at every sample; B1 launched.  Reads ops, the
    measured rate, `monitor.verdict-lag-s` (median and p95 of its
    samples) and the card's peak allocated bytes after the first second
    and at the end."""
    import threading

    from jepsen_tpu_torch import telemetry
    from jepsen_tpu_torch.monitor import MonitorConfig, run_monitor
    from jepsen_tpu_torch.ops import kernels
    from jepsen_tpu_torch.telemetry import flight, profile, slo, timeseries

    store = os.path.join(tmp, "store")
    sink = os.path.join(tmp, "alerts.jsonl")
    cuda = dev.type == "cuda"
    peaks: dict = {}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        peaks["allocated_at_start"] = torch.cuda.memory_allocated()
    timer = threading.Timer(1.0, lambda: peaks.update(
        peak_after_1s=torch.cuda.max_memory_allocated()) if cuda else None)
    timeseries.reset_rings()
    was = telemetry.enabled()
    kernels.launches.clear()
    t0 = time.perf_counter()
    timer.start()
    try:
        summary = run_monitor(MonitorConfig(
            store_dir=store, device=dev.type, rate=MON_RATE,
            duration_s=MON_SECONDS, cadence_s=MON_CADENCE_S,
            inject_slo_s=MON_INJECT_S, sinks=(f"file:{sink}",)))
    finally:
        timer.cancel()
        profile.set_store(None)
        flight.set_dir(None)
        slo.set_dir(None)
        telemetry.enable(was)
    wall = time.perf_counter() - t0
    if cuda:
        torch.cuda.synchronize()
        peaks["peak_at_end"] = torch.cuda.max_memory_allocated()
    launches = dict(kernels.launches)
    lag = timeseries.quantiles("monitor.verdict-lag-s")
    events = [json.loads(ln) for ln in open(sink) if ln.strip()]
    mine = [e for e in events if e.get("rule") == "monitor-injected"]
    firing = [e for e in mine if e.get("rec") == "firing"
              and not e.get("renotify")]
    cleared = [e for e in mine if e.get("rec") == "cleared"]
    rows = [v for _, v in timeseries.read_disk_series(
        store, "monitor.resident-rows")]
    out = {"ops": summary["ops"], "rate_target": MON_RATE,
           "rate_measured": summary["rate_measured"],
           "duration_s": summary["duration_s"], "wall_s": wall,
           "keys": summary["keys"], "ok_keys": summary["ok_keys"],
           "unknown_keys": summary["unknown_keys"],
           "discarded_rows": summary["checker"]["discarded-rows"],
           "verdict_lag_s": {"p50": lag.get("p50"), "p95": lag.get("p95"),
                             "final": summary["verdict_lag_s"]},
           "resident_rows_max": max(rows) if rows else None,
           "samples": len(rows), "alerts": len(events),
           "sweeps": _witness_sweeps(launches), "launches": launches,
           "card_memory": peaks}
    log("phase17a: " + json.dumps(out))
    dossier = firing[0].get("dossier") if len(firing) == 1 else None
    if (len(firing) != 1 or len(cleared) != 1 or not dossier
            or not os.path.isfile(dossier)
            or not firing[0].get("postmortem")):
        raise AssertionError(f"phase17a: the injected alert's round trip: "
                             f"{len(firing)} firing, {len(cleared)} "
                             f"cleared, dossier {dossier!r}")
    if summary["ok_keys"] != summary["keys"] or summary["unknown_keys"]:
        raise AssertionError(f"phase17a: verdicts {summary['verdicts']}")
    if not rows or max(rows) >= MON_ROWS_CEILING or \
            out["discarded_rows"] <= 0:
        raise AssertionError(f"phase17a: resident rows {rows[-5:]}, "
                             f"discarded {out['discarded_rows']}")
    need_launches("phase17a", dev, launches)
    return out


def standing_live(torch, dev, tmp: str) -> dict:
    """(17b) tools/live_monitor_smoke.py with monitor_smoke.py's phase 1:
    `kvdb monitor --suite kvdb --device <dev>` against the kvdb server,
    kill and pause windows; SIGKILLed once a window has completed and
    while the fault ledger holds an outstanding intent; a torn tail
    appended to its tier-0 series file; then a second monitor on the
    same store with the dashboard for LIVE_RESUME_S.  Gates: both
    families injected and healed in the ledger; the stranded intent
    swept on resume, zero outstanding at exit and a clean residue probe;
    search.json resumed as a superset with its window counter advanced;
    the series continuous across the kill and the torn tail truncated;
    /api/series serving the pre-kill samples, /monitor wired to the
    SSE stream and the stream delivering a payload; B1 launched in the
    second monitor (its summary); exit 0 with every key proven, or exit
    2 (the reference smoke's other accepted code) where each unknown key
    is a frontier the witness could not prove (its log says so) and never
    an invalid verdict: the witness, in both packages, leaves some
    linearizable histories with crashed (info) ops unproven, which the
    rolling checker cannot escalate (PERF.md §6)."""
    import signal

    from jepsen_tpu_torch.nemesis import ledger
    from jepsen_tpu_torch.telemetry.timeseries import (read_disk_series,
                                                       series_path)

    store = os.path.join(tmp, "store")
    base = ["monitor", *LIVE_ARGS, "--device", dev.type, "--store-dir",
            store, "--search-dir", os.path.join(store, "search")]
    ledger_path = ledger.ledger_path(os.path.join(store, "live"))
    logs = [os.path.join(tmp, f"m{i}.log") for i in (1, 2)]
    t0 = time.perf_counter()
    first = _Child("m1", base + ["--duration", "300"], 0, tmp).spawn().proc
    try:
        st0 = _until(lambda: (lambda st: st if st.get("windows", 0) >= 1
                              else None)(_read_json(os.path.join(
                                  store, "live-status.json"))),
                     "phase17b: a first fault window", proc=first,
                     log_path=logs[0])
        pre = read_disk_series(store, LIVE_SERIES)
        stranded = _until(lambda: ledger.read_outstanding(ledger_path),
                          "phase17b: an outstanding intent", proc=first,
                          poll_s=0.02, log_path=logs[0])
        os.kill(first.pid, signal.SIGKILL)
        first.wait(timeout=30)
    finally:
        if first.poll() is None:
            first.kill()
            first.wait(timeout=30)
    t_kill = time.time()
    killed_s = time.perf_counter() - t0
    with open(series_path(store), "ab") as f:
        f.write(TORN_TAIL)
    if len(read_disk_series(store, LIVE_SERIES)) < len(pre):
        raise AssertionError("phase17b: a reader lost samples at the tear")
    t1 = time.perf_counter()
    # The dashboard on a port of the monitor's choosing, read from its
    # log: a port picked here could be taken by a client connection
    # before the monitor binds it.
    second = _Child("m2", base + ["--duration", str(LIVE_RESUME_S),
                                  "--serve-port", "0"], 0, tmp).spawn().proc
    try:
        port = _until(lambda: _dashboard_port(logs[1]),
                      "phase17b: the dashboard", proc=second,
                      log_path=logs[1])
        web = f"http://127.0.0.1:{port}"
        names = json.loads(_http(f"{web}/api/series")[1])["names"]
        served = json.loads(_http(
            f"{web}/api/series?name={LIVE_SERIES}")[1])["points"]
        page = _http(f"{web}/monitor")[1].decode()
        payload = _sse_payload(f"{web}/api/series/stream")
        rc = second.wait(timeout=LIVE_RESUME_S + 120)
    finally:
        if second.poll() is None:
            second.kill()
            second.wait(timeout=30)
    resume_s = time.perf_counter() - t1
    with open(series_path(store), "rb") as f:
        torn_left = TORN_TAIL in f.read()
    summary = _read_json(os.path.join(store, "monitor-summary.json"))
    live = summary.get("live") or {}
    with open(logs[1], errors="replace") as f:
        deaths = [ln.split("online frontier died: ", 1)[1].strip()
                  for ln in f if "online frontier died: " in ln]
    unproven = sum(1 for d in deaths if d.startswith(WITNESS_UNPROVEN))
    records = ledger.read_records(ledger_path)
    healed = {r["id"] for r in records if r.get("rec") == "healed"}
    families = sorted({r.get("tag") for r in records
                       if r.get("rec") == "intent" and r["id"] in healed
                       and r.get("tag") in ("db-kill", "db-pause")})
    sj = _read_json(os.path.join(store, "search", "search.json"))
    merged = read_disk_series(store, LIVE_SERIES)
    before = [t for t, _ in merged if t <= t_kill]
    after = [t for t, _ in merged if t > t_kill]
    out = {"exit": rc, "killed_after_s": killed_s, "resume_s": resume_s,
           "stranded": [(e.get("fault"), e.get("tag")) for e in stranded],
           "windows": [st0.get("windows"), sj.get("windows")],
           "coverage": [st0.get("coverage"), len(sj.get("coverage") or [])],
           "novel_windows": sj.get("novel-windows"),
           "families_healed": families,
           "repair_healed": (live.get("repair-on-start") or {}).get("healed"),
           "residue_clean": (live.get("residue") or {}).get("clean"),
           "outstanding_at_exit": live.get("outstanding-at-exit"),
           "series": [len(before), len(after)], "pre_kill": len(pre),
           "ops": summary.get("ops"), "ok_keys": summary.get("ok_keys"),
           "unknown_keys": summary.get("unknown_keys"),
           "frontier_deaths": deaths,
           "sweeps": _witness_sweeps(summary.get("launches")),
           "sse": sorted(payload.get("s") or {})[:3]}
    log("phase17b: " + json.dumps(out))
    unknown = summary.get("unknown_keys")
    fails = [what for what, bad in (
        ("exit", not ((rc == 0 and unknown == 0) or (
            rc == 2 and 0 < unknown <= unproven
            and summary.get("ok_keys", 0) + unknown == 2))),
        ("families", len(families) < 2),
        ("repair", not out["repair_healed"]),
        ("residue", out["residue_clean"] is not True
         or out["outstanding_at_exit"] != 0),
        ("search", len(sj.get("coverage") or []) < st0.get("coverage", 0)
         or sj.get("windows", 0) <= st0.get("windows", 0)
         or sj.get("novel-windows", 0) < 1),
        ("series", len(before) < len(pre) or not after or torn_left),
        ("dashboard", LIVE_SERIES not in names or not served
         or min(t for t, _ in served) > t_kill
         or "EventSource" not in page or not payload.get("s")),
    ) if bad]
    if fails:
        raise AssertionError(f"phase17b: {fails}: {out}")
    need_launches("phase17b", dev, summary.get("launches") or {})
    return out


def _log_tails(d: str) -> None:
    """Logs the end of each child log under `d` (a failed sub-phase's)."""
    import glob

    from jepsen_tpu_torch.nemesis.selfchaos import _tail

    for path in sorted(glob.glob(os.path.join(d, "*.log"))):
        log(f"{path}: ...{_tail(path, 1500)}")


def _dashboard_port(log_path: str):
    """The port a monitor's log says its dashboard serves on, if it
    says so yet."""
    import re

    try:
        with open(log_path, errors="replace") as f:
            m = re.search(r"monitor dashboard at http://127\.0\.0\.1:(\d+)/",
                          f.read())
    except OSError:
        return None
    return int(m.group(1)) if m else None


def _card_processes() -> list:
    """[pid, MiB] of each process holding a context on the card, as
    nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True)
    return [[int(x) for x in ln.split(",")]
            for ln in r.stdout.splitlines() if ln.strip()]


def standing_fleet(torch, dev, tmp: str, chaos=None) -> dict:
    """(17c) tools/fleet_smoke.py: a FleetSupervisor in this process over
    three tenants (kvdb, logd, electd, each a live monitor child with
    kill and pause windows, `--device <dev>`), their tee on a router in
    front of two `jepsen checkerd` daemons (16d's, when `chaos` hands
    them over).  Once every tenant has completed a window, kvdb's
    monitor and daemon 0 are SIGKILLed, and the daemon is restarted 2 s
    later in this thread (a restart that fails raises).  Gates: the
    survivors' series keep every pre-kill point and grow, and their
    window counters advance; kvdb is restarted and resumes its search
    (windows advanced, coverage a superset); no daemon or router dead
    unasked and the restarted daemon 0 answering STATS; each tenant
    under its retention budget, a sweep counted; /api/fleet (off the
    fleet root) lists the three with supervisor state and kvdb's
    restart; the fleet's /metrics has the fleet.* families and daemon
    1's the checkerd queue and overload ones; a surviving tenant that
    daemon 1 shed has still advanced its windows (the smoke's shed
    fairness); B1 launched in daemon 1 (STATS) and, on the card, in
    each tenant's last monitor (its summary, after the drain)."""
    import signal
    import threading

    from jepsen_tpu_torch import telemetry, web
    from jepsen_tpu_torch.monitor.fleet import (FleetRegistry,
                                                FleetSupervisor, TenantSpec,
                                                tenant_argv,
                                                tenant_store_dir)
    from jepsen_tpu_torch.monitor.retention import disk_bytes
    from jepsen_tpu_torch.nemesis import selfchaos as sc
    from jepsen_tpu_torch.nemesis.selfchaos import spawn_child
    from jepsen_tpu_torch.telemetry.timeseries import read_disk_series

    t0 = time.perf_counter()
    own = chaos is None
    if own:
        chaos = sc.ChaosFleet(2, os.path.join(tmp, "checkerd"),
                              metrics=True, device=dev.type)
        chaos.start()
    root = os.path.join(tmp, "fleet")
    here = os.path.dirname(os.path.abspath(__file__))

    def spawn(spec, store, endpoint):
        return spawn_child(tenant_argv(spec, store, endpoint, dev.type),
                           dict(os.environ, PYTHONPATH=here),
                           os.path.join(tmp, f"{spec.name}.log"))

    def live(t):
        return _read_json(os.path.join(tenant_store_dir(root, t),
                                       "live-status.json"))

    def search(t):
        return _read_json(os.path.join(tenant_store_dir(root, t),
                                       "search", "search.json"))

    reg = FleetRegistry(root)
    for name in FLEET_TENANTS:
        reg.add(TenantSpec(
            name=name, suite=name, duration_s=600.0,
            live_faults=("kill", "pause"), endpoint=chaos.router_addr,
            deadline_s=30.0, tee_window_ops=256, retain_dossiers=8,
            retain_bytes=FLEET_RETAIN_BYTES))
    from jepsen_tpu_torch.checkerd.client import fetch_stats

    was = telemetry.enabled()
    telemetry.enable(True)
    launches0 = _daemon_launches(chaos.daemon_addr(1))
    requests0 = fetch_stats(chaos.daemon_addr(1), timeout=10.0).get(
        "requests", 0)
    sup = FleetSupervisor(root, device=dev.type,
                          endpoint=chaos.router_addr, tick_s=0.5,
                          park_after=5, min_uptime_s=3.0,
                          drain_timeout_s=20.0, retention_interval_s=10.0,
                          spawn=spawn)
    stop = threading.Event()
    sup_thread = threading.Thread(target=sup.run, args=(stop,),
                                  name="phase17c-fleet", daemon=True)
    sup_thread.start()
    httpd = web.make_server(root, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    victim, survivors = "kvdb", ("logd", "electd")
    out: dict = {"reused_16d": not own}
    try:
        _until(lambda: all(live(t).get("windows", 0) >= 1
                           for t in FLEET_TENANTS),
               "phase17c: a window on every tenant")
        out["windowed_s"] = time.perf_counter() - t0
        pre = {t: {"windows": live(t).get("windows", 0),
                   "coverage": live(t).get("coverage", 0),
                   "series": len(read_disk_series(
                       tenant_store_dir(root, t), LIVE_SERIES))}
               for t in FLEET_TENANTS}
        os.kill(sup.children[victim].proc.pid, signal.SIGKILL)
        chaos.kill_daemon(0)
        t_kill = time.time()
        t_killed = time.perf_counter()
        time.sleep(2.0)
        chaos.restart_daemon(0)
        out["daemon0_back_s"] = time.perf_counter() - t_killed
        _until(lambda: (sup.children[victim].restarts >= 1
                        and sup.children[victim].alive()),
               "phase17c: kvdb restarted")
        _until(lambda: (search(victim).get("windows", 0)
                        > pre[victim]["windows"]
                        and len(search(victim).get("coverage") or [])
                        >= pre[victim]["coverage"]),
               "phase17c: kvdb's search resumed")
        out["resume_s"] = time.perf_counter() - t_killed
        out["series"] = {}
        for t in survivors:
            _until(lambda t=t: live(t).get("windows", 0)
                   > pre[t]["windows"], f"phase17c: {t}'s windows")
            pts = read_disk_series(tenant_store_dir(root, t), LIVE_SERIES)
            n_before = sum(1 for p in pts if p[0] <= t_kill)
            n_after = len(pts) - n_before
            if n_before < pre[t]["series"] or not n_after:
                raise AssertionError(f"phase17c: {t}'s series: {n_before} "
                                     f"of {pre[t]['series']} pre-kill "
                                     f"points, {n_after} after")
            out["series"][t] = [n_before, n_after]
        dead = chaos.dead_children()
        if dead or chaos.daemons[0] is None:
            raise AssertionError(f"phase17c: children died unasked: {dead}")
        out["daemon0_requests"] = fetch_stats(
            chaos.daemon_addr(0), timeout=10.0).get("requests", 0)
        if dev.type == "cuda":
            # The card's memory by process as nvidia-smi reports it (its
            # pids are the host's, which a sandbox may not show).
            out["card_mib"] = _card_processes()
        disk = {t: disk_bytes(tenant_store_dir(root, t))
                for t in FLEET_TENANTS}
        out["disk_bytes"] = disk
        out["retention_sweeps"] = telemetry.counter_value(
            "fleet.retention.sweeps")
        if max(disk.values()) > FLEET_RETAIN_BYTES or \
                out["retention_sweeps"] < 1:
            raise AssertionError(f"phase17c: retention: {disk}, "
                                 f"{out['retention_sweeps']} sweeps")
        api = json.loads(_http(f"{base}/api/fleet")[1])
        rows = api.get("tenants") or {}
        out["api_states"] = {t: (r.get("supervisor") or {}).get("state")
                             for t, r in rows.items()}
        if sorted(rows) != sorted(FLEET_TENANTS) or not (
                rows[victim].get("supervisor") or {}).get("restarts"):
            raise AssertionError(f"phase17c: /api/fleet: {out['api_states']}")
        metrics = _http(f"{base}/metrics")[1].decode()
        dmetrics = _http(f"http://127.0.0.1:{chaos.metrics_ports[1]}"
                         "/metrics")[1].decode()
        missing = [f for f in ("jepsen_fleet_tenant_starts_total",
                               "jepsen_fleet_retention_sweeps_total")
                   if f not in metrics]
        missing += [f for f in ("jepsen_checkerd_queue_depth",
                                "jepsen_checkerd_overload_brownout_level")
                    if f not in dmetrics]
        if missing:
            raise AssertionError(f"phase17c: /metrics lacks {missing}")
        tenant_lines = [ln for ln in dmetrics.splitlines()
                        if "tenant=" in ln]
        shed = sorted({t for t in FLEET_TENANTS for ln in tenant_lines
                       if "shed" in ln and f'tenant="{t}"' in ln
                       and not ln.rstrip().endswith(" 0.0")})
        stalled = [t for t in shed if t in survivors
                   and live(t).get("windows", 0) <= pre[t]["windows"]]
        if stalled:
            raise AssertionError(f"phase17c: {stalled} shed, then stalled")
        out["daemon_tenant_lines"] = len(tenant_lines)
        out["shed_tenants"] = shed
        out["daemon1_sweeps"] = _daemon_launches(
            chaos.daemon_addr(1)) - launches0
        out["daemon1_requests"] = fetch_stats(
            chaos.daemon_addr(1), timeout=10.0).get("requests", 0) - requests0
        need_launches("phase17c daemon 1", dev,
                      {"witness_sweep": out["daemon1_sweeps"]})
    finally:
        stop.set()
        sup_thread.join(timeout=120)
        httpd.shutdown()
        httpd.server_close()
        telemetry.enable(was)
        if own:
            chaos.stop()
    if sup_thread.is_alive():
        raise AssertionError("phase17c: the supervisor did not drain")
    out["tenants"] = {}
    for t in FLEET_TENANTS:
        s = _read_json(os.path.join(tenant_store_dir(root, t),
                                    "monitor-summary.json"))
        out["tenants"][t] = {
            "ops": s.get("ops"), "ok_keys": s.get("ok_keys"),
            "unknown_keys": s.get("unknown_keys"),
            "windows": (live(t) or {}).get("windows"),
            "restarts": sup.children[t].restarts,
            "last_exit": sup.children[t].last_exit,
            "sweeps": _witness_sweeps(s.get("launches"))}
        need_launches(f"phase17c tenant {t}", dev,
                      {"witness_sweep": out["tenants"][t]["sweeps"]})
    out["wall_s"] = time.perf_counter() - t0
    log("phase17c: " + json.dumps(out))
    return out


def standing_serve(torch, dev, tmp: str, stored: dict) -> dict:
    """(17d) `jepsen serve` through the port's CLI (kvdb's) on phase
    11's store: `/` (with 11a's run valid in its row), 11a's run page,
    its history.txt, its zip and 11e's telemetry page (11e ran with
    telemetry on) each answer 200."""
    import io
    import urllib.parse
    import zipfile

    from jepsen_tpu_torch.nemesis.selfchaos import _free_port

    root = stored["root"]
    rel_a = urllib.parse.quote(os.path.relpath(stored["a"], root))
    rel_e = urllib.parse.quote(os.path.relpath(stored["e"], root))
    port = _free_port()
    t0 = time.perf_counter()
    child = _Child("serve", ["serve", "--store-dir", root, "--host",
                             "127.0.0.1", "--port", str(port)], port, tmp)
    base = f"http://{child.addr}"
    try:
        child.spawn().ready()
        up_s = time.perf_counter() - t0
        got = {what: _http(base + path) for what, path in (
            ("index", "/"), ("run", f"/files/{rel_a}/"),
            ("file", f"/files/{rel_a}/history.txt"),
            ("zip", f"/zip/{rel_a}"), ("telemetry", f"/telemetry/{rel_e}"))}
    finally:
        child.stop()
    codes = {k: c for k, (c, _) in got.items()}
    stamp = os.path.basename(stored["a"])
    index = got["index"][1].decode()
    row = next((r for r in index.split("<tr>") if stamp in r), "")
    names = zipfile.ZipFile(io.BytesIO(got["zip"][1])).namelist() \
        if codes["zip"] == 200 else []
    out = {"codes": codes, "up_s": up_s, "a_valid": stored["a_valid"],
           "row_valid": "valid-true" in row, "zip_members": len(names),
           "history_bytes": len(got["file"][1])}
    log("phase17d: " + json.dumps(out))
    if (set(codes.values()) != {200} or stored["a_valid"] is not True
            or "valid-true" not in row or "history.txt" not in names
            or b"invoke" not in got["file"][1]
            or b"history.txt" not in got["run"][1]):
        raise AssertionError(f"phase17d: {out}")
    return out


def phase_standing(torch, stored: dict, dev=None, chaos=None) -> dict:
    """Phase 17: standing verification on `dev` (the card by default):
    (17a) `standing_monitor` in this process, then (17b)
    `standing_live`, (17c) `standing_fleet` (on 16d's router and
    daemons when `chaos` is given) and (17d) `standing_serve` (on phase
    11's `stored` runs) together, each in a thread of its own, since
    their children wait mostly on their paced clients and fault
    windows.  Each raises on a failed gate; no server started from the
    phase's directory outlives it."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    dev = torch.device("cuda") if dev is None else torch.device(dev)
    out: dict = {"card": _smi(dev)}
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase17-")
    try:
        for part in "abcd":
            os.makedirs(os.path.join(tmp, part))
        out["a"] = standing_monitor(torch, dev, os.path.join(tmp, "a"))
        out["a"]["phase_s"] = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        with ThreadPoolExecutor(3) as pool:
            futs = {"b": pool.submit(standing_live, torch, dev,
                                     os.path.join(tmp, "b")),
                    "c": pool.submit(standing_fleet, torch, dev,
                                     os.path.join(tmp, "c"), chaos),
                    "d": pool.submit(standing_serve, torch, dev,
                                     os.path.join(tmp, "d"), stored)}
            for part, fut in futs.items():
                try:
                    out[part] = fut.result()
                except BaseException:
                    _log_tails(os.path.join(tmp, part))
                    raise
        out["bcd_s"] = time.perf_counter() - t0
    finally:
        left = _close_dir(tmp)
    if left:
        raise AssertionError(f"phase17: processes left running: {left}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase17: done in {out['wall_s']:.3f} s")
    return out


def elle_programs(torch, elle: dict) -> list:
    """The device-program entries (B7 and B8) of phase 8 for the JSON
    line before the kernels line: CUDA-event times from phase 8, device
    time and operations per call from torch.profiler (phase 3), and the
    bound from this run's shapes and BFS levels."""
    import inspect

    from jepsen_tpu_torch.checker.elle import AppendChecker
    from jepsen_tpu_torch.ops import scc
    from jepsen_tpu_torch.telemetry import roofline

    dev = torch.device("cuda")
    a8 = next(r for r in elle["checks"] if r["sub_phase"] == "8a")
    b8 = next(r for r in elle["checks"] if r["sub_phase"] == "8b")
    g_a, g_b = elle["graphs"]["8a"], elle["graphs"]["8b"]

    adj = torch.from_numpy(scc.pack_adjacency([g_a])[0]).to(dev)
    K, V = adj.shape[0], adj.shape[1]
    seen = profile_device(torch, lambda: scc.has_cycle(adj, torch.bfloat16),
                          reps=20)
    cost = roofline.closure_cost(K, V)
    b7_bound = roofline.bound(cost["flops"], cost["bytes_accessed"])
    b7 = {"name": "scc_closure_screen", "route": "torch",
          "source": "jepsen_tpu_torch/ops/scc.py:"
                    f"{inspect.getsourcelines(scc.has_cycle)[1]}",
          "replaces": "jepsen_tpu/ops/scc.py:81",
          "shape": list(adj.shape), "launches": a8["screens"],
          "ms": a8["closure_ms"],
          "device_ms": sum(us for _, us in seen.values()) / 20 / 1e3,
          "device_ops_per_call": sum(n for n, _ in seen.values()) / 20,
          "bound_ms": b7_bound[0], "bound_by": b7_bound[1],
          "library_ms": elle["bmm_ms"],
          "batch_shape": elle["screen_batch"]["shape"],
          "batch_ms": elle["screen_batch"]["closure_ms"]}
    seen = profile_device(torch, lambda: scc.screen_cycles([g_a], device=dev),
                          reps=5)
    b7["screen_call_device_ops"] = sum(n for n, _ in seen.values()) / 5

    layers = scc.layer_entries(g_b)
    a_all, a_req, _ = scc.pack_required([x[0] for x in layers],
                                        [x[1] for x in layers])
    A, R = (torch.from_numpy(x).to(dev) for x in (a_all, a_req))
    K8, V8 = A.shape[0], A.shape[1]
    seen = profile_device(
        torch, lambda: scc.extract_batch(A, R, torch.bfloat16), reps=1)
    cost = roofline.extract_cost(K8, V8, b8["bfs_graph_levels"])
    b8_bound = roofline.bound(cost["flops"], cost["bytes_accessed"])
    b8e = {"name": "scc_extract", "route": "torch",
           "source": "jepsen_tpu_torch/ops/scc.py:"
                     f"{inspect.getsourcelines(scc.extract_batch)[1]}",
           "replaces": "jepsen_tpu/ops/scc.py:162",
           "shape": list(A.shape), "launches": b8["extractions"],
           "bfs_levels": b8["bfs_levels"], "ms": b8["extract_ms"],
           "device_ms": sum(us for _, us in seen.values()) / 1e3,
           "device_ops_per_call": sum(n for n, _ in seen.values()),
           "bound_ms": b8_bound[0], "bound_by": b8_bound[1],
           "library_ms": None}
    h, model = elle["profile_check"]
    seen = profile_device(
        torch, lambda: AppendChecker(model, device=dev).check({}, h, {}),
        reps=1)
    b8e["check_device_ms"] = sum(us for _, us in seen.values()) / 1e3
    b8e["check_device_ops"] = sum(n for n, _ in seen.values())

    # The many-level extraction (8b-chain) beside the one-level one
    # (8b), both serializable and at the same shape: the difference per
    # extra level is one level's cost (a host read, an index upload and
    # the level's device work).
    one = next(r for r in elle["checks"] if r["sub_phase"] == "8b"
               and r["model"] == b8["model"])
    many = next(r for r in elle["checks"] if r["sub_phase"] == "8b-chain"
                and r["model"] == b8["model"])
    layers = scc.layer_entries(elle["graphs"]["8b-chain"])
    a_all, a_req, _ = scc.pack_required([x[0] for x in layers],
                                        [x[1] for x in layers])
    A, R = (torch.from_numpy(x).to(dev) for x in (a_all, a_req))
    seen = profile_device(
        torch, lambda: scc.extract_batch(A, R, torch.bfloat16), reps=1)
    cost = roofline.extract_cost(K8, V8, many["bfs_graph_levels"])
    long_bound = roofline.bound(cost["flops"], cost["bytes_accessed"])
    b8e["long_chain"] = {
        "shape": list(A.shape), "bfs_levels": many["bfs_levels"],
        "bfs_graph_levels": many["bfs_graph_levels"],
        "ms": many["extract_ms"],
        "device_ms": sum(us for _, us in seen.values()) / 1e3,
        "device_ops_per_call": sum(n for n, _ in seen.values()),
        "bound_ms": long_bound[0], "bound_by": long_bound[1],
        "one_level_ms": one["extract_ms"],
        "ms_per_extra_level": (many["extract_ms"] - one["extract_ms"])
        / (many["bfs_levels"] - one["bfs_levels"])}
    for e in (b7, b8e):
        log(f"profile: {e['name']}: " + json.dumps(e))
    return [b7, b8e]


def _kernel_key(mangled: str):
    """"MODEL,SW,NW,STREAM" of a witness_sweep_kernel instantiation,
    "wide,STREAM" of the wide one, "combine" for the lane-group join,
    from a mangled kernel name; None for any other."""
    import re

    t = re.search(r"witness_sweep_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb([01])E",
                  mangled)
    if t:
        return ",".join(t.groups())
    t = re.search(r"witness_sweep_wide_kernelILb([01])E", mangled)
    if t:
        return f"wide,{t.group(1)}"
    return "combine" if "combine_groups_kernel" in mangled else None


def ptxas_report(build_log: str) -> dict:
    """{"MODEL,SW,NW,stream": {"registers", "spill_stores",
    "spill_loads"}} of each witness_sweep_kernel instantiation, from the
    build's -Xptxas -v output."""
    import re

    out, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = _kernel_key(m.group(1))
            if cur:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur].update(spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def sass_instructions(lib_path: str) -> dict:
    """{"MODEL,SW,NW,stream": SASS instructions} of each
    witness_sweep_kernel instantiation in the built library, from
    `cuobjdump -sass` ({} where the toolkit has none)."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = _kernel_key(m.group(1))
            if cur:
                out[cur] = 0
        elif cur and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            out[cur] += 1
    return out


# ---------------------------------------------------------------------------
# Phase 18: the witness's transfer modes, and the port's jepsenlint.
# ---------------------------------------------------------------------------

TRANSFER_MODES = ("full", "indices", "device")
TRANSFER_REPS = 3
#: The many-chunk gates' block shape: K = 64 x 2 blocks a chunk call
#: puts phase 4's death (and the valid run's end) several calls in.
TRANSFER_CHUNK = dict(bars_per_block=64, blocks_per_call=2)
TRANSFER_MULTI_OPS = 20_000
LINT_BUDGET_S = 10.0


def transfer_run(torch, dev, check) -> dict:
    """One witness call `check()` with telemetry on and the counts
    reset: its verdict, death rank, B1 launches, host syncs and H2D
    bytes."""
    from jepsen_tpu_torch import device as D
    from jepsen_tpu_torch import telemetry
    from jepsen_tpu_torch.ops import kernels

    kernels.launches.clear()
    D.counters.clear()
    prior = telemetry.enabled()
    telemetry.enable(True)
    telemetry.reset()
    try:
        info: dict = {}
        r = check(info)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return {"valid": None if r is None else r.valid,
                "died_at_rank": info.get("died_at_rank"),
                "launches": kernels.launches["witness_sweep"],
                "host_syncs": D.counters.get("host_syncs", 0),
                "h2d_bytes": int(telemetry.counter_value("wgl.h2d-bytes"))}
    finally:
        telemetry.reset()
        telemetry.enable(prior)


def phase_transfer(torch, packed, pm, dev=None, reps: int = TRANSFER_REPS,
                   multi_ops: int = TRANSFER_MULTI_OPS) -> dict:
    """18a: `check_wgl_witness(transfer=m)` for "full", "indices" and
    "device" on the bench history (one counted warm run with telemetry
    on, then `reps` timed runs with it off), on phase 4's invalid
    history and on runs many chunk calls long.  Gates: valid in every
    mode on the bench history with equal B1 launches, and equal
    verdicts and death ranks across the modes on the others."""
    from jepsen_tpu_torch.history.packed import pack_history
    from jepsen_tpu_torch.ops.wgl_witness import check_wgl_witness
    from jepsen_tpu_torch.utils.histgen import (random_register_history,
                                                random_register_packed)

    dev = torch.device(dev or "cuda")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    bad = pack_history(random_register_history(
        2000, procs=8, info_rate=0.0, seed=BENCH_SEED, bad=True), pm.encode)
    multi = random_register_packed(multi_ops, procs=16, info_rate=0.05,
                                   seed=9, model=pm)
    out: dict = {"ops": packed.n, "modes": {}}
    for mode in TRANSFER_MODES:
        def check(info, p=packed, **kw):
            return check_wgl_witness(p, pm, transfer=mode, out_info=info,
                                     device=dev, **kw)

        r = transfer_run(torch, dev, check)
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            check({})
            sync()
            walls.append(time.perf_counter() - t0)
        r["wall_s"] = walls
        r["median_s"] = statistics.median(walls)
        r["invalid"] = transfer_run(torch, dev, lambda i: check(i, bad))
        r["invalid_chunked"] = transfer_run(
            torch, dev, lambda i: check(i, bad, **TRANSFER_CHUNK))
        r["multi_chunk"] = transfer_run(
            torch, dev, lambda i: check(i, multi, **TRANSFER_CHUNK))
        out["modes"][mode] = r
        log(f"phase18a: {mode} " + json.dumps(r))
    m = out["modes"]
    full = m["full"]
    for mode in TRANSFER_MODES:
        r = m[mode]
        if r["valid"] is not True or (dev.type == "cuda"
                                      and r["launches"] <= 0):
            raise AssertionError(f"phase18a: {mode}: bench verdict "
                                 f"{r['valid']}, {r['launches']} launches")
        if r["launches"] != full["launches"]:
            raise AssertionError(
                f"phase18a: B1 launches {mode} {r['launches']} != full "
                f"{full['launches']}")
        for key in ("invalid", "invalid_chunked", "multi_chunk"):
            got = (r[key]["valid"], r[key]["died_at_rank"])
            want = (full[key]["valid"], full[key]["died_at_rank"])
            if got != want:
                raise AssertionError(f"phase18a: {key}: {mode} gave {got}, "
                                     f"full {want}")
    if (full["invalid"]["valid"] is not None
            or full["invalid"]["died_at_rank"] is None
            or full["invalid_chunked"]["died_at_rank"] is None):
        raise AssertionError(f"phase18a: the bad history's witness did not "
                             f"die at a barrier: {full['invalid']}, "
                             f"{full['invalid_chunked']}")
    if full["multi_chunk"]["valid"] is not True:
        raise AssertionError(f"phase18a: many-chunk verdict "
                             f"{full['multi_chunk']}")
    return out


def phase_lint(root: str) -> dict:
    """18b: `python -m jepsen_tpu_torch.analysis --json` over the port's
    tree, as a subprocess.  Gates: exit 0, clean, no stale baseline
    entry, under `LINT_BUDGET_S` seconds by the report's own clock."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="lint-") as store:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "jepsen_tpu_torch.analysis", "--json",
             "--lint-store-dir", store],
            cwd=root, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
    try:
        rep = json.loads(proc.stdout)
    except ValueError:
        raise AssertionError(f"phase18b: exit {proc.returncode}, no JSON "
                             f"report: {proc.stderr[-2000:]}")
    r = {"exit": proc.returncode, "clean": rep["clean"],
         "files": rep["files"], "counts": rep["counts"],
         "baselined": len(rep["baselined"]),
         "unbaselined": len(rep["unbaselined"]),
         "stale": len(rep["stale_baseline"]),
         "duration_s": rep["duration_s"], "wall_s": wall}
    log("phase18b: " + json.dumps(r))
    if (proc.returncode != 0 or not r["clean"] or r["stale"]
            or r["duration_s"] >= LINT_BUDGET_S):
        raise AssertionError(f"phase18b: lint {r}: "
                             f"{rep['unbaselined'][:5]}")
    return r


#: Phase 19's mesh: the one card named twice.
MESH_ENTRIES = 2
#: Keys of phase 19b's mutex history (phase 6's generator, every 7th
#: key bad: those reach the batched BFS).
MESH_MUTEX_KEYS = 40
#: Phase 5's keys that phase 19b's direct `check_wgl_batched` splits
#: over the mesh: its last 4 bad keys (their beams climb to 512) and 60
#: valid ones.
MESH_BATCHED_KEYS = range(26, 90)
#: Phase 19c's direct sharded BFS: phase 4's history generator at this
#: many ops (~370 BFS levels; phase 4's 2,000 take 1,477, and its
#: sharded run took most of the phase's 20 s).
MESH_BFS_OPS = 500


class ShardSpy:
    """Inside `with`: each keys-split round of ops/wgl_batched.py
    (`_search_shards`), as one list of {device, keys, levels} per shard,
    the levels counted by wrapping `_advance`."""

    def __init__(self):
        self.rounds: list = []

    def __enter__(self):
        from jepsen_tpu_torch.ops import wgl_batched as wb

        self._wb = wb
        self._saved = (wb._advance, wb._search_shards)
        advance, search_shards = self._saved
        levels: dict = {}

        def spy_advance(carry, live, t, *a):
            levels[id(t)] = levels.get(id(t), 0) + 1
            return advance(carry, live, t, *a)

        def spy_search(ts, *a):
            out = search_shards(ts, *a)
            self.rounds.append([{"device": str(t.ret.device),
                                 "keys": int(t.ret.shape[0]),
                                 "levels": levels.pop(id(t), 0)}
                                for t in ts])
            return out

        wb._advance, wb._search_shards = spy_advance, spy_search
        return self

    def __exit__(self, *exc):
        self._wb._advance, self._wb._search_shards = self._saved
        return False

    def shards(self) -> list:
        """Per shard: its device, and its keys and levels summed over
        the rounds."""
        out: list = []
        for rnd in self.rounds:
            for i, sh in enumerate(rnd):
                if i == len(out):
                    out.append({"device": sh["device"], "keys": 0,
                                "levels": 0})
                out[i]["keys"] += sh["keys"]
                out[i]["levels"] += sh["levels"]
        return out


def _verdicts(res: dict) -> dict:
    return {str(k): r["valid"] for k, r in res["results"].items()}


def phase_mesh(torch, elle_graphs: list, dev=None) -> dict:
    """Phase 19 (module doc): 19a the one card's mesh, 19b keys split
    and 19c the frontier-sharded BFS on a mesh that names `dev` (the
    card by default) twice, each verdict held against the same run
    without the mesh.  `elle_graphs` are phase 8's 1,024-vertex graphs.
    Raises on any failed gate."""
    from jepsen_tpu_torch import device as D
    from jepsen_tpu_torch.checker import Linearizable, linearizable
    from jepsen_tpu_torch.checker.elle import DepGraph
    from jepsen_tpu_torch.history.core import Op, history
    from jepsen_tpu_torch.history.packed import pack_history
    from jepsen_tpu_torch.models import cas_register, mutex
    from jepsen_tpu_torch.ops.scc import screen_cycles
    from jepsen_tpu_torch.ops.wgl import check_wgl_device
    from jepsen_tpu_torch.ops.wgl_batched import check_wgl_batched
    from jepsen_tpu_torch.parallel import (IndependentChecker, Mesh,
                                           checker_mesh, clear_settle_memo,
                                           default_mesh, kv, subhistories)
    from jepsen_tpu_torch.utils.histgen import random_register_history

    dev = torch.device("cuda") if dev is None else torch.device(dev)
    t_phase = time.perf_counter()
    out: dict = {}

    # 19a: one card, no mesh.
    if dev.type == "cuda":
        a = {"checker_mesh": repr(checker_mesh({})),
             "default_mesh_size": default_mesh().devices.size,
             "device_count": torch.cuda.device_count()}
        if (checker_mesh({}) is not None and a["device_count"] == 1) or \
                a["default_mesh_size"] != a["device_count"]:
            raise AssertionError(f"phase19a: {a}")
        out["a"] = a
        log("phase19a: " + json.dumps(a))

    keys_mesh = Mesh([dev] * MESH_ENTRIES, ("keys",))
    beam_mesh = Mesh([dev] * MESH_ENTRIES, ("beam",))

    # 19b: keys split over the mesh.
    t0 = time.perf_counter()
    b: dict = {}
    cases = [("mixed", cas_register,
              mixed_history(MIXED_KEYS, MIXED_BAD)),
             ("mutex", mutex,
              keyed_history(mutex_ops, MESH_MUTEX_KEYS, MODEL_OPS,
                            set(range(0, MESH_MUTEX_KEYS, 7)), Op=Op, kv=kv,
                            history=history))]
    for name, make, h in cases:
        chk = IndependentChecker(Linearizable(make(), time_limit_s=120,
                                              device=dev), device=dev)
        runs = {}
        for label, test in (("alone", {}), ("split", {"mesh": keys_mesh})):
            clear_settle_memo()
            with ShardSpy() as spy:
                t1 = time.perf_counter()
                res, launches, _ = counted(torch, dev,
                                           lambda: chk.check(test, h, {}))
                runs[label] = {"wall_s": time.perf_counter() - t1,
                               "valid": res["valid"],
                               "failures": res["failure-count"],
                               "tiers": res.get("tiers"),
                               "b1_launches": launches.get("witness_sweep",
                                                           0),
                               "shards": spy.shards(),
                               "verdicts": _verdicts(res)}
            need_launches(f"phase19b {name} {label}", dev, launches)
        if runs["split"]["verdicts"] != runs["alone"]["verdicts"]:
            raise AssertionError(f"phase19b {name}: per-key verdicts differ "
                                 f"on the mesh")
        if runs["split"]["b1_launches"] != runs["alone"]["b1_launches"]:
            raise AssertionError(f"phase19b {name}: B1 launches "
                                 f"{runs['split']['b1_launches']} on the "
                                 f"mesh, {runs['alone']['b1_launches']} "
                                 f"without")
        for r in runs.values():
            del r["verdicts"]
        b[name] = runs
    if len(b["mutex"]["split"]["shards"]) != MESH_ENTRIES:
        raise AssertionError(f"phase19b: the mutex keys never reached the "
                             f"split batched BFS: {b['mutex']['split']}")

    pm = cas_register().packed()
    subs = subhistories(cases[0][2])
    packs = [pack_history(subs[f"k{i}"], pm.encode)
             for i in MESH_BATCHED_KEYS]
    batched = {}
    for label, mesh in (("alone", None), ("split", keys_mesh)):
        with ShardSpy() as spy:
            t1 = time.perf_counter()
            res, _, counts = counted(torch, dev, lambda: check_wgl_batched(
                packs, pm, beam=32, mesh=mesh, device=dev))
            batched[label] = {"wall_s": time.perf_counter() - t1,
                              "valid": res.valid,
                              "explored": res.explored.tolist(),
                              "levels": counts.get("bfs_levels", 0),
                              "host_syncs": counts.get("host_syncs", 0),
                              "shards": spy.shards()}
    if (batched["split"]["valid"] != batched["alone"]["valid"]
            or batched["split"]["explored"] != batched["alone"]["explored"]
            or batched["split"]["valid"].count(False) != sum(
                1 for i in MESH_BATCHED_KEYS if i < MIXED_BAD)):
        raise AssertionError("phase19b: the split batched BFS differs from "
                             "the unsplit one")
    for r in batched.values():
        r["valid"] = {str(v): r["valid"].count(v)
                      for v in (True, False, "unknown")}
        r["explored"] = sum(r["explored"])
    b["batched"] = batched

    small = random_dep_graphs(SCREEN_GRAPHS, ELLE_SEED, DepGraph)
    screens = {}
    for name, graphs in (("8d", small), ("8a-8c", list(elle_graphs)
                                         + small[:1])):
        flags = {}
        for label, mesh in (("alone", None), ("split", keys_mesh)):
            t1 = time.perf_counter()
            got, _, counts = counted(torch, dev, lambda: screen_cycles(
                graphs, mesh=mesh, device=dev))
            flags[label] = (got.tolist(), time.perf_counter() - t1,
                            counts.get("scc_screens", 0))
        if flags["split"][0] != flags["alone"][0]:
            raise AssertionError(f"phase19b {name}: screen flags differ on "
                                 f"the mesh")
        screens[name] = {"graphs": len(graphs),
                         "cyclic": sum(flags["alone"][0]),
                         "wall_s": {k: v[1] for k, v in flags.items()},
                         "screens": {k: v[2] for k, v in flags.items()}}
    b["screen"] = screens
    b["wall_s"] = time.perf_counter() - t0
    log("phase19b: " + json.dumps(b))
    out["b"] = b

    # 19c: the frontier-sharded BFS (B5).
    t0 = time.perf_counter()
    c: dict = {}
    for name, bad in (("invalid", True), ("valid", False)):
        h = random_register_history(2000, procs=8, info_rate=0.0,
                                    seed=BENCH_SEED, bad=bad)
        got = {}
        for label, test in (("alone", {}), ("sharded",
                                             {"search-mesh": beam_mesh})):
            res = linearizable(cas_register(), device=dev).check(test, h, {})
            got[label] = {"valid": res["valid"],
                          "algorithm": res.get("algorithm"),
                          "explored": res.get("configs-explored")}
        if got["sharded"] != got["alone"] or got["alone"]["valid"] is bad \
                or not got["sharded"]["explored"]:
            raise AssertionError(f"phase19c {name}: {got}")
        c[name] = got
    packed = pack_history(random_register_history(
        MESH_BFS_OPS, procs=8, info_rate=0.0, seed=BENCH_SEED, bad=True),
        pm.encode)
    bfs = {}
    for label, mesh in (("alone", None), ("sharded", beam_mesh)):
        t1 = time.perf_counter()
        res, launches, counts = counted(torch, dev, lambda: check_wgl_device(
            packed, pm, time_limit_s=300, mesh=mesh, device=dev))
        bfs[label] = {"valid": res.valid, "explored": res.configs_explored,
                      "levels": counts.get("bfs_levels", 0),
                      "host_syncs": counts.get("host_syncs", 0),
                      "b1_launches": launches.get("witness_sweep", 0),
                      "wall_s": time.perf_counter() - t1}
        need_launches(f"phase19c {label}", dev, launches)
    if (bfs["sharded"]["valid"] is not False or not bfs["sharded"]["levels"]
            or any(bfs["sharded"][k] != bfs["alone"][k]
                   for k in ("valid", "explored", "levels"))):
        raise AssertionError(f"phase19c: sharded BFS {bfs}")
    c["bfs"] = bfs
    c["wall_s"] = time.perf_counter() - t0
    log("phase19c: " + json.dumps(c))
    out["c"] = c
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        raise AssertionError("phase19: a process group is up")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase19: {out['wall_s']:.3f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 20: the robustness layer and the differential soak on the card.
# ---------------------------------------------------------------------------

#: 20b: tools/port_soak.py's fuzz schedule, one round from this seed
#: base (each family's CI sizes and its extra ones, one valid and one
#: corrupt history each, size rank by size rank), the wall cap checked
#: between histories, and each history's budgets: the exact CPU engine
#: at a CI size and at an extra one (three times as long, the soak
#: tool's ratio), and the device check (the soak tool's own are 20 s,
#: 60 s and 60 s; a history either side leaves unknown is skipped).
#: Fixed, so every run on the card repeats the same histories.
SOAK_SEED_BASE = 20_000
SOAK_CAP_S = 40.0
SOAK_CPU_BUDGETS_S, SOAK_DEVICE_BUDGET_S = (2.0, 6.0), 5.0
#: 20b's floors: decided verdicts of each kind and decided histories of
#: each family.  The cas-register family's largest size (2,600 ops in
#: the generator) must be decided at least once.
SOAK_MIN_VERDICTS, SOAK_MIN_FAMILY = 3, 2
#: 20c's batch: its rng seed and seed base.  This one is an 8-key
#: cas-register batch that plants a violation in key 4, one of the three
#: keys the transfer modes check, so the gates hold the stream and the
#: witness to an invalid key as well as to valid ones.
SOAK_R5_SEED = 20_002


def _tools():
    """tools/'s port scripts, importable."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
    if d not in sys.path:
        sys.path.insert(0, d)
    import port_fault_matrix
    import port_soak

    return port_fault_matrix, port_soak


def phase_soak(torch, dev=None) -> dict:
    """Phase 20 (module doc): 20a two cells of the port's fault matrix
    on `dev`, 20b the fuzz soak's fixed schedule against the exact CPU
    engine, 20c one round-5 batch and its transfer-mode check."""
    import tempfile

    fm, soak = _tools()
    dev = torch.device("cuda") if dev is None else torch.device(dev)
    out: dict = {}
    t_phase = time.perf_counter()

    t0 = time.perf_counter()
    a: dict = {}
    with tempfile.TemporaryDirectory(prefix="phase20-") as tmp:
        for name in ("wgl-fault", "hanging-checker"):
            t1 = time.perf_counter()
            detail, launches, _ = counted(torch, dev, lambda: fm.SCENARIOS[
                name](os.path.join(tmp, name, "store"), dev.type))
            a[name] = {**detail, "b1_launches": launches.get(
                "witness_sweep", 0), "wall_s": time.perf_counter() - t1}
    if (a["wgl-fault"]["all"]["raised"] != "CardExhausted"
            or a["wgl-fault"]["degraded_tiers"] != ["witness"]
            or (dev.type == "cuda"
                and a["wgl-fault"]["all"]["probe_ok"] is not True)):
        raise AssertionError(f"phase20a: {a}")
    a["wall_s"] = time.perf_counter() - t0
    log("phase20a: " + json.dumps(a, default=repr))
    out["a"] = a

    t0 = time.perf_counter()
    schedule = soak.fuzz_schedule(SOAK_SEED_BASE, 1)
    tally, launches, _ = counted(torch, dev, lambda: soak.run_trials(
        schedule, dev.type, time.monotonic() + SOAK_CAP_S,
        cpu_budgets_s=SOAK_CPU_BUDGETS_S,
        device_budget_s=SOAK_DEVICE_BUDGET_S))
    b = {**tally.summary(), "scheduled": len(schedule),
         "b1_launches": launches.get("witness_sweep", 0),
         "cap_s": SOAK_CAP_S, "wall_s": time.perf_counter() - t0}
    log("phase20b: " + json.dumps(b))
    families = [c[0] for c in soak.CONFIGS]
    short = [f for f in families
             if b["decided_per_family"].get(f, 0) < SOAK_MIN_FAMILY]
    largest = f"cas-register/{max(soak.sizes_of('cas-register'))}"
    if (tally.mismatches or b["decided_true"] < SOAK_MIN_VERDICTS
            or b["decided_false"] < SOAK_MIN_VERDICTS or short
            or b["decided_per_config"].get(largest, 0) < 1):
        raise AssertionError(f"phase20b: mismatches {tally.mismatches}, "
                             f"families under {SOAK_MIN_FAMILY}: {short}, "
                             f"{b}")
    need_launches("phase20b", dev, launches)
    out["b"] = b

    t0 = time.perf_counter()
    c, launches, _ = counted(torch, dev, lambda: soak.round5_batch(
        random.Random(SOAK_R5_SEED), SOAK_R5_SEED, 1, dev.type))
    c["b1_launches"] = launches.get("witness_sweep", 0)
    c["wall_s"] = time.perf_counter() - t0
    log("phase20c: " + json.dumps(c))
    if (c["mismatches"] or not c["keys"] or not c["modes_checked"]
            or c["bad_planted"] < 1
            or c["bad_convicted"] != c["bad_planted"]):
        raise AssertionError(f"phase20c: {c}")
    need_launches("phase20c", dev, launches)
    out["c"] = c
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase20: {out['wall_s']:.3f} s")
    return out


class Stages:
    """The script's wall seconds by stage, for its time budget: each
    call closes the stage it names, logs it and keeps it in
    `seconds`."""

    def __init__(self):
        self.t, self.seconds = time.perf_counter(), {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now
        log(f"stage {name}: {self.seconds[name]:.3f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from jepsen_tpu_torch.history.packed import pack_history
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import kernels
    from jepsen_tpu_torch.ops.wgl_witness import plan_width
    from jepsen_tpu_torch.utils.histgen import random_register_history

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}); nvidia-smi: {smi}")

    stage = Stages()
    t0 = time.perf_counter()
    kernels.sweep_lib()
    log(f"build: {time.perf_counter() - t0:.3f} s")
    stage("build")
    for line in kernels.build_log.strip().splitlines():
        log(f"build[witness_sweep]: {line}")

    t0 = time.perf_counter()
    history = random_register_history(BENCH_OPS, procs=BENCH_PROCS,
                                      info_rate=BENCH_INFO, seed=BENCH_SEED)
    t_gen = time.perf_counter() - t0
    pm = cas_register().packed()
    t0 = time.perf_counter()
    packed = pack_history(history, pm.encode)
    t_pack = time.perf_counter() - t0
    W = plan_width(packed)
    log(f"bench history: {packed.n} packed ops ({packed.n_ok} ok), "
        f"generate {t_gen:.3f} s, pack {t_pack:.3f} s, window W={W}")

    entry, timings = phase_kernel(torch, packed, pm, W, seed=BENCH_SEED)
    stage("1")
    main_r = phase_main(torch, history, packed.n)
    stage("2")
    entry["launches"] = main_r["sweep_launches"]

    # The many-key path, then phase 1b on the sweep calls it recorded;
    # all before the profiler first runs (phase 3).
    recorder = SweepRecorder()
    mixed_r = phase_mixed(torch, recorder)
    stage("5")
    models_r = phase_models(torch, recorder)
    stage("6")
    online_r = phase_online(torch, pm, packed, history)
    stage("7")
    elle_r = phase_elle(torch)
    stage("8")
    plan_r = phase_plan(torch, history)
    stage("9")
    daemon_r = phase_daemon(torch)
    stage("10")
    import atexit
    import shutil
    import tempfile

    # Phase 11's stores stay for phase 17d's `jepsen serve`.
    run_root = tempfile.mkdtemp(prefix="phase11-")
    atexit.register(shutil.rmtree, run_root, True)
    run_r = phase_run(torch, root=run_root)
    stage("11")
    entry["launches_online"] = {
        "carry": online_r["carry"]["sweep_launches"],
        "scale": online_r["scale"]["sweep_launches"],
        "live": online_r["live"]["sweep_launches"],
        "keyed": online_r["keyed"]["session_launches"],
        "rolling": online_r["rolling"]["discard"]["sweep_launches"],
    }
    launches = dict(mixed_r["mixed"]["launches"])
    for r in models_r.values():
        launches.update(r["launches"])
    more = phase_instantiations(torch, recorder, seed=BENCH_SEED)
    wide, wide_r = phase_wide(torch, packed)
    groups, groups_r = phase_groups(torch, packed)
    batched = phase_batched(torch, recorder)
    stage("1b")
    packing_r = phase_packing(torch, history, recorder)
    stage("12")
    workloads_r = phase_workloads(torch)
    stage("13")
    suites_r = phase_suites(torch)
    stage("14")
    transfer_r = phase_transfer(torch, packed, pm)
    entry["launches_transfer"] = {
        m: r["launches"] for m, r in transfer_r["modes"].items()}
    stage("18a")
    lint_r = phase_lint(os.path.dirname(os.path.abspath(__file__)))
    stage("18b")
    ptxas = ptxas_report(kernels.build_log)
    for key, n in sass_instructions(kernels.sweep_lib()._name).items():
        ptxas.setdefault(key, {})["sass_instructions"] = n
    stage("ptxas, sass")
    for e in more:
        e["launches"] = launches.get(e["name"], 0)
        if e["launches"] <= 0:
            raise AssertionError(f"{e['name']}: no launch on its path")
        model_id = next(m for m, (n, _) in kernels.SWEEP_MODELS.items()
                        if e["name"].startswith(f"witness_sweep[{n}"))
        bucket = 1 << max(0, e["sw"] - 1).bit_length()
        if model_id == 3:  # the multi-register's state buckets
            bucket = max(2, bucket)
        stream = int(e["name"].endswith("+stream]"))
        e["ptxas"] = {f"NW{nw}": ptxas.get(f"{model_id},{bucket},{nw},"
                                           f"{stream}")
                      for nw in (3, 9)}
    for e in wide:
        e["ptxas"] = ({"NW9": ptxas.get("1,1,9,0"),
                       "combine": ptxas.get("combine")}
                      if e["name"] == "witness_sweep[beam>32]"
                      else {"wide": ptxas.get(
                          f"wide,{int(e['name'].endswith('+stream]'))}")})
    for e in groups:
        e["ptxas"] = ({"NW9": ptxas.get("1,1,9,0"),
                       "combine": ptxas.get("combine")}
                      if e["name"] == "witness_sweep[join]"
                      else {"wide": ptxas.get("wide,0")})
    more += wide + groups
    entry["launches_run"] = {k: run_r[k]["sweeps"] for k in "abcd"}
    for key, rep in sorted(ptxas.items()):
        log(f"ptxas: witness_sweep_kernel<MODEL,SW,NW,STREAM>=<{key}>: "
            f"{json.dumps(rep)}")

    phase_profile(torch, entry, timings)
    stage("3 sweep")
    for e in more:
        seen = profile_device(torch, e.pop("_kernel"), reps=INSTANCE_REPS)
        n, _ = next(v for k, v in seen.items() if "witness_sweep" in k)
        # A beam past 32 lanes is the sweep's launch and the join's.
        us = sum(t for k, (_, t) in seen.items()
                 if "witness_sweep" in k or "combine_groups" in k)
        e["device_ms"] = us / n / 1e3
        log(f"profile: {e['name']}: kernel device time "
            f"{e['device_ms']:.6f} ms ({e['device_ms'] * 1e6 / e['barriers_timed']:.4f}"
            f" ns/barrier)")
    for model_name, b in batched.items():
        call = b.pop("_call")
        if BATCHED_PROFILED not in model_name:
            continue
        # Phase 1b ran each call twice already: no warm-up here.
        seen = profile_device(torch, call, reps=1, warm=False)
        b["device_ms"] = sum(us for _, us in seen.values()) / 1e3
        b["device_ops"] = sum(n for n, _ in seen.values())
        log(f"profile: batched BFS {model_name}: {b['levels']} levels, device "
            f"time {b['device_ms']:.3f} ms in {b['device_ops']} device "
            f"operations, wall {b['wall_s']:.3f} s")
    stage("3 instantiations, batched")
    programs = elle_programs(torch, elle_r)
    stage("3 elle")
    main_r["breakdown"] = breakdown(torch, history)
    stage("3 breakdown")
    log("profile: main path breakdown " + json.dumps(main_r["breakdown"]))
    bad_r = phase_invalid(torch)
    programs.append(packed_bfs_entry(bad_r))
    stage("4")
    # Last: phase 15 reads no device time, and phase 3's profiler
    # windows lost more records after its runs (PERF.md §7).
    search_r = phase_search(torch)
    entry["launches_search"] = search_r["a"]["sweeps"]
    stage("15")
    from jepsen_tpu_torch.nemesis.selfchaos import ChaosFleet

    # 16d's router and daemons, kept up for phase 17c.
    chaos_dir = tempfile.mkdtemp(prefix="chaos-")
    chaos = ChaosFleet(2, chaos_dir, metrics=True, device="cuda")
    try:
        remote_r = phase_remote(torch, fleet=chaos)
        entry["launches_remote"] = {
            "ssh": remote_r["a"]["sweeps"],
            "failover_survivor": remote_r["c"]["failover"]["survivor_sweeps"],
            "journal_restart": remote_r["c"]["restart"]["sweeps"],
            "stream": remote_r["c"]["stream"]["sweeps"],
            "chaos": remote_r["d"]["sweeps_by_daemon"]}
        stage("16")
        standing_r = phase_standing(torch, run_r["stored"], chaos=chaos)
    finally:
        chaos.stop()
        left = _close_dir(chaos_dir)
    if left:
        raise AssertionError(f"phases 16-17: processes left running: {left}")
    entry["launches_standing"] = {
        "monitor": standing_r["a"]["sweeps"],
        "live_resumed": standing_r["b"]["sweeps"],
        "tenants": {t: r["sweeps"]
                    for t, r in standing_r["c"]["tenants"].items()},
        "surviving_daemon": standing_r["c"]["daemon1_sweeps"]}
    stage("17")
    mesh_r = phase_mesh(torch, list(elle_r["graphs"].values()))
    stage("19")
    soak_r = phase_soak(torch)
    entry["launches_soak"] = {k: soak_r[k]["b1_launches"] for k in "bc"}
    stage("20")

    log(f"phase4 done; main path {main_r['ops_per_s']:.1f} ops/s, "
        f"invalid path {bad_r['wall_s']:.3f} s; many-key mixed "
        f"{mixed_r['mixed']['ops_per_s']:.1f} ops/s, all-valid "
        f"{mixed_r['all_valid']['ops_per_s']:.1f} ops/s; online "
        f"{online_r['scale']['ops']} ops, verdict lag "
        f"{online_r['scale']['verdict_lag_s']:.3f} s, lag_fraction "
        f"{online_r['scale']['lag_fraction']:.4f}; Elle phase 8 "
        f"{elle_r['wall_s']:.3f} s; plan route on/off median "
        f"{plan_r['single']['median_s']['on']:.4f} / "
        f"{plan_r['single']['median_s']['off']:.4f} s; checkerd phase 10 "
        f"{daemon_r['wall_s']:.3f} s (cohort check "
        f"{daemon_r['10a']['cohort_check_s']:.4f} s, overhead "
        f"{daemon_r['10a']['overhead_fraction']:.4f}); wide phase 1b beam "
        f"{wide_r['beam']['bench_valid']}, beam {GROUP_BEAM_CHECK} "
        f"{groups_r['beam']['bench_valid']}; run phase 11 "
        f"{run_r['wall_s']:.3f} s (11a {run_r['a']['ops_per_s']:.1f} ops/s, "
        f"analyze {run_r['a']['analyze_s']:.3f} s); packing phase 12 "
        f"{packing_r['wall_s']:.3f} s (resume "
        f"{packing_r['resume']['resumed']['wall_s']:.3f} s of fresh "
        f"{packing_r['resume']['fresh']['wall_s']:.3f} s); workloads "
        f"phase 13 {workloads_r['wall_s']:.3f} s (13d "
        f"{workloads_r['d']['vertices']} vertices, route "
        f"{workloads_r['d']['route']}); suites phase 14 "
        f"{suites_r['wall_s']:.3f} s; search phase 15 "
        f"{search_r['wall_s']:.3f} s; remote phase 16 "
        f"{remote_r['wall_s']:.3f} s; standing phase 17 "
        f"{standing_r['wall_s']:.3f} s (17a "
        f"{standing_r['a']['rate_measured']:.1f} ops/s, verdict lag p95 "
        f"{standing_r['a']['verdict_lag_s']['p95']}); transfer phase 18a "
        f"median s " + ", ".join(
            f"{m} {r['median_s']:.4f}"
            for m, r in transfer_r["modes"].items())
        + f"; lint phase 18b {lint_r['duration_s']} s over "
        f"{lint_r['files']} files; mesh phase 19 "
        f"{mesh_r['wall_s']:.3f} s; soak phase 20 "
        f"{soak_r['wall_s']:.3f} s (20b {soak_r['b']['trials']} trials, "
        f"{soak_r['b']['mismatches']} mismatches)")
    print(json.dumps({"stages_s": stage.seconds}))
    print(json.dumps({"soak": soak_r}, default=repr))
    print(json.dumps({"mesh": mesh_r}))
    print(json.dumps({"transfer": transfer_r, "lint": lint_r}))
    print(json.dumps({"standing": standing_r}))
    print(json.dumps({"federation": remote_r}))
    print(json.dumps({"search": search_r}))
    print(json.dumps({"suites": suites_r}))
    print(json.dumps({"workloads": workloads_r}))
    print(json.dumps({"device_programs": programs}))
    print(json.dumps({"kernels": [entry] + more}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
