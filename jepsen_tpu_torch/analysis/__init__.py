"""jepsenlint for the port: AST-based invariant analysis of its sources.

The port's copy of `jepsen_tpu/analysis/`, aimed at ``jepsen_tpu_torch/``
and ``chip_smoke.py``.  The conventions it checks are the reference's:
every nemesis journals ledger intent before injecting, every checker
routes through ``check_safe`` budgets, every device pass runs under
``profile.capture``, every narrowing cast needs a dominating range
guard (the ``wgl_witness._plan_blocks`` bug class), and the modules
that spawn threads keep a lock discipline.  It imports neither torch
nor the code it analyses: ``python -m jepsen_tpu_torch.analysis`` runs
with the standard library alone.

The analysis is interprocedural: ``effects.py`` builds per-function
effect summaries (locks acquired, journal appends, flush/fsync, frame
sends, ``self`` attribute reads/writes with the held-lock stack,
swallowed exceptions) over a resolved intra-repo call graph, with a
bounded fixpoint for transitive effects — so an append and its fsync,
or a lock and the helper it protects, may live in different functions
or modules and still be matched up.

Four rule families (``rules/``):

  * ``device``      — device hygiene in torch code: unguarded narrowing
    casts (``.astype``, ``.to(torch.int32)``, ``.int()``), host syncs
    per loop iteration inside ``profile.capture``, card passes outside
    ``profile.capture``.  The reference's ``device.host-sync-in-jit``
    and ``device.np-in-jit`` are dropped: the port traces no function
    (no ``torch.compile``, ``torch.jit`` or CUDA graph capture);
  * ``concurrency`` — a cross-module lock-order graph from the effect
    summaries (cycles are errors), checked ``# guarded-by:`` contracts,
    plus the unsynced-thread-attr advice fallback;
  * ``durability``  — the crash-durability protocol at every journal
    site: appends that no function or caller path ever fsyncs,
    replies/sends reachable before the append's fsync, ``_read_block``
    results never None-checked (None IS the torn tail), read-back
    ``.json`` state written without tmp+``os.replace``, and
    ``BLOCK_*``/``F_*`` wire-id collisions;
  * ``protocol``    — framework contracts: ledger intent before
    session mutation, compensator ctypes that exist in the ledger
    registry, telemetry counter names inside the declared namespaces
    (cross-checked against ``FLEET_COUNTER_PREFIXES``), no
    ``check_safe`` bypasses, no swallowed exceptions in teardown.

Infrastructure (``core.py``): a ``Finding`` model with severity,
``# jepsenlint: ignore[rule] -- reason`` suppressions (a reason is
mandatory, and a pragma matching nothing is itself an error), the
committed ``jepsen_tpu_torch/lint_baseline.json`` of accepted findings
with written justifications, JSON + human + SARIF 2.1.0 output
(``--sarif``), and a <10 s whole-tree runtime contract.  Run it as
``jepsen lint`` (any suite's CLI) or ``python -m
jepsen_tpu_torch.analysis``.
"""

from .core import (  # noqa: F401
    Finding,
    LintReport,
    Module,
    baseline_path,
    lint_source,
    load_baseline,
    main,
    render_human,
    render_json,
    run_lint,
    save_baseline,
)
