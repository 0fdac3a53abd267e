"""Checking-plan IR: compile histories to pass DAGs, execute them once.

The port's copy of `jepsen_tpu/plan/`.  The checker tiers (witness,
stream, batched BFS, frontier BFS, exact CPU settle, the refutation
screens, the Elle cycle pass) are registered as pass families, and
the checkers compile a plan — a small forward DAG of pass nodes with
typed fallback edges — and run it through one executor:

  * `ir.py`        — `PassFamily` declarations and `PassNode`/`Plan`
  * `compiler.py`  — packed cohort + model + budget -> `Plan`
  * `executor.py`  — runs any plan: work queues node to node, the
                     digest-dedup scope of the settle memo
  * `costmodel.py` — knob choice: a ridge regressor fitted on the
                     profile store when a model file is given
                     (`JEPSEN_COSTMODEL`), else the hand heuristics, which
                     are the hand-wired ladder's formulas
  * `cache.py`     — the persistent plan memo, a journal of settled
                     verdicts that a restarted process replays

The plan is the port's only route for the linearizable checkers.
`JEPSEN_PLAN=0`, which sends the reference back to its hand-wired
ladder, here turns off what that ladder lacks: the trained cost model
(every chooser returns its hand formula) and the persistent memo; the
checks still compile and execute a plan, which does the same work.  The
memo is on disk only when `JEPSEN_PLAN_CACHE=<dir>` (or
`cache.configure`) names a directory.  Both variables are the
reference's names, so one setting steers both packages.
"""

from __future__ import annotations

import os

#: "0"/"false"/"off" turns the cost model and the persistent memo off.
PLAN_ENV = "JEPSEN_PLAN"
#: Persistent plan-memo directory; unset means no on-disk state.
CACHE_ENV = "JEPSEN_PLAN_CACHE"


def enabled() -> bool:
    """Whether the plan may use a trained cost model and the persistent
    memo (the reference: whether checking routes through the plan)."""
    return os.environ.get(PLAN_ENV, "1").lower() not in ("0", "false", "off")


from .ir import (  # noqa: E402
    PassFamily,
    PassNode,
    Plan,
    family,
    known_families,
    register_family,
)

__all__ = [
    "CACHE_ENV",
    "PLAN_ENV",
    "Plan",
    "PassFamily",
    "PassNode",
    "enabled",
    "family",
    "known_families",
    "register_family",
]
