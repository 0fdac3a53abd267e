"""The demo systems under test: five small C++ servers, each built to
exhibit one canonical distributed-systems bug class for the framework
to convict (SURVEY.md §2.5's per-database-suite role):

* ``kvdb.cpp``  — single-node KV store; ``--buffer`` holds acked
  writes in process memory, so kill -9 loses them (durability).
* ``repkv.cpp`` — primary/backup replication with JOIN/LEAVE
  membership; async replication serves stale backup reads under
  partitions (replication).
* ``logd.cpp``  — kafka-shaped partitioned log; ``--flush-ms``
  write-behind loses acked records on SIGKILL (logs).
* ``txnd.cpp``  — MVCC snapshot isolation; first-committer-wins
  admits textbook write skew (transactions).
* ``electd.cpp`` — bully-style leader election with no fencing;
  partitions split-brain it and heal discards one side's acked
  writes (election / lost updates); ``--quorum`` swaps in ABD
  majority rounds as the linearizable control group.

The port's copy of `jepsen_tpu/demo/__init__.py`, with the five sources
copied byte for byte.  Shipped as package data so the suites
(jepsen_tpu_torch/suites/) can upload and compile them on nodes from
any install, not just a repo checkout; each suite's DB.setup compiles
its server with g++ on the node, the way the reference compiles C
helpers there (nemesis/time.clj:21-40).
"""

import os


def source(name: str) -> str:
    """Absolute path of a demo server's source file, e.g.
    source("kvdb") -> .../jepsen_tpu_torch/demo/kvdb.cpp."""
    path = os.path.join(os.path.dirname(__file__), f"{name}.cpp")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no demo source {name!r} at {path}")
    return path
