"""Fault injection: the Nemesis protocol and stock faults.

The port's copy of `jepsen_tpu/nemesis/__init__.py`, without `search`
(the schedule fuzzer, ROADMAP.md Queue A item 3).  Equivalent of
jepsen/src/jepsen/nemesis.clj plus the nemesis/ subtree (combined
packages, clock faults, membership churn).
"""

from . import ledger
from .core import (
    Compose,
    FMap,
    Nemesis,
    NemesisTeardownError,
    NoopNemesis,
    Partitioner,
    Timeout,
    bisect,
    bridge,
    complete_grudge,
    compose,
    f_map,
    invert_grudge,
    majorities_ring,
    noop,
    partition_halves,
    partition_majorities_ring,
    partition_random_halves,
    partition_random_node,
    partitioner,
    split_one,
    timeout,
)

__all__ = [
    "Compose",
    "FMap",
    "Nemesis",
    "NemesisTeardownError",
    "NoopNemesis",
    "ledger",
    "Partitioner",
    "Timeout",
    "bisect",
    "bridge",
    "complete_grudge",
    "compose",
    "f_map",
    "invert_grudge",
    "majorities_ring",
    "noop",
    "partition_halves",
    "partition_majorities_ring",
    "partition_random_halves",
    "partition_random_node",
    "partitioner",
    "split_one",
    "timeout",
]
