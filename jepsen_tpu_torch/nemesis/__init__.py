"""Fault injection: the Nemesis protocol, its combinators and the
durable fault ledger.

The port's copy of `jepsen_tpu/nemesis/__init__.py`, trimmed to what a
run's lifecycle opens and reads: `nemesis.core` and `nemesis.ledger`.
"""

from . import ledger
from .core import (Compose, FMap, Nemesis, NemesisTeardownError,
                   NoopNemesis, Timeout, compose, f_map, noop, timeout)

__all__ = ["Compose", "FMap", "Nemesis", "NemesisTeardownError",
           "NoopNemesis", "Timeout", "compose", "f_map", "ledger", "noop",
           "timeout"]
