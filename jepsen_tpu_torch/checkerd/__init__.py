"""Checker-as-a-service: a long-lived linearizability-checker daemon.

The port's copy of `jepsen_tpu/checkerd/`, on the CUDA card.  Many
concurrent test runs (CI fleets, continuous verification of a live DB
fleet) share one accelerator instead of each paying its own start-up
and kernel build.  This package is that pool:

  * ``server``    — a TCP daemon owning the card.  One worker thread
                    drains a scheduler queue, merging compatible per-key
                    cohorts from *multiple concurrent runs* into a single
                    pass through the checking plan
                    (parallel/independent.py, plan/), so the stream
                    witness's sweep kernel, the settle memo and the warm
                    card are amortized across runs; `/metrics` serves
                    the Prometheus text with the SLO families.
  * ``protocol``  — the framed wire protocol.  Frames reuse the store's
                    block layout (store/format.py: [len][crc32][type]
                    [payload]); history payloads are op-dict chunks or
                    raw packed-column tensors (history/packed.py
                    packed_to_bytes), byte for byte the reference's, so
                    a client of either package talks to a daemon of
                    either package.
  * ``scheduler`` — the cohort queue: admission, cross-run merge,
                    per-request budgets, fleet stats.
  * ``journal``   — the crash-safe queue journal a restarted daemon
                    replays.
  * ``overload``  — fair queueing, deadline shedding, brownout, circuit
                    breakers.
  * ``client``    — CheckerdClient (submit/poll/stats) and
                    RemoteChecker, the drop-in Checker that ships the
                    work to a daemon and falls back to in-process
                    checking (on the card by default) when the daemon
                    is unreachable.
  * ``router``    — the federation router: one address in front of N
                    daemons, with placement, failover, admission and a
                    ticket journal.

Start one with ``jepsen checkerd`` (any suite CLI) or ``python -m
jepsen_tpu_torch.checkerd``, both on the card (``--device cuda``, the
default), and a router with ``jepsen checkerd-router --daemon ADDR
...``; point runs at either with ``--remote host:port``, `RemoteChecker`
/ `wrap_remote` or the JEPSEN_CHECKERD env var ("host:port").  A daemon
started with no CUDA card raises at start; tests pass ``device="cpu"``.
Not ported: the web pages.
"""

from __future__ import annotations

#: Default TCP port for the daemon (the reference's).
DEFAULT_PORT = 7462

#: Default TCP port for the federation router (`jepsen checkerd-router`,
#: router.py), the reference's.
ROUTER_PORT = 7472

#: Environment variable naming a default daemon address ("host:port").
ADDR_ENV = "JEPSEN_CHECKERD"
