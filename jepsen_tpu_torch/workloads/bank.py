"""Bank workload: transfers with a conserved total.

The port's copy of `jepsen_tpu/workloads/bank.py` (jepsen's
tests/bank.clj): the
generator mixes reads of all accounts with random transfers (:40-54),
and the checker (:56-120) asserts every read shows the same total and
(unless negative balances are allowed) no account below zero — the
classic snapshot-isolation probe.  The checker is host code.
"""

from __future__ import annotations

import random
import threading
from typing import Any, Optional

from .. import client as jc
from ..checker.core import Checker
from ..generator.core import FnGen, mix
from ..history import FAIL, OK, History


DEFAULT_ACCOUNTS = list(range(8))
DEFAULT_TOTAL = 100


class BankChecker(Checker):
    """tests/bank.clj:56-120."""

    def __init__(self, *, negative_balances: bool = False):
        self.negative_balances = negative_balances

    def check(self, test: dict, history: History, opts: dict) -> dict:
        total = test.get("total-amount", DEFAULT_TOTAL)
        accounts = set(test.get("accounts", DEFAULT_ACCOUNTS))
        bad_reads = []
        reads = 0
        for op in history:
            if not (op.is_ok and op.f == "read") or op.value is None:
                continue
            reads += 1
            balances = {int(k): v for k, v in dict(op.value).items()}
            problems = []
            if set(balances.keys()) != accounts:
                problems.append("unexpected-accounts")
            got = sum(balances.values())
            if got != total:
                problems.append(f"wrong-total {got}")
            if not self.negative_balances and any(
                v < 0 for v in balances.values()
            ):
                problems.append("negative-balance")
            if problems:
                bad_reads.append(
                    {"op": op.index, "problems": problems, "value": balances}
                )
        return {
            "valid": not bad_reads,
            "read-count": reads,
            "bad-reads": bad_reads[:16],
            "bad-read-count": len(bad_reads),
        }


class InMemoryBankClient(jc.Client):
    """Atomic in-memory ledger."""

    def __init__(self, state=None, lock=None, accounts=None, total=DEFAULT_TOTAL):
        if state is None:
            accounts = accounts or DEFAULT_ACCOUNTS
            state = {a: 0 for a in accounts}
            state[accounts[0]] = total
        self.state = state
        self.lock = lock or threading.Lock()

    def open(self, test, node):
        return InMemoryBankClient(self.state, self.lock)

    def invoke(self, test, op):
        with self.lock:
            if op.f == "read":
                return op.complete(OK, value=dict(self.state))
            t = op.value
            frm, to, amount = t["from"], t["to"], t["amount"]
            if self.state.get(frm, 0) < amount:
                return op.complete(FAIL, error="insufficient funds")
            self.state[frm] -= amount
            self.state[to] += amount
            return op.complete(OK)

    def reusable(self, test):
        return True


def generator(accounts=None, max_transfer: int = 5, rng: Optional[random.Random] = None):
    """Mix of reads and random transfers (tests/bank.clj:40-54)."""
    accounts = accounts or DEFAULT_ACCOUNTS
    rng = rng or random.Random()

    def transfer():
        a, b = rng.sample(accounts, 2)
        return {
            "f": "transfer",
            "value": {
                "from": a,
                "to": b,
                "amount": 1 + rng.randrange(max_transfer),
            },
        }

    return mix([FnGen(lambda: {"f": "read"}), FnGen(transfer)])


def workload(opts: Optional[dict] = None) -> dict:
    opts = opts or {}
    accounts = opts.get("accounts", DEFAULT_ACCOUNTS)
    total = opts.get("total-amount", DEFAULT_TOTAL)
    return {
        "name": "bank",
        "accounts": accounts,
        "total-amount": total,
        "generator": generator(
            accounts,
            opts.get("max-transfer", 5),
            random.Random(opts.get("seed")),
        ),
        "checker": BankChecker(
            negative_balances=opts.get("negative-balances", False)
        ),
        "client": InMemoryBankClient(accounts=accounts, total=total),
    }
