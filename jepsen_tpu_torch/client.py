"""Client protocol: how a test talks to the system under test.

The port's copy of `jepsen_tpu/client.py` (no JAX there either).

Equivalent of jepsen/client.clj: the `Client`
lifecycle protocol (:9-27 — open!/setup!/invoke!/teardown!/close!), the
`Reusable` marker (:29-34), the `Validate` contract-checking wrapper
(:64-109), and the `Timeout` wrapper (:116-148).

A client instance is bound to one node and (at any moment) one logical
process.  `open` is a factory: given the prototype client from the test
map, produce a fresh connected instance.  The interpreter re-opens
clients whenever a process crashes (interpreter.clj:36-70) unless the
client is `reusable`.
"""

from __future__ import annotations

from typing import Any, Optional

from .history import FAIL, INFO, INVOKE, OK, Op
from .utils import JepsenTimeout, timeout as run_timeout


class Client:
    """DB client lifecycle (client.clj:9-27).

    Subclasses override some or all of: `open` returns a connected copy
    for `node`; `setup` installs any schema/state (once per node, by the
    orchestrator); `invoke` applies an op and returns its completion;
    `teardown` undoes setup; `close` releases the connection."""

    def open(self, test: dict, node: Any) -> "Client":
        return self

    def setup(self, test: dict) -> None:
        pass

    def invoke(self, test: dict, op: Op) -> Op:
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        pass

    def close(self, test: dict) -> None:
        pass

    def reusable(self, test: dict) -> bool:
        """When true, the interpreter keeps this client across process
        crashes instead of close+open (client.clj:29-34)."""
        return False


class NoopClient(Client):
    """Does nothing, successfully (client.clj:157-161)."""

    def invoke(self, test: dict, op: Op) -> Op:
        return op.complete(OK)

    def reusable(self, test: dict) -> bool:
        return True


noop = NoopClient()


class ValidationError(Exception):
    pass


class Validate(Client):
    """Wraps a client, checking the protocol contract at runtime
    (client.clj:64-109): invoke must return an Op whose type is
    ok/fail/info and whose process and f match the invocation."""

    def __init__(self, client: Client):
        self.client = client

    def open(self, test: dict, node: Any) -> "Validate":
        inner = self.client.open(test, node)
        if inner is None:
            raise ValidationError(
                f"client open returned None instead of a Client "
                f"(from {self.client!r})"
            )
        return Validate(inner)

    def setup(self, test: dict) -> None:
        self.client.setup(test)

    def invoke(self, test: dict, op: Op) -> Op:
        op2 = self.client.invoke(test, op)
        if not isinstance(op2, Op):
            raise ValidationError(
                f"invoke returned {op2!r}, not an Op, for {op!r}"
            )
        problems = []
        if op2.type not in (OK, FAIL, INFO):
            problems.append(f"type must be ok/fail/info, not {op2.type!r}")
        if op2.process != op.process:
            problems.append(
                f"process changed from {op.process!r} to {op2.process!r}"
            )
        if op2.f != op.f:
            problems.append(f"f changed from {op.f!r} to {op2.f!r}")
        if problems:
            raise ValidationError(
                f"invoke of {op!r} returned invalid completion {op2!r}: "
                + "; ".join(problems)
            )
        return op2

    def teardown(self, test: dict) -> None:
        self.client.teardown(test)

    def close(self, test: dict) -> None:
        self.client.close(test)

    def reusable(self, test: dict) -> bool:
        return self.client.reusable(test)


class Timeout(Client):
    """Wraps a client so invocations time out after `ms` milliseconds,
    completing as indeterminate :info ops (client.clj:116-148).  The
    timed-out call keeps running in its daemon thread — same caveat as
    the reference's `util/timeout`."""

    def __init__(self, ms: float, client: Client):
        self.ms = ms
        self.client = client

    def open(self, test: dict, node: Any) -> "Timeout":
        return Timeout(self.ms, self.client.open(test, node))

    def setup(self, test: dict) -> None:
        self.client.setup(test)

    def invoke(self, test: dict, op: Op) -> Op:
        try:
            return run_timeout(self.ms, lambda: self.client.invoke(test, op))
        except JepsenTimeout:
            return op.complete(INFO, error="timeout")

    def teardown(self, test: dict) -> None:
        self.client.teardown(test)

    def close(self, test: dict) -> None:
        self.client.close(test)

    def reusable(self, test: dict) -> bool:
        return self.client.reusable(test)


def timeout(ms: float, client: Client) -> Timeout:
    return Timeout(ms, client)


def validate(client: Client) -> Validate:
    return Validate(client)


def is_op(value: Any) -> bool:
    return isinstance(value, Op)
