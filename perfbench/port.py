"""What the harness reads from the port besides its checkers: the
always-on counters (`device.counters`, `ops.kernels.launches`), the
telemetry spans, the settle memo it empties before every check, and a
wrapper around the sweep kernel's launches that counts the bytes each
launch needs.  Imported only after `run.py` has cleared the port's
environment switches (telemetry reads its own at import)."""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator

from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch import telemetry
from jepsen_tpu_torch.ops import kernels
from jepsen_tpu_torch.parallel import clear_settle_memo

from . import roofline

#: The sweep kernel's launches under `kernels.launches` (its
#: per-instantiation keys are counted beside it).
SWEEP = "witness_sweep"


def clear_memo() -> None:
    """Empties the port's in-memory verdict memo."""
    clear_settle_memo()


def counts() -> dict:
    """A snapshot of the port's counters and kernel launches."""
    return {"counters": dict(_device.counters),
            "launches": kernels.launch_counts()}


def count_delta(before: dict, after: dict) -> dict:
    """The counts between two snapshots."""
    return {part: {k: v - before[part].get(k, 0)
                   for k, v in after[part].items()
                   if v != before[part].get(k, 0)}
            for part in ("counters", "launches")}


def spans_on(on: bool) -> None:
    """Turns the port's telemetry on or off and empties it."""
    telemetry.enable(on)
    telemetry.reset()


def take_spans() -> tuple:
    """(spans, dropped): the spans recorded since the last call, as
    (thread, start_us, end_us, name) on telemetry's clock, and how many
    the port's buffer dropped; empties the buffer."""
    trace = telemetry.chrome_trace()
    dropped = telemetry.summary()["trace_events_dropped"]
    telemetry.reset()
    spans = [(e["tid"], e["ts"], e["ts"] + e["dur"], e["name"])
             for e in trace["traceEvents"] if e.get("ph") == "X"]
    return spans, dropped


#: A span of the harness's own, on the port's telemetry clock.
span = telemetry.span


@contextmanager
def counting_sweep_bytes() -> Iterator[dict]:
    """While entered, every launch of the sweep kernel also adds the
    bytes it needs (`roofline.launch_bytes`) to the yielded dict's
    "bytes", and one to its "launches".  Reads each launch's death and
    barrier columns back to the host, so it runs in a pass of its own,
    never in a timed or profiled one."""
    real = kernels.witness_sweep
    tally = {"bytes": 0, "launches": 0}

    def counting(model, start_k, bars, member, states, alive, init=None):
        out = real(model, start_k, bars, member, states, alive, init)
        tally["bytes"] += roofline.launch_bytes(
            start_k, int(out[2][0].item()), bars.shape[1], bars[0].tolist(),
            member.shape[1], states.shape[1], init is not None)
        tally["launches"] += 1
        return out

    kernels.witness_sweep = counting
    try:
        yield tally
    finally:
        kernels.witness_sweep = real
