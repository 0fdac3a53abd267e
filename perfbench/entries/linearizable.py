"""One cas-register key, checked as a Jepsen user checks it: the port's
`Linearizable(cas_register(), "wgl-tpu")` on a new `History` each
check."""

from __future__ import annotations

from jepsen_tpu_torch.checker import Linearizable
from jepsen_tpu_torch.history.core import History, Op
from jepsen_tpu_torch.models import cas_register


class Entry:
    def __init__(self, config: dict, device: str):
        self.checker = Linearizable(cas_register(), "wgl-tpu", device=device)

    def prepare(self, records: list) -> list:
        """The port's ops of a history's records (made at set-up)."""
        return [Op(type=t, f=f, value=v, process=p, time=i, index=i)
                for i, (_, p, t, f, v) in enumerate(records)]

    def check(self, ops: list) -> dict:
        res = self.checker.check({}, History(ops), {})
        return {"valid": res["valid"]}
