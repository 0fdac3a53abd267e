"""Independent cas-register keys, checked by the checker the port's
north-star workload builds (`workloads/linearizable_register.py
workload()`: `independent_checker(linearizable(cas_register(),
"wgl-tpu"))`), on a new `History` each check."""

from __future__ import annotations

from jepsen_tpu_torch.history.core import History, Op
from jepsen_tpu_torch.parallel import kv
from jepsen_tpu_torch.workloads.linearizable_register import workload


class Entry:
    def __init__(self, config: dict, device: str):
        self.checker = workload({"device": device})["checker"]

    def prepare(self, records: list) -> list:
        """The port's ops of a history's records, each value under its
        key (made at set-up)."""
        return [Op(type=t, f=f, value=kv(k, v), process=p, time=i, index=i)
                for i, (k, p, t, f, v) in enumerate(records)]

    def check(self, ops: list) -> dict:
        res = self.checker.check({}, History(ops), {})
        return {"valid": res["valid"],
                "keys": {k: r["valid"] for k, r in res["results"].items()},
                "failure_count": res["failure-count"]}
