"""The readings the limits of `compare.py` rest on, taken outside the
benchmark's own runs:

    python3 -m perfbench.controls --workload <cell> --seeds <n,n,...> --seconds <s>

runs the cell with the control in the program's place, once a seed,
through the harness's own window and comparison, and prints each run's
compared numbers (one JSON line a seed).  The control is the reference
with one guarantee of the configurations broken: every :info op is
taken as :fail, as if an indeterminate op had surely not happened (the
shortcut that would tempt a faster checker, since :info ops are what
widens the search).  A sound run reads 0 on every number; the control
has to read more than 0 on one of them, or no limit separates the two.

`faults` holds the faults of the timed path that the CPU tests plant
under a run (`perfbench/tests/test_correct.py`).
"""

from __future__ import annotations

import argparse
import json
import sys

from perfbench import manifest, reference
from perfbench import run as harness


def as_failed(records: list) -> list:
    """`records` with every :info completion taken as :fail."""
    return [(k, p, "fail" if t == "info" else t, f, v)
            for k, p, t, f, v in records]


class Control:
    """The control, in an entry's shape."""

    def __init__(self, config: dict):
        self.keyed = bool(config["keyed"])

    def prepare(self, records: list) -> list:
        return as_failed(records)

    def check(self, records: list) -> dict:
        keys = reference.decide_keys(records)
        out = {"valid": all(keys.values())}
        if self.keyed:
            out["keys"] = keys
            out["failure_count"] = sum(not v for v in keys.values())
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.controls")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    harness.clean_env()
    cell = manifest.load(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run(cell, Control(cell.config), seed, args.seconds)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "compared": out["compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
