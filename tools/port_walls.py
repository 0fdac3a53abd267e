"""Normalizes chip_smoke.py's stage walls to a reference run's host.

    python3 tools/port_walls.py REF.out RUN.out [RUN.out ...] \
        [--changed 7,9,11,13,15,16,17] [--slower 1.24]

Each file is the standard output of one `python3 chip_smoke.py` run: its
`{"stages_s": ...}` line and its "phase4 done; main path N ops/s" line.
Hosts differ between chip calls, so a run's walls compare with another
call's only after scaling by how fast each host ran.  For each run this
prints its stage sum and two estimates of that sum on the reference's
host:

- `by_ops`: scaled by the main path's ops/s (run over reference), one
  reading of one phase;
- `by_stages`: scaled by the host factor of the stages that both runs
  share unchanged (every stage not in `--changed` and present in both):
  the sum of those stages in the run over their sum in the reference.

and each estimate times `--slower`, a host that much slower than the
reference's.
"""

import argparse
import json
import re
import sys


def read_run(path: str) -> tuple:
    stages, ops = None, None
    with open(path, errors="replace") as f:
        for line in f:
            if line.startswith('{"stages_s"'):
                stages = json.loads(line)["stages_s"]
            m = re.search(r"main path ([0-9.]+) ops/s", line)
            if m:
                ops = float(m.group(1))
    if stages is None or ops is None:
        raise SystemExit(f"{path}: no stages line or main-path rate")
    return stages, ops


def normalize(ref: tuple, run: tuple, changed: set, slower: float) -> dict:
    (ref_st, ref_ops), (st, ops) = ref, run
    total = sum(st.values())
    shared = sorted(k for k in st if k in ref_st and k not in changed)
    factor = sum(st[k] for k in shared) / sum(ref_st[k] for k in shared)
    by_ops = total * ops / ref_ops
    by_stages = total / factor
    return {"sum_s": total, "main_ops_s": ops,
            "ops_factor": ref_ops / ops, "stage_factor": factor,
            "shared_stages": shared, "by_ops_s": by_ops,
            "by_stages_s": by_stages,
            "slower_host_s": {"by_ops": by_ops * slower,
                              "by_stages": by_stages * slower}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ref")
    ap.add_argument("runs", nargs="+")
    ap.add_argument("--changed", default="7,9,11,13,15,16,17",
                    help="stages whose work differs from the reference's")
    ap.add_argument("--slower", type=float, default=1.24)
    args = ap.parse_args(argv)
    changed = {s.strip() for s in args.changed.split(",") if s.strip()}
    ref = read_run(args.ref)
    for path in args.runs:
        print(json.dumps({"run": path, **normalize(
            ref, read_run(path), changed, args.slower)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
