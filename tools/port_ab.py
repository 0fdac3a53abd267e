"""A/B of the PyTorch/CUDA port's main path and many-key path between
two trees, on one card.

    python3 tools/port_ab.py TREE_DIR

TREE_DIR is the root of a checkout (for instance a `git archive` of a
commit unpacked under build/).  The script imports that tree's
`chip_smoke.py` and package, builds its kernel, times the history
generator (code both trees share: a reading of the host's speed), times
the tree's `pack_history` on phase 2's history (5 runs, a fresh encoder
each), then runs chip_smoke's phase 2 (the 100k-op main path, median of
3) and phase 5 (run_mixed's 200 keys and the 2,000 all-valid keys), and
prints one line "AB {json}".  Run it for parent, change, change, parent
in one call of the card to compare two commits.

Where the tree has `PackedBuilder`, it also times the builder's two
pairings on the same ops, in ns per op: `append` one op at a time, and
the numpy `append_many` (its scalar fallback off) in chunks of 1 to
2,048 ops — the reading behind `PackedBuilder._MANY_MIN`.
"""
import json
import sys
import time

sys.path.insert(0, sys.argv[1])
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from jepsen_tpu_torch.history.packed import pack_history  # noqa: E402
from jepsen_tpu_torch.models import cas_register  # noqa: E402
from jepsen_tpu_torch.ops import kernels  # noqa: E402
from jepsen_tpu_torch.utils.histgen import random_register_history  # noqa: E402

kernels.sweep_lib()
t0 = time.perf_counter()
h = random_register_history(100_000, procs=16, info_rate=0.05, seed=45100)
t_gen = time.perf_counter() - t0
pack_s = []
for _ in range(5):
    t0 = time.perf_counter()
    packed = pack_history(h, cas_register().packed().encode)
    pack_s.append(time.perf_counter() - t0)


def builder_ns_per_op():
    from jepsen_tpu_torch.history import packed as packed_mod

    PB = getattr(packed_mod, "PackedBuilder", None)
    if PB is None:
        return None
    ops = list(h)
    out = {}
    b = PB(cas_register().packed().encode)
    t0 = time.perf_counter()
    for o in ops:
        b.append(o)
    b.finish()
    out["append"] = (time.perf_counter() - t0) / len(ops) * 1e9
    saved = PB._MANY_MIN
    PB._MANY_MIN = 0
    try:
        for c in (1, 2, 4, 8, 16, 32, 64, 256, 2048):
            b = PB(cas_register().packed().encode)
            t0 = time.perf_counter()
            for i in range(0, len(ops), c):
                b.append_many(ops[i:i + c])
            b.finish()
            out[f"append_many[{c}]"] = ((time.perf_counter() - t0)
                                        / len(ops) * 1e9)
    finally:
        PB._MANY_MIN = saved
    return out


builder = builder_ns_per_op()
main = cs.phase_main(torch, h, packed.n)
mixed = cs.phase_mixed(torch, cs.SweepRecorder())
print("AB " + json.dumps({
    "tree": sys.argv[1], "generate_s": t_gen,
    "pack_s": pack_s, "pack_median_s": sorted(pack_s)[2],
    "builder_ns_per_op": builder,
    "main_wall_s": main["wall_s"], "main_median_s": main["median_s"],
    "main_counts": [main["sweep_launches_per_check"],
                    main["heavy_rounds_per_check"],
                    main["host_syncs_per_check"]],
    "mixed_wall_s": mixed["mixed"]["wall_s"],
    "mixed_median_s": mixed["mixed"]["median_s"],
    "all_valid_median_s": mixed["all_valid"]["median_s"]}), flush=True)
