"""The copied generator, the pool and its relabelling."""

import pytest

from perfbench import generate, reference

CONFIG = {"keyed": True, "history": {"ops_per_key": 60, "procs_per_key": 4,
                                     "info_rate": 0.05, "values": 5}}
TRAFFIC = {"keys": 12, "bad_keys": 3, "pool": 3, "base_seed": 45200}


@pytest.mark.parametrize("n,procs,info,seed,bad", [
    (50, 4, 0.05, 0, False), (300, 16, 0.05, 45100, False),
    (200, 3, 0.3, 2**31 + 5, True), (1, 1, 0.0, 7, True)])
def test_register_records_match_the_ports_generator(n, procs, info, seed,
                                                     bad):
    from jepsen_tpu_torch.utils.histgen import random_register_history

    port = [(o.process, o.type, o.f, o.value) for o in
            random_register_history(n, procs=procs, info_rate=info,
                                    n_values=5, seed=seed, bad=bad)]
    ours = [r[1:] for r in generate.register_records(
        n, procs=procs, info_rate=info, n_values=5, seed=seed, bad=bad)]
    assert ours == port


def test_pool_is_a_function_of_the_seed():
    a = generate.pool(CONFIG, TRAFFIC, 2**31 + 17)
    assert a == generate.pool(CONFIG, TRAFFIC, 2**31 + 17)
    assert a != generate.pool(CONFIG, TRAFFIC, 2**31 + 18)


def _shape(records):
    return [(k, t, f) for k, _, t, f, _ in records]


def test_seeds_relabel_one_set_of_shapes():
    """Every seed checks the pool's base histories, in another order,
    with values and processes permuted: the same verdicts key by key."""
    base = [generate.history_records(CONFIG, TRAFFIC, 45200, i)
            for i in range(3)]
    want = [reference.decide_keys(b) for b in base]
    for seed in (1, 2, 2**31 + 3):
        pool = generate.pool(CONFIG, TRAFFIC, seed)
        order = [[_shape(b) for b in base].index(_shape(h)) for h in pool]
        assert sorted(order) == [0, 1, 2]
        assert order in ([0, 1, 2], [1, 2, 0], [2, 0, 1])
        for i, h in zip(order, pool):
            assert h != base[i]
            assert reference.decide_keys(h) == want[i]


def test_relabelling_keeps_the_ports_work():
    """The port's checker does the same work on a relabelled history:
    equal verdicts and equal counts of chain rounds, stream passes and
    restarts (on the CPU, at a small size)."""
    import random

    from jepsen_tpu_torch import device as D
    from jepsen_tpu_torch.history.core import History, Op
    from jepsen_tpu_torch.parallel import clear_settle_memo, kv
    from jepsen_tpu_torch.workloads.linearizable_register import workload

    checker = workload({"device": "cpu"})["checker"]

    def run(records):
        D.counters.clear()
        clear_settle_memo()
        res = checker.check({}, History([
            Op(type=t, f=f, value=kv(k, v), process=p)
            for k, p, t, f, v in records]), {})
        return res["failure-count"], dict(D.counters)

    base = generate.history_records(CONFIG, TRAFFIC, 45200, 0)
    other = generate.relabel(base, random.Random(9), 5, 4)
    assert other != base
    assert run(other) == run(base)


def test_client_ops_counts_invocations():
    records = generate.register_records(100, procs=4, info_rate=0.05,
                                        n_values=5, seed=1, bad=True)
    assert generate.client_ops(records) == 101


def test_f_mix_draws_the_configured_shares():
    """[read, write, cas] = [0.4, 0.4, 0.2], as the port's
    linearizable-register workload draws a key's ops."""
    records = generate.register_records(
        20_000, procs=4, info_rate=0.0, n_values=5, seed=3,
        f_mix=[0.4, 0.4, 0.2])
    fs = [f for _, _, t, f, _ in records if t == "invoke"]
    for f, share in (("read", 0.4), ("write", 0.4), ("cas", 0.2)):
        assert fs.count(f) / len(fs) == pytest.approx(share, abs=0.015)
