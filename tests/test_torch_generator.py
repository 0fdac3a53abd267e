"""The port's generator (jepsen_tpu_torch/generator/) against the JAX
package's: every scenario of tests/test_generator.py through the port,
and the deterministic simulation (`testkit`) of both packages on the
same seeds giving identical op sequences."""

import pytest

import jepsen_tpu.generator as rgen
import jepsen_tpu.generator.independent as rind
import jepsen_tpu.generator.testkit as rkit
import jepsen_tpu.parallel as rpar
import jepsen_tpu_torch.generator as pgen
import jepsen_tpu_torch.generator.independent as pind
import jepsen_tpu_torch.generator.testkit as pkit
import jepsen_tpu_torch.parallel as ppar
import torch_ported

PORTED = torch_ported.load("test_generator")


@pytest.mark.parametrize("case", torch_ported.cases(PORTED))
def test_generator_scenarios_through_the_port(case, request):
    torch_ported.run(PORTED, case, request)


def _mixed(g, ind, par, seed):
    """A generator exercising the RNG: a seeded value stream under mix
    and stagger on the clients, a flip-flop nemesis, a time limit."""
    import random

    rng = random.Random(seed)
    return g.time_limit(5, g.nemesis(
        g.stagger(0.2, g.cycle([{"type": "info", "f": "start"},
                                {"type": "info", "f": "stop"}])),
        g.stagger(0.01, g.mix([
            g.FnGen(lambda: {"f": "read"}),
            g.FnGen(lambda: {"f": "write", "value": rng.randrange(5)}),
            g.FnGen(lambda: {"f": "cas", "value": (rng.randrange(5),
                                                   rng.randrange(5))}),
        ]))))


def _keyed(g, ind, par, seed):
    """The north-star workload's shape: thread groups over keys
    (concurrent_generator), each key's ops capped, KV values."""
    import random

    rng = random.Random(seed)

    def fgen(key):
        def step():
            r = rng.random()
            if r < 0.4:
                return {"f": "read", "value": par.KV(key, None)}
            return {"f": "write", "value": par.KV(key, rng.randrange(5))}
        return g.limit(12, g.FnGen(step))

    return g.clients(ind.concurrent_generator(2, list(range(6)), fgen))


def _phased(g, ind, par, seed):
    return g.phases(g.each_thread(g.limit(3, {"f": "read"})),
                    g.limit(20, g.mix([{"f": "a"}, {"f": "b"},
                                       {"f": "c"}])),
                    g.once({"f": "final"}))


@pytest.mark.parametrize("build", [_mixed, _keyed, _phased])
@pytest.mark.parametrize("how", ["quick", "perfect", "perfect_info",
                                 "imperfect"])
@pytest.mark.parametrize("seed", [45100, 7])
def test_testkit_simulations_give_identical_ops(build, how, seed):
    """For one set_rng_seed, both generators draw the same op sequence:
    types, processes, times, fs and values, op for op."""
    def ops(g, ind, par, kit):
        g.set_rng_seed(seed)
        ctx = kit.n_plus_nemesis_context(4)
        return [(o.type, o.process, o.time, o.f, o.value)
                for o in getattr(kit, how)(build(g, ind, par, seed), ctx)]

    want = ops(rgen, rind, rpar, rkit)
    got = ops(pgen, pind, ppar, pkit)
    assert len(want) > 2
    assert got == want
