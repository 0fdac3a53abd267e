"""The port's interpreter (jepsen_tpu_torch/interpreter.py) with its
client, nemesis and generator: the scenarios of
tests/test_interpreter.py through the port (the partitioner scenarios
need the nemeses the port has not taken yet, and the throughput ones
measure the host), and one seeded run through both packages giving the
same op sequence."""

import threading

import pytest

import torch_ported

PORTED = torch_ported.load("test_interpreter")
NOT_PORTED = ("test_partitioner_nemesis_with_fake_net", "test_grudge_math",
              "test_majorities_ring_bidirectional",
              "test_interpreter_throughput_floor")


@pytest.mark.parametrize("case", torch_ported.cases(PORTED, NOT_PORTED))
def test_interpreter_scenarios_through_the_port(case, request):
    torch_ported.run(PORTED, case, request)


def _run(pkg):
    """One worker thread per process, a seeded schedule, a register
    client and a nemesis echoing its ops: the journaled ops without
    times."""
    import importlib

    gen = importlib.import_module(f"{pkg}.generator")
    interpreter = importlib.import_module(f"{pkg}.interpreter")
    jc = importlib.import_module(f"{pkg}.client")
    nem = importlib.import_module(f"{pkg}.nemesis")
    OK = importlib.import_module(f"{pkg}.history").OK

    class Reg(jc.Client):
        lock = threading.Lock()
        state = {"v": 0}

        def invoke(self, test, op):
            with self.lock:
                if op.f == "write":
                    self.state["v"] = op.value
                    return op.complete(OK)
                return op.complete(OK, value=self.state["v"])

    gen.set_rng_seed(11)
    g = gen.nemesis(gen.limit(4, gen.repeat({"type": "info", "f": "noop"})),
                    gen.limit(60, gen.mix([{"f": "read"},
                                           {"f": "write", "value": 3}])))
    test = {"concurrency": 1, "nodes": ["n1"], "client": Reg(),
            "nemesis": nem.noop, "generator": g}
    h = interpreter.run(test)
    return sorted((str(o.process), o.type, o.f) for o in h), len(h)


def test_one_schedule_through_both_interpreters():
    """With one client worker the schedule is sequential, so both
    packages journal the same ops (times aside)."""
    assert _run("jepsen_tpu_torch") == _run("jepsen_tpu")
