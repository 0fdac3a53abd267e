"""The port's store (jepsen_tpu_torch/store/) against the JAX
package's: the scenarios of tests/test_store.py through the port, the
same ops written by both giving the same bytes, and a test file of
either package loading in the other with an equal history and test
map — op values with KV pairs, tuples, None and nesting among them."""

import os

import pytest

import jepsen_tpu.store as rstore
import jepsen_tpu.store.format as rfmt
import jepsen_tpu_torch.store as pstore
import jepsen_tpu_torch.store.format as pfmt
from jepsen_tpu.history import Op as ROp
from jepsen_tpu.parallel import KV as RKV
from jepsen_tpu_torch.history import Op as POp
from jepsen_tpu_torch.parallel import KV as PKV
import torch_ported

PORTED = torch_ported.load("test_store")


@pytest.mark.parametrize("case", torch_ported.cases(PORTED))
def test_store_scenarios_through_the_port(case, request):
    torch_ported.run(PORTED, case, request)


#: Op values a run writes: keyed values, cas tuples, None, nesting.
VALUES = [None, 3, "x", (1, 2), [1, [2, (3, None)]], {"a": (1, 2)},
          {1, 2}, 2.5, True]


def _ops(Op, KV):
    out = []
    for i, v in enumerate(VALUES + [KV(k, v) for k, v in
                                    zip(range(4), VALUES)]):
        out.append(Op(type="invoke", f="write", value=v, process=i % 3,
                      time=10 * i, index=2 * i))
        out.append(Op(type="ok", f="write", value=v, process=i % 3,
                      time=10 * i + 5, index=2 * i + 1,
                      ext={"error": None} if i % 4 else {}))
    return out


def _write(fmt, path, ops, chunk_size):
    with fmt.Handle(str(path)) as h:
        h.save_test({"name": "t", "nodes": ["n1", "n2"], "concurrency": 3,
                     "seed": (1, None)})
        hw = h.open_history_writer(chunk_size=chunk_size)
        for o in ops:
            hw.append(o)
        h.save_run({"name": "t", "nodes": ["n1", "n2"], "concurrency": 3})
        h.save_results({"valid": True, "results": {"0": {"valid": True}}})


@pytest.mark.parametrize("chunk_size", [3, 1024])
def test_both_packages_write_the_same_bytes(tmp_path, chunk_size):
    _write(rfmt, tmp_path / "ref.jtpu", _ops(ROp, RKV), chunk_size)
    _write(pfmt, tmp_path / "port.jtpu", _ops(POp, PKV), chunk_size)
    assert (tmp_path / "port.jtpu").read_bytes() == \
        (tmp_path / "ref.jtpu").read_bytes()


@pytest.mark.parametrize("writer,reader", [(pfmt, rstore), (rfmt, pstore)])
def test_each_package_loads_the_others_file(tmp_path, writer, reader):
    Op, KV = (POp, PKV) if writer is pfmt else (ROp, RKV)
    _write(writer, tmp_path / "test.jtpu", _ops(Op, KV), 4)
    tf = reader.load(str(tmp_path / "test.jtpu"))
    try:
        other = (rstore if reader is pstore else pstore).load(
            str(tmp_path / "test.jtpu"))
        try:
            assert tf.test == other.test == {"name": "t",
                                             "nodes": ["n1", "n2"],
                                             "concurrency": 3}
            assert tf.results == other.results
            got = [o.to_dict() for o in tf.history()]
            assert got == [o.to_dict() for o in other.history()]
            assert len(got) == 2 * (len(VALUES) + 4)
            # Tuples and KV pairs come back as JSON lists, sets sorted.
            assert got[6]["value"] == [1, 2]
            assert got[2 * len(VALUES)]["value"] == [0, None]
        finally:
            other.close()
    finally:
        tf.close()


def _register_run(pkg, store_dir):
    """A whole run of the north-star workload on the CPU through `pkg`'s
    core, with a small key count -> its test dir."""
    import importlib

    core = importlib.import_module(f"{pkg}.core")
    gen = importlib.import_module(f"{pkg}.generator")
    lr = importlib.import_module(f"{pkg}.workloads.linearizable_register")
    opts = {"seed": 3, "key-count": 3, "per-key-limit": 16,
            "algorithm": "cpu"}
    if pkg == "jepsen_tpu_torch":
        opts["device"] = "cpu"
    wl = lr.workload(opts)
    gen.set_rng_seed(3)
    test = {**wl, "name": "lr", "nodes": ["n1"], "concurrency": 4,
            "ssh": {"dummy?": True}, "store-dir": str(store_dir),
            "generator": gen.clients(wl["generator"])}
    if pkg == "jepsen_tpu_torch":
        test["device"] = "cpu"
    return rstore.test_dir(core.run(test))


@pytest.mark.parametrize("pkg", ["jepsen_tpu_torch", "jepsen_tpu"])
def test_a_runs_test_file_loads_in_both_packages(tmp_path, pkg):
    d = _register_run(pkg, tmp_path / "store")
    assert os.path.exists(os.path.join(d, rstore.TEST_FILE))
    a, b = rstore.load(d), pstore.load(d)
    try:
        assert a.test == b.test and a.results == b.results
        ha, hb = a.history(), b.history()
        assert len(ha) == len(hb) == 2 * 3 * 16
        assert [o.to_dict() for o in ha] == [o.to_dict() for o in hb]
        assert all(isinstance(o.value, list) for o in hb)
    finally:
        a.close()
        b.close()
