"""No benchmark run imports JAX or `jepsen_tpu`, and the reference
imports nothing of the port: checked in fresh processes that refuse
those top-level names, compared whole (`jepsen_tpu_torch` is not
`jepsen_tpu`)."""

import subprocess
import sys
import textwrap

from perfbench import manifest

BLOCKER = textwrap.dedent("""
    import importlib.abc, sys
    BLOCK = set(sys.argv[1].split(","))

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCK:
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
""")


def run(block, body):
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKER + textwrap.dedent(body), block],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_a_run_loads_no_jax_and_no_jepsen_tpu():
    """Every module of the harness, every entry and reader, and one
    small run of each entry on the CPU."""
    out = run("jax,jaxlib,flax,jepsen_tpu", """
        import io, copy, glob
        from perfbench import manifest, run, controls
        for cell in (manifest.load("register-100k"), manifest.cell(
                "keys-200-bad30", "perfbench/configs/cas-register-keyed.json",
                "keys-200-bad30")):
            cell = copy.deepcopy(cell)
            cell.config["history"]["ops_per_key"] = 60
            cell.traffic.update(keys=min(cell.traffic["keys"], 6), pool=1,
                                bad_keys=min(cell.traffic["bad_keys"], 2))
            out = run.run(cell, run.host_entry(cell), 5, 0.01,
                          log=io.StringIO())
            assert out["correct"], out
        for f in glob.glob("perfbench/metrics/*.py"):
            manifest.load_module(manifest.Path(f))
        import perfbench.trace, perfbench.port
        assert "jepsen_tpu_torch" in sys.modules
        print(run.banned_modules())
    """)
    assert out.strip().endswith("[]")


def test_the_reference_imports_nothing_of_the_port():
    out = run("jax,jaxlib,flax,jepsen_tpu,jepsen_tpu_torch,torch", """
        from perfbench import generate, reference, compare
        recs = generate.register_records(500, procs=4, info_rate=0.1,
                                         n_values=5, seed=1)
        print(reference.decide(recs))
    """)
    assert out.strip() == "True"
