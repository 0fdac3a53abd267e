"""A later change adds a configuration, a traffic mix, a per-layer
metric and a cell by adding files and entries alone: in a copy of the
benchmark, the harness finds them by name and runs the new cell, and
no file that was there changes."""

import hashlib
import json
import shutil
import subprocess
import sys
import textwrap

from perfbench import manifest


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_from_new_files_alone(tmp_path):
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path / "perfbench")
    home = tmp_path / "perfbench"
    (home / "configs" / "cas-register-narrow.json").write_text(json.dumps({
        "entry": "independent", "model": "cas-register", "keyed": True,
        "history": {"ops_per_key": 30, "procs_per_key": 2,
                    "info_rate": 0.05, "values": 3}}))
    (home / "traffic" / "keys-8-bad2.json").write_text(json.dumps({
        "keys": 8, "bad_keys": 2, "pool": 2, "base_seed": 1,
        "profile_checks": 1}))
    (home / "metrics" / "checks_in_window.py").write_text(textwrap.dedent(
        """
        def read(ctx):
            return float(ctx["window"]["checks"])
        """))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "cas-register-narrow", "source": "a test",
        "file": "perfbench/configs/cas-register-narrow.json",
        "reduced": [], "why": "a test"})
    bench["workloads"].append({
        "name": "keys-8-bad2", "config": "cas-register-narrow",
        "traffic": "keys-8-bad2", "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "checks_in_window", "unit": "checks", "better": "higher",
        "source": "host_clock", "layer": "a test", "moves": "ops_per_s",
        "workloads": ["keys-8-bad2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    script = textwrap.dedent("""
        import io, json
        from perfbench import manifest, run
        cell = manifest.load("keys-8-bad2")
        assert cell.home == manifest.ROOT / "perfbench", cell.home
        out = run.run(cell, run.host_entry(cell), 3, 0.2, True,
                      log=io.StringIO())
        print(json.dumps(out))
    """)
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
        text=True, timeout=600,
        env={"PYTHONPATH": str(manifest.ROOT), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["metrics"]["checks_in_window"]["value"] >= 2
    after = digests(home)
    assert {k: v for k, v in after.items() if k in before} == before
