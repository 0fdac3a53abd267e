"""One traced run of each cell on the card, through the command the
benchmark's users run; skips without a card."""

import json
import subprocess
import sys

import pytest

from perfbench import manifest


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (manifest.ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_a_traced_run_prints_its_line(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", cell,
         "--seed", str(2**31 + 1), "--seconds", "3", "--trace", "1"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert list(out)[-1] == "compared"
    names = {m["name"] for m in manifest.load(cell).per_layer}
    assert set(out["metrics"]) == names
    assert out["device"]["busy_s"] > 0
    assert out["breakdown"]["device_ops"] and out["breakdown"]["idle_gaps"]


def test_without_a_card_it_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "register-100k", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert proc.stdout == ""
