"""The frozen byte count against the port's, and the peak table."""

import random

import pytest

from perfbench import roofline


def test_sweep_bytes_equals_the_ports():
    from jepsen_tpu_torch.telemetry import roofline as port

    rng = random.Random(4)
    for _ in range(500):
        K = rng.randrange(1, 300)
        cols = [rng.randrange(40) for _ in range(K)]
        start = rng.randrange(K + 1)
        death = rng.choice([rng.randrange(K + 2), K])
        B, SW = rng.choice([1, 8, 32, 64]), rng.choice([1, 5, 32])
        args = (start, death, K, cols, B, SW)
        assert roofline.sweep_bytes(*args) == port.sweep_bytes(*args)
        for stream in (False, True):
            assert roofline.launch_bytes(*args, stream) == \
                port.sweep_cost(*args, stream)["bytes_accessed"]


def test_peak_is_the_data_sheets_or_none():
    assert roofline.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == \
        pytest.approx(3.35e12)
    assert roofline.peak_bytes_per_s("cpu") is None
