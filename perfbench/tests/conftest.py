"""Small cells for CPU runs of the harness: the real configurations and
mixes at sizes a test run holds, with the port on the CPU.  The keyed
cell is built from its files: `BENCHMARK.json` does not list it yet
(PERF.md, Open questions)."""

import copy

import pytest

from perfbench import manifest


def keyed(name: str = "keys-200-bad30") -> manifest.Cell:
    return manifest.cell(name, "perfbench/configs/cas-register-keyed.json",
                         name)


def _small(name: str, ops_per_key: int, **traffic) -> manifest.Cell:
    cell = copy.deepcopy(keyed(name) if name.startswith("keys-")
                         else manifest.load(name))
    cell.config["history"]["ops_per_key"] = ops_per_key
    cell.traffic.update(traffic)
    return cell


@pytest.fixture
def small():
    """(cell name, ops a key, **traffic) -> that cell, cut down."""
    return _small


@pytest.fixture
def register_cell():
    return _small("register-100k", 1500, pool=2)


@pytest.fixture
def keyed_cell():
    return _small("keys-200-bad30", 40, keys=20, bad_keys=5, pool=2)
