"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names its configuration and its traffic mix.
The configuration's entry in `configs` names its file, which names the
entry module (`perfbench/entries/<entry>.py`) that builds the checker
the window drives.  The traffic mix is `perfbench/traffic/<mix>.json`.
Every metric is read by `perfbench/metrics/<metric>.py`.  A cell
reports each end-to-end metric that lists it (or lists no cells), and
each per-layer metric that lists it, or that lists no cells and moves
an end-to-end metric the cell reports.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    home: Path          # the perfbench directory the cell's files are in
    chips: int
    config: dict
    traffic: dict
    entry: Path
    end_to_end: list = field(default_factory=list)   # BENCHMARK.json entries
    per_layer: list = field(default_factory=list)


def load_module(path: Path) -> ModuleType:
    """The module in the file `path` (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        f"perfbench._loaded.{path.parent.name}.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(cell: Cell, metric: str) -> ModuleType:
    return load_module(cell.home / "metrics" / f"{metric}.py")


def cell(name: str, config_file: str, traffic: str, chips: int = 1,
         end_to_end: list = (), per_layer: list = (),
         root: Path = ROOT) -> Cell:
    """The cell `name` of the configuration in `root`/`config_file` under
    the mix `traffic`, reporting the metrics given."""
    config = json.loads((root / config_file).read_text())
    here = root / "perfbench"
    return Cell(name=name, home=here, chips=chips, config=config,
                traffic=json.loads((here / "traffic" / f"{traffic}.json")
                                   .read_text()),
                entry=here / "entries" / f"{config['entry']}.py",
                end_to_end=list(end_to_end), per_layer=list(per_layer))


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json; raises KeyError for a
    cell it does not list."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    # A per-layer metric with no list of cells is reported in every
    # cell that reports the metric it moves, those added later too.
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return cell(name, conf["file"], w["traffic"], int(w["chips"]), e2e,
                layer, root)
