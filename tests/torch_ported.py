"""Runs a JAX-package test module's scenarios through the port.

`load("test_interpreter")` reads tests/test_interpreter.py, points its
imports of `jepsen_tpu` at `jepsen_tpu_torch`, and executes it as a new
module, so every scenario it defines builds its inputs from the port
and asserts the same expectations the reference's run meets.  While a
case runs, `device.resolve` takes "cuda" for the CPU: every entry point
of the port resolves its `device` there, so its checkers, searches and
a test map's "device", "cuda" by default, run on the CPU (the port runs
on the card unless asked otherwise; these tests run on the CPU).

`load(name, imports={...})` also points the file's imports of a tool
or a sibling test file at their port counterparts.

`cases(mod)` lists its tests ("test_x" or "TestClass.test_y", with one
entry per parametrized case; `cases(mod, slow=True)` its `slow`-marked
ones), `run(mod, case, request)` runs one, with pytest fixtures
(tmp_path, monkeypatch, ...) from `request`.
"""

from __future__ import annotations

import inspect
import itertools
import pathlib
import re
import sys
import types
from typing import Optional

HERE = pathlib.Path(__file__).resolve().parent

_loaded: dict = {}


def load(name: str, imports: Optional[dict] = None) -> types.ModuleType:
    """`imports` maps a module the file imports by name (a tool under
    tools/, a sibling test file) to the one its ported copy imports
    instead, e.g. {"fault_matrix": "port_fault_matrix"}.  A loaded file
    is importable as `ported_<name>`."""
    mod = _loaded.get(name)
    if mod is not None:
        return mod
    path = HERE / f"{name}.py"
    src = re.sub(r"\bjepsen_tpu\b(?!_torch)", "jepsen_tpu_torch",
                 path.read_text())
    for old, new in (imports or {}).items():
        src = re.sub(rf"^(\s*)(from|import) {old}\b", rf"\1\2 {new}",
                     src, flags=re.M)
    mod = types.ModuleType(f"ported_{name}")
    mod.__file__ = str(path)
    sys.modules[mod.__name__] = mod
    exec(compile(src, f"<{path.name} through jepsen_tpu_torch>", "exec"),
         mod.__dict__)
    _loaded[name] = mod
    return mod


def _param_sets(fn) -> list:
    """[(label, {arg: value})] of a test's parametrize marks (one entry
    with no arguments when it has none)."""
    groups = []
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names, values = mark.args[0], mark.args[1]
        if isinstance(names, str):
            names = [n.strip() for n in names.split(",")]
        rows = []
        for v in values:
            v = getattr(v, "values", v)
            v = v if len(names) > 1 else (v,)
            rows.append(dict(zip(names, v)))
        groups.append(rows)
    out = []
    for combo in itertools.product(*groups):
        args: dict = {}
        for part in combo:
            args.update(part)
        out.append(("-".join(repr(v)[:20] for v in args.values()), args))
    return out or [("", {})]


def cases(mod: types.ModuleType, exclude=(), slow: bool = False) -> list:
    """The module's runnable cases: those with no `slow`, `skip` or
    `cuda` mark, or with `slow=True` its `slow`-marked cases alone."""
    out = []
    for name, obj in mod.__dict__.items():
        if name.startswith("test_") and callable(obj):
            fns = [(name, obj)]
        elif name.startswith("Test") and isinstance(obj, type):
            fns = [(f"{name}.{m}", getattr(obj, m)) for m in dir(obj)
                   if m.startswith("test_")]
        else:
            continue
        for qual, fn in fns:
            marks = {m.name for m in getattr(fn, "pytestmark", [])}
            if (qual in exclude or marks & {"skip", "cuda"}
                    or ("slow" in marks) != slow):
                continue
            for i, (label, _) in enumerate(_param_sets(fn)):
                out.append(f"{qual}[{i}]" if label else qual)
    return out


def run(mod: types.ModuleType, case: str, request) -> None:
    qual, _, idx = case.partition("[")
    owner, _, meth = qual.partition(".")
    if meth:
        fn = getattr(getattr(mod, owner)(), meth)
        base = getattr(getattr(mod, owner), meth)
    else:
        fn = base = getattr(mod, owner)
    import importlib

    dev = importlib.import_module("jepsen_tpu_torch.device")
    resolve = dev.resolve
    request.getfixturevalue("monkeypatch").setattr(
        dev, "resolve", lambda device="cuda": resolve(
            "cpu" if device is None or str(device).startswith("cuda")
            else device))
    params = _param_sets(base)[int(idx[:-1]) if idx else 0][1]
    kwargs = dict(params)
    for p, param in inspect.signature(fn).parameters.items():
        if p not in kwargs and param.default is inspect.Parameter.empty:
            kwargs[p] = request.getfixturevalue(p)
    fn(**kwargs)
