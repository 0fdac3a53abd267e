"""Device hygiene rules, translated from the JAX package's to torch code.

The bug classes here are the ones the reference repo shipped and
hand-caught, in the spelling the port writes them:

  * ``device.unguarded-narrowing`` — ``.astype(np.int32)`` (or any
    narrower integer), ``.to(torch.int32)`` (``dtype=`` too) or
    ``.int()`` with no *dominating* range guard.  The exemplar is
    ``wgl_witness._plan_blocks``: it raises ``OverflowError`` when the
    64-bit timeline maximum reaches int32 INF *before* casting, because
    a wrapped ``inv`` silently corrupts the barrier order.  A cast
    counts as guarded when the enclosing function asserts/bails on a
    bound before it, or the cast source is already clamped
    (``np.minimum`` / ``torch.minimum`` / ``.clip`` / ``torch.clamp`` /
    ``.clamp``) or inherently bounded (comparison masks,
    ``searchsorted`` ranks, ``arange``).
  * ``device.host-sync-in-capture`` — ``.item()`` / ``.tolist()`` /
    ``.cpu()`` / ``.numpy()`` / the port's ``device.host(...)`` /
    ``torch.cuda.synchronize()`` inside a loop inside a
    ``profile.capture`` block.  Per-iteration syncs are the classic
    hidden serializer in a device pipeline; a search that is
    sequential by design argues for its sync in the baseline.
  * ``device.uncaptured-device-call`` — a function in ``ops/`` or
    ``streaming/`` that demonstrably drives the card (launches a
    kernel through ``ops/kernels.py``, ``torch.cuda.synchronize``,
    ``device.host(``, ``.cuda(``) but is neither under a
    ``profile.capture`` itself nor only reachable from covered
    functions: a pass invisible to the per-pass cost profiles.

Dropped from the reference: ``device.host-sync-in-jit`` and
``device.np-in-jit``.  Both read the bodies of functions that
``jax.jit`` / ``pmap`` / ``shard_map`` trace.  The port has no traced
function — no ``torch.compile``, no ``torch.jit`` and no CUDA graph
capture — so every torch call runs eagerly and neither bug class can
occur.
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from ..core import Finding, Module, walk

RULES = {
    "device.unguarded-narrowing": (
        "warning",
        ".astype/.to/.int to a narrower int with no dominating range "
        "guard",
    ),
    "device.host-sync-in-capture": (
        "advice",
        "per-iteration host sync inside a profile.capture hot loop",
    ),
    "device.uncaptured-device-call": (
        "warning",
        "device-driving function in ops//streaming/ not under "
        "profile.capture",
    ),
}

#: Integer dtypes narrower than the int64 indices/timestamps the
#: history pipeline carries.
_NARROW_INTS = {
    "int32", "int16", "int8", "uint32", "uint16", "uint8",
}

#: Tokens whose presence in a preceding raise/assert marks the cast
#: range-checked (the _plan_blocks idiom and its relatives).
_GUARD_TOKENS = ("INF", "iinfo", "int32", "overflow", "Overflow")

#: Call names in the cast source that already bound the value
#: (``minimum(`` covers np.minimum and torch.minimum, ``clamp(``
#: torch.clamp and Tensor.clamp).
_CLAMP_TOKENS = ("minimum(", ".clip(", "clip(", "clamp(",
                 "searchsorted(", "arange(", "argsort(", "nonzero(",
                 "cumsum(")

#: Method calls that copy a card tensor to the host.
_HOST_SYNC_ATTRS = ("item", "tolist", "cpu", "numpy")

_KERNELS = "jepsen_tpu_torch/ops/kernels.py"


def _dtype_name(arg: ast.AST) -> Optional[str]:
    if isinstance(arg, ast.Attribute):          # np.int32 / torch.int32
        return arg.attr
    if isinstance(arg, ast.Name):               # bare int32
        return arg.id
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value                        # .astype("int32")
    return None


def _narrowing(call: ast.Call) -> Optional[str]:
    """The cast's spelling ("astype(int32)", "to(int32)", "int()") when
    `call` narrows to an integer type of fewer than 64 bits."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr == "astype" and call.args:
        name = _dtype_name(call.args[0])
        return f"astype({name})" if name in _NARROW_INTS else None
    if func.attr == "to":
        # .to(torch.int32), .to(dev, torch.int32), .to(dtype=torch.int32)
        cands = [a for a in call.args if isinstance(a, ast.Attribute)]
        cands += [k.value for k in call.keywords if k.arg == "dtype"]
        for arg in cands:
            name = _dtype_name(arg)
            if name in _NARROW_INTS:
                return f"to({name})"
        return None
    if func.attr == "int" and not call.args and not call.keywords:
        return "int()"
    return None


def _is_bounded_value(m: Module, value: ast.AST) -> bool:
    """Casts of masks/ranks/clamped values can't overflow int32."""
    if isinstance(value, (ast.Compare, ast.BoolOp)):
        return True
    seg = m.seg(value)
    return any(tok in seg for tok in _CLAMP_TOKENS)


def _has_dominating_guard(m: Module, fn: ast.FunctionDef,
                          cast_line: int) -> bool:
    """A raise/assert before the cast whose text talks about the int32
    bound — the lexical stand-in for dominance that matches how every
    real guard in this repo is written (straight-line prologue checks)."""
    for node in walk(fn):
        if getattr(node, "lineno", 1 << 30) >= cast_line:
            continue
        if isinstance(node, (ast.Raise, ast.Assert)):
            seg = m.seg(node)
            if any(tok in seg for tok in _GUARD_TOKENS):
                return True
        # Delegated guards: a bare call statement whose name says it
        # range-checks (`_require_i32(arr)`) is the same idiom hoisted
        # into a helper.
        if (isinstance(node, ast.Expr)
                and isinstance(node.value, ast.Call)):
            name = m.seg(node.value.func).lower()
            if any(t in name for t in ("i32", "int32", "overflow")) \
                    and any(t in name for t in
                            ("require", "guard", "check", "assert")):
                return True
    return False


def _check_narrowing(m: Module) -> list[Finding]:
    out = []
    for node in walk(m.tree):
        if not isinstance(node, ast.Call):
            continue
        cast = _narrowing(node)
        if cast is None:
            continue
        value = node.func.value  # type: ignore[union-attr]
        if _is_bounded_value(m, value):
            continue
        fn = m.enclosing_function(node)
        if fn is not None and _has_dominating_guard(m, fn, node.lineno):
            continue
        clamp = ("np.minimum" if cast.startswith("astype")
                 else "torch.clamp")
        out.append(m.finding(
            "device.unguarded-narrowing", "warning", node,
            f".{cast} narrows a 64-bit value with no dominating range "
            f"guard; assert/bail on the max first (the "
            f"wgl_witness._plan_blocks idiom) or clamp with {clamp}",
        ))
    return out


def _capture_withs(m: Module) -> list[ast.With]:
    out = []
    for node in walk(m.tree):
        if isinstance(node, ast.With):
            for item in node.items:
                if "profile.capture" in m.seg(item.context_expr):
                    out.append(node)
                    break
    return out


def _host_sync(m: Module, call: ast.Call) -> Optional[str]:
    """The sync's spelling when `call` copies a card value to the host
    or waits for the card."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr in _HOST_SYNC_ATTRS and not call.args:
        return f".{func.attr}()"
    base = m.seg(func.value)
    if func.attr == "host" and base.endswith("device"):
        return f"{base}.host()"
    if func.attr == "synchronize" and base == "torch.cuda":
        return "torch.cuda.synchronize()"
    return None


def _check_capture_loops(m: Module) -> list[Finding]:
    out = []
    for w in _capture_withs(m):
        for loop in walk(w):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            for node in walk(loop):
                if not isinstance(node, ast.Call):
                    continue
                name = _host_sync(m, node)
                if name:
                    out.append(m.finding(
                        "device.host-sync-in-capture", "advice", node,
                        f"{name} per loop iteration inside a "
                        f"profile.capture hot path serializes the "
                        f"device pipeline; batch the sync or justify "
                        f"it (sequential-by-design searches are)",
                    ))
    return out


#: Source markers that say "this function drives the card from host".
_DEVICE_MARKERS = ("torch.cuda.synchronize", "device.host(", ".cuda(")


def _launch_wrappers(modules: list[Module]) -> Optional[set[str]]:
    """The kernel wrappers of ops/kernels.py — its module functions that
    count a launch (``launches[...] += 1``) — parsed from its AST, never
    imported.  None when kernels.py is not in the batch."""
    kmod = next((m for m in modules if m.rel == _KERNELS), None)
    if kmod is None:
        return None
    return {fn.name for fn in kmod.tree.body
            if isinstance(fn, ast.FunctionDef)
            and "launches[" in kmod.seg(fn)}


def _launch_re(wrappers: Optional[set[str]]) -> re.Pattern:
    """``kernels.<wrapper>(`` — any lowercase callable of ``kernels``
    when the wrappers are not known (a fixture batch)."""
    names = ("|".join(sorted(wrappers)) if wrappers
             else r"[a-z_]\w*")
    return re.compile(rf"\bkernels\.(?:{names})\s*\(")


def _check_uncaptured(modules: list[Module]) -> list[Finding]:
    """Repo-wide coverage fixpoint: a device-driving ops//streaming/
    function is fine when it runs under profile.capture itself or is
    only reachable from covered callers — *in any scanned module*
    (check_wgl_witness is covered by wgl.py's `capture("witness")`
    around the call, one module over)."""
    from .concurrency import _import_map

    targets = [m for m in modules
               if m.rel.startswith(("jepsen_tpu_torch/ops/",
                                    "jepsen_tpu_torch/streaming/"))]
    if not targets:
        return []
    launch = _launch_re(_launch_wrappers(modules))

    # Every function in the scan set is a potential caller; module-level
    # functions in target modules are the flag candidates.
    fn_info: dict[tuple[str, str], dict] = {}
    for m in modules:
        for fn in [n for n in walk(m.tree)
                   if isinstance(n, ast.FunctionDef)]:
            seg = m.seg(fn)
            drives = (any(tok in seg for tok in _DEVICE_MARKERS)
                      or launch.search(seg) is not None)
            fn_info[(m.name, fn.name)] = {
                "m": m, "fn": fn, "drives": drives,
                "captures": "profile.capture" in seg,
                "callers": set(), "called_at_toplevel": False,
            }

    # Call graph across modules: bare names resolve in the caller's
    # module, `alias.f(...)` through its import map.
    for m in modules:
        imports = _import_map(m)
        for node in walk(m.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            key = None
            if isinstance(f, ast.Name):
                tgt = imports.get(f.id)
                if tgt and "." in tgt:          # from x import f
                    key = tuple(tgt.rsplit(".", 1))
                else:
                    key = (m.name, f.id)
            elif (isinstance(f, ast.Attribute)
                  and isinstance(f.value, ast.Name)):
                base = imports.get(f.value.id)
                if base:
                    key = (base, f.attr)
            if key is None or key not in fn_info:
                continue
            caller = m.enclosing_function(node)
            if caller is None:
                fn_info[key]["called_at_toplevel"] = True
            elif (m.name, caller.name) in fn_info \
                    and fn_info[(m.name, caller.name)]["fn"] is caller:
                fn_info[key]["callers"].add((m.name, caller.name))
            else:
                # Nested/method caller: count its own capture state.
                if "profile.capture" in m.seg(caller):
                    fn_info[key]["callers"].add(("<covered>", ""))
                else:
                    fn_info[key]["called_at_toplevel"] = True

    # Greatest fixpoint: start with everything covered and strip any
    # function that doesn't capture and has an uncovered entry path.
    # (A least fixpoint can never cover recursion — check_wgl_witness's
    # retry cycle — even when every external caller runs under
    # capture.)
    covered = set(fn_info) | {("<covered>", "")}
    changed = True
    while changed:
        changed = False
        for key, i in fn_info.items():
            if key not in covered or i["captures"]:
                continue
            if (i["called_at_toplevel"] or not i["callers"]
                    or not (i["callers"] <= covered)):
                covered.discard(key)
                changed = True

    out = []
    for m in targets:
        for (mod, _name), i in fn_info.items():
            if mod != m.name or i["m"] is not m:
                continue
            if i["drives"] and (mod, i["fn"].name) not in covered:
                out.append(m.finding(
                    "device.uncaptured-device-call", "warning", i["fn"],
                    f"`{i['fn'].name}` drives devices but neither runs "
                    f"under profile.capture nor is only called from "
                    f"covered functions — its cost is invisible to the "
                    f"per-pass profile store (telemetry/profile.py)",
                ))
    return out


def check(modules: list[Module]) -> list[Finding]:
    out: list[Finding] = []
    scan = [m for m in modules if m.rel.startswith("jepsen_tpu_torch/")]
    for m in scan:
        out.extend(_check_narrowing(m))
        out.extend(_check_capture_loops(m))
    out.extend(_check_uncaptured(scan))
    return out
