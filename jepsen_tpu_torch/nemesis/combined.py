"""Declarative "fault packages": nemesis + generator bundles.

The port's copy of `jepsen_tpu/nemesis/combined.py`.

Equivalent of jepsen/src/jepsen/nemesis/combined.clj:
a package is {"nemesis", "generator", "final-generator", "perf"}
(:26-60); `partition_package` (:228), `db_package` kill/pause (:143),
`packet_package` tc-netem (:288), `clock_package` (:329),
`compose_packages` (:483), and the top-level `nemesis_package` (:508-568)
that turns {"faults": {...}, "interval": secs} into one bundle ready to
merge into a test map:

    pkg = nemesis_package({"faults": {"partition", "kill"}, "interval": 10})
    test["nemesis"] = pkg["nemesis"]
    test["generator"] = gen.nemesis(pkg["generator"], workload_gen)

Fault f's are namespaced ("start-partition"...) and routed by f_map +
compose, like the reference.
"""

from __future__ import annotations

import logging
import random
from typing import Any, Optional, Sequence

from ..generator.core import FnGen, cycle, mix, once, sleep as gen_sleep
from .core import (
    Compose,
    Nemesis,
    _rng,
    bridge,
    complete_grudge,
    bisect,
    compose,
    majorities_ring,
    noop,
    partitioner,
    split_one,
)
from .faults import Bitflip, ClockNemesis, DBNemesis, TruncateFile

log = logging.getLogger(__name__)

DEFAULT_INTERVAL = 10.0  # seconds between fault transitions (:22-24)


def _package(nemesis: Nemesis, generator, final_generator=None, perf=None):
    return {
        "nemesis": nemesis,
        "generator": generator,
        "final-generator": final_generator,
        "perf": perf or [],
    }


def _cycle_ops(interval: float, *templates: dict):
    """start/stop style op cycle spaced by ~interval seconds."""
    steps: list = []
    for t in templates:
        steps.append(gen_sleep(interval))
        steps.append(dict(t, type="info"))
    return cycle(steps)


def _grudge_for(kind: str):
    table = {
        "one": lambda nodes: complete_grudge(split_one(nodes)),
        "majority": lambda nodes: complete_grudge(
            bisect(sorted(nodes, key=lambda _: _rng().random()))
        ),
        "majorities-ring": majorities_ring,
        "bridge": bridge,
        "primaries": lambda nodes: complete_grudge(split_one(nodes)),
    }
    return table[kind]


def partition_package(opts: dict) -> Optional[dict]:
    """Network partitions cycling start/stop (combined.clj:228-286).
    opts["partition"]["targets"]: list of grudge kinds to mix."""
    if "partition" not in opts.get("faults", set()):
        return None
    popts = opts.get("partition", {}) or {}
    targets = popts.get("targets", ["one", "majority", "majorities-ring"])
    interval = opts.get("interval", DEFAULT_INTERVAL)

    nem = partitioner(
        lambda nodes: _grudge_for(_rng().choice(targets))(nodes)
    )
    generator = cycle(
        [
            gen_sleep(interval),
            {"type": "info", "f": "start-partition", "value": None},
            gen_sleep(interval),
            {"type": "info", "f": "stop-partition"},
        ]
    )
    return _package(
        compose([({"start-partition": "start",
                   "stop-partition": "stop"}, nem)]),
        generator,
        final_generator={"type": "info", "f": "stop-partition"},
        perf=[{"name": "partition", "start": {"start-partition"},
               "stop": {"stop-partition"}}],
    )


def db_package(opts: dict) -> Optional[dict]:
    """Kill/pause the DB on random subsets (combined.clj:143-226)."""
    faults = opts.get("faults", set())
    kills = "kill" in faults
    pauses = "pause" in faults
    if not (kills or pauses):
        return None
    interval = opts.get("interval", DEFAULT_INTERVAL)

    def targets():
        return _rng().choice([1, None])  # one node or all

    cycles = []
    if kills:
        cycles.append(
            cycle([
                gen_sleep(interval),
                once(FnGen(lambda: {"type": "info", "f": "kill", "value": targets()})),
                gen_sleep(interval),
                {"type": "info", "f": "start", "value": None},
            ])
        )
    if pauses:
        cycles.append(
            cycle([
                gen_sleep(interval),
                once(FnGen(lambda: {"type": "info", "f": "pause", "value": targets()})),
                gen_sleep(interval),
                {"type": "info", "f": "resume", "value": None},
            ])
        )
    generator = mix(cycles) if len(cycles) > 1 else cycles[0]
    final = [{"type": "info", "f": "start", "value": None}] if kills else []
    if pauses:
        final.append({"type": "info", "f": "resume", "value": None})
    perf = []
    if kills:
        perf.append({"name": "kill", "start": {"kill"}, "stop": {"start"}})
    if pauses:
        perf.append({"name": "pause", "start": {"pause"}, "stop": {"resume"}})
    return _package(
        DBNemesis(),
        generator,
        final_generator=final or None,
        perf=perf,
    )


def packet_package(opts: dict) -> Optional[dict]:
    """tc/netem packet mangling (combined.clj:288-327)."""
    if "packet" not in opts.get("faults", set()):
        return None
    interval = opts.get("interval", DEFAULT_INTERVAL)
    behaviors = (opts.get("packet", {}) or {}).get(
        "behaviors",
        [
            {"delay": {"time": 100, "jitter": 50}},
            {"loss": {"percent": 20}},
            {"duplicate": {"percent": 20}},
            {"reorder": {"percent": 20}},
        ],
    )

    class PacketNemesis(Nemesis):
        def invoke(self, test: dict, op):
            net = test["net"]
            if op.f == "start-packet":
                b = op.ext.get("behavior") or _rng().choice(behaviors)
                net.shape(test, b)
                return op.replace(value=b)
            net.shape(test, None)
            return op.replace(value="healed")

        def teardown(self, test: dict) -> None:
            net = test.get("net")
            if net is not None:
                try:
                    # shape(None) -> net.fast, which journals the heal
                    # (or leaves entries outstanding when abandoned).
                    net.shape(test, None)
                except Exception as e:  # noqa: BLE001
                    log.warning(
                        "packet shaping teardown failed — netem may be "
                        "stranded (see the fault ledger): %r", e,
                    )

        def fs(self):
            return {"start-packet", "stop-packet"}

    generator = cycle([
        gen_sleep(interval),
        {"type": "info", "f": "start-packet"},
        gen_sleep(interval),
        {"type": "info", "f": "stop-packet"},
    ])
    return _package(
        PacketNemesis(),
        generator,
        final_generator={"type": "info", "f": "stop-packet"},
        perf=[{"name": "packet", "start": {"start-packet"},
               "stop": {"stop-packet"}}],
    )


def clock_package(opts: dict) -> Optional[dict]:
    """Clock skew faults (combined.clj:329-400)."""
    if "clock" not in opts.get("faults", set()):
        return None
    interval = opts.get("interval", DEFAULT_INTERVAL)

    def bump_op():
        delta = int(_rng().choice([-1, 1]) * _rng().choice(
            [100, 1000, 10_000, 60_000]
        ))
        return {"type": "info", "f": "bump", "value": delta}

    def strobe_op():
        return {
            "type": "info",
            "f": "strobe",
            "value": {
                "delta": int(_rng().choice([50, 200, 1000])),
                "period": 10,
                "duration": 1000,
            },
        }

    generator = cycle([
        gen_sleep(interval),
        once(mix([FnGen(bump_op), FnGen(strobe_op)])),
        gen_sleep(interval),
        {"type": "info", "f": "reset", "value": None},
    ])
    return _package(
        ClockNemesis(),
        generator,
        final_generator={"type": "info", "f": "reset", "value": None},
        perf=[{"name": "clock", "start": {"bump", "strobe"},
               "stop": {"reset"}}],
    )


def file_corruption_package(opts: dict) -> Optional[dict]:
    """Bitflips/truncation on DB files (combined.clj:402-481).
    opts["file-corruption"]: {"file": path, "targets": [...]}."""
    if "file-corruption" not in opts.get("faults", set()):
        return None
    fopts = opts.get("file-corruption", {}) or {}
    path = fopts.get("file")
    if path is None:
        return None
    interval = opts.get("interval", DEFAULT_INTERVAL)
    generator = cycle([
        gen_sleep(interval),
        once(mix([
            FnGen(lambda: {"type": "info", "f": "bitflip",
                           "value": {"file": path}}),
            FnGen(lambda: {"type": "info", "f": "truncate",
                           "value": {"file": path, "drop": 64}}),
        ])),
    ])
    return _package(
        compose([Bitflip(), TruncateFile()]),
        generator,
    )


def compose_packages(packages: Sequence[dict]) -> dict:
    """Unified package: composed nemesis, mixed generators, sequenced
    final generators (combined.clj:483-506)."""
    packages = [p for p in packages if p is not None]
    if not packages:
        return _package(noop, None)
    nem = compose([p["nemesis"] for p in packages])
    gens = [p["generator"] for p in packages if p["generator"] is not None]
    finals = [
        p["final-generator"] for p in packages
        if p.get("final-generator") is not None
    ]
    perf: list = []
    for p in packages:
        perf.extend(p.get("perf") or [])
    return _package(
        nem,
        mix(gens) if len(gens) > 1 else (gens[0] if gens else None),
        final_generator=finals or None,
        perf=perf,
    )


def _membership_package(opts: dict) -> Optional[dict]:
    from .membership import membership_package
    return membership_package(opts)


def _lazyfs_package(opts: dict) -> Optional[dict]:
    from ..lazyfs import lazyfs_package
    return lazyfs_package(opts)


def _faketime_package(opts: dict) -> Optional[dict]:
    from ..faketime import faketime_package
    return faketime_package(opts)


#: The family registry: name -> (faults served, constructor), in
#: composition order.  One constructor may serve several fault names
#: (kill and pause share one DBNemesis — building it twice would race
#: two nemeses over the same processes).  Constructors stay
#: capability-guarded: each may return None when its faults are absent
#: from opts["faults"] or a capability is missing (no corruption file
#: path, no FUSE for lazyfs, no faketime binary), and callers drop the
#: Nones.  Membership and friends import lazily to keep fault-free
#: startup cheap and cycle-free.
FAMILY_PACKAGES: dict = {
    "partition": ({"partition"}, partition_package),
    "db": ({"kill", "pause"}, db_package),
    "packet": ({"packet"}, packet_package),
    "clock": ({"clock"}, clock_package),
    "file-corruption": ({"file-corruption"}, file_corruption_package),
    "membership": ({"membership"}, _membership_package),
    "lazyfs": ({"lazyfs"}, _lazyfs_package),
    "faketime": ({"faketime"}, _faketime_package),
}


def registry_packages(opts: Optional[dict] = None) -> list:
    """Instantiates every registered package whose served faults
    intersect opts["faults"], in registry order.  Entries may be None
    (capability-guarded constructors); `compose_packages` drops them."""
    opts = opts or {}
    faults = set(opts.get("faults") or set())
    return [
        ctor(opts)
        for served, ctor in FAMILY_PACKAGES.values()
        if faults & served
    ]


def nemesis_package(opts: Optional[dict] = None) -> dict:
    """The one-stop constructor (combined.clj:508-568): opts["faults"]
    from the FAMILY_PACKAGES registry — {"partition", "kill", "pause",
    "packet", "clock", "file-corruption", "membership", "lazyfs",
    "faketime"} (membership needs opts["membership"]["state"], lazyfs
    needs FUSE, faketime needs opts["faketime"]["binary"])."""
    opts = opts or {}
    opts.setdefault("faults", {"partition"})
    return compose_packages(registry_packages(opts))
