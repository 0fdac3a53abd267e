"""The port's suite host layer (control/remotes.py's local and retrying
remotes, control/util.py, the nemesis packages, faults, partitioners
and membership, net.py's nets, db.py's Tcpdump and ComposedDB, oses.py,
the utils helpers) against the JAX package's own tests, on the CPU:
tests/test_control.py, tests/test_nemesis_packages.py,
tests/test_membership.py and tests/test_utils.py run through
`jepsen_tpu_torch` (tests/torch_ported.py rewrites their imports),
and the lazyfs and faketime fault families against the JAX
package's."""

import pytest

import torch_ported

#: Cases of the JAX test files that test modules the port does not have
#: yet, by the ROADMAP.md Queue A item that will port them: none.
NOT_PORTED: set = set()

CONTROL = torch_ported.load("test_control")
NEMESIS = torch_ported.load("test_nemesis_packages")
MEMBERSHIP = torch_ported.load("test_membership")
UTILS = torch_ported.load("test_utils")

MODULES = (CONTROL, NEMESIS, MEMBERSHIP, UTILS)


@pytest.mark.parametrize(
    "mod, case",
    [(m, c) for m in MODULES for c in torch_ported.cases(m, NOT_PORTED)],
    ids=lambda x: x if isinstance(x, str) else x.__name__[len("ported_"):])
def test_control_cases_through_the_port(mod, case, request):
    torch_ported.run(mod, case, request)


def test_every_excluded_case_exists():
    """NOT_PORTED names real cases of test_nemesis_packages.py: nothing
    else of the four files is left out (the perf and clock plots run
    since checker/perf.py and checker/clock.py are ported)."""
    assert NOT_PORTED <= set(torch_ported.cases(NEMESIS))
    assert {"test_perf_checkers_render", "test_clock_plot"} <= set(
        torch_ported.cases(NEMESIS))
    assert len(torch_ported.cases(CONTROL)) == 32
    assert len(set(torch_ported.cases(NEMESIS)) - NOT_PORTED) == 13
    assert len(torch_ported.cases(MEMBERSHIP)) == 3
    assert len(torch_ported.cases(UTILS)) == 10


@pytest.mark.parametrize("family", ["lazyfs", "faketime"])
def test_lazyfs_and_faketime_families_build(family):
    """The lazyfs and faketime families build their packages through
    the registry as the reference's do: the same ops, the same perf
    bands, and nothing without the capability (faketime's binary)."""
    from jepsen_tpu.nemesis import combined as rcombined
    from jepsen_tpu_torch.nemesis import combined

    opts = {"faults": {family}, "interval": 0.1,
            "faketime": {"binary": "/usr/bin/db"}}
    ours = combined.nemesis_package(opts)
    ref = rcombined.nemesis_package(opts)
    assert ours["nemesis"].fs() == ref["nemesis"].fs()
    assert ours["perf"] == ref["perf"]
    want = {"lazyfs": {"lose-unfsynced-writes"},
            "faketime": {"start-faketime", "stop-faketime"}}[family]
    assert want <= set(ours["nemesis"].fs())
    bare = {k: v for k, v in opts.items() if k != "faketime"}
    assert (combined.nemesis_package(bare)["nemesis"].fs()
            == rcombined.nemesis_package(bare)["nemesis"].fs())
