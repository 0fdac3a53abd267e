"""The port's suite host layer (control/remotes.py's local and retrying
remotes, control/util.py, the nemesis packages, faults, partitioners
and membership, net.py's nets, db.py's Tcpdump and ComposedDB, oses.py,
the utils helpers) against the JAX package's own tests, on the CPU:
tests/test_control.py, tests/test_nemesis_packages.py,
tests/test_membership.py and tests/test_utils.py run through
`jepsen_tpu_torch` (tests/torch_ported.py rewrites their imports)."""

import pytest

import torch_ported

#: Cases of the JAX test files that test modules the port does not have
#: yet, by the ROADMAP.md Queue A item that will port them.
NOT_PORTED = {
    # checker/perf.py and checker/clock.py: item 6.
    "test_perf_checkers_render",
    "test_clock_plot",
}

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
    else of the four files is left out."""
    assert NOT_PORTED <= set(torch_ported.cases(NEMESIS))
    assert len(torch_ported.cases(CONTROL)) == 32
    assert len(set(torch_ported.cases(NEMESIS)) - NOT_PORTED) == 11
    assert len(torch_ported.cases(MEMBERSHIP)) == 3
    assert len(torch_ported.cases(UTILS)) == 10


@pytest.mark.parametrize("family", ["lazyfs", "faketime"])
def test_unported_fault_families_raise_with_their_item(family):
    """The lazyfs and faketime families stay in the registry and raise,
    naming the ROADMAP item that ports them."""
    from jepsen_tpu_torch.nemesis import combined

    assert family in combined.FAMILY_PACKAGES
    with pytest.raises(NotImplementedError, match="Queue A item 4"):
        combined.nemesis_package({"faults": {family}})
