"""End-to-end test suites against real systems.

The port's copy of `jepsen_tpu/suites/__init__.py`.

Equivalent of the reference's per-database projects (SURVEY.md §2.5 —
zookeeper/, etcd/, ...): each suite module provides a DB
implementation, a network client, workload assembly, and a CLI `main`,
following the zookeeper/src/jepsen/zookeeper.clj shape.
"""

__all__ = ["electd", "kvdb", "logd", "repkv", "txnd"]


def __getattr__(name):
    # Lazy, kvdb too (the reference imports kvdb here): the suites pull
    # in checker stacks, and `python -m jepsen_tpu_torch.suites.kvdb`
    # must not find its module imported before it runs.
    if name in __all__:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
