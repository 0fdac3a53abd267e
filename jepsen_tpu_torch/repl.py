"""Interactive exploration namespace (repl.clj's role): one import
that brings the whole toolkit into scope for a REPL session.  The
port's copy of `jepsen_tpu/repl.py`; the checkers run on the card
unless given `device="cpu"`.

    >>> from jepsen_tpu_torch.repl import *
    >>> t = store.load(store.latest())
    >>> h = History(list(t.iter_ops()))
    >>> checker.linearizable(models.cas_register()).check({}, h, {})
"""

from jepsen_tpu_torch import (  # noqa: F401
    checker,
    cli,
    client,
    codec,
    core,
    db,
    faketime,
    fs_cache,
    generator,
    lazyfs,
    models,
    nemesis,
    net,
    oses,
    reconnect,
    report,
    store,
    web,
)
from jepsen_tpu_torch.control import (  # noqa: F401
    DummyRemote,
    LocalRemote,
    Session,
    SshCliRemote,
    on_nodes,
    with_sessions,
)
from jepsen_tpu_torch.history import History, Op, history  # noqa: F401
from jepsen_tpu_torch.parallel.independent import (  # noqa: F401
    KV,
    independent_checker,
)
