"""Online (streaming) checking: check the history while the run is
still producing it.

The port of `jepsen_tpu/streaming/`.  The producer tees each op into a
`StreamingSession` (pipeline.py): a double-buffered ingest whose
checker thread packs the ops into appendable per-key packers
(history/packed.py `PackedBuilder`) and advances device work: an
incremental `FrontierCarry` (frontier.py) over a single stream, or
batched stream-witness passes over keys that have gone quiet.  When the
run ends most keys already carry a verdict; `Linearizable` and
`IndependentChecker` take it by packed-digest match, and only the rest
pays the post-hoc ladder.

Enable with `test["streaming"]` or `JEPSEN_STREAMING=1`.  With a
checkerd address (`test["checkerd"]`, `--remote`, or JEPSEN_CHECKERD)
the session also streams each key's ops to that daemon or router while
the run goes on (remote.py `RemoteFeed`), and RemoteChecker consumes
the ticket at analyze instead of uploading the history again.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Union

import torch

from .frontier import FrontierCarry
from .pipeline import StreamingSession

log = logging.getLogger(__name__)

__all__ = ["FrontierCarry", "StreamingSession", "maybe_session",
           "streaming_enabled"]


def streaming_enabled(test: dict) -> bool:
    """Whether this run asked for online checking (`test["streaming"]`
    or the JEPSEN_STREAMING environment variable)."""
    if test.get("streaming"):
        return True
    env = os.environ.get("JEPSEN_STREAMING", "")
    return env not in ("", "0", "false", "no")


def maybe_session(test: dict, *,
                  device: Union[str, torch.device, None] = "cuda"
                  ) -> Optional[StreamingSession]:
    """A StreamingSession for this run on `device`, or None when the
    test has no model with a packed form (online checking needs it;
    host-only models stay post-hoc)."""
    model = test.get("model")
    if model is None:
        log.info("streaming requested but the test has no model; "
                 "checking stays post-hoc")
        return None
    try:
        pm = model.packed()
    except (NotImplementedError, AttributeError):
        log.info("streaming requested but model %s has no packed form; "
                 "checking stays post-hoc", type(model).__name__)
        return None
    remote = None
    addr = test.get("checkerd") or os.environ.get("JEPSEN_CHECKERD")
    if addr:
        from ..ops import degrade

        try:
            from .remote import remote_feed_for

            remote = remote_feed_for(str(addr), test, model)
        except Exception as e:  # noqa: BLE001 — the feed is optional
            # Without a feed the post-hoc submission covers the upload;
            # a device fault is not a feed's to swallow.
            if degrade.is_device_fault(e):
                raise
            log.info("streaming remote feed unavailable: %s", e)
    return StreamingSession(pm, device=device, remote=remote,
                            run_id=str(test.get("name") or "run"))
