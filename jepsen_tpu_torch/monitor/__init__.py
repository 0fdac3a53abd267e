"""Standing-monitor support: rolling-window online checking with
history discard (`RollingChecker`).  The JAX package's `monitor/live.py`,
`loop.py` and `fleet.py` are not ported."""

from .rolling import RollingChecker

__all__ = ["RollingChecker"]
