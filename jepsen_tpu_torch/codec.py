"""Object <-> bytes serialization for wire payloads.

Equivalent of jepsen/src/jepsen/codec.clj (EDN bytes);
the Python-native data format here is JSON.  None maps to empty bytes
both ways, like the reference's nil."""

from __future__ import annotations

import json
from typing import Any, Optional


def encode(o: Any) -> bytes:
    if o is None:
        return b""
    return json.dumps(o, sort_keys=True).encode()


def decode(data: Optional[bytes]) -> Any:
    if not data:
        return None
    return json.loads(data.decode())
