"""Report redirection: run a block with stdout bound to a file.

Equivalent of jepsen/src/jepsen/report.clj's `to`
macro, as a context manager:

    with report.to(path):
        print("everything printed here lands in the file")
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Iterator


@contextlib.contextmanager
def to(filename: str) -> Iterator[None]:
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    with open(filename, "w") as w:
        old = sys.stdout
        sys.stdout = w
        try:
            yield
        finally:
            sys.stdout = old
            print(f"Report written to {filename}")
