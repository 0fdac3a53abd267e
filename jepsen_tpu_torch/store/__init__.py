"""Persistence: test directories, save phases, logging.

The port's copy of `jepsen_tpu/store/__init__.py`; the same directory
layout and test file, so either package loads the other's runs.  One
key more is kept out of the stored test map: "history-reviver", the
function a workload gives to turn stored op values back into the ones
it ran with (`core.rerun_analysis`).

Equivalent of jepsen/store.clj: test dirs
``store/<name>/<start-time>/`` (:40-62), the non-serializable-keys strip
(:92-101), the three save phases (:426-466), plain-text history dumps
(:369-386), ``current``/``latest`` symlinks (:310-340), per-test log
files (:484-504), and loading/querying past tests (:122-283).

The binary block format lives in `store/format.py`.
"""

from __future__ import annotations

import datetime as _dt
import logging
import os
import shutil
from typing import Any, Iterator, Optional

from ..history.core import History, Op
from .format import CHUNK_SIZE, Handle, HistoryWriter, TestFile

#: Test-map keys that hold live objects and never serialize
#: (store.clj:92-101).
NONSERIALIZABLE_KEYS = (
    "client",
    "nemesis",
    "generator",
    "checker",
    "model",
    "net",
    "db",
    "os",
    "remote",
    "sessions",
    "barrier",
    "store",
    # Live FaultLedger handle; its durable form is nemesis.ledger in
    # the same store dir.
    "fault-ledger",
    # Live HealthMonitor + a test-supplied probe callable; their durable
    # form is results["resilience"]["nodes"].
    "node-health",
    "health-probe",
    # Live StreamingSession (streaming/); its durable form
    # is results["streaming"].
    "streaming-session",
    # The workload's stored-value decoder (core.rerun_analysis).
    "history-reviver",
    # Run outputs saved in their own blocks, not inside the test map:
    "history",
    "results",
)

TEST_FILE = "test.jtpu"
LOG_FILE = "jepsen.log"

log = logging.getLogger(__name__)


def serializable_test(test: dict) -> dict:
    return {k: v for k, v in test.items() if k not in NONSERIALIZABLE_KEYS}


def base_dir(test_or_root: Any = None) -> str:
    """The store root: test["store-dir"] or ./store (store.clj:33-38)."""
    if isinstance(test_or_root, str):
        return test_or_root
    if isinstance(test_or_root, dict):
        return test_or_root.get("store-dir", "store")
    return "store"


def time_str(t: Optional[_dt.datetime] = None) -> str:
    t = t or _dt.datetime.now()
    return t.strftime("%Y%m%dT%H%M%S.%f")[:-3]


def test_dir(test: dict) -> str:
    """store/<name>/<start-time>/ (store.clj:40-62)."""
    name = test.get("name", "noname")
    start = test.get("start-time")
    if start is None:
        raise ValueError("test has no start-time; call make_test_dir first")
    return os.path.join(base_dir(test), str(name), str(start))


def path(test: dict, *more: str) -> str:
    return os.path.join(test_dir(test), *more)


def make_test_dir(test: dict) -> dict:
    """Assigns a start-time (if absent), creates the directory, and
    points the `current` and `latest` symlinks at it."""
    test = dict(test)
    test.setdefault("start-time", time_str())
    d = test_dir(test)
    os.makedirs(d, exist_ok=True)
    _update_symlinks(test)
    return test

def _update_symlinks(test: dict) -> None:
    d = test_dir(test)
    name_dir = os.path.dirname(d)
    root = base_dir(test)
    for link_dir, link_name in ((name_dir, "latest"), (root, "current")):
        link = os.path.join(link_dir, link_name)
        try:
            if os.path.islink(link):
                os.unlink(link)
            os.symlink(os.path.relpath(d, link_dir), link)
        except OSError as e:  # pragma: no cover - symlink-less filesystems
            log.debug("couldn't update symlink %s: %s", link, e)


class Store:
    """with-handle for one test run: the open block file plus txt dumps
    (store.clj:412-424)."""

    def __init__(self, test: dict):
        self.test = test
        self.dir = test_dir(test)
        self.handle = Handle(os.path.join(self.dir, TEST_FILE))

    # -- save phases (store.clj:426-466) -------------------------------

    def save_0(self, test: dict) -> None:
        self.handle.save_test(serializable_test(test))

    def history_writer(self, chunk_size: int = CHUNK_SIZE) -> HistoryWriter:
        return self.handle.open_history_writer(chunk_size)

    def save_1(self, test: dict, history: History) -> None:
        self.handle.save_run(serializable_test(test))
        write_history_txt(os.path.join(self.dir, "history.txt"), history)

    def save_2(self, results: dict) -> None:
        self.handle.save_results(results)

    def close(self) -> None:
        self.handle.close()

    def __enter__(self) -> "Store":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def write_history_txt(p: str, history: History) -> None:
    """Plain-text one-op-per-line dump (store.clj:369-386)."""
    with open(p, "w") as f:
        for op in history:
            f.write(str(op))
            f.write("\n")


def start_logging(test: dict, *, console: bool = False) -> logging.Handler:
    """Attaches a jepsen.log file handler for this test's directory
    (store.clj:484-504).  Returns the handler; pass it to stop_logging."""
    handler = logging.FileHandler(path(test, LOG_FILE))
    handler.setFormatter(
        logging.Formatter(
            "%(asctime)s %(levelname)s [%(threadName)s] %(name)s: %(message)s"
        )
    )
    root = logging.getLogger()
    root.addHandler(handler)
    if root.level > logging.INFO or root.level == logging.NOTSET:
        root.setLevel(logging.INFO)
    return handler


def stop_logging(handler: logging.Handler) -> None:
    logging.getLogger().removeHandler(handler)
    handler.close()


# -- reading past tests (store.clj:122-283) -----------------------------


def load(d: str) -> TestFile:
    """Opens a stored test dir (or .jtpu file) for reading."""
    if os.path.isdir(d):
        d = os.path.join(d, TEST_FILE)
    return TestFile(d)


def tests(root: str = "store") -> dict[str, dict[str, str]]:
    """{test-name: {start-time: dir}} of all stored runs."""
    out: dict[str, dict[str, str]] = {}
    if not os.path.isdir(root):
        return out
    for name in sorted(os.listdir(root)):
        name_dir = os.path.join(root, name)
        if not os.path.isdir(name_dir) or name in ("current", "latest"):
            continue
        runs = {}
        for t in sorted(os.listdir(name_dir)):
            d = os.path.join(name_dir, t)
            if os.path.isdir(d) and not os.path.islink(d):
                runs[t] = d
        if runs:
            out[name] = runs
    return out


def latest(root: str = "store") -> Optional[str]:
    """The most recent run dir: the `current` symlink when it resolves,
    else the newest run found by scanning (symlink-less filesystems,
    deleted runs)."""
    link = os.path.join(root, "current")
    if os.path.islink(link):
        target = os.path.realpath(link)
        if os.path.isdir(target):
            return target
    newest: Optional[str] = None
    newest_time = ""
    for runs in tests(root).values():
        for t, d in runs.items():
            if t > newest_time:
                newest_time, newest = t, d
    return newest


def delete(root: str = "store", name: Optional[str] = None) -> None:
    """Deletes stored tests (store.clj:523-531)."""
    target = os.path.join(root, name) if name else root
    if os.path.isdir(target):
        shutil.rmtree(target)
