"""Control-node filesystem cache.

Equivalent of jepsen/src/jepsen/fs_cache.clj (:1-44):
expensive setup artifacts — compiled DB binaries, downloaded tarballs,
pre-joined cluster state — are cached on the *control* node between
runs, addressed by logical paths (tuples of strings/ints/keyword-ish
values).  Writers are atomic (temp file + rename); `locking(path)`
serializes concurrent makers of one entry; remote save/deploy move
files between nodes and the cache through the control plane's Session.

Python idioms replace the Clojure surface: JSON instead of EDN for the
data format, context-manager locking, plain strings for paths on disk.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import threading
from typing import Any, Iterator, Optional, Sequence

#: Default cache root on the control node (fs_cache.clj stores under
#: /tmp/jepsen/cache; ours lives with the store by default).
DEFAULT_ROOT = os.path.join("store", "cache")

_locks: dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


class Cache:
    def __init__(self, root: str = DEFAULT_ROOT):
        self.root = root

    # -- path encoding ----------------------------------------------------

    def _encode_part(self, part: Any) -> str:
        from .utils import sanitize_path_part

        return sanitize_path_part(part)

    def file_path(self, path: Sequence[Any]) -> str:
        """The file backing a logical path."""
        if not path:
            raise ValueError("cache path may not be empty")
        parts = [self._encode_part(p) for p in path]
        return os.path.join(self.root, *parts[:-1], parts[-1] + ".cache")

    # -- predicates -------------------------------------------------------

    def cached(self, path: Sequence[Any]) -> bool:
        return os.path.exists(self.file_path(path))

    def clear(self, path: Optional[Sequence[Any]] = None) -> None:
        if path is None:
            shutil.rmtree(self.root, ignore_errors=True)
        else:
            with contextlib.suppress(FileNotFoundError):
                os.remove(self.file_path(path))

    # -- locking ----------------------------------------------------------

    @contextlib.contextmanager
    def locking(self, path: Sequence[Any]) -> Iterator[None]:
        """Serializes the makers of one cache path within this process."""
        key = self.file_path(path)
        with _locks_guard:
            lock = _locks.setdefault(key, threading.Lock())
        with lock:
            yield

    # -- atomic write plumbing --------------------------------------------

    @contextlib.contextmanager
    def _atomic(self, path: Sequence[Any]) -> Iterator[str]:
        dest = self.file_path(path)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(dest), prefix=".cache-tmp"
        )
        os.close(fd)
        try:
            yield tmp
            os.replace(tmp, dest)
        finally:
            with contextlib.suppress(FileNotFoundError):
                os.remove(tmp)

    # -- strings ----------------------------------------------------------

    def save_string(self, path: Sequence[Any], s: str) -> str:
        with self._atomic(path) as tmp:
            with open(tmp, "w") as f:
                f.write(s)
        return s

    def load_string(self, path: Sequence[Any]) -> Optional[str]:
        try:
            with open(self.file_path(path)) as f:
                return f.read()
        except FileNotFoundError:
            return None

    # -- data (JSON standing in for EDN) ----------------------------------

    def save_data(self, path: Sequence[Any], value: Any) -> Any:
        with self._atomic(path) as tmp:
            with open(tmp, "w") as f:
                json.dump(value, f)
        return value

    def load_data(self, path: Sequence[Any]) -> Any:
        s = self.load_string(path)
        return None if s is None else json.loads(s)

    # -- local files ------------------------------------------------------

    def save_file(self, src: str, path: Sequence[Any]) -> str:
        with self._atomic(path) as tmp:
            shutil.copyfile(src, tmp)
        return src

    def load_file(self, path: Sequence[Any]) -> Optional[str]:
        """The backing file's path, or None when uncached."""
        p = self.file_path(path)
        return p if os.path.exists(p) else None

    # -- remote files (fs_cache.clj save-remote!/deploy-remote!) ----------

    def save_remote(self, sess, remote_path: str,
                    path: Sequence[Any]) -> None:
        """Downloads a file from the session's node into the cache."""
        with self._atomic(path) as tmp:
            sess.download(remote_path, tmp)

    def deploy_remote(self, sess, path: Sequence[Any],
                      remote_path: str) -> bool:
        """Uploads a cached file to the session's node; False when the
        path is uncached."""
        local = self.load_file(path)
        if local is None:
            return False
        sess.upload(local, remote_path)
        return True


#: Module-level default instance, like the reference's implicit cache.
cache = Cache()

cached = cache.cached
clear = cache.clear
locking = cache.locking
save_string = cache.save_string
load_string = cache.load_string
save_data = cache.save_data
load_data = cache.load_data
save_file = cache.save_file
load_file = cache.load_file
save_remote = cache.save_remote
deploy_remote = cache.deploy_remote
