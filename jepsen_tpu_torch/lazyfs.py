"""lazyfs: lose data that was written but never fsynced.

Equivalent of jepsen/src/jepsen/lazyfs.clj (:22-100):
mount a directory on the lazyfs FUSE filesystem, whose page cache can
be dropped on command — un-fsynced writes vanish, exactly the fault
class real disks exhibit on power loss.  The pieces:

  * `LazyFS` — the file layout map for one mounted directory
    (lazyfs.clj:110-150): backing data dir, control fifo, config, log.
  * `install(sess)` — clone + build lazyfs on the node
    (lazyfs.clj:68-108; needs network + fuse on the DB node, so
    container/integration environments only).
  * `mount(sess)` / `umount(sess)` — lifecycle (lazyfs.clj:165-220).
  * `lose_unfsynced_writes(sess)` — the fault itself, sent over the
    fifo (lazyfs.clj:222-232 fifo! + "lazyfs::clear-cache").
  * `LazyFSDB` — wraps any DB so its directory rides lazyfs and its
    logs include the lazyfs log (lazyfs.clj DB record).
  * `lazyfs_package` — a nemesis package injecting the fault on a
    cycle, routed to the wrapped DB (reusable fault layer, unlike a
    per-DB opt-in).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Optional

from . import db as jdb
from .control import Session, on_nodes
from .history import Op
from .nemesis.core import Nemesis
from .nemesis.faults import BUILD_DIR

log = logging.getLogger(__name__)

REPO_URL = "https://github.com/dsrhaslab/lazyfs.git"
COMMIT = "0.2.0"
INSTALL_DIR = f"{BUILD_DIR}/lazyfs"
BIN = f"{INSTALL_DIR}/lazyfs/build/lazyfs"
FUSE_DEV = "/dev/fuse"


@dataclass
class LazyFS:
    """File layout for one lazyfs mount (lazyfs.clj:110-150)."""

    dir: str
    lazyfs_dir: str = ""
    data_dir: str = ""
    fifo: str = ""
    config_file: str = ""
    log_file: str = ""
    user: str = "root"
    cache_size: str = "0.5GB"

    def __post_init__(self) -> None:
        self.lazyfs_dir = self.lazyfs_dir or self.dir + ".lazyfs"
        self.data_dir = self.data_dir or self.lazyfs_dir + "/data"
        self.fifo = self.fifo or self.lazyfs_dir + "/fifo"
        self.config_file = self.config_file or self.lazyfs_dir + "/config"
        self.log_file = self.log_file or self.lazyfs_dir + "/log"

    def config(self) -> str:
        """Config file text (lazyfs.clj:42-60)."""
        return (
            "[faults]\n"
            f'fifo_path="{self.fifo}"\n'
            "[cache]\n"
            "apply_eviction=false\n"
            "[cache.simple]\n"
            f'custom_size="{self.cache_size}"\n'
            "blocks_per_page=1\n"
            "[filesystem]\n"
            f'logfile="{self.log_file}"\n'
            "log_all_operations=false\n"
        )

    # -- lifecycle --------------------------------------------------------

    def install(self, sess: Session) -> None:
        """Builds lazyfs on the node (lazyfs.clj:68-108).  Node
        environment prep (fuse device, fuse.conf) always runs — a fresh
        container may carry a prebuilt /opt volume; only the fetch +
        builds are skipped when the pinned commit's binary is already
        there (every DB cycle calls this, and `git clean -fx` would
        otherwise force a from-scratch rebuild per run)."""
        with sess.su():
            # Environment prep: idempotent, must run even when the
            # binary is cached (LXC/containers lose /dev/fuse).
            if sess.exec_star("test", "-e", FUSE_DEV).get("exit") != 0:
                sess.exec("mknod", FUSE_DEV, "c", "10", "229")
                sess.exec("chmod", "a+rw", FUSE_DEV)
            built = sess.exec_star("test", "-x", BIN).get("exit") == 0
            if built:
                at = sess.exec_star(
                    "git", "-C", INSTALL_DIR, "describe", "--tags",
                    "--always",
                )
                if COMMIT in (at.get("out") or ""):
                    # Cached build: fuse.conf exists iff fuse3 was ever
                    # installed; gate the sed so a stripped image
                    # doesn't crash here.
                    if sess.exec_star(
                        "test", "-e", "/etc/fuse.conf"
                    ).get("exit") == 0:
                        sess.exec(
                            "sed", "-i",
                            r"/\s*user_allow_other/s/^#//g",
                            "/etc/fuse.conf",
                        )
                    return
            sess.exec(
                "env", "DEBIAN_FRONTEND=noninteractive",
                "apt-get", "install", "-y",
                "g++", "cmake", "libfuse3-dev", "libfuse3-3", "fuse3",
                "git",
            )
            # fuse3 ships /etc/fuse.conf; enable user_allow_other.
            sess.exec(
                "sed", "-i", r"/\s*user_allow_other/s/^#//g",
                "/etc/fuse.conf",
            )
            if sess.exec_star("test", "-e", INSTALL_DIR).get("exit") != 0:
                sess.exec("mkdir", "-p",
                          INSTALL_DIR.rsplit("/", 1)[0])
                sess.exec("git", "clone", REPO_URL, INSTALL_DIR)
            with sess.cd(INSTALL_DIR):
                sess.exec("git", "fetch")
                sess.exec("git", "checkout", COMMIT)
                sess.exec("git", "clean", "-fx")
            with sess.cd(f"{INSTALL_DIR}/libs/libpcache"):
                sess.exec("./build.sh")
            with sess.cd(f"{INSTALL_DIR}/lazyfs"):
                sess.exec("./build.sh")

    def mount(self, sess: Session) -> "LazyFS":
        """Creates dirs + config and starts the daemon
        (lazyfs.clj:165-195)."""
        with sess.su():
            sess.exec("mkdir", "-p", self.dir)
            sess.exec("mkdir", "-p", self.data_dir)
            sess.exec("touch", self.log_file)
            sess.exec("tee", self.config_file, stdin=self.config())
            with sess.cd(f"{INSTALL_DIR}/lazyfs"):
                sess.exec(
                    "scripts/mount-lazyfs.sh",
                    "-c", self.config_file,
                    "-m", self.dir,
                    "-r", self.data_dir,
                )
        return self

    def mounted(self, sess: Session) -> bool:
        res = sess.exec_star("findmnt", self.dir)
        return res.get("exit") == 0 and "lazyfs" in (res.get("out") or "")

    def umount(self, sess: Session) -> None:
        """Stops lazyfs and destroys its state (lazyfs.clj:198-217)."""
        with sess.su():
            try:
                self.lose_unfsynced_writes(sess)
            except Exception:  # noqa: BLE001 — best effort, like `meh`
                pass
            sess.exec_star("fusermount", "-uz", self.dir)
            sess.exec("rm", "-rf", self.lazyfs_dir)

    # -- faults -----------------------------------------------------------

    def send_fifo(self, sess: Session, cmd: str) -> None:
        """Sends a command to the lazyfs control fifo
        (lazyfs.clj:219-228)."""
        sess.exec("bash", "-c", f"echo {cmd} > {self.fifo}",
                  timeout=10)

    def lose_unfsynced_writes(self, sess: Session) -> None:
        """Drop the page cache: un-fsynced writes are gone
        (lazyfs.clj:230-238)."""
        log.info("lazyfs: losing un-fsynced writes under %s", self.dir)
        self.send_fifo(sess, "lazyfs::clear-cache")

    def checkpoint(self, sess: Session) -> None:
        """Sync everything to the backing fs (lazyfs::cache-checkpoint)."""
        self.send_fifo(sess, "lazyfs::cache-checkpoint")


class LazyFSDB(jdb.DB):
    """Wraps a DB so its data directory rides a lazyfs mount; composes
    setup/teardown and exposes the lazyfs log (lazyfs.clj DB record)."""

    def __init__(self, db: jdb.DB, lazyfs: LazyFS):
        self.db = db
        self.lazyfs = lazyfs

    def setup(self, test: dict, sess: Session, node: str) -> None:
        self.lazyfs.install(sess)
        self.lazyfs.mount(sess)
        self.db.setup(test, sess, node)

    def teardown(self, test: dict, sess: Session, node: str) -> None:
        self.db.teardown(test, sess, node)
        self.lazyfs.umount(sess)

    def log_files(self, test: dict, sess: Session, node: str):
        files = list(self.db.log_files(test, sess, node) or [])
        files.append(self.lazyfs.log_file)
        return files

    def lose_unfsynced_writes(self, test: dict, sess: Session,
                              node: str) -> None:
        self.lazyfs.lose_unfsynced_writes(sess)

    # Delegate the capability protocols so Kill/Pause sniffing still
    # sees the inner DB (db.clj:16-33).
    def kill(self, test, sess, node):
        return self.db.kill(test, sess, node)

    def start(self, test, sess, node):
        return self.db.start(test, sess, node)

    def pause(self, test, sess, node):
        return self.db.pause(test, sess, node)

    def resume(self, test, sess, node):
        return self.db.resume(test, sess, node)

    def primaries(self, test):
        return self.db.primaries(test)


class LazyFSNemesis(Nemesis):
    """Injects lose-unfsynced-writes on nodes whose DB rides lazyfs.
    Usually composed right after a kill so the crash also eats the page
    cache, like a power failure."""

    def invoke(self, test: dict, op: Op) -> Op:
        db = test["db"]
        if not hasattr(db, "lose_unfsynced_writes"):
            return op.replace(value="db has no lazyfs")
        nodes = op.value if isinstance(op.value, list) else None

        def act(sess: Session, node: str):
            db.lose_unfsynced_writes(test, sess, node)
            return "lost"

        return op.replace(value=on_nodes(test, act, nodes))

    def fs(self) -> set:
        return {"lose-unfsynced-writes"}


def lazyfs_package(opts: dict) -> Optional[dict]:
    """Nemesis package: periodically drop un-fsynced writes
    ({"faults": {"lazyfs", ...}})."""
    if "lazyfs" not in (opts.get("faults") or set()):
        return None
    from .generator.core import cycle, sleep as gen_sleep

    interval = opts.get("interval", 10.0)
    return {
        "nemesis": LazyFSNemesis(),
        "generator": cycle([
            gen_sleep(interval),
            {"type": "info", "f": "lose-unfsynced-writes", "value": None},
        ]),
        "final-generator": None,
        "perf": [{"name": "lazyfs", "start": {"lose-unfsynced-writes"},
                  "stop": set()}],
    }
