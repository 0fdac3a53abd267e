"""Network-namespace micro-cluster: real kernel network faults in CI.

The port's copy of `jepsen_tpu/control/netns.py`; its namespaces run
the port's minissh daemons.  It needs the `ip` binary and
CAP_NET_ADMIN (`netns_available()` probes both).

The reference's bread-and-butter fault — the partitioner
(jepsen/src/jepsen/nemesis.clj:158-184) cutting links with kernel
packet-filter rules (jepsen/src/jepsen/net.clj:177-233) — normally
needs a multi-machine cluster or docker.  This environment has
neither, but it has root and namespace syscalls, which is all a real
kernel-enforced partition needs: one network namespace per node, a
veth into a shared bridge, real IPs, real TCP between the node
processes, and route/tc manipulation *inside each node's namespace*.

Topology (``NetnsCluster``)::

    root ns:   br-<tag>  10.<a>.<b>.1/24
    node i:    ns <tag>-n<i>, veth eth0 10.<a>.<b>.(10+i)/24 -> bridge

The device inside every namespace is literally named ``eth0``, so the
tc-based shaping paths written against real clusters run unmodified.
The control plane reaches node processes from the root namespace
through the bridge address, so injected node<->node partitions never
sever the nemesis/client path to a node that is merely partitioned
from its peers (the same property a real jepsen control node has).

``NetnsRemote`` is the matching transport: ``ip netns exec <ns>``.
Filesystem and PIDs are intentionally shared (exactly like the
reference's docker remote shares the host kernel) — the isolation
under test is the network.

This CI kernel ships no iptables/nft userspace and no sch_netem, so
the partition mechanism is blackhole routes (``net.RouteNet``)
and rate shaping is tbf — both verified kernel-level.  On kernels
with the netem qdisc, IptablesNet's netem paths work inside the
namespaces too (same eth0 naming).
"""

from __future__ import annotations

import hashlib
import itertools
import os
import shutil
import subprocess
from typing import Optional, Sequence

from .core import ConnSpec, Remote, RemoteError

_IP = "ip"


def _run(*args: str, check: bool = True) -> subprocess.CompletedProcess:
    proc = subprocess.run(list(args), capture_output=True, text=True)
    if check and proc.returncode != 0:
        raise RemoteError(
            f"{' '.join(args)!r} failed ({proc.returncode}): "
            f"{proc.stderr.strip()}"
        )
    return proc


def netns_available() -> bool:
    """Whether this environment can create network namespaces + veth
    devices (requires root or CAP_NET_ADMIN and the ip binary).
    Probes by actually creating and deleting a throwaway pair."""
    if shutil.which(_IP) is None:
        return False
    probe = f"jtprobe{os.getpid() % 10000}"
    try:
        if _run(_IP, "netns", "add", probe, check=False).returncode != 0:
            return False
        ok = _run(
            _IP, "link", "add", f"v{probe}a", "type", "veth",
            "peer", "name", f"v{probe}b", check=False,
        ).returncode == 0
        if ok:
            _run(_IP, "link", "del", f"v{probe}a", check=False)
        return ok
    finally:
        _run(_IP, "netns", "del", probe, check=False)


class NetnsCluster:
    """Creates and tears down the namespace topology.

    Node names are ``n1..nN`` (suite convention); ``addresses`` maps
    them to in-cluster IPs for ``test["node-addresses"]``.  The /24 is
    derived from the tag so concurrent clusters (parallel tests) don't
    collide."""

    #: In-process uniquifier: pid alone would hand two concurrent
    #: clusters in one process identical bridge/netns names.
    _seq = itertools.count()

    def __init__(self, n_nodes: int = 3, tag: Optional[str] = None):
        if not 1 <= n_nodes <= 200:
            raise ValueError(f"n_nodes {n_nodes} out of range")
        self.n_nodes = n_nodes
        self.tag = tag or "jt%05x" % (
            (os.getpid() * 97 + next(self._seq)) % 0x100000
        )
        if len(self.tag) > 8:  # veth names cap at 15 chars: tag+v+idx
            raise ValueError(f"tag {self.tag!r} too long")
        h = int(hashlib.sha256(self.tag.encode()).hexdigest(), 16)
        self.subnet = f"10.{200 + h % 50}.{h // 50 % 250}"
        self.bridge = f"br-{self.tag}"
        self.created = False

    # -- naming ----------------------------------------------------------

    @property
    def nodes(self) -> list[str]:
        return [f"n{i + 1}" for i in range(self.n_nodes)]

    def netns_of(self, node: str) -> str:
        return f"{self.tag}-{node}"

    def address_of(self, node: str) -> str:
        i = self.nodes.index(node)
        return f"{self.subnet}.{10 + i + 1}"

    @property
    def addresses(self) -> dict[str, str]:
        return {n: self.address_of(n) for n in self.nodes}

    @property
    def control_address(self) -> str:
        return f"{self.subnet}.1"

    # -- lifecycle -------------------------------------------------------

    def create(self) -> "NetnsCluster":
        try:
            _run(_IP, "link", "add", self.bridge, "type", "bridge")
            _run(_IP, "addr", "add", f"{self.control_address}/24",
                 "dev", self.bridge)
            _run(_IP, "link", "set", self.bridge, "up")
            for i, node in enumerate(self.nodes):
                ns = self.netns_of(node)
                veth = f"{self.tag}v{i + 1}"
                _run(_IP, "netns", "add", ns)
                _run(_IP, "link", "add", veth, "type", "veth",
                     "peer", "name", "eth0", "netns", ns)
                _run(_IP, "link", "set", veth, "master", self.bridge,
                     "up")
                _run(_IP, "-n", ns, "addr", "add",
                     f"{self.address_of(node)}/24", "dev", "eth0")
                _run(_IP, "-n", ns, "link", "set", "eth0", "up")
                _run(_IP, "-n", ns, "link", "set", "lo", "up")
        except Exception:
            self.destroy()
            raise
        self.created = True
        return self

    def destroy(self) -> None:
        for node in self.nodes:
            _run(_IP, "netns", "del", self.netns_of(node), check=False)
        _run(_IP, "link", "del", self.bridge, check=False)
        self.created = False

    def __enter__(self) -> "NetnsCluster":
        return self.create()

    def __exit__(self, *exc) -> None:
        self.destroy()

    # -- test-map wiring -------------------------------------------------

    def test_overlay(self) -> dict:
        """The test-map entries that bind a suite to this cluster:
        nodes, their in-cluster addresses, the netns transport, the
        kernel-level net implementation, and the no-sudo flag (the
        transport is already root; sudo-less CI images must not wrap
        commands in a nonexistent binary)."""
        from ..net import RouteNet

        return {
            "nodes": self.nodes,
            "node-addresses": self.addresses,
            "remote": NetnsRemote(self),
            "ssh": {"no-sudo": True},
            "net": RouteNet(),
        }


class NetnsSshCluster:
    """NetnsCluster + one minissh daemon per namespace: a full
    SSH-reachable micro-cluster on one root machine — the netns
    analogue of the reference's docker harness (docker/bin/up boots
    sshd containers; here each namespace runs
    `python -m jepsen_tpu_torch.control.minissh.server` bound to its own
    IP).  The SshCliRemote then drives REAL ssh/scp wire traffic over
    the veth network (via the minissh/bin shims when OpenSSH isn't
    installed), and kernel-level faults (RouteNet) apply to the
    control plane's own packets exactly as they would on a physical
    cluster."""

    def __init__(self, n_nodes: int = 3, port: int = 2200,
                 tag: Optional[str] = None,
                 work_dir: Optional[str] = None):
        import tempfile

        self.net = NetnsCluster(n_nodes, tag)
        self.port = port
        self.work_dir = work_dir or tempfile.mkdtemp(prefix="jt-sshns-")
        self.procs: list = []
        self.key_path: Optional[str] = None

    def create(self) -> "NetnsSshCluster":
        import sys

        from .minissh.server import generate_keypair

        self.net.create()
        try:
            self.key_path, _ = generate_keypair(self.work_dir)
            for node in self.net.nodes:
                addr = self.net.address_of(node)
                root = os.path.join(self.work_dir, node)
                os.makedirs(root, exist_ok=True)
                # -c instead of -m: the package imports .server, and
                # runpy would warn about re-executing a loaded module.
                code = ("from jepsen_tpu_torch.control.minissh.server "
                        "import main; raise SystemExit(main())")
                proc = subprocess.Popen(
                    [_IP, "netns", "exec", self.net.netns_of(node),
                     sys.executable, "-c", code,
                     "--host", addr, "--port", str(self.port),
                     "--authorized-keys", self.key_path + ".pub",
                     "--hostname", node, "--root-dir", root],
                    stdout=subprocess.PIPE,
                )
                # Register before the handshake check: a daemon that
                # printed garbage is still alive and must be killed
                # by the destroy() below.
                self.procs.append(proc)
                line = proc.stdout.readline()
                if not line.startswith(b"listening"):
                    raise RemoteError(
                        f"minissh on {node} failed to start: {line!r}"
                    )
        except Exception:
            self.destroy()
            raise
        return self

    def destroy(self) -> None:
        for p in self.procs:
            try:
                p.kill()
                p.wait(timeout=5)  # reap: no zombie per node
            except (OSError, subprocess.TimeoutExpired):
                pass
        self.procs.clear()
        self.net.destroy()
        # The work dir holds the generated private key — remove it.
        shutil.rmtree(self.work_dir, ignore_errors=True)

    def __enter__(self) -> "NetnsSshCluster":
        return self.create()

    def __exit__(self, *exc) -> None:
        self.destroy()

    @property
    def ssh_nodes(self) -> list[str]:
        """host:port node names for the test map — the host part is
        the node's real in-cluster IP, so Net implementations need no
        node-addresses aliases."""
        return [
            f"{self.net.address_of(n)}:{self.port}"
            for n in self.net.nodes
        ]


class NetnsRemote(Remote):
    """``ip netns exec`` transport: the node name resolves to its
    namespace through the cluster; commands run on this host but with
    the node's network identity.  Upload/download are plain file
    copies (shared mount namespace — the docker-remote trade-off,
    control/docker.clj:30-92, applied to netns)."""

    # Packet faults land inside the node's private netns and cannot
    # wound the control host; the clock stays machine-global.
    isolation = frozenset({"net"})

    def __init__(self, cluster: NetnsCluster):
        self.cluster = cluster
        self.spec: Optional[ConnSpec] = None

    def _node_of(self, host: str) -> str:
        """Accepts a node name or its cluster address; returns the
        node name (namespaces are keyed by name)."""
        if host in self.cluster.nodes:
            return host
        for node, addr in self.cluster.addresses.items():
            if addr == host:
                return node
        raise RemoteError(
            f"{host!r} is not a node of cluster {self.cluster.tag!r}"
        )

    def connect(self, spec: ConnSpec) -> "NetnsRemote":
        self._node_of(spec.host)  # membership check, fail at connect
        r = NetnsRemote(self.cluster)
        r.spec = spec
        return r

    def execute(self, action: dict) -> dict:
        ns = self.cluster.netns_of(self._node_of(self.spec.host))
        try:
            proc = subprocess.run(
                [_IP, "netns", "exec", ns, "bash", "-c",
                 action["cmd"]],
                input=(action.get("in") or "").encode(),
                capture_output=True,
                timeout=action.get("timeout", 120),
            )
        except subprocess.TimeoutExpired as e:
            raise RemoteError(f"timed out: {action['cmd']!r}") from e
        out = dict(action)
        out.update(
            {
                "host": self.spec.host,
                "out": proc.stdout.decode(errors="replace"),
                "err": proc.stderr.decode(errors="replace"),
                "exit": proc.returncode,
            }
        )
        return out

    def upload(self, local_paths: Sequence[str],
               remote_path: str) -> None:
        for p in local_paths:
            shutil.copy(p, remote_path)

    def download(self, remote_paths: Sequence[str],
                 local_path: str) -> None:
        for p in remote_paths:
            if os.path.exists(p):
                dest = (
                    os.path.join(local_path, os.path.basename(p))
                    if os.path.isdir(local_path)
                    else local_path
                )
                shutil.copy(p, dest)
