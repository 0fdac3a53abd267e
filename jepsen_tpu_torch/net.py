"""Network manipulation: partitions and packet shaping.

The port's copy of `jepsen_tpu/net.py`.

Equivalent of jepsen/src/jepsen/net.clj (+ net/proto.clj):
the `Net` protocol (drop!/heal!/slow!/flaky!/fast!/shape!,
net.clj:15-29), the iptables implementation (:177-233, including the
bulk `PartitionAll` drop :223-233), and tc/netem shaping with
delay/loss/corrupt/duplicate/reorder/rate behaviors (:73-164).

All methods act via the control-plane sessions bound in
``test["sessions"]`` (the reference's dynamic `c/on-nodes` binding).

Addressing: iptables rules on a node name the PEER's address.  Node
names of the form "host:port" (localhost clusters, where the host part
is the control node's view — e.g. 127.0.0.1 with a published ssh
port) are NOT usable as peer addresses inside the cluster; supply
``test["node-addresses"] = {node-name: in-cluster address}`` (e.g. the
compose service hostnames n1..n5) and the helpers below resolve
through it, falling back to the bare host part.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

from .control import Session, on_nodes
from .control.core import split_host_port
from .nemesis import ledger as fault_ledger


def node_address(test: dict, node: str) -> str:
    """The address peers use to reach `node` inside the cluster."""
    alias = (test.get("node-addresses") or {}).get(node)
    if alias:
        return alias
    host, port = split_host_port(node)
    if port is not None and host in ("127.0.0.1", "localhost", "::1"):
        # A loopback host:port name is the CONTROL node's view; as a
        # peer address it would blackhole the node's own loopback
        # instead of partitioning anything — fail loudly rather than
        # inject the wrong fault.
        raise ValueError(
            f"node {node!r} is a control-side loopback view; supply "
            f'test["node-addresses"] with in-cluster addresses'
        )
    return host


class Net:
    """net/proto.clj:5-12 + net.clj:15-29."""

    def drop(self, test: dict, src: str, dest: str) -> None:
        """Cuts the link src -> dest (dest stops hearing src)."""
        raise NotImplementedError

    def drop_all(self, test: dict, grudge: Mapping[str, Any]) -> None:
        """Applies a whole grudge {node: nodes-it-stops-hearing} at
        once (PartitionAll, net.clj:223-233)."""
        for node, cut in grudge.items():
            for src in cut:
                self.drop(test, src, node)

    def heal(self, test: dict) -> None:
        raise NotImplementedError

    def slow(self, test: dict, **opts: Any) -> None:
        """Delays all traffic (mean 50 ms ± 10 ms, net.clj:50-56)."""
        raise NotImplementedError

    def flaky(self, test: dict) -> None:
        """Drops packets probabilistically (20%, net.clj:58-61)."""
        raise NotImplementedError

    def fast(self, test: dict) -> None:
        """Removes shaping (not partitions)."""
        raise NotImplementedError

    def shape(self, test: dict, behavior: Optional[dict], nodes: Optional[Sequence[str]] = None) -> None:
        """Applies a tc/netem behavior dict: keys delay {time,jitter,
        correlation,distribution}, loss {percent,correlation},
        corrupt/duplicate/reorder {percent,correlation}, rate
        (net.clj:73-164).  None removes shaping."""
        raise NotImplementedError


class NoopNet(Net):
    """For dummy remotes and in-memory tests."""

    def drop(self, test: dict, src: str, dest: str) -> None:
        pass

    def drop_all(self, test: dict, grudge: Mapping[str, Any]) -> None:
        pass

    def heal(self, test: dict) -> None:
        pass

    def slow(self, test: dict, **opts: Any) -> None:
        pass

    def flaky(self, test: dict) -> None:
        pass

    def fast(self, test: dict) -> None:
        pass

    def shape(self, test: dict, behavior, nodes=None) -> None:
        pass


def _netem_args(behavior: Mapping[str, Any]) -> list[str]:
    """Renders a behavior map to netem arguments (net.clj:93-146)."""
    args: list[str] = []
    delay = behavior.get("delay")
    if delay:
        args += ["delay", f"{delay.get('time', 50)}ms"]
        if "jitter" in delay:
            args += [f"{delay['jitter']}ms"]
        if "correlation" in delay:
            args += [f"{delay['correlation']}%"]
        if delay.get("distribution"):
            args += ["distribution", str(delay["distribution"])]
    for kind in ("loss", "corrupt", "duplicate", "reorder"):
        spec = behavior.get(kind)
        if spec:
            args += [kind, f"{spec.get('percent', 20)}%"]
            if "correlation" in spec:
                args += [f"{spec['correlation']}%"]
    if behavior.get("rate"):
        args += ["rate", f"{behavior['rate']}kbit"]
    return args


class TcShapingNet(Net):
    """Shared tc/netem shaping half of the Net protocol
    (net.clj:73-164): subclasses supply the partition mechanism and
    inherit slow/flaky/fast/shape.  `dev` is the qdisc device —
    eth0 by default, which is also what NetnsCluster names every
    node's interface."""

    def __init__(self, dev: str = "eth0"):
        self.dev = dev

    def _shaping_intent(self, test: dict, params: dict,
                        nodes: Optional[Sequence[str]] = None) -> None:
        """Journals a netem/tbf shaping fault; the compensator is always
        the same qdisc delete, whatever the behavior was."""
        targets = list(nodes) if nodes else list(test.get("nodes") or [])
        fault_ledger.intent(
            test, "netem", nodes=[str(n) for n in targets],
            params=params,
            compensator={"type": "tc-del", "dev": self.dev,
                         "nodes": [str(n) for n in targets]},
        )

    def slow(self, test: dict, **opts: Any) -> None:
        mean = opts.get("mean", 50)
        variance = opts.get("variance", 10)
        dist = opts.get("distribution", "normal")
        self._shaping_intent(
            test, {"f": "slow", "mean": mean, "variance": variance}
        )

        def do(sess: Session, node: str) -> None:
            with sess.su():
                sess.exec(
                    "tc", "qdisc", "add", "dev", self.dev, "root",
                    "netem", "delay", f"{mean}ms", f"{variance}ms",
                    "distribution", dist,
                )

        on_nodes(test, do)

    def flaky(self, test: dict) -> None:
        self._shaping_intent(test, {"f": "flaky", "loss": "20%"})

        def do(sess: Session, node: str) -> None:
            with sess.su():
                sess.exec(
                    "tc", "qdisc", "add", "dev", self.dev, "root",
                    "netem", "loss", "20%", "75%",
                )

        on_nodes(test, do)

    def fast(self, test: dict) -> None:
        if fault_ledger.heal_guard():
            return

        def do(sess: Session, node: str) -> None:
            with sess.su():
                # Deleting a nonexistent qdisc fails; ignore like the
                # reference (net.clj:69-71).
                res = sess.exec_star(
                    "tc", "qdisc", "del", "dev", self.dev, "root"
                )
                del res

        on_nodes(test, do)
        fault_ledger.healed(test, fault="netem")

    def shape(self, test: dict, behavior, nodes=None) -> None:
        if not behavior:
            self.fast(test)
            return
        self._shaping_intent(
            test, {"f": "shape", "behavior": dict(behavior)}, nodes
        )
        args = self._shape_args(behavior)

        def do(sess: Session, node: str) -> None:
            with sess.su():
                sess.exec_star("tc", "qdisc", "del", "dev", self.dev,
                               "root")
                sess.exec(
                    "tc", "qdisc", "add", "dev", self.dev, "root",
                    *args,
                )

        on_nodes(test, do, nodes)

    def _shape_args(self, behavior: Mapping[str, Any]) -> list[str]:
        return ["netem", *_netem_args(behavior)]


class IptablesNet(TcShapingNet):
    """iptables + tc/netem implementation (net.clj:177-233)."""

    def drop(self, test: dict, src: str, dest: str) -> None:
        def do(sess: Session, node: str) -> None:
            with sess.su():
                sess.exec(
                    "iptables", "-A", "INPUT", "-s",
                    node_address(test, src), "-j", "DROP", "-w",
                )

        on_nodes(test, do, [dest])

    def drop_all(self, test: dict, grudge: Mapping[str, Any]) -> None:
        # One command per node, not per edge: comma-joined sources
        # (PartitionAll, net.clj:223-233).
        targets = {n: sorted(cut) for n, cut in grudge.items() if cut}

        def do(sess: Session, node: str) -> None:
            srcs = ",".join(
                node_address(test, s) for s in targets[node]
            )
            with sess.su():
                sess.exec(
                    "iptables", "-A", "INPUT", "-s", srcs,
                    "-j", "DROP", "-w",
                )

        on_nodes(test, do, list(targets.keys()))

    def heal(self, test: dict) -> None:
        def do(sess: Session, node: str) -> None:
            with sess.su():
                sess.exec("iptables", "-F", "-w")
                sess.exec("iptables", "-X", "-w")

        on_nodes(test, do)


class RouteNet(TcShapingNet):
    """Kernel-level partitions without a packet-filter userspace:
    blackhole routes + tc shaping.

    Some hosts (including this repo's CI kernel) ship neither iptables
    nor nftables binaries, but `ip route` always works.  Routing can
    only drop a node's OWN egress, so `drop(src, dest)` — "dest stops
    hearing src" (net/proto.clj:5-12) — installs a blackhole route
    for dest's address ON SRC: src's packets toward dest die in src's
    routing table and dest genuinely never hears src, for TCP and
    datagrams alike.  The residual asymmetry is on the REVERSE path:
    dest's datagrams still reach src (dest was not asked to stop
    being heard), while reverse TCP stalls because src can't
    acknowledge — iptables `INPUT -s src -j DROP` on dest has the
    mirror-image residue (src's datagrams die at dest but dest's
    still reach src).  Partition packages emit symmetric grudges, on
    which both mechanisms produce identical full cuts.

    Shaping (inherited TcShapingNet, net.clj:73-164) uses the netem
    qdisc where the kernel has it, plus a tbf fallback for rate-only
    behaviors — tbf is compiled into kernels that lack sch_netem."""

    @staticmethod
    def _blackhole_prefix(test: dict, node: str) -> str:
        """node -> an iproute2 prefix.  iproute2 takes only literal
        prefixes, so hostnames resolve on the control side (same
        resolver split_host_port topologies already rely on) and
        IPv6 literals get /128."""
        import ipaddress
        import socket

        addr = node_address(test, node)
        try:
            ip = ipaddress.ip_address(addr)
        except ValueError:
            addr = socket.getaddrinfo(addr, None)[0][4][0]
            ip = ipaddress.ip_address(addr)
        return f"{addr}/{128 if ip.version == 6 else 32}"

    def drop(self, test: dict, src: str, dest: str) -> None:
        prefix = self._blackhole_prefix(test, dest)

        def do(sess: Session, node: str) -> None:
            with sess.su():
                # replace = idempotent: overlapping grudges re-drop
                # the same edge without erroring.
                sess.exec("ip", "route", "replace", "blackhole",
                          prefix)

        on_nodes(test, do, [src])

    def drop_all(self, test: dict, grudge: Mapping[str, Any]) -> None:
        # The grudge maps dest -> the srcs it stops hearing; routes
        # must be installed on each SRC (see class doc), so invert to
        # src -> dest-prefixes and run one shell per src node — still
        # the bulk PartitionAll shape (net.clj:223-233).
        by_src: dict[str, list[str]] = {}
        for dest, cut in grudge.items():
            for src in cut:
                by_src.setdefault(src, []).append(
                    self._blackhole_prefix(test, dest)
                )

        def do(sess: Session, node: str) -> None:
            script = "; ".join(
                f"ip route replace blackhole {prefix}"
                for prefix in sorted(by_src[node])
            )
            with sess.su():
                sess.exec("bash", "-c", script)

        on_nodes(test, do, list(by_src.keys()))

    def heal(self, test: dict) -> None:
        def do(sess: Session, node: str) -> None:
            with sess.su():
                sess.exec("bash", "-c",
                          "ip route flush type blackhole || true")

        on_nodes(test, do)

    def _shape_args(self, behavior: Mapping[str, Any]) -> list[str]:
        if set(behavior) == {"rate"}:
            # tbf fallback: netem-free kernels can still rate-limit.
            return ["tbf", "rate", f"{behavior['rate']}kbit",
                    "burst", "32kbit", "latency", "400ms"]
        return super()._shape_args(behavior)


class IpfilterNet(IptablesNet):
    """IPFilter implementation for SmartOS/illumos nodes
    (net.clj:235-270): partitions via `ipf` rules fed on stdin, heal
    via `ipf -Fa`; shaping inherits the tc/netem path (the reference's
    ipfilter impl shells out to tc for slow/flaky/fast/shape too)."""

    def drop(self, test: dict, src: str, dest: str) -> None:
        def do(sess: Session, node: str) -> None:
            with sess.su():
                sess.exec(
                    "ipf", "-f", "-",
                    stdin=f"block in from {node_address(test, src)} to any\n",
                )

        on_nodes(test, do, [dest])

    def drop_all(self, test: dict, grudge: Mapping[str, Any]) -> None:
        # One ipf invocation per node with the whole rule set on stdin
        # (the bulk analogue of iptables' comma-joined PartitionAll).
        targets = {n: sorted(cut) for n, cut in grudge.items() if cut}

        def do(sess: Session, node: str) -> None:
            rules = "".join(
                f"block in from {node_address(test, s)} to any\n"
                for s in targets[node]
            )
            with sess.su():
                sess.exec("ipf", "-f", "-", stdin=rules)

        on_nodes(test, do, list(targets.keys()))

    def heal(self, test: dict) -> None:
        def do(sess: Session, node: str) -> None:
            with sess.su():
                sess.exec("ipf", "-Fa")

        on_nodes(test, do)


iptables = IptablesNet()
ipfilter = IpfilterNet()
route = RouteNet()
noop = NoopNet()
