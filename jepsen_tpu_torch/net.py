"""Network manipulation: the `Net` protocol and the noop net.

The port's copy of `jepsen_tpu/net.py`, trimmed to the protocol, the
noop net a dummy or in-memory run takes, and `node_address`.  The
iptables, route, ipfilter and tc/netem nets wait for the remotes that
reach real nodes.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

from .control.core import split_host_port


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


noop = NoopNet()
