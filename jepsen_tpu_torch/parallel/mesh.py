"""Device meshes for checker sharding: the port of
`jepsen_tpu/parallel/mesh.py`.

The reference's parallel axis is a `jax.sharding.Mesh` whose "keys"
axis carries independent per-key searches.  Here a `Mesh` is a 1-D
array of `torch.device`s with its axis name.  The code that takes one
splits its work into one contiguous shard per entry and runs each shard
on its entry's device: the batched BFS and the Elle screen split keys
(ops/wgl_batched.py, ops/scc.py), which need no traffic between shards;
the frontier-sharded BFS splits one search's frontier and gathers its
candidates on the first entry's device every level (ops/wgl.py).
Nothing assumes the entries are distinct: a mesh may name one card
twice, and each shard then keeps its own tensors on it.

Across processes, `multihost_init` joins a gloo process group.  A mesh
built after it (`default_mesh`, on every rank) lists every rank's
devices, each entry tagged with its rank; a rank runs the shards of its
own entries, and the shards' results, host objects such as verdicts and
explored counts, come back to every rank through `all_gather_object`
(`gather_shards`).  Nothing else crosses ranks, so the group is gloo,
never NCCL.

Left out: `shard_map_compat`, the reference's shim over the jax
versions' spellings of `shard_map`, which has no torch counterpart.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Union

import numpy as np
import torch

from .. import device as _device

_mesh_cache: dict = {}


def _dist():
    """torch.distributed when this process is in a process group."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist
    return None


def _process_rank() -> int:
    """This process's rank in its process group (0 outside one)."""
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def _process_count() -> int:
    """The number of processes in the group (1 outside one)."""
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


class Mesh:
    """A 1-D mesh: `devices`, a numpy object array of `torch.device`s
    (so `.size` and `.shape` read as the reference's do), `axis_names`,
    and `ranks`, the process that owns each entry (this one's unless
    given).  Caches that depend on a mesh key on the object itself,
    which is why `default_mesh` memoizes."""

    __slots__ = ("devices", "axis_names", "ranks")

    def __init__(self, devices: Iterable[Union[str, torch.device]],
                 axis_names: Union[str, Sequence[str]] = ("keys",),
                 ranks: Optional[Sequence[int]] = None):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(len(devs), dtype=object)
        self.devices[:] = devs
        self.axis_names = ((axis_names,) if isinstance(axis_names, str)
                           else tuple(axis_names))
        if ranks is None:
            ranks = [_process_rank()] * len(devs)
        if len(ranks) != len(devs):
            raise ValueError(f"{len(ranks)} ranks for {len(devs)} devices")
        self.ranks = tuple(int(r) for r in ranks)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def spans_ranks(self) -> bool:
        return len(set(self.ranks)) > 1

    def shard_devices(self) -> list[Optional[torch.device]]:
        """Each entry's device, resolved (`device.resolve`, which raises
        for a card torch cannot see), or None where another rank owns
        the entry."""
        me = _process_rank()
        return [_device.resolve(d) if r == me else None
                for d, r in zip(self.devices.flat, self.ranks)]

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.devices.flat)
        return f"Mesh([{devs}], axis_names={self.axis_names})"


def gather_shards(mesh: Mesh, local: dict) -> dict:
    """{shard index: result} of every shard of `mesh`, from this rank's
    own `local` results and, when the mesh spans ranks, every other
    rank's (`all_gather_object`, which every rank of the mesh calls)."""
    if mesh.spans_ranks:
        dist = _dist()
        if dist is None:
            raise RuntimeError(
                "a mesh across ranks needs multihost_init first")
        parts: list = [None] * dist.get_world_size()
        dist.all_gather_object(parts, local)
        local = {i: r for part in parts for i, r in part.items()}
    missing = [i for i in range(mesh.size) if i not in local]
    if missing:
        raise RuntimeError(f"mesh shards {missing} returned no result")
    return local


def default_mesh(n_devices: Optional[int] = None, axis: str = "keys") -> Mesh:
    """A 1-D mesh over (the first n of) the devices: this process's
    cards (`device.local_devices`), or after `multihost_init` every
    rank's, in rank order (then every rank must call it).  Memoized on
    (n, axis): caches keyed on a mesh must see the same object."""
    key = (n_devices, axis)
    mesh = _mesh_cache.get(key)
    if mesh is not None:
        return mesh
    devs = [str(d) for d in _device.local_devices()]
    ranks = [_process_rank()] * len(devs)
    dist = _dist()
    if dist is not None and dist.get_world_size() > 1:
        per_rank: list = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, devs)
        devs = [d for part in per_rank for d in part]
        ranks = [r for r, part in enumerate(per_rank) for _ in part]
    if n_devices is not None:
        devs, ranks = devs[:n_devices], ranks[:n_devices]
    if not devs:
        raise ValueError("no devices for a mesh: torch sees no card")
    mesh = Mesh(devs, (axis,), ranks)
    _mesh_cache[key] = mesh
    return mesh


def multihost_init(coordinator: str, num_processes: int,
                   process_id: int) -> None:
    """Joins this process to a multi-process group over gloo at
    `coordinator` ("host:port"; rank 0 listens there), blocking until
    all `num_processes` have joined.  After it returns, `default_mesh()`
    spans every rank's devices: each rank runs the shards of its own
    entries and the results come back through `all_gather_object`, so
    only host objects cross ranks.

    The checks run before any wait: a malformed coordinator or a
    process id outside [0, num_processes) raises ValueError.  Call it
    before the first `default_mesh()`; it drops the memoized meshes,
    whose device lists it changes."""
    if not coordinator or ":" not in coordinator:
        raise ValueError(
            f"coordinator must be host:port, got {coordinator!r}")
    if not (0 <= process_id < num_processes):
        raise ValueError(
            f"process_id {process_id} outside [0, {num_processes})")
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id)
    _mesh_cache.clear()


def checker_mesh(test: Optional[dict] = None,
                 device: Union[str, torch.device, None] = None
                 ) -> Optional[Mesh]:
    """The mesh a checker should use: the test map's "mesh" if set,
    else all devices (`default_mesh()`) when there is more than one
    local card or more than one rank, else None.  A checker that runs
    on the CPU (`device`) takes only the test map's mesh: the default
    one lists cards."""
    if test and test.get("mesh") is not None:
        return test["mesh"]
    if device is not None and torch.device(device).type != "cuda":
        return None
    if len(_device.local_devices()) > 1 or _process_count() > 1:
        return default_mesh()
    return None
