"""The device mesh of the sharded prove, and its collectives.

The port's counterpart of icicle_snark_tpu/parallel/mesh.py. A JAX mesh is
a list of devices that one process holds shards on; so is this one: a
`Mesh` is the global list of shard devices and this process's contiguous
span of them. A process holds one shard per local device and may list a
device more than once (on a machine with one card, `make_mesh(["cuda:0"] *
4)` is a four-shard mesh whose shards run one after another on that card).
A sharded value is a Python list with one tensor per local shard, in
order; a `shard_map` body becomes a per-shard step, a collective, the next
per-shard step.

Across processes (the JAX package's multi-host path) the mesh runs on
`torch.distributed`: NCCL between cards, gloo between CPU processes. Call
`init_distributed()` (or let `make_mesh` call it) with the standard
environment MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE set, the
counterpart of the JAX_COORDINATOR_ADDRESS triplet; every process holds the
same number of shards, and process p holds shards [p L, (p + 1) L).

The collectives have a fixed order, so a sharded result does not depend
on how the shards are spread over processes:
  * `all_to_all(xs, split_axis, concat_axis)`: the block order of
    jax.lax.all_to_all(..., tiled=True): shard t receives block t of every
    shard s's split, concatenated in the order of s;
  * `all_gather(xs)`: every shard's tensor, in shard order, on this
    process's first device.
Within a process they are tensor copies (`.to(device)`, `torch.cat`);
across processes `all_to_all_single` and `all_gather`. The R1CS phase
needs no sum: each shard evaluates its own slots (parallel/prove_step.py).
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass

import torch

from ..runtime import require_device

_DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def init_distributed(backend: str | None = None) -> bool:
    """Join the process group named by the environment (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE); a no-op without it. `backend` defaults
    to NCCL when a card is present, else gloo. Returns True when a process
    group is up (from here or an earlier call), and the mesh's collectives
    then go through torch.distributed, at any world size."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True
    if not all(k in os.environ for k in _DIST_ENV):
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(
        backend,
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
    )
    return True


@dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh of shards: `devices` lists every shard's device in global
    order (other processes' entries as they reported them), [lo, hi) is
    this process's span, and `distributed` says whether the collectives
    run through torch.distributed."""

    devices: tuple
    lo: int
    hi: int
    distributed: bool = False

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> range:
        """This process's shard indices."""
        return range(self.lo, self.hi)

    @property
    def local_devices(self) -> tuple:
        return self.devices[self.lo:self.hi]

    @property
    def key(self) -> tuple:
        """What identifies the mesh for the caches built per mesh."""
        return tuple(str(d) for d in self.devices), self.lo, self.hi

    # ------------------------------------------------------------ collectives

    def all_to_all(self, xs: list, split_axis: int, concat_axis: int) -> list:
        """Tiled all-to-all: shard s's tensor is split into `size` equal
        blocks along split_axis; shard t gets block t of every shard,
        concatenated along concat_axis in shard order."""
        d = self.size
        for x in xs:
            if x.shape[split_axis] % d:
                raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} does not "
                                 f"split into {d} blocks")
        if not self.distributed:
            blocks = [x.chunk(d, split_axis) for x in xs]
            return [torch.cat([blocks[s][t].to(dev) for s in range(d)], concat_axis)
                    for t, dev in enumerate(self.devices)]
        import torch.distributed as dist

        home, n_loc = self.local_devices[0], len(xs)
        # send[q][j][i]: local shard i's block for shard j of process q
        send = torch.stack([torch.stack(x.to(home).chunk(d, split_axis)) for x in xs], dim=1)
        send = send.reshape((d // n_loc, n_loc, n_loc) + send.shape[2:]).contiguous()
        recv = torch.empty_like(send)  # recv[p][j][i]: shard i of process p's block for j
        dist.all_to_all_single(recv, send)
        out = []
        for j, dev in enumerate(self.local_devices):
            parts = [recv[p, j, i] for p in range(d // n_loc) for i in range(n_loc)]
            out.append(torch.cat(parts, concat_axis).to(dev))
        return out

    def all_gather(self, xs: list) -> list:
        """Every shard's tensor (all of one shape), in shard order, on this
        process's first device."""
        home = self.local_devices[0]
        if not self.distributed:
            return [x.to(home) for x in xs]
        import torch.distributed as dist

        mine = torch.stack([x.to(home) for x in xs]).contiguous()
        parts = [torch.empty_like(mine) for _ in range(self.size // len(xs))]
        dist.all_gather(parts, mine)
        return [t for part in parts for t in part.unbind(0)]


def on_device(dev: torch.device):
    """Kernels launch on the current CUDA device: make it the shard's."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def make_mesh(devices=None) -> Mesh:
    """The mesh over this process's `devices` (default: every visible CUDA
    device; raises without a card, as an entry point asked for CUDA does).
    When the torch.distributed environment is set (`init_distributed`),
    every process of the group holds as many shards as this one and the
    mesh spans them all, process by process: NCCL for CUDA shards, gloo
    for CPU shards."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=['cpu', ...] for the "
                               "plain versions")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [require_device(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    kinds = {d.type for d in devices}
    if len(kinds) != 1:
        raise ValueError(f"make_mesh: one kind of device per mesh, got {sorted(kinds)}")
    cuda = kinds == {"cuda"}
    if cuda:
        torch.cuda.set_device(devices[0])
    if not init_distributed("nccl" if cuda else "gloo"):
        return Mesh(tuple(devices), 0, len(devices))
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    everyone = [None] * world
    dist.all_gather_object(everyone, [str(d) for d in devices])
    if any(len(e) != len(devices) for e in everyone):
        raise ValueError(f"make_mesh: the processes hold different shard counts: "
                         f"{[len(e) for e in everyone]}")
    glob = tuple(torch.device(s) for e in everyone for s in e)
    n_loc = len(devices)
    return Mesh(glob, rank * n_loc, (rank + 1) * n_loc, distributed=True)


def host_local_to_global(mesh: Mesh, local: torch.Tensor, axis: int | None) -> list:
    """This process's contiguous span of a sharded array -> its local
    shards (one per local device), split evenly along `axis`; axis None: a
    replicated array, one copy per local device."""
    if axis is None:
        return [local.to(dev) for dev in mesh.local_devices]
    n_loc = len(mesh.local)
    if local.shape[axis] % n_loc:
        raise ValueError(f"host_local_to_global: axis {axis} of {tuple(local.shape)} does not "
                         f"split into {n_loc} shards")
    return [c.to(dev) for c, dev in zip(local.chunk(n_loc, axis), mesh.local_devices)]


def globalize(mesh: Mesh, arr: torch.Tensor, axis: int | None) -> list:
    """A FULL array -> this process's local shards: the mesh's contiguous
    blocks along `axis` (the array's length there must divide by the mesh
    size), or one copy per local device for axis None (replicated)."""
    if axis is None:
        return host_local_to_global(mesh, arr, None)
    d = mesh.size
    if arr.shape[axis] % d:
        raise ValueError(f"globalize: axis {axis} of {tuple(arr.shape)} does not split into "
                         f"{d} shards")
    span = arr.shape[axis] // d
    local = arr.narrow(axis, mesh.lo * span, len(mesh.local) * span)
    return host_local_to_global(mesh, local, axis)
