"""Meshes of devices (counterpart of particlesmc_tpu/parallel/mesh.py).

A Mesh is the list of slabs of the spatial decomposition (parallel/spatial.py)
that this process holds, with their devices: either all of them, in one
process (a list of devices, which may repeat one card), or one slab per rank
of an initialised `torch.distributed` process group.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

# the process-group backend of each device type; there is no silent choice
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(device="cuda", **kwargs) -> None:
    """`torch.distributed.init_process_group` with the backend of `device`'s
    type (nccl for cuda, gloo for the CPU); `kwargs` give the rest, e.g.
    init_method="tcp://localhost:<port>", world_size and rank."""
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no process-group backend for {kind} devices")
    dist.init_process_group(backend=BACKENDS[kind], **kwargs)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The slabs this process holds: their devices in slab order, and the
    process group when each rank holds one slab (None in one process)."""

    devices: Tuple[torch.device, ...]
    group: Optional[object] = None

    @property
    def size(self) -> int:
        """Slabs in all."""
        return len(self.devices) if self.group is None else dist.get_world_size(self.group)

    @property
    def first(self) -> int:
        """Index of this process's first slab."""
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)


def make_mesh(
    n_devices: Optional[int] = None,
    device: Union[str, torch.device, Sequence, None] = None,
    group=None,
) -> Mesh:
    """A Mesh of `n_devices` slabs.

    - `group` (a process group, or "world"): one slab per rank, on `device`
      (this rank's device; by default the current card).
    - `device` a list: one slab per entry, in order; entries may repeat.
    - `device` a cuda device (the default): the first `n_devices` visible
      cards (all of them without `n_devices`); fewer raise ValueError.
    - `device` the CPU: `n_devices` slabs on the CPU.
    """
    if group is not None:
        g = dist.group.WORLD if group == "world" else group
        if device is None:
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = Mesh((torch.device(device),), g)
        if n_devices is not None and mesh.size != n_devices:
            raise ValueError(f"the process group has {mesh.size} ranks, not {n_devices}")
        return mesh
    if isinstance(device, (list, tuple)):
        devs = tuple(torch.device(x) for x in device)
        if n_devices is not None and len(devs) != n_devices:
            raise ValueError(f"{len(devs)} devices given for {n_devices} slabs")
        return Mesh(devs)
    kind = torch.device(device if device is not None else "cuda").type
    if kind == "cuda":
        visible = torch.cuda.device_count()
        n = visible if n_devices is None else int(n_devices)
        if n > visible:
            raise ValueError(f"{n} devices requested but only {visible} are visible")
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    return Mesh((torch.device(kind),) * (1 if n_devices is None else int(n_devices)))


def _map(fn, tree):
    """`fn` on every tensor of a tensor, a sequence, a dict or a dataclass."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), (torch.Tensor, list, tuple, dict))
            or dataclasses.is_dataclass(getattr(tree, f.name))
        })
    return tree


def shard_chains(tree, mesh: Mesh):
    """The batched `tree`'s leading (chains) axis cut into the mesh's
    contiguous blocks: this rank's block under a process group, else the
    list of every slab's block, each on its slab's device."""
    if mesh.group is not None:
        p, size = mesh.first, mesh.size

        def block(t):
            n = t.shape[0] // size
            return t[p * n:(p + 1) * n].to(mesh.devices[0])

        return _map(block, tree)
    size = mesh.size
    return [
        _map(lambda t, p=p, dev=dev: t[p * (t.shape[0] // size):(p + 1) * (t.shape[0] // size)].to(dev), tree)
        for p, dev in enumerate(mesh.devices)
    ]


def replicate(tree, mesh: Mesh):
    """Rank 0's tensors on every rank under a process group (a broadcast;
    gloo moves CPU tensors only, so a card's tensor goes through the CPU),
    else a copy on each slab's device."""
    if mesh.group is None:
        return [_map(lambda t, dev=dev: t.to(dev), tree) for dev in mesh.devices]
    staged = mesh.backend == "gloo"

    def bcast(t):
        buf = t.cpu().clone() if staged else t.clone()
        dist.broadcast(buf, src=dist.get_global_rank(mesh.group, 0), group=mesh.group)
        return buf.to(t.device)

    return _map(bcast, tree)
