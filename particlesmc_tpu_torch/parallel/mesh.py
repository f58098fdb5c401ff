"""Meshes of devices (counterpart of particlesmc_tpu/parallel/mesh.py).

A Mesh is the list of blocks that this process holds, with their devices:
the slabs of the spatial decomposition (parallel/spatial.py) or the chain
shards of the engine (engine/simulation.py). It holds either all of them,
in one process (a list of devices, which may repeat one card), or one block
per rank of an initialised `torch.distributed` process group.

The chains axis is cut by `shard_chains` and put back together by
`gather_chains`. A shard's sampler state carries its place in the global
batch (core/state.py::ChainBlock) and a generator of its own, on its device,
with the parent's state: every shard draws the global batch's shape and
keeps its rows, so the shards' generators stay in step and a sharded run
draws what the unsharded run draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..core.state import ChainBlock

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
    """The blocks this process holds: their devices in block order, and the
    process group when each rank holds one block (None in one process)."""

    devices: Tuple[torch.device, ...]
    group: Optional[object] = None

    @property
    def size(self) -> int:
        """Blocks in all."""
        return len(self.devices) if self.group is None else dist.get_world_size(self.group)

    @property
    def first(self) -> int:
        """Index of this process's first block."""
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)


def visible_device(device) -> torch.device:
    """`device` as a torch.device with its index (a card without one is the
    current card); a card that is not visible raises ValueError."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    visible = torch.cuda.device_count()
    index = dev.index if dev.index is not None else (torch.cuda.current_device() if visible else 0)
    if index >= visible:
        raise ValueError(f"{dev} is not visible: {visible} cuda devices are")
    return torch.device("cuda", index)


def make_mesh(
    n_devices: Optional[int] = None,
    device: Union[str, torch.device, Sequence, None] = None,
    group=None,
) -> Mesh:
    """A Mesh of `n_devices` blocks.

    - `group` (a process group, or "world"): one block per rank, on `device`
      (this rank's device; by default the current card).
    - `device` a list: one block per entry, in order; entries may repeat; a
      card that is not visible raises ValueError.
    - `device` a cuda device (the default): the first `n_devices` visible
      cards (all of them without `n_devices`); fewer raise ValueError.
    - `device` the CPU: `n_devices` blocks on the CPU.
    """
    if group is not None:
        g = dist.group.WORLD if group == "world" else group
        if device is None:
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = Mesh((visible_device(device),), g)
        if n_devices is not None and mesh.size != n_devices:
            raise ValueError(f"the process group has {mesh.size} ranks, not {n_devices}")
        return mesh
    if isinstance(device, (list, tuple)):
        devs = tuple(visible_device(x) for x in device)
        if n_devices is not None and len(devs) != n_devices:
            raise ValueError(f"{len(devs)} devices given for {n_devices} blocks")
        return Mesh(devs)
    kind = torch.device(device if device is not None else "cuda").type
    if kind == "cuda":
        visible = torch.cuda.device_count()
        n = visible if n_devices is None else int(n_devices)
        if n > visible:
            raise ValueError(f"{n} devices requested but only {visible} are visible")
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    return Mesh((torch.device(kind),) * (1 if n_devices is None else int(n_devices)))


def copy_generator(gen: torch.Generator, device) -> torch.Generator:
    """A generator on `device` with `gen`'s state. A CUDA generator's state
    (a seed and an offset) is valid on any card; a generator of another
    device type raises ValueError."""
    dev = torch.device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"a {gen.device.type} generator cannot draw for a shard on {dev}")
    out = torch.Generator(device=dev)
    out.set_state(gen.get_state())
    return out


def _mappable(v) -> bool:
    return isinstance(v, (torch.Tensor, torch.Generator, list, tuple, dict)) or dataclasses.is_dataclass(v)


def _zip(fn, gen_fn, trees):
    """`fn(list of tensors)` on the matching tensors of trees of one
    structure (tensors, generators, sequences, dicts, dataclasses), and
    `gen_fn(list of generators)` on their generators."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(trees)
    if isinstance(t0, torch.Generator):
        return gen_fn(trees)
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):  # a NamedTuple
        return type(t0)._make(_zip(fn, gen_fn, xs) for xs in zip(*trees))
    if isinstance(t0, (list, tuple)):
        return type(t0)(_zip(fn, gen_fn, xs) for xs in zip(*trees))
    if isinstance(t0, dict):
        return {k: _zip(fn, gen_fn, [t[k] for t in trees]) for k in t0}
    if dataclasses.is_dataclass(t0):
        return dataclasses.replace(t0, **{
            f.name: _zip(fn, gen_fn, [getattr(t, f.name) for t in trees])
            for f in dataclasses.fields(t0) if _mappable(getattr(t0, f.name))
        })
    return t0


def _map(fn, tree, gen_fn=None):
    """`fn` on every tensor of `tree`, `gen_fn` on every generator (kept
    as it is without one)."""
    return _zip(lambda ts: fn(ts[0]), lambda gs: gs[0] if gen_fn is None else gen_fn(gs[0]), [tree])


def _batch(tree) -> int:
    """The leading (chains) axis of `tree`'s tensors."""
    sizes = []
    _map(lambda t: sizes.append(t.shape[0]), tree)
    if not sizes:
        raise ValueError("the tree holds no tensor")
    return sizes[0]


def _with_block(tree, block):
    if dataclasses.is_dataclass(tree) and any(f.name == "chains" for f in dataclasses.fields(tree)):
        return dataclasses.replace(tree, chains=block)
    return tree


def shard_chains(tree, mesh: Mesh):
    """The batched `tree`'s leading (chains) axis cut into the mesh's
    contiguous blocks, in chain order: this rank's block under a process
    group, else the list of every block, each on its block's device (a
    copy). Every tensor of `tree` has the chains axis first. Each block
    gets its own generator on its device with the parent's state
    (copy_generator), and a sampler state its ChainBlock. The chains must
    divide evenly."""
    if getattr(tree, "chains", None) is not None:
        raise ValueError("the state is already a shard")
    B, size = _batch(tree), mesh.size
    if B % size:
        raise ValueError(f"{B} chains do not split evenly into {size} shards")
    n = B // size

    def block(p, dev):
        lo, hi = p * n, (p + 1) * n
        out = _map(lambda t: t[lo:hi].to(dev, copy=True), tree, lambda g: copy_generator(g, dev))
        return _with_block(out, ChainBlock(lo, hi, B))

    if mesh.group is not None:
        return block(mesh.first, mesh.devices[0])
    return [block(p, dev) for p, dev in enumerate(mesh.devices)]


def _same_stream(gens):
    """The first generator, after checking that every shard's generator has
    its state: the shards draw the same global shapes, so a difference means
    a draw was made on one shard only."""
    state = gens[0].get_state()
    if any(not torch.equal(g.get_state(), state) for g in gens[1:]):
        raise RuntimeError("the chain shards' generators are out of step")
    return gens[0]


def gather_chains(blocks, mesh: Mesh):
    """The inverse of shard_chains: the blocks concatenated in chain order
    on the first block's device, with a copy of their generator (whose
    state every shard must share) and no ChainBlock. Under a process group
    `blocks` is this rank's block and every rank gets the whole batch, by
    an all-gather (staged through the CPU under gloo, which moves CPU
    tensors only)."""
    if mesh.group is None:
        dev = mesh.devices[0]
        out = _zip(lambda ts: torch.cat([t.to(dev) for t in ts]),
                   lambda gs: copy_generator(_same_stream(gs), dev), list(blocks))
        return _with_block(out, None)
    staged = mesh.backend == "gloo"
    size = mesh.size

    def all_gather(t):
        x = (t.cpu() if staged else t).contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=mesh.group)
        return torch.cat(parts).to(t.device)

    return _with_block(_map(all_gather, blocks, lambda g: copy_generator(g, g.device)), None)


def replicate(tree, mesh: Mesh):
    """Rank 0's tensors on every rank under a process group (a broadcast;
    gloo moves CPU tensors only, so a card's tensor goes through the CPU),
    else a copy on each block's device."""
    if mesh.group is None:
        return [_map(lambda t, dev=dev: t.to(dev), tree) for dev in mesh.devices]
    staged = mesh.backend == "gloo"

    def bcast(t):
        buf = t.cpu().clone() if staged else t.clone()
        dist.broadcast(buf, src=dist.get_global_rank(mesh.group, 0), group=mesh.group)
        return buf.to(t.device)

    return _map(bcast, tree)
