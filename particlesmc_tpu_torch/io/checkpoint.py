"""Full simulation checkpoints (counterpart of particlesmc_tpu/io/checkpoint.py).

A checkpoint is the complete sampler state: positions, species, box,
per-chain temperatures and densities, the energy ledgers, the move counters,
the sampler generator's state and the pool's parameters, written as one npz
(no pickle) with the JAX package's array names and `meta_json`. Derived
state is rebuilt on load: the sequential kernel's cell list and MoleculeFlip
rounds, the checkerboard planes and bins (a new grid shift is drawn at the
next hyper-sweep anyway).

In place of the JAX package's `key` a checkpoint stores the state of the
sampler's torch.Generator (`generator_state`) and its device type; it loads
only onto a device of that type, so checkpoints do not cross packages or
device types. The sequential sampler's `flip_failed` flags are stored too.
Not stored, as in the JAX package: the generators of the policy-gradient
estimator and of replica exchange, which restart from their seeds.

Under chain sharding the engine saves the gathered state, in the same
layout with one generator state (parallel/mesh.py::gather_chains raises if
the shards' generators are out of step), and shards what it loads again:
a checkpoint resumes at any shard count.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from ..core.state import SystemState
from ..moves.checkerboard import init_cb_state
from ..moves.kernel import init_mc_state
from ..runtime import resolve_device


def _np(t):
    return t.detach().cpu().numpy()


def save_checkpoint(path: str, mc, pool_params, step: int, extra: Optional[dict] = None):
    """Write a batched sampler state (MCState or CBState), the pool's
    parameters and the step counter to `path`."""
    st = mc.system
    arrays = {
        "position": _np(st.position),
        "species": _np(st.species),
        "box": _np(st.box),
        "temperature": _np(st.temperature),
        "density": _np(st.density),
        "energy": _np(st.energy),
        "generator_state": _np(mc.generator.get_state()),
        "attempted": _np(mc.attempted),
        "accepted": _np(mc.accepted),
        "step": np.asarray(step, np.int64),
    }
    if hasattr(mc, "skipped"):  # checkerboard backend
        arrays["skipped"] = _np(mc.skipped)
    else:
        arrays["flip_failed"] = _np(mc.flip_failed)
    if st.molecule is not None:
        arrays["molecule"] = _np(st.molecule)
        arrays["bonds"] = _np(st.bonds)
    for m, p in enumerate(pool_params):
        for k, v in p.items():
            arrays[f"pool_{m}_{k}"] = _np(v)
    meta = {
        "n_moves": len(pool_params),
        "param_names": [sorted(p.keys()) for p in pool_params],
        "generator_device": mc.generator.device.type,
        "extra": extra or {},
    }
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def _read(path: str, dtype, device):
    """The system, generator, pool parameters, step and raw arrays of a
    checkpoint, on `device`."""
    z = dict(np.load(path))
    meta = json.loads(bytes(z["meta_json"]).decode())
    if "generator_state" not in z:
        raise ValueError(
            f"{path} holds no torch.Generator state: it was written by the JAX "
            "package (particlesmc_tpu), whose random state is JAX PRNG keys; "
            "checkpoints do not load across the two packages"
        )
    device = torch.device(device)
    saved = meta["generator_device"]
    if saved != device.type:
        raise ValueError(
            f"{path} holds a {saved} generator state and cannot resume on a "
            f"{device.type} device: checkpoints are bound to the device type "
            "that wrote them"
        )
    dt = dtype or torch.from_numpy(z["position"]).dtype

    def f(a):
        return torch.from_numpy(a).to(device, dt)

    def i64(name):
        return torch.from_numpy(z[name]).to(device, torch.int64) if name in z else None

    system = SystemState(
        position=f(z["position"]),
        species=i64("species"),
        box=f(z["box"]),
        temperature=f(z["temperature"]),
        density=f(z["density"]),
        energy=torch.from_numpy(z["energy"]).to(device),  # the ledger keeps its width
        molecule=i64("molecule"),
        bonds=i64("bonds"),
    )
    gen = torch.Generator(device=device)
    gen.set_state(torch.from_numpy(z["generator_state"]))
    pool_params = tuple(
        {k: f(z[f"pool_{m}_{k}"]) for k in names} for m, names in enumerate(meta["param_names"])
    )
    return system, gen, pool_params, int(z["step"]), z


def load_checkpoint(path: str, config, dtype=None, device=None):
    """(MCState, pool_params, step) of the sequential kernel from a
    checkpoint; `config` is the KernelConfig (the cell list is rebuilt).
    `device` defaults to the card."""
    device = resolve_device(device)
    system, gen, pool_params, step, z = _read(path, dtype, device)
    mc = init_mc_state(system, config, gen)
    mc = mc.replace(
        attempted=torch.from_numpy(z["attempted"]).to(device, torch.int64),
        accepted=torch.from_numpy(z["accepted"]).to(device, torch.int64),
        flip_failed=torch.from_numpy(z["flip_failed"]).to(device)
        if "flip_failed" in z else mc.flip_failed,
    )
    return mc, pool_params, step


def load_checkpoint_checkerboard(path: str, spec, dtype=None, device=None):
    """(CBState, pool_params, step) of the checkerboard backend from a
    checkpoint; the planes and bins are rebuilt at a zero grid shift.
    `device` defaults to the card."""
    device = resolve_device(device)
    system, gen, pool_params, step, z = _read(path, dtype, device)
    n_moves = z["attempted"].shape[-1]
    cb = init_cb_state(system, spec, gen, n_moves)
    skipped = z.get("skipped", np.zeros(z["attempted"].shape[:-1], np.int64))
    return cb.replace(
        attempted=torch.from_numpy(z["attempted"]).to(device, torch.int64),
        accepted=torch.from_numpy(z["accepted"]).to(device, torch.int64),
        skipped=torch.from_numpy(np.asarray(skipped)).to(device, torch.int64),
    ), pool_params, step
