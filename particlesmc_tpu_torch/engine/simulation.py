"""The Simulation engine (counterpart of particlesmc_tpu/engine/simulation.py).

`Simulation(chains, algorithm_list, steps; path, verbose)` + `run()`. One
step is one sweep of `sweepstep` attempted moves per chain. All chains
advance together, through one of two backends:

- `parallel_moves = true`: the checkerboard hyper-sweep, dispatched in
  blocks of `rebin_every` sweeps (one rebin each);
- otherwise the sequential kernel (moves/kernel.py), one move per chain and
  step, with the dense ΔE, or with a cell list when `list_type` is a cell or
  Verlet list and N > DENSE_DELTA_MAX or `list_parameters.force_cells` is
  set. Per-chain boxes run on the dense path only.

The sweeps between two scheduled events are issued without a host
synchronisation; each event waits for the devices once.

Chain sharding (`devices=`, parallel/mesh.py): the chains axis is cut into
P contiguous blocks, one per device of the list (which may repeat one card,
or name the CPU). Without `devices`, a run whose chains are on a card shards
over every visible card when there are several and `spatial_devices` <= 1
(as the JAX engine does). Chains that do not divide by P warn and stay
unsharded. Every shard draws the global batch's shape from its own
generator, in step with the others, and keeps its rows, so a sharded run
makes the unsharded run's moves: outputs, checkpoints, replica exchange
(global, across shard boundaries), AdaptiveSigma and PGMC read the chains in
global order. `sim.mc` is the gathered state of every chain (`sim.shards`
the shards' own); `sim.mesh` is None when the run is not sharded.

Outputs and their directory layout:
- StoreCallbacks    -> <path>/chains/<k>/<name>.dat        rows "step value"
- StoreAcceptance   -> <path>/moves/<id>/acceptance.dat    rows "step rate"
- StoreTrajectories -> <path>/chains/<k>/trajectory.<ext>  appended frames
- StoreLastFrames   -> <path>/chains/<k>/lastframe.<ext>   restart file
- StoreParameters   -> <path>/moves/<id>/parameters.dat    rows "step v1 v2 ..."
- StoreCheckpoints  -> <path>/checkpoint.npz (checkpoint_<step>.npz with `history`)
- PrintTimeSteps    -> progress and throughput to stdout
- ReplicaExchange   -> <path>/tempering_acceptance.dat     rows "step rate"
- AdaptiveSigma     -> <path>/moves/<id>/sigma.dat         rows "step sigma rate"
- PolicyGradientEstimator / PolicyGradientUpdate: PGMC (engine/pgmc.py); the
  estimator's `optimisers`, `q_batch_size` and `q_every` ride in its entry

On the checkerboard, `list_parameters.trim` turns on the candidate
compaction (moves/checkerboard.py::ColourSubsteps) and the Metropolis
entry's `spatial_devices` > 1 cuts one system's grid into that many slabs
(parallel/spatial.py), one per visible card (or CPU slabs on the CPU).
`profile_dir` runs the whole run() under torch.profiler and writes its
trace there, with the port's spans (tracing.py) on its timeline. Each
engine chunk (the sweeps between two events) is the phase `engine.chunk`,
its final wait `engine.sync`, each event `engine.event.<algorithm>`
(tracing.totals()).

`resume=<checkpoint>` continues a run from a StoreCheckpoints file: state,
counters, policy parameters and step are restored, and the outputs are
appended to instead of truncated.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tracing
from ..core import neighbours as NB
from ..core.state import shared_box
from ..io import checkpoint as CKPT
from ..io import formats
from ..io.loader import Chains
from ..moves import checkerboard as CBK
from ..moves import kernel as K
from ..models.tables import interaction_range
from ..moves.base import Move, init_pool_params
from ..parallel import mesh as PM
from .callbacks import CALLBACK_REGISTRY

FMT_NAMES = {"XYZ": "xyz", "EXYZ": "exyz", "LAMMPS": "lammps"}

# the outputs that _fire_output writes; the others act in _run
STORES = (
    "StoreCallbacks", "StoreAcceptance", "StoreTrajectories", "StoreLastFrames",
    "StoreParameters", "StoreCheckpoints", "PrintTimeSteps",
)
OUTPUTS = STORES + ("ReplicaExchange", "AdaptiveSigma", "PolicyGradientEstimator", "PolicyGradientUpdate")


@dataclass
class Algorithm:
    """One algorithm_list entry."""

    name: str
    scheduler: Optional[np.ndarray] = None
    callbacks: Tuple[Any, ...] = ()
    fmt: str = "xyz"
    dependencies: Tuple[str, ...] = ()
    extra: Dict[str, Any] = field(default_factory=dict)


def _normalise_algorithm(entry) -> Algorithm:
    if isinstance(entry, Algorithm):
        return entry
    d = dict(entry)
    name = d.pop("algorithm")
    if not isinstance(name, str):
        name = getattr(name, "__name__", str(name))
    fmt = d.pop("fmt", "xyz")
    fmt = FMT_NAMES.get(fmt, fmt)
    sched = d.pop("scheduler", None)
    if sched is not None:
        sched = np.asarray(sched, np.int64)
    return Algorithm(
        name=name,
        scheduler=sched,
        callbacks=tuple(d.pop("callbacks", ())),
        fmt=fmt,
        dependencies=tuple(d.pop("dependencies", ())),
        extra=d,
    )


def _check_outputs(outputs):
    for a in outputs:
        if a.name not in OUTPUTS:
            raise ValueError(f"Unsupported output algorithm: {a.name}")
        for cb in a.callbacks:
            if not isinstance(cb, str):
                continue
            if cb not in CALLBACK_REGISTRY:
                raise ValueError(f"Unknown callback {cb!r}")


class Simulation:
    """Engine state: batched chains, the sweep backend, scheduled outputs."""

    def __init__(
        self,
        chains: Chains,
        algorithm_list: Sequence[Any],
        steps: int,
        path: str = "./",
        verbose: bool = False,
        resume: Optional[str] = None,
        profile_dir: Optional[str] = None,
        devices: Optional[Sequence] = None,
    ):
        self.chains = chains
        self.mesh = None  # the chain shards' mesh (set below)
        self._gathered = None  # sim.mc under sharding, until the shards change
        self.steps = int(steps)
        self.path = path
        self.verbose = verbose
        self.profile_dir = profile_dir  # torch.profiler trace of run()
        self._tput_mark: Optional[Tuple[float, int]] = None  # (wall, step)
        self._start_step = 0

        algos = [_normalise_algorithm(a) for a in algorithm_list]
        metro = [a for a in algos if a.name == "Metropolis"]
        if len(metro) != 1:
            raise ValueError("algorithm_list must contain exactly one Metropolis entry")
        m = metro[0]
        self.pool: Tuple[Move, ...] = tuple(m.extra["pool"])
        self.seed = int(m.extra.get("seed", 0))
        self.sweepstep = int(m.extra.get("sweepstep", chains.n_particles))
        self.parallel_moves = bool(m.extra.get("parallel_moves", False))
        self.spatial_devices = int(m.extra.get("spatial_devices", 0))
        self.outputs = [a for a in algos if a.name != "Metropolis"]
        _check_outputs(self.outputs)

        st = chains.states
        if chains.list_type == "verlet":
            warnings.warn(
                "VerletList maps to the bucketed cell implementation (there is "
                "no skin variant); candidates and rebuilds follow the cell "
                "path — set list_type 'CellList' to silence this.",
                stacklevel=2,
            )
        if self.parallel_moves:
            self._init_checkerboard()
        else:
            self._init_sequential()
        self.pool_params = init_pool_params(self.pool, st.position.dtype, st.position.device)
        if self.parallel_moves:
            self._block(self.rebin_every)  # refuses a pool the checkerboard cannot run
        self.mesh = self._chain_mesh(devices)
        if self.mesh is not None:
            self.mc = self.mc  # shards the state
            self.pool_params = self.pool_params  # a copy on every shard's device
        # the pair table on every shard's device
        self.shard_tables = [chains.table] if self.mesh is None else PM.replicate(chains.table, self.mesh)
        if not self.parallel_moves:
            self._shard_runs = self.per_shard_device(
                lambda table: K.build_run_fn(dataclasses.replace(self.config, table=table), chains.n_particles)
            )

        self._sigma_tuner = None
        tuner = [a for a in self.outputs if a.name == "AdaptiveSigma"]
        if tuner:
            from .adaptive import AdaptiveSigma

            t0 = tuner[0]
            if t0.scheduler is None:
                raise ValueError("AdaptiveSigma needs a scheduler")
            self._sigma_tuner = AdaptiveSigma(
                self, move=t0.extra.get("move"), target=float(t0.extra.get("target", 0.22)),
                kappa=float(t0.extra.get("kappa", 1.0)), sigma_max=t0.extra.get("sigma_max"),
            )
            self._sigma_tuner_sched = set(int(t) for t in t0.scheduler)
        self._rex = None
        rex = [a for a in self.outputs if a.name == "ReplicaExchange"]
        if rex:
            from .tempering import ReplicaExchange

            if rex[0].scheduler is None:
                raise ValueError("ReplicaExchange needs a scheduler")
            self._rex = ReplicaExchange(self, seed=self.seed)
            self._rex_sched = set(int(t) for t in rex[0].scheduler)
        self._pgmc = None
        est = [a for a in self.outputs if a.name == "PolicyGradientEstimator"]
        if est:
            from .pgmc import PGMC

            e = est[0].extra
            self._pgmc = PGMC(self, tuple(e.get("optimisers", ())), int(e.get("q_batch_size", 10)))
            upd = [a for a in self.outputs if a.name == "PolicyGradientUpdate"]
            self._pgmc_update_sched = (
                set(int(t) for t in upd[0].scheduler) if upd and upd[0].scheduler is not None else set()
            )
            # estimate every q_every sweeps (1, the reference's cadence, by
            # default); larger values let the engine issue q_every sweeps
            # between two estimates
            self._pgmc_every = max(1, int(e.get("q_every", 1)))
        self._truncate_outputs = resume is None  # a resumed run appends
        if resume is not None:
            self._resume(resume)
        self._event_times = self._collect_event_times()

    # ------------------------------------------------------------------
    # The chains, whole or in shards
    # ------------------------------------------------------------------
    @property
    def mc(self):
        """The sampler state of every chain in chain order; under chain
        sharding the shards gathered on the first shard's device (kept until
        the shards change)."""
        if self.mesh is None:
            return self._shards[0]
        if self._gathered is None:
            self._gathered = PM.gather_chains(self._shards, self.mesh)
        return self._gathered

    @mc.setter
    def mc(self, value):
        self.shards = [value] if self.mesh is None else PM.shard_chains(value, self.mesh)

    @property
    def shards(self) -> list:
        """The chain shards' states in chain order ([mc] when unsharded)."""
        return list(self._shards)

    @shards.setter
    def shards(self, value):
        self._shards = list(value)
        self._gathered = None

    @property
    def device(self) -> torch.device:
        """The device of the first chains (the first shard's)."""
        return self._shards[0].system.position.device

    @property
    def pool_params(self):
        return self._pool_params

    @pool_params.setter
    def pool_params(self, value):
        self._pool_params = tuple(value)
        self.shard_params = (
            [self._pool_params] if self.mesh is None else [tuple(p) for p in PM.replicate(self._pool_params, self.mesh)]
        )

    def per_shard_device(self, build) -> list:
        """`build(table)` with the pair table on each shard's device, once
        per distinct device, in shard order."""
        built = {}
        for s, table in zip(self._shards, self.shard_tables):
            dev = s.system.position.device
            if dev not in built:
                built[dev] = build(table)
        return [built[s.system.position.device] for s in self._shards]

    def counters(self):
        """(attempted, accepted) [n_moves] numpy int64, summed over every
        chain: per shard, then over the shards (integers: exact)."""
        att = sum(s.attempted.sum(dim=0).cpu() for s in self._shards)
        acc = sum(s.accepted.sum(dim=0).cpu() for s in self._shards)
        return att.numpy(), acc.numpy()

    def _chain_mesh(self, devices) -> Optional[PM.Mesh]:
        """The mesh of the chain shards (module docstring), or None."""
        home = self.chains.states.position.device
        if devices is None:
            if home.type != "cuda" or self.spatial_devices > 1 or torch.cuda.device_count() <= 1:
                return None
            mesh = PM.make_mesh()
        else:
            mesh = PM.make_mesh(device=list(devices))
            if mesh.size > 1 and self.spatial_devices > 1:
                raise ValueError(
                    "devices= shards the chains and spatial_devices > 1 shards one "
                    "system's grid: give one of them"
                )
            other = [d for d in mesh.devices if d.type != home.type]
            if other:
                raise ValueError(f"the chains are on {home}: their generator cannot draw on {other[0]}")
        P, B = mesh.size, self.chains.n_chains
        if P <= 1:
            return None
        if B % P:
            warnings.warn(
                f"n_chains = {B} is not divisible by the {P} devices — the chain "
                f"batch stays on ONE device ({P - 1} idle). Round n_chains up to a "
                f"multiple of {P} (nsim in the TOML) to use them all.",
                RuntimeWarning,
                stacklevel=3,
            )
            return None
        return mesh

    def _resume(self, path: str):
        """Restore state, counters, policy parameters and step from a
        StoreCheckpoints file (sharded again under chain sharding)."""
        st = self.chains.states
        dtype, device = st.position.dtype, st.position.device
        if self.parallel_moves:
            self.mc, self.pool_params, self._start_step = CKPT.load_checkpoint_checkerboard(
                path, self.cb_spec, dtype, device
            )
        else:
            self.mc, self.pool_params, self._start_step = CKPT.load_checkpoint(path, self.config, dtype, device)
        if self._start_step >= self.steps:
            raise ValueError(
                f"checkpoint is at step {self._start_step}, past the requested {self.steps} steps"
            )
        if self.verbose:
            print(f"resumed from {path} at step {self._start_step}")

    def _init_checkerboard(self):
        """The checkerboard backend: one static grid for all chains."""
        chains = self.chains
        st = chains.states
        n = chains.n_particles
        params = chains.list_parameters
        box0 = st.box[0].double().cpu().numpy()
        molecular = st.is_molecular
        self.max_bonds = int(st.bonds.shape[-1]) if molecular else 0
        if not shared_box(st.box):
            raise ValueError(
                "parallel_moves requires all chains to share one box "
                "(the checkerboard grid is static)"
            )
        # molecular cells must span the bond reach (a FENE r0 can exceed the
        # pair cutoff), and whole molecules crowd into single cells
        cb_rcut = interaction_range(chains.table) if molecular else chains.table.max_cutoff
        cb_spec = CBK.make_cb_spec(
            box0, cb_rcut, n, params.get("cap"), occ_factor=4.0 if molecular else 2.5
        )
        if cb_spec is None:
            raise ValueError(
                "box too small for a checkerboard grid (need >= 4 cells per "
                "dimension at the interaction cutoff); unset parallel_moves "
                "to use the sequential kernel"
            )
        self.cb_spec = cb_spec
        self.mc = CBK.init_cb_state(st, cb_spec, self.seed, len(self.pool))
        self.rebin_every = max(1, int(params.get("rebin_every", 8)))
        self.inner = int(params.get("inner", 8))
        self._blocks: Dict[int, Callable] = {}
        self.spatial_mesh = None
        self.trim_k = None
        if self.spatial_devices > 1:
            self.spatial_mesh = self._spatial_mesh(molecular)
        else:
            # candidate compaction: off, "auto" (auto_trim_k) or a lane count;
            # 1 == True reads as "auto", as in the JAX package
            trim = params.get("trim", False)
            if trim in (False, 0, "0", "off", "false", None):
                self.trim_k = None
            elif trim in (True, "auto", "true"):
                self.trim_k = CBK.auto_trim_k(cb_spec, box0, cb_rcut, n)
            else:
                self.trim_k = int(trim)
        self.trim_rcut = cb_rcut

    def _spatial_mesh(self, molecular: bool):
        """The slabs of `spatial_devices`: one system, atomic, on the first
        visible cards (CPU slabs for a CPU run), each an even slab."""
        from ..parallel import mesh as PM
        from ..parallel import spatial as SPK

        n_dev = self.spatial_devices
        if self.chains.n_chains != 1:
            raise ValueError(
                "spatial_devices shards ONE system's grid; use nsim = 1 (the "
                "chains axis is the scale-out dimension for replicas)"
            )
        if molecular:
            raise ValueError("spatial_devices supports atomic systems only")
        device = self.chains.states.position.device
        visible = torch.cuda.device_count() if device.type == "cuda" else n_dev
        if visible < n_dev:
            raise ValueError(f"spatial_devices = {n_dev} but only {visible} devices are visible")
        if SPK.spatial_slab_width(self.cb_spec, n_dev) is None:
            raise ValueError(
                f"grid ncells[0] = {self.cb_spec.ncells[0]} cannot shard into even "
                f"slabs over {n_dev} devices (needs even slabs of >= 2 cell columns)"
            )
        return PM.make_mesh(n_dev, device.type)

    def _init_sequential(self):
        """The sequential kernel, dense or with a cell list."""
        chains = self.chains
        st = chains.states
        n = chains.n_particles
        params = chains.list_parameters
        self.cb_spec = None
        cell_spec = None
        if chains.list_type in ("cell", "verlet") and (
            n > K.DENSE_DELTA_MAX or bool(params.get("force_cells", False))
        ):
            if not shared_box(st.box):
                raise ValueError(
                    "cell-list mode requires all chains to share one box (the "
                    "grid is static); use list_type 'dense' for per-chain boxes"
                )
            cell_spec = NB.make_spec(
                st.box[0].double().cpu().numpy(), chains.table.max_cutoff, n, params.get("cap")
            )
            if cell_spec is None and self.verbose:
                print("cell grid too small; falling back to dense candidates")
        if cell_spec is not None:
            warnings.warn(
                f"the sequential kernel at N={n} runs the cell-list ΔE: one "
                "move per chain and step, each step a few dozen small device "
                "launches, so a sweep is N dependent steps. Set parallel_moves "
                "= true (the checkerboard backend) unless this pool or "
                "geometry needs the sequential kernel.",
                stacklevel=3,
            )
        self.config = K.KernelConfig(
            pool=self.pool, table=chains.table, cell_spec=cell_spec,
            mol_start=None if chains.mol_start is None else tuple(int(x) for x in chains.mol_start),
            mol_len=None if chains.mol_len is None else tuple(int(x) for x in chains.mol_len),
            sweepstep=self.sweepstep,
        )
        self.mc = K.init_mc_state(st, self.config, self.seed)

    # ------------------------------------------------------------------
    def _block(self, sweeps: int) -> Callable:
        """The hyper-sweep of `sweeps` sweeps per rebin, built once per size."""
        f = self._blocks.get(sweeps)
        if f is None:
            if self.spatial_mesh is not None:
                from ..parallel.spatial import build_spatial_hyper_sweep_fn

                f = build_spatial_hyper_sweep_fn(
                    self.cb_spec, self.chains.table, self.chains.n_particles, self.spatial_mesh,
                    self.sweepstep, inner=self.inner, sweeps=sweeps, pool=self.pool,
                )
            else:
                f = CBK.build_hyper_sweep_fn(
                    self.cb_spec, self.chains.table, self.chains.n_particles,
                    self.sweepstep, inner=self.inner, sweeps=sweeps, pool=self.pool,
                    max_bonds=self.max_bonds, trim_k=self.trim_k, trim_rcut=self.trim_rcut,
                )
            self._blocks[sweeps] = f
        return f

    def _sync(self):
        """Wait for the queued work of every device that runs chains."""
        with tracing.phase("engine.sync"):
            for dev in dict.fromkeys(s.system.position.device for s in self._shards):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)

    def _run_chunk(self, n_sweeps: int):
        """`n_sweeps` sweeps of every chain: rebin blocks on the
        checkerboard, sweeps on the sequential kernel (no compile per chunk
        length here, so one call covers the gap). The shards take turns
        block by block (sweep by sweep), so that each device has work
        queued while the host issues the next shard's."""
        with tracing.phase("engine.chunk"):
            shards = self._shards
            if self.parallel_moves:
                nb, rem = divmod(n_sweeps, self.rebin_every)
                for f in [self._block(self.rebin_every)] * nb + ([self._block(rem)] if rem else []):
                    shards = [f(mc, params) for mc, params in zip(shards, self.shard_params)]
            else:
                for _ in range(n_sweeps):
                    shards = [run(mc, params, 1) for run, mc, params in zip(self._shard_runs, shards, self.shard_params)]
            self.shards = shards
            self._sync()  # every output event reads the chains anyway

    def _collect_event_times(self) -> np.ndarray:
        times = {0, self.steps}
        for a in self.outputs:
            if a.scheduler is not None:
                times.update(int(t) for t in a.scheduler)
        if self._pgmc is not None:
            times.update(range(0, self.steps + 1, self._pgmc_every))
        return np.asarray(sorted(t for t in times if 0 <= t <= self.steps), np.int64)

    # ------------------------------------------------------------------
    def _prepare_dirs(self):
        for k in range(self.chains.n_chains):
            os.makedirs(os.path.join(self.path, "chains", str(k + 1)), exist_ok=True)
        for m in range(len(self.pool)):
            os.makedirs(os.path.join(self.path, "moves", str(m + 1)), exist_ok=True)
        if not self._truncate_outputs:
            return
        # truncate append-mode files from previous runs
        for a in self.outputs:
            if a.name == "StoreCallbacks":
                for cb in a.callbacks:
                    name = cb if isinstance(cb, str) else cb.__name__
                    for k in range(self.chains.n_chains):
                        open(self._chain_file(k, f"{name}.dat"), "w").close()
            elif a.name == "StoreTrajectories":
                ext = formats.FORMAT_EXTENSION[a.fmt]
                for k in range(self.chains.n_chains):
                    open(self._chain_file(k, f"trajectory{ext}"), "w").close()
            elif a.name == "StoreAcceptance":
                for m in range(len(self.pool)):
                    open(self._move_file(m, "acceptance.dat"), "w").close()
            elif a.name == "StoreParameters":
                for m in range(len(self.pool)):
                    open(self._move_file(m, "parameters.dat"), "w").close()
            elif a.name == "ReplicaExchange":
                open(os.path.join(self.path, "tempering_acceptance.dat"), "w").close()
            elif a.name == "AdaptiveSigma":
                for m in self._sigma_tuner.moves:
                    open(self._move_file(m, "sigma.dat"), "w").close()

    def _chain_file(self, k: int, name: str) -> str:
        return os.path.join(self.path, "chains", str(k + 1), name)

    def _move_file(self, m: int, name: str) -> str:
        return os.path.join(self.path, "moves", str(m + 1), name)

    def _frame_kwargs(self, k: int, t: int, fmt: str, with_bonds: bool):
        """One chain's frame; a molecular system's frames carry the molecule
        column, and its last frames (not LAMMPS) the bond section."""
        st = self.mc.system
        kw = dict(
            species=st.species[k].cpu().numpy() + 1,
            position=st.position[k].double().cpu().numpy(),
            box=st.box[k].double().cpu().numpy(),
            step=t,
        )
        if fmt == "xyz":
            kw["rho"] = float(st.density[k])
            kw["T"] = float(st.temperature[k])
        if st.molecule is not None:
            kw["molecule"] = st.molecule[k].cpu().numpy() + 1
            if with_bonds and fmt != "lammps":
                bonds = st.bonds[k].cpu().numpy()
                kw["bond_pairs"] = [
                    (i + 1, j + 1)
                    for i in range(bonds.shape[0])
                    for j in bonds[i]
                    if j >= 0 and i < j
                ]
        return kw

    def _fire_outputs(self, t: int):
        for a in self.outputs:
            if a.name in STORES and a.scheduler is not None and t in a.scheduler:
                with tracing.phase("engine.event." + a.name):
                    self._fire_output(a, t)

    def _fire_output(self, a: Algorithm, t: int):
        if a.name == "StoreCallbacks":
            for cb in a.callbacks:
                name = cb if isinstance(cb, str) else cb.__name__
                fn = CALLBACK_REGISTRY[name] if isinstance(cb, str) else cb
                vals = fn(self)
                for k in range(self.chains.n_chains):
                    with open(self._chain_file(k, f"{name}.dat"), "a") as f:
                        f.write(f"{t} {vals[k]:.12g}\n")
        elif a.name == "StoreAcceptance":
            # cumulative rates over the whole chain, summed over chains
            att, acc = self.counters()
            for m in range(len(self.pool)):
                rate = acc[m] / att[m] if att[m] > 0 else 0.0
                with open(self._move_file(m, "acceptance.dat"), "a") as f:
                    f.write(f"{t} {rate:.12g}\n")
        elif a.name == "StoreTrajectories":
            ext = formats.FORMAT_EXTENSION[a.fmt]
            for k in range(self.chains.n_chains):
                text = formats.write_frame(a.fmt, **self._frame_kwargs(k, t, a.fmt, False))
                with open(self._chain_file(k, f"trajectory{ext}"), "a") as f:
                    f.write(text)
        elif a.name == "StoreLastFrames":
            ext = formats.FORMAT_EXTENSION[a.fmt]
            for k in range(self.chains.n_chains):
                text = formats.write_frame(a.fmt, **self._frame_kwargs(k, t, a.fmt, True))
                with open(self._chain_file(k, f"lastframe{ext}"), "w") as f:
                    f.write(text)
        elif a.name == "StoreParameters":
            for m, p in enumerate(self.pool_params):
                if not p:
                    continue
                vals = " ".join(f"{float(v):.12g}" for v in p.values())
                with open(self._move_file(m, "parameters.dat"), "a") as f:
                    f.write(f"{t} {vals}\n")
        elif a.name == "StoreCheckpoints":
            name = f"checkpoint_{t}.npz" if a.extra.get("history") else "checkpoint.npz"
            CKPT.save_checkpoint(
                os.path.join(self.path, name), self.mc, self.pool_params, t,
                extra={"backend": "cb" if self.parallel_moves else "seq"},
            )
        elif a.name == "PrintTimeSteps":
            # sweeps/s since the previous print, outputs included
            self._sync()
            now = time.perf_counter()
            if self._tput_mark is not None and t > self._tput_mark[1]:
                t0, s0 = self._tput_mark
                rate = (t - s0) / max(now - t0, 1e-9)
                agg = rate * self.chains.n_chains
                print(
                    f"step {t}/{self.steps}  "
                    f"{rate:.1f} sweeps/s/chain ({agg:.1f} aggregate)"
                )
            else:
                print(f"step {t}/{self.steps}")
            self._tput_mark = (now, t)

    # ------------------------------------------------------------------
    def check_health(self):
        """Raise on a sticky device-side error. Sequential: a cell-list
        bucket overflow or a MoleculeFlip without a valid pair.
        Checkerboard: a bucket overflow skips its block (identity, unbiased)
        and is counted; raise only if every block was skipped."""
        if not self.parallel_moves:
            K.check_state(self.mc)
        elif bool(torch.any(self.mc.skipped > 0)) and int(self.mc.attempted.sum()) == 0:
            raise RuntimeError(
                "checkerboard: every rebin block overflowed and was skipped "
                "— increase list_parameters.cap"
            )

    @property
    def neighbour_mode(self) -> str:
        if self.parallel_moves:
            return "checkerboard"
        return "cell" if self.config.cell_spec is not None else "dense"

    def write_summary(self):
        """Human-readable summary in <path>/simulation.log."""
        st = self.chains.states
        lines = [
            f"\tNumber of particles: {st.n_particles}",
            f"\tDimensions: {st.dim}",
            f"\tCell: {st.box[0].double().cpu().numpy().tolist()}",
            f"\tDensity: {float(st.density[0])}",
            f"\tTemperature: {st.temperature.double().cpu().numpy().tolist()}",
            f"\tNeighbour mode: {self.neighbour_mode}",
            f"\tChains: {self.chains.n_chains}",
            f"\tSteps: {self.steps} (sweepstep {self.sweepstep})",
            f"\tMoves: {[m.action for m in self.pool]}",
            f"\tDevice: {st.position.device}" if self.mesh is None else
            f"\tDevice: {self.mesh.size} chain shards of {self.chains.n_chains // self.mesh.size} on "
            f"{', '.join(str(d) for d in self.mesh.devices)}",
        ]
        os.makedirs(self.path, exist_ok=True)
        with open(os.path.join(self.path, "simulation.log"), "w") as f:
            f.write("\n".join(lines) + "\n")
        return lines

    def run(self):
        """Execute `steps` sweeps, firing the scheduled outputs. With
        `profile_dir`, the whole run executes under torch.profiler and its
        trace (Chrome / TensorBoard format) is written into that directory."""
        if not self.profile_dir:
            return self._run()
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.profile_dir, exist_ok=True)
        with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(self.profile_dir)):
            return self._run()

    def _run(self):
        self._prepare_dirs()
        lines = self.write_summary()
        if self.verbose:
            print("\n".join(lines))
        t = self._start_step
        if t == 0:
            self._fire_outputs(0)
        for nxt in self._event_times:
            if nxt <= t:
                continue
            self._run_chunk(int(nxt - t))
            t = int(nxt)
            if self._sigma_tuner is not None and t in self._sigma_tuner_sched:
                with tracing.phase("engine.event.AdaptiveSigma"):
                    self._sigma_tuner.step(t)
            if self._rex is not None and t in self._rex_sched:
                with tracing.phase("engine.event.ReplicaExchange"):
                    self._rex.step()
                    with open(os.path.join(self.path, "tempering_acceptance.dat"), "a") as f:
                        f.write(f"{t} {self._rex.rate:.12g}\n")
            if self._pgmc is not None:
                if t % self._pgmc_every == 0 or t == self.steps:
                    with tracing.phase("engine.event.PolicyGradientEstimator"):
                        self._pgmc.estimate()
                if t in self._pgmc_update_sched:
                    with tracing.phase("engine.event.PolicyGradientUpdate"):
                        self._pgmc.update()
            self._fire_outputs(t)
        self.check_health()
        return self


def run(sim: Simulation) -> Simulation:
    return sim.run()
