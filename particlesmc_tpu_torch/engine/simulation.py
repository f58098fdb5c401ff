"""The Simulation engine (counterpart of particlesmc_tpu/engine/simulation.py).

`Simulation(chains, algorithm_list, steps; path, verbose)` + `run()`. One
step is one sweep of `sweepstep` attempted moves per chain. All chains
advance together on one device, through one of two backends:

- `parallel_moves = true`: the checkerboard hyper-sweep, dispatched in
  blocks of `rebin_every` sweeps (one rebin each);
- otherwise the sequential kernel (moves/kernel.py), one move per chain and
  step, with the dense ΔE, or with a cell list when `list_type` is a cell or
  Verlet list and N > DENSE_DELTA_MAX or `list_parameters.force_cells` is
  set. Per-chain boxes run on the dense path only.

The sweeps between two scheduled events are issued without a host
synchronisation; each event waits for the device once.

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

`resume=<checkpoint>` continues a run from a StoreCheckpoints file: state,
counters, policy parameters and step are restored, and the outputs are
appended to instead of truncated.
"""

from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import neighbours as NB
from ..core.state import shared_box
from ..io import checkpoint as CKPT
from ..io import formats
from ..io.loader import Chains
from ..moves import checkerboard as CBK
from ..moves import kernel as K
from ..models.tables import interaction_range
from ..moves.base import Move, init_pool_params
from ..runtime import unported
from .callbacks import CALLBACK_REGISTRY

FMT_NAMES = {"XYZ": "xyz", "EXYZ": "exyz", "LAMMPS": "lammps"}

OUTPUTS = (
    "StoreCallbacks", "StoreAcceptance", "StoreTrajectories", "StoreLastFrames",
    "StoreParameters", "StoreCheckpoints", "PrintTimeSteps", "ReplicaExchange",
    "AdaptiveSigma", "PolicyGradientEstimator", "PolicyGradientUpdate",
)
# callbacks of the reference package that a later slice ports, with their
# ROADMAP.md queue-1 item
UNPORTED_CALLBACKS = {"pressure": 12, "chain_correlation": 12}


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
            if cb in UNPORTED_CALLBACKS:
                raise unported(f"the {cb} callback", UNPORTED_CALLBACKS[cb])
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
    ):
        self.chains = chains
        self.steps = int(steps)
        self.path = path
        self.verbose = verbose
        self._tput_mark: Optional[Tuple[float, int]] = None  # (wall, step)
        self.sweep_seconds = 0.0  # wall time of the sweeps alone, outputs excluded
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
        if int(m.extra.get("spatial_devices", 0)) > 1:
            raise unported("spatial_devices (one system over several devices)", 13)
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

    def _resume(self, path: str):
        """Restore state, counters, policy parameters and step from a
        StoreCheckpoints file."""
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
        if params.get("trim", False) not in (False, 0, "0", "off", "false", None):
            raise unported("candidate compaction (list_parameters.trim)", 14)
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
        self._run_sweeps = K.build_run_fn(self.config, n)

    # ------------------------------------------------------------------
    def _block(self, sweeps: int) -> Callable:
        """The hyper-sweep of `sweeps` sweeps per rebin, built once per size."""
        f = self._blocks.get(sweeps)
        if f is None:
            f = CBK.build_hyper_sweep_fn(
                self.cb_spec, self.chains.table, self.chains.n_particles,
                self.sweepstep, inner=self.inner, sweeps=sweeps, pool=self.pool,
                max_bonds=self.max_bonds,
            )
            self._blocks[sweeps] = f
        return f

    def _sync(self):
        """Wait for the queued work of the device that runs the chains."""
        if self.mc.system.position.is_cuda:
            torch.cuda.synchronize(self.mc.system.position.device)

    def _run_chunk(self, n_sweeps: int):
        t0 = time.perf_counter()
        if self.parallel_moves:
            nb, rem = divmod(n_sweeps, self.rebin_every)
            for _ in range(nb):
                self.mc = self._block(self.rebin_every)(self.mc, self.pool_params)
            if rem:
                self.mc = self._block(rem)(self.mc, self.pool_params)
        else:
            # no compile per chunk length here, so one call covers the gap
            self.mc = self._run_sweeps(self.mc, self.pool_params, n_sweeps)
        self._sync()  # every output event reads the chains anyway
        self.sweep_seconds += time.perf_counter() - t0

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
            if a.scheduler is None or t not in a.scheduler:
                continue
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
                att = self.mc.attempted.sum(dim=0).cpu().numpy()
                acc = self.mc.accepted.sum(dim=0).cpu().numpy()
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
            f"\tDevice: {st.position.device}",
        ]
        os.makedirs(self.path, exist_ok=True)
        with open(os.path.join(self.path, "simulation.log"), "w") as f:
            f.write("\n".join(lines) + "\n")
        return lines

    def run(self):
        """Execute `steps` sweeps, firing the scheduled outputs."""
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
                self._sigma_tuner.step(t)
            if self._rex is not None and t in self._rex_sched:
                self._rex.step()
                with open(os.path.join(self.path, "tempering_acceptance.dat"), "a") as f:
                    f.write(f"{t} {self._rex.rate:.12g}\n")
            if self._pgmc is not None:
                if t % self._pgmc_every == 0 or t == self.steps:
                    self._pgmc.estimate()
                if t in self._pgmc_update_sched:
                    self._pgmc.update()
            self._fire_outputs(t)
        self.check_health()
        return self


def run(sim: Simulation) -> Simulation:
    return sim.run()
