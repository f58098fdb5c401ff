"""Configuration loading (counterpart of particlesmc_tpu/io/loader.py).

Parses one file or a directory of files, applies the density rescale, the
temperature and model overrides, the fold-back, the temperature ladder and
`nsim` replica cloning, and returns a batched `Chains` bundle. Model and
list names resolve through explicit registries, never eval. A file with a
molecule column and a bond section gives a molecular system.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core import geometry
from ..core.energy import initialize_energy
from ..core.state import SystemState, bonds_from_pairs, make_system, mol_table, pad_bonds
from ..models.tables import PairTable, resolve_model
from ..runtime import resolve_device
from . import formats


@dataclass
class Chains:
    """A batch of B independent chains plus shared statics."""

    states: SystemState  # leading chains axis on every tensor
    table: PairTable
    list_type: str  # 'dense' | 'cell' | 'verlet'
    list_parameters: Dict[str, Any] = field(default_factory=dict)
    n_chains: int = 1
    mol_start: Optional[np.ndarray] = None  # [Nmol] static molecule layout
    mol_len: Optional[np.ndarray] = None

    @property
    def n_particles(self) -> int:
        return self.states.n_particles

    @property
    def dim(self) -> int:
        return self.states.dim


# Reference list names -> neighbour modes. The sequential kernel takes its
# cell list from a cell or Verlet mode (engine/simulation.py); the
# checkerboard backend bins particles itself.
LIST_REGISTRY = {
    "EmptyList": "dense",
    "CellList": "cell",
    "LinkedList": "cell",
    "VerletList": "verlet",
    "dense": "dense",
    "cell": "cell",
    "verlet": "verlet",
}


def _meta_value(metadata: List[str], key: str) -> Optional[str]:
    for tok in metadata:
        if f"{key}:" in tok:
            return tok.split(f"{key}:", 1)[1]
    return None


def load_configuration(path: str, frame: int = 0) -> Dict:
    """Parse one configuration file by extension."""
    return formats.read_configuration(path, frame)


def _gather_input_files(init_path: str, filename: str = "") -> List[str]:
    files: List[str] = []
    if os.path.isfile(init_path):
        files.append(init_path)
    elif os.path.isdir(init_path):
        for root, _dirs, names in os.walk(init_path):
            for name in sorted(names):
                if filename in name:
                    files.append(os.path.join(root, name))
    return files


def load_chains(
    init_path: str,
    args: Optional[Dict[str, Any]] = None,
    filename: str = "",
    verbose: bool = False,
    dtype=torch.float64,
    energy_dtype=None,
    device=None,
) -> Chains:
    """Build a batch of chains from one file or a directory of files.

    `args` takes the reference keys: temperature (scalar or list), density,
    model (registry name or per-pair dict), list_type, list_parameters,
    nsim. `energy_dtype` widens the energy ledger (mixed precision). The
    chains live on `device`: the card unless the caller names another.
    """
    device = resolve_device(device)
    args = dict(args or {})
    input_files = _gather_input_files(init_path, filename)
    if not input_files:
        raise FileNotFoundError(f"No configuration files found at {init_path!r}")
    if verbose:
        print(f"Processing {len(input_files)} configuration file(s)")

    configs = [load_configuration(f) for f in input_files]
    N, d = configs[0]["N"], configs[0]["d"]
    for c in configs:
        if c["N"] != N or c["d"] != d:
            raise ValueError("All chains must share N and d")

    positions = [c["position"].copy() for c in configs]
    boxes = [c["box"].copy() for c in configs]
    species = [c["species"] for c in configs]
    densities = [c["N"] / np.prod(c["box"]) for c in configs]

    temps = [_meta_value(c["metadata"], "T") for c in configs]
    temps = [float(t) if t is not None else None for t in temps]
    models = [
        _meta_value(c["metadata"], "model") or _meta_value(c["metadata"], "Model")
        for c in configs
    ]

    # density rescale
    if args.get("density") is not None:
        rho = float(args["density"])
        lam = [(dens / rho) ** (1.0 / d) for dens in densities]
        positions = [X * l for X, l in zip(positions, lam)]
        boxes = [b * l for b, l in zip(boxes, lam)]
        densities = [rho] * len(configs)

    # temperature override
    t_arg = args.get("temperature")
    if t_arg is not None:
        if isinstance(t_arg, (list, tuple, np.ndarray)):
            temps = [float(t) for t in t_arg]
        else:
            temps = [float(t_arg)] * len(configs)
    if any(t is None for t in temps):
        raise ValueError("temperature has not been found in metadata or args")

    # model override
    m_arg = args.get("model")
    if m_arg is not None:
        model_spec = m_arg[0] if isinstance(m_arg, (list, tuple)) else m_arg
    else:
        if models[0] is None:
            raise ValueError("model has not been found in metadata or args")
        model_spec = models[0]

    positions = [
        geometry.fold_back(torch.as_tensor(X), torch.as_tensor(b)).numpy()
        for X, b in zip(positions, boxes)
    ]

    # temperature ladder from one configuration: replicate the frame per rung
    if len(temps) > 1 and len(positions) == 1:
        positions = positions * len(temps)
        species = species * len(temps)
        densities = densities * len(temps)
        configs = configs * len(temps)
    if len(temps) != len(positions):
        raise ValueError(
            f"temperature vector length {len(temps)} does not match the "
            f"{len(positions)} chains (pass one T, a length-matched vector, "
            "or a vector with a single configuration)"
        )

    # nsim replica cloning
    nsim = int(args.get("nsim") or 1)
    if nsim > 1:
        positions = [p for p in positions for _ in range(nsim)]
        species = [s for s in species for _ in range(nsim)]
        densities = [r for r in densities for _ in range(nsim)]
        temps = [t for t in temps for _ in range(nsim)]
        configs = [c for c in configs for _ in range(nsim)]

    n_species = len(np.unique(np.concatenate(species)))
    table = resolve_model(model_spec, n_species, dtype, device)

    # neighbour-list heuristic Z/N < 0.1 -> cell list
    Z = float(np.mean(densities)) * geometry.volume_sphere(table.max_cutoff, d)
    list_type = "cell" if Z / N < 0.1 else "dense"
    if args.get("list_type"):
        key = str(args["list_type"])
        if key not in LIST_REGISTRY:
            raise ValueError(f"Unknown list_type {key!r}; known: {sorted(LIST_REGISTRY)}")
        list_type = LIST_REGISTRY[key]
    list_parameters = dict(args.get("list_parameters") or {})

    # a molecular system: the molecule column and each file's bond section
    mol_kw: Dict[str, Any] = {}
    mol_start = mol_len = None
    if "molecule" in configs[0]:
        mol_kw["molecule"] = np.stack([c["molecule"] for c in configs])
        mol_kw["bonds"] = np.stack(
            [pad_bonds(bonds_from_pairs(c["bond_pairs"] - 1, N), N) for c in configs]
        )

    # as in the reference package, each chain's box is the cubic box of its
    # density (make_system's default)
    states = make_system(
        np.stack(positions), np.stack(species), np.asarray(densities),
        np.asarray(temps), dtype=dtype, device=device, **mol_kw,
    )
    states = initialize_energy(states, table, energy_dtype=energy_dtype)
    if states.molecule is not None:
        mol_start, mol_len = mol_table(states.molecule[0].cpu().numpy())
    if verbose:
        print(f"{states.n_chains} chains created")
    return Chains(
        states=states,
        table=table,
        list_type=list_type,
        list_parameters=list_parameters,
        n_chains=states.n_chains,
        mol_start=mol_start,
        mol_len=mol_len,
    )
