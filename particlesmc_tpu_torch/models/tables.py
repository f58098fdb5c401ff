"""Species-pair parameter tables (counterpart of
particlesmc_tpu/models/tables.py).

A `PairTable` holds one [S, S] tensor per precomputed parameter, indexed by
the species pair. The per-pair constructors are host-side float64 math that
mirrors the reference parameterisations: BHHP, KobAndersen, JBB, the binary
LJ mixture of the reference's validation gate (BinaryLJMixture), and the
molecular Trimer (Kremer-Grest pairs with FENE bonds, GeneralKG).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import torch

from ..runtime import resolve_device
from .potentials import (
    KIND_INVERSE_POWER,
    KIND_LENNARD_JONES,
    KIND_NONE,
    KIND_SMOOTH_LJ,
)

# Taylor coefficients of the smoothing polynomial (SmoothLennardJones)
_SMOOTH_C0 = 0.04049023795
_SMOOTH_C2 = -0.00970155098
_SMOOTH_C4 = 0.00062012616

INT_FIELDS = ("kind", "ipl_n", "has_bond")
BOND_FIELDS = ("has_bond", "kr02", "r02", "eps4b", "sigma2b", "shiftb", "rcut2b")


@dataclasses.dataclass(frozen=True)
class PairTable:
    """[S, S] parameter tensors for all pair interactions.

    - kind (int32): potential kind per pair (see models/potentials.py)
    - eps4: 4*eps for LJ-family kinds; raw eps for inverse power
    - sigma2, rcut, rcut2, shift; ipl_n (int32) the inverse-power exponent
    - c0, c2s2, c4s4: smooth-LJ polynomial coefficients (C0, C2/s^2, C4/s^4)
    - has_bond (int32), kr02, r02, eps4b, sigma2b, shiftb, rcut2b: FENE + LJ
      bond parameters (GeneralKG)
    """

    kind: torch.Tensor
    eps4: torch.Tensor
    sigma2: torch.Tensor
    ipl_n: torch.Tensor
    rcut: torch.Tensor
    rcut2: torch.Tensor
    shift: torch.Tensor
    c0: torch.Tensor
    c2s2: torch.Tensor
    c4s4: torch.Tensor
    has_bond: torch.Tensor
    kr02: torch.Tensor
    r02: torch.Tensor
    eps4b: torch.Tensor
    sigma2b: torch.Tensor
    shiftb: torch.Tensor
    rcut2b: torch.Tensor

    @property
    def n_species(self) -> int:
        return self.kind.shape[0]

    @property
    def max_cutoff(self) -> float:
        """Largest pair cutoff — the cell-sizing input."""
        return float(self.rcut.max())

    @property
    def dtype(self) -> torch.dtype:
        return self.eps4.dtype

    @property
    def device(self) -> torch.device:
        return self.eps4.device

    def astype(self, dtype) -> "PairTable":
        """Cast all float fields to `dtype` (ints stay int32)."""
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(dtype)
                for f in dataclasses.fields(self)
                if f.name not in INT_FIELDS
            },
        )


def interaction_range(table: PairTable) -> float:
    """Largest interaction range including bond terms: the cell-sizing input
    for molecular systems. A FENE bond reaches to r0 and its LJ core to
    rcutbond, which can exceed the non-bonded cutoff (Trimer: r0 up to
    1.575 against a pair cutoff of ~1.23)."""
    r = table.rcut.double().cpu()
    rb = torch.sqrt(torch.maximum(table.rcut2b.double().cpu(), table.r02.double().cpu()))
    rb = torch.where(table.has_bond.cpu() > 0, rb, torch.zeros_like(rb))
    return float(torch.maximum(r, rb).max())


def kinds_present(table: PairTable):
    """Static tuple of the potential kinds this table uses."""
    return tuple(sorted(int(k) for k in set(table.kind.cpu().reshape(-1).tolist())))


class _Params:
    """Attribute bundle of gathered per-pair parameters."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def gather_pair(table: PairTable, si, sj, fields=None):
    """Per-pair parameters for species index tensors si, sj (broadcast);
    `fields` limits the gather to the fields the caller reads."""
    if fields is None:
        fields = [f.name for f in dataclasses.fields(table)]
    return _Params(**{f: getattr(table, f)[si, sj] for f in fields})


# ---------------------------------------------------------------------------
# Per-pair constructors (host-side, float64 math)
# ---------------------------------------------------------------------------


def _lj_unshifted(r2: float, eps4: float, sigma2: float) -> float:
    x = sigma2 / r2
    x3 = x**3
    return eps4 * (x3 * x3 - x3)


def _base_entry() -> Dict[str, float]:
    return dict(
        kind=KIND_NONE,
        eps4=0.0,
        sigma2=1.0,
        ipl_n=0,
        rcut=0.0,
        rcut2=0.0,
        shift=0.0,
        c0=0.0,
        c2s2=0.0,
        c4s4=0.0,
        has_bond=0,
        kr02=0.0,
        r02=0.0,
        eps4b=0.0,
        sigma2b=1.0,
        shiftb=0.0,
        rcut2b=0.0,
    )


def soft_spheres(eps: float, sigma: float, n: int, rcut: float | None = None) -> Dict:
    """Inverse-power pair, shifted to zero at rcut."""
    if rcut is None:
        rcut = 2.5 * sigma
    e = _base_entry()
    sigma2 = sigma * sigma
    e.update(
        kind=KIND_INVERSE_POWER,
        eps4=eps,  # raw eps for inverse power
        sigma2=sigma2,
        ipl_n=int(n),
        rcut=rcut,
        rcut2=rcut * rcut,
        shift=eps * (sigma2 / (rcut * rcut)) ** (n / 2),
    )
    return e


def lennard_jones(
    eps: float, sigma: float, rcut: float | None = None, shift_potential: bool = True
) -> Dict:
    """Cut (optionally shifted) LJ pair."""
    if rcut is None:
        rcut = 2.5 * sigma
    e = _base_entry()
    sigma2 = sigma * sigma
    rcut2 = rcut * rcut
    shift = _lj_unshifted(rcut2, 4 * eps, sigma2) if shift_potential else 0.0
    e.update(
        kind=KIND_LENNARD_JONES,
        eps4=4 * eps,
        sigma2=sigma2,
        rcut=rcut,
        rcut2=rcut2,
        shift=shift,
    )
    return e


def smooth_lennard_jones(eps: float, sigma: float, rcut: float | None = None) -> Dict:
    """LJ plus C0 + C2 r2 + C4 r4 smoothing."""
    if rcut is None:
        rcut = 2.5 * sigma
    e = _base_entry()
    sigma2 = sigma * sigma
    e.update(
        kind=KIND_SMOOTH_LJ,
        eps4=4 * eps,
        sigma2=sigma2,
        rcut=rcut,
        rcut2=rcut * rcut,
        c0=_SMOOTH_C0,
        c2s2=_SMOOTH_C2 / sigma2,
        c4s4=_SMOOTH_C4 / (sigma2 * sigma2),
    )
    return e


def general_kg(
    eps: float,
    sigma: float,
    k: float,
    r0: float,
    rcut: float | None = None,
    epsbond: float | None = None,
    sigmabond: float | None = None,
    rcutbond: float | None = None,
) -> Dict:
    """Kremer-Grest: WCA-cut LJ pair plus a FENE/LJ bond."""
    if rcut is None:
        rcut = 2 ** (1 / 6) * sigma
    if epsbond is None:
        epsbond = eps
    if sigmabond is None:
        sigmabond = sigma
    if rcutbond is None:
        rcutbond = rcut
    e = _base_entry()
    sigma2 = sigma * sigma
    sigma2b = sigmabond * sigmabond
    rcut2 = rcut * rcut
    rcut2b = rcutbond * rcutbond
    e.update(
        kind=KIND_LENNARD_JONES,
        eps4=4 * eps,
        sigma2=sigma2,
        rcut=rcut,
        rcut2=rcut2,
        shift=_lj_unshifted(rcut2, 4 * eps, sigma2),
        has_bond=1 if k != 0.0 else 0,
        kr02=-k * r0 * r0 / 2,
        r02=r0 * r0,
        eps4b=4 * epsbond,
        sigma2b=sigma2b,
        shiftb=_lj_unshifted(rcut2b, 4 * epsbond, sigma2b),
        rcut2b=rcut2b,
    )
    return e


def build_pair_table(
    entries: Sequence[Sequence[Dict]], dtype=torch.float64, device=None
) -> PairTable:
    """Assemble an S x S matrix of per-pair entry dicts into a PairTable on
    `device` (the card unless the caller names another)."""
    device = resolve_device(device)
    S = len(entries)
    mats: Dict[str, Any] = {}
    for f in dataclasses.fields(PairTable):
        rows = [[entries[i][j][f.name] for j in range(S)] for i in range(S)]
        if f.name in INT_FIELDS:
            mats[f.name] = torch.tensor(rows, dtype=torch.int32, device=device)
        else:
            mats[f.name] = torch.tensor(rows, dtype=torch.float64).to(device, dtype)
    return PairTable(**mats)


# ---------------------------------------------------------------------------
# Canned model matrices (reference parameter values)
# ---------------------------------------------------------------------------


def BHHP(dtype=torch.float64, device=None) -> PairTable:
    """2-species n=12 soft spheres (Bernu-Hiwatari-Hansen-Pastore)."""
    sig = [[1.0, 1.2], [1.2, 1.4]]
    entries = [[soft_spheres(1.0, sig[i][j], 12) for j in range(2)] for i in range(2)]
    return build_pair_table(entries, dtype, device)


def KobAndersen(dtype=torch.float64, device=None) -> PairTable:
    """2-species Kob-Andersen LJ mixture."""
    eps = [[1.0, 1.5], [1.5, 0.5]]
    sig = [[1.0, 0.8], [0.8, 0.88]]
    entries = [[lennard_jones(eps[i][j], sig[i][j]) for j in range(2)] for i in range(2)]
    return build_pair_table(entries, dtype, device)


def JBB(dtype=torch.float64, device=None) -> PairTable:
    """3-species smooth-LJ matrix."""
    eps = [[1.0, 1.5, 0.75], [1.5, 0.5, 1.5], [0.75, 1.5, 0.75]]
    sig = [[1.0, 0.8, 0.9], [0.8, 0.88, 0.8], [0.9, 0.8, 0.94]]
    entries = [
        [smooth_lennard_jones(eps[i][j], sig[i][j]) for j in range(3)] for i in range(3)
    ]
    return build_pair_table(entries, dtype, device)


def BinaryLJMixture(dtype=torch.float64, device=None) -> PairTable:
    """2-species LJ mixture of Rowley et al., "Monte Carlo Simulations of
    Binary Lennard-Jones Mixtures" (doi:10.1023/A:1022614200488), as
    examples/lj-mixture/run-validation.py runs it: the publication's
    Lorentz-Berthelot-fitted eps and sigma, one cutoff of 4 sigma_1 for
    every pair, unshifted."""
    eps = [[1.0, 1.1523], [1.1523, 1.3702]]
    sig = [[1.0, 1.0339], [1.0339, 1.0640]]
    entries = [
        [lennard_jones(eps[i][j], sig[i][j], rcut=4.0, shift_potential=False) for j in range(2)]
        for i in range(2)
    ]
    return build_pair_table(entries, dtype, device)


def Trimer(dtype=torch.float64, device=None) -> PairTable:
    """3-species Kremer-Grest trimer matrix."""
    sig = [[0.9, 0.95, 1.0], [0.95, 1.0, 1.05], [1.0, 1.05, 1.1]]
    k = [[0.0, 33.241, 30.0], [33.241, 0.0, 27.210884], [30.0, 27.210884, 0.0]]
    r0 = [[0.0, 1.425, 1.5], [1.425, 0.0, 1.575], [1.5, 1.575, 0.0]]
    entries = [
        [general_kg(1.0, sig[i][j], k[i][j], r0[i][j]) for j in range(3)] for i in range(3)
    ]
    return build_pair_table(entries, dtype, device)


# Explicit registry in place of evaluating model names
MODEL_REGISTRY = {
    "BHHP": BHHP,
    "KobAndersen": KobAndersen,
    "JBB": JBB,
    "BinaryLJMixture": BinaryLJMixture,
    "Trimer": Trimer,
    "GeneralKG": Trimer,  # molecule.xyz's metadata names the trimer system model:GeneralKG
}


def model_matrix_from_dict(
    model_dict: Dict[str, Dict], n_species: int, dtype=torch.float64, device=None
) -> PairTable:
    """Build a PairTable from TOML-style {"i-j": {name=..., epsilon=...}}
    blocks: key "i-j" with i <= j, symmetric fill, 1-based species."""
    entries: List[List[Dict]] = [[None] * n_species for _ in range(n_species)]
    for i in range(1, n_species + 1):
        for j in range(1, n_species + 1):
            key = f"{i}-{j}" if i <= j else f"{j}-{i}"
            m = model_dict[key]
            name = m["name"]
            if name == "GeneralKG":
                entry = general_kg(
                    m["epsilon"],
                    m["sigma"],
                    m["k"],
                    m["r0"],
                    rcut=m.get("rcut"),
                    epsbond=m.get("epsilonbond"),
                    sigmabond=m.get("sigmabond"),
                    rcutbond=m.get("rcutbond"),
                )
            elif name == "SmoothLennardJones":
                entry = smooth_lennard_jones(m["epsilon"], m["sigma"], rcut=m.get("rcut"))
            elif name == "LennardJones":
                entry = lennard_jones(
                    m["epsilon"],
                    m["sigma"],
                    rcut=m.get("rcut"),
                    shift_potential=m.get("shift_potential", True),
                )
            elif name == "SoftSpheres":
                entry = soft_spheres(m["epsilon"], m["sigma"], m["n"], rcut=m.get("rcut"))
            else:
                raise ValueError(f"Model {name!r} is not implemented")
            entries[i - 1][j - 1] = entry
    return build_pair_table(entries, dtype, device)


def resolve_model(model: Any, n_species: int, dtype=torch.float64, device=None) -> PairTable:
    """Resolve a model spec (registry name like "JBB"/"JBB()" or a dict of
    per-pair blocks) into a PairTable."""
    if isinstance(model, PairTable):
        return model
    if isinstance(model, dict):
        return model_matrix_from_dict(model, n_species, dtype, device)
    if isinstance(model, str):
        name = model.strip()
        if name.endswith("()"):
            name = name[:-2]
        if name not in MODEL_REGISTRY:
            raise ValueError(f"Unknown model {model!r}; known: {sorted(MODEL_REGISTRY)}")
        return MODEL_REGISTRY[name](dtype, device)
    raise TypeError(f"Cannot resolve model from {type(model)}")
