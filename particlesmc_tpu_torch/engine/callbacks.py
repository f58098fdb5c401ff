"""Scalar observables recorded by StoreCallbacks (counterpart of
particlesmc_tpu/engine/callbacks.py). A callback is `f(sim) -> np.ndarray[B]`,
one value per chain."""

from __future__ import annotations

import numpy as np

from ..core import energy as E


def energy(sim) -> np.ndarray:
    """Energy per particle of each chain (the incremental ledger)."""
    st = sim.mc.system
    return st.energy.double().cpu().numpy() / st.n_particles


def acceptance(sim) -> np.ndarray:
    """Overall acceptance rate per chain."""
    att = sim.mc.attempted.sum(dim=-1).cpu().numpy()
    acc = sim.mc.accepted.sum(dim=-1).cpu().numpy()
    return np.where(att > 0, acc / np.maximum(att, 1), 0.0)


def chain_correlation(sim) -> np.ndarray:
    """Squared species-correlation order parameter of monodisperse chain
    molecules: species values in the file convention (1-based) with species
    2 mapped to -1, Σ_{i<j} (mean over molecules of s_i s_j)^2."""
    st = sim.mc.system
    mol_len = sim.chains.mol_len
    if st.molecule is None:
        raise ValueError("chain_correlation requires a molecular system")
    L = int(mol_len[0])
    if not (mol_len == L).all():
        raise ValueError("All chains must have the same length")
    if L < 2:
        raise ValueError("Chains must have at least two particles")
    sp = st.species.cpu().numpy() + 1  # [B, N], back to file species values
    B = sp.shape[0]
    nmol = len(mol_len)
    poly = sp.reshape(B, nmol, L).astype(np.float64)
    poly[poly == 2] = -1
    out = np.zeros(B)
    for i in range(L - 1):
        for j in range(i + 1, L):
            cross = (poly[:, :, i] * poly[:, :, j]).sum(axis=1) / nmol
            out += cross**2
    return out


def pressure(sim) -> np.ndarray:
    """Virial pressure per chain, P = rho T + W / (d V), computed on the
    chains' device in their dtype."""
    st = sim.mc.system
    p = E.pressure(st.position, st.species, st.box, sim.chains.table, st.density, st.temperature, st.bonds)
    return p.double().cpu().numpy()


CALLBACK_REGISTRY = {
    "energy": energy,
    "acceptance": acceptance,
    "pressure": pressure,
    "callback_energy": energy,
    "callback_acceptance": acceptance,
    "chain_correlation": chain_correlation,
}
