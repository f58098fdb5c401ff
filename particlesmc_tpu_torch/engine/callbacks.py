"""Scalar observables recorded by StoreCallbacks (counterpart of
particlesmc_tpu/engine/callbacks.py). A callback is `f(sim) -> np.ndarray[B]`,
one value per chain."""

from __future__ import annotations

import numpy as np


def energy(sim) -> np.ndarray:
    """Energy per particle of each chain (the incremental ledger)."""
    st = sim.mc.system
    return st.energy.double().cpu().numpy() / st.n_particles


def acceptance(sim) -> np.ndarray:
    """Overall acceptance rate per chain."""
    att = sim.mc.attempted.sum(dim=-1).cpu().numpy()
    acc = sim.mc.accepted.sum(dim=-1).cpu().numpy()
    return np.where(att > 0, acc / np.maximum(att, 1), 0.0)


CALLBACK_REGISTRY = {
    "energy": energy,
    "acceptance": acceptance,
    "callback_energy": energy,
    "callback_acceptance": acceptance,
}
