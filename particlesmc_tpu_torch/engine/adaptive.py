"""Acceptance-targeting sigma controller, the AdaptiveSigma output algorithm
(counterpart of particlesmc_tpu/engine/adaptive.py).

The controller drives each displacement move's sigma to a target acceptance
by a Robbins-Monro update on log sigma at its scheduled events:

    sigma <- sigma * exp(kappa_k * (acc_window - target)),   kappa_k = kappa / sqrt(k)

with acc_window the move's acceptance since the previous event, summed over
all chains (over every chain shard: integer counts, so exactly), clipped to [sigma_min, sigma_max]. Adapting a proposal during
sampling breaks detailed balance of the composite chain, so the controller
is meant for the burn-in window: it freezes after its last scheduled event,
and the 1/sqrt(k) gain keeps the bias vanishing if the schedule runs on.
On the checkerboard backend sigma_max defaults to half the smallest cell
side (past it nearly every proposal leaves its cell and the acceptance
signal dies). The default target, 0.22, is the JAX package's.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


class AdaptiveSigma:
    """Bound to a Simulation; adapts every displacement move's sigma (or one
    move's, `move`, a 0-based pool index). Each event writes
    `<path>/moves/<m>/sigma.dat` rows "step sigma window_acceptance"."""

    def __init__(
        self,
        sim,
        move: Optional[int] = None,
        target: float = 0.22,
        kappa: float = 1.0,
        sigma_min: float = 1e-4,
        sigma_max: Optional[float] = None,
    ):
        self.sim = sim
        self.target = float(target)
        self.kappa = float(kappa)
        self.sigma_min = float(sigma_min)
        spec = getattr(sim, "cb_spec", None)
        if sigma_max is None and spec is not None:
            box0 = sim.chains.states.box[0].double().cpu().numpy()
            sigma_max = float(np.min(box0 / np.asarray(spec.ncells, np.float64))) / 2.0
        self.sigma_max = float(sigma_max) if sigma_max is not None else np.inf
        if move is None:
            self.moves = [m for m, mv in enumerate(sim.pool) if mv.action == "displacement"]
        else:
            if sim.pool[move].action != "displacement":
                raise ValueError(f"AdaptiveSigma move index {move} is not a displacement move")
            self.moves = [int(move)]
        if not self.moves:
            raise ValueError("AdaptiveSigma needs a displacement move in the pool")
        self._snap = None  # (attempted, accepted) at the previous event
        self._k = 0  # update count (diminishing gain)

    def step(self, t: int):
        att, acc = self.sim.counters()
        if self._snap is None:
            self._snap = (att, acc)
            return
        d_att = att - self._snap[0]
        d_acc = acc - self._snap[1]
        self._snap = (att, acc)
        self._k += 1
        gain = self.kappa / np.sqrt(self._k)
        params = list(self.sim.pool_params)
        for m in self.moves:
            if d_att[m] <= 0:
                continue
            rate = float(d_acc[m]) / float(d_att[m])
            sigma = float(params[m]["sigma"])
            sigma = float(np.clip(sigma * np.exp(gain * (rate - self.target)), self.sigma_min, self.sigma_max))
            # same dtype and device as before: the kernels read it as they did
            params[m] = dict(params[m], sigma=torch.full_like(params[m]["sigma"], sigma))
            path = os.path.join(self.sim.path, "moves", str(m + 1), "sigma.dat")
            with open(path, "a") as f:
                f.write(f"{t} {sigma:.12g} {rate:.6g}\n")
        self.sim.pool_params = tuple(params)
