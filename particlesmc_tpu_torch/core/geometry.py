"""Periodic-boundary geometry (counterpart of particlesmc_tpu/core/geometry.py).

Plain tensor functions that broadcast over any leading shape."""

from __future__ import annotations

import math

import torch


def fold_back(x, box):
    """Fold positions into the primary box [0, L) per dimension."""
    return x - torch.floor(x / box) * box


def min_image(dx, box):
    """Minimum-image displacement; torch.round rounds half to even, as the
    reference does."""
    return dx - torch.round(dx / box) * box


def dist2(xi, xj, box):
    """Squared nearest-image distance, reduced over the last axis."""
    dx = min_image(xi - xj, box)
    return torch.sum(dx * dx, dim=-1)


def volume_sphere(r: float, d: int) -> float:
    """Volume of the d-dimensional sphere of radius r."""
    if d == 0:
        return 1.0
    if d == 1:
        return 2.0 * r
    return 2.0 * math.pi * r * r * volume_sphere(r, d - 2) / d
