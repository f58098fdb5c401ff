"""Device selection of the entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Without CUDA and without an explicit device this raises — the
    port never drops to the CPU quietly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (library) or "
            "--device cpu (CLI) to run on the CPU"
        )
    return torch.device("cuda")

