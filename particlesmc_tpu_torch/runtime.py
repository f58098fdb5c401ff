"""Device selection and the error for inputs this port does not cover yet."""

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


def unported(what: str, item: int) -> NotImplementedError:
    """The error for an input outside the ported slice; `item` is the
    ROADMAP.md queue-1 item that will port it."""
    return NotImplementedError(
        f"{what} is not ported to particlesmc_tpu_torch yet "
        f"(ROADMAP.md queue 1 item {item}); use particlesmc_tpu"
    )
