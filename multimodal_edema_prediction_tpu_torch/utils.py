"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, raising when it names CUDA and there is no
    usable card. Entry points default to ``"cuda"``; nothing moves to the
    CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           "is available (pass device='cpu' to run on the "
                           "CPU)")
    return dev
