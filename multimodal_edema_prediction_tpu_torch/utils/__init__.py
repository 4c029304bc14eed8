"""Device selection and console logging shared by the port's entry points;
graceful preemption is ``utils/preemption.py``."""
from __future__ import annotations

import time
from typing import Callable

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


def console_logger(name: str) -> Callable[[str], None]:
    """The console part of the JAX package's ``utils/logging.Logger``: a
    ``log(msg)`` that prints ``[name +seconds] msg``, the seconds counted
    from this call. (Its wandb half is ROADMAP P20.)"""
    t0 = time.time()

    def log(msg: str) -> None:
        print(f"[{name} +{time.time() - t0:7.1f}s] {msg}", flush=True)

    return log
