"""Graceful preemption for preemptible card hosts (the counterpart of
``multimodal_edema_prediction_tpu/utils/preemption.py``).

A SIGTERM (or SIGUSR1, which some schedulers send as the warning before
preemption) sets a flag; the training loops read it at every epoch
boundary, save the full train state (``train/checkpoint.py::
FullStateResumer``) and return cleanly, so the restarted job continues bit
for bit with ``auto_resume`` / ``--resume_dir``. In a multi-process run
the loops agree on the flag over the ranks
(``parallel/multihost.any_flag``), so a signal that reaches one rank stops
every rank at the same boundary.
"""
from __future__ import annotations

import signal
import threading

_requested = threading.Event()
_installed = False


def install_handler(signals=(signal.SIGTERM, signal.SIGUSR1)) -> None:
    """Arm the handler: idempotent, and a no-op off the main thread (where
    Python cannot take a signal handler). The training CLIs call it through
    ``cli/common.py::configs_from_args``."""
    global _installed
    if _installed or threading.current_thread() is not \
            threading.main_thread():
        return

    def _handler(signum, frame):
        _requested.set()

    for s in signals:
        signal.signal(s, _handler)
    _installed = True


def request() -> None:
    """Ask for a preemption from code (tests, in-process schedulers)."""
    _requested.set()


def requested() -> bool:
    return _requested.is_set()


def clear() -> None:
    _requested.clear()
