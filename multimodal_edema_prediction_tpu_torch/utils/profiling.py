"""Profiling and throughput instrumentation: the counterpart of
``multimodal_edema_prediction_tpu/utils/profiling.py``.

- :func:`trace` wraps ``torch.profiler`` (CPU activity, and CUDA's on a
  card) and writes a Chrome trace under ``log_dir``;
- :class:`StepTimer` is the per-step samples/s meter. It reads the host
  clock: its caller synchronises the card before ``stop``, as the JAX
  package's callers block on their results.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import numpy as np


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the enclosed block into ``log_dir/trace_<pid>_<ns>.json``
    and yield the profiler (``key_averages()`` reads it); a no-op yielding
    None when ``log_dir`` is empty."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Wall-clock step timer with warmup discard and percentile stats."""

    def __init__(self, batch_size: int, n_chips: int = 1, warmup: int = 2):
        self.batch_size = batch_size
        self.n_chips = n_chips
        self.warmup = warmup
        self._times: List[float] = []
        self._last: Optional[float] = None

    def start(self):
        self._last = time.perf_counter()

    def stop(self):
        if self._last is not None:
            self._times.append(time.perf_counter() - self._last)
            self._last = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    @property
    def steps(self) -> int:
        return max(len(self._times) - self.warmup, 0)

    def summary(self) -> dict:
        t = np.asarray(self._times[self.warmup:])
        if len(t) == 0:
            return {"steps": 0}
        sps = self.batch_size / t
        return {
            "steps": int(len(t)),
            "mean_step_ms": float(t.mean() * 1e3),
            "p50_step_ms": float(np.percentile(t, 50) * 1e3),
            "p95_step_ms": float(np.percentile(t, 95) * 1e3),
            "samples_per_sec": float(sps.mean()),
            "samples_per_sec_per_chip": float(sps.mean() / self.n_chips),
        }
