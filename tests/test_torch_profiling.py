"""The port's ``utils/profiling.py`` against the JAX package's, on the CPU:
``StepTimer.summary`` equals JAX's on the same recorded times (the warmup
discarded, percentiles, samples/s per chip); ``trace("")`` and
``trace(None)`` are no-ops; ``trace(dir)`` writes a Chrome trace of the
enclosed block there through ``torch.profiler``.
"""
import json
import os

import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.utils import profiling as J
from multimodal_edema_prediction_tpu_torch.utils import profiling as Pt


@pytest.mark.parametrize("n,warmup,chips", [(0, 2, 1), (2, 2, 1),
                                            (9, 2, 4), (30, 0, 8)])
def test_step_timer_summary_matches_jax(n, warmup, chips):
    times = list(np.random.default_rng(n).uniform(0.01, 0.2, n))
    timers = [m.StepTimer(batch_size=32, n_chips=chips, warmup=warmup)
              for m in (J, Pt)]
    for tm in timers:
        tm._times = list(times)
    want, got = (tm.summary() for tm in timers)
    assert got == want
    assert timers[1].steps == timers[0].steps == max(n - warmup, 0)


def test_step_timer_times_what_it_encloses():
    tm = Pt.StepTimer(batch_size=4, warmup=0)
    for _ in range(3):
        with tm:
            pass
    tm.stop()                       # no open step: nothing recorded
    assert tm.steps == 3 and tm.summary()["steps"] == 3


@pytest.mark.parametrize("log_dir", ["", None])
def test_trace_without_a_directory_is_a_no_op(log_dir, tmp_path,
                                              monkeypatch):
    monkeypatch.chdir(tmp_path)
    with Pt.trace(log_dir) as prof:
        torch.ones(3).sum()
    assert prof is None and os.listdir(tmp_path) == []


def test_trace_writes_a_trace_on_the_cpu(tmp_path):
    out = tmp_path / "prof"
    with Pt.trace(str(out)) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    (name,) = os.listdir(out)
    with open(out / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in a.key for a in prof.key_averages())
