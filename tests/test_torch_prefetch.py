"""The port's prefetcher (``data/prefetch.py``) on the CPU: batches in order
and in full, the hook run in the worker thread, equal to the batches
``engine.to_device`` makes without it; a worker's error raised in the
consumer; an early stop (``break``, ``close``, an error in the step) leaves
no live worker; and the teacher loop's epoch batches equal with and
without prefetching. (Pinned copies on a side stream: the card-only
``tests/test_torch_cuda.py``.)"""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu_torch.config import (DataConfig,
                                                          TrainConfig)
from multimodal_edema_prediction_tpu_torch.data import pipeline as P
from multimodal_edema_prediction_tpu_torch.data import synthetic as S
from multimodal_edema_prediction_tpu_torch.data.prefetch import (
    DevicePrefetcher, prefetch)
from multimodal_edema_prediction_tpu_torch.train import engine
from multimodal_edema_prediction_tpu_torch.train import teacher_loop as L


def _batches(n, size=4):
    rng = np.random.default_rng(0)
    for i in range(n):
        yield {"i": np.full(size, i, np.int32),
               "x": rng.normal(size=(size, 3)).astype(np.float32),
               "m": rng.random(size) > 0.5}


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "prefetch"]


@pytest.fixture(autouse=True)
def _no_worker_left():
    yield
    deadline = time.time() + 5
    while _prefetch_threads() and time.time() < deadline:
        time.sleep(0.01)
    assert not _prefetch_threads()


@pytest.mark.parametrize("depth", [0, 1, 2, 5])
def test_order_count_and_values(depth):
    """Every batch, in order, equal to ``engine.to_device``'s tensors."""
    want = [engine.to_device(b, torch.device("cpu")) for b in _batches(7)]
    got = list(prefetch(_batches(7), "cpu", depth=depth))
    assert len(got) == 7
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k])


def test_host_fn_runs_in_the_worker():
    seen = []

    def hook(b):
        seen.append(threading.current_thread().name)
        return {**b, "y": b["x"] * 2}

    out = list(prefetch(_batches(3), "cpu", host_fn=hook))
    assert seen == ["prefetch"] * 3
    assert all(torch.equal(o["y"], o["x"] * 2) for o in out)


def test_worker_error_is_raised_in_the_consumer():
    def boom(b):
        if int(b["i"][0]) == 2:
            raise KeyError("image ids not in HBM bank: [7]")
        return b

    got = []
    with pytest.raises(KeyError, match="not in HBM bank"):
        for b in prefetch(_batches(5), "cpu", depth=2, host_fn=boom):
            got.append(int(b["i"][0]))
    assert got == [0, 1]


def test_an_iterator_error_is_raised_too():
    def bad():
        yield from _batches(1)
        raise ValueError("JPEG decode failed for batch items [3]")

    with pytest.raises(ValueError, match=r"items \[3\]"):
        list(prefetch(bad(), "cpu"))


@pytest.mark.parametrize("how", ["break", "close", "step_error"])
def test_an_early_stop_leaves_no_live_worker(how):
    """The worker, blocked on a full queue ahead of the consumer, is
    stopped and joined (the autouse fixture checks no worker is left)."""
    made = []

    def slow_source():
        for b in _batches(50):
            made.append(int(b["i"][0]))
            yield b

    gen = prefetch(slow_source(), "cpu", depth=2)
    if how == "close":
        next(gen)
        gen.close()
    elif how == "break":
        for b in gen:
            if int(b["i"][0]) == 1:
                break
        gen.close()
    else:
        with pytest.raises(RuntimeError):
            for b in gen:
                raise RuntimeError("a failing step")
    assert len(made) < 50


def test_prefetcher_close_joins_a_blocked_worker():
    p = DevicePrefetcher(_batches(20), "cpu", depth=1)
    time.sleep(0.05)                  # the worker fills the queue and waits
    p.close()
    assert not p._thread.is_alive()


def test_many_prefetchers_at_once_keep_their_order():
    """More workers than cores, with a short switch interval: each
    consumer still sees its own stream whole and in order."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        results = {}

        def consume(k):
            results[k] = [int(b["i"][0]) for b in prefetch(
                _batches(30, size=2), "cpu", depth=1 + k % 3)]

        threads = [threading.Thread(target=consume, args=(k,))
                   for k in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert results == {k: list(range(30)) for k in range(24)}


def test_teacher_epoch_batches_equal_with_and_without_prefetch():
    """The loop's epoch stream (``teacher_loop._train_batches``) gives the
    same batches through the worker as inline, the synthetic pixel hook
    included."""
    ds = S.make_synthetic(seed=0, n_subjects=20, n_stays=40, n_variables=6,
                          min_len=26, max_len=40)
    ad = P.build_anchor_dataset(ds, P.meta_from_events(ds, DataConfig()),
                                DataConfig())
    ad.batch_hook = L.make_synthetic_pixel_hook(28)
    cfg = TrainConfig(batch_size=8, limit_batches=3)
    inline = list(L._train_batches(ad, cfg, 1, torch.device("cpu"), 0))
    fetched = list(L._train_batches(ad, cfg, 1, torch.device("cpu"), 2))
    assert len(inline) == len(fetched) == 3
    for a, b in zip(inline, fetched):
        assert set(a) == set(b) and "valid" not in a
        assert "pixel_values" in a
        for k in a:
            assert torch.equal(a[k], b[k]), k
