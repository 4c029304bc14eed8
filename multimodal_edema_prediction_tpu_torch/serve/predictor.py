"""Dynamic micro-batching predictor over the teacher eval step: the PyTorch
counterpart of ``multimodal_edema_prediction_tpu/serve/predictor.py`` in
pixel mode.

- **Shape buckets.** Requests are padded to a fixed bucket ladder (1, 2, 4,
  … ``max_batch``) by repeating row 0, so the set of shapes the device sees
  is bounded and ``warmup()`` can run each once before the first request.
- **One consumer thread owns the device.** HTTP handler threads only
  enqueue; a single batcher thread forms batches (coalescing whatever is
  queued within ``max_wait_ms``), runs the step, and resolves futures.

In pixel mode each request carries ``pixel_u8`` ([S, S, 3] uint8),
normalized on the device inside the step. Given an ``image_source`` or a
``feature_source`` (the training side's hooks, e.g.
``CXRFeatureBank.feature_source(keyed_by_row=False)``), requests name an
``image_id`` instead and batches carry ``image_ids``. A teacher of a
residual-fusion mode serves (``dual_patch``, ``dual_patch_event``,
``dual``); a ``single`` or ``legacy`` one has no fusion logits, and its
batches fail with the JAX predictor's ``RuntimeError``.

- **Data parallelism** (``data_parallel`` N, JAX's ``mesh``,
  ``predictor.py:117-135``): N replicas of the model, one per card (on the
  CPU, N replicas of the one device); every bucket is a multiple of N, each
  batch is split into N equal parts, each part runs on its replica, and the
  outputs are concatenated in order. N above the cards there are raises
  JAX's ``create_mesh`` error. ``aot_dir`` (persisted executables) has no
  counterpart yet (ROADMAP P10b).
"""
from __future__ import annotations

import copy
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..parallel import mesh as meshlib
from ..train import engine
from ..utils import resolve_device


class QueueFullError(RuntimeError):
    """Backpressure signal: the request queue is at capacity (HTTP 503)."""


@dataclass
class PredictorStats:
    n_requests: int = 0
    n_batches: int = 0
    n_rejected: int = 0
    batch_size_hist: dict = field(default_factory=dict)
    latency_ms: list = field(default_factory=list)   # bounded ring

    def snapshot(self) -> dict:
        lat = np.asarray(self.latency_ms, np.float64)
        pct = (lambda q: float(np.percentile(lat, q))) if lat.size else \
            (lambda q: float("nan"))
        return {
            "n_requests": self.n_requests,
            "n_batches": self.n_batches,
            "n_rejected": self.n_rejected,
            "mean_batch_size": (self.n_requests / self.n_batches
                                if self.n_batches else 0.0),
            "batch_size_hist": dict(sorted(self.batch_size_hist.items())),
            "latency_ms_p50": pct(50), "latency_ms_p90": pct(90),
            "latency_ms_p99": pct(99),
        }


@dataclass
class _Item:
    x_ts: np.ndarray          # [T, 2V] float32
    static: np.ndarray        # [D] float32
    bin_ends: np.ndarray      # [T] float32
    image_id: int             # keys the image/feature source
    pixel_u8: Optional[np.ndarray]      # [S, S, 3] uint8 (pixel mode)
    future: Optional[Future]
    t_enqueue: float


def _bucket_ladder(max_batch: int) -> tuple:
    sizes, b = [], 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return tuple(sizes)


def replica_devices(device: torch.device, n: int) -> list:
    """The devices of ``n`` replicas: cards 0..n-1 for a CUDA ``device``
    (``create_mesh``'s error when there are fewer), else ``device`` n
    times."""
    if n <= 1:
        return [device]
    pool = [torch.device("cuda", i) for i in range(torch.cuda.device_count())
            ] if device.type == "cuda" else [device] * n
    return list(meshlib.create_mesh(n, 1, pool).devices)


class BatchingPredictor:
    """Threaded micro-batching front end over one teacher eval step.

    Parameters
    ----------
    model: the port's ``TeacherModel`` (its weights already loaded).
    image_source / feature_source: the training side's hooks; with both
        None the predictor runs in pixel mode (requests carry
        ``pixel_u8``), else requests carry ``image_id``.
    max_batch: top of the bucket ladder (1, 2, 4, …, max_batch).
    max_wait_ms: how long the batcher waits to coalesce more requests once
        it holds at least one (0 = no coalescing).
    max_queue: backpressure bound; ``submit`` raises QueueFullError beyond.
    dtype: compute dtype (parameters stay float32, cast at use).
    device: where the model runs; ``"cuda"`` unless the caller asks for the
        CPU. The model is moved there.
    data_parallel: replicas of the model (module docstring); the buckets
        become multiples of it. ``feature_source`` may then be one source
        per replica, each reading a bank on its replica's device.
    """

    def __init__(self, model, *, image_source: Optional[Callable] = None,
                 feature_source: Optional[Callable] = None,
                 max_batch: int = 32,
                 max_wait_ms: float = 4.0, max_queue: int = 1024,
                 dtype=torch.bfloat16, labels: Optional[Sequence[str]] = None,
                 device="cuda", data_parallel: int = 1):
        self.devices = replica_devices(resolve_device(device),
                                       int(data_parallel))
        self._model = model.to(self.devices[0]).eval()
        self._pixel_mode = image_source is None and feature_source is None
        n = len(self.devices)
        sources = list(feature_source) \
            if isinstance(feature_source, (list, tuple)) \
            else [feature_source] * n
        if len(sources) != n:
            raise ValueError(f"{len(sources)} feature sources for {n} "
                             "replicas")
        self._steps = []
        for dev, source in zip(self.devices, sources):
            replica = self._model if dev == self.devices[0] \
                else copy.deepcopy(self._model).to(dev)
            self._steps.append(engine.make_teacher_eval_from_windows(
                replica, dtype,
                image_source=image_source or engine.default_image_source,
                feature_source=source))
        self._cfg = model.cfg
        # every bucket a multiple of the replicas (JAX predictor.py:127-135)
        self.buckets = tuple(b * n for b in _bucket_ladder(
            max(1, int(max_batch) // n)))
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._q: "queue.Queue[_Item]" = queue.Queue(maxsize=int(max_queue))
        self._stats = PredictorStats()
        self._lock = threading.Lock()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self.labels = list(labels) if labels is not None else None

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "BatchingPredictor":
        if self._running:
            return self
        self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-batcher", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        while True:     # fail anything still queued
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            item.future.set_exception(RuntimeError("predictor closed"))

    def warmup(self, example: dict) -> dict:
        """Run every bucket once from ONE example request dict; returns
        per-bucket seconds. Run before opening the port so that the first
        real request never pays a kernel build or a first launch."""
        times = {}
        for b in self.buckets:
            items = [self._parse(example) for _ in range(b)]
            for it in items:
                it.future = Future()
            t0 = time.time()
            self._run_batch(items, bucket=b, record=False)
            times[b] = round(time.time() - t0, 3)
        return times

    # --------------------------------------------------------------- intake
    def _parse(self, req: dict) -> _Item:
        x_ts = np.asarray(req["x_ts"], np.float32)
        if x_ts.ndim != 2:
            raise ValueError(f"x_ts must be [T, 2V], got {x_ts.shape}")
        T = x_ts.shape[0]
        static = np.asarray(req["static"], np.float32).reshape(-1)
        # validate against the model geometry HERE so one malformed request
        # can never fail the whole coalesced batch
        d = self._cfg.duett
        if x_ts.shape != (d.n_timesteps, 2 * d.n_variables):
            raise ValueError(
                f"x_ts must be [{d.n_timesteps}, {2 * d.n_variables}] "
                f"for this model, got {list(x_ts.shape)}")
        if static.shape != (d.d_static,):
            raise ValueError(f"static must be [{d.d_static}], "
                             f"got {list(static.shape)}")
        be = req.get("bin_ends")
        bin_ends = (np.arange(1, T + 1, dtype=np.float32) / 24.0
                    if be is None else np.asarray(be, np.float32))
        if bin_ends.shape != (T,):
            raise ValueError(f"bin_ends must be [T]={T}, got {bin_ends.shape}")
        pixel_u8 = None
        if self._pixel_mode:
            if "pixel_u8" not in req:
                raise ValueError("pixel mode: request must carry pixel_u8 "
                                 "[S, S, 3] uint8")
            pixel_u8 = np.asarray(req["pixel_u8"], np.uint8)
            S = self._cfg.vit.image_size
            if pixel_u8.shape != (S, S, 3):
                raise ValueError(f"pixel_u8 must be [{S}, {S}, 3] for this "
                                 f"model, got {list(pixel_u8.shape)}")
        return _Item(x_ts=x_ts, static=static, bin_ends=bin_ends,
                     image_id=int(req.get("image_id", 0)),
                     pixel_u8=pixel_u8, future=None, t_enqueue=0.0)

    def submit(self, req: dict) -> Future:
        """Validate + enqueue one request; resolves to a per-request dict of
        float lists (probabilities + branch logits)."""
        if not self._running:
            raise RuntimeError("predictor not started")
        item = self._parse(req)
        item.future = Future()
        item.t_enqueue = time.time()
        try:
            self._q.put_nowait(item)
        except queue.Full:
            with self._lock:
                self._stats.n_rejected += 1
            raise QueueFullError(
                f"request queue at capacity ({self._q.maxsize})") from None
        return item.future

    def predict(self, req: dict, timeout: float = 60.0) -> dict:
        return self.submit(req).result(timeout=timeout)

    def stats(self) -> dict:
        with self._lock:
            return self._stats.snapshot()

    # -------------------------------------------------------------- batcher
    def _loop(self) -> None:
        max_b = self.buckets[-1]
        while self._running:
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            items = [first]
            deadline = time.time() + self.max_wait_s
            while len(items) < max_b:
                left = deadline - time.time()
                if left <= 0:
                    # grab whatever is already queued, then go
                    try:
                        while len(items) < max_b:
                            items.append(self._q.get_nowait())
                    except queue.Empty:
                        pass
                    break
                try:
                    items.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            try:
                self._run_batch(items)
            except Exception as e:      # noqa: BLE001 — fail the batch, not the server
                for it in items:
                    if not it.future.done():
                        it.future.set_exception(e)

    def _assemble(self, items: list, bucket: int) -> tuple:
        """Pad-to-bucket array assembly: (x_ts, static, batch)."""
        n = len(items)
        # pad by repeating row 0: real data, so padding rows stay finite
        idx = list(range(n)) + [0] * (bucket - n)
        x_ts = np.stack([items[i].x_ts for i in idx])
        static = np.stack([items[i].static for i in idx])
        batch = {"bin_ends": np.stack([items[i].bin_ends for i in idx])}
        if self._pixel_mode:
            batch["pixel_u8"] = np.stack([items[i].pixel_u8 for i in idx])
        else:
            batch["image_ids"] = np.asarray(
                [items[i].image_id for i in idx], np.int32)
        return x_ts, static, batch

    def _forward(self, x_ts, static, batch: dict) -> dict:
        """The bucket's outputs as host arrays: one replica's step, or each
        replica's equal part (all launched before any is read back),
        concatenated in order."""
        n = len(self._steps)
        if n == 1:
            return {k: v.cpu().numpy() for k, v in
                    self._steps[0](x_ts, static, batch).items()}
        part = len(x_ts) // n
        outs = [step(x_ts[i * part:(i + 1) * part],
                     static[i * part:(i + 1) * part],
                     {k: v[i * part:(i + 1) * part]
                      for k, v in batch.items()})
                for i, step in enumerate(self._steps)]
        return {k: np.concatenate([o[k].cpu().numpy() for o in outs])
                for k in outs[0]}

    def _run_batch(self, items: list, bucket: Optional[int] = None,
                   record: bool = True) -> None:
        n = len(items)
        if bucket is None:
            bucket = next(b for b in self.buckets if b >= n)
        x_ts, static, batch = self._assemble(items, bucket)
        # inference mode is thread-local: entered here, in the thread that
        # runs the model
        with torch.inference_mode():
            out = self._forward(x_ts, static, batch)
            out = {k: v[:n] for k, v in out.items()}
        if "fusion_logits" not in out:
            raise RuntimeError(
                "serving requires a dual_patch/dual-mode teacher (got a "
                f"model emitting {sorted(out)}); single/legacy-mode "
                "checkpoints are offline-scoring only (cli/predict.py)")
        probs = 1.0 / (1.0 + np.exp(-out["fusion_logits"]))
        now = time.time()
        if record:      # before the futures resolve, so a client that has
            with self._lock:     # its answer also sees it counted
                s = self._stats
                s.n_requests += n
                s.n_batches += 1
                s.batch_size_hist[n] = s.batch_size_hist.get(n, 0) + 1
                for it in items:
                    if it.t_enqueue:
                        s.latency_ms.append((now - it.t_enqueue) * 1e3)
                if len(s.latency_ms) > 2048:
                    del s.latency_ms[:-1024]
        for i, it in enumerate(items):
            res = {"probabilities": probs[i].tolist(),
                   "fusion_logits": out["fusion_logits"][i].tolist(),
                   "img_logits": out["img_logits"][i].tolist(),
                   "ts_logits": out["ts_logits"][i].tolist(),
                   "main_probability": float(probs[i][0])}
            if self.labels is not None:
                res["labels"] = self.labels
            it.future.set_result(res)
