"""Host → device prefetching for batch streams: the port's counterpart of
``multimodal_edema_prediction_tpu/data/prefetch.py`` (``DevicePrefetcher``,
``prefetch``; the reference's ``DataLoader(num_workers, pin_memory=True)``).

A worker thread runs the host iterator (and with it the dataset's batch
hook: JPEG decode, a u8 store's reads, a token store's rows) and
``host_fn``, keeping ``depth`` batches in flight. On a card it copies each
batch into pinned host memory and from there to the device on a side
stream (a tensor the hook already left on the device, such as the card
decoder's pixels, passes as it is); the consumer's stream waits on that
copy's event before the batch is used, and the batch's tensors are marked
used on the consumer's stream
(``record_stream``), so the caching allocator cannot hand their memory to
another copy while the step still reads it. A pinned buffer is released
only after the consumer has waited on its copy. On the CPU the worker
yields the host batch's tensors as they are, in order. A worker's
exception is raised in the consumer; ``close`` (also when the consumer
stops early) stops the worker and joins it.

``stack_host_batches`` groups a host stream into K-stacked batches for
multi-step dispatch (``train/engine.py::scan_steps``); the prefetcher
carries such a batch as any other, its leading axis K included.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

_END = object()


def _host_tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else torch.as_tensor(x)


class DevicePrefetcher:
    """Wrap a host batch iterator (dicts of numpy arrays); yield batches of
    tensors on ``device``.

    ``depth``: batches kept in flight (at least 1). ``host_fn``: a host
    transform run in the worker before the copy."""

    def __init__(self, batches: Iterable[dict], device, depth: int = 2,
                 host_fn: Optional[Callable[[dict], dict]] = None):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._q: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._thread = threading.Thread(
            target=self._work, args=(iter(batches), host_fn),
            name="prefetch", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Enqueue unless closed; False once the consumer has closed."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _stage(self, batch: dict):
        """(tensors, the copy's event or None, the pinned host tensors);
        the batch's ``_``-keys (host-only side channels) stay behind."""
        host = {k: _host_tensor(v) for k, v in batch.items()
                if not k.startswith("_")}
        if not self._cuda:
            return host, None, None
        pinned = {k: t.pin_memory() for k, t in host.items()
                  if t.device != self.device}
        with torch.cuda.stream(self._stream):
            dev = {k: t.to(self.device, non_blocking=True)
                   for k, t in pinned.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return {**host, **dev}, done, pinned

    def _work(self, it: Iterator[dict], host_fn) -> None:
        try:
            if self._cuda:
                torch.cuda.set_device(self.device)
            for b in it:
                if self._stop.is_set():
                    return
                if host_fn is not None:
                    b = host_fn(b)
                if not self._put(self._stage(b)):
                    return
        except BaseException as e:   # raised again in the consumer
            self._err = e
        finally:
            self._put(_END)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            item = self._q.get()
            if item is _END:
                if self._err is not None:
                    raise self._err
                return
            dev, done, pinned = item
            if done is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(done)
                for t in dev.values():
                    t.record_stream(stream)
            del pinned          # its copy is ordered before any later use
            yield dev

    def close(self) -> None:
        """Stop the worker (it may be blocked on a full queue) and join
        it."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
        self._thread.join()


def prefetch(batches: Iterable[dict], device, depth: int = 2,
             host_fn: Optional[Callable[[dict], dict]] = None
             ) -> Iterator[Dict[str, torch.Tensor]]:
    """``for batch in prefetch(ds.iter_batches(...), device)``: the batches
    of a ``DevicePrefetcher``, whose worker is stopped and joined when the
    loop ends, breaks or raises (or the generator is closed)."""
    p = DevicePrefetcher(batches, device, depth, host_fn)
    try:
        yield from p
    finally:
        p.close()


def stack_host_batches(batches: Iterable[dict], k: int) -> Iterator[dict]:
    """Group a host batch stream into K-stacked batches for
    ``engine.scan_steps`` (a new leading axis K on every field; JAX
    ``data/prefetch.py:73-88``). The last group carries the remainder
    (< k), which ``scan_steps`` runs as a shape of its own (on a card, a
    second captured graph). A nested dict (a process's ``_global`` labels,
    ``parallel/multihost.split_batch_for_process``) is stacked key by key,
    so that its row i stays step i's; a tensor field (a hook's bf16 tokens,
    a card decoder's pixels) is stacked with ``torch.stack``."""
    buf = []
    for b in batches:
        buf.append(b)
        if len(buf) == k:
            yield _stack(buf)
            buf = []
    if buf:
        yield _stack(buf)


def _stack(batches: list) -> dict:
    out = {}
    for key, first in batches[0].items():
        vals = [b[key] for b in batches]
        # a hook's tensors (bf16 tokens, a card decoder's pixels) stack as
        # tensors where they lie: numpy has no bf16
        out[key] = _stack(vals) if isinstance(first, dict) else \
            torch.stack(vals) if isinstance(first, torch.Tensor) else \
            np.stack(vals)
    return out
