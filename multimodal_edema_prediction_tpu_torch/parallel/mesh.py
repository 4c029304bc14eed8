"""Mesh checks, batch placement and the tensor-parallel rules: the port's
counterpart of ``multimodal_edema_prediction_tpu/parallel/mesh.py``.

JAX lays its devices out as a ``Mesh(("data", "model"))`` and lets GSPMD
insert the collectives. The port runs data parallelism as one process per
data shard (``multihost.py``), or, in serving, one model replica per card
(``serve/predictor.py``), so a mesh here is the checked shape of that
layout: ``create_mesh`` raises where JAX's does. ``param_spec`` carries
JAX's tensor-parallel rules over as a pure function of a parameter's path.
No training path calls it, as in JAX, where only serving shards parameters
and always on a ``model`` axis of 1: tensor parallelism stays unported.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from . import multihost as mh

MULTI_PROCESS_TP_ERROR = (
    "multi-process runs are data-parallel over the pod; set n_model=1 (TP "
    "spans hosts only via GSPMD single-controller, not jax.distributed)")


@dataclass(frozen=True)
class Mesh:
    """``n_data`` × ``n_model`` of ``devices`` (ranks, or cards): the data
    axis's i-th shard lives on ``devices[i * n_model]``."""
    n_data: int
    n_model: int
    devices: tuple

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}


def _default_devices() -> list:
    """The ranks of a multi-process run (one data shard each), else this
    host's cards, else the CPU."""
    if mh.process_count() > 1:
        return list(range(mh.process_count()))
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def create_mesh(n_data: int = 0, n_model: int = 1,
                devices: Optional[Sequence] = None) -> Mesh:
    """JAX ``create_mesh`` (``mesh.py:20``) as a check: ``n_data`` 0 takes
    every device (the world size in a multi-process run); ``n_data`` ×
    ``n_model`` must fit the devices there are; a multi-process run takes
    ``n_model`` 1 only (JAX ``teacher_loop.py:181-184``)."""
    devices = list(devices if devices is not None else _default_devices())
    if mh.process_count() > 1 and n_model != 1:
        raise ValueError(MULTI_PROCESS_TP_ERROR)
    if n_data <= 0:
        n_data = len(devices) // max(n_model, 1)
    if n_data * n_model > len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_model} needs more than {len(devices)} devices")
    return Mesh(n_data, n_model, tuple(devices[: n_data * n_model]))


def shard_batch(batch: dict, device) -> dict:
    """A rank's local host batch → tensors on its ``device`` (JAX
    ``mesh.py:40``): the host-only side channels (``_global``, any
    ``_``-key) stay behind; evaluators read them from the host batch."""
    from ..train.engine import to_device
    return to_device(batch, device)


# --- tensor-parallel parameter rules (JAX mesh.py:70-80) -------------------
# (path regex, spec): the axis each entry names "model" is split; first
# match wins. Megatron-style: FFN in / q, k, v split their output features,
# FFN out / attention out their input features, so a pair needs one reduce.
_TP_RULES = (
    (re.compile(r"(vit|cxr).*(ff_in|mlp_in)/kernel"), (None, "model")),
    (re.compile(r"(vit|cxr).*(ff_in|mlp_in)/bias"), ("model",)),
    (re.compile(r"(vit|cxr).*(ff_out|mlp_out)/kernel"), ("model", None)),
    (re.compile(r"(vit|cxr).*attn/(q|k|v)/kernel"), (None, "model")),
    (re.compile(r"(vit|cxr).*attn/(q|k|v)/bias"), ("model",)),
    (re.compile(r"(vit|cxr).*attn/out/kernel"), ("model", None)),
)


def param_spec(path: str, ndim: int) -> Optional[int]:
    """The axis of a flax-layout parameter (``convert.flax_paths``' path,
    e.g. ``cxr/block_0/attn/q/kernel``) that a ``model`` mesh axis would
    split, or None where it would replicate: JAX ``param_spec``
    (``mesh.py:84``) as a pure function."""
    for rx, spec in _TP_RULES:
        if rx.search(path) and len(spec) <= ndim:
            return spec.index("model")
    return None
