"""Orbax checkpoints of the train state, read and written without orbax or
tensorstore: the counterpart of
``multimodal_edema_prediction_tpu/train/orbax_io.py``.

A step is the directory orbax's ``CheckpointManager`` with
``StandardSave`` writes (orbax 0.11), so that either package restores the
other's:

    <directory>/<step>/_CHECKPOINT_METADATA     handler, timestamps
    <directory>/<step>/default/_METADATA        the tree: every leaf's key
                                                path and type (None for an
                                                empty optax state or a
                                                ``MaskedNode``)
    <directory>/<step>/default/_sharding        each array's sharding
    <directory>/<step>/default/array_metadatas/process_0
    <directory>/<step>/default/manifest.ocdbt   an OCDBT store
    <directory>/<step>/default/d/…              (``utils/ocdbt.py``) of zarr
                                                v2 arrays (``utils/zarr2.py``)

The tree is JAX's ``{"params", "batch_stats", "opt_state", "step"}``:
the weights in the flax layout and the optimizer's moments in optax's tree
(``convert.optax_state``), each array under its dotted key path
(``opt_state.inner_states.backbone.inner_state.1.0.mu.duett.…``).

The port writes the store in one level at ``default/`` (orbax writes two,
``default/`` over ``default/ocdbt.process_0/``; both read here and in
orbax), its nodes uncompressed and its zarr chunks as Zstandard frames of
raw blocks, so that a restore copies bytes. A store orbax compressed is
decoded by the port's own Zstandard decoder (``utils/zstd.py``), in
Python. Layouts the port does not read raise ``ValueError``: zarr v3, a
store without OCDBT, a tree other than this model's and optimizer's.

:class:`CheckpointManager` keeps orbax's contract: a save is copied to host
memory at the call and written by one background thread (a new save first
waits for the one before); a step is written into
``<step>.orbax-checkpoint-tmp-<ns>`` and renamed when complete, so a step a
killed writer left behind is never listed; after each commit the oldest
steps beyond ``max_to_keep`` are deleted.
"""
from __future__ import annotations

import base64
import json
import os
import shutil
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..convert import flatten_state, load_optax_state, optax_state
from ..utils import ocdbt, zarr2

ITEM = "default"
TMP_SUFFIX = ".orbax-checkpoint-tmp-"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
# a single-process JAX run's device, as orbax names it in ``_sharding``
SHARDING = json.dumps({"sharding_type": "SingleDeviceSharding",
                       "device_str": "TFRT_CPU_0"})


class CheckpointManager:
    """Steps of a train state under ``directory`` (orbax's
    ``CheckpointManager`` with ``enable_async_checkpointing=True``)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # one row per save: step, seconds of the background write, bytes
        # written
        self.saves: List[dict] = []

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        """The committed steps, ascending."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(os.path.join(
                          self.directory, n, CHECKPOINT_METADATA)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, leaves: List[Tuple[tuple, object]],
             on_commit: Optional[Callable[[], None]] = None) -> None:
        """Write host ``leaves`` (``host_leaves``) as ``step`` in the
        background; ``on_commit`` runs in the writer once the step is
        committed."""
        self.wait_until_finished()
        if os.path.exists(self.step_dir(step)):
            raise ValueError(f"step {step} already exists in "
                             f"{self.directory}")
        row = {"step": step}
        self.saves.append(row)
        self._thread = threading.Thread(
            target=self._write, args=(step, leaves, on_commit, row),
            name=f"orbax-save-{step}")
        self._thread.start()

    def _write(self, step, leaves, on_commit, row) -> None:
        try:
            t0, init_ns = time.perf_counter(), time.time_ns()
            tmp = os.path.join(self.directory,
                               f"{step}{TMP_SUFFIX}{init_ns}")
            row["bytes"] = write_item(os.path.join(tmp, ITEM), leaves)
            with open(os.path.join(tmp, CHECKPOINT_METADATA), "w") as f:
                json.dump({"item_handlers": {ITEM: HANDLER},
                           "metrics": {}, "performance_metrics": {},
                           "init_timestamp_nsecs": init_ns,
                           "commit_timestamp_nsecs": time.time_ns(),
                           "custom_metadata": {}}, f)
            os.rename(tmp, self.step_dir(step))
            if self.max_to_keep:
                for old in self.all_steps()[:-self.max_to_keep]:
                    shutil.rmtree(self.step_dir(old))
            if on_commit is not None:
                on_commit()
            row["write_s"] = time.perf_counter() - t0
        except Exception as e:     # re-raised by wait_until_finished
            self._error = e

    def wait_until_finished(self) -> None:
        """Block until the save in flight is committed; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"orbax save under {self.directory} "
                               "failed") from err

    def close(self) -> None:
        self.wait_until_finished()


def make_manager(directory: str, max_to_keep: int = 3) -> CheckpointManager:
    return CheckpointManager(directory, max_to_keep)


# =============================================================================
# Items: the tree in one step's ``default/``
# =============================================================================
def _name(path: tuple) -> str:
    return ".".join(k for k, _ in path)


def _value_metadata(leaf) -> dict:
    if leaf is None:
        return {"value_type": "None", "skip_deserialize": True}
    if isinstance(leaf, dict):
        return {"value_type": "Dict", "skip_deserialize": True}
    arr = leaf[0] if isinstance(leaf, tuple) else leaf
    return {"value_type": "jax.Array", "skip_deserialize": False,
            "write_shape": list(arr.shape)}


def tree_metadata(leaves: List[Tuple[tuple, object]]) -> dict:
    """``_METADATA``'s ``tree_metadata``: each leaf's key path and type
    (a leaf: a tensor, a ``host_leaves`` pair, None or an empty dict)."""
    return {str(tuple(k for k, _ in path)): {
        "key_metadata": [{"key": k, "key_type": t} for k, t in path],
        "value_metadata": _value_metadata(leaf)} for path, leaf in leaves}


def host_leaves(state) -> List[Tuple[tuple, object]]:
    """The train state's optax tree (``convert.optax_state``) copied to
    host memory: each array leaf a (numpy array, zarr dtype) pair whose
    memory the training no longer touches."""
    import torch
    out = []
    for path, leaf in flatten_state(optax_state(state.model, state.optimizer,
                                                state.step)):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().to("cpu", copy=True)
            dtype = zarr2.zarr_dtype(t)
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            leaf = (t.numpy().view(zarr2.DTYPES[dtype]), dtype)
        out.append((path, leaf))
    return out


def write_item(item_dir: str, leaves: List[Tuple[tuple, object]]) -> int:
    """Write ``leaves`` (``host_leaves``) as orbax's ``StandardSave`` item
    into the new directory ``item_dir``; returns the bytes written."""
    arrays = [(_name(p), leaf) for p, leaf in leaves
              if isinstance(leaf, tuple)]
    items = {}
    for name, (arr, dtype) in arrays:
        for key, value in zarr2.encode(arr, dtype).items():
            items[f"{name}/{key}"] = value
    ocdbt.write_store(item_dir, items)
    with open(os.path.join(item_dir, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_metadata(leaves), "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(item_dir, "_sharding"), "w") as f:
        json.dump({base64.b64encode(n.encode()).decode(): SHARDING
                   for n, _ in arrays}, f, separators=(",", ":"))
    os.makedirs(os.path.join(item_dir, "array_metadatas"))
    with open(os.path.join(item_dir, "array_metadatas", "process_0"),
              "w") as f:
        json.dump({"array_metadatas": [{"array_metadata": {
            "param_name": n, "write_shape": list(a.shape),
            "chunk_shape": list(a.shape), "ext_metadata": None}}
            for n, (a, _) in arrays]}, f)
    return sum(os.path.getsize(os.path.join(d, n))
               for d, _, names in os.walk(item_dir) for n in names)


def read_metadata(item_dir: str) -> dict:
    """``_METADATA``, its layout checked."""
    with open(os.path.join(item_dir, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{item_dir}: arrays stored as zarr v3 are not "
                         "supported (zarr v2 only)")
    if not meta.get("use_ocdbt"):
        raise ValueError(f"{item_dir}: a checkpoint without OCDBT (one "
                         "directory an array) is not supported")
    return meta


def read_arrays(item_dir: str, names: Optional[List[str]] = None
                ) -> Dict[str, Tuple[np.ndarray, str]]:
    """{dotted name: (array, zarr dtype)} of the arrays of one step's item
    (every array its ``_METADATA`` lists, or ``names``)."""
    if names is None:
        names = [".".join(k["key"] for k in v["key_metadata"])
                 for v in read_metadata(item_dir)["tree_metadata"].values()
                 if not v["value_metadata"]["skip_deserialize"]]
    store = ocdbt.Store(item_dir)
    out = {}
    for name in names:
        def chunk(key, name=name):
            k = f"{name}/{key}"
            return store.read(k) if k in store else None
        out[name] = zarr2.decode(store.read(f"{name}/{zarr2.ZARRAY}"),
                                 chunk, f"{item_dir}: {name}")
    return out


# =============================================================================
# The counterparts of JAX's save_state / restore_state
# =============================================================================
def save_state(manager: CheckpointManager, step: int, state,
               on_commit: Optional[Callable[[], None]] = None) -> None:
    """Async save of the train state's ``{params, batch_stats, opt_state,
    step}`` (the state is copied to host memory before this returns)."""
    manager.save(step, host_leaves(state), on_commit)


def restore_state(manager: CheckpointManager, state,
                  step: Optional[int] = None) -> Optional[int]:
    """Load ``step`` (default: the latest) into ``state``'s model and
    optimizer in place and set its step; returns the step, or None when
    there is none. The stored tree must be the one ``state`` saves: the
    same leaves, shapes and dtypes."""
    step = manager.latest_step() if step is None else step
    if step is None:
        return None
    item_dir = os.path.join(manager.step_dir(step), ITEM)
    stored = read_metadata(item_dir)["tree_metadata"]
    template = flatten_state(optax_state(state.model, state.optimizer,
                                         state.step))
    want = tree_metadata(template)
    diff = [k for k in sorted(set(want) | set(stored))
            if want.get(k, {}).get("value_metadata")
            != stored.get(k, {}).get("value_metadata")]
    if diff:
        raise ValueError(f"{item_dir} holds another tree than this model "
                         f"and optimizer save: {len(diff)} leaves differ, "
                         f"e.g. {diff[:3]}")
    expect = {_name(p): zarr2.zarr_dtype(leaf) for p, leaf in template
              if leaf is not None and not isinstance(leaf, dict)}
    arrays = {}
    for name, (arr, dtype) in read_arrays(item_dir, list(expect)).items():
        if dtype != expect[name]:
            raise ValueError(f"{item_dir}: {name} is stored as {dtype}, "
                             f"this state holds {expect[name]}")
        arrays[name] = arr
    state.step = load_optax_state(state.model, state.optimizer, arrays)
    return step
