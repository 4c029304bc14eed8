"""Checkpoints in the JAX package's format, read and written without JAX,
flax or ``msgpack``.

``save_checkpoint`` there (``train/checkpoint.py:30-44``) writes
``flax.serialization.msgpack_serialize({"params", "batch_stats", "step",
"metric", "extra"})`` plus a ``<path>.config.json`` sidecar. ``_unpack``
decodes the msgpack subset that writer emits: maps, arrays (lists), str,
bin, ints, floats, nil/bools, and ext type 1 (an ndarray packed as
``(shape, dtype name, C-order bytes)``) or 3 (a numpy scalar, the same
encoding). ``_pack`` writes the same subset, each map's keys sorted at
every level as flax's writer sorts them (it maps the tree through
``jax.tree_util`` first), so a checkpoint the port saves (its weights in
the flax layout, ``convert.to_flax``) is byte for byte the file the JAX
package's ``save_checkpoint`` writes for the same tree, and loads in its
``load_checkpoint`` and in the port's own loaders.

Full-state resume (the teacher, SSL and KD loops'; JAX
``checkpoint.py:100-221``): ``save_train_state`` writes the weights in the
flax layout, the AdamW moments in parameter order and the step count to one
msgpack file in the port's own layout; the ``orbax`` backend writes the
same state as JAX's optax tree, one orbax step an epoch under
``orbax_state/`` (``train/orbax_io.py``), asynchronously.
``FullStateResumer`` adds a JSON sidecar with the loop's bookkeeping and
the ``torch.Generator`` state, so a restarted run continues bit for bit. A
run directory the JAX package wrote has the same file names but a JAX key
in its sidecar; the resumer refuses it before it loads anything.
"""
from __future__ import annotations

import base64
import json
import os
import struct
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..config import StudentConfig, TeacherConfig


def _unpack(buf: bytes, pos: int = 0) -> Tuple[object, int]:
    """Decode one msgpack object at ``pos``; returns (value, next pos)."""
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _unpack_map(buf, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _unpack_list(buf, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return bytes(buf[pos:pos + n]).decode(), pos + n
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
             0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in fixed:
        fmt = fixed[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)
    sized = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
             0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
             0xDC: ("list", ">H"), 0xDD: ("list", ">I"),
             0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
             0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}
    if b in sized:
        kind, fmt = sized[b]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
        if kind == "bin":
            return bytes(buf[pos:pos + n]), pos + n
        if kind == "str":
            return bytes(buf[pos:pos + n]).decode(), pos + n
        if kind == "list":
            return _unpack_list(buf, pos, n)
        if kind == "map":
            return _unpack_map(buf, pos, n)
        code = struct.unpack_from(">b", buf, pos)[0]
        return _ext(code, buf[pos + 1:pos + 1 + n]), pos + 1 + n
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in fixext:
        n = fixext[b]
        code = struct.unpack_from(">b", buf, pos)[0]
        return _ext(code, buf[pos + 1:pos + 1 + n]), pos + 1 + n
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x} at {pos - 1}")


def _unpack_list(buf, pos, n):
    out = []
    for _ in range(n):
        v, pos = _unpack(buf, pos)
        out.append(v)
    return out, pos


def _unpack_map(buf, pos, n):
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        out[k] = v
    if "__msgpack_chunked_array__" in out:
        raise ValueError("chunked arrays (over 1 GiB) are not supported")
    return out, pos


def _ext(code: int, data: bytes):
    if code not in (1, 3):
        raise ValueError(f"unsupported msgpack ext type {code}")
    (shape, dtype, raw), end = _unpack(data, 0)
    if end != len(data):
        raise ValueError("trailing bytes in an ndarray ext payload")
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
    return arr if code == 1 else arr[()]


def msgpack_restore(data: bytes):
    """The counterpart of ``flax.serialization.msgpack_restore``."""
    value, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"trailing bytes after msgpack object at {end}")
    return value


def _pack_len(out: List[bytes], n: int, fix: Optional[int], fix_max: int,
              codes: Tuple[int, int, int]) -> None:
    """A length header: the fix form when ``n <= fix_max``, else the 8-,
    16- or 32-bit form."""
    if fix is not None and n <= fix_max:
        out.append(bytes([fix | n]))
    elif n < 2 ** 8 and codes[0]:
        out.append(struct.pack(">BB", codes[0], n))
    elif n < 2 ** 16:
        out.append(struct.pack(">BH", codes[1], n))
    elif n < 2 ** 32:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"msgpack object of length {n} is too long")


def _pack_ext(out: List[bytes], code: int, data: bytes) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixext:
        out.append(bytes([fixext[len(data)]]))
    else:
        _pack_len(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out.append(struct.pack(">b", code))
    out.append(data)


# (code, struct format) of msgpack's unsigned and signed int forms, by width
_UINTS = ((0xCC, "B"), (0xCD, "H"), (0xCE, "I"), (0xCF, "Q"))
_INTS = ((0xD0, "b"), (0xD1, "h"), (0xD2, "i"), (0xD3, "q"))


def _pack(obj, out: List[bytes]) -> None:
    """Append the msgpack encoding of ``obj`` (the subset ``_unpack``
    reads) to ``out``."""
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        # the smallest form, as msgpack packs an int
        if 0 <= obj < 128 or -32 <= obj < 0:
            out.append(struct.pack(">b", obj) if obj < 0 else bytes([obj]))
        elif obj >= 0:
            code, fmt = next(c for c in _UINTS
                             if obj < 2 ** (8 * struct.calcsize(c[1])))
            out.append(struct.pack(f">B{fmt}", code, obj))
        else:
            code, fmt = next(c for c in _INTS
                             if obj >= -2 ** (8 * struct.calcsize(c[1]) - 1))
            out.append(struct.pack(f">B{fmt}", code, obj))
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        raw = obj.encode()
        _pack_len(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out.append(raw)
    elif isinstance(obj, bytes):
        _pack_len(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(obj)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.nbytes > 2 ** 30:
            raise ValueError("arrays over 1 GiB are written chunked by flax; "
                             "not supported")
        payload: List[bytes] = []
        _pack([list(arr.shape), arr.dtype.name,
               np.ascontiguousarray(arr).tobytes()], payload)
        _pack_ext(out, 1 if isinstance(obj, np.ndarray) else 3,
                  b"".join(payload))
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (0, 0xDE, 0xDF))
        for k, v in sorted(((str(k), v) for k, v in obj.items()),
                           key=lambda kv: kv[0]):
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (0, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack a {type(obj).__name__}")


def msgpack_serialize(tree) -> bytes:
    """The counterpart of ``flax.serialization.msgpack_serialize`` for
    trees of dicts, lists, numbers, strings and numpy arrays: the same
    bytes, map keys sorted."""
    out: List[bytes] = []
    _pack(tree, out)
    return b"".join(out)


def save_checkpoint(path: str, model, step: int, metric: float,
                    config: Optional[dict] = None,
                    extra: Optional[dict] = None) -> None:
    """Write ``model``'s weights in the JAX package's checkpoint format
    (flax layout, ``convert.to_flax``) plus the ``.config.json`` sidecar."""
    from ..convert import to_flax
    params, batch_stats = to_flax(model)
    save_flax_checkpoint(path, params, batch_stats, step, metric, config,
                         extra)


def save_flax_checkpoint(path: str, params: dict,
                         batch_stats: Optional[dict], step: int,
                         metric: float, config: Optional[dict] = None,
                         extra: Optional[dict] = None) -> None:
    """The JAX package's ``save_checkpoint`` (``train/checkpoint.py:30-44``)
    on flax trees of numpy arrays: ``batch_stats`` may be None, as the
    RAD-DINO converter writes it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"params": params, "batch_stats": batch_stats,
               "step": int(step), "metric": float(metric),
               "extra": extra or {}}
    with open(path, "wb") as f:
        f.write(msgpack_serialize(payload))
    if config is not None:
        with open(path + ".config.json", "w") as f:
            json.dump(config, f, indent=2, default=str)


class BestKTracker:
    """Keep the k best checkpoints by a metric (higher- or lower-is-better):
    the JAX package's tracker, saving a torch model."""

    def __init__(self, ckpt_dir: str, k: int = 1, mode: str = "max",
                 prefix: str = "ckpt"):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.ckpt_dir = ckpt_dir
        self.k = k
        self.mode = mode
        self.prefix = prefix
        self.entries: List[Tuple[float, str]] = []  # (metric, path)

    def _better(self, a: float, b: float) -> bool:
        return a > b if self.mode == "max" else a < b

    @property
    def best(self) -> Optional[Tuple[float, str]]:
        return self.entries[0] if self.entries else None

    def offer(self, metric: float, model, step: int,
              config: Optional[dict] = None) -> bool:
        """Save if within top-k. Returns True if this is the new best."""
        if len(self.entries) >= self.k and not self._better(
                metric, self.entries[-1][0]):
            return False
        path = os.path.join(self.ckpt_dir,
                            f"{self.prefix}-step{step}-{metric:.4f}.msgpack")
        save_checkpoint(path, model, step, metric, config)
        self.entries.append((metric, path))
        self.entries.sort(key=lambda e: e[0], reverse=(self.mode == "max"))
        while len(self.entries) > self.k:
            _, drop = self.entries.pop()
            for p in (drop, drop + ".config.json"):
                if os.path.exists(p):
                    os.remove(p)
        return self.entries[0][1] == path

    def averaged_params(self, dtype=None) -> dict:
        """The kept checkpoints' parameters averaged (``average_params``):
        float64 leaves, or ``dtype``."""
        return average_params([load_checkpoint(p)["params"]
                               for _, p in self.entries], dtype)

    def ensure_saved(self, model, step: int,
                     config: Optional[dict] = None) -> None:
        """Guarantee at least one checkpoint exists (e.g. every epoch's
        metric was NaN): save the final state with a sentinel metric."""
        if not self.entries:
            sentinel = float("-inf") if self.mode == "max" else float("inf")
            path = os.path.join(self.ckpt_dir,
                                f"{self.prefix}-step{step}-final.msgpack")
            save_checkpoint(path, model, step, sentinel, config)
            self.entries.append((sentinel, path))


def average_params(param_trees: Sequence[dict], dtype=None) -> dict:
    """Top-k weight averaging (reference train_duett_finetune.py:56-62, JAX
    ``checkpoint.py:93-97``): each leaf summed over the trees in float64, in
    their order, and divided by their count; float64 leaves, as JAX returns
    them, or cast to ``dtype`` after the division."""
    n = float(len(param_trees))

    def walk(trees):
        first = trees[0]
        if isinstance(first, dict):
            return {k: walk([t[k] for t in trees]) for k in first}
        avg = sum(np.asarray(t).astype(np.float64) for t in trees) / n
        return avg if dtype is None else avg.astype(dtype)

    return walk(list(param_trees))


def load_checkpoint(path: str) -> dict:
    """{"params", "batch_stats", "step", "metric", "extra"[, "config"]}
    with numpy leaves; ``config`` is the JSON sidecar when present."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    cfg_path = path + ".config.json"
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            payload["config"] = json.load(f)
    return payload


def load_teacher_from_ckpt(path: str, device="cuda"):
    """Rebuild the teacher from a checkpoint of either package and its
    config sidecar (the counterpart of ``train/kd_loop.py::
    load_teacher_from_ckpt``): (model in eval mode on ``device``,
    TeacherConfig, raw checkpoint). A ``dual`` teacher's head width and
    label index ride the sidecar (JAX ``kd_loop.py:35-49``)."""
    from ..convert import load_flax
    from ..models.teacher import TeacherModel
    from ..utils import resolve_device

    dev = resolve_device(device)
    ckpt = load_checkpoint(path)
    if "config" not in ckpt:
        raise ValueError(f"{path} has no config sidecar")
    tcfg = TeacherConfig.from_dict(ckpt["config"]["model"])
    keep = ckpt["config"].get("static_keep_idx")
    model = TeacherModel(
        tcfg, int(ckpt["config"].get("n_pretrained_labels", 7)),
        static_keep_idx=None if keep is None else tuple(keep))
    model = load_flax(model, ckpt["params"], ckpt["batch_stats"])
    return model.to(dev).eval(), tcfg, ckpt


def load_student_from_ckpt(path: str, device="cuda"):
    """Rebuild the student from a checkpoint of either package's KD loop and
    its config sidecar: (model in eval mode on ``device``, StudentConfig,
    raw checkpoint)."""
    from ..convert import load_flax
    from ..models.student import StudentModel
    from ..utils import resolve_device

    dev = resolve_device(device)
    ckpt = load_checkpoint(path)
    if "config" not in ckpt:
        raise ValueError(f"{path} has no config sidecar")
    scfg = StudentConfig.from_dict(ckpt["config"]["model"])
    model = load_flax(StudentModel(scfg), ckpt["params"],
                      ckpt["batch_stats"])
    return model.to(dev).eval(), scfg, ckpt


def restore_tolerant(template: dict, loaded: dict,
                     skip_prefixes: Sequence[str] = ("head",)
                     ) -> Tuple[dict, list]:
    """Load the numpy tree ``loaded`` into the tree ``template``: missing
    leaves keep the template's, a leaf of another shape under
    ``skip_prefixes`` is skipped, any other shape mismatch raises (JAX
    ``checkpoint.py:57-90``, reference duett.py:459-487). Returns (tree,
    the list of ``missing:``/``shape-skip:`` paths)."""
    changed = []

    def walk(tmpl, lo, prefix):
        out = {}
        for k, tv in tmpl.items():
            path = f"{prefix}/{k}" if prefix else k
            lv = lo.get(k) if isinstance(lo, dict) else None
            if isinstance(tv, dict):
                out[k] = walk(tv, lv if isinstance(lv, dict) else {}, path)
            elif lv is None:
                changed.append(f"missing:{path}")
                out[k] = tv
            elif np.shape(lv) != np.shape(tv):
                if not any(path.startswith(p) or f"/{p}" in path
                           for p in skip_prefixes):
                    raise ValueError(f"shape mismatch at {path}: "
                                     f"{np.shape(lv)} vs {np.shape(tv)}")
                changed.append(f"shape-skip:{path}")
                out[k] = tv
            else:
                out[k] = np.asarray(lv, dtype=np.asarray(tv).dtype)
        return out

    return walk(template, loaded, ""), changed


def save_train_state(path: str, state, epoch: int,
                     extra: Optional[dict] = None) -> None:
    """The full train state (weights, BatchNorm statistics, AdamW moments,
    step count) of a ``TrainState`` whose optimizer has ``state_dict``."""
    from ..convert import to_flax
    params, batch_stats = to_flax(state.model)
    payload = {"step": int(state.step), "epoch": int(epoch),
               "params": params, "batch_stats": batch_stats,
               "opt_state": state.optimizer.state_dict(),
               "extra": extra or {}}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".tmp", "wb") as f:
        f.write(msgpack_serialize(payload))
    os.replace(path + ".tmp", path)


def load_train_state(path: str, state) -> Tuple[int, dict]:
    """Restore ``save_train_state``'s file into ``state`` in place (the
    model keeps its device); returns (epoch, extra)."""
    from ..convert import load_flax
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    load_flax(state.model, payload["params"], payload["batch_stats"])
    state.optimizer.load_state_dict(payload["opt_state"])
    state.step = int(payload["step"])
    return int(payload["epoch"]), payload.get("extra", {})


class FullStateResumer:
    """Epoch-boundary full-state saves and their restore for a training
    loop (JAX ``checkpoint.py:136-221``): the train state, as one msgpack
    file (``save_train_state``) or as orbax steps under ``orbax_state/``
    (``train/orbax_io.py``: async, the last two kept), plus a JSON sidecar
    with the early-stop watermark, the best-checkpoint tracker's entries,
    the history, the step count and the ``torch.Generator`` state. With
    orbax the sidecar is written when its step is committed, so the two
    never disagree; ``finish`` waits for the save in flight."""

    def __init__(self, ckpt_dir: str, backend: str = "msgpack"):
        if backend not in ("msgpack", "orbax"):
            raise ValueError(f"unknown state_backend {backend!r}")
        self.ckpt_dir = ckpt_dir
        self.backend = backend
        self.state_path = os.path.join(ckpt_dir, "train_state.msgpack")
        self.meta_path = os.path.join(ckpt_dir, "train_state.meta.json")
        self.orbax_dir = os.path.join(ckpt_dir, "orbax_state")
        self._mgr = None

    @property
    def manager(self):
        """The orbax manager, made at its first use (JAX ``_mgr``)."""
        if self._mgr is None:
            from .orbax_io import make_manager
            self._mgr = make_manager(self.orbax_dir, max_to_keep=2)
        return self._mgr

    def restore(self, state) -> Optional[dict]:
        """Load the saved state into ``state``; → its meta, or None when
        there is nothing to resume (no sidecar). A sidecar without this
        backend's state raises, naming what the directory holds."""
        if not os.path.exists(self.meta_path):
            return None
        with open(self.meta_path) as f:
            meta = json.load(f)
        if not isinstance(meta.get("rng"), str):
            # the JAX package keeps its step key as a list of uint32 and
            # its optimizer state as an optax tree
            raise ValueError(
                f"{self.ckpt_dir} holds a train state written by the JAX "
                "package (multimodal_edema_prediction_tpu: a JAX key and an "
                "optax tree), which this package cannot resume; start a new "
                "run from its best checkpoint instead")
        epoch = int(meta["epoch"])
        if self.backend == "orbax":
            if not (os.path.isdir(self.orbax_dir)
                    and epoch in self.manager.all_steps()):
                raise ValueError(self._missing_state(epoch))
            from .orbax_io import restore_state
            restore_state(self.manager, state, epoch)
            return meta
        if not os.path.exists(self.state_path):
            raise ValueError(self._missing_state(epoch))
        load_train_state(self.state_path, state)
        return meta

    def _missing_state(self, epoch: int) -> str:
        held = [n for n, there in (
            ("orbax_state/ (--state_backend orbax)",
             os.path.isdir(self.orbax_dir)),
            ("train_state.msgpack (--state_backend msgpack)",
             os.path.exists(self.state_path))) if there]
        return (f"{self.ckpt_dir}: its train_state.meta.json names epoch "
                f"{epoch}, but the {self.backend} state of that epoch is "
                f"not there; the directory holds "
                f"{' and '.join(held) or 'no train state'}")

    @staticmethod
    def apply_meta(meta: dict, stopper, tracker, gen) -> Tuple[int, list,
                                                                 int]:
        """Restore the loop's bookkeeping and ``gen``'s state; → (start
        epoch, history, n_steps)."""
        import torch
        stopper.best = meta["stopper_best"]
        stopper.bad_epochs = int(meta["bad_epochs"])
        tracker.entries = [(m, p) for m, p in meta["tracker"]
                           if os.path.exists(p)]
        gen.set_state(torch.frombuffer(
            bytearray(base64.b64decode(meta["rng"])), dtype=torch.uint8))
        return int(meta["epoch"]) + 1, list(meta["history"]), \
            int(meta["n_steps"])

    def _write_meta(self, text: str) -> None:
        with open(self.meta_path + ".tmp", "w") as f:
            f.write(text)
        os.replace(self.meta_path + ".tmp", self.meta_path)

    def save(self, state, epoch: int, stopper, tracker, history: list,
             n_steps: int, gen) -> None:
        """Call on every process; only the main one writes (JAX
        ``checkpoint.py:195-216``, msgpack backend): the ranks hold the
        same state, and a shared directory takes one writer."""
        from ..parallel.multihost import is_main_process
        if not is_main_process():
            return
        meta: Any = {"epoch": epoch, "stopper_best": stopper.best,
                     "bad_epochs": stopper.bad_epochs,
                     "tracker": tracker.entries, "history": history,
                     "n_steps": n_steps,
                     "rng": base64.b64encode(gen.get_state().numpy()
                                             .tobytes()).decode()}
        text = json.dumps(meta)
        if self.backend == "orbax":
            from .orbax_io import save_state
            save_state(self.manager, epoch, state,
                       on_commit=lambda: self._write_meta(text))
            return
        save_train_state(self.state_path, state, epoch)
        self._write_meta(text)

    def finish(self) -> None:
        """Wait for the orbax save in flight to commit (a no-op for
        msgpack, and when no manager was made)."""
        if self._mgr is not None:
            self._mgr.wait_until_finished()

    def state_bytes(self) -> int:
        """The bytes of the last state written (0 when none was)."""
        if self.backend == "orbax":
            rows = self._mgr.saves if self._mgr is not None else []
            return rows[-1].get("bytes", 0) if rows else 0
        return os.path.getsize(self.state_path) \
            if os.path.exists(self.state_path) else 0

    def write_seconds(self) -> list:
        """Each orbax save's background write, in seconds (None while in
        flight); empty for msgpack, whose save the loop times whole."""
        rows = self._mgr.saves if self._mgr is not None else []
        return [r.get("write_s") for r in rows]
