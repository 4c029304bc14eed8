"""Serving's persistent warm-up cache (``--aot_dir``): the port's counterpart
of ``multimodal_edema_prediction_tpu/utils/aot.py``.

JAX keeps each shape bucket's compiled executable on disk, keyed by
``sha256(jax version, device kind, device count, program)``, so that a
restarted server loads it instead of compiling. On the card the two halves
of that executable part ways:

- the compiled program is the port's kernel libraries, which ``nvcc``
  builds from ``csrc/``: they are built into ``<aot_dir>/<key>/``
  (``ops/build.py::set_build_dir``) and a later process with the same
  directory loads them and runs no ``nvcc``;
- the executable bound to one bucket is a CUDA graph of the bucket's eval
  step (``serve/predictor.py``). A CUDA graph cannot be saved, so each
  process captures its graphs again at warm-up; the entry keeps a manifest
  of the buckets warmed at its key (shapes, dtypes, mode, replicas), and a
  bucket is a hit, as in JAX, when the manifest names it and this process
  built no kernel library.

The key is a sha256 over the torch and CUDA versions, the card's name and
compute capability, the card count, ``nvcc``'s flags and every library's
source digest (its source and the shared headers). On a host without a card
nothing is built, and the manifest alone decides.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional, Tuple

import torch

from ..ops import build

MANIFEST = "manifest.json"


def _device_facts() -> Tuple[str, str, int]:
    if not torch.cuda.is_available():
        return "cpu", "", 0
    major, minor = torch.cuda.get_device_capability(0)
    return (torch.cuda.get_device_name(0), f"{major}.{minor}",
            torch.cuda.device_count())


def cache_key() -> str:
    """The digest that names this host's entry in an ``aot_dir``."""
    name, capability, count = _device_facts()
    parts = [torch.__version__, str(torch.version.cuda), name, capability,
             str(count), " ".join(build.NVCC_FLAGS)]
    parts += [f"{lib}:{build.source_digest(lib)}"
              for lib in sorted(build.SOURCES)]
    return hashlib.sha256("\x00".join(parts).encode()).hexdigest()[:32]


def entry_dir(cache_dir: str) -> str:
    return os.path.join(os.path.abspath(cache_dir), cache_key())


class Manifest:
    """The buckets warmed at one key: a JSON list of bucket specs, rewritten
    atomically. Two servers warming one entry at once may each drop the
    other's new specs; a dropped spec reads as a miss at the next start."""

    def __init__(self, entry: str):
        self.path = os.path.join(entry, MANIFEST)

    def specs(self) -> list:
        try:
            with open(self.path) as f:
                return json.load(f)["buckets"]
        except (OSError, ValueError, KeyError):
            return []

    def has(self, spec: dict) -> bool:
        return spec in self.specs()

    def _write(self, specs: list) -> None:
        tmp = f"{self.path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"buckets": specs}, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)

    def add(self, spec: dict) -> None:
        specs = self.specs()
        if spec not in specs:
            self._write(specs + [spec])

    def clear(self) -> None:
        self._write([])


def load_or_build(cache_dir: str, force: bool = False
                  ) -> Tuple[Dict[str, str], bool]:
    """Point ``ops/build.py`` at ``cache_dir/<key>/`` and build there every
    kernel library that is missing → ({library: "built" or "found"}, hit):
    hit is True when this process built no library. ``force`` rebuilds and
    overwrites every library and empties the manifest, then makes the next
    launch load the new files (JAX's ``force``: an entry that failed at its
    first launch). Without a card nothing is built: ({}, not force)."""
    entry = entry_dir(cache_dir)
    os.makedirs(entry, exist_ok=True)
    build.set_build_dir(entry)
    if force:
        Manifest(entry).clear()
    if not torch.cuda.is_available():
        return {}, not force
    build.build_all(force=force)
    if force:
        build.reload()
    origins = build.origins()
    return origins, not force and "built" not in origins.values()


def bucket_hit(cache_dir: Optional[str], spec: dict) -> bool:
    """Whether a warmed bucket counts as loaded from ``cache_dir``: the
    manifest names it and this process built no kernel library."""
    if not cache_dir:
        return False
    return Manifest(entry_dir(cache_dir)).has(spec) and \
        "built" not in build.origins().values()
