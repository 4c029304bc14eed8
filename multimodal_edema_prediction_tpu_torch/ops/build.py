"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C entry point, loaded with ``ctypes``. Libraries go to
``build/torch_kernels/`` at the repo root (listed in ``.gitignore``), keyed by
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so a
checkout builds them at first use and reuses them afterwards. Nothing here
runs at import time: this module imports on a machine without ``nvcc`` or a
card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the kernels of the port: library name -> source file under csrc/
SOURCES = {"flash_attention": "flash_attention.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu",
           "gather_rows": "gather_rows.cu",
           "dual_axis_block": "dual_axis_block.cu",
           "ln_qkv": "ln_qkv.cu"}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit (set CUDA_HOME)")
    return cand


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [SOURCES[name]] + sorted(
            f for f in os.listdir(CSRC) if f.endswith(".cuh")):
        with open(os.path.join(CSRC, src), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_all() -> Dict[str, float]:
    """Compile every kernel that is not built yet, one ``nvcc`` per source,
    all started together. Returns the wall seconds per library built now;
    ``ptxas`` register and spill reports go to ``<lib>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.time()
    for name, src in SOURCES.items():
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        log = open(out + ".log", "w")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)],
            stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
    done = {}
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            with open(out + ".log") as f:
                raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                                   f"(rc {rc}):\n{f.read()}")
        os.replace(tmp, out)
        done[name] = time.time() - t0
    return done


def build_log(name: str) -> str:
    with open(_lib_path(name) + ".log") as f:
        return f.read()


def ptxas_usage(log: str) -> Dict[str, dict]:
    """Per entry function of a ``ptxas -v`` log (``build_log``): registers,
    spill stores and loads (bytes) and static shared memory (bytes)."""
    out: Dict[str, dict] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {
                "registers": None, "spill_stores": 0, "spill_loads": 0,
                "smem_bytes": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def _cuobjdump() -> Optional[str]:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    return cand if os.path.exists(cand) else None


def sass(name: str) -> Optional[str]:
    """The SASS of library ``name`` (built first if needed), from
    ``cuobjdump --dump-sass``; None where the toolkit has no cuobjdump."""
    tool = _cuobjdump()
    if tool is None:
        return None
    load(name)
    return subprocess.run([tool, "--dump-sass", _lib_path(name)],
                          capture_output=True, text=True, check=True).stdout


def sass_opcode_counts(listing: str, opcode: str) -> Dict[str, int]:
    """Per function of a ``cuobjdump --dump-sass`` listing, the number of
    instructions whose opcode is ``opcode`` (any predicate or suffix)."""
    ins = re.compile(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P[0-9T]\s+)?"
                     + re.escape(opcode) + r"[.\s]")
    out: Dict[str, int] = {}
    cur = None
    for line in listing.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = 0
        elif cur is not None and ins.search(line):
            out[cur] += 1
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not os.path.exists(_lib_path(name)):
                build_all()
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib
