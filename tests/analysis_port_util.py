"""Shared fixtures of the analysis suite's port tests
(tests/test_torch_analysis*.py, test_torch_grad_flow.py and the P19b
files): tiny teacher checkpoints written by the JAX package, the flags
both packages' scripts take, a recursive comparison of two reports, and
the module fixture ``_one_thread`` the P19b files import."""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.config import TeacherConfig
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.train import engine as JE
from multimodal_edema_prediction_tpu.train import teacher_loop as JTL
from multimodal_edema_prediction_tpu.train.checkpoint import save_checkpoint
from torch_port_util import perturb, tiny_teacher_cfg

STAYS = "60"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread and one BLAS thread: the suite runs several test
    processes on the host's cores at once, and the probes' many small
    numpy products slow down by an order of magnitude when each process's
    BLAS spins a thread per core."""
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def write_teacher(path: str, freeze_cxr: bool = True,
                  mode: str = "dual_patch") -> str:
    """The tiny teacher (``tiny_teacher_cfg``) of ``mode``, initialized and
    perturbed by the JAX package and saved in its format at ``path``."""
    cfg = tiny_teacher_cfg()
    cfg = TeacherConfig.from_dict({**cfg.to_dict(), "freeze_cxr": freeze_cxr,
                                   "perceiver_type": mode})
    variables = JTL.init_teacher(JT(cfg), cfg, 2, cfg.duett.n_timesteps,
                                 jax.random.key(0))
    save_checkpoint(path, perturb(variables["params"]),
                    perturb(variables["batch_stats"], 1), step=1, metric=0.5,
                    config={"model": cfg.to_dict()})
    return path


def flags(ckpt, out_dir, extra=()) -> list:
    return (["--ckpt", ckpt] if ckpt else []) + [
        "--synthetic_stays", STAYS, "--n_variables", "6",
        "--batch_size", "16", "--out_dir", str(out_dir), "--n_boot", "20",
    ] + list(extra)


def jax_at_float32(monkeypatch) -> None:
    """The JAX package's eval-step factories at float32 (their default is
    bf16), patched from the test: nothing in the package changes."""
    for name in ("make_teacher_eval", "make_teacher_eval_from_windows"):
        monkeypatch.setattr(JE, name, functools.partial(
            getattr(JE, name), dtype=jnp.float32))


def assert_report_close(got, want, tol: float = 1e-4, path: str = ""):
    """Two reports (nested dicts and lists): the same keys and lengths,
    strings, booleans and integers equal, floats both NaN or within
    ``tol`` of max(1, |want|)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, sorted(set(got) ^ set(want)))
        for k in want:
            assert_report_close(got[k], want[k], tol, f"{path}/{k}")
    elif isinstance(want, (list, tuple, np.ndarray)) and not isinstance(
            want, str):
        want = list(np.asarray(want).tolist()) \
            if isinstance(want, np.ndarray) else list(want)
        got = list(np.asarray(got).tolist()) \
            if isinstance(got, np.ndarray) else list(got)
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_report_close(g, w, tol, f"{path}[{i}]")
    elif isinstance(want, (bool, str, np.bool_)) or want is None:
        assert got == want, (path, got, want)
    elif isinstance(want, (int, np.integer)) and not isinstance(
            got, (float, np.floating)):
        assert int(got) == int(want), (path, got, want)
    else:
        w, g = float(want), float(got)
        if math.isnan(w):
            assert math.isnan(g), (path, g, w)
        else:
            assert abs(g - w) <= tol * max(1.0, abs(w)), (path, g, w)
