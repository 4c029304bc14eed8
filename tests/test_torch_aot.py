"""Serving's ``--aot_dir`` in the port (ROADMAP P10b): the counterparts of
JAX's ``tests/test_serve.py`` aot tests, ``utils/aot.py``'s key and
manifest, and ``ops/build.py``'s build directory.

On the CPU no kernel library exists, so the bucket manifest alone decides a
hit: a first predictor on a fresh directory reports every bucket a miss and
writes the manifest, a second one on the same directory reports every
bucket a hit, at one replica and at two. The served fusion logits equal
JAX's direct eval of the same checkpoint at float32 within
``tests/test_torch_serve.py``'s tolerance (1e-4). An entry with a library
without a kernel image for the card (its first launch refused) is rebuilt
in warm-up: no exception, every bucket a miss, a manifest written anew,
finite answers. The CLI prints JAX's ``aot cache:`` line. ``ops/build.py`` is held with a fake
library and no ``nvcc``: a second directory after a load is refused, and a
library that ``ctypes`` cannot load is rebuilt once. The card's side
(graphs bit-equal to the eager step, a second process building nothing) is
``tests/test_torch_cuda.py``'s and ``chip_smoke.py``'s ``aot_serve``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.analysis.common import load_teacher
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.train import engine as JE
from multimodal_edema_prediction_tpu.train.checkpoint import save_checkpoint
from multimodal_edema_prediction_tpu.train.teacher_loop import init_teacher
from multimodal_edema_prediction_tpu_torch.ops import build
from multimodal_edema_prediction_tpu_torch.serve import BatchingPredictor
from multimodal_edema_prediction_tpu_torch.train.checkpoint import \
    load_teacher_from_ckpt
from multimodal_edema_prediction_tpu_torch.utils import aot
from torch_port_util import perturb, tiny_teacher_cfg, window_inputs

TOL = 1e-4      # tests/test_torch_serve.py: the whole-teacher float32 bound


@pytest.fixture(autouse=True)
def fresh_build_state(monkeypatch):
    """Each test starts with ``ops/build.py`` as a new process finds it."""
    for name, value in (("_dir", build.BUILD_DIR), ("_loaded_dir", None),
                        ("_libs", {}), ("_fns", {}), ("_origin", {}),
                        ("_opened", {})):
        monkeypatch.setattr(build, name, value)


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    """A JAX checkpoint of the tiny teacher, three requests and JAX's
    direct float32 fusion logits for them."""
    cfg = tiny_teacher_cfg()
    jmodel = JT(cfg)
    variables = init_teacher(jmodel, cfg, 2, cfg.duett.n_timesteps,
                             jax.random.key(0))
    path = str(tmp_path_factory.mktemp("ckpt") / "teacher.msgpack")
    save_checkpoint(path, perturb(variables["params"]),
                    perturb(variables["batch_stats"], 1), step=1, metric=0.5,
                    config={"model": cfg.to_dict()})
    jm, _, params, stats, _ = load_teacher(path)
    x_ts, static, bin_ends, pixel_u8 = window_inputs(cfg, 3, seed=7)
    want = JE.make_teacher_eval_from_windows(jm, jnp.float32)(
        params, stats, jnp.asarray(x_ts), jnp.asarray(static),
        {"bin_ends": jnp.asarray(bin_ends),
         "pixel_u8": jnp.asarray(pixel_u8)})["fusion_logits"]
    reqs = [{"x_ts": x_ts[i], "static": static[i], "bin_ends": bin_ends[i],
             "pixel_u8": pixel_u8[i]} for i in range(3)]
    S = cfg.vit.image_size
    example = {"x_ts": np.zeros_like(x_ts[0]),
               "static": np.zeros_like(static[0]),
               "pixel_u8": np.zeros((S, S, 3), np.uint8)}
    return path, reqs, np.asarray(want), example


def _predictor(path, aot_dir, replicas=1):
    model, _, _ = load_teacher_from_ckpt(path, device="cpu")
    return BatchingPredictor(model, max_batch=4, max_wait_ms=5.0,
                             dtype=torch.float32, device="cpu",
                             data_parallel=replicas,
                             aot_dir=aot_dir).start()


def _serve(pred, reqs) -> np.ndarray:
    return np.stack([np.asarray(pred.predict(r)["fusion_logits"])
                     for r in reqs])


@pytest.mark.parametrize("replicas", [1, 2])
def test_aot_dir_persists_and_reloads(teacher, tmp_path, replicas):
    """JAX ``test_aot_warmup_persists_and_reloads`` (one replica) and
    ``test_aot_warmup_mesh_mode`` (two): misses, then hits, the manifest
    naming every bucket, and JAX's answers both times."""
    path, reqs, want, example = teacher
    aot_dir = str(tmp_path / "aot")
    for expect in (False, True):
        pred = _predictor(path, aot_dir, replicas)
        try:
            pred.warmup(example)
            assert pred.buckets == ((1, 2, 4) if replicas == 1 else (2, 4))
            assert pred.aot_hits == {b: expect for b in pred.buckets}
            np.testing.assert_allclose(_serve(pred, reqs), want, rtol=TOL,
                                       atol=TOL)
        finally:
            pred.close()
        entry = aot.entry_dir(aot_dir)
        assert os.listdir(aot_dir) == [os.path.basename(entry)]
        with open(os.path.join(entry, aot.MANIFEST)) as f:
            specs = json.load(f)["buckets"]
        assert sorted(s["bucket"] for s in specs) == list(pred.buckets)
        for s in specs:
            assert s["replicas"] == replicas and s["mode"] == "pixel"
            assert s["dtype"] == "float32"
            assert s["inputs"]["pixel_u8"] == [
                [s["bucket"] // replicas, 28, 28, 3], "uint8"]
    # no kernel library on the CPU: nothing was built or loaded
    assert build.origins() == {}
    assert build.build_dir() == aot.entry_dir(aot_dir)


def test_stale_entry_is_rebuilt_in_warmup(teacher, tmp_path, monkeypatch):
    """JAX ``test_aot_stale_executable_falls_back_to_recompile``: an entry
    whose library fails once at a bucket's first launch (no kernel image
    for the card: ``StaleLibraryError``) is rebuilt with ``force=True``;
    warm-up does not raise, every bucket reports a miss, the manifest is
    written anew, and the answers are finite and JAX's. (A library that
    will not load at all is rebuilt by ``ops/build.py`` itself:
    ``test_build_rebuilds_a_library_that_will_not_load``.)"""
    path, reqs, want, example = teacher
    aot_dir = str(tmp_path / "aot")
    pred = _predictor(path, aot_dir)
    pred.warmup(example)
    pred.close()
    assert pred.aot_hits == {b: False for b in pred.buckets}   # cold
    calls = []
    real_load = aot.load_or_build

    def load_or_build(cache_dir, force=False):
        calls.append(force)
        return real_load(cache_dir, force=force)

    monkeypatch.setattr(aot, "load_or_build", load_or_build)
    pred = _predictor(path, aot_dir)
    step, failed = pred._steps[0], []

    def first_launch_fails(*args):
        if not failed:
            failed.append(True)
            raise build.launch_error("flash_fwd_bf16", 209)
        return step(*args)

    pred._steps[0] = first_launch_fails
    try:
        pred.warmup(example)
        assert calls == [False, True] and failed
        assert pred.aot_hits == {b: False for b in pred.buckets}
        got = _serve(pred, reqs)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    finally:
        pred.close()
    specs = aot.Manifest(aot.entry_dir(aot_dir)).specs()
    assert sorted(s["bucket"] for s in specs) == [1, 2, 4]
    # the rebuilt entry serves the next start as hits
    monkeypatch.setattr(aot, "load_or_build", real_load)
    pred = _predictor(path, aot_dir)
    try:
        pred.warmup(example)
        assert pred.aot_hits == {b: True for b in pred.buckets}
    finally:
        pred.close()


def test_launch_error_names_a_stale_image():
    """CUDA's two kernel-image errors raise ``StaleLibraryError`` (warm-up
    rebuilds on it); any other launch error a plain ``RuntimeError``."""
    for err in build.STALE_IMAGE_ERRORS:
        assert isinstance(build.launch_error("k", err),
                          build.StaleLibraryError)
    other = build.launch_error("k", 1)
    assert type(other) is RuntimeError and "CUDA error 1" in str(other)


_KEY_INPUTS = {
    "torch_version": lambda mp: mp.setattr(torch, "__version__", "0.0.0"),
    "cuda_version": lambda mp: mp.setattr(torch.version, "cuda", "0.0"),
    "device_name": lambda mp: mp.setattr(
        aot, "_device_facts", lambda: ("another card", "", 0)),
    "capability": lambda mp: mp.setattr(
        aot, "_device_facts", lambda: ("cpu", "9.0", 0)),
    "device_count": lambda mp: mp.setattr(
        aot, "_device_facts", lambda: ("cpu", "", 2)),
    "nvcc_flags": lambda mp: mp.setattr(
        build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",)),
    "a_source": lambda mp: mp.setattr(
        build, "source_digest",
        (lambda real: lambda n: real(n) + ("x" if n == "ln_qkv" else ""))(
            build.source_digest)),
}


@pytest.mark.parametrize("what", sorted(_KEY_INPUTS))
def test_cache_key_changes_with_each_input(what, monkeypatch):
    before = aot.cache_key()
    _KEY_INPUTS[what](monkeypatch)
    assert aot.cache_key() != before


def test_cache_key_changes_with_nothing_else(tmp_path, monkeypatch):
    """The directory, the working directory, the environment and the build
    directory leave the key as it is."""
    before = aot.cache_key()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    build.set_build_dir(str(tmp_path / "elsewhere"))
    assert aot.cache_key() == before
    assert aot.entry_dir(str(tmp_path / "a")) != aot.entry_dir(
        str(tmp_path / "b"))
    assert os.path.basename(aot.entry_dir(str(tmp_path / "a"))) == before


class _FakeLib:
    def __init__(self, path):
        self.path = path


def _fake_library(monkeypatch, directory, fail_first=False):
    """A fake ``ctypes`` opener and a fake ``nvcc`` run: ``build_all``
    writes a file per library, the opener returns a ``_FakeLib`` (failing
    its first call with ``fail_first``). → the opened paths, the built
    names."""
    opened, built = [], []

    def open_(path):
        opened.append(path)
        if fail_first and len(opened) == 1:
            raise OSError(f"{path}: invalid ELF header")
        return _FakeLib(path)

    def build_all(force=False, names=None):
        os.makedirs(build.build_dir(), exist_ok=True)
        done = {}
        for n in names or build.SOURCES:
            out = build._lib_path(n)
            if os.path.exists(out) and not force:
                continue
            with open(f"{out}.tmp", "w") as f:
                f.write("built")
            os.replace(f"{out}.tmp", out)
            build._origin[n] = "built"
            built.append(n)
            done[n] = 0.0
        return done

    monkeypatch.setattr(build.ctypes, "CDLL", open_)
    monkeypatch.setattr(build, "build_all", build_all)
    build.set_build_dir(str(directory))
    return opened, built


def test_build_refuses_a_second_directory_after_a_load(tmp_path,
                                                       monkeypatch):
    opened, built = _fake_library(monkeypatch, tmp_path / "a")
    build.set_build_dir(str(tmp_path / "b"))      # nothing loaded yet
    build.set_build_dir(str(tmp_path / "a"))
    lib = build.load("gather_rows")
    assert isinstance(lib, _FakeLib) and built == list(build.SOURCES)
    assert os.path.dirname(lib.path) == str(tmp_path / "a")
    assert build.origins()["gather_rows"] == "built"
    with pytest.raises(RuntimeError, match="loaded from"):
        build.set_build_dir(str(tmp_path / "b"))
    build.set_build_dir(str(tmp_path / "a"))      # the same one is fine
    # a reload keeps the directory: no second copy of a kernel
    build.reload()
    with pytest.raises(RuntimeError, match="loaded from"):
        build.set_build_dir(None)
    again = build.load("gather_rows")
    assert again is not lib and again.path.endswith(".r1.so")
    assert built == list(build.SOURCES)           # no nvcc run for it


def test_build_rebuilds_a_library_that_will_not_load(tmp_path, monkeypatch):
    """A library found in the directory that ``ctypes`` refuses is rebuilt
    once, replacing its file, and then loaded; its origin is "built"."""
    d = tmp_path / "a"
    d.mkdir()
    build.set_build_dir(str(d))
    stale = build._lib_path("gather_rows")
    with open(stale, "w") as f:
        f.write("trunc")
    opened, built = _fake_library(monkeypatch, d, fail_first=True)
    lib = build.load("gather_rows")
    assert built == ["gather_rows"] and opened == [stale, stale]
    with open(stale) as f:
        assert f.read() == "built"
    assert lib.path == stale and build.origins() == {"gather_rows": "built"}
    # a found library that loads is "found"
    build.load("ln_qkv")
    assert build.origins()["ln_qkv"] == "built"    # built by build_all
    with open(build._lib_path("dual_axis_block"), "w") as f:
        f.write("ok")
    monkeypatch.setattr(build, "_origin", {})
    build.load("dual_axis_block")
    assert build.origins() == {"dual_axis_block": "found"}


def test_serve_cli_reports_aot_hits(teacher, tmp_path, monkeypatch, capsys):
    """``cli.serve --aot_dir DIR`` twice on one directory (the server
    stopped as soon as it would serve): JAX's line, ``aot cache: 0/3``
    and then ``3/3 buckets loaded from DIR``, after the warm-up."""
    from multimodal_edema_prediction_tpu_torch import serve as serve_pkg
    from multimodal_edema_prediction_tpu_torch.cli import serve as cli_serve
    path = teacher[0]

    def stop(server):
        raise KeyboardInterrupt

    monkeypatch.setattr(serve_pkg, "serve_forever", stop)
    aot_dir = str(tmp_path / "aot")
    for hits in (0, 3):
        cli_serve.main(["--ckpt", path, "--device", "cpu", "--port", "0",
                        "--max_batch", "4", "--aot_dir", aot_dir])
        out = capsys.readouterr().out
        assert f"aot cache: {hits}/3 buckets loaded from {aot_dir}" in out
        assert out.index("warm:") < out.index("aot cache:") \
            < out.index("serving on")
