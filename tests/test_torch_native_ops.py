"""The port's host data-path ops (``data/native_loader.py``:
``densify_events_native``, ``gather_windows_native`` over
``csrc/host/data_ops.cpp``) against the JAX package's native ops
(``native/mmedema_native.cpp``, built here by its own ``make``) and against
the port's main path (``data/pipeline.py``: ``densify_events`` in numpy,
``gather_windows`` in torch), on ``make_synthetic`` data as
``tests/test_native.py`` builds it.

Tolerances: the grid within rtol 1e-6 (atol 1e-6, ``tests/test_native.py``'s
bounds) of numpy's and bit-equal to JAX's C++; the windows bit-equal; 1 and
4 threads bit-equal.
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.data import native_loader as JNL
from multimodal_edema_prediction_tpu_torch.config import DataConfig
from multimodal_edema_prediction_tpu_torch.data import native_loader as NL
from multimodal_edema_prediction_tpu_torch.data import pipeline as P
from multimodal_edema_prediction_tpu_torch.data import synthetic as S


@pytest.fixture(scope="module")
def jax_native():
    """JAX's native library (built by its ``make`` at first use), decided
    here rather than at import: where it does not build, its comparisons
    skip."""
    if JNL.load_native() is None:
        pytest.skip("JAX's native library unavailable")


@pytest.fixture(scope="module")
def data():
    ds = S.make_synthetic(seed=0, n_subjects=30, n_stays=50, n_variables=8,
                          min_len=26, max_len=40)
    meta = P.meta_from_events(ds, DataConfig())
    return ds, meta


def _densify(ev, meta, L, clip=15, threads=4):
    return NL.densify_events_native(ev.offsets, ev.slot_idx, ev.values,
                                    ev.counts, meta.means, meta.stds, L,
                                    count_clip=clip, n_threads=threads)


def _windows(grid, n=16, T=24, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, grid.shape[0], n).astype(np.int32)
    ends = rng.integers(T, grid.shape[1] + 1, n).astype(np.int32)
    return rows, ends


def test_densify_matches_jax_native_and_numpy(data, jax_native):
    ds, meta = data
    ev, L = ds.events, int(ds.events.stay_len.max())
    got = _densify(ev, meta, L)
    want = JNL.densify_events_native(ev.offsets, ev.slot_idx, ev.values,
                                     ev.counts, meta.means, meta.stds, L)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, P.densify_events(ev, meta, L),
                               rtol=1e-6, atol=1e-6)


def test_gather_matches_jax_native_and_the_torch_path(data, jax_native):
    ds, meta = data
    L = int(ds.events.stay_len.max())
    grid = P.densify_events(ds.events, meta, L)
    rows, ends = _windows(grid)
    got = NL.gather_windows_native(grid, rows, ends, 24)
    want = JNL.gather_windows_native(grid, rows, ends, 24)
    assert got.tobytes() == want.tobytes()
    on_torch = P.gather_windows(torch.from_numpy(grid),
                                torch.from_numpy(rows),
                                torch.from_numpy(ends), 24).numpy()
    assert got.tobytes() == on_torch.tobytes()


@pytest.mark.parametrize("op", ["densify", "gather"])
def test_thread_count_does_not_change_the_result(data, op):
    ds, meta = data
    L = int(ds.events.stay_len.max())
    if op == "densify":
        runs = [_densify(ds.events, meta, L, threads=n) for n in (1, 4, 7)]
    else:
        grid = P.densify_events(ds.events, meta, L)
        rows, ends = _windows(grid, n=33, seed=1)
        runs = [NL.gather_windows_native(grid, rows, ends, 24, n_threads=n)
                for n in (1, 4, 7)]
    assert runs[0].tobytes() == runs[1].tobytes() == runs[2].tobytes()


def _hand_events(max_len=6, V=3, clip=15):
    """Two stays of rows with slots in and out of [0, max_len), counts
    above the clip and at or below 0, and the grid those rows must give,
    written out cell by cell."""
    slots = np.array([0, -1, 5, 6, 9, 2, 2, -7, 3], np.int32)
    offsets = np.array([0, 5, 9], np.int64)
    rng = np.random.default_rng(2)
    values = rng.normal(size=(len(slots), V)).astype(np.float32)
    counts = rng.integers(-2, 40, size=(len(slots), V)).astype(np.int32)
    counts[0] = [0, 1, 40]
    means = np.array([0.5, -1.0, 2.0], np.float32)
    stds = np.array([1.5, 0.25, 3.0], np.float32)
    want = np.zeros((2, max_len, 2 * V), np.float32)
    for s in range(2):
        for r in range(offsets[s], offsets[s + 1]):
            t = slots[r]
            if not 0 <= t < max_len:
                continue
            for j in range(V):
                c = min(max(int(counts[r, j]), 0), clip)
                if c > 0:
                    want[s, t, j] = (values[r, j] - means[j]) / (
                        stds[j] + np.float32(1e-7))
                    want[s, t, V + j] = c
    return (offsets, slots, values, counts, means, stds), want


@pytest.mark.parametrize("clip", [15, 3])
def test_out_of_range_slots_dropped_and_counts_clipped(clip, jax_native):
    args, want = _hand_events(clip=clip)
    got = NL.densify_events_native(*args, max_len=6, count_clip=clip)
    np.testing.assert_array_equal(got, want)
    assert got[..., 3:].max() == clip
    jax_got = JNL.densify_events_native(*args, max_len=6, count_clip=clip)
    np.testing.assert_array_equal(got, jax_got)


def test_windows_outside_the_grid_and_misfit_rows_raise(data):
    ds, meta = data
    grid = P.densify_events(ds.events, meta, 30)
    ok = np.array([0, 1], np.int32), np.array([24, 30], np.int32)
    assert NL.gather_windows_native(grid, *ok, 24).shape == (2, 24, 16)
    for rows, ends in (([0, 50], [24, 24]), ([0, -1], [24, 24]),
                       ([0, 1], [23, 24]), ([0, 1], [24, 31])):
        with pytest.raises(ValueError, match="outside the grid"):
            NL.gather_windows_native(grid, np.array(rows, np.int32),
                                     np.array(ends, np.int32), 24)
    (offsets, slots, values, counts, means, stds), _ = _hand_events()
    for bad in (dict(offsets=np.array([0, 5, 10])),
                dict(offsets=np.array([0, 6, 5])),
                dict(counts=counts[:, :2]), dict(slot_idx=slots[:-1])):
        kw = {**dict(offsets=offsets, slot_idx=slots, values=values,
                     counts=counts, means=means, stds=stds, max_len=6),
              **bad}
        with pytest.raises(ValueError, match="do not fit"):
            NL.densify_events_native(**kw)


_HOST_TYPES = {"int32_t": ctypes.c_int, "int64_t": ctypes.c_longlong}


@pytest.mark.parametrize("name", sorted(NL.DATA_OPS_ENTRY_POINTS))
def test_signatures_match_the_source(name):
    """The ops' C entry points take the parameters ctypes is told, and
    are the JAX package's (the same C signature in
    ``native/mmedema_native.cpp``)."""
    def signature(path):
        with open(path) as f:
            found = re.findall(r"\nvoid " + name + r"\(([^)]*)\)", f.read())
        assert len(found) == 1, (path, name)
        return [" ".join(p.split()) for p in found[0].split(",")]

    ours = signature(NL.DATA_OPS_SOURCE)
    assert ours == signature(JNL._NATIVE_DIR + "/mmedema_native.cpp")
    want = [ctypes.c_void_p if "*" in p
            else _HOST_TYPES[" ".join(p.split()[:-1])] for p in ours]
    assert NL.DATA_OPS_ENTRY_POINTS[name] == want


def test_build_is_keyed_and_needs_no_libjpeg():
    """The library lands under build/torch_host/ with a hash of the
    source and the flags in its name, links nothing and takes no ISA
    flag."""
    path = NL.build_data_ops()
    assert path.startswith(NL.BUILD_DIR) and "libdata_ops-" in path
    assert NL.build_data_ops() == path
    assert not any(f.startswith(("-l", "-m")) for f in NL.DATA_OPS_FLAGS)


def test_a_failed_build_raises_with_the_compilers_output(tmp_path,
                                                         monkeypatch):
    """No fallback: where the library will not build, the op raises (JAX
    returns None), naming g++ or quoting the compiler."""
    bad = tmp_path / "data_ops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(NL, "_data_lib", None)
    monkeypatch.setattr(NL, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(NL, "DATA_OPS_SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="(?s)host data ops failed.*error"):
        NL.gather_windows_native(np.zeros((1, 24, 2), np.float32),
                                 np.zeros(1, np.int32),
                                 np.full(1, 24, np.int32), 24)
    monkeypatch.setattr(NL.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        NL.densify_events_native(*_hand_events()[0], max_len=6)
