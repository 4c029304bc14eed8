"""Data parallelism over processes in the port (ROADMAP P18): the loops'
refusals and checks, ``parallel/multihost.py`` and ``parallel/mesh.py``
against the JAX package's, partitioned batch composition, and data-parallel
serving. Two real processes are ``tests/test_torch_multihost_2proc.py``.

JAX's process count and index are patched here as a second process would
see them (``jax.process_count`` / ``jax.process_index``), and the port's
through ``parallel/multihost``'s own functions, so each package's pure
slicing and composition is compared on the same numpy cohort, key for key
and row for row. ``param_spec`` is held against JAX's on every parameter of
the teacher; data-parallel serving over two CPU replicas against one
replica (1e-5 relative: each replica runs half the bucket, whose float32
products round apart) on JAX's bucket ladder.
"""
import jax
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.config import DataConfig as JData
from multimodal_edema_prediction_tpu.data import pipeline as JP
from multimodal_edema_prediction_tpu.data import sliding as JSL
from multimodal_edema_prediction_tpu.data import synthetic as JS
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.parallel import mesh as jmesh
from multimodal_edema_prediction_tpu.parallel import multihost as jmh
from multimodal_edema_prediction_tpu.serve import \
    BatchingPredictor as JPredictor
from multimodal_edema_prediction_tpu.train import teacher_loop as JTL
from multimodal_edema_prediction_tpu_torch.cli import serve as cli_serve
from multimodal_edema_prediction_tpu_torch.config import (DataConfig,
                                                          DuettConfig,
                                                          StudentConfig,
                                                          TeacherConfig,
                                                          TrainConfig)
from multimodal_edema_prediction_tpu_torch.convert import flax_paths
from multimodal_edema_prediction_tpu_torch.data import pipeline as P
from multimodal_edema_prediction_tpu_torch.data import sliding as SL
from multimodal_edema_prediction_tpu_torch.data import synthetic as S
from multimodal_edema_prediction_tpu_torch.models.teacher import init_teacher
from multimodal_edema_prediction_tpu_torch.parallel import mesh
from multimodal_edema_prediction_tpu_torch.parallel import multihost as mh
from multimodal_edema_prediction_tpu_torch.serve import BatchingPredictor
from multimodal_edema_prediction_tpu_torch.train import cxr_head_loop as CH
from multimodal_edema_prediction_tpu_torch.train import finetune_loop as FT
from multimodal_edema_prediction_tpu_torch.train import kd_loop as K
from multimodal_edema_prediction_tpu_torch.train import loops as L
from multimodal_edema_prediction_tpu_torch.train import ssl_loop as SSL
from multimodal_edema_prediction_tpu_torch.train import teacher_loop as TL
from torch_port_util import tiny_teacher_cfg, window_inputs

COHORT = dict(seed=0, n_subjects=60, n_stays=150, n_variables=8, min_len=26,
              max_len=40, obs_rate=0.5)

# the loops that run data-parallel since P18, and those that refuse (P18b)
PARALLEL = {
    "teacher": lambda d, cfg: TL.train_teacher(None, TeacherConfig(), cfg,
                                               d, (), device="cpu"),
    "ssl": lambda d, cfg: SSL.train_ssl(None, DuettConfig(), cfg, d,
                                        device="cpu"),
    "kd": lambda d, cfg: K.train_student_kd(None, StudentConfig(), "", cfg,
                                            d, device="cpu"),
}
REFUSING = {
    "supervised": lambda d: L.train_supervised_ts(None, StudentConfig(),
                                                  TrainConfig(), d,
                                                  device="cpu"),
    "finetune": lambda d: FT.finetune_duett(None, DuettConfig(),
                                            TrainConfig(), d,
                                            device="cpu"),
    "cxr_head": lambda d: CH.train_cxr_head(None, None, {}, (), d,
                                            device="cpu"),
}


def _as_process(monkeypatch, count: int, index: int) -> None:
    """Both packages see ``count`` processes, this one ``index``."""
    monkeypatch.setattr(jax, "process_count", lambda: count)
    monkeypatch.setattr(jax, "process_index", lambda: index)
    monkeypatch.setattr(mh, "process_count", lambda: count)
    monkeypatch.setattr(mh, "process_index", lambda: index)


def _assert_batches_equal(got: list, want: list) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k == "_global":
                assert sorted(g[k]) == sorted(w[k])
                for kk in w[k]:
                    np.testing.assert_array_equal(g[k][kk], w[k][kk],
                                                  err_msg=kk)
            else:
                np.testing.assert_array_equal(np.asarray(g[k]),
                                              np.asarray(w[k]), err_msg=k)


@pytest.fixture(scope="module")
def datasets():
    jds = JS.make_synthetic(**COHORT)
    jads = JP.build_anchor_dataset(jds, JP.meta_from_events(jds, JData()),
                                   JData())
    ds = S.make_synthetic(**COHORT)
    meta = P.meta_from_events(ds, DataConfig())
    ads = P.build_anchor_dataset(ds, meta, DataConfig())
    return jds, jads, ds, meta, ads


# ---------------------------------------------------------------------------
# the loops: F6's refusals and the group check
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("loop", sorted(PARALLEL))
def test_loop_refuses_a_launcher_without_a_group(loop, tmp_path,
                                                 monkeypatch):
    """WORLD_SIZE=2 with no initialised group: each process would train
    alone on every batch, so the loop refuses before any work."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no torch.distributed process"):
        PARALLEL[loop](str(tmp_path), TrainConfig())


@pytest.mark.parametrize("loop", sorted(REFUSING))
def test_loop_refuses_more_than_one_process(loop, tmp_path, monkeypatch):
    """Supervised training, fine-tuning and the CXR head have no
    multi-process branch in JAX either: they refuse naming ROADMAP P18b."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="P18b"):
        REFUSING[loop](str(tmp_path))


@pytest.mark.parametrize("loop", sorted(PARALLEL))
def test_multi_process_loop_refuses_tensor_parallelism(loop, tmp_path,
                                                       monkeypatch):
    """n_model != 1 in a multi-process run raises JAX's ValueError
    (``teacher_loop.py:181-184``), before any data is read."""
    monkeypatch.setattr(mh, "check_group", lambda: 2)
    monkeypatch.setattr(mh, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="set n_model=1"):
        PARALLEL[loop](str(tmp_path), TrainConfig(n_model=2))


@pytest.mark.parametrize("world,backend,device,captured", [
    (1, None, "cuda", True), (1, None, "cpu", False),
    (2, "nccl", "cuda", True), (2, "gloo", "cuda", False),
    (2, "gloo", "cpu", False)])
def test_multistep_route_follows_the_backend(world, backend, device,
                                             captured, monkeypatch):
    """``engine.capture_route``, chosen before the first step: K steps are
    captured on a card in one process or an NCCL group, and run as a loop
    over gloo (logged, naming the backend) and on the CPU. The two-process
    runs of both routes' loops are ``test_torch_multihost_2proc.py``'s
    (gloo) and ``test_torch_cuda.py``'s (NCCL, two cards)."""
    from multimodal_edema_prediction_tpu_torch.train import engine
    monkeypatch.setattr(mh, "process_count", lambda: world)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda: backend)
    lines = []
    assert engine.capture_route(device, 4, lines.append) is captured
    assert lines == ([] if backend != "gloo" else [
        "[multistep] K=4 as a loop over gloo (a host-side collective "
        "cannot be captured)"])


def test_multi_process_teacher_refuses_grad_diagnostics(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(mh, "check_group", lambda: 2)
    monkeypatch.setattr(mh, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="P18b"):
        TL.train_teacher(None, TeacherConfig(), TrainConfig(), str(tmp_path),
                         (), device="cpu", grad_diag_every=1)


# ---------------------------------------------------------------------------
# parallel/multihost.py
# ---------------------------------------------------------------------------
def test_single_process_no_ops(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mh.initialize_distributed() is None
    assert mh.initialize_distributed(num_processes=1) is None
    jmh.initialize_distributed(num_processes=1)
    assert mh.is_main_process() and jmh.is_main_process()
    assert mh.process_count() == 1 and mh.process_index() == 0
    assert mh.check_group() == 1
    x = torch.arange(6.0).reshape(3, 2).requires_grad_()
    for f in (mh.gather_rows, mh.all_reduce_sum, mh.param_term):
        assert f(x) is x
    np.testing.assert_array_equal(mh.fetch_global(x), x.detach().numpy())
    np.testing.assert_array_equal(mh.gather_metrics(np.arange(3)),
                                  jmh.gather_metrics(np.arange(3)))
    assert mh.any_flag(True) and not mh.any_flag(False)
    mh.barrier()
    b = {"stay_rows": np.arange(4)}
    assert mh.split_batch_for_process(b) is b
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    np.testing.assert_array_equal(
        mh.draw_rows(lambda sh: torch.rand(sh, generator=g1), (3, 2)),
        torch.rand((3, 2), generator=g2))
    x.grad = None
    mh.all_reduce_grads([x])
    assert x.grad is None
    assert mh.choose_backend(2, "cpu") == "gloo"
    assert mh.rank_device("cpu") == torch.device("cpu")


def test_draw_rows_takes_this_ranks_rows_of_the_global_draw(monkeypatch):
    """Rank 1 of 2 draws the global batch's values from the same generator
    state and keeps rows [n, 2n): one process's rows n..2n-1."""
    g_one, g_rank = (torch.Generator().manual_seed(7) for _ in range(2))
    want = torch.rand((6, 4), generator=g_one)
    _as_process(monkeypatch, 2, 1)
    got = mh.draw_rows(lambda sh: torch.rand(sh, generator=g_rank), (3, 4))
    np.testing.assert_array_equal(got, want[3:])
    # and the generator moved on as one process's would
    np.testing.assert_array_equal(torch.rand(2, generator=g_rank),
                                  torch.rand(2, generator=g_one))


def test_param_term_counts_a_parameter_term_once_over_the_ranks(
        monkeypatch):
    w = torch.tensor([1.5, -2.0], requires_grad=True)
    _as_process(monkeypatch, 4, 2)
    term = mh.param_term((w ** 2).mean())
    assert term.item() == (w ** 2).mean().item()
    term.backward()
    np.testing.assert_allclose(w.grad.numpy(), w.detach().numpy() / 4)


def test_launcher_world_without_a_group_raises(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        mh.check_group()


@pytest.mark.parametrize("pid", [0, 1])
def test_split_batch_for_process_matches_jax(pid, monkeypatch):
    rng = np.random.default_rng(pid)
    batch = {"stay_rows": np.arange(8), "slot_idx": rng.integers(0, 9, 8),
             "image_ids": rng.integers(0, 50, 8).astype(np.int32),
             "y": rng.random(8).astype(np.float32),
             "y_multi": rng.random((8, 7)).astype(np.float32),
             "y_multi_mask": np.ones((8, 7), np.float32),
             "valid": np.ones(8, np.float32),
             "bin_ends": np.broadcast_to(np.arange(24.0), (8, 24))}
    _as_process(monkeypatch, 2, pid)
    got = mh.split_batch_for_process(dict(batch))
    want = jmh.split_batch_for_process(dict(batch))
    _assert_batches_equal([got], [want])
    np.testing.assert_array_equal(got["stay_rows"],
                                  np.arange(4) + 4 * pid)
    _as_process(monkeypatch, 3, pid)
    for f in (mh.split_batch_for_process, jmh.split_batch_for_process):
        with pytest.raises(ValueError, match="not divisible by 3"):
            f(dict(batch))


@pytest.mark.parametrize("count,pid", [(1, 0), (2, 0), (2, 1)])
@pytest.mark.parametrize("split,shuffle", [("train", True), ("val", False)])
def test_partitioned_batches_match_jax(datasets, count, pid, split, shuffle,
                                       monkeypatch):
    """``host_partition_count`` 2: every global batch (and its process
    slice) equals JAX's index for index; a process's rows name only its
    own ``image_id % 2`` partition."""
    _, jads, _, _, ads = datasets
    _as_process(monkeypatch, count, pid)
    jads.host_partition_count = ads.host_partition_count = 2
    try:
        got = list(ads.iter_batches(split, 16, shuffle, seed=3))
        want = list(jads.iter_batches(split, 16, shuffle, seed=3))
    finally:
        jads.host_partition_count = ads.host_partition_count = 0
    _assert_batches_equal(got, want)
    if count == 2:
        for b in got:
            assert np.all(b["image_ids"] % 2 == pid)


@pytest.mark.parametrize("pid", [0, 1])
def test_process_slices_of_plain_and_sliding_batches_match_jax(
        datasets, pid, monkeypatch):
    jds, jads, ds, meta, ads = datasets
    _as_process(monkeypatch, 2, pid)
    _assert_batches_equal(list(ads.iter_batches("val", 16, False)),
                          list(jads.iter_batches("val", 16, False)))
    jmeta = JP.meta_from_events(jds, JData())
    jsl = JSL.build_stay_label_dataset(jds, jmeta)
    sl = SL.build_stay_label_dataset(ds, meta)
    _assert_batches_equal(list(sl.iter_batches("train", 8, True, seed=1)),
                          list(jsl.iter_batches("train", 8, True, seed=1)))


# ---------------------------------------------------------------------------
# parallel/mesh.py
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_teacher():
    cfg = tiny_teacher_cfg()
    model = JT(cfg)
    variables = JTL.init_teacher(model, cfg, 2, cfg.duett.n_timesteps,
                                 jax.random.key(0))
    return cfg, model, variables


def test_param_spec_matches_jax_on_every_teacher_parameter(jax_teacher):
    cfg, _, variables = jax_teacher
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    split = 0
    for entries, leaf in flat:
        path = "/".join(str(getattr(k, "key", k)) for k in entries)
        spec = tuple(jmesh.param_spec(path, leaf))
        want = spec.index("model") if "model" in spec else None
        assert mesh.param_spec(path, leaf.ndim) == want, path
        split += want is not None
    assert split > 0            # the ViT's q, k, v, out and MLP leaves
    # the port's parameters carry exactly JAX's paths
    ported = init_teacher(TeacherConfig.from_dict(cfg.to_dict()), 0)
    paths = {p for c, p in flax_paths(ported).values() if c == "params"}
    assert paths == {"/".join(str(getattr(k, "key", k)) for k in e)
                     for e, _ in flat}


def test_create_mesh_checks_as_jax(monkeypatch):
    devs = jax.devices()[:2]
    for args in ((3, 1), (1, 3), (2, 2)):
        with pytest.raises(ValueError) as want:
            jmesh.create_mesh(*args, devices=devs)
        with pytest.raises(ValueError) as got:
            mesh.create_mesh(*args, devices=["d0", "d1"])
        assert str(got.value) == str(want.value)
    m = mesh.create_mesh(0, 1, devices=["d0", "d1"])
    assert m.shape == dict(jmesh.create_mesh(0, 1, devices=devs).shape)
    # a multi-process run: the data axis is the ranks, n_model 1 only
    monkeypatch.setattr(mh, "process_count", lambda: 2)
    assert mesh.create_mesh().shape == {"data": 2, "model": 1}
    with pytest.raises(ValueError, match="set n_model=1"):
        mesh.create_mesh(0, 2)
    batch = {"x": np.arange(4.0), "_global": {"x": np.arange(8.0)}}
    assert sorted(mesh.shard_batch(batch, torch.device("cpu"))) == ["x"]


# ---------------------------------------------------------------------------
# serving: --data_parallel
# ---------------------------------------------------------------------------
def _items(pred, reqs):
    from concurrent.futures import Future
    items = [pred._parse(r) for r in reqs]
    for it in items:
        it.future = Future()
    return items


def test_data_parallel_serving_matches_one_replica(jax_teacher):
    cfg, jm, variables = jax_teacher
    model = init_teacher(TeacherConfig.from_dict(cfg.to_dict()), 0)
    one = BatchingPredictor(model, max_batch=8, max_wait_ms=0.0,
                            dtype=torch.float32, device="cpu")
    two = BatchingPredictor(model, max_batch=8, max_wait_ms=0.0,
                            dtype=torch.float32, device="cpu",
                            data_parallel=2)
    jmesh2 = jmesh.create_mesh(2, 1)
    jpred = JPredictor(jm, variables["params"], variables["batch_stats"],
                       max_batch=8, mesh=jmesh2)
    assert two.buckets == jpred.buckets == (2, 4, 8)
    assert one.buckets == (1, 2, 4, 8)
    x_ts, static, _, pixels = window_inputs(cfg, 5, seed=2)
    reqs = [{"x_ts": x_ts[i], "static": static[i], "pixel_u8": pixels[i]}
            for i in range(5)]
    got, want = _items(two, reqs), _items(one, reqs)
    two._run_batch(got)
    one._run_batch(want, bucket=8)
    for g, w in zip(got, want):
        g, w = g.future.result(), w.future.result()
        for k in ("fusion_logits", "img_logits", "ts_logits"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6)


def test_serve_cli_takes_data_parallel_and_refuses_missing_cards(
        monkeypatch):
    # nothing of the serve CLI is queued any more (--aot_dir: P10b)
    assert not hasattr(cli_serve, "QUEUED_FLAGS")
    args = cli_serve.build_parser().parse_args(
        ["--ckpt", "x.msgpack", "--data_parallel", "2", "--aot_dir", "d"])
    assert args.data_parallel == 2 and args.aot_dir == "d"
    # N replicas need N cards: JAX's create_mesh error, before any load
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="mesh 2x1 needs more than 1"):
        cli_serve.main(["--ckpt", "x.msgpack", "--data_parallel", "2"])
