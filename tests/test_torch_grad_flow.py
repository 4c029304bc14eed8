"""The gradient-flow diagnostics in the port
(``analysis/grad_flow_diagnostics.py``) against the JAX package's, on the
CPU, on tiny teacher checkpoints the JAX package wrote
(``analysis_port_util.write_teacher``): a frozen ``dual_patch`` teacher,
one whose ViT trains (``freeze_cxr=False``) and a frozen
``dual_patch_event`` teacher (two query banks).

One diagnostics batch: every array of the step (the per-label losses, the
query Jacobian, the token sensitivities, the input gradients) within 1e-4
of its max abs against JAX's ``jacrev``; on a frozen teacher the pixel
gradients are exactly 0 in both packages (JAX stops the gradient at the
ViT's outputs, the port never puts the pixels in the graph), on the
unfrozen one the image branch's is not. The CLI's whole report against
JAX's within 1e-4 of max(1, |value|). The two refusals (a non-patch mode,
the encode-once tier). The teacher loop's in-loop diagnostics
(``--grad_diag_every``): finite, and equal to the script's report on the
epoch's checkpoint.
"""
import jax
import numpy as np
import pytest
import torch

from analysis_port_util import assert_report_close, flags, write_teacher
from multimodal_edema_prediction_tpu.analysis import common as JC
from multimodal_edema_prediction_tpu.analysis import \
    grad_flow_diagnostics as JG
from multimodal_edema_prediction_tpu_torch.analysis import common as C
from multimodal_edema_prediction_tpu_torch.analysis import \
    grad_flow_diagnostics as G
from multimodal_edema_prediction_tpu_torch.cli import train_teacher
from multimodal_edema_prediction_tpu_torch.train.engine import to_device
from multimodal_edema_prediction_tpu_torch.train.teacher_loop import \
    make_synthetic_pixel_hook

KINDS = {"frozen": (True, "dual_patch"), "unfrozen": (False, "dual_patch"),
         "event": (True, "dual_patch_event")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("teachers")
    return {k: write_teacher(str(d / f"{k}.msgpack"), freeze, mode)
            for k, (freeze, mode) in KINDS.items()}


def _batch(pkg, ckpt, B=8):
    """(model, variables or None, image source, x_ts, x_static, batch) of
    the val split's first B anchors through ``pkg``'s analysis helpers."""
    import argparse
    p = argparse.ArgumentParser()
    pkg.add_analysis_flags(p)
    args = p.parse_args(flags(ckpt, "-"))
    if pkg is JC:
        model, cfg, params, stats, _ = JC.load_teacher(ckpt)
        variables = {"params": params, "batch_stats": stats}
    else:
        model, cfg, _ = C.load_teacher(ckpt, "cpu")
        variables = None
    _, _, data, _ = pkg.load_analysis_data(args,
                                           n_variables=cfg.duett.n_variables)
    idx = data.splits["val"][:B]
    x_ts, x_static = pkg.gather_host_windows(data, idx)
    a = data.anchor
    batch = {"image_ids": a["image_ids"][idx].astype(np.int32),
             "y_multi": a["y_multi"][idx],
             "y_multi_mask": a["y_multi_mask"][idx],
             "bin_ends": np.broadcast_to(data.bin_ends,
                                         (B, data.n_timesteps)).copy()}
    return (model, variables, pkg.make_image_source(args, data, cfg.vit),
            x_ts, x_static, batch)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_one_batch_matches_jax(kind, ckpts):
    jm, jv, jsrc, x_ts, x_static, batch = _batch(JC, ckpts[kind])
    want = jax.tree.map(np.asarray, JG.make_diag_step(jm, jsrc)(
        jv, x_ts, x_static, jax.tree.map(jax.numpy.asarray, batch)))
    model, _, src, x_ts2, x_static2, batch2 = _batch(C, ckpts[kind])
    np.testing.assert_array_equal(x_ts, x_ts2)
    got = {k: v.detach().numpy() for k, v in G.make_diag_step(model, src)(
        x_ts2, x_static2, to_device(batch2, torch.device("cpu"))).items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        assert float(np.abs(got[k] - want[k]).max()) <= 1e-4 * scale, k
    if KINDS[kind][0]:      # a frozen ViT: no gradient reaches the pixels
        assert (got["px_input_grad"] == 0).all()
        assert (want["px_input_grad"] == 0).all()
    else:                   # only the image branch reaches them
        assert got["px_input_grad"][0] > 0
        assert (got["px_input_grad"][1:] == 0).all()
    # the fusion loss never reaches the image tokens (detached anchor)
    assert got["fus_sens"][0] == 0 and got["fus_sens"][1] > 0


@pytest.mark.parametrize("kind", ["frozen", "unfrozen"])
def test_report_matches_jax(kind, ckpts, tmp_path):
    argv = flags(ckpts[kind], tmp_path / "jax", ["--n_batches", "2"])
    want = JG.main(argv)
    got = G.main(flags(ckpts[kind], tmp_path / "port",
                       ["--n_batches", "2", "--device", "cpu"]))
    assert_report_close(got, want, 1e-4)
    assert got["fus_px_input_grad"] == 0.0
    assert (got["img_px_input_grad"] > 0) == (kind == "unfrozen")
    for name in ("grad_flow_report.txt", "grad_flow.json",
                 "grad_flow_report.json"):
        assert (tmp_path / "port" / name).exists()
    logged = G.diagnostics_to_log_dict(got)
    assert logged == pytest.approx(JG.diagnostics_to_log_dict(want),
                                   rel=1e-4, abs=1e-4, nan_ok=True)


def test_refuses_the_feature_cache_and_non_patch_modes(ckpts, tmp_path):
    with pytest.raises(SystemExit):
        G.main(flags(str(tmp_path / "unused.msgpack"), tmp_path,
                     ["--cxr_feature_cache", "hbm", "--device", "cpu"]))
    from multimodal_edema_prediction_tpu_torch.config import TeacherConfig
    from multimodal_edema_prediction_tpu_torch.models.teacher import \
        init_teacher
    from multimodal_edema_prediction_tpu_torch.train.checkpoint import \
        save_checkpoint
    from torch_port_util import tiny_teacher_cfg
    cfg = TeacherConfig.from_dict({**tiny_teacher_cfg().to_dict(),
                                   "perceiver_type": "single"})
    single = str(tmp_path / "single.msgpack")
    save_checkpoint(single, init_teacher(cfg, 0), 1, 0.5,
                    config={"model": cfg.to_dict()})
    with pytest.raises(ValueError, match="patch teacher modes"):
        G.main(flags(single, tmp_path, ["--device", "cpu"]))


def test_teacher_loop_runs_the_diagnostics(tmp_path, capsys):
    """``--grad_diag_every 1 --grad_diag_batches 1``: after each epoch the
    loop prints the report and keeps its scalars in the history; they are
    finite and equal the script's ``run_diagnostics`` on the epoch's
    checkpoint with the loop's pixels."""
    res = train_teacher.main([
        "--device", "cpu", "--vit_size", "tiny", "--synthetic_stays", "60",
        "--batch_size", "8", "--epochs", "1", "--limit_batches", "2",
        "--warmup_steps", "1", "--cxr_feature_cache", "hbm",
        "--no_save_state", "--grad_diag_every", "1",
        "--grad_diag_batches", "1", "--ckpt_dir", str(tmp_path)])
    assert capsys.readouterr().out.count("grad-flow diagnostics:") == 1
    logged = {k: v for k, v in res.history[0].items()
              if k.startswith("grad_diag/")}
    assert "grad_diag/query_gram_gap" in logged
    assert all(np.isfinite(v) for v in logged.values())
    assert logged["grad_diag/fus_px_input_grad"] == 0.0
    from multimodal_edema_prediction_tpu_torch.train.checkpoint import \
        load_teacher_from_ckpt
    model, cfg, ck = load_teacher_from_ckpt(res.best_path, "cpu")
    from multimodal_edema_prediction_tpu_torch.cli.common import load_data
    from multimodal_edema_prediction_tpu_torch.config import DataConfig
    args = train_teacher.build_parser().parse_args(
        ["--synthetic_stays", "60"])
    _, _, data = load_data(args, DataConfig())
    labels = ck["config"]["pathology_labels"]
    from multimodal_edema_prediction_tpu_torch.train import engine
    again = G.run_diagnostics(
        model, data, engine.default_image_source, "val", 8, 1,
        label_names=labels,
        image_hook=make_synthetic_pixel_hook(cfg.vit.image_size))
    assert G.diagnostics_to_log_dict(again, labels=labels) == logged
