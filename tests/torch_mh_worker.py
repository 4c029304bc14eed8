"""The port's multi-process recipes, and their worker (not a pytest module).

The counterparts of ``tests/mh_recipe.py`` and ``tests/mh_worker.py`` for
``multimodal_edema_prediction_tpu_torch``. ``run_recipe`` runs one tiny
recipe on the CPU, in the calling process; the worker joins a gloo group of
``num_processes`` (``parallel/multihost.initialize_distributed``) and runs
a list of recipes in turn on a SHARED workdir, each rank writing its
results to ``result_{pid}.json``. ``tests/test_torch_multihost_2proc.py``
compares the two ranks with each other and with the same recipes run in one
process. Recipes:

- ``teacher``: the ``dual_patch`` teacher on procedural pixels, with the
  gradient-flow diagnostics every epoch (``grad_diag/*`` in the history;
  the count of reports each rank printed through its ``Logger``);
- ``teacher_images``: real JPEGs, each rank decoding only its ``image_id %
  2`` share into a ``HostU8Bank`` (one process: the same batch composition,
  ``host_partition_count`` 2, and the card-tier bank);
- ``teacher_cached``: the encode-once tier, each rank encoding only its
  share into a ``HostFeatureStore``;
- ``teacher_preempt``: 4 epochs, a SIGTERM sent by rank 1 to itself during
  epoch 1 (rank 0 is never signalled); ``teacher_preempt_resume`` resumes
  that run to its end;
- ``ssl``: DuETT SSL pretraining on sliding windows;
- ``kd``: a teacher, then the student distilled from its checkpoint (written
  by rank 0 on the shared workdir);
- ``uneven``: one teacher step on a hand-made batch whose rows have uneven
  label masks and shifted values across the ranks' halves, and its loss
  parts, BatchNorm statistics and gradient;
- ``multistep_teacher_cached``, ``multistep_ssl``, ``multistep_kd``: the
  encode-once teacher, SSL and KD (its student; the teacher trained once)
  at ``steps_per_call`` 1 and 3 over 4 batches an epoch (a group of 3 and a
  remainder of 1), each with a digest of its final weights, optimizer
  moments and step generator, and the ``[multistep]`` lines it logged.

Usage: python torch_mh_worker.py <process_id> <num_processes> <port>
       <outdir> <recipe>[,<recipe>...]
"""
import contextlib
import io
import json
import os
import signal
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from multimodal_edema_prediction_tpu_torch.config import (  # noqa: E402
    DataConfig, DuettConfig, OptimConfig, PerceiverConfig, StudentConfig,
    TeacherConfig, TrainConfig, ViTConfig)
from multimodal_edema_prediction_tpu_torch.parallel import \
    multihost as mh  # noqa: E402

LABELS = DataConfig().pathology_labels
# the step of rank 1's run after which it sends itself SIGTERM: the first
# step of epoch 1 (3 steps an epoch)
PREEMPT_AT_STEP = 4
# the ``teacher`` recipe's gradient-flow diagnostics: val batches an epoch
DIAG_BATCHES = 1


def tiny_teacher_cfgs():
    """JAX ``mh_recipe._tiny_teacher_cfgs``."""
    tcfg = TeacherConfig(
        duett=DuettConfig(n_variables=8, n_timesteps=24, d_static=18,
                          d_embedding=8, n_layers=1, d_feedforward=32,
                          d_hidden_mlp_embedding=16,
                          d_hidden_tab_encoder=16, aug_noise=0.1,
                          aug_mask=0.1),
        vit=ViTConfig(image_size=56, patch_size=14, d_model=32, n_layers=1,
                      n_heads=2, d_feedforward=64),
        perceiver=PerceiverConfig(n_pathologies=7, d_latent=32, n_heads=2,
                                  head_hidden=16))
    cfg = TrainConfig(batch_size=32, epochs=2, patience=2, dtype="float32",
                      limit_batches=3,
                      optim=OptimConfig(lr=1e-3, warmup_steps=5))
    return tcfg, cfg


def cohort():
    """JAX ``mh_recipe._cohort``, through the port's own data code."""
    from multimodal_edema_prediction_tpu_torch.data import pipeline as P
    from multimodal_edema_prediction_tpu_torch.data import synthetic as S
    ds = S.make_synthetic(seed=0, n_subjects=100, n_stays=250,
                          n_variables=8, min_len=26, max_len=40,
                          obs_rate=0.5)
    meta = P.meta_from_events(ds, DataConfig())
    return ds, meta, P.build_anchor_dataset(ds, meta, DataConfig())


def _result(res) -> dict:
    out = {"best_metric": float(res.best_metric),
           "best_path": res.best_path,
           "history": [{k: float(v) for k, v in h.items()
                        if isinstance(v, (int, float))}
                       for h in res.history]}
    tm = res.test_metrics
    out["test_auroc"] = float(tm.get("main_auroc", tm.get("auroc",
                                                         float("nan"))))
    return out


def _preempt_rank1_at(step_no: int):
    """Wrap the teacher loop's step factory: rank 1 of a multi-process run
    sends itself SIGTERM after its ``step_no``-th step; returns the undo."""
    from multimodal_edema_prediction_tpu_torch.train import teacher_loop
    make = teacher_loop.engine.make_teacher_step

    def wrapped(*a, **k):
        step, n = make(*a, **k), [0]

        def run(*args):
            out = step(*args)
            n[0] += 1
            if n[0] == step_no and mh.process_index() == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return run

    teacher_loop.engine.make_teacher_step = wrapped
    return lambda: setattr(teacher_loop.engine, "make_teacher_step", make)


def _jpeg_blobs(anchor_ds) -> dict:
    from PIL import Image
    rng = np.random.default_rng(3)
    blobs = {}
    for img_id in np.unique(anchor_ds.anchor["image_ids"]):
        arr = (rng.random((56, 56, 3)) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG")
        blobs[int(img_id)] = buf.getvalue()
    return blobs


def uneven_batch(anchor_ds, n: int = 8) -> dict:
    """A global batch of ``n`` train anchors whose first half (rank 0's
    rows in two processes) keeps one valid label in 14 and whose second
    half keeps them all."""
    batch = anchor_ds.anchor_batch(anchor_ds.splits["train"][:n])
    mask = np.ones_like(batch["y_multi_mask"])
    mask[: n // 2] = 0.0
    mask[0, 0] = mask[1, 3] = 1.0
    batch["y_multi_mask"] = mask.astype(np.float32)
    batch["valid"] = np.ones(n, np.float32)
    return batch


def uneven_step(tcfg, anchor_ds, batch: dict) -> dict:
    """One teacher training step (dropout and augmentation on) on this
    process's rows of ``batch``, from ``init_teacher(seed 0)``: its loss
    parts, the BatchNorm running statistics and the gradient the update
    took."""
    from multimodal_edema_prediction_tpu_torch.models.teacher import \
        init_teacher
    from multimodal_edema_prediction_tpu_torch.train import engine
    from multimodal_edema_prediction_tpu_torch.train.optim import \
        MultiGroupAdamW
    from multimodal_edema_prediction_tpu_torch.train.state import TrainState
    from multimodal_edema_prediction_tpu_torch.train.teacher_loop import (
        make_synthetic_pixel_hook, teacher_frozen_prefixes)
    _, cfg = tiny_teacher_cfgs()
    model = init_teacher(tcfg, 0)
    state = TrainState(model, MultiGroupAdamW(
        model, cfg.optim, 10, frozen_prefixes=teacher_frozen_prefixes(tcfg)))
    step = engine.make_teacher_step(cfg, tcfg.duett,
                                    anchor_ds.n_timesteps,
                                    np.ones(len(LABELS), np.float32), None,
                                    torch.float32)
    local = mh.split_batch_for_process(dict(batch))
    local = make_synthetic_pixel_hook(tcfg.vit.image_size)(local)
    local.pop("valid")
    gen = torch.Generator().manual_seed(1)
    out = step(state, anchor_ds.grid, anchor_ds.static,
               engine.to_device(local, torch.device("cpu")), gen)
    sd = model.state_dict()
    # the update's gradient (summed over the ranks), trainable leaves only
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for ps in state.optimizer.params for p in ps]
    return {"losses": {k: float(out[k]) for k in
                       ("total", "img_total", "ts_total", "fus_total")},
            "bn": {k: sd[k].tolist() for k in sorted(sd)
                   if k.endswith(("running_mean", "running_var"))},
            "grads": torch.cat([g.reshape(-1) for g in grads]).tolist()}


def shifted_grid(anchor_ds, batch: dict) -> None:
    """Shift the values of the second half's stays by +2 (in place), so
    that the two halves' BatchNorm moments differ."""
    n = len(batch["stay_rows"])
    V = anchor_ds.grid.shape[-1] // 2
    rows = np.unique(batch["stay_rows"][n // 2:])
    rows = rows[~np.isin(rows, batch["stay_rows"][: n // 2])]
    anchor_ds.grid[torch.as_tensor(rows, dtype=torch.long), :, :V] += 2.0


# multi-step dispatch: K steps a call over 4 batches an epoch
MULTISTEP_K = 3
MULTISTEP_BATCHES = 4


def state_digest(res) -> str:
    """sha256 of a run's final weights and buffers, AdamW moments and step
    generator state."""
    import hashlib
    state, h = res.extras["state"], hashlib.sha256()
    sd = state.model.state_dict()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].detach().cpu().contiguous().numpy().tobytes())
    for moments in (state.optimizer.mu, state.optimizer.nu):
        for ts in moments:
            for t in ts:
                h.update(t.detach().cpu().contiguous().numpy().tobytes())
    h.update(res.extras["generator"].get_state().numpy().tobytes())
    return h.hexdigest()


def multistep_runs(kind: str, workdir: str, device: str = "cpu") -> dict:
    """``kind``'s run at K = 1 and at K = MULTISTEP_K on ``device``
    (``run_recipe``'s ``multistep_*``; on the card, the NCCL test of
    ``tests/test_torch_cuda.py``)."""
    from multimodal_edema_prediction_tpu_torch.train.teacher_loop import \
        train_teacher
    tcfg, cfg = tiny_teacher_cfgs()
    teacher_best = None
    if kind == "kd":
        import glob
        _, _, ads = cohort()
        t_dir = os.path.join(workdir, "ms_kd_teacher")
        t_res = train_teacher(ads, tcfg, cfg, t_dir, LABELS, device=device,
                              log=lambda msg: None)
        teacher_best = t_res.best_path or sorted(glob.glob(
            os.path.join(t_dir, "best-*.msgpack")))[-1]
    out = {}
    for k in (1, MULTISTEP_K):
        lines = []
        run_cfg = cfg.replace(limit_batches=MULTISTEP_BATCHES,
                              steps_per_call=k)
        run_dir = os.path.join(workdir, f"ms_{kind}_k{k}")
        if kind == "teacher_cached":
            _, _, ads = cohort()
            ads.host_partition_count = 2
            res = train_teacher(ads, tcfg, run_cfg, run_dir, LABELS,
                                device=device, feature_cache="host",
                                log=lines.append)
        elif kind == "ssl":
            from multimodal_edema_prediction_tpu_torch.data.sliding import \
                build_sliding_ssl_dataset
            from multimodal_edema_prediction_tpu_torch.train.ssl_loop import \
                train_ssl
            ds, meta, _ = cohort()
            sds = build_sliding_ssl_dataset(ds, meta, n_timesteps=24,
                                            stride=12)
            res = train_ssl(sds, tcfg.duett, run_cfg, run_dir,
                            warmup_steps=5, device=device, log=lines.append)
        else:
            from multimodal_edema_prediction_tpu_torch.train.kd_loop import \
                train_student_kd
            _, _, ads = cohort()
            res = train_student_kd(ads, StudentConfig(duett=tcfg.duett),
                                   teacher_best, run_cfg, run_dir,
                                   device=device, log=lines.append)
        r = _result(res)
        r["digest"] = state_digest(res)
        r["n_train_steps"] = res.extras["n_train_steps"]
        r["multistep_lines"] = [ln for ln in lines if "[multistep]" in ln]
        out[f"k{k}"] = r
    return out


def run_recipe(kind: str, workdir: str) -> dict:
    from multimodal_edema_prediction_tpu_torch.train.teacher_loop import \
        train_teacher
    os.makedirs(workdir, exist_ok=True)
    tcfg, cfg = tiny_teacher_cfgs()

    if kind == "teacher":
        # with the gradient-flow diagnostics every epoch, printed through
        # a Logger (rank 0 alone prints)
        from multimodal_edema_prediction_tpu_torch.utils.logging import \
            Logger
        _, _, ads = cohort()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            res = train_teacher(ads, tcfg, cfg,
                                os.path.join(workdir, "teacher"), LABELS,
                                device="cpu", grad_diag_every=1,
                                grad_diag_batches=DIAG_BATCHES,
                                logger=Logger("teacher"))
        out = _result(res)
        out["printed_diagnostics"] = printed.getvalue().count(
            "grad-flow diagnostics")
        out["printed_lines"] = len(printed.getvalue().splitlines())
        return out

    if kind == "teacher_images":
        from multimodal_edema_prediction_tpu_torch.data.images import \
            JpegStore
        _, _, ads = cohort()
        # one process composes its batches by the same P=2 rule that two
        # processes take for their partitions
        ads.host_partition_count = 2
        res = train_teacher(ads, tcfg, cfg,
                            os.path.join(workdir, "teacher_img"), LABELS,
                            device="cpu",
                            jpeg_store=JpegStore(blobs=_jpeg_blobs(ads)))
        out = _result(res)
        out["image_tier"] = res.extras["image_tier"]["tier"]
        out["n_images"] = res.extras["image_tier"]["n_images"]
        return out

    if kind == "teacher_cached":
        _, _, ads = cohort()
        ads.host_partition_count = 2
        res = train_teacher(ads, tcfg, cfg,
                            os.path.join(workdir, "teacher_cached"), LABELS,
                            device="cpu", feature_cache="host")
        out = _result(res)
        out["feature_tier"] = res.extras["feature_tier"]["tier"]
        out["n_images"] = res.extras["feature_tier"]["n_images"]
        return out

    if kind == "teacher_orbax":
        # JAX's recipe on the orbax backend, paused after epoch 1 and
        # resumed: rank 0 alone writes the steps (the ranks hold the same
        # state), every rank restores from the shared directory
        from multimodal_edema_prediction_tpu_torch.train.orbax_io import \
            make_manager
        _, _, ads = cohort()
        d = os.path.join(workdir, "teacher_orbax")
        first = train_teacher(ads, tcfg, cfg, d, LABELS, device="cpu",
                              save_full_state=True, state_backend="orbax",
                              stop_after_epochs=1)
        res = train_teacher(ads, tcfg, cfg, d, LABELS, device="cpu",
                            auto_resume=True, state_backend="orbax")
        out = _result(res)
        out["first_history"] = first.history
        out["start_epoch"] = res.extras["start_epoch"]
        out["orbax_steps"] = make_manager(os.path.join(
            d, "orbax_state")).all_steps()
        out["digest"] = state_digest(res)
        return out

    if kind in ("teacher_preempt", "teacher_preempt_resume",
                "teacher_4epochs"):
        from multimodal_edema_prediction_tpu_torch.utils import preemption
        # patience high enough that only the signal ends the run early
        cfg = cfg.replace(epochs=4, patience=10)
        _, _, ads = cohort()
        prev = signal.getsignal(signal.SIGTERM)
        installed = preemption._installed
        preemption.clear()
        preemption.install_handler()
        undo = _preempt_rank1_at(PREEMPT_AT_STEP) \
            if kind == "teacher_preempt" else (lambda: None)
        try:
            res = train_teacher(
                ads, tcfg, cfg, os.path.join(workdir, "teacher_pre"),
                LABELS, device="cpu",
                auto_resume=kind == "teacher_preempt_resume",
                save_full_state=kind != "teacher_4epochs")
        finally:
            undo()
            preemption.clear()
            signal.signal(signal.SIGTERM, prev)
            preemption._installed = installed
        out = _result(res)
        out["n_epochs_run"] = len(res.history)
        out["state_saved"] = os.path.exists(os.path.join(
            workdir, "teacher_pre", "train_state.meta.json"))
        return out

    if kind == "ssl":
        from multimodal_edema_prediction_tpu_torch.data.sliding import \
            build_sliding_ssl_dataset
        from multimodal_edema_prediction_tpu_torch.train.ssl_loop import \
            train_ssl
        ds, meta, _ = cohort()
        sds = build_sliding_ssl_dataset(ds, meta, n_timesteps=24, stride=12)
        scfg = TrainConfig(batch_size=32, epochs=2, patience=2,
                           dtype="float32", limit_batches=3)
        res = train_ssl(sds, tcfg.duett, scfg, os.path.join(workdir, "ssl"),
                        warmup_steps=5, device="cpu")
        return _result(res)

    if kind == "kd":
        import glob
        from multimodal_edema_prediction_tpu_torch.train.kd_loop import \
            train_student_kd
        _, _, ads = cohort()
        t_dir = os.path.join(workdir, "kd_teacher")
        t_res = train_teacher(ads, tcfg, cfg, t_dir, LABELS, device="cpu")
        # rank 0 wrote the checkpoint before train_teacher returned
        best = t_res.best_path or sorted(glob.glob(
            os.path.join(t_dir, "best-*.msgpack")))[-1]
        res = train_student_kd(ads, StudentConfig(duett=tcfg.duett), best,
                               cfg, os.path.join(workdir, "kd_student"),
                               device="cpu")
        out = _result(res)
        out["teacher_best"] = float(t_res.best_metric)
        return out

    if kind == "uneven":
        _, _, ads = cohort()
        batch = uneven_batch(ads)
        shifted_grid(ads, batch)
        return uneven_step(tcfg, ads, batch)

    if kind.startswith("multistep_"):
        return multistep_runs(kind[len("multistep_"):], workdir)

    raise ValueError(f"unknown recipe {kind!r}")


def main():
    pid, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                int(sys.argv[3]), sys.argv[4])
    recipes = sys.argv[5].split(",")
    torch.set_num_threads(1)
    backend = mh.initialize_distributed(f"localhost:{port}", nproc, pid,
                                        device="cpu")
    assert backend == "gloo" and mh.process_count() == nproc
    results = {}
    for kind in recipes:
        r = run_recipe(kind, os.path.join(outdir, "shared"))
        r["process_id"] = mh.process_index()
        r["is_main"] = mh.is_main_process()
        results[kind] = r
    with open(os.path.join(outdir, f"result_{pid}.json"), "w") as f:
        json.dump(results, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
