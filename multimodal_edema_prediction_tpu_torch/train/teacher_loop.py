"""Teacher training loop (``dual_patch``): the port's counterpart of
``multimodal_edema_prediction_tpu/train/teacher_loop.py::train_teacher``
(reference ``training_duett/trainer.py:216-764``).

Per epoch: shuffled train batches through ``engine.make_teacher_step`` (loss
sums stay on the device; one host sync per epoch), a finite-loss guard, the
validation macro fusion AUROC, early stopping and the best checkpoint (JAX
format); at the end the test split is evaluated from the best checkpoint,
reloaded through ``load_teacher_from_ckpt``.

Image tiers: ``feature_cache="none"`` runs the frozen ViT inside every step
on pixels; ``"hbm"`` encodes every unique image once into a
``CXRFeatureBank`` on the card and gathers its rows through K2 in every
train and eval step; ``"auto"`` takes the bank when it fits
``hbm_feature_budget_gb``. With ``freeze_cxr=False`` the ViT trains inside
every step on pixels (its attention's gradient through K1's backward
kernels), so only ``feature_cache="none"`` is legal. Single process only.
Not ported yet, each named by its ROADMAP item: the host feature store
(P8), LP mode and the other perceiver modes (P13), full-state resume (P16),
multi-process (P18).
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..config import TeacherConfig, TrainConfig
from ..data.features import CXRFeatureBank, encode_fn_for_teacher
from ..data.pipeline import AnchorDataset
from ..data.synthetic import synthetic_image_batch
from ..models.teacher import TeacherModel, init_teacher
from ..models.vit import IMAGE_MEAN, IMAGE_STD
from ..utils import resolve_device
from . import engine
from .checkpoint import BestKTracker, load_teacher_from_ckpt
from .evaluator import (evaluate_dual_pathology,
                        format_dual_pathology_gap_table)
from .loops import EarlyStopper, TrainResult
from .optim import MultiGroupAdamW
from .state import TrainState, param_count

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_synthetic_pixel_hook(image_size: int = 518
                              ) -> Callable[[dict], dict]:
    """Host batch hook: attach ``pixel_values``, the procedural images of
    ``data/synthetic.synthetic_image_batch`` for the batch's image ids and
    labels, normalized as the ViT expects."""
    mean = np.asarray(IMAGE_MEAN, np.float32)
    std = np.asarray(IMAGE_STD, np.float32)

    def hook(batch: dict) -> dict:
        px = synthetic_image_batch(None, batch["image_ids"],
                                   batch["y_multi"], image_size)
        return {**batch, "pixel_values": (px - mean) / std}

    return hook


def teacher_frozen_prefixes(cfg: TeacherConfig) -> tuple:
    frozen = []
    if cfg.freeze_cxr:
        frozen.append("cxr/")
    if cfg.freeze_duett:
        frozen.append("duett/")
    return tuple(frozen)


def check_ported(cfg: TeacherConfig) -> None:
    """Raise on what the port cannot train yet, on every device."""
    if cfg.perceiver_type != "dual_patch":
        raise NotImplementedError(
            f"perceiver_type={cfg.perceiver_type!r} is not ported yet "
            "(ROADMAP P13); the port trains 'dual_patch'")


def build_feature_bank(model, dataset: AnchorDataset, image_hook, dtype
                        ) -> CXRFeatureBank:
    """Encode every unique image of the dataset once (JAX
    ``teacher_loop.py:311-381``): each id's pixels come from the image hook
    with the labels of its first anchor."""
    all_ids = np.unique(dataset.anchor["image_ids"]).astype(np.int64)
    order = np.argsort(dataset.anchor["image_ids"], kind="stable")
    srt = dataset.anchor["image_ids"][order]
    first = order[np.searchsorted(srt, all_ids)]
    y_rep = np.asarray(dataset.anchor["y_multi"][first], np.float32)

    def pixels_for_ids(ids):
        rows = np.searchsorted(all_ids, np.asarray(ids, np.int64))
        b = image_hook({"image_ids": np.asarray(ids, np.int32),
                        "y_multi": y_rep[rows]})
        return b["pixel_values"]

    out_dtype = torch.float32 if dtype == torch.float32 else torch.bfloat16
    return CXRFeatureBank.build(encode_fn_for_teacher(model, dtype),
                                pixels_for_ids, all_ids, out_dtype=out_dtype)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_teacher(dataset: AnchorDataset, teacher_cfg: TeacherConfig,
                  cfg: TrainConfig, ckpt_dir: str,
                  pathology_labels: Sequence[str],
                  model: Optional[TeacherModel] = None,
                  device="cuda",
                  image_hook: Optional[Callable[[dict], dict]] = None,
                  feature_cache: str = "none",
                  hbm_feature_budget_gb: float = 8.0,
                  log: Callable[[str], None] = print) -> TrainResult:
    """Train the teacher; returns the best val macro fusion AUROC, its
    checkpoint, the per-epoch history and the test metrics.

    ``model``: the initial weights (default: ``init_teacher`` from
    ``cfg.seed``), e.g. with a loaded RAD-DINO ViT
    (``models/vit.py::load_vit_params``); it is moved to ``device`` and
    trained in place.
    ``image_hook``: host batch hook that attaches ``pixel_values`` (default:
    the synthetic cohort's procedural images); the pixel tier runs it on
    every batch, the encode-once tier once per unique image."""
    check_ported(teacher_cfg)
    if feature_cache not in ("none", "auto", "hbm", "host"):
        raise ValueError(f"unknown feature_cache mode {feature_cache!r}")
    if feature_cache != "none" and not teacher_cfg.freeze_cxr:
        raise ValueError(
            "feature_cache requires freeze_cxr=True: cached ViT tokens are "
            "constants, so a trainable CXR branch would never update")
    if feature_cache == "host":
        raise NotImplementedError("feature_cache='host' (the host feature "
                                  "store) is not ported yet (ROADMAP P8)")
    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    if model is None:
        model = init_teacher(teacher_cfg, cfg.seed)
    model = model.to(dev)
    dataset.to(dev)
    T = dataset.n_timesteps
    lw = np.ones(len(pathology_labels), np.float32)  # trainer.py:390-391
    image_hook = image_hook or make_synthetic_pixel_hook(
        teacher_cfg.vit.image_size)
    log(f"params: {param_count(model):,}  mode={teacher_cfg.perceiver_type}"
        f"  device={dev}")

    phase = {}
    feature_source = None
    dataset.batch_hook = image_hook
    if feature_cache != "none":
        n_images = len(np.unique(dataset.anchor["image_ids"]))
        itemsize = 4 if dtype == torch.float32 else 2
        fb_bytes = CXRFeatureBank.nbytes(n_images, teacher_cfg.vit.n_patches,
                                         teacher_cfg.vit.d_model, itemsize)
        if feature_cache == "auto" and \
                fb_bytes > hbm_feature_budget_gb * 2 ** 30:
            raise NotImplementedError(
                f"the feature bank ({fb_bytes / 2 ** 30:.2f} GiB) exceeds "
                f"hbm_feature_budget_gb={hbm_feature_budget_gb}, and the "
                "host feature store is not ported yet (ROADMAP P8)")
        t0 = time.perf_counter()
        bank = build_feature_bank(model, dataset, image_hook, dtype)
        _sync(dev)
        phase["feature_build"] = time.perf_counter() - t0
        dataset.batch_hook = bank.host_fn()
        feature_source = bank.feature_source()
        log(f"[features] encode-once bank on {dev}: {n_images} images "
            f"({fb_bytes / 2 ** 30:.2f} GiB, "
            f"{phase['feature_build']:.1f}s build)")

    steps_per_epoch = dataset.split_size("train") // cfg.batch_size
    if cfg.limit_batches > 0:
        steps_per_epoch = min(steps_per_epoch, cfg.limit_batches)
    total_steps = max(steps_per_epoch * cfg.epochs, 1)
    state = TrainState(model, MultiGroupAdamW(
        model, cfg.optim, total_steps,
        frozen_prefixes=teacher_frozen_prefixes(teacher_cfg)))
    train_step = engine.make_teacher_step(
        cfg, teacher_cfg.duett, T, lw, None, dtype,
        feature_source=feature_source)
    loop_eval = engine.make_teacher_eval(T, dtype,
                                         feature_source=feature_source)
    n_eval = [0]

    def eval_step(m, grid, static, batch):
        n_eval[0] += 1
        return loop_eval(m, grid, static, batch)

    def run_eval(m, split: str):
        beta = m.perceiver.beta.detach().cpu().numpy()
        t0 = time.perf_counter()
        r = evaluate_dual_pathology(eval_step, m, dataset, split,
                                    cfg.batch_size, pathology_labels, beta)
        phase["eval"] = phase.get("eval", 0.0) + time.perf_counter() - t0
        return r

    loss_keys = ("total", "img_total", "ts_total", "fus_total")
    if cfg.aux_residual_alpha > 0.0:
        loss_keys += ("aux_residual",)
    stopper = EarlyStopper(cfg.patience, mode="max")
    tracker = BestKTracker(ckpt_dir, k=1, mode="max", prefix="best")
    history: List[dict] = []
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    cfg_dict = {"model": teacher_cfg.to_dict(), "train": cfg.to_dict(),
                "pathology_labels": list(pathology_labels)}
    best_val_outputs = None
    n_steps = 0
    phase["train"] = 0.0
    t_start = time.perf_counter()
    for epoch in range(cfg.epochs):
        acc, nb = None, 0
        t0 = time.perf_counter()
        for b in dataset.iter_batches("train", cfg.batch_size, shuffle=True,
                                      seed=cfg.seed + epoch,
                                      limit=cfg.limit_batches):
            b.pop("valid")
            out = train_step(state, dataset.grid, dataset.static,
                             engine.to_device(b, dev), gen)
            cur = torch.stack([out[k] for k in loss_keys])
            acc = cur if acc is None else acc + cur
            nb += 1
            n_steps += 1
        # one host sync per epoch
        sums = acc.tolist() if acc is not None else [0.0] * len(loss_keys)
        phase["train"] += time.perf_counter() - t0
        run = dict(zip(loss_keys, sums))
        if not np.isfinite(run["total"]):
            raise FloatingPointError(
                f"non-finite training loss at epoch {epoch} "
                f"(loss={run['total']}); aborting before the optimizer "
                "state is poisoned")
        val = run_eval(model, "val")
        val_metric = val["main_auroc"]
        improved = stopper.update(val_metric)
        if improved:
            tracker.offer(val_metric, model, state.step, cfg_dict)
            best_val_outputs = val["outputs"]
        history.append({"epoch": epoch,
                        **{f"train_{k}": v / max(nb, 1)
                           for k, v in run.items()},
                        "val_main_auroc": val_metric})
        parts = " ".join(f"{k}={run[k] / max(nb, 1):.3f}"
                         for k in loss_keys[1:])
        log(f"epoch {epoch:3d}  loss={run['total'] / max(nb, 1):.4f} "
            f"({parts})  val_AUROC={val_metric:.4f}"
            f"{'  *' if improved else ''}")
        if stopper.should_stop:
            log(f"early stop at epoch {epoch}")
            break
    elapsed = time.perf_counter() - t_start

    tracker.ensure_saved(model, state.step, cfg_dict)
    best_metric, best_path = tracker.best
    best_model, _, _ = load_teacher_from_ckpt(best_path, device=dev)
    test = run_eval(best_model, "test")
    log(f"test: main AUROC={test['main_auroc']:.4f}\n"
        + format_dual_pathology_gap_table(test))

    sps = n_steps / max(elapsed, 1e-9)
    test_metrics = {k: test[k] for k in ("main_auroc", "main_auprc",
                                         "per_label")}
    return TrainResult(
        best_metric=best_metric, best_path=best_path, history=history,
        test_metrics=test_metrics, steps_per_sec=sps,
        samples_per_sec=sps * cfg.batch_size,
        extras={"phase_seconds": phase, "n_train_steps": n_steps,
                "n_eval_steps": n_eval[0],
                "best_val_outputs": best_val_outputs,
                "evaluate": run_eval})
