"""Teacher training loop, every mode and LP mode: the port's counterpart
of ``multimodal_edema_prediction_tpu/train/teacher_loop.py::train_teacher``
(reference ``training_duett/trainer.py:216-764``).

Per epoch: shuffled train batches through the mode's step (loss sums stay
on the device; one host sync per epoch), a finite-loss guard, the
validation metric, early stopping and the best checkpoint (JAX format),
and with ``cfg.eval_train_batches`` > 0 a train-subset evaluation and its
gap table; at the end the test split is evaluated from the best
checkpoint, reloaded through ``load_teacher_from_ckpt``. The modes (JAX
``teacher_loop.py:414-501``): ``dual_patch``, ``dual_patch_event`` and
``dual`` train on the 3-branch loss (``engine.make_teacher_step``) and
select on the macro fusion AUROC; ``single`` on stage 2 + stage 4
(``make_teacher_pathology_step``) and the macro stage 4 AUROC; ``legacy``
on the binary label (``make_teacher_legacy_step``, pixels only) and its
AUROC.

Image tiers: ``feature_cache="none"`` runs the frozen ViT inside every step
on pixels; ``"hbm"`` encodes every unique image once into a
``CXRFeatureBank`` on the card and gathers its rows through K2 in every
train and eval step; ``"host"`` keeps the same tokens in a
``HostFeatureStore`` (RAM, or a reusable disk memmap at
``feature_store_path``) whose batch hook attaches each batch's rows, so no
kernel runs for them in the step; ``"auto"`` takes the bank when it fits
``hbm_feature_budget_gb``, else the host store. With ``freeze_cxr=False``
the ViT trains inside every step on pixels (its attention's gradient
through K1's backward kernels), so only ``feature_cache="none"`` is legal,
as it is for ``legacy``.

``dual`` takes the frozen CXR linear head of ``pretrained_head_ckpt``
(``train/cxr_head_loop.py``) as its image branch: the head's labels are
mapped onto the pathology order (``static_keep_idx``), its weights loaded
and left out of the optimizer, and both facts written into the
checkpoint's config sidecar. Its cached tiers hand the step the CLS token
alone (one K2 gather a step on ``hbm``).

LP mode (``lp_from``, JAX ``teacher_loop.py:81-107, :287-306``): the
correction-only linear probe of a ``dual_patch`` or ``dual_patch_event``
checkpoint, loaded into the model (``restore_tolerant``); only the
correction head and β train, the step runs in eval mode and adds the β
and correction L2 terms, and each epoch records |β|.

Full-state resume and preemption (JAX ``teacher_loop.py:400-413,
:692-710``): with ``save_full_state`` the train state (weights, AdamW
moments, step count, the step generator and the loop's bookkeeping) is
saved at every epoch boundary, and ``auto_resume`` continues from it bit
for bit; a SIGTERM (``utils/preemption.py``) saves it at the next boundary
and ends the call cleanly; ``stop_after_epochs`` pauses after that many
epochs of one call. Single process only. Not ported yet, each named by its
ROADMAP item: the orbax state backend (P16), multi-process (P18).
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import TeacherConfig, TrainConfig
from ..convert import load_flax, to_flax
from ..data.features import (CXRFeatureBank, HostFeatureStore,
                             encode_fn_for_teacher, features_from_batch)
from ..data.pipeline import AnchorDataset
from ..data.synthetic import synthetic_image_batch
from ..models.teacher import TeacherModel, init_teacher
from ..models.vit import IMAGE_MEAN, IMAGE_STD
from ..utils import preemption, resolve_device
from . import engine
from .checkpoint import (BestKTracker, FullStateResumer, load_checkpoint,
                         load_teacher_from_ckpt, restore_tolerant)
from .cxr_head_loop import load_cxr_head_into_teacher
from .evaluator import (evaluate_dual_pathology, evaluate_pathology,
                        format_dual_pathology_gap_table,
                        format_pathology_gap_table)
from .loops import EarlyStopper, TrainResult, evaluate_binary_split
from .optim import MultiGroupAdamW, default_label_fn
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
    if cfg.perceiver_type == "dual":
        frozen.append("pretrained_cxr_head/")
    return tuple(frozen)


# the residual-fusion modes: the 3-branch loss, the fusion AUROC, LP mode
DUAL_MODES = ("dual_patch", "dual_patch_event", "dual")
LP_MODES = ("dual_patch", "dual_patch_event")
LP_TRAINABLE = ("perceiver/correction_head", "perceiver/beta")


def lp_frozen_label_fn(path: str) -> str:
    """LP mode's optimizer groups (JAX ``teacher_loop.py:103-107``,
    reference trainer.py:194-202): only the correction head and β train."""
    if any(path.startswith(p) for p in LP_TRAINABLE):
        return "correction"
    return "frozen"


def load_lp_start(model: TeacherModel, lp_from: str,
                  log: Callable[[str], None]) -> None:
    """LP mode's start (JAX ``teacher_loop.py:301-306``): the checkpoint's
    weights and BatchNorm statistics into ``model`` through
    ``restore_tolerant`` (leaves it lacks keep the model's; any shape
    mismatch raises)."""
    ckpt = load_checkpoint(lp_from)
    params, stats = to_flax(model)
    params, changed = restore_tolerant(params, ckpt["params"], ())
    stats, _ = restore_tolerant(stats, ckpt["batch_stats"], ())
    load_flax(model, params, stats)
    log(f"[LP] loaded {lp_from} (metric={ckpt['metric']:.4f}); "
        f"{len(changed)} keys adjusted")


def pretrained_head_spec(cfg: TeacherConfig,
                         pretrained_head_ckpt: Optional[str],
                         pathology_labels: Sequence[str]) -> dict:
    """``TeacherModel``'s ``n_pretrained_labels`` and ``static_keep_idx``
    for a ``dual`` teacher (JAX ``teacher_loop.py:188-197``): the head
    checkpoint's width and, for each pathology label, its column there;
    without a checkpoint, one column per pathology label in order. {} for
    the other modes."""
    if cfg.perceiver_type != "dual":
        return {}
    if not pretrained_head_ckpt:
        return {"n_pretrained_labels": len(pathology_labels),
                "static_keep_idx": None}
    labels = list(load_checkpoint(pretrained_head_ckpt)["config"]
                  ["label_cols"])
    missing = [lab for lab in pathology_labels if lab not in labels]
    if missing:
        raise ValueError(f"pretrained CXR head missing labels: {missing}; "
                         f"has {labels}")
    return {"n_pretrained_labels": len(labels),
            "static_keep_idx": tuple(labels.index(lab)
                                     for lab in pathology_labels)}


def pixels_for_ids_fn(dataset: AnchorDataset, image_hook
                      ) -> Tuple[np.ndarray, Callable]:
    """(the dataset's sorted unique image ids, ``pixels_for_ids``): each
    id's pixels come from the image hook with the labels of its first
    anchor (JAX ``teacher_loop.py:322-335``, ``kd_loop.py:89-110``)."""
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

    return all_ids, pixels_for_ids


def build_feature_tier(model, dataset: AnchorDataset, image_hook, dtype,
                       feature_cache: str, hbm_feature_budget_gb: float,
                       feature_store_path: Optional[str], device,
                       log: Callable[[str], None]) -> Tuple[Callable, dict]:
    """The encode-once tier of a frozen ViT (``feature_cache`` "hbm",
    "host" or "auto"; JAX ``teacher_loop.py:315-377``): every unique image
    of the dataset encoded once through ``model``'s ViT, into a bank on the
    card ("hbm", or "auto" within ``hbm_feature_budget_gb``) or a host
    store (otherwise; a disk memmap at ``feature_store_path``, reopened
    when its fingerprint matches). A ``dual`` teacher's tier hands the
    step the CLS token alone. Sets ``dataset.batch_hook`` to the tier's
    hook; returns (the step's feature source, {"tier", "n_images",
    "bytes", "build_s"})."""
    all_ids, pixels_for_ids = pixels_for_ids_fn(dataset, image_hook)
    vit = model.cfg.vit
    # tokens at the loop's compute precision: bf16 storage is lossless for
    # bf16 compute, float32 loops keep float32
    out_dtype = torch.float32 if dtype == torch.float32 else torch.bfloat16
    nbytes = CXRFeatureBank.nbytes(len(all_ids), vit.n_patches, vit.d_model,
                                   out_dtype.itemsize)
    on_card = feature_cache == "hbm" or (
        feature_cache == "auto" and nbytes <= hbm_feature_budget_gb * 2 ** 30)
    encode = encode_fn_for_teacher(model, dtype)
    cls_only = model.cfg.perceiver_type == "dual"
    t0 = time.perf_counter()
    if on_card:
        bank = CXRFeatureBank.build(encode, pixels_for_ids, all_ids,
                                    out_dtype=out_dtype)
        dataset.batch_hook = bank.host_fn()
        source, tier = bank.feature_source(cls_only=cls_only), "hbm"
        where = f"token bank on {device}"
    else:
        store = HostFeatureStore.build(encode, pixels_for_ids, all_ids,
                                       path=feature_store_path,
                                       out_dtype=out_dtype)
        dataset.batch_hook = store.host_fn(cls_only=cls_only)
        source, tier = features_from_batch, "host"
        where = (f"disk memmap token store at {feature_store_path}"
                 if feature_store_path else "host-RAM token store")
    _sync(device)
    build_s = time.perf_counter() - t0
    log(f"[features] encode-once {where}: {len(all_ids)} images "
        f"({nbytes / 2 ** 30:.2f} GiB, {build_s:.1f}s build)")
    return source, {"tier": tier, "n_images": len(all_ids), "bytes": nbytes,
                    "build_s": build_s}


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
                  feature_store_path: Optional[str] = None,
                  pretrained_head_ckpt: Optional[str] = None,
                  auto_resume: bool = False,
                  save_full_state: Optional[bool] = None,
                  state_backend: str = "msgpack",
                  stop_after_epochs: Optional[int] = None,
                  lp_from: Optional[str] = None, lp_beta_l2: float = 1e-3,
                  lp_corr_l2: float = 1e-2,
                  log: Callable[[str], None] = print) -> TrainResult:
    """Train the teacher; returns the best val metric of its mode (macro
    fusion AUROC, macro stage 4 AUROC for ``single``, AUROC for
    ``legacy``), its checkpoint, the per-epoch history and the test
    metrics.

    ``model``: the initial weights (default: ``init_teacher`` from
    ``cfg.seed``), e.g. with a loaded RAD-DINO ViT
    (``models/vit.py::load_vit_params``); it is moved to ``device`` and
    trained in place.
    ``image_hook``: host batch hook that attaches ``pixel_values`` (default:
    the synthetic cohort's procedural images); the pixel tier runs it on
    every batch, the encode-once tier once per unique image.
    ``feature_store_path``: where the host tier keeps its disk store (RAM
    when None).
    ``pretrained_head_ckpt`` (``dual``): the CXR linear head's checkpoint,
    written by either package's CXR-head stage; a given ``model`` must
    match ``pretrained_head_spec``.
    ``auto_resume``: continue from the full train state in ``ckpt_dir``,
    if there is one; ``save_full_state`` (default: ``auto_resume``) saves
    it at every epoch boundary; ``stop_after_epochs`` ends this call after
    that many epochs (the schedule still spans ``cfg.epochs``).
    ``lp_from``: LP mode from this checkpoint (a ``dual_patch`` or
    ``dual_patch_event`` teacher's), with the L2 weights ``lp_beta_l2`` of
    β and ``lp_corr_l2`` of the scaled correction."""
    mode = teacher_cfg.perceiver_type
    lp_mode = lp_from is not None
    if feature_cache not in ("none", "auto", "hbm", "host"):
        raise ValueError(f"unknown feature_cache mode {feature_cache!r}")
    if feature_cache != "none" and not teacher_cfg.freeze_cxr:
        raise ValueError(
            "feature_cache requires freeze_cxr=True: cached ViT tokens are "
            "constants, so a trainable CXR branch would never update")
    if feature_cache != "none" and mode == "legacy":
        raise ValueError("feature_cache is not supported for the "
                         "deprecated 'legacy' perceiver mode")
    if lp_mode and mode not in LP_MODES:
        # JAX fails here too (no β to regularize, or nothing to train)
        raise ValueError(f"LP mode trains the correction head and beta of a "
                         f"{' or '.join(LP_MODES)} teacher, not {mode!r}")
    if save_full_state is None:
        save_full_state = auto_resume
    resumer = FullStateResumer(ckpt_dir, state_backend)
    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    head = pretrained_head_spec(teacher_cfg, pretrained_head_ckpt,
                                pathology_labels)
    if model is None:
        model = init_teacher(teacher_cfg, cfg.seed, **head)
    elif head and (model.static_keep_idx != head["static_keep_idx"] or
                   model.pretrained_cxr_head.linear.weight.shape[0]
                   != head["n_pretrained_labels"]):
        raise ValueError(f"the given dual teacher does not fit its head "
                         f"checkpoint: {head}")
    if pretrained_head_ckpt and head:
        load_cxr_head_into_teacher(pretrained_head_ckpt, model)
        log(f"[dual] pretrained head {pretrained_head_ckpt}: "
            f"keep_idx={head['static_keep_idx']}")
    if lp_mode:
        load_lp_start(model, lp_from, log)
    model = model.to(dev)
    dataset.to(dev)
    T = dataset.n_timesteps
    lw = np.ones(len(pathology_labels), np.float32)  # trainer.py:390-391
    image_hook = image_hook or make_synthetic_pixel_hook(
        teacher_cfg.vit.image_size)
    log(f"params: {param_count(model):,}  mode={mode}  lp={lp_mode}  "
        f"device={dev}")

    phase = {}
    feature_source, tier = None, {"tier": "pixels"}
    dataset.batch_hook = image_hook
    if feature_cache != "none":
        feature_source, tier = build_feature_tier(
            model, dataset, image_hook, dtype, feature_cache,
            hbm_feature_budget_gb, feature_store_path, dev, log)
        phase["feature_build"] = tier["build_s"]

    steps_per_epoch = dataset.split_size("train") // cfg.batch_size
    if cfg.limit_batches > 0:
        steps_per_epoch = min(steps_per_epoch, cfg.limit_batches)
    total_steps = max(steps_per_epoch * cfg.epochs, 1)
    state = TrainState(model, MultiGroupAdamW(
        model, cfg.optim, total_steps,
        frozen_prefixes=() if lp_mode
        else teacher_frozen_prefixes(teacher_cfg),
        label_fn=lp_frozen_label_fn if lp_mode else default_label_fn))
    uses_dual = mode in DUAL_MODES
    if uses_dual:
        train_step = engine.make_teacher_step(
            cfg, teacher_cfg.duett, T, lw, None, dtype,
            feature_source=feature_source, lp_mode=lp_mode,
            lp_beta_l2=lp_beta_l2, lp_corr_l2=lp_corr_l2)
        loop_eval = engine.make_teacher_eval(T, dtype,
                                             feature_source=feature_source)
        loss_keys = ("total", "img_total", "ts_total", "fus_total")
        if cfg.aux_residual_alpha > 0.0:
            loss_keys += ("aux_residual",)
        if lp_mode:
            loss_keys += ("reg_beta_l2", "reg_corr_l2")
    elif mode == "single":
        train_step = engine.make_teacher_pathology_step(
            cfg, teacher_cfg.duett, T, lw, None, dtype,
            alpha_stage2=cfg.aux_stage2_alpha,
            alpha_stage4=cfg.aux_stage4_alpha,
            feature_source=feature_source)
        loop_eval = engine.make_teacher_eval(
            T, dtype, feature_source=feature_source,
            keys=engine.PATHOLOGY_EVAL_KEYS)
        loss_keys = ("total", "stage2_total", "stage4_total")
    else:
        train_step = engine.make_teacher_legacy_step(
            cfg, teacher_cfg.duett, T, dtype,
            aux_alpha=cfg.aux_cxr_alpha if cfg.use_aux_cxr else 0.0)
        loop_eval = engine.make_teacher_eval(T, dtype, keys=None)
        loss_keys = ("loss", "main_loss", "aux_loss")
    n_eval = [0]

    def eval_step(m, grid, static, batch):
        n_eval[0] += 1
        return loop_eval(m, grid, static, batch)

    def run_eval(m, split: str, limit: int = 0) -> dict:
        """The mode's evaluation (JAX ``teacher_loop.py:483-501``); its
        main metric is under ``main_auroc`` and its gap table under
        ``table``."""
        t0 = time.perf_counter()
        if uses_dual:
            # 'dual' fuses additively, with no beta
            beta = getattr(m.perceiver, "beta", None)
            r = evaluate_dual_pathology(
                eval_step, m, dataset, split, cfg.batch_size,
                pathology_labels,
                None if beta is None else beta.detach().cpu().numpy(),
                limit=limit)
            r["table"] = format_dual_pathology_gap_table(r)
        elif mode == "single":
            r = evaluate_pathology(eval_step, m, dataset, split,
                                   cfg.batch_size, pathology_labels,
                                   limit=limit)
            r["table"] = format_pathology_gap_table(r)
        else:
            r = evaluate_binary_split(eval_step, m, dataset, split,
                                      cfg.batch_size, limit=limit,
                                      keep_logits=True)
            r = {**r, "main_auroc": r["auroc"], "outputs": {
                "main": r.pop("logits")}}
            r["table"] = "binary: " + ", ".join(
                f"{k}={v:.4f}" for k, v in r.items()
                if isinstance(v, float))
        phase["eval"] = phase.get("eval", 0.0) + time.perf_counter() - t0
        return r

    stopper = EarlyStopper(cfg.patience, mode="max")
    tracker = BestKTracker(ckpt_dir, k=1, mode="max", prefix="best")
    # the step generator: dropout and augmentation; saved with the state
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    cfg_dict = {"model": teacher_cfg.to_dict(), "train": cfg.to_dict(),
                "pathology_labels": list(pathology_labels)}
    if head:
        # not recoverable from the weights (JAX teacher_loop.py:513-518)
        cfg_dict["n_pretrained_labels"] = head["n_pretrained_labels"]
        if head["static_keep_idx"] is not None:
            cfg_dict["static_keep_idx"] = list(head["static_keep_idx"])
    best_val_outputs = None
    history, start_epoch, n_steps = [], 0, 0
    if auto_resume:
        meta = resumer.restore(state)
        if meta is not None:
            start_epoch, history, n_steps = resumer.apply_meta(
                meta, stopper, tracker, gen)
            log(f"[resume:{state_backend}] restored epoch {meta['epoch']} "
                f"from {ckpt_dir}; continuing at epoch {start_epoch}")
    resumed_steps = n_steps
    phase["train"] = 0.0
    saves = []
    t_start = time.perf_counter()
    for epoch in range(start_epoch, cfg.epochs):
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
            if n_steps == resumed_steps + 1:
                _sync(dev)
                log(f"step {n_steps} done ({time.perf_counter() - t0:.2f}s "
                    "after the epoch began)")
        # one host sync per epoch
        sums = acc.tolist() if acc is not None else [0.0] * len(loss_keys)
        phase["train"] += time.perf_counter() - t0
        run = dict(zip(loss_keys, sums))
        total = run[loss_keys[0]]
        if not np.isfinite(total):
            raise FloatingPointError(
                f"non-finite training loss at epoch {epoch} "
                f"(loss={total}); aborting before the optimizer "
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
        log(f"epoch {epoch:3d}  loss={total / max(nb, 1):.4f} "
            f"({parts})  val_AUROC={val_metric:.4f}"
            f"{'  *' if improved else ''}")
        if lp_mode:
            # LP's β telemetry (JAX teacher_loop.py:648-651; its wandb
            # scalars are history keys here)
            babs = model.perceiver.beta.detach().abs()
            history[-1]["lp_beta_mean_abs"] = float(babs.mean())
            history[-1]["lp_beta_max_abs"] = float(babs.max())
            log(f"[LP] |beta| mean {history[-1]['lp_beta_mean_abs']:.4f} "
                f"max {history[-1]['lp_beta_max_abs']:.4f}")
        if cfg.eval_train_batches > 0:
            # train-vs-val overfit reading (JAX teacher_loop.py:656-675;
            # its wandb scalars are history keys here)
            tr = run_eval(model, "train", limit=cfg.eval_train_batches)
            history[-1]["train_eval_main_auroc"] = tr["main_auroc"]
            history[-1]["train_eval_main_gap_over_val"] = \
                tr["main_auroc"] - val_metric
            log("train-subset gap table:\n" + tr["table"])
        preempted = preemption.requested()
        if save_full_state or preempted:
            t0 = time.perf_counter()
            resumer.save(state, epoch, stopper, tracker, history, n_steps,
                         gen)
            saves.append(time.perf_counter() - t0)
        if preempted:
            log(f"SIGTERM/preemption at epoch {epoch}: state saved; resume "
                "with auto_resume / --resume_dir")
            break
        if stopper.should_stop:
            log(f"early stop at epoch {epoch}")
            break
        if stop_after_epochs is not None \
                and epoch + 1 - start_epoch >= stop_after_epochs:
            log(f"pausing after {stop_after_epochs} epochs of this call "
                "(resume with auto_resume)")
            break
    elapsed = time.perf_counter() - t_start

    tracker.ensure_saved(model, state.step, cfg_dict)
    best_metric, best_path = tracker.best
    best_model, _, _ = load_teacher_from_ckpt(best_path, device=dev)
    test = run_eval(best_model, "test")
    log(f"test: main AUROC={test['main_auroc']:.4f}\n" + test["table"])

    ran = n_steps - resumed_steps
    sps = ran / max(elapsed, 1e-9)
    test_metrics = {k: test[k] for k in ("main_auroc", "main_auprc",
                                         "per_label", "auprc") if k in test}
    return TrainResult(
        best_metric=best_metric, best_path=best_path, history=history,
        test_metrics=test_metrics, steps_per_sec=sps,
        samples_per_sec=sps * cfg.batch_size,
        extras={"phase_seconds": phase, "n_train_steps": ran,
                "start_epoch": start_epoch, "state_save_s": saves,
                "state_bytes": (os.path.getsize(resumer.state_path)
                                if saves else 0),
                "feature_tier": tier,
                "n_eval_steps": n_eval[0],
                "best_val_outputs": best_val_outputs,
                "evaluate": run_eval})
