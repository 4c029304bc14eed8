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
on pixels: the synthetic cohort's procedural images by default, or with a
``jpeg_store`` real chest X-rays (JAX ``teacher_loop.py:208-286``), from
the card's uint8 bank (``image_bank`` "hbm", or "auto" within
``hbm_image_budget_gb``; the step gathers and normalizes rows on the
card), else a disk memmap of uint8 rows (``u8_store_path``), else decoded
for every batch ("stream"); ``"hbm"`` encodes every unique image once into
a ``CXRFeatureBank`` on the card and gathers its rows through K2 in every
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
epochs of one call. Not ported yet: the orbax state backend (P16),
refused naming its ROADMAP item.

Multi-step dispatch (``cfg.steps_per_call`` K > 1; JAX
``teacher_loop.py:414-445, :536-577``): the residual-fusion modes and LP
mode run each group of K train batches (``stack_host_batches``; the
remainder group last) through ``engine.scan_steps``, one CUDA graph replay
per group on a card, a loop of K steps on the CPU; the history, weights,
moments and generator equal K = 1's bit for bit. In a multi-process run
the K steps are one graph over NCCL (one card per rank) and a loop of K
steps over gloo (logged; ``engine.capture_route``), and equal K = 1 bit
for bit there too. ``single`` and ``legacy`` log JAX's line and run
K = 1.

Multi-process (JAX ``teacher_loop.py:180-293, :519-617, :694-724``; ROADMAP
P18): under an initialised ``torch.distributed`` group
(``parallel/multihost.initialize_distributed``) every rank iterates the
same global batches of ``cfg.batch_size`` and trains on its own rows; the
step's losses, BatchNorm statistics and draws are the global batch's and
the gradients are summed over the ranks (``parallel/multihost.py``), so
the ranks hold the same weights. Real images and the encode-once tier are
partitioned by ``image_id % P``: each rank decodes (``HostU8Bank``, or a
``U8MemmapStore`` at ``{u8_store_path}.host{rank}``) or encodes
(``HostFeatureStore``, at ``{feature_store_path}.host{rank}``) only its
share, and no card-resident bank is built. Evaluations gather the outputs,
so every rank takes the same early-stop decision; each keeps the best
weights in memory and tests them, and only rank 0 writes checkpoints and
the full state. A SIGTERM on any rank stops all of them at the same epoch
boundary. ``n_model`` must be 1, and the gradient-flow diagnostics
(``grad_diag_every``) are single-process (ROADMAP P18b).

With ``prefetch_depth`` > 0 (2, as in JAX) the epoch's train batches come
through ``data/prefetch.py``: a worker thread runs the batch hook (the
decode, a store's reads) and copies the batch to the card from pinned
memory on a side stream while the previous step runs; the steps, their
order and their generator are those of ``prefetch_depth=0``.

Telemetry (``logger``, a ``utils/logging.Logger``; JAX
``teacher_loop.py:554-744``): the rows JAX sends to wandb, with its keys
and steps: ``train_step/*`` every ``cfg.log_every`` steps, only while a
wandb sink is live (the only per-step host sync, so the default path
has none); per epoch the train losses, the per-label validation scalars
and β (``train/*``, ``val/*``), the train-subset gap (``train_eval/*``)
and the gradient-flow diagnostics (``grad_diag/*``); at the end the test
scalars (``test/*``).
"""
from __future__ import annotations

import copy
import os
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import TeacherConfig, TrainConfig
from ..convert import load_flax, to_flax
from ..data.features import (CXRFeatureBank, HostFeatureStore,
                             encode_fn_for_teacher, features_from_batch)
from ..data.images import (HBMImageBank, HostU8Bank, JpegStore,
                           U8MemmapStore, make_jpeg_host_fn)
from ..data.pipeline import AnchorDataset, synthetic_image_device
from ..data.prefetch import prefetch, stack_host_batches
from ..data.synthetic import synthetic_image_batch
from ..models.teacher import TeacherModel, init_teacher
from ..models.vit import IMAGE_MEAN, IMAGE_STD, normalize_image
from ..parallel import mesh as meshlib
from ..parallel import multihost as mh
from ..utils import preemption, resolve_device
from ..utils.logging import Logger
from . import engine
from .checkpoint import (BestKTracker, FullStateResumer, load_checkpoint,
                         load_teacher_from_ckpt, restore_tolerant)
from .cxr_head_loop import load_cxr_head_into_teacher
from .evaluator import (evaluate_dual_pathology, evaluate_pathology,
                        format_dual_pathology_gap_table,
                        format_pathology_gap_table)
from .loops import (EarlyStopper, TrainResult, evaluate_binary_split,
                    without_valid)
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
        px -= mean          # in place: the same values as (px - mean) / std
        px /= std
        return {**batch, "pixel_values": px}

    return hook


def make_synthetic_image_source(image_size: int = 518
                                ) -> Callable[[dict], torch.Tensor]:
    """Device-side procedural image source (JAX ``teacher_loop.py:40-47``):
    a device batch's ``image_ids`` and ``y_multi`` → the normalized pixels
    of ``data/pipeline.synthetic_image_device``, JAX's procedural images,
    drawn on the batch's device. The analysis CLIs and serving's
    ``synthetic`` mode take it; the training loops take the host hook
    above."""
    def source(batch: dict) -> torch.Tensor:
        return normalize_image(synthetic_image_device(
            batch["image_ids"], batch["y_multi"], image_size))

    return source


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

# loss part → wandb key, the reference's names (JAX teacher_loop.py:85-93)
_WB_TRAIN_KEYS = {
    "img_total": "train/img_loss", "ts_total": "train/ts_loss",
    "fus_total": "train/fus_loss",
    "aux_residual": "train/aux_residual_loss",
    "reg_beta_l2": "train/lp_reg_beta_l2",
    "reg_corr_l2": "train/lp_reg_corr_l2",
    "stage2_total": "train/stage2_loss", "stage4_total": "train/stage4_loss",
    "main_loss": "train/main_loss", "aux_loss": "train/aux_loss",
}

# per-label val/train_eval/test scalars (JAX teacher_loop.py:96-100)
_WB_PER_LABEL_KEYS = (
    "img_auroc", "ts_auroc", "fus_auroc", "gap_i2f", "gap_t2f",
    "img_auprc", "ts_auprc", "fus_auprc", "beta",
    "stage2_auroc", "stage4_auroc", "stage2_auprc", "stage4_auprc",
)


def _split_scalars(prefix: str, r: dict) -> dict:
    """An evaluation's ``{prefix}/auprc`` and per-label
    ``{prefix}/{label}/{key}`` scalars, where it has them."""
    out = {}
    if "main_auprc" in r:
        out[f"{prefix}/auprc"] = r["main_auprc"]
    for row in r.get("per_label", []):
        for key in _WB_PER_LABEL_KEYS:
            if key in row:
                out[f"{prefix}/{row['name']}/{key}"] = row[key]
    return out


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


def _own_partition(dataset: AnchorDataset, all_ids: np.ndarray
                   ) -> np.ndarray:
    """This rank's ``image_id % P`` share of ``all_ids``; the dataset's
    batches are composed per partition from now on (JAX
    ``teacher_loop.py:236-239, :341-344``)."""
    P, pid = mh.process_count(), mh.process_index()
    dataset.host_partition_count = P
    return all_ids[all_ids % P == pid]


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
    step the CLS token alone. In a multi-process run each rank encodes
    only its ``image_id % P`` share into a host store (at
    ``{feature_store_path}.host{rank}``) and no bank is built (JAX
    ``teacher_loop.py:341-355``, ``kd_loop.py:116-136``). Sets
    ``dataset.batch_hook`` to the tier's hook; returns (the step's feature
    source, {"tier", "n_images", "bytes", "build_s"})."""
    all_ids, pixels_for_ids = pixels_for_ids_fn(dataset, image_hook)
    if mh.process_count() > 1:
        all_ids = _own_partition(dataset, all_ids)
        if feature_store_path:
            feature_store_path = \
                f"{feature_store_path}.host{mh.process_index()}"
    vit = model.cfg.vit
    # tokens at the loop's compute precision: bf16 storage is lossless for
    # bf16 compute, float32 loops keep float32
    out_dtype = torch.float32 if dtype == torch.float32 else torch.bfloat16
    nbytes = CXRFeatureBank.nbytes(len(all_ids), vit.n_patches, vit.d_model,
                                   out_dtype.itemsize)
    on_card = mh.process_count() == 1 and (feature_cache == "hbm" or (
        feature_cache == "auto"
        and nbytes <= hbm_feature_budget_gb * 2 ** 30))
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


def build_image_tier(dataset: AnchorDataset, jpeg_store: JpegStore,
                     side: int, feature_cache: str, image_bank: str,
                     u8_store_path: Optional[str],
                     hbm_image_budget_gb: float, device,
                     log: Callable[[str], None]) -> Tuple[Callable, Callable,
                                                          dict]:
    """The real-image feed of one process (JAX ``teacher_loop.py:208-286``):
    with an encode-once ``feature_cache`` the JPEG hook (decoded float32
    pixels) feeds the feature build and nothing else; otherwise every image
    is decoded once into the card's uint8 bank (``image_bank`` "hbm", or
    "auto" when it fits ``hbm_image_budget_gb``), else into the disk
    memmap store at ``u8_store_path``, else decoded per batch ("stream").
    In a multi-process run each rank decodes only its ``image_id % P``
    share, into host RAM (``HostU8Bank``) or the memmap store at
    ``{u8_store_path}.host{rank}``, and no card bank is built (JAX
    ``teacher_loop.py:236-253``). Returns (the batch hook, the step's image
    source, {"tier", "n_images", "bytes", "build_s"})."""
    if feature_cache != "none":
        return (make_jpeg_host_fn(jpeg_store, side),
                engine.default_image_source, {"tier": "jpeg_for_features"})
    if image_bank not in ("auto", "hbm", "stream"):
        raise ValueError(f"unknown image_bank mode {image_bank!r}")
    all_ids = np.unique(dataset.anchor["image_ids"]).astype(np.int64)
    nbytes = HBMImageBank.nbytes(len(all_ids), side)
    use_bank = image_bank == "hbm" or (
        image_bank == "auto" and nbytes <= hbm_image_budget_gb * 2 ** 30)
    t0 = time.perf_counter()
    if mh.process_count() > 1:
        own = _own_partition(dataset, all_ids)
        pid = mh.process_index()
        if u8_store_path:
            store = U8MemmapStore.build(jpeg_store, own, side,
                                        f"{u8_store_path}.host{pid}")
            hook, tier = store.host_fn(), "u8_store_partition"
        else:
            hook, tier = HostU8Bank(jpeg_store, own, side).host_fn(), \
                "host_u8_partition"
        source = engine.default_image_source
        where = (f"rank {pid}'s u8 partition ({len(own)} of "
                 f"{len(all_ids)} images)")
        all_ids = own
    elif use_bank:
        bank = HBMImageBank(jpeg_store, all_ids, side, device=device)
        hook, source, tier = bank.host_fn(), bank.image_source(), "hbm"
        where = f"u8 bank on {device}"
    elif u8_store_path:
        store = U8MemmapStore.build(jpeg_store, all_ids, side, u8_store_path)
        hook, source, tier = (store.host_fn(), engine.default_image_source,
                              "u8_store")
        where = f"disk memmap u8 store at {u8_store_path}"
    else:
        hook, source, tier = (make_jpeg_host_fn(jpeg_store, side),
                              engine.default_image_source, "stream")
        where = "decoded for every batch (no decode-once tier)"
    _sync(device)
    build_s = time.perf_counter() - t0
    log(f"[images] {where}: {len(all_ids)} images "
        f"({nbytes / 2 ** 30:.2f} GiB of u8 at {side}², {build_s:.1f}s)")
    return hook, source, {"tier": tier, "n_images": len(all_ids),
                          "bytes": nbytes, "build_s": build_s}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _train_batches(dataset: AnchorDataset, cfg: TrainConfig, epoch: int,
                   device, prefetch_depth: int, k: int = 1):
    """The epoch's shuffled train batches on ``device``, K-stacked in
    groups of ``k`` when ``k`` > 1: through the prefetch worker with
    ``prefetch_depth`` > 0, else hooked and copied inline. A generator
    either way (``close`` stops the worker)."""
    host = without_valid(dataset.iter_batches(
        "train", cfg.batch_size, shuffle=True, seed=cfg.seed + epoch,
        limit=cfg.limit_batches))
    if k > 1:
        host = stack_host_batches(host, k)
    if prefetch_depth > 0:
        return prefetch(host, device, prefetch_depth)
    return (engine.to_device(b, device) for b in host)


def train_teacher(dataset: AnchorDataset, teacher_cfg: TeacherConfig,
                  cfg: TrainConfig, ckpt_dir: str,
                  pathology_labels: Sequence[str],
                  model: Optional[TeacherModel] = None,
                  device="cuda",
                  image_hook: Optional[Callable[[dict], dict]] = None,
                  feature_cache: str = "none",
                  hbm_feature_budget_gb: float = 8.0,
                  feature_store_path: Optional[str] = None,
                  jpeg_store: Optional[JpegStore] = None,
                  prefetch_depth: int = 2, image_bank: str = "auto",
                  u8_store_path: Optional[str] = None,
                  hbm_image_budget_gb: float = 8.0,
                  pretrained_head_ckpt: Optional[str] = None,
                  auto_resume: bool = False,
                  save_full_state: Optional[bool] = None,
                  state_backend: str = "msgpack",
                  stop_after_epochs: Optional[int] = None,
                  lp_from: Optional[str] = None, lp_beta_l2: float = 1e-3,
                  lp_corr_l2: float = 1e-2,
                  grad_diag_every: int = 0, grad_diag_batches: int = 4,
                  log: Optional[Callable[[str], None]] = None,
                  logger: Optional[Logger] = None) -> TrainResult:
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
    ``jpeg_store``: real chest X-rays (``data/images.py``) in place of
    ``image_hook``, fed through ``build_image_tier`` (``image_bank``
    "auto", "hbm" or "stream"; ``u8_store_path``; ``hbm_image_budget_gb``).
    ``prefetch_depth``: train batches in flight in the prefetch worker (0:
    the hook and the copy run inline).
    ``pretrained_head_ckpt`` (``dual``): the CXR linear head's checkpoint,
    written by either package's CXR-head stage; a given ``model`` must
    match ``pretrained_head_spec``.
    ``auto_resume``: continue from the full train state in ``ckpt_dir``,
    if there is one; ``save_full_state`` (default: ``auto_resume``) saves
    it at every epoch boundary; ``stop_after_epochs`` ends this call after
    that many epochs (the schedule still spans ``cfg.epochs``).
    ``lp_from``: LP mode from this checkpoint (a ``dual_patch`` or
    ``dual_patch_event`` teacher's), with the L2 weights ``lp_beta_l2`` of
    β and ``lp_corr_l2`` of the scaled correction.
    ``grad_diag_every``: every that many epochs, in the two patch modes,
    the read-only gradient-flow diagnostics
    (``analysis/grad_flow_diagnostics.run_diagnostics``) over
    ``grad_diag_batches`` val batches, on the pixels of the run's image
    feed (JAX ``teacher_loop.py:677-690``): the report is printed and its
    scalars go into the epoch's history entry.
    ``log``: the console lines (default: ``logger.info``, else ``print``);
    ``logger``: the telemetry sink (module docstring)."""
    world = mh.check_group()
    multi = world > 1
    scan_k = engine.steps_per_call(cfg.steps_per_call)
    if multi:
        meshlib.create_mesh(cfg.n_data, cfg.n_model)
        if grad_diag_every > 0:
            raise NotImplementedError(
                "grad_diag_every > 0: the gradient-flow diagnostics of a "
                "multi-process run are not ported yet (ROADMAP P18b)")
    mode = teacher_cfg.perceiver_type
    lp_mode = lp_from is not None
    if log is None:
        log = logger.info if logger is not None else print
    metrics = logger.metrics if logger is not None else \
        (lambda data, step=None: None)
    # per-step scalars only with a live sink: float() is a host sync
    step_log = cfg.log_every > 0 \
        and getattr(logger, "_wb", None) is not None
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
    dev = mh.rank_device(resolve_device(device))
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
    log(f"params: {param_count(model):,}  mode={mode}  lp={lp_mode}  "
        f"device={dev}")

    phase = {}
    image_source = engine.default_image_source
    image_tier = {"tier": "synthetic"}
    if jpeg_store is not None:
        image_hook, image_source, image_tier = build_image_tier(
            dataset, jpeg_store, teacher_cfg.vit.image_size, feature_cache,
            image_bank, u8_store_path, hbm_image_budget_gb, dev, log)
        if "build_s" in image_tier:
            phase["image_build"] = image_tier["build_s"]
    image_hook = image_hook or make_synthetic_pixel_hook(
        teacher_cfg.vit.image_size)
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
    if scan_k > 1 and not uses_dual:
        log(f"steps_per_call={scan_k} is wired for the dual modes only; "
            "falling back to single-step dispatch")
        scan_k = 1
    if uses_dual:
        train_step = engine.make_teacher_step(
            cfg, teacher_cfg.duett, T, lw, None, dtype,
            image_source=image_source, feature_source=feature_source,
            lp_mode=lp_mode, lp_beta_l2=lp_beta_l2, lp_corr_l2=lp_corr_l2)
        loop_eval = engine.make_teacher_eval(T, dtype,
                                             image_source=image_source,
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
            image_source=image_source, feature_source=feature_source)
        loop_eval = engine.make_teacher_eval(
            T, dtype, image_source=image_source,
            feature_source=feature_source, keys=engine.PATHOLOGY_EVAL_KEYS)
        loss_keys = ("total", "stage2_total", "stage4_total")
    else:
        train_step = engine.make_teacher_legacy_step(
            cfg, teacher_cfg.duett, T, dtype,
            aux_alpha=cfg.aux_cxr_alpha if cfg.use_aux_cxr else 0.0,
            image_source=image_source)
        loop_eval = engine.make_teacher_eval(T, dtype,
                                             image_source=image_source,
                                             keys=None)
        loss_keys = ("loss", "main_loss", "aux_loss")
    # K steps per call (engine.scan_steps): one CUDA graph replay a call on
    # a card; the same steps as K = 1, bit for bit
    if scan_k > 1:
        train_step = engine.scan_steps(
            train_step, scan_k, log, engine.capture_route(dev, scan_k, log))
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
    best_state = None   # multi-process: every rank keeps the best in memory
    history, start_epoch, n_steps = [], 0, 0
    if auto_resume:
        meta = resumer.restore(state)
        if meta is not None:
            start_epoch, history, n_steps = resumer.apply_meta(
                meta, stopper, tracker, gen)
            if multi and tracker.best is not None:
                # the best so far, from the run directory every rank reads
                best_state = load_teacher_from_ckpt(tracker.best[1], device=dev)[0].state_dict()
            log(f"[resume:{state_backend}] restored epoch {meta['epoch']} "
                f"from {ckpt_dir}; continuing at epoch {start_epoch}")
    resumed_steps = n_steps
    phase["train"] = 0.0
    saves = []
    t_start = time.perf_counter()
    for epoch in range(start_epoch, cfg.epochs):
        acc, nb = None, 0
        t0 = time.perf_counter()
        batches = _train_batches(dataset, cfg, epoch, dev, prefetch_depth,
                                 scan_k)
        try:
            for dev_batch in batches:
                out = train_step(state, dataset.grid, dataset.static,
                                 dev_batch, gen)
                first = n_steps == resumed_steps
                # step by step, in step order, whatever K (JAX :564-577)
                for cur in engine.step_rows(out, loss_keys):
                    acc = cur if acc is None else acc + cur
                    nb += 1
                    n_steps += 1
                    if step_log and n_steps % cfg.log_every == 0:
                        metrics({f"train_step/{k}": float(v)
                                 for k, v in zip(loss_keys, cur)}, n_steps)
                if first:
                    _sync(dev)
                    log(f"step {n_steps} done "
                        f"({time.perf_counter() - t0:.2f}s after the epoch "
                        "began)")
        finally:
            batches.close()
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
            if multi:
                best_state = {k: v.detach().clone()
                              for k, v in model.state_dict().items()}
            if mh.is_main_process():
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
        # the epoch's row at the reference's depth (JAX
        # teacher_loop.py:631-654)
        wb = {"train/loss": total / max(nb, 1), "train/epoch": epoch,
              "val/auroc": val_metric, "val/main_auroc": val_metric}
        for k in loss_keys[1:]:
            wb[_WB_TRAIN_KEYS.get(k, f"train/{k}")] = run[k] / max(nb, 1)
        wb.update(_split_scalars("val", val))
        if lp_mode:
            # LP's β telemetry (JAX teacher_loop.py:648-651), also kept in
            # the history
            babs = model.perceiver.beta.detach().abs()
            history[-1]["lp_beta_mean_abs"] = float(babs.mean())
            history[-1]["lp_beta_max_abs"] = float(babs.max())
            wb["train/lp_beta_mean_abs"] = history[-1]["lp_beta_mean_abs"]
            wb["train/lp_beta_max_abs"] = history[-1]["lp_beta_max_abs"]
            log(f"[LP] |beta| mean {history[-1]['lp_beta_mean_abs']:.4f} "
                f"max {history[-1]['lp_beta_max_abs']:.4f}")
        if improved:
            wb["val/best_auroc"] = stopper.best
        metrics(wb, epoch)
        if cfg.eval_train_batches > 0:
            # train-vs-val overfit reading (JAX teacher_loop.py:656-675)
            tr = run_eval(model, "train", limit=cfg.eval_train_batches)
            history[-1]["train_eval_main_auroc"] = tr["main_auroc"]
            history[-1]["train_eval_main_gap_over_val"] = \
                tr["main_auroc"] - val_metric
            log("train-subset gap table:\n" + tr["table"])
            metrics({"train_eval/auroc": tr["main_auroc"],
                     "train_eval/epoch": epoch,
                     "train_eval/main_gap_over_val":
                         tr["main_auroc"] - val_metric,
                     **_split_scalars("train_eval", tr)}, epoch)
        if grad_diag_every > 0 and (epoch + 1) % grad_diag_every == 0 \
                and mode in LP_MODES:
            # the diagnostics' scalars go to the history and the logger
            # (JAX teacher_loop.py:677-690)
            from ..analysis.grad_flow_diagnostics import (
                diagnostics_to_log_dict, format_report, run_diagnostics)
            t0 = time.perf_counter()
            diag = run_diagnostics(
                model, dataset, image_source, "val", cfg.batch_size,
                grad_diag_batches,
                alphas=(cfg.alpha_img, cfg.alpha_ts, cfg.alpha_fus),
                label_weights=lw, label_names=list(pathology_labels),
                image_hook=image_hook)
            phase["grad_diag"] = phase.get("grad_diag", 0.0) \
                + time.perf_counter() - t0
            log("grad-flow diagnostics:\n" + format_report(diag))
            diag_row = diagnostics_to_log_dict(
                diag, labels=list(pathology_labels))
            history[-1].update(diag_row)
            metrics(diag_row, epoch)
        # agreed over the ranks: a SIGTERM may reach only some of them
        preempted = mh.any_flag(preemption.requested())
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

    if mh.is_main_process():
        tracker.ensure_saved(model, state.step, cfg_dict)
        best_metric, best_path = tracker.best
    else:
        best_metric = stopper.best if stopper.best is not None \
            else float("nan")
        best_path = ""
    if multi:
        # the best weights from memory: ranks need not share rank 0's disk
        best_model = copy.deepcopy(model)
        if best_state is not None:
            best_model.load_state_dict(best_state)
    else:
        best_model, _, _ = load_teacher_from_ckpt(best_path, device=dev)
    test = run_eval(best_model, "test")
    mh.barrier()    # rank 0's files are complete before any rank returns
    log(f"test: main AUROC={test['main_auroc']:.4f}\n" + test["table"])
    metrics({"test/auroc": test["main_auroc"],
             **_split_scalars("test", test)})

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
                "feature_tier": tier, "image_tier": image_tier,
                "n_eval_steps": n_eval[0],
                "best_val_outputs": best_val_outputs,
                "evaluate": run_eval, "state": state, "generator": gen})
