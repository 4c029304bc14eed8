"""CXR linear-head training on the full image catalog: the port's
counterpart of ``multimodal_edema_prediction_tpu/train/cxr_head_loop.py``
(reference ``cxr_linear_training.ipynb``).

The frozen ViT's CLS token is extracted once for every catalog image (K1's
forward, once per ViT layer and chunk of ``batch_size``; a ``.npz`` cache
under the key ``cls``, the JAX package's layout); the head (dropout, then
``linear``) trains full-batch or mini-batch on the card with the masked
per-label BCE summed over labels and AdamW (``optax.adamw(lr,
weight_decay)``); the best val macro AUROC picks its weights. The
checkpoint is the JAX package's format with the sidecar ``{"label_cols",
"num_classes", "kind": "cxr_linear_head"}``, the artifact a ``dual``
teacher loads into its ``pretrained_cxr_head``
(``load_cxr_head_into_teacher``). With a ``jpeg_store`` the sweep reads
real chest X-rays: decoded per chunk on a host thread, or with
``u8_store_path`` decoded once into a disk memmap of uint8 rows
(``data/images.py::U8MemmapStore``) whose chunks are normalized on the
card.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..convert import load_flax
from ..data.images import JpegStore, U8MemmapStore, decode_batch
from ..data.pipeline import train_test_split
from ..models.cxr_head import CXRLinearHead
from ..models.layers import init_like_flax
from ..ops import metrics as M
from ..ops.losses import masked_per_label_bce
from ..utils import resolve_device
from .checkpoint import load_checkpoint, save_checkpoint
from .engine import default_image_source, to_device
from .loops import refuse_multi_process
from .optim import MultiGroupAdamW


def apply_uncertain_policy(labels: np.ndarray, policy: str) -> np.ndarray:
    """The CheXpert uncertain label (-1): ``to_positive`` maps it to 1 (the
    CXR-head level, reference cxr_db.ipynb cell 24), ``to_zero`` to 0 (the
    ICU anchor's main label, data_processing.py:170), ``keep`` leaves it;
    NaN stays NaN (JAX ``data/cxr_catalog.py:34-52``)."""
    lab = np.asarray(labels, np.float32).copy()
    if policy == "to_positive":
        lab[lab == -1.0] = 1.0
    elif policy == "to_zero":
        lab[lab == -1.0] = 0.0
    elif policy != "keep":
        raise ValueError(f"unknown uncertain policy {policy!r}")
    return lab


def split_catalog_subjects(subject_ids: np.ndarray, labels: np.ndarray,
                           seed: int = 42) -> dict:
    """Subject-level 70/15/15 over the labeled catalog rows, the split every
    later stage aligns to (reference data_processing.py:234-243): subjects
    in order of first appearance, split as sklearn's ``train_test_split``
    splits them. {"train", "val", "test"} → row indices."""
    has = ~np.isnan(labels).all(axis=1)
    subj = subject_ids[has]
    _, first = np.unique(subj, return_index=True)
    subj_all = subj[np.sort(first)]
    tr, tmp = train_test_split(subj_all, test_size=0.30, random_state=seed)
    va, te = train_test_split(tmp, test_size=0.50, random_state=seed)
    idx = np.arange(len(subject_ids))
    return {"train": idx[has & np.isin(subject_ids, tr)],
            "val": idx[has & np.isin(subject_ids, va)],
            "test": idx[has & np.isin(subject_ids, te)]}


def extract_cls_features(vit, image_hook: Optional[Callable[[dict], dict]],
                         image_ids: np.ndarray, labels: np.ndarray,
                         batch_size: int = 64,
                         cache_path: Optional[str] = None,
                         jpeg_store: Optional[JpegStore] = None,
                         u8_store_path: Optional[str] = None) -> np.ndarray:
    """The frozen ViT's CLS token [N, D] (float32, host) for every image of
    ``image_ids``, in chunks of ``batch_size`` in eval mode on the ViT's
    device, in float32 (as the JAX package runs it). Pixels come from
    ``image_hook`` (a batch of ``image_ids`` and ``y_multi``, the labels
    with NaN as 0, → ``pixel_values``), or with ``jpeg_store`` from real
    JPEGs (JAX ``cxr_head_loop.py:48-107``): decoded per chunk
    (``pixel_values``), or with ``u8_store_path`` decoded once into a disk
    memmap whose uint8 rows (``pixel_u8``) are normalized on the card. A
    host thread makes each chunk's pixels one chunk ahead of the card. A
    complete ``cache_path`` is read instead; a new one is written."""
    if cache_path and os.path.exists(cache_path):
        return np.load(cache_path)["cls"]
    device = next(vit.parameters()).device
    vit.eval()
    side = vit.cfg.image_size
    u8_rows = None
    if jpeg_store is not None and u8_store_path:
        u8_rows = U8MemmapStore.build(jpeg_store, image_ids, side,
                                      u8_store_path).get_batch

    def make_batch(i):
        idx = np.arange(i, min(i + batch_size, len(image_ids)))
        if u8_rows is not None:
            return {"pixel_u8": u8_rows(image_ids[idx])}
        if jpeg_store is not None:
            blobs = [jpeg_store.get(j) for j in image_ids[idx]]
            return {"pixel_values": decode_batch(blobs, side)}
        b = image_hook({"image_ids": image_ids[idx].astype(np.int32),
                        "y_multi": np.nan_to_num(labels[idx], nan=0.0)})
        return {"pixel_values": np.asarray(b["pixel_values"], np.float32)}

    out = []
    starts = list(range(0, len(image_ids), batch_size))
    with ThreadPoolExecutor(1) as ex, torch.no_grad():
        nxt = ex.submit(make_batch, starts[0])
        for k in range(len(starts)):
            batch = nxt.result()
            if k + 1 < len(starts):      # the next chunk's pixels meanwhile
                nxt = ex.submit(make_batch, starts[k + 1])
            pixels = default_image_source(to_device(batch, device))
            cls, _ = vit(pixels)
            out.append(cls.float().cpu().numpy())
    cls = np.concatenate(out)
    if cache_path:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        np.savez_compressed(cache_path, cls=cls)
    return cls


def train_cxr_head(cls_features: np.ndarray, labels: np.ndarray,
                   splits: dict, label_cols: Sequence[str], ckpt_path: str,
                   lr: float = 1e-3, weight_decay: float = 1e-4,
                   epochs: int = 50, dropout: float = 0.2, seed: int = 0,
                   batch_size: int = 0,
                   uncertain_policy: str = "to_positive",
                   head: Optional[CXRLinearHead] = None, device="cuda",
                   log: Callable[[str], None] = print) -> dict:
    """Train the head on ``splits["train"]``; keep the epoch of the best
    val macro AUROC; evaluate the test split with it and save it to
    ``ckpt_path``. ``batch_size`` 0 trains full-batch (one update an
    epoch), else mini-batch over a permutation of the train rows from
    ``numpy.random.default_rng(seed)`` (the last partial batch dropped).
    Dropout draws from a ``torch.Generator`` seeded ``seed + 1``.
    ``head``: the initial weights (default: ``init_like_flax`` from
    ``seed``). Returns {"best_val_macro_auroc", "test_macro_auroc",
    "test_per_label", "val_macro_auroc" (per epoch), "ckpt_path",
    "head"}."""
    refuse_multi_process("CXR-head training", "P18b")
    dev = resolve_device(device)
    K = labels.shape[1]
    if head is None:
        head = init_like_flax(CXRLinearHead(cls_features.shape[1], K,
                                            dropout), seed)
    head = head.to(dev)
    labels = apply_uncertain_policy(labels, uncertain_policy)
    mask = (~np.isnan(labels)).astype(np.float32)
    y = np.nan_to_num(labels, nan=0.0).astype(np.float32)

    def on_dev(a, split):
        return torch.from_numpy(np.ascontiguousarray(a[splits[split]])).to(
            dev)

    x_tr, y_tr, m_tr = (on_dev(a, "train") for a in (cls_features, y, mask))
    opt = MultiGroupAdamW.one_group(head, lambda step: lr, weight_decay)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    n_tr = x_tr.shape[0]
    shuffle = np.random.default_rng(seed)
    count = 0

    def update(xb, yb, mb):
        nonlocal count
        opt.zero_grad()
        logits = head(xb, train=True, gen=gen)
        masked_per_label_bce(logits, yb, mb).sum().backward()
        opt.step(count)
        count += 1

    def train_epoch():
        if batch_size <= 0 or batch_size >= n_tr:
            update(x_tr, y_tr, m_tr)
            return
        order = torch.from_numpy(shuffle.permutation(n_tr)).to(dev)
        for i in range(0, n_tr - n_tr % batch_size, batch_size):
            b = order[i:i + batch_size]
            update(x_tr[b], y_tr[b], m_tr[b])

    def macro_auroc(split):
        with torch.no_grad():
            logits = head(on_dev(cls_features, split)).cpu().numpy()
        rows = M.masked_multilabel_metrics(y[splits[split]],
                                           mask[splits[split]],
                                           {"head": logits})
        return M.macro_mean(rows, "head_auroc"), rows

    def weights():
        return {k: v.detach().clone() for k, v in head.state_dict().items()}

    best, best_sd, history = -1.0, weights(), []
    for epoch in range(epochs):
        train_epoch()
        val_auroc, _ = macro_auroc("val")
        history.append(val_auroc)
        if val_auroc > best:
            best, best_sd = val_auroc, weights()
        if epoch % 10 == 0:
            log(f"epoch {epoch:3d}  val macro AUROC={val_auroc:.4f}")
    head.load_state_dict(best_sd)
    test_auroc, test_rows = macro_auroc("test")
    log(f"best val={best:.4f}  test={test_auroc:.4f}")
    save_checkpoint(ckpt_path, head, epochs, best,
                    config={"label_cols": list(label_cols),
                            "num_classes": K, "kind": "cxr_linear_head"})
    return {"best_val_macro_auroc": best, "test_macro_auroc": test_auroc,
            "test_per_label": test_rows, "val_macro_auroc": history,
            "ckpt_path": ckpt_path, "head": head}


def load_cxr_head_into_teacher(head_ckpt: str, teacher) -> None:
    """Copy a head checkpoint's ``linear`` weights (written by either
    package) into a ``dual`` teacher's ``pretrained_cxr_head``, in place.
    The teacher's ``static_keep_idx`` maps the checkpoint's ``label_cols``
    onto the pathology order (``teacher_loop.pretrained_head_spec``)."""
    load_flax(teacher.pretrained_cxr_head,
              {"linear": load_checkpoint(head_ckpt)["params"]["linear"]})
