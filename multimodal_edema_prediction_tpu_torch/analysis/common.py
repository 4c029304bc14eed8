"""Shared analysis machinery, the counterpart of
``multimodal_edema_prediction_tpu/analysis/common.py``: the flags, the
image and feature sources, the data and the teacher (the config rides in
the checkpoint's sidecar, so the teacher is rebuilt in one call: the
reference's ``load_teacher``, analysis/visualize_pathology.py:94-192), the
host-side window gather and the counterfactual and bootstrap helpers
(numpy, as in JAX); and what the probes of the analysis scripts share in
place of optax and ``jax.random``: ``adam`` (optax's Adam, in its order of
operations) and ``write_figure`` (matplotlib, imported only when a figure
is drawn).
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import DataConfig
from ..data import pipeline as P
from ..data import synthetic as S


def add_analysis_flags(p: argparse.ArgumentParser, needs_ckpt: bool = True
                       ) -> None:
    """The JAX analysis CLIs' flags, and ``--device``."""
    if needs_ckpt:
        p.add_argument("--ckpt", type=str, required=True,
                       help="teacher best checkpoint (.msgpack), written by "
                            "either package")
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--synthetic_stays", type=int, default=400)
    p.add_argument("--n_variables", type=int, default=34)
    p.add_argument("--split", type=str, default="test",
                   choices=["train", "val", "test"])
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n_boot", type=int, default=200)
    p.add_argument("--max_batches", type=int, default=0)
    p.add_argument("--out_dir", type=str, default="analysis_out")
    p.add_argument("--cxr_jpeg_root", type=str, default="",
                   help="directory of {image_id}.jpg files: run on real "
                        "CXRs instead of procedural images")
    p.add_argument("--cxr_feature_cache", type=str, default="none",
                   choices=["none", "hbm"],
                   help="encode-once tier: every unique image of the cohort "
                        "through the frozen ViT once, into a token bank on "
                        "the device; each forward then gathers its tokens "
                        "(K2) instead of running the ViT")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' only when asked for")


def make_image_source(args, anchor_ds, vit_cfg) -> Callable:
    """The eval steps' image source. With ``--cxr_jpeg_root`` the JPEG
    decode hook goes onto the dataset, so that every batch carries real
    ``pixel_values``, and the pass-through source is returned; otherwise
    the device-side procedural source (JAX's procedural images)."""
    from ..train import engine
    root = getattr(args, "cxr_jpeg_root", "")
    if root:
        from ..data.images import JpegStore, make_jpeg_host_fn
        anchor_ds.batch_hook = make_jpeg_host_fn(JpegStore(root=root),
                                                 vit_cfg.image_size)
        return engine.default_image_source
    from ..train.teacher_loop import make_synthetic_image_source
    return make_synthetic_image_source(vit_cfg.image_size)


def make_sources(args, anchor_ds, model, cfg, dtype=torch.bfloat16
                 ) -> Tuple[Callable, Optional[Callable]]:
    """(image_source, feature_source) after ``--cxr_feature_cache`` (JAX
    ``common.py:69-101``). With ``hbm``, every unique image of the cohort
    is encoded once through the checkpoint's frozen ViT (K1) into a
    ``CXRFeatureBank`` on the model's device, each image with its first
    anchor's labels, and batches gather their tokens by raw image id
    (``keyed_by_row=False``: analysis batches are not rewritten by a hook);
    then the pixel hook is detached, so no batch decodes a JPEG."""
    from ..data import features as F
    from ..train.engine import to_device
    from ..train.teacher_loop import pixels_for_ids_fn
    image_source = make_image_source(args, anchor_ds, cfg.vit)
    if getattr(args, "cxr_feature_cache", "none") == "none":
        return image_source, None
    base_hook = anchor_ds.batch_hook
    device = next(model.parameters()).device

    def hook(b: dict) -> dict:
        if base_hook is not None:
            b = base_hook(b)
        return {**b, "pixel_values": image_source(to_device(b, device))}

    all_ids, pixels_for_ids = pixels_for_ids_fn(anchor_ds, hook)
    bank = F.CXRFeatureBank.build(
        F.encode_fn_for_teacher(model, dtype), pixels_for_ids, all_ids,
        out_dtype=torch.float32 if dtype == torch.float32
        else torch.bfloat16)
    anchor_ds.batch_hook = None      # pixels no longer needed per batch
    return image_source, bank.feature_source(keyed_by_row=False)


def load_analysis_data(args, n_variables: Optional[int] = None) -> tuple:
    """(cohort, meta, AnchorDataset on the CPU, DataConfig) from
    ``--data_dir`` or the synthetic cohort of ``--synthetic_stays``."""
    dcfg = DataConfig(data_dir=getattr(args, "data_dir", ""))
    if getattr(args, "data_dir", ""):
        from ..data.ingest import load_artifacts
        ds, meta = load_artifacts(args.data_dir)
    else:
        ds = S.make_synthetic(
            seed=0, n_stays=args.synthetic_stays,
            n_subjects=max(args.synthetic_stays // 3, 10),
            n_variables=n_variables or args.n_variables)
        meta = P.meta_from_events(ds, dcfg)
    anchor_ds = P.build_anchor_dataset(ds, meta, dcfg)
    return ds, meta, anchor_ds, dcfg


def load_teacher(ckpt_path: str, device="cuda") -> tuple:
    """(model in eval mode on ``device``, TeacherConfig, raw checkpoint)
    from one checkpoint of either package."""
    from ..train.checkpoint import load_teacher_from_ckpt
    return load_teacher_from_ckpt(ckpt_path, device)


def _host(x) -> np.ndarray:
    """A tensor (on any device) or an array → a numpy array on the host."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def gather_host_windows(anchor_ds, idx: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """The windows [N, T, 2V] and static rows [N, D] of anchors ``idx``,
    on the host, for counterfactual transforms (JAX ``common.py:122-131``).
    The grid may live on the card; it is copied back for the gather."""
    grid = _host(anchor_ds.grid)
    static = _host(anchor_ds.static)
    a = anchor_ds.anchor
    T = anchor_ds.n_timesteps
    rows, ends = a["stay_rows"][idx], a["slot_idx"][idx]
    x_ts = np.stack([grid[r, e - T:e] for r, e in zip(rows, ends)])
    return x_ts, static[rows]


def window_batch(anchor_ds, idx: np.ndarray) -> Tuple[np.ndarray,
                                                      np.ndarray, dict]:
    """(x_ts, x_static, batch) of anchors ``idx`` for
    ``engine.make_teacher_eval_from_windows``: the host windows and the
    batch of image ids, labels and bin ends, through the dataset's pixel
    hook where it has one (real JPEGs)."""
    a = anchor_ds.anchor
    x_ts, x_static = gather_host_windows(anchor_ds, idx)
    batch = {"image_ids": a["image_ids"][idx].astype(np.int32),
             "y_multi": a["y_multi"][idx],
             "y_multi_mask": a["y_multi_mask"][idx],
             "bin_ends": np.broadcast_to(anchor_ds.bin_ends,
                                         (len(idx), anchor_ds.n_timesteps))}
    if anchor_ds.batch_hook is not None:   # real-JPEG pixel hook
        batch = anchor_ds.batch_hook(batch)
    return x_ts, x_static, batch


def different_subject_permutation(subject_ids: np.ndarray,
                                  rng: np.random.Generator) -> np.ndarray:
    """Within-batch permutation maximizing cross-subject pairing
    (reference diagnose_temporal_usage.py:104-126): up to 100 random
    draws, then the roll with the fewest same-subject pairs."""
    n = len(subject_ids)
    if n <= 1:
        return np.arange(n)
    for _ in range(100):
        perm = rng.permutation(n)
        if np.all(subject_ids[perm] != subject_ids):
            return perm
    best_perm = np.roll(np.arange(n), 1)
    best = int(np.sum(subject_ids[best_perm] == subject_ids))
    for shift in range(2, n):
        cand = np.roll(np.arange(n), shift)
        m = int(np.sum(subject_ids[cand] == subject_ids))
        if m < best:
            best_perm, best = cand, m
            if m == 0:
                break
    return best_perm


def subject_cluster_bootstrap(subject_ids: np.ndarray,
                              stat_fn: Callable[[np.ndarray], float],
                              n_boot: int = 200, seed: int = 0
                              ) -> Dict[str, float]:
    """Paired bootstrap resampling whole subjects (reference
    diagnose_temporal_usage.py:215-242). ``stat_fn`` maps an index array
    (sample rows) to a scalar; returns the mean, the 95% CI and the count
    of finite draws."""
    rng = np.random.default_rng(seed)
    subjects = np.unique(subject_ids)
    by_subj = {s: np.nonzero(subject_ids == s)[0] for s in subjects}
    stats = []
    for _ in range(n_boot):
        chosen = rng.choice(subjects, size=len(subjects), replace=True)
        idx = np.concatenate([by_subj[s] for s in chosen])
        v = stat_fn(idx)
        if np.isfinite(v):
            stats.append(v)
    stats = np.asarray(stats)
    if len(stats) == 0:
        return {"mean": float("nan"), "lo": float("nan"),
                "hi": float("nan"), "n_valid": 0}
    return {"mean": float(stats.mean()),
            "lo": float(np.percentile(stats, 2.5)),
            "hi": float(np.percentile(stats, 97.5)),
            "n_valid": int(len(stats))}


def attention_entropy(attn: np.ndarray) -> np.ndarray:
    """Normalized entropy of attention rows [N, K, S] → [N, K] (reference
    diagnose_temporal_usage.py:397-406)."""
    p = attn / np.clip(attn.sum(axis=-1, keepdims=True), 1e-12, None)
    ent = -(p * np.log(np.clip(p, 1e-12, None))).sum(axis=-1)
    return ent / max(np.log(attn.shape[-1]), 1e-12)


def adam(loss_fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
         params: Dict[str, torch.Tensor], lr: float, steps: int,
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> Dict[str, torch.Tensor]:
    """``steps`` full-batch updates of ``params`` by optax's ``adam(lr)``:
    m ← (1−b1)·g + b1·m, v ← (1−b2)·g² + b2·v, p ← p − lr·m̂/(√v̂ + eps)
    with m̂ = m/(1−b1ᵗ), v̂ = v/(1−b2ᵗ) and the corrections in float32, in
    optax's order of operations (``torch.optim.Adam`` divides in another
    order). Returns the final parameters, detached."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in
         params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    f32 = torch.float32
    for t in range(1, steps + 1):
        grads = torch.autograd.grad(loss_fn(p), list(p.values()))
        bc1 = 1 - torch.tensor(b1, dtype=f32) ** t
        bc2 = 1 - torch.tensor(b2, dtype=f32) ** t
        with torch.no_grad():
            for (k, x), g in zip(p.items(), grads):
                m[k] = (1 - b1) * g + b1 * m[k]
                v2[k] = (1 - b2) * (g * g) + b2 * v2[k]
                upd = (m[k] / bc1.to(x.device)) / (
                    torch.sqrt(v2[k] / bc2.to(x.device)) + eps)
                x.add_(-lr * upd)
    return {k: x.detach() for k, x in p.items()}


def write_figure(draw: Callable[[object], None]) -> bool:
    """Run ``draw(pyplot)``, which draws and saves one figure. matplotlib
    is imported here, when a figure is asked for; where it cannot be
    imported nothing is drawn and False is returned (the caller names the
    figures it did not draw)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    draw(plt)
    return True


def report_skipped_figures(skipped: List[str]) -> None:
    """One line naming the figures a script did not draw (no
    matplotlib)."""
    if skipped:
        print("matplotlib is not installed: figures not drawn: "
              + ", ".join(skipped), flush=True)


def load_for_analysis(args, dtype=torch.bfloat16, grid_on_device: bool = True
                      ) -> tuple:
    """What a teacher analysis starts from: (model in eval mode on
    ``args.device``, TeacherConfig, AnchorDataset, DataConfig,
    image_source, feature_source), the cohort built with the teacher's
    variable count and the sources after ``--cxr_feature_cache`` at
    ``dtype``. ``grid_on_device``: move the windows' grid to the card (the
    eval steps gather there); False keeps it on the host for scripts that
    gather windows on the host (``gather_host_windows``)."""
    model, cfg, _ = load_teacher(args.ckpt, args.device)
    _, _, anchor_ds, dcfg = load_analysis_data(
        args, n_variables=cfg.duett.n_variables)
    if grid_on_device:
        anchor_ds.to(next(model.parameters()).device)
    image_source, feature_source = make_sources(args, anchor_ds, model, cfg,
                                                dtype)
    return model, cfg, anchor_ds, dcfg, image_source, feature_source


def save_json(obj, out_dir: str, name: str) -> str:
    """``obj`` as indented JSON at ``out_dir/name`` (numpy scalars as
    floats); returns the path."""
    import json
    import os
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=float)
    return path
