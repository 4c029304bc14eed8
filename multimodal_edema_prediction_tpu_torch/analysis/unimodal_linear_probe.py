"""Unimodal linear probes: frozen-backbone features → a joint multi-label
head. The counterpart of
``multimodal_edema_prediction_tpu/analysis/unimodal_linear_probe.py``
(reference ``analysis/unimodal_linear_probe.py``): what each frozen
modality encodes linearly, the CXR CLS token against DuETT's token
poolings (``rep`` / ``hourly_mean`` / ``multiscale`` / ``attn_pool``,
reference ``_pool_duett_tokens`` :64-88). The probe is one dense layer
trained by full-batch Adam (optax's, ``common.adam``) on the masked
multi-label BCE; ``attn_pool`` adds a learned query drawn as JAX draws it
(``data/pipeline.jax_normal``). One pass over the anchors runs DuETT and
the ViT in float32 (K1's float32 forward), as the JAX script does, or with
``--cxr_feature_cache hbm`` gathers each anchor's CLS from the encode-once
bank (K2); ``--save_features`` caches the features in an ``.npz``.

    python -m multimodal_edema_prediction_tpu_torch.analysis.unimodal_linear_probe \\
        --ckpt runs/<run>/best-*.msgpack --device cuda [--cxr_feature_cache hbm]
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from ..data.pipeline import jax_key, jax_normal
from ..models.duett import feats_to_input
from ..ops import metrics as M
from ..ops.losses import masked_per_label_bce
from ..train.engine import to_device
from .common import (add_analysis_flags, adam, gather_host_windows,
                     load_for_analysis, save_json)

POOLINGS = ("rep", "hourly_mean", "multiscale", "attn_pool")


def extract_features(model, anchor_ds, image_source, batch_size: int = 64,
                     cache_path: Optional[str] = None,
                     feature_source=None) -> dict:
    """One pass over all anchors → DuETT's tokens [N, T+1, R] (every
    pooling reads them) and the CXR CLS [N, D], float32 on the host. With
    ``feature_source`` (the encode-once tier) the CLS comes from the bank
    instead of a ViT forward per anchor."""
    if cache_path and os.path.exists(cache_path):
        z = np.load(cache_path)
        return {k: z[k] for k in z.files}
    device = next(model.parameters()).device
    a = anchor_ds.anchor
    N = len(a["y"])
    T = anchor_ds.n_timesteps
    tokens_all, cls_all = [], []
    with torch.inference_mode():
        for i in range(0, N, batch_size):
            idx = np.arange(i, min(i + batch_size, N))
            x_ts, x_static = gather_host_windows(anchor_ds, idx)
            b = {"image_ids": a["image_ids"][idx].astype(np.int32),
                 "y_multi": a["y_multi"][idx]}
            if anchor_ds.batch_hook is not None:   # real-JPEG pixel hook
                b = anchor_ds.batch_hook(b)
            b = to_device({**b, "x_ts": x_ts, "x_static": x_static,
                           "times": np.broadcast_to(anchor_ds.bin_ends,
                                                    (len(idx), T))},
                          device)
            x_in, xs = feats_to_input(b["x_ts"], b["x_static"])
            tokens, _ = model.duett(x_in, xs, b["times"], False)
            if feature_source is not None:
                cls, _ = feature_source(b)
            else:
                cls, _ = model.cxr(image_source(b))
            tokens_all.append(tokens.float().cpu().numpy())
            cls_all.append(cls.float().cpu().numpy())
    feats = {"duett_tokens": np.concatenate(tokens_all),
             "cxr_cls": np.concatenate(cls_all)}
    if cache_path:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        np.savez_compressed(cache_path, **feats)
    return feats


def pool_duett_tokens(tokens: np.ndarray, pooling: str,
                      windows=(6, 12, 24)) -> np.ndarray:
    """[N, T+1, R] → pooled features (reference :64-88)."""
    hourly, rep = tokens[:, :-1], tokens[:, -1]
    if pooling == "rep":
        return rep
    if pooling == "hourly_mean":
        return hourly.mean(axis=1)
    if pooling == "multiscale":
        T = hourly.shape[1]
        parts = [hourly[:, T - w:].mean(axis=1) for w in windows]
        return np.concatenate(parts, axis=1)
    if pooling == "attn_pool":
        return hourly  # pooled inside the probe with a learned query
    raise ValueError(pooling)


def train_probe(x_train, y_train, m_train, x_eval, y_eval, m_eval,
                attn_pool: bool = False, lr: float = 1e-2,
                steps: int = 400, seed: int = 0, device="cpu") -> dict:
    """Joint multi-label linear head on frozen features (full-batch
    Adam)."""
    K = y_train.shape[1]

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)

    if attn_pool:
        R = x_train.shape[2]
        params = {"q": 0.02 * jax_normal(jax_key(seed), (R,), device),
                  "w": torch.zeros(R, K, device=device),
                  "b": torch.zeros(K, device=device)}

        def logits_fn(p, x):
            att = torch.softmax(torch.einsum("ntr,r->nt", x, p["q"]), dim=1)
            pooled = torch.einsum("nt,ntr->nr", att, x)
            return pooled @ p["w"] + p["b"]
    else:
        mu, sd = x_train.mean(0), x_train.std(0) + 1e-6
        x_train = (x_train - mu) / sd
        x_eval = (x_eval - mu) / sd
        params = {"w": torch.zeros(x_train.shape[1], K, device=device),
                  "b": torch.zeros(K, device=device)}

        def logits_fn(p, x):
            return x @ p["w"] + p["b"]

    xt, yt, mt = t(x_train), t(y_train), t(m_train)
    params = adam(lambda p: masked_per_label_bce(logits_fn(p, xt), yt,
                                                 mt).sum(),
                  params, lr, steps)
    with torch.no_grad():
        ev_logits = logits_fn(params, t(x_eval)).cpu().numpy()
    rows = M.masked_multilabel_metrics(y_eval, m_eval, {"probe": ev_logits})
    return {"per_label": rows,
            "macro_auroc": M.macro_mean(rows, "probe_auroc"),
            "macro_auprc": M.macro_mean(rows, "probe_auprc")}


def main(argv=None, dtype=torch.bfloat16) -> dict:
    """``dtype``: the precision of the encode-once bank (bf16, as the JAX
    script's); the feature pass and the probes run in float32."""
    p = argparse.ArgumentParser("unimodal linear probes")
    add_analysis_flags(p)
    p.add_argument("--save_features", type=str, default="")
    p.add_argument("--probe_steps", type=int, default=400)
    args = p.parse_args(argv)
    model, _, anchor_ds, _, image_source, feature_source = \
        load_for_analysis(args, dtype, grid_on_device=False)
    feats = extract_features(model, anchor_ds, image_source,
                             args.batch_size, args.save_features or None,
                             feature_source=feature_source)
    a, s = anchor_ds.anchor, anchor_ds.splits
    tr, ev = s["train"], s[args.split]
    y_tr, m_tr = a["y_multi"][tr], a["y_multi_mask"][tr]
    y_ev, m_ev = a["y_multi"][ev], a["y_multi_mask"][ev]
    device = next(model.parameters()).device
    results = {"cxr_cls": train_probe(
        feats["cxr_cls"][tr], y_tr, m_tr, feats["cxr_cls"][ev], y_ev, m_ev,
        steps=args.probe_steps, seed=args.seed, device=device)}
    for pooling in POOLINGS:
        x = pool_duett_tokens(feats["duett_tokens"], pooling)
        results[f"duett_{pooling}"] = train_probe(
            x[tr], y_tr, m_tr, x[ev], y_ev, m_ev,
            attn_pool=(pooling == "attn_pool"), steps=args.probe_steps,
            seed=args.seed, device=device)
    print(f"{'probe':<20s} {'macroROC':>9s} {'macroAP':>9s}")
    for name, r in results.items():
        print(f"{name:<20s} {r['macro_auroc']:>9.4f} {r['macro_auprc']:>9.4f}")
    out = save_json({k: {"macro_auroc": v["macro_auroc"],
                         "macro_auprc": v["macro_auprc"],
                         "per_label": v["per_label"]}
                     for k, v in results.items()},
                    args.out_dir, "unimodal_probe.json")
    print(f"saved → {out}")
    return results


if __name__ == "__main__":
    main()
