"""The time-series-only trajectory probe: the counterpart of
``multimodal_edema_prediction_tpu/analysis/train_trajectory_probe.py``
(reference ``analysis/train_trajectory_probe.py``). It trains
``models/trajectory.py::LocalTrajectoryEncoder`` and a pathology-query
readout (masked cross-attention, then self-attention) on the anchor cohort
with no image: AdamW (optax's ``adamw`` on a cosine decay over every
step, ``weight_decay`` 1e-4; ``train/optim.py::MultiGroupAdamW``), early
stopping on the validation macro AUROC, and a Δ table against the
reference's stored AUROCs (:71-77).

The probe is built and initialized by ``init_probe``, after flax's
initializers in distribution (``torch.Generator`` draws are not
``jax.random``'s); dropout draws from a ``torch.Generator`` seeded with
``seed + 1``. The probe's 4 heads of d_model/4 never take the flash route,
so it launches no kernel of the repo.

    python -m multimodal_edema_prediction_tpu_torch.analysis.train_trajectory_probe \\
        --device cuda --d_model 128 --epochs 20 --out_dir analysis_out

Writes ``trajectory_probe_best.msgpack`` (the best epoch's parameters in
flax's layout, which ``flax.serialization.msgpack_restore`` reads) with its
``.config.json``, ``trajectory_probe.json`` and ``test_metrics.json``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..convert import to_flax
from ..models.layers import LayerNorm, MultiHeadAttention, Dense, \
    init_like_flax
from ..models.trajectory import LocalTrajectoryEncoder
from ..ops import metrics as M
from ..ops.losses import masked_per_label_bce
from ..train.checkpoint import msgpack_serialize
from ..train.optim import MultiGroupAdamW
from ..utils import resolve_device
from .common import add_analysis_flags, gather_host_windows, \
    load_analysis_data, save_json

# Reference TS-branch AUROCs for the 4-label era (train_trajectory_probe.py:72-75)
REFERENCE_AUROCS = {"label_edema": 0.641, "label_cardiomegaly": 0.634,
                    "label_effusion": 0.609, "label_pneumonia": 0.604}


class TrajectoryPathologyProbe(nn.Module):
    """Trajectory tokens → K pathology queries (masked cross-attention and
    self-attention) → per-label logits (reference
    TrajectoryPathologyProbe :98-167)."""

    def __init__(self, n_vars: int, n_timesteps: int = 24,
                 n_pathologies: int = 7, d_model: int = 128,
                 n_heads: int = 4, dropout: float = 0.1):
        super().__init__()
        self.encoder = LocalTrajectoryEncoder(n_vars, n_timesteps, d_model,
                                              dropout)
        self.pathology_queries = nn.Parameter(torch.zeros(n_pathologies,
                                                          d_model))
        self.cross = MultiHeadAttention(d_model, n_heads, dropout=dropout)
        self.add_module("self", MultiHeadAttention(d_model, n_heads,
                                                   dropout=dropout))
        self.norm = LayerNorm(d_model)
        self.head = Dense(d_model, 1)
        self.label_bias = nn.Parameter(torch.zeros(n_pathologies))

    def forward(self, x_ts: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        tokens, pad = self.encoder(x_ts, train=train, gen=gen,
                                   return_padding_mask=True)
        B = tokens.shape[0]
        q = self.pathology_queries.to(tokens.dtype).expand(B, -1, -1)
        h = q + self.cross(q, tokens, train=train, gen=gen,
                           key_padding_mask=pad)
        h = h + getattr(self, "self")(h, h, train=train, gen=gen)
        logits = self.head(self.norm(h)).squeeze(-1)
        return logits.float() + self.label_bias[None, :]


def init_probe(n_vars: int, n_timesteps: int, n_pathologies: int,
               d_model: int, seed: int, x0: np.ndarray,
               device="cpu") -> TrajectoryPathologyProbe:
    """The probe, initialized from ``seed`` after flax's initializers (in
    distribution): ``lecun_normal`` for the Dense kernels, ``orthogonal``
    for the GRU's recurrent kernels ``hr``, ``hz``, ``hn``, flax
    ``nn.Embed``'s N(0, 1/d) for the two embeddings, N(0, 1) for
    ``window_embedding``, N(0, 0.02²) for ``rep_token`` and
    ``pathology_queries``, zeros for the biases and ``label_bias``; on
    ``device``, checked by one forward of ``x0`` (the two training windows
    flax's ``init`` runs)."""
    model = init_like_flax(TrajectoryPathologyProbe(
        n_vars, n_timesteps, n_pathologies, d_model), seed)
    g = torch.Generator().manual_seed(seed + 1)
    enc = model.encoder
    with torch.no_grad():
        for name in ("hr", "hz", "hn"):
            nn.init.orthogonal_(getattr(enc.GRUCell_0, name).weight,
                                generator=g)
        for emb in (enc.variable_embedding, enc.hour_embedding):
            nn.init.normal_(emb.weight, 0.0, d_model ** -0.5, generator=g)
        nn.init.normal_(enc.window_embedding, 0.0, 1.0, generator=g)
        nn.init.normal_(enc.rep_token, 0.0, 0.02, generator=g)
    model.to(device)
    with torch.no_grad():
        model(torch.as_tensor(x0, device=device))
    return model


def cosine_decay(lr: float, decay_steps: int):
    """optax ``cosine_decay_schedule(lr, decay_steps)``."""
    def schedule(step: int) -> float:
        count = min(step, decay_steps)
        return lr * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
    return schedule


def train_step(model, opt: MultiGroupAdamW, count: int, x, y, m,
               gen: torch.Generator) -> torch.Tensor:
    """One AdamW update on the summed per-label masked BCE; returns the
    loss (detached)."""
    loss = masked_per_label_bce(model(x, train=True, gen=gen), y, m).sum()
    opt.zero_grad()
    loss.backward()
    opt.step(count)
    return loss.detach()


def train_probe(anchor_ds, labels, n_vars: int, d_model: int = 128,
                epochs: int = 20, batch_size: int = 64, lr: float = 1e-3,
                patience: int = 5, seed: int = 0, device="cuda") -> dict:
    """JAX ``train_probe`` (:70-137): the same epochs, permutations
    (``default_rng(seed + epoch)``), batches and early stop. Returns the
    best validation and the test macro AUROC, the test split's per-label
    metrics and ``best_params`` (the best epoch's flax parameter tree)."""
    dev = resolve_device(device)
    a = anchor_ds.anchor
    x0, _ = gather_host_windows(anchor_ds, anchor_ds.splits["train"][:2])
    model = init_probe(n_vars, anchor_ds.n_timesteps, len(labels), d_model,
                       seed, x0, dev)
    steps_per_epoch = max(len(anchor_ds.splits["train"]) // batch_size, 1)
    opt = MultiGroupAdamW.one_group(
        model, cosine_decay(lr, steps_per_epoch * epochs),
        weight_decay=1e-4)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=dev)

    def evaluate(split):
        idx = anchor_ds.splits[split]
        logits = []
        with torch.no_grad():
            for i in range(0, len(idx), batch_size):
                x, _ = gather_host_windows(anchor_ds, idx[i:i + batch_size])
                logits.append(model(t(x)).cpu().numpy())
        logits = np.concatenate(logits)
        rows = M.masked_multilabel_metrics(a["y_multi"][idx],
                                           a["y_multi_mask"][idx],
                                           {"ts": logits})
        return M.macro_mean(rows, "ts_auroc"), rows

    gen = torch.Generator(dev).manual_seed(seed + 1)
    best, bad, count = -1.0, 0, 0
    for epoch in range(epochs):
        order = np.random.default_rng(seed + epoch).permutation(
            anchor_ds.splits["train"])
        bs = min(batch_size, max(len(order), 1))
        n = len(order) - len(order) % bs
        for i in range(0, n, bs):
            idx = order[i:i + bs]
            x, _ = gather_host_windows(anchor_ds, idx)
            train_step(model, opt, count, t(x), t(a["y_multi"][idx]),
                       t(a["y_multi_mask"][idx]), gen)
            count += 1
        val, _ = evaluate("val")
        if val > best:
            best, bad = val, 0
            best_state = {k: v.detach().clone()
                          for k, v in model.state_dict().items()}
        else:
            bad += 1
            if bad >= patience:
                break
    model.load_state_dict(best_state)
    test, test_rows = evaluate("test")
    return {"val_macro_auroc": best, "test_macro_auroc": test,
            "test_per_label": test_rows, "best_params": to_flax(model)[0]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("trajectory-encoder TS-only probe")
    add_analysis_flags(p, needs_ckpt=False)
    p.add_argument("--d_model", type=int, default=128)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--lr", type=float, default=1e-3)
    args = p.parse_args(argv)
    resolve_device(args.device)
    _, meta, anchor_ds, dcfg = load_analysis_data(args)
    result = train_probe(anchor_ds, dcfg.pathology_labels, meta.n_variables,
                         args.d_model, args.epochs, args.batch_size, args.lr,
                         seed=args.seed, device=args.device)
    print(f"val macro AUROC:  {result['val_macro_auroc']:.4f}")
    print(f"test macro AUROC: {result['test_macro_auroc']:.4f}")
    print(f"{'label':<22s} {'AUROC':>7s} {'ref':>7s} {'delta':>7s}")
    for k, lbl in enumerate(dcfg.pathology_labels):
        au = result["test_per_label"][k]["ts_auroc"]
        ref = REFERENCE_AUROCS.get(lbl, float("nan"))
        print(f"{lbl:<22s} {au:>7.4f} {ref:>7.3f} {au - ref:>+7.4f}")
    os.makedirs(args.out_dir, exist_ok=True)
    # best-probe checkpoint + test metrics file (reference
    # train_trajectory_probe.py:351-358, :378-379)
    best_params = result.pop("best_params")
    ckpt_path = os.path.join(args.out_dir, "trajectory_probe_best.msgpack")
    with open(ckpt_path, "wb") as f:
        f.write(msgpack_serialize(best_params))
    with open(ckpt_path + ".config.json", "w") as f:
        json.dump({"labels": list(dcfg.pathology_labels),
                   "d_model": args.d_model, "epochs": args.epochs,
                   "lr": args.lr, "seed": args.seed,
                   "val_macro_auroc": result["val_macro_auroc"]},
                  f, indent=2, default=float)
    save_json(result, args.out_dir, "trajectory_probe.json")
    save_json({"test_macro_auroc": result["test_macro_auroc"],
               "test_per_label": result["test_per_label"]},
              args.out_dir, "test_metrics.json")
    return result


if __name__ == "__main__":
    main()
