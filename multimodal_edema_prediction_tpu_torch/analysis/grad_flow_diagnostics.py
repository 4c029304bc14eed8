"""Read-only gradient-flow diagnostics of the dual-branch teacher: the
counterpart of
``multimodal_edema_prediction_tpu/analysis/grad_flow_diagnostics.py``
(reference ``analysis/grad_flow_diagnostics.py:234-610``; the teacher
loop runs them every N epochs with ``--grad_diag_every``). Without an
optimizer step it reports:

- per branch (img/ts/fus), the objective's gradient w.r.t. the pathology
  query banks: losses, α weights, raw and α-weighted norms, cosine of each
  weighted branch gradient to the total update (reference :472-482);
- pairwise cosines of the batch-mean gradients, and the per-batch img–ts
  cosine's mean and negative fraction (:373-375, :581-591);
- fusion-token sensitivity: ‖∂fus_loss/∂I‖ and ‖∂fus_loss/∂T_k‖ on the
  post-self-attention fusion tokens, raw and scale-normalized (‖g_i‖ ·
  ‖token_i‖ per sample, :188-196), in total and per label (:389-419),
  through the perceiver's zero-perturbation hook (``token_eps``);
- per label: each branch's query-gradient norm, pairwise cosines, the
  α-weighted total and the share that lands on query row k (:498-549);
- modality-input sensitivity: ‖∂branch_loss/∂ts_windows‖ and
  ‖∂branch_loss/∂pixels‖: fusion → pixels is 0, the image anchor being
  detached;
- the query geometry: prototype norms, the raw Gram and the effective
  Grams after each branch's LayerNorm and W_Q, and the image-vs-TS Gram
  gap ‖G_img − G_ts‖/K (:551-573, :596-608).

One forward per batch, in float32 with autograd on, gives everything: the
[3 branches, K labels] weighted per-label losses are differentiated one
entry at a time (3·K ``torch.autograd.grad`` calls) w.r.t. the query banks
and the two token perturbations, whose paths stay inside the perceiver;
then the 3 branch totals w.r.t. the windows and the pixels. Only the image
branch reaches the pixels, so on a teacher whose ViT trains
(``freeze_cxr=False``) the ViT's backward runs once a batch: K1's D, dkv
and dq once per ViT layer. A frozen ViT runs under ``torch.no_grad()``, so
the pixels never enter the graph and their gradient is exactly 0, as JAX's
``stop_gradient`` gives it.

    python -m multimodal_edema_prediction_tpu_torch.analysis.grad_flow_diagnostics \\
        --ckpt runs/<run>/best-*.msgpack --device cuda --n_batches 4

Writes ``grad_flow_report.txt``, ``grad_flow.json`` and
``grad_flow_report.json`` (reference :821-828).
"""
from __future__ import annotations

import argparse
import os
from contextlib import contextmanager
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..models.duett import feats_to_input
from ..ops.losses import masked_per_label_bce
from ..train.engine import to_device
from .common import (add_analysis_flags, gather_host_windows,
                     load_analysis_data, load_teacher, make_image_source,
                     save_json)

BRANCHES = ("img", "ts", "fus")
_LOGIT_KEY = {"img": "img_logits", "ts": "ts_logits", "fus": "fusion_logits"}
_EPS = 1e-12
PATCH_MODES = ("dual_patch", "dual_patch_event")


def _cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.reshape(-1), b.reshape(-1)
    return torch.dot(a, b) / (torch.linalg.norm(a) * torch.linalg.norm(b)
                              + _EPS)


def _cosine_matrix(rows: torch.Tensor) -> torch.Tensor:
    rows = rows.float()
    rows = rows / (torch.linalg.norm(rows, dim=-1, keepdim=True) + _EPS)
    return rows @ rows.T


def _layer_norm(x: torch.Tensor, ln) -> torch.Tensor:
    """flax's LayerNorm (eps 1e-6) with ``ln``'s scale and bias."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-6) * ln.weight + ln.bias


def _dense(x: torch.Tensor, layer) -> torch.Tensor:
    out = x @ layer.weight.T
    return out if layer.bias is None else out + layer.bias


def _effective_queries(block, q: torch.Tensor) -> torch.Tensor:
    """A PerceiverBlock's norm_q LayerNorm, then its attention's W_Q
    (reference ``_effective_queries``, :211-227)."""
    return _dense(_layer_norm(q, block.norm_q), block.attn.q)


def _effective_event_queries(event_cross, q: torch.Tensor) -> torch.Tensor:
    """event_query_norm(event_query_proj(q)): the event variant's TS query
    path (reference grad_flow_diagnostics.py:563-571)."""
    return _layer_norm(_dense(q, event_cross.event_query_proj),
                       event_cross.event_query_norm)


def _bank_names(perc) -> tuple:
    """The perceiver's query banks: the shared one, or the image and
    temporal banks of the event variant (reference
    ``_find_pathology_query_banks``, :70-90)."""
    if hasattr(perc, "shared_queries"):
        return ("shared_queries",)
    return ("image_queries", "temporal_queries")


def query_geometry(model) -> dict:
    """At the checkpoint, from the weights alone (reference :551-573)."""
    perc = model.perceiver
    with torch.no_grad():
        banks = [getattr(perc, n).float() for n in _bank_names(perc)]
        img_q, ts_q = banks[0], banks[-1]
        K = ts_q.shape[0]
        raw_gram = _cosine_matrix(ts_q)
        img_eff = _effective_queries(perc.img_cross, img_q)
        ts_eff = _effective_event_queries(perc.event_cross, ts_q) \
            if hasattr(perc, "event_cross") else \
            _effective_queries(perc.ts_cross, ts_q)
        img_gram = _cosine_matrix(img_eff)
        ts_gram = _cosine_matrix(ts_eff)
        gap = torch.linalg.norm(img_gram - ts_gram) / K
        eye = torch.eye(K, device=raw_gram.device)
        return {
            "prototype_norms": torch.linalg.norm(ts_q, dim=-1).tolist(),
            "raw_cosine": raw_gram.tolist(),
            "image_effective_cosine": img_gram.tolist(),
            "ts_effective_cosine": ts_gram.tolist(),
            "image_ts_gram_gap": float(gap),
            # the round-1 report's scalar: ‖QQᵀ − I‖ of the row-normalized
            # bank
            "query_gram_gap": float(torch.linalg.norm(raw_gram - eye)),
        }


@contextmanager
def _grads_only_for(model, keep: Sequence[torch.Tensor]):
    """Within the block, only the tensors ``keep`` of ``model``'s
    parameters require a gradient (so the forward builds no graph for the
    weights); the flags are restored after."""
    flags = [(p, p.requires_grad) for p in model.parameters()]
    ids = {id(t) for t in keep}
    try:
        for p, _ in flags:
            p.requires_grad_(id(p) in ids)
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def _grad(out: torch.Tensor, inputs: list, retain: bool) -> list:
    """``torch.autograd.grad`` with the gradient of an input that ``out``
    does not reach (a detached or frozen path) as exact zeros."""
    gs = torch.autograd.grad(out, inputs, retain_graph=retain,
                             allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(inputs, gs)]


def make_diag_step(model, image_source: Callable, label_weights=None
                   ) -> Callable:
    """``step(x_ts, x_static, batch)`` → the per-batch diagnostics as
    float32 tensors (JAX ``make_diag_step``, :141-222): ``wper`` [3, K],
    ``jac_q`` [3, K, NB, K, D], ``valid_per_label`` [K], ``fus_sens`` [4],
    ``fus_sens_label`` [4, K], ``ts_input_grad`` [3], ``px_input_grad``
    [3] and ``batch_img_ts_cos``. ``batch`` is on the model's device and
    carries ``bin_ends``, the labels and what ``image_source`` reads."""
    perc = model.perceiver
    names = _bank_names(perc)

    def step(x_ts, x_static, batch: dict) -> dict:
        device = batch["y_multi"].device
        f32 = torch.float32
        banks = [getattr(perc, n) for n in names]
        NB, (K, D) = len(banks), banks[0].shape
        y, mask = batch["y_multi"].to(f32), batch["y_multi_mask"].to(f32)
        B = y.shape[0]
        lw = torch.ones(K, device=device) if label_weights is None else \
            torch.as_tensor(np.asarray(label_weights), dtype=f32,
                            device=device)
        x_ts = torch.as_tensor(x_ts, dtype=f32, device=device) \
            .requires_grad_(True)
        x_static = torch.as_tensor(x_static, dtype=f32, device=device)
        pixels = image_source(batch).to(f32).detach().requires_grad_(True)
        eps_i = torch.zeros(B, K, D, device=device, requires_grad=True)
        eps_t = torch.zeros(B, K, D, device=device, requires_grad=True)
        with _grads_only_for(model, banks), torch.enable_grad():
            x_in, xs = feats_to_input(x_ts, x_static)
            out = model(x_in, xs, batch["bin_ends"].to(f32), pixels,
                        return_attn=True, token_eps=(eps_i, eps_t))
            # one [K] loss vector per branch, kept apart (not stacked), so
            # that differentiating one branch never walks another's graph
            losses = [lw * masked_per_label_bce(out[_LOGIT_KEY[b]], y, mask)
                      for b in BRANCHES]
            jac_q = torch.zeros(3, K, NB, K, D, device=device)
            jac_ei = torch.zeros(3, K, B, K, D, device=device)
            jac_et = torch.zeros(3, K, B, K, D, device=device)
            for j in range(3):
                for k in range(K):
                    *gq, jac_ei[j, k], jac_et[j, k] = _grad(
                        losses[j][k], banks + [eps_i, eps_t], retain=True)
                    jac_q[j, k] = torch.stack(gq)
            # the 3 branch totals w.r.t. the raw inputs: only the image
            # branch reaches the pixels, and only through a trainable ViT
            g_in = [_grad(losses[j].sum(), [x_ts, pixels], retain=j < 2)
                    for j in range(3)]
        r = {"wper": torch.stack(losses).detach(), "jac_q": jac_q,
             "valid_per_label": mask.sum(dim=0)}
        # fusion-token sensitivity (fus branch only, reference :389-419)
        tok_i = out["img_tokens"].detach().to(f32).reshape(B, -1)
        tok_t = out["ts_tokens"].detach().to(f32).reshape(B, -1)
        tok_i_norm = torch.linalg.norm(tok_i, dim=1)             # [B]
        tok_t_norm = torch.linalg.norm(tok_t, dim=1)
        gi = torch.linalg.norm(jac_ei[2].reshape(K, B, -1), dim=-1)  # [K,B]
        gt = torch.linalg.norm(jac_et[2].reshape(K, B, -1), dim=-1)
        agg_i = torch.linalg.norm(jac_ei[2].sum(0).reshape(B, -1), dim=-1)
        agg_t = torch.linalg.norm(jac_et[2].sum(0).reshape(B, -1), dim=-1)
        r["fus_sens"] = torch.stack([
            agg_i.sum(), agg_t.sum(),
            (agg_i * tok_i_norm).sum(), (agg_t * tok_t_norm).sum()])
        r["fus_sens_label"] = torch.stack([
            gi.sum(1), gt.sum(1), (gi * tok_i_norm[None, :]).sum(1),
            (gt * tok_t_norm[None, :]).sum(1)])                  # [4, K]
        r["ts_input_grad"] = torch.stack(
            [torch.linalg.norm(g[0].reshape(-1)) for g in g_in])
        r["px_input_grad"] = torch.stack(
            [torch.linalg.norm(g[1].reshape(-1)) for g in g_in])
        agg = jac_q.sum(dim=1)                                   # [3,NB,K,D]
        r["batch_img_ts_cos"] = _cos(agg[0], agg[1])
        return r

    return step


def run_diagnostics(model, anchor_ds, image_source: Callable,
                    split: str = "val", batch_size: int = 32,
                    n_batches: int = 4, alphas: tuple = (0.5, 0.5, 1.0),
                    label_weights=None,
                    label_names: Optional[Sequence[str]] = None,
                    image_hook: Optional[Callable[[dict], dict]] = None
                    ) -> dict:
    """The report over the first ``n_batches`` full batches of ``split``
    (JAX ``run_diagnostics``, :225-). ``image_hook``: a host batch hook
    that attaches what ``image_source`` reads (e.g. the JPEG decode or the
    loop's procedural pixels); None when the source draws the pixels
    itself."""
    mode = model.cfg.perceiver_type
    if mode not in PATCH_MODES:
        raise ValueError(
            f"grad-flow diagnostics target the patch teacher modes (got "
            f"perceiver_type={mode!r}): the reference CLI enforces the same "
            "(grad_flow_diagnostics.py:782-783)")
    device = next(model.parameters()).device
    step = make_diag_step(model, image_source, label_weights)
    a = anchor_ds.anchor
    idx_all = anchor_ds.splits[split]
    sums: dict = {}
    cos_list: list = []
    nb, n_samples = 0, 0
    for i in range(0, min(len(idx_all), n_batches * batch_size), batch_size):
        idx = idx_all[i:i + batch_size]
        if len(idx) < batch_size:
            break
        x_ts, x_static = gather_host_windows(anchor_ds, idx)
        batch = {
            "image_ids": a["image_ids"][idx].astype(np.int32),
            "y_multi": a["y_multi"][idx],
            "y_multi_mask": a["y_multi_mask"][idx],
            "bin_ends": np.broadcast_to(
                anchor_ds.bin_ends,
                (len(idx), anchor_ds.n_timesteps)).copy(),
        }
        if image_hook is not None:
            batch = image_hook(batch)
        out = step(x_ts, x_static, to_device(batch, device))
        out = {k: v.detach().cpu().numpy() for k, v in out.items()}
        cos_list.append(float(out.pop("batch_img_ts_cos")))
        for k, v in out.items():
            sums[k] = sums.get(k, 0.0) + v.astype(np.float64)
        nb += 1
        n_samples += len(idx)
    if nb == 0:
        raise RuntimeError("the diagnostic split yielded no full batches")
    return _report(sums, cos_list, nb, n_samples, alphas, label_names,
                   query_geometry(model))


def _report(sums: dict, cos_list: list, nb: int, n_samples: int,
            alphas: tuple, label_names, geometry: dict) -> dict:
    K = sums["jac_q"].shape[1]
    n_banks = sums["jac_q"].shape[2]
    # each branch's own query bank: the image branch reads bank 0, ts and
    # fus the last (one and the same bank in the shared layout)
    bank_of = {"img": 0, "ts": n_banks - 1, "fus": n_banks - 1}
    if label_names is None:
        label_names = [f"label_{k}" for k in range(K)]
    alphas_d = dict(zip(BRANCHES, alphas))

    mean_jac = sums["jac_q"] / nb                    # [3, K, NB, K, D]
    mean_agg = mean_jac.sum(axis=1)                  # [3, NB, K, D]
    losses = sums["wper"].sum(axis=1) / nb           # [3]
    valid = sums["valid_per_label"]                  # [K]

    def norm(x):
        return float(np.linalg.norm(np.asarray(x).ravel()))

    def cosn(x, y):
        d = norm(x) * norm(y)
        return float(np.dot(np.asarray(x).ravel(), np.asarray(y).ravel())
                     / d) if d > _EPS else 0.0

    weighted = {b: alphas_d[b] * mean_agg[j]
                for j, b in enumerate(BRANCHES)}
    total_update = sum(weighted.values())
    branch_report = {}
    for j, b in enumerate(BRANCHES):
        branch_report[b] = {
            "loss": float(losses[j]),
            "alpha": float(alphas_d[b]),
            "raw_grad_norm": norm(mean_agg[j]),
            "weighted_grad_norm": norm(weighted[b]),
            "cos_to_total_update": cosn(weighted[b], total_update),
        }

    fus_sens = sums["fus_sens"] / max(n_samples, 1)  # [4]
    sens_report = {
        "img_raw": float(fus_sens[0]), "ts_raw": float(fus_sens[1]),
        "img_scaled": float(fus_sens[2]), "ts_scaled": float(fus_sens[3]),
    }
    sens_report["raw_img_over_ts"] = sens_report["img_raw"] / max(
        sens_report["ts_raw"], _EPS)
    sens_report["scaled_img_over_ts"] = sens_report["img_scaled"] / max(
        sens_report["ts_scaled"], _EPS)

    label_sens = sums["fus_sens_label"]              # [4, K]
    per_label = []
    for k in range(K):
        g = {b: mean_jac[j, k] for j, b in enumerate(BRANCHES)}
        full = {b: norm(g[b]) for b in BRANCHES}
        own = {b: float(np.linalg.norm(mean_jac[j, k, bank_of[b], k]))
               for j, b in enumerate(BRANCHES)}
        total_k = sum(alphas_d[b] * g[b] for b in BRANCHES)
        vk = max(float(valid[k]), 1.0)
        ls = {key: float(label_sens[i, k] / vk)
              for i, key in enumerate(
                  ("img_raw", "ts_raw", "img_scaled", "ts_scaled"))}
        ls["scaled_img_over_ts"] = ls["img_scaled"] / max(ls["ts_scaled"],
                                                          _EPS)
        per_label.append({
            "label": str(label_names[k]) if k < len(label_names)
            else f"label_{k}",
            "valid_samples": int(round(float(valid[k]))),
            "img_grad_norm": full["img"],
            "ts_grad_norm": full["ts"],
            "fus_grad_norm": full["fus"],
            "img_ts_cos": cosn(g["img"], g["ts"]),
            "img_fus_cos": cosn(g["img"], g["fus"]),
            "ts_fus_cos": cosn(g["ts"], g["fus"]),
            "weighted_total_grad_norm": norm(total_k),
            "img_own_query_fraction": own["img"] / max(full["img"], _EPS),
            "ts_own_query_fraction": own["ts"] / max(full["ts"], _EPS),
            "fus_own_query_fraction": own["fus"] / max(full["fus"], _EPS),
            "fusion_token_sensitivity": ls,
        })

    report = {
        "query_parameter": "perceiver/shared_queries" if n_banks == 1 else
        "perceiver/image_queries+perceiver/temporal_queries",
        "query_layout": "shared" if n_banks == 1 else "independent",
        "batches": nb,
        "samples": n_samples,
        "n_batches": nb,   # the round-1 key
        "branch": branch_report,
        "pairwise_gradient_cosine": {
            "img_ts": cosn(mean_agg[0], mean_agg[1]),
            "img_fus": cosn(mean_agg[0], mean_agg[2]),
            "ts_fus": cosn(mean_agg[1], mean_agg[2]),
            "img_ts_batch_mean": float(np.mean(cos_list)),
            "img_ts_negative_batch_fraction": float(
                np.mean([c < 0 for c in cos_list])),
        },
        "weighted_img_over_ts": branch_report["img"]["weighted_grad_norm"]
        / max(branch_report["ts"]["weighted_grad_norm"], _EPS),
        "fusion_token_sensitivity": sens_report,
        "per_label": per_label,
        "query_geometry": geometry,
    }
    # the flat scalars the in-loop logger and the tests read
    for j, b in enumerate(BRANCHES):
        report[f"{b}_query_grad_norm"] = norm(mean_agg[j])
        report[f"{b}_ts_input_grad"] = float(sums["ts_input_grad"][j] / nb)
        report[f"{b}_px_input_grad"] = float(sums["px_input_grad"][j] / nb)
    for pair in ("img_ts", "img_fus", "ts_fus"):
        report[f"{pair}_query_grad_cos"] = report[
            "pairwise_gradient_cosine"][pair]
    report["query_gram_gap"] = geometry["query_gram_gap"]
    img_rows = np.linalg.norm(mean_agg[0, bank_of["img"]], axis=-1)
    ts_rows = np.linalg.norm(mean_agg[1, bank_of["ts"]], axis=-1)
    report["per_label_img_query_grad"] = img_rows.tolist()
    report["per_label_ts_query_grad"] = ts_rows.tolist()
    report["per_label_img_dominance"] = (
        img_rows / (img_rows + ts_rows + _EPS)).tolist()
    return report


def diagnostics_to_log_dict(r: dict, labels=None,
                            prefix: str = "grad_diag") -> dict:
    """A report flattened into scalar keys: the reference's
    ``gradient_diagnostics_to_log_dict`` (grad_flow_diagnostics.py:705-751);
    the teacher loop keeps them in its history."""
    out = {}
    for b, item in r.get("branch", {}).items():
        for key in ("loss", "raw_grad_norm", "weighted_grad_norm",
                    "cos_to_total_update"):
            out[f"{prefix}/{b}/{key}"] = float(item[key])
    for key, v in r.get("pairwise_gradient_cosine", {}).items():
        out[f"{prefix}/cosine/{key}"] = float(v)
    if "weighted_img_over_ts" in r:
        out[f"{prefix}/dominance/weighted_img_over_ts"] = float(
            r["weighted_img_over_ts"])
    for key in ("raw_img_over_ts", "scaled_img_over_ts"):
        if key in r.get("fusion_token_sensitivity", {}):
            out[f"{prefix}/fusion_sensitivity/{key}"] = float(
                r["fusion_token_sensitivity"][key])
    if "query_geometry" in r:
        out[f"{prefix}/query_geometry/image_ts_gram_gap"] = float(
            r["query_geometry"]["image_ts_gram_gap"])
    for item in r.get("per_label", []):
        base = f"{prefix}/label/{item['label'].replace('/', '_')}"
        for key in ("img_grad_norm", "ts_grad_norm", "fus_grad_norm",
                    "img_ts_cos"):
            out[f"{base}/{key}"] = float(item[key])
        out[f"{base}/fusion_scaled_img_over_ts"] = float(
            item["fusion_token_sensitivity"]["scaled_img_over_ts"])
    # the flat scalars (the input sensitivity has no reference counterpart)
    for k, v in r.items():
        if isinstance(v, (int, float)) and k not in out:
            out[f"{prefix}/{k}"] = float(v)
        elif isinstance(v, (list, tuple)) and k.startswith("per_label_"):
            for i, x in enumerate(v):
                name = (labels[i].replace("/", "_")
                        if labels is not None and i < len(labels) else str(i))
                out[f"{prefix}/label/{name}/{k}"] = float(x)
    return out


def format_report(r: dict) -> str:
    """The console summary (reference ``format_gradient_diagnostics``,
    :613-702)."""
    lines = [
        f"[grad-diag] parameter={r['query_parameter']} "
        f"layout={r['query_layout']} batches={r['batches']} "
        f"samples={r['samples']}",
        "",
        "branch      loss    alpha    ||g raw||   ||alpha*g||   cos(g,total)",
        "-------------------------------------------------------------------",
    ]
    for b in BRANCHES:
        item = r["branch"][b]
        lines.append(
            f"{b:<7} {item['loss']:>9.5f} {item['alpha']:>7.3f} "
            f"{item['raw_grad_norm']:>12.6g} "
            f"{item['weighted_grad_norm']:>13.6g} "
            f"{item['cos_to_total_update']:>14.5f}")
    c = r["pairwise_gradient_cosine"]
    s = r["fusion_token_sensitivity"]
    lines.extend([
        "",
        f"gradient cosine: img-ts={c['img_ts']:+.5f}  "
        f"img-fus={c['img_fus']:+.5f}  ts-fus={c['ts_fus']:+.5f}",
        f"batch img-ts cosine: mean={c['img_ts_batch_mean']:+.5f}  "
        f"negative_fraction={c['img_ts_negative_batch_fraction']:.3f}",
        f"weighted gradient dominance: "
        f"img/ts={r['weighted_img_over_ts']:.4f}",
        f"fusion token sensitivity: "
        f"raw img/ts={s['raw_img_over_ts']:.4f}  "
        f"scale-normalized img/ts={s['scaled_img_over_ts']:.4f}",
        "",
        "input sensitivity  |dL/dTS|   |dL/dPX|   (fus→PX must be ~0: "
        "residual fusion stop-grads the image anchor)",
    ])
    for b in BRANCHES:
        lines.append(f"  {b:<6s} {r[f'{b}_ts_input_grad']:>10.4f} "
                     f"{r[f'{b}_px_input_grad']:>10.4f}")
    lines.extend([
        "",
        "label                         ||g_img||   ||g_ts||  cos(i,t)  "
        "fusSens(i/t)  ownQ(img/ts/fus)",
        "-" * 100,
    ])
    for item in r["per_label"]:
        ts_sens = item["fusion_token_sensitivity"]
        lines.append(
            f"{item['label']:<28} "
            f"{item['img_grad_norm']:>10.5g} "
            f"{item['ts_grad_norm']:>10.5g} "
            f"{item['img_ts_cos']:>+9.4f} "
            f"{ts_sens['scaled_img_over_ts']:>13.4f} "
            f"{item['img_own_query_fraction']:.2f}/"
            f"{item['ts_own_query_fraction']:.2f}/"
            f"{item['fus_own_query_fraction']:.2f}")
    g = r["query_geometry"]
    lines.extend([
        "",
        "query geometry: prototype norms="
        + ", ".join(f"{v:.4f}" for v in g["prototype_norms"]),
        f"effective image-vs-TS Gram gap={g['image_ts_gram_gap']:.6f}",
        f"query Gram gap ||QQ^T - I|| = {g['query_gram_gap']:.4f}",
    ])
    return "\n".join(lines)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("gradient-flow diagnostics")
    add_analysis_flags(p)
    p.add_argument("--n_batches", type=int, default=4)
    p.add_argument("--alpha_img", type=float, default=0.5)
    p.add_argument("--alpha_ts", type=float, default=0.5)
    p.add_argument("--alpha_fus", type=float, default=1.0)
    args = p.parse_args(argv)
    if getattr(args, "cxr_feature_cache", "none") != "none":
        p.error("--cxr_feature_cache is not applicable here: the pixel-"
                "input sensitivity diagnostics (px_input_grad) differentiate "
                "the loss w.r.t. PIXELS, which the encode-once tier removes")
    model, cfg, _ = load_teacher(args.ckpt, args.device)
    _, _, anchor_ds, dcfg = load_analysis_data(
        args, n_variables=cfg.duett.n_variables)
    image_source = make_image_source(args, anchor_ds, cfg.vit)
    labels = list(dcfg.pathology_labels)[:cfg.perceiver.n_pathologies]
    r = run_diagnostics(model, anchor_ds, image_source, args.split,
                        args.batch_size, args.n_batches,
                        alphas=(args.alpha_img, args.alpha_ts,
                                args.alpha_fus),
                        label_names=labels, image_hook=anchor_ds.batch_hook)
    txt = format_report(r)
    print(txt)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "grad_flow_report.txt"), "w") as f:
        f.write(txt + "\n")
    for name in ("grad_flow.json", "grad_flow_report.json"):
        save_json(r, args.out_dir, name)
    return r


if __name__ == "__main__":
    main()
