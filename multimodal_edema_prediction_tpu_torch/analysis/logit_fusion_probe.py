"""Oracle late-fusion probe on the frozen branches' logits: the counterpart
of ``multimodal_edema_prediction_tpu/analysis/logit_fusion_probe.py``
(reference ``analysis/logit_fusion_probe.py``). Bounds from above what any
fusion rule could extract from the two branches' logits alone:

    per_label  per-pathology 2→1 linear head, image-passthrough init
               (weight [1, 0], bias 0): training starts at the image branch
    linear     joint 2K→K linear map
    mlp        2K→64→K with GELU (tanh form, ``jax.nn.gelu``'s default)

Every head trains by full-batch Adam (optax's, ``common.adam``) on the
masked multi-label BCE of the train split's logits, from JAX's random
init (``data/pipeline.jax_normal``: ``jax.random``'s threefry draws);
the eval split's per-label and macro AUROC stand beside the image and TS
branches'.

    python -m multimodal_edema_prediction_tpu_torch.analysis.logit_fusion_probe \\
        --ckpt runs/<run>/best-*.msgpack --device cuda [--cxr_feature_cache hbm]
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from ..data.pipeline import jax_key, jax_normal, jax_split
from ..ops import metrics as M
from ..ops.losses import masked_per_label_bce
from ..train import engine
from ..train.evaluator import collect_dual_outputs
from .common import add_analysis_flags, adam, load_for_analysis, save_json

HEADS = ("per_label", "linear", "mlp")


def make_head(kind: str, K: int, key: Tuple[int, int], device="cpu"
              ) -> Tuple[Dict[str, torch.Tensor], Callable]:
    """(parameters, fn(params, img, ts) → logits) of one probe head, its
    init drawn as JAX's ``make_head`` draws it from ``key``."""
    def zeros(*shape):
        return torch.zeros(shape, device=device)

    if kind == "per_label":
        params = {"w": torch.tensor([[1.0], [0.0]], device=device)
                  .repeat(1, K), "b": zeros(K)}

        def fn(p, img, ts):
            return img * p["w"][0] + ts * p["w"][1] + p["b"]
    elif kind == "linear":
        params = {"w": 0.01 * jax_normal(key, (2 * K, K), device),
                  "b": zeros(K)}

        def fn(p, img, ts):
            return torch.cat([img, ts], dim=1) @ p["w"] + p["b"]
    elif kind == "mlp":
        k1, k2 = jax_split(key)
        params = {"w1": 0.1 * jax_normal(k1, (2 * K, 64), device),
                  "b1": zeros(64),
                  "w2": 0.1 * jax_normal(k2, (64, K), device),
                  "b2": zeros(K)}

        def fn(p, img, ts):
            h = F.gelu(torch.cat([img, ts], dim=1) @ p["w1"] + p["b1"],
                       approximate="tanh")
            return h @ p["w2"] + p["b2"]
    else:
        raise ValueError(kind)
    return params, fn


def train_fusion_head(kind: str, tr: dict, ev: dict, steps: int = 500,
                      lr: float = 5e-2, seed: int = 0, device="cpu") -> dict:
    K = tr["y"].shape[1]
    params, fn = make_head(kind, K, jax_key(seed), device)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    img, ts, y, m = t(tr["img"]), t(tr["ts"]), t(tr["y"]), t(tr["mask"])
    params = adam(lambda p: masked_per_label_bce(fn(p, img, ts), y, m).sum(),
                  params, lr, steps)
    with torch.no_grad():
        ev_logits = fn(params, t(ev["img"]), t(ev["ts"])).cpu().numpy()
    rows = M.masked_multilabel_metrics(ev["y"], ev["mask"],
                                       {"fusion": ev_logits})
    return {"per_label": rows,
            "macro_auroc": M.macro_mean(rows, "fusion_auroc")}


def main(argv=None, dtype=torch.bfloat16) -> dict:
    """``dtype``: the eval's compute precision (the CLI's is bf16, as the
    JAX script's); the probes train in float32."""
    p = argparse.ArgumentParser("oracle logit-fusion probe")
    add_analysis_flags(p)
    p.add_argument("--probe_steps", type=int, default=500)
    args = p.parse_args(argv)
    model, _, anchor_ds, _, image_source, feature_source = \
        load_for_analysis(args, dtype)
    eval_step = engine.make_teacher_eval(anchor_ds.n_timesteps, dtype,
                                         image_source=image_source,
                                         feature_source=feature_source)
    tr = collect_dual_outputs(eval_step, model, anchor_ds, "train",
                              args.batch_size)
    ev = collect_dual_outputs(eval_step, model, anchor_ds, args.split,
                              args.batch_size)
    base = M.masked_multilabel_metrics(ev["y"], ev["mask"],
                                       {"img": ev["img"], "ts": ev["ts"],
                                        "fus": ev["fus"]})
    results = {"base": {
        "img_macro_auroc": M.macro_mean(base, "img_auroc"),
        "ts_macro_auroc": M.macro_mean(base, "ts_auroc"),
        "trained_fus_macro_auroc": M.macro_mean(base, "fus_auroc")}}
    device = next(model.parameters()).device
    for kind in HEADS:
        results[kind] = train_fusion_head(kind, tr, ev, args.probe_steps,
                                          seed=args.seed, device=device)
    print(f"{'head':<12s} {'macroROC':>9s}")
    print(f"{'img (base)':<12s} {results['base']['img_macro_auroc']:>9.4f}")
    print(f"{'ts (base)':<12s} {results['base']['ts_macro_auroc']:>9.4f}")
    print(f"{'fus (model)':<12s} "
          f"{results['base']['trained_fus_macro_auroc']:>9.4f}")
    for kind in HEADS:
        print(f"{kind:<12s} {results[kind]['macro_auroc']:>9.4f}")
    out = save_json(results, args.out_dir, "logit_fusion_probe.json")
    print(f"saved → {out}")
    return results


if __name__ == "__main__":
    main()
