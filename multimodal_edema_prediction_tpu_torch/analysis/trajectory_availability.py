"""Data audit: is there enough within-window trajectory signal to encode?
The counterpart of
``multimodal_edema_prediction_tpu/analysis/trajectory_availability.py``
(reference ``analysis/trajectory_availability.py``, audit_dataset
:56-139), on the host: per variable, the fraction of windows with >= 2 and
>= 3 observed hours, the mean recency of the last observation and the
within-window std of the observed values; the verdict SPARSE or
TRAJECTORY-RICH.

    python -m multimodal_edema_prediction_tpu_torch.analysis.trajectory_availability \\
        --device cuda --out_dir analysis_out
"""
from __future__ import annotations

import argparse

import numpy as np

from ..utils import resolve_device
from .common import (add_analysis_flags, gather_host_windows,
                     load_analysis_data, save_json)


def audit_dataset(anchor_ds, var_names, split: str = "train",
                  max_samples: int = 2000) -> dict:
    idx = anchor_ds.splits[split][:max_samples]
    x_ts, _ = gather_host_windows(anchor_ds, idx)
    V = len(var_names)
    values, counts = x_ts[..., :V], x_ts[..., V:]
    observed = counts > 0                          # [N, T, V]
    T = observed.shape[1]

    obs_hours = observed.sum(axis=1)               # [N, V]
    last_obs = np.where(observed.any(axis=1),
                        T - 1 - np.argmax(observed[:, ::-1, :], axis=1),
                        -1)
    recency = np.where(last_obs >= 0, T - 1 - last_obs, np.nan)

    per_var = []
    for v in range(V):
        vals = np.where(observed[:, :, v], values[:, :, v], np.nan)
        with np.errstate(all="ignore"):
            stds = np.nanstd(vals, axis=1)
        per_var.append({
            "name": var_names[v],
            "ge2_rate": float((obs_hours[:, v] >= 2).mean()),
            "ge3_rate": float((obs_hours[:, v] >= 3).mean()),
            "mean_obs_hours": float(obs_hours[:, v].mean()),
            "mean_recency": float(np.nanmean(recency[:, v])),
            "mean_within_window_std": float(np.nanmean(stds)),
        })
    ge2 = float(np.mean([r["ge2_rate"] for r in per_var]))
    verdict = "TRAJECTORY-RICH" if ge2 > 0.5 else "SPARSE"
    return {"n_samples": int(len(idx)), "per_var": per_var,
            "macro_ge2_rate": ge2, "verdict": verdict}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("trajectory availability audit")
    add_analysis_flags(p, needs_ckpt=False)
    p.add_argument("--max_samples", type=int, default=2000)
    args = p.parse_args(argv)
    resolve_device(args.device)
    _, meta, anchor_ds, _ = load_analysis_data(args)
    result = audit_dataset(anchor_ds, list(meta.all_vars), args.split,
                           args.max_samples)
    print(f"{'variable':<14s} {'>=2h':>6s} {'>=3h':>6s} {'hrs':>6s} "
          f"{'recency':>8s} {'std':>7s}")
    for r in result["per_var"]:
        print(f"{r['name']:<14s} {r['ge2_rate']:>6.3f} {r['ge3_rate']:>6.3f} "
              f"{r['mean_obs_hours']:>6.2f} {r['mean_recency']:>8.2f} "
              f"{r['mean_within_window_std']:>7.3f}")
    print(f"\nverdict: {result['verdict']} "
          f"(macro ≥2h rate {result['macro_ge2_rate']:.3f})")
    save_json(result, args.out_dir, "trajectory_availability.json")
    return result


if __name__ == "__main__":
    main()
