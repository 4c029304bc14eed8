"""CLI: raw MIMIC-IV-layout directory → training-ready cohort artifacts.

The port's counterpart of ``multimodal_edema_prediction_tpu/cli/
preprocess.py``, with the same flags and defaults. One command replaces
the reference's six preprocessing notebooks (SURVEY §2.3): it runs the
full L0 chain (:mod:`..data.raw_mimic`, numpy only) and leaves
``cohort.npz`` + ``meta_with_stats.pkl`` (plus the reference-format
``final_df`` / ``static_full`` / ``final_cxr_df`` frames for auditing, as
``.ftr``) in ``--out_dir``, ready for ``--data_dir`` of every training
CLI.

Expected layout under ``--raw_root`` (each table as ``.ftr``,
``.feather``, ``.csv`` or ``.csv.gz``, tried in that order; feather as
``DataFrame.to_feather`` writes it, LZ4, ZSTD or uncompressed):
    hosp/admissions  hosp/patients  hosp/labevents  [hosp/omr]
    [hosp/diagnoses_icd]  icu/icustays  icu/chartevents  icu/inputevents
    icu/outputevents  cxr/mimic-cxr-2.0.0-metadata
    cxr/mimic-cxr-2.0.0-chexpert  [cxr/CXLSeg-mask]
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--raw_root", required=True,
                   help="directory laid out like a MIMIC-IV + MIMIC-CXR "
                        "download, tables as .ftr/.feather/.csv/.csv.gz "
                        "(see module docstring)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--n_timesteps", type=int, default=24)
    p.add_argument("--label_policy", default="to_positive",
                   choices=["to_positive", "to_zero", "keep"],
                   help="CXR-head uncertain-label policy (cxr_db cell 24; "
                        "anchors always keep raw labels)")
    p.add_argument("--split_seed", type=int, default=42)
    p.add_argument("--count_clip", type=int, default=15)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..data.raw_mimic import run_l0
    paths = run_l0(args.raw_root, args.out_dir,
                   n_timesteps=args.n_timesteps,
                   label_policy=args.label_policy,
                   split_seed=args.split_seed, count_clip=args.count_clip)
    for k, v in paths.items():
        print(f"[l0] {k}: {v}")
    return paths


if __name__ == "__main__":
    main()
