#!/usr/bin/env python3
"""The feather fixtures of the L0 chain, written by pandas and pyarrow.

    python3 scripts/make_feather_goldens.py [OUT_DIR]

Writes the 24-subject raw MIMIC-IV + MIMIC-CXR rehearsal layout (seed 0,
``data/synthetic_raw.py``, byte-equal to the JAX package's) and converts
each table as the reference converts its downloads (groundwork cell 3):
``pd.read_csv(p).to_feather(q, compression=c)`` for c in lz4 and zstd,
into ``OUT_DIR/{lz4,zstd}/<table>.ftr`` (default
``tests/goldens/feather_l0``). The card's host has neither pandas nor
pyarrow, so ``chip_smoke.py``'s ``l0`` phase reads these committed files
with the port's own reader; ``tests/test_torch_feather.py`` holds them
equal, frame for frame, to what this script writes now.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from multimodal_edema_prediction_tpu_torch.data.synthetic_raw import \
    make_raw_layout  # noqa: E402

CODECS = ("lz4", "zstd")
DEFAULT_OUT = os.path.join(REPO, "tests", "goldens", "feather_l0")


def make_goldens(out_dir: str) -> dict:
    """{codec: [table paths relative to ``out_dir/codec``]}."""
    import pandas as pd
    written = {}
    with tempfile.TemporaryDirectory() as raw:
        make_raw_layout(raw, n_subjects=24, seed=0)
        tables = sorted(os.path.relpath(p, raw)[:-len(".csv")]
                        for p in glob.glob(os.path.join(raw, "*", "*.csv")))
        for codec in CODECS:
            for rel in tables:
                q = os.path.join(out_dir, codec, rel + ".ftr")
                os.makedirs(os.path.dirname(q), exist_ok=True)
                pd.read_csv(os.path.join(raw, rel + ".csv")).to_feather(
                    q, compression=codec)
            written[codec] = [t + ".ftr" for t in tables]
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("out_dir", nargs="?", default=DEFAULT_OUT)
    args = p.parse_args(argv)
    for codec, tables in make_goldens(args.out_dir).items():
        print(f"{codec}: {len(tables)} tables under "
              f"{os.path.join(args.out_dir, codec)}")


if __name__ == "__main__":
    main()
