#!/usr/bin/env python3
"""Chest-X-ray-like test JPEGs, written in numpy.

    python3 scripts/jpeg_fixtures.py OUT_DIR 50000 50001 ... [--height H]
        [--width W] [--quality Q]

Writes ``{image_id}.jpg`` for each id through the port's baseline
grayscale writer (``multimodal_edema_prediction_tpu_torch/data/
jpeg_writer.py``: one component, baseline sequential DCT, the standard
tables of ITU-T T.81 Annex K, no restart markers). Each image is drawn
from its id (``cxr_like``): a smooth body with two lung fields, ribs and a
marker whose place and size follow the id, plus seeded noise, so that two
ids never give the same pixels and a wrong id → row mapping shows. The tests and
``chip_smoke.py`` import it (the card's host has no PIL); the drawing and
the CLI are not part of the port.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from multimodal_edema_prediction_tpu_torch.data.jpeg_writer import \
    encode_gray  # noqa: E402

# MIMIC-CXR-JPG's files are of the order of 3056 x 2544, one component
MIMIC_CXR_SHAPE = (3056, 2544)


def cxr_like(image_id: int, height: int, width: int) -> np.ndarray:
    """A [height, width] uint8 chest-X-ray-like image drawn from
    ``image_id``: a bright body with two dark lung fields, rib arcs and a
    bright marker whose place and radius follow the id, plus seeded
    noise."""
    rng = np.random.default_rng(int(image_id))
    y = np.linspace(-1.0, 1.0, height, dtype=np.float32)[:, None]
    x = np.linspace(-1.0, 1.0, width, dtype=np.float32)[None, :]
    img = 150.0 + 60.0 * np.exp(-(x ** 2) * 1.5) - 40.0 * y
    for side in (-1.0, 1.0):
        cx = side * (0.42 + 0.08 * rng.random())
        lung = ((x - cx) / 0.3) ** 2 + ((y + 0.05) / 0.62) ** 2
        img -= 70.0 * np.exp(-lung ** 2)
    img += 18.0 * np.sin(y * (18.0 + 6.0 * rng.random()) + x ** 2 * 3.0)
    my, mx = rng.uniform(-0.7, 0.7, 2)
    r = 0.04 + 0.08 * rng.random()
    img += 90.0 * ((((y - my) ** 2 + (x - mx) ** 2) < r ** 2))
    img += 4.0 * rng.standard_normal((height, width), np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_one(out_dir: str, image_id: int, height: int, width: int,
              quality: int = 90) -> int:
    """Write ``{out_dir}/{image_id}.jpg``; returns its bytes."""
    blob = encode_gray(cxr_like(int(image_id), height, width), quality)
    with open(os.path.join(out_dir, f"{int(image_id)}.jpg"), "wb") as f:
        f.write(blob)
    return len(blob)


def write_jpegs(out_dir: str, image_ids, height: int, width: int,
                quality: int = 90, processes: int = 0) -> dict:
    """Write ``{id}.jpg`` for each id; returns {id: bytes written}. With
    ``processes`` > 1 the ids are split over that many runs of this script
    as subprocesses, all waited for."""
    os.makedirs(out_dir, exist_ok=True)
    ids = [int(i) for i in image_ids]
    if processes <= 1 or len(ids) < 2:
        return {i: write_one(out_dir, i, height, width, quality)
                for i in ids}
    import subprocess
    import sys
    # one BLAS thread each: the processes are the parallelism
    env = {**os.environ, "OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
           "MKL_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), out_dir,
         *map(str, ids[k::processes]), "--height", str(height), "--width",
         str(width), "--quality", str(quality)],
        stdout=subprocess.DEVNULL, env=env)
        for k in range(min(processes, len(ids)))]
    failed = [p.args for p in procs if p.wait() != 0]
    if failed:
        raise RuntimeError(f"writing JPEGs failed: {failed[0][:4]}")
    return {i: os.path.getsize(os.path.join(out_dir, f"{i}.jpg"))
            for i in ids}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir")
    p.add_argument("image_ids", type=int, nargs="+")
    p.add_argument("--height", type=int, default=MIMIC_CXR_SHAPE[0])
    p.add_argument("--width", type=int, default=MIMIC_CXR_SHAPE[1])
    p.add_argument("--quality", type=int, default=90)
    a = p.parse_args(argv)
    sizes = write_jpegs(a.out_dir, a.image_ids, a.height, a.width, a.quality)
    print(f"wrote {len(sizes)} JPEGs, {sum(sizes.values())} bytes, to "
          f"{a.out_dir}")


if __name__ == "__main__":
    main()
