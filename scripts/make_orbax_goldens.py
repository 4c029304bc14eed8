#!/usr/bin/env python3
"""An orbax train state written by the JAX package, for readers without
orbax.

    python3 scripts/make_orbax_goldens.py [OUT_DIR]

Takes the tree of a tiny teacher of the JAX package and keeps a few of its
subtrees, one or more for each of ``make_optimizer``'s groups (``SUBTREES``:
DuETT's embedding layers, with their BatchNorm statistics, one cast to
bfloat16, for the backbone; the shared queries; the correction head and β;
the time-series projection for the rest; the image projection, frozen), so
that the store stays small: orbax's ``_METADATA`` names every leaf of every
group. The optimizer state is ``make_optimizer``'s (``grad_clip > 0``) as
after one step: every leaf, weights and moments, drawn from a numpy seed
(no XLA arithmetic, so the state is the same bits on any host), every
count 1. The JAX package's ``train/orbax_io.py::save_state`` writes it as
step 1 into ``OUT_DIR`` (default ``tests/goldens/orbax_state``): orbax's own
two-level OCDBT store, zstd nodes and chunks, with ``<f4``, ``<i4`` and one
``bfloat16`` leaf. Beside it, ``OUT_DIR/expected.npz`` holds every array by
its dotted orbax name (the bfloat16 leaf as its uint16 bits) and
``__dtypes__``, the JSON of each name's zarr dtype. The card's host has no
orbax: ``chip_smoke.py``'s ``resume`` phase reads the committed store with
the port's own reader (``train/orbax_io.py::read_arrays``) and holds it to
``expected.npz``; ``tests/test_torch_orbax.py`` holds the committed files
to what this script writes now, by content (orbax's file names and
timestamps differ between runs).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
DEFAULT_OUT = os.path.join(REPO, "tests", "goldens", "orbax_state")
STEP = 1
SUBTREES = {"duett": ("embedding_layers", "special_embeddings"),
            "perceiver": ("shared_queries", "correction_head", "beta",
                          "ts_proj"),
            "img_proj": None}


def tiny_teacher_config():
    from multimodal_edema_prediction_tpu.config import (DuettConfig,
                                                        PerceiverConfig,
                                                        TeacherConfig,
                                                        ViTConfig)
    return TeacherConfig(
        duett=DuettConfig(n_variables=4, n_timesteps=8, d_static=6,
                          d_embedding=4, n_layers=1, d_feedforward=8,
                          d_hidden_mlp_embedding=8, d_hidden_tab_encoder=8),
        vit=ViTConfig(image_size=28, patch_size=14, d_model=8, n_layers=1,
                      n_heads=2, d_feedforward=16),
        perceiver=PerceiverConfig(n_pathologies=7, d_latent=8, n_heads=2,
                                  head_hidden=8))


def jax_state():
    """The JAX TrainState: the tiny teacher's subtrees, as after one
    step."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from multimodal_edema_prediction_tpu.config import OptimConfig
    from multimodal_edema_prediction_tpu.models.teacher import TeacherModel
    from multimodal_edema_prediction_tpu.train.optim import make_optimizer
    from multimodal_edema_prediction_tpu.train.state import TrainState
    from multimodal_edema_prediction_tpu.train.teacher_loop import \
        init_teacher
    cfg = tiny_teacher_config()
    # the tree's shapes only: every value is drawn below
    v = jax.eval_shape(lambda: init_teacher(
        TeacherModel(cfg), cfg, 2, cfg.duett.n_timesteps, jax.random.key(0)))
    rng = np.random.default_rng(0)

    def draw(x, positive=False):
        a = rng.standard_normal(x.shape).astype(np.float32)
        return jnp.asarray(np.abs(a) if positive else a)

    params = jax.tree.map(draw, {
        top: v["params"][top] if keep is None else
        {k: v["params"][top][k] for k in keep}
        for top, keep in SUBTREES.items()})
    stats = jax.tree.map(lambda x: draw(x, True), {"duett": {
        "embedding_layers": v["batch_stats"]["duett"]["embedding_layers"]}})
    stats["duett"]["embedding_layers"]["mean"] = \
        stats["duett"]["embedding_layers"]["mean"].astype(jnp.bfloat16)
    tx = make_optimizer(OptimConfig(lr=1e-2, warmup_steps=2, grad_clip=0.5),
                        10, frozen_prefixes=("img_proj/",))
    state = TrainState.create(params, stats, tx)

    def after_one_step(path, x):
        names = [getattr(k, "name", None) for k in path]
        if names[-1] == "count":
            return jnp.ones((), jnp.int32)
        return draw(x, positive="nu" in names)

    return state.replace(
        step=jnp.ones((), jnp.int32),
        opt_state=jax.tree_util.tree_map_with_path(after_one_step,
                                                   state.opt_state))


def expected_arrays(state) -> dict:
    """{dotted orbax name: numpy array} of the state's leaves."""
    import jax
    import numpy as np
    tree = {"params": state.params, "batch_stats": state.batch_stats,
            "opt_state": state.opt_state, "step": state.step}
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "name", getattr(
            k, "idx", k)))) for k in path)
        out[name] = np.asarray(leaf)
    return out


def make_goldens(out_dir: str) -> dict:
    """Write the store and ``expected.npz``; returns the expected arrays."""
    import numpy as np

    from multimodal_edema_prediction_tpu.train.orbax_io import (make_manager,
                                                                save_state)
    if os.path.exists(out_dir):
        shutil.rmtree(out_dir)
    state = jax_state()
    mgr = make_manager(out_dir)
    save_state(mgr, STEP, state)
    mgr.wait_until_finished()
    mgr.close()
    arrays = expected_arrays(state)
    dtypes = {k: "bfloat16" if a.dtype.name == "bfloat16" else a.dtype.str
              for k, a in arrays.items()}
    np.savez_compressed(os.path.join(out_dir, "expected.npz"),
                        __dtypes__=np.array(json.dumps(dtypes)),
                        **{k: a.view(np.uint16) if dtypes[k] == "bfloat16"
                           else a for k, a in arrays.items()})
    return arrays


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("out_dir", nargs="?", default=DEFAULT_OUT)
    args = p.parse_args(argv)
    arrays = make_goldens(args.out_dir)
    size = sum(os.path.getsize(os.path.join(d, n))
               for d, _, names in os.walk(args.out_dir) for n in names)
    print(f"{len(arrays)} arrays, {size} bytes under {args.out_dir}")


if __name__ == "__main__":
    main()
