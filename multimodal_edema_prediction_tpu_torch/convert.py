"""Weight carrier: the JAX package's flax ``params``/``batch_stats`` trees
(nested dicts of numpy arrays) → this package's ``state_dict``.

The port's modules mirror the flax tree (``models/layers.py``), so the
layout map is one rule per leaf, the inverse of the torch → flax transplant
helpers in ``tests/ref_harness.py``:

- a flax ``Dense``/``_ProjParams`` ``kernel [in, out]`` → ``weight [out, in]``
  (for attention projections ``[d, H·dh]`` → ``[H·dh, d]``);
- the patch conv's HWIO ``kernel [P, P, 3, D]`` → ``weight [D, P·P·3]``;
- LayerNorm/BatchNorm ``scale`` → ``weight``; ``nn.Embed`` ``embedding`` →
  ``weight``;
- ``batch_stats`` ``{mean, var}`` → buffers ``running_mean``/``running_var``;
- the ``BatchNorm_0`` level of ``BatchNormLastDim`` is dropped;
- every other leaf keeps its name and layout.

``load_flax`` fails on any key that is missing, left over, or of the wrong
shape.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

_RENAME = {"scale": "weight", "embedding": "weight"}
_STATS = {"mean": "running_mean", "var": "running_var"}


def _param_leaf(name: str, arr: np.ndarray):
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 4:                      # HWIO conv
            return "weight", arr.reshape(-1, arr.shape[-1]).T
        raise ValueError(f"kernel of rank {arr.ndim} has no layout rule")
    return _RENAME.get(name, name), arr


def flax_to_state_dict(params: dict, batch_stats: Optional[dict] = None
                       ) -> Dict[str, torch.Tensor]:
    """Flatten and re-layout the flax trees into torch names and layouts."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path, leaf_fn):
        for k, v in tree.items():
            sub = path if k == "BatchNorm_0" else path + [k]
            if isinstance(v, dict):
                walk(v, sub, leaf_fn)
                continue
            name, arr = leaf_fn(k, np.asarray(v))
            key = ".".join(sub[:-1] + [name])
            if key in out:
                raise ValueError(f"two flax leaves map to {key!r}")
            out[key] = torch.tensor(np.ascontiguousarray(arr))

    walk(params, [], _param_leaf)
    if batch_stats:
        walk(batch_stats, [], lambda k, a: (_STATS.get(k, k), a))
    return out


def load_flax(model: nn.Module, params: dict,
              batch_stats: Optional[dict] = None) -> nn.Module:
    """Copy flax weights into ``model`` (in place, keeping its device)."""
    sd = flax_to_state_dict(params, batch_stats)
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    bad = sorted(f"{k}: flax {tuple(sd[k].shape)} vs torch "
                 f"{tuple(want[k].shape)}" for k in set(sd) & set(want)
                 if sd[k].shape != want[k].shape)
    if missing or extra or bad:
        raise ValueError(f"flax → torch weights do not fit: missing "
                         f"{missing}, left over {extra}, wrong shape {bad}")
    model.load_state_dict(sd, strict=True)
    return model
