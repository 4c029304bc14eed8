"""Weight carrier between the JAX package's flax ``params``/``batch_stats``
trees (nested dicts of numpy arrays) and this package's ``state_dict``, both
ways.

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
shape. ``flax_paths`` and ``to_flax`` run the same rules backwards, from the
modules' types: they name each torch tensor's flax leaf (the optimizer's
parameter groups are decided on those names, as in the JAX package) and
write the flax trees a port checkpoint carries.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def check_fit(sd: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              what: str = "flax → torch weights") -> None:
    """Raise ``ValueError`` unless ``sd`` has exactly ``want``'s keys, each
    of ``want``'s shape."""
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    bad = sorted(f"{k}: flax {tuple(sd[k].shape)} vs torch "
                 f"{tuple(want[k].shape)}" for k in set(sd) & set(want)
                 if sd[k].shape != want[k].shape)
    if missing or extra or bad:
        raise ValueError(f"{what} do not fit: missing {missing}, left over "
                         f"{extra}, wrong shape {bad}")


def load_flax(model: nn.Module, params: dict,
              batch_stats: Optional[dict] = None) -> nn.Module:
    """Copy flax weights into ``model`` (in place, keeping its device)."""
    sd = flax_to_state_dict(params, batch_stats)
    check_fit(sd, model.state_dict())
    model.load_state_dict(sd, strict=True)
    return model


def _flax_leaf(module: nn.Module, name: str) -> str:
    from .models.layers import BatchNormLastDim, Dense, LayerNorm
    if name == "weight":
        if isinstance(module, Dense):
            return "kernel"
        if isinstance(module, (LayerNorm, BatchNormLastDim)):
            return "scale"
        if isinstance(module, nn.Embedding):
            return "embedding"
    return {v: k for k, v in _STATS.items()}.get(name, name)


def flax_paths(model: nn.Module) -> Dict[str, Tuple[str, str]]:
    """``state_dict`` key → (collection, '/'-joined flax path), where the
    collection is ``params`` or ``batch_stats``."""
    from .models.layers import BatchNormLastDim
    out = {}
    for mname, m in model.named_modules():
        parts = mname.split(".") if mname else []
        if isinstance(m, BatchNormLastDim):
            parts = parts + ["BatchNorm_0"]
        for kind, tensors in (("params", m.named_parameters(recurse=False)),
                              ("batch_stats", m.named_buffers(recurse=False))):
            for name, _ in tensors:
                key = f"{mname}.{name}" if mname else name
                out[key] = (kind, "/".join(parts + [_flax_leaf(m, name)]))
    return out


def _conv_kernel_shapes(model: nn.Module) -> Dict[str, tuple]:
    """state_dict key of each ViT patch embedding → its flax HWIO shape."""
    from .models.vit import DinoViT
    shapes = {}
    for mname, m in model.named_modules():
        if isinstance(m, DinoViT):
            P, d = m.cfg.patch_size, m.cfg.d_model
            key = f"{mname}.patch_embed.weight" if mname else \
                "patch_embed.weight"
            shapes[key] = (P, P, 3, d)
    return shapes


def to_flax(model: nn.Module) -> Tuple[dict, dict]:
    """The model's weights as flax (params, batch_stats) trees of float32
    numpy arrays: the inverse of ``flax_to_state_dict``."""
    paths = flax_paths(model)
    conv = _conv_kernel_shapes(model)
    trees = {"params": {}, "batch_stats": {}}
    for key, t in model.state_dict().items():
        kind, path = paths[key]
        arr = t.detach().cpu().numpy()
        if path.endswith("/kernel") or path == "kernel":
            arr = arr.T.reshape(conv[key]) if key in conv else arr.T
        node = trees[kind]
        *dirs, leaf = path.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = np.ascontiguousarray(arr)
    return trees["params"], trees["batch_stats"]
