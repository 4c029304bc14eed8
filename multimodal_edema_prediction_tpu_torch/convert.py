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

from typing import Dict, List, Optional, Tuple

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


def _flax_layout(t, path: str, conv_shape: Optional[tuple]):
    """A tensor (or array) of the torch layout in the flax layout of the
    leaf at ``path``: a kernel transposed (a view), a patch conv's reshaped
    to HWIO."""
    if path.endswith("/kernel") or path == "kernel":
        return t.T.reshape(conv_shape) if conv_shape else t.T
    return t


def _insert(tree: dict, path: str, leaf) -> None:
    node = tree
    *dirs, name = path.split("/")
    for d in dirs:
        node = node.setdefault(d, {})
    node[name] = leaf


def to_flax(model: nn.Module) -> Tuple[dict, dict]:
    """The model's weights as flax (params, batch_stats) trees of float32
    numpy arrays: the inverse of ``flax_to_state_dict``."""
    paths = flax_paths(model)
    conv = _conv_kernel_shapes(model)
    trees = {"params": {}, "batch_stats": {}}
    for key, t in model.state_dict().items():
        kind, path = paths[key]
        _insert(trees[kind], path, np.ascontiguousarray(_flax_layout(
            t.detach().cpu().numpy(), path, conv.get(key))))
    return trees["params"], trees["batch_stats"]


# =============================================================================
# The optax train state (orbax checkpoints, ``train/orbax_io.py``)
# =============================================================================

def _adamw_state(count, mu, nu, clip: bool):
    """``optax.adamw``'s state, ``(ScaleByAdamState(count, mu, nu),
    EmptyState, ScaleByScheduleState(count))``, behind
    ``clip_by_global_norm``'s ``EmptyState`` when ``clip``. A named tuple
    is a dict here and an empty state None, as orbax stores them."""
    inner = ({"count": count, "mu": mu, "nu": nu}, None, {"count": count})
    return (None, inner) if clip else inner


def _moment_paths(model: nn.Module, optimizer) -> List[List[str]]:
    """The flax path of every parameter of every optimizer group."""
    paths = flax_paths(model)
    name = {id(p): n for n, p in model.named_parameters()}
    return [[paths[name[id(p)]][1] for p in ps] for ps in optimizer.params]


def optax_state(model: nn.Module, optimizer, step: int) -> dict:
    """The JAX package's train state, ``{"params", "batch_stats",
    "opt_state", "step"}``, over the port's model and ``MultiGroupAdamW``.
    Leaves are torch tensors in the flax layout (views of the model's and
    the optimizer's own tensors where the layout allows), None for an empty
    optax state or a ``MaskedNode``; named tuples are dicts, tuples tuples.

    ``opt_state`` is JAX ``make_optimizer``'s ``multi_transform`` over
    ``train/optim.py``'s ``GROUPS`` (the teacher and KD loops) or, for
    ``MultiGroupAdamW.one_group``, SSL's ``chain(clip_by_global_norm,
    adamw)`` (a bare ``adamw`` without a clip). Every ``count`` is the
    step, as int32: optax counts every group at every update."""
    import torch

    from .train.optim import FROZEN, GROUPS
    conv = _conv_kernel_shapes(model)
    paths = flax_paths(model)
    trees = {"params": {}, "batch_stats": {}}
    for key, t in model.state_dict(keep_vars=True).items():
        kind, path = paths[key]
        _insert(trees[kind], path, _flax_layout(t.detach(), path,
                                                conv.get(key)))
    by_path = {paths[k][1]: k for k in paths if paths[k][0] == "params"}
    count = torch.tensor(int(step), dtype=torch.int32)
    clip = optimizer.cfg.grad_clip > 0
    moments = _moment_paths(model, optimizer)

    def moment_tree(g: Optional[int], which: str) -> dict:
        """The params tree with group ``g``'s moments, None elsewhere."""
        tree = {}
        own = {} if g is None else dict(zip(moments[g],
                                            getattr(optimizer, which)[g]))
        for path, key in by_path.items():
            t = own.get(path)
            _insert(tree, path, None if t is None else _flax_layout(
                t, path, conv.get(key)))
        return tree

    if optimizer.labels == ["all"]:
        opt = _adamw_state(count, moment_tree(0, "mu"), moment_tree(0, "nu"),
                           clip)
    else:
        unknown = set(optimizer.labels) - set(GROUPS)
        if unknown:
            raise ValueError(f"optimizer groups {sorted(unknown)} have no "
                             "optax counterpart")
        groups = {}
        for label in GROUPS:
            if label == FROZEN:
                groups[label] = {"inner_state": None}     # set_to_zero
                continue
            g = optimizer.labels.index(label) \
                if label in optimizer.labels else None
            groups[label] = {"inner_state": _adamw_state(
                count, moment_tree(g, "mu"), moment_tree(g, "nu"), clip)}
        opt = {"inner_states": groups}
    return {"params": trees["params"], "batch_stats": trees["batch_stats"],
            "opt_state": opt, "step": count}


def flatten_state(tree) -> List[Tuple[tuple, object]]:
    """The leaves of an ``optax_state`` tree in JAX's order: (key path,
    leaf), the key path a tuple of (key, key type), 2 for a dict key and 1
    for a sequence index, as orbax's metadata names them; an empty dict is
    a leaf of its own."""
    out: List[Tuple[tuple, object]] = []

    def walk(node, path):
        if isinstance(node, dict) and node:
            for k in sorted(node):
                walk(node[k], path + ((str(k), 2),))
        elif isinstance(node, tuple):
            for i, v in enumerate(node):
                walk(v, path + ((str(i), 1),))
        else:
            out.append((path, node))

    walk(tree, ())
    return out


def load_optax_state(model: nn.Module, optimizer,
                     arrays: Dict[str, np.ndarray]) -> int:
    """Load an optax train state into ``model`` and ``optimizer`` in place
    (the inverse of ``optax_state``); ``arrays`` maps each array's dotted
    name (``params.duett.…``, ``opt_state.…``, ``step``) to its value in
    the flax layout. Returns the step. Every ``count`` must equal it."""
    import torch
    step = int(arrays["step"])
    bad = sorted(k for k, v in arrays.items() if k.startswith("opt_state.")
                 and k.endswith(".count") and int(v) != step)
    if bad:
        raise ValueError(f"optimizer counts {bad[:4]} differ from the step "
                         f"{step}")
    trees = {"params": {}, "batch_stats": {}}
    for name, arr in arrays.items():
        kind, _, rest = name.partition(".")
        if kind in trees:
            _insert(trees[kind], rest.replace(".", "/"), arr)
    load_flax(model, trees["params"], trees["batch_stats"])
    clip = optimizer.cfg.grad_clip > 0
    adam = "1.0." if clip else "0."
    for g, paths in enumerate(_moment_paths(model, optimizer)):
        head = "opt_state." if optimizer.labels == ["all"] else \
            f"opt_state.inner_states.{optimizer.labels[g]}.inner_state."
        for which in ("mu", "nu"):
            for t, path in zip(getattr(optimizer, which)[g], paths):
                arr = arrays[f"{head}{adam}{which}.{path.replace('/', '.')}"]
                if path.endswith("/kernel") or path == "kernel":
                    arr = _param_leaf("kernel", arr)[1]
                with torch.no_grad():
                    t.copy_(torch.from_numpy(np.ascontiguousarray(arr))
                            .reshape(t.shape))
    return step
