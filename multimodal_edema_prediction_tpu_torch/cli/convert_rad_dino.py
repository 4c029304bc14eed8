"""RAD-DINO (Hugging Face ``Dinov2Model``) weights → the checkpoint that
``cli.train_teacher --vit_weights`` and ``cli.train_cxr_head
--vit_params`` read: the counterpart of ``scripts/convert_rad_dino.py``,
with its flags, defaults (ViT-B/14 at 518) and output files, on a host
with no JAX, no ``transformers`` and no ``safetensors``:

    python -m multimodal_edema_prediction_tpu_torch.cli.convert_rad_dino \\
        --source /path/to/rad-dino --out runs/rad_dino_flax.msgpack

``--source`` is a local Hugging Face directory (``config.json``,
``model.safetensors`` or ``pytorch_model.bin``, and
``preprocessor_config.json`` for ``image_mean``/``image_std``), a bare
state-dict file (``.safetensors``, or ``.pt``/``.bin`` through
``torch.load(weights_only=True)``, a ``.pt`` perhaps under a
``"state_dict"`` key), or a hub id such as ``microsoft/rad-dino``, found
only in a local Hugging Face cache (``$HF_HOME/hub``,
``~/.cache/huggingface/hub``): nothing is downloaded. ``.safetensors`` is
read in numpy (``utils/safetensors_io.py``: F32, F16, BF16).

Every array is checked against the geometry before anything is written (a
missing, left-over or misshapen array raises, naming it), mapped by
``models/vit.py::convert_hf_dinov2`` into ``DinoViT`` and written in the
flax layout by ``train/checkpoint.py::save_flax_checkpoint``: ``<out>``
(``batch_stats`` None, step 0, metric 0.0; ``<out>.config.json`` holds
``vit``, ``source``, ``image_mean``, ``image_std``) and
``<out>.manifest.json`` (source, sha256, the norm constants, the ViT
config, ``verified_max_abs_err``, ``n_params`` and each array's shape by
its flax path). From a float32 source both files are byte for byte the
JAX script's; the weights are written in float32 whatever the source's
dtype.

Verification: where ``transformers`` imports and the source is a Hugging
Face directory (or hub id) with its ``config.json``, the converted ``DinoViT`` in float32 on the
CPU is held against ``Dinov2Model`` on 2 seeded random images (CLS and
patch tokens, atol 2e-4, rtol 1e-3, the JAX script's bounds). Elsewhere,
as on a host without ``transformers``, a line says the conversion is
unverified, and why, and the manifest's ``verified_max_abs_err`` is
null.
"""
from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ViTConfig
from ..convert import check_fit, to_flax
from ..models.vit import (IMAGE_MEAN, IMAGE_STD, DinoViT, convert_hf_dinov2,
                          hf_dinov2_shapes)
from ..train.checkpoint import save_flax_checkpoint
from ..utils import safetensors_io

WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")
# config.json's geometry keys → the flags they must agree with
HF_GEOMETRY = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
               "num_attention_heads": "n_heads", "patch_size": "patch_size"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("rad-dino → flax-layout converter "
                                 "(PyTorch, no JAX)")
    ap.add_argument("--source", default="microsoft/rad-dino",
                    help="HF hub id (local cache only), local HF dir, or "
                         "state-dict file")
    ap.add_argument("--out", default="runs/rad_dino_flax.msgpack")
    ap.add_argument("--image_size", type=int, default=518)
    ap.add_argument("--patch_size", type=int, default=14)
    ap.add_argument("--d_model", type=int, default=768)
    ap.add_argument("--n_layers", type=int, default=12)
    ap.add_argument("--n_heads", type=int, default=12)
    ap.add_argument("--d_feedforward", type=int, default=3072)
    ap.add_argument("--skip_verify", action="store_true")
    return ap


def hub_cache_dirs() -> List[str]:
    """Where a Hugging Face hub cache may be: ``$HF_HOME/hub``, then
    ``~/.cache/huggingface/hub``."""
    dirs = []
    if os.environ.get("HF_HOME"):
        dirs.append(os.path.join(os.environ["HF_HOME"], "hub"))
    dirs.append(os.path.join(os.path.expanduser("~"), ".cache",
                             "huggingface", "hub"))
    return list(dict.fromkeys(dirs))


def resolve_hub_id(repo_id: str) -> str:
    """The snapshot directory of ``repo_id`` in a local hub cache: the one
    ``refs/main`` names, else the newest that holds weights. Raises
    ``FileNotFoundError`` naming every path it looked in."""
    looked = []
    for cache in hub_cache_dirs():
        repo = os.path.join(cache, "models--" + repo_id.replace("/", "--"))
        looked.append(os.path.join(repo, "snapshots", "*"))
        ref = os.path.join(repo, "refs", "main")
        if os.path.isfile(ref):
            with open(ref) as f:
                snap = os.path.join(repo, "snapshots", f.read().strip())
            if _weight_file(snap):
                return snap
        snaps = sorted((s for s in glob.glob(os.path.join(repo, "snapshots",
                                                          "*"))
                        if _weight_file(s)), key=os.path.getmtime)
        if snaps:
            return snaps[-1]
    raise FileNotFoundError(
        f"{repo_id!r} is neither a file nor a directory, and no local "
        f"Hugging Face cache holds it (looked in {looked}); nothing is "
        "downloaded: copy the model directory to this host and pass it as "
        "--source")


def _weight_file(hf_dir: str) -> Optional[str]:
    for name in WEIGHT_FILES:
        path = os.path.join(hf_dir, name)
        if os.path.isfile(path):
            return path
    return None


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.is_floating_point() else v).numpy()
    return np.asarray(v)


def read_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A state-dict file as numpy arrays: ``.safetensors`` in numpy, else
    ``torch.load(weights_only=True)`` (a ``"state_dict"`` key unwrapped,
    as the JAX script does)."""
    if path.endswith(".safetensors"):
        return safetensors_io.load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: _numpy(v) for k, v in sd.items()}


def load_source(source: str) -> Tuple[Dict[str, np.ndarray], Optional[str],
                                      List[float], List[float]]:
    """(state dict, the HF directory or None, image_mean, image_std) of
    ``source``."""
    mean, std = list(IMAGE_MEAN), list(IMAGE_STD)
    if os.path.isfile(source):
        return read_state_dict(source), None, mean, std
    hf_dir = source if os.path.isdir(source) else resolve_hub_id(source)
    weights = _weight_file(hf_dir)
    if weights is None:
        raise FileNotFoundError(f"{hf_dir} holds none of {WEIGHT_FILES}")
    pre = os.path.join(hf_dir, "preprocessor_config.json")
    if os.path.isfile(pre):
        with open(pre) as f:
            p = json.load(f)
        if "image_mean" in p and "image_std" in p:
            mean = [float(x) for x in p["image_mean"]]
            std = [float(x) for x in p["image_std"]]
    return read_state_dict(weights), hf_dir, mean, std


def check_hf_config(hf_dir: str, cfg: ViTConfig) -> None:
    """Raise ``ValueError`` where ``config.json`` gives a geometry other
    than the flags' (a head count does not show in any array's shape)."""
    path = os.path.join(hf_dir, "config.json")
    if not os.path.isfile(path):
        return
    with open(path) as f:
        hf = json.load(f)
    wrong = {k: (hf[k], getattr(cfg, ours)) for k, ours in HF_GEOMETRY.items()
             if k in hf and hf[k] != getattr(cfg, ours)}
    if "mlp_ratio" in hf and "hidden_size" in hf and \
            int(hf["mlp_ratio"] * hf["hidden_size"]) != cfg.d_feedforward:
        wrong["mlp_ratio * hidden_size"] = (
            hf["mlp_ratio"] * hf["hidden_size"], cfg.d_feedforward)
    if wrong:
        raise ValueError(f"{path} disagrees with the flags' ViT "
                         f"(config.json, flags): {wrong}")


def check_hf_state_dict(sd: Dict[str, np.ndarray], cfg: ViTConfig) -> None:
    """Raise ``ValueError`` unless ``sd`` holds exactly the arrays of a
    ``Dinov2Model`` at ``cfg``'s geometry, each of its shape."""
    want = dict(hf_dinov2_shapes(cfg))
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    bad = sorted(f"{k}: {tuple(sd[k].shape)}, wanted {want[k]}"
                 for k in set(sd) & set(want)
                 if tuple(sd[k].shape) != want[k])
    if missing or extra or bad:
        raise ValueError(
            f"the source's arrays do not fit a ViT of {cfg.n_layers} layers, "
            f"d={cfg.d_model}, ff={cfg.d_feedforward}, patch "
            f"{cfg.patch_size}, image {cfg.image_size}: missing {missing}, "
            f"left over {extra}, wrong shape {bad}")


def convert(sd: Dict[str, np.ndarray], cfg: ViTConfig) -> DinoViT:
    """The ``DinoViT`` (float32, CPU) holding ``sd``, every array checked
    first."""
    check_hf_state_dict(sd, cfg)
    state = convert_hf_dinov2(sd, cfg)
    with torch.device("meta"):
        want = DinoViT(cfg).state_dict()
    check_fit(state, want, f"the converted ViT ({cfg.n_layers} layers, "
                           f"d={cfg.d_model}, image {cfg.image_size})")
    model = DinoViT(cfg)
    model.load_state_dict(state, strict=True)
    return model.eval()


def verify(model: DinoViT, hf_dir: str, cfg: ViTConfig, atol: float = 2e-4,
           rtol: float = 1e-3, batch: int = 2) -> Optional[float]:
    """The converted ViT's CLS and patch tokens against ``Dinov2Model``'s
    on ``batch`` seeded random images, in float32 on the CPU (the JAX
    script's ``verify``); None where ``transformers`` is not installed."""
    try:
        from transformers import Dinov2Model
    except ImportError:
        return None
    hf = Dinov2Model.from_pretrained(hf_dir).eval().float()
    rng = np.random.default_rng(0)
    px = rng.random((batch, cfg.image_size, cfg.image_size, 3)) \
        .astype(np.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = hf(pixel_values=torch.from_numpy(
                px.transpose(0, 3, 1, 2).copy())).last_hidden_state.numpy()
            cls, patches = model.float()(torch.from_numpy(px))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    ours = np.concatenate([cls.numpy()[:, None, :], patches.numpy()], axis=1)
    np.testing.assert_allclose(ours, want, atol=atol, rtol=rtol)
    return float(np.abs(ours - want).max())


def flat_shapes(tree: dict, prefix: str = "") -> Dict[str, list]:
    """Each leaf's shape by its '/'-joined path, keys sorted at every
    level (JAX ``tree_flatten_with_path``'s order)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = list(np.shape(v))
    return out


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = ViTConfig(image_size=args.image_size, patch_size=args.patch_size,
                    d_model=args.d_model, n_layers=args.n_layers,
                    n_heads=args.n_heads, d_feedforward=args.d_feedforward,
                    use_flash_attention=False)
    sd, hf_dir, mean, std = load_source(args.source)
    model = convert(sd, cfg)
    del sd
    if hf_dir is not None:
        check_hf_config(hf_dir, cfg)
    max_err = None
    if not args.skip_verify:
        has_config = hf_dir is not None and os.path.isfile(
            os.path.join(hf_dir, "config.json"))
        if has_config:
            max_err = verify(model, hf_dir, cfg)
        if max_err is not None:
            print(f"[convert] verified vs torch: max |diff| = {max_err:.2e}")
        else:
            why = ("a bare state dict names no Hugging Face model"
                   if hf_dir is None else "the directory has no config.json"
                   if not has_config else "transformers is not installed")
            print(f"[convert] UNVERIFIED: {why}, so the converted ViT was "
                  "not held against Dinov2Model (verified_max_abs_err: "
                  "null)")
    params, _ = to_flax(model)
    save_flax_checkpoint(args.out, params, None, step=0, metric=0.0,
                         config={"vit": cfg.to_dict(), "source": args.source,
                                 "image_mean": mean, "image_std": std})
    digest = hashlib.sha256()
    with open(args.out, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            digest.update(chunk)
    shapes = flat_shapes(params)
    manifest = {
        "source": args.source,
        "sha256": digest.hexdigest(),
        "image_mean": mean, "image_std": std,
        "vit_config": cfg.to_dict(),
        "verified_max_abs_err": max_err,
        "n_params": int(sum(int(np.prod(s)) for s in shapes.values())),
        "shapes": shapes,
    }
    with open(args.out + ".manifest.json", "w") as f:
        json.dump(manifest, f, indent=1)
    print(f"[convert] wrote {args.out} (sha256 {manifest['sha256'][:16]}…) "
          f"+ manifest ({manifest['n_params']:,} params)")
    return {"out": args.out, "manifest": manifest}


if __name__ == "__main__":
    main()
