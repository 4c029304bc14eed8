"""The port's ``DinoViT`` against flax, at a flash-gated tiny geometry
(image 224, patch 14 → 257 tokens, d 128, 2 heads of 64, 2 layers, ff 256).

The JAX ViT pads 257 tokens to 384 and masks the pad; the port does not pad.
Both must give the same CLS and patch tokens. Tolerance ≤1e-5 at float32.

The full-geometry golden check (``tests/goldens/rad_dino_full_geometry.npz``)
runs on the card in ``chip_smoke.py``; here its weight fill and the HF →
port conversion are checked at the tiny geometry.
"""
import importlib.util
import os

import jax
import numpy as np
import torch

from multimodal_edema_prediction_tpu.config import ViTConfig as JViTConfig
from multimodal_edema_prediction_tpu.models import vit as JV
from multimodal_edema_prediction_tpu_torch.config import ViTConfig
from multimodal_edema_prediction_tpu_torch.convert import load_flax
from multimodal_edema_prediction_tpu_torch.models import vit as PV
from torch_port_util import init_perturbed, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(image_size=224, patch_size=14, d_model=128, n_layers=2,
            n_heads=2, d_feedforward=256)
# the golden-fill and HF-conversion check needs names and layouts, not
# the flash gate: a smaller geometry keeps it fast
SMALL = dict(image_size=28, patch_size=14, d_model=32, n_layers=1,
             n_heads=2, d_feedforward=64)
TOL = 1e-5


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pixels(B=2, S=224):
    px = np.random.default_rng(0).random((B, S, S, 3)).astype(np.float32)
    return np.asarray(JV.normalize_image(px))


def test_vit_matches_flax_flash_gated():
    jcfg = JViTConfig(**TINY)
    px = _pixels()
    module = JV.DinoViT(jcfg)
    params, _ = init_perturbed(module, px)
    jcls, jpatch = jax.jit(module.apply)({"params": params}, px)
    model = load_flax(PV.DinoViT(ViTConfig(**TINY)), params).eval()
    with torch.inference_mode():
        cls, patch = model(t(px))
    assert patch.shape == (2, 256, 128)
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(patch.numpy(), np.asarray(jpatch), atol=TOL,
                               rtol=TOL)


def test_normalize_image_matches():
    px = np.random.default_rng(1).random((2, 5, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(PV.normalize_image(t(px)).numpy(),
                               np.asarray(JV.normalize_image(px)), atol=1e-6)


class _NamedArrays:
    """Stand-in for a HF ``Dinov2Model``: the golden's fill only reads
    ``state_dict()`` names and shapes and copies into the tensors."""

    def __init__(self, shapes):
        self._sd = {n: torch.zeros(shape) for n, shape in shapes}

    def state_dict(self):
        return self._sd


def test_golden_fill_and_hf_conversion():
    """chip_smoke.py's fill equals the golden test's fill
    (``tests/test_rad_dino_golden.py::_deterministic_fill``) name for name;
    the JAX package's ``convert_hf_dinov2`` accepts those names and shapes;
    and the port loaded through its own ``convert_hf_dinov2`` matches the
    JAX ViT loaded through the JAX one."""
    golden = _load(os.path.join(REPO, "tests", "test_rad_dino_golden.py"),
                   "rad_dino_golden_for_port")
    smoke = _load(os.path.join(REPO, "chip_smoke.py"), "chip_smoke")
    cfg = ViTConfig(**SMALL)
    shapes = PV.hf_dinov2_shapes(cfg)
    ours = smoke.golden_vit_state(cfg)
    assert list(ours) == [n for n, _ in shapes]
    stand_in = _NamedArrays(shapes)
    golden._deterministic_fill(stand_in)
    for k, v in stand_in.state_dict().items():
        np.testing.assert_array_equal(ours[k], v.numpy(), err_msg=k)

    model = PV.DinoViT(cfg).eval()
    model.load_state_dict(PV.convert_hf_dinov2(ours, cfg), strict=True)
    px = _pixels(S=28)
    with torch.inference_mode():
        cls, patch = model(t(px))
    jparams = JV.convert_hf_dinov2(ours, JViTConfig(**SMALL))
    jcls, jpatch = jax.jit(JV.DinoViT(JViTConfig(**SMALL)).apply)(
        {"params": jparams}, px)
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(patch.numpy(), np.asarray(jpatch), atol=TOL,
                               rtol=TOL)
