"""Typed configuration for every pipeline stage.

The PyTorch port's own copy of ``multimodal_edema_prediction_tpu/config.py``
(the port imports nothing of the JAX package); ``tests/test_torch_config.py``
pins it equal to the original, so checkpoints keep one config contract.
Fields that only the JAX package reads (``flash_block_b``, ``quant``,
``n_data``/``n_model``) stay so that sidecars round-trip.

Replaces the reference's ~60-flag argparse namespaces
(``training_duett/run.py:49-178``) with frozen dataclasses that:

- serialize to/from plain dicts (checkpoint-as-config, the reference's
  ``args``-in-ckpt pattern at ``training_duett/trainer.py:63-71``),
- produce diff-tag run ids from non-default fields
  (``training_duett/run.py:26-41``),
- validate invariants at construction (``pathology_labels[0] == label_col``,
  ``training_duett/data_processing.py:186-190``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field, fields
from datetime import datetime
from typing import Any, Optional, Tuple

# Index 0 must be the main target (edema) — query order of the perceiver.
# Reference: training_duett/data_processing.py:22-30.
DEFAULT_PATHOLOGY_LABELS: Tuple[str, ...] = (
    "label_edema",
    "label_cardiomegaly",
    "label_effusion",
    "label_pneumonia",
    "label_atelectasis",
    "label_opacity",
    "label_consolidation",
)

# Non-semantic fields excluded from the diff-tag (run.py:18-23).
TAG_EXCLUDE = frozenset({
    "data_dir", "ckpt_dir", "meta_path", "duett_ckpt", "teacher_ckpt",
    "pretrained_cxr_head_ckpt", "wandb_project", "wandb_run_name",
    "wandb_disabled", "log_every", "limit_batches", "run_id",
})


class _ConfigBase:
    """Dict round-trip + diff-tag machinery shared by all configs."""

    def to_dict(self) -> dict:
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if dataclasses.is_dataclass(v):
                v = v.to_dict()
            elif isinstance(v, tuple):
                v = list(v)
            out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "Any":
        kwargs = {}
        for f in fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            if dataclasses.is_dataclass(f.type) or (
                    isinstance(f.type, type) and issubclass(f.type, _ConfigBase)
                    if isinstance(f.type, type) else False):
                v = f.type.from_dict(v)
            elif isinstance(f.default, tuple) or (
                    f.default_factory is not dataclasses.MISSING  # type: ignore[misc]
                    and isinstance(f.default_factory(), tuple)):  # type: ignore[misc]
                v = tuple(v)
            kwargs[f.name] = v
        return cls(**kwargs)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def diff_tag(self) -> str:
        """Run-id tag built from non-default fields (run.py:26-33)."""
        ref = type(self)()
        diff = {}
        for f in fields(self):
            if f.name in TAG_EXCLUDE:
                continue
            v, d = getattr(self, f.name), getattr(ref, f.name)
            if dataclasses.is_dataclass(v):
                continue
            if v != d:
                diff[f.name] = v
        if not diff:
            return "default"
        return "_".join(f"{k}={v}" for k, v in sorted(diff.items()))

    def save_json(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"__class__": type(self).__name__, **self.to_dict()}, f,
                      indent=2, default=str)


def make_run_id(cfg: _ConfigBase) -> str:
    return datetime.now().strftime("%Y%m%d_%H%M%S") + "_" + cfg.diff_tag()


# =============================================================================
# Model configs
# =============================================================================
@dataclass(frozen=True)
class DuettConfig(_ConfigBase):
    """DuETT dual-axis transformer (reference duett/duett.py:49-141)."""
    n_variables: int = 34            # V: clinical TS variables
    n_timesteps: int = 24            # T: hourly bins in the window
    d_static: int = 18               # static feature dim (age + one-hots)
    d_embedding: int = 24            # per-cell embedding dim
    n_layers: int = 2                # dual-axis layer pairs
    n_heads: int = 2
    d_feedforward: int = 512
    n_hidden_mlp_embedding: int = 1
    d_hidden_mlp_embedding: int = 64
    d_hidden_tab_encoder: int = 128
    n_hidden_tab_encoder: int = 1
    n_obs_bins: int = 16             # count-embedding bins (duett.py:88)
    scalenorm: bool = True
    transformer_dropout: float = 0.0
    aug_noise: float = 0.0
    aug_mask: float = 0.0
    # SSL pretrain heads (duett.py:110-122)
    pretrain_masked_steps: int = 1
    pretrain_n_hidden: int = 0
    pretrain_d_hidden: int = 64
    pretrain_dropout: float = 0.5
    pretrain_value: bool = True
    pretrain_presence: bool = True
    pretrain_presence_weight: float = 0.2
    predict_events: bool = True
    # Supervised head (duett.py:110)
    n_hidden_head: int = 1
    d_hidden_head: int = 64

    @property
    def d_representation(self) -> int:
        # d_embedding * (V + 1): time-series vars + static column
        return self.d_embedding * (self.n_variables + 1)

    @property
    def et_dim(self) -> int:
        return self.d_embedding * (self.n_timesteps + 1)

    @property
    def tt_dim(self) -> int:
        return self.d_embedding * (self.n_variables + 1)


@dataclass(frozen=True)
class ViTConfig(_ConfigBase):
    """RAD-DINO-style DINOv2 ViT-B/14 (microsoft/rad-dino)."""
    image_size: int = 518
    patch_size: int = 14
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_feedforward: int = 3072
    layerscale_init: float = 1.0
    dropout: float = 0.0
    use_flash_attention: bool = True   # Pallas flash kernel on TPU
    # flash batch-block: 2 runs ~10% faster at the production shape but
    # needs ~19 MiB of scoped VMEM — the train-step factories raise the
    # compiler's scoped-VMEM limit automatically when this is >1
    # (benchmarks/flash_step_probe.py: b96 314.5 → 345.3 samples/s/chip at
    # block_b=2 + 48 MiB). Leave 1 for steps compiled outside those
    # factories (the default 16 MiB limit rejects block_b=2).
    flash_block_b: int = 1
    quant: str = "none"   # "int8": post-training-quantized matmuls (frozen
    #                        branch only — 2x MXU rate on v5e; ops/int8.py)

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2  # 37*37 = 1369


@dataclass(frozen=True)
class PerceiverConfig(_ConfigBase):
    """Pathology-query perceiver (models/main_architecture_duett.py:538-654)."""
    n_pathologies: int = 7
    d_latent: int = 256
    n_heads: int = 4
    dropout: float = 0.2             # run.py:78 default (not module default .1)
    head_hidden: int = 64
    head_dropout: float = 0.2
    ts_ablation: str = "hourly_only"  # {'full','hourly_only','rep_only'}
    # 'legacy' TemporalPerceiver geometry (run.py:75-76)
    n_latents: int = 16
    n_layers: int = 2
    # correction-head dropout override; None → head_dropout. The reference
    # resets it to --lp_correction_dropout in LP mode (trainer.py:365-370).
    correction_dropout: Optional[float] = None
    # Pallas flash kernel for the img_cross 1370-token-KV read. Engages
    # ONLY where it is numerically exact: eval/serving (train keeps the
    # standard path because attention-prob dropout 0.2 — run.py:78 — has
    # no flash equivalent) and KV len >= 256 with d_head >= 64, i.e. the
    # image cross-attention but not the 24-token ts_cross. Measured on the
    # cached tier in benchmarks/perceiver_flash_probe.py (docs/PERF.md).
    use_flash: bool = False


@dataclass(frozen=True)
class TeacherConfig(_ConfigBase):
    duett: DuettConfig = field(default_factory=DuettConfig)
    vit: ViTConfig = field(default_factory=ViTConfig)
    perceiver: PerceiverConfig = field(default_factory=PerceiverConfig)
    d_img: int = 768
    perceiver_type: str = "dual_patch"   # {'dual_patch', 'dual'}
    freeze_duett: bool = False
    freeze_cxr: bool = True

    def __post_init__(self):
        # int8 quantized matmuls round through jnp.round whose gradient is
        # zero — training through them would silently learn nothing, so the
        # quantized ViT is only legal frozen. Enforced here (not just in the
        # CLI) so programmatic construction fails fast too.
        if self.vit.quant != "none" and not self.freeze_cxr:
            raise ValueError(
                f"vit.quant={self.vit.quant!r} requires freeze_cxr=True: "
                "quantize_rows uses jnp.round (zero gradient) — an unfrozen "
                "quantized CXR branch trains with silently dead gradients")

    @classmethod
    def from_dict(cls, d: dict) -> "TeacherConfig":
        return cls(
            duett=DuettConfig.from_dict(d.get("duett", {})),
            vit=ViTConfig.from_dict(d.get("vit", {})),
            perceiver=PerceiverConfig.from_dict(d.get("perceiver", {})),
            **{k: v for k, v in d.items()
               if k in {"d_img", "perceiver_type", "freeze_duett", "freeze_cxr"}},
        )


@dataclass(frozen=True)
class StudentConfig(_ConfigBase):
    duett: DuettConfig = field(default_factory=DuettConfig)
    pool: str = "mean"               # {'mean', 'rep_token'}
    head_hidden: int = 128
    head_dropout: float = 0.1

    @classmethod
    def from_dict(cls, d: dict) -> "StudentConfig":
        return cls(
            duett=DuettConfig.from_dict(d.get("duett", {})),
            **{k: v for k, v in d.items()
               if k in {"pool", "head_hidden", "head_dropout"}},
        )


# =============================================================================
# Training configs
# =============================================================================
@dataclass(frozen=True)
class OptimConfig(_ConfigBase):
    """AdamW + differential LR + warmup/cosine (trainer.py:77-125)."""
    lr: float = 8e-5
    backbone_lr_mult: float = 0.2
    query_lr_mult: float = 0.2
    correction_lr_mult: float = 1.0
    weight_decay: float = 5e-2
    warmup_steps: int = 300
    min_lr_ratio: float = 0.01
    grad_clip: float = 0.0           # SSL uses 1.0 (train_duett_ssl.py:190)
    b1: float = 0.9
    b2: float = 0.999


@dataclass(frozen=True)
class TrainConfig(_ConfigBase):
    batch_size: int = 128
    epochs: int = 30
    patience: int = 5
    seed: int = 42
    limit_batches: int = 0
    eval_train_batches: int = 0
    log_every: int = 20
    dtype: str = "bfloat16"          # compute dtype; params stay f32
    # loss alphas (run.py:140-150)
    alpha_img: float = 0.5
    alpha_ts: float = 0.5
    alpha_fus: float = 1.0
    aux_residual_alpha: float = 0.0
    # 'single'-mode stage weights: total = s2·stage2 + s4·stage4
    # (run.py:134-137, loss/losses_duett.py:63-125)
    aux_stage2_alpha: float = 1.0
    aux_stage4_alpha: float = 0.5
    # legacy-mode auxiliary CXR head: total = main_bce + aux_cxr_alpha·aux_bce
    # (run.py:120-123, engine.py:42-73)
    use_aux_cxr: bool = False
    aux_cxr_alpha: float = 0.0
    # KD (run.py:200-204)
    kd_name: str = "vanilla_kl"
    kd_T: float = 4.0
    kd_alpha: float = 0.5
    # mesh
    n_data: int = 0                  # 0 → all devices on the data axis
    n_model: int = 1
    # K optimizer steps per call (engine.scan_steps): on a card one CUDA
    # graph replay per K steps, which amortizes per-step host dispatch on
    # the device-resident input tiers; 1 = one step per call (the
    # reference's only mode)
    steps_per_call: int = 1
    optim: OptimConfig = field(default_factory=OptimConfig)

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        return cls(
            optim=OptimConfig.from_dict(d.get("optim", {})),
            **{k: v for k, v in d.items()
               if k != "optim" and k in {f.name for f in fields(cls)}},
        )


@dataclass(frozen=True)
class DataConfig(_ConfigBase):
    label_col: str = "label_edema"
    n_timesteps: int = 24
    split_seed: int = 42
    count_clip: int = 15             # mimic_dataset.py:294 / duett.py:88
    pathology_labels: Tuple[str, ...] = DEFAULT_PATHOLOGY_LABELS
    data_dir: str = ""

    def __post_init__(self):
        if self.pathology_labels and self.pathology_labels[0] != self.label_col:
            raise ValueError(
                "pathology_labels[0] must equal label_col "
                f"(got {self.pathology_labels[0]!r} vs {self.label_col!r})")
