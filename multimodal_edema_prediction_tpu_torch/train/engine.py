"""Per-batch teacher, student and SSL steps: the PyTorch counterpart of
``multimodal_edema_prediction_tpu/train/engine.py`` (``_prep_inputs``,
``_cxr_inputs``, ``make_teacher_step`` with LP mode, ``make_teacher_eval``,
``make_teacher_pathology_step`` and ``_eval`` (``single``),
``make_teacher_legacy_step`` and the legacy eval (JAX
``teacher_loop.py:464-479``), ``default_image_source``,
``make_teacher_eval_from_windows``, ``make_supervised_ts_step``,
``make_supervised_ts_eval``,
``make_kd_step``, ``make_ssl_step``, ``make_ssl_eval``), and
``scan_steps``, K steps per call (``--steps_per_call``; one CUDA graph
replay per call on a card).

A step runs eagerly on the device that holds the batch: window gather →
augmentation → model forward/backward → optimizer update. The encode-once
tier's ``feature_source`` (``data/features.py``) and the pixel tier's
``image_source`` share one code path, as in JAX: the first replaces the ViT
forward with two K2 gathers (the device bank) or with the tokens the host
store's hook attached to the batch. In a multi-process run each rank's step
sees its rows of the global batch; the outputs that feed a loss and their
labels are gathered over the ranks first (``parallel/multihost.gather_rows``,
the identity for one process), so every masked count is the global batch's
and each rank's gradient is its rows' share of the global one. On the pixel tier with
``freeze_cxr=False`` the ViT trains in the step: nothing here detaches its
tokens, and its attention's backward runs K1's dkv and dq kernels.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import DuettConfig, TrainConfig
from ..data.pipeline import gather_windows
from ..models.duett import feats_to_input, pretrain_prep_batch
from ..models.teacher import ATTN_KEYS
from ..models.vit import normalize_image
from ..ops import losses as L
from ..parallel import multihost as mh
from ..parallel.multihost import gather_rows as G
from ..parallel.multihost import param_term
from .state import TrainState

EVAL_KEYS = ("main_logit", "img_logits", "ts_logits", "fusion_logits",
             "scaled_correction")
PATHOLOGY_EVAL_KEYS = ("main_logit", "stage2_logits", "stage4_logits")


def default_image_source(batch: dict) -> torch.Tensor:
    """Pixel batch, in one of two layouts: ``pixel_u8`` [B, S, S, 3] uint8
    → float32 in [0, 1] → normalized on the device; or ``pixel_values``,
    already normalized float32. The caller casts to the compute dtype."""
    if "pixel_u8" in batch:
        return normalize_image(batch["pixel_u8"].float() / 255.0)
    return batch["pixel_values"]


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else torch.as_tensor(x)
    return t.to(device, non_blocking=True)


def to_device(batch: dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """Host batch (numpy) → tensors on ``device``, copied ``non_blocking``;
    host-only side channels (``_global``, any ``_``-key) stay behind."""
    return {k: _as_tensor(v, device) for k, v in batch.items()
            if not k.startswith("_")}


def _on_device(array) -> Callable[[torch.device], torch.Tensor]:
    """``device`` → ``array`` as a float32 tensor there, copied once per
    device (a step copies nothing from the host: a CUDA graph's capture
    would stop at such a copy)."""
    made: Dict[torch.device, torch.Tensor] = {}

    def get(device: torch.device) -> torch.Tensor:
        t = made.get(device)
        if t is None:
            t = made[device] = torch.as_tensor(array, dtype=torch.float32,
                                               device=device)
        return t

    return get


def _prep_inputs(grid, static, batch, n_timesteps, dtype, gen=None,
                 aug_noise=0.0, aug_mask=0.0, train=False):
    x_ts = gather_windows(grid, batch["stay_rows"], batch["slot_idx"],
                          n_timesteps)
    x_static = static[batch["stay_rows"].long()]
    x_in, x_static = feats_to_input(x_ts, x_static, aug_noise, aug_mask,
                                    train, gen)
    return x_in.to(dtype), x_static.to(dtype), batch["bin_ends"].to(dtype)


def _cxr_inputs(batch, image_source, feature_source, dtype):
    """(pixels, cxr_feats) for the teacher forward: the encode-once tier
    (``feature_source``) replaces the frozen-ViT forward with a cached-token
    gather (patches None from a CLS-only source, which a ``dual`` teacher
    takes); otherwise pixels flow to the in-step ViT."""
    if feature_source is None:
        return image_source(batch).to(dtype), None
    cls, patches = feature_source(batch)
    return None, (cls.to(dtype),
                  None if patches is None else patches.to(dtype))


def make_teacher_step(cfg: TrainConfig, duett_cfg: DuettConfig,
                      n_timesteps: int, label_weights,
                      pos_weight=None, dtype=torch.bfloat16,
                      image_source: Callable = default_image_source,
                      feature_source: Optional[Callable] = None,
                      lp_mode: bool = False, lp_beta_l2: float = 0.0,
                      lp_corr_l2: float = 0.0) -> Callable:
    """``step(state, grid, static, batch, gen)`` → metrics: one teacher
    update of a residual-fusion mode on a device batch. Dropout and
    augmentation draw from the ``torch.Generator`` ``gen``. The loss is the
    3-branch masked BCE plus ``aux_residual_alpha``·KL. Returns the loss
    parts and ``main_logit``, detached, on the device; ``state`` is updated
    in place.

    ``lp_mode``: the correction-only linear probe (JAX ``engine.py:196-
    264``): the optimizer must already leave out everything but the
    correction head and β (``teacher_loop.lp_frozen_label_fn``); the
    forward runs with ``train=False`` (no augmentation, no dropout, even
    the correction head's, and no BatchNorm update), and the loss gains
    ``reg_beta_l2 = lp_beta_l2·mean(β²)`` and ``reg_corr_l2 =
    lp_corr_l2·mean(scaled_correction²)``."""
    train = not lp_mode
    weights = _on_device(label_weights)

    def step(state: TrainState, grid, static, batch, gen
             ) -> Dict[str, torch.Tensor]:
        x_in, x_static, times = _prep_inputs(
            grid, static, batch, n_timesteps, dtype, gen,
            duett_cfg.aug_noise, duett_cfg.aug_mask, train=train)
        pixels, feats = _cxr_inputs(batch, image_source, feature_source,
                                    dtype)
        out = state.model(x_in, x_static, times, pixels, train=train,
                          gen=gen, cxr_feats=feats)
        lw = weights(x_in.device)
        img, y, ym = G(out["img_logits"]), G(batch["y_multi"]), \
            G(batch["y_multi_mask"])
        losses = L.dual_pathology_loss(
            img, G(out["ts_logits"]), G(out["fusion_logits"]), y, ym, lw,
            pos_weight, cfg.alpha_img, cfg.alpha_ts, cfg.alpha_fus)
        total = losses["total"]
        if cfg.aux_residual_alpha > 0.0 or lp_mode:
            corr = G(out["scaled_correction"])
        if cfg.aux_residual_alpha > 0.0:
            aux = L.aux_residual_kl(img, corr, y, ym)
            losses["aux_residual"] = aux
            total = total + cfg.aux_residual_alpha * aux
        if lp_mode:
            beta = state.model.perceiver.beta
            losses["reg_beta_l2"] = lp_beta_l2 * param_term(
                (beta ** 2).mean())
            losses["reg_corr_l2"] = lp_corr_l2 * (corr ** 2).mean()
            total = total + losses["reg_beta_l2"] + losses["reg_corr_l2"]
        losses["total"] = total
        state.apply_gradients(total)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["main_logit"] = out["main_logit"].detach().float()
        return metrics

    return step


_WARM = object()     # a K-stacked shape whose eager first call has run


def launch_counters() -> tuple:
    """Every kernel wrapper's launch counter (and the int8 matmul's call
    counter): the dicts a graph's replay adds its captured launches to."""
    from ..ops import attention, dual_axis, gather, int8, jpeg, ln_qkv
    return (attention.LAUNCHES, gather.LAUNCHES, dual_axis.LAUNCHES,
            ln_qkv.LAUNCHES, jpeg.LAUNCHES, int8.CALLS)


def launches_since(before: list) -> list:
    """What each counter of ``launch_counters`` gained since ``before``
    (``[dict(c) for c in launch_counters()]``)."""
    return [{n: c[n] - b[n] for n in c}
            for c, b in zip(launch_counters(), before)]


def add_launches(added: list) -> None:
    """Count a graph's captured launches (``launches_since``) again: a
    replay runs no wrapper."""
    for counter, more in zip(launch_counters(), added):
        for n, v in more.items():
            counter[n] += v


def _collect(outs: list) -> Dict[str, torch.Tensor]:
    """K steps' metrics as JAX ``scan_steps`` returns them: each scalar
    summed over the K steps, its K values under ``per_step``; any other
    metric stacked [K, ...]."""
    out: Dict[str, torch.Tensor] = {}
    per_step: Dict[str, torch.Tensor] = {}
    for key in outs[0]:
        vals = torch.stack([o[key] for o in outs])
        if vals.ndim == 1:
            per_step[key] = vals
            out[key] = vals.sum(0)
        else:
            out[key] = vals
    out["per_step"] = per_step
    return out


class _CapturedSteps:
    """K steps captured as one CUDA graph, with static input buffers for the
    K-stacked batch and a memory pool of its own. The capture runs no step
    (the graph's first replay does), but the wrappers count the launches
    they record: that count is the graph's, added again at each later
    replay."""

    def __init__(self, step: Callable, state: TrainState, fixed: tuple,
                 batches: Dict[str, torch.Tensor], gen: torch.Generator):
        self.k = next(iter(batches.values())).shape[0]
        self.state, self.fixed, self.gen = state, fixed, gen
        self.version = state.optimizer.version
        self.inputs = {n: torch.empty_like(v) for n, v in batches.items()}
        for n, v in batches.items():
            self.inputs[n].copy_(v)
        self.graph = torch.cuda.CUDAGraph()
        # replays then draw from ``gen`` at its state of the moment, and
        # advance it by what the K steps draw, as eager steps do
        self.graph.register_generator_state(gen)
        before = [dict(c) for c in launch_counters()]
        # thread_local: the prefetch worker's pinned copies and allocations
        # on its own stream and thread go on during the capture
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out = _collect([
                step(state, *fixed,
                     {n: v[i] for n, v in self.inputs.items()}, gen)
                for i in range(self.k)])
        self.launches = launches_since(before)
        # the capture advanced the host count by K, the replay advances
        # the device count
        self.graph.replay()

    def binds(self, state: TrainState, fixed: tuple,
              gen: torch.Generator) -> bool:
        """Whether a call with these arguments is one this graph replays."""
        return state is self.state and gen is self.gen and \
            len(fixed) == len(self.fixed) and \
            all(a is b for a, b in zip(fixed, self.fixed))

    def replay(self, batches: Dict[str, torch.Tensor]) -> None:
        for n, v in batches.items():
            self.inputs[n].copy_(v)
        self.graph.replay()
        self.state.advance_host_step(self.k)
        add_launches(self.launches)

    def outputs(self) -> Dict[str, torch.Tensor]:
        """This replay's metrics, copied out of the graph's buffers."""
        out = {k: v.clone() for k, v in self.out.items() if k != "per_step"}
        out["per_step"] = {k: v.clone()
                           for k, v in self.out["per_step"].items()}
        return out


def steps_per_call(k: int) -> int:
    """A loop's steps per call: ``k``, at least 1."""
    return max(1, int(k))


def capture_route(device, k: int,
                  log: Optional[Callable[[str], None]] = None) -> bool:
    """Whether ``scan_steps`` captures a loop's K steps on ``device`` as CUDA
    graphs, chosen from the process group's backend before the first step:
    on a card, in one process or an NCCL group (its collectives run on the
    capturing stream); a loop of K steps in a gloo group, whose collectives
    copy through the host (logged), and on the CPU."""
    if mh.process_count() > 1 and torch.distributed.get_backend() != "nccl":
        if log is not None:
            log(f"[multistep] K={k} as a loop over "
                f"{torch.distributed.get_backend()} (a host-side collective "
                "cannot be captured)")
        return False
    return torch.device(device).type == "cuda"


def step_rows(out: Dict[str, torch.Tensor], keys) -> torch.Tensor:
    """[K, len(keys)]: the scalars ``keys`` of each step of a call, in step
    order, from a single step's metrics (K = 1) or a ``scan_steps`` call's
    ``per_step``. A loop that sums them row by row sums what K single
    steps give it in the same order, so its sums do not depend on K."""
    if "per_step" in out:
        return torch.stack([out["per_step"][k] for k in keys], 1)
    return torch.stack([out[k] for k in keys])[None]


def scan_steps(step: Callable, k: int,
               log: Optional[Callable[[str], None]] = None,
               capture: bool = True) -> Callable:
    """K train steps per call: the counterpart of JAX ``engine.py:239``
    ``scan_steps`` (``--steps_per_call K``).

    ``step(state, [consts,] grid, static, batch, gen)`` is a step factory's
    step; the returned ``multi(state, [consts,] grid, static, batches,
    gen)`` takes a K-stacked batch (``data/prefetch.stack_host_batches``,
    a leading axis of 1..``k`` on every field) and runs its K steps in
    order, exactly as K calls of ``step``: the same losses, parameters,
    BatchNorm statistics, AdamW moments, step count and generator state,
    bit for bit. Returned metrics: each scalar summed over the K steps, its
    K values under ``out["per_step"]`` (for ``--log_every`` and for sums
    taken in step order), any other metric (``main_logit``) stacked
    [K, ...].

    On the CPU, or with ``capture`` False (``capture_route``: a gloo group),
    a call is a loop of the K steps. On a card, each K-stacked
    shape (the full groups, and the remainder group as a second shape, as
    JAX compiles a second scan) runs its first call as K eager steps
    (real steps, which also warm up what capture needs: the kernels'
    build, cuBLAS, the autograd streams); its second call captures the K
    steps as one ``torch.cuda.CUDAGraph`` and replays it; every later call
    copies its batch into the graph's input buffers and replays. A capture
    or replay that fails raises: there is no return to eager steps. The
    graph binds the state, the constants, grid, static and ``gen`` of its
    capture; a call with others raises. A change of the optimizer's
    schedule table (``MultiGroupAdamW.reserve`` growing it) drops the
    graph, which the next two calls build again. The step generator must
    be the one the steps draw from, registered with each graph
    (``CUDAGraph.register_generator_state``), so that a replay draws what
    K eager steps draw.

    JAX's ``split_chain`` has no counterpart: the port's steps draw from
    one ``torch.Generator`` in step order, so K steps in one call consume
    it as K calls do; the bit-equal tests of ``tests/test_torch_multistep
    .py`` hold the port to that, as JAX's ``split_chain`` holds the key
    chain to its single-step loop's. In a multi-process run each rank's K
    steps draw at the global batch's size (``multihost.draw_rows``) and
    gather as its K single steps do, so K steps equal K single steps there
    too (``tests/test_torch_multihost_2proc.py``)."""
    if k < 1:
        raise ValueError(f"steps per call must be at least 1, got {k}")
    # K-stacked shape → _WARM after its eager first call, then its graph
    graphs: Dict[tuple, object] = {}

    def multi(state: TrainState, *args) -> Dict[str, torch.Tensor]:
        *fixed, batches, gen = args
        sizes = {v.shape[0] for v in batches.values()}
        if len(sizes) != 1 or not 1 <= min(sizes) <= k:
            raise ValueError(f"a K-stacked batch of 1..{k} steps expected, "
                             f"got leading sizes {sorted(sizes)}")
        kk = sizes.pop()
        key = tuple(sorted((n, tuple(v.shape), v.dtype)
                           for n, v in batches.items()))
        g = None
        if capture and state.step_t.device.type == "cuda":
            state.optimizer.reserve(state.step + kk)
            g = graphs.get(key)
            if isinstance(g, _CapturedSteps) and \
                    g.version != state.optimizer.version:
                g = None        # its schedule table was replaced
            graphs[key] = g or _WARM
        if g is None:           # the CPU, or a shape's first call
            return _collect([
                step(state, *fixed, {n: v[i] for n, v in batches.items()},
                     gen) for i in range(kk)])
        if g is _WARM:
            g = graphs[key] = _CapturedSteps(step, state, tuple(fixed),
                                              batches, gen)
            if log is not None:
                log(f"[multistep] captured K={kk} steps as one CUDA graph "
                    f"(step {state.step - kk})")
        elif g.binds(state, tuple(fixed), gen):
            g.replay(batches)
        else:
            raise ValueError("a captured multi-step call replays with the "
                             "state, constants, data and generator of its "
                             "capture")
        return g.outputs()

    return multi


def make_teacher_pathology_step(cfg: TrainConfig, duett_cfg: DuettConfig,
                                n_timesteps: int, label_weights,
                                pos_weight=None, dtype=torch.bfloat16,
                                alpha_stage2: float = 1.0,
                                alpha_stage4: float = 0.5,
                                image_source: Callable = default_image_source,
                                feature_source: Optional[Callable] = None
                                ) -> Callable:
    """``single`` mode's step (JAX ``engine.py:287-330``, reference
    training_duett/engine.py:94-129): stage 2 + stage 4 masked multi-label
    BCE, weighted ``alpha_stage2`` and ``alpha_stage4`` (the loop passes
    ``TrainConfig.aux_stage2_alpha`` and ``aux_stage4_alpha``). Returns
    the loss parts and ``main_logit``, detached."""
    weights = _on_device(label_weights)

    def step(state: TrainState, grid, static, batch, gen
             ) -> Dict[str, torch.Tensor]:
        x_in, x_static, times = _prep_inputs(
            grid, static, batch, n_timesteps, dtype, gen,
            duett_cfg.aug_noise, duett_cfg.aug_mask, train=True)
        pixels, feats = _cxr_inputs(batch, image_source, feature_source,
                                    dtype)
        out = state.model(x_in, x_static, times, pixels, train=True, gen=gen,
                          cxr_feats=feats)
        lw = weights(x_in.device)
        losses = L.pathology_multilabel_loss(
            G(out["stage2_logits"]), G(out["stage4_logits"]),
            G(batch["y_multi"]), G(batch["y_multi_mask"]), lw, pos_weight,
            alpha_stage2, alpha_stage4)
        state.apply_gradients(losses["total"])
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["main_logit"] = out["main_logit"].detach().float()
        return metrics

    return step


def make_teacher_legacy_step(cfg: TrainConfig, duett_cfg: DuettConfig,
                             n_timesteps: int, dtype=torch.bfloat16,
                             aux_alpha: float = 0.0,
                             image_source: Callable = default_image_source
                             ) -> Callable:
    """``legacy`` mode's step (JAX ``engine.py:350-381``, reference
    training_duett/engine.py:42-73), on pixels only: the binary BCE of
    ``main_logit`` on ``batch["y"]``, plus ``aux_alpha`` × the auxiliary
    CXR head's BCE, which is 0.0 when ``aux_alpha`` is 0. Returns
    ``loss``, ``main_loss``, ``aux_loss`` and ``logits``, detached."""
    def step(state: TrainState, grid, static, batch, gen
             ) -> Dict[str, torch.Tensor]:
        x_in, x_static, times = _prep_inputs(
            grid, static, batch, n_timesteps, dtype, gen,
            duett_cfg.aug_noise, duett_cfg.aug_mask, train=True)
        out = state.model(x_in, x_static, times,
                          image_source(batch).to(dtype), train=True, gen=gen)
        y = G(batch["y"])
        main_loss = L.bce_with_logits(G(out["main_logit"]), y)
        aux_loss = L.bce_with_logits(G(out["aux_logit"]), y) \
            if aux_alpha > 0 else torch.zeros((), device=x_in.device)
        total = main_loss + aux_alpha * aux_loss
        state.apply_gradients(total)
        return {"loss": total.detach(), "main_loss": main_loss.detach(),
                "aux_loss": aux_loss.detach(),
                "logits": out["main_logit"].detach()}

    return step


def make_teacher_eval(n_timesteps: int, dtype=torch.bfloat16,
                      image_source: Callable = default_image_source,
                      feature_source: Optional[Callable] = None,
                      keys=EVAL_KEYS) -> Callable:
    """``step(model, grid, static, batch)`` → the eval outputs ``keys`` as
    float32 tensors: eval mode, no gradients, no augmentation. ``keys``:
    ``EVAL_KEYS`` (the residual-fusion modes) or ``PATHOLOGY_EVAL_KEYS``
    (``single``: JAX ``make_teacher_pathology_eval``); ``None`` returns
    ``main_logit`` alone as a tensor (``legacy``, the binary eval of JAX
    ``teacher_loop.py:464-479``)."""
    def step(model, grid, static, batch):
        with torch.inference_mode():
            x_in, x_static, times = _prep_inputs(grid, static, batch,
                                                 n_timesteps, dtype)
            pixels, feats = _cxr_inputs(batch, image_source, feature_source,
                                        dtype)
            out = model(x_in, x_static, times, pixels, cxr_feats=feats)
            if keys is None:
                return out["main_logit"].float()
            return {k: out[k].float() for k in keys}

    return step


def make_teacher_eval_from_windows(
        model, dtype=torch.bfloat16,
        image_source: Callable = default_image_source,
        feature_source: Optional[Callable] = None,
        return_attn: bool = False) -> Callable:
    """``step(x_ts [B,T,2V], x_static [B,D], batch)`` → the five eval
    outputs as float32 tensors on the model's device (those the model's
    mode has: ``main_logit`` alone for ``single`` and ``legacy``), and with
    ``return_attn`` the perceiver's attentions and tokens too
    (``img_attn``, ``ts_attn``, ``event_attn``, ``img_tokens``,
    ``ts_tokens``, ``fusion_tokens``, those the mode has; JAX
    ``engine.py:403-427``).
    ``batch`` carries ``bin_ends`` [B, T] and either ``pixel_u8``
    [B, S, S, 3] for the ViT or, with ``feature_source`` (e.g.
    ``CXRFeatureBank.feature_source(keyed_by_row=False)`` over raw
    ``image_ids``), what that source reads:
    windows perturbed on the host then reuse the cached tokens (JAX
    ``engine.py:403-432``). numpy or torch inputs are moved to the model's
    device."""
    device = next(model.parameters()).device

    def step(x_ts, x_static, batch: dict) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            b = to_device(batch, device)
            x_in, xs = feats_to_input(
                _as_tensor(x_ts, device).to(dtype),
                _as_tensor(x_static, device).to(dtype))
            pixels, feats = _cxr_inputs(b, image_source, feature_source,
                                        dtype)
            out = model(x_in, xs, b["bin_ends"].to(dtype), pixels,
                        cxr_feats=feats, return_attn=return_attn)
            keys = EVAL_KEYS + (ATTN_KEYS if return_attn else ())
            return {k: out[k].float() for k in keys if k in out}

    return step


def make_supervised_ts_step(duett_cfg: DuettConfig, n_timesteps: int,
                            dtype=torch.bfloat16, pos_weight=None
                            ) -> Callable:
    """``step(state, grid, static, batch, gen)`` → ``loss`` and ``logits``
    (float32), detached: one update of a time-series model (the student
    architecture) on the BCE of ``batch["y"]`` (JAX ``engine.py:51-79``).
    Augmentation and dropout draw from ``gen``; BatchNorm takes batch
    statistics and updates its running ones; ``state`` is updated in
    place."""
    def step(state: TrainState, grid, static, batch, gen
             ) -> Dict[str, torch.Tensor]:
        x_in, x_static, times = _prep_inputs(
            grid, static, batch, n_timesteps, dtype, gen,
            duett_cfg.aug_noise, duett_cfg.aug_mask, train=True)
        logits = state.model(x_in, x_static, times, train=True, gen=gen)
        loss = L.bce_with_logits(logits, batch["y"], pos_weight=pos_weight)
        state.apply_gradients(loss)
        return {"loss": loss.detach(), "logits": logits.detach().float()}

    return step


def make_supervised_ts_eval(n_timesteps: int, dtype=torch.bfloat16
                            ) -> Callable:
    """``step(model, grid, static, batch)`` → a time-series model's logits
    [B] as float32 (the student's eval, JAX ``engine.py:82-92``): eval
    mode, no gradients, no augmentation."""
    def step(model, grid, static, batch) -> torch.Tensor:
        with torch.inference_mode():
            x_in, x_static, times = _prep_inputs(grid, static, batch,
                                                 n_timesteps, dtype)
            return model(x_in, x_static, times).float()

    return step


def make_kd_step(cfg: TrainConfig, duett_cfg: DuettConfig, n_timesteps: int,
                 dtype=torch.bfloat16,
                 image_source: Callable = default_image_source,
                 feature_source: Optional[Callable] = None) -> Callable:
    """``step(state, teacher, grid, static, batch, gen)`` → metrics: one
    student update by knowledge distillation (JAX ``engine.py:435-477``,
    reference training_duett/engine.py:270-301). The frozen teacher sees
    the un-augmented inputs in eval mode under ``torch.no_grad()`` (not
    ``inference_mode``: the KD loss keeps its probabilities for the
    student's backward), on pixels through its ViT or on the tier's cached
    tokens; the student sees the inputs augmented from ``gen``, trains with
    dropout from ``gen`` and updates its BatchNorm statistics. The loss is
    α·BCE + (1 − α)·KD (``ops/losses.student_kd_loss``). Returns ``total``,
    ``bce``, ``kd`` and the student's ``logits``, detached, on the device;
    ``state`` (the student's) is updated in place."""
    def step(state: TrainState, teacher, grid, static, batch, gen
             ) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            x_in_t, x_static_t, times = _prep_inputs(
                grid, static, batch, n_timesteps, dtype)
            pixels, feats = _cxr_inputs(batch, image_source, feature_source,
                                        dtype)
            z_t = teacher(x_in_t, x_static_t, times, pixels,
                          cxr_feats=feats)["main_logit"].detach()
        x_in, x_static, _ = _prep_inputs(
            grid, static, batch, n_timesteps, dtype, gen,
            duett_cfg.aug_noise, duett_cfg.aug_mask, train=True)
        z_s = state.model(x_in, x_static, times, train=True, gen=gen)
        losses = L.student_kd_loss(G(z_s), G(z_t), G(batch["y"]), cfg.kd_T,
                                   cfg.kd_alpha, kd_name=cfg.kd_name)
        state.apply_gradients(losses["total"])
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["logits"] = z_s.detach().float()
        return metrics

    return step


def _ssl_forward(model, duett_cfg: DuettConfig, n_timesteps: int, grid,
                 static, batch, dtype, gen, train: bool) -> dict:
    """Window gather → SSL masking (or the batch's ``ssl_mask_idx`` /
    ``ssl_event_var``) → the pretrain model → ``ssl_pretrain_loss``."""
    x_ts = gather_windows(grid, batch["stay_rows"], batch["slot_idx"],
                          n_timesteps)
    x_static = static[batch["stay_rows"].long()].to(dtype)
    times = batch["bin_ends"].to(dtype)
    pb = pretrain_prep_batch(
        x_ts, duett_cfg.pretrain_masked_steps, duett_cfg.pretrain_dropout,
        duett_cfg.predict_events, mask_idx=batch.get("ssl_mask_idx"),
        event_var=batch.get("ssl_event_var"), gen=gen)
    pb = pb._replace(x_in=pb.x_in.to(dtype))
    out = model(pb, x_static, times, train=train, gen=gen)
    return L.ssl_pretrain_loss(
        G(out["y_hat_value"]), G(out["y_hat_presence"]),
        G(out["y_hat_events"]), G(out["y_hat_events_presence"]),
        G(pb.y_value), G(pb.y_presence_mask), G(pb.y_events),
        G(pb.y_events_mask),
        pretrain_value=duett_cfg.pretrain_value,
        pretrain_presence=duett_cfg.pretrain_presence,
        presence_weight=duett_cfg.pretrain_presence_weight,
        predict_events=duett_cfg.predict_events)


def make_ssl_step(duett_cfg: DuettConfig, n_timesteps: int,
                  dtype=torch.bfloat16) -> Callable:
    """``step(state, grid, static, batch, gen)`` → loss parts: one DuETT SSL
    update (JAX ``engine.py:97-134``, reference duett.py:329-358). The masks
    and dropout draw from ``gen``; the parts come back detached, on the
    device; ``state`` is updated in place."""
    def step(state: TrainState, grid, static, batch, gen
             ) -> Dict[str, torch.Tensor]:
        parts = _ssl_forward(state.model, duett_cfg, n_timesteps, grid,
                             static, batch, dtype, gen, train=True)
        state.apply_gradients(parts["total"])
        return {k: v.detach() for k, v in parts.items()}

    return step


def make_ssl_eval(duett_cfg: DuettConfig, n_timesteps: int,
                  dtype=torch.bfloat16) -> Callable:
    """``step(model, grid, static, batch, gen)`` → loss parts in eval mode,
    no gradients (JAX ``engine.py:480-516``). The reference's quirk is
    kept: ``total`` leaves out the event-presence term that the training
    step includes (duett.py:394-399 against :355-358), so the best
    checkpoint is chosen on value + presence + event value;
    ``total_all_terms`` is the full sum."""
    def step(model, grid, static, batch, gen) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            parts = _ssl_forward(model, duett_cfg, n_timesteps, grid, static,
                                 batch, dtype, gen, train=False)
        parts["total_all_terms"] = parts["total"]
        if duett_cfg.predict_events and duett_cfg.pretrain_presence:
            parts["total"] = parts["total"] - parts["event_presence"]
        return parts

    return step
