"""Student knowledge-distillation loop, the paper's second stage: the port's
counterpart of ``multimodal_edema_prediction_tpu/train/kd_loop.py``
(reference ``training_duett/trainer.py:828-989``).

The teacher is rebuilt from its checkpoint and config sidecar, written by
either package (``checkpoint.load_teacher_from_ckpt``), and frozen; the
student, a DuETT backbone and a head on the time series alone
(``models/student.py``), trains with α·BCE + (1 − α)·T²·binary KL against
the teacher's logit (``engine.make_kd_step``). Per epoch: shuffled train
batches (the loss parts stay on the device until the epoch's one host
sync), the val AUROC, early stopping and the best checkpoint (JAX format,
config ``{"model", "train", "teacher_ckpt"}``); at the end the test split
is evaluated from the best checkpoint, reloaded.

Image tiers, as the teacher loop's (``teacher_loop.build_feature_tier``):
``feature_cache="none"`` runs the teacher's ViT inside every KD step on
pixels (K1's forward, once per ViT layer); ``"hbm"`` encodes every unique
image once into a bank on the card and each step gathers its rows through
K2; ``"host"`` keeps the tokens in a host store (RAM, or a disk memmap at
``feature_store_path``) that the batch hook reads, so the step launches
neither kernel for them; ``"auto"`` takes the bank within
``hbm_feature_budget_gb``, else the host store. The student's evaluation
needs no teacher and no image.

With ``save_full_state`` the full train state is saved at every epoch
boundary (``FullStateResumer``: msgpack, or ``state_backend="orbax"``'s
async orbax steps, committed before the call returns) and ``auto_resume``
continues from it bit for bit; a SIGTERM (``utils/preemption.py``) saves it
at the next boundary and ends the call cleanly. The teacher may be of any
mode: the student distills its ``main_logit`` (JAX ``kd_loop.py:80-82``;
the reference distills only from ``dual``).

Multi-step dispatch (``cfg.steps_per_call`` K > 1; JAX ``kd_loop.py:
194-250``): each group of K train batches (``stack_host_batches``; the
remainder group last) goes through ``engine.scan_steps``, the frozen
teacher's eval-mode forward (under ``no_grad``) inside each of the K
steps, one CUDA graph replay per group on a card (in one process or an
NCCL group; a loop of K steps over gloo, ``engine.capture_route``); the
history, weights and generator equal K = 1's bit for bit, in a
multi-process run too.

Multi-process (JAX ``kd_loop.py:74-311``): under an initialised
``torch.distributed`` group each rank distills on its rows of the same
global batches (``parallel/multihost.py``: the global batch's loss and
draws, gradients summed over the ranks); a cached tier encodes only the
rank's ``image_id % P`` share into a host store (no card bank); every rank
keeps the best student in memory and tests it, and only rank 0 writes.
"""
from __future__ import annotations

import copy
import time
from typing import Callable, Optional

import torch

from ..config import StudentConfig, TrainConfig
from ..data.pipeline import AnchorDataset
from ..data.prefetch import stack_host_batches
from ..models.student import StudentModel, init_student
from ..parallel import mesh as meshlib
from ..parallel import multihost as mh
from ..utils import preemption, resolve_device
from . import engine
from .checkpoint import (BestKTracker, FullStateResumer,
                         load_student_from_ckpt, load_teacher_from_ckpt)
from .loops import (EarlyStopper, TrainResult, evaluate_binary_split,
                    without_valid)
from .optim import MultiGroupAdamW
from .ssl_loop import transplant_encoder
from .state import TrainState, param_count
from .teacher_loop import (DTYPES, _sync, build_feature_tier,
                           make_synthetic_pixel_hook)

LOSS_KEYS = ("total", "bce", "kd")


def check_ported(cfg: TrainConfig) -> int:
    """Raise on what the port cannot run yet, on every device, or on a
    launcher's process count with no group to run it; → the process
    count."""
    world = mh.check_group()
    if world > 1:
        meshlib.create_mesh(cfg.n_data, cfg.n_model)
    return world


def train_student_kd(dataset: AnchorDataset, student_cfg: StudentConfig,
                     teacher_ckpt: str, cfg: TrainConfig, ckpt_dir: str,
                     model: Optional[StudentModel] = None,
                     device="cuda",
                     image_hook: Optional[Callable[[dict], dict]] = None,
                     ssl_backbone_ckpt: Optional[str] = None,
                     auto_resume: bool = False,
                     save_full_state: Optional[bool] = None,
                     state_backend: str = "msgpack",
                     stop_after_epochs: Optional[int] = None,
                     feature_cache: str = "none",
                     feature_store_path: Optional[str] = None,
                     hbm_feature_budget_gb: float = 8.0,
                     log: Callable[[str], None] = print) -> TrainResult:
    """Distill the student; returns the best val AUROC, its checkpoint, the
    per-epoch history (``train_total``/``bce``/``kd`` means and the val
    ``binary_metrics``) and the test metrics.

    ``model``: the student's initial weights (default: ``init_student``
    from ``cfg.seed``), moved to ``device`` and trained in place;
    ``ssl_backbone_ckpt`` then loads its DuETT backbone from an SSL
    checkpoint (``ssl_loop.transplant_encoder``). ``image_hook``: host
    batch hook that attaches ``pixel_values`` (default: the synthetic
    cohort's procedural images), run on every batch of the pixel tier and
    once per unique image by the cached tiers. ``stop_after_epochs`` pauses
    after that many epochs of this call, the state saved as a preempted
    run's would be."""
    world = check_ported(cfg)
    multi = world > 1
    if feature_cache not in ("none", "auto", "hbm", "host"):
        raise ValueError(f"unknown feature_cache mode {feature_cache!r}")
    if save_full_state is None:
        save_full_state = auto_resume
    resumer = FullStateResumer(ckpt_dir, state_backend)
    dev = mh.rank_device(resolve_device(device))
    dtype = DTYPES[cfg.dtype]

    teacher, teacher_cfg, t_ckpt = load_teacher_from_ckpt(teacher_ckpt, dev)
    teacher.requires_grad_(False)
    log(f"teacher from {teacher_ckpt} (metric={t_ckpt['metric']:.4f}, "
        f"mode={teacher_cfg.perceiver_type})")
    dataset.to(dev)
    image_hook = image_hook or make_synthetic_pixel_hook(
        teacher_cfg.vit.image_size)
    phase = {}
    feature_source, tier = None, {"tier": "pixels"}
    dataset.batch_hook = image_hook
    if feature_cache != "none":
        feature_source, tier = build_feature_tier(
            teacher, dataset, image_hook, dtype, feature_cache,
            hbm_feature_budget_gb, feature_store_path, dev, log)
        phase["feature_build"] = tier["build_s"]

    if model is None:
        model = init_student(student_cfg, cfg.seed)
    model = model.to(dev)
    if ssl_backbone_ckpt:
        changed = transplant_encoder(ssl_backbone_ckpt, model)
        log(f"student backbone from {ssl_backbone_ckpt} ({len(changed)} "
            "keys adjusted)")
    log(f"student params: {param_count(model):,}  device={dev}")

    steps_per_epoch = dataset.split_size("train") // cfg.batch_size
    if cfg.limit_batches > 0:
        steps_per_epoch = min(steps_per_epoch, cfg.limit_batches)
    state = TrainState(model, MultiGroupAdamW(
        model, cfg.optim, max(steps_per_epoch * cfg.epochs, 1)))
    T = dataset.n_timesteps
    kd_step = engine.make_kd_step(cfg, student_cfg.duett, T, dtype,
                                  feature_source=feature_source)
    scan_k = engine.steps_per_call(cfg.steps_per_call)
    if scan_k > 1:
        # the frozen teacher rides along as a constant of the K steps
        kd_step = engine.scan_steps(kd_step, scan_k, log,
                                    engine.capture_route(dev, scan_k, log))
    loop_eval = engine.make_supervised_ts_eval(T, dtype)
    n_eval = [0]

    def eval_step(m, grid, static, batch):
        n_eval[0] += 1
        return loop_eval(m, grid, static, batch)

    def run_eval(m, split: str) -> dict:
        t0 = time.perf_counter()
        r = evaluate_binary_split(eval_step, m, dataset, split,
                                  cfg.batch_size)
        phase["eval"] = phase.get("eval", 0.0) + time.perf_counter() - t0
        return r

    stopper = EarlyStopper(cfg.patience, mode="max")
    tracker = BestKTracker(ckpt_dir, k=1, mode="max", prefix="best")
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    cfg_dict = {"model": student_cfg.to_dict(), "train": cfg.to_dict(),
                "teacher_ckpt": teacher_ckpt}
    history, start_epoch, n_steps = [], 0, 0
    best_state = None   # multi-process: every rank keeps the best in memory
    if auto_resume:
        meta = resumer.restore(state)
        if meta is not None:
            start_epoch, history, n_steps = resumer.apply_meta(
                meta, stopper, tracker, gen)
            if multi and tracker.best is not None:
                # the best so far, from the run directory every rank reads
                best_state = load_student_from_ckpt(tracker.best[1], dev)[0].state_dict()
            log(f"[resume:{state_backend}] continuing at epoch "
                f"{start_epoch}")

    step_losses = {k: [] for k in LOSS_KEYS}
    phase["train"] = 0.0
    t_start, resumed_steps = time.perf_counter(), n_steps
    for epoch in range(start_epoch, cfg.epochs):
        outs = []
        t0 = time.perf_counter()
        batches = without_valid(dataset.iter_batches(
            "train", cfg.batch_size, shuffle=True, seed=cfg.seed + epoch,
            limit=cfg.limit_batches))
        if scan_k > 1:
            batches = stack_host_batches(batches, scan_k)
        for b in batches:
            out = kd_step(state, teacher, dataset.grid, dataset.static,
                          engine.to_device(b, dev), gen)
            rows = engine.step_rows(out, LOSS_KEYS)
            outs.extend(rows)
            n_steps += rows.shape[0]
        # one host sync per epoch
        per_step = torch.stack(outs).tolist() if outs else []
        phase["train"] += time.perf_counter() - t0
        nb = max(len(per_step), 1)
        run = {}
        for i, k in enumerate(LOSS_KEYS):
            step_losses[k] += [s[i] for s in per_step]
            run[k] = sum(s[i] for s in per_step)
        val = run_eval(model, "val")
        improved = stopper.update(val["auroc"])
        if improved:
            if multi:
                best_state = {k: v.detach().clone()
                              for k, v in model.state_dict().items()}
            if mh.is_main_process():
                tracker.offer(val["auroc"], model, state.step, cfg_dict)
        history.append({"epoch": epoch,
                        **{f"train_{k}": v / nb for k, v in run.items()},
                        **val})
        log(f"epoch {epoch:3d}  loss={run['total'] / nb:.4f} "
            f"(bce={run['bce'] / nb:.3f} kd={run['kd'] / nb:.3f})  "
            f"val_auroc={val['auroc']:.4f}{'  *' if improved else ''}")
        # agreed over the ranks: a SIGTERM may reach only some of them
        preempted = mh.any_flag(preemption.requested())
        if save_full_state or preempted:
            resumer.save(state, epoch, stopper, tracker, history, n_steps,
                         gen)
        if preempted:
            log(f"SIGTERM/preemption at epoch {epoch}: state saved; resume "
                "with auto_resume / --resume_dir")
            break
        if stopper.should_stop:
            break
        if stop_after_epochs is not None \
                and epoch + 1 - start_epoch >= stop_after_epochs:
            log(f"pausing after {stop_after_epochs} epochs")
            break
    resumer.finish()    # the orbax save in flight, committed (JAX :307)
    _sync(dev)
    elapsed = time.perf_counter() - t_start

    if mh.is_main_process():
        tracker.ensure_saved(model, state.step, cfg_dict)
        best_metric, best_path = tracker.best
    else:
        best_metric = stopper.best if stopper.best is not None \
            else float("nan")
        best_path = ""
    if multi:
        best_model = copy.deepcopy(model)
        if best_state is not None:
            best_model.load_state_dict(best_state)
    else:
        best_model, _, _ = load_student_from_ckpt(best_path, dev)
    test = run_eval(best_model, "test")
    mh.barrier()    # rank 0's files are complete before any rank returns
    log(f"test: auroc={test['auroc']:.4f} auprc={test['auprc']:.4f}")

    ran = n_steps - resumed_steps
    sps = ran / max(elapsed, 1e-9)
    return TrainResult(
        best_metric=best_metric, best_path=best_path, history=history,
        test_metrics=test, steps_per_sec=sps,
        samples_per_sec=sps * cfg.batch_size,
        extras={"phase_seconds": phase, "n_train_steps": ran,
                "n_eval_steps": n_eval[0], "feature_tier": tier,
                "step_losses": step_losses, "evaluate": run_eval,
                "state": state, "generator": gen})
