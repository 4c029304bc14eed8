"""Multi-process data parallelism on ``torch.distributed``: the port's
counterpart of ``multimodal_edema_prediction_tpu/parallel/multihost.py``.

Every process iterates the same seeded global batches and keeps its own
contiguous slice of rows (``split_batch_for_process``); the full label
arrays ride along under ``batch["_global"]`` for evaluation. Under GSPMD a
JAX step computes over the global array; here each rank holds only its
rows, so a step reproduces the global batch's meaning by hand:

- **losses**: the outputs that feed a loss, and their labels, are gathered
  over the ranks (``gather_rows``), so every rank computes the loss of the
  whole batch, masked counts and all; the gather's backward keeps this
  rank's rows, so each rank's gradient is its rows' share and the shares
  sum (``all_reduce_grads``) to the global gradient. A term of the
  parameters alone would be counted once per rank: ``param_term`` divides
  its gradient by the world size;
- **BatchNorm** (``models/layers.py``) takes the global batch's mean and
  variance through ``all_reduce_sum``, whose backward all-reduces too;
- **random draws** (dropout, augmentation, SSL masks): ``draw_rows`` draws
  for the global batch from the same generator on every rank and keeps
  this rank's rows, which is what JAX's sharded draw gives.

With one process every function here is the identity, and the steps are
unchanged bit for bit. The host gathers (``fetch_global``,
``gather_metrics``, ``any_flag``) go through ``all_gather_object``, which
runs over gloo with CUDA ranks; the in-step collectives are ``all_reduce``
on the step's own device, which gloo takes for CUDA tensors as NCCL does.

JAX's ``maybe_raw_key`` has no counterpart: the port draws from explicit
``torch.Generator``s seeded alike on every rank. ``global_batch_from_local``
and ``replicate_to_mesh`` have none either: a rank's batch and weights are
ordinary tensors on its own device.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# host-side label/index keys kept globally (for evaluation) when batches are
# process-sliced; see split_batch_for_process (JAX multihost.py:24)
GLOBAL_LABEL_KEYS = ("y", "y_multi", "y_multi_mask", "valid", "stay_rows")


def _live() -> bool:
    return dist.is_available() and dist.is_initialized()


def choose_backend(local_world: int, device="cuda") -> str:
    """``nccl`` when each of the host's ``local_world`` ranks has a card of
    its own, else ``gloo`` (ranks that share a card, or run on the CPU):
    NCCL refuses two ranks on one device, and gloo takes CUDA tensors for
    ``all_reduce`` and ``broadcast``, the only collectives a step runs on
    the device (the host gathers run on CPU pickles)."""
    if torch.device(device).type == "cuda" and torch.cuda.is_available() \
            and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda") -> Optional[str]:
    """Join the process group of a multi-process run (JAX
    ``multihost.py:27``); nothing for one process. With no arguments the
    launcher's ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and
    ``WORLD_SIZE`` name the group (JAX's auto-detection); a failed join
    raises. The backend follows ``choose_backend`` over the host's ranks
    (``LOCAL_WORLD_SIZE``, else every rank on this host) and ``device``,
    where the ranks compute; under NCCL the rank's card (``LOCAL_RANK``,
    else the rank) becomes its current device.
    Returns the backend, or None when there is no group to join; a group
    already joined is kept, and its backend returned."""
    if _live():
        return dist.get_backend()
    env = os.environ
    if num_processes is None and coordinator_address is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
        if num_processes > 1:
            coordinator_address = \
                f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
            process_id = int(env["RANK"])
    if num_processes is None or num_processes <= 1:
        return None
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator's "
                         "address and this process's id")
    local_world = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    local_rank = int(env.get("LOCAL_RANK", process_id))
    backend = choose_backend(local_world, device)
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return backend


def rank_device(device="cuda") -> torch.device:
    """This rank's device for ``device``: under NCCL the rank's own card
    (the current device ``initialize_distributed`` set), under gloo the
    card the ranks share; ``device`` as given otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and _live() \
            and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def process_count() -> int:
    return dist.get_world_size() if _live() else 1


def process_index() -> int:
    return dist.get_rank() if _live() else 0


def is_main_process() -> bool:
    return process_index() == 0


def check_group() -> int:
    """The run's process count; raises when a launcher says more than one
    process (``WORLD_SIZE``) but no group is initialised, where each
    process would train alone on every batch."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not _live():
        raise RuntimeError(
            f"WORLD_SIZE={world} but no torch.distributed process group is "
            "initialised: call parallel.multihost.initialize_distributed() "
            "first (the training CLIs do)")
    return process_count()


def split_batch_for_process(batch: dict) -> dict:
    """A GLOBAL host batch → this process's rows (JAX ``multihost.py:54``):
    each array sliced to ``[pid*local : (pid+1)*local]``, and the label
    arrays' full copies kept under ``batch["_global"]`` so evaluators can
    align gathered outputs with labels. The identity for one process."""
    pcount = process_count()
    if pcount == 1:
        return batch
    pid = process_index()
    B = len(batch["stay_rows"])
    if B % pcount:
        raise ValueError(f"global batch {B} not divisible by "
                         f"{pcount} processes")
    local = B // pcount
    sl = slice(pid * local, (pid + 1) * local)
    out = {k: np.asarray(v)[sl] for k, v in batch.items()}
    out["_global"] = {k: np.asarray(batch[k])
                      for k in GLOBAL_LABEL_KEYS if k in batch}
    return out


def fetch_global(x) -> np.ndarray:
    """Per-process rows (a tensor or an array) → the full host array on
    EVERY process, the ranks' rows concatenated in rank order (JAX
    ``multihost.py:108``). One process: a host copy."""
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    if process_count() == 1:
        return a
    parts = [None] * process_count()
    dist.all_gather_object(parts, a)
    return np.concatenate(parts, axis=0)


def any_flag(flag: bool) -> bool:
    """Global OR of a per-process flag (JAX ``multihost.py:132``): a
    SIGTERM that reaches only some ranks stops all of them at the same
    epoch boundary, where the others would enter the next epoch's
    collectives alone and hang."""
    if process_count() == 1:
        return bool(flag)
    flags = [None] * process_count()
    dist.all_gather_object(flags, bool(flag))
    return any(flags)


def gather_metrics(x):
    """Host values of every process, stacked on a new leading axis in rank
    order (JAX ``multihost.py:147``, ``process_allgather``); ``x`` itself
    for one process."""
    if process_count() == 1:
        return x
    parts = [None] * process_count()
    dist.all_gather_object(parts, np.asarray(x))
    return np.stack(parts)


def barrier() -> None:
    """Wait for every rank (nothing for one process)."""
    if process_count() > 1:
        dist.barrier()


# ---------------------------------------------------------------------------
# in-step collectives: the global batch's meaning of a step
# ---------------------------------------------------------------------------
_WIRE = (torch.float32, torch.float64)


def _all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """In-place SUM over the ranks, carried in float32 or float64 (a
    bf16/int/bool tensor rides as float64, exactly)."""
    if t.dtype in _WIRE:
        dist.all_reduce(t)
        return t
    w = t.double()
    dist.all_reduce(w)
    return w.to(t.dtype)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        world, rank = process_count(), process_index()
        n = x.shape[0]
        ctx.rows = (rank * n, (rank + 1) * n)
        buf = torch.zeros((world * n, *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        buf[rank * n:(rank + 1) * n] = x
        # a SUM over zero-filled slots is an exact gather, on every backend
        return _all_reduce_(buf)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.rows
        return g[lo:hi]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` (leading axis) in rank order, the same
    tensor on every rank; the backward keeps this rank's rows of the
    gradient. ``x`` itself for one process."""
    if process_count() == 1:
        return x
    return _GatherRows.apply(x)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        # every rank's loss reads the sum: its gradient is the sum of theirs
        return _all_reduce_(g.clone())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks (autograd: the gradient is summed over
    the ranks too); ``x`` itself for one process."""
    if process_count() == 1:
        return x
    return _AllReduceSum.apply(x)


def param_term(x: torch.Tensor) -> torch.Tensor:
    """A loss term of the parameters alone (no batch rows): its value as it
    is, its gradient divided by the world size, so that the ranks' summed
    gradients count it once."""
    world = process_count()
    if world == 1:
        return x
    return x.detach() + (x - x.detach()) / world


def draw_rows(draw: Callable[[tuple], torch.Tensor],
              shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)`` for this rank's rows of the global batch: the draw is
    made at the global leading size (``shape[0]`` × world) from the same
    generator on every rank, and this rank's rows kept, so that every rank
    consumes the generator as one process would and the rows equal that
    process's. ``draw(shape)`` itself for one process."""
    world = process_count()
    if world == 1:
        return draw(tuple(shape))
    n = shape[0]
    full = draw((n * world, *shape[1:]))
    r = process_index()
    return full[r * n:(r + 1) * n]


def all_reduce_grads(params: Sequence[torch.Tensor]) -> None:
    """Sum every parameter's gradient over the ranks, in one flat buffer per
    device and dtype (a parameter without one counts as zeros, as the
    optimizer counts it). Nothing for one process."""
    if process_count() == 1:
        return
    groups = {}
    for p in params:
        groups.setdefault((p.device, p.dtype), []).append(p)
    for ps in groups.values():
        flat = torch.cat([(torch.zeros_like(p) if p.grad is None
                           else p.grad).reshape(-1) for p in ps])
        flat = _all_reduce_(flat)
        off = 0
        for p in ps:
            n = p.numel()
            p.grad = flat[off:off + n].view_as(p).clone()
            off += n
