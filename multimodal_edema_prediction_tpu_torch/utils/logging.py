"""Console and optional wandb logging: the counterpart of
``multimodal_edema_prediction_tpu/utils/logging.py``.

wandb is off unless a project is named, and is imported only inside
``Logger.__init__``: where it is missing (or fails to start) the logger
says so once and carries on with the console alone, as the JAX package
does. Only the main process logs: rank 0 of ``torch.distributed`` when it
is initialised, else the process itself.
"""
from __future__ import annotations

import time
import traceback
from typing import Optional


def _is_main_process() -> bool:
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


class Logger:
    """``info`` prints ``[name +seconds] msg``; ``metrics`` sends a dict of
    scalars to wandb when it is live; ``alert`` prints and sends a wandb
    alert; ``finish`` closes the wandb run."""

    def __init__(self, name: str, wandb_project: Optional[str] = None,
                 wandb_run_name: Optional[str] = None,
                 config: Optional[dict] = None):
        self.name = name
        self._t0 = time.time()
        self._wb = None
        if wandb_project and _is_main_process():
            try:
                import wandb
                wandb.init(project=wandb_project,
                           name=wandb_run_name or name, config=config or {})
                self._wb = wandb
            except Exception as e:
                print(f"[{name}] wandb unavailable ({e}); continuing "
                      "without", flush=True)

    def info(self, msg: str) -> None:
        if _is_main_process():
            print(f"[{self.name} +{time.time() - self._t0:7.1f}s] {msg}",
                  flush=True)

    def metrics(self, data: dict, step: Optional[int] = None) -> None:
        if self._wb is not None:
            self._wb.log(data, step=step)

    def alert(self, title: str, text: str = "") -> None:
        print(f"[{self.name}] ALERT: {title}\n{text}", flush=True)
        if self._wb is not None:
            try:
                self._wb.alert(title=title, text=text[:1024])
            except Exception:
                pass

    def finish(self) -> None:
        if self._wb is not None:
            self._wb.finish()


def run_with_crash_alert(main_fn, logger: Logger):
    """Run ``main_fn()``; on an exception, alert with its traceback and
    re-raise; finish the logger either way."""
    try:
        return main_fn()
    except Exception as e:
        logger.alert(f"run crashed: {type(e).__name__}",
                     traceback.format_exc())
        raise
    finally:
        logger.finish()
