"""What the training CLI calls of the experiment loggers (counterpart of
part of ``multiyolov5_tpu/utils/loggers.py``), without wandb.

The card's machine has no wandb, so the port's ``WandbLogger`` is the JAX
one with wandb absent: it reports ``enabled = False`` and every call is a
no-op.  The artifact workflow (``--upload-dataset``, ``--bbox-interval``,
``--save-period``, a ``wandb-artifact://`` resume) raises
``NotImplementedError`` up front in ``cli/train.py`` instead of silently
doing nothing.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

WANDB_ARTIFACT_PREFIX = "wandb-artifact://"


def remove_prefix(s: str, prefix: str = WANDB_ARTIFACT_PREFIX) -> str:
    """reference wandb_utils.py:23-24."""
    return s[len(prefix):]


def check_wandb_resume(opt) -> Optional[bool]:
    """True iff ``--resume wandb-artifact://...`` (wandb_utils.py:42-53)."""
    if isinstance(opt.resume, str) and opt.resume.startswith(WANDB_ARTIFACT_PREFIX):
        return True
    return None


class WandbLogger:
    """The JAX ``WandbLogger`` when wandb is not installed: disabled."""

    def __init__(self, opt=None, name: Optional[str] = None, run_id: Optional[str] = None,
                 data_dict: Optional[Dict[str, Any]] = None, job_type: str = "Training"):
        self.wandb = self.run = None
        self.job_type = job_type
        self.data_dict = data_dict
        self.current_epoch = 0
        self.bbox_interval = getattr(opt, "bbox_interval", -1) if opt else -1

    @property
    def enabled(self) -> bool:
        return False

    def log(self, d: Dict[str, Any], step: Optional[int] = None) -> None:
        pass

    def end_epoch(self, best_result: bool = False) -> None:
        pass

    def finish(self) -> None:
        pass
