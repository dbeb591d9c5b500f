"""Checkpoints of trees of tensors (``manager.py``), readable by the
reference package's ``repro.checkpoint`` and the other way round."""

from .manager import (  # noqa: F401
    AsyncCheckpointer,
    latest_step,
    load_checkpoint,
    restore_into,
    save_checkpoint,
)
