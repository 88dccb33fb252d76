"""Training checkpoints: model, optimizer and step, with real resume.

Counterpart of `pigeon_tpu/train/checkpoints.py` in torch's own format:
each checkpoint is one ``torch.save`` file ``step_<N>.pt`` of
``{"step", "model", "optimizer"}`` under the run's directory
(``saved_models/<name>/``), written under a temporary name and renamed
into place, the newest `MAX_TO_KEEP` kept. These files and the JAX
package's Orbax checkpoints do not read each other.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")
#: Checkpoints kept in a run's directory, the newest first.
MAX_TO_KEEP = 3


def _steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                               os.listdir(directory)) if m)


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step}.pt")


def latest_step(directory: str) -> Optional[int]:
    """The newest checkpointed step in ``directory``, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def save_checkpoint(directory: str, state) -> int:
    """Save a `TrainState` at ``state.step``; returns the step."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, state.step)
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save({"step": state.step,
                "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict()}, tmp)
    os.replace(tmp, path)
    for old in _steps(directory)[:-MAX_TO_KEEP]:
        os.unlink(_path(directory, old))
    return state.step


def restore_model(directory: str, model) -> Optional[int]:
    """Load the newest checkpoint's model weights into ``model``
    (``strict``: a model built with other head flags fails loudly); returns
    its step, or None when ``directory`` holds no checkpoint. The
    optimizer state is not read (`pigeon_tpu/cli/run.py::_init_and_restore`
    for ``serve``)."""
    step = latest_step(directory)
    if step is None:
        return None
    device = next(model.parameters()).device
    saved = torch.load(_path(directory, step), map_location=device,
                       weights_only=True)
    model.load_state_dict(saved["model"], strict=True)
    return int(saved["step"])


def restore_checkpoint(directory: str, state):
    """Load the newest checkpoint into ``state``'s model and optimizer, on
    the model's device; returns ``state``."""
    step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {directory}")
    device = next(state.model.parameters()).device
    saved = torch.load(_path(directory, step), map_location=device,
                       weights_only=True)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return state
