"""Training checkpoints: model, optimizer and step, with real resume.

Counterpart of `pigeon_tpu/train/checkpoints.py` in torch's own format:
each checkpoint is one ``torch.save`` file ``step_<N>.pt`` of
``{"step", "model", "optimizer"}`` under the run's directory
(``saved_models/<name>/``), written under a temporary name and renamed
into place, the newest `MAX_TO_KEEP` kept. These files and the JAX
package's Orbax checkpoints do not read each other.

`CheckpointSession` is the training loop's writer: its saves copy the
state to host memory at once and write it on a background thread while
training goes on, as the JAX session's Orbax manager does. The copy has
to be taken inside `CheckpointSession.save`: torch's AdamW updates the
parameters and moments in place, where JAX arrays are immutable and
Orbax may snapshot them later.
"""

from __future__ import annotations

import os
import re
import threading
import time
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


def _payload(state) -> dict:
    return {"step": state.step, "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict()}


def _write(directory: str, payload: dict, max_to_keep: int) -> None:
    """``payload`` to ``step_<N>.pt`` through a temporary file, then the
    steps beyond the newest ``max_to_keep`` removed."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, payload["step"])
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in _steps(directory)[:-max_to_keep]:
        os.unlink(_path(directory, old))


def latest_step(directory: str) -> Optional[int]:
    """The newest checkpointed step in ``directory``, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def save_checkpoint(directory: str, state) -> int:
    """Save a `TrainState` at ``state.step`` and wait for the write;
    returns the step."""
    _write(directory, _payload(state), MAX_TO_KEEP)
    return state.step


def _load(directory: str, step: Optional[int], device) -> dict:
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {directory}")
    return torch.load(_path(directory, step), map_location=device,
                      weights_only=True)


def restore_model(directory: str, model) -> Optional[int]:
    """Load the newest checkpoint's model weights into ``model``
    (``strict``: a model built with other head flags fails loudly); returns
    its step, or None when ``directory`` holds no checkpoint. The
    optimizer state is not read (`pigeon_tpu/cli/run.py::_init_and_restore`
    for ``serve``)."""
    if latest_step(directory) is None:
        return None
    saved = _load(directory, None, next(model.parameters()).device)
    model.load_state_dict(saved["model"], strict=True)
    return int(saved["step"])


def restore_checkpoint(directory: str, state, step: Optional[int] = None):
    """Load the newest checkpoint (or ``step``'s) into ``state``'s model
    and optimizer, on the model's device; returns ``state``."""
    saved = _load(directory, step, next(state.model.parameters()).device)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return state


class CheckpointSession:
    """One writer for a whole training run
    (`pigeon_tpu.train.checkpoints.CheckpointSession`).

    `save` copies the state to host memory before it returns (into
    pinned buffers kept for the next save, for a model on the GPU) and
    writes the copy on a background thread; one write runs at a time,
    and a save first joins the one in flight. `restore`, `latest_step`
    and `close` join it too, so neither a rollback nor pruning reads a
    half-written directory. A write's error is raised by the next call
    that joins it. Use as a context manager.
    """

    def __init__(self, directory: str, max_to_keep: int = MAX_TO_KEEP):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._buffers: dict = {}
        #: Seconds the last finished write took on its thread.
        self.write_seconds: Optional[float] = None

    def _host_copy(self, obj, key: tuple):
        """``obj`` with every tensor copied to host memory; a CUDA tensor
        goes into this session's pinned buffer for ``key``."""
        if isinstance(obj, dict):
            return {k: self._host_copy(v, key + (k,)) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._host_copy(v, key + (i,))
                             for i, v in enumerate(obj))
        if not torch.is_tensor(obj):
            return obj
        obj = obj.detach()
        if obj.device.type != "cuda":
            return obj.clone()
        buf = self._buffers.get(key)
        if buf is None or buf.shape != obj.shape or buf.dtype != obj.dtype:
            buf = self._buffers[key] = torch.empty(
                obj.shape, dtype=obj.dtype, pin_memory=True)
        return buf.copy_(obj, non_blocking=True)

    def save(self, state, wait: bool = False) -> int:
        """Save ``state`` at ``state.step``; returns the step. With
        ``wait`` the write is durable when this returns."""
        self.wait()
        payload = self._host_copy(_payload(state), ())
        if self._buffers:
            torch.cuda.synchronize()    # the non-blocking copies land
        self._thread = threading.Thread(
            target=self._run, args=(payload,), name="checkpoint-writer",
            daemon=True)
        self._thread.start()
        if wait:
            self.wait()
        return payload["step"]

    def _run(self, payload: dict) -> None:
        t0 = time.perf_counter()
        try:
            _write(self.directory, payload, self.max_to_keep)
        except BaseException as e:  # noqa: BLE001 - raised by wait()
            self._error = e
        self.write_seconds = time.perf_counter() - t0

    @property
    def writing(self) -> bool:
        """Whether a write is in flight."""
        return self._thread is not None and self._thread.is_alive()

    def wait(self) -> None:
        """Join the write in flight; raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def latest_step(self) -> Optional[int]:
        self.wait()
        return latest_step(self.directory)

    def restore(self, state, step: Optional[int] = None):
        """Load the newest checkpoint (or ``step``'s) into ``state`` after
        the write in flight; returns ``state``."""
        self.wait()
        return restore_checkpoint(self.directory, state, step)

    def close(self) -> None:
        self.wait()
        self._buffers.clear()

    def __enter__(self) -> "CheckpointSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
