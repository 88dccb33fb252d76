"""Training checkpoints: model, optimizer and step, with real resume.

Counterpart of `pigeon_tpu/train/checkpoints.py` in torch's own format:
each checkpoint is a directory ``step_<N>/`` of
`torch.distributed.checkpoint` (DCP) under the run's directory
(``saved_models/<name>/``), complete once its ``.metadata`` is written,
the newest `MAX_TO_KEEP` kept. Its keys are the parameters' names in the
full model, ``model.<name>`` and ``optim.<name>.<exp_avg|exp_avg_sq|
step|acc>``, and the ``counters`` (step, optimizer updates, micro-step).
One process writes it alone; under a process group (`torchrun`) every
rank writes its shards together, each replicated tensor once, the
tensor-parallel shards as DTensors on the ``model`` axis and FSDP2's as
its own. So a checkpoint restores at any world size and mesh, in one
process too (`serve`, `evaluate`). These checkpoints and the JAX
package's Orbax ones do not read each other
(`scripts/convert_orbax_to_torch.py` converts).

A ``step_<N>.pt`` file (``torch.save`` of ``{"step", "model",
"optimizer"}``, the format of earlier versions) is read-only: it
restores in one process (`restore_checkpoint`), and its weights into
any whole model (`restore_model`).

`CheckpointSession` is the training loop's writer: its saves copy the
state at once and write the copy on a background thread while training
goes on, as the JAX session's Orbax manager does. The copy has to be
taken inside `CheckpointSession.save`: torch's AdamW updates the
parameters and moments in place, where JAX arrays are immutable and
Orbax may snapshot them later.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
import time
from typing import Optional

import torch
import torch.distributed as dist

from pigeon_tpu_torch.train.multihost import distributed, is_primary

_NAME = re.compile(r"^step_(\d+)(\.pt)?$")
#: Checkpoints kept in a run's directory, the newest first.
MAX_TO_KEEP = 3


def _steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                               os.listdir(directory))
                  if m and (m.group(2) or _is_dcp(os.path.join(
                      directory, m.group(0)))))


def _is_dcp(path: str) -> bool:
    """A complete DCP checkpoint (its metadata is written last)."""
    return os.path.isfile(os.path.join(path, ".metadata"))


def _path(directory: str, step: int) -> str:
    """The checkpoint of ``step``: its DCP directory where one exists,
    else its ``.pt`` file."""
    dcp_dir = os.path.join(directory, f"step_{step}")
    return dcp_dir if _is_dcp(dcp_dir) else dcp_dir + ".pt"


def _prune(directory: str, max_to_keep: int) -> None:
    for old in _steps(directory)[:-max_to_keep]:
        path = _path(directory, old)
        if os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.unlink(path)


def latest_step(directory: str) -> Optional[int]:
    """The newest checkpointed step in ``directory``, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def _over_group(state) -> bool:
    """Whether ``state`` is a rank's part of a run over a process group."""
    mesh = getattr(state, "mesh", None)
    return mesh is not None and mesh.device_mesh is not None


def restore_model(directory: str, model) -> Optional[int]:
    """Load the newest checkpoint's model weights into a whole ``model``
    (``strict``: a model built with other head flags fails loudly);
    returns its step, or None when ``directory`` holds no checkpoint. The
    optimizer state is not read (`pigeon_tpu/cli/run.py::
    _init_and_restore` for ``serve``)."""
    step = latest_step(directory)
    if step is None:
        return None
    path = _path(directory, step)
    if os.path.isdir(path):
        return _restore_dcp_model(path, model)
    saved = torch.load(path, map_location=next(model.parameters()).device,
                       weights_only=True)
    model.load_state_dict(saved["model"], strict=True)
    return int(saved["step"])


def restore_checkpoint(directory: str, state, step: Optional[int] = None):
    """Load the newest checkpoint (or ``step``'s) into ``state``'s model
    and optimizer as this rank holds them; returns ``state``. A DCP
    checkpoint restores at any world size and mesh (each rank reads its
    own shards), a ``.pt`` file in one process only."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {directory}")
    path = _path(directory, step)
    if os.path.isdir(path):
        return _restore_dcp(path, state)
    if _over_group(state):
        raise ValueError(
            f"{path}: a .pt checkpoint restores in one process; resume "
            f"from it there once, and the DCP checkpoint that run writes "
            f"restores at any world size")
    saved = torch.load(path, map_location=next(
        state.model.parameters()).device, weights_only=True)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return state


# ---------------------------------------------------------------------------
# Writing and reading DCP
# ---------------------------------------------------------------------------

def _tp_dim(model, name: str):
    from pigeon_tpu_torch.train.mesh import model_dim

    spec = getattr(model, "tp_specs", {}).get(name)
    return None if spec is None else model_dim(spec)


def _entries(state):
    """``(key, tensor, tp_dim)`` for every tensor a checkpoint holds: the
    parameters (and buffers) by name, then each trainable parameter's
    optimizer state (AdamW's moments and step, and the accumulation's
    running mean)."""
    model, opt = state.model, state.optimizer
    for name, t in model.state_dict().items():
        yield f"model.{name}", t, _tp_dim(model, name)
    acc = getattr(opt, "acc_grads", {})
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        dim = _tp_dim(model, name)
        for key, t in opt.state.get(p, {}).items():
            yield f"optim.{name}.{key}", t, dim if t.dim() else None
        if p in acc:
            yield f"optim.{name}.acc", acc[p], dim


def _counters(state) -> dict:
    opt = state.optimizer
    return {"step": int(state.step), "updates": getattr(opt, "updates", 0),
            "mini_step": getattr(opt, "mini_step", 0)}


def _as_saved(t: torch.Tensor, dim, mesh) -> torch.Tensor:
    """``t`` as DCP stores it: a tensor-parallel shard as a DTensor on
    the ``model`` axis (after gathering an FSDP2 shard of it over
    ``data``), an FSDP2 shard as it is, the rest plain (each replicated
    tensor is written once)."""
    from torch.distributed.tensor import DTensor, Shard

    if dim is None or mesh is None or mesh.tp == 1:
        return t
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return DTensor.from_local(t, mesh.device_mesh["model"], [Shard(dim)],
                              run_check=False)


def _payload(state) -> dict:
    mesh = getattr(state, "mesh", None)
    payload = {key: _as_saved(t.detach(), dim, mesh)
               for key, t, dim in _entries(state)}
    payload["counters"] = _counters(state)
    return payload


def _writer(directory: str, step: int):
    """DCP's file writer for ``step_<N>/``, without an fsync of each file
    (as ``torch.save`` writes; the ``.metadata`` file, written last,
    marks a checkpoint complete)."""
    from torch.distributed.checkpoint import FileSystemWriter

    return FileSystemWriter(os.path.join(directory, f"step_{step}"),
                            sync_files=False)


def save_checkpoint(directory: str, state, max_to_keep: int = MAX_TO_KEEP
                    ) -> int:
    """Write ``state`` as the DCP checkpoint ``step_<N>/`` and wait for
    it, then keep the newest ``max_to_keep``; returns the step. Under a
    process group every rank calls this at the same step."""
    import torch.distributed.checkpoint as dcp

    dcp.save(_payload(state), storage_writer=_writer(directory, state.step),
             no_dist=not distributed())
    if is_primary():
        _prune(directory, max_to_keep)
    return state.step


def _read_keys(path: str) -> set:
    import torch.distributed.checkpoint as dcp

    return set(dcp.FileSystemReader(path).read_metadata()
               .state_dict_metadata)


def _check_model_keys(path: str, keys: set, names) -> None:
    """``strict`` as `torch.nn.Module.load_state_dict`: the checkpoint's
    ``model.*`` keys and the model's names must match both ways."""
    saved = {k[len("model."):] for k in keys if k.startswith("model.")}
    if saved != set(names):
        raise RuntimeError(
            f"{path}: the checkpoint's state_dict and the model's differ: "
            f"missing {sorted(set(names) - saved)[:5]}, unexpected "
            f"{sorted(saved - set(names))[:5]}")


def _restore_dcp_model(path: str, model) -> int:
    """A DCP checkpoint's parameters into a whole ``model``, read in
    this process alone (``no_dist``; under a group every rank reads all
    of them)."""
    import torch.distributed.checkpoint as dcp

    state = model.state_dict()
    _check_model_keys(path, _read_keys(path), state)
    target = {f"model.{k}": v for k, v in state.items()}
    target["counters"] = {"step": 0, "updates": 0, "mini_step": 0}
    dcp.load(target, checkpoint_id=path, no_dist=True)
    return int(target["counters"]["step"])


def _ensure_optimizer_state(state, keys: set) -> None:
    """Create AdamW's state for every trainable parameter the checkpoint
    has moments for (torch makes it lazily at the first step), so the
    load has tensors to fill."""
    opt = state.optimizer
    for name, p in state.model.named_parameters():
        if p.requires_grad and f"optim.{name}.exp_avg" in keys \
                and p not in opt.state:
            opt.state[p] = {"step": torch.zeros((), dtype=torch.float32),
                            "exp_avg": torch.zeros_like(p),
                            "exp_avg_sq": torch.zeros_like(p)}
        if f"optim.{name}.acc" in keys:
            opt.acc_grads.setdefault(p, torch.zeros_like(p))


def _restore_dcp(path: str, state):
    """A DCP checkpoint into ``state`` as this rank holds it: each rank
    reads its own shards, whatever world size and mesh wrote them."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor, distribute_tensor

    mesh = getattr(state, "mesh", None)
    keys = _read_keys(path)
    _check_model_keys(path, keys, state.model.state_dict())
    _ensure_optimizer_state(state, keys)
    entries = [(k, t, d) for k, t, d in _entries(state) if k in keys]
    target = {k: _as_saved(t.detach(), d, mesh) for k, t, d in entries}
    target["counters"] = {"step": 0, "updates": 0, "mini_step": 0}
    dcp.load(target, checkpoint_id=path, no_dist=not _over_group(state))
    for key, t, dim in entries:
        if isinstance(t, DTensor) and dim is not None and mesh.tp > 1:
            # An FSDP2 shard of a tensor-parallel shard was loaded whole
            # over ``data``: keep this rank's part of it.
            part = distribute_tensor(target[key].to_local(), t.device_mesh,
                                     t.placements, src_data_rank=None)
            with torch.no_grad():
                t.to_local().copy_(part.to_local())
    counters = target["counters"]
    state.step = int(counters["step"])
    state.optimizer.updates = int(counters["updates"])
    state.optimizer.mini_step = int(counters["mini_step"])
    return state


def read_counters(directory: str, step: Optional[int] = None) -> dict:
    """A DCP checkpoint's ``step``, optimizer ``updates`` and
    ``mini_step`` (the newest checkpoint's, or ``step``'s)."""
    import torch.distributed.checkpoint as dcp

    step = latest_step(directory) if step is None else step
    counters = {"step": 0, "updates": 0, "mini_step": 0}
    target = {"counters": counters}
    dcp.load(target, checkpoint_id=_path(directory, step), no_dist=True)
    return target["counters"]


class CheckpointSession:
    """One writer for a whole training run
    (`pigeon_tpu.train.checkpoints.CheckpointSession`).

    `save` copies the state where the write can read it before it
    returns (a CUDA tensor into a pinned host buffer kept for the next
    save, an FSDP2 or tensor-parallel shard into a clone on its card)
    and writes the copy as DCP on a background thread; one write runs at
    a time, and a save first joins the one in flight. `restore`,
    `latest_step` and `close` join it too, so neither a rollback nor
    pruning reads a half-written directory. A write's error is raised by
    the next call that joins it. Under a process group every rank saves
    at the same steps, and the writes coordinate over a gloo group of
    the session's own, so that they never interleave with the training's
    collectives. Use as a context manager.
    """

    def __init__(self, directory: str, max_to_keep: int = MAX_TO_KEEP):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._group = None
        self._buffers: dict = {}
        #: Seconds the last finished write took on its thread.
        self.write_seconds: Optional[float] = None

    def _copy(self, obj, key: tuple):
        """``obj`` with every tensor copied: a CUDA tensor into this
        session's pinned buffer for ``key``, a DTensor's local shard
        cloned on its device (DCP moves it to the host as it writes),
        any other tensor cloned."""
        from torch.distributed.tensor import DTensor

        if isinstance(obj, dict):
            return {k: self._copy(v, key + (k,)) for k, v in obj.items()}
        if not torch.is_tensor(obj):
            return obj
        obj = obj.detach()
        if isinstance(obj, DTensor):
            return DTensor.from_local(
                obj.to_local().clone(), obj.device_mesh, obj.placements,
                run_check=False, shape=obj.shape, stride=obj.stride())
        if obj.device.type != "cuda":
            return obj.clone()
        buf = self._buffers.get(key)
        if buf is None or buf.shape != obj.shape or buf.dtype != obj.dtype:
            buf = self._buffers[key] = torch.empty(
                obj.shape, dtype=obj.dtype, pin_memory=True)
        return buf.copy_(obj, non_blocking=True)

    def save(self, state, wait: bool = False) -> int:
        """Save ``state`` at ``state.step``; returns the step. With
        ``wait`` the write is done when this returns. Under a process
        group the save is collective: every rank calls it at the same
        step."""
        self.wait()
        if distributed() and self._group is None:
            self._group = dist.new_group(backend="gloo")
        payload = self._copy(_payload(state), ())
        if self._buffers:
            torch.cuda.synchronize()    # the non-blocking copies land
        self._thread = threading.Thread(
            target=self._run, args=(payload, state.step),
            name="checkpoint-writer", daemon=True)
        self._thread.start()
        if wait:
            self.wait()
        return state.step

    def _run(self, payload: dict, step: int) -> None:
        import torch.distributed.checkpoint as dcp

        t0 = time.perf_counter()
        try:
            dcp.save(payload, storage_writer=_writer(self.directory, step),
                     process_group=self._group,
                     no_dist=self._group is None)
        except BaseException as e:  # noqa: BLE001 - raised by wait()
            self._error = e
        self.write_seconds = time.perf_counter() - t0

    @property
    def writing(self) -> bool:
        """Whether a write is in flight."""
        return self._thread is not None and self._thread.is_alive()

    def wait(self) -> None:
        """Join the write in flight (raising its error, if it failed),
        then keep the newest ``max_to_keep`` checkpoints (rank 0)."""
        if self._thread is None:
            return
        self._thread.join()
        self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error
        if is_primary():
            _prune(self.directory, self.max_to_keep)

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
        if self._group is not None and distributed():
            dist.destroy_process_group(self._group)
        self._group = None

    def __enter__(self) -> "CheckpointSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
