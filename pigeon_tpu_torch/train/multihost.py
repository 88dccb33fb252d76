"""Multi-process scale-out primitives over `torch.distributed`.

Counterpart of `pigeon_tpu/train/multihost.py`. One process runs per
card (`torchrun`); the JAX package's "hosts" are the port's ranks:

  * per-rank INPUT sharding: each rank loads only its contiguous slice
    of every global batch (`host_slice`, `iter_host_batches`), so the
    concatenation of the slices keeps the global order;
  * `allgather_hosts` collects a per-rank array on every rank (the
    reference's `accelerator.gather`, `preprocessing/embed.py:36-37`);
  * `sync_hosts` barriers (`accelerator.wait_for_everyone`);
  * `coordinated_flag`: a boolean agreed by every rank, for coordinated
    preemption (`train/preemption.py`);
  * `is_primary`: rank 0 alone writes.

Without a process group (no `torchrun`) every function takes its
one-process path: rank 0 of 1, no collective. The object collectives
run on the CPU: under ``cpu:gloo,cuda:nccl`` they go through gloo.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist


def distributed() -> bool:
    """Whether a process group is up."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if distributed() else 1


def is_primary() -> bool:
    """Rank-0 check for host-side effects (disk writes, logging), the
    reference's `is_local_main_process`."""
    return process_index() == 0


def sync_hosts() -> None:
    """Barrier across every rank (`accelerator.wait_for_everyone`); a
    no-op in one process. It is a CPU tensor's all-reduce, so under
    ``cpu:gloo,cuda:nccl`` it rides gloo and needs no device binding."""
    if process_count() > 1:
        dist.all_reduce(torch.zeros(1))


def allgather_hosts(x, group=None) -> np.ndarray:
    """A per-rank array gathered on EVERY rank of ``group`` (default:
    all) as ``(ranks, ...)``; one process adds the leading axis. Arrays
    of different shapes across ranks raise (pad them first)."""
    x = np.asarray(x)
    if not distributed() or dist.get_world_size(group) == 1:
        return x[None]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, x, group=group)
    shapes = {a.shape for a in out}
    if len(shapes) != 1:
        raise ValueError(f"allgather_hosts: ranks hold shapes {shapes}")
    return np.stack(out)


def gather_objects(obj, group=None) -> list:
    """Any picklable ``obj`` of each rank of ``group``, in rank order, on
    every rank (``[obj]`` in one process)."""
    if not distributed() or dist.get_world_size(group) == 1:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def coordinated_flag(local_flag: bool) -> bool:
    """True on every rank when it is True on any rank.

    A SIGTERM reaches one rank first; a rank that broke out of the step
    loop alone would strand the others at their next collective (and a
    collective checkpoint would deadlock). Every rank therefore polls
    this at the same step boundaries and takes the same branch. In one
    process the flag is returned as it is."""
    if process_count() == 1:
        return bool(local_flag)
    flag = torch.tensor([1.0 if local_flag else 0.0])
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item() > 0)


def host_slice(n: int, pid: Optional[int] = None,
               nproc: Optional[int] = None) -> slice:
    """Rank ``pid``'s contiguous slice of ``n`` global samples (of
    ``nproc`` ranks; default this process's rank and the world size):
    the first ``n % nproc`` ranks take one more."""
    pid = process_index() if pid is None else pid
    nproc = process_count() if nproc is None else nproc
    per, extra = divmod(n, nproc)
    start = pid * per + min(pid, extra)
    return slice(start, start + per + (1 if pid < extra else 0))


def global_batch_from_local(local_batch: Dict[str, np.ndarray], mesh
                            ) -> Dict[str, np.ndarray]:
    """The global batch as the data axis holds it: each rank keeps the
    local rows it was given (`iter_host_batches`' slices), so this checks
    that the leaves agree on their row count and returns the batch. The
    JAX package assembles one global array here; a rank of the port
    computes on its rows and the collectives join the results."""
    rows = {len(v) for v in local_batch.values()
            if getattr(v, "ndim", 0) > 0}
    if len(rows) > 1:
        raise ValueError(f"local batch leaves disagree on rows: {rows} "
                         f"(data axis {mesh.dp})")
    return local_batch


def check_global_batch(global_batch_size: int, mesh) -> int:
    """The local batch of ``global_batch_size`` over ``mesh``'s data
    axis; a size the data axis does not divide stops the run
    (`pigeon_tpu/train/multihost.py:144-147`)."""
    data = mesh.dp
    if global_batch_size % data:
        raise ValueError(
            f"global batch {global_batch_size} must divide evenly over "
            f"{process_count()} processes and the {data}-way data axis")
    return global_batch_size // data


def iter_host_batches(dataset, global_batch_size: int, mesh,
                      shuffle: bool = False, seed: int = 0,
                      drop_last: bool = True
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """The global batches of ``dataset`` in the one-process order (the
    same seed), each rank decoding only its data rank's `host_slice` of
    every batch (`pigeon_tpu/train/multihost.py::iter_host_batches`).
    The ranks of one model group share a data rank, so they load the
    same rows."""
    from pigeon_tpu_torch.data.pipeline import iter_batches

    check_global_batch(global_batch_size, mesh)

    def local(idx):
        return idx[host_slice(len(idx), mesh.data_rank, mesh.dp)]

    for batch in iter_batches(dataset, global_batch_size, shuffle=shuffle,
                              seed=seed, drop_last=drop_last, select=local):
        yield global_batch_from_local(batch, mesh)


def padded_rows(idx: np.ndarray, rank: int, ranks: int):
    """Rank ``rank``'s `host_slice` of the global rows ``idx``, padded
    to ``ceil(len(idx) / ranks)`` rows by repeating the batch's last row
    (every rank then runs a forward of one size: FSDP's all-gathers need
    every rank in every forward), and their row index: ``idx``'s entries,
    -1 for the padding. Returns ``(rows, row_index)``."""
    per = -(-len(idx) // ranks)
    own = idx[host_slice(len(idx), rank, ranks)]
    rows = np.concatenate([own, np.full(per - len(own), idx[-1],
                                        idx.dtype)])
    row_index = np.full(per, -1, np.int64)
    row_index[:len(own)] = own
    return rows, row_index


def iter_eval_batches(dataset, global_batch_size: int, mesh
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Evaluation's global batches in order, each rank loading its data
    rank's rows padded by `padded_rows`; every batch carries
    ``row_index``, the rows' positions in ``dataset`` (-1 for padding),
    by which `train.loop.evaluate_model` puts the gathered rows back in
    order and drops the padding."""
    from pigeon_tpu_torch.data.pipeline import iter_batches

    indices = []

    def local(idx):
        rows, row_index = padded_rows(idx, mesh.data_rank, mesh.dp)
        indices.append(row_index)
        return rows

    batches = iter_batches(dataset, global_batch_size, select=local)
    try:
        for i, batch in enumerate(batches):
            batch["row_index"] = indices[i]
            yield batch
    finally:
        batches.close()


def local_eval_batches(batches, mesh) -> Iterator[Dict[str, np.ndarray]]:
    """`iter_eval_batches` for batches already in host memory (head-only
    training's embeddings): each global batch cut to the rank's padded
    rows, with their ``row_index`` counted across the batches."""
    start = 0
    for batch in batches:
        n = len(batch["inputs"])
        rows, row_index = padded_rows(np.arange(n), mesh.data_rank, mesh.dp)
        out = {k: v[rows] for k, v in batch.items()}
        out["row_index"] = np.where(row_index >= 0, row_index + start, -1)
        start += n
        yield out
