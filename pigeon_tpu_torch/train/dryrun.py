"""A multi-rank dry run of the training step on the CPU.

Counterpart of `__graft_entry__.py::dryrun_multichip`: ``n`` gloo
processes on this machine form a ``(n / 2, 2)`` mesh (``(n, 1)`` for an
odd ``n``) and take the full train step of a small panorama
`SuperGuessr` (multi-task, headings, smoothed labels, AdamW with
clipping) under DDP with tensor parallelism, then under FSDP2 with it;
each check prints one ``... OK`` line from rank 0, and the parameters of
each must equal the one-process step's. For an even ``n`` a third check
runs the tower pipelined over 2 stages (`train/pipeline.py`), its pooled
output held against the sequential tower's, as the JAX dry run's
``pp`` line. Run it as::

    python -c "from pigeon_tpu_torch.train.dryrun import dryrun_multichip;
    dryrun_multichip(4)"
"""

from __future__ import annotations

import copy
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pigeon_tpu_torch.config import HeadConfig, VisionConfig

VISION = VisionConfig(image_size=32, patch_size=8, hidden_size=64,
                      intermediate_size=128, num_layers=2, num_heads=4,
                      projection_dim=32)
HEAD = HeadConfig(num_cells=32, embed_dim=64, panorama=True,
                  multi_task=True, heading=True, smooth_labels=True)
#: The parameters of the sharded steps against the one-process step's
#: (f32; the sharded sums add in another order).
TOLERANCE = 1e-4


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_batch(b: int, seed: int = 0) -> dict:
    """A seeded global batch of ``b`` panoramas with every label the
    multi-task loss reads."""
    rng = np.random.default_rng(seed)
    return {
        "inputs": rng.normal(size=(b, 4, 32, 32, 3)).astype(np.float32),
        "heading": rng.normal(size=(b, 4, 2)).astype(np.float32),
        "labels": np.stack([rng.uniform(-180, 180, b),
                            rng.uniform(-60, 70, b)], -1).astype(np.float32),
        "labels_multi_task": rng.normal(size=(b, 6)).astype(np.float32),
        "labels_climate": rng.integers(0, 28, b),
        "labels_month": rng.integers(0, 12, b),
    }


def _state(mesh, fsdp: bool):
    """The sharded state and the one-process one, from the same seeded
    weights."""
    from pigeon_tpu_torch.config import PigeonConfig
    from pigeon_tpu_torch.models.super_guessr import init_weights
    from pigeon_tpu_torch.train.modes import build_finetune_model
    from pigeon_tpu_torch.train.train_loop import (
        TrainState,
        adamw,
        create_train_state,
    )

    def optimizer(params):
        return adamw(params, 1e-4, weight_decay=1e-3, max_grad_norm=1.0)

    model = init_weights(build_finetune_model(
        PigeonConfig(vision=VISION, head=HEAD), dtype=torch.float32,
        attn_impl="fused"), 0)
    reference = copy.deepcopy(model)
    state = create_train_state(model, optimizer, mesh, fsdp=fsdp)
    return state, TrainState(reference, optimizer(reference.parameters()))


def _rank(rank: int, world: int, port: int) -> None:
    from pigeon_tpu_torch.train.mesh import (
        create_mesh,
        full_parameters,
        shard_batch,
    )
    from pigeon_tpu_torch.train.train_loop import (
        batch_to_device,
        make_train_step,
    )

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        tp = 2 if world % 2 == 0 else 1
        mesh = create_mesh(tp=tp)
        cells = torch.from_numpy(np.stack(
            [np.linspace(-170, 170, 32), np.linspace(-55, 65, 32)],
            -1).astype(np.float32))
        batch = dryrun_batch(mesh.dp * 2)
        step = make_train_step(HEAD, cells)
        for fsdp in (False, True):
            state, ref = _state(mesh, fsdp)
            metrics = step(state, batch_to_device(shard_batch(batch, mesh),
                                                  "cpu"))
            step(ref, batch_to_device(batch, "cpu"))
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                raise RuntimeError(f"non-finite loss: {loss}")
            full = full_parameters(state.model, mesh)
            err = max((full[n] - p.detach()).abs().max().item()
                      for n, p in ref.model.named_parameters())
            if err > TOLERANCE:
                raise RuntimeError(f"parameters {err:.3g} from the "
                                   "one-process step's")
            if rank == 0:
                print(f"dryrun_multichip(n={world}): mesh={mesh.shape} "
                      f"{'FSDP2' if fsdp else 'DDP'} loss={loss:.4f} "
                      f"step={state.step} max|param - one process|="
                      f"{err:.2e} OK", flush=True)
        if world % 2 == 0:
            _pipeline_check(rank)
    finally:
        dist.destroy_process_group()


def _pipeline_check(rank: int) -> None:
    """The tower pipelined over 2 stages at M = 2 against the sequential
    tower (`__graft_entry__.py::dryrun_multichip`'s ``pp`` check)."""
    from pigeon_tpu_torch.kernels.sharded import all_gather_along
    from pigeon_tpu_torch.models.clip import CLIPVisionTower
    from pigeon_tpu_torch.models.super_guessr import init_weights
    from pigeon_tpu_torch.train.mesh import batch_slice
    from pigeon_tpu_torch.train.pipeline import (
        create_pipeline_mesh,
        pipeline_vision_forward,
        shard_pipeline_params,
    )

    mesh = create_pipeline_mesh(pp=2)
    tower = init_weights(CLIPVisionTower(VISION), 2)
    px = torch.from_numpy(np.random.default_rng(0).normal(
        size=(mesh.dp * 2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        _, want = tower(px)
        shard_pipeline_params(tower, mesh)
        _, got = pipeline_vision_forward(
            tower, px[batch_slice(len(px), mesh)], mesh, num_microbatches=2)
        if mesh.dp > 1:
            got = all_gather_along(got.contiguous(), mesh.data_group)
    err = float((got - want).abs().max())
    if err > TOLERANCE:
        raise RuntimeError(f"pipeline parity error {err}")
    if rank == 0:
        print(f"dryrun_multichip pp: mesh={mesh.shape} parity_err={err:.2e} "
              "OK", flush=True)


def dryrun_multichip(n_devices: int) -> None:
    """The full train step over ``n_devices`` gloo CPU processes; raises
    if a rank fails."""
    mp.start_processes(_rank, args=(n_devices, free_port()),
                       nprocs=n_devices, start_method="spawn")
