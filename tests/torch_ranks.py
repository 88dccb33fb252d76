"""A pool of gloo ranks for the port's multi-process CPU tests, and the
tasks its ranks run.

`RankPool(n)` starts ``n`` spawned processes once (a module-scoped
fixture keeps one per world size); each joins one gloo process group at
``tcp://localhost:<free port>`` and then runs the tasks `RankPool.run`
sends it, by name, from this module. Tasks import torch and the port
only (never JAX), take and return numpy arrays and plain values, and run
in the rank's main thread (so a task may install a SIGTERM handler).
Every wait has a timeout: a rank that fails or hangs fails the test.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import signal
import socket
import traceback

import numpy as np

#: Seconds a task may take before the test fails.
TASK_TIMEOUT = 180


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _serve(rank, world, port, inbox, outbox):
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TASK_TIMEOUT))
    try:
        while True:
            item = inbox.get()
            if item is None:
                break
            name, args, kwargs = item
            try:
                outbox.put((rank, True, globals()[name](*args, **kwargs)))
            except BaseException:  # noqa: BLE001 - sent to the test
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world`` gloo ranks that run this module's tasks on request."""

    def __init__(self, world: int):
        ctx = multiprocessing.get_context("spawn")
        self.world = world
        self.outbox = ctx.Queue()
        self.inboxes = [ctx.Queue() for _ in range(world)]
        port = free_port()
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, world, port, self.inboxes[r],
                                        self.outbox))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, task: str, *args, timeout: float = TASK_TIMEOUT,
            **kwargs) -> list:
        """``task(*args, **kwargs)`` on every rank; the results by rank.
        A rank's exception is raised here with its traceback."""
        for q in self.inboxes:
            q.put((task, args, kwargs))
        results, errors = {}, []
        for _ in range(self.world):
            rank, ok, value = self.outbox.get(timeout=timeout)
            (results.__setitem__(rank, value) if ok
             else errors.append(f"rank {rank}:\n{value}"))
        if errors:
            raise RuntimeError("\n".join(errors))
        return [results[r] for r in range(self.world)]

    def close(self) -> None:
        for q in self.inboxes:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        assert not any(p.is_alive() for p in self.procs)


# ---------------------------------------------------------------------------
# Helpers of the tasks
# ---------------------------------------------------------------------------

_MESHES = {}


def mesh_of(tp: int):
    """This rank's `train.mesh.Mesh` with model axis ``tp`` (made once)."""
    from pigeon_tpu_torch.train.mesh import create_mesh

    if tp not in _MESHES:
        _MESHES[tp] = create_mesh(tp=tp)
    return _MESHES[tp]


def tensors(state: dict) -> dict:
    import torch

    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def arrays(state: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def full_params(model, mesh) -> dict:
    """The parameters of a sharded ``model``, whole, as numpy arrays."""
    from pigeon_tpu_torch.train.mesh import full_parameters

    return arrays(full_parameters(model, mesh))


def full_grads(model, mesh) -> dict:
    from pigeon_tpu_torch.train.mesh import gather_params

    local = {n: (p.grad.full_tensor() if hasattr(p.grad, "full_tensor")
                 else p.grad) for n, p in model.named_parameters()
             if p.grad is not None}
    return arrays(gather_params(local, mesh, getattr(model, "tp_specs",
                                                     {})))


@contextlib.contextmanager
def environ(values: dict):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# Tasks
# ---------------------------------------------------------------------------

def shard_roundtrip(state: dict, tp: int):
    """`shard_params` then `gather_params`: the local shapes and whether
    the gathered state equals ``state`` bit for bit."""
    import torch

    from pigeon_tpu_torch.train.mesh import (
        gather_params,
        param_specs,
        shard_params,
    )

    mesh = mesh_of(tp)
    full = tensors(state)
    specs = param_specs(full)
    local = shard_params(full, mesh, specs)
    back = gather_params(local, mesh, specs)
    same = all(torch.equal(back[k], full[k]) for k in full)
    return {k: tuple(v.shape) for k, v in local.items()}, same


def finetune_steps(state: dict, vision: dict, head: dict, cells, batches,
                   tp: int = 1, fsdp: bool = False, lr: float = 1e-3,
                   route: str = "fused", remat: str = "attn_kernel"):
    """Train steps of a `SuperGuessr` (f32, every layer but the last
    frozen) from ``state`` on this rank's rows of ``batches``, over a
    ``(world / tp, tp)`` mesh under DDP or FSDP2: the metrics of each step
    and the parameters after them, whole."""
    import torch

    from pigeon_tpu_torch.config import HeadConfig, PigeonConfig, \
        VisionConfig
    from pigeon_tpu_torch.train.mesh import shard_batch
    from pigeon_tpu_torch.train.modes import build_finetune_model
    from pigeon_tpu_torch.train.train_loop import (
        adamw,
        batch_to_device,
        create_train_state,
        make_train_step,
    )

    mesh = mesh_of(tp)
    cfg = PigeonConfig(vision=VisionConfig(**vision), head=HeadConfig(**head))
    model = build_finetune_model(cfg, dtype=torch.float32, attn_impl=route,
                                 remat=remat)
    model.load_state_dict(tensors(state), strict=True)
    st = create_train_state(model, lambda p: adamw(p, lr), mesh, fsdp=fsdp)
    step = make_train_step(cfg.head, torch.from_numpy(np.array(cells)))
    metrics = []
    for batch in batches:
        got = step(st, batch_to_device(shard_batch(batch, mesh), "cpu"))
        metrics.append({k: float(v) for k, v in got.items()})
    return metrics, full_params(model, mesh)


def hostings(x, ws, bs, heads, g, wq8=None, act_scale=None):
    """K1 (K2 in the backward), K3 (K4) and K8 on this rank's heads
    (their plain versions on the CPU), joined over the model axis: K1's
    output, ``dx`` and weight gradients for the output gradient ``g``;
    K3's output and q/k/v gradients on the same heads; K8's output for
    the int8 operands ``wq8`` (``[(w, scale, bias)] * 3``) at
    ``act_scale``."""
    import torch

    from pigeon_tpu_torch.kernels.attention import FlashAttention
    from pigeon_tpu_torch.kernels.sharded import (
        gather_from_model,
        sharded_fused_qkv_attention,
        sharded_fused_qkv_attention_int8,
    )

    mesh = mesh_of(2)
    axis = mesh.model_axis
    r, n = axis.rank, axis.size

    def rows(a):            # a (P, ...) -> this rank's heads' rows
        return torch.from_numpy(np.ascontiguousarray(
            np.array_split(a, n, 0)[r]))

    out = {}
    xt = torch.from_numpy(x).requires_grad_(True)
    w = [rows(wi).requires_grad_(True) for wi in ws]
    b = [rows(bi).requires_grad_(True) for bi in bs]
    y = sharded_fused_qkv_attention(xt, *w, *b, heads, axis)
    full = gather_from_model(y, axis)
    (full * torch.from_numpy(g)).sum().backward()
    out["k1"] = full.detach().numpy()
    out["k1_dx"] = xt.grad.numpy()
    for i, wi in enumerate(w):
        out[f"k1_dw{i}"] = gather_from_model(
            wi.grad.t().contiguous(), axis).t().numpy()

    bsz, s, d = x.shape
    dh = d // heads
    qkv = [torch.from_numpy(np.ascontiguousarray(
        (x @ wi.T + bi).reshape(bsz, s, heads, dh)[:, :, r * heads // n:
                                                   (r + 1) * heads // n]))
        .requires_grad_(True) for wi, bi in zip(ws, bs)]
    y3 = FlashAttention.apply(*qkv)
    g3 = torch.from_numpy(np.ascontiguousarray(
        g.reshape(bsz, s, heads, dh)[:, :, r * heads // n:
                                     (r + 1) * heads // n]))
    (y3 * g3).sum().backward()
    out["k3"] = gather_from_model(y3.reshape(bsz, s, -1).detach(),
                                  axis).numpy()
    out["k3_dq"] = gather_from_model(qkv[0].grad.reshape(bsz, s, -1),
                                     axis).numpy()
    if wq8 is not None:
        ops = [t for wi, si, bi in wq8 for t in (rows(wi), rows(si),
                                                  rows(bi))]
        with torch.no_grad():
            y8 = sharded_fused_qkv_attention_int8(
                torch.from_numpy(x), torch.tensor(act_scale), *ops, heads,
                axis)
            out["k8"] = gather_from_model(y8, axis).numpy()
    return out


def head_loss(state: dict, head: dict, emb, labels, cells):
    """The geocell head's loss and logits with its cell layer split over
    the model axis (K10 smoothing the rank's rows; its plain version on
    the CPU), and the gradients, whole."""
    import torch

    from pigeon_tpu_torch.config import HeadConfig
    from pigeon_tpu_torch.models.geocell_head import GeocellHead
    from pigeon_tpu_torch.train.mesh import tensor_parallel
    from pigeon_tpu_torch.train.train_loop import batch_loss

    class Holder(torch.nn.Module):      # names the head ``head.*``
        def __init__(self, h):
            super().__init__()
            self.head = h

        def forward(self, x, heading=None):
            return self.head(x, heading)

    mesh = mesh_of(2)
    model = Holder(GeocellHead(HeadConfig(**head)))
    model.load_state_dict({f"head.{k}": v for k, v in
                           tensors(state).items()})
    tensor_parallel(model, mesh)
    assert model.head.tp is not None
    out, loss, _ = batch_loss(
        model, {"inputs": torch.from_numpy(emb),
                "labels": torch.from_numpy(labels)},
        torch.from_numpy(cells), model.head.config)
    loss.backward()
    return (float(loss), out.logits.detach().numpy(),
            full_grads(model, mesh))


def pretrain_steps(state: dict, vision: dict, text: dict, batches,
                   tp: int = 1, fsdp: bool = False, accum: int = 1,
                   lr: float = 1e-3):
    """Contrastive micro-steps of a `CLIPModel` (f32) from ``state`` on
    this rank's rows of each global batch, the negatives the global
    batch's: the loss of each, the gradients of the first, whole, the
    global norm each update clips by, and the parameters after all of
    them."""
    import torch

    from pigeon_tpu_torch.config import TextConfig, VisionConfig
    from pigeon_tpu_torch.models.clip import CLIPModel
    from pigeon_tpu_torch.train.mesh import shard_batch
    from pigeon_tpu_torch.train.modes import make_pretrain_step
    from pigeon_tpu_torch.train.train_loop import adamw, create_train_state

    mesh = mesh_of(tp)
    model = CLIPModel(VisionConfig(**vision), TextConfig(**text),
                      eos_token_id=text["vocab_size"] - 1)
    model.load_state_dict(tensors(state), strict=True)
    st = create_train_state(model, lambda p: adamw(
        p, lr, max_grad_norm=1.0, accum_steps=accum), mesh, fsdp=fsdp)
    opt = st.optimizer
    step = make_pretrain_step()
    first = None
    losses, norms = [], []
    original = opt.step
    norm_of = opt.grad_norm
    opt.grad_norm = lambda params: norms.append(
        float(norm_of(params))) or torch.tensor(norms[-1])

    def keep_first_grads():
        nonlocal first
        if first is None:
            first = full_grads(model, mesh)
        return original()

    opt.step = keep_first_grads
    for batch in batches:
        local = shard_batch(batch, mesh)
        got = step(st, {"pixel_values": torch.from_numpy(
            local["pixel_values"]), "input_ids": torch.from_numpy(
                local["input_ids"]).long()})
        losses.append(float(got["loss"]))
    return losses, first, norms, full_params(model, mesh)


def primitives(n: int):
    """The multi-host primitives on this rank: `host_slice` of ``n``,
    `allgather_hosts` of the rank, `coordinated_flag` with only rank 1
    raising it and with none, and `process_index/count`."""
    from pigeon_tpu_torch.train import multihost as mh

    rank = mh.process_index()
    return {"slice": mh.host_slice(n), "rank": rank,
            "count": mh.process_count(), "primary": mh.is_primary(),
            "gathered": mh.allgather_hosts(np.array([rank, 10 * rank])),
            "one": mh.coordinated_flag(rank == 1),
            "none": mh.coordinated_flag(False)}


def host_batches(meta: str, images: str, batch: int, tp: int,
                 seed: int = 0):
    """`iter_host_batches` over a panorama dataset: this rank's rows of
    each shuffled global batch (their latitudes) and keys."""
    import pandas as pd

    from pigeon_tpu_torch.data.pipeline import TabularImageDataset
    from pigeon_tpu_torch.train.multihost import iter_host_batches

    ds = TabularImageDataset(pd.read_csv(meta), images, image_size=32,
                             panorama=True)
    return [(b["labels"][:, 1].tolist(), sorted(b))
            for b in iter_host_batches(ds, batch, mesh_of(tp),
                                       shuffle=True, seed=seed)]


def cli(argv, cwd: str, env: dict = None):
    """`cli.run.main(argv)` in this rank under the pool's process group,
    from ``cwd``, with ``env`` set: its return code, or the message of
    the SystemExit that stopped it."""
    from pigeon_tpu_torch.cli.run import main

    old = os.getcwd()
    os.chdir(cwd)
    try:
        with environ(env or {}):
            return main(list(argv))
    except SystemExit as e:
        return f"SystemExit: {e}"
    finally:
        os.chdir(old)


def preempted_finetune(argv, cwd: str, signal_step: int, signal_rank: int):
    """`cli.run.main(argv)` (a finetune) where rank ``signal_rank``
    sends itself a SIGTERM as it takes train step ``signal_step``; the
    step each rank stopped at and the checkpoints written."""
    from pigeon_tpu_torch.cli import run
    from pigeon_tpu_torch.train import train_loop
    from pigeon_tpu_torch.train.checkpoints import latest_step
    from pigeon_tpu_torch.train.multihost import process_index

    make = train_loop.make_train_step
    stopped = {}

    def make_signalling(*a, **k):
        step = make(*a, **k)

        def signalling(state, batch):
            if state.step + 1 == signal_step and \
                    process_index() == signal_rank:
                os.kill(os.getpid(), signal.SIGTERM)
            out = step(state, batch)
            stopped["step"] = state.step
            return out

        return signalling

    train_loop.make_train_step = make_signalling
    old = os.getcwd()
    os.chdir(cwd)
    try:
        run.main(list(argv))
    finally:
        train_loop.make_train_step = make
        os.chdir(old)
    ckpt = os.path.join(cwd, "saved_models", argv[1])
    return stopped["step"], latest_step(ckpt), sorted(os.listdir(ckpt))


def preempted_pretrain(ckpt: str, signal_step: int, signal_rank: int,
                       poll: int):
    """`train.modes.pretrain` over 3 epochs of 4 micro-steps of a small
    model (DDP over the pool's ranks), rank ``signal_rank`` sending
    itself a SIGTERM as it takes micro-step ``signal_step``: the step
    every rank stopped at and the checkpoints written."""
    import torch

    from pigeon_tpu_torch.train.checkpoints import latest_step
    from pigeon_tpu_torch.train.modes import pretrain
    from pigeon_tpu_torch.train.multihost import process_index
    from pigeon_tpu_torch.train.train_loop import adamw, create_train_state

    torch.manual_seed(0)
    state = create_train_state(torch.nn.Linear(4, 2),
                               lambda p: adamw(p, 1e-3), mesh_of(1))

    def step_fn(st, batch):
        if st.step + 1 == signal_step and process_index() == signal_rank:
            os.kill(os.getpid(), signal.SIGTERM)
        st.optimizer.zero_grad()
        st.runner(batch).square().mean().backward()
        st.optimizer.step()
        st.step += 1
        return {}

    pretrain(state, step_fn, lambda epoch: [torch.ones(2, 4)] * 4, 3,
             checkpoint_dir=ckpt, save_steps=100, preempt_poll_steps=poll)
    return state.step, latest_step(ckpt), sorted(os.listdir(ckpt))


_PIPE_MESHES = {}


def pipeline_params(model, mesh, grads: bool = False) -> dict:
    """Every stage's parameters (or gradients), whole, as numpy arrays:
    tensor-parallel shards gathered over ``model``, the stages' layers
    over ``stage``."""
    import torch.distributed as dist

    from pigeon_tpu_torch.train.mesh import gather_params

    local = {n: (p.grad if grads else p).detach()
             for n, p in model.named_parameters()
             if not grads or p.grad is not None}
    full = arrays(gather_params(local, mesh,
                                getattr(model, "tp_specs", {})))
    parts = [None] * mesh.pp
    dist.all_gather_object(parts, full, group=mesh.stage_group)
    return {n: a for part in parts for n, a in part.items()}


def pipe_mesh_of(pp: int, tp: int):
    """This rank's ``(data, stage, model)`` pipeline mesh (made once)."""
    from pigeon_tpu_torch.train.pipeline import create_pipeline_mesh

    if (pp, tp) not in _PIPE_MESHES:
        _PIPE_MESHES[(pp, tp)] = create_pipeline_mesh(pp, tp)
    return _PIPE_MESHES[(pp, tp)]


def pipeline_tower(state: dict, vision: dict, px, pp: int, tp: int, m: int,
                   route: str = "fused"):
    """A `CLIPVisionTower` from ``state``, pipelined over ``pp`` stages
    (tensor-parallel over ``tp``) at M = ``m`` on this rank's data rows of
    ``px``: its output (last hidden and pooled) joined over ``data``, the
    gradients of ``sum(pooled**2)`` over the whole batch, whole, and the
    same three of the one-process tower; the stage's layer names."""
    import torch

    from pigeon_tpu_torch.config import VisionConfig
    from pigeon_tpu_torch.kernels.sharded import all_gather_along
    from pigeon_tpu_torch.models.clip import CLIPVisionTower
    from pigeon_tpu_torch.train.mesh import batch_slice
    from pigeon_tpu_torch.train.pipeline import (
        pipeline_vision_forward,
        shard_pipeline_params,
        sync_pipeline_grads,
    )

    def tower():
        t = CLIPVisionTower(VisionConfig(**vision), attn_impl=route)
        t.load_state_dict(tensors(state), strict=True)
        return t

    x = torch.from_numpy(px)
    one = tower()
    h1, p1 = one(x)
    (p1 ** 2).sum().backward()
    mesh = pipe_mesh_of(pp, tp)
    pipe = shard_pipeline_params(tower(), mesh)
    h, p = pipeline_vision_forward(pipe, x[batch_slice(len(px), mesh)],
                                   mesh, m)
    (p ** 2).sum().backward()
    sync_pipeline_grads(pipe, mesh)
    for q in pipe.parameters():
        if q.grad is not None:    # the mean over data -> the batch's sum
            q.grad.mul_(mesh.dp)
    if mesh.dp > 1:
        h, p = (all_gather_along(t.detach().contiguous(), mesh.data_group)
                for t in (h, p))
    return {"h": h.detach().numpy(), "pooled": p.detach().numpy(),
            "grads": pipeline_params(pipe, mesh, grads=True),
            "one_h": h1.detach().numpy(), "one_pooled": p1.detach().numpy(),
            "one_grads": {n: q.grad.numpy()
                          for n, q in one.named_parameters()},
            "layers": sorted(pipe.encoder.layers.keys()),
            "mesh": mesh.shape}


def pipeline_steps(state: dict, vision: dict, head: dict, cells, batch,
                   pp: int, tp: int, m: int, steps: int, lr: float = 1e-3,
                   reference: bool = True):
    """``steps`` pipelined train steps of a `SuperGuessr` (f32, the whole
    model training, AdamW clipped at 1.0) from ``state`` on ``batch``,
    and (``reference``) the first two in one process: the metrics of
    each and the parameters after the first two, whole."""
    import torch

    from pigeon_tpu_torch.config import HeadConfig, PigeonConfig, \
        VisionConfig
    from pigeon_tpu_torch.models.super_guessr import SuperGuessr
    from pigeon_tpu_torch.train.mesh import Mesh, shard_batch
    from pigeon_tpu_torch.train.pipeline import (
        create_pipeline_train_state,
        make_pipeline_train_step,
    )
    from pigeon_tpu_torch.train.train_loop import (
        TrainState,
        adamw,
        batch_to_device,
        make_train_step,
    )

    cfg = PigeonConfig(vision=VisionConfig(**vision), head=HeadConfig(**head))
    geocells = torch.from_numpy(np.array(cells))

    def model():
        mdl = SuperGuessr(cfg.vision, cfg.head)
        mdl.load_state_dict(tensors(state), strict=True)
        return mdl

    def optimizer(params):
        return adamw(params, lr, max_grad_norm=1.0)

    mesh = pipe_mesh_of(pp, tp)
    st = create_pipeline_train_state(model(), optimizer, mesh)
    step = make_pipeline_train_step(cfg.head, geocells, m)
    one = model()
    ref = TrainState(one, optimizer(one.parameters()), mesh=Mesh())
    ref_step = make_train_step(cfg.head, geocells)
    local = batch_to_device(shard_batch(batch, mesh), "cpu")
    whole = batch_to_device(batch, "cpu")
    out = {"metrics": [], "one_metrics": []}
    for i in range(steps):
        out["metrics"].append({k: float(v) for k, v in
                               step(st, local).items()})
        if i < 2 and reference:
            out["one_metrics"].append({k: float(v) for k, v in
                                       ref_step(ref, whole).items()})
        if i == 1:
            out["params"] = pipeline_params(st.model, mesh)
            out["one_params"] = arrays(dict(one.named_parameters()))
    out["layers"] = sorted(st.model.vision.encoder.layers.keys())
    return out
