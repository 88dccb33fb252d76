"""The program's spans (`pigeon_tpu_torch/train/profiling.py`): recorded
exactly while a torch profiler runs, at the micro-batcher's, the train
step's and the embed step's phases, nested as the code runs them, and
read by the benchmark's span metrics (`portbench/metrics/`)."""

import collections
import json
import os
import statistics
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pigeon_tpu_torch.config import HeadConfig, PigeonConfig, VisionConfig
from pigeon_tpu_torch.serve.batching import MicroBatcher
from pigeon_tpu_torch.train import profiling

#: Seconds any wait of these tests may take.
WAIT_S = 30.0
BATCH_PHASES = ("serve.collect", "serve.stage", "serve.forward",
                "serve.refine", "serve.readback")
TRAIN_PHASES = ("train.forward", "train.backward", "train.optimizer")


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    """Each test its own, empty store."""
    monkeypatch.setattr(profiling, "_SPANS", collections.deque(
        maxlen=profiling.SPAN_CAPACITY))


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def serve_fn(pixels):
    """A stub serving forward: every field the refiner and the batcher's
    answer read."""
    x = pixels.float().mean(dim=(1, 2))
    b = pixels.shape[0]
    return {"pred_lla": torch.stack([x, -x], -1),
            "embedding": x[:, None].repeat(1, 4),
            "topk_cells": torch.arange(3).repeat(b, 1),
            "topk_probs": torch.full((b, 3), 1 / 3)}


serve_fn.device = torch.device("cpu")


def refine_fn(embedding, pred_lla, topk_cells, topk_probs):
    return {"pred_lla": pred_lla + 1, "pred_cell": topk_cells[:, 0]}


def serve_requests(batcher, n):
    futures = [batcher.submit(np.full((2, 3), i, np.uint8))
               for i in range(n)]
    return [f.result(timeout=WAIT_S) for f in futures]


def tiny_train():
    """A tiny SuperGuessr's train state, step and one batch, on the CPU
    and the plain route."""
    from pigeon_tpu_torch.models.super_guessr import init_weights
    from pigeon_tpu_torch.train.modes import build_finetune_model
    from pigeon_tpu_torch.train.train_loop import (
        TrainState,
        adamw,
        make_train_step,
    )

    vision = VisionConfig(image_size=32, patch_size=16, hidden_size=32,
                          intermediate_size=64, num_layers=1, num_heads=2,
                          projection_dim=16)
    head = HeadConfig(num_cells=7, embed_dim=32)
    model = init_weights(build_finetune_model(
        PigeonConfig(vision=vision, head=head), dtype=torch.float32,
        attn_impl="plain", remat="none"), 0)
    gen = torch.Generator().manual_seed(0)
    cells = torch.rand((7, 2), generator=gen) * 100 - 50
    batch = {"inputs": torch.randn((2, 32, 32, 3), generator=gen),
             "labels": torch.rand((2, 2), generator=gen) * 100 - 50}
    state = TrainState(model, adamw(model.parameters(), 1e-3))
    return state, make_train_step(head, cells), batch


def tiny_embed_step():
    from pigeon_tpu_torch.train.embed import make_embed_step

    class Mean(torch.nn.Module):
        def forward(self, x):
            return x.mean(dim=(1, 2))

    return make_embed_step(Mean(), "cpu")


def by_start(spans):
    return sorted(spans, key=lambda s: s.start_ns)


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------

def test_spans_nest_by_thread_and_record_takes_given_times():
    with cpu_profile():
        with profiling.span("outer", tag=1) as outer:
            with profiling.span("inner") as inner:
                pass
            aside = profiling.span("aside", parent=outer.id)
            aside.__enter__()
            with profiling.span("after") as after:
                pass
            aside.__exit__(None, None, None)
        got = profiling.record("waited", 5, 9, request=3)
    assert outer.parent is None and outer.attrs == {"tag": 1}
    # A span given its parent is no parent of the spans inside it.
    assert inner.parent == after.parent == aside.parent == outer.id
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert (got.start_ns, got.end_ns, got.ms) == (5, 9, 4e-6)
    assert got.attrs == {"request": 3} and got.parent is None
    assert got.device_ms is None
    assert [s.name for s in profiling.spans()] == [
        "inner", "after", "aside", "outer", "waited"]
    assert profiling.spans("inner") == [inner]


def test_spans_of_two_threads_keep_their_own_parents():
    seen = {}

    def worker():
        with profiling.span("worker.root") as root:
            with profiling.span("worker.child") as child:
                seen["ids"] = root.id, child.parent, root.parent

    with cpu_profile():
        with profiling.span("main.root"):
            thread = threading.Thread(target=worker)
            thread.start()
            thread.join(timeout=WAIT_S)
    assert not thread.is_alive()
    root_id, child_parent, root_parent = seen["ids"]
    assert child_parent == root_id and root_parent is None


def test_the_store_is_a_bounded_ring(monkeypatch):
    monkeypatch.setattr(profiling, "_SPANS", collections.deque(maxlen=4))
    with cpu_profile():
        for i in range(6):
            profiling.record("r", i, i + 1)
    assert [s.start_ns for s in profiling.spans()] == [2, 3, 4, 5]


@pytest.mark.parametrize("site", ["batcher", "train", "embed"])
def test_off_records_nothing_and_creates_nothing(monkeypatch, site):
    """No profiler: no span, no ``record_function``, no CUDA event, even
    where CUDA would be there to time."""
    def refuse(*args, **kwargs):
        raise AssertionError("created while no profiler runs")

    monkeypatch.setattr(profiling, "Span", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert not profiling.tracing()
    if site == "batcher":
        batcher = MicroBatcher(serve_fn, refine_fn, max_batch=4,
                               max_wait_ms=5)
        try:
            assert len(serve_requests(batcher, 5)) == 5
        finally:
            batcher.close()
        assert batcher.requests_served == 5
    elif site == "train":
        state, step, batch = tiny_train()
        step(state, batch)
        assert state.step == 1
    else:
        assert tiny_embed_step()(np.zeros((2, 4, 4, 3), np.uint8)).shape \
            == (2, 3)
    assert profiling.spans() == []


# ---------------------------------------------------------------------------
# The sites
# ---------------------------------------------------------------------------

def test_batcher_spans_under_the_profiler():
    batcher = MicroBatcher(serve_fn, refine_fn, max_batch=4, max_wait_ms=20)
    try:
        with cpu_profile():
            rows = serve_requests(batcher, 5)
    finally:
        batcher.close()
    assert [float(r["pred_lla"][0]) for r in rows] == [1, 2, 3, 4, 5]
    queued = profiling.spans("serve.queue")
    batches = by_start(profiling.spans("serve.batch"))
    assert sorted(s.attrs["request"] for s in queued) == list(range(5))
    assert len(batches) == batcher.batches_run
    assert [(b.attrs["fill"], b.attrs["bucket"]) for b in batches] \
        == batcher.fills
    assert sum(b.attrs["fill"] for b in batches) == 5
    for b in batches:
        children = by_start(s for s in profiling.spans()
                            if s.parent == b.id and s.name != "serve.device")
        assert [c.name for c in children] == list(BATCH_PHASES)
        assert b.start_ns <= children[0].start_ns
        assert children[-1].end_ns <= b.end_ns
        for one, two in zip(children, children[1:]):
            assert one.start_ns <= one.end_ns <= two.start_ns
        stage = children[1]
        (device,) = [s for s in profiling.spans("serve.device")
                     if s.parent == b.id]
        assert stage.start_ns <= device.start_ns <= stage.end_ns
        assert children[3].end_ns <= device.end_ns <= children[4].start_ns
        mine = [q for q in queued if q.attrs["batch"] == b.id]
        assert len(mine) == b.attrs["fill"]
        assert all(q.end_ns == stage.start_ns and q.start_ns <= b.start_ns
                   for q in mine)


def test_all_threads_trace_holds_the_batchers_spans(tmp_path):
    batcher = MicroBatcher(serve_fn, refine_fn, max_batch=4, max_wait_ms=5)
    try:
        profiling.capture_trace(lambda: serve_requests(batcher, 3),
                                str(tmp_path), steps=1)
    finally:
        batcher.close()
    (path,) = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("serve.")]
    names = {e["name"] for e in marks}
    assert {"serve.batch", *BATCH_PHASES, "serve.device"} <= names
    assert len({e["tid"] for e in marks}) == 1
    assert sum(e["name"] == "serve.batch" for e in marks) \
        == batcher.batches_run


def test_train_step_records_its_phases_in_order():
    state, step, batch = tiny_train()
    with cpu_profile():
        for _ in range(2):
            step(state, batch)
    steps = by_start(profiling.spans("train.step"))
    assert len(steps) == 2
    for s in steps:
        phases = by_start(p for p in profiling.spans() if p.parent == s.id)
        assert [p.name for p in phases] == list(TRAIN_PHASES)
        assert s.start_ns <= phases[0].start_ns
        assert phases[-1].end_ns <= s.end_ns
        for one, two in zip(phases, phases[1:]):
            assert one.end_ns <= two.start_ns
        # No card: no device time.
        assert all(p.device_ms is None for p in (s, *phases))


def test_embed_step_records_its_copy():
    step = tiny_embed_step()
    with cpu_profile():
        for _ in range(2):
            step(np.zeros((2, 4, 4, 3), np.uint8))
    copies = profiling.spans("embed.h2d")
    assert profiling.spans() == copies and len(copies) == 2
    # A root of its own; no card, no device time.
    assert all(c.parent is None and c.device_ms is None for c in copies)


def test_drain_empties_the_ring():
    with cpu_profile():
        for i in range(3):
            profiling.record("r", i, i + 1)
        first = profiling.drain()
        profiling.record("r", 7, 8)
    assert [s.start_ns for s in first] == [0, 1, 2]
    assert [s.start_ns for s in profiling.drain()] == [7]
    assert profiling.spans() == [] and profiling.drain() == []


# ---------------------------------------------------------------------------
# The benchmark's span metrics
# ---------------------------------------------------------------------------

SPAN_METRICS = [
    ("queue_wait_ms.serve", "serve.queue", "ms"),
    ("collect_ms.serve", "serve.collect", "ms"),
    ("stage_ms.serve", "serve.stage", "ms"),
    ("batch_card_elapsed_ms.serve", "serve.device", "device_ms"),
    ("forward_host_ms.serve", "serve.forward", "ms"),
    ("refine_host_ms.serve", "serve.refine", "ms"),
    ("readback_ms.serve", "serve.readback", "ms"),
    ("forward_ms.train", "train.forward", "device_ms"),
    ("backward_ms.train", "train.backward", "device_ms"),
    ("optimizer_ms.train", "train.optimizer", "device_ms"),
    ("h2d_ms.embed_b32", "embed.h2d", "device_ms"),
]


def metric(name):
    from portbench.harness import Bench

    return Bench().metric(name)


@pytest.mark.parametrize("name,span,field", SPAN_METRICS)
def test_span_metric_is_none_without_spans(name, span, field):
    assert metric(name).read(types.SimpleNamespace()) is None


@pytest.mark.parametrize("name,span,field", SPAN_METRICS)
def test_span_metric_is_none_on_a_program_without_drain(monkeypatch, name,
                                                       span, field):
    """The parent's program under this benchmark: its profiling module
    has no `drain`, so the metric is left out, recorded spans or not."""
    monkeypatch.delattr(profiling, "drain")
    with cpu_profile():
        profiling.record(span, 0, 10)
    assert metric(name).read(types.SimpleNamespace()) is None


@pytest.mark.parametrize("name,span,field", SPAN_METRICS)
def test_span_metric_is_the_mean_of_its_spans(monkeypatch, name, span,
                                              field):
    store = [types.SimpleNamespace(name=n, ms=ms, device_ms=dev)
             for n, ms, dev in [(span, 2.0, 20.0), (span, 4.0, 40.0),
                                (span, 9.0, None), ("other", 99.0, 99.0)]]
    monkeypatch.setattr(profiling, "drain", lambda: list(store))
    # Host time: the mean of every span; device time: of those that
    # timed the card.
    want = 5.0 if field == "ms" else 30.0
    assert metric(name).read(types.SimpleNamespace()) == pytest.approx(want)


def test_each_run_reads_the_spans_of_its_own_slice():
    """Two profiled slices in one process: every metric of a run reads
    the spans recorded since the last run was read, none of the earlier
    slice's."""
    from portbench.yardstick.spans import recorded

    collect, stage = metric("collect_ms.serve"), metric("stage_ms.serve")
    batcher = MicroBatcher(serve_fn, refine_fn, max_batch=2, max_wait_ms=5)
    try:
        for n in (3, 5):
            before = batcher.batches_run
            with cpu_profile():
                serve_requests(batcher, n)
            want = [s.ms for s in profiling.spans("serve.collect")]
            run = types.SimpleNamespace()
            assert collect.read(run) == pytest.approx(statistics.fmean(want))
            assert len(recorded(run, "serve.collect")) \
                == batcher.batches_run - before
            assert stage.read(run) is not None
            assert profiling.spans("serve.collect") == []
    finally:
        batcher.close()


def test_span_metrics_are_in_the_benchmark():
    from portbench.harness import Bench

    entries = {m["name"]: m for m in Bench().spec["per_layer"]}
    for name, _, _ in SPAN_METRICS:
        assert entries[name]["source"] == "program_span"
        assert entries[name]["unit"] == "ms"
        assert len(entries[name]["workloads"]) == 1


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans' CUDA events time the "
                    "card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_device_times_on_the_card(cuda):
    """Device time is positive, and the train step's three phases add up
    to the step's: a step large enough that the card, not the host, sets
    its pace, so the host's time between the phases' events is not idle
    time on the card."""
    from pigeon_tpu_torch.models.super_guessr import init_weights
    from pigeon_tpu_torch.train.embed import make_embed_step
    from pigeon_tpu_torch.train.modes import build_finetune_model
    from pigeon_tpu_torch.train.train_loop import (
        TrainState,
        adamw,
        make_train_step,
    )

    vision = VisionConfig(image_size=224, patch_size=16, hidden_size=768,
                          intermediate_size=3072, num_layers=4, num_heads=12,
                          projection_dim=512)
    head = HeadConfig(num_cells=2203, embed_dim=768)
    model = init_weights(build_finetune_model(
        PigeonConfig(vision=vision, head=head), attn_impl="plain",
        remat="none"), 0).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = {"inputs": torch.randn((512, 224, 224, 3), generator=gen,
                                   device=cuda),
             "labels": torch.rand((512, 2), generator=gen, device=cuda)
             * 100 - 50}
    cells = torch.rand((2203, 2), generator=gen, device=cuda) * 100 - 50
    state = TrainState(model, adamw(model.parameters(), 1e-5))
    step = make_train_step(head, cells)
    step(state, batch)                          # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            step(state, batch)
        embed = make_embed_step(model.vision, cuda)
        embed(np.zeros((64, 224, 224, 3), np.uint8))
        torch.cuda.synchronize()
    steps = profiling.spans("train.step")
    assert len(steps) == 3
    for s in steps:
        phases = {p.name: p.device_ms for p in profiling.spans()
                  if p.parent == s.id}
        assert set(phases) == set(TRAIN_PHASES)
        assert all(ms > 0 for ms in phases.values()), phases
        assert sum(phases.values()) == pytest.approx(s.device_ms, rel=0.02), \
            (s.device_ms, phases)
    (h2d,) = profiling.spans("embed.h2d")
    assert h2d.device_ms > 0
