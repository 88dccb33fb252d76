"""The benchmark's arithmetic against the numbers it was copied from:
PERF.md's bound column (the larger of bytes over 3.35 TB/s and bf16
operations over 989 TFLOP/s), the model FLOP counts of each
configuration, and the reduction of a trace."""

import json
import os

import pytest

from portbench.harness import ROOT
from portbench.yardstick import flops, trace


def config(name):
    with open(os.path.join(ROOT, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("fn,shape,ms", [
    (flops.k1_ops_bytes, (32, 577, 1024, 16), 0.162),
    (flops.k1_ops_bytes, (4, 577, 1024, 16), 0.020),
    (flops.k1_ops_bytes, (512, 577, 1024, 16), 2.585),
    (flops.k1_ops_bytes, (32, 577, 1024, 8), 0.081),
    (flops.k2_ops_bytes, (32, 577, 1024, 16), 0.345),
    (flops.k2_ops_bytes, (32, 577, 1024, 8), 0.173),
])
def test_kernel_bounds_match_the_table(fn, shape, ms):
    assert flops.bound_seconds(*fn(*shape)) * 1e3 == pytest.approx(
        ms, abs=5e-4)


def test_vit_b32_k1_operations():
    ops, _ = flops.k1_ops_bytes(8, 50, 768, 12)
    assert ops / 1e9 == pytest.approx(1.48, abs=5e-3)


def test_bytes_bound_where_operations_are_few():
    ops, nbytes = flops.k1_ops_bytes(1, 1, 1024, 16)
    assert flops.bound_seconds(ops, nbytes) == nbytes \
        / flops.PEAK_HBM_BYTES_PER_S


@pytest.mark.parametrize("name,forward,train", [
    ("pigeon-vitl14-336", 381.9, 811.1),
    ("pigeon-vitb32", 8.82, None),
])
def test_model_flops(name, forward, train):
    cfg = config(name)
    assert flops.tower_forward_flops(cfg) / 1e9 == pytest.approx(
        forward, rel=1e-3)
    if train is not None:
        per_view = flops.train_flops_per_view(
            cfg, cfg, 4, cfg["trained_encoder_layers"])
        assert per_view / 1e9 == pytest.approx(train, rel=1e-3)


def event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_summary():
    events = [
        event(trace.WINDOW_MARK, "user_annotation", 100.0, 1000.0),
        event("void K1Attention_kernel<...>", "kernel", 50.0, 100.0),
        event("K1Projection gemm_sm90_kernel", "kernel", 300.0, 200.0),
        event("ampere_bf16_s16816gemm", "kernel", 400.0, 200.0),
        event("elementwise_kernel", "kernel", 900.0, 300.0),
        event("aten::linear", "cpu_op", 120.0, 150.0),
        event("cudaStreamSynchronize", "cuda_runtime", 620.0, 250.0),
    ]
    s = trace.summarize(events)
    assert s.window_s == pytest.approx(1e-3)
    # Busy: 100-150, 300-600, 900-1100 (clipped to the window).
    assert s.busy_s == pytest.approx(550e-6)
    assert s.group_seconds["K1 attention"] == pytest.approx(50e-6)
    assert s.group_seconds["K1 projection GEMM"] == pytest.approx(200e-6)
    assert s.group_seconds["library GEMMs"] == pytest.approx(200e-6)
    assert s.group_seconds["other"] == pytest.approx(200e-6)
    assert trace.kernel_seconds(s, "K1") == pytest.approx(250e-6)
    # Idle: 150-300 (aten::linear), 600-900 (the synchronise).
    assert s.idle_by_host == pytest.approx(
        {"aten::linear": 150e-6, "cudaStreamSynchronize": 300e-6})
    b = trace.breakdown(s)
    assert b["idle_gaps"][0][0] == "cudaStreamSynchronize"
    assert len(b["device_ops"]) <= 10


def test_group_order_puts_the_ports_gemms_first():
    assert trace.group_of("gemm_sm90_kernel<K2Dx, false>") == "K2 dx GEMM"
    assert trace.group_of("sm90_xmma_gemm_bf16") == "library GEMMs"
    assert trace.group_of("vectorized_elementwise") == "other"
