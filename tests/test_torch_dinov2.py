"""DINOv2 ViT-g/14 with registers on the port (`models/vit_embedder.py`
under `config.dinov2_variant`) against the benchmark's plain float32
reference (`portbench/reference/dinov2.py`), on the CPU at a tiny size:
width 128 (two heads of 64), 2 layers, SwiGLU width 344 by HF's rule,
56-px images in 14-px patches and 4 registers, so 21 tokens. Seeded
weights are the benchmark cell's own (`portbench/drivers/embed_dinov2`),
LayerScale drawn per channel in 0.05-1. Also: the token layout and the
pooling, where the layer reaches the one-pass kernels (a spy; a CPU bf16
activation takes the card's path through their plain versions), the HF
import, the embed step's normalisation, ``embed --model dinov2-g14-reg``,
the published configuration against the port's preset, and the tiny cell
through the benchmark's harness."""

import dataclasses
import json
import os
import pathlib
import time

import numpy as np
import pandas as pd
import pytest
import torch

from pigeon_tpu_torch.config import (
    ViTVariant,
    dinov2_g14_reg_vision,
    dinov2_variant,
)
from pigeon_tpu_torch.data.image_ops import (
    IMAGENET_IMAGE_MEAN,
    IMAGENET_IMAGE_STD,
    normalize_images,
)
from pigeon_tpu_torch.kernels import eltwise
from pigeon_tpu_torch.models import clip
from pigeon_tpu_torch.models.vit_embedder import (
    ViTEmbedder,
    hf_dinov2_state,
    import_dinov2_params,
)
from portbench import program
from portbench.drivers import embed_dinov2 as driver
from portbench.harness import ROOT as BENCH_ROOT
from portbench.reference import dinov2 as ref
from portbench.yardstick import dinov2 as arith

SEED = 2 ** 33 + 11
CONFIG = os.path.join(BENCH_ROOT, "configs", "pigeon-dinov2-g14-reg4-518.json")
TINY = dict(image_size=56, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=2)
#: The routes a DINOv2 layer takes (``"block"``'s K6 adds the residual
#: unscaled).
ROUTES = ("plain", "fused", "flash", "fused_ln", "fused_mlp")
#: f32 against the reference: the same products summed in other orders
#: (K1's plain version, the patch unfold against a convolution): 1.3e-6 to
#: 1.5e-6 relative over five seeds.
F32_TOL = 1e-4
#: bf16 (the kernels' plain versions) against the f32 reference, worst
#: row's relative L2 of the CLS embedding: bf16 keeps 8 bits, and the CLS
#: row after the final LN carries every rounding of 2 layers with no mean
#: over tokens to average it out: 0.012-0.019 over five seeds. The planted
#: faults read 0.060-0.080 (CLIP's normalisation) and 0.35 or more.
BF16_TOL = 0.03


def published():
    with open(CONFIG) as f:
        return json.load(f)


def tiny_cfg(**over):
    return dict(published(), **TINY, **over)


def port(cfg, dtype=torch.float32, route="fused", fault=None, weights=None):
    model = program.build(lambda: ViTEmbedder(
        driver.vision_config(cfg), dtype=dtype, pool="cls", attn_impl=route,
        variant=driver.variant(cfg, fault)), "cpu")
    program.load(model, weights if weights is not None
                 else driver.make_weights(cfg, SEED, "cpu"))
    return model.eval()


def images(cfg, n=3, seed=SEED):
    s = cfg["image_size"]
    return torch.randint(0, 256, (n, s, s, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(seed))


def rel_err(got, want):
    return ((got.float() - want).norm(dim=-1) / want.norm(dim=-1)).max() \
        .item()


def run_port(model, px, grad=False):
    x = normalize_images(px, model.pixel_mean, model.pixel_std)
    if grad:
        return model(x)
    with torch.inference_mode():
        return model(x)


def test_published_configuration_is_the_ports_preset():
    """The configuration file builds `dinov2_g14_reg_vision` and
    `dinov2_variant`; 1,374 tokens; 3.58 TFLOP an image (77.8 GFLOP of
    dense products and 11.6 of attention a layer, 2.5 the patches)."""
    cfg = published()
    assert driver.vision_config(cfg) == dinov2_g14_reg_vision()
    assert driver.variant(cfg) == dinov2_variant()
    assert arith.seq_len(cfg) == 1374
    assert arith.swiglu_width(cfg) == ref.swiglu_width(cfg) == 4096
    s, d, i = 1374, 1536, 4096
    assert 2 * s * d * (4 * d + 3 * i) / 1e9 == pytest.approx(77.8, abs=0.05)
    assert 4 * s * s * d / 1e9 == pytest.approx(11.6, abs=0.05)
    assert arith.forward_flops(cfg) / 1e12 == pytest.approx(3.578, abs=1e-3)
    weights = sum(torch.Size(shape).numel()
                  for _, shape, _, _ in driver.weight_specs(cfg))
    assert (weights + 80 * d) / 1e9 == pytest.approx(1.136, abs=1e-3)


@pytest.mark.parametrize("route", ROUTES)
def test_port_matches_reference_in_f32(route):
    cfg = tiny_cfg()
    w = driver.make_weights(cfg, SEED, "cpu")
    px = images(cfg)
    got = run_port(port(cfg, route=route, weights=w), px)
    want = ref.embed(w, cfg, px, block=2)
    assert got.shape == (3, 128) and got.dtype == torch.float32
    assert rel_err(got, want) < F32_TOL


@pytest.mark.parametrize("route", ["fused", "flash", "fused_ln"])
def test_port_matches_reference_in_bf16(route):
    """The inference forward in bf16 takes the kernels' plain versions on
    the CPU: within `BF16_TOL` of the f32 reference, and the grad-mode
    forward (the eager chain) bit for bit."""
    cfg = tiny_cfg()
    w = driver.make_weights(cfg, SEED, "cpu")
    px = images(cfg)
    model = port(cfg, torch.bfloat16, route, weights=w)
    got = run_port(model, px)
    assert rel_err(got, ref.embed(w, cfg, px)) < BF16_TOL
    assert torch.equal(got, run_port(model, px, grad=True).detach())


@pytest.mark.parametrize("fault", ["no_layer_scale", "no_registers",
                                   "clip_norm"])
def test_a_planted_fault_fails_the_bf16_tolerance(fault):
    cfg = tiny_cfg()
    w = driver.make_weights(cfg, SEED, "cpu")
    px = images(cfg)
    model = port(cfg, torch.bfloat16, fault=fault, weights=w)
    if fault == "no_layer_scale":
        with torch.no_grad():
            for name in driver.gamma_names(cfg):
                model.get_parameter(name).fill_(1.0)
    if fault == "no_registers":
        model.register_tokens = None
    assert rel_err(run_port(model, px), ref.embed(w, cfg, px)) > BF16_TOL


def test_fp8_control_departs_from_float32():
    cfg = tiny_cfg()
    w = driver.make_weights(cfg, SEED, "cpu")
    px = images(cfg)
    err = rel_err(ref.embed(w, cfg, px, fp8=True), ref.embed(w, cfg, px))
    assert 1e-3 < err < 0.5


def test_token_layout_puts_registers_after_cls_without_positions():
    cfg = tiny_cfg()
    model = port(cfg)
    x = normalize_images(images(cfg, 2), model.pixel_mean, model.pixel_std)
    with torch.no_grad():
        tokens = model.tokens(x)
        patches = model.patch_embed(x)
    pos = model.pos_embed
    assert tokens.shape == (2, 21, 128)
    torch.testing.assert_close(tokens[:, 0],
                               (model.cls_token + pos[0]).expand(2, 128))
    assert torch.equal(tokens[:, 1:5], model.register_tokens.expand(2, 4, 128))
    torch.testing.assert_close(tokens[:, 5:], patches + pos[1:])


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_pooling_reads_the_final_ln_and_skips_registers(pool):
    cfg = tiny_cfg()
    model = port(cfg)
    model.pool = pool
    x = normalize_images(images(cfg, 2), model.pixel_mean, model.pixel_std)
    with torch.no_grad():
        h = clip.layer_norm(model.final_ln, model.encoder(model.tokens(x)))
        got = model(x)
    want = h[:, 0] if pool == "cls" else torch.cat(
        [h[:, :1], h[:, 5:]], 1).mean(1)
    torch.testing.assert_close(got, want)


#: Calls of each wrapper in a forward of L layers, grad mode off, by route
#: (LN, scale-add + LN, SwiGLU, add + LN, quick-GELU): on ``"fused"`` and
#: ``"flash"`` each layer's MLP residual runs with the next layer's LN1
#: (the last one's with the final LN); on ``"fused_ln"`` K5 folds LN1 in
#: and the MLP residual is one eager scale-add.
CALLS = {"fused": (1, 2, 1, 0, 0), "flash": (1, 2, 1, 0, 0),
         "fused_ln": (0, 1, 1, 0, 0), "plain": (0, 0, 0, 0, 0),
         "fused_mlp": (0, 0, 0, 0, 0)}
WRAPPERS = ("layer_norm_bf16", "scale_add_layer_norm_bf16", "swiglu_bf16",
            "add_layer_norm_bf16", "quick_gelu_bf16")


@pytest.mark.parametrize("route", sorted(CALLS))
def test_the_inference_forward_reaches_the_kernels(monkeypatch, route):
    calls = dict.fromkeys(WRAPPERS, 0)

    def counted(name):
        real = getattr(eltwise, name)

        def wrapper(*args):
            calls[name] += 1
            return real(*args)
        return wrapper

    for name in WRAPPERS:
        monkeypatch.setattr(clip, name, counted(name))
    cfg = tiny_cfg()
    model = port(cfg, torch.bfloat16, route)
    run_port(model, images(cfg, 2))
    first = calls["layer_norm_bf16"]
    assert tuple(calls[n] for n in WRAPPERS) == (
        first, *(2 * n for n in CALLS[route][1:]))
    assert first == CALLS[route][0]
    before = dict(calls)
    run_port(model, images(cfg, 2), grad=True)
    assert calls == before


@pytest.mark.parametrize("swiglu,layer_scale", [(True, False),
                                                 (False, True)])
def test_swiglu_and_layer_scale_each_alone(swiglu, layer_scale):
    """A layer with SwiGLU and no LayerScale, or LayerScale and a GELU
    MLP: the inference forward through the kernels' plain versions equals
    the grad-mode eager chain bit for bit, and is finite."""
    from pigeon_tpu_torch.models.super_guessr import init_weights

    cfg = driver.vision_config(tiny_cfg())
    torch.manual_seed(0)
    stack = init_weights(clip.TransformerStack(
        cfg, "fused", swiglu=swiglu, layer_scale=layer_scale), 1).eval()
    ln = torch.nn.LayerNorm(128, eps=1e-6)
    x = torch.randn(2, 21, 128).bfloat16()
    with torch.inference_mode():
        got = stack.forward_ln(x, ln)
    want = stack.forward_ln(x, ln)
    assert torch.equal(got, want.detach()) and got.isfinite().all()


def test_block_route_and_int8_are_refused():
    cfg = tiny_cfg()
    model = port(cfg, torch.bfloat16, "block")
    with pytest.raises(ValueError, match="block"):
        run_port(model, images(cfg, 1))
    with pytest.raises(ValueError, match="int8"):
        clip.TransformerLayer(driver.vision_config(cfg), quant="dynamic",
                              swiglu=True, layer_scale=True)


def test_init_weights_and_gradients():
    """`init_weights` zeroes the registers and sets LayerScale to one
    (DINOv2's ``layerscale_value``); training's eager chain reaches every
    DINOv2 parameter."""
    from pigeon_tpu_torch.models.super_guessr import init_weights

    cfg = tiny_cfg()
    model = init_weights(ViTEmbedder(driver.vision_config(cfg),
                                     variant=dinov2_variant()), 0)
    assert not model.register_tokens.any()
    layer = model.encoder.layers[0]
    assert bool((layer.gamma1 == 1).all() and (layer.gamma2 == 1).all())
    with torch.no_grad():
        model.register_tokens.normal_()
    model(torch.randn(2, 56, 56, 3)).square().sum().backward()
    for name in ("register_tokens", "encoder.layers.0.gamma1",
                 "encoder.layers.1.gamma2", "encoder.layers.0.w_in.weight",
                 "encoder.layers.1.w_out.bias"):
        assert model.get_parameter(name).grad.abs().sum() > 0, name


@pytest.mark.parametrize("prefix", ["", "dinov2_with_registers."])
def test_hf_import_round_trips(prefix):
    """`hf_dinov2_state` writes HF `Dinov2WithRegistersModel`'s names;
    `import_dinov2_params` reads back every tensor bit for bit, bare or
    under the classifier's prefix, with a mask token it does not read."""
    cfg = tiny_cfg()
    model = port(cfg)
    state = {prefix + k: v for k, v in hf_dinov2_state(model).items()}
    state[prefix + "embeddings.mask_token"] = torch.zeros(1, 128)
    assert state[prefix + "embeddings.patch_embeddings.projection.weight"] \
        .shape == (128, 3, 14, 14)
    assert state[prefix + "encoder.layer.1.mlp.weights_in.weight"].shape \
        == (688, 128)
    assert state[prefix + "encoder.layer.0.layer_scale2.lambda1"].shape \
        == (128,)
    back = import_dinov2_params(state, 2)
    assert back.keys() == model.state_dict().keys()
    for name, value in model.state_dict().items():
        assert torch.equal(back[name], value), name


def test_embed_step_normalises_by_the_models_constants():
    from pigeon_tpu_torch.train.embed import make_embed_step

    cfg = tiny_cfg()
    model = port(cfg)
    assert (model.pixel_mean, model.pixel_std) == (IMAGENET_IMAGE_MEAN,
                                                   IMAGENET_IMAGE_STD)
    px = images(cfg, 2)
    got = make_embed_step(model, "cpu")(px.numpy())
    with torch.no_grad():
        want = model(normalize_images(px, IMAGENET_IMAGE_MEAN,
                                      IMAGENET_IMAGE_STD))
    assert torch.equal(got, want)
    assert ViTEmbedder(driver.vision_config(cfg)).pixel_mean \
        == ViTVariant().pixel_mean


SAMPLE20 = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "benchmarks", "sample20", "images")


def test_embed_command_builds_dinov2(tmp_path, monkeypatch):
    """``embed --model dinov2-g14-reg`` builds the DINOv2 `ViTEmbedder`
    through `build_embedder` (at ``--tiny`` widths here) and embeds each
    split; an HF ``--base`` file is loaded; the other commands and
    ``--embedder clip`` stop."""
    from pigeon_tpu_torch.cli import run as cli

    names = sorted(os.listdir(SAMPLE20))[:6]
    pd.DataFrame({"image": names, "lng": 0.0, "lat": 0.0,
                  "selection": ["train"] * 4 + ["val"] * 2}).to_csv(
        tmp_path / "meta.csv", index=False)
    argv = ["embed", "dino", "--tiny", "--model", "dinov2-g14-reg",
            "--device", "cpu", "--metadata", str(tmp_path / "meta.csv"),
            "--images", SAMPLE20, "--batch-size", "4"]
    seen = {}
    real = cli.build_embedder

    def spy(args, cfg):
        seen["model"] = real(args, cfg)
        return seen["model"]

    monkeypatch.setattr(cli, "build_embedder", spy)
    assert cli.main(argv + ["--output", str(tmp_path / "a")]) == 0
    model = seen["model"]
    assert model.variant == dinov2_variant()
    assert clip.routes_of(model) == {"fused"}
    train = np.load(tmp_path / "a" / "train.npy")
    assert train.shape == (4, 64) and np.isfinite(train).all()
    torch.save(hf_dinov2_state(model), tmp_path / "dino.pt")
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    assert cli.main(argv + ["--output", str(tmp_path / "b"), "--base",
                            str(tmp_path / "dino.pt")]) == 0
    np.testing.assert_array_equal(np.load(tmp_path / "b" / "train.npy"),
                                  train)
    with pytest.raises(SystemExit, match="embed only"):
        cli.main(["finetune", "dino", "--tiny", "--model", "dinov2-g14-reg",
                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="clip"):
        cli.main(argv + ["--embedder", "clip"])


def test_the_tiny_cell_through_the_harness(tmp_path, monkeypatch):
    """The cell's driver, reference and check at the tiny size on the
    CPU: sound, and failed by LayerScale left out; the driver's kernel
    groups are gone from the trace's once it is done. The suite's conftest
    loads JAX into this process, so the harness's guard against it, which
    the benchmark's own runs keep, is off here."""
    from portbench import harness
    from portbench.harness import Bench, run_cell
    from portbench.yardstick import trace

    monkeypatch.setattr(harness, "guard_imports", lambda: None)
    groups = trace.KERNEL_GROUPS

    with open(os.path.join(os.path.dirname(BENCH_ROOT),
                           "BENCHMARK.json")) as f:
        spec = json.load(f)
    root = pathlib.Path(tmp_path)
    for kind in ("configs", "limits", "traffic"):
        (root / kind).mkdir()
    (root / "configs" / "tiny-dino.json").write_text(json.dumps(
        tiny_cfg(embed_batch_size_per_device=4)))
    (root / "limits" / "tiny-dino.json").write_text(json.dumps(
        {"embedding_error": BF16_TOL}))
    with open(os.path.join(BENCH_ROOT, "traffic", "embed-dinov2.json")) as f:
        traffic = dict(json.load(f), checked_rows=6, reference_block=3)
    (root / "traffic" / "embed-dinov2.json").write_text(json.dumps(traffic))
    spec["workloads"].append({"name": "tiny-dino", "config": "tiny-dino",
                              "traffic": "embed-dinov2", "chips": 1,
                              "why": "tiny"})
    for metric in spec["end_to_end"]:
        if metric["name"] == "embed_images_per_s":
            metric["workloads"].append("tiny-dino")
    bench = Bench(spec, roots=(str(root), BENCH_ROOT))
    line = run_cell(bench, "tiny-dino", SEED, 0.05, False, "cpu",
                    time.perf_counter())
    assert line["correct"], line
    assert set(line["metrics"]) == {"embed_images_per_s", "setup_s"}
    assert trace.KERNEL_GROUPS == groups
    bad = run_cell(bench, "tiny-dino", SEED, 0.05, False, "cpu",
                   time.perf_counter(), fault="no_layer_scale")
    assert not bad["correct"]
    assert dataclasses.asdict(driver.variant(tiny_cfg()))["mlp"] == "swiglu"


@pytest.mark.parametrize("kernel", ["swiglu", "scale_add_ln"])
def test_kernel_groups_and_rooflines_while_the_driver_runs(kernel):
    """A trace groups the kernel's records (its CUDA name carries its tag)
    under its own group only between `add_groups` and `restore_groups`,
    and the roofline is its calls' bytes bound over the group's device
    time; a slice with fewer records than launches reads nothing."""
    from portbench.harness import RunRecord
    from portbench.yardstick import flops, trace

    label, mark = arith.GROUPS[kernel]
    name = f"void eltwise::{mark}Kernel<8>(...)"
    shape = (128 * 1374, 4096) if kernel == "swiglu" else (128 * 1374, 1536)
    bound = flops.bound_seconds(*arith.OPS_BYTES[kernel](*shape))
    events = [{"name": trace.WINDOW_MARK, "ph": "X", "ts": 0.0,
               "dur": 1e6, "cat": "user_annotation"}]
    events += [{"name": name, "ph": "X", "ts": 1000.0 * i,
                "dur": 1e6 * bound / 0.9, "cat": "kernel"} for i in range(2)]
    assert trace.summarize(events).group_records == {"other": 2}
    before = arith.add_groups()
    try:
        summary = trace.summarize(events)
    finally:
        arith.restore_groups(before)
    assert trace.KERNEL_GROUPS == before
    assert summary.group_records == {label: 2}
    run = RunRecord({}, {}, {}, {}, trace=summary,
                    calls={kernel: [(shape, 2)]})
    assert arith.roofline(run, kernel) == pytest.approx(90.0)
    run.calls = {kernel: [(shape, 3)]}
    assert arith.roofline(run, kernel) is None
