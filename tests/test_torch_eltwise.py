"""The one-pass element-wise kernels of the encoder layers' inference
forward (`kernels/eltwise.py`: LayerNorm, residual add + LayerNorm,
quick-GELU, SwiGLU, LayerScale'd add + LayerNorm). On the CPU: each plain
version is today's eager composition bit for bit, the wrappers dispatch a
CPU tensor to it, and `TransformerLayer` reaches the wrappers only where
its docstring says (a spy on the wrappers; a CPU bf16 activation takes
the card's path). On a GPU (``-m gpu``): each kernel against its plain
version at the main path's shapes, a ViT-L/14-336-shaped tower under
``inference_mode`` against the same tower under grad mode (launching
none of DINOv2's kernels), and DINOv2-g/14-shaped layers likewise.
"""

import pytest
import torch
import torch.nn.functional as F

from pigeon_tpu_torch.config import VisionConfig
from pigeon_tpu_torch.kernels import eltwise
from pigeon_tpu_torch.models import clip

DTYPES = [torch.bfloat16, torch.float32]
EPS = 1e-5
#: A small tower: D = 128 (two heads of 64, the narrowest K1 takes), 2
#: layers, 10 tokens.
TINY = VisionConfig(image_size=42, patch_size=14, hidden_size=128,
                    intermediate_size=512, num_layers=2, num_heads=2)


def operands(shape, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    d = shape[-1]
    x = (torch.randn(shape, generator=gen) * 3 + 1).to(dtype)
    a = torch.randn(shape, generator=gen).to(dtype)
    w = 1 + 0.5 * torch.randn(d, generator=gen)
    b = 0.5 * torch.randn(d, generator=gen)
    return x, a, w, b


def eager_layer_norm(x, w, b):
    """`models/clip.py::layer_norm` as the layers ran it before the
    kernels: f32 statistics, rounded back."""
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, EPS).to(x.dtype)


# ---------------------------------------------------------------------------
# The plain versions and the wrappers on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_are_todays_composition(dtype):
    x, a, w, b = operands((3, 17, 64), dtype)
    assert torch.equal(eltwise.layer_norm_reference(x, w, b, EPS),
                       eager_layer_norm(x, w, b))
    s, ln = eltwise.add_layer_norm_reference(x, a, w, b, EPS)
    assert torch.equal(s, x + a)
    assert torch.equal(ln, eager_layer_norm(x + a, w, b))
    assert torch.equal(eltwise.quick_gelu(x), x * torch.sigmoid(1.702 * x))
    layer = torch.nn.LayerNorm(64, eps=EPS)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(b)
    assert torch.equal(clip.layer_norm(layer, x), eager_layer_norm(x, w, b))


@pytest.mark.parametrize("dtype", DTYPES)
def test_wrappers_run_the_plain_versions_on_the_cpu(dtype):
    x, a, w, b = operands((2, 9, 32), dtype, seed=1)
    counts = (eltwise.layer_norm_bf16.launches,
              eltwise.add_layer_norm_bf16.launches,
              eltwise.quick_gelu_bf16.launches)
    assert torch.equal(eltwise.layer_norm_bf16(x, w, b, EPS),
                       eager_layer_norm(x, w, b))
    s, ln = eltwise.add_layer_norm_bf16(x, a, w, b, EPS)
    assert torch.equal(s, x + a) and torch.equal(
        ln, eager_layer_norm(x + a, w, b))
    assert torch.equal(eltwise.quick_gelu_bf16(x),
                       x * torch.sigmoid(1.702 * x))
    assert counts == (eltwise.layer_norm_bf16.launches,
                      eltwise.add_layer_norm_bf16.launches,
                      eltwise.quick_gelu_bf16.launches)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dinov2_plain_versions_are_the_eager_composition(dtype):
    """SwiGLU is ``silu(u1) * u2`` of the fc-in output's halves, and the
    LayerScale'd add casts gamma to the activation's dtype first, as the
    layers cast their parameters; the wrappers run them on the CPU."""
    x, a, w, b = operands((3, 17, 64), dtype, seed=2)
    gamma = torch.rand(64, generator=torch.Generator().manual_seed(3))
    u = torch.cat([x, a], -1)
    want = F.silu(x) * a
    assert torch.equal(eltwise.swiglu(u), want)
    s = x + a * gamma.to(dtype)
    assert torch.equal(eltwise.scale_add(x, a, gamma), s)
    got = eltwise.scale_add_layer_norm_reference(x, a, gamma, w, b, EPS)
    assert torch.equal(got[0], s)
    assert torch.equal(got[1], eager_layer_norm(s, w, b))
    counts = (eltwise.swiglu_bf16.launches,
              eltwise.scale_add_layer_norm_bf16.launches)
    assert torch.equal(eltwise.swiglu_bf16(u), want)
    got = eltwise.scale_add_layer_norm_bf16(x, a, gamma, w, b, EPS)
    assert torch.equal(got[0], s)
    assert torch.equal(got[1], eager_layer_norm(s, w, b))
    assert counts == (eltwise.swiglu_bf16.launches,
                      eltwise.scale_add_layer_norm_bf16.launches)


@pytest.mark.parametrize("call", ["layer_norm", "add_layer_norm",
                                  "quick_gelu", "swiglu", "scale_add"])
def test_wrappers_refuse_a_device_without_a_kernel(call):
    x = torch.empty(4, 16, dtype=torch.bfloat16, device="meta")
    w = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        if call == "layer_norm":
            eltwise.layer_norm_bf16(x, w, w, EPS)
        elif call == "add_layer_norm":
            eltwise.add_layer_norm_bf16(x, x, w, w, EPS)
        elif call == "swiglu":
            eltwise.swiglu_bf16(x)
        elif call == "scale_add":
            eltwise.scale_add_layer_norm_bf16(x, x, w, w, w, EPS)
        else:
            eltwise.quick_gelu_bf16(x)


def test_the_kernels_need_a_cuda_activation():
    """A CPU bf16 tower's inference forward takes the wrappers (the spy
    below counts the calls) and launches no kernel: the wrappers run their
    plain versions."""
    kernels = (eltwise.layer_norm_bf16, eltwise.add_layer_norm_bf16,
               eltwise.quick_gelu_bf16)
    before = [k.launches for k in kernels]
    tower, px = tiny_tower("fused"), pixels()
    with torch.inference_mode():
        tower(px)
    assert [k.launches for k in kernels] == before


# ---------------------------------------------------------------------------
# Where the layer reaches the kernels (a spy, the CPU standing in for the
# card)
# ---------------------------------------------------------------------------

#: Calls a layer makes of each wrapper on each route, grad mode off.
EXPECTED = {"fused": (1, 1, 1), "flash": (1, 1, 1), "fused_ln": (0, 1, 1),
            "plain": (0, 0, 0), "fused_mlp": (0, 0, 0), "block": (0, 0, 0)}
WRAPPERS = ("layer_norm_bf16", "add_layer_norm_bf16", "quick_gelu_bf16")


@pytest.fixture
def spy(monkeypatch):
    """Counts of the layer's calls of each wrapper. A CPU bf16 activation
    takes the card's path through the layer, and the wrappers run their
    plain versions on it."""
    calls = dict.fromkeys(WRAPPERS, 0)

    def counted(name):
        real = getattr(eltwise, name)

        def wrapper(*args):
            calls[name] += 1
            return real(*args)
        return wrapper

    for name in WRAPPERS:
        monkeypatch.setattr(clip, name, counted(name))
    return calls


def tiny_tower(route, config=TINY, quant=False):
    from pigeon_tpu_torch.models.super_guessr import init_weights

    torch.manual_seed(0)
    tower = clip.CLIPVisionTower(config, dtype=torch.bfloat16,
                                 attn_impl=route, quant=quant)
    return init_weights(tower, 3).eval()


def pixels(b=2, size=42):
    return torch.randn(b, size, size, 3,
                       generator=torch.Generator().manual_seed(5))


@pytest.mark.parametrize("route", clip.ATTN_IMPLS)
def test_inference_forward_reaches_the_kernels_on_their_routes(spy, route):
    tower, px = tiny_tower(route), pixels()
    with torch.inference_mode():
        got = tower(px)
    assert tuple(spy[n] for n in WRAPPERS) == tuple(
        TINY.num_layers * n for n in EXPECTED[route])
    want = tower(px)                                    # grad mode: eager
    assert all(spy[n] == TINY.num_layers * e
               for n, e in zip(WRAPPERS, EXPECTED[route]))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_a_gelu_layer_keeps_its_activation(spy):
    config = VisionConfig(image_size=42, patch_size=14, hidden_size=128,
                          intermediate_size=512, num_layers=2, num_heads=2,
                          hidden_act="gelu")
    tower, px = tiny_tower("fused", config), pixels()
    with torch.no_grad():
        got = tower(px)
    assert (spy["layer_norm_bf16"], spy["add_layer_norm_bf16"],
            spy["quick_gelu_bf16"]) == (2, 2, 0)
    for g, w in zip(got, tower(px)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("quant", ["dynamic", "static"])
def test_an_int8_layer_keeps_the_flax_layer_norm(spy, quant):
    layer = clip.TransformerLayer(TINY, "fused", quant=quant)
    x = torch.randn(2, 10, 128).bfloat16()
    with torch.no_grad():
        layer(x)
    assert not any(spy.values())


def test_a_masked_call_keeps_the_eager_chain(spy):
    from pigeon_tpu_torch.models.super_guessr import init_weights

    layer = init_weights(clip.TransformerLayer(TINY, "fused"), 1)
    x = torch.randn(2, 10, 128).bfloat16()
    with torch.no_grad():
        layer(x, mask=clip.causal_mask(10))
    assert not any(spy.values())


def test_an_f32_activation_keeps_the_eager_chain(spy):
    from pigeon_tpu_torch.models.super_guessr import init_weights

    layer = init_weights(clip.TransformerLayer(TINY, "fused"), 1)
    with torch.no_grad():
        layer(torch.randn(2, 10, 128))
    assert not any(spy.values())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

#: Rows of (batch x tokens): the ViT-L/14-336 sweep (512 x 577) and
#: training (32 x 577) batches, the ViT-B/32 sweep (512 x 50), ragged
#: counts; and widths past 1024 and below a warp's 256 columns.
ROW_CASES = [(512 * 577, 1024), (32 * 577, 1024), (512 * 50, 768),
             (4 * 577 + 3, 1024), (77, 1280), (13, 2048), (29, 136)]
#: quick-GELU: ViT-L's and ViT-B's hiddens at the sweeps' batches, a
#: serving batch, and an element count that is not a multiple of 8.
GELU_CASES = [(512 * 577, 4096), (32 * 577, 4096), (512 * 50, 3072),
              (8 * 577, 4096), (101, 37)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def cuda_operands(rows, d, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed + rows + d)
    x = (torch.randn(rows, d, generator=gen, device="cuda") * 3 + 1) \
        .bfloat16()
    a = torch.randn(rows, d, generator=gen, device="cuda").bfloat16()
    w = 1 + 0.5 * torch.randn(d, generator=gen, device="cuda")
    b = 0.5 * torch.randn(d, generator=gen, device="cuda")
    return x, a, w, b


def ulps_apart(got, want):
    """The distance of two bf16 tensors in units in the last place (bf16
    bit patterns mapped to ordered integers)."""
    def ordered(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(got) - ordered(want)).abs()


def ln_within_one_ulp(got, x, w, b):
    """Whether a bf16 LayerNorm output lies within one bf16 ulp of the
    plain version's, give or take four f32 ulps of the terms that the f32
    arithmetic ``w * rstd * (x - mean) + b`` adds, ``|w| rstd (|x| +
    mean|x|) + |b|``. The kernel's two-pass statistics and PyTorch's
    Welford ones differ by about an f32 ulp of those terms (1.63 at most
    on the card over the shapes below, four seeds each). Where ``x - mean``
    or ``+ b`` cancels, that is many bf16 ulps of a near-zero output, and
    the plain version is as far from the f64 result there as the kernel."""
    want = eltwise.layer_norm_reference(x, w, b, EPS).float()
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xf - mean) ** 2).mean(-1, keepdim=True) + EPS)
    terms = w.abs() * rstd * (xf.abs() + xf.abs().mean(-1, keepdim=True)) \
        + b.abs()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs())) - 7)
    return bool(((got.float() - want).abs() <= ulp + terms * 2.0**-22).all())


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d", ROW_CASES)
def test_cuda_layer_norm_matches_plain_version(cuda, rows, d):
    x, _, w, b = cuda_operands(rows, d)
    before = eltwise.layer_norm_bf16.launches
    got = eltwise.layer_norm_bf16(x, w, b, EPS)
    torch.cuda.synchronize()
    assert eltwise.layer_norm_bf16.launches == before + 1
    assert ln_within_one_ulp(got, x, w, b)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d", ROW_CASES)
def test_cuda_add_layer_norm_matches_plain_version(cuda, rows, d):
    x, a, w, b = cuda_operands(rows, d, seed=1)
    before = eltwise.add_layer_norm_bf16.launches
    s, ln = eltwise.add_layer_norm_bf16(x, a, w, b, EPS)
    torch.cuda.synchronize()
    assert eltwise.add_layer_norm_bf16.launches == before + 1
    assert torch.equal(s, x + a)
    assert ln_within_one_ulp(ln, s, w, b)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,inter", GELU_CASES)
def test_cuda_quick_gelu_matches_plain_version(cuda, rows, inter):
    gen = torch.Generator(device="cuda").manual_seed(rows + inter)
    x = (torch.randn(rows, inter, generator=gen, device="cuda") * 4) \
        .bfloat16()
    before = eltwise.quick_gelu_bf16.launches
    got = eltwise.quick_gelu_bf16(x)
    torch.cuda.synchronize()
    assert eltwise.quick_gelu_bf16.launches == before + 1
    assert ulps_apart(got, eltwise.quick_gelu(x)).max().item() <= 1


def seeded_tower(route, device, layers=24, seed=0):
    """A ViT-L/14-336-shaped tower on the card with seeded weights: the
    products N(0, 1/fan_in), LayerNorm scales 1 + N(0, 0.02^2), the
    rest N(0, 0.02^2)."""
    with torch.device(device):
        tower = clip.CLIPVisionTower(VisionConfig(num_layers=layers),
                                     dtype=torch.bfloat16, attn_impl=route)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in tower.named_parameters():
            noise = torch.randn(p.shape, generator=gen, device=device)
            if p.dim() == 2 and "embed" not in name:
                p.copy_(noise * p.shape[1] ** -0.5)
            elif p.dim() == 2:                  # patch embed, positions
                p.copy_(noise * (p.shape[1] ** -0.5
                                 if name.startswith("patch") else 0.02))
            elif "ln" in name and name.endswith("weight"):
                p.copy_(1 + 0.02 * noise)
            else:
                p.copy_(0.02 * noise)
    return tower.eval()


@pytest.mark.gpu
@pytest.mark.parametrize("route", clip.ELTWISE_IMPLS)
def test_cuda_inference_tower_matches_the_eager_tower(cuda, route):
    """24 layers of ViT-L/14-336 on two images: the inference forward
    (the kernels) against the grad-mode forward (the eager chain), each
    image's token-mean embedding within the benchmark's embedding limit
    (0.012 relative), one launch a layer of each kernel the route takes,
    none under grad mode."""
    tower = seeded_tower(route, cuda)
    px = torch.randn(2, 336, 336, 3, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(7))
    kernels = (eltwise.layer_norm_bf16, eltwise.add_layer_norm_bf16,
               eltwise.quick_gelu_bf16)
    before = [k.launches for k in kernels]
    with torch.inference_mode():
        got, _ = tower(px)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(kernels, before)] == [
        24 * e for e in EXPECTED[route]]
    before = [k.launches for k in kernels]
    want, _ = tower(px)
    assert [k.launches for k in kernels] == before
    got, want = got.float().mean(1), want.detach().float().mean(1)
    err = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
    assert err < 0.012


#: SwiGLU: (rows, I) of DINOv2-g/14's sweep batch (128 x 1,374 tokens,
#: I = 4096) and of one image, a tiny width (344) and the narrowest one.
SWIGLU_CASES = [(128 * 1374, 4096), (1374, 4096), (77, 344), (13, 8)]
#: The LayerScale'd add + LN: DINOv2-g/14's width at the sweep batch and
#: one image, and the ragged widths of `ROW_CASES`.
SCALE_ADD_CASES = [(128 * 1374, 1536), (1374, 1536), (77, 1280), (13, 2048),
                   (29, 136)]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,inter", SWIGLU_CASES)
def test_cuda_swiglu_matches_plain_version(cuda, rows, inter):
    """Bit for bit: silu in f32 as PyTorch's CUDA kernel computes it,
    rounded to bf16, then the product rounded once."""
    gen = torch.Generator(device="cuda").manual_seed(rows + inter)
    u = (torch.randn(rows, 2 * inter, generator=gen, device="cuda") * 4) \
        .bfloat16()
    before = eltwise.swiglu_bf16.launches
    got = eltwise.swiglu_bf16(u)
    torch.cuda.synchronize()
    assert eltwise.swiglu_bf16.launches == before + 1
    assert got.shape == (rows, inter)
    assert torch.equal(got, eltwise.swiglu(u))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d", SCALE_ADD_CASES)
def test_cuda_scale_add_layer_norm_matches_plain_version(cuda, rows, d):
    """The sum bit for bit (gamma rounded to bf16, the product and the sum
    each rounded once), LN within `ln_within_one_ulp`."""
    x, a, w, b = cuda_operands(rows, d, seed=2)
    gamma = 0.05 + 0.95 * torch.rand(d, device="cuda", generator=torch
                                     .Generator(device="cuda").manual_seed(d))
    before = eltwise.scale_add_layer_norm_bf16.launches
    s, ln = eltwise.scale_add_layer_norm_bf16(x, a, gamma, w, b, EPS)
    torch.cuda.synchronize()
    assert eltwise.scale_add_layer_norm_bf16.launches == before + 1
    assert torch.equal(s, eltwise.scale_add(x, a, gamma))
    assert ln_within_one_ulp(ln, s, w, b)


def dinov2_launches():
    return (eltwise.swiglu_bf16.launches,
            eltwise.scale_add_layer_norm_bf16.launches)


@pytest.mark.gpu
def test_cuda_clip_forward_launches_none_of_dinov2s_kernels(cuda):
    """A ViT-L/14-336 forward on the sweep's route launches what it did
    before the DINOv2 kernels: 24 each of LN, add + LN and quick-GELU, 24
    of K1, and no SwiGLU or LayerScale'd add."""
    from pigeon_tpu_torch.kernels import fused_qkv_attention as k1

    tower = seeded_tower("fused", cuda)
    px = torch.randn(2, 336, 336, 3, device=cuda)
    kernels = (eltwise.layer_norm_bf16, eltwise.add_layer_norm_bf16,
               eltwise.quick_gelu_bf16, k1.fused_qkv_attention)
    before, new = [k.launches for k in kernels], dinov2_launches()
    with torch.inference_mode():
        tower(px)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(kernels, before)] == [24] * 4
    assert dinov2_launches() == new


def seeded_dinov2(device, layers, seed=0):
    """A DINOv2-g/14-shaped tower (518 px, width 1536, 24 heads, SwiGLU
    4096, 4 registers) of ``layers`` layers on the card, with seeded
    weights as `seeded_tower`'s and LayerScale uniform in 0.05-1."""
    import dataclasses

    from pigeon_tpu_torch.config import dinov2_g14_reg_vision, dinov2_variant
    from pigeon_tpu_torch.models.vit_embedder import ViTEmbedder

    config = dataclasses.replace(dinov2_g14_reg_vision(), num_layers=layers)
    with torch.device(device):
        model = ViTEmbedder(config, dtype=torch.bfloat16,
                            variant=dinov2_variant())
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen, device=device)
            if name.endswith(("gamma1", "gamma2")):
                p.copy_(0.05 + 0.95 * torch.rand(p.shape, generator=gen,
                                                 device=device))
            elif p.dim() == 2 and name not in ("pos_embed",
                                               "register_tokens"):
                p.copy_(noise * p.shape[1] ** -0.5)
            elif name.startswith(("encoder", "final_ln")) and "ln" in name \
                    and name.endswith("weight"):
                p.copy_(1 + 0.02 * noise)
            else:
                p.copy_(0.02 * noise)
    return model.eval()


@pytest.mark.gpu
def test_cuda_dinov2_layers_match_the_eager_layers(cuda):
    """Four DINOv2-g/14 layers on two 518-px images: the inference forward
    (K1, one LN, two LayerScale'd add + LN and one SwiGLU a layer) and the
    grad-mode forward (the eager chain), each against the same tower in
    float32 on the plain route. The kernels round where the eager chain
    rounds but for LN's 1 ulp on ~0.003% of elements, which compounds
    over the layers as any bf16 rounding does: the kernels' CLS
    embeddings may sit no further from float32 than 1.5 times the eager
    chain's, and within the benchmark cell's limit on 40 layers
    (`portbench/limits/pigeon-dinov2g-embed-b128.json`)."""
    import json
    import os

    from pigeon_tpu_torch.kernels import fused_qkv_attention as k1

    model = seeded_dinov2(cuda, layers=4)
    px = torch.randn(2, 518, 518, 3, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(7))
    before = (eltwise.layer_norm_bf16.launches, *dinov2_launches(),
              k1.fused_qkv_attention.launches,
              eltwise.add_layer_norm_bf16.launches,
              eltwise.quick_gelu_bf16.launches)
    with torch.inference_mode():
        got = model(px)
    torch.cuda.synchronize()
    after = (eltwise.layer_norm_bf16.launches, *dinov2_launches(),
             k1.fused_qkv_attention.launches,
             eltwise.add_layer_norm_bf16.launches,
             eltwise.quick_gelu_bf16.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 4, 8, 4, 0, 0]
    eager = model(px).detach()
    clip.set_route(model, "plain")
    model.dtype = torch.float32
    with torch.no_grad():
        want = model(px)

    def err(a):
        return ((a - want).norm(dim=-1) / want.norm(dim=-1)).max().item()

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "portbench", "limits", "pigeon-dinov2g-embed-b128.json")
    with open(path) as f:
        limit = json.load(f)["embedding_error"]
    assert err(got) <= 1.5 * err(eager)
    assert err(got) < limit
