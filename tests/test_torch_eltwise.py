"""The one-pass element-wise kernels of the encoder layers
(`kernels/eltwise.py`: LayerNorm, residual add + LayerNorm, quick-GELU,
SwiGLU, LayerScale'd add + LayerNorm) and the backwards of the first
three. On the CPU: each plain version is the eager composition bit for
bit, each backward's plain version is autograd's gradient of it bit for
bit, the wrappers dispatch a CPU tensor to them, and `TransformerLayer`
and the tower's pre-LN reach the wrappers, and under grad mode their
autograd versions, only where their docstrings say (a spy; a CPU bf16
activation takes the card's path), the remat recompute included. On a
GPU (``-m gpu``): each kernel against its plain version at the main
path's shapes, a ViT-L/14-336-shaped tower under ``inference_mode``
against the eager chain (launching none of DINOv2's kernels), a
ViT-L-wide tower's gradients against the eager chain's, and
DINOv2-g/14-shaped layers likewise.
"""

import types

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

#: Calls a layer makes of each wrapper on each route, grad mode off; the
#: tower's pre-LN adds one `layer_norm_bf16` on the routes that have any.
EXPECTED = {"fused": (1, 1, 1), "flash": (1, 1, 1), "fused_ln": (0, 1, 1),
            "plain": (0, 0, 0), "fused_mlp": (0, 0, 0), "block": (0, 0, 0)}
WRAPPERS = ("layer_norm_bf16", "add_layer_norm_bf16", "quick_gelu_bf16")
#: The eager chain each wrapper stands for (its plain version).
PLAIN = {"layer_norm_bf16": eltwise.layer_norm_reference,
         "add_layer_norm_bf16": eltwise.add_layer_norm_reference,
         "quick_gelu_bf16": eltwise.quick_gelu}
#: The autograd versions, and the eager compositions autograd
#: differentiates in their place.
FUNCTIONS = {"LayerNormBF16": eltwise.layer_norm_reference,
             "AddLayerNormBF16": eltwise.add_layer_norm_reference,
             "QuickGeluBF16": eltwise.quick_gelu}


def tower_calls(route, layers=TINY.num_layers):
    """Wrapper calls of a tower's inference forward on ``route``."""
    pre_ln = int(route in clip.ELTWISE_IMPLS)
    return (layers * EXPECTED[route][0] + pre_ln,
            *(layers * n for n in EXPECTED[route][1:]))


def eager_chain(monkeypatch):
    """Route the layers' and the pre-LN's calls of the wrappers and of
    their autograd versions to the eager compositions."""
    for name, fn in PLAIN.items():
        monkeypatch.setattr(clip, name, fn)
    for name, fn in FUNCTIONS.items():
        monkeypatch.setattr(clip, name, types.SimpleNamespace(apply=fn))


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
def test_inference_forward_reaches_the_kernels_on_their_routes(
        spy, monkeypatch, route):
    tower, px = tiny_tower(route), pixels()
    with torch.inference_mode():
        got = tower(px)
    assert tuple(spy[n] for n in WRAPPERS) == tower_calls(route)
    eager_chain(monkeypatch)
    with torch.inference_mode():
        want = tower(px)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_a_gelu_layer_keeps_its_activation(spy, monkeypatch):
    config = VisionConfig(image_size=42, patch_size=14, hidden_size=128,
                          intermediate_size=512, num_layers=2, num_heads=2,
                          hidden_act="gelu")
    tower, px = tiny_tower("fused", config), pixels()
    with torch.no_grad():
        got = tower(px)
    assert (spy["layer_norm_bf16"], spy["add_layer_norm_bf16"],
            spy["quick_gelu_bf16"]) == (3, 2, 0)
    eager_chain(monkeypatch)
    with torch.no_grad():
        want = tower(px)
    for g, w in zip(got, want):
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
# The backwards and the autograd versions on the CPU
# ---------------------------------------------------------------------------

def leaves(*tensors, trains=True):
    """Copies of the activations (which take gradients) and of the
    LayerNorm parameters (which do where ``trains``)."""
    *acts, w, b = (t.detach().clone() for t in tensors)
    return ([t.requires_grad_() for t in acts]
            + [t.requires_grad_(trains) for t in (w, b)])


def grads_of(*tensors):
    return [t.grad for t in tensors]


@pytest.mark.parametrize("trains", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm_backward_plain_version_is_autograds(dtype, trains):
    """`layer_norm_backward_reference` on the statistics of
    `layer_norm_stats_reference`, and `LayerNormBF16`, give autograd's
    gradient of the eager LayerNorm bit for bit; the parameters'
    gradients only where they train."""
    x, _, w, b = operands((3, 17, 64), dtype, seed=4)
    dy = torch.randn(3, 17, 64, generator=torch.Generator().manual_seed(9)) \
        .to(dtype)
    x, w, b = leaves(x, w, b, trains=trains)
    eltwise.layer_norm_reference(x, w, b, EPS).backward(dy)
    out, stats = eltwise.layer_norm_stats_reference(x.detach(), w.detach(),
                                                    b.detach(), EPS)
    assert torch.equal(out, eltwise.layer_norm_reference(x, w, b, EPS))
    assert stats.shape == (2, 51) and stats.dtype == torch.float32
    dx, dw, db = eltwise.layer_norm_backward_reference(
        x.detach(), dy, w.detach(), b.detach(), stats, trains)
    assert torch.equal(dx, x.grad) and dx.dtype == dtype
    if trains:
        assert torch.equal(dw, w.grad) and torch.equal(db, b.grad)
    else:
        assert dw is None and db is None and w.grad is None
    fn = leaves(x, w, b, trains=trains)
    got = eltwise.LayerNormBF16.apply(*fn, EPS)
    got.backward(dy)
    assert torch.equal(got, out)
    for g, w_ in zip(grads_of(*fn), grads_of(x, w, b)):
        assert (g is None and w_ is None) or torch.equal(g, w_)


@pytest.mark.parametrize("used", ["both", "sum", "norm"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_add_layer_norm_backward_plain_version_is_autograds(dtype, used):
    """Both addends take ``ds + LN'(s) dh``, the LN gradient rounded
    first, as autograd sums them; with one output unused, the other's
    gradient alone."""
    x, a, w, b = operands((2, 9, 64), dtype, seed=5)
    gen = torch.Generator().manual_seed(10)
    ds, dh = (torch.randn(2, 9, 64, generator=gen).to(dtype)
              for _ in range(2))
    x, a, w, b = leaves(x, a, w, b)
    s, h = eltwise.add_layer_norm_reference(x, a, w, b, EPS)
    outs = {"both": ([s, h], [ds, dh]), "sum": ([s], [ds]),
            "norm": ([h], [dh])}[used]
    torch.autograd.backward(*outs)
    want = grads_of(x, a, w, b)
    args = [t.detach() for t in (x, a, w, b)]
    got_leaves = leaves(*args)
    s2, h2 = eltwise.AddLayerNormBF16.apply(*got_leaves, EPS)
    outs = {"both": ([s2, h2], [ds, dh]), "sum": ([s2], [ds]),
            "norm": ([h2], [dh])}[used]
    torch.autograd.backward(*outs)
    assert torch.equal(s2, s) and torch.equal(h2, h)
    for g, w_ in zip(grads_of(*got_leaves), want):
        assert (g is None and w_ is None) or torch.equal(g, w_)
    if used == "both":
        stats = eltwise.layer_norm_stats_reference(s.detach(), *args[2:],
                                                   EPS)[1]
        dx, dw, db = eltwise.add_layer_norm_backward_reference(
            s.detach(), ds, dh, *args[2:], stats, True)
        assert torch.equal(dx, want[0]) and torch.equal(dx, want[1])
        assert torch.equal(dw, want[2]) and torch.equal(db, want[3])


@pytest.mark.parametrize("dtype", DTYPES)
def test_quick_gelu_backward_plain_version_is_autograds(dtype):
    gen = torch.Generator().manual_seed(11)
    u = (torch.randn(5, 37, generator=gen) * 4).to(dtype).requires_grad_()
    dy = torch.randn(5, 37, generator=gen).to(dtype)
    eltwise.quick_gelu(u).backward(dy)
    assert torch.equal(
        eltwise.quick_gelu_backward_reference(u.detach(), dy), u.grad)
    v = u.detach().clone().requires_grad_()
    out = eltwise.QuickGeluBF16.apply(v)
    out.backward(dy)
    assert torch.equal(out, eltwise.quick_gelu(u))
    assert torch.equal(v.grad, u.grad)


def test_backward_wrappers_run_the_plain_versions_on_the_cpu():
    x, a, w, b = operands((2, 9, 32), torch.bfloat16, seed=7)
    dy = torch.randn(2, 9, 32, generator=torch.Generator().manual_seed(13)) \
        .bfloat16()
    names = ("layer_norm_bwd_bf16", "add_layer_norm_bwd_bf16",
             "quick_gelu_bwd_bf16")
    counts = [getattr(eltwise, n).launches for n in names]
    stats = torch.empty(2, 18)
    out = eltwise.layer_norm_bf16(x, w, b, EPS, stats)
    want_out, want_stats = eltwise.layer_norm_stats_reference(x, w, b, EPS)
    assert torch.equal(out, want_out) and torch.equal(stats, want_stats)
    s, h = eltwise.add_layer_norm_bf16(x, a, w, b, EPS, stats)
    assert torch.equal(stats, eltwise.layer_norm_stats_reference(
        x + a, w, b, EPS)[1])
    got = eltwise.layer_norm_bwd_bf16(x, dy, w, b, want_stats, True)
    for g, r in zip(got, eltwise.layer_norm_backward_reference(
            x, dy, w, b, want_stats, True)):
        assert torch.equal(g, r)
    got = eltwise.add_layer_norm_bwd_bf16(s, a, dy, w, b, stats, False)
    want = eltwise.add_layer_norm_backward_reference(s, a, dy, w, b, stats,
                                                     False)
    assert torch.equal(got[0], want[0]) and got[1:] == (None, None)
    assert torch.equal(eltwise.quick_gelu_bwd_bf16(x, dy),
                       eltwise.quick_gelu_backward_reference(x, dy))
    assert counts == [getattr(eltwise, n).launches for n in names]


def test_the_forward_ops_are_registered_for_the_remat_policy():
    """The remat policy sees the forwards as ``pigeon`` operators, and
    recomputes them (no checkpoint name is theirs)."""
    from torch.utils.checkpoint import CheckpointPolicy

    for op in (eltwise.LAYER_NORM_OP, eltwise.ADD_LAYER_NORM_OP,
               eltwise.QUICK_GELU_OP):
        assert op.namespace == "pigeon"
        assert clip._remat_policy(("attn_out", "attn_kernel_out"), None,
                                  op) == CheckpointPolicy.PREFER_RECOMPUTE
    x, a, w, b = operands((3, 16), torch.bfloat16, seed=8)
    out, stats = eltwise.LAYER_NORM_OP(x, w, b, EPS)
    assert torch.equal(out, eltwise.layer_norm_reference(x, w, b, EPS))
    s, h, stats2 = eltwise.ADD_LAYER_NORM_OP(x, a, w, b, EPS)
    assert torch.equal(h, eltwise.layer_norm_reference(x + a, w, b, EPS))
    assert torch.equal(eltwise.QUICK_GELU_OP(x), eltwise.quick_gelu(x))


#: Calls of each autograd version a layer makes under grad mode, by
#: route: LN1 where no kernel folds it in, add + LN2, quick-GELU.
TRAINING = {"fused": (1, 1, 1), "flash": (1, 1, 1), "fused_ln": (0, 1, 1),
            "plain": (0, 0, 0), "fused_mlp": (0, 0, 0), "block": (0, 0, 0)}


@pytest.fixture
def grad_spy(monkeypatch):
    """Counts of the calls of each autograd version (and of each inference
    wrapper, which grad mode must not reach) from `models/clip.py`."""
    calls = dict.fromkeys((*FUNCTIONS, *WRAPPERS), 0)

    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    for name in FUNCTIONS:
        fn = getattr(eltwise, name)
        monkeypatch.setattr(clip, name, types.SimpleNamespace(
            apply=counted(name, fn.apply)))
    for name in WRAPPERS:
        monkeypatch.setattr(clip, name, counted(name, getattr(eltwise,
                                                              name)))
    return calls


def train_tower(route, config=TINY, remat="none", quant=False):
    """A bf16 tower with every layer but the last frozen, as finetune
    trains it, and the trained leaves' gradients of one loss."""
    tower = tiny_tower(route, config, quant)
    tower.encoder.remat = remat
    for layer in tower.encoder.layers[:-1]:
        layer.requires_grad_(False)
    hidden, _ = tower(pixels())
    hidden.float().square().mean().backward()
    return hidden, {n: p.grad for n, p in tower.named_parameters()
                    if p.grad is not None}


@pytest.mark.parametrize("remat", ["none", "attn_kernel"])
@pytest.mark.parametrize("route", clip.ATTN_IMPLS)
def test_training_reaches_the_autograd_versions_on_their_routes(
        grad_spy, monkeypatch, route, remat):
    """A quick-GELU tower under grad mode takes the autograd versions
    where the inference forward takes the kernels (the pre-LN too), and
    its gradients are the eager chain's bit for bit (the CPU runs the
    plain versions)."""
    hidden, got = train_tower(route, remat=remat)
    pre_ln = int(route in clip.ELTWISE_IMPLS)
    runs = 2 if remat == "attn_kernel" else 1     # the recompute's too
    want = [runs * TINY.num_layers * n for n in TRAINING[route]]
    want[0] += pre_ln
    assert [grad_spy[n] for n in FUNCTIONS] == want
    assert not any(grad_spy[n] for n in WRAPPERS)
    eager_chain(monkeypatch)
    want_hidden, want = train_tower(route, remat=remat)
    assert torch.equal(hidden, want_hidden) and sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("case", ["gelu", "dynamic", "static", "masked",
                                  "f32", "layer_scale", "swiglu"])
def test_training_keeps_the_eager_chain_where_no_backward_fits(grad_spy,
                                                                case):
    """Under grad mode a ``gelu`` layer keeps its activation (its LNs
    take the autograd versions), and an int8 layer, a masked call, an f32
    activation and a DINOv2 layer (SwiGLU, LayerScale) keep the whole
    eager chain."""
    from pigeon_tpu_torch.models.super_guessr import init_weights

    x = torch.randn(2, 10, 128).bfloat16().requires_grad_()
    if case == "gelu":
        config = VisionConfig(image_size=42, patch_size=14, hidden_size=128,
                              intermediate_size=512, num_layers=2,
                              num_heads=2, hidden_act="gelu")
        layer = init_weights(clip.TransformerLayer(config, "fused"), 1)
    elif case in ("dynamic", "static"):
        layer = clip.TransformerLayer(TINY, "fused", quant=case)
        init_weights(layer, 1)
    else:
        layer = init_weights(clip.TransformerLayer(
            TINY, "fused", swiglu=case == "swiglu",
            layer_scale=case in ("layer_scale", "swiglu")), 1)
    if case == "f32":
        x = torch.randn(2, 10, 128, requires_grad=True)
    mask = clip.causal_mask(10) if case == "masked" else None
    layer(x, mask).float().sum().backward()
    assert x.grad is not None
    want = (1, 1, 0) if case == "gelu" else (0, 0, 0)
    assert tuple(grad_spy[n] for n in FUNCTIONS) == want
    assert not any(grad_spy[n] for n in WRAPPERS)


def test_an_int8_tower_keeps_the_eager_pre_ln(spy):
    tower, px = tiny_tower("fused", quant="static"), pixels()
    with torch.no_grad():
        tower.embed(px)
    assert not any(spy.values())


@pytest.mark.parametrize("remat", ["none", "attn_kernel"])
def test_remat_recompute_launches_the_forward_ops(monkeypatch, remat):
    """Under ``attn_kernel`` a layer's backward runs the forward ops again
    in the recompute (the registered operators, through the wrappers) and
    no eager LayerNorm or quick-GELU; the backwards run once a layer (the
    pre-LN's LayerNorm too), as in a finetune step at full width."""
    names = (*WRAPPERS, "layer_norm_bwd_bf16", "add_layer_norm_bwd_bf16",
             "quick_gelu_bwd_bf16")
    calls = dict.fromkeys((*names, "eager"), 0)

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in names:
        monkeypatch.setattr(eltwise, name, counted(name,
                                                   getattr(eltwise, name)))
    monkeypatch.setattr(clip, "layer_norm", counted("eager", clip.layer_norm))
    monkeypatch.setitem(clip.ACTIVATIONS, "quick_gelu",
                        counted("eager", eltwise.quick_gelu))
    layers = TINY.num_layers
    tower = tiny_tower("fused")
    tower.encoder.remat = remat
    for layer in tower.encoder.layers[:-1]:
        layer.requires_grad_(False)
    hidden, _ = tower(pixels())               # the post-LN: one eager LN
    forward = dict(calls)
    assert forward == {**dict.fromkeys(names, 0), "eager": 1,
                       "layer_norm_bf16": layers + 1,
                       "add_layer_norm_bf16": layers,
                       "quick_gelu_bf16": layers}
    hidden.float().square().mean().backward()
    reruns = layers if remat == "attn_kernel" else 0
    assert {n: calls[n] - forward[n] for n in calls} == {
        "layer_norm_bf16": reruns, "add_layer_norm_bf16": reruns,
        "quick_gelu_bf16": reruns, "layer_norm_bwd_bf16": layers + 1,
        "add_layer_norm_bwd_bf16": layers, "quick_gelu_bwd_bf16": layers,
        "eager": 0}


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
def test_cuda_inference_tower_matches_the_eager_tower(cuda, monkeypatch,
                                                      route):
    """24 layers of ViT-L/14-336 on two images: the inference forward
    (the kernels) against the eager chain (the wrappers routed to their
    plain versions), each image's token-mean embedding within the
    benchmark's embedding limit (0.012 relative), one launch a layer of
    each kernel the route takes and one for the pre-LN, none on the eager
    chain."""
    tower = seeded_tower(route, cuda)
    px = torch.randn(2, 336, 336, 3, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(7))
    kernels = (eltwise.layer_norm_bf16, eltwise.add_layer_norm_bf16,
               eltwise.quick_gelu_bf16)
    before = [k.launches for k in kernels]
    with torch.inference_mode():
        got, _ = tower(px)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(kernels, before)] == list(
        tower_calls(route, 24))
    before = [k.launches for k in kernels]
    eager_chain(monkeypatch)
    with torch.inference_mode():
        want, _ = tower(px)
    assert [k.launches for k in kernels] == before
    got, want = got.float().mean(1), want.float().mean(1)
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
    before the DINOv2 kernels: 24 each of add + LN and quick-GELU, 24 of
    K1, 25 LN (the pre-LN's), and no SwiGLU or LayerScale'd add."""
    from pigeon_tpu_torch.kernels import fused_qkv_attention as k1

    tower = seeded_tower("fused", cuda)
    px = torch.randn(2, 336, 336, 3, device=cuda)
    kernels = (eltwise.layer_norm_bf16, eltwise.add_layer_norm_bf16,
               eltwise.quick_gelu_bf16, k1.fused_qkv_attention)
    before, new = [k.launches for k in kernels], dinov2_launches()
    with torch.inference_mode():
        tower(px)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(kernels, before)] == [
        25, 24, 24, 24]
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


# ---------------------------------------------------------------------------
# The backwards on the card
# ---------------------------------------------------------------------------

#: LayerNorm and add + LayerNorm backward: the ViT-L/14-336 sweep's rows,
#: a training batch's (32 views), ragged counts, the widest and a narrow
#: width.
BWD_ROW_CASES = [(512 * 577, 1024), (32 * 577, 1024), (4 * 577 + 3, 1024),
                 (13, 2048), (29, 136)]
#: quick-GELU backward: the finetune cell's fc1 output (512 views), a
#: training batch's, and an element count that is not a multiple of 8.
BWD_GELU_CASES = [(512 * 577, 4096), (32 * 577, 4096), (101, 37)]


def ulp(t):
    """One bf16 ulp of each element of ``t`` (0 at 0)."""
    return torch.exp2(torch.floor(torch.log2(t.float().abs())) - 7)


def ln_grad_slack(x, dy, w, stats):
    """How far the kernel's f32 input gradient may lie from the plain
    version's on the same statistics: both take ``rstd (g - mean(g) -
    x_hat mean(g x_hat))``, ``g = w dy``, with the two row sums added in
    other orders (each within (D - 1) f32 ulps of the sum of the terms'
    magnitudes) and a few rounded operations an element. Rounded to
    bf16, the two may then also fall one ulp apart."""
    d = x.shape[-1]
    mean, rstd = (t.view(*x.shape[:-1], 1) for t in stats)
    x_hat = (x.float() - mean) * rstd
    g = dy.float() * w
    terms = g.abs() + g.abs().mean(-1, keepdim=True) + x_hat.abs() * (
        g * x_hat).abs().mean(-1, keepdim=True)
    return (d + 8) * 2.0**-23 * rstd * terms


def param_grad_slack(x, dy, stats):
    """The LayerNorm's own gradients sum ``dy x_hat`` and ``dy`` over the
    rows in other orders than PyTorch's: 1e-4 of the sum of the terms'
    magnitudes, some 1,700 f32 ulps, above the depth of either order's
    summation tree (the kernel's: rows / 2,112 + 49 additions)."""
    mean, rstd = (t.view(*x.shape[:-1], 1) for t in stats)
    x_hat = (x.float() - mean) * rstd
    flat = x.shape[-1]
    return (1e-4 * (dy.float() * x_hat).abs().reshape(-1, flat).sum(0),
            1e-4 * dy.float().abs().reshape(-1, flat).sum(0))


def check_ln_backward(got, want, slack, inner=None):
    """The input gradient within `ln_grad_slack` plus one bf16 ulp (two
    where ``inner``, the LN part before the residual sum, rounds too)."""
    room = ulp(want) + slack + (0 if inner is None else ulp(inner))
    assert bool(((got.float() - want.float()).abs() <= room).all())


@pytest.mark.gpu
@pytest.mark.parametrize("trains", [True, False])
@pytest.mark.parametrize("rows,d", BWD_ROW_CASES)
def test_cuda_layer_norm_backward_matches_plain_version(cuda, rows, d,
                                                         trains):
    x, _, w, b = cuda_operands(rows, d, seed=3)
    dy = torch.randn(rows, d, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(d)).bfloat16()
    stats = torch.empty(2, rows, device=cuda)
    eltwise.layer_norm_bf16(x, w, b, EPS, stats)
    before = eltwise.layer_norm_bwd_bf16.launches
    dx, dw, db = eltwise.layer_norm_bwd_bf16(x, dy, w, b, stats, trains)
    torch.cuda.synchronize()
    assert eltwise.layer_norm_bwd_bf16.launches == before + 1
    want = eltwise.layer_norm_backward_reference(x, dy, w, b, stats, trains)
    check_ln_backward(dx, want[0], ln_grad_slack(x, dy, w, stats))
    if trains:
        for got_p, want_p, room in zip((dw, db), want[1:],
                                       param_grad_slack(x, dy, stats)):
            assert got_p.dtype == torch.float32
            assert bool(((got_p - want_p).abs() <= room).all())
        again = eltwise.layer_norm_bwd_bf16(x, dy, w, b, stats, True)
        assert all(torch.equal(p, q) for p, q in zip(again, (dx, dw, db)))
        frozen = eltwise.layer_norm_bwd_bf16(x, dy, w, b, stats, False)[0]
        assert torch.equal(frozen, dx)
    else:
        assert dw is None and db is None


@pytest.mark.gpu
@pytest.mark.parametrize("trains", [True, False])
@pytest.mark.parametrize("rows,d", BWD_ROW_CASES)
def test_cuda_add_layer_norm_backward_matches_plain_version(cuda, rows, d,
                                                             trains):
    x, a, w, b = cuda_operands(rows, d, seed=4)
    gen = torch.Generator(device=cuda).manual_seed(d + 1)
    ds, dh = (torch.randn(rows, d, device=cuda, generator=gen).bfloat16()
              for _ in range(2))
    stats = torch.empty(2, rows, device=cuda)
    s, _ = eltwise.add_layer_norm_bf16(x, a, w, b, EPS, stats)
    before = eltwise.add_layer_norm_bwd_bf16.launches
    dx, dw, db = eltwise.add_layer_norm_bwd_bf16(s, ds, dh, w, b, stats,
                                                 trains)
    torch.cuda.synchronize()
    assert eltwise.add_layer_norm_bwd_bf16.launches == before + 1
    want = eltwise.add_layer_norm_backward_reference(s, ds, dh, w, b, stats,
                                                     trains)
    inner = eltwise.layer_norm_backward_reference(s, dh, w, b, stats,
                                                  False)[0]
    check_ln_backward(dx, want[0], ln_grad_slack(s, dh, w, stats), inner)
    if trains:
        for got_p, want_p, room in zip((dw, db), want[1:],
                                       param_grad_slack(s, dh, stats)):
            assert bool(((got_p - want_p).abs() <= room).all())
    else:
        assert dw is None and db is None


@pytest.mark.gpu
@pytest.mark.parametrize("rows,inter", BWD_GELU_CASES)
def test_cuda_quick_gelu_backward_matches_plain_version(cuda, rows, inter):
    """Bit for bit: the forward's t and s again, then each product of
    autograd's chain rounded where PyTorch's CUDA kernels round it."""
    gen = torch.Generator(device="cuda").manual_seed(rows + inter + 1)
    u = (torch.randn(rows, inter, generator=gen, device="cuda") * 4) \
        .bfloat16()
    dy = torch.randn(rows, inter, generator=gen, device="cuda").bfloat16()
    before = eltwise.quick_gelu_bwd_bf16.launches
    got = eltwise.quick_gelu_bwd_bf16(u, dy)
    torch.cuda.synchronize()
    assert eltwise.quick_gelu_bwd_bf16.launches == before + 1
    assert torch.equal(got, eltwise.quick_gelu_backward_reference(u, dy))


def rel_errors(got: dict, want: dict) -> dict:
    return {k: ((got[k].float() - want[k].float()).norm()
                / want[k].float().norm()).item() for k in want}


def tower_grads(tower, px, probe):
    """The pixels' and every trained leaf's gradient of ``<probe,
    last_hidden>``."""
    px = px.clone().requires_grad_()
    hidden, _ = tower(px)
    (hidden.float() * probe).sum().backward()
    out = {n: p.grad for n, p in tower.named_parameters()
           if p.grad is not None}
    tower.zero_grad(set_to_none=True)
    return {"pixels": px.grad, **out}


@pytest.mark.gpu
@pytest.mark.parametrize("remat", ["none", "attn_kernel"])
def test_cuda_tower_gradients_match_the_eager_chain(cuda, monkeypatch,
                                                    remat):
    """Two ViT-L/14-336-wide layers on eight images, the first frozen as
    finetune freezes it: the launches a finetune step predicts (the
    forward ops again in ``attn_kernel``'s recompute, each backward once a
    layer, the pre-LN's too) and the pixels' and every trained leaf's
    gradient against the eager chain's: each no further from the float32
    tower's (the plain route) than 1.5 times the eager chain's, give or
    take 1e-3 of its norm."""
    tower = seeded_tower("fused", cuda, layers=2).train()
    tower.encoder.remat = remat
    tower.encoder.layers[0].requires_grad_(False)
    gen = torch.Generator(device=cuda).manual_seed(11)
    px = torch.randn(8, 336, 336, 3, device=cuda, generator=gen)
    probe = torch.randn(8, 577, 1024, device=cuda, generator=gen)
    kernels = (eltwise.layer_norm_bf16, eltwise.add_layer_norm_bf16,
               eltwise.quick_gelu_bf16, eltwise.layer_norm_bwd_bf16,
               eltwise.add_layer_norm_bwd_bf16, eltwise.quick_gelu_bwd_bf16)
    before = [k.launches for k in kernels]
    got = tower_grads(tower, px, probe)
    torch.cuda.synchronize()
    runs = 2 if remat == "attn_kernel" else 1
    assert [k.launches - n for k, n in zip(kernels, before)] == [
        2 * runs + 1, 2 * runs, 2 * runs, 3, 2, 2]
    with monkeypatch.context() as patch:
        eager_chain(patch)
        before = [k.launches for k in kernels]
        eager = tower_grads(tower, px, probe)
        assert [k.launches for k in kernels] == before
    clip.set_route(tower, "plain")
    tower.dtype = torch.float32
    want = tower_grads(tower, px, probe)
    assert sorted(got) == sorted(eager) == sorted(want)
    got_err, eager_err = rel_errors(got, want), rel_errors(eager, want)
    for name in want:
        assert got_err[name] <= 1.5 * eager_err[name] + 1e-3, (
            name, got_err[name], eager_err[name])
