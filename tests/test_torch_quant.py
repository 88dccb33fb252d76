"""Int8 serving of the PyTorch port against the JAX package, on the CPU:
per-channel weight quantization, the plain versions of kernels K3
(attention on separate q/k/v) and K8 (int8 fused QKV + attention) against
the JAX package's Pallas kernels in interpret mode, the bridge of a
quantized tree, calibration, the static and dynamic int8 towers, and the
int8 serving slice; on a GPU (``-m gpu``), K3 and K8 against their plain
versions. flax is imported inside the tests that need it: the GPU machine
has JAX but not flax."""

import contextlib
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pigeon_tpu.config import HeadConfig, VisionConfig
from pigeon_tpu_torch.kernels import attention as k3
from pigeon_tpu_torch.kernels import fused_qkv_attention_int8 as k8
from pigeon_tpu_torch.models import quant as tquant
from pigeon_tpu_torch.models.jax_bridge import state_dict_from_jax

#: The tiny tower of tests/test_quant.py.
TOWER = VisionConfig(image_size=32, patch_size=8, hidden_size=64,
                     intermediate_size=128, num_layers=3, num_heads=4,
                     projection_dim=32)
#: The slice's tower: 14 x 14 x 3 = 588 patch features, padded to 592.
SLICE = VisionConfig(image_size=42, patch_size=14, hidden_size=64,
                     intermediate_size=128, num_layers=2, num_heads=4)
HEAD = HeadConfig(num_cells=37, embed_dim=64, panorama=True,
                  multi_task=True, heading=True)
H = 4
#: The int8 bound (tests/test_flash_attention.py): max error, and the
#: share of elements allowed off by more than 5e-4 (requantize flips).
INT8_MAX, INT8_FLIP_TOL, INT8_FLIP_SHARE = 5e-2, 5e-4, 5e-3


@contextlib.contextmanager
def jax_interpret():
    """Pallas kernels as the JAX package's own tests run them on the CPU:
    interpret mode, two head groups."""
    from jax.experimental.pallas import tpu as pltpu

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIGEON_FUSED_GROUPS", "2")
        with pltpu.force_tpu_interpret_mode():
            yield


@pytest.fixture
def interpret_mode():
    with jax_interpret():
        yield


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def t(a, dtype=None):
    out = torch.from_numpy(np.array(a))        # a writable copy
    return out if dtype is None else out.to(dtype)


def assert_int8_close(got, want):
    """The int8 bound: max error and the share of flipped elements."""
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert err.max() < INT8_MAX, err.max()
    assert (err > INT8_FLIP_TOL).mean() < INT8_FLIP_SHARE, \
        (err > INT8_FLIP_TOL).mean()


def tower_state(params):
    """The port's tower state dict from a JAX tower tree."""
    state = state_dict_from_jax({"vision": params})
    return {k[len("vision."):]: v for k, v in state.items()}


# ---------------------------------------------------------------------------
# Quantization primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["dense", "zero_channel", "patch"])
def test_quantize_channelwise_matches_jax(case):
    from pigeon_tpu.models.quant import quantize_channelwise

    rng = np.random.default_rng(1)
    if case == "patch":
        w = rng.normal(size=(8, 8, 3, 16)).astype(np.float32)
        port_w = w.reshape(-1, 16).T                    # (D, P*P*C)
    else:
        w = rng.normal(size=(64, 32)).astype(np.float32)
        if case == "zero_channel":
            w[:, 5] = 0.0
        port_w = w.T                                    # Linear (out, in)
    want_q, want_s = quantize_channelwise(jnp.asarray(w), axis=-1)
    got_q, got_s = tquant.quantize_channelwise(t(port_w), axis=0)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy().T.reshape(w.shape),
                                  np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_zero_row_does_not_inflate_the_calibrated_scale():
    """ADVICE r2: the dynamic zero guard maps an all-zero row to scale
    1.0; the recorded amax is the true one, as the JAX layer sows."""
    import flax.linen  # noqa: F401  (pigeon_tpu.models.quant needs it)
    from pigeon_tpu.models.quant import QuantDense

    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, 64)).astype(np.float32) * 0.5
    x[3] = 0.0
    model = QuantDense(32, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    _, state = model.apply({"params": params}, jnp.asarray(x),
                           mutable=["intermediates"])
    sown = state["intermediates"]["act_amax"]
    sown = float(sown[0] if isinstance(sown, tuple) else sown)

    layer = tquant.QuantLinear(64, 32)
    layer(t(x))
    amax = float(layer.observed_amax)
    assert amax == pytest.approx(float(np.abs(x).max()), rel=1e-6)
    assert amax == pytest.approx(sown, rel=1e-6)
    assert amax < 127.0
    tquant.calibrate_act_scales(layer, t(x))
    assert layer.mode == "static"
    assert float(layer.act_scale) == pytest.approx(amax / 127.0, rel=1e-6)


def test_fc2_products_sum_exactly_in_int32():
    """At fc2's depth (K = 4096) a dot product of int8 values reaches
    127^2 * 4096 ~ 6.6e7 > 2^24: int32 sums it exactly, f32 does not."""
    k = 4096
    x_q = torch.full((2, k), 127, dtype=torch.int8)
    w = torch.full((8, k), 127, dtype=torch.int8)
    w[:, 0] = 126                          # an odd sum, above 2^24
    exact = 127 * 127 * (k - 1) + 127 * 126
    got = tquant.int8_matmul(x_q, w)
    assert got.dtype == torch.int32
    assert (got == exact).all()
    # No f32 lies on the exact sum (the spacing there is 8).
    assert (x_q.float() @ w.float().t())[0, 0].item() != exact
    # The layer dequantizes the exact sum: f32(sum) * (0.25 * 0.5).
    layer = tquant.QuantLinear(k, 8, bias=False, mode="static")
    layer.weight.copy_(w)
    layer.scale.fill_(0.5)
    layer.act_scale.fill_(0.25)
    y = layer(x_q.float() * 0.25)
    assert torch.equal(y, torch.full((2, 8), float(np.float32(exact))
                                     * 0.125))


# ---------------------------------------------------------------------------
# K3 and K8: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [10, 17, 33])
def test_attention_plain_version_matches_jax_mha(interpret_mode, s, dtype):
    from pigeon_tpu.kernels.flash_attention import mha

    rng = np.random.default_rng(s)
    qkv = [(rng.normal(size=(2, s, H, 32)) * 0.3).astype(np.float32)
           for _ in range(3)]
    jdt = jnp.dtype(dtype)
    want = np.asarray(mha(*(jnp.asarray(a, jdt) for a in qkv)), np.float32)
    got = k3.flash_attention_reference(
        *(t(a, getattr(torch, dtype)) for a in qkv))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, s, H, 32)
    # 2e-5 in f32 and 3e-2 in bf16: the repo's attention bounds
    # (tests/test_flash_attention.py); the sums run in another order.
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2e-5 if dtype == "float32" else 3e-2)


def int8_operands(s, d=64, b=2, seed=0):
    """x, act_scale and three (int8 kernel (D, P), scale, bias) packs
    quantized by the JAX package (tests/test_flash_attention.py)."""
    from pigeon_tpu.models.quant import quantize_channelwise

    rng = np.random.default_rng(seed + s)
    x = (rng.normal(size=(b, s, d)) * 0.5).astype(np.float32)
    packs = []
    for _ in range(3):
        w_q, scale = quantize_channelwise(jnp.asarray(
            (rng.normal(size=(d, d)) * 0.1).astype(np.float32)))
        packs.append((np.asarray(w_q), np.asarray(scale),
                      (rng.normal(size=(d,)) * 0.1).astype(np.float32)))
    return x, np.float32(np.abs(x).max() / 127.0), packs


def torch_int8_operands(x, packs):
    """The same operands in the port's layout: int8 Linear weights (P, D)."""
    return t(x), [a for w, s, b in packs for a in (t(w.T), t(s), t(b))]


@pytest.mark.parametrize("s", [10, 17, 33])
def test_int8_plain_version_matches_jax_fused_qkv_mha_int8(interpret_mode,
                                                           s):
    import flax.linen  # noqa: F401  (pigeon_tpu.models.quant needs it)
    from pigeon_tpu.kernels.flash_attention import fused_qkv_mha_int8

    x, act_scale, packs = int8_operands(s)
    want = np.asarray(fused_qkv_mha_int8(
        jnp.asarray(x), act_scale,
        *(jnp.asarray(a) for p in packs for a in p), H))
    tx, ops = torch_int8_operands(x, packs)
    got = k8.fused_qkv_attention_int8_reference(tx, torch.tensor(act_scale),
                                                *ops, H)
    # 5e-5: the JAX package's bound for this kernel in f32
    # (tests/test_flash_attention.py:633); q/k/v agree bit for bit, the
    # attention sums run in another order.
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


def test_cpu_tensors_run_the_plain_versions_without_counting():
    import flax.linen  # noqa: F401  (pigeon_tpu.models.quant needs it)

    x, act_scale, packs = int8_operands(17)
    tx, ops = torch_int8_operands(x, packs)
    before = (k3.flash_attention.launches,
              k8.fused_qkv_attention_int8.launches)
    got = k8.fused_qkv_attention_int8(tx, act_scale, *ops, H)
    torch.testing.assert_close(got, k8.fused_qkv_attention_int8_reference(
        tx, act_scale, *ops, H), rtol=0, atol=0)
    q = tx.view(2, 17, H, 16)
    torch.testing.assert_close(k3.flash_attention(q, q, q),
                               k3.flash_attention_reference(q, q, q),
                               rtol=0, atol=0)
    assert (k3.flash_attention.launches,
            k8.fused_qkv_attention_int8.launches) == before
    meta = torch.empty(1, 8, 1, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k3.flash_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="no kernel"):
        k8.fused_qkv_attention_int8(meta.view(1, 8, 64), 1.0,
                                    *(o.to("meta") for o in ops), 1)


@pytest.mark.parametrize("case, error, match", [
    ("ok", None, None), ("f32", TypeError, "dtype"),
    ("head_dim", ValueError, "head_dim"), ("too_long", ValueError, "outside"),
    ("strided", ValueError, "contiguous"), ("shape", ValueError, "shape")])
def test_attention_operand_checks(case, error, match):
    shape = [2, 17, 2, 64]
    if case == "head_dim":
        shape[-1] = 32
    elif case == "too_long":
        shape[1] = 641
    q = torch.zeros(shape, dtype=torch.bfloat16)
    k = v = q
    if case == "f32":
        k = q.float()
    elif case == "strided":
        v = torch.zeros(2, 2, 17, 64, dtype=torch.bfloat16).transpose(1, 2)
    elif case == "shape":
        v = q[:, :16]
    if error is None:
        k3._check_operands(q, k, v, max_seq=640)
    else:
        with pytest.raises(error, match=match):
            k3._check_operands(q, k, v, max_seq=640)


@pytest.mark.parametrize("case, error, match", [
    ("ok", None, None), ("x_f32", TypeError, "kernel writes bf16"),
    ("w_bf16", TypeError, "dtype"), ("scale_shape", ValueError, "shape"),
    ("ragged_d", ValueError, "D=96 .* multiples of 128"),
    ("strided", ValueError, "contiguous")])
def test_int8_operand_checks(case, error, match):
    d, heads, p = 128, 2, 128
    x = torch.zeros(2, 17, d, dtype=torch.bfloat16)
    ws = [torch.zeros(p, d, dtype=torch.int8) for _ in range(3)]
    scales = [torch.ones(p) for _ in range(3)]
    biases = [torch.zeros(p) for _ in range(3)]
    if case == "x_f32":
        x = x.float()
    elif case == "w_bf16":
        ws[2] = ws[2].bfloat16()
    elif case == "scale_shape":
        scales[1] = torch.ones(p + 1)
    elif case == "ragged_d":
        x = torch.zeros(2, 17, 96, dtype=torch.bfloat16)
    elif case == "strided":
        ws[0] = torch.zeros(d, p, dtype=torch.int8).t()
    x_q = torch.zeros(x.shape, dtype=torch.int8)
    if error is None:
        k8._check_operands(x, x_q, ws, scales, biases, heads)
    else:
        with pytest.raises(error, match=match):
            k8._check_operands(x, x_q, ws, scales, biases, heads)


def test_backward_through_k3_raises_naming_k4():
    """K3's backward is kernel K4: on the CPU its plain version, which
    equals autograd through K3's plain version, and never raises; the
    ``flash`` route of `MultiHeadAttention` trains through the pair. (The
    name is the one this test had when K3's backward still raised, naming
    K4 as missing; it is kept so that the test stays the same one.)"""
    from pigeon_tpu_torch.models.clip import MultiHeadAttention

    q = torch.randn(2, 9, H, 16, requires_grad=True)
    plain = q.detach().clone().requires_grad_()
    out = k3.FlashAttention.apply(q, q, q)
    assert out.grad_fn.name() == "FlashAttentionBackward"
    out.square().sum().backward()
    k3.flash_attention_reference(plain, plain, plain).square().sum() \
        .backward()
    # 1e-5 relative: the same products, the softmax's gradient taken in
    # the deferred-denominator form instead of autograd's.
    torch.testing.assert_close(q.grad, plain.grad, rtol=1e-5, atol=1e-5)
    mha = MultiHeadAttention(64, H, attn_impl="flash")
    mha(torch.randn(2, 9, 64)).sum().backward()
    assert all(p.grad is not None for p in mha.parameters())
    with torch.inference_mode():
        assert mha(torch.randn(2, 9, 64)).shape == (2, 9, 64)


# ---------------------------------------------------------------------------
# Bridge, calibration and the int8 towers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_tower():
    """f32 tiny-tower params, calibration pixels, and the JAX package's
    quantized + calibrated tree (dynamic forward through `mha`)."""
    import flax.linen  # noqa: F401
    from pigeon_tpu.models.clip import CLIPVisionTower
    from pigeon_tpu.models.quant import quantize_and_calibrate

    px = np.random.default_rng(5).normal(size=(3, 32, 32, 3)) \
        .astype(np.float32)
    params = jax.jit(CLIPVisionTower(TOWER).init)(
        jax.random.PRNGKey(1), jnp.asarray(px))["params"]
    with jax_interpret():
        dyn = CLIPVisionTower(TOWER, attn_impl="flash_fused", quant=True)
        qparams = quantize_and_calibrate(dyn, params, jnp.asarray(px),
                                         margin=1.1)
    return to_numpy(params), px, to_numpy(qparams)


def test_port_quantize_and_calibrate_matches_jax(jax_tower):
    """From the same bridged f32 weights: identical int8 weights and
    scales, activation scales within 1e-4 relative."""
    from pigeon_tpu_torch.models.clip import CLIPVisionTower

    params, px, qparams = jax_tower
    tower = CLIPVisionTower(TOWER, attn_impl="fused")
    tower.load_state_dict(tower_state(params), strict=True)
    before = k3.flash_attention.launches
    qtower = tquant.quantize_and_calibrate(tower, t(px), margin=1.1)
    assert k3.flash_attention.launches == before      # CPU: plain version
    want = tower_state(qparams)
    got = qtower.state_dict()
    assert got.keys() == want.keys()
    for name, value in want.items():
        if name.endswith("act_scale"):
            np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                       rtol=1e-4, err_msg=name)
        else:
            assert got[name].dtype == value.dtype, name
            np.testing.assert_array_equal(got[name].numpy(), value.numpy(),
                                          err_msg=name)
    assert all(m.mode == "static" for m in qtower.modules()
               if isinstance(m, tquant.QuantLinear))


@pytest.mark.parametrize("quant, jax_impl, torch_impl", [
    ("static", "flash_fused", "fused"), ("static", "flash", "flash"),
    ("static", "xla", "plain"), ("dynamic", "flash_fused", "fused"),
    ("static", "flash_fused_block", "block"),
    ("dynamic", "flash_fused_block", "block")])
def test_int8_tower_matches_jax(jax_tower, interpret_mode, quant, jax_impl,
                                torch_impl):
    """The JAX package's calibrated tree bridged into the port: the static
    towers (K8, K3, plain attention and K7) and the dynamic ones (K3)
    against JAX `CLIPVisionTower` on the same pixels, in f32."""
    from pigeon_tpu.models.clip import CLIPVisionTower
    from pigeon_tpu_torch.models.clip import CLIPVisionTower as TTower

    _, px, qparams = jax_tower
    pixels = np.random.default_rng(6).normal(size=(2, 32, 32, 3)) \
        .astype(np.float32)
    want_h, want_p = CLIPVisionTower(
        TOWER, attn_impl=jax_impl,
        quant=True if quant == "dynamic" else quant).apply(
        {"params": qparams}, jnp.asarray(pixels))
    tower = TTower(TOWER, attn_impl=torch_impl, quant=quant)
    tower.load_state_dict(tower_state(qparams), strict=True)
    with torch.inference_mode():
        hidden, pooled = tower(t(pixels))
    assert_int8_close(hidden.numpy(), want_h)
    assert_int8_close(pooled.numpy(), want_p)


@pytest.fixture(scope="module")
def jax_slice():
    """A JAX `SuperGuessr` at `SLICE` width, quantized and calibrated the
    way `cli serve --quant` does it (dynamic forward through `mha`)."""
    import flax.linen  # noqa: F401
    from pigeon_tpu.models.quant import quantize_and_calibrate
    from pigeon_tpu.models.super_guessr import SuperGuessr

    calib = np.random.default_rng(7).normal(size=(2, 4, 42, 42, 3)) \
        .astype(np.float32)
    params = SuperGuessr(SLICE, HEAD).init(
        jax.random.PRNGKey(5), jnp.zeros((1, 4, 42, 42, 3)))["params"]
    with jax_interpret():
        dyn = SuperGuessr(SLICE, HEAD, attn_impl="flash_fused", quant=True)
        qparams = quantize_and_calibrate(dyn, params, jnp.asarray(calib),
                                         tower_key="vision", margin=1.25)
    return to_numpy(qparams)


def test_bridge_carries_a_quantized_tree(jax_slice):
    from pigeon_tpu_torch.models.super_guessr import SuperGuessr

    state = state_dict_from_jax(jax_slice)
    model = SuperGuessr(SLICE, HEAD, quant="static")
    model.load_state_dict(state, strict=True)
    layers = jax_slice["vision"]["encoder"]["layers"]
    q = model.vision.encoder.layers[1].attn.q_proj
    assert q.weight.dtype == torch.int8
    np.testing.assert_array_equal(q.weight.numpy(),
                                  layers["attn"]["q_proj"]["kernel"][1].T)
    np.testing.assert_array_equal(q.act_scale.numpy(),
                                  layers["attn"]["q_proj"]["act_scale"][1])
    patch = model.vision.patch_embed
    assert patch.weight.shape == (64, 592) and patch.bias is None
    assert patch.weight.dtype == torch.int8
    assert not patch.weight[:, 588:].any()
    assert {v.dtype for k, v in state.items() if k.endswith(".weight")
            and ("proj" in k or "fc" in k or "patch" in k)} == {torch.int8}


def test_int8_serving_slice_matches_jax(jax_slice, interpret_mode):
    """JAX `SuperGuessr(quant='static', attn_impl='flash_fused')` +
    `geocell_predictions` against the port's int8 `make_serving_fn` on
    the same normalised panoramas, in f32."""
    assert_serving_slice_matches_jax(jax_slice, "flash_fused", "fused")


@pytest.mark.parametrize("name", ["flash", "xla", "flash_fused_block"])
def test_int8_serving_route_of_the_cli_matches_jax(jax_slice, interpret_mode,
                                                   monkeypatch, name):
    """``serve --quant`` under ``PIGEON_ATTN_IMPL=flash`` (static int8
    projections, then K3 on every request), ``xla`` (plain attention) and
    ``PIGEON_QUANT_ATTN_IMPL=flash_fused_block`` (K7): the route each
    package's CLI resolves, as the int8 serving slice, against the JAX
    package's; K3 (its plain version here) runs once a layer a forward on
    ``flash``, K7 once a layer on ``flash_fused_block``, K8 never."""
    from pigeon_tpu.cli import run as jax_cli
    from pigeon_tpu_torch.cli import run as cli
    from pigeon_tpu_torch.kernels import fused_block_attention_int8 as k7

    variable = ("PIGEON_QUANT_ATTN_IMPL" if name == "flash_fused_block"
                else "PIGEON_ATTN_IMPL")
    for unset in ("PIGEON_ATTN_IMPL", "PIGEON_QUANT_ATTN_IMPL"):
        monkeypatch.delenv(unset, raising=False)
    monkeypatch.setenv(variable, name)
    with monkeypatch.context() as mp:
        # The JAX CLI resolves the variable on a TPU only.
        mp.setattr(jax, "default_backend", lambda: "tpu")
        jax_impl = jax_cli._quant_attn_impl()
    torch_impl = cli.quant_attn_impl()
    assert (jax_impl, torch_impl) == (name, cli.ATTN_ROUTES[name])
    calls = []
    for module, fn_name in ((k3, "flash_attention_reference"),
                            (k8, "fused_qkv_attention_int8_reference"),
                            (k7, "fused_block_attention_int8_reference")):
        fn = getattr(module, fn_name)
        monkeypatch.setattr(
            module, fn_name,
            lambda *a, _fn=fn, _n=fn_name: calls.append(_n) or _fn(*a))
    assert_serving_slice_matches_jax(jax_slice, jax_impl, torch_impl)
    # Two forwards: the serving function's and the logits'.
    per_layer = {"flash": ["flash_attention_reference"],
                 "flash_fused_block": ["fused_block_attention_int8_reference"]}
    assert calls == per_layer.get(name, []) * 2 * SLICE.num_layers


def assert_serving_slice_matches_jax(jax_slice, jax_impl, torch_impl):
    """The JAX int8 `SuperGuessr` on ``jax_impl`` and the port's on
    ``torch_impl``, from the same calibrated tree and pixels."""
    from pigeon_tpu.data.image_ops import normalize_images
    from pigeon_tpu.models.geocell_head import geocell_predictions
    from pigeon_tpu.models.super_guessr import SuperGuessr
    from pigeon_tpu_torch.models.super_guessr import SuperGuessr as TModel
    from pigeon_tpu_torch.serve.server import make_serving_fn

    rng = np.random.default_rng(8)
    cells = np.stack([rng.uniform(-10, 25, HEAD.num_cells),
                      rng.uniform(36, 60, HEAD.num_cells)], -1) \
        .astype(np.float32)
    # Both sides take the same f32 pixels: a one-ulp difference in the
    # normalisation would move a quantize boundary of the patch embed.
    pixels = np.asarray(normalize_images(rng.integers(
        0, 256, (2, 4, 42, 42, 3), dtype=np.uint8)), np.float32)
    out = SuperGuessr(SLICE, HEAD, attn_impl=jax_impl,
                      quant="static").apply({"params": jax_slice},
                                            jnp.asarray(pixels))
    want = geocell_predictions(out.logits, jnp.asarray(cells),
                               HEAD.num_candidates)
    model = TModel(SLICE, HEAD, attn_impl=torch_impl, quant="static")
    model.load_state_dict(state_dict_from_jax(jax_slice), strict=True)
    got = make_serving_fn(model, HEAD, cells, "cpu")(pixels)
    # The int8 max error, and not the share of elements: a requantize
    # flip (an activation at a rounding boundary, where XLA and torch sum
    # in another order) in one view's K or V moves every token of that
    # view, so all of its token-mean embedding. On these inputs one flip
    # in the second layer puts 1 of the 8 views (12.5% of the elements)
    # off by up to ~4e-2; the tower tests hold the share.
    for name, value, ref in (("embedding", got["embedding"], out.embedding),
                             ("logits", model(torch.from_numpy(pixels))
                              .logits.detach(), out.logits),
                             ("topk_probs", got["topk_probs"],
                              want["topk_probs"])):
        err = np.abs(value.numpy() - np.asarray(ref)).max()
        assert err < INT8_MAX, (name, err)
    np.testing.assert_array_equal(got["topk_cells"].numpy(),
                                  np.asarray(want["topk_cells"]))
    np.testing.assert_array_equal(got["pred_lla"].numpy(),
                                  np.asarray(want["pred_lla"]))


def test_clip_preprocess_pil_matches_jax():
    import glob
    import os

    from PIL import Image

    from pigeon_tpu.data.image_ops import clip_preprocess_pil
    from pigeon_tpu_torch.data.image_ops import clip_preprocess_pil as tpre

    path = sorted(glob.glob(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "data", "benchmarks", "sample20", "images", "*.png")))[0]
    with Image.open(path) as im:
        got = tpre(im, 48)
        want = np.asarray(clip_preprocess_pil(im, 48), np.float32)
    assert got.dtype == np.float32 and got.shape == (48, 48, 3)
    np.testing.assert_array_equal(got, want)


def test_quantize_tower_keeps_routes_and_pads_the_patch_embed():
    from pigeon_tpu_torch.models.clip import CLIPVisionTower
    from pigeon_tpu_torch.models.super_guessr import init_weights

    tower = init_weights(CLIPVisionTower(SLICE, attn_impl="flash"), 0)
    qtower = tquant.quantize_tower(tower)
    assert qtower.attn_impl == "flash" and qtower.config is SLICE
    assert qtower.patch_embed.weight.shape == (64, 592)
    w_q, _ = tquant.quantize_channelwise(tower.patch_embed.weight)
    np.testing.assert_array_equal(qtower.patch_embed.weight[:, :588].numpy(),
                                  w_q.numpy())
    assert all(m.mode == "dynamic" for m in qtower.modules()
               if isinstance(m, tquant.QuantLinear))
    tquant.set_quant_mode(qtower, "static")
    with torch.inference_mode():
        hidden, _ = qtower(torch.randn(2, 42, 42, 3))
    assert hidden.shape == (2, 10, 64) and torch.isfinite(hidden).all()
    with pytest.raises(ValueError, match="mode"):
        tquant.set_quant_mode(qtower, "int4")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b, s, heads", [
    (1, 1, 1), (2, 17, 2), (2, 65, 4), (1, 640, 2), (3, 577, 16),
    (80, 577, 16)])
def test_cuda_attention_kernel_matches_plain_version(cuda, b, s, heads):
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn(b, s, heads, 64, generator=gen, device=cuda)
               .bfloat16() for _ in range(3))
    before = k3.flash_attention.launches
    got = k3.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert k3.flash_attention.launches == before + 1
    want = k3.flash_attention_reference(q, k, v)
    # 3e-2: the repo's bf16 attention bound; both round p to bf16 at the
    # same place, only the summation order differs.
    assert (got.float() - want.float()).abs().max().item() <= 3e-2


@pytest.mark.gpu
@pytest.mark.parametrize("b, s, d, heads", [
    (1, 1, 128, 2), (1, 17, 128, 2), (2, 65, 256, 4), (1, 640, 128, 2),
    (4, 577, 1024, 16), (2, 1025, 256, 4), (3, 63, 1024, 16)])
def test_cuda_int8_kernel_matches_plain_version(cuda, b, s, d, heads):
    gen = torch.Generator(device=cuda).manual_seed(s)
    p = heads * 64
    x = torch.nn.functional.layer_norm(
        torch.randn(b, s, d, generator=gen, device=cuda), (d,)).bfloat16()
    act_scale = x.float().abs().max() / 127
    ops = []
    for _ in range(3):
        w_q, scale = tquant.quantize_channelwise(
            torch.randn(p, d, generator=gen, device=cuda) * 0.02)
        ops += [w_q, scale, torch.randn(p, generator=gen, device=cuda) * 0.02]
    before = k8.fused_qkv_attention_int8.launches
    got = k8.fused_qkv_attention_int8(x, act_scale, *ops, heads)
    torch.cuda.synchronize()
    assert k8.fused_qkv_attention_int8.launches == before + 1
    want = k8.fused_qkv_attention_int8_reference(x, act_scale, *ops, heads)
    assert bool(torch.isfinite(got.float()).all())
    # 3e-2: the repo's bf16 attention bound; and 2e-2 of the output's
    # magnitude, K1's bound: q/k/v agree bit for bit, p is rounded against
    # K3's running max, the plain version's against the exact one.
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 3e-2
    assert err <= 2e-2 * want.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("m, k, n", [(1, 592, 1024), (17, 64, 8),
                                     (2308, 4096, 1024)])
def test_cuda_int8_matmul_is_exact(cuda, m, k, n):
    gen = torch.Generator().manual_seed(m)
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
    got = tquant.int8_matmul(a.to(cuda), w.to(cuda)).cpu()
    assert torch.equal(got, tquant.int8_matmul(a, w))


@pytest.mark.gpu
def test_cuda_int8_serving_model_launches_k8(cuda):
    from pigeon_tpu_torch.models.super_guessr import SuperGuessr, init_weights

    vision = dataclasses.replace(SLICE, hidden_size=128, num_heads=2,
                                 intermediate_size=256)
    head = dataclasses.replace(HEAD, embed_dim=128)
    model = init_weights(SuperGuessr(vision, head, dtype=torch.bfloat16),
                         0).to(cuda)
    calib = torch.randn(2, 4, 42, 42, 3, device=cuda)
    before = (k3.flash_attention.launches,
              k8.fused_qkv_attention_int8.launches)
    tquant.quantize_and_calibrate(model, calib, tower_key="vision")
    with torch.inference_mode():
        out = model(calib)
    torch.cuda.synchronize()
    assert (k3.flash_attention.launches - before[0],
            k8.fused_qkv_attention_int8.launches - before[1]) == (2, 2)
    assert torch.isfinite(out.logits.float()).all()
