"""Kernels K6 (LN1 + QKV + attention + out-projection + residual), K7 (its
int8 twin) and K3′ (online-softmax attention) of the PyTorch port: on the
CPU, their plain versions (and K6's autograd Function) against the JAX
package, its Pallas kernels in interpret mode; the wrappers' dispatch,
``PIGEON_FLASH_FWD`` and the operand checks; on a GPU (``-m gpu``), the
CUDA kernels against their plain versions at ragged and full-width
shapes. flax is imported inside the tests that need it: the GPU machine
has JAX but not flax."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pigeon_tpu_torch.kernels import attention as k3
from pigeon_tpu_torch.kernels import fused_block_attention as k6
from pigeon_tpu_torch.kernels import fused_block_attention_int8 as k7

EPS = 1e-5


@pytest.fixture
def interpret_mode(monkeypatch):
    """The JAX package's kernels as its own tests run them on the CPU:
    interpret mode, two head groups forward and backward."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("PIGEON_FUSED_GROUPS", "2")
    monkeypatch.setenv("PIGEON_FUSED_BWD", "kernel")
    monkeypatch.setenv("PIGEON_FUSED_BWD_GROUPS", "2")
    monkeypatch.delenv("PIGEON_FLASH_FWD", raising=False)
    with pltpu.force_tpu_interpret_mode():
        yield


def tensor(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def block_operands(s, d=128, b=2, seed=0):
    """Raw x, LN scale and bias, four weights in the JAX layout (D, D) and
    four biases (tests/test_flash_attention.py's `TestFusedBlock`)."""
    rng = np.random.default_rng(seed + s)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    ls = (1.0 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    lb = (0.1 * rng.normal(size=(d,))).astype(np.float32)
    ws = [(0.1 * rng.normal(size=(d, d))).astype(np.float32)
          for _ in range(4)]
    bs = [(0.1 * rng.normal(size=(d,))).astype(np.float32) for _ in range(4)]
    return x, ls, lb, ws, bs


def port_block_args(x, ls, lb, ws, bs, grad=False):
    """The same operands in the port's order and layout: Linear weights
    (out, in), out_proj's after the q/k/v biases."""
    return [tensor(a, grad) for a in (x, ls, lb, *(w.T for w in ws[:3]),
                                      *bs[:3], ws[3].T, bs[3])]


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [64, 100, 577])
def test_k6_plain_version_matches_jax_fused_block_attention(interpret_mode,
                                                            s):
    from pigeon_tpu.kernels.flash_attention import fused_block_attention

    x, ls, lb, ws, bs = block_operands(s)
    want = np.asarray(fused_block_attention(
        *map(jnp.asarray, (x, ls, lb, *ws[:3], *bs[:3], ws[3], bs[3])), 2,
        EPS))
    got = k6.fused_block_attention_reference(*port_block_args(
        x, ls, lb, ws, bs), 2, EPS)
    # 1e-4 in f32: tests/test_flash_attention.py's bound for this kernel;
    # the out-projection sums its head groups in another order.
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_k6_gradients_match_jax(interpret_mode):
    """`FusedBlockAttention` (K6 forward; K1 again, K2 and the f32
    out-projection's VJP backward; plain versions on the CPU) against
    `jax.grad` of `fused_block_attention`, all 11 inputs."""
    from pigeon_tpu.kernels.flash_attention import fused_block_attention

    x, ls, lb, ws, bs = block_operands(80)
    jargs = [jnp.asarray(a) for a in (x, ls, lb, *ws[:3], *bs[:3], ws[3],
                                      bs[3])]
    want = jax.grad(lambda *a: jnp.sum(fused_block_attention(*a, 2, EPS)
                                       ** 2),
                    argnums=tuple(range(11)))(*jargs)
    leaves = port_block_args(x, ls, lb, ws, bs, grad=True)
    out = k6.FusedBlockAttention.apply(*leaves, 2, EPS)
    assert out.grad_fn.name() == "FusedBlockAttentionBackward"
    out.square().sum().backward()
    for i, (t, w) in enumerate(zip(leaves, want)):
        grad = t.grad.numpy()
        # 1e-3: tests/test_flash_attention.py's bound for these gradients.
        np.testing.assert_allclose(grad.T if i in (3, 4, 5, 9) else grad,
                                   np.asarray(w), atol=1e-3, err_msg=str(i))


@pytest.mark.parametrize("wo_trainable", [False, True],
                         ids=["wo_frozen", "wo_trainable"])
def test_k6_backward_runs_k1_then_its_vjp(monkeypatch, wo_trainable):
    """The backward launches K1 again for the out-projection's input (the
    JAX VJP reruns `fused_qkv_mha`) only where Wo wants a gradient, then
    K1's VJP; a frozen parameter gets no gradient and the residual's
    reaches ``x``."""
    from pigeon_tpu_torch.kernels import fused_qkv_attention as k1

    calls = []
    forward = k1.fused_qkv_attention
    monkeypatch.setattr(k1, "fused_qkv_attention",
                        lambda *a: calls.append(1) or forward(*a))
    x, ls, lb, ws, bs = block_operands(9)
    leaves = port_block_args(x, ls, lb, ws, bs)
    leaves[0].requires_grad_()
    leaves[9].requires_grad_(wo_trainable)
    out = k6.FusedBlockAttention.apply(*leaves, 2, EPS)
    assert calls == []
    out.backward(torch.ones_like(out))
    assert calls == ([1] if wo_trainable else [])
    assert all(t.grad is None for i, t in enumerate(leaves)
               if i not in (0, 9))
    plain = [t.detach().clone().requires_grad_(t.requires_grad)
             for t in leaves]
    k6.fused_block_attention_reference(*plain, 2, EPS) \
        .backward(torch.ones_like(out))
    torch.testing.assert_close(leaves[0].grad, plain[0].grad, rtol=0,
                               atol=1e-5)
    if wo_trainable:
        # The plain version sums dWo in f32 over the same products.
        torch.testing.assert_close(leaves[9].grad, plain[9].grad, rtol=0,
                                   atol=1e-4)
    else:
        assert leaves[9].grad is None


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

def int8_block_operands(s, d=128, b=2, seed=0):
    """x, LN parameters, and four (int8 kernel (D, D), scale, bias) packs
    quantized by the JAX package, with its test's activation scales."""
    import flax.linen  # noqa: F401  (pigeon_tpu.models.quant needs it)
    from pigeon_tpu.models.quant import quantize_channelwise

    x, ls, lb, ws, bs = block_operands(s, d, b, seed)
    packs = []
    for w, bias in zip(ws, bs):
        w_q, scale = quantize_channelwise(jnp.asarray(w))
        packs.append((np.asarray(w_q), np.asarray(scale), bias))
    return x, ls, lb, packs, np.float32(0.05), np.float32(0.01)


def port_int8_args(x, ls, lb, packs, aqkv, ao):
    q, k, v, o = ([tensor(w.T), tensor(sc), tensor(bias)]
                  for w, sc, bias in packs)
    return [tensor(x), tensor(ls), tensor(lb), torch.tensor(aqkv), *q, *k,
            *v, torch.tensor(ao), *o]


@pytest.mark.parametrize("s", [64, 577])
def test_k7_plain_version_matches_jax_fused_block_attention_int8(
        interpret_mode, s):
    from pigeon_tpu.kernels.flash_attention import fused_block_attention_int8

    x, ls, lb, packs, aqkv, ao = int8_block_operands(s)
    flat = [jnp.asarray(a) for p in packs[:3] for a in p]
    want = np.asarray(fused_block_attention_int8(
        jnp.asarray(x), jnp.asarray(ls), jnp.asarray(lb), aqkv, *flat, ao,
        *map(jnp.asarray, packs[3]), 2, EPS))
    got = k7.fused_block_attention_int8_reference(
        *port_int8_args(x, ls, lb, packs, aqkv, ao), 2, EPS).numpy()
    # tests/test_flash_attention.py's bound for this kernel: requantize
    # flips (one ulp of LN or exp at a round() boundary) move an output by
    # up to one out-projection LSB, on few elements.
    lsb = float(ao * packs[3][1].max() * 127)
    err = np.abs(got - want)
    assert err.max() <= 1.5 * lsb + 2e-4, err.max()
    assert (err > 2e-4).mean() < 5e-3, (err > 2e-4).mean()


def test_k7_plain_version_is_the_separate_int8_composition():
    """K7's plain version equals LN, static int8 q/k/v, attention and a
    static int8 out_proj as separate `QuantLinear` layers, plus the
    residual: the int8 tower's ``"flash"`` route for one attention half."""
    from pigeon_tpu_torch.models.clip import flax_layer_norm, plain_attention
    from pigeon_tpu_torch.models.quant import QuantLinear

    x, ls, lb, packs, aqkv, ao = int8_block_operands(33)
    args = port_int8_args(x, ls, lb, packs, aqkv, ao)
    layers = []
    for (w, sc, bias), a in zip(packs, (aqkv, aqkv, aqkv, ao)):
        layer = QuantLinear(128, 128, mode="static")
        layer.weight.copy_(tensor(w.T))
        layer.scale.copy_(tensor(sc))
        layer.bias.copy_(tensor(bias))
        layer.act_scale.fill_(float(a))
        layers.append(layer)
    ln = torch.nn.LayerNorm(128, eps=EPS)
    ln.weight.data.copy_(tensor(ls))
    ln.bias.data.copy_(tensor(lb))
    xt = tensor(x)
    with torch.no_grad():
        xn = flax_layer_norm(ln, xt)
        heads = (2, 33, 2, 64)
        o = plain_attention(*(layer(xn).view(heads) for layer in layers[:3]))
        want = xt + layers[3](o.reshape(2, 33, 128))
    got = k7.fused_block_attention_int8_reference(*args, 2, EPS)
    # 5e-5: the int8 fused QKV bound (tests/test_flash_attention.py); the
    # plain attention normalises p before its product and K7's after, and
    # on these inputs no requantize flips.
    torch.testing.assert_close(got, want, rtol=0, atol=5e-5)


# ---------------------------------------------------------------------------
# K3′
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [64, 100, 577])
def test_k3_online_plain_version_matches_jax_mha(interpret_mode,
                                                 monkeypatch, s, dtype):
    from pigeon_tpu.kernels.flash_attention import mha

    monkeypatch.setenv("PIGEON_FLASH_FWD", "online")
    rng = np.random.default_rng(s)
    qkv = [(rng.normal(size=(2, s, 2, 64)) * 0.3).astype(np.float32)
           for _ in range(3)]
    jdt = jnp.dtype(dtype)
    want = np.asarray(mha(*(jnp.asarray(a, jdt) for a in qkv)), np.float32)
    tdt = getattr(torch, dtype)
    got = k3.flash_attention_online_reference(*(tensor(a).to(tdt)
                                                for a in qkv))
    assert got.dtype == tdt and got.shape == (2, s, 2, 64)
    # 2e-5 in f32 and 3e-2 in bf16: the repo's attention bounds
    # (tests/test_flash_attention.py); the sums run in another order.
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2e-5 if dtype == "float32" else 3e-2)
    # The wrapper takes the online body under the variable.
    torch.testing.assert_close(
        k3.flash_attention(*(tensor(a).to(tdt) for a in qkv)), got, rtol=0,
        atol=0)


def test_k3_online_is_another_function_in_bf16():
    """bf16(p) is taken against the running max: past the first chunk the
    online body rounds other values than K3's, so the two differ."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 300, 1, 64, generator=gen).bfloat16()
               for _ in range(3))
    mono = k3.flash_attention_reference(q, k, v).float()
    online = k3.flash_attention_online_reference(q, k, v).float()
    assert not torch.equal(mono, online)
    assert (mono - online).abs().max().item() <= 3e-2


def test_flash_fwd_selects_the_body_and_refuses_unknown_values(monkeypatch):
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(1, 9, 2, 64, generator=gen)
    before = (k3.flash_attention.launches,
              k3.flash_attention_online.launches)
    monkeypatch.delenv("PIGEON_FLASH_FWD", raising=False)
    assert k3.flash_fwd() == "monolithic"
    torch.testing.assert_close(k3.flash_attention(q, q, q),
                               k3.flash_attention_reference(q, q, q),
                               rtol=0, atol=0)
    monkeypatch.setenv("PIGEON_FLASH_FWD", "online")
    assert k3.flash_fwd() == "online"
    torch.testing.assert_close(k3.flash_attention(q, q, q),
                               k3.flash_attention_online_reference(q, q, q),
                               rtol=0, atol=0)
    assert (k3.flash_attention.launches,
            k3.flash_attention_online.launches) == before
    monkeypatch.setenv("PIGEON_FLASH_FWD", "onlin")
    with pytest.raises(ValueError, match="PIGEON_FLASH_FWD"):
        k3.flash_attention(q, q, q)


# ---------------------------------------------------------------------------
# Dispatch and operand checks
# ---------------------------------------------------------------------------

def test_wrappers_dispatch_by_device():
    """On the CPU the wrappers run their plain versions without counting a
    launch; on another device they raise."""
    import flax.linen  # noqa: F401

    x, ls, lb, ws, bs = block_operands(9)
    b6 = port_block_args(x, ls, lb, ws, bs)
    b7 = port_int8_args(*int8_block_operands(9))
    q = torch.randn(1, 9, 2, 64)
    before = (k6.fused_block_attention.launches,
              k7.fused_block_attention_int8.launches,
              k3.flash_attention_online.launches)
    torch.testing.assert_close(
        k6.fused_block_attention(*b6, 2, EPS),
        k6.fused_block_attention_reference(*b6, 2, EPS), rtol=0, atol=0)
    torch.testing.assert_close(
        k7.fused_block_attention_int8(*b7, 2, EPS),
        k7.fused_block_attention_int8_reference(*b7, 2, EPS), rtol=0, atol=0)
    k3.flash_attention_online(q, q, q)
    assert before == (k6.fused_block_attention.launches,
                      k7.fused_block_attention_int8.launches,
                      k3.flash_attention_online.launches)
    with pytest.raises(ValueError, match="no kernel"):
        k6.fused_block_attention(*(t.to("meta") for t in b6), 2, EPS)
    with pytest.raises(ValueError, match="no kernel"):
        k7.fused_block_attention_int8(*(t.to("meta") for t in b7), 2, EPS)
    with pytest.raises(ValueError, match="no kernel"):
        k3.flash_attention_online(*(q.to("meta"),) * 3)


def _k6_operands(d=128, heads=2, s=17):
    x = torch.zeros(2, s, d, dtype=torch.bfloat16)
    ls, lb = torch.ones(d), torch.zeros(d)
    ws = [torch.zeros(heads * 64, d, dtype=torch.bfloat16) for _ in range(4)]
    bs = [torch.zeros(heads * 64, dtype=torch.bfloat16) for _ in range(4)]
    return [x, ls, lb, *ws[:3], *bs[:3], ws[3], bs[3]], heads


@pytest.mark.parametrize("case, error, match", [
    ("ok", None, None), ("d_192", ValueError, "D=192 .* multiples of 128"),
    ("wo_f32", TypeError, "dtype"), ("bo_short", ValueError, "shape"),
    ("ln_bf16", TypeError, "dtype"), ("p_64", ValueError, "P=64")])
def test_k6_operand_checks(case, error, match):
    ops, heads = _k6_operands(d=192, heads=3) if case == "d_192" else \
        _k6_operands(heads=1) if case == "p_64" else _k6_operands()
    if case == "wo_f32":
        ops[9] = ops[9].float()
    elif case == "bo_short":
        ops[10] = ops[10][:64]
    elif case == "ln_bf16":
        ops[1] = ops[1].bfloat16()
    if error is None:
        k6._check_operands(*ops, heads)
    else:
        with pytest.raises(error, match=match):
            k6._check_operands(*ops, heads)


@pytest.mark.parametrize("case, error, match", [
    ("ok", None, None), ("x_f32", TypeError, "kernel takes bf16"),
    ("wo_bf16", TypeError, "dtype"), ("scale_shape", ValueError, "shape"),
    ("ao_vector", ValueError, "shape"), ("heads", ValueError, "H \\* 64")])
def test_k7_operand_checks(case, error, match):
    d, heads = 128, 2
    x = torch.zeros(2, 17, d, dtype=torch.bfloat16)
    ls, lb = torch.ones(d), torch.zeros(d)
    scalars = [("a_qkv", torch.ones(())), ("ao", torch.ones(()))]
    weights = [(n, torch.zeros(d, d, dtype=torch.int8)) for n in "qkvo"]
    vectors = [(n, torch.ones(d)) for n in ("fsq", "fsk", "fsv", "fso",
                                            "bq", "bk", "bv", "bo")]
    if case == "x_f32":
        x = x.float()
    elif case == "wo_bf16":
        weights[3] = ("wo", weights[3][1].bfloat16())
    elif case == "scale_shape":
        vectors[1] = ("fsk", torch.ones(d + 1))
    elif case == "ao_vector":
        scalars[1] = ("ao", torch.ones(1))
    elif case == "heads":
        heads = 4
    if error is None:
        k7._check_operands(x, ls, lb, scalars, weights, vectors, heads)
    else:
        with pytest.raises(error, match=match):
            k7._check_operands(x, ls, lb, scalars, weights, vectors, heads)


def test_new_sources_name_the_headers_they_include():
    """The tuning kernels build from the WMMA online body and attention
    backward, K3 and K3′ from the wgmma forward, K4 from the wgmma
    backward, K2 from that backward and the wgmma GEMM, K5, K6, K7 and K8
    from K1's two stages (that GEMM and the wgmma forward), K9 from the
    GEMM alone, all over the Hopper building blocks; K5, K6, K7 and K9
    share the LayerNorm kernel. Editing one renames the libraries that
    include it (`native.library_path`)."""
    from pigeon_tpu_torch import native

    for kernel, headers in (
            ("fused_block_attention", ["ln_row.cuh", "qkv_forward_sm90.cuh",
                                       "gemm_sm90.cuh", "hopper_sm90.cuh",
                                       "flash_fwd_sm90.cuh"]),
            ("fused_ln_qkv_attention", ["ln_row.cuh", "qkv_forward_sm90.cuh",
                                        "gemm_sm90.cuh", "hopper_sm90.cuh",
                                        "flash_fwd_sm90.cuh"]),
            ("fused_block_attention_int8", [
                "ln_row.cuh", "qkv_forward_sm90.cuh", "gemm_sm90.cuh",
                "hopper_sm90.cuh", "flash_fwd_sm90.cuh"]),
            ("fused_qkv_attention_int8", [
                "qkv_forward_sm90.cuh", "gemm_sm90.cuh", "hopper_sm90.cuh",
                "flash_fwd_sm90.cuh"]),
            ("fused_mlp", ["gemm_sm90.cuh", "hopper_sm90.cuh",
                           "ln_row.cuh"]),
            ("flash_attention_online", ["flash_fwd_sm90.cuh",
                                        "hopper_sm90.cuh"]),
            ("attention_fwd_variants", ["online_attention_tile.cuh",
                                        "attention_tile.cuh"]),
            ("attention_bwd_variants", ["attention_bwd_tile.cuh",
                                        "attention_tile.cuh"]),
            ("flash_attention", ["flash_fwd_sm90.cuh", "hopper_sm90.cuh"]),
            ("flash_attention_bwd", ["flash_bwd_sm90.cuh",
                                     "hopper_sm90.cuh"]),
            ("fused_qkv_attention_bwd", ["flash_bwd_sm90.cuh",
                                         "hopper_sm90.cuh",
                                         "gemm_sm90.cuh"])):
        closure = native.source_closure(
            os.path.join(native.CSRC_DIR, f"{kernel}.cu"))
        assert [os.path.basename(p) for p in closure] == [f"{kernel}.cu",
                                                         *headers]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _card_block(cuda, b, s, d, seed, std=3.0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn(b, s, d, generator=gen, device=cuda) * std + std / 3) \
        .bfloat16()
    ls = 1 + 0.5 * torch.randn(d, generator=gen, device=cuda)
    lb = 0.5 * torch.randn(d, generator=gen, device=cuda)
    return gen, x, ls, lb


@pytest.mark.gpu
@pytest.mark.parametrize("b, s, d", [(1, 1, 128), (2, 65, 256),
                                     (1, 640, 128), (4, 577, 1024)]
                         + [(3, s, d) for d in (128, 1024)
                            for s in (1, 63, 65, 129, 577)])
def test_cuda_k6_matches_plain_version(cuda, b, s, d):
    gen, x, ls, lb = _card_block(cuda, b, s, d, s)
    ws = [(torch.randn(d, d, generator=gen, device=cuda) * 0.02).bfloat16()
          for _ in range(4)]
    bs = [(torch.randn(d, generator=gen, device=cuda) * 0.02).bfloat16()
          for _ in range(4)]
    args = (x, ls, lb, *ws[:3], *bs[:3], ws[3], bs[3], d // 64, EPS)
    before = k6.fused_block_attention.launches
    got = k6.fused_block_attention(*args)
    torch.cuda.synchronize()
    assert k6.fused_block_attention.launches == before + 1
    want = k6.fused_block_attention_reference(*args)
    assert bool(torch.isfinite(got.float()).all())
    # 2e-2 of the output's magnitude, K5's bound: the attention output is
    # rounded to bf16 from sums in another order before the projection,
    # and p against K3's running max, the plain version's the exact one.
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("b, s, d", [(1, 1, 128), (2, 65, 256),
                                     (1, 640, 128), (4, 577, 1024),
                                     (1, 1025, 128), (3, 63, 1024)])
def test_cuda_k7_matches_plain_version(cuda, b, s, d):
    from pigeon_tpu_torch.models.quant import quantize_channelwise

    # Outputs stay under ~4, where a bf16 ulp (<= 1/64) is under 3e-2: a
    # flip's one-LSB change then moves an output by at most one ulp.
    gen, x, ls, lb = _card_block(cuda, b, s, d, s, std=0.5)
    packs = []
    for _ in range(4):
        w_q, scale = quantize_channelwise(
            torch.randn(d, d, generator=gen, device=cuda) * 0.02)
        packs.append([w_q, scale,
                      torch.randn(d, generator=gen, device=cuda) * 0.02])
    xn = k6.flax_layer_norm_f32(x, ls, lb, EPS)
    a_qkv = xn.abs().max() * 1.1 / 127
    ao = torch.tensor(0.01, device=cuda)
    args = (x, ls, lb, a_qkv, *packs[0], *packs[1], *packs[2], ao,
            *packs[3], d // 64, EPS)
    before = k7.fused_block_attention_int8.launches
    got = k7.fused_block_attention_int8(*args)
    torch.cuda.synchronize()
    assert k7.fused_block_attention_int8.launches == before + 1
    want = k7.fused_block_attention_int8_reference(*args)
    # One out-projection LSB (tests/test_flash_attention.py's form) for a
    # requantize flip, plus bf16 rounding; flips stay rare.
    lsb = (ao * packs[3][1].max() * 127).item()
    err = (got.float() - want.float()).abs()
    assert err.max().item() <= 1.5 * lsb + 3e-2
    assert (err > 3e-2).float().mean().item() < 5e-3


@pytest.mark.gpu
@pytest.mark.parametrize("b, s, heads", [(1, 1, 1), (2, 65, 2), (1, 640, 2),
                                         (1, 1200, 1), (80, 577, 16)])
def test_cuda_k3_online_matches_plain_version(cuda, b, s, heads):
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn(b, s, heads, 64, generator=gen, device=cuda)
               .bfloat16() for _ in range(3))
    before = k3.flash_attention_online.launches
    got = k3.flash_attention_online(q, k, v)
    torch.cuda.synchronize()
    assert k3.flash_attention_online.launches == before + 1
    want = k3.flash_attention_online_reference(q, k, v)
    # 3e-2: the repo's bf16 attention bound; both round p against the same
    # running max, only the summation order differs.
    assert (got.float() - want.float()).abs().max().item() <= 3e-2
