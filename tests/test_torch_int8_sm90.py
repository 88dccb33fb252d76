"""Kernels K8 (int8 fused QKV projection + attention) and K7 (the int8
attention half of a block) in their wgmma form: s8 projection GEMMs with
dequant epilogues around K3's streaming forward, K7 behind a LayerNorm
that writes int8 and before an int8 out-projection GEMM. On the CPU: the
wrappers' checks take any length and refuse widths off the GEMM's
128-wide tiles, the workspaces have the kernels' shapes and types, and
the folded dequant scales equal the ones the JAX wrappers hand their
Pallas kernels, bit for bit. The kernels themselves run on the card only
(`tests/test_torch_quant.py`, `tests/test_torch_block.py`, ``-m gpu``)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pigeon_tpu_torch.kernels import fused_block_attention_int8 as k7
from pigeon_tpu_torch.kernels import fused_qkv_attention_int8 as k8
from pigeon_tpu_torch.models.quant import quantize_static

#: The lengths the checks take: one row, ragged, the model's 577, and
#: past the 640 rows the kernels' resident blocks once held.
LENGTHS = [1, 17, 577, 641, 1025]


def k8_operands(s=17, d=128, heads=2, b=2):
    p = heads * 64
    x = torch.zeros(b, s, d, dtype=torch.bfloat16)
    x_q = torch.zeros(b, s, d, dtype=torch.int8)
    ws = [torch.zeros(p, d, dtype=torch.int8) for _ in range(3)]
    scales = [torch.ones(p) for _ in range(3)]
    biases = [torch.zeros(p) for _ in range(3)]
    return x, x_q, ws, scales, biases, heads


def k7_operands(s=17, d=128, heads=2, b=2):
    x = torch.zeros(b, s, d, dtype=torch.bfloat16)
    scalars = [("a_qkv", torch.ones(())), ("ao", torch.ones(()))]
    weights = [(n, torch.zeros(d, d, dtype=torch.int8)) for n in "qkvo"]
    vectors = [(n, torch.ones(d)) for n in ("fsq", "fsk", "fsv", "fso",
                                            "bq", "bk", "bv", "bo")]
    return x, torch.ones(d), torch.zeros(d), scalars, weights, vectors, heads


@pytest.mark.parametrize("kernel", ["K8", "K7"])
@pytest.mark.parametrize("s", LENGTHS)
def test_int8_checks_take_any_length(kernel, s):
    """Both kernels stream K and V through K3's forward, so no length is
    refused."""
    if kernel == "K8":
        k8._check_operands(*k8_operands(s))
    else:
        k7._check_operands(*k7_operands(s))


@pytest.mark.parametrize("kernel, d, heads, match", [
    ("K8", 192, 2, "D=192"),        # D a multiple of 64, not of 128
    ("K8", 128, 1, "P=64"),         # an odd head count
    ("K7", 192, 3, "D=192"),        # D = H * 64, not a multiple of 128
])
def test_int8_checks_refuse_widths_off_the_gemm_tiles(kernel, d, heads,
                                                      match):
    with pytest.raises(ValueError, match=match):
        if kernel == "K8":
            k8._check_operands(*k8_operands(d=d, heads=heads))
        else:
            k7._check_operands(*k7_operands(d=d, heads=heads))


@pytest.mark.parametrize("s", [1, 577, 1025])
def test_int8_workspaces_have_the_kernels_shapes(s):
    """K8 projects into K1's q/k/v workspaces (B, S, P) bf16; K7 quantizes
    LN1 into xq and the attention output into oq, both int8, around them."""
    x = torch.zeros(3, s, 256, dtype=torch.bfloat16)
    ws = k8.forward_workspaces(x, 4)
    assert ws._fields == ("q", "k", "v")
    for buf in ws:
        assert (buf.shape, buf.dtype) == ((3, s, 256), torch.bfloat16)
        assert buf.is_contiguous()
    block = k7.forward_workspaces(x)
    assert block._fields == ("xq", "q", "k", "v", "oq")
    for buf, dtype in zip(block, (torch.int8, *(torch.bfloat16,) * 3,
                                  torch.int8)):
        assert (buf.shape, buf.dtype) == (x.shape, dtype)
        assert buf.is_contiguous()


def captured_operands(monkeypatch, call):
    """The operands ``call`` hands `pl.pallas_call`'s kernel in the JAX
    package, which is not run."""
    from pigeon_tpu.kernels import flash_attention as fa

    seen = []

    def pallas_call(kernel, *, out_shape, **kwargs):
        def run(*operands):
            seen.extend(np.asarray(o) for o in operands)
            return jnp.zeros(out_shape.shape, out_shape.dtype)
        return run

    monkeypatch.setattr(fa.pl, "pallas_call", pallas_call)
    call(fa)
    return seen


def seeded_int8_pack(rng, d):
    """An int8 (D, D) weight in the JAX layout, f32 scales and biases."""
    return (rng.integers(-127, 128, (d, d)).astype(np.int8),
            rng.uniform(1e-4, 1e-2, d).astype(np.float32),
            rng.normal(0, 0.02, d).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_k8_folded_scales_equal_the_jax_wrappers_fold(monkeypatch, seed):
    """``act_scale * s`` as `fold_scales` forms it for the kernel equals
    `fused_qkv_mha_int8`'s ``fold``, and the quantized x its ``x_q``."""
    rng = np.random.default_rng(seed)
    d, heads = 128, 2
    x = rng.normal(0, 1, (2, 9, d)).astype(np.float32)
    act_scale = np.float32(np.abs(x).max() * 1.1 / 127)
    packs = [seeded_int8_pack(rng, d) for _ in range(3)]
    ops = captured_operands(monkeypatch, lambda fa: fa.fused_qkv_mha_int8(
        jnp.asarray(x), act_scale, *(jnp.asarray(a) for p in packs
                                     for a in p), heads))
    a = torch.tensor(act_scale)
    folded = k8.fold_scales(a, [torch.from_numpy(p[1]) for p in packs])
    for i, got in enumerate(folded):
        want = ops[2 + 3 * i].reshape(-1)
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))
    x_q = quantize_static(torch.from_numpy(x), a)
    np.testing.assert_array_equal(x_q.numpy(), ops[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_k7_folded_scales_equal_the_jax_wrappers_sv_vec(monkeypatch, seed):
    """``a_qkv * s*`` and ``ao * so`` as K7's wrapper forms them equal
    `fused_block_attention_int8`'s ``sv_vec``, bit for bit."""
    rng = np.random.default_rng(seed)
    d, heads = 128, 2
    x = rng.normal(0, 1, (2, 9, d)).astype(np.float32)
    ls = (1 + 0.3 * rng.normal(size=d)).astype(np.float32)
    lb = (0.3 * rng.normal(size=d)).astype(np.float32)
    packs = [seeded_int8_pack(rng, d) for _ in range(4)]
    aqkv, ao = np.float32(0.031), np.float32(0.0427)
    flat = [jnp.asarray(a) for p in packs[:3] for a in p]
    ops = captured_operands(
        monkeypatch, lambda fa: fa.fused_block_attention_int8(
            jnp.asarray(x), jnp.asarray(ls), jnp.asarray(lb), aqkv, *flat,
            ao, *map(jnp.asarray, packs[3]), heads))
    a_qkv, a_o = torch.tensor(aqkv), torch.tensor(ao)
    folded = (k7.fold_scales(a_qkv, [torch.from_numpy(p[1])
                                     for p in packs[:3]])
              + k7.fold_scales(a_o, [torch.from_numpy(packs[3][1])]))
    for got, at in zip(folded, (5, 8, 11, 15)):
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      ops[at].reshape(-1).view(np.int32))
