"""Kernel K2 (the fused QKV projection + attention backward) in its wgmma
form, and K3′ (the online forward) on K3's streaming kernel: on the CPU,
K2's workspaces and their checks, K2's plain version against the JAX
package's `_fused_qkv_backward` (its Pallas kernel in interpret mode) at
ragged lengths, and, on the JAX side, that kernel's dq/dk/dv against
`_flash_backward` on the same projected q/k/v (the reference's own
evidence that K2's attention part is K4's); on a GPU (``-m gpu``), K2 and
K3′ against their plain versions at ragged lengths around the 64- and
128-row tiles, and two K2 calls on the same inputs against each other.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pigeon_tpu_torch.kernels import attention as k34
from pigeon_tpu_torch.kernels import fused_qkv_attention as k12

#: Lengths around the kernels' 64-row chunks and 128-row tiles, the
#: model's 577, and 1024.
LENGTHS = [1, 63, 64, 65, 127, 128, 129, 577, 1024]
#: Two heads of 64: P = 128, the narrowest width K2 takes.
HEADS, D = 2, 128


@pytest.fixture
def interpret_mode(monkeypatch):
    """The JAX package's fused backward as its own tests run it on the
    CPU: interpret mode, two head groups forward and backward."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("PIGEON_FUSED_GROUPS", "2")
    monkeypatch.setenv("PIGEON_FUSED_BWD", "kernel")
    monkeypatch.setenv("PIGEON_FUSED_BWD_GROUPS", "2")
    with pltpu.force_tpu_interpret_mode():
        yield


def jax_operands(s, b=3, d=D, heads=HEADS, seed=0):
    """Seeded f32 x (B, S, D), weights in the JAX layout (D, P), biases
    (P,) and the cotangent g (B, S, P)."""
    rng = np.random.default_rng(seed + s)
    p = heads * 64
    x = (rng.normal(size=(b, s, d)) * 0.3).astype(np.float32)
    ws = [(rng.normal(size=(d, p)) * 0.1).astype(np.float32)
          for _ in range(3)]
    bs = [(rng.normal(size=(p,)) * 0.1).astype(np.float32)
          for _ in range(3)]
    g = rng.normal(size=(b, s, p)).astype(np.float32)
    return x, ws, bs, g


def torch_operands(x, ws, bs, g, dtype=torch.float32):
    """The same operands in the port's layout: Linear weights (P, D)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)

    return (t(x), *(t(w.T) for w in ws), *(t(bb) for bb in bs), t(g))


@pytest.mark.parametrize("s", [1, 65, 577])
def test_workspaces_have_the_kernels_shapes(s):
    x = torch.zeros(3, s, D, dtype=torch.bfloat16)
    ws = k12.backward_workspaces(x, HEADS)
    assert ws._fields == ("q", "k", "v", "stats", "g_n", "dq_acc")
    for t in (ws.q, ws.k, ws.v):
        assert t.shape == (3, s, HEADS * 64) and t.dtype == torch.bfloat16
    assert ws.stats.shape == (3, 3, HEADS, s)
    assert ws.stats.dtype == torch.float32
    assert ws.g_n.shape == (3, s, HEADS, 64)
    assert ws.g_n.dtype == torch.bfloat16
    assert ws.dq_acc.shape == (3, HEADS, -(-s // 64), 64 * 64)
    assert ws.dq_acc.dtype == torch.float32
    assert not ws.dq_acc.any()
    assert all(t.is_contiguous() for t in ws)


@pytest.mark.parametrize("field",
                         ["q", "k", "v", "stats", "g_n", "dq_acc"])
def test_backward_refuses_a_wrong_workspace(field):
    x = torch.zeros(3, 65, D, dtype=torch.bfloat16)
    w = torch.zeros(HEADS * 64, D, dtype=torch.bfloat16)
    bias = torch.zeros(HEADS * 64, dtype=torch.bfloat16)
    g = torch.zeros(3, 65, HEADS * 64, dtype=torch.bfloat16)
    ws = k12.backward_workspaces(x, HEADS)
    bad = getattr(ws, field)
    bad = bad.float() if bad.dtype == torch.bfloat16 else bad[..., :-1]
    before = k12.fused_qkv_attention_backward.launches
    with pytest.raises(ValueError, match=f"workspace {field}"):
        k12.fused_qkv_attention_backward_into(
            x, w, w, w, bias, bias, bias, g, HEADS,
            ws._replace(**{field: bad}))
    assert k12.fused_qkv_attention_backward.launches == before


@pytest.mark.parametrize("s", [1, 65, 129])
def test_plain_version_matches_jax_fused_qkv_backward(interpret_mode, s):
    """B = 3, so B * S is no multiple of the GEMMs' 128-row tiles."""
    from pigeon_tpu.kernels.flash_attention import _fused_qkv_backward

    x, ws, bs, g = jax_operands(s)
    want = _fused_qkv_backward(jnp.asarray(x), *map(jnp.asarray, ws),
                               *map(jnp.asarray, bs), jnp.asarray(g), HEADS)
    got = k12.fused_qkv_attention_backward_reference(
        *torch_operands(x, ws, bs, g), HEADS)
    for name, a, w in zip(("dx", "dq", "dk", "dv"), got, want):
        assert a.shape == w.shape, name
        # 5e-4: the JAX package's bound for these gradients in f32
        # (tests/test_flash_attention.py); the sums run in another order.
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=5e-4,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("s", [1, 65, 129])
def test_jax_fused_backward_attention_is_flash_backward(interpret_mode, s,
                                                        dtype):
    """`_fused_qkv_backward`'s projection cotangents are `_flash_backward`
    on the q/k/v it projects (rounded to the input type as it rounds
    them): the attention part of the TPU kernel K2 replaces is K4's."""
    from pigeon_tpu.kernels.flash_attention import (
        _flash_backward,
        _fused_qkv_backward,
    )

    x, ws, bs, g = (jnp.asarray(a, dtype) if not isinstance(a, list)
                    else [jnp.asarray(w, dtype) for w in a]
                    for a in jax_operands(s))
    _, *dqkv = _fused_qkv_backward(x, *ws, *bs, g, HEADS)
    b = x.shape[0]

    def fold(a):                                   # (B,S,P)->(BH,S,64)
        return a.reshape(b, s, HEADS, 64).transpose(0, 2, 1, 3) \
            .reshape(b * HEADS, s, 64)

    qkv = [(jnp.dot(x, w, preferred_element_type=jnp.float32)
            + bias.astype(jnp.float32)).astype(dtype)
           for w, bias in zip(ws, bs)]
    want = _flash_backward(*map(fold, qkv), fold(g))
    # The same products on the same operands: f32 sums in another order
    # (1e-5), or in bf16 one output ulp (2^-8 of the largest value).
    for name, a, w in zip(("dq", "dk", "dv"), dqkv, want):
        a, w = np.asarray(fold(a), np.float32), np.asarray(w, np.float32)
        tol = 1e-5 if dtype == jnp.float32 else 2 ** -8 * np.abs(w).max()
        np.testing.assert_allclose(a, w, atol=tol, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def cuda_operands(s, d, b=3, amp=1.0, seed=0):
    """Seeded bf16 operands on the card: x layer-normed, weights of
    magnitude 0.02 (Wq and bq times ``amp``, so the logits move the
    running max from chunk to chunk at x8), g of 0.01."""
    gen = torch.Generator(device="cuda").manual_seed(seed + s + d)
    p = d  # heads of 64 across the width, as ViT-B and ViT-L
    x = torch.nn.functional.layer_norm(
        torch.randn(b, s, d, generator=gen, device="cuda"), (d,)).bfloat16()
    ws = [torch.randn(p, d, generator=gen, device="cuda") * 0.02
          for _ in range(3)]
    bs = [torch.randn(p, generator=gen, device="cuda") * 0.02
          for _ in range(3)]
    ws[0], bs[0] = ws[0] * amp, bs[0] * amp
    g = torch.randn(b, s, p, generator=gen, device="cuda") * 0.01
    return (x, *(t.bfloat16() for t in (*ws, *bs)), g.bfloat16()), p // 64


def within(got, want, tol=2e-2):
    """Each output finite and within ``tol`` of its largest magnitude."""
    for a, w in zip(got, want):
        assert bool(torch.isfinite(a.float()).all())
        scale = w.float().abs().max().item()
        assert (a.float() - w.float()).abs().max().item() <= tol * scale


@pytest.mark.gpu
@pytest.mark.parametrize("amp", [1.0, 8.0])
@pytest.mark.parametrize("d", [128, 768, 1024])
@pytest.mark.parametrize("s", LENGTHS)
def test_cuda_k2_matches_plain_version(cuda, s, d, amp):
    ops, heads = cuda_operands(s, d, amp=amp)
    before = (k12.fused_qkv_attention_backward.launches,
              k34.flash_attention_backward.launches)
    got = k12.fused_qkv_attention_backward(*ops, heads)
    torch.cuda.synchronize()
    assert (k12.fused_qkv_attention_backward.launches,
            k34.flash_attention_backward.launches) == (before[0] + 1,
                                                       before[1])
    # 2e-2 of each output's magnitude: u and dl are rounded to bf16 from
    # f32 values summed in another order (K4's and chip_smoke.py's bound).
    within(got, k12.fused_qkv_attention_backward_reference(*ops, heads))


@pytest.mark.gpu
@pytest.mark.parametrize("s", [65, 577])
def test_cuda_k2_calls_agree(cuda, s):
    """Two calls on the same inputs agree: dq's sums land in another
    order, but each call starts from a zeroed workspace."""
    ops, heads = cuda_operands(s, 1024, amp=8.0)
    first = k12.fused_qkv_attention_backward(*ops, heads)
    second = k12.fused_qkv_attention_backward(*ops, heads)
    torch.cuda.synchronize()
    within(second, first)


@pytest.mark.gpu
@pytest.mark.parametrize("amp", [1.0, 8.0])
@pytest.mark.parametrize("s", LENGTHS)
def test_cuda_k3_online_matches_plain_version(cuda, s, amp):
    gen = torch.Generator(device="cuda").manual_seed(s)
    q, k, v = (torch.randn(3, s, 4, 64, generator=gen, device="cuda")
               for _ in range(3))
    q, k, v = (t.bfloat16() for t in (q * amp, k, v))
    before = (k34.flash_attention_online.launches,
              k34.flash_attention.launches)
    got = k34.flash_attention_online(q, k, v)
    torch.cuda.synchronize()
    assert (k34.flash_attention_online.launches,
            k34.flash_attention.launches) == (before[0] + 1, before[1])
    want = k34.flash_attention_online_reference(q, k, v)
    # 3e-2: the repo's bf16 attention bound.
    assert (got.float() - want.float()).abs().max().item() <= 3e-2


@pytest.mark.gpu
@pytest.mark.parametrize("p", [512, 256])
@pytest.mark.parametrize("s", LENGTHS)
def test_cuda_k2_matches_plain_version_on_local_heads(cuda, s, p):
    """K2 at D = 1024 with P = 512 and 256: a rank's heads of ViT-L/14
    under tensor parallelism at tp = 2 and 4; its dx is the rank's partial
    sum, which the model axis all-reduces."""
    ops, _ = cuda_operands(s, 1024, amp=8.0)
    x, wq, wk, wv, bq, bk, bv, g = ops
    ops = (x, *(w[:p].contiguous() for w in (wq, wk, wv)),
           *(bb[:p].contiguous() for bb in (bq, bk, bv)),
           g[..., :p].contiguous())
    before = k12.fused_qkv_attention_backward.launches
    got = k12.fused_qkv_attention_backward(*ops, p // 64)
    torch.cuda.synchronize()
    assert k12.fused_qkv_attention_backward.launches == before + 1
    assert got[0].shape == (3, s, 1024) and got[1].shape == (3, s, p)
    # K2's bound, as at P = D above.
    within(got, k12.fused_qkv_attention_backward_reference(*ops, p // 64))
