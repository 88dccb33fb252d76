"""Kernels K1 (the fused QKV projection + attention forward) and K5 (LN1
folded in) in their wgmma form: the projection GEMM feeding K3's
streaming forward, behind a LayerNorm pass for K5. On the CPU, their
plain versions against the JAX package's `_fused_qkv_forward` and
`_fused_ln_qkv_forward` (Pallas kernels in interpret mode) at ragged
lengths around the 64- and 128-row tiles, the wrappers' checks (and
K6's, which runs K5's stages) and the workspaces' shapes (and K6's and
K9's); on a GPU (``-m gpu``), both kernels against their
plain versions at those lengths and three widths.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pigeon_tpu_torch.kernels import fused_ln_qkv_attention as k5
from pigeon_tpu_torch.kernels import fused_qkv_attention as k1

#: Lengths around the GEMM's and the forward's 128-row tiles and 64-row
#: wgmma halves, and the model's 577.
LENGTHS = [1, 63, 64, 65, 127, 128, 129, 577]
#: Two heads of 64: P = D = 128, the narrowest width the GEMM takes.
HEADS, D = 2, 128
EPS = 1e-5


@pytest.fixture
def interpret_mode(monkeypatch):
    """The JAX package's fused forwards as its own tests run them on the
    CPU: interpret mode, two head groups."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("PIGEON_FUSED_GROUPS", "2")
    with pltpu.force_tpu_interpret_mode():
        yield


def jax_operands(s, b=2, seed=0):
    """Seeded f32 raw x (B, S, D), LN scale and bias (D,), q/k/v weights
    in the JAX layout (D, P) and biases (P,)."""
    rng = np.random.default_rng(seed + s)
    p = HEADS * 64
    x = (rng.normal(size=(b, s, D)) * 2 + 0.5).astype(np.float32)
    ls = (1.0 + 0.3 * rng.normal(size=(D,))).astype(np.float32)
    lb = (0.3 * rng.normal(size=(D,))).astype(np.float32)
    ws = [(rng.normal(size=(D, p)) * D ** -0.5).astype(np.float32)
          for _ in range(3)]
    bs = [(rng.normal(size=(p,)) * 0.1).astype(np.float32)
          for _ in range(3)]
    return x, ls, lb, ws, bs


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("s", LENGTHS)
def test_k1_plain_version_matches_jax_fused_qkv_forward(interpret_mode, s):
    from pigeon_tpu.kernels.flash_attention import _fused_qkv_forward

    x, _, _, ws, bs = jax_operands(s)
    x = x / 2                       # a layer-normed scale
    want = _fused_qkv_forward(jnp.asarray(x), *map(jnp.asarray, ws),
                              *map(jnp.asarray, bs), HEADS)
    got = k1.fused_qkv_attention_reference(
        t(x), *(t(w.T) for w in ws), *map(t, bs), HEADS)
    assert got.shape == want.shape
    # 5e-5: the repo's bound for the fused QKV forward in f32.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


@pytest.mark.parametrize("s", LENGTHS)
def test_k5_plain_version_matches_jax_fused_ln_qkv_forward(interpret_mode,
                                                           s):
    from pigeon_tpu.kernels.flash_attention import _fused_ln_qkv_forward

    x, ls, lb, ws, bs = jax_operands(s)
    want = _fused_ln_qkv_forward(jnp.asarray(x), jnp.asarray(ls),
                                 jnp.asarray(lb), *map(jnp.asarray, ws),
                                 *map(jnp.asarray, bs), HEADS, EPS)
    got = k5.fused_ln_qkv_attention_reference(
        t(x), t(ls), t(lb), *(t(w.T) for w in ws), *map(t, bs), HEADS, EPS)
    assert got.shape == want.shape
    # 5e-5: as K1; the LayerNorm is the same f32 arithmetic on both sides.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


def bf16_operands(s=17, d=D, heads=HEADS):
    p = heads * k1.HEAD_DIM
    x = torch.zeros(2, s, d, dtype=torch.bfloat16)
    ws = [torch.zeros(p, d, dtype=torch.bfloat16) for _ in range(3)]
    bs = [torch.zeros(p, dtype=torch.bfloat16) for _ in range(3)]
    return x, ws, bs


@pytest.mark.parametrize("s", [1, 577, 1024])
def test_k1_and_k5_checks_take_any_length(s):
    """The GEMM and the streaming forward have no sequence limit: S = 1024
    passes the checks K1 and K5 run, past K6's resident block's 640."""
    x, ws, bs = bf16_operands(s)
    k1._check_gemm_operands(x, ws, bs, HEADS)
    k5.check_ln_params(x, torch.ones(D), torch.zeros(D))


@pytest.mark.parametrize("d, heads, match", [
    (192, 2, "D=192"),              # D a multiple of 64, not of 128
    (128, 3, "P=192"),              # an odd head count
    (96, 2, "multiple of 64"),
])
def test_k1_and_k5_checks_refuse_widths_off_the_gemm_tiles(d, heads, match):
    x, ws, bs = bf16_operands(d=d, heads=heads)
    with pytest.raises(ValueError, match=match):
        k1._check_gemm_operands(x, ws, bs, heads)


def test_k6_checks_take_any_length():
    """K6 runs K5's stages and a GEMM, so its checks take S = 1024, past
    the 640 rows its resident block once held."""
    from pigeon_tpu_torch.kernels import fused_block_attention as k6

    x, ws, bs = bf16_operands(1024)
    wo = torch.zeros(D, D, dtype=torch.bfloat16)
    k6._check_operands(x, torch.ones(D), torch.zeros(D), *ws, *bs, wo,
                       torch.zeros(D, dtype=torch.bfloat16), HEADS)


@pytest.mark.parametrize("s", [1, 65, 577])
def test_workspaces_have_the_kernels_shapes(s):
    x = torch.zeros(3, s, D, dtype=torch.bfloat16)
    ws = k1.forward_workspaces(x, HEADS)
    assert ws._fields == ("q", "k", "v")
    ln_ws = k5.forward_workspaces(x, HEADS)
    assert ln_ws._fields == ("xn", "q", "k", "v")
    assert ln_ws.xn.shape == x.shape
    for buf in (*ws, *ln_ws):
        assert buf.dtype == torch.bfloat16 and buf.is_contiguous()
    for buf in (*ws, *ln_ws[1:]):
        assert buf.shape == (3, s, HEADS * 64)
    # K2's workspaces start with K1's; K6's are K5's and the attention
    # output; K9's the normalised x and the hidden (B*S, 4D).
    assert k1.backward_workspaces(x, HEADS).q.shape == ws.q.shape
    from pigeon_tpu_torch.kernels import fused_block_attention as k6
    from pigeon_tpu_torch.kernels import fused_mlp as k9

    block_ws = k6.forward_workspaces(x, HEADS)
    assert block_ws._fields == ("xn", "q", "k", "v", "ao")
    mlp_ws = k9.forward_workspaces(x, 4 * D)
    assert mlp_ws._fields == ("xn", "h")
    assert (mlp_ws.xn.shape, mlp_ws.h.shape) == ((3 * s, D), (3 * s, 4 * D))
    for buf in (*block_ws, *mlp_ws):
        assert buf.dtype == torch.bfloat16 and buf.is_contiguous()
    for buf in block_ws:
        assert buf.shape == x.shape


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def cuda_operands(s, d, b=3, seed=0):
    """Seeded bf16 operands on the card, heads of 64 across the width (as
    ViT-B and ViT-L): raw x of scale 3 around 1, LN parameters as widely
    spread as a trained CLIP's, weights and biases of magnitude 0.02."""
    gen = torch.Generator(device="cuda").manual_seed(seed + s + d)
    x = (torch.randn(b, s, d, generator=gen, device="cuda") * 3 + 1) \
        .bfloat16()
    ls = 1 + 0.5 * torch.randn(d, generator=gen, device="cuda")
    lb = 0.5 * torch.randn(d, generator=gen, device="cuda")
    ws = [(torch.randn(d, d, generator=gen, device="cuda") * 0.02).bfloat16()
          for _ in range(3)]
    bs = [(torch.randn(d, generator=gen, device="cuda") * 0.02).bfloat16()
          for _ in range(3)]
    return x, ls, lb, ws, bs, d // 64


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 768, 1024])
@pytest.mark.parametrize("s", LENGTHS)
def test_cuda_k1_matches_plain_version(cuda, s, d):
    x, ls, lb, ws, bs, heads = cuda_operands(s, d)
    xn = torch.nn.functional.layer_norm(x.float(), (d,)).bfloat16()
    before = k1.fused_qkv_attention.launches
    got = k1.fused_qkv_attention(xn, *ws, *bs, heads)
    torch.cuda.synchronize()
    assert k1.fused_qkv_attention.launches == before + 1
    want = k1.fused_qkv_attention_reference(xn, *ws, *bs, heads)
    assert bool(torch.isfinite(got.float()).all())
    # 2e-2 of the output's magnitude (chip_smoke.py's K1_TOL): a bf16
    # output one ulp apart is up to 2^-7 of it, q/k/v are rounded from sums
    # taken in another order, and p against the running max, the plain
    # version's against the exact one.
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 768, 1024])
@pytest.mark.parametrize("s", LENGTHS)
def test_cuda_k5_matches_plain_version(cuda, s, d):
    x, ls, lb, ws, bs, heads = cuda_operands(s, d)
    before = (k5.fused_ln_qkv_attention.launches,
              k1.fused_qkv_attention.launches)
    got = k5.fused_ln_qkv_attention(x, ls, lb, *ws, *bs, heads, EPS)
    torch.cuda.synchronize()
    assert (k5.fused_ln_qkv_attention.launches,
            k1.fused_qkv_attention.launches) == (before[0] + 1, before[1])
    want = k5.fused_ln_qkv_attention_reference(x, ls, lb, *ws, *bs, heads,
                                               EPS)
    assert bool(torch.isfinite(got.float()).all())
    # 2e-2 of the output's magnitude (chip_smoke.py's K5_TOL): a bf16
    # output one ulp apart is up to 2^-7 of it, and xn, q/k/v and p are
    # rounded from sums taken in another order.
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * scale
