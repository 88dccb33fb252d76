"""The wgmma forms of kernels K3 (attention forward) and K4 (attention
backward) of the PyTorch port: on the CPU, the wrapper contract (any
sequence length, K4's workspaces) and the plain version of K4's
statistics pass against the exact f32 row statistics; on a GPU
(``-m gpu``), both kernels against their plain versions at ragged lengths
around the 64- and 128-row tiles, with logits that move the running max
across chunks, and K4's statistics workspace against the plain pass.
"""

import numpy as np
import pytest
import torch

from pigeon_tpu_torch.kernels import attention as k34

#: Lengths around the kernels' 64-row chunks and 128-row tiles, the
#: model's 577, and one past the old resident-K/V limit of 640.
LENGTHS = [1, 63, 64, 65, 127, 128, 129, 577, 1024]


def qkvg(s, b=2, h=2, seed=0, amp=1.0):
    """Seeded f32 (B, S, H, 64) q/k/v/g; ``amp`` scales q (x8 makes the
    logits move the running max from chunk to chunk)."""
    rng = np.random.default_rng(seed + s)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(b, s, h, 64))
                                   .astype(np.float32)) for _ in range(4))
    return q * amp, k, v, g


def exact_stats(q, k, v, g):
    """The rows' m, den and r in one f32 step: (3, B, H, S)."""
    qh, kh, vh, gh = (t.transpose(1, 2).double() for t in (q, k, v, g))
    s = (qh @ kh.transpose(-1, -2)) * q.shape[-1] ** -0.5
    m = s.amax(-1)
    u = torch.exp(s - m[..., None])
    den = u.sum(-1)
    r = ((gh @ vh.transpose(-1, -2)) * u).sum(-1) / den
    return torch.stack([m, den, r]).float()


@pytest.mark.parametrize("amp", [1.0, 8.0])
@pytest.mark.parametrize("s", [1, 65, 129, 577])
def test_stats_pass_plain_version_matches_exact_statistics(s, amp):
    q, k, v, g = qkvg(s, amp=amp)
    got = k34.flash_attention_backward_stats_reference(q, k, v, g)
    assert got.shape == (3, 2, 2, s) and got.dtype == torch.float32
    want = exact_stats(q, k, v, g)
    # f32 sums over 128-key chunks rescaled by exp(m - m_new), against one
    # f64 pass: a few f32 ulps of each sum.
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s", [1, 64, 65, 577])
def test_backward_workspaces_have_the_kernels_shapes(s):
    q = torch.zeros(3, s, 2, 64, dtype=torch.bfloat16)
    ws = k34.backward_workspaces(q)
    assert ws.stats.shape == (3, 3, 2, s)
    assert ws.stats.dtype == torch.float32
    assert ws.g_n.shape == q.shape and ws.g_n.dtype == torch.bfloat16
    assert ws.dq_acc.shape == (3, 2, -(-s // 64), 64 * 64)
    assert ws.dq_acc.dtype == torch.float32
    assert not ws.dq_acc.any()


@pytest.mark.parametrize("field", ["stats", "g_n", "dq_acc"])
def test_backward_refuses_a_wrong_workspace(field):
    q = torch.zeros(1, 65, 2, 64, dtype=torch.bfloat16)
    ws = k34.backward_workspaces(q)
    bad = getattr(ws, field)
    bad = bad.float() if bad.dtype == torch.bfloat16 else bad[..., :-1]
    with pytest.raises(ValueError, match=f"workspace {field}"):
        k34.flash_attention_backward_into(q, q, q, q,
                                          ws._replace(**{field: bad}))


@pytest.mark.parametrize("s", [641, 1024])
def test_cpu_path_takes_sequences_past_the_old_resident_limit(s):
    """K3 has no sequence limit since it streams K and V: the operand
    check takes any S, and the CPU path runs the plain versions."""
    q, k, v, g = (t.bfloat16() for t in qkvg(s, b=1, h=1))
    k34._check_operands(q, k, v, max_seq=q.shape[1])
    before = (k34.flash_attention.launches,
              k34.flash_attention_backward.launches)
    out = k34.flash_attention(q, k, v)
    torch.testing.assert_close(out, k34.flash_attention_reference(q, k, v),
                               rtol=0, atol=0)
    grads = k34.flash_attention_backward(q, k, v, g)
    for a, w in zip(grads, k34.flash_attention_backward_reference(q, k, v,
                                                                  g)):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    assert before == (k34.flash_attention.launches,
                      k34.flash_attention_backward.launches)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("amp", [1.0, 8.0])
@pytest.mark.parametrize("s", LENGTHS)
def test_cuda_k3_matches_plain_version_at_any_length(cuda, s, amp):
    q, k, v, _ = (t.to(cuda).bfloat16() for t in qkvg(s, amp=amp))
    before = k34.flash_attention.launches
    got = k34.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert k34.flash_attention.launches == before + 1
    want = k34.flash_attention_reference(q, k, v)
    # 3e-2: the repo's bf16 attention bound. The kernel rounds p relative
    # to the running max, the plain version relative to the exact one.
    assert (got.float() - want.float()).abs().max().item() <= 3e-2


@pytest.mark.gpu
@pytest.mark.parametrize("zero_rows", [False, True])
@pytest.mark.parametrize("amp", [1.0, 8.0])
@pytest.mark.parametrize("s", LENGTHS)
def test_cuda_k4_matches_plain_version_at_any_length(cuda, s, amp,
                                                     zero_rows):
    q, k, v, g = (t.to(cuda).bfloat16() for t in qkvg(s, amp=amp))
    g = g * 0.01
    if zero_rows:
        g[:, ::3] = 0
    before = k34.flash_attention_backward.launches
    got = k34.flash_attention_backward(q, k, v, g)
    torch.cuda.synchronize()
    assert k34.flash_attention_backward.launches == before + 1
    for a, w in zip(got, k34.flash_attention_backward_reference(q, k, v, g)):
        assert bool(torch.isfinite(a.float()).all())
        # 2e-2 of each output's magnitude: K4's bound (K2's for the same
        # passes).
        scale = w.float().abs().max().item()
        assert (a.float() - w.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("amp", [1.0, 8.0])
@pytest.mark.parametrize("s", [1, 65, 129, 577])
def test_cuda_k4_statistics_match_the_plain_pass(cuda, s, amp):
    q, k, v, g = (t.to(cuda).bfloat16() for t in qkvg(s, amp=amp))
    ws = k34.backward_workspaces(q)
    k34.flash_attention_backward_into(q, k, v, g, ws)
    torch.cuda.synchronize()
    want = k34.flash_attention_backward_stats_reference(q, k, v, g)
    # f32 sums in another order, exp2 with log2(e) folded into the scale.
    for got_row, want_row in zip(ws.stats, want):
        scale = want_row.abs().max().item()
        assert (got_row - want_row).abs().max().item() <= 1e-4 * max(scale,
                                                                     1.0)
