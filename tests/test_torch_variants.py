"""The tuning kernels V1-V10 of the PyTorch port (the Pallas bodies of
`scripts/bench_attn_bwd.py` and `scripts/bench_attn_fwd_diag.py`) and the
drivers that run them (`scripts/bench_torch_attn_*.py`).

On the CPU, each plain version against the script's own body: the bodies
are closures inside the script's ``main()``, so their ``FunctionDef``s are
read from the unedited source with `ast`, run with the closure's names
bound (``jax``, ``jnp``, ``np``, ``scale``, ``S``, ``DH``) and launched
through ``pl.pallas_call`` in interpret mode, as the script launches them.
The exact variants are also held against the script's own reference
(``jax.vjp`` of `_xla_attention_bshd`) or `_flash_forward`. Then the
wrappers' dispatch and operand checks, K3′'s chunk, and the drivers'
variant names and checks. On a GPU (``-m gpu``), each CUDA variant
against its plain version."""

import ast
import functools
import importlib.util
import os
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pigeon_tpu_torch import tuning
from pigeon_tpu_torch.kernels import attention as k34
from pigeon_tpu_torch.kernels import attention_bwd_variants as bv
from pigeon_tpu_torch.kernels import attention_fwd_variants as fv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DH = 64
B, H = 2, 2  # BH = 4 sequences
PACK = 2
#: (exact, diagnostic) bounds by dtype. Forward: exact max abs error,
#: diagnostics max abs error over the output's max magnitude. Backward:
#: every output's max abs error over its max magnitude in bf16 (u and dl
#: round to bf16 from f32 sums taken in another order), absolute for the
#: exact ones in f32.
FWD_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
BWD_TOL = {"float32": 5e-4, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def script_bodies(script: str, names, seq: int) -> dict:
    """The nested functions ``names`` of ``scripts/<script>``'s ``main()``,
    exec'd from the unedited source with the closure's names bound at
    S = ``seq``."""
    path = os.path.join(ROOT, "scripts", script)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    main = next(node for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name == "main")
    defs = [node for node in main.body
            if isinstance(node, ast.FunctionDef) and node.name in names]
    assert sorted(d.name for d in defs) == sorted(names)
    scope = {"jax": jax, "jnp": jnp, "np": np, "scale": DH ** -0.5,
             "S": seq, "DH": DH}
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"),
         scope)
    return {name: scope[name] for name in names}


def pallas(body, args, n_out: int, dtype):
    """``body`` over (BH, S, 64) ``args`` as the script's ``make`` /
    ``make_bwd`` launch it: one ``(PACK, S, 64)`` block of every operand a
    grid step, in interpret mode (the caller's fixture)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    bh, s, _ = args[0].shape
    spec = pl.BlockSpec((PACK, s, DH), lambda b: (b, 0, 0),
                        memory_space=pltpu.VMEM)
    shape = jax.ShapeDtypeStruct((bh, s, DH), dtype)
    out = pl.pallas_call(
        functools.partial(body, pack=PACK),
        out_shape=(shape,) * n_out if n_out > 1 else shape,
        grid=(bh // PACK,),
        in_specs=[spec] * len(args),
        out_specs=(spec,) * n_out if n_out > 1 else spec)(*args)
    return out if n_out > 1 else (out,)


@pytest.fixture
def interpret_mode(monkeypatch):
    """The scripts' bodies and the JAX package's kernels as the package's
    own tests run them on the CPU: interpret mode."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.delenv("PIGEON_FLASH_FWD", raising=False)
    with pltpu.force_tpu_interpret_mode():
        yield


def operands(n: int, s: int, dtype: str, seed: int = 0):
    """``n`` seeded (BH, S, 64) operands: as JAX arrays in the script's
    layout, and as the port's (B, S, H, 64) tensors of the same values."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed + s)
    arrays = [rng.normal(size=(B * H, s, DH)).astype(np.float32)
              for _ in range(n)]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a.reshape(B, H, s, DH).transpose(0, 2, 1, 3)
                              .copy()).to(tdt) for a in arrays])


def fold(t) -> np.ndarray:
    """A port's (B, S, H, 64) output as the script's (BH, S, 64), f32."""
    b, s, h, dh = t.shape
    return t.float().transpose(1, 2).reshape(b * h, s, dh).numpy()


def assert_close(got, want, tol: float, relative: bool):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    if relative:
        err /= np.abs(want).max()
    assert err <= tol, (err, tol)


# ---------------------------------------------------------------------------
# Plain versions against the scripts' own bodies
# ---------------------------------------------------------------------------

BWD_CASES = [  # (script body, outputs, port plain version, diagnostic)
    ("bwd_r_from_o", 3, bv.bwd_r_from_o_reference, False),
    ("dq_body", 1, bv.attention_dq_reference, False),
    ("dkv_body", 2, bv.attention_dkv_reference, False),
    ("dots_only", 3, bv.bwd_dots_only_reference, True),
    ("vpu_only", 3, bv.bwd_vpu_only_reference, True),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [80, 97])
@pytest.mark.parametrize("body, n_out, plain, diagnostic", BWD_CASES,
                         ids=[c[0] for c in BWD_CASES])
def test_bwd_plain_version_matches_script_body(interpret_mode, body, n_out,
                                               plain, diagnostic, s, dtype):
    fn = script_bodies("bench_attn_bwd.py", [body], s)[body]
    jargs, targs = operands(4, s, dtype)
    want = pallas(fn, jargs, n_out, DTYPES[dtype][0])
    got = tuning.outputs(plain(*targs))
    relative = diagnostic or dtype == "bfloat16"
    for g, w in zip(got[:n_out], want, strict=True):
        assert g.dtype == targs[0].dtype
        assert_close(fold(g), w, BWD_TOL[dtype], relative)


FWD_CASES = [  # (script body, chunk, port plain version, diagnostic)
    ("dots_only", None, fv.fwd_dots_only_reference, True),
    ("softmax_only", None, fv.fwd_softmax_only_reference, True),
    ("qk_only", None, fv.fwd_qk_only_reference, True),
    ("qk_chunked", None, fv.fwd_qk_chunked_reference, True),
    ("online_softmax", 256, fv.flash_attention_online_c256_reference, False),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [80, 97, 300])
@pytest.mark.parametrize("body, chunk, plain, diagnostic", FWD_CASES,
                         ids=[c[0] for c in FWD_CASES])
def test_fwd_plain_version_matches_script_body(interpret_mode, body, chunk,
                                               plain, diagnostic, s, dtype):
    fn = script_bodies("bench_attn_fwd_diag.py", [body], s)[body]
    if chunk:
        fn = functools.partial(fn, chunk=chunk)
    jargs, targs = operands(3, s, dtype)
    (want,) = pallas(fn, jargs, 1, DTYPES[dtype][0])
    got = tuning.outputs(plain(*targs))[0]
    assert got.dtype == targs[0].dtype
    assert_close(fold(got), want, FWD_TOL[dtype], diagnostic)


# ---------------------------------------------------------------------------
# The exact variants against the scripts' references; the side outputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [80, 97])
def test_exact_bwd_variants_match_jax_vjp_of_xla_attention(interpret_mode,
                                                           s):
    """V1, V2 + V3 against the script's reference, ``jax.vjp`` of
    `_xla_attention_bshd` (`bench_attn_bwd.py:232-233`), in f32."""
    from pigeon_tpu.kernels import flash_attention as fa

    jargs, targs = operands(4, s, "float32")
    q, k, v, g = jargs
    want = jax.vjp(fa._xla_attention_bshd, q, k, v)[1](g)
    v1 = bv.bwd_r_from_o_reference(*targs)
    split = (bv.attention_dq_reference(*targs),
             *bv.attention_dkv_reference(*targs))
    for got in (v1, split):
        for a, w in zip(got, want, strict=True):
            assert_close(fold(a), w, BWD_TOL["float32"], False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [80, 300])
def test_v10_matches_jax_flash_forward(interpret_mode, s, dtype):
    """V10's plain version against the JAX package's K3
    (`_flash_forward`, interpret mode), the script's ``base``."""
    from pigeon_tpu.kernels import flash_attention as fa

    jargs, targs = operands(3, s, dtype)
    want = fa._flash_forward(*jargs)
    got = fv.flash_attention_online_c256_reference(*targs)
    assert_close(fold(got), want, FWD_TOL[dtype], False)


def test_side_outputs_keep_the_whole_row():
    """V5's ``dl_abs`` and V8's ``rowsum`` sum over every key, in f64."""
    s = 97
    _, (q, k, v, g) = operands(4, s, "float32")
    qh, kh = (t.double().transpose(1, 2).numpy() for t in (q, k))
    scores = qh @ kh.swapaxes(-1, -2)
    _, rowsum = fv.fwd_qk_only_reference(q, k, v)
    np.testing.assert_allclose(rowsum.numpy(), scores.sum(-1), rtol=1e-4,
                               atol=1e-3)
    logits = scores * DH ** -0.5
    u = np.exp(logits - logits.max(-1, keepdims=True))
    den = u.sum(-1, keepdims=True)
    r = (logits * u).sum(-1, keepdims=True) / den
    dl = u * (logits - r) * (DH ** -0.5 / den)
    *_, dl_abs = bv.bwd_vpu_only_reference(q, k, v, g)
    assert dl_abs.shape == (B, H, s)
    np.testing.assert_allclose(dl_abs.numpy(), np.abs(dl).sum(-1),
                               rtol=1e-5)
    # The first 64 columns are what dq keeps; the rest reach only dl_abs.
    assert np.abs(dl[..., DH:]).sum() > 0.1 * np.abs(dl).sum()


# ---------------------------------------------------------------------------
# Models of the CUDA designs of V10 and V1-V7
# ---------------------------------------------------------------------------

#: log2(e) and c2 = 64^-0.5 log2(e) in f32, as the kernels fold them.
LOG2E = np.float32(1.4426950408889634)
C2 = float(LOG2E / np.float32(8.0))
LOG2E = float(LOG2E)


def v10_model(q, k, v):
    """V10's arithmetic on the card (`csrc/flash_fwd_sm90.cuh` at 256-key
    steps): per step the max of the unscaled scores over all 256 keys,
    ``p = 2^(s c2 - m c2)`` (c2 folded into the exponent), ``p`` rounded
    to ``q.dtype`` against the running max, ``l`` from f32 ``p``."""
    dt = q.dtype
    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
    m = torch.full(qh.shape[:-1] + (1,), -torch.inf)
    den = torch.zeros_like(m)
    acc = torch.zeros_like(qh)
    for c0 in range(0, q.shape[1], 256):
        s = qh @ kh[:, :, c0:c0 + 256].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        mc = m_new * C2
        p = torch.exp2(s * C2 - mc)
        corr = torch.exp2(m * C2 - mc)
        den = den * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(dt).float() @ vh[:, :, c0:c0 + 256]
        m = m_new
    return (acc / den).to(dt).transpose(1, 2).contiguous()


def crafted_operands(s: int, dtype=torch.bfloat16):
    """Seeded q/k/v whose rows take their max in keys 128-255, about 2
    (scaled) above every other key: q's first feature is 4 and the keys
    128-255 have 4 more in theirs. A 128-key online softmax rounds p of
    keys 0-127 against a max that later moves; a 256-key one does not."""
    rng = np.random.default_rng(s)
    q, k, v = (rng.normal(size=(B, s, H, DH)).astype(np.float32)
               for _ in range(3))
    q[..., 0] = 4.0
    k[:, 128:256, :, 0] += 4.0
    return [torch.from_numpy(a).to(dtype) for a in (q, k, v)]


def mean_abs(a, b) -> float:
    return (a.float() - b.float()).abs().mean().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [80, 300, 577])
def test_v10_design_matches_its_plain_version(s, dtype):
    """(a) The model of V10's kernel arithmetic against V10's plain
    version (exp of the scaled scores at chunk 256)."""
    _, (q, k, v) = operands(3, s, dtype)
    assert_close(fold(v10_model(q, k, v)),
                 fold(fv.flash_attention_online_c256_reference(q, k, v)),
                 FWD_TOL[dtype], False)


@pytest.mark.parametrize("s", [300, 577])
def test_v10_design_is_nearer_chunk_256_than_chunk_128(s):
    """(a) On rows whose max lies in keys 128-255 the model of V10 sits
    far nearer the chunk-256 plain version than the chunk-128 one (K3′'s):
    the premise of the card's test that V10 runs 256-key steps."""
    q, k, v = crafted_operands(s)
    logits = (q.float().transpose(1, 2) @ k.float().permute(0, 2, 3, 1)) \
        * DH ** -0.5
    top = logits.argmax(-1)
    assert ((top >= 128) & (top < 256)).float().mean() > 0.98
    margin = logits[..., 128:256].amax(-1) - torch.cat(
        [logits[..., :128], logits[..., 256:]], -1).amax(-1)
    assert 1.5 < margin.mean().item() < 2.5
    got = v10_model(q, k, v)
    near = mean_abs(got, fv.flash_attention_online_c256_reference(q, k, v))
    far = mean_abs(got, k34.flash_attention_online_reference(q, k, v,
                                                             chunk=128))
    assert near < 0.05 * far, (near, far)


def v1_stats_model(q, k, v, g):
    """V1's statistics pass on the card (`flash_bwd_sm90.cuh`,
    ``flash_attention_bwd_stats_from_output_kernel``): sweep 1 the exact
    max of the unscaled scores over 128-key chunks; sweep 2 ``u = 2^(s c2
    - m c2)`` against it, ``den`` and ``o_rec = bf16(u) v`` summed chunk
    by chunk; ``r = sum(g * o_rec / den)``. ``(3, B, H, S)`` in K4's
    workspace units (``m`` of the scaled scores)."""
    dt = q.dtype
    qh, kh, vh, gh = (t.transpose(1, 2).float() for t in (q, k, v, g))
    chunks = range(0, q.shape[1], 128)
    scores = [qh @ kh[:, :, c0:c0 + 128].transpose(-1, -2) for c0 in chunks]
    mc = torch.stack([s.amax(-1) for s in scores]).amax(0) * C2
    den = torch.zeros_like(mc)
    o_rec = torch.zeros_like(qh)
    for c0, s in zip(chunks, scores):
        u = torch.exp2(s * C2 - mc[..., None])
        den = den + u.sum(-1)
        o_rec = o_rec + u.to(dt).float() @ vh[:, :, c0:c0 + 128]
    r = (gh * (o_rec / den[..., None])).sum(-1)
    return torch.stack([mc / LOG2E, den, r])


def k4_grads_from_stats(q, k, v, g, stats):
    """K4's gradient arithmetic (`flash_bwd_sm90.cuh`'s gradient pass) on
    given row statistics: ``u = 2^(s c2 - m log2 e)``, ``g_n =
    bf16(g / den)``, ``dl = bf16(u (dp - r) scale / den)``; ``(dq, dk,
    dv)`` in ``q.dtype``."""
    dt = q.dtype
    qh, kh, vh, gh = (t.transpose(1, 2).float() for t in (q, k, v, g))
    m, den, r = (x[..., None] for x in stats)
    u = torch.exp2((qh @ kh.transpose(-1, -2)) * C2 - m * LOG2E)
    dp = gh @ vh.transpose(-1, -2)
    dl = (u * (dp - r) * (DH ** -0.5 / den)).to(dt).float()
    dv = (u.to(dt).float().transpose(-1, -2) @ (gh / den).to(dt).float())
    return tuple(x.to(dt).transpose(1, 2).contiguous()
                 for x in (dl @ kh, dl.transpose(-1, -2) @ qh, dv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [80, 97])
def test_v1_design_matches_its_plain_version(s, dtype):
    """(b) The model of V1's two-sweep statistics: in f32 its m, den and r
    equal the plain version's within 1e-6 of each one's magnitude; K4's
    gradient arithmetic on them gives the plain version's (dq, dk, dv)
    within the backward bound. K4's own r (from dp) is further off than
    the card's statistics bound in bf16, so that check tells them apart."""
    _, (q, k, v, g) = operands(4, s, dtype)
    stats = v1_stats_model(q, k, v, g)
    want = bv.bwd_r_from_o_stats_reference(q, k, v, g)
    rel = [((a - w).abs().max() / w.abs().max()).item()
           for a, w in zip(stats, want)]
    if dtype == "float32":
        assert max(rel) <= 1e-6, rel
    else:
        assert max(rel) <= 1e-4, rel
        k4_r = k34.flash_attention_backward_stats_reference(q, k, v, g)[2]
        assert ((k4_r - want[2]).abs().max() / want[2].abs().max()) > 2e-4
    for a, w in zip(k4_grads_from_stats(q, k, v, g, stats),
                    bv.bwd_r_from_o_reference(q, k, v, g), strict=True):
        assert_close(fold(a), fold(w), BWD_TOL[dtype], dtype == "bfloat16")


def v2_rows_model(q, k, v, g, stats):
    """V2's dq-rows pass on the card (`flash_bwd_sm90.cuh`,
    ``flash_attention_bwd_rows_dq_kernel``) on given row statistics: per
    128-key chunk ``u = 2^(s c2 - m log2 e)``, ``dl = bf16(u (dp - r)
    scale / den)``, ``dq += dl k_c`` in f32, chunk by chunk; dq in
    ``q.dtype``."""
    dt = q.dtype
    qh, kh, vh, gh = (t.transpose(1, 2).float() for t in (q, k, v, g))
    m, den, r = (x[..., None] for x in stats)
    dq = torch.zeros_like(qh)
    for c0 in range(0, q.shape[1], 128):
        kc, vc = kh[:, :, c0:c0 + 128], vh[:, :, c0:c0 + 128]
        u = torch.exp2((qh @ kc.transpose(-1, -2)) * C2 - m * LOG2E)
        dp = gh @ vc.transpose(-1, -2)
        dl = (u * (dp - r) * (DH ** -0.5 / den)).to(dt).float()
        dq = dq + dl @ kc
    return dq.to(dt).transpose(1, 2).contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [80, 97, 300])
def test_v2_design_matches_its_plain_version(s, dtype):
    """The model of V2 on the card, K4's statistics pass
    (`flash_attention_backward_stats_reference`) then the dq rows over
    128-key chunks, against V2's plain version within the backward
    bound; at S = 300 the rows span three chunks, the last ragged."""
    _, (q, k, v, g) = operands(4, s, dtype)
    stats = k34.flash_attention_backward_stats_reference(q, k, v, g)
    assert_close(fold(v2_rows_model(q, k, v, g, stats)),
                 fold(bv.attention_dq_reference(q, k, v, g)),
                 BWD_TOL[dtype], dtype == "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [80, 97, 300])
def test_v3_design_matches_its_plain_version(s, dtype):
    """V3 on the card is K4's statistics pass, then K4's gradient
    arithmetic without dq: (dk, dv) of `k4_grads_from_stats` on K4's
    statistics against V3's plain version within the backward bound."""
    _, (q, k, v, g) = operands(4, s, dtype)
    stats = k34.flash_attention_backward_stats_reference(q, k, v, g)
    _, dk, dv = k4_grads_from_stats(q, k, v, g, stats)
    for a, w in zip((dk, dv), bv.attention_dkv_reference(q, k, v, g),
                    strict=True):
        assert_close(fold(a), fold(w), BWD_TOL[dtype], dtype == "bfloat16")


def v4_model(q, k, v, g):
    """V4 on the card (`flash_bwd_sm90.cuh`'s gradient pass under
    ``CastChain``, then K4's dq cast): per 128-key tile and 64-query
    chunk, ``s^T = k_t q_c^T`` unscaled and ``dp^T = v_t g_c^T`` in f32,
    ``u = bf16(s)``, ``dl = bf16(s dp)``; ``dv_t += u^T g_c`` and ``dk_t +=
    dl^T q_c`` chunk by chunk, ``dq_c += dl k_t`` summed over the key
    tiles in f32 (the bulk reduce-adds), each cast to ``q.dtype``."""
    dt = q.dtype
    qh, kh, vh, gh = (t.transpose(1, 2).float() for t in (q, k, v, g))
    dq, dk, dv = (torch.zeros_like(qh) for _ in range(3))
    for k0 in range(0, q.shape[1], 128):
        kt, vt = kh[:, :, k0:k0 + 128], vh[:, :, k0:k0 + 128]
        for q0 in range(0, q.shape[1], 64):
            qc, gc = qh[:, :, q0:q0 + 64], gh[:, :, q0:q0 + 64]
            s = kt @ qc.transpose(-1, -2)
            dl = (s * (vt @ gc.transpose(-1, -2))).to(dt).float()
            dv[:, :, k0:k0 + 128] += s.to(dt).float() @ gc
            dk[:, :, k0:k0 + 128] += dl @ qc
            dq[:, :, q0:q0 + 64] += dl.transpose(-1, -2) @ kt
    return tuple(x.to(dt).transpose(1, 2).contiguous() for x in (dq, dk, dv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [80, 97, 300])
def test_v4_design_matches_its_plain_version(s, dtype):
    """The model of V4 on the card, K4's gradient arithmetic with casts
    for the softmax chain over 64-query chunks of 128-key tiles, against
    V4's plain version within the diagnostics' bound; at S = 300 the key
    tiles and query chunks end ragged."""
    _, (q, k, v, g) = operands(4, s, dtype)
    for a, w in zip(v4_model(q, k, v, g), bv.bwd_dots_only_reference(
            q, k, v, g), strict=True):
        assert a.dtype == q.dtype
        assert_close(fold(a), fold(w), tuning.DIAG_TOL, True)


def v5_model(q, k, g):
    """V5 on the card: (a) K4's statistics pass without ``G V^T``
    (`flash_attention_backward_stats_reference`'s order over 128-key
    chunks, with ``dp = s``, the scaled scores), ``dv = bf16(g / den)``
    its ``g_n``; (b) the dl sweep against the final max, ``u = 2^(s c2 -
    m log2 e)``, ``dl = u (s scale - r) scale / den``, ``dq = bf16(q +
    bf16(dl[:, :64]))`` from chunk 0 and ``dl_abs = sum |dl|`` chunk by
    chunk. ``((dq, dk, dv, dl_abs), den)``."""
    dt = q.dtype
    scale = DH ** -0.5
    qh, kh, gh = (t.transpose(1, 2).float() for t in (q, k, g))
    chunks = range(0, q.shape[1], 128)
    m = torch.full(qh.shape[:-1], -torch.inf)
    den, num = torch.zeros_like(m), torch.zeros_like(m)
    for c0 in chunks:
        s = (qh @ kh[:, :, c0:c0 + 128].transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(-1))
        u = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        den = den * corr + u.sum(-1)
        num = num * corr + (s * u).sum(-1)
        m = m_new
    r = (num / den)[..., None]
    dl_abs = torch.zeros_like(m)
    for c0 in chunks:
        s = qh @ kh[:, :, c0:c0 + 128].transpose(-1, -2)
        u = torch.exp2(s * C2 - m[..., None] * LOG2E)
        dl = u * (s * scale - r) * (scale / den[..., None])
        dl_abs = dl_abs + dl.abs().sum(-1)
        if c0 == 0:
            dq = (qh + dl[..., :DH].to(dt).float()).to(dt)
    dv = (gh / den[..., None]).to(dt)
    dq, dv = (x.transpose(1, 2).contiguous() for x in (dq, dv))
    return (dq, k.clone(), dv, dl_abs), den


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [80, 97, 300])
def test_v5_design_matches_its_plain_version(s, dtype):
    """The model of V5 on the card, the online statistics over 128-key
    chunks with dp the scaled scores, then the dl sweep against the final
    max, against V5's plain version within the diagnostics' bound; its dv
    is bf16(g / den) of K4's statistics model bit for bit (den does not
    read dp)."""
    _, (q, k, v, g) = operands(4, s, dtype)
    got, den = v5_model(q, k, g)
    for a, w in zip(got, bv.bwd_vpu_only_reference(q, k, v, g),
                    strict=True):
        assert a.dtype == w.dtype
        assert_close(a.float().numpy(), w.float().numpy(), tuning.DIAG_TOL,
                     True)
    k4_den = k34.flash_attention_backward_stats_reference(q, k, v, g)[1]
    torch.testing.assert_close(den, k4_den, rtol=0, atol=0)
    k4_g_n = (g.transpose(1, 2).float() / k4_den[..., None]).to(q.dtype)
    assert torch.equal(got[2], k4_g_n.transpose(1, 2).contiguous())


def v6_model(q, k, v):
    """V6 on the card (K3's streaming forward under ``CastChain``): per
    128-key chunk ``bf16(s) @ v_c`` of the unscaled scores, summed over
    the chunks in f32, rounded once; no mask (keys past S are absent, as
    their zero rows add 0)."""
    dt = q.dtype
    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
    acc = torch.zeros_like(qh)
    for c0 in range(0, q.shape[1], 128):
        s = qh @ kh[:, :, c0:c0 + 128].transpose(-1, -2)
        acc = acc + s.to(dt).float() @ vh[:, :, c0:c0 + 128]
    return acc.to(dt).transpose(1, 2).contiguous()


def v7_model(q, k, v, correct: bool = True):
    """V7 on the card (K3's streaming forward with ``PV = false``): K3's
    online chain over 128-key chunks (``p = 2^(s c2 - m c2)`` against the
    running max, ``den`` from f32 p); p of keys 0-63 kept from chunk 0
    and rescaled by each later chunk's ``corr``, as K3 rescales o (not
    rescaled where ``correct`` is false); then ``p / den + v``."""
    dt = q.dtype
    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
    m = torch.full(qh.shape[:-1] + (1,), -torch.inf)
    den = torch.zeros_like(m)
    for c0 in range(0, q.shape[1], 128):
        s = qh @ kh[:, :, c0:c0 + 128].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        mc = m_new * C2
        p = torch.exp2(s * C2 - mc)
        corr = torch.exp2(m * C2 - mc)
        den = den * corr + p.sum(-1, keepdim=True)
        if c0 == 0:
            first = p[..., :DH]
        elif correct:
            first = first * corr
        m = m_new
    return (first / den + vh).to(dt).transpose(1, 2).contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [80, 97, 300])
def test_v6_design_matches_its_plain_version(s, dtype):
    """The model of V6 on the card, bf16 scores times V summed chunk by
    chunk in f32, against V6's plain version (one product over all keys)
    within the diagnostics' bound; at S = 300 the last chunk is ragged."""
    _, (q, k, v) = operands(3, s, dtype)
    got = v6_model(q, k, v)
    assert got.dtype == q.dtype
    assert_close(fold(got), fold(fv.fwd_dots_only_reference(q, k, v)),
                 tuning.DIAG_TOL, True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [80, 97, 300])
def test_v7_design_matches_its_plain_version(s, dtype):
    """The model of V7 on the card, K3's online chain with p of keys 0-63
    corrected chunk by chunk, against V7's plain version (exp against the
    exact row max) within the diagnostics' bound."""
    _, (q, k, v) = operands(3, s, dtype)
    got = v7_model(q, k, v)
    assert got.dtype == q.dtype
    assert_close(fold(got), fold(fv.fwd_softmax_only_reference(q, k, v)),
                 tuning.DIAG_TOL, True)


@pytest.mark.parametrize("s", [300, 577])
def test_v7_design_corrects_chunk_0s_p_when_the_max_moves(s):
    """On rows whose max lies in keys 128-255 (about 2 above chunk 0's),
    V7's p of keys 0-63, taken against chunk 0's max, must be rescaled
    by the later chunks' corr: with v = 0 the model's p / den is the
    plain version's within f32 rounding, and without the correction it
    is off by the factor e^2."""
    q, k, v = crafted_operands(s, torch.float32)
    v = torch.zeros_like(v)
    want = fold(fv.fwd_softmax_only_reference(q, k, v))
    assert_close(fold(v7_model(q, k, v)), want, 1e-5, True)
    stale = fold(v7_model(q, k, v, correct=False)) / want
    assert 5.0 < np.median(stale) < 10.0, np.median(stale)


def v8_v9_model(q, k, v, round_first: bool = True):
    """V8 and V9 on the card (K3's streaming forward with ``PV = false``
    under ``SumChain``), in numpy f32: keys zero-padded to 128-key chunks;
    each of a row's four threads (quad) adds its 32 scores of a chunk
    into its partial sum in the kernel's register order (columns 8 g + 2
    quad and 8 g + 2 quad + 1, g = 0..15); the epilogue reduces the four
    partials as its two shuffles do, (l0 + l1) + (l2 + l3); chunk 0's
    scores of keys 0-63 are kept raw. Returns V8's ``(out, rowsum)``,
    ``out = bf16(f32(bf16(s)) + v)`` (``bf16(s + v)`` where
    ``round_first`` is false), and V9's ``bf16(rowsum + v)``. Refuses
    S < 64, as V8's wrapper does."""
    b, s, h, dh = q.shape
    if s < DH:
        raise ValueError(f"S={s} below {DH}")
    qh, kh, vh = (t.float().transpose(1, 2).numpy() for t in (q, k, v))
    n = -(-s // 128) * 128
    kp = np.zeros((b, h, n, dh), np.float32)
    kp[:, :, :s] = kh
    quads = np.zeros((b, h, s, 4), np.float32)
    for c0 in range(0, n, 128):
        sc = (qh @ kp[:, :, c0:c0 + 128].transpose(0, 1, 3, 2)).astype(
            np.float32)
        if c0 == 0:
            first = sc[..., :DH]
        for g in range(16):
            for e in range(2):
                quads += sc[..., 8 * g + 2 * np.arange(4) + e]
    rowsum = (quads[..., 0] + quads[..., 1]) + (quads[..., 2] + quads[..., 3])
    dt = q.dtype
    first, vt = torch.from_numpy(first), torch.from_numpy(vh)
    if round_first:
        first = first.to(dt).float()
    out8 = (first + vt).to(dt)
    out9 = (torch.from_numpy(rowsum)[..., None] + vt).to(dt)
    return ((out8.transpose(1, 2).contiguous(), torch.from_numpy(rowsum)),
            out9.transpose(1, 2).contiguous())


#: The model of V8 and V9 against their plain versions: outputs within
#: two bf16 ulps of their max magnitude (an f32 score or sum taken in
#: another order may round to the neighbouring bf16), rowsum within f32
#: rounding of its max magnitude.
BF16_TOL, F32_TOL = 2.0 ** -7, 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [63, 64, 128, 129, 577])
def test_v8_v9_design_matches_their_plain_versions(s, dtype):
    """The model of V8 and V9 on the card, per-quad partial row sums over
    zero-padded 128-key chunks, against their plain versions (one sum
    over exactly S keys): the chunks' zero rows add exactly 0, so the
    ragged last chunk (S = 129, 577) and the partial one (S = 64) need no
    mask. S = 63 is refused, by the model and by the wrapper's check."""
    _, (q, k, v) = operands(3, s, dtype)
    if s < DH:
        with pytest.raises(ValueError, match="below 64"):
            fv.check_operands(*(t.bfloat16() for t in (q, k, v)),
                              min_seq=DH)
        with pytest.raises(ValueError, match="below 64"):
            v8_v9_model(q, k, v)
        return
    (out8, rowsum), out9 = v8_v9_model(q, k, v)
    want8, want_rowsum = fv.fwd_qk_only_reference(q, k, v)
    assert out8.dtype == out9.dtype == q.dtype
    assert rowsum.shape == want_rowsum.shape == (B, H, s)
    assert_close(rowsum.numpy(), want_rowsum.numpy(), F32_TOL, True)
    assert_close(fold(out8), fold(want8), BF16_TOL, True)
    assert_close(fold(out9), fold(fv.fwd_qk_chunked_reference(q, k, v)),
                 BF16_TOL, True)


def rounding_operands(s: int = 129, dtype=torch.bfloat16):
    """q/k/v whose every score is 1 + 3 * 2^-10 (q's rows (1, 1, 0, ...),
    k's (1, 3 * 2^-10, 0, ...), exact in bf16 and in f32) and v = -1:
    bf16(bf16(s) + v) = bf16(1 - 1) = 0, but bf16(s + v) = 3 * 2^-10."""
    q, k = torch.zeros(2, 1, s, 1, DH)
    q[..., :2] = 1.0
    k[..., 0], k[..., 1] = 1.0, 3 * 2.0 ** -10
    return q.to(dtype), k.to(dtype), torch.full_like(q, -1.0).to(dtype)


def test_v8_design_rounds_the_scores_before_adding_v():
    """V8's output policy rounds o to bf16 before it adds v, as the TPU
    body casts its logits: on scores that bf16 rounds to 1 and v = -1
    the model gives 0, the plain version's output bit for bit, and a
    policy that adds v to the f32 scores first misses by 3 * 2^-10."""
    q, k, v = rounding_operands()
    want = fv.fwd_qk_only_reference(q, k, v)[0]
    assert torch.equal(want, torch.zeros_like(want))
    assert torch.equal(v8_v9_model(q, k, v)[0][0], want)
    wrong = v8_v9_model(q, k, v, round_first=False)[0][0]
    assert (wrong.float() - want.float()).abs().max().item() == 3 * 2.0 ** -10


def test_split_runs_k4s_statistics_pass_under_its_own_tags():
    """The sources: V1-V5 launch K4's passes under their own tags, V2, V3
    and V5 K4's statistics pass (V1 its own, V5 without the dp product,
    DP = false; V4 none); V2's second pass is the dq rows, V3's the
    gradient pass with DQ = false, V4's the gradient pass under its
    CastChain, V5's the dl sweep; the WMMA tile headers of V2 and V3 and
    of V8 and V9 are gone and nothing includes them; no source holds WMMA
    code, and V8 and V9 launch K3's streaming forward under their own
    tags with SumChain and PV = false, their WMMA kernel and launcher
    gone."""
    csrc = os.path.join(ROOT, "pigeon_tpu_torch", "csrc")

    def read(name):
        with open(os.path.join(csrc, name)) as f:
            return f.read()

    variants = read("attention_bwd_variants.cu")
    assert re.findall(r"launch_flash_backward<(\w+), BwdPasses::(\w+)>",
                      variants) == [
        ("V1Attention", "kFromOutput"), ("V2Attention", "kRowsDq"),
        ("V3Attention", "kDkDv"), ("V4Attention", "kDotsOnly"),
        ("V5Attention", "kVpuOnly")]
    header = read("flash_bwd_sm90.cuh")
    assert re.findall(r"return &(flash_attention_bwd_\w+_kernel)<Tag(.*)>;",
                      header) == [
        ("flash_attention_bwd_stats_from_output_kernel", ""),
        ("flash_attention_bwd_stats_kernel", ", P != BwdPasses::kVpuOnly"),
        ("flash_attention_bwd_rows_dq_kernel", ""),
        ("flash_attention_bwd_dl_sweep_kernel", ""),
        ("flash_attention_bwd_grad_kernel", ", true, CastChain"),
        ("flash_attention_bwd_grad_kernel", ", P != BwdPasses::kDkDv")]
    assert re.findall(r"template <class Tag, bool DQ = true, class Chain = "
                      r"SoftmaxChain>\s+__global__[^\n]*\n"
                      r"flash_attention_bwd_grad_kernel", header)
    assert re.findall(r"template <class Tag, bool DP = true>\s+__global__"
                      r"[^\n]*\nflash_attention_bwd_stats_kernel", header)
    assert not os.path.exists(os.path.join(csrc, "attention_bwd_tile.cuh"))
    for name in os.listdir(csrc):
        assert "attention_bwd_tile.cuh" not in read(name), name
    assert not os.path.exists(os.path.join(csrc, "attention_tile.cuh"))
    for name in os.listdir(csrc):
        text = read(name)
        for gone in ("attention_tile.cuh", "wmma::", "mma.h",
                     "fwd_diag_kernel", "launch_diag"):
            assert gone not in text, (name, gone)
    fwd = read("attention_fwd_variants.cu")
    for gone in ("FwdArgs", "DIAG_SMEM", "QK_ONLY", "QK_CHUNKED",
                 "FragBRow", "write_rows", "DOTS_ONLY", "SOFTMAX_ONLY"):
        assert gone not in fwd, gone
    assert re.findall(r"launch_flash_forward<(V[89]\w+), (\w+), FWD_CHUNK,"
                      r"\s*SumChain, false>", fwd) == [
        ("V8Attention", "AttnOutScoresPlusBf16"),
        ("V9Attention", "AttnOutSumPlusBf16")]


def test_v6_and_v7_run_k3s_forward_under_their_own_tags():
    """The sources: V6-V9 launch K3's streaming forward at 128-key steps
    under their own tags, V6 under CastChain, V7 with PV = false and its
    output policy (o / l + v, reading v), V8 and V9 under SumChain with
    PV = false and theirs (V8 also writing rowsum), beside V10 at 256-key
    steps; the kernel and its launcher take the chain and the flag as
    template parameters whose defaults are K3's, so K3, K3′ and the
    attention of K1 and K5-K8 launch as before; SumChain's epilogue
    reduces l as the softmax's does; no source includes both the forward
    and the backward, whose chain policies share names."""
    from pigeon_tpu_torch import native

    csrc = os.path.join(ROOT, "pigeon_tpu_torch", "csrc")

    def read(name):
        with open(os.path.join(csrc, name)) as f:
            return f.read()

    launches = re.findall(
        r"launch_flash_forward<(\w+),\s*(\w+),\s*(\w+)(?:,\s*(\w+))?"
        r"(?:,\s*(\w+))?>", read("attention_fwd_variants.cu"))
    assert launches == [
        ("V10OnlineForward", "AttnOutBf16", "256", "", ""),
        ("V6Attention", "AttnOutBf16", "FWD_CHUNK", "CastChain", ""),
        ("V7Attention", "AttnOutPlusBf16", "FWD_CHUNK", "SoftmaxChain",
         "false"),
        ("V8Attention", "AttnOutScoresPlusBf16", "FWD_CHUNK", "SumChain",
         "false"),
        ("V9Attention", "AttnOutSumPlusBf16", "FWD_CHUNK", "SumChain",
         "false")]
    header = read("flash_fwd_sm90.cuh")
    chains = dict(re.findall(r"struct (\w+Chain) \{\s+static constexpr "
                             r"bool kSoftmax = \w+;\s+static constexpr "
                             r"bool kSums = (\w+);", header))
    assert chains == {"SoftmaxChain": "true", "CastChain": "false",
                      "SumChain": "true"}
    assert "if constexpr (Chain::kSums) {" in header
    assert re.findall(r"template <class Tag, class Out, int STEP, class "
                      r"Chain, bool PV>\s+__global__[^\n]*\n"
                      r"flash_attention_kernel_wgmma", header)
    assert re.findall(r"template <class Tag, class Out = AttnOutBf16, int "
                      r"STEP = FWD_CHUNK,\s+class Chain = SoftmaxChain, "
                      r"bool PV = true>\s+inline cudaError_t "
                      r"launch_flash_forward", header)
    for src, tag in (("flash_attention.cu", "K3Forward"),
                     ("flash_attention_online.cu", "K3OnlineForward")):
        assert re.findall(r"launch_flash_forward<(\w+)>", read(src)) == [tag]
    assert re.findall(r"launch_flash_forward<(\w+), (\w+)>\(",
                      read("qkv_forward_sm90.cuh")) == [("AttentionTag",
                                                        "Attention")]
    for name in os.listdir(csrc):
        if name.endswith(".cu"):
            closure = {os.path.basename(p) for p in native.source_closure(
                os.path.join(csrc, name))}
            assert not {"flash_fwd_sm90.cuh",
                        "flash_bwd_sm90.cuh"} <= closure, name


# ---------------------------------------------------------------------------
# Dispatch, operand checks, K3′'s chunk
# ---------------------------------------------------------------------------

WRAPPERS = [
    (bv.bwd_r_from_o, bv.bwd_r_from_o_reference, 4),
    (bv.attention_dq, bv.attention_dq_reference, 4),
    (bv.attention_dkv, bv.attention_dkv_reference, 4),
    (bv.bwd_dots_only, bv.bwd_dots_only_reference, 4),
    (bv.bwd_vpu_only, bv.bwd_vpu_only_reference, 4),
    (fv.fwd_dots_only, fv.fwd_dots_only_reference, 3),
    (fv.fwd_softmax_only, fv.fwd_softmax_only_reference, 3),
    (fv.fwd_qk_only, fv.fwd_qk_only_reference, 3),
    (fv.fwd_qk_chunked, fv.fwd_qk_chunked_reference, 3),
    (fv.flash_attention_online_c256,
     fv.flash_attention_online_c256_reference, 3),
]


@pytest.mark.parametrize("wrapper, plain, n_in", WRAPPERS,
                         ids=[w[0].__name__ for w in WRAPPERS])
def test_wrappers_dispatch_by_device(wrapper, plain, n_in):
    """A CPU tensor runs the plain version and counts no launch; a device
    with no kernel raises."""
    _, args = operands(n_in, 80, "bfloat16")
    before = wrapper.launches
    for a, w in zip(tuning.outputs(wrapper(*args)),
                    tuning.outputs(plain(*args)), strict=True):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    assert wrapper.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        wrapper(*(a.to("meta") for a in args))


def test_bwd_operand_checks():
    _, (q, k, v, g) = operands(4, 80, "bfloat16")
    bv.check_operands(q, k, v, g, min_seq=64)
    with pytest.raises(ValueError, match="below 64"):
        bv.check_operands(*(t[:, :63].contiguous() for t in (q, k, v, g)),
                          min_seq=64)
    with pytest.raises(TypeError, match="bf16"):
        bv.check_operands(q, k, v, g.float())
    with pytest.raises(ValueError, match="shape"):
        bv.check_operands(q, k, v, g[:, :40].contiguous())
    with pytest.raises(ValueError, match="head_dim"):
        bv.check_operands(*(torch.zeros(1, 8, 1, 32, dtype=torch.bfloat16)
                            for _ in range(4)))
    with pytest.raises(ValueError, match="contiguous"):
        bv.check_operands(q, k, v, g.transpose(1, 2).contiguous()
                          .transpose(1, 2))


def test_fwd_operand_checks():
    _, (q, k, v) = operands(3, 80, "bfloat16")
    fv.check_operands(q, k, v, min_seq=64)
    with pytest.raises(ValueError, match="below 64"):
        fv.check_operands(*(t[:, :40].contiguous() for t in (q, k, v)),
                          min_seq=64)
    with pytest.raises(TypeError, match="bf16"):
        fv.check_operands(q, k.float(), v)
    with pytest.raises(ValueError, match="shape"):
        fv.check_operands(q, k[:, :40].contiguous(), v)


def test_k3_online_keeps_chunk_128_and_v10_runs_256():
    """K3′'s entry point stays at 128-key chunks (its plain version, and
    its CUDA entry point, which launches K3's streaming forward with its
    128-key chunks); V10 is the online body at 256 (its CUDA entry point
    launches the same forward at 256-key steps under its own tag), and in
    bf16 the two differ where S spans several chunks."""
    assert k34.ONLINE_CHUNK == 128 and fv.CHUNK_256 == 256
    with open(os.path.join(ROOT, "pigeon_tpu_torch", "csrc",
                           "flash_attention_online.cu")) as f:
        assert re.findall(r"launch_flash_forward<(\w+)>",
                          f.read()) == ["K3OnlineForward"]
    with open(os.path.join(ROOT, "pigeon_tpu_torch", "csrc",
                           "flash_fwd_sm90.cuh")) as f:
        assert re.findall(r"constexpr int FWD_CHUNK = (\d+);",
                          f.read()) == ["128"]
    with open(os.path.join(ROOT, "pigeon_tpu_torch", "csrc",
                           "attention_fwd_variants.cu")) as f:
        assert re.findall(r"launch_flash_forward<(\w+), (\w+), (\d+)>",
                          f.read()) == [("V10OnlineForward", "AttnOutBf16",
                                         "256")]
    _, (q, k, v) = operands(3, 300, "bfloat16")
    k3p = k34.flash_attention_online(q, k, v)
    torch.testing.assert_close(
        k3p, k34.flash_attention_online_reference(q, k, v, chunk=128),
        rtol=0, atol=0)
    assert not torch.equal(k3p, fv.flash_attention_online_c256(q, k, v))


# ---------------------------------------------------------------------------
# The drivers
# ---------------------------------------------------------------------------

def load_module(path: str):
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(path))[0], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(name: str):
    return load_module(os.path.join(ROOT, "scripts", f"{name}.py"))


def jax_variant_names(script: str) -> list:
    """The keys of the ``variants = {...}`` literal in a TPU script's
    ``main()``."""
    with open(os.path.join(ROOT, "scripts", script)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "variants"):
            return [ast.literal_eval(key) for key in node.value.keys]
    raise AssertionError(f"no variants literal in {script}")


def test_bwd_driver_runs_the_script_variants_on_the_cpu():
    driver = load_driver("bench_torch_attn_bwd")
    _, args = operands(4, 80, "bfloat16")
    variants = driver.variants(*args)
    assert [v.name for v in variants] == jax_variant_names(
        "bench_attn_bwd.py")
    kernels = {v.name: [p.kernel for p in v.parts] for v in variants}
    assert kernels["split4"] == ["attention_dq", "attention_dkv"]
    assert kernels["r_from_o_pack1"] == ["bwd_r_from_o"]
    for variant in variants:
        errs = tuning.check(variant)
        assert all(e == (0.0, 0.0) for e in errs.values())
    # The exact variants stay close to the script's reference, the
    # autograd VJP of the einsum attention.
    xla = driver.xla_grads(*(a.float() for a in args))
    for a, w in zip(variants[2](), xla, strict=True):
        assert ((a.float() - w).abs().max() / w.abs().max()).item() < 2e-2


@pytest.mark.parametrize("s", [80, 300])
def test_bwd_driver_composition_computes_v4s_function(s):
    """The driver's yardstick of V4, its five products as library calls,
    computes V4's function: within the diagnostics' bound of V4's plain
    version (its scores rounded to bf16 by the product), in V4's
    layout."""
    driver = load_driver("bench_torch_attn_bwd")
    _, args = operands(4, s, "bfloat16")
    got = driver.dots_only_composition(*args)
    want = bv.bwd_dots_only_reference(*args)
    assert [t.shape for t in got] == [t.shape for t in want]
    assert tuning.errors(got, want)[1] <= tuning.DIAG_TOL


@pytest.mark.parametrize("s", [80, 300])
@pytest.mark.parametrize("kernel", ["fwd_dots_only", "fwd_softmax_only",
                                    "fwd_qk_only", "fwd_qk_chunked"])
def test_fwd_driver_compositions_compute_their_variants_function(kernel, s):
    """The forward driver's yardsticks of V6-V9, each diagnostic's
    function in library calls (bf16 matmuls, whose scores round to bf16),
    compute that function: within the diagnostics' bound of its plain
    version, in its layout and types."""
    driver = load_driver("bench_torch_attn_fwd_diag")
    _, args = operands(3, s, "bfloat16")
    got = tuning.outputs(driver.COMPOSITIONS[kernel](*args))
    want = tuning.outputs(getattr(fv, f"{kernel}_reference")(*args))
    assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype)
                                                 for t in want]
    assert tuning.errors(got, want)[1] <= tuning.DIAG_TOL


@pytest.mark.parametrize("s", [300, 577])
def test_fwd_driver_checks_v7_with_v_zero(monkeypatch, s):
    """The forward driver's check of V7 with v = 0 on seeded operands
    (not crafted ones): it passes the model of V7's kernel and refuses,
    at more than 10 times the diagnostics' bound, the model whose p of
    keys 0-63 missed the later chunks' corr."""
    driver = load_driver("bench_torch_attn_fwd_diag")
    _, (q, k) = operands(2, s, "bfloat16")
    monkeypatch.setattr(fv, "fwd_softmax_only", v7_model)
    rec = driver.softmax_only_without_v(q, k)
    assert rec["check"] == "fwd_softmax_only_v_zero"
    assert rec["max_err_vs_plain"] <= tuning.DIAG_TOL
    assert rec["max_magnitude"] > 0
    monkeypatch.setattr(fv, "fwd_softmax_only", functools.partial(
        v7_model, correct=False))
    with pytest.raises(RuntimeError, match="v = 0") as err:
        driver.softmax_only_without_v(q, k)
    assert float(str(err.value).split("relative error ")[1].split()[0]) \
        > 10 * tuning.DIAG_TOL


def test_sass_comparison_pairs_mangled_kernels_across_builds():
    """`scripts/compare_torch_sass.py` keys a kernel whose name stays
    mangled without the hashes that each build puts in its anonymous
    namespace's name, so two checkouts' instances pair, and keeps the
    template argument that tells them apart; other names are untouched."""
    compare = load_module(os.path.join(ROOT, "scripts",
                                       "compare_torch_sass.py"))
    name = ("_ZN58_GLOBAL__N__{}_25_attention_fwd_variants_cu_9e1bd01b"
            "15fwd_diag_kernelILi{}EEEvNS_7FwdArgsE")
    here, there = (compare.stable(name.format(h, 2))
                   for h in ("3b9d1546", "85a163e7"))
    assert here == there and len(here) == len(name.format("3b9d1546", 2))
    assert compare.stable(name.format("3b9d1546", 3)) != here
    assert compare.stable("_Z3fooi") == "_Z3fooi"


def test_smoke_tables_name_the_drivers_variants_and_yardsticks():
    """`chip_smoke.py`'s [variants] tables name what the drivers make:
    each pair's variants (V8 and V9 beside K3 too), each tuning kernel's
    yardstick (a record the drivers time) and each forward tag (a kernel
    instance's tag type in the sources); the walk's differences read
    wrappers whose differences from K3 are taken; V8's and V9's kernels
    are among those [sass] holds to no MUFU.EX2."""
    smoke = load_module(os.path.join(ROOT, "chip_smoke.py"))
    _, args3 = operands(3, 80, "bfloat16")
    _, args4 = operands(4, 80, "bfloat16")
    names = {v.name for v in load_driver("bench_torch_attn_fwd_diag")
             .variants(*args3)}
    names |= {v.name for v in load_driver("bench_torch_attn_bwd")
              .variants(*args4)}
    assert {n for pair in smoke.VARIANT_PAIRS for n in pair} <= names
    sources = ""
    for name in smoke.DRIVERS:
        with open(os.path.join(ROOT, "scripts", f"{name}.py")) as f:
            sources += f.read()
    fwd = load_driver("bench_torch_attn_fwd_diag")
    for kernel, yardstick in smoke.VARIANT_LIBRARY.items():
        assert kernel in smoke.VARIANT_WORK
        assert (f'"yardstick": "{yardstick}"' in sources or yardstick in
                [f"{k}_composition" for k in fwd.COMPOSITIONS]), yardstick
    fwd_diffs = {name for _, name in smoke.FWD_DIFFS}
    assert {n for pair in smoke.FWD_WALK_DIFFS for n in pair} <= fwd_diffs
    assert {"diag_qk_only_p4", "diag_qk_chunked_p4"} <= {
        name for name, beside in smoke.VARIANT_PAIRS
        if beside == "base_fwd_pack4"}
    assert set(smoke.SASS_EXPS) | set(smoke.SASS_NO_EXPS) <= set(
        smoke.SASS_TAGS)
    assert not set(smoke.SASS_EXPS) & set(smoke.SASS_NO_EXPS)
    assert {"V8Attention", "V9Attention"} <= set(smoke.SASS_NO_EXPS)
    for tags, passes, diffs in ((smoke.FWD_TAGS, smoke.FWD_PASSES,
                                 smoke.FWD_DIFFS),
                                (smoke.BWD_TAGS, smoke.BWD_PASSES,
                                 smoke.BWD_DIFFS)):
        labels = {label for label, _ in passes}
        assert {name for _, name in diffs} <= {name for name, _, _ in tags}
        assert all(set(launched) <= labels for _, _, launched in tags)
        assert {label for label, _ in diffs} <= labels
    csrc = os.path.join(ROOT, "pigeon_tpu_torch", "csrc")
    text = ""
    for name in os.listdir(csrc):
        with open(os.path.join(csrc, name)) as f:
            text += f.read()
    for _, tag, _ in smoke.FWD_TAGS:
        assert re.search(rf"struct {tag} {{}};", text), tag
    for tag in smoke.SASS_TAGS:
        assert re.search(rf"struct {tag} {{}};", text), tag


def test_fwd_and_qkv_drivers_run_the_script_variants_on_the_cpu():
    fwd = load_driver("bench_torch_attn_fwd_diag")
    _, args = operands(3, 80, "bfloat16")
    variants = fwd.variants(*args)
    assert [v.name for v in variants] == jax_variant_names(
        "bench_attn_fwd_diag.py")
    for variant in variants:
        tuning.check(variant)
    qkv = load_driver("bench_torch_attn_qkv_fused")
    rng = torch.Generator().manual_seed(0)
    d, heads = 128, 2
    x = torch.randn(2, 40, d, generator=rng).bfloat16()
    ws = [(torch.randn(d, d, generator=rng) * 0.02).bfloat16()
          for _ in range(3)]
    bs = [(torch.randn(d, generator=rng) * 0.02).bfloat16()
          for _ in range(3)]
    ls, lb = torch.ones(d), torch.zeros(d)
    variants = qkv.variants(x, ls, lb, ws, bs, heads)
    assert [v.name for v in variants] == [
        "baseline_xla_proj_flash", "fused", "ln_xla_then_fused",
        "ln_fused_in_kernel"]
    outs = {}
    for variant in variants:
        tuning.check(variant)
        outs[variant.name] = variant()[0].float()
    assert (outs["fused"] - outs["baseline_xla_proj_flash"]).abs().max() \
        < qkv.FAMILY_TOL
    assert (outs["ln_fused_in_kernel"] - outs["ln_xla_then_fused"]).abs() \
        .max() < qkv.FAMILY_TOL


def test_drivers_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("bench_torch_attn_bwd", "bench_torch_attn_fwd_diag",
                 "bench_torch_attn_qkv_fused"):
        with pytest.raises(SystemExit):
            load_driver(name).run(1, 1, 1)


def test_check_refuses_a_variant_off_its_plain_version():
    _, (q, k, v) = operands(3, 80, "bfloat16")
    wrong = tuning.Variant("wrong", [tuning.Part(
        "fwd_dots_only", lambda: fv.fwd_dots_only_reference(q, k, v) * 1.1,
        lambda: fv.fwd_dots_only_reference(q, k, v))], tuning.DIAG_TOL,
        True)
    with pytest.raises(RuntimeError, match="disagrees"):
        tuning.check(wrong)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b, s, heads", [(1, 64, 1), (2, 65, 2), (2, 97, 2),
                                         (2, 127, 2), (2, 129, 2),
                                         (1, 255, 2), (1, 256, 2),
                                         (1, 257, 2), (1, 385, 2),
                                         (1, 640, 2), (32, 577, 16)])
@pytest.mark.parametrize("wrapper, plain, n_in", WRAPPERS,
                         ids=[w[0].__name__ for w in WRAPPERS])
def test_cuda_variant_matches_plain_version(cuda, wrapper, plain, n_in, b, s,
                                            heads):
    gen = torch.Generator(device=cuda).manual_seed(s)
    args = tuning.normal(gen, n_in, (b, s, heads, DH))
    before = wrapper.launches
    got = tuning.outputs(wrapper(*args))
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = tuning.outputs(plain(*args))
    abs_err, rel_err = tuning.errors(got, want)
    if wrapper is fv.flash_attention_online_c256:
        assert abs_err <= tuning.FWD_TOL
    elif n_in == 4 and wrapper not in (bv.bwd_dots_only, bv.bwd_vpu_only):
        assert rel_err <= tuning.BWD_TOL
    else:
        assert rel_err <= tuning.DIAG_TOL


#: V1's statistics workspace against the plain version's, each row's max
#: abs error over its max magnitude: m and den at K4's statistics bound
#: (f32 sums over 128-key chunks in another order, exp2 with log2(e)
#: folded in); r also takes bf16(u), which one f32 ulp of u can flip at
#: a rounding boundary, moving r by 2^-8 u g.v / den for that key.
STATS_TOL, R_TOL = 1e-4, 2e-3


#: The outputs of V1-V3 that are 0 by the math at S = 1 (dq and dk).
ZERO_AT_ONE_KEY = {"bwd_r_from_o": (0, 1), "attention_dq": (0,),
                   "attention_dkv": (0,)}


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 64, 65, 127, 128, 129, 255, 256, 257, 384,
                               385, 577])
@pytest.mark.parametrize("wrapper, plain, n_in",
                         [*WRAPPERS[:3], WRAPPERS[-1]],
                         ids=["bwd_r_from_o", "attention_dq", "attention_dkv",
                              "flash_attention_online_c256"])
def test_cuda_v1_and_v10_at_ragged_steps(cuda, wrapper, plain, n_in, s):
    """V10's last 256-key step may hold one 128-key half (S in (256k,
    256k + 128]) or a ragged second half; V1's sweeps, V2's dq rows and
    V3's gradient pass end on a ragged chunk."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    args = tuning.normal(gen, n_in, (2, s, 2, DH))
    got = tuning.outputs(wrapper(*args))
    torch.cuda.synchronize()
    want = tuning.outputs(plain(*args))
    if n_in == 3:
        assert tuning.errors(got, want)[0] <= tuning.FWD_TOL
    elif s == 1:
        # One key: dq and dk are 0 (dp - r = g.v - g.v, the two sums taken
        # in other orders leave f32 rounding, ~1e-7); dv = g.
        zero = ZERO_AT_ONE_KEY[wrapper.__name__]
        rest = [i for i in range(len(got)) if i not in zero]
        assert tuning.errors([got[i] for i in zero],
                             [want[i] for i in zero])[0] <= 1e-5
        if rest:
            assert tuning.errors([got[i] for i in rest],
                                 [want[i] for i in rest])[1] \
                <= tuning.BWD_TOL
    else:
        assert tuning.errors(got, want)[1] <= tuning.BWD_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("b, s, heads", [(2, 129, 2), (4, 577, 4),
                                         (32, 577, 16)])
def test_cuda_v2_and_v3_repeat_bit_for_bit(cuda, b, s, heads):
    """V2 keeps each row's dq in registers and sums it over the key
    chunks in one order, so two calls give the same bits (K4's dq, summed
    by bulk reduce-adds in the order they land, need not); V3's dk and dv
    are register sums of one block too."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    args = tuning.normal(gen, 4, (b, s, heads, DH))
    first = (bv.attention_dq(*args), *bv.attention_dkv(*args))
    second = (bv.attention_dq(*args), *bv.attention_dkv(*args))
    torch.cuda.synchronize()
    for a, w in zip(first, second, strict=True):
        assert torch.equal(a, w)


@pytest.mark.gpu
@pytest.mark.parametrize("name, n_out", [("dq", 1), ("dkv", 2)])
@pytest.mark.parametrize("b, s, heads", [(2, 80, 2), (2, 97, 2), (1, 385, 2),
                                         (4, 577, 4)])
def test_cuda_v2_and_v3_statistics_are_k4s(cuda, name, n_out, b, s, heads):
    """V2 and V3 launched through ``_launch`` with workspaces the test
    holds: K4's statistics pass wrote m, den and r, each within
    `STATS_TOL` of K4's plain statistics pass, and the gradients are
    within the backward bound."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v, g = tuning.normal(gen, 4, (b, s, heads, DH))
    stats, g_n = bv._stats_workspaces(q)
    outs = [torch.empty_like(q) for _ in range(n_out)]
    bv._launch(name, q, k, v, g, *outs, stats, g_n)
    torch.cuda.synchronize()
    want = k34.flash_attention_backward_stats_reference(q, k, v, g)
    for got_row, want_row in zip(stats, want, strict=True):
        err = ((got_row - want_row).abs().max() / want_row.abs().max())
        assert err.item() <= STATS_TOL
    plain = (bv.attention_dq_reference if name == "dq"
             else bv.attention_dkv_reference)
    assert tuning.errors(outs, tuning.outputs(plain(q, k, v, g)))[1] \
        <= tuning.BWD_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("s", [300, 577])
def test_cuda_v10_is_nearer_its_chunk_256_plain_version(cuda, s):
    """(c) On rows whose max lies in keys 128-255, V10 sits nearer the
    chunk-256 plain version than the chunk-128 one, and K3′ (128-key
    steps) the other way round: V10 is not K3′'s instance."""
    q, k, v = (t.to(cuda) for t in crafted_operands(s))
    c256 = fv.flash_attention_online_c256_reference(q, k, v)
    c128 = k34.flash_attention_online_reference(q, k, v, chunk=128)
    v10 = fv.flash_attention_online_c256(q, k, v)
    k3p = k34.flash_attention_online(q, k, v)
    torch.cuda.synchronize()
    assert mean_abs(v10, c256) < 0.25 * mean_abs(v10, c128)
    assert mean_abs(k3p, c128) < 0.25 * mean_abs(k3p, c256)


@pytest.mark.gpu
@pytest.mark.parametrize("b, s, heads", [(2, 80, 2), (2, 97, 2), (1, 385, 2),
                                         (4, 577, 4)])
def test_cuda_v1_statistics_take_r_from_the_output(cuda, b, s, heads):
    """(d) V1 launched through ``_launch`` with workspaces the test holds:
    its statistics agree with the plain version's (m and den within
    `STATS_TOL`, r within `R_TOL`); r's mean error is far below that of
    K4's r (from dp and f32 u) against the same plain r, so the check
    tells the two apart; the gradients are within the backward bound."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v, g = tuning.normal(gen, 4, (b, s, heads, DH))
    ws = k34.backward_workspaces(q)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    bv._launch("bwd_r_from_o", q, k, v, g, dq, dk, dv, *ws)
    torch.cuda.synchronize()
    want = bv.bwd_r_from_o_stats_reference(q, k, v, g)

    def rel(a, w):
        return ((a - w).abs().max() / w.abs().max()).item()

    for got_row, want_row, tol in zip(ws.stats, want,
                                      (STATS_TOL, STATS_TOL, R_TOL)):
        assert rel(got_row, want_row) <= tol
    k4_r = k34.flash_attention_backward_stats_reference(q, k, v, g)[2]
    assert mean_abs(ws.stats[2], want[2]) < 0.25 * mean_abs(k4_r, want[2])
    _, rel_err = tuning.errors((dq, dk, dv),
                               bv.bwd_r_from_o_reference(q, k, v, g))
    assert rel_err <= tuning.BWD_TOL


#: V4 and V5 at the ragged steps of V1-V3 (V5 from S = 64: the TPU body
#: slices 64 key columns).
V4_V5_STEPS = [(wrapper, s)
               for wrapper in (bv.bwd_dots_only, bv.bwd_vpu_only)
               for s in (1, 64, 65, 127, 128, 129, 255, 256, 257, 384, 385,
                         577)
               if wrapper is bv.bwd_dots_only or s >= DH]


@pytest.mark.gpu
@pytest.mark.parametrize("wrapper, s", V4_V5_STEPS,
                         ids=[f"{w.__name__}-{s}" for w, s in V4_V5_STEPS])
def test_cuda_v4_and_v5_at_ragged_steps(cuda, wrapper, s):
    """V4's gradient pass ends on a ragged key tile and query chunk, V5's
    statistics pass and dl sweep on a ragged key chunk: each output
    within the diagnostics' bound of its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    args = tuning.normal(gen, 4, (2, s, 2, DH))
    plain = {bv.bwd_dots_only: bv.bwd_dots_only_reference,
             bv.bwd_vpu_only: bv.bwd_vpu_only_reference}[wrapper]
    got = tuning.outputs(wrapper(*args))
    torch.cuda.synchronize()
    assert tuning.errors(got, tuning.outputs(plain(*args)))[1] \
        <= tuning.DIAG_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("b, s, heads", [(2, 129, 2), (4, 577, 4),
                                         (32, 577, 16)])
def test_cuda_v4_and_v5_repeat_bit_for_bit(cuda, b, s, heads):
    """V4's dk and dv are register sums of one block, and V5's four
    outputs are formed in one order, so two calls give the same bits
    (V4's dq, summed by bulk reduce-adds in the order they land, need
    not)."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    args = tuning.normal(gen, 4, (b, s, heads, DH))
    first = (*bv.bwd_dots_only(*args)[1:], *bv.bwd_vpu_only(*args))
    second = (*bv.bwd_dots_only(*args)[1:], *bv.bwd_vpu_only(*args))
    torch.cuda.synchronize()
    for a, w in zip(first, second, strict=True):
        assert torch.equal(a, w)


@pytest.mark.gpu
@pytest.mark.parametrize("b, s, heads", [(2, 80, 2), (2, 97, 2), (1, 385, 2),
                                         (4, 577, 4)])
def test_cuda_v5_dv_is_k4s_g_n(cuda, b, s, heads):
    """V5 launched through ``_launch`` with a statistics workspace the
    test holds: its statistics pass forms m and den by K4's operations
    (dp does not reach them), so they and its dv = bf16(g / den) are K4's
    m, den and g_n on the same q/k/g bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v, g = tuning.normal(gen, 4, (b, s, heads, DH))
    ws = k34.backward_workspaces(q)
    k34.flash_attention_backward_into(q, k, v, g, ws)
    stats = bv._stats(q)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dl_abs = torch.empty((b, heads, s), dtype=torch.float32, device=cuda)
    bv._launch("bwd_vpu_only", q, k, v, g, dq, dk, dv, dl_abs, stats)
    torch.cuda.synchronize()
    assert torch.equal(stats[:2], ws.stats[:2])
    assert torch.equal(dv, ws.g_n)


#: V6 and V7 at the ragged steps of K3's 128-key chunks (V7 from S = 64:
#: the TPU body slices 64 key columns).
V6_V7_STEPS = [(wrapper, s)
               for wrapper in (fv.fwd_dots_only, fv.fwd_softmax_only)
               for s in (64, 65, 127, 128, 129, 255, 256, 257, 577)]
FWD_PLAIN = {fv.fwd_dots_only: fv.fwd_dots_only_reference,
             fv.fwd_softmax_only: fv.fwd_softmax_only_reference}


@pytest.mark.gpu
@pytest.mark.parametrize("wrapper, s", V6_V7_STEPS,
                         ids=[f"{w.__name__}-{s}" for w, s in V6_V7_STEPS])
def test_cuda_v6_and_v7_at_ragged_steps(cuda, wrapper, s):
    """V6's and V7's last 128-key chunk may be ragged (V6's keys past S
    unmasked, scoring 0 against zero rows of K and V; V7's masked): each
    output within the diagnostics' bound of its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    args = tuning.normal(gen, 3, (2, s, 2, DH))
    got = tuning.outputs(wrapper(*args))
    torch.cuda.synchronize()
    assert tuning.errors(got, tuning.outputs(FWD_PLAIN[wrapper](*args)))[1] \
        <= tuning.DIAG_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("b, s, heads", [(2, 129, 2), (4, 577, 4),
                                         (32, 577, 16)])
def test_cuda_v6_and_v7_repeat_bit_for_bit(cuda, b, s, heads):
    """V6 and V7 keep each row's sums in registers and take them in one
    order, so two calls give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    args = tuning.normal(gen, 3, (b, s, heads, DH))
    first = (fv.fwd_dots_only(*args), fv.fwd_softmax_only(*args))
    second = (fv.fwd_dots_only(*args), fv.fwd_softmax_only(*args))
    torch.cuda.synchronize()
    for a, w in zip(first, second, strict=True):
        assert torch.equal(a, w)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [300, 577])
def test_cuda_v7_corrects_chunk_0s_p_when_the_max_moves(cuda, s):
    """On rows whose max lies in keys 128-255, V7 rescales p of keys 0-63
    (taken against chunk 0's max) by the later chunks' corr: with v = 0
    its output is p / den alone, within the diagnostics' bound of the
    plain version, where p left at chunk 0's max would be e^2 times too
    large; with the crafted v as well."""
    q, k, v = (t.to(cuda) for t in crafted_operands(s))
    for vv in (torch.zeros_like(v), v):
        got = fv.fwd_softmax_only(q, k, vv)
        torch.cuda.synchronize()
        want = fv.fwd_softmax_only_reference(q, k, vv)
        assert tuning.errors([got], [want])[1] <= tuning.DIAG_TOL


#: V8 and V9 at the ragged steps of K3's 128-key chunks (V8 from S = 64:
#: the TPU body slices 64 key columns).
V8_V9_STEPS = [(wrapper, s)
               for wrapper in (fv.fwd_qk_only, fv.fwd_qk_chunked)
               for s in (1, 64, 65, 127, 128, 129, 255, 256, 257, 577)
               if wrapper is fv.fwd_qk_chunked or s >= DH]
FWD_PLAIN.update({fv.fwd_qk_only: fv.fwd_qk_only_reference,
                  fv.fwd_qk_chunked: fv.fwd_qk_chunked_reference})


@pytest.mark.gpu
@pytest.mark.parametrize("wrapper, s", V8_V9_STEPS,
                         ids=[f"{w.__name__}-{s}" for w, s in V8_V9_STEPS])
def test_cuda_v8_and_v9_at_ragged_steps(cuda, wrapper, s):
    """V8's and V9's last 128-key chunk may be ragged or the only, partial
    one (keys past S unmasked, scoring 0 against zero K rows): each output
    within the diagnostics' bound of its plain version, and V8's rowsum,
    an f32 sum over exactly S keys, within f32 rounding of its own."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    args = tuning.normal(gen, 3, (2, s, 2, DH))
    got = tuning.outputs(wrapper(*args))
    torch.cuda.synchronize()
    want = tuning.outputs(FWD_PLAIN[wrapper](*args))
    assert tuning.errors(got, want)[1] <= tuning.DIAG_TOL
    if wrapper is fv.fwd_qk_only:
        assert_close(got[1].cpu().numpy(), want[1].cpu().numpy(), F32_TOL,
                     True)


@pytest.mark.gpu
@pytest.mark.parametrize("b, s, heads", [(2, 129, 2), (4, 577, 4),
                                         (32, 577, 16)])
def test_cuda_v8_and_v9_repeat_bit_for_bit(cuda, b, s, heads):
    """V8 and V9 keep each row's sums in registers and take them in one
    order, so two calls give the same bits, V8's rowsum too."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    args = tuning.normal(gen, 3, (b, s, heads, DH))
    first = (*fv.fwd_qk_only(*args), fv.fwd_qk_chunked(*args))
    second = (*fv.fwd_qk_only(*args), fv.fwd_qk_chunked(*args))
    torch.cuda.synchronize()
    for a, w in zip(first, second, strict=True):
        assert torch.equal(a, w)


@pytest.mark.gpu
def test_cuda_v8_rounds_the_scores_before_adding_v(cuda):
    """On scores that bf16 rounds to 1 and v = -1, V8's output is 0 bit
    for bit, as its plain version's: its policy rounds o before it adds
    v (adding v first would leave 3 * 2^-10)."""
    q, k, v = (t.to(cuda) for t in rounding_operands())
    out, _ = fv.fwd_qk_only(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))
