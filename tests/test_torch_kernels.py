"""Kernels K1 (fused QKV projection + attention), K2 (its backward), K4
(attention backward), K5 (LN + fused QKV + attention), K9 (LN + MLP) and
K10 (haversine label smoothing) of the PyTorch port: on the CPU, their
plain versions against the JAX package (its Pallas kernels in interpret
mode), the autograd Functions around them (including the
``PIGEON_FUSED_BWD=xla`` backward), and the wrappers' dispatch and
operand checks; on a GPU (``-m gpu``), the CUDA kernels against their
plain versions at ragged and full-width shapes.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pigeon_tpu_torch.kernels import attention as k4
from pigeon_tpu_torch.kernels import fused_ln_qkv_attention as k5
from pigeon_tpu_torch.kernels import fused_mlp as k9
from pigeon_tpu_torch.kernels import fused_qkv_attention as k1
from pigeon_tpu_torch.kernels import geodesy as k10

H = 4


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run the Pallas kernel as the JAX package's own tests do: interpret
    mode, with two head groups so the multi-group layout is exercised."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("PIGEON_FUSED_GROUPS", "2")
    with pltpu.force_tpu_interpret_mode():
        yield


def operands(s, d=64, b=2, seed=0, dtype=np.float32):
    """x (B, S, D) and q/k/v weights in the JAX layout (D, P), biases."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d)).astype(dtype)
    ws = [(rng.normal(size=(d, d)) * d ** -0.5).astype(dtype)
          for _ in range(3)]
    bs = [(rng.normal(size=(d,)) * 0.1).astype(dtype) for _ in range(3)]
    return x, ws, bs


def torch_operands(x, ws, bs, dtype=torch.float32):
    """The same operands in the port's layout: Linear weights (P, D)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)

    return (t(x), *(t(w.T) for w in ws), *(t(b) for b in bs))


@pytest.mark.parametrize("s", [10, 17, 33])
def test_plain_version_matches_jax_fused_qkv_mha(interpret_mode, s):
    from pigeon_tpu.kernels.flash_attention import fused_qkv_mha

    x, ws, bs = operands(s)
    want = np.asarray(fused_qkv_mha(jnp.asarray(x),
                                    *map(jnp.asarray, ws),
                                    *map(jnp.asarray, bs), H))
    got = k1.fused_qkv_attention_reference(*torch_operands(x, ws, bs), H)
    # 5e-5: the JAX package's own bound for this kernel in f32
    # (tests/test_flash_attention.py); only the summation order differs.
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


def test_cpu_tensor_runs_plain_version_without_counting():
    x, ws, bs = operands(17)
    ops = torch_operands(x, ws, bs)
    before = k1.fused_qkv_attention.launches
    got = k1.fused_qkv_attention(*ops, H)
    assert k1.fused_qkv_attention.launches == before
    torch.testing.assert_close(
        got, k1.fused_qkv_attention_reference(*ops, H), rtol=0, atol=0)


def test_plain_version_rounds_projections_in_bf16():
    """In bf16 the plain version rounds q/k/v and the probabilities to
    bf16, as the kernel does, and returns bf16."""
    x, ws, bs = operands(33)
    got = k1.fused_qkv_attention_reference(
        *torch_operands(x, ws, bs, torch.bfloat16), H)
    want = k1.fused_qkv_attention_reference(*torch_operands(x, ws, bs), H)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 33, 64)
    # 3e-2: the repo's bound for bf16 attention against f32.
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=3e-2)


def test_other_devices_raise():
    x = torch.empty(1, 8, 64, dtype=torch.bfloat16, device="meta")
    w = torch.empty(64, 64, dtype=torch.bfloat16, device="meta")
    b = torch.empty(64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k1.fused_qkv_attention(x, w, w, w, b, b, b, 1)


def _bf16_ops(s=17, d=128, heads=2):
    p = heads * k1.HEAD_DIM
    x = torch.zeros(2, s, d, dtype=torch.bfloat16)
    ws = [torch.zeros(p, d, dtype=torch.bfloat16) for _ in range(3)]
    bs = [torch.zeros(p, dtype=torch.bfloat16) for _ in range(3)]
    return x, ws, bs


def test_operand_checks_accept_the_kernels_shapes():
    x, ws, bs = _bf16_ops()
    k1._check_operands(x, ws, bs, 2, max_seq=640)


@pytest.mark.parametrize("case, error, match", [
    ("f32", TypeError, "dtype"),
    ("head_dim", ValueError, "head_dim"),
    ("ragged_d", ValueError, "multiple of 64"),
    ("too_long", ValueError, "outside"),
    ("strided", ValueError, "contiguous"),
])
def test_operand_checks_refuse_what_the_kernel_cannot_take(case, error,
                                                            match):
    x, ws, bs = _bf16_ops()
    heads = 2
    if case == "f32":
        ws[1] = ws[1].float()
    elif case == "head_dim":
        heads = 4                       # 4 heads of 32 over P = 128
    elif case == "ragged_d":
        x, ws, bs = _bf16_ops(d=96)
    elif case == "too_long":
        x, ws, bs = _bf16_ops(s=641)
    elif case == "strided":
        x = torch.zeros(2, 128, 17, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(error, match=match):
        k1._check_operands(x, ws, bs, heads, max_seq=640)


@pytest.fixture
def backward_interpret_mode(monkeypatch):
    """The JAX package's fused backward kernel as its tests run it on the
    CPU: interpret mode, two head groups forward and backward."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("PIGEON_FUSED_GROUPS", "2")
    monkeypatch.setenv("PIGEON_FUSED_BWD", "kernel")
    monkeypatch.setenv("PIGEON_FUSED_BWD_GROUPS", "2")
    with pltpu.force_tpu_interpret_mode():
        yield


def leaves(x, ws, bs):
    """Torch leaves (Linear layout) that collect gradients."""
    return [t.requires_grad_() for t in torch_operands(x, ws, bs)]


@pytest.mark.parametrize("s, h, dh", [(64, 4, 16), (100, 4, 16),
                                      (80, 8, 16)])
def test_backward_matches_jax_vjp(backward_interpret_mode, s, h, dh):
    """K2's plain backward plus the Function's weight and bias gradients
    against `jax.vjp` of `fused_qkv_mha` (the Pallas backward kernel)."""
    import jax

    from pigeon_tpu.kernels.flash_attention import fused_qkv_mha

    rng = np.random.default_rng(s)
    d = h * dh
    x = (rng.normal(size=(2, s, d)) * 0.3).astype(np.float32)
    ws = [(rng.normal(size=(d, d)) * 0.1).astype(np.float32)
          for _ in range(3)]
    bs = [(rng.normal(size=(d,)) * 0.1).astype(np.float32)
          for _ in range(3)]
    g = rng.normal(size=(2, s, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: fused_qkv_mha(*a, h),
                     jnp.asarray(x), *map(jnp.asarray, ws),
                     *map(jnp.asarray, bs))
    want = vjp(jnp.asarray(g))

    ops = leaves(x, ws, bs)
    k1.FusedQKVAttention.apply(*ops, h).backward(torch.from_numpy(g))
    # 5e-4: the JAX package's bound for these gradients in f32
    # (tests/test_flash_attention.py); the sums run in another order.
    for i, (t, w) in enumerate(zip(ops, want)):
        got = t.grad.numpy()
        np.testing.assert_allclose(got.T if i in (1, 2, 3) else got,
                                   np.asarray(w), atol=5e-4, err_msg=str(i))


def test_function_matches_autograd_through_plain_forward():
    x, ws, bs = operands(33)
    g = np.random.default_rng(1).normal(size=(2, 33, 64)) \
        .astype(np.float32)
    fused, plain = leaves(x, ws, bs), leaves(x, ws, bs)
    out = k1.FusedQKVAttention.apply(*fused, H)
    assert out.grad_fn.name() == "FusedQKVAttentionBackward"
    out.backward(torch.from_numpy(g))
    k1.fused_qkv_attention_reference(*plain, H).backward(torch.from_numpy(g))
    for a, b in zip(fused, plain):
        # 1e-5: the same products, with the softmax's gradient taken in
        # the deferred-denominator form instead of autograd's.
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-5)


def test_function_skips_gradients_nobody_needs():
    """A frozen layer's weights need no gradient: only dx is formed."""
    x, ws, bs = operands(17)
    ops = torch_operands(x, ws, bs)
    ops[0].requires_grad_()
    k1.FusedQKVAttention.apply(*ops, H).sum().backward()
    assert ops[0].grad is not None
    assert all(t.grad is None for t in ops[1:])


def test_fused_attention_route_is_differentiable():
    """The module's ``fused`` route goes through the autograd Function
    (K1 forward, K2 backward) and its gradients equal the plain route's;
    under inference mode it runs the forward alone."""
    from pigeon_tpu_torch.models.clip import MultiHeadAttention

    torch.manual_seed(0)
    fused = MultiHeadAttention(64, H, attn_impl="fused")
    plain = MultiHeadAttention(64, H, attn_impl="plain")
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, 17, 64)
    out = fused(x)

    def nodes(fn, seen):
        if fn is not None and fn not in seen:
            seen.add(fn)
            for nxt, _ in fn.next_functions:
                nodes(nxt, seen)
        return seen

    assert "FusedQKVAttentionBackward" in {
        n.name() for n in nodes(out.grad_fn, set())}
    out.square().sum().backward()
    plain(x).square().sum().backward()
    for (name, a), b in zip(fused.named_parameters(), plain.parameters()):
        assert a.grad is not None and a.grad.abs().max() > 0, name
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-4)
    with torch.inference_mode():
        torch.testing.assert_close(fused(x), out.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("case, error", [
    ("ok", None), ("d_192", ValueError), ("odd_heads", ValueError),
    ("g_f32", TypeError), ("g_short", ValueError)])
def test_backward_operand_checks(case, error):
    heads = 3 if case == "odd_heads" else 2
    x, ws, bs = _bf16_ops(d=192 if case == "d_192" else 128, heads=heads)
    g = torch.zeros(2, 17, heads * k1.HEAD_DIM, dtype=torch.bfloat16)
    if case == "g_f32":
        g = g.float()
    elif case == "g_short":
        g = g[:, :16]
    if error is None:
        k1._check_backward_operands(x, ws, bs, g, heads)
    else:
        with pytest.raises(error):
            k1._check_backward_operands(x, ws, bs, g, heads)


@pytest.mark.gpu
@pytest.mark.parametrize("b, c", [(3, 5), (8, 2203), (300, 2203)])
def test_cuda_smoothing_kernel_zeros_nan_label_rows(cuda, b, c):
    """A NaN label (a corrupt metadata row) gives a row of zero targets,
    as the plain version's nan_to_num does; the other rows stay its bits
    for bits."""
    rng = np.random.default_rng(b + c)
    labels = points(rng, b)
    labels[0, 0] = np.nan                  # longitude
    labels[-1, 1] = np.nan                 # latitude
    labels = torch.from_numpy(labels).to(cuda)
    cells = torch.from_numpy(points(rng, c)).to(cuda)
    got = k10.smooth_labels_from_points(labels, cells, 75.0)
    want = k10.smooth_labels_reference(labels, cells, 75.0)
    assert not got[0].any() and not got[-1].any()
    assert torch.equal(got, want)


def test_smoothing_plain_version_zeros_nan_label_rows():
    """The plain version's and the JAX reference's NaN row: zeros."""
    from pigeon_tpu.kernels.geodesy import smooth_labels_reference

    rng = np.random.default_rng(4)
    labels, cells = points(rng, 3), points(rng, 7)
    labels[1] = np.nan
    got = k10.smooth_labels_from_points(torch.from_numpy(labels),
                                        torch.from_numpy(cells), 75.0)
    want = np.asarray(smooth_labels_reference(jnp.asarray(labels),
                                              jnp.asarray(cells), 75.0))
    assert not got[1].any()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def points(rng, n):
    return np.stack([rng.uniform(-180, 180, n), rng.uniform(-65, 70, n)],
                    -1).astype(np.float32)


@pytest.mark.parametrize("tau", [65.0, 75.0])
@pytest.mark.parametrize("b, c", [(4, 16), (37, 200), (128, 300)])
def test_smoothing_plain_version_matches_jax(b, c, tau):
    from jax.experimental.pallas import tpu as pltpu

    from pigeon_tpu.kernels.geodesy import (
        smooth_labels_from_points,
        smooth_labels_reference,
    )

    rng = np.random.default_rng(b + c)
    labels, cells = points(rng, b), points(rng, c)
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(smooth_labels_from_points(
            jnp.asarray(labels), jnp.asarray(cells), tau_km=tau))
    reference = np.asarray(smooth_labels_reference(
        jnp.asarray(labels), jnp.asarray(cells), tau_km=tau))
    got = k10.smooth_labels_from_points(torch.from_numpy(labels),
                                        torch.from_numpy(cells), tau).numpy()
    assert got.shape == (b, c)
    # 2e-5: the repo's bound for the smoothing kernel against its
    # reference (tests/test_kernels.py).
    np.testing.assert_allclose(got, reference, atol=2e-5)
    # The Pallas kernel computes arcsin by the A&S polynomial (Mosaic has
    # no asin), which moves it up to ~2.6e-5 from its own reference at
    # these points; the port stays within 2e-5 of the kernel beyond that.
    assert (np.abs(got - kernel)
            <= np.abs(kernel - reference) + 2e-5).all()
    np.testing.assert_allclose(got.max(-1), 1.0, atol=1e-5)


def test_smoothing_operand_checks():
    labels = torch.zeros(3, 2)
    k10._check_operands(labels, torch.zeros(5, 2), 75.0)
    for args, error in [((labels.double(), torch.zeros(5, 2), 75.0),
                         TypeError),
                        ((labels, torch.zeros(5, 3), 75.0), ValueError),
                        ((labels, torch.zeros(2, 5).t(), 75.0), ValueError),
                        ((labels, torch.zeros(5, 2), 0.0), ValueError)]:
        with pytest.raises(error):
            k10._check_operands(*args)
    with pytest.raises(ValueError, match="no kernel"):
        k10.smooth_labels_from_points(labels.to("meta"),
                                      torch.zeros(5, 2, device="meta"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b, s, d, heads", [
    (1, 1, 128, 2), (1, 17, 128, 2), (2, 64, 128, 2), (2, 65, 256, 4),
    (1, 640, 128, 2), (4, 577, 1024, 16)])
def test_cuda_kernel_matches_plain_version(cuda, b, s, d, heads):
    gen = torch.Generator(device=cuda).manual_seed(s)
    p = heads * k1.HEAD_DIM
    x = torch.nn.functional.layer_norm(
        torch.randn(b, s, d, generator=gen, device=cuda), (d,)).bfloat16()
    ws = [(torch.randn(p, d, generator=gen, device=cuda) * 0.02).bfloat16()
          for _ in range(3)]
    bs = [(torch.randn(p, generator=gen, device=cuda) * 0.02).bfloat16()
          for _ in range(3)]
    before = k1.fused_qkv_attention.launches
    got = k1.fused_qkv_attention(x, *ws, *bs, heads)
    torch.cuda.synchronize()
    assert k1.fused_qkv_attention.launches == before + 1
    want = k1.fused_qkv_attention_reference(x, *ws, *bs, heads)
    # 3e-2: the repo's bf16 attention bound; both round q/k/v and p to
    # bf16 at the same places, the kernel p against the running max.
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("b, s, d, heads", [
    (1, 1, 128, 2), (1, 17, 128, 2), (2, 65, 256, 4), (2, 577, 1024, 16)])
def test_cuda_backward_kernel_matches_plain_version(cuda, b, s, d, heads):
    gen = torch.Generator(device=cuda).manual_seed(s)
    p = heads * k1.HEAD_DIM
    x = torch.nn.functional.layer_norm(
        torch.randn(b, s, d, generator=gen, device=cuda), (d,)).bfloat16()
    ws = [(torch.randn(p, d, generator=gen, device=cuda) * 0.02).bfloat16()
          for _ in range(3)]
    bs = [(torch.randn(p, generator=gen, device=cuda) * 0.02).bfloat16()
          for _ in range(3)]
    g = (torch.randn(b, s, p, generator=gen, device=cuda) * 0.01).bfloat16()
    before = k1.fused_qkv_attention_backward.launches
    got = k1.fused_qkv_attention_backward(x, *ws, *bs, g, heads)
    torch.cuda.synchronize()
    assert k1.fused_qkv_attention_backward.launches == before + 1
    want = k1.fused_qkv_attention_backward_reference(x, *ws, *bs, g, heads)
    for a, w in zip(got, want):
        # 2e-2 of each output's magnitude: u and dl are rounded to bf16 from
        # f32 values summed in another order (chip_smoke.py's bound).
        scale = w.float().abs().max().item()
        assert (a.float() - w.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.gpu
def test_cuda_fused_route_gradient_reaches_attention_weights(cuda):
    from pigeon_tpu_torch.models.clip import MultiHeadAttention

    torch.manual_seed(0)
    m = MultiHeadAttention(128, 2, attn_impl="fused").to(cuda)
    x = torch.randn(2, 33, 128, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    before = k1.fused_qkv_attention_backward.launches
    m(x).float().square().sum().backward()
    assert k1.fused_qkv_attention_backward.launches == before + 1
    for proj in (m.q_proj, m.k_proj, m.v_proj):
        assert proj.weight.grad.abs().max().item() > 0
    assert x.grad.abs().max().item() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("b, c", [(1, 1), (3, 5), (8, 2203), (256, 2203),
                                  (300, 2203), (8, 9000)])
def test_cuda_smoothing_kernel_matches_plain_version(cuda, b, c):
    rng = np.random.default_rng(c)
    labels = torch.from_numpy(points(rng, b)).to(cuda)
    cells = torch.from_numpy(points(rng, c)).to(cuda)
    before = k10.smooth_labels_from_points.launches
    got = k10.smooth_labels_from_points(labels, cells, 75.0)
    again = k10.smooth_labels_from_points(labels, cells, 75.0)
    torch.cuda.synchronize()
    assert k10.smooth_labels_from_points.launches == before + 2
    want = k10.smooth_labels_reference(labels, cells, 75.0)
    # 2e-5: the repo's bound for the smoothing kernel.
    assert (got - want).abs().max().item() <= 2e-5
    assert bool((got.max(-1).values == 1.0).all())
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert got.data_ptr() != again.data_ptr()


@pytest.mark.gpu
@pytest.mark.parametrize("b, c", [(300, 2203), (13, 3000), (500, 5),
                                  (8, 9000)])
def test_cuda_smoothing_kernel_gives_the_same_bits_under_every_plan(cuda, b,
                                                                    c):
    """Every instance and block size the kernel takes, several chunks a
    CTA among them (d computed again for the exp; at C = 9000 under the
    wrapper's own plan too), against the plan the wrapper picks; a plan
    the kernel does not take is refused."""
    rng = np.random.default_rng(b + c)
    labels = torch.from_numpy(points(rng, b)).to(cuda)
    cells = torch.from_numpy(points(rng, c)).to(cuda)
    want = k10.smooth_labels_from_points(labels, cells, 75.0)
    lib = k10.load()
    stream = torch.cuda.current_stream().cuda_stream

    def call(out, rows, threads):
        return lib.pigeon_smooth_labels(
            labels.data_ptr(), cells.data_ptr(), out.data_ptr(), b, c, 75.0,
            rows, threads, stream)

    for rows in k10.ROWS:
        for threads in (64, 96, 512):
            out = torch.full_like(want, float("nan"))
            assert call(out, rows, threads) == 0
            torch.cuda.synchronize()
            assert torch.equal(out.view(torch.int32),
                               want.view(torch.int32)), (rows, threads)
    for plan in ((3, 64), (1, 32), (1, 100), (1, 1024)):
        assert call(torch.empty_like(want), *plan) != 0


@pytest.mark.gpu
def test_cuda_smoothing_kernel_takes_a_second_table_between_calls(cuda):
    rng = np.random.default_rng(1)
    labels = torch.from_numpy(points(rng, 8)).to(cuda)
    first, second = (torch.from_numpy(points(rng, c)).to(cuda)
                     for c in (2203, 300))
    before = k10.smooth_labels_from_points.launches
    outs = [k10.smooth_labels_from_points(labels, t, 75.0)
            for t in (first, second, first)]
    torch.cuda.synchronize()
    assert k10.smooth_labels_from_points.launches == before + 3
    for got, t in zip(outs, (first, second, first)):
        want = k10.smooth_labels_reference(labels, t, 75.0)
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= 2e-5
    assert torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="contiguous"):
        k10.smooth_labels_from_points(labels, first.t().contiguous().t(),
                                      75.0)
    assert k10.smooth_labels_from_points.launches == before + 3


def test_build_keeps_the_compiler_log_for_a_reused_library(tmp_path,
                                                          monkeypatch):
    """A reused library comes back with the log of the build that made it,
    so the smoke's gates on nvcc's register and spill lines also hold on
    a cached build."""
    import sys

    from pigeon_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    fake = tmp_path / "fake_compiler.py"
    fake.write_text(
        "import sys\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n"
        "print('ptxas info    : Used 32 registers')\n")
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    compiler = [sys.executable, str(fake)]
    first = native.build_shared(str(src), compiler)
    again = native.build_shared(str(src), compiler)
    assert "Used 32 registers" in first.log
    assert again.path == first.path and again.log == first.log
    assert again.seconds == 0.0 < first.seconds


def test_library_name_covers_the_local_headers_a_source_includes(tmp_path):
    """K1 and K8 build from their two stages' header over the wgmma GEMM
    and forward headers, V6-V10 from the wgmma forward and V1-V5 from the
    wgmma backward: editing a header must give every library that
    includes it a new name, so a stale build is never loaded."""
    import os

    from pigeon_tpu_torch import native

    (tmp_path / "inner.cuh").write_text("// v1\n")
    (tmp_path / "tile.cuh").write_text('#include "inner.cuh"\n')
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "tile.cuh"\n')

    def name():
        return native.library_path(str(src), ["nvcc"], native.NVCC_FLAGS)

    first = name()
    assert first == name()
    (tmp_path / "inner.cuh").write_text("// v2\n")
    assert name() != first
    for kernel, headers in (
            ("fused_qkv_attention", ["qkv_forward_sm90.cuh",
                                     "gemm_sm90.cuh", "hopper_sm90.cuh",
                                     "flash_fwd_sm90.cuh"]),
            ("fused_qkv_attention_int8", ["qkv_forward_sm90.cuh",
                                          "gemm_sm90.cuh", "hopper_sm90.cuh",
                                          "flash_fwd_sm90.cuh"]),
            ("attention_fwd_variants", ["flash_fwd_sm90.cuh",
                                        "hopper_sm90.cuh"]),
            ("attention_bwd_variants", ["flash_bwd_sm90.cuh",
                                        "hopper_sm90.cuh"])):
        closure = native.source_closure(
            os.path.join(native.CSRC_DIR, f"{kernel}.cu"))
        assert [os.path.basename(p) for p in closure] == [
            f"{kernel}.cu", *headers]


# ---------------------------------------------------------------------------
# K4, K5, K9 and the PIGEON_FUSED_BWD=xla backward against the JAX package
# ---------------------------------------------------------------------------

def tensor(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


@pytest.fixture
def routes_interpret_mode(monkeypatch):
    """The JAX package's kernels as its own tests run them on the CPU:
    interpret mode, two head groups forward and backward, 128-wide MLP
    chunks."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("PIGEON_FUSED_GROUPS", "2")
    monkeypatch.setenv("PIGEON_FUSED_BWD", "kernel")
    monkeypatch.setenv("PIGEON_FUSED_BWD_GROUPS", "2")
    monkeypatch.setenv("PIGEON_MLP_CHUNK", "128")
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("b, s, h", [(2, 17, 2), (1, 64, 2), (2, 100, 1)])
def test_k4_plain_version_matches_jax_flash_backward(routes_interpret_mode,
                                                     b, s, h):
    from pigeon_tpu.kernels.flash_attention import _flash_backward

    rng = np.random.default_rng(s)
    q, k, v, g = (rng.normal(size=(b, s, h, 64)).astype(np.float32)
                  for _ in range(4))

    def fold(a):                                   # (B,S,H,dh)->(BH,S,dh)
        return a.transpose(0, 2, 1, 3).reshape(b * h, s, 64)

    want = _flash_backward(*(jnp.asarray(fold(a)) for a in (q, k, v, g)))
    got = k4.flash_attention_backward(*map(tensor, (q, k, v, g)))
    for a, w in zip(got, want):
        # 3e-4: the JAX package's bound for this backward in f32
        # (tests/test_flash_attention.py); the sums run in another order.
        np.testing.assert_allclose(fold(a.numpy()), np.asarray(w),
                                   atol=3e-4)


def test_flash_attention_gradients_match_jax_vjp_of_mha(
        routes_interpret_mode):
    """`FlashAttention` (K3 forward, K4 backward; their plain versions on
    the CPU) against `jax.vjp` of `mha` (the Pallas kernels)."""
    import jax

    from pigeon_tpu.kernels.flash_attention import mha

    rng = np.random.default_rng(3)
    q, k, v, g = (rng.normal(size=(2, 33, 2, 64)).astype(np.float32)
                  for _ in range(4))
    out, vjp = jax.vjp(mha, *map(jnp.asarray, (q, k, v)))
    leaves = [tensor(a, grad=True) for a in (q, k, v)]
    got = k4.FlashAttention.apply(*leaves)
    assert got.grad_fn.name() == "FlashAttentionBackward"
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=5e-5)
    got.backward(tensor(g))
    for t, w in zip(leaves, vjp(jnp.asarray(g))):
        # 3e-4: tests/test_flash_attention.py's bound for mha's gradients.
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=3e-4)


def ln_operands(s, d=128, seed=0):
    """Raw x, LN scale and bias, and q/k/v weights (JAX layout) and
    biases for the LN-fused attention."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, s, d)).astype(np.float32)
    ls = (1.0 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    lb = (0.1 * rng.normal(size=(d,))).astype(np.float32)
    ws = [(rng.normal(size=(d, d)) * d ** -0.5).astype(np.float32)
          for _ in range(3)]
    bs = [(0.1 * rng.normal(size=(d,))).astype(np.float32) for _ in range(3)]
    g = rng.normal(size=(2, s, d)).astype(np.float32)
    return x, ls, lb, ws, bs, g


@pytest.mark.parametrize("s", [10, 33])
def test_k5_plain_version_and_gradients_match_jax(routes_interpret_mode, s):
    import jax

    from pigeon_tpu.kernels.flash_attention import fused_ln_qkv_mha

    x, ls, lb, ws, bs, g = ln_operands(s)
    out, vjp = jax.vjp(lambda *a: fused_ln_qkv_mha(*a, 2, 1e-5),
                       *map(jnp.asarray, (x, ls, lb, *ws, *bs)))
    leaves = [tensor(a, grad=True)
              for a in (x, ls, lb, *(w.T for w in ws), *bs)]
    got = k5.FusedLNQKVAttention.apply(*leaves, 2, 1e-5)
    # 5e-5 forward and 5e-4 gradients: tests/test_flash_attention.py's
    # bounds for the LN-fused kernel in f32.
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=5e-5)
    torch.testing.assert_close(
        k5.fused_ln_qkv_attention(*(t.detach() for t in leaves), 2, 1e-5),
        got.detach(), rtol=0, atol=0)
    got.backward(tensor(g))
    for i, (t, w) in enumerate(zip(leaves, vjp(jnp.asarray(g)))):
        grad = t.grad.numpy()
        np.testing.assert_allclose(grad.T if 3 <= i <= 5 else grad,
                                   np.asarray(w), atol=5e-4, err_msg=str(i))


@pytest.mark.parametrize("s", [10, 64])
def test_k9_plain_version_and_gradients_match_jax(routes_interpret_mode, s):
    import jax

    from pigeon_tpu.kernels.fused_mlp import fused_ln_mlp

    rng = np.random.default_rng(s)
    d, inter = 128, 512
    x = rng.normal(size=(2, s, d)).astype(np.float32)
    ls = (1.0 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    lb, b2 = ((0.1 * rng.normal(size=(d,))).astype(np.float32)
              for _ in range(2))
    w1 = (0.1 * rng.normal(size=(d, inter))).astype(np.float32)
    b1 = (0.1 * rng.normal(size=(inter,))).astype(np.float32)
    w2 = (0.1 * rng.normal(size=(inter, d))).astype(np.float32)
    g = rng.normal(size=(2, s, d)).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: fused_ln_mlp(*a, 1e-5),
                       *map(jnp.asarray, (x, ls, lb, w1, b1, w2, b2)))
    leaves = [tensor(a, grad=True) for a in (x, ls, lb, w1.T, b1, w2.T, b2)]
    got = k9.FusedLNMLP.apply(*leaves, 1e-5)
    # 2e-4 forward, atol 1e-3 / rtol 1e-4 gradients: the bounds of
    # tests/test_fused_mlp.py for this kernel in f32.
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=2e-4)
    got.backward(tensor(g))
    for i, (t, w) in enumerate(zip(leaves, vjp(jnp.asarray(g)))):
        grad = t.grad.numpy()
        np.testing.assert_allclose(grad.T if i in (3, 5) else grad,
                                   np.asarray(w), atol=1e-3, rtol=1e-4,
                                   err_msg=str(i))


@pytest.mark.parametrize("ln", [False, True])
def test_xla_backward_matches_jax_xla_branch(routes_interpret_mode,
                                             monkeypatch, ln):
    """``PIGEON_FUSED_BWD=xla``: plain projections around K4 (never K2),
    against the JAX package's `xla` branch of `_fused_qkv_bwd`, for the
    fused attention with and without LN folded in."""
    import jax

    from pigeon_tpu.kernels import flash_attention as jfa

    monkeypatch.setenv("PIGEON_FUSED_BWD", "xla")
    calls = []
    backward = k1.flash_attention_backward
    monkeypatch.setattr(k1, "flash_attention_backward",
                        lambda *a: calls.append(1) or backward(*a))

    def no_k2(*a):
        raise AssertionError("K2 ran under PIGEON_FUSED_BWD=xla")

    monkeypatch.setattr(k1, "fused_qkv_attention_backward", no_k2)
    x, ls, lb, ws, bs, g = ln_operands(24, seed=5)
    x = x * 0.5
    head = (x, ls, lb) if ln else (x,)
    fn = ((lambda *a: jfa.fused_ln_qkv_mha(*a, 2, 1e-5)) if ln
          else (lambda *a: jfa.fused_qkv_mha(*a, 2)))
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (*head, *ws, *bs)))
    leaves = [tensor(a, grad=True)
              for a in (*head, *(w.T for w in ws), *bs)]
    fwd = k5.FusedLNQKVAttention if ln else k1.FusedQKVAttention
    fwd.apply(*leaves, 2, *((1e-5,) if ln else ())).backward(tensor(g))
    assert calls == [1]
    n = len(head)
    for i, (t, w) in enumerate(zip(leaves, vjp(jnp.asarray(g)))):
        grad = t.grad.numpy()
        # 5e-4: the repo's bound for these gradients in f32.
        np.testing.assert_allclose(grad.T if n <= i < n + 3 else grad,
                                   np.asarray(w), atol=5e-4, err_msg=str(i))


def test_fused_bwd_refuses_an_unknown_choice(monkeypatch):
    x, ws, bs = operands(9)
    ops = [t.requires_grad_() for t in torch_operands(x, ws, bs)]
    out = k1.FusedQKVAttention.apply(*ops, H)
    monkeypatch.setenv("PIGEON_FUSED_BWD", "kernal")
    with pytest.raises(ValueError, match="PIGEON_FUSED_BWD"):
        out.sum().backward()


def test_k2_plain_version_runs_k4s_attention_backward():
    """K2's plain version is K4's with the projections around it: the
    projection cotangents equal K4's on the projected q/k/v."""
    x, ws, bs = operands(20, d=128)
    g = np.random.default_rng(2).normal(size=(2, 20, 128)).astype(np.float32)
    ops = torch_operands(x, ws, bs)
    _, *dqkv = k1.fused_qkv_attention_backward_reference(*ops, tensor(g), 2)
    heads = (2, 20, 2, 64)
    q, k, v = (torch.nn.functional.linear(ops[0], w, b).view(heads)
               for w, b in zip(ops[1:4], ops[4:]))
    for a, w in zip(dqkv, k4.flash_attention_backward_reference(
            q, k, v, tensor(g).view(heads))):
        torch.testing.assert_close(a, w.reshape(2, 20, 128), rtol=0,
                                   atol=1e-6)


def test_new_wrappers_dispatch_by_device():
    """On the CPU the wrappers run their plain versions without counting
    a launch; on another device they raise."""
    x, ls, lb, ws, bs, _ = ln_operands(9)
    ops = [tensor(a) for a in (x, ls, lb, *(w.T for w in ws), *bs)]
    mlp = [tensor(a) for a in (x, ls, lb)] + [
        torch.zeros(256, 128), torch.zeros(256), torch.zeros(128, 256),
        torch.zeros(128)]
    q = torch.randn(1, 9, 2, 64)
    before = (k4.flash_attention_backward.launches,
              k5.fused_ln_qkv_attention.launches, k9.fused_ln_mlp.launches)
    k4.flash_attention_backward(q, q, q, q)
    k5.fused_ln_qkv_attention(*ops, 2, 1e-5)
    k9.fused_ln_mlp(*mlp, 1e-5)
    assert before == (k4.flash_attention_backward.launches,
                      k5.fused_ln_qkv_attention.launches,
                      k9.fused_ln_mlp.launches)
    meta = torch.empty(1, 9, 2, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k4.flash_attention_backward(meta, meta, meta, meta)
    with pytest.raises(ValueError, match="no kernel"):
        k5.fused_ln_qkv_attention(*(t.to("meta") for t in ops), 2, 1e-5)
    with pytest.raises(ValueError, match="no kernel"):
        k9.fused_ln_mlp(*(t.to("meta") for t in mlp), 1e-5)


@pytest.mark.parametrize("case, error", [
    ("ok", None), ("ln_bf16", TypeError), ("ln_short", ValueError),
    ("d_192", ValueError), ("w1_f32", TypeError)])
def test_k5_and_k9_operand_checks(case, error):
    d = 192 if case == "d_192" else 128
    x = torch.zeros(2, 17, d, dtype=torch.bfloat16)
    ls, lb = torch.ones(d), torch.zeros(d)
    if case == "ln_bf16":
        ls = ls.bfloat16()
    elif case == "ln_short":
        lb = lb[:64]
    w1, w2 = (torch.zeros(s, dtype=torch.bfloat16)
              for s in ((4 * d, d), (d, 4 * d)))
    if case == "w1_f32":
        w1 = w1.float()
    b1, b2 = (torch.zeros(n, dtype=torch.bfloat16) for n in (4 * d, d))
    if error is None:
        k5.check_ln_params(x, ls, lb)
        k9._check_operands(x, ls, lb, w1, b1, w2, b2)
    else:
        with pytest.raises(error):
            k9._check_operands(x, ls, lb, w1, b1, w2, b2)


@pytest.mark.gpu
@pytest.mark.parametrize("b, s, heads", [(1, 1, 1), (2, 65, 2), (1, 640, 2),
                                         (32, 577, 16)])
def test_cuda_k4_matches_plain_version(cuda, b, s, heads):
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn(b, s, heads, 64, generator=gen, device=cuda)
               .bfloat16() for _ in range(3))
    g = (torch.randn(b, s, heads, 64, generator=gen, device=cuda) * 0.01) \
        .bfloat16()
    before = k4.flash_attention_backward.launches
    got = k4.flash_attention_backward(q, k, v, g)
    torch.cuda.synchronize()
    assert k4.flash_attention_backward.launches == before + 1
    for a, w in zip(got, k4.flash_attention_backward_reference(q, k, v, g)):
        # 2e-2 of each output's magnitude: K2's bound for the same passes.
        scale = w.float().abs().max().item()
        assert (a.float() - w.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("b, s, d, heads", [(1, 1, 128, 2), (2, 65, 256, 4),
                                            (1, 640, 128, 2),
                                            (4, 577, 1024, 16)])
def test_cuda_k5_matches_plain_version(cuda, b, s, d, heads):
    gen = torch.Generator(device=cuda).manual_seed(s)
    p = heads * 64
    x = (torch.randn(b, s, d, generator=gen, device=cuda) * 3 + 1).bfloat16()
    ls = 1 + 0.5 * torch.randn(d, generator=gen, device=cuda)
    lb = 0.5 * torch.randn(d, generator=gen, device=cuda)
    ws = [(torch.randn(p, d, generator=gen, device=cuda) * 0.02).bfloat16()
          for _ in range(3)]
    bs = [(torch.randn(p, generator=gen, device=cuda) * 0.02).bfloat16()
          for _ in range(3)]
    before = k5.fused_ln_qkv_attention.launches
    got = k5.fused_ln_qkv_attention(x, ls, lb, *ws, *bs, heads, 1e-5)
    torch.cuda.synchronize()
    assert k5.fused_ln_qkv_attention.launches == before + 1
    want = k5.fused_ln_qkv_attention_reference(x, ls, lb, *ws, *bs, heads,
                                               1e-5)
    # 2e-2 of the output's magnitude: a bf16 output one ulp apart is up to
    # 2^-7 of it, and q/k/v and p are rounded from sums in another order.
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("b, s, d, inter", [(1, 1, 128, 128), (2, 65, 128,
                                                               512),
                                            (32, 577, 1024, 4096)]
                         + [(3, s, d, 4 * d) for d in (128, 1024)
                            for s in (1, 63, 65, 129, 577)])
def test_cuda_k9_matches_plain_version(cuda, b, s, d, inter):
    gen = torch.Generator(device=cuda).manual_seed(s)
    x = torch.randn(b, s, d, generator=gen, device=cuda).bfloat16()
    ls = 1 + 0.5 * torch.randn(d, generator=gen, device=cuda)
    lb = 0.5 * torch.randn(d, generator=gen, device=cuda)
    w1 = (torch.randn(inter, d, generator=gen, device=cuda) * d ** -0.5) \
        .bfloat16()
    w2 = (torch.randn(d, inter, generator=gen, device=cuda)
          * inter ** -0.5).bfloat16()
    b1, b2 = ((0.1 * torch.randn(n, generator=gen, device=cuda)).bfloat16()
              for n in (inter, d))
    before = k9.fused_ln_mlp.launches
    got = k9.fused_ln_mlp(x, ls, lb, w1, b1, w2, b2, 1e-5)
    torch.cuda.synchronize()
    assert k9.fused_ln_mlp.launches == before + 1
    want = k9.fused_ln_mlp_reference(x, ls, lb, w1, b1, w2, b2, 1e-5)
    assert bool(torch.isfinite(got.float()).all())
    # 2e-2 of the output's magnitude: h is rounded to bf16 from f32 sums
    # taken in another order, and fc2 sums I of them.
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * scale
