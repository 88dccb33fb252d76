"""The remat policies of the port (`models/clip.py`): on every route and
every policy the gradients of a two-layer tower equal those of ``none``
and the JAX package's under the same policy, each policy runs the
attention kernel forward again exactly where the JAX policy implies,
``block`` falls back to ``attn_out``, and ``PIGEON_REMAT`` takes the five
names.

The JAX side runs its Pallas entry points through exact XLA twins, as
`tests/test_train_remat_fused.py` does: interpret-mode Pallas cannot run
under `jax.checkpoint`. The port's side runs the kernels' plain versions
(CPU tensors)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pigeon_tpu.config import HeadConfig, VisionConfig
from pigeon_tpu_torch.models import clip
from pigeon_tpu_torch.models.jax_bridge import state_dict_from_jax

VISION = VisionConfig(image_size=28, patch_size=14, hidden_size=64,
                      intermediate_size=128, num_layers=2, num_heads=4,
                      projection_dim=32)
HEAD = HeadConfig(num_cells=11, embed_dim=64, multi_task=True)
#: The JAX package's route name of each port route.
ROUTES = {"fused": "flash_fused", "flash": "flash", "plain": "xla",
          "fused_ln": "flash_fused_ln", "fused_mlp": "flash_fused_mlp",
          "block": "flash_fused_block"}
CELLS = np.stack([np.linspace(-170, 170, HEAD.num_cells),
                  np.linspace(-55, 65, HEAD.num_cells)], -1) \
    .astype(np.float32)


def batch(n=3, seed=4):
    rng = np.random.default_rng(seed)
    return {
        "inputs": rng.normal(size=(n, 28, 28, 3)).astype(np.float32),
        "labels": np.stack([rng.uniform(-170, 170, n),
                            rng.uniform(-55, 65, n)], -1).astype(np.float32),
        "labels_multi_task": rng.normal(size=(n, 6)).astype(np.float32),
        "labels_climate": rng.integers(0, 28, n).astype(np.int32),
        "labels_month": rng.integers(0, 12, n).astype(np.int32),
    }


@pytest.fixture(scope="module")
def jax_params():
    from pigeon_tpu.models.super_guessr import SuperGuessr

    params = SuperGuessr(VISION, HEAD).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 28, 28, 3)))["params"]
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def port_grads(params, route, remat):
    """The trainable parameters' gradients of one loss on the port's
    finetune model (the last layer, embeddings and head train)."""
    from pigeon_tpu_torch.config import PigeonConfig
    from pigeon_tpu_torch.kernels.geodesy import smooth_labels_reference
    from pigeon_tpu_torch.train.modes import build_finetune_model
    from pigeon_tpu_torch.train.train_loop import batch_loss

    cfg = PigeonConfig(vision=VISION, head=HEAD)
    model = build_finetune_model(cfg, dtype=torch.float32, attn_impl=route,
                                 remat=remat)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    model.train()
    b = {k: torch.from_numpy(v) for k, v in batch().items()}
    _, total, _ = batch_loss(model, b, torch.from_numpy(CELLS), HEAD,
                             smooth_labels_reference)
    total.backward()
    return {n: p.grad for n, p in model.named_parameters()
            if p.requires_grad and p.grad is not None}


@pytest.fixture(scope="module")
def none_grads(jax_params):
    return {route: port_grads(jax_params, route, "none")
            for route in ROUTES}


def test_saved_names_follow_the_jax_policies():
    """`remat_saved_names` is `_remat_policy_names` with ``mlp_out``
    (K9's output) added to every policy but ``none``."""
    from pigeon_tpu.models.clip import _remat_policy_names

    for route, jax_route in ROUTES.items():
        assert clip.remat_saved_names("none", route) == ()
        for remat in ("full", "attn_out", "attn_kernel", "attn_slim"):
            assert clip.remat_saved_names(remat, route) == (
                *_remat_policy_names(remat, jax_route), "mlp_out")
    for remat in ("attn_kernel", "attn_slim", "attn_out"):
        assert clip.remat_saved_names(remat, "block") == ("attn_out",
                                                           "mlp_out")
    with pytest.raises(ValueError, match="remat="):
        clip.remat_saved_names("attn", "fused")
    assert clip.REMATS == ("none", "full", "attn_out", "attn_kernel",
                           "attn_slim")


@pytest.mark.parametrize("remat", ["full", "attn_out", "attn_kernel",
                                   "attn_slim"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_policy_gives_the_gradients_of_none(jax_params, none_grads, route,
                                            remat):
    got = port_grads(jax_params, route, remat)
    want = none_grads[route]
    assert got.keys() == want.keys()
    for name, g in want.items():
        # 1e-6: the recompute replays the same operations on the same
        # inputs.
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)


#: The plain versions the kernels' wrappers run on CPU tensors: the
#: attention forward of each route (K1, K3, K5, K6) and K9.
FORWARDS = {"fused": ("fused_qkv_attention", "fused_qkv_attention_reference"),
            "flash": ("attention", "flash_attention_reference"),
            "plain": None,
            "fused_ln": ("fused_ln_qkv_attention",
                         "fused_ln_qkv_attention_reference"),
            "fused_mlp": ("fused_ln_qkv_attention",
                          "fused_ln_qkv_attention_reference"),
            "block": ("fused_block_attention",
                      "fused_block_attention_reference")}


@pytest.mark.parametrize("remat", list(clip.REMATS))
@pytest.mark.parametrize("route", sorted(r for r in FORWARDS if FORWARDS[r]))
def test_kernel_forwards_per_policy(jax_params, monkeypatch, route, remat):
    """One loss and backward: each layer's attention forward runs once,
    and once more in the backward of every layer under ``full`` and, where
    an ``out_proj`` follows the kernel, ``attn_out`` (the JAX policy
    recomputes the kernel output for ``dWo``); K9 never runs again; K6's
    backward runs K1 once, for the trainable layer's ``dWo`` (and K6's
    plain version runs K1's plain version inside it)."""
    import importlib

    counts = {}

    def count(module, name):
        mod = importlib.import_module(f"pigeon_tpu_torch.kernels.{module}")
        real = getattr(mod, name)

        def counted(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return real(*a, **kw)

        monkeypatch.setattr(mod, name, counted)

    count(*FORWARDS[route])
    count("fused_mlp", "fused_ln_mlp_reference")
    if route == "block":
        count("fused_qkv_attention", "fused_qkv_attention_reference")
    port_grads(jax_params, route, remat)
    layers = VISION.num_layers
    rerun = remat == "full" or (remat == "attn_out" and route != "block")
    name = FORWARDS[route][1]
    want = {name: layers * (2 if rerun else 1)}
    if route in ("fused_mlp", "block"):
        want["fused_ln_mlp_reference"] = layers
    if route == "block":
        # K6's plain version runs K1's inside it.
        want["fused_qkv_attention_reference"] = want[name] + 1
    assert counts == want


@pytest.mark.parametrize("remat, want", [
    ("full", set()),
    ("attn_out", {"aten.addmm.default"}),
    ("attn_kernel", {"aten.addmm.default",
                     "pigeon.fused_qkv_attention.default"}),
    ("attn_slim", {"pigeon.fused_qkv_attention.default"})])
def test_policies_keep_their_tensors_and_no_view(jax_params, monkeypatch,
                                                 remat, want):
    """On ``fused`` each policy keeps ``out_proj``'s product and/or K1's
    output and nothing else: no view (a kept view of the kernel output
    would hold it under ``attn_out``, which recomputes it)."""
    kept = set()
    real = clip._remat_policy

    def policy(names, ctx, func, *a, **kw):
        out = real(names, ctx, func, *a, **kw)
        if out == clip.CheckpointPolicy.MUST_SAVE:
            kept.add(str(func))
        return out

    monkeypatch.setattr(clip, "_remat_policy", policy)
    port_grads(jax_params, "fused", remat)
    assert kept == want


def test_block_falls_back_to_attn_out(jax_params, monkeypatch):
    """On ``block`` the ``attn_kernel`` and ``attn_slim`` regions keep
    exactly what ``attn_out``'s keeps: K6's and K9's outputs."""
    seen = {}
    real = clip._remat_policy

    def policy(names, ctx, func, *a, **kw):
        out = real(names, ctx, func, *a, **kw)
        if out == clip.CheckpointPolicy.MUST_SAVE:
            seen.setdefault(names, set()).add(str(func))
        return out

    monkeypatch.setattr(clip, "_remat_policy", policy)
    for remat in ("attn_out", "attn_kernel", "attn_slim"):
        port_grads(jax_params, "block", remat)
    assert list(seen) == [("attn_out", "mlp_out")]
    assert seen[("attn_out", "mlp_out")] == {
        "pigeon.fused_block_attention.default", "pigeon.fused_ln_mlp.default"}


@pytest.fixture
def xla_twins(monkeypatch):
    """The JAX package's Pallas forwards and backwards as exact XLA
    equivalents (`tests/test_train_remat_fused.py`'s twins)."""
    from pigeon_tpu.kernels import flash_attention as fa
    from pigeon_tpu.kernels import fused_mlp as fm

    def fold(t, b, s, h, dh):
        return jnp.swapaxes(t.reshape(b, s, h, dh), 1, 2) \
            .reshape(b * h, s, dh)

    def fused_qkv(x, wq, wk, wv, bq, bk, bv, num_heads, head_dim=None):
        b, s, d = x.shape
        dh = head_dim or d // num_heads
        q, k, v = (fold((x @ w + bb).astype(x.dtype), b, s, num_heads, dh)
                   for w, bb in ((wq, bq), (wk, bk), (wv, bv)))
        out = fa._xla_attention_bshd(q, k, v)
        return jnp.swapaxes(out.reshape(b, num_heads, s, dh), 1, 2) \
            .reshape(b, s, d)

    def fused_qkv_backward(x, wq, wk, wv, bq, bk, bv, g, num_heads,
                           head_dim=None):
        b, s, d = x.shape
        dh = head_dim if head_dim is not None else d // num_heads
        q, k, v = (fold((x @ w + bb).astype(x.dtype), b, s, num_heads, dh)
                   for w, bb in ((wq, bq), (wk, bk), (wv, bv)))
        _, vjp = jax.vjp(fa._xla_attention_bshd, q, k, v)
        grads = vjp(fold(g.astype(x.dtype), b, s, num_heads, dh))
        dq, dk, dv = (jnp.swapaxes(t.reshape(b, num_heads, s, dh), 1, 2)
                      .reshape(b, s, num_heads * dh) for t in grads)
        return dq @ wq.T + dk @ wk.T + dv @ wv.T, dq, dk, dv

    def fused_ln_qkv(x, ls, lb, wq, wk, wv, bq, bk, bv, num_heads, eps):
        xn = fa._layer_norm_f32(x, ls, lb, eps).astype(x.dtype)
        return fused_qkv(xn, wq, wk, wv, bq, bk, bv, num_heads)

    def flash_bwd(q, k, v, g):
        return jax.vjp(fa._xla_attention_bshd, q, k, v)[1](g)

    monkeypatch.setattr(fa, "_flash_forward", fa._xla_attention_bshd)
    monkeypatch.setattr(fa, "_flash_backward", flash_bwd)
    monkeypatch.setattr(fa, "_fused_qkv_forward", fused_qkv)
    monkeypatch.setattr(fa, "_fused_qkv_backward", fused_qkv_backward)
    monkeypatch.setattr(fa, "_fused_ln_qkv_forward", fused_ln_qkv)
    monkeypatch.setattr(fa, "_fused_block_attn_forward",
                        lambda *a: fa._fused_block_reference(*a))
    monkeypatch.setattr(fm, "_fused_ln_mlp_forward",
                        lambda *a: fm._reference_ln_mlp(*a))


@pytest.mark.parametrize("remat", list(clip.REMATS))
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_policy_matches_jax(jax_params, xla_twins, route, remat):
    from pigeon_tpu.models.geocell_head import geocell_loss
    from pigeon_tpu.models.super_guessr import (
        SuperGuessr,
        trainable_last_layer_mask,
    )

    model = SuperGuessr(VISION, HEAD, dtype=jnp.float32,
                        attn_impl=ROUTES[route], remat=remat)
    b = {k: jnp.asarray(v) for k, v in batch().items()}

    def loss(params):
        out = model.apply({"params": params}, b["inputs"])
        return geocell_loss(
            out, jnp.asarray(CELLS), HEAD, labels_lla=b["labels"],
            labels_multi_task=b["labels_multi_task"],
            labels_climate=b["labels_climate"],
            labels_month=b["labels_month"])[0]

    mask = trainable_last_layer_mask(jax_params, VISION.num_layers)
    grads = jax.tree_util.tree_map(
        lambda g, m: np.asarray(g * m),
        jax.jit(jax.grad(loss))(jax_params), mask)
    want = state_dict_from_jax(grads)
    got = port_grads(jax_params, route, remat)
    for name, g in got.items():
        # 1e-4: the slice's bound (LayerNorm variance and summation order
        # differ between the packages).
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-4,
                                   err_msg=name)
