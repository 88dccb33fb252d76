"""The generic ViT embedder of the PyTorch port against the JAX package's
(`pigeon_tpu/models/vit_embedder.py`), on the CPU in f32: one seeded HF
`ViTModel` state dict (``vit.``-prefixed and bare) through both
`import_vit_params`, the forward with CLS and mean pooling on every
route of the port (the plain versions of its kernels; kernel K9 never,
the MLPs being exact GELU), and the exact-GELU layer of the tower."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pigeon_tpu_torch.models.jax_bridge import vit_state_dict_from_jax
from tests.test_torch_hf_import import VISION

#: HF `ViTLayer` tensors: (name, weight shape) with D and I symbolic.
HF_VIT_LAYER = (("layernorm_before", "d"), ("layernorm_after", "d"),
                ("attention.attention.query", "dd"),
                ("attention.attention.key", "dd"),
                ("attention.attention.value", "dd"),
                ("attention.output.dense", "dd"),
                ("intermediate.dense", "id"), ("output.dense", "di"))


def seeded_hf_vit_state(rng, vision, prefix: str = "vit.",
                 dtype=torch.float32) -> dict:
    """A seeded HF `ViTModel` state dict of ``vision`` under ``prefix``,
    with a pooler that neither import reads."""
    d, i, p = vision.hidden_size, vision.intermediate_size, vision.patch_size
    dims = {"d": d, "i": i}
    shapes = {"embeddings.cls_token": (1, 1, d),
              "embeddings.position_embeddings": (1, vision.seq_len, d),
              "embeddings.patch_embeddings.projection.weight": (d, 3, p, p),
              "embeddings.patch_embeddings.projection.bias": (d,),
              "layernorm.weight": (d,), "layernorm.bias": (d,),
              "pooler.dense.weight": (d, d), "pooler.dense.bias": (d,)}
    for layer in range(vision.num_layers):
        for name, shape in HF_VIT_LAYER:
            key = f"encoder.layer.{layer}.{name}"
            shapes[f"{key}.weight"] = tuple(dims[c] for c in shape)
            shapes[f"{key}.bias"] = (dims[shape[0]],)
    state = {}
    for key, shape in shapes.items():
        value = rng.normal(size=shape) * 0.1
        if "layernorm" in key and key.endswith("weight"):
            value += 1.0
        state[prefix + key] = torch.tensor(value, dtype=torch.float32) \
            .to(dtype)
    return state


def pixels(rng, b=3) -> np.ndarray:
    return rng.normal(size=(b, VISION.image_size, VISION.image_size, 3)) \
        .astype(np.float32)


@pytest.mark.parametrize("prefix", ["vit.", ""])
def test_import_vit_params_matches_jax(prefix):
    """Both packages' `import_vit_params` give the same tensors, bit for
    bit, under the port's names, with or without the ``vit.`` prefix."""
    from pigeon_tpu.models.vit_embedder import import_vit_params as jax_import
    from pigeon_tpu_torch.models.vit_embedder import (
        ViTEmbedder,
        import_vit_params,
    )

    state = seeded_hf_vit_state(np.random.default_rng(0), VISION, prefix)
    got = import_vit_params(state, VISION.num_layers)
    want = vit_state_dict_from_jax(jax_import(state, VISION.num_layers))
    assert got.keys() == want.keys() == ViTEmbedder(VISION).state_dict() \
        .keys()
    for name, value in want.items():
        assert torch.equal(got[name], value), name


ROUTES = ("plain", "fused", "flash", "fused_ln", "fused_mlp", "block")


@pytest.mark.parametrize("pool", ["cls", "mean"])
@pytest.mark.parametrize("route", ROUTES)
def test_vit_embedder_matches_jax(pool, route, monkeypatch):
    """The port's `ViTEmbedder` on each route against the JAX package's
    on ``xla``, from one seeded HF state dict, in f32: within 1e-4. K9
    (the fused LN + quick-GELU MLP) is never called."""
    from pigeon_tpu.models.vit_embedder import ViTEmbedder as JaxViT
    from pigeon_tpu.models.vit_embedder import import_vit_params as jax_import
    from pigeon_tpu_torch.kernels import fused_mlp
    from pigeon_tpu_torch.models.vit_embedder import (
        ViTEmbedder,
        import_vit_params,
    )

    monkeypatch.setattr(fused_mlp, "fused_ln_mlp_reference",
                        lambda *a, **k: pytest.fail("K9 ran a GELU MLP"))
    rng = np.random.default_rng(1)
    state = seeded_hf_vit_state(rng, VISION)
    x = pixels(rng)
    want = JaxViT(VISION, pool=pool).apply(
        {"params": jax_import(state, VISION.num_layers)}, jnp.asarray(x))
    model = ViTEmbedder(VISION, pool=pool, attn_impl=route)
    model.load_state_dict(import_vit_params(state, VISION.num_layers),
                          strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (3, VISION.hidden_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_gelu_layer_is_exact_erf_and_refuses_other_activations():
    """A ``gelu`` tower layer runs ``F.gelu(approximate="none")``, JAX's
    ``jax.nn.gelu(approximate=False)``; an activation the port lacks is
    refused by name."""
    import dataclasses

    from pigeon_tpu.models.clip import _ACTIVATIONS
    from pigeon_tpu_torch.models.clip import ACTIVATIONS, TransformerLayer

    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    np.testing.assert_allclose(ACTIVATIONS["gelu"](torch.from_numpy(x)),
                               np.asarray(_ACTIVATIONS["gelu"](
                                   jnp.asarray(x))), atol=1e-6)
    assert not np.allclose(np.asarray(_ACTIVATIONS["gelu_approx"](
        jnp.asarray(x))), ACTIVATIONS["gelu"](torch.from_numpy(x)),
        atol=1e-6)
    with pytest.raises(ValueError, match="gelu_approx"):
        TransformerLayer(dataclasses.replace(VISION,
                                             hidden_act="gelu_approx"))


def test_vit_embedder_init_and_refused_pool():
    """`init_weights` zeroes the CLS token and patch bias as the JAX
    initialisers do; an unknown pooling is refused."""
    from pigeon_tpu_torch.models.super_guessr import init_weights
    from pigeon_tpu_torch.models.vit_embedder import ViTEmbedder

    model = init_weights(ViTEmbedder(VISION), 0)
    assert not model.cls_token.any() and not model.patch_embed.bias.any()
    assert 0.01 < model.pos_embed.std().item() < 0.03
    with pytest.raises(ValueError, match="pool"):
        ViTEmbedder(VISION, pool="max")


def test_hf_vit_state_round_trips():
    """`hf_vit_state` writes a model under HF's names; `import_vit_params`
    reads back every tensor bit for bit (the GPU smoke's ``--base`` file
    for ``embed --embedder vit`` is written so)."""
    from pigeon_tpu_torch.models.super_guessr import init_weights
    from pigeon_tpu_torch.models.vit_embedder import (
        ViTEmbedder,
        hf_vit_state,
        import_vit_params,
    )

    model = init_weights(ViTEmbedder(VISION), 3)
    with torch.no_grad():
        model.cls_token.normal_()
    state = hf_vit_state(model)
    assert state.keys() == hf_vit_state_keys()
    back = import_vit_params(state, VISION.num_layers)
    assert back.keys() == model.state_dict().keys()
    for name, value in model.state_dict().items():
        assert torch.equal(back[name], value), name


def hf_vit_state_keys() -> set:
    return {k for k in seeded_hf_vit_state(np.random.default_rng(0), VISION,
                                           "")
            if not k.startswith("pooler.")}
