"""``--base`` weights: the port's `models/hf_import.py` against the JAX
package's import (`import_super_guessr_params` / `import_vision_tower_params`
+ `merge_params`, through the JAX CLI's `_load_base_checkpoint`) and
`jax_bridge.state_dict_from_jax`, on seeded state dicts in the
reference's SuperGuessr layout and HF's ``vision_model.*`` layout at the
CLI's ``--tiny`` size (2 layers, D=64, 4 heads, 64 px): the loaded
weights equal bit for bit, the f32 forwards within the slice bound, and a
shape mismatch refused by both."""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pigeon_tpu.config import HeadConfig, VisionConfig
from pigeon_tpu_torch.models.jax_bridge import state_dict_from_jax

#: The CLI's ``--tiny`` tower (`cli/run.py::make_config`).
VISION = VisionConfig(image_size=64, patch_size=16, hidden_size=64,
                      intermediate_size=128, num_layers=2, num_heads=4,
                      projection_dim=32)
HEADS = {"single": HeadConfig(num_cells=23, embed_dim=64),
         "panorama_multitask": HeadConfig(num_cells=23, embed_dim=64,
                                          panorama=True, multi_task=True,
                                          heading=True)}
HF_LAYER = ("layer_norm1", "layer_norm2", "self_attn.q_proj",
            "self_attn.k_proj", "self_attn.v_proj", "self_attn.out_proj",
            "mlp.fc1", "mlp.fc2")


def hf_vision_state(rng, prefix: str, dtype=torch.float32) -> dict:
    """A seeded HF `CLIPVisionModel` state dict of `VISION` under
    ``prefix``, with HF's ``position_ids`` buffer and a projection that
    neither import reads."""
    d, i, p = VISION.hidden_size, VISION.intermediate_size, VISION.patch_size
    tokens = (VISION.image_size // p) ** 2 + 1
    shapes = {"embeddings.patch_embedding.weight": (d, 3, p, p),
              "embeddings.class_embedding": (d,),
              "embeddings.position_embedding.weight": (tokens, d)}
    for ln in ("pre_layrnorm", "post_layernorm"):
        shapes.update({f"{ln}.weight": (d,), f"{ln}.bias": (d,)})
    for layer in range(VISION.num_layers):
        for name in HF_LAYER:
            out, inp = {"mlp.fc1": (i, d), "mlp.fc2": (d, i)}.get(
                name, (d, d))
            key = f"encoder.layers.{layer}.{name}"
            shapes[f"{key}.weight"] = (out, inp) if "proj" in name or \
                "mlp" in name else (d,)
            shapes[f"{key}.bias"] = (out,) if "proj" in name or \
                "mlp" in name else (d,)
    state = {prefix + k: torch.tensor(rng.normal(size=s) * 0.1,
                                      dtype=torch.float32).to(dtype)
             for k, s in shapes.items()}
    state[prefix + "embeddings.position_ids"] = torch.arange(tokens)[None]
    state["visual_projection.weight"] = torch.zeros(32, d)
    return state


def seeded_reference_state(rng, head: HeadConfig,
                           dtype=torch.float32) -> dict:
    """A seeded reference SuperGuessr ``.model``: the tower under
    ``base_model.vision_model.`` and the head linears of ``head``."""
    state = hf_vision_state(rng, "base_model.vision_model.", dtype)
    d_in = head.input_dim
    linears = {"cell_layer": (head.num_cells, d_in)}
    if head.multi_task:
        linears.update(multi_task_head=(head.num_mt_vars, head.embed_dim),
                       climate_layer=(head.num_climates, d_in),
                       month_layer=(head.num_months, d_in))
    for name, (out, inp) in linears.items():
        state[f"{name}.weight"] = torch.tensor(
            rng.normal(size=(out, inp)) * 0.1, dtype=torch.float32).to(dtype)
        state[f"{name}.bias"] = torch.tensor(
            rng.normal(size=out) * 0.1, dtype=torch.float32).to(dtype)
    return state


def jax_params(head: HeadConfig) -> dict:
    """The JAX `SuperGuessr`'s seeded initialisation, as numpy (a fresh
    copy of one initialisation per head)."""
    return jax.tree_util.tree_map(np.copy, _jax_init(head))


@functools.cache
def _jax_init(head: HeadConfig) -> dict:
    from pigeon_tpu.models.super_guessr import SuperGuessr

    views = (4,) if head.panorama else ()
    params = SuperGuessr(VISION, head).init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, *views, 64, 64, 3)))["params"]
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def port_model(head: HeadConfig, params: dict):
    """The port's f32 `SuperGuessr` holding the bridged ``params``."""
    from pigeon_tpu_torch.models.super_guessr import SuperGuessr

    model = SuperGuessr(VISION, head)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


def load_both(tmp_path, head: HeadConfig, state: dict):
    """``state`` saved to a file and loaded by the JAX CLI's
    `_load_base_checkpoint` over the JAX initialisation, and by the port's
    `load_base` into a model holding that same initialisation. Returns
    the JAX tree, the port model and the port's mapped tensors."""
    from pigeon_tpu.cli.run import _load_base_checkpoint
    from pigeon_tpu_torch.models.hf_import import load_base

    path = str(tmp_path / "base.pt")
    torch.save(state, path)
    params = jax_params(head)
    merged = _load_base_checkpoint(params, path, VISION.num_layers)
    model = port_model(head, params)
    loaded = load_base(model, path)
    return jax.tree_util.tree_map(np.asarray, merged), model, loaded


CASES = {
    "reference_single": ("single", "reference", torch.float32),
    "reference_panorama_multitask_bf16": ("panorama_multitask", "reference",
                                          torch.bfloat16),
    "hf_vision_model": ("single", "vision_model.", torch.float32),
    "hf_unprefixed_bf16": ("panorama_multitask", "", torch.bfloat16),
}


def make_state(case):
    head_name, layout, dtype = CASES[case]
    head = HEADS[head_name]
    rng = np.random.default_rng(len(case))
    if layout == "reference":
        return head, seeded_reference_state(rng, head, dtype)
    return head, hf_vision_state(rng, layout, dtype)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loaded_weights_equal_the_jax_import_bit_for_bit(tmp_path, case):
    """Every parameter of the port's model after ``--base`` equals the
    bridged JAX tree after the JAX CLI's import, bit for bit: the file's
    tensors as f32 (bf16 files widened), the patch embed flattened in
    (p, p, c) order, the parameters the file lacks (an HF file's head)
    untouched."""
    head, state = make_state(case)
    merged, model, loaded = load_both(tmp_path, head, state)
    want = state_dict_from_jax(merged)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for name, value in want.items():
        assert got[name].dtype == torch.float32, name
        assert torch.equal(got[name], value), name
    assert all(v.dtype == torch.float32 for v in loaded.values())
    has_head = CASES[case][1] == "reference"
    assert any(k.startswith("head.") for k in loaded) == has_head
    patch = state[next(k for k in state if k.endswith(
        "patch_embedding.weight"))].float()
    assert torch.equal(got["vision.patch_embed.weight"],
                       patch.permute(0, 2, 3, 1).reshape(64, -1))


@pytest.mark.parametrize("case", ["reference_single",
                                  "reference_panorama_multitask_bf16"])
def test_loaded_forward_matches_jax(tmp_path, case):
    """The f32 forwards of the two loaded models on the same pixels agree
    within 1e-4 (the slice bound), logits and embeddings."""
    from pigeon_tpu.models.super_guessr import SuperGuessr

    head, state = make_state(case)
    merged, model, _ = load_both(tmp_path, head, state)
    views = (4,) if head.panorama else ()
    rng = np.random.default_rng(3)
    pixels = rng.normal(size=(2, *views, 64, 64, 3)).astype(np.float32)
    kw = {}
    if head.heading:
        angle = rng.uniform(0, 2 * np.pi, (2, 4))
        kw["heading"] = np.stack([np.sin(angle), np.cos(angle)],
                                 -1).astype(np.float32)
    want = SuperGuessr(VISION, head).apply(
        {"params": merged}, jnp.asarray(pixels),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.inference_mode():
        got = model(torch.from_numpy(pixels),
                    **{k: torch.from_numpy(v) for k, v in kw.items()})
    for name in ("logits", "embedding"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("keys, shape", [
    (("cell_layer.weight",), (22, 64)),
    (tuple(f"base_model.vision_model.encoder.layers.{i}.mlp.fc1.weight"
           for i in range(VISION.num_layers)), (64, 64)),
])
def test_a_shape_mismatch_raises_in_both(tmp_path, keys, shape):
    """Tensors of another shape than the model's (fc1 in every layer,
    which the JAX import stacks) stop both imports; the port's leaves the
    model as it was."""
    from pigeon_tpu.cli.run import _load_base_checkpoint
    from pigeon_tpu_torch.models.hf_import import load_base

    head, state = make_state("reference_single")
    for key in keys:
        state[key] = torch.zeros(shape)
    path = str(tmp_path / "base.pt")
    torch.save(state, path)
    params = jax_params(head)
    with pytest.raises(ValueError, match="shape mismatch"):
        _load_base_checkpoint(params, path, VISION.num_layers)
    model = port_model(head, params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="shape mismatch"):
        load_base(model, path)
    for name, value in model.state_dict().items():
        assert torch.equal(value, before[name]), name


def test_a_head_the_model_lacks_is_not_loaded(tmp_path):
    """A multi-task checkpoint into a single-task model: the tower and the
    cell layer load, the other head linears have no parameter to go to
    (the JAX package's merged tree carries them unused)."""
    from pigeon_tpu_torch.models.hf_import import load_base

    _, state = make_state("reference_panorama_multitask_bf16")
    single = HEADS["single"]
    assert single.input_dim == HEADS["panorama_multitask"].input_dim
    model = port_model(single, jax_params(single))
    path = str(tmp_path / "base.pt")
    torch.save(state, path)
    loaded = load_base(model, path)
    assert "head.month_layer.weight" in loaded
    torch.testing.assert_close(model.head.cell_layer.weight,
                               state["cell_layer.weight"].float(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("head_name", sorted(HEADS))
def test_reference_state_inverts_the_import(head_name):
    """`reference_state` writes a model in the reference's layout, which
    the import maps back to the same tensors; the conv weight is the
    inverse permutation of the patch embed's."""
    from pigeon_tpu_torch.models.hf_import import (
        import_state,
        merge_state,
        reference_state,
    )

    head = HEADS[head_name]
    model = port_model(head, jax_params(head))
    state = reference_state(model)
    assert state["base_model.vision_model.embeddings.patch_embedding"
                 ".weight"].shape == (64, 3, 16, 16)
    other = port_model(head, jax.tree_util.tree_map(
        lambda a: a + 1, jax_params(head)))
    assert merge_state(other, import_state(state, VISION.num_layers)) == []
    for name, value in model.state_dict().items():
        assert torch.equal(other.state_dict()[name], value), name
