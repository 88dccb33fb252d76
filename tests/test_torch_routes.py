"""The attention routes ``flash``, ``flash_fused_ln``, ``flash_fused_mlp``
and ``flash_fused_block`` (and the ``PIGEON_FUSED_BWD=xla`` backward and
``PIGEON_FLASH_FWD=online``) of the PyTorch port against the JAX package,
on the CPU in f32, at 2 layers, D=128, 2 heads of 64: the bridged vision
tower, two finetune steps of the whole model (the JAX side through its
Pallas kernels in interpret mode, ``remat='none'``), and the port's
``attn_kernel`` remat on every route (equal gradients, each kernel forward
run once a layer)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pigeon_tpu.config import HeadConfig, PigeonConfig, VisionConfig
from pigeon_tpu_torch.kernels import attention as k34
from pigeon_tpu_torch.kernels import fused_block_attention as k6
from pigeon_tpu_torch.kernels import fused_ln_qkv_attention as k5
from pigeon_tpu_torch.kernels import fused_mlp as k9
from pigeon_tpu_torch.kernels import fused_qkv_attention as k12
from pigeon_tpu_torch.models.jax_bridge import state_dict_from_jax

VISION = VisionConfig(image_size=42, patch_size=14, hidden_size=128,
                      intermediate_size=512, num_layers=2, num_heads=2)
HEAD = HeadConfig(num_cells=37, embed_dim=128, panorama=True,
                  multi_task=True, heading=True)
CFG = PigeonConfig(vision=VISION, head=HEAD)
RNG = np.random.default_rng(21)
CELLS = np.stack([RNG.uniform(-180, 180, HEAD.num_cells),
                  RNG.uniform(-60, 70, HEAD.num_cells)], -1) \
    .astype(np.float32)
LR = 1e-3
#: The JAX package's route names and the port's.
ROUTES = {"flash": "flash", "flash_fused_ln": "fused_ln",
          "flash_fused_mlp": "fused_mlp", "flash_fused_block": "block"}
#: Each port route's kernel forwards (their plain versions on the CPU).
KERNEL_FORWARDS = {
    "fused": [(k12, "fused_qkv_attention_reference")],
    "flash": [(k34, "flash_attention_reference")],
    "fused_ln": [(k5, "fused_ln_qkv_attention_reference")],
    "fused_mlp": [(k5, "fused_ln_qkv_attention_reference"),
                  (k9, "fused_ln_mlp_reference")],
    "block": [(k6, "fused_block_attention_reference"),
              (k9, "fused_ln_mlp_reference")]}


@pytest.fixture
def interpret_mode(monkeypatch):
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


@pytest.fixture(scope="module")
def jax_params():
    from pigeon_tpu.models.super_guessr import SuperGuessr

    params = SuperGuessr(VISION, HEAD).init(
        jax.random.PRNGKey(11), jnp.zeros((1, 4, 42, 42, 3)))["params"]
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def batches(n, b=2, seed=4):
    """Panorama batches with every label the multi-task loss reads."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        heading = rng.uniform(0, 2 * np.pi, (b, 4))
        out.append({
            "inputs": rng.integers(0, 256, (b, 4, 42, 42, 3),
                                   dtype=np.uint8),
            "heading": np.stack([np.sin(heading), np.cos(heading)],
                                -1).astype(np.float32),
            "labels": np.stack([rng.uniform(-180, 180, b),
                                rng.uniform(-60, 70, b)],
                               -1).astype(np.float32),
            "labels_clf": rng.integers(0, HEAD.num_cells, b).astype(np.int32),
            "labels_multi_task": rng.normal(size=(b, 6)).astype(np.float32),
            "labels_climate": rng.integers(0, 28, b).astype(np.int32),
            "labels_month": rng.integers(0, 12, b).astype(np.int32)})
    return out


def port_state(params, route, remat="attn_kernel"):
    from pigeon_tpu_torch.train.modes import build_finetune_model
    from pigeon_tpu_torch.train.train_loop import TrainState, adamw

    model = build_finetune_model(CFG, dtype=torch.float32, attn_impl=route,
                                 remat=remat)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return TrainState(model, adamw(model.parameters(), LR))


@pytest.mark.parametrize("jax_impl", sorted(ROUTES))
def test_tower_matches_jax_on_each_route(jax_params, interpret_mode,
                                         jax_impl):
    from pigeon_tpu.models.clip import CLIPVisionTower
    from pigeon_tpu_torch.models.clip import CLIPVisionTower as TTower

    pixels = np.random.default_rng(1).normal(
        size=(3, 42, 42, 3)).astype(np.float32)
    want_hidden, want_pooled = CLIPVisionTower(
        VISION, attn_impl=jax_impl).apply(
        {"params": jax_params["vision"]}, jnp.asarray(pixels))
    tower = TTower(VISION, attn_impl=ROUTES[jax_impl])
    state = state_dict_from_jax(jax_params)
    tower.load_state_dict({k[len("vision."):]: v for k, v in state.items()
                           if k.startswith("vision.")}, strict=True)
    with torch.no_grad():
        hidden, pooled = tower(torch.from_numpy(pixels))
    # 1e-4 in f32: the tower bound of tests/test_torch_bridge.py (LayerNorm
    # variance and matmul summation order differ).
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_hidden),
                               atol=1e-4)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled),
                               atol=1e-4)


@pytest.mark.parametrize("jax_impl, fused_bwd", [
    ("flash", "kernel"), ("flash_fused_ln", "kernel"),
    ("flash_fused_mlp", "kernel"), ("flash_fused", "xla"),
    ("flash_fused_block", "kernel"), ("flash", "online")])
def test_two_train_steps_match_jax(jax_params, interpret_mode, monkeypatch,
                                   jax_impl, fused_bwd):
    from pigeon_tpu.data.image_ops import normalize_images
    from pigeon_tpu.models.geocell_head import geocell_loss
    from pigeon_tpu.models.super_guessr import trainable_last_layer_mask
    from pigeon_tpu.train.modes import build_finetune_model
    from pigeon_tpu.train.train_loop import (
        TrainState,
        adamw,
        make_train_step,
    )
    from pigeon_tpu_torch.train.train_loop import (
        batch_to_device,
        make_train_step as tstep,
    )

    # "online": PIGEON_FLASH_FWD=online (K3′ forward, K4 backward).
    if fused_bwd == "online":
        monkeypatch.setenv("PIGEON_FLASH_FWD", "online")
    else:
        monkeypatch.setenv("PIGEON_FUSED_BWD", fused_bwd)
    # Interpret-mode Pallas cannot run under jax.checkpoint, so the JAX
    # side runs remat='none'; the port runs its default, attn_kernel.
    model, _ = build_finetune_model(CFG, dtype=jnp.float32,
                                    attn_impl=jax_impl, remat="none")
    opt = adamw(LR)
    mask = trainable_last_layer_mask(jax_params, VISION.num_layers)
    step = make_train_step(model, opt, HEAD, CELLS, grad_mask=mask,
                           donate=False)

    def labels(batch, conv):
        return {("labels_lla" if k == "labels" else k): conv(batch[k])
                for k in ("labels", "labels_clf", "labels_multi_task",
                          "labels_climate", "labels_month")}

    def loss(params, batch):
        out = model.apply({"params": params},
                          normalize_images(jnp.asarray(batch["inputs"])),
                          heading=jnp.asarray(batch["heading"]))
        return geocell_loss(out, jnp.asarray(CELLS), HEAD,
                            **labels(batch, jnp.asarray))[0]

    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=jax_params,
                        opt_state=opt.init(jax_params))
    route = {"flash_fused": "fused"}.get(jax_impl) or ROUTES[jax_impl]
    state = port_state(jax_params, route)
    train_step = tstep(HEAD, torch.from_numpy(CELLS))
    grad_fn = jax.jit(jax.grad(loss))
    for batch in batches(2):
        jgrads = grad_fn(jstate.params, batch)
        jgrads = jax.tree_util.tree_map(lambda g, m: g * m, jgrads, mask)
        jstate, want = step(jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()},
                            jax.random.PRNGKey(0))
        got = train_step(state, batch_to_device(batch, "cpu"))
        assert sorted(got) == sorted(want)
        for key in want:
            # 1e-4: the tower and slice bound of tests/test_torch_train.py.
            np.testing.assert_allclose(got[key].item(), float(want[key]),
                                       rtol=1e-4, atol=1e-4, err_msg=key)
        want_grads = state_dict_from_jax(jax.device_get(jgrads))
        for name, p in state.model.named_parameters():
            if p.requires_grad:
                want_g = want_grads[name].numpy()
                got_g = (np.zeros_like(want_g) if p.grad is None
                         else p.grad.numpy())
                # 5e-4: the repo's bound for the fused QKV gradients.
                np.testing.assert_allclose(got_g, want_g, atol=5e-4,
                                           err_msg=name)
    assert state.step == int(jstate.step) == 2
    want_params = state_dict_from_jax(jax.device_get(jstate.params))
    for name, p in state.model.named_parameters():
        # AdamW moves each entry by ~LR * sign(g) a step: where a gradient
        # is near 0 the signs may differ, so two steps part by <= 2 * LR.
        diff = (p.detach() - want_params[name]).abs()
        assert diff.max().item() <= 2 * 2 * LR, name


@pytest.mark.parametrize("route", ["flash", "fused_ln", "fused_mlp",
                                   "block"])
def test_remat_attn_kernel_gives_the_gradients_of_none(jax_params,
                                                       monkeypatch, route):
    """Bit for bit on the CPU, with every kernel forward of the route
    (here its plain version) run once per layer: the recompute pass
    replays the saved outputs. (On ``block`` K6's backward runs K1 again
    on purpose, as the JAX VJP does; that is not a replay.)"""
    from pigeon_tpu_torch.train.train_loop import batch_loss, batch_to_device

    calls = []
    for module, name in KERNEL_FORWARDS[route]:
        fn = getattr(module, name)
        monkeypatch.setattr(
            module, name,
            lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a))
    batch = batch_to_device(batches(1)[0], "cpu")
    grads = {}
    for remat in ("none", "attn_kernel"):
        state = port_state(jax_params, route, remat)
        calls.clear()
        _, total, _ = batch_loss(state.model, batch,
                                 torch.from_numpy(CELLS), HEAD)
        total.backward()
        assert sorted(calls) == sorted(
            name for _, name in KERNEL_FORWARDS[route]
            for _ in range(VISION.num_layers)), remat
        grads[remat] = {n: p.grad for n, p in
                        state.model.named_parameters() if p.requires_grad}
    for name, g in grads["none"].items():
        other = grads["attn_kernel"][name]
        assert (g is None and other is None) or torch.equal(g, other), name


def test_switching_the_route_on_a_built_model(jax_params):
    """`set_route` switches a built model's route (the smoke test drives
    one model that way) and refuses an unknown one; an LN handed to a
    route that cannot fold it is refused."""
    from pigeon_tpu_torch.models.clip import ATTN_IMPLS, routes_of, set_route

    state = port_state(jax_params, "fused")
    pixels = torch.from_numpy(batches(1)[0]["inputs"][:, 0]).float() / 255
    outs = {}
    for route in ATTN_IMPLS:
        set_route(state.model, route)
        assert routes_of(state.model) == {route}
        assert state.model.vision.attn_impl == route
        with torch.no_grad():
            outs[route] = state.model.vision(pixels)[0]
    with pytest.raises(ValueError, match="not in"):
        set_route(state.model, "flash_fused")
    assert routes_of(state.model) == {ATTN_IMPLS[-1]}
    for route, out in outs.items():
        # 1e-4: the tower bound; only LayerNorm's form and sums differ.
        torch.testing.assert_close(out, outs["plain"], rtol=0, atol=1e-4,
                                   msg=route)
    layer = state.model.vision.encoder.layers[0]
    layer.attn.attn_impl = "flash"
    with pytest.raises(ValueError, match="fused float route"):
        layer.attn(torch.zeros(1, 3, 128), ln=layer.ln1)
