"""Hierarchical view aggregation of the port's geocell head
(`models/geocell_head.py::ViewAttention`) against the JAX package's
``GeocellHead(hierarchical=True)``, bridged (`models/jax_bridge.py`),
deterministic, with and without heading, and a panorama `SuperGuessr`
train step on it."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pigeon_tpu.config import HeadConfig, VisionConfig

HEAD = HeadConfig(num_cells=13, embed_dim=32, panorama=True,
                  hierarchical=True, multi_task=True, num_attention_heads=4)


def inputs(b=3, d=32, seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, (b, 4))
    return (rng.normal(size=(b, 4, d)).astype(np.float32),
            np.stack([np.sin(theta), np.cos(theta)], -1).astype(np.float32))


@pytest.mark.parametrize("heading", ["given", "default", "off"])
def test_head_matches_jax(heading):
    from pigeon_tpu.models.geocell_head import GeocellHead as JaxHead
    from pigeon_tpu_torch.models.geocell_head import GeocellHead
    from pigeon_tpu_torch.models.jax_bridge import head_state_dict_from_jax

    cfg = dataclasses.replace(HEAD, heading=heading != "off")
    emb, hd = inputs()
    hd = hd if heading == "given" else None
    params = JaxHead(cfg).init(jax.random.PRNGKey(1), jnp.asarray(emb),
                               None if hd is None else jnp.asarray(hd))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    want = JaxHead(cfg).apply({"params": params}, jnp.asarray(emb),
                              None if hd is None else jnp.asarray(hd))
    head = GeocellHead(cfg)
    head.load_state_dict(head_state_dict_from_jax(params), strict=True)
    head.eval()
    got = head(torch.from_numpy(emb),
               None if hd is None else torch.from_numpy(hd))
    width = 32 + (4 if cfg.heading else 0)
    assert got.aggregated.shape == (3, width)
    for key in ("logits", "aggregated", "preds_mt", "preds_climate",
                "preds_month"):
        # 1e-5: f32 products in another order.
        np.testing.assert_allclose(getattr(got, key).detach().numpy(),
                                   np.asarray(getattr(want, key)),
                                   atol=1e-5, rtol=1e-5, err_msg=key)


def test_dropout_follows_training_mode():
    from pigeon_tpu_torch.models.geocell_head import GeocellHead

    head = GeocellHead(dataclasses.replace(HEAD, attn_dropout=0.5))
    emb = torch.from_numpy(inputs()[0])
    head.eval()
    assert torch.equal(head(emb).logits, head(emb).logits)
    head.train()
    torch.manual_seed(0)
    assert not torch.equal(head(emb).logits, head(emb).logits)


def test_panorama_train_step_matches_jax():
    """One AdamW step of a panorama `SuperGuessr` with the hierarchical
    head (no dropout, the plain attention route on both sides): the loss
    parts and the gradients, read from Adam's first moment."""
    from pigeon_tpu.config import PigeonConfig
    from pigeon_tpu.models.super_guessr import (
        SuperGuessr,
        trainable_last_layer_mask,
    )
    from pigeon_tpu.train.train_loop import (
        TrainState,
        adamw,
        make_train_step,
    )
    from pigeon_tpu_torch.models.jax_bridge import state_dict_from_jax
    from pigeon_tpu_torch.train.modes import build_finetune_model
    from pigeon_tpu_torch.train.train_loop import adamw as port_adamw
    from pigeon_tpu_torch.train.train_loop import (
        TrainState as PortState,
        batch_to_device,
        make_train_step as port_step,
    )

    vision = VisionConfig(image_size=28, patch_size=14, hidden_size=32,
                          intermediate_size=64, num_layers=2, num_heads=4,
                          projection_dim=16)
    head = dataclasses.replace(HEAD, heading=True, attn_dropout=0.0)
    cells = np.stack([np.linspace(-170, 170, 13),
                      np.linspace(-55, 65, 13)], -1).astype(np.float32)
    rng = np.random.default_rng(5)
    emb, hd = inputs()
    batch = {"inputs": rng.integers(0, 256, (3, 4, 28, 28, 3),
                                    dtype=np.uint8),
             "heading": hd,
             "labels": np.stack([rng.uniform(-170, 170, 3),
                                 rng.uniform(-55, 65, 3)],
                                -1).astype(np.float32),
             "labels_multi_task": rng.normal(size=(3, 6)).astype(np.float32),
             "labels_climate": rng.integers(0, 28, 3).astype(np.int32),
             "labels_month": rng.integers(0, 12, 3).astype(np.int32)}
    model = SuperGuessr(vision, head, dtype=jnp.float32, attn_impl="xla")
    params = model.init(jax.random.PRNGKey(2), jnp.zeros((1, 4, 28, 28, 3)),
                        heading=jnp.asarray(hd[:1]))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    opt = adamw(1e-3)
    mask = trainable_last_layer_mask(params, vision.num_layers)
    step = make_train_step(model, opt, head, cells, grad_mask=mask,
                           donate=False)
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                        opt_state=opt.init(params))
    jstate, want = step(jstate, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, jax.random.PRNGKey(0))

    cfg = PigeonConfig(vision=vision, head=head)
    tmodel = build_finetune_model(cfg, dtype=torch.float32,
                                  attn_impl="plain", remat="none")
    tmodel.load_state_dict(state_dict_from_jax(params), strict=True)
    state = PortState(tmodel, port_adamw(tmodel.parameters(), 1e-3))
    got = port_step(head, torch.from_numpy(cells))(
        state, batch_to_device(batch, "cpu"))
    for key in want:
        # 1e-4: the slice's bound.
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    attn = tmodel.head.view_attention
    assert all(torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0
               for p in attn.parameters())
    # Adam's first moment after one step is 0.1 g: the gradients of the
    # trainable parameters, the view attention's among them, within the
    # slice's 1e-4 (times 0.1).
    mu = state_dict_from_jax(jax.device_get(jstate.opt_state[0][0].mu))
    moments = state.optimizer.state_dict()["state"]
    trainable = [n for n, p in tmodel.named_parameters() if p.requires_grad]
    assert {trainable[i] for i in moments} >= {
        n for n in trainable if n.startswith("head.view_attention")}
    for i, name in enumerate(trainable):
        if i not in moments:            # post_ln: the head reads no CLS
            continue
        np.testing.assert_allclose(moments[i]["exp_avg"].numpy(),
                                   mu[name].numpy(), atol=1e-5, err_msg=name)
