"""The plain reference against the port's CPU path in float32 at the tiny
size: the tower's embeddings, the head's outputs, the loss and the
gradients of the trained leaves, and one AdamW update against
``torch.optim.AdamW``. The port's CPU path runs its kernels' plain
versions, so the two agree to float32 rounding."""

import torch

from portbench import inputs, program
from portbench.drivers.train import trained_names
from portbench.reference import model as ref
from portbench.tests.tiny import tiny_config

SEED = 7


def port_model(cfg, weights):
    from pigeon_tpu_torch.models.super_guessr import SuperGuessr
    from pigeon_tpu_torch.models.super_guessr import \
        freeze_all_but_last_layer

    pcfg = program.pigeon_config(cfg)
    model = program.build(lambda: SuperGuessr(
        pcfg.vision, pcfg.head, dtype=torch.float32,
        attn_impl=program.route(cfg)), "cpu")
    program.load(model, weights)
    return freeze_all_but_last_layer(model), pcfg


def batch(cfg, b=3):
    s = cfg["image_size"]
    px = inputs.pixels(SEED, "px", (b, 4, s, s, 3), "cpu")
    return px, inputs.train_labels(SEED, "labels", b, cfg, "cpu")


def test_tower_embeddings_match():
    cfg = tiny_config()
    w = inputs.make_weights(cfg, cfg, SEED, "cpu")
    model, _ = port_model(cfg, w)
    px, _ = batch(cfg)
    views = px.reshape(-1, *px.shape[2:])
    from pigeon_tpu_torch.data.image_ops import normalize_images

    with torch.no_grad():
        last, _ = model.vision(normalize_images(views))
    got = last.mean(1)
    want = ref.embed(w, cfg, views, block=5)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_loss_and_gradients_match():
    from pigeon_tpu_torch.data.image_ops import normalize_images
    from pigeon_tpu_torch.train.train_loop import batch_loss

    cfg = tiny_config()
    w = inputs.make_weights(cfg, cfg, SEED, "cpu")
    model, pcfg = port_model(cfg, w)
    px, labels = batch(cfg)
    cells = inputs.points(SEED, "cells", cfg["num_cells"], "cpu")
    _, total, _ = batch_loss(model, dict(labels, inputs=normalize_images(px)),
                             cells, pcfg.head)
    total.backward()
    trained = trained_names(cfg)
    loss, grads, _ = ref.loss_and_grads(w, trained, cfg, cfg, px, labels,
                                        cells, block=2)
    assert abs(total.item() - loss) <= 1e-5 * abs(loss)
    params = dict(model.named_parameters())
    assert sorted(n for n, p in params.items() if p.requires_grad) \
        == sorted(trained)
    for name in trained:
        got = params[name].grad
        got = torch.zeros_like(grads[name]) if got is None else got
        torch.testing.assert_close(got, grads[name], rtol=1e-3, atol=1e-6)


def test_adamw_matches_torch():
    torch.manual_seed(0)
    p = torch.randn(5, 3)
    q = p.clone().requires_grad_(True)
    opt = torch.optim.AdamW([q], lr=1e-2, weight_decay=0.1)
    mine = ref.AdamW(1e-2, weight_decay=0.1)
    params = {"p": p}
    for _ in range(3):
        g = torch.randn(5, 3)
        q.grad = g.clone()
        opt.step()
        mine.step(params, {"p": g})
    torch.testing.assert_close(params["p"], q.detach(), rtol=1e-6,
                               atol=1e-7)


def test_fp8_control_departs_from_float32():
    cfg = tiny_config()
    w = inputs.make_weights(cfg, cfg, SEED, "cpu")
    px, _ = batch(cfg)
    views = px.reshape(-1, *px.shape[2:])
    f32 = ref.embed(w, cfg, views)
    fp8 = ref.embed(w, cfg, views, fp8=True)
    err = ((fp8 - f32).norm(dim=-1) / f32.norm(dim=-1)).max().item()
    assert 1e-3 < err < 0.5
