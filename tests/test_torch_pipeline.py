"""The port's GPipe schedule (`pigeon_tpu_torch/train/pipeline.py`) over
gloo ranks on the CPU, against the sequential tower: the cases of
`tests/test_pipeline.py`.

The JAX side runs in this process: the sequential `CLIPVisionTower` of
`tests/test_pipeline.py`'s config, its output and the gradients of
``sum(pooled**2)``; its weights are bridged into the port. The port's
side runs in 4 gloo processes (`tests/torch_ranks.py`, started once for
this module): the pipelined tower at pp/M = (2, 2) (dp = 2), (4, 1),
(4, 4) and pp x tp = (2, 2), its output and gradients against the
one-process tower's at `tests/test_pipeline.py`'s tolerances and against
JAX's at the tower's (1e-4); the pipelined train step against the
one-process step, and learning; the head's dropout drawn alike on every
stage; the two ValueError cases."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_ranks
from pigeon_tpu.config import VisionConfig
from pigeon_tpu.models.clip import CLIPVisionTower
from pigeon_tpu_torch.models.jax_bridge import state_dict_from_jax
from pigeon_tpu_torch.train.mesh import Mesh
from pigeon_tpu_torch.train.pipeline import pipeline_stack_apply

VISION = dict(image_size=16, patch_size=8, hidden_size=32,
              intermediate_size=64, num_layers=8, num_heads=4,
              projection_dim=16)
#: `tests/test_pipeline.py`'s bounds: the pipeline against the
#: sequential tower, forward and gradients.
FWD = dict(atol=2e-5, rtol=1e-5)
GRAD = dict(atol=2e-4, rtol=5e-3)
#: The port's tower against JAX's (ROADMAP's tower bound, f32).
TOWER = 1e-4


@pytest.fixture(scope="module")
def pool4():
    pool = torch_ranks.RankPool(4)
    yield pool
    pool.close()


def port_names(tree) -> dict:
    """A JAX tower tree as the port's tower state dict (no prefix)."""
    out = state_dict_from_jax({"vision": tree})
    return {k[len("vision."):]: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def setup():
    model = CLIPVisionTower(VisionConfig(**VISION))
    px = jnp.asarray(np.random.default_rng(0).normal(
        size=(8, 16, 16, 3)).astype(np.float32))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), px)["params"]
    want_h, want_p = model.apply({"params": params}, px)

    def loss(p):
        return jnp.sum(model.apply({"params": p}, px)[1] ** 2)

    grads = jax.grad(loss)(params)
    return (port_names(params), np.asarray(px), np.asarray(want_h),
            np.asarray(want_p), port_names(grads))


@pytest.mark.parametrize("pp,tp,m", [(2, 1, 2), (4, 1, 1), (4, 1, 4),
                                     (2, 2, 2)])
def test_pipelined_tower_matches_sequential(pool4, setup, pp, tp, m):
    state, px, want_h, want_p, want_g = setup
    results = pool4.run("pipeline_tower", state, VISION, px, pp, tp, m)
    for r, got in enumerate(results):
        assert got["mesh"] == {"data": 4 // (pp * tp), "stage": pp,
                               "model": tp}
        per = 8 // pp
        stage = (r // tp) % pp
        assert got["layers"] == sorted(str(i) for i in range(
            stage * per, (stage + 1) * per))
        np.testing.assert_allclose(got["h"], got["one_h"], **FWD)
        np.testing.assert_allclose(got["pooled"], got["one_pooled"], **FWD)
        np.testing.assert_allclose(got["pooled"], want_p, atol=TOWER,
                                   rtol=TOWER)
        np.testing.assert_allclose(got["h"], want_h, atol=TOWER,
                                   rtol=TOWER)
        assert sorted(got["grads"]) == sorted(want_g)
        for name, g in got["one_grads"].items():
            np.testing.assert_allclose(got["grads"][name], g, **GRAD,
                                       err_msg=name)
            np.testing.assert_allclose(got["grads"][name], want_g[name],
                                       **GRAD, err_msg=name)


def test_pipelined_train_step_learns(pool4):
    """pp = 4, M = 2, the whole model training: the first two steps'
    loss, grad_norm and parameters as one process's (1e-4), and the
    loss falls by a fifth over 8 steps."""
    from pigeon_tpu_torch.config import HeadConfig, PigeonConfig
    from pigeon_tpu_torch.config import VisionConfig as TorchVision
    from pigeon_tpu_torch.models.super_guessr import SuperGuessr, init_weights

    head = dict(num_cells=16, embed_dim=32, panorama=False, multi_task=True,
                smooth_labels=True)
    cfg = PigeonConfig(vision=TorchVision(**VISION), head=HeadConfig(**head))
    state = {k: v.numpy() for k, v in init_weights(
        SuperGuessr(cfg.vision, cfg.head), 0).state_dict().items()}
    rng = np.random.default_rng(0)
    cells = np.stack([np.linspace(-170, 170, 16),
                      np.linspace(-55, 65, 16)], -1).astype(np.float32)
    batch = {
        "inputs": rng.normal(size=(8, 16, 16, 3)).astype(np.float32),
        "labels": np.stack([rng.uniform(-180, 180, 8),
                            rng.uniform(-60, 70, 8)], -1).astype(np.float32),
        "labels_multi_task": rng.normal(size=(8, 6)).astype(np.float32),
        "labels_climate": rng.integers(0, 28, 8),
        "labels_month": rng.integers(0, 12, 8)}
    results = pool4.run("pipeline_steps", state, VISION, head, cells, batch,
                        4, 1, 2, 8)
    for r, got in enumerate(results):
        assert got["layers"] == [str(2 * r), str(2 * r + 1)]
        losses = [m["loss"] for m in got["metrics"]]
        assert all(np.isfinite(losses))
        assert losses[-1] < losses[0] * 0.8, losses
        for m, w in zip(got["metrics"], got["one_metrics"]):
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(m[key], w[key], rtol=1e-4,
                                           err_msg=key)
        for name, w in got["one_params"].items():
            np.testing.assert_allclose(got["params"][name], w, atol=1e-4,
                                       rtol=1e-4, err_msg=name)


def test_pipelined_step_draws_the_same_dropout_on_every_stage(pool4):
    """A hierarchical panorama head (view attention with dropout 0.1)
    runs on every stage: its draws must agree, or the stages' copies of
    the head part ways. pp = 2, dp = 2: every rank ends two steps with
    the same parameters and metrics."""
    from pigeon_tpu_torch.config import HeadConfig, PigeonConfig
    from pigeon_tpu_torch.config import VisionConfig as TorchVision
    from pigeon_tpu_torch.models.super_guessr import SuperGuessr, init_weights

    head = dict(num_cells=16, embed_dim=32, panorama=True,
                hierarchical=True, heading=True, smooth_labels=True)
    cfg = PigeonConfig(vision=TorchVision(**VISION), head=HeadConfig(**head))
    assert cfg.head.attn_dropout > 0
    state = {k: v.numpy() for k, v in init_weights(
        SuperGuessr(cfg.vision, cfg.head), 1).state_dict().items()}
    rng = np.random.default_rng(1)
    cells = np.stack([np.linspace(-170, 170, 16),
                      np.linspace(-55, 65, 16)], -1).astype(np.float32)
    batch = {"inputs": rng.normal(size=(4, 4, 16, 16, 3)).astype(np.float32),
             "heading": rng.normal(size=(4, 4, 2)).astype(np.float32),
             "labels": np.stack([rng.uniform(-180, 180, 4),
                                 rng.uniform(-60, 70, 4)],
                                -1).astype(np.float32)}
    results = pool4.run("pipeline_steps", state, VISION, head, cells, batch,
                        2, 1, 2, 2, reference=False)
    first = results[0]
    for got in results[1:]:
        assert got["metrics"] == first["metrics"]
        for name, w in first["params"].items():
            np.testing.assert_array_equal(got["params"][name], w,
                                          err_msg=name)


def test_rejects_indivisible_layers_and_batch():
    """6 layers over 4 stages, and a batch of 8 in 3 microbatches, raise
    before any rank is reached."""
    mesh = Mesh(pp=4)
    layers = [torch.nn.Identity() for _ in range(6)]
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_stack_apply(lambda layer, h: h, layers,
                             torch.zeros(8, 5, 32), mesh, 4)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_stack_apply(lambda layer, h: h, layers + layers[:2],
                             torch.zeros(8, 5, 32), mesh, 3)
