"""Scale-out of the PyTorch port (`pigeon_tpu_torch/train/mesh.py`,
`kernels/sharded.py`) against the JAX package's GSPMD mesh, on the CPU.

The JAX side runs in this process on the 8 virtual CPU devices
`tests/conftest.py` gives, on JAX's ``create_mesh(tp=2)`` (a (4, 2)
mesh); the port's side in 2 and 4 gloo processes (`tests/torch_ranks.py`,
started once for this module), on the same seeded numpy inputs and the
bridged weights, in f32:

* the sharding rules against JAX's `param_specs`, and `shard_params`
  then `gather_params` giving the state back bit for bit;
* train steps under DDP, FSDP2 and ``--tp 2`` against JAX's sharded
  step and against the port's one-process step;
* K1 (K2 behind it), K3 (K4) and K8 on the local heads (their plain
  versions) against the JAX `sharded_*` hostings in interpret mode;
* the cell-sharded head's loss; `pretrain`'s global-batch negatives;
* the routes with no sharded hosting stop the command.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_ranks
from pigeon_tpu.config import HeadConfig, VisionConfig
from pigeon_tpu_torch.models.jax_bridge import state_dict_from_jax

VISION = dict(image_size=32, patch_size=8, hidden_size=64,
              intermediate_size=128, num_layers=2, num_heads=4,
              projection_dim=32)
HEAD = dict(num_cells=16, embed_dim=64, panorama=True, multi_task=True,
            heading=True)
RNG = np.random.default_rng(22)
CELLS = np.stack([np.linspace(-170, 170, 16),
                  np.linspace(-55, 65, 16)], -1).astype(np.float32)
#: Parameters and metrics of a sharded step against the one-process
#: step's, in f32 (the sharded sums add in another order).
TOL = 1e-4


@pytest.fixture(scope="module")
def pool2():
    pool = torch_ranks.RankPool(2)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def pool4():
    pool = torch_ranks.RankPool(4)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def jax_mesh():
    from pigeon_tpu.train.mesh import create_mesh

    assert len(jax.devices()) == 8
    return create_mesh(tp=2)


@pytest.fixture
def interpret_mode(monkeypatch):
    """The JAX package's kernels as its own tests run them on the CPU."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("PIGEON_FUSED_GROUPS", "2")
    monkeypatch.setenv("PIGEON_FUSED_BWD", "kernel")
    monkeypatch.setenv("PIGEON_FUSED_BWD_GROUPS", "2")
    with pltpu.force_tpu_interpret_mode():
        yield


def batches(n, b=8, seed=3):
    rng = np.random.default_rng(seed)
    return [{
        "inputs": rng.normal(size=(b, 4, 32, 32, 3)).astype(np.float32),
        "heading": rng.normal(size=(b, 4, 2)).astype(np.float32),
        "labels": np.stack([rng.uniform(-180, 180, b),
                            rng.uniform(-60, 70, b)], -1).astype(np.float32),
        "labels_multi_task": rng.normal(size=(b, 6)).astype(np.float32),
        "labels_climate": rng.integers(0, 28, b).astype(np.int32),
        "labels_month": rng.integers(0, 12, b).astype(np.int32),
    } for _ in range(n)]


def jax_state(mesh, fsdp=False, lr=1e-3):
    from pigeon_tpu.train import create_train_state
    from pigeon_tpu.train.modes import build_finetune_model
    from pigeon_tpu.train.train_loop import adamw
    from pigeon_tpu.config import PigeonConfig

    cfg = PigeonConfig(vision=VisionConfig(**VISION),
                       head=HeadConfig(**HEAD))
    model, mask_builder = build_finetune_model(
        cfg, dtype=jnp.float32, attn_impl="xla", remat="none")
    opt = adamw(lr)
    state = create_train_state(jax.random.PRNGKey(0), model, opt,
                               (jnp.zeros((2, 4, 32, 32, 3)),), mesh=mesh,
                               fsdp=fsdp)
    return cfg, model, opt, state, mask_builder(state.params)


@pytest.fixture(scope="module")
def bridged(jax_mesh):
    """The JAX model's initial parameters as the port's state dict."""
    _, _, _, state, _ = jax_state(jax_mesh)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    return {k: v.numpy() for k, v in state_dict_from_jax(params).items()}


def one_process_steps(state, data, lr):
    """The port's train steps in this process, unsharded."""
    from pigeon_tpu_torch.config import PigeonConfig
    from pigeon_tpu_torch.config import HeadConfig as THead
    from pigeon_tpu_torch.config import VisionConfig as TVision
    from pigeon_tpu_torch.train.modes import build_finetune_model
    from pigeon_tpu_torch.train.train_loop import (
        TrainState,
        adamw,
        batch_to_device,
        make_train_step,
    )

    cfg = PigeonConfig(vision=TVision(**VISION), head=THead(**HEAD))
    model = build_finetune_model(cfg, dtype=torch.float32, attn_impl="fused")
    model.load_state_dict(torch_ranks.tensors(state), strict=True)
    st = TrainState(model, adamw(model.parameters(), lr))
    step = make_train_step(cfg.head, torch.from_numpy(CELLS))
    metrics = [{k: float(v) for k, v in
                step(st, batch_to_device(b, "cpu")).items()} for b in data]
    return metrics, {n: p.detach().numpy()
                     for n, p in model.named_parameters()}


def assert_params_close(got, want, name, lr):
    """Within `TOL`, but for the key biases: their gradient is 0 in exact
    arithmetic (the softmax ignores a shift shared by all keys), so
    AdamW's update of them follows rounding noise, up to ~lr a step
    either way (tests/test_torch_train.py exempts them alike)."""
    if name.endswith("k_proj.bias"):
        assert np.abs(got - want).max() <= 2 * lr, name
    else:
        np.testing.assert_allclose(got, want, atol=TOL, err_msg=name)


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------

def test_param_specs_follow_the_jax_rules(jax_mesh):
    """Each port parameter's spec is its JAX leaf's (the stacked layer
    axis dropped, transposed where the bridge transposes the kernel)."""
    from pigeon_tpu.train.mesh import param_specs as jax_specs
    from pigeon_tpu_torch.train.mesh import param_specs

    _, _, _, state, _ = jax_state(jax_mesh)
    params = jax.device_get(state.params)
    specs = jax_specs(params)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    # Mark every JAX leaf with its index, bridge, and read the index back.
    marked = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [np.full(leaf.shape, i, np.float32) for i, (_, leaf)
         in enumerate(flat)])
    port = state_dict_from_jax(marked)
    got = param_specs(port)
    sharded = 0
    for name, t in port.items():
        i = int(t.flatten()[0])
        leaf_shape = np.shape(flat[i][1])
        want = list(spec_leaves[i]) + [None] * (len(leaf_shape)
                                                - len(spec_leaves[i]))
        if len(leaf_shape) == t.dim() + 1:          # a stacked layer leaf
            want = want[1:]
        last = getattr(flat[i][0][-1], "key", "")
        if last == "kernel" and t.dim() == 2:       # the bridge transposes
            want = want[::-1]
        want = tuple(want) if "model" in want else ()
        have = tuple(got[name]) + (None,) * (len(want) - len(got[name]))
        assert (have if got[name] else ()) == want, name
        sharded += bool(want)
    # q/k/v/out/fc1/fc2 of 2 layers (weights 12, biases 8) and the head.
    assert sharded == 22


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_then_gather_gives_the_state_back(bridged, pool4, tp):
    shapes, same = zip(*pool4.run("shard_roundtrip", bridged, tp))
    assert all(same)
    q = "vision.encoder.layers.1.attn.q_proj.weight"
    fc2 = "vision.encoder.layers.0.fc2.weight"
    assert shapes[0][q] == (64 // tp, 64)
    assert shapes[0][fc2] == (64, 128 // tp)
    assert shapes[0]["head.cell_layer.bias"] == (16 // tp,)
    assert shapes[0]["vision.pos_embed"] == (17, 64)


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["ddp", "fsdp", "tp"])
def test_sharded_step_matches_jax_and_one_process(bridged, jax_mesh, pool2,
                                                  case):
    """One step at global batch 8: 2 ranks (DDP, FSDP2 or a 1 x 2 model
    axis) against JAX's step on its (4, 2) mesh (with ``fsdp`` where the
    port runs FSDP2) and against the port's unsharded step."""
    from pigeon_tpu.train import make_train_step, shard_batch

    lr = 1e-3
    data = batches(1)
    cfg, model, opt, state, mask = jax_state(jax_mesh, fsdp=case == "fsdp",
                                             lr=lr)
    step = make_train_step(model, opt, cfg.head, CELLS, grad_mask=mask,
                           donate=False)
    state, want = step(state, shard_batch(
        {k: jnp.asarray(v) for k, v in data[0].items()}, jax_mesh),
        jax.random.PRNGKey(0))
    want_params = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.device_get(state.params)).items()}

    tp = 2 if case == "tp" else 1
    results = pool2.run("finetune_steps", bridged, VISION, HEAD, CELLS,
                        data, tp=tp, fsdp=case == "fsdp", lr=lr)
    metrics, params = results[0]
    assert results[1][0] == metrics            # every rank logs the same
    one_metrics, one_params = one_process_steps(bridged, data, lr)
    for key in want:
        np.testing.assert_allclose(metrics[0][key], float(want[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)
        np.testing.assert_allclose(metrics[0][key], one_metrics[0][key],
                                   rtol=TOL, atol=TOL, err_msg=key)
    for name, p in params.items():
        assert_params_close(p, one_params[name], name, lr)
        # As tests/test_torch_train.py: AdamW's first step moves each
        # entry by ~lr * sign(g); a gradient within rounding of 0 may
        # take the other sign in JAX.
        diff = np.abs(p - want_params[name])
        assert diff.max() <= 2 * lr, name
        if not name.endswith("k_proj.bias"):
            assert (diff > 1e-6).mean() <= 0.05, name


@pytest.mark.parametrize("case", [dict(fsdp=True, tp=2),
                                  dict(fsdp=False, tp=2)])
def test_four_ranks_two_steps_match_one_process(bridged, pool4, case):
    """A (2, 2) mesh, with and without FSDP2, two steps at global batch
    8: the one-process port's metrics and parameters."""
    lr = 1e-4
    data = batches(2, seed=9)
    results = pool4.run("finetune_steps", bridged, VISION, HEAD, CELLS,
                        data, lr=lr, **case)
    one_metrics, one_params = one_process_steps(bridged, data, lr)
    for metrics, params in results:
        for got, want in zip(metrics, one_metrics):
            for key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=TOL,
                                           atol=TOL, err_msg=key)
        for name, p in params.items():
            assert_params_close(p, one_params[name], name, lr)


# ---------------------------------------------------------------------------
# The kernels on local heads
# ---------------------------------------------------------------------------

def test_hostings_match_the_jax_sharded_functions(jax_mesh, pool2,
                                                  interpret_mode):
    """K1 (K2 in the backward), K3 (K4) and K8 at 2 of 4 heads a rank
    against `sharded_fused_qkv_mha`, `sharded_mha` and
    `sharded_fused_qkv_mha_int8` on JAX's (4, 2) mesh."""
    import flax.linen  # noqa: F401  (pigeon_tpu.models.quant needs it)
    from pigeon_tpu.kernels.flash_attention import (
        sharded_fused_qkv_mha,
        sharded_fused_qkv_mha_int8,
        sharded_mha,
    )
    from pigeon_tpu.models.quant import quantize_channelwise

    b, s, d, h = 4, 17, 64, 4
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(b, s, d)) * 0.5).astype(np.float32)
    ws = [(rng.normal(size=(d, d)) * d ** -0.5).astype(np.float32)
          for _ in range(3)]
    bs = [(rng.normal(size=(d,)) * 0.1).astype(np.float32)
          for _ in range(3)]
    g = rng.normal(size=(b, s, d)).astype(np.float32)
    packs = []
    for _ in range(3):
        w_q, scale = quantize_channelwise(jnp.asarray(
            (rng.normal(size=(d, d)) * 0.1).astype(np.float32)))
        packs.append((np.asarray(w_q), np.asarray(scale),
                      (rng.normal(size=(d,)) * 0.1).astype(np.float32)))
    act_scale = np.float32(np.abs(x).max() / 127.0)

    def k1(x, *wb):
        return jnp.sum(sharded_fused_qkv_mha(x, *wb, h, jax_mesh) * g)

    args = [jnp.asarray(a) for a in (x, *ws, *bs)]
    want_k1 = np.asarray(sharded_fused_qkv_mha(*args, h, jax_mesh))
    grads = jax.grad(k1, argnums=tuple(range(7)))(*args)
    qkv = [jnp.asarray((x @ w + bb).reshape(b, s, h, d // h))
           for w, bb in zip(ws, bs)]
    want_k3 = np.asarray(sharded_mha(*qkv, jax_mesh))
    dq = jax.grad(lambda q: jnp.sum(sharded_mha(q, *qkv[1:], jax_mesh)
                                    * g.reshape(b, s, h, d // h)))(qkv[0])
    want_k8 = np.asarray(sharded_fused_qkv_mha_int8(
        jnp.asarray(x), act_scale,
        *(jnp.asarray(a) for p in packs for a in p), h, jax_mesh))

    got = pool2.run("hostings", x, [w.T.copy() for w in ws], bs, h, g,
                    wq8=[(w.T.copy(), sc, bb) for w, sc, bb in packs],
                    act_scale=act_scale)
    for r in got:
        # 5e-5 / 2e-5: the JAX package's f32 bounds for K1 and K3
        # (tests/test_flash_attention.py); K2's are 5e-4.
        np.testing.assert_allclose(r["k1"], want_k1, atol=5e-5)
        np.testing.assert_allclose(r["k1_dx"], np.asarray(grads[0]),
                                   atol=5e-4)
        for i in range(3):
            np.testing.assert_allclose(r[f"k1_dw{i}"],
                                       np.asarray(grads[1 + i]).T, atol=5e-4)
        np.testing.assert_allclose(r["k3"], want_k3.reshape(b, s, d),
                                   atol=2e-5)
        np.testing.assert_allclose(r["k3_dq"], np.asarray(dq).reshape(
            b, s, d), atol=5e-4)
        # The int8 bound (tests/test_torch_quant.py): q/k/v agree bit for
        # bit, the attention sums run in another order.
        np.testing.assert_allclose(r["k8"], want_k8, atol=5e-5)


def test_cell_sharded_head_loss_matches_jax(pool2):
    """The geocell layer split over 2 ranks by cells, its logits
    gathered before the loss: JAX's head loss and gradients."""
    from pigeon_tpu.models.geocell_head import GeocellHead, geocell_loss
    from pigeon_tpu_torch.models.jax_bridge import head_state_dict_from_jax

    head = dict(num_cells=16, embed_dim=64, smooth_labels=True)
    cfg = HeadConfig(**head)
    rng = np.random.default_rng(8)
    emb = rng.normal(size=(6, 64)).astype(np.float32)
    labels = np.stack([rng.uniform(-180, 180, 6),
                       rng.uniform(-60, 70, 6)], -1).astype(np.float32)
    model = GeocellHead(cfg)
    params = model.init(jax.random.PRNGKey(3), jnp.asarray(emb))["params"]

    def loss(p):
        out = model.apply({"params": p}, jnp.asarray(emb))
        return geocell_loss(out, jnp.asarray(CELLS), cfg,
                            labels_lla=jnp.asarray(labels))[0]

    want = float(loss(params))
    want_grads = {k: v.numpy() for k, v in head_state_dict_from_jax(
        jax.device_get(jax.grad(loss)(params))).items()}
    state = {k: v.numpy() for k, v in head_state_dict_from_jax(
        jax.device_get(params)).items()}
    for got, logits, grads in pool2.run("head_loss", state, head, emb,
                                        labels, CELLS):
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert logits.shape == (6, 16)
        for name, g in grads.items():
            np.testing.assert_allclose(g, want_grads[name.removeprefix(
                "head.")], atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# Pretraining
# ---------------------------------------------------------------------------

TEXT = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_layers=1, num_heads=2, max_position_embeddings=8,
            projection_dim=32)
CLIP_VISION = dict(image_size=16, patch_size=8, hidden_size=32,
                   intermediate_size=64, num_layers=1, num_heads=2,
                   projection_dim=32)


@pytest.fixture(scope="module")
def clip_state():
    from pigeon_tpu_torch.config import TextConfig as TText
    from pigeon_tpu_torch.config import VisionConfig as TVision
    from pigeon_tpu_torch.models.clip import CLIPModel
    from pigeon_tpu_torch.models.super_guessr import init_weights

    model = init_weights(CLIPModel(TVision(**CLIP_VISION), TText(**TEXT),
                                   eos_token_id=63), 4)
    return {k: v.numpy() for k, v in model.state_dict().items()}


def clip_batches(n, b=8, seed=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(1, 62, (b, 8))
        ids[np.arange(b), rng.integers(2, 8, b)] = 63      # an EOS a row
        out.append({"pixel_values": rng.normal(size=(b, 16, 16, 3))
                    .astype(np.float32), "input_ids": ids})
    return out


@pytest.mark.parametrize("case", [dict(pool="pool2", tp=1),
                                  dict(pool="pool2", tp=1, fsdp=True),
                                  dict(pool="pool4", tp=2, fsdp=True)])
def test_pretrain_negatives_span_the_global_batch(clip_state, case,
                                                  request):
    """Each rank's rows of a global batch of 8, the loss over all 8
    (all-gathered embeddings): the unsharded step's loss and gradients,
    and after 4 micro-steps at 2 an update (accumulation, clipping) its
    global norm, the logit scale (whole on every rank under FSDP2)
    counted once, and its parameters."""
    import copy

    pool = request.getfixturevalue(case.pop("pool"))
    data = clip_batches(4)
    results = pool.run("pretrain_steps", clip_state, CLIP_VISION, TEXT,
                       data, accum=2, lr=1e-4, **copy.deepcopy(case))
    want = one_process_pretrain(clip_state, data)
    for losses, grads, norms, params in results:
        np.testing.assert_allclose(losses, want[0], rtol=1e-5, atol=1e-6)
        for name, g in want[1].items():
            np.testing.assert_allclose(grads[name], g, atol=1e-5,
                                       err_msg=name)
        assert len(norms) == len(want[2]) == 2
        np.testing.assert_allclose(norms, want[2], rtol=1e-5)
        for name, p in want[3].items():
            np.testing.assert_allclose(params[name], p, atol=TOL,
                                       err_msg=name)


def one_process_pretrain(state, data):
    from pigeon_tpu_torch.config import TextConfig as TText
    from pigeon_tpu_torch.config import VisionConfig as TVision
    from pigeon_tpu_torch.models.clip import CLIPModel
    from pigeon_tpu_torch.train.modes import make_pretrain_step
    from pigeon_tpu_torch.train.train_loop import TrainState, adamw

    model = CLIPModel(TVision(**CLIP_VISION), TText(**TEXT), eos_token_id=63)
    model.load_state_dict(torch_ranks.tensors(state))
    opt = adamw(model.parameters(), 1e-4, max_grad_norm=1.0, accum_steps=2)
    st = TrainState(model, opt)
    step = make_pretrain_step()
    losses, first, norms = [], None, []
    norm_of = opt.grad_norm
    opt.grad_norm = lambda params: norms.append(
        float(norm_of(params))) or torch.tensor(norms[-1])
    for batch in data:
        original = opt.step

        def keep():
            nonlocal first
            if first is None:
                first = {n: p.grad.numpy().copy()
                         for n, p in model.named_parameters()
                         if p.grad is not None}
            return original()

        opt.step = keep
        got = step(st, {"pixel_values": torch.from_numpy(
            batch["pixel_values"]), "input_ids": torch.from_numpy(
                batch["input_ids"]).long()})
        opt.step = original
        losses.append(float(got["loss"]))
    return losses, first, norms, {n: p.detach().numpy()
                                  for n, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["flash_fused_ln", "flash_fused_mlp",
                                   "flash_fused_block"])
def test_unsharded_routes_stop_under_tp(pool2, tmp_path, route):
    """K5, K6, K7 and K9 have no sharded hosting in the JAX package: the
    port's command stops with a message that says so (after the mesh is
    up, before any step)."""
    argv = ["finetune", "x", "--tiny", "--device", "cpu", "--tp", "2",
            "--metadata", "missing.csv", "--geocells", "missing.csv"]
    got = pool2.run("cli", argv, str(tmp_path), {"PIGEON_ATTN_IMPL": route})
    assert all("no sharded hosting" in g for g in got), got


def test_tp_widths_the_card_cannot_take_stop(monkeypatch):
    """On the card K1, K2 and K8 take P in multiples of 128: a tp that
    leaves one 64-wide head a rank (ViT-L/14 at tp = 16) stops."""
    from pigeon_tpu_torch.config import VisionConfig as TVision
    from pigeon_tpu_torch.models.clip import CLIPVisionTower
    from pigeon_tpu_torch.train.mesh import Mesh, check_widths

    tower = CLIPVisionTower(TVision(image_size=28, patch_size=14,
                                    hidden_size=1024, intermediate_size=64,
                                    num_layers=1, num_heads=16))
    check_widths(tower, Mesh(tp=8), "cuda")
    check_widths(tower, Mesh(tp=16), "cpu")
    with pytest.raises(ValueError, match="multiples of 128"):
        check_widths(tower, Mesh(tp=16), "cuda")
