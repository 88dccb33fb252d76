"""The serving slice of the PyTorch port against the JAX package, on the
CPU in f32: the same uint8 panorama through JAX `SuperGuessr`
(``attn_impl='flash_fused'``, its Pallas kernel in interpret mode) plus
`geocell_predictions`, and through the port's `make_serving_fn`; the same
numpy prototype bank and queries through both refiners; and the pieces
between them one by one."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pigeon_tpu.config import HeadConfig, VisionConfig
from pigeon_tpu_torch.models.jax_bridge import state_dict_from_jax

VISION = VisionConfig(image_size=42, patch_size=14, hidden_size=64,
                      intermediate_size=128, num_layers=2, num_heads=4)
HEAD = HeadConfig(num_cells=37, embed_dim=64, panorama=True,
                  multi_task=True, heading=True)
RNG = np.random.default_rng(11)
# Cells over Europe: candidates lie 0-3000 km apart, so the refiner's
# 1000 km cancel gate both passes and cancels.
CELLS = np.stack([RNG.uniform(-10, 25, HEAD.num_cells),
                  RNG.uniform(36, 60, HEAD.num_cells)], -1) \
    .astype(np.float32)


@pytest.fixture
def interpret_mode(monkeypatch):
    """The Pallas kernel as the JAX package's tests run it on the CPU."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("PIGEON_FUSED_GROUPS", "2")
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture(scope="module")
def jax_model_and_params():
    from pigeon_tpu.models.super_guessr import SuperGuessr

    # Both routes share one parameter tree; init on the XLA route, which
    # runs outside interpret mode.
    params = SuperGuessr(VISION, HEAD).init(
        jax.random.PRNGKey(5), jnp.zeros((1, 4, 42, 42, 3)))["params"]
    model = SuperGuessr(VISION, HEAD, attn_impl="flash_fused")
    return model, jax.tree_util.tree_map(np.asarray,
                                         jax.device_get(params))


def port_model(params, head=HEAD):
    from pigeon_tpu_torch.models.super_guessr import SuperGuessr

    model = SuperGuessr(VISION, head, attn_impl="fused")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


def test_serving_forward_matches_jax(jax_model_and_params, interpret_mode):
    from pigeon_tpu.data.image_ops import normalize_images
    from pigeon_tpu.models.geocell_head import geocell_predictions
    from pigeon_tpu_torch.data.image_ops import normalize_images as tnorm
    from pigeon_tpu_torch.serve.server import make_serving_fn

    model, params = jax_model_and_params
    pixels = np.random.default_rng(2).integers(
        0, 256, (2, 4, 42, 42, 3), dtype=np.uint8)
    out = model.apply({"params": params}, normalize_images(pixels))
    want = geocell_predictions(out.logits, jnp.asarray(CELLS),
                               HEAD.num_candidates)

    tmodel = port_model(params)
    got = make_serving_fn(tmodel, HEAD, CELLS, "cpu")(pixels)
    with torch.inference_mode():
        logits = tmodel(tnorm(torch.from_numpy(pixels))).logits

    # 1e-4 in f32: two encoder layers, LayerNorm variance taken another
    # way, matmuls summed in another order (as the tower test).
    np.testing.assert_allclose(got["embedding"].numpy(),
                               np.asarray(out.embedding), atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(out.logits),
                               atol=1e-4)
    np.testing.assert_allclose(got["preds_mt"].numpy(),
                               np.asarray(out.preds_mt), atol=1e-4)
    # 1e-5: probabilities are softmax outputs of logits that agree to
    # 1e-4 over 37 cells.
    np.testing.assert_allclose(got["topk_probs"].numpy(),
                               np.asarray(want["topk_probs"]), atol=1e-5)
    np.testing.assert_array_equal(got["topk_cells"].numpy(),
                                  np.asarray(want["topk_cells"]))
    np.testing.assert_array_equal(got["pred_lla"].numpy(),
                                  np.asarray(want["pred_lla"]))


def test_single_image_head_with_heading_matches_jax():
    """Single-image mode keeps the heading features (input_dim D + 2)."""
    from pigeon_tpu.models.geocell_head import GeocellHead
    from pigeon_tpu_torch.models.geocell_head import GeocellHead as THead

    head = dataclasses.replace(HEAD, panorama=False)
    emb = np.random.default_rng(3).normal(size=(5, 64)).astype(np.float32)
    heading = np.random.default_rng(4).normal(size=(5, 2)) \
        .astype(np.float32)
    jhead = GeocellHead(head)
    params = jhead.init(jax.random.PRNGKey(0), jnp.asarray(emb))["params"]
    thead = THead(head)
    thead.load_state_dict({
        f"{name}.{'weight' if leaf == 'kernel' else 'bias'}":
            torch.tensor(np.asarray(v).T if leaf == "kernel"
                         else np.asarray(v))
        for name, layer in params.items() for leaf, v in layer.items()},
        strict=True)
    for h in (None, heading):
        want = jhead.apply({"params": params}, jnp.asarray(emb),
                           heading=None if h is None else jnp.asarray(h))
        with torch.no_grad():
            got = thead(torch.from_numpy(emb),
                        None if h is None else torch.from_numpy(h))
        for name in ("logits", "preds_mt", "preds_climate", "preds_month"):
            # 1e-5: one f32 Dense layer of depth 66.
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def bank_inputs():
    """A numpy prototype bank over 37 cells: 0-3 clusters of 1-9
    members each, some cells empty."""
    rng = np.random.default_rng(21)
    n_bank, d = 150, 16
    bank_emb = rng.normal(size=(n_bank, d)).astype(np.float32)
    bank_lla = np.stack([rng.uniform(-10, 25, n_bank),
                         rng.uniform(36, 60, n_bank)], -1) \
        .astype(np.float32)
    rows, nxt = [], 0
    for cell in range(HEAD.num_cells):
        for _ in range(rng.integers(0, 4)):
            idx = [int(i) % n_bank
                   for i in range(nxt, nxt + int(rng.integers(1, 10)))]
            nxt += len(idx)
            rows.append({"geocell_idx": cell,
                         "lng": float(bank_lla[idx, 0].mean()),
                         "lat": float(bank_lla[idx, 1].mean()),
                         "count": len(idx), "indices": idx})
    # Queries near random bank rows, so some candidates' clusters pull
    # the guess away from the first candidate.
    b = 24
    near = bank_emb[rng.integers(0, n_bank, b)]
    emb = (near[:, None] + rng.normal(0, 0.5, (b, 4, d))).astype(np.float32)
    probs = rng.dirichlet(np.ones(HEAD.num_cells) * 3.0, size=b)
    cand = np.argsort(-probs, axis=1)[:, :8].astype(np.int32)
    cand_p = np.take_along_axis(probs, cand, 1).astype(np.float32)
    initial = CELLS[cand[:, 0]]
    return rows, bank_emb, bank_lla, (emb, initial, cand, cand_p)


@pytest.mark.parametrize("preset", ["geoguessr", "yfcc4k"])
@pytest.mark.parametrize("hedge", [False, True])
def test_refiner_matches_jax(bank_inputs, hedge, preset):
    """The serving preset (topk 5, 1000 km gate, T=1.6) and a planet-scale
    one (topk 40 > the 8 candidates given, no gate, T=0.6)."""
    from pigeon_tpu.models.refiner import build_proto_bank, make_refine_fn
    from pigeon_tpu_torch.models import refiner as trefiner
    from pigeon_tpu_torch.train.evaluate import refiner_preset

    rows, bank_emb, bank_lla, queries = bank_inputs
    cfg = dataclasses.replace(refiner_preset(preset), hedge=hedge)
    bank = build_proto_bank(rows, bank_emb, bank_lla, HEAD.num_cells,
                            max_protos=2, max_members=6)
    want = make_refine_fn(bank, cfg)(*map(jnp.asarray, queries))
    tbank = trefiner.build_proto_bank(rows, bank_emb, bank_lla,
                                      HEAD.num_cells, max_protos=2,
                                      max_members=6)
    got = trefiner.make_refine_fn(tbank, cfg)(
        *(torch.from_numpy(np.asarray(q)) for q in queries))
    for key in ("pred_cell", "refine_index", "changed"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    # 1e-4 degrees: both pick the same bank row; the view mean and the
    # gathers are exact, so any gap is f32 rounding of the coordinates.
    np.testing.assert_allclose(got["pred_lla"].numpy(),
                               np.asarray(want["pred_lla"]), atol=1e-4)


def test_hedge_probs_matches_jax():
    from pigeon_tpu.models.refiner import hedge_probs
    from pigeon_tpu_torch.models.refiner import hedge_probs as thedge

    rng = np.random.default_rng(8)
    locs = np.stack([rng.uniform(-170, 170, (6, 5)),
                     rng.uniform(-60, 70, (6, 5))], -1).astype(np.float32)
    probs = rng.dirichlet(np.ones(5), size=6).astype(np.float32)
    want = hedge_probs(jnp.asarray(locs), jnp.asarray(probs), 5.0)
    got = thedge(torch.from_numpy(locs), torch.from_numpy(probs), 5.0)
    # 1e-6: f32 haversine means and a softmax over 5 entries.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_haversine_matches_jax():
    from pigeon_tpu.core.geodesy import haversine_matrix
    from pigeon_tpu_torch.core.geodesy import haversine, haversine_matrix \
        as thm

    rng = np.random.default_rng(9)
    x = np.stack([rng.uniform(-180, 180, 7), rng.uniform(-90, 90, 7)], -1)
    y = np.stack([rng.uniform(-180, 180, 4), rng.uniform(-90, 90, 4)], -1)
    x, y = x.astype(np.float32), y.astype(np.float32)
    want = np.asarray(haversine_matrix(jnp.asarray(x), jnp.asarray(y)))
    got = thm(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    # 0.05 km in f32 over distances up to 20,000 km (2.5e-6 relative).
    np.testing.assert_allclose(got, want, atol=0.05)
    # The repo's anchor: Paris-London on the equatorial radius.
    paris_london = haversine(torch.tensor([2.3522, 48.8566]),
                             torch.tensor([-0.1276, 51.5072]))
    assert abs(float(paris_london) - 343.9) < 0.1


def test_small_pieces_match_jax():
    from pigeon_tpu.data.image_ops import normalize_images
    from pigeon_tpu.models.embedder import token_mean_embedding
    from pigeon_tpu.models.geocell_head import sinusoidal_positions
    from pigeon_tpu.models.refiner import parse_indices
    from pigeon_tpu.train.evaluate import REFINER_PRESETS
    from pigeon_tpu_torch.data.image_ops import normalize_images as tnorm
    from pigeon_tpu_torch.models import embedder, geocell_head, refiner
    from pigeon_tpu_torch.train.evaluate import REFINER_PRESETS as TPRESETS

    # The port has its own RefinerConfig class: compare field by field.
    assert {k: dataclasses.asdict(v) for k, v in TPRESETS.items()} == {
        k: dataclasses.asdict(v) for k, v in REFINER_PRESETS.items()}
    np.testing.assert_array_equal(geocell_head.sinusoidal_positions(4, 18),
                                  sinusoidal_positions(4, 18))
    for idx in ([3, 1], "[4, 5]", None, float("nan"), "not json"):
        assert refiner.parse_indices(idx) == parse_indices(idx)
    u8 = np.random.default_rng(0).integers(0, 256, (2, 5, 5, 3),
                                           dtype=np.uint8)
    np.testing.assert_array_equal(tnorm(torch.from_numpy(u8)).numpy(),
                                  np.asarray(normalize_images(u8)))
    hidden = np.random.default_rng(1).normal(size=(2, 9, 4)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        embedder.token_mean_embedding(torch.from_numpy(hidden)).numpy(),
        np.asarray(token_mean_embedding(jnp.asarray(hidden))), atol=1e-7)
