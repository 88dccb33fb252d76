"""Zero-shot geocell classification of the PyTorch port against the JAX
package, on the CPU: the tokenizers (`data/tokenizer.py`) on a tiny BPE
vocabulary written here, the prompts, the classifier
(`models/zeroshot.py`), the full HF CLIP import (`models/hf_import.py`)
and ``evaluate --zeroshot``."""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pigeon_tpu.config import TextConfig, VisionConfig
from pigeon_tpu_torch.cli import run as cli
from pigeon_tpu_torch.data import tokenizer as ttok
from pigeon_tpu_torch.models.jax_bridge import clip_state_dict_from_jax
from tests.test_torch_evaluate import REGISTRY
from tests.test_torch_serve import write_cells

VISION = VisionConfig(image_size=64, patch_size=16, hidden_size=64,
                      intermediate_size=128, num_layers=2, num_heads=4,
                      projection_dim=32)
TEXT = TextConfig(vocab_size=1024, hidden_size=64, intermediate_size=128,
                  num_layers=2, num_heads=4, max_position_embeddings=32,
                  projection_dim=32)
TEXTS = ["hello world", "Hello, WORLD!! hello", "Zürich in São Paulo",
         "zürich ãã 12 km/h", "A photo located in Bayern, Germany.",
         "it's we'll they've   tabs\tand\nnewlines", "&amp; html &lt;b&gt;",
         "", "hello " * 40, "数字 ٣ 𝔘 emoji 🙂 x²"]


@pytest.fixture(scope="module")
def tiny_bpe(tmp_path_factory):
    """A minimal BPE vocabulary: every byte symbol alone and word-final,
    a few merges (ASCII and across a multibyte character), CLIP's
    special tokens."""
    d = tmp_path_factory.mktemp("vocab")
    bu = ttok._bytes_to_unicode()
    chars = list(bu.values())
    vocab = {}
    for c in chars:
        vocab[c] = len(vocab)
    for c in chars:
        vocab[c + "</w>"] = len(vocab)
    u_uml = [bu[b] for b in "ü".encode()]
    a_til = [bu[b] for b in "ã".encode()]
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o</w>"),
              ("w", "o"), ("r", "l"), ("wo", "rl"), ("worl", "d</w>"),
              (u_uml[0], u_uml[1]), (a_til[0], a_til[1]),
              ("z", "".join(u_uml))]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    return str(d)


@pytest.mark.parametrize("pattern", ["regex", "re"])
@pytest.mark.parametrize("context_len", [8, 77])
def test_clip_tokenizer_ids_equal_the_jax_packages(tiny_bpe, monkeypatch,
                                                   pattern, context_len):
    from pigeon_tpu.data import tokenizer as jtok

    if pattern == "re":
        # Where the `regex` module is missing, both fall back to `re`.
        monkeypatch.setattr(ttok, "_PAT", ttok.FALLBACK_PATTERN)
        monkeypatch.setattr(jtok, "_PAT", jtok.re.compile(
            ttok.FALLBACK_PATTERN.pattern, ttok.FALLBACK_PATTERN.flags))
    else:
        assert ttok._PAT.pattern == jtok._PAT.pattern
    got = ttok.ClipTokenizer.from_dir(tiny_bpe, context_len=context_len)
    want = jtok.ClipTokenizer.from_dir(tiny_bpe, context_len=context_len)
    assert (got.bos_id, got.eos_id, got.vocab_size) == \
        (want.bos_id, want.eos_id, want.vocab_size)
    for text in TEXTS:
        assert got.encode_text(text) == want.encode_text(text), text
    np.testing.assert_array_equal(got(TEXTS), want(TEXTS))
    assert got(TEXTS).dtype == np.int32
    assert [got.decoder[i] for i in got.encode_text("hello world")] == \
        ["hello</w>", "world</w>"]


def test_fallback_pattern_splits_otherwise_than_regex():
    text = "x² ٣"
    assert ttok.FALLBACK_PATTERN.findall(text) != ttok._PAT.findall(text)


@pytest.mark.parametrize("vocab, context_len", [(1024, 77), (49408, 16),
                                                (300, 5)])
def test_hash_tokenizer_ids_equal_the_jax_packages(vocab, context_len):
    from pigeon_tpu.data.tokenizer import HashTokenizer

    got = ttok.HashTokenizer(vocab, context_len)
    want = HashTokenizer(vocab, context_len)
    np.testing.assert_array_equal(got(TEXTS), want(TEXTS))
    assert (got.bos_id, got.eos_id) == (vocab - 2, vocab - 1)


def test_load_tokenizer_falls_back_as_the_jax_packages(tiny_bpe, tmp_path):
    from pigeon_tpu.data.tokenizer import load_tokenizer

    for path in (tiny_bpe, str(tmp_path)):
        got = ttok.load_tokenizer(path, context_len=12,
                                  fallback_vocab_size=512)
        want = load_tokenizer(path, context_len=12, fallback_vocab_size=512)
        assert type(got).__name__ == type(want).__name__
        np.testing.assert_array_equal(got(TEXTS), want(TEXTS))


def geocell_records():
    nan = float("nan")
    return [{"lat": 48.1, "lng": 11.6, "admin_1": "Bayern",
             "country": "Germany"},
            {"lat": -23.5, "lng": -46.6, "admin_1": nan, "country": "Brazil"},
            {"lat": 35.0, "lng": 139.0, "admin_1": "", "country": "Japan"},
            {"lat": 10.04, "lng": -70.0, "country": nan},
            {"lat": -1.26, "lng": 36.8, "admin_1": "None", "country": "none"},
            {"lat": 0.05, "lng": 0.0}]


def test_geocell_prompts_equal_the_jax_packages():
    from pigeon_tpu.models.zeroshot import geocell_prompts as jprompts
    from pigeon_tpu_torch.models.zeroshot import geocell_prompts

    records = geocell_records()
    assert geocell_prompts(records) == jprompts(records)
    assert geocell_prompts(records, "Somewhere in {place}") == \
        jprompts(records, "Somewhere in {place}")
    assert geocell_prompts(records)[0] == \
        "A photo located in Bayern, Germany."


@pytest.fixture(scope="module")
def clip_pair():
    from pigeon_tpu.models.clip import CLIPModel
    from pigeon_tpu_torch.models.clip import CLIPModel as TCLIPModel

    model = CLIPModel(VISION, TEXT, eos_token_id=TEXT.vocab_size - 1)
    params = jax.jit(model.init)(jax.random.PRNGKey(2),
                                 jnp.zeros((1, 64, 64, 3)),
                                 jnp.zeros((1, 16), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    port = TCLIPModel(VISION, TEXT, eos_token_id=TEXT.vocab_size - 1,
                      attn_impl="fused")
    port.load_state_dict(clip_state_dict_from_jax(params), strict=True)
    return model, params, port


def test_zero_shot_classifier_matches_jax(clip_pair):
    from pigeon_tpu.models.zeroshot import embed_prompts as jembed
    from pigeon_tpu.models.zeroshot import make_zero_shot_classifier as jcls
    from pigeon_tpu_torch.models.zeroshot import (
        embed_prompts,
        geocell_prompts,
        make_zero_shot_classifier,
    )

    model, params, port = clip_pair
    ids = ttok.HashTokenizer(TEXT.vocab_size, 16)(
        geocell_prompts(geocell_records()))
    want_text = jembed(model, params, ids)
    got_text = embed_prompts(port, ids)
    np.testing.assert_allclose(got_text.numpy(), np.asarray(want_text),
                               atol=1e-4)
    px = np.random.default_rng(3).normal(size=(5, 64, 64, 3)) \
        .astype(np.float32)
    want_probs, want_logits = jcls(model, params, want_text)(jnp.asarray(px))
    probs, logits = make_zero_shot_classifier(port, got_text)(
        torch.from_numpy(px))
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_probs),
                               atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-3)
    np.testing.assert_array_equal(probs.argmax(-1).numpy(),
                                  np.asarray(want_probs).argmax(-1))


def hf_clip_state(seed=4):
    """A full HF `CLIPModel` state dict of the tiny towers (seeded)."""
    gen = torch.Generator().manual_seed(seed)

    def t(*shape):
        return torch.randn(*shape, generator=gen) * 0.05

    d, p = VISION.hidden_size, VISION.patch_size
    state = {"logit_scale": torch.tensor(2.3),
             "visual_projection.weight": t(VISION.projection_dim, d),
             "text_projection.weight": t(TEXT.projection_dim,
                                         TEXT.hidden_size),
             "vision_model.embeddings.patch_embedding.weight": t(d, 3, p, p),
             "vision_model.embeddings.class_embedding": t(d),
             "vision_model.embeddings.position_embedding.weight":
                 t(VISION.seq_len, d),
             "vision_model.embeddings.position_ids":
                 torch.arange(VISION.seq_len)[None],
             "text_model.embeddings.token_embedding.weight":
                 t(TEXT.vocab_size, TEXT.hidden_size),
             "text_model.embeddings.position_embedding.weight":
                 t(TEXT.max_position_embeddings, TEXT.hidden_size)}
    for tower, norms in (("vision_model", ("pre_layrnorm",
                                           "post_layernorm")),
                         ("text_model", ("final_layer_norm",))):
        for norm in norms:
            state[f"{tower}.{norm}.weight"] = 1 + t(d)
            state[f"{tower}.{norm}.bias"] = t(d)
        for i in range(2):
            pre = f"{tower}.encoder.layers.{i}."
            for name, shape in (("layer_norm1", (d,)), ("layer_norm2", (d,)),
                                ("self_attn.q_proj", (d, d)),
                                ("self_attn.k_proj", (d, d)),
                                ("self_attn.v_proj", (d, d)),
                                ("self_attn.out_proj", (d, d)),
                                ("mlp.fc1", (128, d)), ("mlp.fc2", (d, 128))):
                state[pre + name + ".weight"] = (1 + t(*shape)
                                                 if "norm" in name
                                                 else t(*shape))
                state[pre + name + ".bias"] = t(shape[0])
    return state


def test_full_hf_clip_import_matches_jax(clip_pair):
    from pigeon_tpu.models.hf_import import import_clip_params, merge_params
    from pigeon_tpu_torch.models.clip import CLIPModel
    from pigeon_tpu_torch.models.hf_import import clip_state, merge_state

    model, params, _ = clip_pair
    state = hf_clip_state()
    want_params = merge_params(params, import_clip_params(state, 2, 2))
    want_state = clip_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, want_params))
    loaded = clip_state(state, 2, 2)
    assert set(loaded) == set(want_state)
    for name, value in loaded.items():
        assert torch.equal(value, want_state[name]), name
    port = CLIPModel(VISION, TEXT, eos_token_id=TEXT.vocab_size - 1,
                     attn_impl="plain")
    assert merge_state(port, loaded) == []
    px = np.random.default_rng(9).normal(size=(3, 64, 64, 3)) \
        .astype(np.float32)
    ids = ttok.HashTokenizer(TEXT.vocab_size, 16)(TEXTS[:3])
    want = model.apply({"params": want_params}, jnp.asarray(px),
                       jnp.asarray(ids))
    with torch.no_grad():
        got = port(torch.from_numpy(px), torch.from_numpy(ids).long())
    for key in ("image_embeds", "text_embeds", "logits_per_image"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, err_msg=key)


def test_hf_clip_state_is_the_inverse_of_the_import():
    from pigeon_tpu_torch.models.clip import CLIPModel
    from pigeon_tpu_torch.models.hf_import import clip_hf_state, clip_state
    from pigeon_tpu_torch.models.super_guessr import init_weights

    model = init_weights(CLIPModel(VISION, TEXT), 3)
    hf = clip_hf_state(model)
    assert set(hf) == set(hf_clip_state()) - {
        "vision_model.embeddings.position_ids"}
    back = clip_state(hf, 2, 2)
    assert set(back) == set(model.state_dict())
    for name, value in model.state_dict().items():
        assert torch.equal(back[name], value), name


def evaluate_argv(tmp_path, *extra):
    return ["evaluate", "zs", "--tiny", "--zeroshot", "--geocells",
            str(tmp_path / "cells.csv"), "-l", "sample20", "--benchmarks",
            REGISTRY, "--batch-size", "8", *extra]


def test_evaluate_zeroshot_writes_the_jax_suites_keys(tmp_path, monkeypatch):
    """``evaluate --zeroshot -b`` through both CLIs on the same HF CLIP
    file: the port's JSON has the JAX suite's benchmarks and metric keys,
    all finite."""
    from pigeon_tpu.cli import run as jax_cli

    write_cells(tmp_path, 6)
    torch.save(hf_clip_state(), tmp_path / "clip.pt")
    monkeypatch.chdir(tmp_path)
    outputs = {}
    for name, main, device in (("port", cli.main, ["--device", "cpu"]),
                               ("jax", jax_cli.main, [])):
        out = tmp_path / f"{name}.json"
        assert main(evaluate_argv(tmp_path, "-b", str(tmp_path / "clip.pt"),
                                  "--output", str(out), *device)) == 0
        outputs[name] = json.loads(out.read_text())
    assert list(outputs["port"]) == list(outputs["jax"]) == ["sample20"]
    got, want = outputs["port"]["sample20"], outputs["jax"]["sample20"]
    assert sorted(got) == sorted(want)
    assert all(np.isfinite(v) for v in got.values())


@pytest.mark.parametrize("argv, match", [
    (["--quant"], "exclusive"), (["--device", "cuda"], "no CUDA device")])
def test_evaluate_zeroshot_stops(tmp_path, monkeypatch, argv, match):
    write_cells(tmp_path, 6)
    if match == "no CUDA device":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    else:
        argv = [*argv, "--device", "cpu"]
    with pytest.raises(SystemExit, match=match):
        cli.main(evaluate_argv(tmp_path, *argv))


def test_an_eos_outside_the_text_vocab_stops(tmp_path, tiny_bpe,
                                             monkeypatch):
    """A CLIP vocabulary whose EOS id (2000) lies past the text config's
    vocabulary (the tiny config's 1024) stops ``evaluate --zeroshot``."""
    import os
    import shutil

    vocab = json.loads(open(os.path.join(tiny_bpe, "vocab.json")).read())
    eos = vocab.pop("<|endoftext|>")
    vocab["<|endoftext|>"] = 2000
    assert eos < 2000
    target = tmp_path / "data" / "clip_vocab"
    target.mkdir(parents=True)
    (target / "vocab.json").write_text(json.dumps(vocab))
    shutil.copy(os.path.join(tiny_bpe, "merges.txt"), target)
    write_cells(tmp_path, 6)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="eos id 2000 exceeds"):
        cli.main(evaluate_argv(tmp_path, "--device", "cpu"))
