"""The attention route of the port's CLI: `cli.run.attn_impl` and
`quant_attn_impl` read ``PIGEON_ATTN_IMPL`` and ``PIGEON_QUANT_ATTN_IMPL``
in the JAX package's names and agree with its resolvers (as they resolve
on a TPU); unknown names, and unknown ``PIGEON_FLASH_FWD`` values, stop
the command; ``serve`` and ``finetune`` on the CPU build and run on the
route the variable names."""

import dataclasses
import math

import numpy as np
import pytest

from pigeon_tpu_torch.cli import run as cli
from tests.test_torch_serve import (
    panorama,
    post,
    serve_args,
    write_cells,
)
from tests.test_torch_train import finetune_argv, write_world

JAX_NAMES = ("flash_fused", "flash", "xla", "flash_fused_ln",
             "flash_fused_mlp", "flash_fused_block")
#: The JAX model's int8 precedence (`pigeon_tpu/models/clip.py`): the LN
#: and MLP fusions have no int8 kernel and run as the fused route.
INT8_ROUTE = {"fused_ln": "fused", "fused_mlp": "fused"}


@pytest.fixture
def env(monkeypatch):
    for name in ("PIGEON_ATTN_IMPL", "PIGEON_QUANT_ATTN_IMPL",
                 "PIGEON_FLASH_FWD", "PIGEON_REMAT"):
        monkeypatch.delenv(name, raising=False)

    def setenv(**values):
        for name, value in values.items():
            monkeypatch.setenv(name, value)

    return setenv


@pytest.fixture
def jax_cli(monkeypatch):
    """The JAX package's CLI module, resolving as it does on a TPU."""
    import jax

    from pigeon_tpu.cli import run

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    return run


@pytest.mark.parametrize("name", [None, *JAX_NAMES])
def test_attn_impl_maps_each_jax_name(env, jax_cli, name):
    if name is not None:
        env(PIGEON_ATTN_IMPL=name)
    want = jax_cli._attn_impl()
    assert want == (name or "flash_fused")
    assert cli.attn_impl() == cli.ATTN_ROUTES[want]


@pytest.mark.parametrize("attn", [None, *JAX_NAMES])
@pytest.mark.parametrize("quant", [None, "flash_fused", "flash",
                                   "flash_fused_ln", "flash_fused_mlp",
                                   "flash_fused_block"])
def test_quant_attn_impl_downgrades_as_the_jax_cli(env, jax_cli, attn,
                                                   quant):
    """Under ``--quant`` every ``flash_fused*`` name of
    ``PIGEON_ATTN_IMPL`` runs K8's fused route and ``flash`` stays
    ``flash``; ``PIGEON_QUANT_ATTN_IMPL`` overrides, and its
    ``flash_fused_block`` is K7's ``block`` route."""
    if attn is not None:
        env(PIGEON_ATTN_IMPL=attn)
    if quant is not None:
        env(PIGEON_QUANT_ATTN_IMPL=quant)
    route = cli.ATTN_ROUTES[jax_cli._quant_attn_impl()]
    assert cli.quant_attn_impl() == INT8_ROUTE.get(route, route)
    assert cli.quant_attn_impl() in ("fused", "flash", "plain", "block")
    assert (cli.quant_attn_impl() == "block") == (
        quant == "flash_fused_block")


@pytest.mark.parametrize("variable, name, resolver, match", [
    ("PIGEON_ATTN_IMPL", "flash_fused_block", "attn_impl", "K6"),
    ("PIGEON_QUANT_ATTN_IMPL", "flash_fused_block", "quant_attn_impl",
     "K7"),
    ("PIGEON_ATTN_IMPL", "flash_fused_bogus", "attn_impl", "not one of"),
    ("PIGEON_ATTN_IMPL", "flash_fused_bogus", "quant_attn_impl",
     "not one of"),
    ("PIGEON_QUANT_ATTN_IMPL", "fused", "quant_attn_impl", "not one of"),
    ("PIGEON_ATTN_IMPL", "plain", "attn_impl", "not one of"),
])
def test_unported_and_unknown_routes_are_refused(env, variable, name,
                                                 resolver, match):
    """No silent fallback: a name the JAX package does not know (the
    port's own route names included) stops the command. Every JAX route
    is ported now, so ``flash_fused_block`` resolves: to K6's ``block``
    route, and under ``--quant`` to K7's (the cases tagged K6 and K7,
    which named the missing kernel while it was)."""
    env(**{variable: name})
    if name == "flash_fused_block":
        assert getattr(cli, resolver)() == "block", match
        return
    with pytest.raises(SystemExit, match=match) as info:
        getattr(cli, resolver)()
    assert variable in str(info.value)


def count_calls(monkeypatch, targets) -> list:
    """Record the name of each call of the (module, function name) pairs
    ``targets`` in the returned list."""
    calls = []
    for module, name in targets:
        fn = getattr(module, name)
        monkeypatch.setattr(
            module, name,
            lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a))
    return calls


def test_serve_refuses_an_unported_route(env, tmp_path, monkeypatch):
    """``serve --tiny --device cpu`` under
    ``PIGEON_ATTN_IMPL=flash_fused_block``, refused while K6 was not
    ported, builds every layer on the ``block`` route and answers over
    HTTP, each request running K6 and K9 once a layer (their plain
    versions here) and K1 never; what ``serve`` still refuses is a name it
    does not know."""
    from pigeon_tpu_torch.kernels import fused_block_attention as k6
    from pigeon_tpu_torch.kernels import fused_mlp as k9
    from pigeon_tpu_torch.kernels import fused_qkv_attention as k1
    from pigeon_tpu_torch.models.clip import routes_of

    calls = count_calls(monkeypatch, (
        (k6, "fused_block_attention_reference"),
        (k9, "fused_ln_mlp_reference"),
        (k1, "fused_qkv_attention")))
    cells = write_cells(tmp_path)
    env(PIGEON_ATTN_IMPL="flash_fused_block")
    httpd = cli.start_server(serve_args(tmp_path, "--panorama", "-m",
                                        "--heading"), block=False)
    try:
        model = httpd.RequestHandlerClass.service.serve_fn.model
        assert routes_of(model) == {"block"}
        calls.clear()
        status, body = post(
            f"http://127.0.0.1:{httpd.server_address[1]}/api/v1/predict",
            panorama(4))
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert status == 200
    assert sorted(calls) == sorted(
        ["fused_block_attention_reference", "fused_ln_mlp_reference"]
        * len(model.vision.encoder.layers))
    lat, lng = body["results"]["lat"], body["results"]["lng"]
    assert np.isclose(cells, [lng, lat], atol=1e-4).all(-1).any()
    env(PIGEON_ATTN_IMPL="flash_fused_blocks")
    with pytest.raises(SystemExit, match="not one of"):
        cli.start_server(serve_args(tmp_path), block=False)


def test_serve_quant_answers_on_the_block_route(env, tmp_path, monkeypatch):
    """``serve --quant --tiny --device cpu`` under
    ``PIGEON_QUANT_ATTN_IMPL=flash_fused_block``: the calibration forward
    projects separately through K3 and fills out_proj's activation scale,
    then every forward runs K7 once a layer (plain versions here), K3 and
    K8 never."""
    from pigeon_tpu_torch.kernels import attention
    from pigeon_tpu_torch.kernels import fused_block_attention_int8 as k7
    from pigeon_tpu_torch.kernels import fused_qkv_attention_int8 as k8
    from pigeon_tpu_torch.models.clip import routes_of
    from pigeon_tpu_torch.models.quant import QuantLinear

    calls = count_calls(monkeypatch, (
        (attention, "flash_attention_reference"),
        (k8, "fused_qkv_attention_int8_reference"),
        (k7, "fused_block_attention_int8_reference")))
    cells = write_cells(tmp_path)
    env(PIGEON_QUANT_ATTN_IMPL="flash_fused_block")
    httpd = cli.start_server(serve_args(tmp_path, "--panorama", "-m",
                                        "--heading", "--quant"), block=False)
    try:
        model = httpd.RequestHandlerClass.service.serve_fn.model
        layers = len(model.vision.encoder.layers)
        # Start-up: the calibration forward, then the warm-up request.
        assert calls == (["flash_attention_reference"] * layers
                         + ["fused_block_attention_int8_reference"] * layers)
        assert routes_of(model) == {"block"}
        assert {m.mode for m in model.modules()
                if isinstance(m, QuantLinear)} == {"static"}
        assert all(float(layer.attn.out_proj.act_scale) != 1.0
                   for layer in model.vision.encoder.layers)
        calls.clear()
        status, body = post(
            f"http://127.0.0.1:{httpd.server_address[1]}/api/v1/predict",
            panorama(4))
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert status == 200
    assert calls == ["fused_block_attention_int8_reference"] * layers
    lat, lng = body["results"]["lat"], body["results"]["lng"]
    assert np.isclose(cells, [lng, lat], atol=1e-4).all(-1).any()


@pytest.mark.parametrize("command", ["serve", "finetune"])
def test_an_unknown_flash_fwd_stops_the_command(env, tmp_path, command):
    """``PIGEON_FLASH_FWD`` takes ``monolithic`` or ``online``; another
    value stops ``serve`` and ``finetune`` before a model is built (the
    JAX package would take it as ``monolithic``)."""
    write_world(tmp_path)
    env(PIGEON_FLASH_FWD="onlin")
    with pytest.raises(SystemExit, match="PIGEON_FLASH_FWD"):
        if command == "serve":
            cli.start_server(serve_args(tmp_path), block=False)
        else:
            cli.main(finetune_argv(tmp_path, "--epochs", "1"))


def test_serve_answers_on_the_fused_mlp_route(env, tmp_path):
    """``serve --tiny --device cpu`` under
    ``PIGEON_ATTN_IMPL=flash_fused_mlp`` builds every layer on the port's
    ``fused_mlp`` route and answers over HTTP."""
    from pigeon_tpu_torch.models.clip import routes_of

    cells = write_cells(tmp_path)
    env(PIGEON_ATTN_IMPL="flash_fused_mlp")
    httpd = cli.start_server(serve_args(tmp_path, "--panorama", "-m",
                                        "--heading"), block=False)
    try:
        model = httpd.RequestHandlerClass.service.serve_fn.model
        assert routes_of(model) == {"fused_mlp"}
        status, body = post(
            f"http://127.0.0.1:{httpd.server_address[1]}/api/v1/predict",
            panorama(4))
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert status == 200
    lat, lng = body["results"]["lat"], body["results"]["lng"]
    assert np.isclose(cells, [lng, lat], atol=1e-4).all(-1).any()


def test_serve_quant_answers_on_the_flash_route(env, tmp_path, monkeypatch):
    """``serve --quant --tiny --device cpu`` under
    ``PIGEON_ATTN_IMPL=flash`` builds static int8 projections on the
    ``flash`` route and answers over HTTP; each request runs K3 once a
    layer (its plain version here) and K8 never."""
    from pigeon_tpu_torch.kernels import attention
    from pigeon_tpu_torch.kernels import fused_qkv_attention_int8 as k8
    from pigeon_tpu_torch.models.clip import routes_of
    from pigeon_tpu_torch.models.quant import QuantLinear

    calls = []
    for module, name in ((attention, "flash_attention_reference"),
                         (k8, "fused_qkv_attention_int8_reference")):
        fn = getattr(module, name)
        monkeypatch.setattr(
            module, name,
            lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a))
    cells = write_cells(tmp_path)
    env(PIGEON_ATTN_IMPL="flash")
    httpd = cli.start_server(serve_args(tmp_path, "--panorama", "-m",
                                        "--heading", "--quant"), block=False)
    try:
        model = httpd.RequestHandlerClass.service.serve_fn.model
        assert routes_of(model) == {"flash"}
        assert {m.mode for m in model.modules()
                if isinstance(m, QuantLinear)} == {"static"}
        calls.clear()
        status, body = post(
            f"http://127.0.0.1:{httpd.server_address[1]}/api/v1/predict",
            panorama(4))
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert status == 200
    assert calls == ["flash_attention_reference"] * len(
        model.vision.encoder.layers)
    lat, lng = body["results"]["lat"], body["results"]["lng"]
    assert np.isclose(cells, [lng, lat], atol=1e-4).all(-1).any()


def test_finetune_trains_on_the_flash_route(env, tmp_path, monkeypatch):
    """``finetune --tiny --device cpu`` under ``PIGEON_ATTN_IMPL=flash``:
    K3 forward and K4 backward (their plain versions here) train an epoch
    with finite losses and a checkpoint."""
    import json

    from pigeon_tpu_torch.kernels import attention
    from pigeon_tpu_torch.train.checkpoints import latest_step

    calls = []
    backward = attention.flash_attention_backward_reference
    monkeypatch.setattr(attention, "flash_attention_backward_reference",
                        lambda *a: calls.append(1) or backward(*a))
    write_world(tmp_path)
    monkeypatch.chdir(tmp_path)
    env(PIGEON_ATTN_IMPL="flash")
    assert cli.main(finetune_argv(tmp_path, "--epochs", "1")) == 0
    assert latest_step(str(tmp_path / "saved_models" / "tinyrun")) == 2
    # 2 steps, each back through both layers of the tiny tower.
    assert len(calls) == 2 * 2
    records = [json.loads(line) for line in
               open(tmp_path / "runs" / "tinyrun" / "metrics.jsonl")]
    assert [r["step"] for r in records if r["tag"] == "train/loss"] == [1, 2]
    assert all(math.isfinite(r["value"]) for r in records)


def test_serve_answers_with_the_checkpoint_finetune_wrote(env, tmp_path,
                                                          monkeypatch):
    """``finetune --tiny --device cpu`` writes ``step_N/``; ``serve`` on
    the same run name and ``--checkpoint-dir`` restores it
    (`pigeon_tpu/cli/run.py::_init_and_restore`) and answers with that
    model's embedding: the one of a model with the DCP checkpoint loaded
    by hand,
    not the seeded initialisation's. ``--quant`` restores before it
    quantizes."""
    import torch
    import torch.distributed.checkpoint as dcp

    from pigeon_tpu_torch.models.super_guessr import SuperGuessr, init_weights
    from pigeon_tpu_torch.serve.server import make_serving_fn
    from pigeon_tpu_torch.train.checkpoints import latest_step

    write_world(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert cli.main(finetune_argv(tmp_path, "--epochs", "1")) == 0
    ckpt_dir = tmp_path / "saved_models" / "tinyrun"
    step = latest_step(str(ckpt_dir))
    assert step == 2
    saved = str(ckpt_dir / f"step_{step}")

    argv = ["serve", "tinyrun", "--tiny", "--device", "cpu", "--port", "0",
            "--geocells", str(tmp_path / "cells.csv"), "--checkpoint-dir",
            str(tmp_path / "saved_models"), "--panorama", "-m", "--heading"]
    httpd = cli.start_server(cli.build_parser().parse_args(argv),
                             block=False)
    try:
        serve_fn = httpd.RequestHandlerClass.service.serve_fn
        status, body = post(
            f"http://127.0.0.1:{httpd.server_address[1]}/api/v1/predict",
            panorama(4))
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert status == 200

    args = cli.build_parser().parse_args(argv)
    cfg = cli.make_config(args)
    cfg = cfg.replace(head=dataclasses.replace(cfg.head, num_cells=5))

    def served_by(model):
        return make_serving_fn(model, cfg.head, np.zeros((5, 2), np.float32),
                               "cpu")

    def seeded():
        return init_weights(SuperGuessr(cfg.vision, cfg.head,
                                        dtype=torch.bfloat16),
                            cli.INIT_SEED)

    by_hand = seeded()
    loaded = {f"model.{k}": v for k, v in by_hand.state_dict().items()}
    dcp.load(loaded, checkpoint_id=saved, no_dist=True)
    by_hand.load_state_dict({k[len("model."):]: v
                             for k, v in loaded.items()})
    pixels = np.random.default_rng(0).integers(
        0, 256, (1, 4, 64, 64, 3), dtype=np.uint8)
    got = serve_fn(pixels)["embedding"]
    torch.testing.assert_close(got, served_by(by_hand)(pixels)["embedding"],
                               rtol=0, atol=0)
    seeded_emb = served_by(seeded())(pixels)["embedding"]
    assert (got.float() - seeded_emb.float()).abs().max() > 1e-3

    calls = []
    from pigeon_tpu_torch.models import quant

    real = quant.quantize_and_calibrate
    monkeypatch.setattr(quant, "quantize_and_calibrate",
                        lambda model, *a, **kw: calls.append(
                            model.head.cell_layer.bias.detach().clone())
                        or real(model, *a, **kw))
    httpd = cli.start_server(cli.build_parser().parse_args(argv + ["--quant"]),
                             block=False)
    httpd.shutdown()
    httpd.server_close()
    torch.testing.assert_close(calls[0],
                               by_hand.state_dict()["head.cell_layer.bias"])


def test_serve_refuses_a_checkpoint_of_other_head_flags(env, tmp_path,
                                                        monkeypatch):
    """The restore is strict: serving a panorama/multi-task checkpoint
    without those flags fails loudly, as the JAX restore does."""
    write_world(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert cli.main(finetune_argv(tmp_path, "--epochs", "1")) == 0
    args = cli.build_parser().parse_args([
        "serve", "tinyrun", "--tiny", "--device", "cpu", "--port", "0",
        "--geocells", str(tmp_path / "cells.csv")])
    with pytest.raises(RuntimeError, match="state_dict"):
        cli.start_server(args, block=False)


@pytest.mark.parametrize("value, want", [(None, "attn_kernel"),
                                         ("attn_kernel", "attn_kernel"),
                                         ("none", "none"),
                                         ("full", "full"),
                                         ("attn_out", "attn_out"),
                                         ("attn_slim", "attn_slim")])
def test_finetune_builds_under_the_remat_policy_named(env, tmp_path,
                                                      monkeypatch, value,
                                                      want):
    """``PIGEON_REMAT`` (`pigeon_tpu/cli/run.py::_remat_override`) reaches
    `build_finetune_model`'s ``remat`` and the tower it builds."""
    from pigeon_tpu_torch.train import modes

    seen = []
    real = modes.build_finetune_model
    monkeypatch.setattr(modes, "build_finetune_model",
                        lambda cfg, **kw: seen.append(kw["remat"])
                        or real(cfg, **kw))
    write_world(tmp_path)
    if value is not None:
        env(PIGEON_REMAT=value)
    run = cli.build_finetune(cli.build_parser().parse_args(
        finetune_argv(tmp_path)))
    assert seen == [want]
    assert run.state.model.vision.encoder.remat == want


def test_finetune_trains_without_remat(env, tmp_path, monkeypatch):
    """``PIGEON_REMAT=none`` trains an epoch with finite losses, no layer
    under the checkpointed path."""
    import json

    from pigeon_tpu_torch.models import clip

    def no_checkpoint(*a, **kw):
        raise AssertionError("a layer was checkpointed under remat none")

    monkeypatch.setattr(clip, "checkpoint", no_checkpoint)
    write_world(tmp_path)
    monkeypatch.chdir(tmp_path)
    env(PIGEON_REMAT="none")
    assert cli.main(finetune_argv(tmp_path, "--epochs", "1")) == 0
    records = [json.loads(line) for line in
               open(tmp_path / "runs" / "tinyrun" / "metrics.jsonl")]
    assert [r["step"] for r in records if r["tag"] == "train/loss"] == [1, 2]
    assert all(math.isfinite(r["value"]) for r in records)


@pytest.mark.parametrize("value", ["True", "attn", "attn_kernel_out"])
def test_finetune_stops_on_a_remat_policy_the_port_lacks(env, tmp_path,
                                                         value):
    """A value that names no policy stops ``finetune`` with the policies
    the port has, where the JAX package would fall back to full remat
    silently."""
    write_world(tmp_path)
    env(PIGEON_REMAT=value)
    with pytest.raises(SystemExit, match="PIGEON_REMAT.*attn_kernel"):
        cli.main(finetune_argv(tmp_path, "--epochs", "1"))
