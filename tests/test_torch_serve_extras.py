"""The serving extras of the PyTorch port against the JAX package, on the
CPU: the micro-batcher (`serve/batching.py`, ``serve --serve-batch``),
the serving artifact (`serve/export.py`, ``export`` and ``serve
--artifact``), the comma-separated refinement datasets of
``--landmarks`` and the configs of ``--landmarks`` and ``--model
vit-b32``. The JAX side runs as its own tests run it (``xla`` attention
for the artifact, platforms ``("cpu",)``)."""

import dataclasses
import json
import os
import threading
import zipfile

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pigeon_tpu.config import HeadConfig, VisionConfig
from pigeon_tpu_torch.cli import run as cli
from pigeon_tpu_torch.models.jax_bridge import state_dict_from_jax
from pigeon_tpu_torch.serve import export as texport
from pigeon_tpu_torch.serve.batching import MicroBatcher
from tests.test_torch_serve import panorama, post, serve_args, write_cells

VCFG = VisionConfig(image_size=32, patch_size=8, hidden_size=64,
                    intermediate_size=128, num_layers=2, num_heads=4,
                    projection_dim=32)
HCFG = HeadConfig(num_cells=8, embed_dim=64, panorama=True,
                  multi_task=True, num_candidates=5)
CELLS = np.stack([np.linspace(-150, 150, 8),
                  np.linspace(-50, 60, 8)], -1).astype(np.float32)
RNG = np.random.default_rng(3)


@pytest.fixture(scope="module")
def jax_setup():
    """A JAX `SuperGuessr` (f32, ``xla``) and its parameters."""
    from pigeon_tpu.models.super_guessr import SuperGuessr

    model = SuperGuessr(VCFG, HCFG)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 4, 32, 32, 3)))["params"]
    return model, jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def port_model(params, route="plain"):
    """The port's f32 `SuperGuessr` on ``route`` with the bridged
    ``params``."""
    from pigeon_tpu_torch.models.super_guessr import SuperGuessr

    model = SuperGuessr(VCFG, HCFG, attn_impl=route)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


def pixels(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 4, 32, 32, 3)).astype(np.uint8)


# ---------------------------------------------------------------------------
# MicroBatcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_batch, buckets", [
    (8, None), (1, None), (5, None), (32, None), (8, (2, 4)),
    (4, (8, 2, 2, 1)), (16, (3, 6, 12))])
def test_bucket_ladder_and_clamp_equal_jax(max_batch, buckets):
    from pigeon_tpu.serve.batching import MicroBatcher as JaxBatcher

    got = MicroBatcher(lambda x: x, max_batch=max_batch, buckets=buckets)
    want = JaxBatcher(lambda x: x, max_batch=max_batch, buckets=buckets)
    try:
        assert got.buckets == want.buckets
        assert got.max_batch == want.max_batch
        assert got.max_wait == want.max_wait
    finally:
        got.close()
        want.close()


def submit_together(batcher, samples):
    """Submit every sample from its own thread at once; the futures."""
    futures = [None] * len(samples)
    barrier = threading.Barrier(len(samples))

    def go(i):
        barrier.wait()
        futures[i] = batcher.submit(samples[i])

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(samples))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return futures


@pytest.fixture
def one_thread():
    """torch on one CPU thread: a multi-threaded GEMM may split a small
    batch's sums otherwise than a large one's."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_concurrent_rows_equal_alone_and_the_jax_batchers(jax_setup,
                                                          one_thread):
    """Five concurrent panoramas coalesce (with a wide wait) into one
    padded bucket of 8; each row equals its panorama served alone within
    1e-5 and the JAX `MicroBatcher`'s row within 1e-4 (f32)."""
    from pigeon_tpu.serve.batching import MicroBatcher as JaxBatcher
    from pigeon_tpu.serve.server import make_serving_fn as jax_serving
    from pigeon_tpu_torch.serve.server import make_serving_fn

    jmodel, params = jax_setup
    serve_fn = make_serving_fn(port_model(params, "fused"), HCFG, CELLS,
                               "cpu")
    samples = list(pixels(5, seed=1))
    batcher = MicroBatcher(serve_fn, max_batch=8, max_wait_ms=500.0)
    jbatcher = JaxBatcher(jax_serving(jmodel, params, HCFG, CELLS),
                          max_batch=8, max_wait_ms=500.0)
    try:
        got = [f.result(60) for f in submit_together(batcher, samples)]
        want = [f.result(60) for f in submit_together(jbatcher, samples)]
        assert batcher.batches_run == 1 and batcher.requests_served == 5
        assert batcher.fills == [(5, 8)]
    finally:
        batcher.close()
        jbatcher.close()
    for sample, row, jrow in zip(samples, got, want):
        alone = serve_fn(sample[None])
        for key in ("pred_lla", "topk_probs", "embedding"):
            np.testing.assert_allclose(row[key], alone[key][0].numpy(),
                                       atol=1e-5, err_msg=key)
            np.testing.assert_allclose(row[key], np.asarray(jrow[key]),
                                       atol=1e-4, err_msg=key)
        np.testing.assert_array_equal(row["topk_cells"],
                                      alone["topk_cells"][0].numpy())


def test_a_failing_forward_fails_every_future_of_its_batch():
    calls = []

    def serve_fn(x):
        calls.append(x.shape[0])
        raise RuntimeError("forward failed")

    batcher = MicroBatcher(serve_fn, max_batch=4, max_wait_ms=500.0)
    try:
        futures = submit_together(batcher, list(pixels(3)))
        for fut in futures:
            with pytest.raises(RuntimeError, match="forward failed"):
                fut.result(30)
        assert calls == [4]                 # one batch, at bucket 4
        assert batcher.batches_run == 0 and batcher.requests_served == 0
    finally:
        batcher.close()


def test_warm_runs_every_bucket_with_the_refiner():
    shapes, refined = [], []

    def serve_fn(x):
        shapes.append(tuple(x.shape))
        b = x.shape[0]
        return {"pred_lla": torch.zeros(b, 2), "embedding": torch.zeros(b, 4),
                "topk_cells": torch.zeros(b, 2, dtype=torch.long),
                "topk_probs": torch.zeros(b, 2)}

    batcher = MicroBatcher(serve_fn, max_batch=8,
                           refine_fn=lambda e, *_: refined.append(len(e)))
    try:
        batcher.warm((4, 32, 32, 3))
    finally:
        batcher.close()
    assert shapes == [(b, 4, 32, 32, 3) for b in (1, 2, 4, 8)]
    assert refined == [1, 2, 4, 8]


def test_serve_batch_answers_concurrent_http_requests(tmp_path):
    cells = write_cells(tmp_path)
    httpd = cli.start_server(serve_args(tmp_path, "--panorama", "-m",
                                        "--heading", "--serve-batch", "4"),
                             block=False)
    service = httpd.RequestHandlerClass.service
    url = f"http://127.0.0.1:{httpd.server_address[1]}/api/v1/predict"
    replies = [None] * 6

    def ask(i):
        replies[i] = post(url, {"gameID": "g", "roundID": i,
                                **panorama(2 * i)})

    try:
        assert service.batcher is not None
        assert service.batcher.buckets == (1, 2, 4)
        assert httpd.request_queue_size >= 64     # concurrent connects
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        served = service.batcher.requests_served
        runs = service.batcher.batches_run
    finally:
        service.batcher.close()
        httpd.shutdown()
        httpd.server_close()
    assert served == 6 and 1 <= runs <= 6
    for i, (status, body) in enumerate(replies):
        assert status == 200 and body["roundID"] == i
        lat, lng = body["results"]["lat"], body["results"]["lng"]
        assert np.isclose(cells, [lng, lat], atol=1e-4).all(-1).any()


# ---------------------------------------------------------------------------
# Serving artifacts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def float_artifact(jax_setup, tmp_path_factory):
    """The port's artifact of the bridged f32 model, symbolic batch."""
    _, params = jax_setup
    out = str(tmp_path_factory.mktemp("art") / "float")
    manifest = texport.export_serving_artifact(
        port_model(params), HCFG, CELLS, out, image_size=32, panorama=True,
        platforms=("cpu",))
    return out, manifest


def test_symbolic_batch_round_trip(jax_setup, float_artifact):
    from pigeon_tpu_torch.serve.server import make_serving_fn

    _, params = jax_setup
    out, manifest = float_artifact
    assert manifest["batch"] == "symbolic"
    assert manifest["artifact_version"] == 1
    assert manifest["torch_version"] == torch.__version__
    assert sorted(os.listdir(out)) == sorted(
        [texport.MODULE_FILE, texport.PARAMS_FILE, texport.GEOCELLS_FILE,
         texport.MANIFEST_FILE])
    serve_fn, loaded = texport.load_serving_artifact(out, "cpu")
    assert loaded == manifest
    direct = make_serving_fn(port_model(params), HCFG, CELLS, "cpu")
    for batch in (1, 3):           # one program serves every batch size
        px = pixels(batch, seed=batch)
        got, want = serve_fn(px), direct(px)
        for key in texport.OUTPUTS:
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                       atol=1e-5, err_msg=f"{key} {batch}")


def test_the_artifact_matches_the_jax_artifact(jax_setup, float_artifact,
                                               tmp_path):
    from pigeon_tpu.serve.export import (
        export_serving_artifact,
        load_serving_artifact,
    )

    jmodel, params = jax_setup
    export_serving_artifact(jmodel, params, HCFG, CELLS, str(tmp_path),
                            image_size=32, panorama=True,
                            platforms=("cpu",))
    want_fn, want_manifest = load_serving_artifact(str(tmp_path))
    got_fn, got_manifest = texport.load_serving_artifact(float_artifact[0],
                                                         "cpu")
    shared = set(want_manifest) - {"jax_version"}
    assert {k: got_manifest[k] for k in shared} == \
        {k: want_manifest[k] for k in shared}
    px = pixels(3, seed=9)
    got, want = got_fn(px), want_fn(px)
    for key in ("pred_lla", "embedding", "topk_probs"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, err_msg=key)
    np.testing.assert_array_equal(got["topk_cells"].numpy(),
                                  np.asarray(want["topk_cells"]))


def test_new_weights_of_the_same_shapes_serve_without_a_new_export(
        jax_setup, float_artifact, tmp_path):
    import shutil

    from pigeon_tpu_torch.models.super_guessr import SuperGuessr, init_weights
    from pigeon_tpu_torch.serve.server import make_serving_fn

    out = str(tmp_path / "swapped")
    shutil.copytree(float_artifact[0], out)
    other = init_weights(SuperGuessr(VCFG, HCFG, attn_impl="plain"), 5)
    np.savez(os.path.join(out, texport.PARAMS_FILE),
             **{k: v.numpy() for k, v in other.state_dict().items()})
    serve_fn, _ = texport.load_serving_artifact(out, "cpu")
    px = pixels(2, seed=4)
    got = serve_fn(px)
    want = make_serving_fn(other, HCFG, CELLS, "cpu")(px)
    old = texport.load_serving_artifact(float_artifact[0], "cpu")[0](px)
    for key in ("pred_lla", "embedding"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   atol=1e-5, err_msg=key)
    assert not np.allclose(got["embedding"].numpy(),
                           old["embedding"].numpy(), atol=1e-3)
    # The program holds no weights: a missing or reshaped array is
    # refused, not read from the program.
    state = other.state_dict()
    name = "vision.pos_embed"
    for bad in ({k: v for k, v in state.items() if k != name},
                {**state, name: state[name][:-1]}):
        np.savez(os.path.join(out, texport.PARAMS_FILE),
                 **{k: v.numpy() for k, v in bad.items()})
        with pytest.raises(Exception):
            texport.load_serving_artifact(out, "cpu")[0](px)
    path = os.path.join(out, texport.MODULE_FILE)
    program = torch.export.load(path)
    assert dict(program.state_dict) == {}
    assert program.example_inputs is None
    with zipfile.ZipFile(path) as archive:
        stored = sum(i.file_size for i in archive.infolist()
                     if "/data/" in i.filename)
    assert stored < 1024                 # the two normalisation vectors


def test_fixed_batch_refuses_another(jax_setup, tmp_path):
    _, params = jax_setup
    manifest = texport.export_serving_artifact(
        port_model(params), HCFG, CELLS, str(tmp_path), image_size=32,
        panorama=True, batch=2, platforms=("cpu",))
    assert manifest["batch"] == 2
    serve_fn, _ = texport.load_serving_artifact(str(tmp_path), "cpu")
    assert serve_fn(pixels(2))["pred_lla"].shape == (2, 2)
    with pytest.raises(Exception):
        serve_fn(pixels(3))


def test_f32_wire(jax_setup, tmp_path):
    from pigeon_tpu_torch.serve.server import make_serving_fn

    _, params = jax_setup
    texport.export_serving_artifact(
        port_model(params), HCFG, CELLS, str(tmp_path), image_size=32,
        panorama=True, wire_dtype="float32", platforms=("cpu",))
    serve_fn, manifest = texport.load_serving_artifact(str(tmp_path), "cpu")
    assert manifest["wire_dtype"] == "float32"
    px = RNG.normal(size=(2, 4, 32, 32, 3)).astype(np.float32)
    want = make_serving_fn(port_model(params), HCFG, CELLS, "cpu")(px)
    np.testing.assert_allclose(serve_fn(px)["pred_lla"].numpy(),
                               want["pred_lla"].numpy(), atol=1e-5)


def test_static_int8_export(jax_setup, tmp_path):
    """The int8 serving recipe exports, traced with ``torch._int_mm`` (an
    op the card runs too), and serves as the live int8 model."""
    from pigeon_tpu_torch.models.quant import quantize_and_calibrate
    from pigeon_tpu_torch.serve.server import make_serving_fn

    _, params = jax_setup
    calib = torch.from_numpy(RNG.normal(size=(2, 4, 32, 32, 3))
                             .astype(np.float32))
    qmodel = quantize_and_calibrate(port_model(params), calib,
                                    tower_key="vision", margin=1.25)
    texport.export_serving_artifact(qmodel, HCFG, CELLS, str(tmp_path),
                                    image_size=32, panorama=True,
                                    platforms=("cpu",))
    serve_fn, _ = texport.load_serving_artifact(str(tmp_path), "cpu")
    targets = {str(n.target) for n in serve_fn.program.graph.nodes}
    assert "aten._int_mm.default" in targets
    px = pixels(2, seed=6)
    got = serve_fn(px)
    want = make_serving_fn(qmodel, HCFG, CELLS, "cpu")(px)
    np.testing.assert_allclose(got["embedding"].numpy(),
                               want["embedding"].numpy(), atol=1e-5)
    assert (got["topk_cells"].numpy() < 8).all()


def test_version_and_platform_guards(float_artifact, tmp_path):
    import shutil

    out = str(tmp_path / "v")
    shutil.copytree(float_artifact[0], out)
    path = os.path.join(out, texport.MANIFEST_FILE)
    manifest = json.load(open(path))
    with pytest.raises(ValueError, match="exported for"):
        texport.load_serving_artifact(out, "cuda")
    manifest["artifact_version"] = 99
    json.dump(manifest, open(path, "w"))
    with pytest.raises(ValueError, match="artifact version"):
        texport.load_serving_artifact(out, "cpu")
    assert texport.check_platforms(["cuda", "cpu"]) == ("cuda", "cpu")
    for bad in (["tpu"], ["cpu", "tpu"], ["gpu"], []):
        with pytest.raises(ValueError):
            texport.check_platforms(bad)


def test_no_node_of_the_exported_program_is_a_kernel_op(float_artifact):
    """The artifact's graph calls no ``pigeon::`` operator; the walk does
    find one in a program that calls kernel K3's."""
    from pigeon_tpu_torch.kernels.attention import FLASH_ATTENTION_OP

    serve_fn, _ = texport.load_serving_artifact(float_artifact[0], "cpu")
    exported = torch.export.load(os.path.join(float_artifact[0],
                                              texport.MODULE_FILE))
    for graph in (serve_fn.program, exported.graph_module):
        assert texport.kernel_ops(graph) == []

    class Attend(torch.nn.Module):
        def forward(self, q, k, v):
            return FLASH_ATTENTION_OP(q, k, v)

    # Traced symbolically: the operator has no fake version for export.
    found = texport.kernel_ops(torch.fx.symbolic_trace(Attend()))
    assert found == ["pigeon::flash_attention"]


def test_export_refuses_a_kernel_route(jax_setup, tmp_path):
    _, params = jax_setup
    with pytest.raises(ValueError, match="plain route"):
        texport.export_serving_artifact(
            port_model(params, "fused"), HCFG, CELLS, str(tmp_path),
            image_size=32, panorama=True, platforms=("cpu",))


def test_export_then_serve_artifact_through_the_cli(tmp_path, monkeypatch):
    """``export`` (int8 too) writes an artifact; ``serve --artifact``
    builds no model and answers the bot protocol over HTTP."""
    cells = write_cells(tmp_path)
    monkeypatch.chdir(tmp_path)
    for quant in ([], ["--quant"]):
        art = str(tmp_path / f"artifact{len(quant)}")
        assert cli.main(["export", "exp", "--tiny", "--device", "cpu",
                         "--geocells", str(tmp_path / "cells.csv"),
                         "--panorama", "--platforms", "cpu", "--output",
                         art, *quant]) == 0
        manifest = json.load(open(os.path.join(art, texport.MANIFEST_FILE)))
        assert manifest["platforms"] == ["cpu"]
        assert manifest["batch"] == "symbolic" and manifest["panorama"]
        # The int8 artifact also behind the micro-batcher.
        batch = ["--serve-batch", "2"] if quant else []
        args = cli.build_parser().parse_args(
            ["serve", "--artifact", art, "--device", "cpu", "--port", "0",
             *batch])
        httpd = cli.start_artifact_server(args, block=False)
        try:
            service = httpd.RequestHandlerClass.service
            assert not hasattr(service.serve_fn, "model")
            assert (service.batcher is not None) == bool(quant)
            status, body = post(f"http://127.0.0.1:"
                                f"{httpd.server_address[1]}/api/v1/predict",
                                {"gameID": "g", "roundID": 1, **panorama()})
        finally:
            if service.batcher is not None:
                service.batcher.close()
            httpd.shutdown()
            httpd.server_close()
        assert status == 200
        lat, lng = body["results"]["lat"], body["results"]["lng"]
        assert np.isclose(cells, [lng, lat], atol=1e-3).all(-1).any()
    with pytest.raises(SystemExit, match="not a torch device type"):
        cli.main(["export", "exp", "--tiny", "--device", "cpu", "--geocells",
                  str(tmp_path / "cells.csv"), "--platforms", "tpu,cpu"])
    with pytest.raises(SystemExit, match="exported for"):
        cli.start_artifact_server(cli.build_parser().parse_args(
            ["serve", "--artifact", art, "--device", "meta"]), block=False)


# ---------------------------------------------------------------------------
# --landmarks, --model, scale-out flags
# ---------------------------------------------------------------------------

def write_dataset(root, name, rows, dim, seed, bad_bank=False):
    """One refinement dataset: a metadata CSV (train rows and one val
    row), a train bank and a prototype CSV over the bank's rows."""
    rng = np.random.default_rng(seed)
    lla = np.stack([rng.uniform(-180, 180, rows),
                    rng.uniform(-60, 70, rows)], -1).astype(np.float32)
    with open(root / f"{name}.csv", "w") as f:
        f.write("lng,lat,selection\n")
        for lng, lat in lla.tolist():
            f.write(f"{lng!r},{lat!r},train\n")
        f.write("1.5,2.5,val\n")
    emb = root / f"{name}_emb"
    emb.mkdir()
    n = rows + 1 if bad_bank else rows
    order = rng.permutation(n)
    np.save(emb / "train.npy",
            rng.normal(size=(n, dim)).astype(np.float32)[order])
    np.save(emb / "train_indices.npy", order)
    with open(root / f"{name}_protos.csv", "w") as f:
        f.write("geocell_idx,lng,lat,count,indices\n")
        for c in range(3):
            idx = sorted(rng.choice(rows, 3, replace=False).tolist())
            lng, lat = lla[idx].mean(0).tolist()
            f.write(f'{c},{lng!r},{lat!r},3,"{json.dumps(idx)}"\n')
    return str(root / f"{name}.csv"), str(emb), \
        str(root / f"{name}_protos.csv")


def refine_argv(paths):
    meta, emb, protos = (",".join(p) for p in zip(*paths))
    return ["serve", "--landmarks", "--metadata", meta, "--embeddings", emb,
            "--prototypes", protos]


def test_comma_separated_datasets_load_as_the_jax_clis(tmp_path):
    from pigeon_tpu.cli import run as jax_cli

    paths = [write_dataset(tmp_path, "yfcc", 12, 16, 1),
             write_dataset(tmp_path, "landmarks", 7, 16, 2)]
    argv = refine_argv(paths)
    got = cli.load_refine_assets(cli.build_parser().parse_args(argv))
    want = jax_cli._load_refine_assets(
        jax_cli.build_parser().parse_args(argv))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    assert got[1].shape == (19, 16) and got[2].shape == (19, 2)
    assert len(got[0]) == len(want[0]) == 6
    for g, w in zip(got[0], want[0]):
        assert g["indices"] == w["indices"]
        assert (g["geocell_idx"], g["count"]) == (w["geocell_idx"],
                                                  w["count"])
        # f32, the bank's dtype: pandas' CSV parser may round the
        # decimal one f64 ulp off Python's.
        assert np.float32(g["lng"]) == np.float32(w["lng"])
        assert np.float32(g["lat"]) == np.float32(w["lat"])
    # The landmark prototypes address the rows after the first bank's.
    assert min(i for r in got[0][3:] for i in r["indices"]) >= 12


@pytest.mark.parametrize("fault", ["lengths", "bank"])
def test_mismatched_datasets_stop_both_clis(tmp_path, fault):
    from pigeon_tpu.cli import run as jax_cli

    paths = [write_dataset(tmp_path, "yfcc", 12, 16, 1),
             write_dataset(tmp_path, "landmarks", 7, 16, 2,
                           bad_bank=fault == "bank")]
    argv = refine_argv(paths)
    if fault == "lengths":
        argv[argv.index("--prototypes") + 1] = paths[0][2]
        match = "same number"
    else:
        match = "8 embeddings vs 7"
    for module in (cli, jax_cli):
        with pytest.raises(SystemExit, match=match):
            loader = getattr(module, "load_refine_assets", None) \
                or module._load_refine_assets
            loader(module.build_parser().parse_args(argv))


def fields(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return obj


@pytest.mark.parametrize("make", ["landmarks_config", "vit_b32_vision",
                                  "vit_b32_text"])
def test_new_presets_equal_the_jax_packages(make):
    from pigeon_tpu import config as jax_config
    from pigeon_tpu_torch import config

    assert fields(getattr(config, make)()) == \
        fields(getattr(jax_config, make)())


@pytest.mark.parametrize("flags", [
    ["--landmarks"], ["--landmarks", "--panorama"], ["--model", "vit-b32"],
    ["--model", "vit-l14-336", "--yfcc"], ["--model", "vit-b32", "--tiny"],
    ["--landmarks", "--model", "vit-b32", "-m"], ["--tiny"]])
def test_make_config_equals_the_jax_clis(flags):
    from pigeon_tpu.cli import run as jax_cli

    argv = ["evaluate", "x", *flags]
    got = cli.make_config(cli.build_parser().parse_args(argv))
    want = jax_cli.make_config(jax_cli.build_parser().parse_args(argv))
    assert fields(got) == fields(want)


@pytest.mark.parametrize("argv, match", [
    (["serve", "--tp", "2"], "serve runs on one card"),
    (["export", "--fsdp"], "export runs on one card"),
    (["finetune", "--tp", "4", "--fsdp", "--device", "cpu"],
     "tp=4 must divide the world size 1"),
    (["pretrain", "--tp", "2", "--device", "cpu"],
     "tp=2 must divide the world size 1")])
def test_scale_out_flags_stop_with_the_queue_item(argv, match):
    """``serve`` and ``export`` stay on one card, as in the JAX CLI; the
    other commands take ``--tp`` only where it divides the ranks
    `torchrun` started (one process here)."""
    with pytest.raises(SystemExit, match=match):
        cli.main(argv)
