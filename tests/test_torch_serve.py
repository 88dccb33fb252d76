"""The PyTorch port's server over real HTTP on loopback: the ``serve``
command's startup path (`cli.run.start_server`) with the tiny config on
``--device cpu``, bf16 and int8 (``--quant``), the bot protocol's
replies, and the wiring of geocells, calibration images and refinement
assets."""

import base64
import glob
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pigeon_tpu_torch.cli.run import build_parser, main, start_server

FIXTURES = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data", "benchmarks", "sample20", "images", "*.png")))
RNG = np.random.default_rng(4)


def b64(path):
    with open(path, "rb") as f:
        return "data:image/png;base64," + base64.b64encode(f.read()).decode()


def panorama(first=0):
    keys = ("image", "image_2", "image_3", "image_4")
    return {k: b64(FIXTURES[first + i]) for i, k in enumerate(keys)}


def post(url, payload, raw=None):
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def write_cells(tmp_path, n=5):
    cells = np.stack([np.linspace(-150, 150, n),
                      np.linspace(-50, 60, n)], -1).astype(np.float32)
    with open(tmp_path / "cells.csv", "w") as f:
        f.write("name,lng,lat\n")
        for i, (lng, lat) in enumerate(cells.tolist()):
            f.write(f"c{i},{lng!r},{lat!r}\n")
    return cells


def serve_args(tmp_path, *extra):
    return build_parser().parse_args([
        "serve", "tiny", "--tiny", "--device", "cpu", "--port", "0",
        "--geocells", str(tmp_path / "cells.csv"), *extra])


@pytest.fixture(scope="module")
def panorama_server(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("serve")
    cells = write_cells(tmp_path)
    httpd = start_server(serve_args(tmp_path, "--panorama", "-m",
                                    "--heading"), block=False)
    # The command logs games under ./runs; keep this run's log in tmp.
    log = str(tmp_path / "games.jsonl")
    httpd.RequestHandlerClass.service.game_log = log
    yield f"http://127.0.0.1:{httpd.server_address[1]}", cells, log
    httpd.shutdown()
    httpd.server_close()


def test_panorama_of_fixtures_is_answered(panorama_server):
    url, cells, _ = panorama_server
    status, body = post(f"{url}/api/v1/predict",
                        {"gameID": "g1", "roundID": 3, **panorama()})
    assert status == 200
    lat, lng = body["results"]["lat"], body["results"]["lng"]
    assert np.isfinite([lat, lng]).all()
    # Without refinement the answer is a geocell centroid.
    assert np.isclose(cells, [lng, lat], atol=1e-4).all(-1).any()
    assert (body["gameID"], body["roundID"]) == ("g1", 3)


@pytest.mark.parametrize("fault, message", [
    ("garbage", "undecodable"), ("missing_image_3", "image_3")])
def test_client_faults_are_400_and_the_server_keeps_answering(
        panorama_server, fault, message):
    url, _, _ = panorama_server
    payload = panorama(4)
    if fault == "garbage":
        payload["image_2"] = base64.b64encode(
            b"\x00\x01notanimage\x02" * 40).decode()
    else:
        del payload["image_3"]
    status, body = post(f"{url}/api/v1/predict", payload)
    assert status == 400
    assert message in body["error"]
    status, _ = post(f"{url}/api/v1/predict", panorama(8))
    assert status == 200


def test_invalid_json_game_log_and_unknown_path(panorama_server):
    url, _, log = panorama_server
    status, _ = post(f"{url}/api/v1/predict", None, raw=b"not json{{")
    assert status == 400
    status, body = post(f"{url}/api/v1/game",
                        {"gameID": "g1", "game": {"score": 4000}})
    assert status == 200 and body["status"] == "ok"
    with open(log) as f:
        assert json.loads(f.readlines()[-1])["game"] == {"score": 4000}
    status, _ = post(f"{url}/api/v1/nope", {})
    assert status == 404


@pytest.mark.parametrize("calib", ["synthetic", "images"])
def test_quant_server_answers_a_panorama(tmp_path, calib):
    """``serve --quant`` quantizes and calibrates the tower at start-up
    (on the fixtures or a seeded synthetic batch), then answers."""
    from pigeon_tpu_torch.models.quant import QuantLinear

    cells = write_cells(tmp_path)
    extra = (["--calib-images", os.path.dirname(FIXTURES[0])]
             if calib == "images" else [])
    httpd = start_server(serve_args(tmp_path, "--panorama", "-m",
                                    "--heading", "--quant", *extra),
                         block=False)
    try:
        model = httpd.RequestHandlerClass.service.serve_fn.model
        layers = [m for m in model.modules() if isinstance(m, QuantLinear)]
        # 6 per encoder layer and the patch embed, all calibrated.
        assert len(layers) == 6 * 2 + 1
        assert all(m.mode == "static" and float(m.act_scale) != 1.0
                   for m in layers)
        status, body = post(
            f"http://127.0.0.1:{httpd.server_address[1]}/api/v1/predict",
            panorama(12))
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert status == 200
    lat, lng = body["results"]["lat"], body["results"]["lng"]
    assert np.isclose(cells, [lng, lat], atol=1e-4).all(-1).any()


def test_calibration_batch_tiles_images_over_the_views(tmp_path):
    from pigeon_tpu_torch.cli.run import make_config, serve_calibration_batch

    args = serve_args(tmp_path, "--panorama", "--quant", "--calib-images",
                      os.path.dirname(FIXTURES[0]))
    batch = serve_calibration_batch(args, make_config(args))
    assert batch.shape == (len(FIXTURES), 4, 64, 64, 3)
    assert batch.dtype == torch.float32
    assert torch.equal(batch[:, 0], batch[:, 3])
    args.calib_images = str(tmp_path)              # no image there
    with pytest.raises(SystemExit, match="no images"):
        serve_calibration_batch(args, make_config(args))


def test_serve_wires_refinement_assets_with_hedge(tmp_path):
    """--prototypes/--embeddings/--metadata --hedge put the refiner in the
    HTTP path: the answer is an exact bank or prototype location, never a
    bare geocell centroid."""
    rng = np.random.default_rng(7)
    n_cells, dim, n_bank = 5, 64, 40
    cells = write_cells(tmp_path, n_cells)
    bank_lla = (np.repeat(cells, n_bank // n_cells, axis=0)
                + rng.normal(0, 0.5, (n_bank, 2))).astype(np.float32)
    with open(tmp_path / "meta.csv", "w") as f:
        f.write("lng,lat,selection\n")
        for lng, lat in bank_lla.tolist():
            f.write(f"{lng!r},{lat!r},train\n")
        f.write("0.0,0.0,val\n")            # not in the bank
    emb_dir = tmp_path / "emb"
    emb_dir.mkdir()
    order = rng.permutation(n_bank)
    np.save(emb_dir / "train.npy",
            rng.normal(size=(n_bank, dim)).astype(np.float32)[order])
    np.save(emb_dir / "train_indices.npy", order)
    protos = []
    with open(tmp_path / "protos.csv", "w") as f:
        f.write("geocell_idx,lng,lat,count,indices\n")
        for c in range(n_cells):
            for half in range(2):
                start = c * (n_bank // n_cells) + half * 4
                idx = list(range(start, start + 4))
                lng, lat = bank_lla[idx].mean(0).tolist()
                protos.append((lng, lat))
                f.write(f'{c},{lng!r},{lat!r},4,"{json.dumps(idx)}"\n')

    httpd = start_server(serve_args(
        tmp_path, "--hedge", "--metadata", str(tmp_path / "meta.csv"),
        "--prototypes", str(tmp_path / "protos.csv"),
        "--embeddings", str(emb_dir)), block=False)
    try:
        assert httpd.RequestHandlerClass.service.refine_fn is not None
        status, body = post(
            f"http://127.0.0.1:{httpd.server_address[1]}/api/v1/predict",
            {"image": b64(FIXTURES[0])})
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert status == 200
    lat, lng = body["results"]["lat"], body["results"]["lng"]
    pool = np.concatenate([bank_lla, np.array(protos, np.float32)])
    assert np.isclose(pool, [lng, lat], atol=1e-4).all(-1).any()


@pytest.mark.parametrize("flags, message", [
    (["--device", "cpu", "--hedge"], "--hedge requires"),
    (["--device", "cuda"], "no CUDA device"),
    (["--device", "cuda", "--quant"], "no CUDA device"),
])
def test_serve_refuses_what_it_cannot_do(tmp_path, flags, message):
    """Hedging without a bank, and a CUDA device that is absent, stop the
    command: it never drops to the CPU by itself."""
    import torch

    if "cuda" in flags and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    write_cells(tmp_path)
    with pytest.raises(SystemExit, match=message):
        main(["serve", "x", "--tiny", "--geocells",
              str(tmp_path / "cells.csv"), *flags])


def test_parser_takes_the_jax_clis_serve_flags():
    args = build_parser().parse_args([
        "serve", "run1", "--panorama", "-m", "--heading", "--yfcc",
        "--geocells", "c.csv", "--prototypes", "p.csv", "--embeddings",
        "e", "--metadata", "m.csv", "--hedge", "--host", "0.0.0.0",
        "--port", "8080", "--quant", "--calib-images", "imgs"])
    assert args.panorama and args.multitask and args.heading and args.yfcc
    assert (args.device, args.port, args.host) == ("cuda", 8080, "0.0.0.0")
    assert args.quant and args.calib_images == "imgs"
    defaults = build_parser().parse_args(["serve"])
    assert not defaults.quant and defaults.calib_images is None
