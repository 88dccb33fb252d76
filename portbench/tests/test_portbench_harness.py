"""The harness on the CPU at the tiny size: a sound run is correct, every
planted fault is not, and new configuration, traffic, metric and limit
files are found by name without an edit to any file already there."""

import json
import time

import pytest

from portbench.harness import ROOT, Bench, RunRecord, run_cell
from portbench.tests.tiny import tiny_spec

SEED = 2 ** 31 + 11


def run(root, workload, fault=None, spec=None, trace=False):
    bench = Bench(spec or tiny_spec(), roots=(str(root), ROOT))
    return run_cell(bench, workload, SEED, 0.5, trace, "cpu",
                    time.perf_counter(), fault=fault)


@pytest.mark.parametrize("workload", ["tiny-train", "tiny-embed",
                                      "tiny-serve"])
def test_sound_run_is_correct(tiny_root, workload):
    line = run(tiny_root, workload)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "checks"
    names = {"tiny-train": "train_images_per_s",
             "tiny-embed": "embed_images_per_s",
             "tiny-serve": "serve_p95_ms"}
    assert set(line["metrics"]) == {names[workload], "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())


@pytest.mark.parametrize("workload,fault", [
    ("tiny-train", "unchanged"), ("tiny-train", "half_batch"),
    ("tiny-embed", "half_batch"), ("tiny-embed", "altered"),
    ("tiny-serve", "half_batch"), ("tiny-serve", "altered"),
    ("tiny-serve", "head_rolled"), ("tiny-serve", "view_dropped")])
def test_planted_fault_is_not_correct(tiny_root, workload, fault):
    line = run(tiny_root, workload, fault)
    assert not line["correct"], (line["checks"], line["attempted"])


def test_new_files_found_by_name(tiny_root):
    """A cell added with files of its own: a configuration, a traffic mix
    for an existing driver, a per-layer metric and the cell's limits."""
    cfg = json.loads((tiny_root / "configs" / "tiny.json").read_text())
    cfg["embed_batch_size_per_device"] = 4
    (tiny_root / "configs" / "tiny4.json").write_text(json.dumps(cfg))
    (tiny_root / "traffic").mkdir()
    traffic = json.loads(open(f"{ROOT}/traffic/embed.json").read())
    traffic["pool"] = 2
    (tiny_root / "traffic" / "embed-pool2.json").write_text(
        json.dumps(traffic))
    (tiny_root / "metrics").mkdir()
    (tiny_root / "metrics" / "items.new.py").write_text(
        "def read(run):\n    return float(run.window['items'])\n")
    (tiny_root / "limits" / "tiny4-embed.json").write_text(
        json.dumps({"embedding_error": 0.05}))
    spec = tiny_spec()
    spec["workloads"].append({"name": "tiny4-embed", "config": "tiny4",
                              "traffic": "embed-pool2", "chips": 1,
                              "why": "tiny"})
    spec["end_to_end"][1]["workloads"].append("tiny4-embed")
    spec["per_layer"].append({"name": "items.new", "unit": "images",
                              "better": "higher", "source": "host_clock",
                              "layer": "embed step",
                              "moves": "embed_images_per_s",
                              "workloads": ["tiny4-embed"]})
    bench = Bench(spec, roots=(str(tiny_root), ROOT))
    assert [m["name"] for m in bench.per_layer("tiny4-embed")] == [
        "items.new"]
    drv = bench.driver(bench.traffic("embed-pool2")).Driver(
        bench.config("tiny4"), bench.traffic("embed-pool2"), SEED, "cpu")
    assert (drv.batch, drv.traffic["pool"]) == (4, 2)
    line = run(tiny_root, "tiny4-embed", spec=spec)
    assert line["correct"], line["checks"]
    record = RunRecord(bench.workload("tiny4-embed"), {}, {}, {"items": 8})
    assert bench.metric("items.new").read(record) == 8.0


def test_per_layer_metrics_of_each_cell():
    """Each cell reads the per-layer metrics that list it, and each of
    those modules exists."""
    bench = Bench()
    for cell in bench.spec["workloads"]:
        names = [m["name"] for m in bench.per_layer(cell["name"])]
        assert names, cell["name"]
        for name in names:
            assert callable(bench.metric(name).read)
