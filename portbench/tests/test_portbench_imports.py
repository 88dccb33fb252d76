"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names; the reference loads nothing of the program."""

import subprocess
import sys

from portbench.harness import REPO, forbidden_modules


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["pigeon_tpu_torch", "pigeon_tpu_torch.x",
                              "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_modules(["pigeon_tpu", "pigeon_tpu.models", "jax",
                              "jaxlib.xla_client", "flax.linen",
                              "torch"]) == [
        "flax.linen", "jax", "jaxlib.xla_client", "pigeon_tpu",
        "pigeon_tpu.models"]


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, check=True, timeout=300)
    return set(out.stdout.split())


def test_a_tiny_run_loads_no_jax(tmp_path):
    code = f"""
import time, pathlib
from portbench import run
from portbench.harness import Bench, ROOT, run_cell, guard_imports
from portbench.tests.tiny import tiny_spec, write_tiny_root
root = write_tiny_root(pathlib.Path({str(tmp_path)!r}))
bench = Bench(tiny_spec(), roots=(str(root), ROOT))
for w in ("tiny-train", "tiny-embed"):
    line = run_cell(bench, w, 3, 0.1, False, "cpu", time.perf_counter())
    assert line["correct"], line
guard_imports()
"""
    names = loaded_after(code)
    assert "pigeon_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "pigeon_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = loaded_after("import portbench.reference.model")
    assert not names & {"pigeon_tpu_torch", "pigeon_tpu", "jax"}
