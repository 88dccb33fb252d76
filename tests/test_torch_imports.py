"""The PyTorch port imports no JAX and nothing of the JAX package: every
module of `pigeon_tpu_torch` and every tuning driver
(`scripts/bench_torch_attn_*.py`) imports in a process where ``jax``,
``flax``, ``optax`` and ``pigeon_tpu`` are blocked, and no source line of
the port, of the drivers, of the port's other scripts or of
`chip_smoke.py` imports them."""

import os
import pkgutil
import re
import subprocess
import sys

import pigeon_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "pigeon_tpu")
DRIVERS = ("bench_torch_attn_bwd", "bench_torch_attn_fwd_diag",
           "bench_torch_attn_qkv_fused")
IMPORT_LINE = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|pigeon_tpu)(\.|\s|$)")


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        pigeon_tpu_torch.__path__, "pigeon_tpu_torch."))


def test_every_module_imports_with_jax_blocked():
    modules = port_modules()
    assert {f"pigeon_tpu_torch.{name}" for name in (
        "serve.server", "cli.run", "kernels.fused_qkv_attention",
        "kernels.attention", "kernels.fused_qkv_attention_int8",
        "models.quant", "kernels.geodesy", "core.geodesy", "core.scoring",
        "models.geocell_head", "data.pipeline", "train.modes",
        "train.train_loop", "train.metrics", "train.loop",
        "train.checkpoints", "config", "kernels.fused_ln_qkv_attention",
        "kernels.fused_mlp", "data.native_decode",
        "kernels.fused_block_attention",
        "kernels.fused_block_attention_int8",
        "kernels.attention_bwd_variants", "kernels.attention_fwd_variants",
        "tuning", "models.hf_import", "train.evaluate", "train.embed",
        "models.vit_embedder", "train.preemption", "train.profiling",
        "geocell.boundaries", "geocell.augmentor", "serve.batching",
        "serve.export", "models.zeroshot", "data.tokenizer",
        "data.captions", "data.pretrain", "train.mesh",
        "train.multihost", "kernels.sharded", "train.dryrun",
        "geocell.geokernels", "geocell.geometry", "geocell.voronoi",
        "geocell.optics", "geocell.cells", "geocell.creation",
        "geocell.naive", "geocell.assignment", "geocell.prototypes",
        "train.pipeline")} \
        <= set(modules)
    code = (f"import runpy, sys\nfor name in {BLOCKED!r}:\n"
            "    sys.modules[name] = None\n"
            f"for name in {modules!r}:\n    __import__(name)\n"
            f"for name in {DRIVERS!r}:\n"
            "    runpy.run_path(f'scripts/{name}.py')\n"
            "print('imported', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def source_files():
    for dirpath, _, files in os.walk(pigeon_tpu_torch.__path__[0]):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")
    for name in (*DRIVERS, "bench_torch_flash_sm90", "profile_torch_routes",
                 "pretrain_grad_precision", "probe_gloo_cuda"):
        yield os.path.join(ROOT, "scripts", f"{name}.py")


def test_no_source_line_imports_jax():
    files = list(source_files())
    assert any(f.endswith("config.py") for f in files)
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                assert not IMPORT_LINE.match(line), f"{path}:{i}: {line}"


def test_import_pattern_tells_the_port_from_the_jax_package():
    for line in ("import jax", "from jax.numpy import x", "import pigeon_tpu",
                 "from pigeon_tpu.config import VisionConfig",
                 "    from pigeon_tpu import config", "import flax.linen"):
        assert IMPORT_LINE.match(line), line
    for line in ("import pigeon_tpu_torch", "from pigeon_tpu_torch import x",
                 "from pigeon_tpu_torch.config import VisionConfig",
                 "import jaxtyping", "# from pigeon_tpu.config import x"):
        assert not IMPORT_LINE.match(line), line
