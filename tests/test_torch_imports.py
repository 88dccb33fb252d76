"""The PyTorch port imports no JAX: every module of `pigeon_tpu_torch`
imports in a process where ``jax``, ``flax`` and ``optax`` are blocked."""

import os
import pkgutil
import re
import subprocess
import sys

import pigeon_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax")


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
        "train.checkpoints")} <= set(modules)
    code = (f"import sys\nfor name in {BLOCKED!r}:\n"
            "    sys.modules[name] = None\n"
            f"for name in {modules!r}:\n    __import__(name)\n"
            "print('imported', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_no_source_line_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax)\b")
    for dirpath, _, files in os.walk(pigeon_tpu_torch.__path__[0]):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    for i, line in enumerate(f, 1):
                        assert not pattern.match(line), f"{name}:{i}"
