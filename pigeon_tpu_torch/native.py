"""Build native sources into shared libraries at first use.

The port's CUDA kernels (`csrc/*.cu`, compiled by ``nvcc`` for
``sm_90a``) and the host JPEG decoder (`csrc/decode.cpp`, by ``g++``)
are compiled on the machine that runs them, into ``build/`` at the root
of the checkout (listed in ``.gitignore``). A library's file name carries
a hash of its source, the local headers it includes (``#include "..."``,
followed recursively) and its command, so an edited source or header is
rebuilt and a stale library is never loaded. The output is written to a temporary name
and renamed into place, so concurrent builds never expose a partial
file.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import NamedTuple, Sequence

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(REPO_ROOT, "build")
CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

#: nvcc flags for every CUDA kernel of the port (Hopper, ctypes-bound).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Built(NamedTuple):
    """A compiled library: its path, the compiler's output (kept beside
    the library, and read back when an existing build is reused) and the
    seconds the build took (0 when reused)."""

    path: str
    log: str
    seconds: float


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_closure(src_path: str) -> list:
    """``src_path`` and every local header it includes, recursively
    (quoted includes, resolved beside the including file), in a fixed
    order."""
    seen, order = set(), []

    def visit(path: str) -> None:
        path = os.path.abspath(path)
        if path in seen:
            return
        seen.add(path)
        order.append(path)
        with open(path, "rb") as f:
            text = f.read()
        for name in _LOCAL_INCLUDE.findall(text):
            header = os.path.join(os.path.dirname(path), name.decode())
            if os.path.exists(header):
                visit(header)

    visit(src_path)
    return order


def library_path(src_path: str, compiler: Sequence[str],
                 flags: Sequence[str] = (), libs: Sequence[str] = ()) -> str:
    """Where ``build_shared`` puts the library: ``build/lib<stem>-<hash>.so``
    with the hash over the source, its local headers and the command."""
    digest = hashlib.sha256()
    for path in source_closure(src_path):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0"
                          + f.read() + b"\0")
    digest.update("\0".join([os.path.basename(compiler[0]), *compiler[1:],
                             *flags, *libs]).encode())
    stem = os.path.splitext(os.path.basename(src_path))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def build_shared(src_path: str, compiler: Sequence[str],
                 flags: Sequence[str] = (), libs: Sequence[str] = ()
                 ) -> Built:
    """Compile ``src_path`` with ``compiler + flags -o OUT src + libs``.

    Raises ``RuntimeError`` with the compiler's output when the build
    fails, and ``FileNotFoundError`` when the source or compiler is
    missing."""
    lib_path = library_path(src_path, compiler, flags, libs)
    log_path = f"{lib_path}.log"
    if os.path.exists(lib_path):
        log = ""
        if os.path.exists(log_path):
            with open(log_path, encoding="utf-8") as f:
                log = f.read()
        return Built(lib_path, log, 0.0)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp_path = f"{lib_path}.tmp.{os.getpid()}"
    start = time.perf_counter()
    proc = subprocess.run(
        [*compiler, *flags, "-o", tmp_path, src_path, *libs],
        capture_output=True, text=True, timeout=600, check=False)
    seconds = time.perf_counter() - start
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
        raise RuntimeError(f"building {src_path} failed "
                           f"(exit {proc.returncode}):\n{log}")
    with open(f"{tmp_path}.log", "w", encoding="utf-8") as f:
        f.write(log)
    os.replace(f"{tmp_path}.log", log_path)
    os.replace(tmp_path, lib_path)
    return Built(lib_path, log, seconds)


def build_cuda(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` for sm_90a with the port's nvcc flags."""
    return build_shared(os.path.join(CSRC_DIR, f"{name}.cu"), [nvcc()],
                        NVCC_FLAGS)
