"""ctypes loader for the port's native JPEG decoder (`csrc/decode.cpp`).

Counterpart of `pigeon_tpu/data/native_decode.py`, with the same
contract: libjpeg decode + bicubic shortest-edge resize + centre crop in
C++, OpenMP across the images of a batch. The source is the port's own
copy of the JAX package's decoder (`native/decode.cpp`), built with the
same flags. The library is built with
``g++`` at first use into the checkout's ignored ``build/`` directory.
Where it cannot be built (no compiler or no libjpeg headers), or for an
image it cannot decode (a PNG, a CMYK JPEG), the caller decodes with PIL
instead, as the JAX service does.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
import subprocess
from typing import List, Optional, Sequence

import numpy as np

from pigeon_tpu_torch import native

logger = logging.getLogger("pigeon_tpu_torch.native_decode")

SRC_PATH = os.path.join(native.CSRC_DIR, "decode.cpp")
#: The flags the JAX package builds its copy with (`native/build.sh`).
GXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=fast", "-funroll-loops",
             "-fPIC", "-shared", "-fopenmp")


@functools.lru_cache(maxsize=None)
def load() -> Optional[ctypes.CDLL]:
    """Build (at first use) and load the decoder; None where it cannot be
    built on this machine, or where ``PIGEON_NATIVE_DECODE=0`` asks for PIL
    (`pigeon_tpu/data/native_decode.py::load`)."""
    if os.environ.get("PIGEON_NATIVE_DECODE", "1") == "0":
        logger.warning("native decode off (PIGEON_NATIVE_DECODE=0), "
                       "decoding with PIL")
        return None
    try:
        built = native.build_shared(SRC_PATH, ["g++"], GXX_FLAGS,
                                    libs=("-ljpeg",))
        lib = ctypes.CDLL(built.path)
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        logger.warning("native decode unavailable, decoding with PIL: %s",
                       str(e).splitlines()[0])
        return None
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.decode_resize_crop_batch.argtypes = [u8p, i64p, i64, i64, u8p, u8p,
                                             i64, i64]
    lib.decode_resize_crop_batch.restype = None
    return lib


def available() -> bool:
    return load() is not None


def decode_resize_crop_batch(buffers: Sequence[bytes], target: int,
                             nthreads: int = 0
                             ) -> Optional[List[Optional[np.ndarray]]]:
    """Decode JPEG buffers in one native call, with libjpeg's M/8 IDCT
    scaling (the JAX service's ``fast`` mode).

    Returns a list aligned with ``buffers``: a ``(target, target, 3)``
    uint8 array per success, None per image that failed; None wholesale
    when the library is unavailable.
    """
    lib = load()
    if lib is None:
        return None
    n = len(buffers)
    offsets = np.zeros(n + 1, np.int64)
    offsets[1:] = np.cumsum([len(b) for b in buffers])
    data = np.frombuffer(b"".join(buffers), dtype=np.uint8) if n \
        else np.zeros(0, np.uint8)
    out = np.empty((n, target, target, 3), np.uint8)
    ok = np.zeros(n, np.uint8)
    lib.decode_resize_crop_batch(data, offsets, n, target, out, ok,
                                 1, int(nthreads))
    return [out[i] if ok[i] else None for i in range(n)]
