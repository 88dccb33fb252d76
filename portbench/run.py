"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. Set-up (building and warming up the
program, its first steps, the kernels' first build in a fresh checkout)
is timed from the start of this process; then the window measures for
``--seconds``; with ``--trace 1`` a short steady slice after it is
profiled and the per-layer metrics replace the end-to-end ones. The last
line on standard output is one JSON object; the numbers the correctness
check compared are the last lines on standard error. Without as many CUDA
devices as the cell asks for, the run prints no result and exits 3; with
a module of JAX or of the JAX package loaded, it exits 4.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

#: Exit codes: no card (or too few), a forbidden module loaded.
NO_DEVICE, FORBIDDEN = 3, 4


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_environment(repo: str) -> None:
    """Kernel caches inside the checkout, at fixed paths, and no JAX
    behind any library."""
    build = os.path.join(repo, "build")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(build, "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    args = parse_args(argv)
    from portbench.harness import (
        REPO,
        Bench,
        ForbiddenImport,
        guard_imports,
        run_cell,
    )

    cache_environment(REPO)
    bench = Bench()
    chips = bench.workload(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return NO_DEVICE
    try:
        line = run_cell(bench, args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda", T0)
        guard_imports()
    except ForbiddenImport as err:
        print(f"portbench: {err}", file=sys.stderr)
        return FORBIDDEN
    for name, r in line["checks"].items():
        print(f"check {name} {r['value']!r} limit {r['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
