#!/usr/bin/env python3
"""Which gloo operations take CUDA tensors: two ranks share card 0 (as
the smoke's gloo rigs do: NCCL refuses two ranks on one device) and run
one operation on a CUDA tensor, each operation in a fresh pair of
processes, so that one that aborts its process hides none of the others.

    python3 scripts/probe_gloo_cuda.py

Prints the card's name and power limit, then one JSON line per
operation: ``ok`` with the value rank 1 holds after it, ``raised`` with
the exception's first line, or ``died`` with the ranks' exit codes (a
C++ exception on gloo's own thread ends the process with SIGABRT).
`train/pipeline.py` stages its point-to-point hops through host memory
because of the answer for ``send_recv``.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OPS = ("send_recv", "isend_irecv", "broadcast", "all_reduce")


def _rank(rank: int, port: int, op: str, out: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    t = torch.full((4, 8), float(rank + 1), device="cuda")
    try:
        if op == "send_recv":
            dist.send(t, 1) if rank == 0 else dist.recv(t, 0)
        elif op == "isend_irecv":
            (dist.isend(t, 1) if rank == 0 else dist.irecv(t, 0)).wait()
        elif op == "broadcast":
            dist.broadcast(t, 0)
        else:
            dist.all_reduce(t)
        torch.cuda.synchronize()
        result = {"ok": float(t[0, 0])}
    except Exception as e:  # noqa: BLE001 - the probe's answer
        result = {"raised": str(e).splitlines()[0][:200]}
    if rank == 1:
        with open(out, "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe_gloo_cuda: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    out = f"probe_gloo_cuda.{os.getpid()}.json"
    for op in OPS:
        ctx = mp.start_processes(_rank, args=(free_port(), op, out),
                                 nprocs=2, start_method="spawn",
                                 join=False)
        for p in ctx.processes:
            p.join(120)
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in ctx.processes]
        if os.path.exists(out) and not any(codes):
            with open(out) as f:
                result = json.load(f)
            os.remove(out)
        else:
            result = {"died": codes}
        print(json.dumps({"op": op, "torch": torch.__version__,
                          **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
