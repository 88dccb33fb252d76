"""Readings that set the limits of a cell's check, on the chip.

    python3 -m portbench.control --workload NAME --seeds 1,2,3 \\
        [--mode program|control|FAULT] [--seconds S]

For each seed, in one process: the cell's driver set up as a run sets
it up (``program``), with the control in the program's place
(``control``: the reference in int8 for training, the program's own
int8 path for the forward-only cells) or with one of the driver's faults
planted; then a window of ``--seconds`` (the window at the cell's own
load, long enough to fill the checked sample), the release of the
program's state and the check. One JSON line a seed gives the numbers
the check compared. The benchmark's own runs never take this path.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", default="program")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--rates", default="",
                   help="with --mode sweep: offered rates, requests/s")
    args = p.parse_args(argv)

    import torch

    from portbench.harness import Bench

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 3
    bench = Bench()
    cell = bench.workload(args.workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    module = bench.driver(traffic)
    if args.mode == "sweep":
        return sweep(module, config, traffic, int(args.seeds.split(",")[0]),
                     [float(r) for r in args.rates.split(",")], args.seconds)
    control = args.mode == "control"
    fault = None if args.mode in ("program", "control") else args.mode
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        drv = module.Driver(config, traffic, seed, "cuda", fault=fault,
                            control=control)
        drv.setup()
        win = drv.window(args.seconds)
        drv.release()
        torch.cuda.empty_cache()
        checks = drv.check()
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "checks": checks,
                          "details": getattr(drv, "details", None),
                          "attempted": win["attempted"],
                          "seconds": time.perf_counter() - t}), flush=True)
        del drv
        torch.cuda.empty_cache()
    return 0


def sweep(module, config, traffic, seed, rates, seconds) -> int:
    """Offered rates in turn on one set-up serving driver: for each, the
    latency's median, 95th percentile and maximum, the median latency of
    the last quarter of requests against the first (a backlog that grows
    widens it), the mean fill and the sender's lateness."""
    import numpy as np
    import torch

    drv = module.Driver(config, traffic, seed, "cuda")
    drv.setup()
    for rate in rates:
        drv.traffic = dict(traffic, arrivals=dict(traffic["arrivals"],
                                                  rate=rate))
        win = drv.window(seconds)
        lat = np.asarray(win["counters"]["latency_ms"])
        q = max(1, len(lat) // 4)
        fills = win["counters"]["fills"]
        print(json.dumps({
            "rate": rate, "sent": len(lat), "failed": win["failed"],
            "p50_ms": float(np.median(lat)),
            "p95_ms": float(np.percentile(lat, 95)),
            "max_ms": float(lat.max()),
            "first_quarter_p50_ms": float(np.median(lat[:q])),
            "last_quarter_p50_ms": float(np.median(lat[-q:])),
            "mean_fill": sum(n for n, _ in fills) / max(1, len(fills)),
            "send_late_p95_ms": win["counters"]["send_late_p95_ms"]}),
            flush=True)
    drv.release()
    torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
