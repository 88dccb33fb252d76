"""collect_ms.serve: the mean time a batch collects requests, from its
first request taken to the batch closed, full or at `max_wait_ms` (the
program's `serve.collect` spans, as `yardstick.spans` reads them), in ms."""

from portbench.yardstick.spans import mean_ms


def read(run):
    return mean_ms(run, "serve.collect")
