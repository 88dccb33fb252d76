"""queue_wait_ms.serve: the mean wait of a request in the micro-batcher,
from `submit` to its batch's staging (the program's `serve.queue` spans, as
`yardstick.spans` reads them), in ms."""

from portbench.yardstick.spans import mean_ms


def read(run):
    return mean_ms(run, "serve.queue")
