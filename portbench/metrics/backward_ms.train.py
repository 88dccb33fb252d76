"""backward_ms.train: the mean elapsed time on the card of a train step's
backward, remat recompute included, between CUDA events (the program's
`train.backward` spans, as `yardstick.spans` reads them), in ms."""

from portbench.yardstick.spans import mean_device_ms


def read(run):
    return mean_device_ms(run, "train.backward")
