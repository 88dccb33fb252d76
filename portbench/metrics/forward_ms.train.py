"""forward_ms.train: the mean elapsed time on the card of a train step's
forward, label smoothing and loss, between CUDA events (the program's
`train.forward` spans, as `yardstick.spans` reads them), in ms."""

from portbench.yardstick.spans import mean_device_ms


def read(run):
    return mean_device_ms(run, "train.forward")
