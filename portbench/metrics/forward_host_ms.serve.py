"""forward_host_ms.serve: the mean host time of a batch's serving forward,
`serve_fn` enqueuing the tower and the head on the card (the program's
`serve.forward` spans, as `yardstick.spans` reads them), in ms."""

from portbench.yardstick.spans import mean_ms


def read(run):
    return mean_ms(run, "serve.forward")
