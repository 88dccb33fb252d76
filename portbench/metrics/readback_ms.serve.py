"""readback_ms.serve: the mean host time of reading a batch's rows back,
the wait for the card included (the program's `serve.readback` spans, as
`yardstick.spans` reads them), in ms."""

from portbench.yardstick.spans import mean_ms


def read(run):
    return mean_ms(run, "serve.readback")
