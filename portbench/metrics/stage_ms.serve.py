"""stage_ms.serve: the mean host time of staging a batch: stacking the
panoramas, the copy to the card and the pad (the program's `serve.stage`
spans, as `yardstick.spans` reads them), in ms."""

from portbench.yardstick.spans import mean_ms


def read(run):
    return mean_ms(run, "serve.stage")
