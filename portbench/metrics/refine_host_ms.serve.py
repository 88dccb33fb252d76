"""refine_host_ms.serve: the mean host time of a batch's refiner,
`refine_fn` enqueuing the prototype search on the card (the program's
`serve.refine` spans, as `yardstick.spans` reads them), in ms."""

from portbench.yardstick.spans import mean_ms


def read(run):
    return mean_ms(run, "serve.refine")
