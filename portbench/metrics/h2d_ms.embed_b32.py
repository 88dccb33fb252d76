"""h2d_ms.embed_b32: the mean elapsed time on the card of a sweep batch's
copy to the card and its normalisation there, between CUDA events (the
program's `embed.h2d` spans, as `yardstick.spans` reads them), in ms."""

from portbench.yardstick.spans import mean_device_ms


def read(run):
    return mean_device_ms(run, "embed.h2d")
