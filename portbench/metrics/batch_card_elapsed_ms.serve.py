"""batch_card_elapsed_ms.serve: the mean elapsed time of a batch on the
card, from its copy to the refiner's last launch, between two CUDA events
(the program's `serve.device` spans, as `yardstick.spans` reads them), in
ms. Not busy time: it holds the card's idle gaps while the host's launches
pace the forward and the refiner."""

from portbench.yardstick.spans import mean_device_ms


def read(run):
    return mean_device_ms(run, "serve.device")
