"""mfu.serve: the model FLOPs of the requests served in the window (their
real rows, not the padding) over the summed wall time of the batches
that served them (each from its forward's start to its last answer),
and the H100's bf16 peak, in %."""

from portbench.yardstick.readers import mfu as read  # noqa: F401
