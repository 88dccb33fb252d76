"""mfu.embed_b32: the window's model FLOPs (from shapes, remat recompute not
counted) over its host-clock time and the H100's bf16 peak, in %."""

from portbench.yardstick.readers import mfu as read  # noqa: F401
