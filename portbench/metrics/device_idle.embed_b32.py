"""device_idle.embed_b32: the share of the traced slice in which no operation
ran on the device, in %."""

from portbench.yardstick.readers import device_idle as read  # noqa: F401
