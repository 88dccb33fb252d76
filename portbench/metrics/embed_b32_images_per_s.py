"""embed_b32_images_per_s: images embedded over the window's host-clock
time, in the ViT-B/32 sweep."""

from portbench.yardstick.readers import rate as read  # noqa: F401
