"""embed_images_per_s: images embedded over the window's host-clock
time, in the ViT-L/14-336 sweep."""

from portbench.yardstick.readers import rate as read  # noqa: F401
