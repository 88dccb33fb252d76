"""train_images_per_s: views through whole train steps over the
window's host-clock time."""

from portbench.yardstick.readers import rate as read  # noqa: F401
