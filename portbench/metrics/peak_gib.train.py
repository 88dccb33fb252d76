"""peak_gib.train: the allocator's peak of device memory over the
window (`torch.cuda.max_memory_allocated`), in GiB."""

from portbench.yardstick.readers import peak_gib as read  # noqa: F401
