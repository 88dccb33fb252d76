"""serve_p95_ms: the 95th percentile of every request sent in the
window, each from its due time to the moment its result is set."""

from portbench.yardstick.readers import p95_ms as read  # noqa: F401
