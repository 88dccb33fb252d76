"""HTTP model server speaking the Chrome-extension bot protocol, its
micro-batcher and its serving artifacts."""

from pigeon_tpu_torch.serve.batching import MicroBatcher  # noqa: F401
from pigeon_tpu_torch.serve.server import (  # noqa: F401
    PredictionService,
    serve,
)
