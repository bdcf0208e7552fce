"""Online inference serving (port of the reference `serve/`): admission
queue -> continuous batcher -> bucketed engine on one device."""

from dist_mnist_tpu_torch.serve.admission import (
    DeadlineExceededError,
    InferenceResult,
    QueueFullError,
    ShuttingDownError,
)
from dist_mnist_tpu_torch.serve.engine import InferenceEngine
from dist_mnist_tpu_torch.serve.loader import (
    ServingBundle,
    load_for_serving,
    quantize_for_serving,
)
from dist_mnist_tpu_torch.serve.loadgen import make_images, run_loadgen
from dist_mnist_tpu_torch.serve.metrics import ServeMetrics
from dist_mnist_tpu_torch.serve.server import InferenceServer, ServeConfig

__all__ = [
    "DeadlineExceededError",
    "InferenceEngine",
    "InferenceResult",
    "InferenceServer",
    "QueueFullError",
    "ServeConfig",
    "ServeMetrics",
    "ServingBundle",
    "ShuttingDownError",
    "load_for_serving",
    "make_images",
    "quantize_for_serving",
    "run_loadgen",
]
