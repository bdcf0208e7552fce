"""Online inference serving (port of the reference `serve/`): admission
queue -> continuous batcher -> bucketed engine on one device for the
classifiers; prefill/decode engine + continuous-batching scheduler for
the causal LM (`serve/decode.py`)."""

from dist_mnist_tpu_torch.serve.admission import (
    DeadlineExceededError,
    InferenceResult,
    QueueFullError,
    ShuttingDownError,
)
from dist_mnist_tpu_torch.serve.decode import (
    DecodeEngine,
    DecodeResult,
    DecodeScheduler,
)
from dist_mnist_tpu_torch.serve.engine import InferenceEngine
from dist_mnist_tpu_torch.serve.loader import (
    ServingBundle,
    init_lm_for_serving,
    load_for_serving,
    quantize_for_serving,
)
from dist_mnist_tpu_torch.serve.loadgen import (
    make_images,
    make_prompts,
    run_decode_loadgen,
    run_loadgen,
)
from dist_mnist_tpu_torch.serve.metrics import DecodeMetrics, ServeMetrics
from dist_mnist_tpu_torch.serve.router import (
    BEST_EFFORT,
    DECODE_SLO_TARGETS,
    LATENCY_SENSITIVE,
    REQUEST_CLASSES,
)
from dist_mnist_tpu_torch.serve.server import InferenceServer, ServeConfig
from dist_mnist_tpu_torch.serve.zoo import (
    DecodeGrid,
    build_decode_engine,
    default_decode_grid,
)

__all__ = [
    "BEST_EFFORT",
    "DECODE_SLO_TARGETS",
    "DeadlineExceededError",
    "DecodeEngine",
    "DecodeGrid",
    "DecodeMetrics",
    "DecodeResult",
    "DecodeScheduler",
    "InferenceEngine",
    "InferenceResult",
    "InferenceServer",
    "LATENCY_SENSITIVE",
    "QueueFullError",
    "REQUEST_CLASSES",
    "ServeConfig",
    "ServeMetrics",
    "ServingBundle",
    "ShuttingDownError",
    "build_decode_engine",
    "default_decode_grid",
    "init_lm_for_serving",
    "load_for_serving",
    "make_images",
    "make_prompts",
    "quantize_for_serving",
    "run_decode_loadgen",
    "run_loadgen",
]
