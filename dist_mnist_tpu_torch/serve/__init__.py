"""Online inference serving (port of the reference `serve/`): admission
queue -> continuous batcher -> (batch, height) grid engine on one device
for the classifiers (`serve/zoo.py` plans the height buckets);
prefill/decode engine + continuous-batching scheduler for the causal LM
(`serve/decode.py`)."""

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
    make_varlen_images,
    run_decode_loadgen,
    run_loadgen,
    run_longctx_loadgen,
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
    SeqGrid,
    build_decode_engine,
    build_zoo_engine,
    default_decode_grid,
    default_seq_grid,
    parse_seq_buckets,
    per_device_state_bytes,
    supports_mask,
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
    "SeqGrid",
    "ServeConfig",
    "ServeMetrics",
    "ServingBundle",
    "ShuttingDownError",
    "build_decode_engine",
    "build_zoo_engine",
    "default_decode_grid",
    "default_seq_grid",
    "init_lm_for_serving",
    "load_for_serving",
    "make_images",
    "make_prompts",
    "make_varlen_images",
    "parse_seq_buckets",
    "per_device_state_bytes",
    "quantize_for_serving",
    "run_decode_loadgen",
    "run_loadgen",
    "run_longctx_loadgen",
    "supports_mask",
]
