"""Online inference serving (port of the reference `serve/`): admission
queue -> continuous batcher -> (batch, height) grid engine on one device
for the classifiers (`serve/zoo.py` plans the height buckets; the
engine's `CompiledModelCache` holds the warmed cells and the serve memory
budget); prefill/decode engine + continuous-batching scheduler for the
causal LM (`serve/decode.py`); the fleet: `serve/router.py` (N replicas,
tiered shedding, failover, hedging, hot weight swap), the trace and
fleet load generators, and `serve/autoscale.py` (the replica count as a
control variable)."""

from dist_mnist_tpu_torch.serve.admission import (
    DeadlineExceededError,
    InferenceResult,
    QueueFullError,
    ShuttingDownError,
)
from dist_mnist_tpu_torch.serve.autoscale import (
    Autoscaler,
    Decision,
    FleetSignals,
    FleetSignalSource,
    PolicyState,
    ScalePolicy,
)
from dist_mnist_tpu_torch.serve.decode import (
    DecodeEngine,
    DecodeResult,
    DecodeScheduler,
)
from dist_mnist_tpu_torch.serve.engine import (
    CompiledModelCache,
    InferenceEngine,
    ServeMemoryBudgetError,
)
from dist_mnist_tpu_torch.serve.errors import (
    AllReplicasDownError,
    ReplicaKilledError,
    ShedError,
    classify_failure,
)
from dist_mnist_tpu_torch.serve.loader import (
    ServingBundle,
    init_lm_for_serving,
    load_for_serving,
    quantize_for_serving,
)
from dist_mnist_tpu_torch.serve.loadgen import (
    burst_trace,
    diurnal_trace,
    flash_crowd_trace,
    make_images,
    make_prompts,
    make_varlen_images,
    run_decode_loadgen,
    run_fleet_loadgen,
    run_loadgen,
    run_longctx_loadgen,
    run_trace_loadgen,
)
from dist_mnist_tpu_torch.serve.metrics import DecodeMetrics, ServeMetrics
from dist_mnist_tpu_torch.serve.router import (
    BEST_EFFORT,
    DECODE_SLO_TARGETS,
    LATENCY_SENSITIVE,
    REQUEST_CLASSES,
    CheckpointWatcher,
    HttpReplica,
    InProcessReplica,
    Router,
    RouterConfig,
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
    "AllReplicasDownError",
    "Autoscaler",
    "BEST_EFFORT",
    "CheckpointWatcher",
    "CompiledModelCache",
    "DECODE_SLO_TARGETS",
    "DeadlineExceededError",
    "Decision",
    "DecodeEngine",
    "DecodeGrid",
    "DecodeMetrics",
    "DecodeResult",
    "DecodeScheduler",
    "FleetSignalSource",
    "FleetSignals",
    "HttpReplica",
    "InProcessReplica",
    "InferenceEngine",
    "InferenceResult",
    "InferenceServer",
    "LATENCY_SENSITIVE",
    "PolicyState",
    "QueueFullError",
    "REQUEST_CLASSES",
    "ReplicaKilledError",
    "Router",
    "RouterConfig",
    "ScalePolicy",
    "SeqGrid",
    "ServeConfig",
    "ServeMemoryBudgetError",
    "ServeMetrics",
    "ServingBundle",
    "ShedError",
    "ShuttingDownError",
    "build_decode_engine",
    "build_zoo_engine",
    "burst_trace",
    "classify_failure",
    "default_decode_grid",
    "default_seq_grid",
    "diurnal_trace",
    "flash_crowd_trace",
    "init_lm_for_serving",
    "load_for_serving",
    "make_images",
    "make_prompts",
    "make_varlen_images",
    "parse_seq_buckets",
    "per_device_state_bytes",
    "quantize_for_serving",
    "run_decode_loadgen",
    "run_fleet_loadgen",
    "run_loadgen",
    "run_longctx_loadgen",
    "run_trace_loadgen",
    "supports_mask",
]
