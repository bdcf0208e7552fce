"""Observability: metric writers (tf.summary / SummaryWriterCache analogue,
SURVEY.md §5.5), chrome-trace export (client/timeline.py analogue, §5.1),
and the live telemetry spine — streaming histograms, in-process metric
registry, /metrics + /healthz exposition, the structured run journal, the
fleet scraper and anomaly detection (the reference package's exports)."""

from dist_mnist_tpu_torch.obs.writers import (
    MetricWriter,
    StdoutWriter,
    CsvWriter,
    TensorBoardWriter,
    MultiWriter,
    make_default_writer,
)
from dist_mnist_tpu_torch.obs.timeline import (
    latest_trace,
    export_chrome_trace,
    summarize_trace,
)
from dist_mnist_tpu_torch.obs.hist import StreamingHistogram
from dist_mnist_tpu_torch.obs.registry import MetricRegistry, RegistryWriter
from dist_mnist_tpu_torch.obs.exporter import HealthState, MetricsExporter
from dist_mnist_tpu_torch.obs.events import RunJournal
from dist_mnist_tpu_torch.obs.fleet import FleetScraper, parse_prometheus
from dist_mnist_tpu_torch.obs.anomaly import AnomalyHook, RobustDetector

__all__ = [
    "MetricWriter",
    "StdoutWriter",
    "CsvWriter",
    "TensorBoardWriter",
    "MultiWriter",
    "make_default_writer",
    "latest_trace",
    "export_chrome_trace",
    "summarize_trace",
    "StreamingHistogram",
    "MetricRegistry",
    "RegistryWriter",
    "HealthState",
    "MetricsExporter",
    "RunJournal",
    "FleetScraper",
    "parse_prometheus",
    "AnomalyHook",
    "RobustDetector",
]
