"""Structured telemetry (port of ``repro.obs``): device-side metric
buffers, phase spans, the ``obs/v1`` JSONL sinks, profiler windows and
their summaries.  See ``docs/observability.md`` for the schema and the
contract that metrics do not perturb training."""
from repro_torch.obs.console import Console, fmt_metrics
from repro_torch.obs.hist import LATENCY_EDGES_S, FixedHistogram, log_edges
from repro_torch.obs.metrics import (MetricSpec, counter_add, flush,
                                     gauge_max, gauge_set, hist_observe)
from repro_torch.obs.profiler import ProfileWindow
from repro_torch.obs.runlog import RunTelemetry
from repro_torch.obs.sink import (KINDS, SCHEMA, JsonlSink, iter_records,
                                  read_records, validate_record)
from repro_torch.obs.spans import SERVE_PHASES, TRAIN_PHASES, SpanClock
from repro_torch.obs.summary import render, summarize, summarize_file

__all__ = ["KINDS", "LATENCY_EDGES_S", "SCHEMA", "SERVE_PHASES",
           "TRAIN_PHASES", "Console", "FixedHistogram", "JsonlSink",
           "MetricSpec", "ProfileWindow", "RunTelemetry", "SpanClock",
           "counter_add", "flush", "fmt_metrics", "gauge_max", "gauge_set",
           "hist_observe", "iter_records", "log_edges", "read_records",
           "render", "summarize", "summarize_file", "validate_record"]
