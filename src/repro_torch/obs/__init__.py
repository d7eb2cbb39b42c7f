"""Host-side telemetry the serving engine needs; the JSONL sinks, metric
buffers and profiler hooks arrive with the observability slice."""
from repro_torch.obs.hist import FixedHistogram, log_edges
from repro_torch.obs.spans import SpanClock

__all__ = ["FixedHistogram", "SpanClock", "log_edges"]
