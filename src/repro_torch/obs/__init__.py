"""Host-side telemetry: the console, histograms and phase spans; the
JSONL sinks, metric buffers and profiler hooks arrive with the
observability slice."""
from repro_torch.obs.console import Console
from repro_torch.obs.hist import FixedHistogram, log_edges
from repro_torch.obs.spans import SpanClock

__all__ = ["Console", "FixedHistogram", "SpanClock", "log_edges"]
