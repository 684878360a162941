"""Streaming observability for the data plane (DESIGN.md §11), torch port.

Three layers, each usable alone:

* ``stream``  — ``TelemetryStream``, the bounded in-process event bus the
  runtime publishes telemetry deltas, epoch spans, and health-lease
  transitions onto; ``attach`` wires any runtime or mesh into one.
* ``server``  — ``ObsServer``, a threaded stdlib HTTP server exposing
  live mesh state as JSON + SSE, plus the self-contained
  ``dashboard.html`` renderer.
* ``anomaly`` — ``AnomalyDetector``, rolling-window detectors over the
  delta stream that classify the active traffic regime and *propose*
  (never auto-apply) typed command epochs.

Host-side Python and NumPy only: the stream carries counters the runtime
has already copied off the device.
"""

from repro_torch.obs.anomaly import AnomalyDetector  # noqa: F401
from repro_torch.obs.spans import epoch_event, epoch_log_doc, health_event  # noqa: F401
from repro_torch.obs.stream import TelemetryStream, attach, detach  # noqa: F401
