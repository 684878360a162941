"""Live dashboard API over a running data plane (torch port; the standard
library's HTTP server).

``ObsServer`` wraps a ``ThreadingHTTPServer`` around one runtime (or
mesh) + its ``TelemetryStream``:

* ``GET /``        — the self-contained ``dashboard.html`` renderer
* ``GET /metrics`` — live per-queue pps / drops / ring depth / slot mix
  plus runtime shape, event counters, control stats, health states
* ``GET /epochs``  — the machine-readable epoch log (``spans.epoch_log_doc``,
  the one serializer of that document)
* ``GET /anomaly`` — detector classification, findings, proposed epochs
* ``GET /stream``  — Server-Sent Events tail of the telemetry stream
  (``?cursor=N`` resumes; events are the raw stream dicts)
* ``GET /healthz`` — liveness probe for smoke tests

The server threads only ever *read* run-loop state: per-queue counters
come from folding the delta stream (``_Aggregator``), never from walking
live telemetry, and the run loop never blocks on a subscriber.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from repro_torch.obs import spans
from repro_torch.obs.stream import TelemetryStream

_DASHBOARD = os.path.join(os.path.dirname(__file__), "dashboard.html")
#: wall-clock span the /metrics pps gauges average over
RATE_WINDOW_S = 2.0


def _json_default(o):
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().tolist()
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


class _Aggregator:
    """Folds the delta stream into cumulative per-queue state + a short
    rate window; consumed lazily from server threads under a lock."""

    def __init__(self, stream: TelemetryStream, *, num_queues: int,
                 queues_per_host: int, num_slots: int):
        self._stream = stream
        self._cursor = 0
        self._lock = threading.Lock()
        self.num_queues = num_queues
        self.queues_per_host = queues_per_host
        self.completed = np.zeros(num_queues, np.int64)
        self.dropped = np.zeros(num_queues, np.int64)
        self.per_slot = np.zeros((num_queues, num_slots), np.int64)
        self.actions = np.zeros((num_queues, 3), np.int64)
        self.depth = np.zeros(num_queues, np.int64)
        self.events: dict[str, int] = {}
        self.last_tick = 0
        self.epochs_seen = 0
        self.health_last: dict[int, str] = {}
        self._rate: list[tuple[float, np.ndarray]] = []  # (t_s, d_completed)

    def refresh(self) -> None:
        with self._lock:
            events, self._cursor = self._stream.tail(self._cursor,
                                                     limit=1 << 20)
            for ev in events:
                kind = ev.get("kind")
                if kind == "delta":
                    self._fold_delta(ev)
                elif kind == "epoch":
                    self.epochs_seen += 1
                elif kind == "health":
                    self.health_last[ev["host"]] = ev["to"]

    def _fold_delta(self, ev: dict) -> None:
        base = ev.get("host", 0) * self.queues_per_host
        burst = np.zeros(self.num_queues, np.int64)
        for q in ev["queues"]:
            gid = base + q["queue"]
            self.completed[gid] += q["completed"]
            self.dropped[gid] += q["dropped"]
            self.per_slot[gid] += np.asarray(q["per_slot"], np.int64)
            self.actions[gid] += np.asarray(q["actions"], np.int64)
            if "depth" in q:
                self.depth[gid] = q["depth"]
            burst[gid] = q["completed"]
        self.last_tick = max(self.last_tick, ev["tick"])
        for name, d in ev.get("events", {}).items():
            self.events[name] = self.events.get(name, 0) + d
        t = ev.get("t_s") or time.perf_counter()
        self._rate.append((t, burst))
        cutoff = t - RATE_WINDOW_S
        while len(self._rate) > 1 and self._rate[0][0] < cutoff:
            self._rate.pop(0)

    def metrics(self) -> dict:
        self.refresh()
        with self._lock:
            if len(self._rate) >= 2:
                span = max(self._rate[-1][0] - self._rate[0][0], 1e-9)
                pps = sum(b for _, b in self._rate[1:]) / span
            else:
                pps = np.zeros(self.num_queues)
            queues = []
            for gid in range(self.num_queues):
                queues.append({
                    "gid": gid,
                    "host": gid // self.queues_per_host,
                    "queue": gid % self.queues_per_host,
                    "completed": int(self.completed[gid]),
                    "dropped": int(self.dropped[gid]),
                    "depth": int(self.depth[gid]),
                    "pps": float(pps[gid]),
                    "per_slot": self.per_slot[gid].tolist(),
                    "actions": {"forward": int(self.actions[gid][0]),
                                "drop": int(self.actions[gid][1]),
                                "flag": int(self.actions[gid][2])},
                })
            slot_tot = self.per_slot.sum(axis=0)
            return {
                "tick": self.last_tick,
                "queues": queues,
                "totals": {"completed": int(self.completed.sum()),
                           "dropped": int(self.dropped.sum()),
                           "pps": float(pps.sum())},
                "slot_mix": slot_tot.tolist(),
                "events": dict(self.events),
                "epochs_seen": self.epochs_seen,
                "health": dict(self.health_last),
            }


class ObsServer:
    """Threaded HTTP observer for one runtime; start() returns at once."""

    def __init__(self, runtime, stream: TelemetryStream, *,
                 host: str = "127.0.0.1", port: int = 0, detector=None):
        self.runtime = runtime
        self.stream = stream
        self.detector = detector
        qph = getattr(runtime, "queues_per_host",
                      getattr(runtime, "num_queues_per_host",
                              runtime.num_queues))
        self.shape = {
            "hosts": getattr(runtime, "hosts", 1),
            "queues_per_host": qph,
            "num_queues": runtime.num_queues,
            "num_slots": getattr(runtime, "num_slots", None),
            "strategy": getattr(runtime, "strategy", None),
            "pipeline_depth": getattr(runtime, "pipeline_depth", None),
        }
        self.agg = _Aggregator(
            stream, num_queues=runtime.num_queues, queues_per_host=qph,
            num_slots=self.shape["num_slots"] or 1)
        self._det_lock = threading.Lock()
        self._stopping = threading.Event()
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None

    # -- endpoint payloads ---------------------------------------------------

    def metrics_doc(self) -> dict:
        doc = {"t_s": time.time(), "shape": self.shape,
               **self.agg.metrics(),
               "stream": self.stream.snapshot_stats()}
        try:
            doc["control"] = self.runtime.control.stats()
        except Exception:
            pass
        health = getattr(self.runtime, "health", None)
        if health is not None:
            try:
                doc["health_states"] = health.snapshot()["hosts"]
            except Exception:
                pass
        return doc

    def epochs_doc(self) -> dict:
        return spans.epoch_log_doc(self.runtime)

    def anomaly_doc(self) -> dict:
        if self.detector is None:
            return {"enabled": False}
        with self._det_lock:
            self.detector.poll()
            doc = self.detector.classify()
            doc.update({
                "enabled": True,
                "detect_tick": self.detector.detect_tick(),
                "findings": [f.as_dict()
                             for f in self.detector.findings[-64:]],
                "proposals": [c.describe()
                              for c in self.detector.proposals()],
            })
        return doc

    # -- plumbing ------------------------------------------------------------

    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet by default
                pass

            def _send_json(self, doc, code=200):
                body = json.dumps(doc, default=_json_default).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                try:
                    if url.path in ("/", "/dashboard", "/dashboard.html"):
                        self._send_file(_DASHBOARD, "text/html")
                    elif url.path == "/metrics":
                        self._send_json(server.metrics_doc())
                    elif url.path == "/epochs":
                        self._send_json(server.epochs_doc())
                    elif url.path == "/anomaly":
                        self._send_json(server.anomaly_doc())
                    elif url.path == "/healthz":
                        self._send_json({"ok": True, "port": server.port})
                    elif url.path == "/stream":
                        self._sse(url)
                    else:
                        self._send_json({"error": "unknown endpoint",
                                         "endpoints": ["/", "/metrics",
                                                       "/epochs", "/anomaly",
                                                       "/stream", "/healthz"]},
                                        code=404)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def _send_file(self, path, ctype):
                with open(path, "rb") as f:
                    body = f.read()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _sse(self, url):
                qs = parse_qs(url.query)
                cursor = int(qs.get("cursor", [max(
                    server.stream.next_sid - 64, 0)])[0])
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Access-Control-Allow-Origin", "*")
                self.end_headers()
                last_ping = time.monotonic()
                while not server._stopping.is_set():
                    events, cursor = server.stream.tail(cursor, limit=256)
                    for ev in events:
                        data = json.dumps(ev, default=_json_default)
                        self.wfile.write(
                            f"id: {ev['sid']}\ndata: {data}\n\n".encode())
                    if events:
                        self.wfile.flush()
                    else:
                        now = time.monotonic()
                        if now - last_ping > 2.0:
                            self.wfile.write(b": ping\n\n")
                            self.wfile.flush()
                            last_ping = now
                        time.sleep(0.05)
                self.close_connection = True

        return Handler

    def start(self) -> "ObsServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="obs-server", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopping.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
