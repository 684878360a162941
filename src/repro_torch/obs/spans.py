"""Span/trace-event model for control-plane epochs and health leases
(torch port).

An epoch's life is submit -> stage -> (barrier) -> commit | rollback.
``EpochRecord`` already timestamps the endpoints: ``submitted_s`` at
submit, ``apply_latency_us`` submit->effective, ``apply_us`` for the
stage+apply window alone.  ``epoch_event`` folds those into a span dict
(queued time = latency - apply) suitable for a timeline renderer, and
``health_event`` does the same for ``HealthMonitor`` transitions.

``epoch_log_doc`` is the ONE serializer for the machine-readable epoch
log — the ``/epochs`` API endpoint and any file export call it, so the
wire formats cannot drift apart.
"""

from __future__ import annotations

from repro_torch.control.plane import API_VERSION, EpochRecord


def epoch_event(rec: EpochRecord) -> dict:
    """One epoch record as a stream event with an embedded span."""
    doc = rec.as_dict()
    queued_us = None
    if rec.apply_latency_us is not None and rec.apply_us is not None:
        queued_us = max(0.0, rec.apply_latency_us - rec.apply_us)
    doc.update({
        "kind": "epoch",
        "span": {
            "submitted_s": rec.submitted_s,
            # time spent queued waiting for a quiescent tick boundary
            # (and, on meshes, for the cross-host barrier)
            "queued_us": queued_us,
            "apply_us": rec.apply_us,
            "total_us": rec.apply_latency_us,
            "outcome": rec.commit_mode,
        },
    })
    return doc


def health_event(tr) -> dict:
    """One ``HealthMonitor`` transition as a stream event."""
    return {"kind": "health", **tr.as_dict()}


def epoch_log_doc(runtime) -> dict:
    """The full machine-readable epoch log for ``runtime`` (single-host
    or mesh): per-epoch spans, commit-mode counts, continuity audit,
    health transitions, and injected fault events when present."""
    control = runtime.control
    doc = {
        "api_version": API_VERSION,
        "epochs": [epoch_event(rec) for rec in control.log],
        "stats": control.stats(),
        "continuity": control.continuity_audit(),
    }
    health = getattr(runtime, "health", None)
    if health is not None:
        doc["health"] = health.snapshot()  # states + transitions
    faults = getattr(runtime, "_faults", None)
    if faults is not None and getattr(faults, "events", None):
        doc["fault_events"] = [dict(e) for e in faults.events]
    deploy = getattr(runtime, "deploy_log", None)
    if deploy:
        # deployment decision trail (repro_torch.deploy): canary start,
        # promote and rollback, retrain triggers, auto-remediation actions,
        # each tied to its typed epoch id in "epochs" above
        doc["deployments"] = [dict(d) for d in deploy]
    return doc
