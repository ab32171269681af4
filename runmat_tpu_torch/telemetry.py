"""Copy of runmat_tpu/telemetry.py in the PyTorch port.

Tracing spans + execution/provider telemetry + OTLP export.

Reference parity: runmat-logging (tracing subscriber with EnvFilter +
optional OTLP span export, crates/runmat-logging/src/lib.rs:1-40; spans like
runtime.execute / runtime.lower / fusion.execute), runmat-telemetry
(consent-gated product events `runtime.run.started/finished` with provider
telemetry attached, src/lib.rs:1-40) and ProviderTelemetry
(runmat-accelerate-api/src/lib.rs:1337-1376 — dispatch counts,
upload/download bytes, cache hit/miss, bounded kernel-launch log), surfaced
by `accel-info --json`.

Zero-egress design: OTLP spans serialize to the standard OTLP/JSON shape but
sink to a local file (RUNMAT_TPU_OTLP_FILE) — any collector can tail it;
product telemetry writes local JSONL instead of shipping events.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import secrets
import time
from typing import Any, Optional

_SPANS: list[dict] = []          # bounded ring of recent finished spans
_MAX_SPANS = 512
_ENABLED = os.environ.get("RUNMAT_TPU_TRACE") == "1" or \
    bool(os.environ.get("RUNMAT_TPU_OTLP_FILE"))

# W3C-style trace context: spans nest via a contextvar so OTLP parent ids
# reconstruct the call tree
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "runmat_span", default=None)   # (trace_id, span_id) | None


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


@contextlib.contextmanager
def span(name: str, **attrs):
    """Timing span (≙ tracing span). Cheap no-op unless tracing is enabled.
    Records start/end wall-clock ns + trace/parent ids for OTLP export."""
    if not _ENABLED:
        yield
        return
    parent = _CURRENT.get()
    trace_id = parent[0] if parent else secrets.token_hex(16)
    span_id = secrets.token_hex(8)
    token = _CURRENT.set((trace_id, span_id))
    start_ns = time.time_ns()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _CURRENT.reset(token)
        rec = {"span": name, "ms": (time.perf_counter() - t0) * 1e3,
               "trace_id": trace_id, "span_id": span_id,
               "parent_id": parent[1] if parent else None,
               "start_ns": start_ns, "end_ns": time.time_ns(), **attrs}
        _SPANS.append(rec)
        if len(_SPANS) > _MAX_SPANS:
            del _SPANS[:len(_SPANS) - _MAX_SPANS]
        sink = os.environ.get("RUNMAT_TPU_OTLP_FILE")
        if sink:
            try:
                with open(sink, "a") as f:
                    f.write(json.dumps(_otlp_payload([rec])) + "\n")
            except OSError:
                pass


def spans() -> list[dict]:
    return list(_SPANS)


def _otlp_payload(recs: list) -> dict:
    """Standard OTLP/JSON ExportTraceServiceRequest shape (resourceSpans ->
    scopeSpans -> spans), consumable by any OpenTelemetry collector."""
    def _attr(k, v):
        if isinstance(v, bool):
            return {"key": k, "value": {"boolValue": v}}
        if isinstance(v, (int,)):
            return {"key": k, "value": {"intValue": str(v)}}
        if isinstance(v, float):
            return {"key": k, "value": {"doubleValue": v}}
        return {"key": k, "value": {"stringValue": str(v)}}

    out_spans = []
    for r in recs:
        skip = {"span", "ms", "trace_id", "span_id", "parent_id",
                "start_ns", "end_ns"}
        sp = {
            "traceId": r["trace_id"],
            "spanId": r["span_id"],
            "name": r["span"],
            "kind": 1,   # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(r["start_ns"]),
            "endTimeUnixNano": str(r["end_ns"]),
            "attributes": [_attr(k, v) for k, v in r.items()
                           if k not in skip],
        }
        if r.get("parent_id"):
            sp["parentSpanId"] = r["parent_id"]
        out_spans.append(sp)
    return {"resourceSpans": [{
        "resource": {"attributes": [
            _attr("service.name", "runmat-tpu"),
            _attr("telemetry.sdk.language", "python")]},
        "scopeSpans": [{"scope": {"name": "runmat_tpu"},
                        "spans": out_spans}],
    }]}


def export_otlp(path: str) -> int:
    """Write every buffered span as one OTLP/JSON request; returns count."""
    recs = spans()
    if recs:
        with open(path, "a") as f:
            f.write(json.dumps(_otlp_payload(recs)) + "\n")
    return len(recs)


# --------------------------------------------------------------------------- #
# structured log subscriber with EnvFilter semantics (≙ runmat-logging)
# --------------------------------------------------------------------------- #

class _JsonFormatter(logging.Formatter):
    def format(self, record):
        rec = {"ts": record.created, "level": record.levelname.lower(),
               "target": record.name, "message": record.getMessage()}
        return json.dumps(rec)


def init_logging(filter_spec: str | None = None,
                 json_format: bool | None = None) -> None:
    """Configure the runmat_tpu logger tree from an EnvFilter-style spec:
    `RUNMAT_TPU_LOG="info,runmat_tpu.accel=debug"` — a default level plus
    per-target overrides. `RUNMAT_TPU_LOG_FORMAT=json` emits one JSON
    record per line (the host-consumable stream the reference's subscriber
    produces)."""
    spec = filter_spec if filter_spec is not None else \
        os.environ.get("RUNMAT_TPU_LOG", "warning")
    as_json = json_format if json_format is not None else \
        os.environ.get("RUNMAT_TPU_LOG_FORMAT") == "json"
    root = logging.getLogger("runmat_tpu")
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler()
    handler.setFormatter(_JsonFormatter() if as_json else logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    root.addHandler(handler)
    root.propagate = False
    default = "warning"
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            target, _, level = part.partition("=")
            logging.getLogger(target.strip()).setLevel(
                getattr(logging, level.strip().upper(), logging.WARNING))
        else:
            default = part
    root.setLevel(getattr(logging, default.upper(), logging.WARNING))


def logger(target: str = "runmat_tpu") -> logging.Logger:
    return logging.getLogger(target)


def snapshot(session=None) -> dict:
    """Full telemetry snapshot (≙ ProviderTelemetry + ExecutionStats)."""
    out: dict[str, Any] = {"spans": len(_SPANS)}
    from .accel import active_engine
    eng = active_engine()
    if eng is not None:
        out["provider"] = {
            "platform": eng.platform,
            "device": str(getattr(eng.device, "device_kind", eng.device)),
            **eng.stats,
        }
        # live HBM accounting + per-category dispatch stats + bounded
        # kernel-launch log (api lib.rs:1337-1376 parity)
        out["memory"] = eng.memory_info()
        out["residency"] = eng.residency.snapshot()
        out["categories"] = {
            k: {"dispatches": v[0], "enqueue_ms": round(v[1], 3)}
            for k, v in sorted(eng.category_stats.items())}
        out["launches"] = list(eng.launch_log)
    if session is not None:
        out["session"] = {
            "workspace_vars": len(session.base_frame.vars),
            "functions": len(session.functions),
            "classes": len(session.classes),
            "rng_counter": session.rng.counter,
        }
    return out


class EventLog:
    """Consent-gated product telemetry -> local JSONL (zero-egress build)."""

    def __init__(self, path: Optional[str], enabled: bool):
        self.path = path
        self.enabled = enabled and path is not None

    def emit(self, event: str, **attrs) -> None:
        if not self.enabled:
            return
        rec = {"event": event, "ts": time.time(), **attrs}
        try:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            pass
