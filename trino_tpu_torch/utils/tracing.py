"""Tracing spans (reference: OpenTelemetry threaded through the engine —
74 files import io.opentelemetry; spans for planning
(SqlQueryExecution.java:473 tracer.spanBuilder("planner")), fragmenting,
per-task/per-split execution, keyed by tracing/TrinoAttributes.java:29-56).

Zero-dependency equivalent: a Tracer produces nested Spans (thread-local
context stack), records wall time + attributes, and hands finished root
spans to exporters.  The engine opens query/plan/execute spans
(runtime/engine.py); anything can add children via `tracer.span(...)`.

Distributed propagation (reference: the W3C TraceContext propagator the
engine installs for task HTTP calls): every span carries a 128-bit trace_id
and 64-bit span_id; `traceparent(span)` encodes the standard
`00-{trace}-{span}-01` header, the coordinator injects it into task POSTs,
and a worker joins the remote trace via `tracer.join(header)` so its task
spans share the coordinator's trace_id (scripts/trace_dump.py stitches the
JSONL export back into one flame summary per query).
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

__all__ = [
    "Span", "Tracer", "InMemorySpanExporter", "JsonlSpanExporter",
    "traceparent", "parse_traceparent", "add_exporters_from_env",
]

_ids = random.Random()  # module-level; reseeded after fork (below)
_ids_lock = threading.Lock()


def _reseed_ids() -> None:
    """Forked children inherit the parent's RNG state byte-for-byte, so two
    workers forked from one warm parent would mint IDENTICAL trace/span ids
    and trace_dump.py would stitch unrelated queries together.  Reseed from
    the kernel CSPRNG (plus the pid, in case urandom is exhausted) in every
    child."""
    with _ids_lock:
        _ids.seed(int.from_bytes(os.urandom(16), "big") ^ os.getpid())


if hasattr(os, "register_at_fork"):  # absent on some non-POSIX platforms
    os.register_at_fork(after_in_child=_reseed_ids)


def _new_trace_id() -> str:
    with _ids_lock:
        return f"{_ids.getrandbits(128):032x}"


def _new_span_id() -> str:
    with _ids_lock:
        return f"{_ids.getrandbits(64):016x}"


@dataclass
class Span:
    name: str
    attributes: dict = field(default_factory=dict)
    start_s: float = 0.0
    end_s: float = 0.0
    children: list = field(default_factory=list)
    trace_id: str = ""
    span_id: str = ""
    parent_id: str = ""  # remote or local parent span id ("" == root)

    @property
    def duration_ms(self) -> float:
        return (self.end_s - self.start_s) * 1e3

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "attributes": dict(self.attributes),
            "duration_ms": round(self.duration_ms, 3),
            "children": [c.to_dict() for c in self.children],
        }

    def to_export_dict(self) -> dict:
        """Wire/export form: trace identity at EVERY level, not just the
        root — a worker task span's parent may be a nested coordinator
        span, and trace_dump.py can only stitch to ids it can see."""
        return {
            "name": self.name,
            "attributes": dict(self.attributes),
            "duration_ms": round(self.duration_ms, 3),
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "children": [c.to_export_dict() for c in self.children],
        }

    def find(self, name: str) -> Optional["Span"]:
        if self.name == name:
            return self
        for c in self.children:
            hit = c.find(name)
            if hit is not None:
                return hit
        return None


def traceparent(span: Span) -> str:
    """W3C trace-context header for `span` (version 00, sampled)."""
    return f"00-{span.trace_id}-{span.span_id}-01"


def parse_traceparent(header: str) -> Optional[tuple[str, str]]:
    """-> (trace_id, parent_span_id), or None on malformed input."""
    try:
        parts = header.strip().split("-")
        if len(parts) != 4:
            return None
        _version, trace_id, span_id, _flags = parts
        if len(trace_id) != 32 or len(span_id) != 16:
            return None
        int(trace_id, 16), int(span_id, 16)  # hex-validate
        return trace_id, span_id
    except (ValueError, AttributeError):
        return None


class _Ctx(threading.local):
    def __init__(self):
        self.stack: list[Span] = []
        # remote parent joined via traceparent: (trace_id, span_id); consumed
        # by the next root span opened on this thread
        self.remote: Optional[tuple[str, str]] = None


class Tracer:
    """`with tracer.span("planner", query_id=qid): ...` — nested spans build
    a tree; when the outermost span closes it goes to every exporter.

    Exporter registration and dispatch are lock-guarded: worker task threads
    and the coordinator poll loop export concurrently."""

    def __init__(self) -> None:
        self._ctx = _Ctx()
        self._exporters: list[Callable[[Span], None]] = []
        self._lock = threading.Lock()

    def add_exporter(self, exporter: Callable[[Span], None]) -> None:
        with self._lock:
            self._exporters.append(exporter)

    def span(self, name: str, **attributes):
        return _SpanCm(self, name, attributes)

    def current(self) -> Optional[Span]:
        return self._ctx.stack[-1] if self._ctx.stack else None

    def annotate(self, **attributes) -> None:
        cur = self.current()
        if cur is not None:
            cur.attributes.update(attributes)

    def join(self, traceparent_header: Optional[str]) -> bool:
        """Join a remote trace: the next ROOT span opened on this thread
        adopts the header's trace_id and records its span_id as parent
        (reference: W3C TraceContext extract on the worker's task
        resource).  Returns False (and joins nothing) on malformed input."""
        parsed = parse_traceparent(traceparent_header or "")
        if parsed is None:
            return False
        self._ctx.remote = parsed
        return True

    def _export(self, span: Span) -> None:
        with self._lock:
            exporters = list(self._exporters)
        for ex in exporters:
            try:
                ex(span)
            except Exception:
                pass


class _SpanCm:
    def __init__(self, tracer: Tracer, name: str, attributes: dict):
        self.tracer = tracer
        self.span = Span(name, dict(attributes))

    def __enter__(self) -> Span:
        self.span.start_s = time.perf_counter()
        ctx = self.tracer._ctx
        stack = ctx.stack
        self.span.span_id = _new_span_id()
        if stack:
            parent = stack[-1]
            self.span.trace_id = parent.trace_id
            self.span.parent_id = parent.span_id
            parent.children.append(self.span)
        elif ctx.remote is not None:
            # root span joining a remote trace (coordinator -> worker hop)
            self.span.trace_id, self.span.parent_id = ctx.remote
            ctx.remote = None
        else:
            self.span.trace_id = _new_trace_id()
        stack.append(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        self.span.end_s = time.perf_counter()
        if exc is not None:
            self.span.attributes["error"] = repr(exc)
        stack = self.tracer._ctx.stack
        stack.pop()
        if not stack:  # root closed: export the finished trace
            self.tracer._export(self.span)


class InMemorySpanExporter:
    """Test/debug exporter (reference: TestingTelemetry span capture).
    Thread-safe: concurrent task threads append under a lock."""

    def __init__(self) -> None:
        self.traces: list[Span] = []
        self._lock = threading.Lock()

    def __call__(self, span: Span) -> None:
        with self._lock:
            self.traces.append(span)

    def snapshot(self) -> list[Span]:
        with self._lock:
            return list(self.traces)


class JsonlSpanExporter:
    """One JSON line per finished root span, appended to `path`.  Multiple
    processes/components can share the file (O_APPEND line writes);
    scripts/trace_dump.py groups lines by trace_id into per-query flame
    summaries.  Enabled fleet-wide via TRINO_TPU_TRACE_FILE (see
    add_exporters_from_env)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def __call__(self, span: Span) -> None:
        line = json.dumps(
            dict(span.to_export_dict(), ts=time.time()), default=str
        )
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line + "\n")


def add_exporters_from_env(tracer: Tracer) -> Optional[JsonlSpanExporter]:
    """Attach the JSONL file exporter when TRINO_TPU_TRACE_FILE is set —
    Engine, Coordinator and Worker all call this at construction, so one
    env var lights up the whole fleet's trace export."""
    path = os.environ.get("TRINO_TPU_TRACE_FILE")
    if not path:
        return None
    exporter = JsonlSpanExporter(path)
    tracer.add_exporter(exporter)
    return exporter
