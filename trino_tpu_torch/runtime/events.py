"""Query event listeners (reference: spi/eventlistener/EventListener +
eventlistener/EventListenerManager — plugins receive query created/completed
events; ours are plain callables)."""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Optional

__all__ = ["QueryEvent", "EventListenerManager"]


@dataclass(frozen=True)
class QueryEvent:
    kind: str  # "created" | "completed" | "failed" | "resumed"
    query_id: str
    sql: str
    wall_s: float = 0.0
    rows: int = 0
    error: Optional[str] = None
    # resource accounting (reference: QueryStatistics on QueryCompletedEvent):
    # cpu_ms sums task wall time across the cluster (> wall_s when stages
    # overlap), peak_memory_bytes is the largest per-task output footprint
    cpu_ms: float = 0.0
    peak_memory_bytes: int = 0
    stage_count: int = 0
    ts: float = field(default_factory=time.time)


class EventListenerManager:
    def __init__(self) -> None:
        self._listeners: list[Callable[[QueryEvent], None]] = []

    def add(self, listener: Callable[[QueryEvent], None]) -> None:
        self._listeners.append(listener)

    def fire(self, event: QueryEvent) -> None:
        for fn in self._listeners:
            try:
                fn(event)
            except Exception:  # a listener must never kill the query path
                traceback.print_exc()
