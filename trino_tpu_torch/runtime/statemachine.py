"""Query lifecycle state machine.

Reference: execution/QueryStateMachine.java (1776 lines) driving
QueryState.java:21-58 (QUEUED -> WAITING_FOR_RESOURCES -> DISPATCHING ->
PLANNING -> STARTING -> RUNNING -> FINISHING -> FINISHED | FAILED) over the
generic listener-based StateMachine.java:43.  Same contract: monotone
transitions, terminal states absorb, listeners fire outside the lock.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

__all__ = ["QueryState", "QueryStateMachine", "STATES"]

STATES = [
    "QUEUED", "PLANNING", "STARTING", "RUNNING", "FINISHING",
    "FINISHED", "FAILED", "CANCELED",
]
_ORDER = {s: i for i, s in enumerate(STATES)}
TERMINAL = {"FINISHED", "FAILED", "CANCELED"}


class QueryState:
    pass


class QueryStateMachine:
    def __init__(self, query_id: str):
        self.query_id = query_id
        self._state = "QUEUED"
        self._lock = threading.Lock()
        self._listeners: list[Callable[[str], None]] = []
        self.error: Optional[str] = None
        # typed failure reason (reference: ErrorCode on QueryInfo — e.g.
        # EXCEEDED_TIME_LIMIT, EXCEEDED_QUEUED_TIME_LIMIT, NO_PROGRESS);
        # surfaced to the client alongside the message
        self.error_code: Optional[str] = None
        self.created_at = time.time()
        self.finished_at: Optional[float] = None
        self.state_changed_at = self.created_at  # /ui "in state for" column
        # entry timestamp per visited state, in visit order — the raw
        # material of the phase ledger (reference: QueryStateTimer's
        # elapsed/planning/execution durations on QueryStats)
        self.state_history: list[tuple[str, float]] = [
            ("QUEUED", self.created_at)
        ]

    @property
    def state(self) -> str:
        return self._state

    @property
    def done(self) -> bool:
        return self._state in TERMINAL

    def add_listener(self, fn: Callable[[str], None]) -> None:
        with self._lock:
            self._listeners.append(fn)
            current = self._state
        fn(current)

    def transition(self, new_state: str) -> bool:
        """Monotone transition; returns False if not applied (terminal or
        backwards)."""
        with self._lock:
            if self._state in TERMINAL:
                return False
            if _ORDER[new_state] <= _ORDER[self._state] and new_state not in TERMINAL:
                return False
            self._state = new_state
            self.state_changed_at = time.time()
            self.state_history.append((new_state, self.state_changed_at))
            if new_state in TERMINAL:
                self.finished_at = time.time()
            listeners = list(self._listeners)
        for fn in listeners:  # outside the lock (reference: StateMachine.java)
            fn(new_state)
        return True

    def phase_seconds(self) -> dict[str, float]:
        """Wall seconds spent in each visited non-terminal state; an
        unfinished query's current state accrues up to now."""
        with self._lock:
            history = list(self.state_history)
            end = self.finished_at
        if end is None:
            end = time.time()
        out: dict[str, float] = {}
        for i, (state, entered) in enumerate(history):
            if state in TERMINAL:
                continue
            left = history[i + 1][1] if i + 1 < len(history) else end
            out[state] = out.get(state, 0.0) + max(0.0, left - entered)
        return out

    def fail(self, message: str, code: Optional[str] = None) -> None:
        self.error = message
        if code is not None:
            self.error_code = code
        self.transition("FAILED")
