"""MATCH_RECOGNIZE pattern compiler — not ported yet.

The planner imports `compile_pattern` lazily when a query uses
MATCH_RECOGNIZE; until the row-pattern operator is ported (ROADMAP A.8b)
that import resolves here and fails loudly.
"""

from __future__ import annotations

__all__ = ["compile_pattern"]


def compile_pattern(*args, **kwargs):
    raise NotImplementedError(
        "MATCH_RECOGNIZE is not ported to trino_tpu_torch yet (ROADMAP A.8b)"
    )
