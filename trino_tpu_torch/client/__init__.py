"""Client protocol library (reference: client/trino-client
StatementClientV1.java:76 — POST /v1/statement, poll nextUri)."""

from .client import QueryFailed, StatementClient

__all__ = ["StatementClient", "QueryFailed"]
