"""Test harness utilities (reference: testing/trino-testing)."""

from .runner import DistributedQueryRunner

__all__ = ["DistributedQueryRunner"]
