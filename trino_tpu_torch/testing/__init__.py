"""Test harness utilities (reference: testing/trino-testing): the
in-process cluster and its seeded chaos harness."""

from .chaos import ChaosRunner, make_chaos_cluster
from .runner import DistributedQueryRunner

__all__ = ["ChaosRunner", "DistributedQueryRunner", "make_chaos_cluster"]
