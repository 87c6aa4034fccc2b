"""The port's copied front end (lexer, parser, planner, optimizer, serde)
plans every TPC-H query exactly as the reference does."""

import numpy as np
import pytest

from tests.tpch_queries import QUERIES


@pytest.fixture(scope="module")
def planners(tpch_tiny):
    try:  # arrow before torch (see test_torch_dec128)
        import pyarrow  # noqa: F401
    except ImportError:
        pass
    import torch

    torch.set_num_threads(1)
    from trino_tpu.connectors.tpch import TpchConnector as RefConn
    from trino_tpu.runtime.engine import Engine as RefEngine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.runtime.engine import Engine

    ref = RefEngine()
    ref.register_catalog("tpch", RefConn(0.01))
    port = Engine(device="cpu")
    port.register_catalog("tpch", TpchConnector(0.01))
    return ref, port


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_plan_json_equals_reference(name, planners):
    from trino_tpu.plan import serde as ref_serde
    from trino_tpu_torch.plan import serde as port_serde

    ref, port = planners
    want = ref_serde.plan_to_json(ref.plan(QUERIES[name]))
    got = port_serde.plan_to_json(port.plan(QUERIES[name]))
    assert got == want
    if name == "q01":
        # the folded filter constant: date '1998-12-01' - interval '90' day
        assert "10471" in str(got)


def test_plan_json_round_trips_in_the_port(planners):
    from trino_tpu_torch.plan import serde

    _, port = planners
    plan = port.plan(QUERIES["q01"])
    assert serde.plan_from_json(serde.plan_to_json(plan)) == plan


def test_unported_statements_and_patterns_name_their_roadmap_item(planners):
    import torch

    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.spi import ColumnSchema
    from trino_tpu_torch.data.types import BIGINT
    from trino_tpu_torch.ops.expr import eval_expr
    from trino_tpu_torch.plan.ir import Param

    # statements run since A.9a (tests/test_torch_statements.py), the
    # prepared-statement fast path's runtime parameters since A.9b (they
    # named that item until then: a Param evaluates inside a binding
    # context); bucketed memory tables named the distributed plane (A.10)
    # until it was ported: they read one split per bucket
    from trino_tpu_torch.ops.expr import param_context

    with param_context((np.int64(7),)):
        v = eval_expr(Param(0, BIGINT), [], 3, torch.device("cpu"))
    assert v.data.tolist() == [7, 7, 7] and v.valid is None
    mem = MemoryConnector()
    mem.create_table("t", [ColumnSchema("a", BIGINT)], bucketed_by=["a"])
    assert mem.table_partitioning("t") == (("a",), 8)
    assert len(mem.get_splits("t", 2)) == 8
    # MATCH_RECOGNIZE named ROADMAP A.8b until its operator was ported: its
    # pattern now compiles to the reference's VM program
    from trino_tpu.ops.matchrec import compile_pattern as ref_compile
    from trino_tpu.sql.parser import parse as ref_parse
    from trino_tpu_torch.ops.matchrec import compile_pattern
    from trino_tpu_torch.sql.parser import parse

    sql = ("select * from t match_recognize (order by ts measures first(a.ts) as f "
           "one row per match pattern (a+? (b | c){1,3} d*) define a as x > 0)")
    got = compile_pattern(parse(sql).select.relations[0].pattern)
    want = ref_compile(ref_parse(sql).select.relations[0].pattern)
    assert got == want and got[1] == ("a", "b", "c", "d")
