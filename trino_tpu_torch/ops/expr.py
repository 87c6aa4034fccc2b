"""Expression evaluation over device pages.

This is the replacement for the reference's runtime bytecode generation
(sql/gen/ExpressionCompiler.java:38, PageFunctionCompiler.java:103): IR
expressions evaluate eagerly as vectorized torch ops over whole columns.

Value model: every IR expression evaluates to a ColumnVal
    data  : tensor [capacity]  (for VARCHAR: int32 dictionary codes)
    valid : bool mask or None (None == all valid) — SQL NULLs
    dict  : host Dictionary for VARCHAR values

NULL semantics are Kleene 3-valued logic for and/or, strict for everything
else (reference: sql/ir + interpreter semantics).

The port carries the operators the 22 TPC-H queries reach: literals
(string literals as one-entry dictionaries), field references, arithmetic
and comparisons (single-lane and decimal128), string comparisons, IN lists,
LIKE and substring through host tables over the dictionaries, CASE (numeric,
decimal128 and varchar branches), coalesce, casts between numeric types,
Kleene and/or/not, is_null, date arithmetic and field extraction.  Every
other operator raises NotImplementedError naming the ROADMAP item that ports
it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.page import Column, Dictionary
from ..data.types import BOOLEAN, DATE, Type, VARCHAR
from ..plan.ir import Call, CaseWhen, Const, FieldRef, InListIr, IrExpr, LikeIr, Param

__all__ = [
    "ColumnVal", "eval_expr", "eval_predicate", "column_val", "to_column",
    "translate_codes",
]

_NOT_PORTED = "not ported to trino_tpu_torch yet (ROADMAP A.8: remaining SQL surface)"


@dataclass
class ColumnVal:
    data: torch.Tensor
    valid: Optional[torch.Tensor]
    dict: Optional[Dictionary] = None
    type: Optional[Type] = None
    # decimal128 high limb (data/dec128.py): value = data2*2^64 + u64(data).
    # None for every non-limbed column.
    data2: Optional[torch.Tensor] = None


def column_val(col: Column) -> ColumnVal:
    return ColumnVal(col.data, col.valid, col.dictionary, col.type, col.data2)


def to_column(v: ColumnVal, type_: Type) -> Column:
    return Column(type_, v.data, v.valid, v.dict, v.data2)


def _and_valid(a: Optional[torch.Tensor], b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _torch_dtype(t: Type) -> torch.dtype:
    if t == BOOLEAN:
        return torch.bool
    return torch.from_numpy(np.zeros((0,), dtype=t.np_dtype)).dtype


def _device_of(cols: Sequence[ColumnVal], device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not cols:
        raise ValueError("eval_expr over no columns needs an explicit device")
    return cols[0].data.device


def eval_expr(e: IrExpr, cols: Sequence[ColumnVal], n: int, device=None) -> ColumnVal:
    """Evaluate IR over the input columns; n = page capacity (for consts).
    Constants are materialized on `device` (default: where the columns
    live)."""
    if isinstance(e, FieldRef):
        return cols[e.index]
    dev = _device_of(cols, device)
    if isinstance(e, Const):
        return _const_val(e, n, dev)
    if isinstance(e, Call):
        return _call(e, cols, n, dev)
    if isinstance(e, CaseWhen):
        return _case(e, cols, n, dev)
    if isinstance(e, InListIr):
        return _in_list(e, cols, n, dev)
    if isinstance(e, LikeIr):
        return _like(e, cols, n, dev)
    if isinstance(e, Param):
        raise NotImplementedError(f"{type(e).__name__} expressions are {_NOT_PORTED}")
    raise NotImplementedError(f"eval: {e}")


def eval_predicate(e: IrExpr, cols: Sequence[ColumnVal], n: int, device=None) -> torch.Tensor:
    """Boolean predicate -> selection mask (NULL -> False, the reference's
    FilterAndProject semantics)."""
    v = eval_expr(e, cols, n, device)
    m = v.data.to(torch.bool)
    if v.valid is not None:
        m = m & v.valid
    return m


# ----------------------------------------------------------------- literals


def _const_val(e: Const, n: int, dev: torch.device) -> ColumnVal:
    if e.type.is_array:
        raise NotImplementedError(f"{e.type.name} literals are {_NOT_PORTED}")
    if e.type.is_string:
        # a one-entry dictionary: comparisons against it become a host table
        # over the other side's dictionary (_string_compare); a typed NULL
        # keeps the same shape with every lane invalid
        d = Dictionary(np.asarray(["" if e.value is None else e.value], dtype=object))
        valid = None if e.value is not None else torch.zeros((n,), dtype=torch.bool, device=dev)
        return ColumnVal(torch.zeros((n,), dtype=torch.int32, device=dev), valid, d, e.type)
    if e.value is None:
        return ColumnVal(
            torch.zeros((n,), dtype=_torch_dtype(e.type), device=dev),
            torch.zeros((n,), dtype=torch.bool, device=dev),
            None,
            e.type,
        )
    if (
        e.type.is_decimal
        and isinstance(e.value, int)
        and not -(1 << 63) <= e.value < (1 << 63)
    ):
        # beyond-int64 decimal literal: two-limb lanes (data/dec128.py)
        from ..data.dec128 import split_py

        hi, lo = split_py(e.value)
        return ColumnVal(
            torch.full((n,), lo, dtype=torch.int64, device=dev), None, None, e.type,
            data2=torch.full((n,), hi, dtype=torch.int64, device=dev),
        )
    return ColumnVal(
        torch.full((n,), e.value, dtype=_torch_dtype(e.type), device=dev),
        None, None, e.type,
    )


# -------------------------------------------------------------------- calls

_COMPARE = {
    "eq": torch.eq, "ne": torch.ne, "lt": torch.lt,
    "le": torch.le, "gt": torch.gt, "ge": torch.ge,
}


def _trunc_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SQL truncating integer division (sign of the exact quotient)."""
    return torch.sign(a) * torch.sign(b) * (torch.abs(a) // torch.abs(b))


def _call(e: Call, cols: Sequence[ColumnVal], n: int, dev: torch.device) -> ColumnVal:
    op = e.op
    if op in ("and", "or"):
        return _kleene(op, e, cols, n, dev)
    if op == "not":
        a = eval_expr(e.args[0], cols, n, dev)
        return ColumnVal(~a.data.to(torch.bool), a.valid, None, BOOLEAN)
    if op == "is_null":
        a = eval_expr(e.args[0], cols, n, dev)
        data = (
            torch.zeros((n,), dtype=torch.bool, device=dev)
            if a.valid is None else ~a.valid
        )
        return ColumnVal(data, None, None, BOOLEAN)
    if op == "coalesce":
        return _coalesce(e, cols, n, dev)
    if op == "cast":
        a = eval_expr(e.args[0], cols, n, dev)
        return _cast(a, e.type, n)
    if op == "substring":
        return _substring(e, cols, n, dev)
    if op in ("extract_year", "extract_month", "extract_day"):
        a = eval_expr(e.args[0], cols, n, dev)
        y, m, d = _civil_from_days(a.data.to(torch.int64))
        out = {"extract_year": y, "extract_month": m, "extract_day": d}[op]
        return ColumnVal(out, a.valid, None, e.type)
    if op == "add_days":
        a = eval_expr(e.args[0], cols, n, dev)
        b = eval_expr(e.args[1], cols, n, dev)
        return ColumnVal(
            (a.data.to(torch.int64) + b.data.to(torch.int64)).to(a.data.dtype),
            _and_valid(a.valid, b.valid),
            None,
            DATE,
        )
    if op not in (
        "neg", "abs", "eq", "ne", "lt", "le", "gt", "ge",
        "add", "sub", "mul", "div", "mod",
    ):
        raise NotImplementedError(f"operator {op} is {_NOT_PORTED}")

    args = [eval_expr(a, cols, n, dev) for a in e.args]
    if any(v.dict is not None for v in args):
        if op in _COMPARE:
            return _string_compare(op, args)
        raise NotImplementedError(f"string {op} is {_NOT_PORTED}")

    valid = None
    for v in args:
        valid = _and_valid(valid, v.valid)

    if any(v.data2 is not None for v in args) or (
        # single-lane decimal arithmetic whose RESULT type exceeds int64
        # digits: compute at 128-bit width rather than silently wrapping
        # the int64 lanes (reference: Int128Math.multiply / add)
        op in ("add", "sub", "mul")
        and e.type.is_decimal
        and e.type.precision > 18
        and all(v.type is not None and v.type.is_decimal for v in args)
    ):
        return _limbed_op(op, args, valid, e)
    if op == "neg":
        return ColumnVal(-args[0].data, valid, None, e.type)
    if op == "abs":
        return ColumnVal(torch.abs(args[0].data), valid, None, e.type)
    if op in _COMPARE:
        a, b = _numeric_align(args[0].data, args[1].data)
        return ColumnVal(_COMPARE[op](a, b), valid, None, BOOLEAN)
    a, b = _numeric_align(args[0].data, args[1].data)
    target = _torch_dtype(e.type)
    a = a.to(target)
    b = b.to(target)
    if op == "add":
        out = a + b
    elif op == "sub":
        out = a - b
    elif op == "mul":
        out = a * b
    else:  # div / mod: a zero divisor yields NULL
        safe_b = torch.where(b == 0, torch.ones_like(b), b)
        valid = _and_valid(valid, b != 0)
        if op == "div":
            out = a / safe_b if e.type.is_floating else _trunc_div(a, safe_b).to(target)
        elif e.type.is_floating:
            out = torch.fmod(a, safe_b)
        else:  # sign of the dividend, SQL semantics
            out = a - safe_b * _trunc_div(a, safe_b).to(target)
    return ColumnVal(out, valid, None, e.type)


def _numeric_align(a: torch.Tensor, b: torch.Tensor):
    if a.dtype == b.dtype:
        return a, b
    target = torch.promote_types(a.dtype, b.dtype)
    return a.to(target), b.to(target)


def _round_div(d: torch.Tensor, div: int) -> torch.Tensor:
    """Divide by a positive power of ten, rounding half away from zero."""
    return torch.sign(d) * ((torch.abs(d) + div // 2) // div)


def _cast(a: ColumnVal, target: Type, n: int) -> ColumnVal:
    if a.type == target:
        return a
    if target == VARCHAR or a.dict is not None:
        raise NotImplementedError(f"varchar casts are {_NOT_PORTED}")
    # DECIMAL rescaling on int64 lanes (reference: spi/type/DecimalConversions
    # — rescale by powers of ten, round half away from zero when narrowing)
    if a.data2 is not None:
        if target.is_decimal and target.scale == (
            a.type.scale if a.type is not None else 0
        ):
            # precision widening at the same scale: lanes unchanged
            return ColumnVal(a.data, a.valid, None, target, data2=a.data2)
        if target.is_floating:
            # limbed decimal128 -> double.  v = lo_signed + 2^64*(hi + [lo<0])
            # — the signed-lo form avoids the catastrophic cancellation of
            # hi*2^64 + u64(lo) for small negatives
            lo = a.data.to(torch.int64)
            src_scale = a.type.scale if a.type is not None else 0
            hi_adj = a.data2 + (lo < 0).to(a.data2.dtype)
            out = (
                lo.to(torch.float64) + hi_adj.to(torch.float64) * float(2**64)
            ) / (10.0**src_scale)
            return ColumnVal(out.to(_torch_dtype(target)), a.valid, None, target)
        raise NotImplementedError(f"cast decimal128 to {target.name}")
    if target.is_decimal or (a.type is not None and a.type.is_decimal):
        src_scale = a.type.scale if (a.type is not None and a.type.is_decimal) else 0
        if target.is_decimal:
            if a.type is not None and a.type.is_floating:
                data = torch.round(a.data.to(torch.float64) * (10.0**target.scale))
                return ColumnVal(data.to(torch.int64), a.valid, None, target)
            d = a.data.to(torch.int64)
            if target.scale >= src_scale:
                out = d * (10 ** (target.scale - src_scale))
            else:
                out = _round_div(d, 10 ** (src_scale - target.scale))
            return ColumnVal(out, a.valid, None, target)
        # decimal source -> non-decimal target
        d = a.data.to(torch.int64)
        if target.is_floating:
            # a true divide by 10^scale, as the reference does: multiplying
            # by the reciprocal differs in the last ulp
            out = d.to(torch.float64) / (10.0**src_scale)
            return ColumnVal(out.to(_torch_dtype(target)), a.valid, None, target)
        out = _round_div(d, 10**src_scale)
        return ColumnVal(out.to(_torch_dtype(target)), a.valid, None, target)
    return ColumnVal(a.data.to(_torch_dtype(target)), a.valid, None, target)


def _kleene(op: str, e: Call, cols: Sequence[ColumnVal], n: int, dev) -> ColumnVal:
    a = eval_expr(e.args[0], cols, n, dev)
    b = eval_expr(e.args[1], cols, n, dev)
    ad = a.data.to(torch.bool)
    bd = b.data.to(torch.bool)
    av, bv = a.valid, b.valid
    a_true = ad if av is None else (ad & av)
    b_true = bd if bv is None else (bd & bv)
    if op == "and":
        data = a_true & b_true
        if av is None and bv is None:
            return ColumnVal(data, None, None, BOOLEAN)
        # null AND false == false (valid); null AND true == null
        a_false = (~ad) if av is None else (av & ~ad)
        b_false = (~bd) if bv is None else (bv & ~bd)
        valid = _and_valid(av, bv) | a_false | b_false
        return ColumnVal(data, valid, None, BOOLEAN)
    data = a_true | b_true
    if av is None and bv is None:
        return ColumnVal(data, None, None, BOOLEAN)
    valid = _and_valid(av, bv) | a_true | b_true
    return ColumnVal(data, valid, None, BOOLEAN)


def _case(e: CaseWhen, cols: Sequence[ColumnVal], n: int, dev) -> ColumnVal:
    """CASE WHEN: the branches evaluate over every lane and the first true
    condition selects per lane; a missing ELSE is a typed NULL.  decimal128
    branches select over both limbs (a single-lane branch such as the
    literal 0 sign-extends into limb space, `_as_limbs`); varchar branches
    are re-coded into the union of their dictionaries first."""
    if e.default is not None:
        out = eval_expr(e.default, cols, n, dev)
    else:
        out = ColumnVal(
            torch.zeros((n,), dtype=_torch_dtype(e.type), device=dev),
            torch.zeros((n,), dtype=torch.bool, device=dev),
            None,
            e.type,
        )
    evaluated = [
        (eval_expr(c, cols, n, dev), eval_expr(r, cols, n, dev)) for c, r in e.whens
    ]
    limbed = out.data2 is not None or any(r.data2 is not None for _, r in evaluated)
    if out.dict is not None or any(r.dict is not None for _, r in evaluated):
        out, *rs = _to_union_dict([out] + [r for _, r in evaluated], n, dev, e.type, "CASE")
        evaluated = [(c, r) for (c, _), r in zip(evaluated, rs)]
    out_data, out_valid, out_hi = out.data, out.valid, None
    if limbed:
        out_data, out_hi = _as_limbs(out)
    for c, r in reversed(evaluated):
        cm = c.data.to(torch.bool)
        if c.valid is not None:
            cm = cm & c.valid
        if limbed:
            rlo, rhi = _as_limbs(r)
            out_data = torch.where(cm, rlo, out_data)
            out_hi = torch.where(cm, rhi, out_hi)
        else:
            out_data = torch.where(cm, r.data.to(out_data.dtype), out_data)
        if out_valid is not None or r.valid is not None:
            ov = out_valid if out_valid is not None else torch.ones_like(cm)
            rv = r.valid if r.valid is not None else torch.ones_like(cm)
            out_valid = torch.where(cm, rv, ov)
    return ColumnVal(out_data, out_valid, out.dict, e.type, data2=out_hi)


def _coalesce(e: Call, cols: Sequence[ColumnVal], n: int, dev) -> ColumnVal:
    """First non-NULL argument per lane, merged in a dtype wide enough for
    every branch; varchar branches are re-coded into the union of their
    dictionaries first, as CASE's are."""
    vals = [eval_expr(a, cols, n, dev) for a in e.args]
    if any(v.data2 is not None for v in vals):
        raise NotImplementedError("decimal128 through coalesce")
    if any(v.dict is not None for v in vals):
        vals = _to_union_dict(vals, n, dev, e.type, "coalesce")
    out = vals[-1]
    for v in reversed(vals[:-1]):
        if v.valid is None:
            out = v
        else:
            merged = torch.promote_types(v.data.dtype, out.data.dtype)
            out = ColumnVal(
                torch.where(v.valid, v.data.to(merged), out.data.to(merged)),
                None if out.valid is None else (v.valid | out.valid),
                v.dict,
                v.type,
            )
    return out


def _to_union_dict(branches: list[ColumnVal], n: int, dev, ty, what: str) -> list[ColumnVal]:
    """Varchar branches re-coded into the union of their dictionaries, so
    that codes merged lane by lane from several branches name the right
    strings."""
    # a dictionary-less varchar branch is a NULL literal: its codes never
    # surface through its all-false validity
    if any(b.dict is None and not (b.type is None or b.type.is_string) for b in branches):
        raise NotImplementedError(f"{what} mixing varchar and non-varchar results")
    union = np.unique(np.concatenate(
        [np.asarray(b.dict.values, dtype=object) for b in branches if b.dict is not None]
    ))
    udict = Dictionary(union)

    def remap(b: ColumnVal) -> ColumnVal:
        if b.dict is None:
            return ColumnVal(torch.zeros((n,), dtype=torch.int32, device=dev), b.valid, udict, ty)
        table = np.searchsorted(union, np.asarray(b.dict.values, dtype=object))
        return ColumnVal(_gather_table(table.astype(np.int32), b), b.valid, udict, ty)

    return [remap(b) for b in branches]


def _as_limbs(v: ColumnVal):
    """(lo, hi) int64 pair; single-lane numeric operands sign-extend."""
    lo = v.data.to(torch.int64)
    if v.data2 is not None:
        return lo, v.data2.to(torch.int64)
    return lo, lo >> 63  # arithmetic shift: 0 for >=0, -1 for <0


def _limbed_op(op: str, args, valid, e) -> ColumnVal:
    """decimal128 elementwise ops over two-limb lanes (reference:
    spi/type/Int128Math.java add/subtract/multiply/compare).  Operands were
    already scale-aligned by the planner, like the single-lane decimal
    path."""
    from ..data import dec128 as d

    if op in ("div", "mod"):
        raise NotImplementedError(
            f"decimal128 {op} (128-bit divide lanes; cast to double instead)"
        )
    alo, ahi = _as_limbs(args[0])
    if op == "neg":
        lo, hi = d.neg128(alo, ahi)
        return ColumnVal(lo, valid, None, e.type, data2=hi)
    if op == "abs":
        lo, hi = d.neg128(alo, ahi)
        neg = ahi < 0
        return ColumnVal(
            torch.where(neg, lo, alo), valid, None, e.type,
            data2=torch.where(neg, hi, ahi),
        )
    blo, bhi = _as_limbs(args[1])
    if op == "mul":
        lo, hi = d.mul128(alo, ahi, blo, bhi)
        return ColumnVal(lo, valid, None, e.type, data2=hi)
    if op in ("add", "sub"):
        lo, hi = (
            d.add128(alo, ahi, blo, bhi)
            if op == "add"
            else d.sub128(alo, ahi, blo, bhi)
        )
        return ColumnVal(lo, valid, None, e.type, data2=hi)
    lt, eq = d.cmp128(alo, ahi, blo, bhi)
    out = {
        "eq": eq, "ne": ~eq, "lt": lt, "le": lt | eq,
        "gt": ~(lt | eq), "ge": ~lt,
    }[op]
    return ColumnVal(out, valid, None, BOOLEAN)


# ---------------------------------------------------- dictionary (host) ops


def _string_compare(op: str, args: list[ColumnVal]) -> ColumnVal:
    """Comparisons over dictionary-coded strings: a host-built table over
    the (small) dictionary, gathered on the device by code."""
    a, b = args
    if a.dict is None or b.dict is None:
        raise NotImplementedError(f"string {op} against a non-string value is {_NOT_PORTED}")
    valid = _and_valid(a.valid, b.valid)
    if len(b.dict) == 1:
        return _dict_vs_const(op, a, str(b.dict.values[0]), valid)
    if len(a.dict) == 1:
        flip = {"eq": "eq", "ne": "ne", "lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}
        return _dict_vs_const(flip[op], b, str(a.dict.values[0]), valid)
    if a.dict is b.dict:
        if op in ("eq", "ne"):
            return ColumnVal(_COMPARE[op](a.data, b.data), valid, None, BOOLEAN)
        ranks = torch.from_numpy(a.dict.sorted_rank()).to(a.data.device)
        ra = ranks.index_select(0, a.data.to(torch.int64))
        rb = ranks.index_select(0, b.data.to(torch.int64))
        return ColumnVal(_COMPARE[op](ra, rb), valid, None, BOOLEAN)
    # different dictionaries: translate b's codes into a's code space (eq/ne)
    if op in ("eq", "ne"):
        b_in_a = translate_codes(b, a.dict)
        eq = (b_in_a >= 0) & (a.data == b_in_a)
        return ColumnVal(eq if op == "eq" else ~eq, valid, None, BOOLEAN)
    raise NotImplementedError("ordering comparison across distinct dictionaries")


def translate_codes(col: ColumnVal, to: Dictionary) -> torch.Tensor:
    """`col`'s dictionary codes in `to`'s code space (-1 where `to` lacks
    the value): a host-built table, gathered on the device by code."""
    # an empty dictionary has only dead or NULL lanes: they map to -1
    trans = np.asarray([to.code_of(v) for v in col.dict.values] or [-1], dtype=np.int32)
    return torch.from_numpy(trans).to(col.data.device).index_select(
        0, col.data.to(torch.int64).clamp(0, len(trans) - 1)
    )


def _dict_vs_const(op: str, col: ColumnVal, const: str, valid) -> ColumnVal:
    import operator as _op

    py = {
        "eq": _op.eq, "ne": _op.ne, "lt": _op.lt, "le": _op.le, "gt": _op.gt, "ge": _op.ge,
    }[op]
    table = np.asarray([py(str(v), const) for v in col.dict.values], dtype=np.bool_)
    return ColumnVal(_gather_table(table, col), valid, None, BOOLEAN)


def _gather_table(table: np.ndarray, col: ColumnVal) -> torch.Tensor:
    """A host table over `col`'s dictionary, gathered on the device by code
    (an empty dictionary has only dead or NULL lanes: they read entry 0)."""
    if len(table) == 0:
        table = np.zeros((1,), dtype=table.dtype)
    return torch.from_numpy(table).to(col.data.device).index_select(
        0, col.data.to(torch.int64).clamp(0, len(table) - 1)
    )


def _in_list(e: InListIr, cols: Sequence[ColumnVal], n: int, dev) -> ColumnVal:
    """x [NOT] IN (literals): a host table over a varchar operand's
    dictionary, OR-ed equalities over a numeric one."""
    a = eval_expr(e.operand, cols, n, dev)
    if a.dict is not None:
        wanted = {str(v) for v in e.values}
        table = np.asarray([str(v) in wanted for v in a.dict.values], dtype=np.bool_)
        m = _gather_table(table, a)
    else:
        m = torch.zeros((n,), dtype=torch.bool, device=dev)
        for v in e.values:
            m = m | (a.data == v)
    if e.negated:
        m = ~m
    return ColumnVal(m, a.valid, None, BOOLEAN)


def _like(e: LikeIr, cols: Sequence[ColumnVal], n: int, dev) -> ColumnVal:
    """[NOT] LIKE: the pattern is matched once per distinct dictionary value
    on the host, and the table is gathered by code."""
    a = eval_expr(e.operand, cols, n, dev)
    rx = _like_regex(e.pattern)
    table = np.asarray(
        [rx.fullmatch(str(v)) is not None for v in a.dict.values], dtype=np.bool_
    )
    m = _gather_table(table, a)
    if e.negated:
        m = ~m
    return ColumnVal(m, a.valid, None, BOOLEAN)


def _like_regex(pattern: str) -> re.Pattern:
    """A LIKE pattern as an anchored regex: % any run, _ any one character."""
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("".join(out), re.DOTALL)


def _substring(e: Call, cols: Sequence[ColumnVal], n: int, dev) -> ColumnVal:
    """substring(x, start[, length]) with literal bounds: the sliced distinct
    values form a new dictionary and the codes are remapped into it."""
    a = eval_expr(e.args[0], cols, n, dev)
    start = e.args[1]
    length = e.args[2] if len(e.args) > 2 else None
    if not isinstance(start, Const) or not (length is None or isinstance(length, Const)):
        raise NotImplementedError("substring bounds must be literals")
    s = int(start.value)
    if length is not None:
        ln = int(length.value)
        vals = [str(v)[s - 1 : s - 1 + ln] for v in a.dict.values]
    else:
        vals = [str(v)[s - 1 :] for v in a.dict.values]
    uniq, remap = np.unique(np.asarray(vals, dtype=object), return_inverse=True)
    return ColumnVal(
        _gather_table(remap.astype(np.int32).reshape(-1), a), a.valid, Dictionary(uniq), VARCHAR
    )


# ------------------------------------------------------------- date helpers


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _civil_from_days(z: torch.Tensor):
    """days-since-epoch -> (year, month, day), branch-free integer math
    (public domain algorithm)."""
    z = z + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524) - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(y.dtype)
    return y, m, d


def _days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(year, month, day) -> days-since-epoch; exact inverse of
    _civil_from_days (same public-domain algorithm)."""
    y = y - (m <= 2).to(y.dtype)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    doy = _fdiv(153 * (m + torch.where(m > 2, -3, 9)) + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468
