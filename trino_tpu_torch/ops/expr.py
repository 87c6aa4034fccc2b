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

The port carries the scalar surface of the reference: literals (string
literals as one-entry dictionaries), field references, arithmetic and
comparisons (single-lane and decimal128), the float math library, bitwise
ops, nullif / greatest / least, CASE (numeric, decimal128 and varchar
branches), coalesce, casts (numeric, and from varchar by a host parse of
each distinct value), try_cast, Kleene and/or/not, is_null, date arithmetic,
extraction and truncation.  String functions (comparisons, IN, LIKE,
substring, length, upper / lower / trim, replace, pads, split_part, the
regexp family, concatenation) run once per distinct dictionary value on the
host and the table is gathered by code on the device — the reference's
design, and its DictionaryAwarePageProjection fast path made the only path.
JSON functions, arrays, maps, rows and lambdas take the same route: a
nested value is dictionary-coded (tuples on the host, int32 codes on the
device), each function runs once per distinct value, and a lambda body is
compiled once into a python closure that runs on the host (`_py_compile`).
A prepared statement's bound parameter (ir.Param) evaluates to its value for
the current run (`param_context`), broadcast like a constant: one plan
serves every binding.  Lambda bodies refuse a Param.  The fused pipeline's
recipe is built per run, with each Param's value in it as a constant of its
own (`bind_params`): constants are kernel arguments, so every binding runs
the one compiled kernel and nothing cached per plan holds a value.
"""

from __future__ import annotations

import itertools
import re
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.page import Column, Dictionary
from ..data.types import BOOLEAN, DATE, DOUBLE, Type, VARCHAR, date_to_days
from ..plan.ir import Call, CaseWhen, Const, FieldRef, InListIr, IrExpr, LikeIr, Param
from ..plan.planner import _cast_const
from . import kernels as _kernels

__all__ = [
    "ColumnVal", "eval_expr", "eval_predicate", "column_val", "to_column",
    "translate_codes", "param_context", "bind_params",
]


class _ParamContext(threading.local):
    """The bound values of a prepared statement's parameters during one
    plan run (exec/compiler.py LocalExecutor.execute sets them)."""

    def __init__(self):
        self.values = ()


_PARAMS = _ParamContext()


@contextmanager
def param_context(values):
    """Bind `values` (one per ir.Param index) for the runs inside."""
    prev = _PARAMS.values
    _PARAMS.values = tuple(values)
    try:
        yield
    finally:
        _PARAMS.values = prev


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
        return _param_val(e, n, dev)
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
        # a one-entry dictionary holding the tuple, as a string literal is
        # one entry; a NULL array keeps the shape with every lane invalid
        d = Dictionary(_obj_array([() if e.value is None else tuple(e.value)]))
        valid = None if e.value is not None else torch.zeros((n,), dtype=torch.bool, device=dev)
        return ColumnVal(torch.zeros((n,), dtype=torch.int32, device=dev), valid, d, e.type)
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


def _bound_value(e: Param):
    """The python value `e` is bound to in the current run."""
    values = _PARAMS.values
    if e.index >= len(values):
        raise NotImplementedError(
            f"parameter ${e.index} evaluated outside a binding context"
        )
    return np.asarray(values[e.index]).reshape(()).item()


def _param_val(e: Param, n: int, dev: torch.device) -> ColumnVal:
    """A bound parameter: its value for this run, materialized over the
    page as a constant is."""
    return _const_val(Const(_bound_value(e), e.type), n, dev)


@dataclass(frozen=True)
class BoundParam(Const):
    """A Param's value in the current run, as a constant of a fused recipe.
    It keeps the parameter's index, so it never equals a literal or another
    parameter that happens to hold the same value: the recipe's structure,
    which keys its compile, is the same for every binding."""

    index: int = -1


def bind_params(e: IrExpr) -> IrExpr:
    """`e` with each Param replaced by its bound value (a BoundParam) and
    each cast of one folded, as the planner folds a literal's cast; `e`
    itself outside a binding context."""
    if not _PARAMS.values:
        return e
    if isinstance(e, Param):
        return BoundParam(_bound_value(e), e.type, e.index)
    if isinstance(e, Call):
        args = tuple(bind_params(a) for a in e.args)
        if e.op == "cast" and isinstance(args[0], BoundParam):
            a = args[0]
            return BoundParam(_cast_const(a.value, e.type, a.type), e.type, a.index)
        return Call(e.op, args, e.type)
    return e


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
    if op in _HOF_OPS:
        return _hof_fn(op, e, cols, n, dev)
    if op == "map_construct":
        return _map_construct(e, cols, n, dev)
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
    if op == "length":
        a = eval_expr(e.args[0], cols, n, dev)
        table = np.asarray([len(str(v)) for v in a.dict.values], dtype=np.int64)
        return ColumnVal(_gather_table(table, a), a.valid, None, e.type)
    if op in _NESTED_OPS:
        return _nested(op, e, [eval_expr(a, cols, n, dev) for a in e.args])
    if op in _STR_UNARY:
        return _dict_map_str(eval_expr(e.args[0], cols, n, dev), _STR_UNARY[op], e.type)
    if op in _STRING_FNS:
        return _string_fn(op, e, [eval_expr(a, cols, n, dev) for a in e.args])
    if op == "try_cast":
        return _try_cast(eval_expr(e.args[0], cols, n, dev), e.type)
    if op in _SCALAR_OPS:
        # date_trunc's unit is a literal read from the IR, never a lane
        operands = e.args[:1] if op == "date_trunc" else e.args
        return _scalar(op, e, [eval_expr(a, cols, n, dev) for a in operands])
    if op not in _ARITH:
        raise NotImplementedError(f"call op: {op}")

    args = [eval_expr(a, cols, n, dev) for a in e.args]
    if any(v.dict is not None for v in args):
        if op in _COMPARE:
            return _string_compare(op, args)
        raise NotImplementedError(f"string {op} (no such operator over varchar)")

    valid = _all_valid(args)
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


def _all_valid(args: Sequence[ColumnVal]) -> Optional[torch.Tensor]:
    valid = None
    for v in args:
        valid = _and_valid(valid, v.valid)
    return valid


_ARITH = frozenset({
    "neg", "abs", "eq", "ne", "lt", "le", "gt", "ge", "add", "sub", "mul", "div", "mod",
})

# float math over f64 lanes; a domain error is NULL, not NaN (SQL semantics)
_F64_UNARY = {
    "ln": torch.log, "log2": torch.log2, "log10": torch.log10, "exp": torch.exp,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan, "asin": torch.asin,
    "acos": torch.acos, "atan": torch.atan,
    "cbrt": lambda x: torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0),
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
}

_BITWISE = {
    "bitwise_and": torch.bitwise_and, "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor, "shift_left": torch.bitwise_left_shift,
    "shift_right": torch.bitwise_right_shift,
}

_DATE_FIELDS = ("extract_quarter", "extract_dow", "extract_doy", "extract_week")

_SCALAR_OPS = frozenset({
    "round", "floor", "ceil", "sqrt", "power", "atan2", "sign", "truncate",
    "nullif", "greatest", "least", "date_trunc", "last_day_of_month", "date_diff_days",
    *_F64_UNARY, *_BITWISE, *_DATE_FIELDS,
})


def _literal(e_arg, what: str):
    if not isinstance(e_arg, Const):
        raise NotImplementedError(f"{what} must be a literal")
    return e_arg.value


def _f64(v: ColumnVal) -> torch.Tensor:
    return v.data.to(torch.float64)


def _scalar(op: str, e: Call, args: list[ColumnVal]) -> ColumnVal:
    """Numeric, conditional and date functions over single-lane columns
    (reference: trino_tpu/ops/expr.py _call, the math / conditional / date
    blocks).  The planner hands decimals to the float functions as doubles."""
    if any(v.data2 is not None for v in args):
        raise NotImplementedError(f"decimal128 through {op}")
    valid = _all_valid(args)
    if op == "nullif":
        a, b = args
        if a.dict is not None or b.dict is not None:
            eq_mask = _string_compare("eq", [a, b]).data
        else:
            x, y = _numeric_align(a.data, b.data)
            eq_mask = x == y
        # NULLIF nulls only where b is non-NULL and equal
        both = eq_mask if b.valid is None else (eq_mask & b.valid)
        return ColumnVal(a.data, ~both if a.valid is None else (a.valid & ~both), a.dict, a.type)
    if any(v.dict is not None for v in args):
        raise NotImplementedError(f"{op} over varchar")
    if op == "round":
        digits = int(_literal(e.args[1], "round() digits")) if len(e.args) == 2 else 0
        return ColumnVal(_round_half_away(args[0].data, digits), valid, None, e.type)
    if op in ("floor", "ceil", "sqrt"):
        fn = {"floor": torch.floor, "ceil": torch.ceil, "sqrt": torch.sqrt}[op]
        return ColumnVal(fn(_f64(args[0])), valid, None, e.type)
    if op in ("power", "atan2"):
        fn = torch.pow if op == "power" else torch.atan2
        return ColumnVal(fn(_f64(args[0]), _f64(args[1])), valid, None, e.type)
    if op in _F64_UNARY:
        out = _F64_UNARY[op](_f64(args[0]))
        return ColumnVal(out, _and_valid(valid, ~torch.isnan(out)), None, e.type)
    if op == "sign":
        return ColumnVal(torch.sign(args[0].data), valid, None, e.type)
    if op == "truncate":
        x = _f64(args[0])
        if len(e.args) == 2:
            f = 10.0 ** int(_literal(e.args[1], "truncate() scale"))
            return ColumnVal(torch.trunc(x * f) / f, valid, None, e.type)
        return ColumnVal(torch.trunc(x), valid, None, e.type)
    if op in _BITWISE:
        a, b = (v.data.to(torch.int64) for v in args)
        return ColumnVal(_BITWISE[op](a, b), valid, None, e.type)
    if op in ("greatest", "least"):
        fn = torch.maximum if op == "greatest" else torch.minimum
        target = _torch_dtype(e.type)
        acc = args[0].data.to(target)
        for v in args[1:]:
            acc = fn(acc, v.data.to(target))
        return ColumnVal(acc, valid, None, e.type)  # NULL if any argument is
    if op == "date_diff_days":
        a, b = args
        return ColumnVal(b.data.to(torch.int64) - a.data.to(torch.int64), valid, None, e.type)
    a = args[0]
    days = a.data.to(torch.int64)
    y, m, d = _civil_from_days(days)
    one = torch.ones_like(m)
    if op in _DATE_FIELDS:
        if op == "extract_quarter":
            out = _fdiv(m + 2, 3)
        elif op == "extract_dow":
            # ISO day of week 1..7 (Monday 1); 1970-01-01 was a Thursday
            out = torch.remainder(days + 3, 7) + 1
        else:
            jan1 = _days_from_civil(y, one, one)
            if op == "extract_doy":
                out = days - jan1 + 1
            else:  # the reference's week number: weeks from the Monday on or before Jan 4
                jan4 = jan1 + 3
                anchor = jan4 - torch.remainder(jan4 + 3, 7)
                out = torch.clamp(_fdiv(days - anchor, 7) + 1, min=1)
        return ColumnVal(out, a.valid, None, e.type)
    if op == "last_day_of_month":
        ny = torch.where(m == 12, y + 1, y)
        nm = torch.where(m == 12, one, m + 1)
        out = _days_from_civil(ny, nm, one) - 1
        return ColumnVal(out.to(a.data.dtype), a.valid, None, DATE)
    # date_trunc: the unit is a literal the planner folded
    unit = _literal(e.args[1], "date_trunc unit")
    if unit == "year":
        out = _days_from_civil(y, one, one)
    elif unit == "quarter":
        out = _days_from_civil(y, _fdiv(m - 1, 3) * 3 + 1, one)
    elif unit == "month":
        out = _days_from_civil(y, m, one)
    elif unit == "week":  # ISO week start (Monday)
        out = days - torch.remainder(days + 3, 7)
    elif unit == "day":
        out = days
    else:
        raise NotImplementedError(f"date_trunc unit {unit}")
    return ColumnVal(out.to(a.data.dtype), a.valid, None, DATE)


def _round_half_away(x: torch.Tensor, digits: int) -> torch.Tensor:
    """round(x, digits) with ties away from zero (Trino's MathFunctions.round:
    sign(x) * floor(|x| * 10^d + 0.5) / 10^d).  A float already integral at
    that scale (|x| * 10^d >= 2^52) is kept, since adding 0.5 there would
    round in the last bit; integers round exactly in integer arithmetic."""
    if x.is_floating_point():
        f = 10.0 ** digits
        y = torch.abs(x) * f
        r = torch.where(y >= 2.0**52, y, torch.floor(y + 0.5))
        return torch.sign(x) * r / f
    if digits >= 0:
        return x
    return _round_div(x.to(torch.int64), 10 ** -digits).to(x.dtype) * 10 ** -digits


def _numeric_align(a: torch.Tensor, b: torch.Tensor):
    if a.dtype == b.dtype:
        return a, b
    target = torch.promote_types(a.dtype, b.dtype)
    return a.to(target), b.to(target)


def _round_div(d: torch.Tensor, div: int) -> torch.Tensor:
    """Divide by a positive power of ten, rounding half away from zero."""
    return torch.sign(d) * ((torch.abs(d) + div // 2) // div)


def _parse(s: str, target: Type):
    """One varchar value as `target` (raises ValueError / KeyError when it
    does not parse): dates ISO, decimals rounded half away from zero at the
    target's scale (the reference's try_cast goes through a double)."""
    s = s.strip()
    if target == DATE:
        return date_to_days(s)
    if target.is_decimal:
        return int(round(float(s) * (10.0**target.scale)))
    if target.is_floating:
        return float(s)
    if target == BOOLEAN:
        return {"true": True, "false": False}[s.lower()]
    return int(s)


def _try_cast(a: ColumnVal, target: Type) -> ColumnVal:
    """varchar -> T with failures as NULL (reference: TryCastFunction):
    parsed once per distinct dictionary value on the host, gathered by
    code."""
    parsed, ok = [], []
    for v in a.dict.values:
        try:
            parsed.append(_parse(str(v), target))
            ok.append(True)
        except (ValueError, KeyError, OverflowError):
            parsed.append(0)
            ok.append(False)
    data = _gather_table(np.asarray(parsed, dtype=target.np_dtype), a)
    ok_lane = _gather_table(np.asarray(ok, dtype=np.bool_), a)
    return ColumnVal(data, _and_valid(a.valid, ok_lane), None, target)


def _cast(a: ColumnVal, target: Type, n: int) -> ColumnVal:
    if a.type == target:
        return a
    if target == VARCHAR:
        raise NotImplementedError("cast to varchar")  # refused by the reference too
    if a.dict is not None:
        # varchar -> numeric / date / boolean: a host parse of each distinct
        # value; a value that does not parse is an error (try_cast makes it
        # NULL)
        table = np.asarray([_parse(str(v), target) for v in a.dict.values],
                           dtype=target.np_dtype)
        return ColumnVal(_gather_table(table, a), a.valid, None, target)
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
        raise NotImplementedError(f"string {op} against a non-string value")
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
    return _gather(table, col.data.to(torch.int64).clamp(0, max(len(table) - 1, 0)))


def _gather(table: np.ndarray, idx: torch.Tensor) -> torch.Tensor:
    """A host table uploaded once and gathered on the device at `idx`."""
    if len(table) == 0:
        table = np.zeros((1,), dtype=table.dtype)
    return torch.from_numpy(np.ascontiguousarray(table)).to(idx.device).index_select(0, idx)


_STR_UNARY = {
    "upper": str.upper,
    "lower": str.lower,
    "trim": str.strip,
    "ltrim": str.lstrip,
    "rtrim": str.rstrip,
    "reverse_str": lambda s: s[::-1],
}

_STRING_FNS = frozenset({
    "replace", "strpos", "starts_with", "lpad", "rpad", "split_part",
    "regexp_like", "regexp_replace", "regexp_extract", "concat_str",
})


def _dict_map_str_nullable(a: ColumnVal, fn, out_type) -> ColumnVal:
    """Like _dict_map_str, but fn may return None (SQL NULL — e.g. a regex
    that does not match): those codes' validity merges into the column's
    mask."""
    raw = [fn(str(v)) for v in a.dict.values]
    ok = np.asarray([r is not None for r in raw], dtype=np.bool_)
    vals = np.asarray([r if r is not None else "" for r in raw], dtype=object)
    uniq, remap = np.unique(vals, return_inverse=True)
    codes = _gather_table(remap.astype(np.int32).reshape(-1), a)
    return ColumnVal(
        codes, _and_valid(a.valid, _gather_table(ok, a)), Dictionary(uniq), out_type
    )


def _dict_map_str(a: ColumnVal, fn, out_type) -> ColumnVal:
    """str -> str applied once per distinct dictionary VALUE; the rows gather
    the remapped codes (the reference's DictionaryAwarePageProjection does
    the same per-distinct-value trick)."""
    vals = [fn(str(v)) for v in a.dict.values]
    uniq, remap = np.unique(np.asarray(vals, dtype=object), return_inverse=True)
    codes = _gather_table(remap.astype(np.int32).reshape(-1), a)
    return ColumnVal(codes, a.valid, Dictionary(uniq), out_type)


def _string_fn(op: str, e: Call, args: list[ColumnVal]) -> ColumnVal:
    """String functions with extra (literal) arguments, evaluated on the
    dictionary on the host; scalar results gather through a host table."""
    a = args[0]

    def lit(i: int):
        return _literal(e.args[i], f"argument {i + 1} of {op}")

    def str_out(fn) -> ColumnVal:
        return _dict_map_str(a, fn, e.type)

    def scalar_out(values, dtype) -> ColumnVal:
        return ColumnVal(_gather_table(np.asarray(values, dtype=dtype), a), a.valid, None, e.type)

    if op == "replace":
        old, new = str(lit(1)), str(lit(2))
        return str_out(lambda s: s.replace(old, new))
    if op == "strpos":
        needle = str(lit(1))
        return scalar_out([str(v).find(needle) + 1 for v in a.dict.values], np.int64)
    if op == "starts_with":
        prefix = str(lit(1))
        return scalar_out([str(v).startswith(prefix) for v in a.dict.values], np.bool_)
    if op in ("lpad", "rpad"):
        width = int(lit(1))
        pad = str(lit(2)) if len(e.args) > 2 else " "

        def _pad(s: str) -> str:
            if len(s) >= width:
                return s[:width]
            fill = (pad * width)[: width - len(s)]
            return fill + s if op == "lpad" else s + fill

        return str_out(_pad)
    if op == "split_part":
        delim, ix = str(lit(1)), int(lit(2))

        def _split(s: str):
            parts = s.split(delim)
            # an index out of range is NULL (Trino semantics), not ''
            return parts[ix - 1] if 1 <= ix <= len(parts) else None

        return _dict_map_str_nullable(a, _split, e.type)
    if op == "regexp_like":
        pat = re.compile(str(lit(1)))
        return scalar_out([bool(pat.search(str(v))) for v in a.dict.values], np.bool_)
    if op == "regexp_replace":
        pat = re.compile(str(lit(1)))
        repl = str(lit(2)) if len(e.args) > 2 else ""
        return str_out(lambda s: pat.sub(repl, s))
    if op == "regexp_extract":
        pat = re.compile(str(lit(1)))
        group = int(lit(2)) if len(e.args) > 2 else 0

        def _ext(s: str):
            # no match / a group that did not take part is NULL
            m = pat.search(s)
            return m.group(group) if m else None

        return _dict_map_str_nullable(a, _ext, e.type)
    # concat_str: n-ary over dictionary-coded and literal operands.  A pair
    # of dictionaries combines into at most |A| * |B| distinct outputs.
    out = a
    for nxt_ir, nxt in zip(e.args[1:], args[1:]):
        if isinstance(nxt_ir, Const):
            out = _dict_map_str(out, lambda s, _l=str(nxt_ir.value): s + _l, e.type)
            continue
        if len(out.dict) * len(nxt.dict) > 1_000_000:
            raise NotImplementedError("concat of two high-cardinality string columns")
        pair_vals = np.asarray(
            [str(x) + str(y) for x in out.dict.values for y in nxt.dict.values], dtype=object
        )
        uniq, remap = np.unique(pair_vals, return_inverse=True)
        width = max(len(nxt.dict), 1)
        pair_code = out.data.to(torch.int64) * width + nxt.data.to(torch.int64)
        codes = _gather_table(
            remap.astype(np.int32).reshape(-1), ColumnVal(pair_code, None)
        )
        out = ColumnVal(codes, _and_valid(out.valid, nxt.valid), Dictionary(uniq), e.type)
    return out


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


# ------------------------------------------------------------ nested values
#
# Arrays, maps and rows are dictionary-coded host objects, as VARCHAR is: a
# column holds int32 codes on the device, and `Dictionary.values` is an
# object array of tuples (arrays), key-sorted pair tuples (maps) or field
# tuples (rows).  Each function runs once per DISTINCT value on the host;
# the device gathers the result table by code.  JSON functions read VARCHAR
# dictionaries the same way.

_HOF_OPS = frozenset({
    "transform", "filter_arr", "reduce", "any_match", "all_match",
    "none_match", "zip_with", "transform_keys", "transform_values",
    "map_filter",
})

_JSON_OPS = frozenset({"json_extract_scalar", "json_extract", "json_array_length", "json_size"})

_ARRAY_OPS = frozenset({
    "cardinality", "element_at", "contains", "array_position", "array_distinct",
    "array_sort", "array_join", "array_min", "array_max",
})

_NESTED_OPS = _JSON_OPS | _ARRAY_OPS | {"map_element_at", "map_keys", "map_values",
                                        "row_field", "split"}


def _nested(op: str, e: Call, args: list[ColumnVal]) -> ColumnVal:
    if op in _JSON_OPS:
        return _json_fn(op, e, args[0])
    if op in ("map_element_at", "map_keys", "map_values") or (
        op == "cardinality" and e.args[0].type.is_map
    ):
        return _map_fn(op, e, args[0])
    if op == "row_field":
        return _row_field(e, args[0])
    if op == "split":
        # distinct strings split into distinct arrays (joining the parts
        # gives the string back), so the codes carry over unchanged
        delim = _const_str(e.args[1])
        a = args[0]
        _kernels.record_dispatch("host_pass", "host", str(len(a.dict)))
        parts = _obj_array([tuple(str(v).split(delim)) for v in a.dict.values] or [()])
        return ColumnVal(a.data, a.valid, Dictionary(parts), e.type)
    return _array_fn(op, e, args)


def _const_str(e_arg) -> str:
    return str(_literal(e_arg, "argument"))


def _obj_array(items) -> np.ndarray:
    """Object ndarray of python values built element by element (np.asarray
    would turn equal-length tuples into a 2-D array)."""
    out = np.empty(len(items), dtype=object)
    for i, v in enumerate(items):
        out[i] = v
    return out


def _intern(values: list, empty) -> tuple[np.ndarray, Dictionary]:
    """(remap, Dictionary) of per-distinct host results: remap[i] is the
    code of values[i].  Interned by hash, not sorted: tuples may hold None
    beside values, which a sort cannot order.  An empty input keeps one
    `empty` entry, so a gather always has a row to read."""
    uniq = list(dict.fromkeys(values))  # first occurrences, in order
    index = dict(zip(uniq, range(len(uniq))))
    remap = np.fromiter(map(index.__getitem__, values), dtype=np.int32, count=len(values))
    return remap, Dictionary(_obj_array(uniq or [empty]))


def _codes(v: ColumnVal) -> torch.Tensor:
    """`v`'s dictionary codes as int64 gather indices, clamped into the
    dictionary (dead and NULL lanes may hold any code)."""
    return v.data.to(torch.int64).clamp(0, max(len(v.dict) - 1, 0))


def _host_out(picked: list, idx: torch.Tensor, valid, t: Type) -> ColumnVal:
    """Per-distinct host results (None = SQL NULL) as a column of type `t`,
    gathered at `idx`: an interned dictionary for varchar and nested types,
    a value table otherwise; the NULLs merge into `valid`."""
    _kernels.record_dispatch("host_pass", "host", str(len(picked)))
    if None in picked:
        ok = np.fromiter((p is not None for p in picked), dtype=np.bool_, count=len(picked))
        valid = _and_valid(valid, _gather(ok, idx))
    if t.is_string or t.is_dict_object:
        empty = "" if t.is_string else ()
        remap, d = _intern([empty if p is None else p for p in picked], empty)
        return ColumnVal(_gather(remap, idx), valid, d, t)
    table = np.asarray([0 if p is None else p for p in picked], dtype=t.np_dtype)
    return ColumnVal(_gather(table, idx), valid, None, t)


# ---- JSON (the reference's JsonFunctions over the path subset below)


def _json_path(path: str) -> list:
    """The JSONPath subset '$', '$.key', '$[i]', '$["key"]' and chains of
    them ('$.a[1].b'); any other syntax is an error, never a prefix match."""
    if not path.startswith("$"):
        raise ValueError(f"invalid JSON path: {path!r}")
    steps: list = []
    pos = 0
    rest = path[1:]
    for m in re.finditer(r"\.([A-Za-z_][A-Za-z0-9_]*)|\[(\d+)\]|\[\"([^\"]+)\"\]", rest):
        if m.start() != pos:  # an unparsed segment
            raise ValueError(f"unsupported JSON path: {path!r}")
        pos = m.end()
        if m.group(1) is not None:
            steps.append(m.group(1))
        elif m.group(2) is not None:
            steps.append(int(m.group(2)))
        else:
            steps.append(m.group(3))
    if pos != len(rest):
        raise ValueError(f"unsupported JSON path: {path!r}")
    return steps


_MALFORMED = object()  # a document that does not parse

# JSON documents parsed during the current plan run, by dictionary: several
# JSON functions over one column (a path, a size, an extraction) parse each
# distinct document once per run.  Cleared when the run ends
# (exec/compiler.py _trace_plan), so nothing parsed outlives its statement.
_PARSED: dict = {}


def _json_docs(d: Dictionary) -> list:
    """The parsed documents of `d`'s values (_MALFORMED where one does not
    parse)."""
    import json

    hit = _PARSED.get(id(d))
    if hit is not None and hit[0] is d:
        return hit[1]
    decode = json.JSONDecoder().decode
    docs = []
    for v in d.values:
        try:
            docs.append(decode(str(v)))
        except ValueError:
            docs.append(_MALFORMED)
    _PARSED[id(d)] = (d, docs)
    return docs


def clear_run_memos() -> None:
    """Forget what the current plan run parsed (called when a run ends)."""
    _PARSED.clear()


def _json_walk(v, steps: list):
    """(value, found) of `steps` in the parsed document `v`; a malformed
    document and a missing step are not found."""
    if v is _MALFORMED:
        return None, False
    for s in steps:
        if isinstance(s, int):
            if not isinstance(v, list) or s >= len(v):
                return None, False
        elif not isinstance(v, dict) or s not in v:
            return None, False
        v = v[s]
    return v, True


def _json_fn(op: str, e: Call, a: ColumnVal) -> ColumnVal:
    """json_extract_scalar / json_extract / json_array_length / json_size:
    each distinct document parsed once per run on the host; what is not
    found (or is malformed) is NULL."""
    import json

    steps = _json_path(_const_str(e.args[1])) if len(e.args) > 1 else []
    encode = json.JSONEncoder(separators=(",", ":")).encode
    raw = []
    for doc in _json_docs(a.dict):
        val, found = _json_walk(doc, steps)
        if op == "json_extract_scalar":
            if not found or val is None or isinstance(val, (dict, list)):
                raw.append(None)
            elif isinstance(val, bool):
                raw.append("true" if val else "false")
            else:
                raw.append(str(val))
        elif op == "json_extract":
            raw.append(encode(val) if found else None)
        elif op == "json_array_length":
            raw.append(len(val) if found and isinstance(val, list) else None)
        elif not found:  # json_size: members of an object or array, 0 for scalars
            raw.append(None)
        else:
            raw.append(len(val) if isinstance(val, (dict, list)) else 0)
    return _host_out(raw, _codes(a), a.valid, e.type)


# ---- maps and rows


def _canon_pairs(d: dict) -> tuple:
    """A map's canonical form: its (key, value) pairs sorted by key (by the
    keys' repr where they do not compare)."""
    try:
        return tuple(sorted(d.items()))
    except TypeError:
        return tuple(sorted(d.items(), key=lambda it: repr(it[0])))


def _map_fn(op: str, e: Call, m: ColumnVal) -> ColumnVal:
    """cardinality / map_keys / map_values / map_element_at (literal key; a
    missing key is NULL) over a map column."""
    vals = m.dict.values
    if op == "cardinality":
        picked = [len(v) for v in vals]
    elif op in ("map_keys", "map_values"):
        ix = 0 if op == "map_keys" else 1
        picked = [tuple(p[ix] for p in v) for v in vals]
    else:
        want = _literal(e.args[1], "map subscript key")
        picked = [dict(v).get(want) for v in vals]
    return _host_out(picked, _codes(m), m.valid, e.type)


def _row_field(e: Call, r: ColumnVal) -> ColumnVal:
    """row.field: a per-distinct field table gathered by row code.  A NULL
    nested field reads as an empty value, as in the reference."""
    ix = int(_literal(e.args[1], "row field index"))
    picked = [v[ix] if ix < len(v) else None for v in r.dict.values]
    if e.type.is_dict_object:
        picked = [() if p is None else p for p in picked]
    return _host_out(picked, _codes(r), r.valid, e.type)


def _map_construct(e: Call, cols: Sequence[ColumnVal], n: int, dev) -> ColumnVal:
    """map(keys array, values array): one canonical map per occurring pair
    of codes; arrays of different lengths give NULL."""
    a = eval_expr(e.args[0], cols, n, dev)
    b = eval_expr(e.args[1], cols, n, dev)

    def build(ks, vs):
        return None if len(ks) != len(vs) else _canon_pairs(dict(zip(ks, vs)))

    return _pair_out(a, b, build, e.type)


def _pair_out(a: ColumnVal, b: ColumnVal, fn, t: Type) -> ColumnVal:
    """fn(a value, b value) over the pairs of codes that occur: the pair
    keys are made unique on the device, one host pass runs per occurring
    pair, and the table is gathered back through the inverse.  (A table
    over every |A| x |B| pair, the reference's, grows as a product: 10^10
    entries for two columns of 10^5 distinct arrays.)"""
    nb = max(len(b.dict), 1)
    key = _codes(a) * nb + _codes(b)
    uniq, inv = torch.unique(key, return_inverse=True)
    picked = [fn(a.dict.values[k // nb], b.dict.values[k % nb]) for k in uniq.tolist()]
    return _host_out(picked, inv.reshape(-1), _and_valid(a.valid, b.valid), t)


# ---- lambdas


def _round_py(x, digits: int = 0):
    """round() inside a lambda body, ties away from zero as in the column
    path."""
    if isinstance(x, int):
        if digits >= 0:
            return x
        div = 10 ** -digits
        return (1 if x >= 0 else -1) * ((abs(x) + div // 2) // div) * div
    import math

    f = 10.0 ** digits
    y = abs(x) * f
    r = y if y >= 2.0**52 else math.floor(y + 0.5)
    return math.copysign(r / f, x)


def _py_compile(ir):
    """A lambda body compiled once into a python closure over an environment
    of python scalars, env -> value (None is SQL NULL).  The reference
    interprets the IR tree for every element; Trino compiles the body to
    bytecode (LambdaBytecodeGenerator) — closures are the host's
    equivalent, and with dictionary interning each body runs once per
    element of each distinct value."""
    import math
    import operator

    from ..plan.ir import LambdaVarIr

    if isinstance(ir, Const):
        v = ir.value
        if v is not None and ir.type.is_decimal:
            v = v / (10.0 ** ir.type.scale)
        return lambda env: v
    if isinstance(ir, LambdaVarIr):
        name = ir.name
        return lambda env: env[name]
    if isinstance(ir, CaseWhen):
        whens = [(_py_compile(c), _py_compile(r)) for c, r in ir.whens]
        default = None if ir.default is None else _py_compile(ir.default)

        def case(env):
            for cond, res in whens:
                if cond(env) is True:
                    return res(env)
            return None if default is None else default(env)

        return case
    if isinstance(ir, (InListIr, LikeIr)):
        operand, negated = _py_compile(ir.operand), ir.negated
        if isinstance(ir, InListIr):
            values = ir.values
            test = lambda v: v in values
        else:
            rx = _like_regex(ir.pattern)
            test = lambda v: bool(rx.match(str(v)))

        def member(env):
            v = operand(env)
            return None if v is None else test(v) != negated

        return member
    if isinstance(ir, Param):
        # a closure holding the value would be keyed by the value
        raise NotImplementedError("a prepared-statement parameter inside a lambda body")
    if not isinstance(ir, Call):
        raise NotImplementedError(f"lambda body node {type(ir).__name__}")

    op = ir.op
    args = [_py_compile(a) for a in ir.args]
    if op in ("and", "or"):
        decisive = op == "or"  # True decides OR, False decides AND

        def kleene(env):
            vals = [a(env) for a in args]
            if any(v is decisive for v in vals):
                return decisive
            return None if any(v is None for v in vals) else not decisive

        return kleene
    if op == "not":
        (a,) = args
        return lambda env: (lambda v: None if v is None else not v)(a(env))
    if op == "is_null":
        (a,) = args
        return lambda env: a(env) is None
    if op == "coalesce":
        def coalesce(env):
            for a in args:
                v = a(env)
                if v is not None:
                    return v
            return None

        return coalesce
    if op == "cast":
        t = ir.type
        conv = (str if t.is_string else float if (t.is_floating or t.is_decimal)
                else int if t.is_integer else (lambda v: v))
        (a,) = args
        return lambda env: (lambda v: None if v is None else conv(v))(a(env))

    def div(a, b):
        if b == 0:
            return None
        if isinstance(a, int) and isinstance(b, int):
            # SQL truncates toward zero; exact in python ints
            q = abs(a) // abs(b)
            return -q if (a < 0) != (b < 0) else q
        return a / b

    def mod(a, b):
        if b == 0:
            return None
        if isinstance(a, int) and isinstance(b, int):
            r = abs(a) % abs(b)  # the sign of the dividend
            return -r if a < 0 else r
        return a - b * float(math.trunc(a / b))

    fn = {
        "add": operator.add, "sub": operator.sub, "mul": operator.mul,
        "div": div, "mod": mod, "neg": operator.neg, "abs": abs,
        "eq": operator.eq, "ne": operator.ne, "lt": operator.lt,
        "le": operator.le, "gt": operator.gt, "ge": operator.ge,
        "length": lambda v: len(str(v)),
        "concat_str": lambda *vs: "".join(str(v) for v in vs),
        "nullif": lambda a, b: None if a == b else a,
        "sqrt": lambda v: math.sqrt(v) if v >= 0 else None,
        "ln": lambda v: math.log(v) if v > 0 else None,
        "exp": math.exp,
        "floor": lambda v: float(math.floor(v)),
        "ceil": lambda v: float(math.ceil(v)),
        "round": lambda v, d=0: _round_py(v, int(d)),
        "power": lambda a, b: float(a) ** float(b),
        **{k: (lambda f: lambda v: f(str(v)))(f) for k, f in _STR_UNARY.items()
           if k != "reverse_str"},
    }.get(op)
    if fn is None:
        raise NotImplementedError(f"lambda body op {op}")
    if len(args) == 1:
        (a,) = args
        return lambda env: (lambda v: None if v is None else fn(v))(a(env))
    if len(args) == 2:
        a, b = args

        def binary(env):
            x, y = a(env), b(env)
            return None if x is None or y is None else fn(x, y)

        return binary

    def strict(env):  # NULL in, NULL out
        vals = [a(env) for a in args]
        return None if any(v is None for v in vals) else fn(*vals)

    return strict


def _coerce_elem(v, t: Type):
    """A lambda result in the canonical python form of `t` (numpy scalars
    become python values; decimal results stay floats)."""
    if v is None:
        return None
    if isinstance(v, np.generic):
        v = v.item()
    if t.is_integer:
        return int(v)
    if t.is_floating:
        return float(v)
    if t.is_string:
        return str(v)
    return v


def _hof_fn(op: str, e: Call, cols: Sequence[ColumnVal], n: int, dev) -> ColumnVal:
    """Higher-order functions over array and map columns: the lambda body
    is interpreted once per distinct container value on the host, and the
    device gathers the result by code."""
    a = eval_expr(e.args[0], cols, n, dev)
    vals = a.dict.values

    def out(picked, t=e.type) -> ColumnVal:
        return _host_out(picked, _codes(a), a.valid, t)

    if op == "zip_with":
        b = eval_expr(e.args[1], cols, n, dev)
        lam = e.args[2]
        xp, yp = lam.params
        et = e.type.element
        body = _py_compile(lam.body)

        def zipped(va, vb):
            ln = max(len(va), len(vb))
            pa = tuple(va) + (None,) * (ln - len(va))
            pb = tuple(vb) + (None,) * (ln - len(vb))
            return tuple(_coerce_elem(body({xp: x, yp: y}), et) for x, y in zip(pa, pb))

        return _pair_out(a, b, zipped, e.type)
    if op == "reduce":
        init_ir, comb, fin = e.args[1], e.args[2], e.args[3]
        init = _py_compile(init_ir)({})
        sp, xp = comb.params
        step, finish, fp = _py_compile(comb.body), _py_compile(fin.body), fin.params[0]
        picked = []
        for v in vals:
            state = init
            for x in v:
                state = step({sp: state, xp: x})
            picked.append(_coerce_elem(finish({fp: state}), e.type))
        return out(picked)
    lam = e.args[1]
    body = _py_compile(lam.body)
    if op == "transform":
        p, et = lam.params[0], e.type.element
        return out([tuple(_coerce_elem(body({p: x}), et) for x in v) for v in vals])
    if op == "filter_arr":
        p = lam.params[0]
        return out([tuple(x for x in v if body({p: x}) is True) for v in vals])
    if op in ("any_match", "all_match", "none_match"):
        p = lam.params[0]
        # the result that decides, what it gives, and what an undecided
        # walk gives (NULL when any element's predicate was NULL)
        decide, gives = {"any_match": (True, True), "all_match": (False, False),
                         "none_match": (True, False)}[op]
        picked = []
        for v in vals:
            results = [body({p: x}) for x in v]
            if any(r is decide for r in results):
                picked.append(gives)
            else:
                picked.append(None if any(r is None for r in results) else not gives)
        return out(picked)
    # map HOFs: values are key-sorted tuples of (key, value) pairs
    kp, vp = lam.params
    if op == "transform_keys":
        kt = e.type.key
        return out([
            _canon_pairs({_coerce_elem(body({kp: k, vp: v}), kt): v
                          for k, v in m})
            for m in vals
        ])
    if op == "transform_values":
        vt = e.type.value
        return out([
            tuple((k, _coerce_elem(body({kp: k, vp: v}), vt)) for k, v in m)
            for m in vals
        ])
    # map_filter
    return out([
        tuple((k, v) for k, v in m if body({kp: k, vp: v}) is True)
        for m in vals
    ])


# ---- arrays


def array_elements(vals: np.ndarray, et: Type, device) -> tuple:
    """The elements of the distinct arrays `vals` in flat form (CSR) on
    `device`: (starts, elements, element dictionary).  Array c's elements
    are elements[starts[c]:starts[c + 1]].  A varchar element is a code
    into the dictionary, which is built once for the call; a NULL numeric
    element reads 0, as in the reference's element matrix."""
    lens = np.fromiter(map(len, vals), dtype=np.int64, count=len(vals))
    starts = np.zeros((len(vals) + 1,), dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    total = int(starts[-1])
    _kernels.record_dispatch("host_pass", "host", str(total))
    elements = list(itertools.chain.from_iterable(vals))
    if et.is_string:
        flat, ed = _intern(list(map(str, elements)), "")
    else:
        if None in elements:
            elements = [0 if x is None else x for x in elements]
        flat = np.asarray(elements, dtype=et.np_dtype).reshape(-1)
        ed = None
    if total == 0:
        flat = np.zeros((1,), dtype=flat.dtype)
    dev = torch.device(device)
    return torch.from_numpy(starts).to(dev), torch.from_numpy(flat).to(dev), ed


def _array_fn(op: str, e: Call, args: list[ColumnVal]) -> ColumnVal:
    """Array functions over array columns, once per distinct array on the
    host (element_at and contains with a per-row operand gather the flat
    element table on the device)."""
    a = args[0]
    vals = a.dict.values
    code = _codes(a)

    def out(picked, t=e.type) -> ColumnVal:
        return _host_out(picked, code, a.valid, t)

    if op == "cardinality":
        return out([len(v) for v in vals])
    if op == "element_at":
        if isinstance(e.args[1], Const):
            i = int(e.args[1].value)
            # 1-based, negative counts from the end; out of bounds is NULL
            return out([None if i == 0 or abs(i) > len(v) else v[i - 1 if i > 0 else i]
                        for v in vals])
        starts, flat, ed = array_elements(vals, e.type, code.device)
        ix = args[1].data.to(torch.int64)
        lo = starts.index_select(0, code)
        ln = starts.index_select(0, code + 1) - lo
        pos = torch.where(ix > 0, ix - 1, ln + ix)
        ok = (pos >= 0) & (pos < ln)
        at = (lo + pos.clamp(min=0)).clamp(max=flat.shape[0] - 1)
        valid = _and_valid(_and_valid(a.valid, args[1].valid), ok)
        return ColumnVal(flat.index_select(0, at), valid, ed, e.type)
    if op == "contains":
        if isinstance(e.args[1], Const):
            want = e.args[1].value
            return out([any(el == want for el in v) for v in vals])
        return _contains_lane(a, args[1], code)
    if op == "array_position":
        want = _literal(e.args[1], "array_position needle")
        return out([next((i + 1 for i, el in enumerate(v) if el == want), 0) for v in vals])
    if op == "array_distinct":
        return out([tuple(dict.fromkeys(v)) for v in vals])
    if op == "array_sort":  # NULL elements last
        return out([tuple(sorted(x for x in v if x is not None))
                    + (None,) * sum(1 for x in v if x is None) for v in vals])
    if op == "array_join":
        delim = _const_str(e.args[1])
        return out([delim.join(str(x) for x in v) for v in vals], VARCHAR)
    if op in ("array_min", "array_max"):
        # empty, or any NULL element, is NULL
        f = min if op == "array_min" else max
        picked = [None if not len(v) or any(x is None for x in v) else f(v) for v in vals]
        if e.type.is_string:
            picked = [None if p is None else str(p) for p in picked]
        return out(picked)
    raise NotImplementedError(f"array op {op}")


def _contains_lane(a: ColumnVal, x: ColumnVal, code: torch.Tensor) -> ColumnVal:
    """contains(array, per-row needle): each row's elements gathered from
    the flat element table into a [rows, longest array] frame and compared
    with the needle (varchar elements in the needle's code space)."""
    vals = a.dict.values
    if x.dict is not None:
        starts, flat, ed = array_elements(vals, VARCHAR, code.device)
        # element codes -> the needle's code space (-2: absent, never equal)
        trans = np.asarray([x.dict.code_of(str(v)) for v in ed.values], dtype=np.int64)
        flat = _gather(np.where(trans < 0, -2, trans), flat.to(torch.int64))
        needle = x.data.to(torch.int64)
    else:
        starts, flat, _ = array_elements(vals, DOUBLE, code.device)
        needle = x.data.to(torch.float64)
    lo = starts.index_select(0, code)
    ln = starts.index_select(0, code + 1) - lo
    width = max(1, int((starts[1:] - starts[:-1]).max()) if len(vals) else 1)
    at = lo[:, None] + torch.arange(width, device=code.device)[None, :]
    inlen = torch.arange(width, device=code.device)[None, :] < ln[:, None]
    rows = flat.index_select(0, at.clamp(max=flat.shape[0] - 1).reshape(-1)).reshape(at.shape)
    hit = ((rows == needle[:, None]) & inlen).any(dim=1)
    return ColumnVal(hit, _and_valid(a.valid, x.valid), None, BOOLEAN)
