"""Fused scan→filter→project→aggregate pipeline.

Port of trino_tpu/ops/pallas/fused.py (`plan_pipeline`, `run`, `assemble`,
kernel `_fused_kernel`).  q01/q06-shaped fragments — a TableScan feeding a
stack of Filters/Projects feeding one Aggregate whose keys are small
dictionary columns — are memory bound: the operator-at-a-time path reads the
scan columns once per relational operator and writes every intermediate.
This pipeline reads every referenced scan column exactly once and writes
only the per-group totals.

  * the compiler (exec/compiler.py) substitutes the filter predicates and
    aggregate arguments down to scan level (plan/ir.substitute), so the
    pipeline receives raw columns plus a closed IR tree;
  * `plan_pipeline` is the support proof: a static pass that types every
    subexpression, rejects what the pipeline cannot evaluate exactly, and
    deduplicates the aggregate streams.  It then compiles the tree into a
    flat postfix *bytecode* — (opcode, dst, a, b, imm) records over at most
    32 registers (assigned by liveness, so q01 needs six), each register
    statically typed I (integer / decimal / date / bool, held as a 128-bit
    integer) or F (double) and carrying a validity bit;
  * `run` executes the bytecode: on CUDA tensors through a kernel generated
    for the recipe (ops/cuda/fused_codegen.py lowers the bytecode into
    straight-line CUDA C, NVRTC compiles it once per recipe shape), on CPU
    tensors through `run_plain`, a vectorised interpreter of the SAME
    bytecode (one tensor op per instruction over all rows, 128-bit integers
    through data/dec128.py);
  * `assemble` turns the totals into aggregate output columns shaped like
    relops.group_aggregate's.

Every aggregate lowers to *streams* (per-row values summed per group):
count -> the row mask or a non-NULL mask; sum -> one integer or double sum
stream plus its count; avg -> the same two.  Streams are deduplicated.
Integer (decimal) sums are exact to 128 bits, so a decimal(38, s) SUM comes
out bit-identical to the operator-at-a-time path; double sums differ from it
only by the order of the additions.

Named limits: `_DTILE` (key-code domain <= 512) and `_MAX_STREAMS` (<= 64)
are kept from the reference as the contract of what counts as a "small
dictionary" aggregate.  There they were also the size of an on-chip
accumulator tile; here they bound the generated kernel's tables, and
tables too large for shared memory take its global-atomics route.
`_MAX_REGS` and `_MAX_INSTR` bound the bytecode (and so the generated code).
The reference's 2^47 bound on decimal constants (float-pair exactness) does
not exist here: integer registers are 128 bits wide.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ...data import dec128
from ...plan.ir import Call, Const, FieldRef, IrExpr

__all__ = [
    "plan_pipeline", "run", "run_plain", "assemble", "launches",
    "reset_launches",
]

_DTILE = 512
_MAX_STREAMS = 64
_MAX_REGS = 32
_MAX_INSTR = 256
_MAX_COLS = 64

_AGG_WHITELIST = ("sum", "count", "count_star", "avg")

# opcodes — ops/cuda/fused_codegen.py lowers each into CUDA C
(
    OP_LOAD_COL, OP_LOAD_VALID, OP_CONST_I, OP_CONST_F, OP_CONST_NULL,
    OP_ADD_I, OP_SUB_I, OP_MUL_I, OP_NEG_I,
    OP_ADD_F, OP_SUB_F, OP_MUL_F, OP_NEG_F,
    OP_RESCALE_I, OP_CAST_I2F,
    OP_EQ_I, OP_NE_I, OP_LT_I, OP_LE_I, OP_GT_I, OP_GE_I,
    OP_EQ_F, OP_NE_F, OP_LT_F, OP_LE_F, OP_GT_F, OP_GE_F,
    OP_AND3, OP_OR3, OP_NOT, OP_IS_NULL,
    OP_FILTER, OP_KEY,
    OP_EMIT_COUNT, OP_EMIT_SUM_I, OP_EMIT_SUM_F,
) = range(36)

_CMP = ("eq", "ne", "lt", "le", "gt", "ge")
_DT_CODE = {torch.int32: 0, torch.int64: 1, torch.float64: 2, torch.bool: 3}
_STREAM_KIND = {"rows": 0, "cnt": 0, "isum": 1, "fsum": 2}

_launches = 0


def launches() -> int:
    return _launches


def reset_launches() -> None:
    global _launches
    _launches = 0


class _Unsupported(Exception):
    pass


# --------------------------------------------------------------- planning
#
# Static pass over the scan-level IR: decide every subexpression's kind
# ("i32" | "dd" | "bool" — the reference's names: a narrow integer, a
# decimal-or-double number, a boolean), its decimal scale (None for doubles),
# and whether it can be NULL — rejecting anything the pipeline can't evaluate
# exactly.  The same walk deduplicates aggregate streams, and the result (a
# frozen _Recipe) carries the compiled bytecode.


@dataclass(frozen=True)
class _Recipe:
    n_cols: int
    # column table: ("data" | "valid", scan col index, dtype code)
    table: tuple
    filters: tuple  # IrExpr, scan-level
    keys: tuple     # (col_idx, domain, stride)
    domain: int
    streams: tuple  # ("rows", None) | ("cnt", e) | ("isum", e) | ("fsum", e)
    aggs: tuple     # ("count", si) | ("sum", vi, ci, scale_shift, wide)
                    # | ("fsum", vi, ci) | ("favg", vi, ci)
    program: tuple  # ((opcode, dst, a, b, imm), ...)
    n_regs: int


def _kind_of_type(t) -> tuple[str, Optional[int]]:
    """Map a column/const Type to a kind + decimal scale (None for floating
    point, 0 for integers/dates/bools)."""
    name = getattr(t, "name", "")
    if t.is_decimal:
        return "dd", t.scale
    if name in ("double", "real"):
        return "dd", None
    if name in ("integer", "date", "smallint", "tinyint"):
        return "i32", 0
    if name == "boolean":
        return "bool", 0
    raise _Unsupported(f"type {name}")


class _Planner:
    def __init__(self, cols):
        self.scan_cols = cols
        self.used: dict[int, str] = {}  # col index -> "val" | "dict"
        self.streams: list = []
        self.stream_ix: dict = {}

    def use_col(self, i: int) -> None:
        if i in self.used:
            return
        cv = self.scan_cols[i]
        if cv.data2 is not None:
            raise _Unsupported("decimal128 scan column")
        if cv.dict is not None:
            raise _Unsupported("dictionary column in expression")
        _kind_of_type(cv.type)
        self.used[i] = "val"

    def use_key(self, i: int) -> None:
        cv = self.scan_cols[i]
        if cv.dict is None or cv.valid is not None:
            raise _Unsupported("group key must be a no-null dictionary column")
        got = self.used.get(i)
        if got is not None:
            if got != "dict":
                raise _Unsupported("key column also used as a value")
            return
        self.used[i] = "dict"

    # ---- static type/nullability check: returns (kind, scale, nullable)

    def check(self, e: IrExpr) -> tuple[str, Optional[int], bool]:
        if isinstance(e, FieldRef):
            self.use_col(e.index)
            cv = self.scan_cols[e.index]
            kind, scale = _kind_of_type(cv.type)
            return kind, scale, cv.valid is not None
        if isinstance(e, Const):
            kind, scale = _kind_of_type(e.type)
            return kind, scale, e.value is None
        if isinstance(e, Call):
            return self._check_call(e)
        raise _Unsupported(f"expression {type(e).__name__}")

    def _check_call(self, e: Call):
        op = e.op
        if op in ("add", "sub", "mul", "neg"):
            sub = [self.check(a) for a in e.args]
            if any(k == "bool" for k, _, _ in sub):
                raise _Unsupported(f"{op} over boolean")
            scales = [s for _, s, _ in sub]
            if any(s is None for s in scales) != all(s is None for s in scales):
                raise _Unsupported("mixed decimal/double arithmetic")
            nullable = any(nl for _, _, nl in sub)
            okind, oscale = _kind_of_type(e.type)
            if okind != "dd":
                raise _Unsupported(f"integer {op}")
            if oscale is not None:
                if scales[0] is None:
                    raise _Unsupported("double operands with decimal result")
                if op == "mul":
                    if oscale != scales[0] + scales[1]:
                        raise _Unsupported("mul rescale")
                elif op == "neg":
                    if oscale != scales[0]:
                        raise _Unsupported("neg rescale")
                elif oscale != scales[0] or scales[0] != scales[1]:
                    raise _Unsupported(f"{op} operand scales differ")
            elif scales[0] is not None:
                raise _Unsupported("integer operands with double result")
            return "dd", oscale, nullable
        if op in _CMP:
            (k1, s1, n1), (k2, s2, n2) = self.check(e.args[0]), self.check(e.args[1])
            if "bool" in (k1, k2):
                raise _Unsupported("comparison over boolean")
            if (s1 is None) != (s2 is None) or (
                s1 is not None and s1 != s2
            ):
                raise _Unsupported("comparison operand scales differ")
            return "bool", 0, n1 or n2
        if op in ("and", "or"):
            subs = [self.check(a) for a in e.args]
            if any(k != "bool" for k, _, _ in subs):
                raise _Unsupported(f"{op} over non-boolean")
            return "bool", 0, any(nl for _, _, nl in subs)
        if op == "not":
            k, _, nl = self.check(e.args[0])
            if k != "bool":
                raise _Unsupported("not over non-boolean")
            return "bool", 0, nl
        if op == "is_null":
            self.check(e.args[0])
            return "bool", 0, False
        if op == "cast":
            k, s, nl = self.check(e.args[0])
            okind, oscale = _kind_of_type(e.type)
            if okind != "dd":
                raise _Unsupported(f"cast to {e.type}")
            if k == "bool":
                raise _Unsupported("cast from boolean")
            if oscale is None:  # -> double: any numeric source works
                return "dd", None, nl
            if k == "i32":
                return "dd", oscale, nl
            if s is None or oscale < s:
                raise _Unsupported("narrowing or float->decimal cast")
            return "dd", oscale, nl
        raise _Unsupported(f"op {op}")

    # ---- stream dedup

    def stream(self, tag: str, e: Optional[IrExpr]) -> int:
        key = (tag, e)
        got = self.stream_ix.get(key)
        if got is not None:
            return got
        ix = len(self.streams)
        if ix >= _MAX_STREAMS:
            raise _Unsupported("too many aggregate streams")
        self.streams.append((tag, e))
        self.stream_ix[key] = ix
        return ix


def _f64_bits(x: float) -> int:
    return struct.unpack("<q", struct.pack("<d", float(x)))[0]


def _bits_f64(b: int) -> float:
    return struct.unpack("<d", struct.pack("<q", int(b)))[0]


class _Compiler:
    """_Recipe pieces -> postfix bytecode.  One virtual register per distinct
    subexpression (the IR is hashable), so common subexpressions — q01's
    `extendedprice * (1 - discount)` — are evaluated once per row."""

    def __init__(self, scan_cols):
        self.scan_cols = scan_cols
        self.table: list = []  # ("data"|"valid", col, dtype code)
        self.table_ix: dict = {}
        self.prog: list = []
        self.memo: dict = {}  # IrExpr -> (reg, "I"|"F")
        self.n_regs = 0

    def slot(self, what: str, col: int) -> int:
        key = (what, col)
        got = self.table_ix.get(key)
        if got is not None:
            return got
        cv = self.scan_cols[col]
        t = cv.data if what == "data" else cv.valid
        if t.dtype not in _DT_CODE:
            raise _Unsupported(f"column dtype {t.dtype}")
        if len(self.table) >= _MAX_COLS:
            raise _Unsupported("too many scan columns")
        self.table.append((what, col, _DT_CODE[t.dtype]))
        self.table_ix[key] = len(self.table) - 1
        return len(self.table) - 1

    def reg(self) -> int:
        """A fresh VIRTUAL register; `_allocate_registers` maps them onto the
        machine's registers afterwards."""
        self.n_regs += 1
        return self.n_regs - 1

    def emit(self, op, dst=0, a=0, b=0, imm=0) -> None:
        if len(self.prog) >= _MAX_INSTR:
            raise _Unsupported(f"program longer than {_MAX_INSTR} instructions")
        self.prog.append((int(op), int(dst), int(a), int(b), int(imm)))

    def ev(self, e: IrExpr) -> tuple[int, str]:
        got = self.memo.get(e)
        if got is None:
            got = self._ev(e)
            self.memo[e] = got
        return got

    def _ev(self, e: IrExpr) -> tuple[int, str]:
        if isinstance(e, FieldRef):
            cv = self.scan_cols[e.index]
            _, scale = _kind_of_type(cv.type)
            r = self.reg()
            s = self.slot("data", e.index)
            self.emit(OP_LOAD_COL, r, s, self.table[s][2])
            if cv.valid is not None:
                self.emit(OP_LOAD_VALID, r, self.slot("valid", e.index))
            floating = cv.data.dtype.is_floating_point
            if floating != (scale is None):
                raise _Unsupported("column lanes do not match the column type")
            return r, ("F" if floating else "I")
        if isinstance(e, Const):
            _, scale = _kind_of_type(e.type)
            r = self.reg()
            ty = "F" if scale is None else "I"
            if e.value is None:
                self.emit(OP_CONST_NULL, r)
            elif ty == "F":
                self.emit(OP_CONST_F, r, imm=_f64_bits(e.value))
            else:
                hi, lo = dec128.split_py(int(e.value))
                self.emit(OP_CONST_I, r, b=hi, imm=lo)
            return r, ty
        assert isinstance(e, Call)
        op = e.op
        if op in ("add", "sub", "mul"):
            (ra, ta), (rb, _) = self.ev(e.args[0]), self.ev(e.args[1])
            r = self.reg()
            base = {"add": OP_ADD_I, "sub": OP_SUB_I, "mul": OP_MUL_I}[op]
            self.emit(base + (4 if ta == "F" else 0), r, ra, rb)
            return r, ta
        if op == "neg":
            ra, ta = self.ev(e.args[0])
            r = self.reg()
            self.emit(OP_NEG_F if ta == "F" else OP_NEG_I, r, ra)
            return r, ta
        if op in _CMP:
            (ra, ta), (rb, _) = self.ev(e.args[0]), self.ev(e.args[1])
            r = self.reg()
            self.emit((OP_EQ_F if ta == "F" else OP_EQ_I) + _CMP.index(op), r, ra, rb)
            return r, "I"
        if op in ("and", "or"):
            acc, _ = self.ev(e.args[0])
            for a in e.args[1:]:
                rb, _ = self.ev(a)
                r = self.reg()
                self.emit(OP_AND3 if op == "and" else OP_OR3, r, acc, rb)
                acc = r
            return acc, "I"
        if op == "not":
            ra, _ = self.ev(e.args[0])
            r = self.reg()
            self.emit(OP_NOT, r, ra)
            return r, "I"
        if op == "is_null":
            ra, _ = self.ev(e.args[0])
            r = self.reg()
            self.emit(OP_IS_NULL, r, ra)
            return r, "I"
        if op == "cast":
            ra, ta = self.ev(e.args[0])
            s = _kind_of_type(e.args[0].type)[1]
            oscale = _kind_of_type(e.type)[1]
            if oscale is None:
                if ta == "F":
                    return ra, "F"
                r = self.reg()
                # divide by 10^scale, exactly as the expression evaluator's
                # decimal -> double cast does
                self.emit(OP_CAST_I2F, r, ra, imm=_f64_bits(10.0 ** (s or 0)))
                return r, "F"
            shift = oscale - (s if s is not None else oscale)
            if not shift:
                return ra, "I"
            r = self.reg()
            hi, lo = dec128.split_py(10 ** shift)
            self.emit(OP_RESCALE_I, r, ra, hi, lo)
            return r, "I"
        raise AssertionError(op)  # the planner vetted the tree


_BINARY_OPS = frozenset(
    [OP_ADD_I, OP_SUB_I, OP_MUL_I, OP_ADD_F, OP_SUB_F, OP_MUL_F, OP_AND3, OP_OR3]
    + list(range(OP_EQ_I, OP_GE_F + 1))
)
_UNARY_OPS = frozenset(
    [OP_NEG_I, OP_NEG_F, OP_RESCALE_I, OP_CAST_I2F, OP_NOT, OP_IS_NULL]
)
_DEFINING_OPS = frozenset([OP_LOAD_COL, OP_CONST_I, OP_CONST_F, OP_CONST_NULL])


def _register_reads(ins) -> list[int]:
    op, dst, a, b, _ = ins
    if op in _BINARY_OPS:
        return [a, b]
    if op in _UNARY_OPS or op == OP_FILTER:
        return [a]
    if op == OP_LOAD_VALID:
        return [dst]  # read-modify-write of the validity bit
    if op in (OP_EMIT_SUM_I, OP_EMIT_SUM_F) or (op == OP_EMIT_COUNT and b >= 0):
        return [b]
    return []


def _allocate_registers(prog):
    """Map the compiler's virtual registers onto as few machine registers as
    their live ranges allow (linear scan over the straight-line program):
    q01's fifteen values fit six registers.  Returns (program, registers
    used)."""
    last_use: dict[int, int] = {}
    for i, ins in enumerate(prog):
        op, dst = ins[0], ins[1]
        if op in _DEFINING_OPS or op in _BINARY_OPS or op in _UNARY_OPS:
            last_use.setdefault(dst, i)
        for v in _register_reads(ins):
            last_use[v] = i
    phys: dict[int, int] = {}
    free: list[int] = []
    used = 0
    out = []
    for i, ins in enumerate(prog):
        op, dst, a, b, imm = ins
        reads = _register_reads(ins)
        mapped = {v: phys[v] for v in reads}
        for v in set(reads):
            if last_use[v] == i and not (op == OP_LOAD_VALID and v == dst):
                free.append(phys.pop(v))
        writes = op in _DEFINING_OPS or op in _BINARY_OPS or op in _UNARY_OPS
        if writes:
            if free:
                free.sort()
                phys[dst] = free.pop(0)
            else:
                phys[dst] = used
                used += 1
        if op in _BINARY_OPS:
            out.append((op, phys[dst], mapped[a], mapped[b], imm))
        elif op in _UNARY_OPS:
            out.append((op, phys[dst], mapped[a], b, imm))
        elif op == OP_FILTER:
            out.append((op, dst, mapped[a], b, imm))
        elif op == OP_LOAD_VALID or writes:
            out.append((op, phys[dst], a, b, imm))
        elif reads:  # EMIT over a register
            out.append((op, dst, a, mapped[b], imm))
        else:
            out.append(ins)
        if (writes or op == OP_LOAD_VALID) and last_use[dst] == i:
            free.append(phys.pop(dst))  # defined and never read again
    return out, used


def plan_pipeline(scan_cols, filters, key_exprs, agg_fns, agg_args, agg_types):
    """Try to compile the fused pipeline.  Returns (recipe, "") on success or
    (None, reason) when any piece falls outside the pipeline's reach —
    the caller then runs the regular operator-at-a-time path."""
    p = _Planner(scan_cols)
    try:
        for f in filters:
            k, _, _ = p.check(f)
            if k != "bool":
                raise _Unsupported("non-boolean filter")
        keys = []
        domain = 1
        for ke in key_exprs:
            if not isinstance(ke, FieldRef):
                raise _Unsupported("computed group key")
            p.use_key(ke.index)
            d = len(p.scan_cols[ke.index].dict)
            keys.append((ke.index, d))
            domain *= max(d, 1)
        if domain > _DTILE:
            raise _Unsupported(f"key domain {domain} > {_DTILE}")
        rows_s = p.stream("rows", None)
        aggs = []
        for fn, arg, otype in zip(agg_fns, agg_args, agg_types):
            if fn not in _AGG_WHITELIST:
                raise _Unsupported(f"agg {fn}")
            if fn == "count_star":
                aggs.append(("count", rows_s))
                continue
            kind, scale, nullable = p.check(arg)
            if kind == "bool":
                raise _Unsupported(f"{fn} over boolean")
            cnt_s = rows_s if not nullable else p.stream("cnt", arg)
            if fn == "count":
                aggs.append(("count", cnt_s))
                continue
            okind, oscale = _kind_of_type(otype)
            if okind != "dd":
                raise _Unsupported(f"{fn} result {otype}")
            if scale is None:  # floating point in
                if oscale is not None:
                    raise _Unsupported(f"float {fn} with decimal result")
                val_s = p.stream("fsum", arg)
                aggs.append((("fsum" if fn == "sum" else "favg"), val_s, cnt_s))
                continue
            if oscale is None or oscale < scale:
                raise _Unsupported(f"{fn} result rescale")
            if fn == "avg":
                raise _Unsupported("avg with decimal result")
            wide = bool(getattr(otype, "precision", 18) > 18)
            aggs.append(("sum", p.stream("isum", arg), cnt_s, oscale - scale, wide))

        # mixed-radix strides, first key most significant (matches nested order)
        strides = []
        acc = 1
        for _, d in reversed(keys):
            strides.append(acc)
            acc *= max(d, 1)
        strides.reverse()
        keys3 = tuple((i, d, s) for (i, d), s in zip(keys, strides))

        # ---- bytecode: filters (each row leaves at its first failed one),
        # then keys, then one EMIT per stream
        c = _Compiler(scan_cols)
        for f in filters:
            r, _ = c.ev(f)
            c.emit(OP_FILTER, a=r)
        for ci, d, stride in keys3:
            c.emit(OP_KEY, a=c.slot("data", ci), b=max(d, 1), imm=stride)
        for si, (tag, e) in enumerate(p.streams):
            if tag == "rows":
                c.emit(OP_EMIT_COUNT, a=si, b=-1)
                continue
            r, ty = c.ev(e)
            if tag == "cnt":
                c.emit(OP_EMIT_COUNT, a=si, b=r)
            elif tag == "isum":
                assert ty == "I"
                c.emit(OP_EMIT_SUM_I, a=si, b=r)
            else:
                assert ty == "F"
                c.emit(OP_EMIT_SUM_F, a=si, b=r)
        program, n_regs = _allocate_registers(c.prog)
        if n_regs > _MAX_REGS:
            raise _Unsupported(f"expression needs more than {_MAX_REGS} registers")
    except _Unsupported as ex:
        return None, str(ex)
    recipe = _Recipe(
        n_cols=len(scan_cols),
        table=tuple(c.table),
        filters=tuple(filters),
        keys=keys3,
        domain=domain,
        streams=tuple(p.streams),
        aggs=tuple(aggs),
        program=tuple(program),
        n_regs=n_regs,
    )
    return recipe, ""


# ----------------------------------------------------------------- running


def _table_tensors(recipe: _Recipe, scan_cols) -> list[torch.Tensor]:
    out = []
    for what, col, code in recipe.table:
        cv = scan_cols[col]
        t = cv.data if what == "data" else cv.valid
        if t is None or _DT_CODE.get(t.dtype) != code:
            raise TypeError(
                f"fused_pipeline: scan column {col} ({what}) does not match "
                f"the dtype the recipe was planned for"
            )
        out.append(t)
    return out


def run(recipe: _Recipe, scan_cols, live: Optional[torch.Tensor]):
    """Execute the fused pipeline.

    Returns totals, an int64 tensor [streams, 2, D]: per stream and group,
    word 0 holds the count, the low limb of an integer sum or the bits of a
    double sum, word 1 the high limb of an integer sum.  The caller
    assembles aggregate columns via `assemble`.

    `live` is the page's bool row mask (None == every row live)."""
    tensors = _table_tensors(recipe, scan_cols)
    if not tensors and live is None:
        raise ValueError("fused_pipeline: a recipe that reads no column needs a live mask")
    dev = tensors[0].device if tensors else live.device
    if dev.type == "cuda":
        return _run_cuda(recipe, tensors, live, dev)
    return run_plain(recipe, scan_cols, live)


def _run_cuda(recipe, tensors, live, dev):
    global _launches
    from . import fused_codegen, nvrtc

    n = tensors[0].shape[0] if tensors else live.shape[0]
    for t in tensors + ([live] if live is not None else []):
        if t.device != dev:
            raise ValueError(f"fused_pipeline: input on {t.device}, expected {dev}")
        if t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(
                f"fused_pipeline: inputs must be contiguous [{n}] columns,"
                f" got {tuple(t.shape)}"
            )
    if live is not None and live.dtype != torch.bool:
        raise TypeError(f"fused_pipeline: live must be bool, got {live.dtype}")
    totals = torch.empty(
        (len(recipe.streams), 2, recipe.domain), dtype=torch.int64, device=dev
    )
    with torch.cuda.device(dev):
        nvrtc.bind_context(dev.index)
        stream = torch.cuda.current_stream().cuda_stream
        nvrtc.memset_async(totals.data_ptr(), totals.numel() * 8, stream)
        if n == 0:
            return totals
        kern, gen = fused_codegen.kernel_for(recipe, dev.index)
        words = fused_codegen.constants(recipe) or [0]
        args = [ctypes.c_void_p(t.data_ptr()) for t in tensors] + [
            ctypes.c_void_p(None if live is None else live.data_ptr()),
            ctypes.c_longlong(n),
            (ctypes.c_uint64 * len(words))(*words),
            ctypes.c_void_p(totals.data_ptr()),
        ]
        per_sm = kern.blocks_per_sm(gen.threads, gen.smem)
        if per_sm < 1:
            raise RuntimeError(f"fused_pipeline: {gen.name} cannot fit one block on an SM")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        rows_per_step = gen.threads * gen.rows_per_thread
        grid = min(-(-n // rows_per_step), sms * per_sm)
        kern.launch(grid, gen.threads, gen.smem, stream, args)
    _launches += 1
    return totals


# ------------------------------------------- plain version: same bytecode


def _i128_to_f64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(lo, hi) -> double, the way ops/expr.py casts decimal128: signed low
    limb plus the adjusted high limb (exact when the value fits 64 bits)."""
    hi_adj = hi + (lo < 0).to(hi.dtype)
    return lo.to(torch.float64) + hi_adj.to(torch.float64) * float(2**64)


def run_plain(recipe: _Recipe, scan_cols, live: Optional[torch.Tensor]):
    """Vectorised interpreter of the recipe's bytecode in plain PyTorch: one
    tensor op per instruction over all rows.  Same totals layout as `run`."""
    tensors = _table_tensors(recipe, scan_cols)
    dev = tensors[0].device if tensors else live.device
    n = tensors[0].shape[0] if tensors else live.shape[0]
    D = recipe.domain
    ones = torch.ones((n,), dtype=torch.bool, device=dev)
    mask = ones if live is None else live
    # register file: I registers are (lo, hi) int64 pairs, F registers a
    # float64 tensor; `valid` holds a bool tensor or None (== all valid)
    val: dict[int, object] = {}
    valid: dict[int, Optional[torch.Tensor]] = {}
    code = torch.zeros((n,), dtype=torch.int64, device=dev)
    totals = torch.zeros((len(recipe.streams), 2, D), dtype=torch.int64, device=dev)

    def both(a, b):
        va, vb = valid[a], valid[b]
        if va is None:
            return vb
        return va if vb is None else (va & vb)

    def full_i(lo: int, hi: int):
        return (
            torch.full((n,), lo, dtype=torch.int64, device=dev),
            torch.full((n,), hi, dtype=torch.int64, device=dev),
        )

    def truth(r):
        lo, hi = val[r]
        return (lo != 0) | (hi != 0)

    def seg_for(ok):
        return torch.where(ok, code, torch.full_like(code, D))

    for op, dst, a, b, imm in recipe.program:
        if op == OP_LOAD_COL:
            t = tensors[a]
            if b == _DT_CODE[torch.float64]:
                val[dst] = t
            else:
                lo = t.to(torch.int64)
                val[dst] = (lo, torch.zeros_like(lo) if t.dtype == torch.bool else lo >> 63)
            valid[dst] = None
        elif op == OP_LOAD_VALID:
            v = tensors[a]
            valid[dst] = v if valid[dst] is None else (valid[dst] & v)
        elif op == OP_CONST_I:
            val[dst] = full_i(imm, b)
            valid[dst] = None
        elif op == OP_CONST_F:
            val[dst] = torch.full((n,), _bits_f64(imm), dtype=torch.float64, device=dev)
            valid[dst] = None
        elif op == OP_CONST_NULL:
            val[dst] = full_i(0, 0)
            valid[dst] = ~ones
        elif op in (OP_ADD_I, OP_SUB_I, OP_MUL_I):
            fn = {OP_ADD_I: dec128.add128, OP_SUB_I: dec128.sub128,
                  OP_MUL_I: dec128.mul128}[op]
            val[dst] = fn(*val[a], *val[b])
            valid[dst] = both(a, b)
        elif op == OP_NEG_I:
            val[dst] = dec128.neg128(*val[a])
            valid[dst] = valid[a]
        elif op in (OP_ADD_F, OP_SUB_F, OP_MUL_F):
            x, y = val[a], val[b]
            val[dst] = x + y if op == OP_ADD_F else (x - y if op == OP_SUB_F else x * y)
            valid[dst] = both(a, b)
        elif op == OP_NEG_F:
            val[dst] = -val[a]
            valid[dst] = valid[a]
        elif op == OP_RESCALE_I:
            val[dst] = dec128.mul128(*val[a], *full_i(imm, b))
            valid[dst] = valid[a]
        elif op == OP_CAST_I2F:
            val[dst] = _i128_to_f64(*val[a]) / _bits_f64(imm)
            valid[dst] = valid[a]
        elif OP_EQ_I <= op <= OP_GE_I:
            lt, eq = dec128.cmp128(*val[a], *val[b])
            out = {
                "eq": eq, "ne": ~eq, "lt": lt, "le": lt | eq,
                "gt": ~(lt | eq), "ge": ~lt,
            }[_CMP[op - OP_EQ_I]]
            lo = out.to(torch.int64)
            val[dst] = (lo, torch.zeros_like(lo))
            valid[dst] = both(a, b)
        elif OP_EQ_F <= op <= OP_GE_F:
            fn = (torch.eq, torch.ne, torch.lt, torch.le, torch.gt, torch.ge)[op - OP_EQ_F]
            lo = fn(val[a], val[b]).to(torch.int64)
            val[dst] = (lo, torch.zeros_like(lo))
            valid[dst] = both(a, b)
        elif op in (OP_AND3, OP_OR3):
            va = ones if valid[a] is None else valid[a]
            vb = ones if valid[b] is None else valid[b]
            da, db = truth(a), truth(b)
            t1, t2 = da & va, db & vb
            f1, f2 = ~da & va, ~db & vb
            if op == OP_AND3:
                data = t1 & t2
                known = f1 | f2 | data
            else:
                data = t1 | t2
                known = (f1 & f2) | data
            lo = data.to(torch.int64)
            val[dst] = (lo, torch.zeros_like(lo))
            valid[dst] = None if (valid[a] is None and valid[b] is None) else known
        elif op == OP_NOT:
            lo = (~truth(a)).to(torch.int64)
            val[dst] = (lo, torch.zeros_like(lo))
            valid[dst] = valid[a]
        elif op == OP_IS_NULL:
            isn = ~ones if valid[a] is None else ~valid[a]
            lo = isn.to(torch.int64)
            val[dst] = (lo, torch.zeros_like(lo))
            valid[dst] = None
        elif op == OP_FILTER:
            ok = truth(a)
            if valid[a] is not None:
                ok = ok & valid[a]  # NULL -> the row fails
            mask = mask & ok
        elif op == OP_KEY:
            c = tensors[a].to(torch.int64)
            mask = mask & (c >= 0) & (c < b)
            code = code + c * imm
        elif op == OP_EMIT_COUNT:
            ok = mask if (b < 0 or valid[b] is None) else (mask & valid[b])
            acc = torch.zeros((D + 1,), dtype=torch.int64, device=dev)
            totals[a, 0] = acc.index_add_(0, seg_for(mask), ok.to(torch.int64))[:D]
        elif op == OP_EMIT_SUM_I:
            ok = mask if valid[b] is None else (mask & valid[b])
            seg = seg_for(mask)
            sums = []
            for limb in dec128.limbs32(*val[b]):
                acc = torch.zeros((D + 1,), dtype=torch.int64, device=dev)
                limb = torch.where(ok, limb, torch.zeros_like(limb))
                sums.append(acc.index_add_(0, seg, limb)[:D])
            lo, hi = dec128.recombine32(*sums)
            totals[a, 0] = lo
            totals[a, 1] = hi
        elif op == OP_EMIT_SUM_F:
            ok = mask if valid[b] is None else (mask & valid[b])
            x = torch.where(ok, val[b], torch.zeros_like(val[b]))
            acc = torch.zeros((D + 1,), dtype=torch.float64, device=dev)
            totals[a, 0] = acc.index_add_(0, seg_for(mask), x)[:D].view(torch.int64)
        else:
            raise ValueError(f"fused_pipeline: unknown opcode {op}")
    return totals


# ---------------------------------------------------------------- assemble


def assemble(recipe: _Recipe, totals: torch.Tensor):
    """Turn raw stream totals into aggregate output columns.

    Returns (key_codes list of (D,) int32, agg_cols list of tuples shaped
    like relops group_aggregate outputs — (data, valid) or the decimal128
    4-tuple (lo, valid, None, hi) — out_live (D,) bool, n_groups)."""
    D = recipe.domain
    dev = totals.device
    rows_ix = 0  # stream 0 is always the row-mask stream
    for ix, (tag, _) in enumerate(recipe.streams):
        if tag == "rows":
            rows_ix = ix
            break
    rows = totals[rows_ix, 0]
    if recipe.keys:
        out_live = rows > 0
        n_groups = out_live.sum(dtype=torch.int64)
    else:
        out_live = torch.ones((1,), dtype=torch.bool, device=dev)
        n_groups = torch.ones((), dtype=torch.int64, device=dev)

    # decode group index -> key codes (host-side iota tables), first key
    # most significant
    key_codes = []
    lanes = np.arange(D, dtype=np.int64)
    for _, d, stride in recipe.keys:
        codes = ((lanes // stride) % max(d, 1)).astype(np.int32)
        key_codes.append(torch.from_numpy(codes).to(dev))

    agg_cols = []
    for spec in recipe.aggs:
        if spec[0] == "count":
            agg_cols.append((totals[spec[1], 0], None))
            continue
        if spec[0] in ("fsum", "favg"):
            _, val_s, cnt_s = spec
            tot = totals[val_s, 0].view(torch.float64)
            cnt = totals[cnt_s, 0]
            nonempty = cnt > 0
            if spec[0] == "favg":
                ones = torch.ones_like(cnt)
                tot = tot / torch.where(nonempty, cnt, ones).to(torch.float64)
            agg_cols.append((tot, nonempty))
            continue
        _, val_s, cnt_s, shift, wide = spec
        lo, hi = totals[val_s, 0], totals[val_s, 1]
        if shift:
            f_hi, f_lo = dec128.split_py(10 ** shift)
            lo, hi = dec128.mul128(
                lo, hi, torch.full_like(lo, f_lo), torch.full_like(hi, f_hi)
            )
        nonempty = totals[cnt_s, 0] > 0
        if wide:
            agg_cols.append((lo, nonempty, None, hi))
        else:
            agg_cols.append((lo, nonempty))
    return key_codes, agg_cols, out_live, n_groups
