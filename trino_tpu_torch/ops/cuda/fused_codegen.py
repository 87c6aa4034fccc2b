"""One CUDA kernel per fused-pipeline recipe, generated and compiled at run time.

The reference generates one Pallas kernel per recipe from the plan's
expression tree (trino_tpu/ops/pallas/fused.py `_fused_kernel`); the port
does the same from the recipe's bytecode (`fused.plan_pipeline`).  The
bytecode stays the IR: `fused.run_plain` interprets it on CPU tensors, and
this module lowers it into straight-line CUDA C — each machine register a
set of local variables, each instruction one statement — around the fixed
helpers in csrc/fused_pipeline.cuh.  NVRTC compiles the result for sm_90a
(ops/cuda/nvrtc.py).

What is compiled in and what is passed: the program's structure, the column
dtypes, the key domain D and the stream kinds make the kernel; constants
(decimal literals, rescale factors, cast divisors) are kernel arguments, so
a statement re-run with other literals reuses its kernel.  `cache_key` is a
digest of exactly the compiled-in parts (never of a pointer or a value).
Kernels are cached in the process and, as cubins, on disk under
trino_tpu_torch/build/nvrtc/ (delete the directory to clear it).

Accumulation routes (`route_for`, by the size of the S x D table): "reg" —
D = 1, each thread sums in registers over its whole loop; "warp" — each
warp pre-aggregates the lanes that share a group code and its leader adds
into the warp's private table in shared memory; "global" — tables too large
for shared memory take global atomics per row.
"""

from __future__ import annotations

import functools
import hashlib
import threading
from dataclasses import dataclass
from fractions import Fraction
from pathlib import Path

from . import nvrtc
from .fused import (
    OP_ADD_F, OP_ADD_I, OP_AND3, OP_CAST_I2F, OP_CONST_F, OP_CONST_I,
    OP_CONST_NULL, OP_EMIT_COUNT, OP_EMIT_SUM_F, OP_EMIT_SUM_I, OP_EQ_F,
    OP_EQ_I, OP_FILTER, OP_GE_F, OP_GE_I, OP_IS_NULL, OP_KEY, OP_LOAD_COL,
    OP_LOAD_VALID, OP_MUL_F, OP_MUL_I, OP_NEG_F, OP_NEG_I, OP_NOT, OP_OR3,
    OP_RESCALE_I, OP_SUB_F, OP_SUB_I, _DTILE, _MAX_COLS, _MAX_INSTR,
    _MAX_REGS, _MAX_STREAMS, _STREAM_KIND, _bits_f64, _f64_bits,
)

__all__ = [
    "FusedCodegenError", "Generated", "generate", "cache_key", "constants",
    "route_for", "cubin_stem", "kernel_for", "compile_info", "clear_cache", "THREADS",
]

THREADS = 128
# Rows a thread takes from its warp's tile per step (32 apart), by route.
# Chosen by measurement on the H100 (PERF.md, Findings): two rows keep
# more loads in flight, but a warp-route thread holding two rows' eight
# 128-bit streams runs out of registers.
_ROWS = {"reg": 2, "warp": 1, "global": 2}
_WARP_TABLE_BYTES = 96 * 1024   # "warp" route: all warps' tables of one block
_OPTIONS = ("--device-int128", "--std=c++17", "--fmad=false", "--ptxas-options=-v")

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
_HEADER = "fused_pipeline.cuh"
CACHE_DIR = Path(__file__).resolve().parents[2] / "build" / "nvrtc"

_DT_PTR = {0: "const int*", 1: "const long long*", 2: "const double*", 3: "const unsigned char*"}
_COUNT, _ISUM, _FSUM = 0, 1, 2
_CMP_C = ("==", "!=", "<", "<=", ">", ">=")
_BIN_C = {OP_ADD_I: "+", OP_SUB_I: "-", OP_MUL_I: "*", OP_ADD_F: "+", OP_SUB_F: "-", OP_MUL_F: "*"}


class FusedCodegenError(ValueError):
    """A recipe outside what the generated kernel takes."""


@dataclass(frozen=True)
class Generated:
    key: str
    name: str      # the kernel's `extern "C"` name
    source: str    # the generated part, which includes the fixed header
    route: str     # "reg" | "warp" | "global"
    threads: int   # threads per block
    smem: int      # dynamic shared memory per block, bytes
    rows_per_thread: int
    n_consts: int  # 64-bit words of the constants argument


def _check_limits(recipe) -> None:
    s = len(recipe.streams)
    if not 1 <= s <= _MAX_STREAMS:
        raise FusedCodegenError(f"{s} aggregate streams (the kernel takes 1..{_MAX_STREAMS})")
    if not 1 <= recipe.domain <= _DTILE:
        raise FusedCodegenError(f"key domain {recipe.domain} (the kernel takes 1..{_DTILE})")
    if len(recipe.program) > _MAX_INSTR:
        raise FusedCodegenError(f"{len(recipe.program)} instructions (at most {_MAX_INSTR})")
    if len(recipe.table) > _MAX_COLS:
        raise FusedCodegenError(f"{len(recipe.table)} columns (at most {_MAX_COLS})")
    if recipe.n_regs > _MAX_REGS:
        raise FusedCodegenError(f"{recipe.n_regs} registers (at most {_MAX_REGS})")
    for op, *_ in recipe.program:
        if not OP_LOAD_COL <= op <= OP_EMIT_SUM_F:
            raise FusedCodegenError(f"unknown opcode {op}")


def _structure(recipe) -> tuple:
    """The program with its constants replaced by their argument slots."""
    out, w = [], 0
    for op, dst, a, b, imm in recipe.program:
        if op in (OP_CONST_I, OP_RESCALE_I):
            out.append((op, dst, a, -1, w))
            w += 2
        elif op == OP_CONST_F:
            out.append((op, dst, a, -1, w))
            w += 1
        elif op == OP_CAST_I2F:  # the divisor and its rounded reciprocal
            out.append((op, dst, a, -1, w))
            w += 2
        else:
            out.append((op, dst, a, b, imm))
    return tuple(out), w


def constants(recipe) -> list[int]:
    """The constants argument: unsigned 64-bit words in instruction order
    ((lo, hi) of an integer, the bits of a double; a cast's divisor d and
    RN(1 / d))."""
    words = []
    for op, _, _, b, imm in recipe.program:
        if op in (OP_CONST_I, OP_RESCALE_I):
            words += [imm & 0xFFFFFFFFFFFFFFFF, b & 0xFFFFFFFFFFFFFFFF]
        elif op == OP_CONST_F:
            words.append(imm & 0xFFFFFFFFFFFFFFFF)
        elif op == OP_CAST_I2F:
            d = _bits_f64(imm)
            words += [imm & 0xFFFFFFFFFFFFFFFF,
                      _f64_bits(float(Fraction(1) / Fraction(d))) & 0xFFFFFFFFFFFFFFFF]
    return words


def _smem(route: str, kinds: list[int], D: int) -> int:
    if route == "warp":
        return (THREADS // 32) * len(kinds) * D * 16
    return 0


def route_for(recipe) -> tuple[str, int]:
    """(route, dynamic shared bytes) for a recipe's table of S x D slots."""
    kinds = [_STREAM_KIND[tag] for tag, _ in recipe.streams]
    d = recipe.domain
    if d == 1:
        return "reg", 0
    if _smem("warp", kinds, d) <= _WARP_TABLE_BYTES:
        return "warp", _smem("warp", kinds, d)
    return "global", 0


@functools.lru_cache(maxsize=1)
def _template_digest() -> str:
    h = hashlib.sha256((_CSRC / _HEADER).read_bytes())
    # the generator and the compile step are part of every kernel
    h.update(Path(__file__).read_bytes())
    h.update(Path(nvrtc.__file__).read_bytes())
    return h.hexdigest()


def cache_key(recipe) -> str:
    """Digest of what is compiled into a recipe's kernel: the program's
    structure, the column dtypes, D, the stream kinds, the route, the target
    architecture, the compiler options and the fixed sources.  The compiler's
    own version is added to the name of the cubin on disk (`kernel_for`)."""
    structure, _ = _structure(recipe)
    parts = (
        structure,
        tuple(code for _, _, code in recipe.table),
        recipe.domain,
        tuple(_STREAM_KIND[tag] for tag, _ in recipe.streams),
        route_for(recipe)[0],
        THREADS,
        nvrtc.ARCH,
        _OPTIONS,
        _template_digest(),
    )
    return hashlib.sha256(repr(parts).encode()).hexdigest()[:32]


def cubin_stem(key: str, compiler_version: str) -> str:
    """File name (without suffix) of a kernel's cubin in CACHE_DIR: its
    cache key and the NVRTC version that compiled it."""
    return f"{key}-nvrtc{compiler_version}"


# ------------------------------------------------------------------ lowering


def _lower(ins, j: int) -> list[str]:
    """One bytecode instruction for row j of the thread, as C statements."""
    op, d, a, b, w = ins
    I = lambda k: f"I{k}_{j}"  # noqa: E731 - register views
    F = lambda k: f"F{k}_{j}"  # noqa: E731
    V = lambda k: f"V{k}_{j}"  # noqa: E731
    alive, code = f"a{j}", f"code{j}"
    if op == OP_LOAD_COL:
        col = f"L{a}_{j}"
        if b == 2:
            return [f"{F(d)} = {col}; {V(d)} = true;"]
        if b == 3:
            return [f"{I(d)} = (u128){col}; {V(d)} = true;"]
        return [f"{I(d)} = (u128)(i128)(long long){col}; {V(d)} = true;"]
    if op == OP_LOAD_VALID:
        return [f"{V(d)} = {V(d)} && (L{a}_{j} != 0);"]
    if op == OP_CONST_I:
        return [f"{I(d)} = KI({w}); {V(d)} = true;"]
    if op == OP_CONST_F:
        return [f"{F(d)} = KF({w}); {V(d)} = true;"]
    if op == OP_CONST_NULL:
        return [f"{I(d)} = 0; {F(d)} = 0.0; {V(d)} = false;"]
    if op in (OP_ADD_I, OP_SUB_I, OP_MUL_I):
        return [f"{I(d)} = {I(a)} {_BIN_C[op]} {I(b)}; {V(d)} = {V(a)} && {V(b)};"]
    if op in (OP_ADD_F, OP_SUB_F, OP_MUL_F):
        return [f"{F(d)} = {F(a)} {_BIN_C[op]} {F(b)}; {V(d)} = {V(a)} && {V(b)};"]
    if op == OP_NEG_I:
        return [f"{I(d)} = (u128)0 - {I(a)}; {V(d)} = {V(a)};"]
    if op == OP_NEG_F:
        return [f"{F(d)} = -{F(a)}; {V(d)} = {V(a)};"]
    if op == OP_RESCALE_I:
        return [f"{I(d)} = {I(a)} * KI({w}); {V(d)} = {V(a)};"]
    if op == OP_CAST_I2F:
        return [f"{F(d)} = div_by(i128_to_f({I(a)}), KF({w}), KF({w + 1})); {V(d)} = {V(a)};"]
    if OP_EQ_I <= op <= OP_GE_I:
        c = _CMP_C[op - OP_EQ_I]
        return [f"{I(d)} = ((i128){I(a)} {c} (i128){I(b)}) ? 1 : 0; {V(d)} = {V(a)} && {V(b)};"]
    if OP_EQ_F <= op <= OP_GE_F:
        c = _CMP_C[op - OP_EQ_F]
        return [f"{I(d)} = ({F(a)} {c} {F(b)}) ? 1 : 0; {V(d)} = {V(a)} && {V(b)};"]
    if op in (OP_AND3, OP_OR3):
        if op == OP_AND3:
            data, known = "t1 && t2", "f1 || f2 || (t1 && t2)"
        else:
            data, known = "t1 || t2", "(f1 && f2) || t1 || t2"
        return [
            f"{{ const bool da = {I(a)} != 0, db = {I(b)} != 0;"
            f" const bool t1 = da && {V(a)}, t2 = db && {V(b)};"
            f" const bool f1 = !da && {V(a)}, f2 = !db && {V(b)};"
            f" {I(d)} = ({data}) ? 1 : 0; {V(d)} = {known}; }}"
        ]
    if op == OP_NOT:
        return [f"{I(d)} = ({I(a)} != 0) ? 0 : 1; {V(d)} = {V(a)};"]
    if op == OP_IS_NULL:
        return [f"{I(d)} = {V(a)} ? 0 : 1; {V(d)} = true;"]
    if op == OP_FILTER:  # NULL -> the row fails
        return [f"{alive} = {alive} && {V(a)} && ({I(a)} != 0);"]
    if op == OP_KEY:  # a code outside the dictionary kills the row
        return [
            f"{{ const long long c = (long long)L{a}_{j};"
            f" if (c < 0 || c >= {b}LL) {alive} = false; {code} += c * {w}LL; }}"
        ]
    if op == OP_EMIT_COUNT:
        return [f"ok{a}_{j} = {alive}" + ("" if b < 0 else f" && {V(b)}") + ";"]
    if op == OP_EMIT_SUM_I:
        return [f"ok{a}_{j} = {alive} && {V(b)}; v{a}_{j} = {I(b)};"]
    if op == OP_EMIT_SUM_F:
        return [f"ok{a}_{j} = {alive} && {V(b)}; f{a}_{j} = {F(b)};"]
    raise FusedCodegenError(f"unknown opcode {op}")


def _accumulate(route: str, kinds: list[int], D: int, R: int) -> list[str]:
    """Fold the tile's stream values (R rows a thread) into the route's
    accumulators."""
    out = []
    rows = range(R)
    if route == "reg":
        # D = 1: one accumulator per stream in registers
        for j in rows:
            for s, k in enumerate(kinds):
                if k == _COUNT:
                    out.append(f"acc{s} += ok{s}_{j} ? 1ull : 0ull;")
                elif k == _ISUM:
                    out.append(f"if (ok{s}_{j}) acc{s} += v{s}_{j};")
                else:
                    out.append(f"if (ok{s}_{j}) acc{s} += f{s}_{j};")
        return out
    if route == "global":
        for j in rows:
            for s, k in enumerate(kinds):
                slot = f"totals + {2 * s * D} + code{j}"
                if k == _COUNT:
                    out.append(f"if (ok{s}_{j}) atomicAdd({slot}, 1ull);")
                elif k == _ISUM:
                    out.append(f"if (ok{s}_{j}) add_i128_global({slot}, {slot} + {D}, v{s}_{j});")
                else:
                    out.append(f"if (ok{s}_{j}) atomicAdd((double*)({slot}), f{s}_{j});")
        return out
    # "warp": the lanes sharing a code pre-aggregate (the R rows' reductions
    # interleaved); each leader then updates this warp's private table with
    # plain loads and stores, one row slot after the other
    any_alive = " || ".join(f"a{j}" for j in rows)
    out.append(f"if (__any_sync(WARP_FULL, {any_alive})) {{")
    out.append(f"  unsigned peers[{R}]; PeerSched ps[{R}]; bool lead[{R}];")
    for j in rows:
        out.append(f"  peers[{j}] = __match_any_sync(WARP_FULL, a{j} ? (unsigned)code{j} : 0xffffffffu);")
    out.append("  const int steps = peer_schedule(peers, lane, ps);")
    for j in rows:
        out.append(f"  lead[{j}] = a{j} && lane == __ffs(peers[{j}]) - 1;")
    summed = []
    for s, k in enumerate(kinds):
        if k == _COUNT:
            vals = ", ".join(f"(unsigned)__popc(peers[{j}] & __ballot_sync(WARP_FULL, ok{s}_{j}))"
                             for j in rows)
            out.append(f"  const unsigned x{s}[{R}] = {{{vals}}};")
        elif k == _ISUM:
            vals = ", ".join(f"ok{s}_{j} ? v{s}_{j} : (u128)0" for j in rows)
            out.append(f"  u128 x{s}[{R}] = {{{vals}}};")
            summed.append(s)
        else:
            vals = ", ".join(f"ok{s}_{j} ? f{s}_{j} : 0.0" for j in rows)
            out.append(f"  double x{s}[{R}] = {{{vals}}};")
            summed.append(s)
    # every stream's reduction steps in one loop: one branch per step
    out.append("#pragma unroll")
    out.append("  for (int i = 0; i < 5; ++i) {")
    out.append("    if (i >= steps) break;")
    for j in rows:
        out.append(f"    const int src{j} = ps[{j}].src[i], from{j} = src{j} < 0 ? lane : src{j};")
    for s in summed:
        for j in rows:
            out.append(f"    {{ const auto t = warp_shfl(x{s}[{j}], from{j}); if (src{j} >= 0) x{s}[{j}] += t; }}")
    out.append("  }")
    for j in rows:
        out.append(f"  if (lead[{j}]) {{")
        out.append(f"    ull* t = wtab + code{j} * 2;")
        for s, k in enumerate(kinds):
            at = f"t[{2 * s * D}]"
            if k == _COUNT:
                out.append(f"    {at} += x{s}[{j}];")
            elif k == _ISUM:
                out.append(f"    {{ const u128 sum = ((((u128)t[{2 * s * D + 1}]) << 64) | (u128){at}) + x{s}[{j}];"
                           f" {at} = (ull)sum; t[{2 * s * D + 1}] = (ull)(sum >> 64); }}")
            else:
                out.append(f"    *(double*)&{at} += x{s}[{j}];")
        out.append("  }")
        out.append("  __syncwarp();")
    out.append("}")
    return out


def _flush(route: str, kinds: list[int], D: int) -> list[str]:
    out = []
    W = THREADS // 32
    S = len(kinds)
    if route == "reg":  # D = 1: warp shuffles, then one flush per block and stream
        out.append(f"__shared__ ull red[{W}][{S}][2];")
        for s, k in enumerate(kinds):
            a, slot = f"acc{s}", f"red[warp][{s}]"
            if k == _ISUM:
                out.append(f"for (int o = 16; o > 0; o >>= 1) {a} += shfl_down_u128({a}, o);")
                out.append(f"if (lane == 0) {{ {slot}[0] = (ull){a}; {slot}[1] = (ull)({a} >> 64); }}")
            else:
                out.append(f"for (int o = 16; o > 0; o >>= 1) {a} += __shfl_down_sync(WARP_FULL, {a}, o);")
                word = f"(ull)__double_as_longlong({a})" if k == _FSUM else a
                out.append(f"if (lane == 0) {{ {slot}[0] = {word}; {slot}[1] = 0; }}")
        out.append("__syncthreads();")
        out.append(f"for (int p = threadIdx.x; p < {S}; p += blockDim.x) {{")
        out.append("  const int kind = kKinds[p];")
        out.append("  ull* lo = totals + 2 * p; ull* hi = lo + 1;")
        out.append("  if (kind == 2) { double v = 0.0;"
                   f" for (int w = 0; w < {W}; ++w) v += __longlong_as_double((long long)red[w][p][0]);"
                   " if (v != 0.0) atomicAdd((double*)lo, v); }")
        out.append("  else { u128 v = 0;"
                   f" for (int w = 0; w < {W}; ++w) v += ((u128)red[w][p][1] << 64) | (u128)red[w][p][0];"
                   " if (v != 0) add_i128_global(lo, hi, v); }")
        out.append("}")
        return out
    if route == "warp":
        out.append("__syncthreads();")
        out.append(f"for (int p = threadIdx.x; p < {S * D}; p += blockDim.x) {{")
        out.append(f"  const int s = p / {D}, g = p % {D};")
        out.append("  const int kind = kKinds[s];")
        out.append(f"  ull* lo = totals + 2 * s * {D} + g; ull* hi = lo + {D};")
        out.append("  if (kind == 2) { double v = 0.0;"
                   f" for (int w = 0; w < {W}; ++w) v += *(const double*)&wsm[(w * {S * D} + p) * 2];"
                   " if (v != 0.0) atomicAdd((double*)lo, v); }")
        out.append("  else { u128 v = 0;"
                   f" for (int w = 0; w < {W}; ++w) {{ const ull* q = &wsm[(w * {S * D} + p) * 2];"
                   " v += ((u128)q[1] << 64) | (u128)q[0]; }"
                   " if (v != 0) add_i128_global(lo, hi, v); }")
        out.append("}")
    return out


def generate(recipe) -> Generated:
    """The CUDA source of `recipe`'s kernel (deterministic in its inputs)."""
    _check_limits(recipe)
    kinds = [_STREAM_KIND[tag] for tag, _ in recipe.streams]
    route, smem = route_for(recipe)
    R = _ROWS[route]
    threads = THREADS
    key = cache_key(recipe)
    name = f"fused_{key[:16]}"
    structure, n_consts = _structure(recipe)
    S, D = len(kinds), recipe.domain
    W = threads // 32
    n_regs = max(recipe.n_regs, 1)

    L: list[str] = []
    L.append('#include "fused_pipeline.cuh"')
    L.append(f"// recipe {key}: {len(structure)} instructions, {len(recipe.table)} columns,"
             f" {S} streams, D = {D}, route {route}, {R} rows per thread")
    L.append(f"struct FusedConsts {{ ull w[{max(n_consts, 1)}]; }};")
    L.append(f"__constant__ unsigned char kKinds[{S}] = {{{', '.join(map(str, kinds))}}};")
    L.append("#define KI(i) ((((u128)k.w[(i) + 1]) << 64) | (u128)k.w[i])")
    L.append("#define KF(i) __longlong_as_double((long long)k.w[i])")
    params = [f"{_DT_PTR[code]} __restrict__ c{i}" for i, (_, _, code) in enumerate(recipe.table)]
    params += ["const unsigned char* __restrict__ live", "long long n", "FusedConsts k",
               "ull* __restrict__ totals"]
    L.append(f'extern "C" __global__ void __launch_bounds__({threads}) {name}(')
    L.append("    " + ",\n    ".join(params) + ") {")
    L.append("  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;")
    if route == "reg":
        for s, kd in enumerate(kinds):
            ty = {_COUNT: "ull", _ISUM: "u128", _FSUM: "double"}[kd]
            L.append(f"  {ty} acc{s} = 0;")
    elif route == "warp":
        L.append("  extern __shared__ ull wsm[];")
        L.append(f"  for (int i = threadIdx.x; i < {smem // 8}; i += blockDim.x) wsm[i] = 0ull;")
        L.append("  __syncthreads();")
        L.append(f"  ull* const wtab = wsm + warp * {S * D * 2};")
    L.append(f"  const long long tile = {32 * R}LL;")
    L.append(f"  const long long warps = (long long)gridDim.x * {W};")
    # software pipelined: the next tile's columns are loaded before this
    # tile's rows are evaluated, so a warp's loads overlap its arithmetic
    rows = range(R)
    cty = {c: _DT_PTR[code][6:-1] for c, (_, _, code) in enumerate(recipe.table)}
    L.append("  const long long step = warps * tile;")
    L.append(f"  long long base = ((long long)blockIdx.x * {W} + warp) * tile;")
    for j in rows:
        L.append(f"  long long r{j} = base + lane + {32 * j}; if (r{j} >= n) r{j} = n - 1;")
    for c in cty:
        for j in rows:
            L.append(f"  {cty[c]} L{c}_{j} = c{c}[r{j}];")
    for j in rows:
        L.append(f"  unsigned char Lv{j} = live != nullptr ? live[r{j}] : 1;")
    L.append("  for (; base < n; base += step) {")
    for j in rows:
        L.append(f"    long long q{j} = base + step + lane + {32 * j}; if (q{j} >= n) q{j} = n - 1;")
    for c in cty:
        for j in rows:
            L.append(f"    const {cty[c]} N{c}_{j} = c{c}[q{j}];")
    for j in rows:
        L.append(f"    const unsigned char Nv{j} = live != nullptr ? live[q{j}] : 1;")
    L.append("    do {")
    for j in rows:
        L.append(f"    bool a{j} = base + lane + {32 * j} < n && Lv{j} != 0;")
    any_alive = " || ".join(f"a{j}" for j in rows)
    L.append(f"    if (!__any_sync(WARP_FULL, {any_alive})) break;")
    for j in rows:
        L.append(f"    long long code{j} = 0;")
        regs = ", ".join(f"I{k}_{j} = 0" for k in range(n_regs))
        L.append(f"    u128 {regs};")
        L.append("    double " + ", ".join(f"F{k}_{j} = 0.0" for k in range(n_regs)) + ";")
        L.append("    bool " + ", ".join(f"V{k}_{j} = false" for k in range(n_regs)) + ";")
        L.append("    bool " + ", ".join(f"ok{s}_{j} = false" for s in range(S)) + ";")
        for s, kd in enumerate(kinds):
            if kd == _ISUM:
                L.append(f"    u128 v{s}_{j} = 0;")
            elif kd == _FSUM:
                L.append(f"    double f{s}_{j} = 0.0;")
    for ins in structure:
        for j in rows:
            L.extend("    " + s for s in _lower(ins, j))
        if ins[0] == OP_FILTER:
            L.append(f"    if (!__any_sync(WARP_FULL, {any_alive})) break;")
    L.extend("    " + s for s in _accumulate(route, kinds, D, R))
    L.append("    } while (0);")
    for c in cty:
        for j in rows:
            L.append(f"    L{c}_{j} = N{c}_{j};")
    for j in rows:
        L.append(f"    Lv{j} = Nv{j};")
    L.append("  }")
    L.extend("  " + s for s in _flush(route, kinds, D))
    L.append("}")
    return Generated(key=key, name=name, source="\n".join(L) + "\n", route=route,
                     threads=threads, smem=smem, rows_per_thread=R, n_consts=n_consts)


# ------------------------------------------------------------ compile / load

_LOCK = threading.Lock()
_KERNELS: dict = {}   # (key, device index) -> (nvrtc.Kernel, Generated)
_BY_RECIPE: dict = {}  # the same, by the recipe's own fields: no source built per call
_COMPILES: dict = {}  # key -> {"compile_ms", "from", "log"}


def kernel_for(recipe, device_index: int):
    """The loaded kernel of `recipe` on a device: compiled with NVRTC at
    first use (or read from the disk cache), then kept in the process.
    Returns (nvrtc.Kernel, Generated).  Raises nvrtc.NvrtcError with the
    compiler's log when the source does not compile or load."""
    fast = (recipe.program, recipe.table, recipe.domain, tuple(t for t, _ in recipe.streams),
            device_index)
    got = _BY_RECIPE.get(fast)
    if got is not None:
        return got
    gen = generate(recipe)
    with _LOCK:
        got = _KERNELS.get((gen.key, device_index))
        if got is not None:
            _BY_RECIPE[fast] = got
            return got
        stem = CACHE_DIR / cubin_stem(gen.key, nvrtc.nvrtc_version())
        cubin_path = Path(f"{stem}.cubin")
        if cubin_path.exists():
            cubin = cubin_path.read_bytes()
            _COMPILES.setdefault(gen.key, {"compile_ms": 0.0, "from": "disk", "log": ""})
        else:
            cubin, log, ms = nvrtc.compile_cubin(
                _with_header(gen.source), f"{gen.name}.cu", _OPTIONS
            )
            _COMPILES[gen.key] = {"compile_ms": ms, "from": "nvrtc", "log": log}
            CACHE_DIR.mkdir(parents=True, exist_ok=True)
            tmp = Path(f"{stem}.{threading.get_ident()}.tmp")
            tmp.write_bytes(cubin)
            tmp.replace(cubin_path)
            Path(f"{stem}.cu").write_text(gen.source)
            Path(f"{stem}.log").write_text(log)
        kern = nvrtc.load_kernel(cubin, gen.name, device_index)
        _KERNELS[(gen.key, device_index)] = _BY_RECIPE[fast] = (kern, gen)
        return kern, gen


def _with_header(source: str) -> str:
    """The generated source with the fixed header pasted in place of its
    include, so NVRTC needs no include path."""
    header = (_CSRC / _HEADER).read_text().replace("#pragma once\n", "")
    return source.replace(f'#include "{_HEADER}"', header)


def compile_info(recipe) -> dict:
    """How this process got the recipe's kernel: {"compile_ms", "from"
    ("nvrtc" | "disk"), "log"}; {} before its first use."""
    return dict(_COMPILES.get(cache_key(recipe), {}))


def clear_cache() -> None:
    """Forget every loaded kernel and delete the cubins on disk."""
    with _LOCK:
        _KERNELS.clear()
        _BY_RECIPE.clear()
        _COMPILES.clear()
        if CACHE_DIR.exists():
            for p in CACHE_DIR.iterdir():
                p.unlink()
