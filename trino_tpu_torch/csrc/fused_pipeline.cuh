// fused_pipeline.cuh — the fixed part of every fused scan -> filter ->
// project -> aggregate kernel.  ops/cuda/fused_codegen.py writes one
// `__global__` function per recipe around these helpers and NVRTC compiles
// the two together (built-in types only: NVRTC sees no system header).
//
// Replaces the TPU kernel trino_tpu/ops/pallas/fused.py:572 `_fused_kernel`,
// which the reference also generates per recipe from the plan's expression
// tree.  The contract is its: every referenced scan column is read from
// device memory once; filter predicates and aggregate arguments are
// evaluated per row (exact decimal arithmetic in 128 bits, Kleene NULL
// logic, a NULL predicate fails the row); dictionary group keys combine into
// one mixed-radix code in [0, D); per-group totals of every aggregate stream
// (row count, non-NULL count, integer or double sum) come back as a
// [streams][2][D] table of 64-bit words, integer sums exact to 128 bits in
// any order of the adds.
//
// What bounds it on an H100: bytes — sum(referenced column bytes) * n read
// once; the [streams][2][D] totals are noise.  The per-row arithmetic (a few
// dozen 64/128-bit integer operations) is far below the card's rate.
//
// What the design does about it (the generated code; fused_codegen.py):
//   * the recipe's bytecode is lowered to straight-line C: each machine
//     register becomes local variables (a 128-bit integer, a double, a
//     validity bool), each instruction one statement, so nothing is decoded
//     per row and the compiler keeps the values in real registers;
//   * a thread takes R rows of its warp's tile, 32 apart, so every column
//     load stays coalesced (R = 2 on the register route, 1 on the warp
//     route, where two rows' eight 128-bit streams exhaust the registers);
//   * software pipelining: the next tile's columns are loaded before this
//     tile is evaluated, so a warp's loads overlap its arithmetic;
//   * the warp moves through its tile in lockstep: a row that fails a FILTER
//     (or whose dictionary code is out of range) only clears the flag that
//     gates its EMITs, and the warp leaves the tile once all its rows are
//     dead (`__any_sync`);
//   * a decimal -> double cast divides by 10^s without a division
//     (`div_by`: a reciprocal and one FMA correction, correctly rounded) —
//     q01's three casts were 0.9 of its 2.3 ms at 64 Mi rows;
//   * accumulation never chains dependent atomics: with D = 1 a thread sums
//     in registers over its whole loop and each block flushes once; with a
//     small table each warp pre-aggregates the lanes that share a group code
//     (one match per row, one schedule for every stream: below) and
//     the leader adds the total into the warp's private table in shared
//     memory with plain loads and stores; larger tables take global
//     atomics per row.  Blocks flush non-zero totals with global atomics.
//     Double sums take the order of those adds.
#pragma once

typedef unsigned long long ull;
typedef unsigned __int128 u128;
typedef __int128 i128;

#define WARP_FULL 0xffffffffu

// Warp-level pre-aggregation by group code ("warp" route).  The lanes of a
// warp that carry the same code are peers (`__match_any_sync`);
// `peer_schedule` plans a tree reduction inside every peer set at once (the
// scheme of E. Westphal's "Voting and shuffling to optimize atomic
// operations"): at step i each lane adds the value of its next peer still
// in play, and the lanes whose rank has bit i set drop out.  After
// ceil(log2(largest set)) steps the lowest lane of each set — its leader —
// holds the set's total.  The schedule depends only on the peer masks, so
// one schedule serves every stream, and the R rows' schedules run the same
// number of steps so their shuffles interleave.
struct PeerSched {
  int src[5];  // lane to pull from at each step, -1 for none
};

// Plans the reductions of R rows; returns the number of steps in play (the
// same on every lane of the warp).
template <int R>
__device__ __forceinline__ int peer_schedule(const unsigned (&peers)[R], int lane,
                                             PeerSched (&s)[R]) {
  unsigned rest[R], rank[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    rest[j] = peers[j] & (0xfffffffeu << lane);        // peers above this lane
    rank[j] = __popc(peers[j] & ((1u << lane) - 1u));  // position among its peers
#pragma unroll
    for (int i = 0; i < 5; ++i) s[j].src[i] = -1;
  }
  int steps = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    unsigned any = 0u;
#pragma unroll
    for (int j = 0; j < R; ++j) any |= rest[j];
    if (!__any_sync(WARP_FULL, any != 0u)) break;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      s[j].src[i] = __ffs(rest[j]) - 1;
      rest[j] &= ~__ballot_sync(WARP_FULL, rank[j] & 1u);
      rank[j] >>= 1;
    }
    steps = i + 1;
  }
  return steps;
}

__device__ __forceinline__ double warp_shfl(double v, int src) { return __shfl_sync(WARP_FULL, v, src); }
__device__ __forceinline__ u128 warp_shfl(u128 v, int src) {
  const ull lo = __shfl_sync(WARP_FULL, (ull)v, src);
  const ull hi = __shfl_sync(WARP_FULL, (ull)(v >> 64), src);
  return ((u128)hi << 64) | (u128)lo;
}

__device__ __forceinline__ u128 shfl_down_u128(u128 v, int delta) {
  const ull lo = __shfl_down_sync(WARP_FULL, (ull)v, delta);
  const ull hi = __shfl_down_sync(WARP_FULL, (ull)(v >> 64), delta);
  return ((u128)hi << 64) | (u128)lo;
}

// int128 -> double as the engine's cast does it: signed low limb plus the
// adjusted high limb (exact whenever the value fits 64 bits; the common
// case then takes one conversion, with the same bits)
__device__ __forceinline__ double i128_to_f(u128 r) {
  const long long lo = (long long)(ull)r;
  const long long hi = (long long)(ull)(r >> 64);
  const long long hi_adj = hi + (lo < 0 ? 1 : 0);
  if (hi_adj == 0) return (double)lo;
  return __dadd_rn((double)lo, __dmul_rn((double)hi_adj, 18446744073709551616.0));
}

// RN(x / d) without a division: with y = RN(1 / d), q = RN(x y) is within an
// ulp of x / d, the residual x - q d is exact under one FMA, and q + r y
// rounded once is the correctly rounded quotient (Markstein's theorem) —
// the same bits as the engine's x / d, in three operations.
__device__ __forceinline__ double div_by(double x, double d, double y) {
  const double q = __dmul_rn(x, y);
  const double r = __fma_rn(-q, d, x);
  return __fma_rn(r, y, q);
}

// exact 128-bit add into a (lo, hi) pair of global words, once per block
// and slot: the low add's carry goes into the high word
__device__ __forceinline__ void add_i128_global(ull* lo, ull* hi, u128 v) {
  const ull vlo = (ull)v;
  ull vhi = (ull)(v >> 64);
  const ull old = atomicAdd(lo, vlo);
  if (old + vlo < old) vhi += 1;
  if (vhi != 0) atomicAdd(hi, vhi);
}
