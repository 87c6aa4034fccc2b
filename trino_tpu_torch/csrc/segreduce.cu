// segment_reduce — every SUM / COUNT / MIN / MAX of a GROUP BY in one pass.
//
// Replaces the TPU kernel trino_tpu/ops/pallas/segreduce.py `_make_kernel`
// (driven by `fused_segment_reduce`).  The contract is that function's: rows
// carry a segment id in [0, G); rows with an id outside that range are dead
// lanes and are skipped (not clamped into a group); every requested reduction
// is computed in the same pass; integer sums and counts are exact int64
// (two's-complement wrap), double sums are float64, min/max keep the input
// type (a NaN wins a double min/max); empty groups give 0 for sum/count and
// the type's extrema (+-inf for doubles) for min/max.
//
// What bounds it on an H100: bytes.  The pass must read
//   n * (4 + sum(value bytes) + sum(distinct mask bytes))
// once and writes only n_reds * G results; the arithmetic per row is small.
//
// What the design does about it.  The host (ops/cuda/segreduce.py) decodes
// the reductions once per call: it sorts them by kind — (op, value type) —
// and passes each kind's range, plus a de-duplicated table of validity
// masks, so a mask shared by several reductions is read once per row and
// the row loop runs one specialised body per kind instead of switching on
// (op, dtype) per row.  A thread takes SR_ROWS rows at a time (32 apart in
// its warp's tile, so every column load stays coalesced), which puts four
// independent loads of each column in flight (four measured faster than one
// or two on the H100: PERF.md, Findings).
//   * Tables that fit 48 KB of shared memory: up to 32 copies of the block
//     table, lane l updating copy l % copies, so the lanes of a warp that
//     hit one group do not contend.  Counts are native 32-bit shared atomic
//     adds; int64 sums are three independent 32-bit adds of the value's 16-,
//     16- and 32-bit limbs, folded into 64 bits when the block flushes (no
//     compare-and-swap and no carry chain per row); 32-bit min/max are native
//     atomics; double sums and 64-bit min/max are compare-and-swap (a min/max
//     skips it when it cannot win).  A block reduces at most SR_BLOCK_ROWS
//     rows (the host sizes the grid), so no 32-bit word can wrap.  Each block
//     folds its copies and flushes non-identity slots with one global atomic.
//     (Matching a warp's lanes by segment id and reducing over the peers
//     before one update per group, as kernel 2's warp route does, measured
//     slower on the H100 at every table size tried: PERF.md, Findings.)
//   * Larger tables (q03's 2^20 groups): every row goes straight to global
//     64-bit atomics (native for sums, counts and integer min/max;
//     compare-and-swap for double min/max).

#include <cuda_runtime.h>
#include <stdint.h>

#define SR_MAX_REDS 32
#define SR_MAX_MASKS 32
#define SR_THREADS 256
#define SR_BLOCK_ROWS 65536  // 65536 * 0xffff < 2^32: 16-bit limb sums fit a word
#define SR_ROWS 4            // rows a thread takes per step
#define WARP_FULL 0xffffffffu

typedef unsigned long long ull;

// reduction kinds, in the order the host sorts them
enum {
  K_COUNT = 0,
  K_SUM_I64, K_SUM_I32, K_SUM_U8, K_SUM_F64,
  K_MIN_I64, K_MIN_I32, K_MIN_U8, K_MIN_F64,
  K_MAX_I64, K_MAX_I32, K_MAX_U8, K_MAX_F64,
  K_KINDS
};

struct SrRed {
  const void* values;  // null for a count
  int32_t mask;        // index into SrPlan::masks; -1: every live row counts
  int32_t word;        // first 32-bit word of its block table (shared route)
};

struct SrPlan {
  int32_t n_reds;
  int32_t n_masks;
  int32_t shared;           // 1: lane replicas of a shared block table; 0: global atomics
  int32_t replicas;         // copies of the shared table (a power of 2)
  int32_t rep_stride;       // 32-bit words between replicas
  int32_t blocks;
  int32_t kind_end[K_KINDS];  // kind k spans reds [kind_end[k-1], kind_end[k])
  const uint8_t* masks[SR_MAX_MASKS];
  SrRed reds[SR_MAX_REDS];
};

__host__ __device__ constexpr bool is_sum_i(int k) { return k >= K_SUM_I64 && k <= K_SUM_U8; }
__host__ __device__ constexpr bool is_min(int k) { return k >= K_MIN_I64 && k <= K_MIN_F64; }
__host__ __device__ constexpr int base_type(int k) {  // 0 i64, 1 i32, 2 u8, 3 f64
  return k == K_COUNT ? 0 : (k - 1) % 4;
}

// value type a kind loads and reduces
template <int K> struct Val { typedef long long T; };
template <> struct Val<K_MIN_I32> { typedef int T; };
template <> struct Val<K_MAX_I32> { typedef int T; };
template <> struct Val<K_MIN_U8> { typedef unsigned T; };
template <> struct Val<K_MAX_U8> { typedef unsigned T; };
template <> struct Val<K_SUM_F64> { typedef double T; };
template <> struct Val<K_MIN_F64> { typedef double T; };
template <> struct Val<K_MAX_F64> { typedef double T; };

template <int K>
__device__ __forceinline__ typename Val<K>::T load_val(const void* p, long long r) {
  typedef typename Val<K>::T T;
  switch (base_type(K)) {
    case 0: return (T)((const long long*)p)[r];
    case 1: return (T)((const int32_t*)p)[r];
    case 2: return (T)((const uint8_t*)p)[r];
    default: return (T)((const double*)p)[r];
  }
}

// identity of a min/max kind in its value type
template <int K>
__device__ __forceinline__ typename Val<K>::T identity() {
  switch (K) {
    case K_MIN_I64: return (typename Val<K>::T)0x7fffffffffffffffLL;
    case K_MAX_I64: return (typename Val<K>::T)(-0x7fffffffffffffffLL - 1);
    case K_MIN_I32: return (typename Val<K>::T)0x7fffffff;
    case K_MAX_I32: return (typename Val<K>::T)(-0x7fffffff - 1);
    case K_MIN_U8: return (typename Val<K>::T)0xffffffffu;
    case K_MIN_F64: return (typename Val<K>::T)__longlong_as_double(0x7ff0000000000000LL);
    case K_MAX_F64: return (typename Val<K>::T)__longlong_as_double((long long)0xfff0000000000000ULL);
    default: return (typename Val<K>::T)0;  // K_MAX_U8 and every sum / count
  }
}

// identity of a kind's 64-bit output slot
__device__ __forceinline__ ull out_identity(int k) {
  switch (k) {
    case K_MIN_I64: case K_MIN_I32: case K_MIN_U8: return 0x7fffffffffffffffULL;
    case K_MAX_I64: case K_MAX_I32: case K_MAX_U8: return 0x8000000000000000ULL;
    case K_MIN_F64: return 0x7ff0000000000000ULL;
    case K_MAX_F64: return 0xfff0000000000000ULL;
    default: return 0ULL;
  }
}

// identity of a 32-bit min/max word in the block table (i32 or u8 values)
__device__ __forceinline__ unsigned shared_identity32(int k) {
  return k == K_MIN_I32 ? 0x7fffffffu : k == K_MAX_I32 ? 0x80000000u : k == K_MIN_U8 ? 0xffffffffu : 0u;
}

__device__ __forceinline__ int kind_of(const SrPlan& p, int red) {
  int k = 0;
  while (k < K_KINDS - 1 && red >= p.kind_end[k]) ++k;
  return k;
}

// v wins against the held value `old` (a NaN wins; nothing beats a NaN)
template <bool MIN>
__device__ __forceinline__ bool f64_wins(double v, double old) {
  if (old != old) return false;
  return v != v || (MIN ? v < old : v > old);
}

// double min/max by compare-and-swap, skipped when v cannot win
template <bool MIN>
__device__ __forceinline__ void cas_f64(double* a, double v) {
  ull old = *(volatile ull*)a;
  while (f64_wins<MIN>(v, __longlong_as_double((long long)old))) {
    const ull seen = atomicCAS((ull*)a, old, (ull)__double_as_longlong(v));
    if (seen == old) break;
    old = seen;
  }
}

// 64-bit integer min/max on SHARED memory by compare-and-swap, skipped when
// v cannot win
template <bool MIN>
__device__ __forceinline__ void cas_i64(long long* a, long long v) {
  long long old = *(volatile long long*)a;
  while (MIN ? v < old : v > old) {
    const long long seen = (long long)atomicCAS((ull*)a, (ull)old, (ull)v);
    if (seen == old) break;
    old = seen;
  }
}

// one update of a block-table entry (an atomic: other lanes or warps may
// hit the same entry): counts as a native 32-bit add, int64 sums as three
// independent 32-bit adds of their 16-, 16- and 32-bit limbs, 32-bit
// min/max natively, the rest by compare-and-swap
template <int K>
__device__ __forceinline__ void update_entry(unsigned* w, int g, int G, typename Val<K>::T v) {
  if (K == K_COUNT) {
    atomicAdd(w + g, (unsigned)v);
  } else if (is_sum_i(K)) {
    const ull u = (ull)(long long)v;
    atomicAdd(w + g, (unsigned)(u & 0xffffu));
    atomicAdd(w + G + g, (unsigned)((u >> 16) & 0xffffu));
    atomicAdd(w + 2 * G + g, (unsigned)(u >> 32));
  } else if (K == K_SUM_F64) {
    atomicAdd((double*)w + g, (double)v);
  } else {
    switch (base_type(K)) {
      case 0: cas_i64<is_min(K)>((long long*)w + g, (long long)v); break;
      case 1: if (is_min(K)) atomicMin((int*)w + g, (int)v); else atomicMax((int*)w + g, (int)v); break;
      case 2: if (is_min(K)) atomicMin(w + g, (unsigned)v); else atomicMax(w + g, (unsigned)v); break;
      default: cas_f64<is_min(K)>((double*)w + g, (double)v); break;
    }
  }
}

// ---- shared route: lane l updates copy l % replicas of the block table
template <int K, int R>
__device__ __forceinline__ void rows_table(const SrPlan& p, int k0, int k1, const long long (&r)[R],
                                           const int (&g)[R], const bool (&live)[R],
                                           const unsigned (&mbits)[R], unsigned* tab, int G) {
  typedef typename Val<K>::T T;
#pragma unroll 2
  for (int k = k0; k < k1; ++k) {
    const SrRed d = p.reds[k];
    unsigned* w = tab + d.word;
    bool ok[R];
    T v[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      ok[j] = live[j] && (d.mask < 0 || ((mbits[j] >> d.mask) & 1u));
      v[j] = K == K_COUNT ? (T)1 : (ok[j] ? load_val<K>(d.values, r[j]) : identity<K>());
    }
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (ok[j] && v[j] != identity<K>()) update_entry<K>(w, g[j], G, v[j]);
  }
}

// ---- global route: each live row updates the output slots directly
template <int K, int R>
__device__ __forceinline__ void rows_global(const SrPlan& p, int k0, int k1, const long long (&r)[R],
                                            const int (&g)[R], const bool (&live)[R],
                                            const unsigned (&mbits)[R], ull* out, int G) {
  typedef typename Val<K>::T T;
#pragma unroll 2
  for (int k = k0; k < k1; ++k) {
    const SrRed d = p.reds[k];
    bool ok[R];
    T v[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      ok[j] = live[j] && (d.mask < 0 || ((mbits[j] >> d.mask) & 1u));
      v[j] = (ok[j] && K != K_COUNT) ? load_val<K>(d.values, r[j]) : (T)0;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (!ok[j]) continue;
      ull* slot = out + (long long)k * G + g[j];
      if (K == K_COUNT) {
        atomicAdd(slot, 1ull);
      } else if (is_sum_i(K)) {
        if (v[j] != 0) atomicAdd(slot, (ull)(long long)v[j]);
      } else if (K == K_SUM_F64) {
        atomicAdd((double*)slot, (double)v[j]);
      } else if (base_type(K) == 3) {
        cas_f64<is_min(K)>((double*)slot, (double)v[j]);
      } else if (is_min(K)) {
        atomicMin((long long*)slot, (long long)v[j]);
      } else {
        atomicMax((long long*)slot, (long long)v[j]);
      }
    }
  }
}

// a block-table entry as a 64-bit partial of the output slot; false when it
// holds the identity
__device__ __forceinline__ bool read_entry(int kind, const unsigned* w, int g, int G, ull* v) {
  if (kind == K_COUNT) {
    *v = w[g];
    return w[g] != 0u;
  }
  if (is_sum_i(kind)) {
    *v = (ull)w[g] + ((ull)w[G + g] << 16) + ((ull)w[2 * G + g] << 32);
    return *v != 0ull;
  }
  if (kind == K_SUM_F64 || base_type(kind) == 0 || base_type(kind) == 3) {
    *v = ((const ull*)w)[g];
    return kind == K_SUM_F64 ? __longlong_as_double((long long)*v) != 0.0 : *v != out_identity(kind);
  }
  if (w[g] == shared_identity32(kind)) return false;
  *v = base_type(kind) == 1 ? (ull)(long long)(int)w[g] : (ull)w[g];
  return true;
}

// fold partial b into a (both held) by the kind's operation
__device__ __forceinline__ ull fold(int kind, ull a, ull b) {
  if (kind == K_COUNT || is_sum_i(kind)) return a + b;
  const double x = __longlong_as_double((long long)a), y = __longlong_as_double((long long)b);
  if (kind == K_SUM_F64) return (ull)__double_as_longlong(x + y);
  if (base_type(kind) == 3)
    return (is_min(kind) ? f64_wins<true>(y, x) : f64_wins<false>(y, x)) ? b : a;
  const long long p = (long long)a, q = (long long)b;
  return (is_min(kind) ? q < p : q > p) ? b : a;
}

#define SR_KIND_RANGE(K) ((K) == 0 ? 0 : p.kind_end[(K) - 1]), p.kind_end[K]

__global__ void segreduce_init_kernel(SrPlan p, int G, ull* out) {
  const long long slots = (long long)p.n_reds * G;
  for (long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x; s < slots;
       s += (long long)gridDim.x * blockDim.x)
    out[s] = out_identity(kind_of(p, (int)(s / G)));
}

// SHARED: lane replicas of a block table in shared memory; otherwise
// global atomics per row
template <bool SHARED>
__global__ void __launch_bounds__(SR_THREADS)
segreduce_kernel(const int32_t* __restrict__ seg, long long n, int G, SrPlan p, ull* out) {
  constexpr int R = SR_ROWS;
  extern __shared__ unsigned sm[];
  const int lane = threadIdx.x & 31;
  if (SHARED) {
    const int per_rep = p.n_reds * G;
    for (int i = threadIdx.x; i < p.replicas * per_rep; i += blockDim.x) {
      const int rep = i / per_rep, k = (i % per_rep) / G, g = i % G, kind = kind_of(p, k);
      unsigned* w = sm + rep * p.rep_stride + p.reds[k].word;
      if (kind == K_COUNT) {
        w[g] = 0u;
      } else if (is_sum_i(kind)) {
        w[g] = 0u; w[G + g] = 0u; w[2 * G + g] = 0u;
      } else if (base_type(kind) == 0 || base_type(kind) == 3) {
        ((ull*)w)[g] = out_identity(kind);  // 64-bit entries: double sums, 64-bit min/max
      } else {
        w[g] = shared_identity32(kind);
      }
    }
    __syncthreads();
  }
  unsigned* tab = sm + (lane & (p.replicas - 1)) * p.rep_stride;
  const int warps = SR_THREADS / 32;
  const long long tile = 32LL * R;  // a warp's rows per step: lane + 32 j
  const long long stride = (long long)gridDim.x * warps * tile;
  for (long long base = ((long long)blockIdx.x * warps + (threadIdx.x >> 5)) * tile; base < n;
       base += stride) {
    long long r[R];
    int g[R];
    bool live[R], any = false;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      r[j] = base + lane + 32 * j;
      live[j] = r[j] < n;
      if (!live[j]) r[j] = n - 1;  // a safe row to read
    }
#pragma unroll
    for (int j = 0; j < R; ++j) g[j] = seg[r[j]];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      live[j] = live[j] && (unsigned)g[j] < (unsigned)G;
      any = any || live[j];
    }
    if (!__any_sync(WARP_FULL, any)) continue;
    unsigned mbits[R];
#pragma unroll
    for (int j = 0; j < R; ++j) mbits[j] = 0u;
    for (int m = 0; m < p.n_masks; ++m) {
#pragma unroll
      for (int j = 0; j < R; ++j) mbits[j] |= (p.masks[m][r[j]] != 0 ? 1u : 0u) << m;
    }
    if (!SHARED) {
#define SR_GLOBAL(K) rows_global<K, R>(p, SR_KIND_RANGE(K), r, g, live, mbits, out, G)
      SR_GLOBAL(K_COUNT);
      SR_GLOBAL(K_SUM_I64); SR_GLOBAL(K_SUM_I32); SR_GLOBAL(K_SUM_U8); SR_GLOBAL(K_SUM_F64);
      SR_GLOBAL(K_MIN_I64); SR_GLOBAL(K_MIN_I32); SR_GLOBAL(K_MIN_U8); SR_GLOBAL(K_MIN_F64);
      SR_GLOBAL(K_MAX_I64); SR_GLOBAL(K_MAX_I32); SR_GLOBAL(K_MAX_U8); SR_GLOBAL(K_MAX_F64);
#undef SR_GLOBAL
    } else {
#define SR_TABLE(K) rows_table<K, R>(p, SR_KIND_RANGE(K), r, g, live, mbits, tab, G)
      SR_TABLE(K_COUNT);
      SR_TABLE(K_SUM_I64); SR_TABLE(K_SUM_I32); SR_TABLE(K_SUM_U8); SR_TABLE(K_SUM_F64);
      SR_TABLE(K_MIN_I64); SR_TABLE(K_MIN_I32); SR_TABLE(K_MIN_U8); SR_TABLE(K_MIN_F64);
      SR_TABLE(K_MAX_I64); SR_TABLE(K_MAX_I32); SR_TABLE(K_MAX_U8); SR_TABLE(K_MAX_F64);
#undef SR_TABLE
    }
  }
  if (SHARED) {
    __syncthreads();
    for (int i = threadIdx.x; i < p.n_reds * G; i += blockDim.x) {
      const int k = i / G, g = i % G, kind = kind_of(p, k);
      ull v = 0ull, x;
      bool held = false;
      for (int rep = 0; rep < p.replicas; ++rep) {
        if (!read_entry(kind, sm + rep * p.rep_stride + p.reds[k].word, g, G, &x)) continue;
        v = held ? fold(kind, v, x) : x;
        held = true;
      }
      if (!held) continue;
      ull* slot = out + i;
      if (kind == K_COUNT || is_sum_i(kind)) {
        atomicAdd(slot, v);
      } else if (kind == K_SUM_F64) {
        atomicAdd((double*)slot, __longlong_as_double((long long)v));
      } else if (base_type(kind) == 3) {
        const double x = __longlong_as_double((long long)v);
        if (is_min(kind)) cas_f64<true>((double*)slot, x); else cas_f64<false>((double*)slot, x);
      } else if (is_min(kind)) {
        atomicMin((long long*)slot, (long long)v);
      } else {
        atomicMax((long long*)slot, (long long)v);
      }
    }
  }
}

extern "C" const char* trino_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// seg: int32[n] on the device; plan: host struct built by
// ops/cuda/segreduce.py (reductions sorted by kind, mask table, route and
// grid); out: 8-byte slots [n_reds, G] in the plan's order, fully written
// here.  Returns cudaGetLastError().
extern "C" int trino_segment_reduce(const void* seg, long long n, int G, const SrPlan* plan,
                                    void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const SrPlan p = *plan;
  if (p.n_reds < 1 || p.n_reds > SR_MAX_REDS || p.n_masks < 0 || p.n_masks > SR_MAX_MASKS ||
      G < 1 || p.kind_end[K_KINDS - 1] != p.n_reds)
    return (int)cudaErrorInvalidValue;
  const long long slots = (long long)p.n_reds * G;
  int init_blocks = (int)((slots + SR_THREADS - 1) / SR_THREADS);
  if (init_blocks > 1024) init_blocks = 1024;
  segreduce_init_kernel<<<init_blocks, SR_THREADS, 0, st>>>(p, G, (ull*)out);
  if (n > 0 && p.blocks > 0) {
    if (p.shared && (long long)p.blocks * SR_BLOCK_ROWS < n) return (int)cudaErrorInvalidValue;
    const size_t smem = p.shared ? (size_t)p.replicas * p.rep_stride * 4 : 0;
    const int32_t* sg = (const int32_t*)seg;
    ull* o = (ull*)out;
    if (p.shared)
      segreduce_kernel<true><<<p.blocks, SR_THREADS, smem, st>>>(sg, n, G, p, o);
    else
      segreduce_kernel<false><<<p.blocks, SR_THREADS, smem, st>>>(sg, n, G, p, o);
  }
  return (int)cudaGetLastError();
}
