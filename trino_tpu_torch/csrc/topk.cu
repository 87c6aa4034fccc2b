// radix select — the exact K-th largest u32 key of the live rows, and the
// ids of the rows at or above it, for TopN without a sort of the relation.
//
// Replaces the TPU kernel trino_tpu/ops/pallas/topk.py `radix_topk_threshold`
// (which had no pallas_call of its own: each of its four byte passes was a
// 256-bin count through the segmented-reduce kernel, segreduce.py, with the
// bin chosen by XLA ops between passes).
//
// Contract: threshold = the K-th largest key among live rows (the smallest
// live key when K exceeds them; 0 when none is live); required = the live
// rows with key >= threshold; ids = the first `cap` of those rows' ids.
//
// What bounds it on an H100: bytes — every key (4 B) and live byte (1 B)
// must be read at least once; nothing large is written.  The selection has
// to come as near that one read as it can.
//
// What the design does about it (one call of trino_radix_select):
// - Three passes over the digits of 11, 11 and 10 bits (2048, 2048 and 1024
//   bins, one histogram per pass in 8 KB of shared memory): a key mapped
//   from a narrow int32 range (a price, a date) still spreads over the first
//   digit's bins, so no pass is wasted.
// - A full pass loads 16 bytes of keys and 4 live bytes per thread per step,
//   with a warp-uniform row loop; a view whose keys are not 16-byte aligned
//   takes its first rows one at a time, and a live mask that is not 4-byte
//   aligned is read a byte at a time.  Plain shared atomics count (the
//   compiler already merges equal addresses of a warp: ATOMS.POPC.INC).
// - The bin is chosen on the device: every block folds its bins into the
//   pass's global histogram, and the last block to finish (a ticket after a
//   fence) scans it from the top and writes the prefix, the rows above it and
//   the rows in the chosen bin to a small state.  No host work and no sync
//   between passes.
// - After pass 1 the count of live rows at or above the chosen first-digit
//   bin is known (fewer than K above it, plus the bin).  When it fits the
//   buffer (n/16 entries), pass 2 also appends those rows' keys and ids —
//   each warp gathers them in shared memory and reserves room with one
//   atomic per 128 entries, since one counter for every warp's appends
//   costs a third of a pass — and pass 3 and the candidate pass read only
//   the buffer: two full reads in all.  When it does not fit (heavy ties),
//   they read every row again.
// - The candidate pass appends the ids of live rows with key >= threshold to
//   `ids` (one atomic per warp; the caller sorts the <= cap ids into row
//   order, pass 3 having marked every lane unused) and counts them all into
//   `required`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Pass p's digit: its shift, its bin count, and the key bits above it.
__host__ __device__ constexpr int digit_shift(int p) { return p == 0 ? 21 : p == 1 ? 10 : 0; }
__host__ __device__ constexpr int digit_bins(int p) { return p == 2 ? 1024 : 2048; }
__host__ __device__ constexpr uint32_t prefix_mask(int p) {
  return p == 0 ? 0u : p == 1 ? 0xFFE00000u : 0xFFFFFC00u;
}

// The head of the scratch, zeroed before pass 1.  The wrapper
// (ops/cuda/topk.py) reads `threshold` and `required` and the three
// histograms that follow the state.
struct State {
  long long threshold;  // the digits resolved so far; after pass 3 the threshold
  long long above;      // live rows above every key with that prefix
  long long in_bin;     // live rows whose key has that prefix
  long long required;   // live rows with key >= threshold
  unsigned buffered;    // 1: the buffer holds every live row whose first digit >= the threshold's
  unsigned buf_n;       // entries in the buffer
  unsigned ticket[3];   // blocks finished, per pass
  unsigned pad[3];
};
static_assert(sizeof(State) == 64, "the wrapper reads the state at fixed offsets");
constexpr long long kHistWords = 2048 + 2048 + 1024;
constexpr long long kHeaderBytes = sizeof(State) + 4 * kHistWords;  // 20,544: the buffer stays 16-byte aligned

// Inclusive sum of c over the lanes up to this one.  Every lane calls it.
__device__ __forceinline__ int warp_incl(int c, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, c, o);
    if (lane >= o) c += y;
  }
  return c;
}

// Reserves c slots at *counter for this lane with one atomic per warp;
// returns the lane's first slot.  Every lane of the warp calls it together.
template <typename C>
__device__ __forceinline__ C warp_reserve(int c, C* counter, int lane) {
  const int incl = warp_incl(c, lane);
  C base = 0;
  if (lane == 31 && incl) base = atomicAdd(counter, (C)incl);
  base = __shfl_sync(kFull, base, 31);
  return base + (C)(incl - c);
}

constexpr int kStage = 128;  // buffer entries a warp gathers before one reservation: one step's most

// Moves a warp's staged entries to the buffer with one atomic.
__device__ __forceinline__ void flush_stage(const uint2* stage, int staged, unsigned* counter,
                                            uint2* buf, int lane) {
  __syncwarp();
  unsigned base = 0;
  if (lane == 0 && staged) base = atomicAdd(counter, (unsigned)staged);
  base = __shfl_sync(kFull, base, 0);
  for (int i = lane; i < staged; i += 32) buf[base + i] = stage[i];
  __syncwarp();
}

// Row geometry of a full read: `head` rows (< 4) until the keys are 16-byte
// aligned, `groups` of four rows, then fewer than four tail rows.
struct Rows {
  long long n, head, groups, tail0;
  bool live_words;
  __device__ Rows(const uint32_t* u, const uint8_t* live, long long n_) : n(n_) {
    const long long h = (long long)((16 - (reinterpret_cast<uintptr_t>(u) & 15)) & 15) >> 2;
    head = h < n ? h : n;
    groups = (n - head) >> 2;
    tail0 = head + 4 * groups;
    live_words = ((reinterpret_cast<uintptr_t>(live + head)) & 3) == 0;
  }
  // the head and tail rows, one per lane of warp 0 of block 0 (-1: none)
  __device__ long long edge_row(int lane) const {
    if (lane < head) return lane;
    const long long t = tail0 + (lane - head);
    return (lane < head + 3 && t < n) ? t : -1;
  }
};

// Loads group g (rows head + 4g .. +3): four keys and their live bytes
// (bit 8j of `lw` set when row j is live).
__device__ __forceinline__ void load_group(const uint32_t* u, const uint8_t* live, const Rows& R,
                                           long long g, uint32_t v[4], uint32_t& lw) {
  const uint4 kv = __ldg(reinterpret_cast<const uint4*>(u + R.head) + g);
  v[0] = kv.x; v[1] = kv.y; v[2] = kv.z; v[3] = kv.w;
  const uint8_t* lp = live + R.head + 4 * g;
  if (R.live_words) {
    lw = __ldg(reinterpret_cast<const unsigned*>(lp));
  } else {
    lw = (unsigned)__ldg(lp) | ((unsigned)__ldg(lp + 1) << 8) | ((unsigned)__ldg(lp + 2) << 16) |
         ((unsigned)__ldg(lp + 3) << 24);
  }
}

// The last block of pass P: scan the pass's histogram from the top bin down,
// choose the bin that holds the K-th row (rows above it < K <= rows above it
// + its rows), or, when K exceeds the rows, the lowest non-empty bin; update
// the state.
template <int P>
__device__ void choose_bin(const unsigned* hist, State* st, long long k, long long buf_cap) {
  constexpr int BINS = digit_bins(P), PER = BINS / kThreads, WARPS = kThreads / 32;
  __shared__ long long wsum[WARPS];
  __shared__ int pick, low;
  __shared__ long long pick_above;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  // thread t holds bins BINS-1-PER*t down to BINS-PER*(t+1)
  unsigned h[PER];
  long long s = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    h[j] = __ldcg(hist + BINS - 1 - PER * t - j);
    s += h[j];
  }
  long long incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[w] = incl;
  if (t == 0) {
    pick = -1;
    low = BINS;
  }
  __syncthreads();
  if (w == 0) {
    long long x = lane < WARPS ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane < WARPS) wsum[lane] = x;
  }
  __syncthreads();
  const long long above0 = st->above;
  long long a = above0 + (w ? wsum[w - 1] : 0) + incl - s;  // rows in the bins above mine
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int b = BINS - 1 - PER * t - j;
    if (a < k && a + h[j] >= k) {
      pick = b;
      pick_above = a;
    }
    if (h[j]) atomicMin(&low, b);
    a += h[j];
  }
  __syncthreads();
  if (t == 0) {
    const long long total = wsum[WARPS - 1];
    int b;
    long long above = above0, at_or_above;
    if (pick >= 0) {
      b = pick;
      above = pick_above;
    } else {
      b = low < BINS ? low : 0;
    }
    const long long in_bin = __ldcg(hist + b);
    at_or_above = pick >= 0 ? pick_above - above0 + in_bin : total;
    st->threshold |= (long long)b << digit_shift(P);
    st->above = above;
    st->in_bin = in_bin;
    if (P == 0) st->buffered = at_or_above <= buf_cap;
  }
}

// Pass P: count the digit of every live row whose higher digits equal the
// prefix; pass 2 also fills the buffer, pass 3 reads only the buffer when it
// is full.  The last block chooses the bin.
template <int P>
__global__ void __launch_bounds__(kThreads) radix_pass_kernel(
    const uint32_t* __restrict__ u, const uint8_t* __restrict__ live, long long n, long long k,
    State* st, unsigned* hist, uint2* buf, long long buf_cap, int* ids, long long cap) {
  constexpr int SHIFT = digit_shift(P), BINS = digit_bins(P);
  constexpr uint32_t MASK = prefix_mask(P);
  __shared__ unsigned bins[BINS];
  for (int i = threadIdx.x; i < BINS; i += kThreads) bins[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const uint32_t want = (uint32_t)st->threshold & MASK;
  const long long stride = (long long)gridDim.x * kThreads;
  // pass 3 marks the candidate lanes unused (the value sorts after every id)
  if (P == 2)
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < cap; i += stride)
      ids[i] = 0x7F7F7F7F;

  if (P == 2 && st->buffered) {
    const long long m = st->buf_n;
    for (long long e0 = (long long)blockIdx.x * kThreads; e0 < m; e0 += stride) {
      const long long e = e0 + threadIdx.x;
      if (e < m) {
        const uint32_t v = __ldcg(&buf[e].x);
        if ((v & MASK) == want) atomicAdd(&bins[(v >> SHIFT) & (BINS - 1)], 1u);
      }
    }
  } else {
    // pass 2 appends every live row whose first digit is at or above the
    // chosen one: the rows above it (fewer than K) and the bin's rows
    const bool append = P == 1 && st->buffered;
    const uint32_t first = want & 0xFFE00000u;
    const Rows R(u, live, n);
    // a warp gathers its appends here and reserves buffer room once per
    // kStage entries: one counter takes far fewer atomics
    __shared__ uint2 stages[P == 1 ? kThreads / 32 : 1][kStage];
    uint2* stage = stages[P == 1 ? threadIdx.x >> 5 : 0];
    int staged = 0;  // warp-uniform
    for (long long g0 = (long long)blockIdx.x * kThreads; g0 < R.groups; g0 += stride) {
      const long long g = g0 + threadIdx.x;
      uint32_t v[4] = {0, 0, 0, 0}, lw = 0;
      if (g < R.groups) load_group(u, live, R, g, v, lw);
      int take = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool l = (lw >> (8 * j)) & 0xFFu;
        if (l && (v[j] & MASK) == want) atomicAdd(&bins[(v[j] >> SHIFT) & (BINS - 1)], 1u);
        if (append && l && (v[j] & 0xFFE00000u) >= first) take |= 1 << j;
      }
      if (append && __any_sync(kFull, take)) {
        const int c = __popc(take);
        const int incl = warp_incl(c, lane);
        const int total = __shfl_sync(kFull, incl, 31);
        if (staged + total > kStage) {
          flush_stage(stage, staged, &st->buf_n, buf, lane);
          staged = 0;
        }
        int at = staged + incl - c;
        const unsigned row0 = (unsigned)(R.head + 4 * g);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (take >> j & 1) stage[at++] = make_uint2(v[j], row0 + j);
        staged += total;
      }
    }
    if (append) flush_stage(stage, staged, &st->buf_n, buf, lane);
    if (blockIdx.x == 0 && threadIdx.x < 32) {
      const long long r = R.edge_row(lane);
      const bool l = r >= 0 && live[r];
      const uint32_t v = r >= 0 ? u[r] : 0u;
      if (l && (v & MASK) == want) atomicAdd(&bins[(v >> SHIFT) & (BINS - 1)], 1u);
      const int take = append && l && (v & 0xFFE00000u) >= first;
      if (append && __any_sync(kFull, take)) {
        const unsigned pos = warp_reserve<unsigned>(take, &st->buf_n, lane);
        if (take) buf[pos] = make_uint2(v, (unsigned)r);
      }
    }
  }

  __syncthreads();
  for (int b = threadIdx.x; b < BINS; b += kThreads)
    if (bins[b]) atomicAdd(hist + b, bins[b]);
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0) last = atomicAdd(&st->ticket[P], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  choose_bin<P>(hist, st, k, buf_cap);
}

// The candidates: ids of live rows with key >= threshold, appended in
// atomic order (the first `cap` kept), all counted into `required`.
__global__ void __launch_bounds__(kThreads) radix_rows_kernel(
    const uint32_t* __restrict__ u, const uint8_t* __restrict__ live, long long n,
    State* st, const uint2* buf, int* ids, long long cap) {
  const int lane = threadIdx.x & 31;
  const uint32_t thr = (uint32_t)st->threshold;
  const long long stride = (long long)gridDim.x * kThreads;
  unsigned long long* required = reinterpret_cast<unsigned long long*>(&st->required);
  if (st->buffered) {
    const long long m = st->buf_n;
    for (long long e0 = (long long)blockIdx.x * kThreads; e0 < m; e0 += stride) {
      const long long e = e0 + threadIdx.x;
      uint2 ent = make_uint2(0, 0);
      if (e < m) ent = buf[e];
      const int take = e < m && ent.x >= thr;
      if (__any_sync(kFull, take)) {
        const unsigned long long pos = warp_reserve<unsigned long long>(take, required, lane);
        if (take && pos < (unsigned long long)cap) ids[pos] = (int)ent.y;
      }
    }
    return;
  }
  const Rows R(u, live, n);
  for (long long g0 = (long long)blockIdx.x * kThreads; g0 < R.groups; g0 += stride) {
    const long long g = g0 + threadIdx.x;
    uint32_t v[4] = {0, 0, 0, 0}, lw = 0;
    if (g < R.groups) load_group(u, live, R, g, v, lw);
    int take = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (((lw >> (8 * j)) & 0xFFu) && v[j] >= thr) take |= 1 << j;
    if (__any_sync(kFull, take)) {
      unsigned long long pos = warp_reserve<unsigned long long>(__popc(take), required, lane);
      const int row0 = (int)(R.head + 4 * g);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (take >> j & 1) {
          if (pos < (unsigned long long)cap) ids[pos] = row0 + j;
          ++pos;
        }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const long long r = R.edge_row(lane);
    const int take = r >= 0 && live[r] && u[r] >= thr;
    if (__any_sync(kFull, take)) {
      const unsigned long long pos = warp_reserve<unsigned long long>(take, required, lane);
      if (take && pos < (unsigned long long)cap) ids[pos] = (int)r;
    }
  }
}

// The grid: one wave of resident blocks, a grid-stride loop inside.
int grid_for(long long n) {
  static int most = 0;
  if (most == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const void* kernels[] = {(const void*)radix_pass_kernel<0>, (const void*)radix_pass_kernel<1>,
                             (const void*)radix_pass_kernel<2>, (const void*)radix_rows_kernel};
    per_sm = 1 << 30;
    for (const void* f : kernels) {
      int b = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, f, kThreads, 0);
      if (b < per_sm) per_sm = b;
    }
    most = (sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
  }
  const long long want = ((n + 3) / 4 + kThreads - 1) / kThreads;
  return (int)(want < most ? want : most);
}

}  // namespace

// u: u32 [n] (any 4-byte aligned address); live: bool [n] (any address);
// scratch: the state and histograms (kHeaderBytes), then buf_cap
// buffer entries of 8 bytes, 16-byte aligned; ids: int32 [cap], or null for the threshold alone.
// Zeroes the scratch's head and launches the three passes (and the
// candidate pass when ids is given) on `stream`; no host sync.  Returns
// cudaGetLastError().
extern "C" int trino_radix_select(const void* u, const void* live, long long n, long long k,
                                  void* scratch, long long buf_cap, void* ids, long long cap,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(scratch, 0, kHeaderBytes, s);
  if (n <= 0) return (int)cudaGetLastError();
  const uint32_t* uk = (const uint32_t*)u;
  const uint8_t* lv = (const uint8_t*)live;
  State* st = (State*)scratch;
  unsigned* hist = (unsigned*)((char*)scratch + sizeof(State));
  uint2* buf = (uint2*)((char*)scratch + kHeaderBytes);
  const int blocks = grid_for(n);
  int* out = (int*)ids;
  const long long lanes = ids != nullptr ? cap : 0;
  radix_pass_kernel<0><<<blocks, kThreads, 0, s>>>(uk, lv, n, k, st, hist, buf, buf_cap, out, 0);
  radix_pass_kernel<1><<<blocks, kThreads, 0, s>>>(uk, lv, n, k, st, hist + 2048, buf, buf_cap,
                                                   out, 0);
  radix_pass_kernel<2><<<blocks, kThreads, 0, s>>>(uk, lv, n, k, st, hist + 4096, buf, buf_cap,
                                                   out, lanes);
  if (ids != nullptr) radix_rows_kernel<<<blocks, kThreads, 0, s>>>(uk, lv, n, st, buf, out, cap);
  return (int)cudaGetLastError();
}
