// hash_build — insert every live row's key into an open-addressing table and
// give the row the dense id of its key's group.
//
// Replaces the TPU kernel trino_tpu/ops/pallas/hashagg.py `_build_kernel`
// (driven by `build_hash_table`).  Contract: words are up to 6 int32 per row;
// the start slot is hash_words(words) % T (T a power of two); equality is
// decided on all words; a row gets the group id of its key (ids dense in
// [0, n_groups), in claim order), -1 when dead or when its walk stepped past
// `budget` slots; the overflow flag is set when a walk ran out of budget or
// more than `cap` keys were claimed.
//
// What bounds it on an H100: the row stream (the words and the live byte
// read once, the id written once) while the table fits the 50 MB L2 (joins
// and group-bys up to ~2 M keys).  Past L2, the random 32-byte sectors of
// device memory each row's walk reads, one per slot visited, whose latency a
// warp waits on; and the claims: one compare-and-swap, one fence and one
// publish per new key, and the id counter every new key takes a number from.
//
// What the design does about it:
// - One record per slot (hashtable.cuh): a slot's state and its words come
//   in one vector load from one sector, not 1 + W sectors from separate
//   planes; the next slot of a walk is the neighbouring record.
// - The row loop is warp-uniform, 32 consecutive rows per warp pass.  Lanes
//   whose rows carry the same key (runs of equal keys are how a join's build
//   side arrives: lineitem's rows of one order are adjacent) are grouped by
//   __match_any_sync on the 64-bit hash and their words checked against the
//   group leader's; only the leader walks and claims, and hands its id to
//   the others with a shuffle.  A lane whose words differ from its leader's
//   (a hash collision) walks on its own.
// - The id counter: a new key takes its id with one atomicAdd; the leaders
//   of a warp that claim in the same pass issue theirs together.  Taking
//   one add per warp for them (ballot, popc, a shuffled base) measured no
//   faster at either tracked shape and is not done (PERF.md).
// - Claiming stays lock-free: an EMPTY slot is taken with atomicCAS(EMPTY ->
//   BUSY) on the record's state word; the winner writes its words, fences,
//   and publishes its id with atomicExch.  A loser reads the same slot again
//   (an equal key claimed at the same moment must converge on one entry); a
//   walk that meets BUSY reads the slot again on the next pass.  Records are
//   read from L2 (ld.global.cg), never from a line L1 cached before the words
//   were written.  A published slot whose words differ from the row's is read
//   once more after an acquire load of its state before the walk steps on:
//   the words of one vector load are not ordered after its state word.
// - The winner also writes its words to group_keys[w][gid] (gid < cap), so
//   the caller decodes output keys without reading the table.

#include "hashtable.cuh"

__device__ __forceinline__ int ld_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

template <int W>
__global__ void __launch_bounds__(256)
    hash_build_kernel(WordPtrs words, const uint8_t* __restrict__ live, long long n, int T,
                      int cap, int32_t* slots, int32_t* group_keys, int32_t* gid_out,
                      int32_t* counters, int budget) {
  constexpr int R = trino_record_words(W);
  constexpr unsigned FULL = 0xffffffffu;
  const unsigned mask = (unsigned)T - 1u;
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long base = ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * 32;
       base < n; base += warps * 32) {
    const long long r = base + lane;
    const bool in = r < n;
    const bool alive = in && live[r];
    int32_t w[W];
    uint64_t h = 0;
    if (alive) {
      trino_load_words<W>(words, r, w);
      h = trino_hash_words<W>(w);
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i) w[i] = 0;
    }
    const unsigned alive_mask = __ballot_sync(FULL, alive);
    if (alive_mask == 0) {  // the whole warp pass is dead rows
      if (in) gid_out[r] = -1;
      continue;
    }
    // lanes with equal keys: the lowest lane of each group walks for all
    const unsigned peers = __match_any_sync(FULL, h) & alive_mask;
    const int leader = alive ? __ffs(peers) - 1 : lane;
    bool same = true;
#pragma unroll
    for (int i = 0; i < W; ++i) same &= __shfl_sync(FULL, w[i], leader) == w[i];
    bool walking = alive && (leader == lane || !same);
    unsigned s = (unsigned)(h & mask);
    int g = -1;
    int walked = 0;
    while (__any_sync(FULL, walking)) {
      if (!walking) continue;
      int32_t* rec = slots + (size_t)s * R;
      const Record<R> v = trino_load_record_cg<R>(rec);
      const int st = v.v[0];
      if (st == TRINO_SLOT_EMPTY) {
        // a loser reads the same slot again on the next pass
        if (atomicCAS(rec, TRINO_SLOT_EMPTY, TRINO_SLOT_BUSY) == TRINO_SLOT_EMPTY) {
          g = atomicAdd(counters, 1);
#pragma unroll
          for (int i = 0; i < W; ++i) rec[1 + i] = w[i];
          if (g < cap) {
            if (group_keys != nullptr)
#pragma unroll
              for (int i = 0; i < W; ++i) group_keys[(long long)i * cap + g] = w[i];
          } else {
            atomicExch(counters + 1, 1);  // more keys than the capacity tier
          }
          __threadfence();  // the words are visible before the id is
          atomicExch(rec, g);
          walking = false;
        }
      } else if (st != TRINO_SLOT_BUSY) {  // published; BUSY: read again next pass
        bool eq = trino_record_equal<W, R>(v, w);
        if (!eq) {  // the words again, ordered after the state
          (void)ld_acquire(rec);
          eq = trino_record_equal<W, R>(trino_load_record_cg<R>(rec), w);
        }
        if (eq) {
          g = st;
          walking = false;
        } else {
          s = (s + 1u) & mask;
          if (++walked > budget) {
            atomicExch(counters + 1, 1);  // walk budget exhausted
            walking = false;
          }
        }
      }
    }
    // the leader's peers with its words take its id
    const int lg = __shfl_sync(FULL, g, leader);
    if (alive && leader != lane && same) g = lg;
    if (in) gid_out[r] = g;
  }
}

template <int W>
static void launch_build(WordPtrs words, const uint8_t* live, long long n, int T, int cap,
                         int32_t* slots, int32_t* group_keys, int32_t* gid_out, int32_t* counters,
                         int budget, cudaStream_t stream) {
  const int threads = 256;
  hash_build_kernel<W><<<trino_grid_blocks(n, threads), threads, 0, stream>>>(
      words, live, n, T, cap, slots, group_keys, gid_out, counters, budget);
}

// words: W int32 pointers [n]; live: bool [n]; slots: int32 [T, R] records
// (R = trino_record_words(W)) with every state word EMPTY; group_keys: int32
// [W, cap] or null; gid_out: int32 [n]; counters: int32 [2] zeroed
// (n_groups, overflow).  Returns cudaGetLastError().
extern "C" int trino_hash_build(WordPtrs words, int W, const void* live, long long n, int T,
                                int cap, void* slots, void* group_keys, void* gid_out,
                                void* counters, int budget, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const uint8_t* lv = (const uint8_t*)live;
  int32_t* sl = (int32_t*)slots;
  int32_t* gk = (int32_t*)group_keys;
  int32_t* out = (int32_t*)gid_out;
  int32_t* cn = (int32_t*)counters;
  cudaStream_t st = (cudaStream_t)stream;
  switch (W) {
    case 1: launch_build<1>(words, lv, n, T, cap, sl, gk, out, cn, budget, st); break;
    case 2: launch_build<2>(words, lv, n, T, cap, sl, gk, out, cn, budget, st); break;
    case 3: launch_build<3>(words, lv, n, T, cap, sl, gk, out, cn, budget, st); break;
    case 4: launch_build<4>(words, lv, n, T, cap, sl, gk, out, cn, budget, st); break;
    case 5: launch_build<5>(words, lv, n, T, cap, sl, gk, out, cn, budget, st); break;
    case 6: launch_build<6>(words, lv, n, T, cap, sl, gk, out, cn, budget, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
