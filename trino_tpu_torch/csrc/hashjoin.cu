// hash_probe — look every live row's key up in a finished hash table.
//
// Replaces the TPU kernel trino_tpu/ops/pallas/hashjoin.py `_probe_kernel`
// (driven by `probe_hash_table`).  Contract: the table is the one
// hash_build wrote (hashtable.cuh), now read-only; each row walks the same
// linear-probing sequence from hash_words(words) % T and gets the group id of
// the published slot whose words equal its own, or -1 when its walk reaches
// an EMPTY slot (a proven miss) or the row is dead; a walk past `budget`
// slots sets the unresolved flag (the caller then discards the result and
// takes its sort path).
//
// What bounds it on an H100: the row stream (words and live byte in, id out)
// while the table fits the 50 MB L2; past that, one random 32-byte sector of
// device memory per slot a walk visits, and the latency of those reads.
//
// What the design does about it:
// - One record per slot (hashtable.cuh): a slot's state and words come in
//   one vector load through the read-only cache (the table does not change
//   during the launch, so no ordering is needed), so a hit costs one sector,
//   not one for the state and one more for the words.
// - One thread per row in a grid-stride loop, so many independent walks are
//   in flight at once.  Giving a thread 2 or 4 rows whose first loads are
//   issued together
//   measured no faster at either tracked shape and is not done (PERF.md).
//   At load <= 0.5 most walks end at their first slot (equal words or
//   EMPTY); the rest step to the neighbouring record, usually in the same
//   line.

#include "hashtable.cuh"

template <int W>
__global__ void __launch_bounds__(256)
    hash_probe_kernel(WordPtrs words, const uint8_t* __restrict__ live, long long n, int T,
                      const int32_t* __restrict__ slots, int32_t* gid_out, int32_t* unresolved,
                      int budget) {
  constexpr int R = trino_record_words(W);
  const unsigned mask = (unsigned)T - 1u;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n; r += step) {
    int g = -1;
    if (live[r]) {
      int32_t w[W];
      trino_load_words<W>(words, r, w);
      unsigned s = (unsigned)(trino_hash_words<W>(w) & mask);
      int walked = 0;
      while (true) {
        const Record<R> v = trino_load_record_nc<R>(slots + (size_t)s * R);
        const int st = v.v[0];
        if (st == TRINO_SLOT_EMPTY) break;  // proven miss
        if (st >= 0 && trino_record_equal<W, R>(v, w)) {
          g = st;
          break;
        }
        s = (s + 1u) & mask;
        if (++walked > budget) {
          atomicExch(unresolved, 1);
          break;
        }
      }
    }
    gid_out[r] = g;
  }
}

template <int W>
static void launch_probe(WordPtrs words, const uint8_t* live, long long n, int T,
                         const int32_t* slots, int32_t* gid_out, int32_t* unresolved, int budget,
                         cudaStream_t stream) {
  const int threads = 256;
  hash_probe_kernel<W><<<trino_grid_blocks(n, threads), threads, 0, stream>>>(
      words, live, n, T, slots, gid_out, unresolved, budget);
}

// words: W int32 pointers [n]; live: bool [n]; slots: the table's records
// from trino_hash_build; gid_out: int32 [n]; unresolved: int32 [1] zeroed.
// Returns cudaGetLastError().
extern "C" int trino_hash_probe(WordPtrs words, int W, const void* live, long long n, int T,
                                const void* slots, void* gid_out, void* unresolved, int budget,
                                void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const uint8_t* lv = (const uint8_t*)live;
  const int32_t* sl = (const int32_t*)slots;
  int32_t* out = (int32_t*)gid_out;
  int32_t* un = (int32_t*)unresolved;
  cudaStream_t st = (cudaStream_t)stream;
  switch (W) {
    case 1: launch_probe<1>(words, lv, n, T, sl, out, un, budget, st); break;
    case 2: launch_probe<2>(words, lv, n, T, sl, out, un, budget, st); break;
    case 3: launch_probe<3>(words, lv, n, T, sl, out, un, budget, st); break;
    case 4: launch_probe<4>(words, lv, n, T, sl, out, un, budget, st); break;
    case 5: launch_probe<5>(words, lv, n, T, sl, out, un, budget, st); break;
    case 6: launch_probe<6>(words, lv, n, T, sl, out, un, budget, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
