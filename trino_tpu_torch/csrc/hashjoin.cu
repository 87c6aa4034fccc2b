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
// What bounds it on an H100: the bytes of the row stream (words and live
// byte in, id out) while the table fits the 50 MB L2; past that, one or more
// random 32-byte sectors of device memory per row (state, then the key
// words of each slot on the walk), whose latency the thread waits on.
//
// What the design does about it: one thread per row in a grid-stride loop,
// so many independent walks are in flight at once; the table is read-only
// for the whole launch, so every read goes through the read-only cache
// (__ldg) and no ordering is needed; a walk stops at the first slot that
// decides it (equal words or EMPTY), which at load <= 0.5 is one to three
// slots on average.

#include "hashtable.cuh"

__global__ void hash_probe_kernel(WordPtrs words, int W, const uint8_t* __restrict__ live,
                                  long long n, int T, const int32_t* __restrict__ state,
                                  const int32_t* __restrict__ keys, int32_t* gid_out,
                                  int32_t* unresolved, int budget) {
  const unsigned mask = (unsigned)T - 1u;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n; r += step) {
    int g = -1;
    if (live[r]) {
      int32_t w[TRINO_MAX_WORDS];
      trino_load_words(words, W, r, w);
      unsigned s = (unsigned)(trino_hash_words(w, W) & mask);
      int walked = 0;
      while (true) {
        const int st = __ldg(state + s);
        if (st == TRINO_SLOT_EMPTY) break;  // proven miss
        if (st >= 0) {
          bool eq = true;
          for (int i = 0; i < W; ++i) eq &= __ldg(keys + (long long)i * T + s) == w[i];
          if (eq) {
            g = st;
            break;
          }
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

// words: W int32 pointers [n]; live: bool [n]; state/keys: the table from
// trino_hash_build; gid_out: int32 [n]; unresolved: int32 [1] zeroed.
// Returns cudaGetLastError().
extern "C" int trino_hash_probe(WordPtrs words, int W, const void* live, long long n, int T,
                                const void* state, const void* keys, void* gid_out,
                                void* unresolved, int budget, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  hash_probe_kernel<<<trino_grid_blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
      words, W, (const uint8_t*)live, n, T, (const int32_t*)state, (const int32_t*)keys,
      (int32_t*)gid_out, (int32_t*)unresolved, budget);
  return (int)cudaGetLastError();
}
