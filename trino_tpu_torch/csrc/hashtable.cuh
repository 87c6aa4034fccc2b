// Shared by hashagg.cu (build) and hashjoin.cu (probe): the key-word
// pointers, the start-slot hash and the slot states of the open-addressing
// table both kernels walk.
//
// The table: T = 2 * pow2(cap) slots (a power of two), `state[T]` int32 —
// EMPTY, BUSY (claimed, words being written) or the published group id —
// and `keys[W * T]` int32, word w of slot s at keys[w * T + s].
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TRINO_MAX_WORDS 6
#define TRINO_SLOT_EMPTY (-1)
#define TRINO_SLOT_BUSY (-2)

struct WordPtrs {
  const int32_t* w[TRINO_MAX_WORDS];
};

// splitmix64 finalizer (ops/relops.py _mix64)
__device__ __forceinline__ uint64_t trino_mix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// the start-slot hash of ops/cuda/hashagg.py hash_words: h = mix(h ^ mix(u32(w)))
__device__ __forceinline__ uint64_t trino_hash_words(const int32_t* w, int W) {
  uint64_t h = 0;
#pragma unroll
  for (int i = 0; i < TRINO_MAX_WORDS; ++i)
    if (i < W) h = trino_mix64(h ^ trino_mix64((uint64_t)(uint32_t)w[i]));
  return h;
}

__device__ __forceinline__ void trino_load_words(const WordPtrs& p, int W, long long r,
                                                 int32_t* w) {
#pragma unroll
  for (int i = 0; i < TRINO_MAX_WORDS; ++i) w[i] = i < W ? p.w[i][r] : 0;
}

static inline int trino_grid_blocks(long long n, int threads) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  long long want = (n + threads - 1) / threads;
  long long cap = (long long)sms * 16;
  return (int)(want < cap ? want : cap);
}
