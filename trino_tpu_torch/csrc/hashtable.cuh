// Shared by hashagg.cu (build) and hashjoin.cu (probe): the key-word
// pointers, the start-slot hash and the slot records of the open-addressing
// table both kernels walk.
//
// The table: T = 2 * pow2(cap) slots (a power of two), one aligned record of
// R = trino_record_words(W) int32 per slot.  Word 0 of a record is the slot's
// state — EMPTY, BUSY (claimed, words being written) or the published group
// id — and words 1..W are the key; the rest is padding.  A record is 8 bytes
// for W = 1, 16 for W <= 3 and 32 for W <= 6: it never straddles a 32-byte
// sector, a walk reads a slot with one vector load (two for 32 bytes), and
// linear probing's next slot is the neighbouring record.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TRINO_MAX_WORDS 6
#define TRINO_SLOT_EMPTY (-1)
#define TRINO_SLOT_BUSY (-2)

struct WordPtrs {
  const int32_t* w[TRINO_MAX_WORDS];
};

// int32 words per slot record (ops/cuda/hashagg.py record_words)
__host__ __device__ constexpr int trino_record_words(int W) {
  return W == 1 ? 2 : (W <= 3 ? 4 : 8);
}

template <int R>
struct Record {
  int32_t v[R];
};

// splitmix64 finalizer (ops/relops.py _mix64)
__device__ __forceinline__ uint64_t trino_mix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// the start-slot hash of ops/cuda/hashagg.py hash_words: h = mix(h ^ mix(u32(w)))
template <int W>
__device__ __forceinline__ uint64_t trino_hash_words(const int32_t (&w)[W]) {
  uint64_t h = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) h = trino_mix64(h ^ trino_mix64((uint64_t)(uint32_t)w[i]));
  return h;
}

template <int W>
__device__ __forceinline__ void trino_load_words(const WordPtrs& p, long long r, int32_t (&w)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) w[i] = p.w[i][r];
}

// the key words of a record against a row's words
template <int W, int R>
__device__ __forceinline__ bool trino_record_equal(const Record<R>& rec, const int32_t (&w)[W]) {
  bool eq = true;
#pragma unroll
  for (int i = 0; i < W; ++i) eq &= rec.v[1 + i] == w[i];
  return eq;
}

// A record through the read-only cache: the probe's table does not change
// during its launch.
template <int R>
__device__ __forceinline__ Record<R> trino_load_record_nc(const int32_t* p) {
  Record<R> rec;
  if constexpr (R == 2) {
    const int2 a = __ldg(reinterpret_cast<const int2*>(p));
    rec.v[0] = a.x, rec.v[1] = a.y;
  } else {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(p) + q);
      rec.v[4 * q] = a.x, rec.v[4 * q + 1] = a.y, rec.v[4 * q + 2] = a.z, rec.v[4 * q + 3] = a.w;
    }
  }
  return rec;
}

// A record from L2, past L1 (other blocks claim and publish slots during the
// build).  volatile with a memory clobber: a walk that waits on a BUSY slot
// reads the same address again, and the compiler must not reuse the value.
template <int R>
__device__ __forceinline__ Record<R> trino_load_record_cg(const int32_t* p) {
  Record<R> rec;
  if constexpr (R == 2) {
    asm volatile("ld.global.cg.v2.s32 {%0, %1}, [%2];"
                 : "=r"(rec.v[0]), "=r"(rec.v[1])
                 : "l"(p)
                 : "memory");
  } else {
#pragma unroll
    for (int q = 0; q < R / 4; ++q)
      asm volatile("ld.global.cg.v4.s32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(rec.v[4 * q]), "=r"(rec.v[4 * q + 1]), "=r"(rec.v[4 * q + 2]),
                     "=r"(rec.v[4 * q + 3])
                   : "l"(p + 4 * q)
                   : "memory");
  }
  return rec;
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
