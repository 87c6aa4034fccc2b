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
// What bounds it on an H100: with a table that fits the 50 MB L2 (joins and
// group-bys up to ~2 M keys), the bytes of the row stream: the words and the
// live byte read once, the id written once.  Past L2, every row's first slot
// probe is a random 32-byte sector read from device memory (state plus the
// key words of a slot lie in different planes, so one or more sectors each),
// and latency of those dependent reads, not bandwidth, is what a thread waits
// on.
//
// What the design does about it: nothing of the TPU design is carried over
// (no VMEM table, no one-hot matmuls, no f32 halves).  One thread per row in
// a grid-stride loop keeps many independent probes in flight to hide the
// random-read latency; the row's words stay in registers for the whole walk.
// Claiming is lock-free: an EMPTY slot is taken with atomicCAS(EMPTY->BUSY),
// the winner writes its words, takes its id with atomicAdd on the group
// counter, fences, and publishes the id with atomicExch.  A loser re-reads
// the same slot (an equal key claimed by another row at the same moment must
// converge on one entry, the race the reference resolves per sub-chunk).  A
// row that finds BUSY waits on the slot with acquire loads (a plain load
// could spin on a stale cached value); key words of other rows' slots are
// read with L2-only loads so a line cached in L1 before the words were
// written is never compared.  The winner also writes its words to
// group_keys[w][gid] (gid < cap), so the caller decodes output keys without
// sorting the table.

#include "hashtable.cuh"

__device__ __forceinline__ int ld_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__global__ void hash_build_kernel(WordPtrs words, int W, const uint8_t* __restrict__ live,
                                  long long n, int T, int cap, int32_t* state, int32_t* keys,
                                  int32_t* group_keys, int32_t* gid_out, int32_t* counters,
                                  int budget) {
  const unsigned mask = (unsigned)T - 1u;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n; r += step) {
    if (!live[r]) {
      gid_out[r] = -1;
      continue;
    }
    int32_t w[TRINO_MAX_WORDS];
    trino_load_words(words, W, r, w);
    unsigned s = (unsigned)(trino_hash_words(w, W) & mask);
    int g = -1;
    int walked = 0;
    while (true) {
      const int st = ld_acquire(state + s);
      if (st == TRINO_SLOT_EMPTY) {
        if (atomicCAS(state + s, TRINO_SLOT_EMPTY, TRINO_SLOT_BUSY) == TRINO_SLOT_EMPTY) {
          for (int i = 0; i < W; ++i) keys[(long long)i * T + s] = w[i];
          g = atomicAdd(counters, 1);
          if (g < cap) {
            if (group_keys != nullptr)
              for (int i = 0; i < W; ++i) group_keys[(long long)i * cap + g] = w[i];
          } else {
            atomicExch(counters + 1, 1);  // more keys than the capacity tier
          }
          __threadfence();  // the words are visible before the id is
          atomicExch(state + s, g);
          break;
        }
        continue;  // lost the claim: read the same slot again
      }
      if (st == TRINO_SLOT_BUSY) continue;  // wait for the claimant to publish
      bool eq = true;
      for (int i = 0; i < W; ++i) eq &= __ldcg(keys + (long long)i * T + s) == w[i];
      if (eq) {
        g = st;
        break;
      }
      s = (s + 1u) & mask;
      if (++walked > budget) {
        atomicExch(counters + 1, 1);  // walk budget exhausted
        break;
      }
    }
    gid_out[r] = g;
  }
}

// words: W int32 pointers [n]; live: bool [n]; state: int32 [T] filled with
// EMPTY; keys: int32 [W, T]; group_keys: int32 [W, cap] or null; gid_out:
// int32 [n]; counters: int32 [2] zeroed (n_groups, overflow).  Returns
// cudaGetLastError().
extern "C" int trino_hash_build(WordPtrs words, int W, const void* live, long long n, int T,
                                int cap, void* state, void* keys, void* group_keys,
                                void* gid_out, void* counters, int budget, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  hash_build_kernel<<<trino_grid_blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
      words, W, (const uint8_t*)live, n, T, cap, (int32_t*)state, (int32_t*)keys,
      (int32_t*)group_keys, (int32_t*)gid_out, (int32_t*)counters, budget);
  return (int)cudaGetLastError();
}
