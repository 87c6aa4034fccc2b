// radix_histogram — one pass of radix select: the 256-bin histogram of one
// byte of the u32 keys of live rows whose higher bytes equal the prefix
// resolved so far.
//
// Replaces the TPU kernel trino_tpu/ops/pallas/topk.py `radix_topk_threshold`
// (which had no pallas_call of its own: each of its four passes was a
// 256-segment count through the segmented-reduce kernel, segreduce.py).
// Contract of one pass: hist[b] += #{live r : (u[r] >> shift) & 0xFF == b and
// u[r] & M == prefix & M}, M the bits above the byte (none on the first pass).
// The prefix lives in device memory: the bin selection between passes runs
// on the device (ops/cuda/topk.py), so four passes cost no host sync.
//
// What bounds it on an H100: bytes — 4 bytes of key and 1 live byte per row
// per pass, nothing written but 256 counters.
//
// What the design does about it: one thread per row, coalesced reads; each
// block counts into its own 256 bins in shared memory and folds them into the
// global bins with one atomic per non-empty bin.  Keys concentrate — the first
// byte of an int32-mapped price is the same for every row — so the lanes of a
// warp that fall into one bin are merged first (__match_any_sync) and their
// leader adds the group's size: one shared atomic per distinct bin per warp
// instead of 32 on one address.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void radix_hist_kernel(const uint32_t* __restrict__ u, const uint8_t* __restrict__ live,
                                  long long n, const long long* __restrict__ prefix, int shift,
                                  unsigned long long* hist) {
  __shared__ unsigned int bins[256];
  for (int b = threadIdx.x; b < 256; b += blockDim.x) bins[b] = 0;
  __syncthreads();
  const uint32_t mask = shift >= 24 ? 0u : (0xFFFFFFFFu << (shift + 8));
  const uint32_t want = (uint32_t)(*prefix) & mask;
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * blockDim.x;
  // warp-uniform trip count: every lane reaches __match_any_sync together
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n; base += step) {
    const long long r = base + threadIdx.x;
    int bin = 256;  // no bin
    if (r < n && live[r]) {
      const uint32_t v = u[r];
      if ((v & mask) == want) bin = (int)((v >> shift) & 0xFFu);
    }
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, bin);
    if (bin < 256 && lane == __ffs(peers) - 1) atomicAdd(&bins[bin], (unsigned)__popc(peers));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < 256; b += blockDim.x)
    if (bins[b]) atomicAdd(hist + b, (unsigned long long)bins[b]);
}

// u: u32 [n]; live: bool [n]; prefix: int64 [1] on the device (only its low
// 32 bits are read); hist: uint64 [256], accumulated into (the caller zeroes
// it).  Returns cudaGetLastError().
extern "C" int trino_radix_histogram(const void* u, const void* live, long long n,
                                     const void* prefix, int shift, void* hist, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const int threads = 256;
  long long want = (n + threads - 1) / threads;
  long long cap = (long long)sms * 8;
  const int blocks = (int)(want < cap ? want : cap);
  radix_hist_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)u, (const uint8_t*)live, n, (const long long*)prefix, shift,
      (unsigned long long*)hist);
  return (int)cudaGetLastError();
}
