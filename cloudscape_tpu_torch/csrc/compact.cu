// K2: stream compaction of a flat mask, for Hopper (sm_90a).
//
// Replaces the TPU kernel `compact_indices_pallas` (`_kernel`) in
// cloudscape_tpu/ops/compact_pallas.py. Outputs, for a mask of n bytes:
//
//   idx[capacity]: flat indices of the first `capacity` set entries,
//                  ascending, the rest filled with `fill`;
//   rank[n]:       each element's exclusive rank (set entries before it).
//
// Bound: memory, and little of it: at the serving path's cone-occupancy
// finalize (8,388,608 cells into 3,801,088 slots) the mask is 8.4 MB read
// twice, rank 33.6 MB and idx 15.2 MB written — ~65 MB, ~20 us at 3.35 TB/s.
//
// Design: the TPU kernel walks its grid in order with one write cursor;
// blocks here run in no order, so the cursor becomes a three-pass scan:
//
//   1. count: each block of 256 threads covers a tile of 4096 elements
//      (each warp 512 contiguous ones, 32 per round); __ballot_sync and
//      __popc count the set bits without shared-memory traffic;
//   2. scan: one block turns the ~2,048 tile counts into exclusive tile
//      offsets in place and writes the grand total after them;
//   3. scatter: each tile recounts its warps, takes warp offsets from a
//      shared-memory scan of 8 values, and writes rank for every element
//      and idx[rank] = i for set elements with rank < capacity;
//   4. fill: slots from min(total, capacity) to capacity get `fill`.
//
// No atomics, so the output is the same on every run and equals
// torch.nonzero's order bitwise. The mask may have any length.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;
constexpr int kWarpSpan = 32 * kRounds;       // 512 elements per warp
constexpr int kTile = kWarps * kWarpSpan;     // 4096 elements per block
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool is_set(const uint8_t* mask, long long i,
                                       long long n) {
  return i < n && mask[i] != 0;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ mask, long long n,
             int* __restrict__ counts) {
  __shared__ int warp_count[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * kTile + warp * kWarpSpan;
  int c = 0;
#pragma unroll 4
  for (int r = 0; r < kRounds; ++r)
    c += __popc(__ballot_sync(kFull, is_set(mask, base + r * 32 + lane, n)));
  if (lane == 0) warp_count[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_count[w];
    counts[blockIdx.x] = s;
  }
}

// counts[0:nb] → exclusive offsets in place; counts[nb] = total.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ counts, int nb) {
  __shared__ int sums[kScanThreads];
  const int t = threadIdx.x;
  const int per = (nb + kScanThreads - 1) / kScanThreads;
  const int b0 = min(t * per, nb), b1 = min(b0 + per, nb);
  int s = 0;
  for (int b = b0; b < b1; ++b) s += counts[b];
  sums[t] = s;
  __syncthreads();
  for (int k = 1; k < kScanThreads; k <<= 1) {
    const int v = t >= k ? sums[t - k] : 0;
    __syncthreads();
    sums[t] += v;
    __syncthreads();
  }
  int run = sums[t] - s;
  for (int b = b0; b < b1; ++b) {
    const int c = counts[b];
    counts[b] = run;
    run += c;
  }
  if (t == kScanThreads - 1) counts[nb] = sums[t];
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint8_t* __restrict__ mask, long long n,
               const int* __restrict__ offsets, int capacity,
               int* __restrict__ idx, int* __restrict__ rank) {
  __shared__ int warp_off[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * kTile + warp * kWarpSpan;
  int c = 0;
#pragma unroll 4
  for (int r = 0; r < kRounds; ++r)
    c += __popc(__ballot_sync(kFull, is_set(mask, base + r * 32 + lane, n)));
  if (lane == 0) warp_off[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = offsets[blockIdx.x];
    for (int w = 0; w < kWarps; ++w) {
      const int v = warp_off[w];
      warp_off[w] = s;
      s += v;
    }
  }
  __syncthreads();
  int run = warp_off[warp];
  const unsigned below = (1u << lane) - 1u;
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + r * 32 + lane;
    const bool set = is_set(mask, i, n);
    const unsigned bits = __ballot_sync(kFull, set);
    const int rk = run + __popc(bits & below);
    if (i < n) rank[i] = rk;
    if (set && rk < capacity) idx[rk] = (int)i;
    run += __popc(bits);
  }
}

__global__ void fill_kernel(const int* __restrict__ total, int capacity,
                            int fill, int* __restrict__ idx) {
  const int start = min(*total, capacity);
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       k < capacity; k += (long long)gridDim.x * blockDim.x)
    if (k >= start) idx[k] = fill;
}

}  // namespace

// Scratch ints the compaction of n elements needs (tile counts + total).
extern "C" long long cs_compact_scratch(long long n) {
  return (n + kTile - 1) / kTile + 1;
}

// mask: [n] u8 (nonzero = set); idx: [capacity] i32; rank: [n] i32;
// scratch: [cs_compact_scratch(n)] i32. Returns a CUDA error code (0 = ok).
extern "C" int cs_compact(const void* mask, long long n, int capacity,
                          int fill, void* idx, void* rank, void* scratch,
                          long long scratch_len, void* stream) {
  const long long nb = (n + kTile - 1) / kTile;
  if (n < 0 || n > 0x7fffffffLL || capacity < 0 || scratch_len < nb + 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int* counts = (int*)scratch;
  if (nb > 0) {
    count_kernel<<<(unsigned)nb, kThreads, 0, s>>>((const uint8_t*)mask, n,
                                                   counts);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    scan_kernel<<<1, kScanThreads, 0, s>>>(counts, (int)nb);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    scatter_kernel<<<(unsigned)nb, kThreads, 0, s>>>(
        (const uint8_t*)mask, n, counts, capacity, (int*)idx, (int*)rank);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  } else {
    cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(int), s);
    if (e != cudaSuccess) return (int)e;
  }
  if (capacity > 0) {
    long long blocks = ((long long)capacity + kThreads - 1) / kThreads;
    if (blocks > 4096) blocks = 4096;
    fill_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(counts + nb, capacity,
                                                      fill, (int*)idx);
  }
  return (int)cudaGetLastError();
}
