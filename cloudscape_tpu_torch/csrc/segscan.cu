// K3: segmented inclusive prefix sum, for Hopper (sm_90a).
//
// Replaces the TPU kernel `segscan_sum_pallas` (`_kernel`) in
// cloudscape_tpu/ops/segscan_pallas.py. For n values and n head flags:
//
//   out[i] = values[i] + (heads[i] ? 0 : out[i - 1]),   out[-1] = 0,
//
// the `seg_sum` monoid of the v3 march's hot-list accumulation
// (march_fast.py `_accumulate_segmented`), for any n, with no padding.
//
// Bound: memory. An element is 5 bytes in (f32 value, u8 flag) and 4 out;
// at the headline's hot list (~2M elements) that is ~18 MB, a few
// microseconds at 3.35 TB/s. This design reads the input twice (~28 MB).
//
// Design: the TPU kernel carries the running sum from tile to tile in one
// SMEM scalar, because its grid runs in order. Blocks on the card run in no
// order, so the carry becomes a three-pass scan, like K2's compaction:
//
//   1. reduce: each block of 256 threads covers a tile of 4096 elements
//      (each warp 512 contiguous ones, 32 per round) and writes the tile's
//      aggregate: the sum since its last head, and whether it has a head;
//   2. scan: one block turns the tile aggregates into each tile's carry-in,
//      an exclusive segmented scan;
//   3. downsweep: each tile scans again, takes its warps' carry-ins from a
//      shared-memory scan of 8 warp aggregates, and adds the carry to the
//      elements that come before the first head of their warp's span.
//
// Within a round a warp runs a __shfl_up_sync segmented scan over
// (value, head) pairs; the running sum carries from round to round in
// registers. No atomics, so the result is the same on every run, and an
// element with its head flag set is written as its value, bit for bit.

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

// A segment-scan partial: the sum since the last head, and whether a head
// was seen.
struct Seg {
  float v;
  int f;
};

// The monoid: a comes before b.
__device__ __forceinline__ Seg combine(Seg a, Seg b) {
  return Seg{b.f ? b.v : a.v + b.v, a.f | b.f};
}

// Scans one warp's span of kWarpSpan elements from `base` into registers.
// On return v[r] is the segmented inclusive sum of element base + 32r + lane
// counted from the span's start, and bit r of `seen` says a head lies at or
// before that element within the span. Returns the span's aggregate.
__device__ __forceinline__ Seg warp_span(const float* __restrict__ values,
                                         const uint8_t* __restrict__ heads,
                                         long long base, long long n, int lane,
                                         float (&v)[kRounds], unsigned& seen) {
  float carry = 0.0f;
  int any = 0;
  seen = 0u;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + r * 32 + lane;
    float x = 0.0f;
    int f = 0;
    if (i < n) {
      x = values[i];
      f = heads[i] != 0;
    }
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const float ux = __shfl_up_sync(kFull, x, k);
      const int uf = __shfl_up_sync(kFull, f, k);
      if (lane >= k) {
        if (!f) x += ux;
        f |= uf;
      }
    }
    if (!f) x += carry;
    f |= any;
    v[r] = x;
    seen |= (unsigned)f << r;
    carry = __shfl_sync(kFull, x, 31);
    any = __shfl_sync(kFull, f, 31);
  }
  return Seg{carry, any};
}

// Combines the block's warp aggregates in order, starting from `in`; warp w's
// carry-in goes to warp_in[w]. Returns the tile's aggregate.
__device__ __forceinline__ Seg block_carry(Seg in, const Seg* warp_agg,
                                           float* warp_in) {
  Seg run = in;
  for (int w = 0; w < kWarps; ++w) {
    warp_in[w] = run.v;
    run = combine(run, warp_agg[w]);
  }
  return run;
}

__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ values,
              const uint8_t* __restrict__ heads, long long n,
              float* __restrict__ agg_v, int* __restrict__ agg_f) {
  __shared__ Seg warp_agg[kWarps];
  __shared__ float warp_in[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * kTile + warp * kWarpSpan;
  float v[kRounds];
  unsigned seen;
  const Seg a = warp_span(values, heads, base, n, lane, v, seen);
  if (lane == 0) warp_agg[warp] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    const Seg t = block_carry(Seg{0.0f, 0}, warp_agg, warp_in);
    agg_v[blockIdx.x] = t.v;
    agg_f[blockIdx.x] = t.f;
  }
}

// Tile aggregates → each tile's carry-in (the value part of the exclusive
// segmented scan).
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const float* __restrict__ agg_v, const int* __restrict__ agg_f,
            float* __restrict__ carry, int nb) {
  __shared__ float sv[kScanThreads];
  __shared__ int sf[kScanThreads];
  const int t = threadIdx.x;
  const int per = (nb + kScanThreads - 1) / kScanThreads;
  const int b0 = min(t * per, nb), b1 = min(b0 + per, nb);
  Seg s{0.0f, 0};
  for (int b = b0; b < b1; ++b) s = combine(s, Seg{agg_v[b], agg_f[b]});
  sv[t] = s.v;
  sf[t] = s.f;
  __syncthreads();
  for (int k = 1; k < kScanThreads; k <<= 1) {
    Seg cur{sv[t], sf[t]};
    if (t >= k) cur = combine(Seg{sv[t - k], sf[t - k]}, cur);
    __syncthreads();
    sv[t] = cur.v;
    sf[t] = cur.f;
    __syncthreads();
  }
  Seg run = t > 0 ? Seg{sv[t - 1], sf[t - 1]} : Seg{0.0f, 0};
  for (int b = b0; b < b1; ++b) {
    carry[b] = run.v;
    run = combine(run, Seg{agg_v[b], agg_f[b]});
  }
}

__global__ void __launch_bounds__(kThreads)
downsweep_kernel(const float* __restrict__ values,
                 const uint8_t* __restrict__ heads, long long n,
                 const float* __restrict__ carry, float* __restrict__ out) {
  __shared__ Seg warp_agg[kWarps];
  __shared__ float warp_in[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * kTile + warp * kWarpSpan;
  float v[kRounds];
  unsigned seen;
  const Seg a = warp_span(values, heads, base, n, lane, v, seen);
  if (lane == 0) warp_agg[warp] = a;
  __syncthreads();
  if (threadIdx.x == 0)
    block_carry(Seg{carry[blockIdx.x], 0}, warp_agg, warp_in);
  __syncthreads();
  const float cin = warp_in[warp];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + r * 32 + lane;
    if (i < n) out[i] = ((seen >> r) & 1u) ? v[r] : v[r] + cin;
  }
}

}  // namespace

// Scratch ints the scan of n elements needs (three per tile).
extern "C" long long cs_segscan_scratch(long long n) {
  return 3 * ((n + kTile - 1) / kTile);
}

// values: [n] f32; heads: [n] u8 (nonzero = segment head); out: [n] f32;
// scratch: [cs_segscan_scratch(n)] i32. Returns a CUDA error code (0 = ok).
extern "C" int cs_segscan(const void* values, const void* heads, long long n,
                          void* out, void* scratch, long long scratch_len,
                          void* stream) {
  const long long nb = (n + kTile - 1) / kTile;
  if (n < 0 || nb > 0x7fffffffLL || scratch_len < 3 * nb)
    return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  float* agg_v = (float*)scratch;
  int* agg_f = (int*)scratch + nb;
  float* carry = (float*)scratch + 2 * nb;
  const float* vals = (const float*)values;
  const uint8_t* hds = (const uint8_t*)heads;
  reduce_kernel<<<(unsigned)nb, kThreads, 0, s>>>(vals, hds, n, agg_v, agg_f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_kernel<<<1, kScanThreads, 0, s>>>(agg_v, agg_f, carry, (int)nb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  downsweep_kernel<<<(unsigned)nb, kThreads, 0, s>>>(vals, hds, n, carry,
                                                     (float*)out);
  return (int)cudaGetLastError();
}
