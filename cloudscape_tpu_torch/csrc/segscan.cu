// K3: segmented inclusive prefix sum, for Hopper (sm_90a).
//
// Replaces the TPU kernel `segscan_sum_pallas` (`_kernel`) in
// cloudscape_tpu/ops/segscan_pallas.py. For k rows of n values (k = 1..4,
// row stride n) and one row of n head flags:
//
//   out[r, i] = values[r, i] + (heads[i] ? 0 : out[r, i - 1]),   out[r, -1] = 0,
//
// the `seg_sum` monoid of the v3 march's hot-list accumulation
// (march_fast.py `_accumulate_segmented`: the log-transmittance scan with
// k = 1, then the three radiance channels together with k = 3), for any n.
//
// Bound: memory. An element is 4k + 1 bytes in (k f32 values and one u8
// flag that the rows share) and 4k out: (8k + 1) bytes over 3.35 TB/s.
// At the 768² re-render's hot list (819,200 elements) that is 2.20 us for
// k = 1 and 6.11 us for k = 3.
//
// Design: one cooperative launch of 256-thread blocks, at most four per SM
// (K2's skeleton, csrc/compact.cu, on (value, head) pairs). The plan
// (elements per block, blocks, stash bytes) comes from ops/segscan.py's
// `segscan_plan`; it depends on n alone, not on k.
//
//   1. scan: block b takes the elements [b·E, (b + 1)·E), each warp a
//      contiguous span of E/8 in rounds of 128. Lane l takes 4 consecutive
//      elements (a 16-byte load per row and one 4-byte load of flags when
//      the rows and flags are aligned, else scalar loads), scans them in
//      registers, and one __shfl_up_sync segmented scan over the lanes plus
//      the carry from the round before give every element its sum from the
//      span's start. Those sums go to shared memory when the block's k rows
//      fit in the plan's stash; a larger range is loaded and scanned again
//      in step 4 instead, as K2 re-reads its mask. The block's aggregate
//      (per row the sum since its last head; whether it holds a head) goes
//      to global scratch.
//   2. cg::this_grid().sync() (no -rdc needed: the cooperative launch makes
//      the blocks co-resident).
//   3. carry: warp 0 combines the aggregates of the blocks before b in index
//      order, 32 at a time by a fixed shuffle tree, walking back only until
//      a chunk holds a head (on the hot lists, whose segments are one ray's
//      few cells, the first chunk does). Thread 0 carries the result through
//      the block's warp aggregates to each warp's carry-in.
//   4. write: each element before its warp span's first head adds the
//      span's carry-in; every output is written once, coalesced (16-byte
//      stores where aligned).
//
// One launch instead of the earlier reduce / one-block scan / downsweep,
// the input read from device memory once instead of twice, and the k rows
// of one call share one read of the flags (the march scans its three
// radiance channels in one call). No atomics and a fixed order of every
// float addition, so two calls on the same input give bitwise-equal
// outputs, and a row of a [k, n] call equals the 1-D call on that row bit
// for bit; a head element is written as its value, bit for bit (a select,
// never a + 0).
//
// What is left: every block loads and scans its whole range before the
// grid barrier, so no output is written before the slowest block has
// loaded; the walk-back reads its aggregates from L2 after the barrier.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 4;  // ops/segscan.py's BLOCKS_PER_SM
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRound = 128;                   // 4 elements a lane
constexpr int kBlockRound = kWarps * kWarpRound;  // ops/segscan.py's BLOCK_ROUND
constexpr int kMaxRows = 4;
constexpr unsigned kFull = 0xffffffffu;

// A segment-scan partial of K rows: per row the sum since the last head,
// and whether a head was seen.
template <int K>
struct Seg {
  float v[K];
  int f;
};

template <int K>
__device__ __forceinline__ Seg<K> seg_zero() {
  Seg<K> s;
#pragma unroll
  for (int c = 0; c < K; ++c) s.v[c] = 0.0f;
  s.f = 0;
  return s;
}

// The monoid: a comes before b.
template <int K>
__device__ __forceinline__ Seg<K> combine(const Seg<K>& a, const Seg<K>& b) {
  Seg<K> r;
#pragma unroll
  for (int c = 0; c < K; ++c) r.v[c] = b.f ? b.v[c] : a.v[c] + b.v[c];
  r.f = a.f | b.f;
  return r;
}

template <int K>
__device__ __forceinline__ Seg<K> shfl_up(const Seg<K>& s, int d) {
  Seg<K> r;
#pragma unroll
  for (int c = 0; c < K; ++c) r.v[c] = __shfl_up_sync(kFull, s.v[c], d);
  r.f = __shfl_up_sync(kFull, s.f, d);
  return r;
}

template <int K>
__device__ __forceinline__ Seg<K> shfl_from(const Seg<K>& s, int lane) {
  Seg<K> r;
#pragma unroll
  for (int c = 0; c < K; ++c) r.v[c] = __shfl_sync(kFull, s.v[c], lane);
  r.f = __shfl_sync(kFull, s.f, lane);
  return r;
}

// Inclusive segmented scan over the warp's lanes, lane 0 first.
template <int K>
__device__ __forceinline__ Seg<K> warp_scan(Seg<K> s, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg<K> up = shfl_up(s, d);
    if (lane >= d) s = combine(up, s);
  }
  return s;
}

struct Args {
  const float* values;   // [k, n], row stride n
  const uint8_t* heads;  // [n], nonzero = segment head
  float* out;            // [k, n]
  long long n;
  int vec;  // rows of values and out 16-B aligned, heads 4-B aligned
};

// Elements i..i+3 (i a multiple of 4) of every row into x; bit j of the
// result says element i + j is a head. Elements at or past n read as 0 and
// no head.
template <int K>
__device__ __forceinline__ unsigned load4(const Args& a, long long i, float (&x)[K][4]) {
  unsigned hb = 0u;
  if (a.vec && i + 4 <= a.n) {
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(a.values + c * a.n + i));
      x[c][0] = q.x;
      x[c][1] = q.y;
      x[c][2] = q.z;
      x[c][3] = q.w;
    }
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(a.heads + i));
#pragma unroll
    for (int j = 0; j < 4; ++j) hb |= ((w >> (8 * j)) & 0xffu) ? (1u << j) : 0u;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long e = i + j;
      const bool in = e < a.n;
#pragma unroll
      for (int c = 0; c < K; ++c) x[c][j] = in ? __ldg(a.values + c * a.n + e) : 0.0f;
      if (in && __ldg(a.heads + e) != 0) hb |= 1u << j;
    }
  }
  return hb;
}

template <int K>
__device__ __forceinline__ void store4(const Args& a, long long i, const float (&y)[K][4]) {
  if (a.vec && i + 4 <= a.n) {
#pragma unroll
    for (int c = 0; c < K; ++c)
      *reinterpret_cast<float4*>(a.out + c * a.n + i) =
          make_float4(y[c][0], y[c][1], y[c][2], y[c][3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i + j < a.n) {
#pragma unroll
        for (int c = 0; c < K; ++c) a.out[c * a.n + i + j] = y[c][j];
      }
  }
}

// One warp round, the lane's elements i..i+3: y gets each element's sum
// from the warp span's start, given `run`, the span's partial before this
// round, which then advances past the round. Returns the lane's head bits.
template <int K>
__device__ __forceinline__ unsigned scan_round(const Args& a, long long i, int lane,
                                               Seg<K>& run, float (&y)[K][4]) {
  float x[K][4];
  const unsigned hb = load4<K>(a, i, x);
#pragma unroll
  for (int j = 1; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < K; ++c)
      x[c][j] = ((hb >> j) & 1u) ? x[c][j] : x[c][j - 1] + x[c][j];
  Seg<K> s;
#pragma unroll
  for (int c = 0; c < K; ++c) s.v[c] = x[c][3];
  s.f = hb != 0u;
  const Seg<K> inc = warp_scan(s, lane);
  Seg<K> ex = shfl_up(inc, 1);  // the lanes before this one
  if (lane == 0) ex = seg_zero<K>();
  const Seg<K> pre = combine(run, ex);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < K; ++c)
      y[c][j] = (hb & ((2u << j) - 1u)) ? x[c][j] : pre.v[c] + x[c][j];
  run = combine(run, shfl_from(inc, 31));
  return hb;
}

template <int K>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
segscan_kernel(Args a, int rounds, int stash, float* __restrict__ agg_v,
               int* __restrict__ agg_f) {
  extern __shared__ float4 dyn[];
  float* sums = reinterpret_cast<float*>(dyn);  // [K][E] span sums, if stash
  __shared__ Seg<K> warp_agg[kWarps];
  __shared__ float warp_in[kWarps][K];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_block = rounds * kBlockRound;  // E
  const long long b0 = (long long)blockIdx.x * per_block;
  const int w0 = warp * rounds * kWarpRound;  // the warp's span, from b0

  // 1. Scan the span; `first` is the span's first head (from b0).
  Seg<K> run = seg_zero<K>();
  int first = INT_MAX;
  for (int r = 0; r < rounds; ++r) {
    const int l = w0 + r * kWarpRound + 4 * lane;
    if (b0 + w0 + r * kWarpRound >= a.n) break;  // the same for the whole warp
    float y[K][4];
    const unsigned hb = scan_round<K>(a, b0 + l, lane, run, y);
    if (hb != 0u && first == INT_MAX) first = l + __ffs(hb) - 1;
    if (stash) {
#pragma unroll
      for (int c = 0; c < K; ++c)
        *reinterpret_cast<float4*>(sums + c * per_block + l) =
            make_float4(y[c][0], y[c][1], y[c][2], y[c][3]);
    }
  }
  first = __reduce_min_sync(kFull, first);
  if (lane == 0) warp_agg[warp] = run;
  __syncthreads();
  if (threadIdx.x == 0) {
    Seg<K> t = warp_agg[0];
    for (int w = 1; w < kWarps; ++w) t = combine(t, warp_agg[w]);
#pragma unroll
    for (int c = 0; c < K; ++c) agg_v[c * gridDim.x + blockIdx.x] = t.v[c];
    agg_f[blockIdx.x] = t.f;
  }

  // 2. Every block's aggregate is written.
  cg::this_grid().sync();

  // 3. The block's carry-in: the blocks before it, combined in index order
  // back to the nearest one that holds a head; then each warp's.
  if (warp == 0) {
    Seg<K> carry = seg_zero<K>();
    for (int hi = blockIdx.x; hi > 0; hi -= 32) {
      const int j = hi - 32 + lane;
      Seg<K> s = seg_zero<K>();
      if (j >= 0) {
#pragma unroll
        for (int c = 0; c < K; ++c) s.v[c] = __ldcg(agg_v + c * gridDim.x + j);
        s.f = __ldcg(agg_f + j);
      }
      carry = combine(shfl_from(warp_scan(s, lane), 31), carry);
      if (carry.f) break;  // the same for the whole warp
    }
    if (lane == 0) {
      for (int w = 0; w < kWarps; ++w) {
#pragma unroll
        for (int c = 0; c < K; ++c) warp_in[w][c] = carry.v[c];
        carry = combine(carry, warp_agg[w]);
      }
    }
  }
  __syncthreads();

  // 4. Add the carry-in before the span's first head and write.
  float cin[K];
#pragma unroll
  for (int c = 0; c < K; ++c) cin[c] = warp_in[warp][c];
  run = seg_zero<K>();
  for (int r = 0; r < rounds; ++r) {
    const int l = w0 + r * kWarpRound + 4 * lane;
    if (b0 + w0 + r * kWarpRound >= a.n) break;
    float y[K][4];
    if (stash) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const float4 q = *reinterpret_cast<const float4*>(sums + c * per_block + l);
        y[c][0] = q.x;
        y[c][1] = q.y;
        y[c][2] = q.z;
        y[c][3] = q.w;
      }
    } else {
      scan_round<K>(a, b0 + l, lane, run, y);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < K; ++c) y[c][j] = l + j < first ? y[c][j] + cin[c] : y[c][j];
    store4<K>(a, b0 + l, y);
  }
}

// Per device, once: whether it takes cooperative launches (1 yes, -1 no, 0
// not asked yet); and per row count the dynamic shared memory the kernel
// may use there.
constexpr int kMaxDevices = 64;
int coop_checked[kMaxDevices];
int smem_allowed[kMaxRows][kMaxDevices];

template <int K>
cudaError_t launch(Args a, int rounds, int blocks, int stash_bytes, float* agg_v,
                   int* agg_f, int dev, cudaStream_t stream) {
  if (stash_bytes > smem_allowed[K - 1][dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        segscan_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, stash_bytes);
    if (e != cudaSuccess) return e;
    smem_allowed[K - 1][dev] = stash_bytes;
  }
  int stash = stash_bytes != 0;
  void* args[] = {&a, &rounds, &stash, &agg_v, &agg_f};
  return cudaLaunchCooperativeKernel((const void*)segscan_kernel<K>, dim3(blocks),
                                     dim3(kThreads), args, (size_t)stash_bytes, stream);
}

}  // namespace

// values: [rows, n] f32 contiguous (rows 1..4), any 4-B alignment; heads:
// [n] u8 (nonzero = segment head), any alignment; out: [rows, n] f32;
// scratch: [scratch_len >= (rows + 1) * blocks] i32. rounds, blocks,
// stash_bytes: the plan of ops/segscan.py (`segscan_plan`): a block scans
// rounds * 1024 elements, there are at most four blocks per SM, and a
// block keeps its span sums in stash_bytes of shared memory (4 * rows *
// rounds * 1024, or 0 to load and scan its range again). Returns a CUDA
// error code (0 = ok).
extern "C" int cs_segscan(const void* values, const void* heads, int rows, long long n,
                          int rounds, int blocks, int stash_bytes, void* out,
                          void* scratch, long long scratch_len, void* stream) {
  if (rows < 1 || rows > kMaxRows || n < 0 || rounds < 1 || blocks < 1 ||
      (long long)rounds * kBlockRound > (1LL << 24) ||
      (long long)blocks * rounds * kBlockRound < n ||
      scratch_len < (long long)(rows + 1) * blocks || stash_bytes < 0 ||
      (stash_bytes != 0 && stash_bytes < 4LL * rows * rounds * kBlockRound))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  if (((uintptr_t)values & 3) || ((uintptr_t)out & 3)) return (int)cudaErrorMisalignedAddress;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (coop_checked[dev] == 0) {
    int coop;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return (int)e;
    coop_checked[dev] = coop ? 1 : -1;
  }
  if (coop_checked[dev] < 0) return (int)cudaErrorNotSupported;
  const bool rows_aligned = rows == 1 || n % 4 == 0;
  Args a{(const float*)values, (const uint8_t*)heads, (float*)out, n,
         rows_aligned && ((uintptr_t)values & 15) == 0 && ((uintptr_t)out & 15) == 0 &&
             ((uintptr_t)heads & 3) == 0};
  float* agg_v = (float*)scratch;
  int* agg_f = (int*)scratch + (long long)rows * blocks;
  cudaStream_t s = (cudaStream_t)stream;
  switch (rows) {
    case 1: e = launch<1>(a, rounds, blocks, stash_bytes, agg_v, agg_f, dev, s); break;
    case 2: e = launch<2>(a, rounds, blocks, stash_bytes, agg_v, agg_f, dev, s); break;
    case 3: e = launch<3>(a, rounds, blocks, stash_bytes, agg_v, agg_f, dev, s); break;
    default: e = launch<4>(a, rounds, blocks, stash_bytes, agg_v, agg_f, dev, s); break;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
