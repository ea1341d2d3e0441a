// K2: stream compaction of a flat mask, for Hopper (sm_90a).
//
// Replaces the TPU kernel `compact_indices_pallas` (`_kernel`) in
// cloudscape_tpu/ops/compact_pallas.py. Outputs, for a mask of n bytes:
//
//   idx[capacity]: flat indices of the first `capacity` set entries,
//                  ascending, the rest filled with `fill`;
//   rank[n]:       each element's exclusive rank (set entries before it),
//                  only when the caller passes a rank buffer.
//
// Bound: memory. At the serving path's cone-occupancy finalize (8,388,608
// cells into 3,801,088 slots) the mask is 8.4 MB read once and idx 15.2 MB
// written: 23.6 MB, 7.0 us at 3.35 TB/s; with rank (33.6 MB more) 17.1 us.
//
// Design: one cooperative launch of blocks of 256 threads, at most four per
// SM (the TPU kernel walks its grid in order with one write cursor; blocks
// here run in no order, so the cursor becomes a block offset):
//
//   1. load: the mask, seen as 16-byte words from its 16-B aligned start
//      (a word at either end that holds bytes outside the mask reads them
//      as 0, byte by byte), is cut into one contiguous range of words per
//      block. Each thread keeps 4 words' loads in flight, stashes the words
//      in dynamic shared memory and counts their nonzero bytes; a block sum
//      gives the block's count, written to `counts`;
//   2. grid.sync() (cooperative_groups, no -rdc needed: the cooperative
//      launch guarantees the blocks are co-resident);
//   3. offset and total: each block sums the counts of the blocks before it
//      and of all blocks: integer sums, so the result is the same on every
//      run and equals torch.nonzero's order bitwise;
//   4. write: the block re-reads its words from shared memory (from the
//      mask again only where the range exceeds shared memory) a round of
//      256 words at a time. A block scan gives each word its first rank;
//      the words' ranks and set bytes go to shared memory, and so do the
//      round's set indices, in slot order. Then the threads write the
//      round's ranks as consecutive 16-byte pieces (4-byte ones when the
//      mask's start is not 4-element aligned) and its slots [run, run +
//      round) below capacity as consecutive ints, so every warp's stores
//      are coalesced (a thread writing its own word's 16 ranks and its
//      scattered slots made each store instruction touch ~32 sectors).
//      Last, the block writes its share of the fill slots [min(total,
//      capacity), capacity).
//
// One launch instead of the earlier count / scan / scatter / fill, and the
// mask is read from device memory once. Four small blocks per SM rather
// than one of 1,024 threads: one block's barriers then overlap another's
// stores (one large block measured slower on the H100). The plan
// (words per block, blocks, stash bytes) comes from ops/compact.py's
// `compact_plan`; a block adds 16 KB of shared memory for a round's slots.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 4;  // ops/compact.py's BLOCKS_PER_SM
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;  // words each thread has in flight in pass 1
constexpr int kRoundElems = 16 * kThreads;  // mask elements of one round
constexpr unsigned kFull = 0xffffffffu;

// The mask as 16-byte words from its 16-B aligned start `base`: word w holds
// elements 16w - mis .. 16w - mis + 15.
struct Words {
  const uint8_t* base;
  long long n;
  int mis;

  __device__ __forceinline__ uint4 load(long long w) const {
    const long long e0 = 16 * w - mis;
    if (e0 >= 0 && e0 + 16 <= n) return __ldg(reinterpret_cast<const uint4*>(base) + w);
    unsigned v[4] = {0u, 0u, 0u, 0u};  // a word at either end, byte by byte
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const long long e = e0 + i;
      if (e >= 0 && e < n) v[i >> 2] |= (unsigned)base[16 * w + i] << (8 * (i & 3));
    }
    return make_uint4(v[0], v[1], v[2], v[3]);
  }
};

// Bit i of the result: byte i of the word is nonzero.
__device__ __forceinline__ unsigned set_bits(uint4 q) {
  const unsigned c[4] = {q.x, q.y, q.z, q.w};
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned m = __vcmpne4(c[k], 0u) & 0x01010101u;
    bits |= (((m >> 0) & 1u) | ((m >> 7) & 2u) | ((m >> 14) & 4u) | ((m >> 21) & 8u))
            << (4 * k);
  }
  return bits;
}

// Sums of a and of b over the block, to every thread. Every thread of the
// block calls it; two calls need a barrier between them.
__device__ __forceinline__ int2 block_sum2(int a, int b) {
  __shared__ int2 warp_s2[kWarps];
  a = __reduce_add_sync(kFull, a);
  b = __reduce_add_sync(kFull, b);
  if ((threadIdx.x & 31) == 0) warp_s2[threadIdx.x >> 5] = make_int2(a, b);
  __syncthreads();
  int2 r = make_int2(0, 0);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    r.x += warp_s2[w].x;
    r.y += warp_s2[w].y;
  }
  return r;
}

// Exclusive scan of v over the block; *sum gets the block's total. Every
// thread of the block calls it.
__device__ __forceinline__ int block_scan(int v, int* sum) {
  __shared__ int warp_s[kWarps + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += up;
  }
  if (lane == 31) warp_s[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int x = lane < kWarps ? warp_s[lane] : 0;
    int xi = x;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int up = __shfl_up_sync(kFull, xi, d);
      if (lane >= d) xi += up;
    }
    if (lane < kWarps) warp_s[lane] = xi - x;
    if (lane == kWarps - 1) warp_s[kWarps] = xi;
  }
  __syncthreads();
  const int excl = warp_s[warp] + inc - v;
  *sum = warp_s[kWarps];
  __syncthreads();  // the next call may overwrite warp_s
  return excl;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
compact_kernel(Words mask, long long words, long long wpb, int in_smem,
               int capacity, int fill, int* __restrict__ idx,
               int* __restrict__ rank, int* __restrict__ counts) {
  extern __shared__ uint4 dyn[];
  int* slots = reinterpret_cast<int*>(dyn);  // a round's idx, kRoundElems
  uint4* stash = dyn + kRoundElems / 4;      // the block's words
  __shared__ int word_rank[kThreads];        // a round's words: first rank
  __shared__ unsigned word_bits[kThreads];   //   and set bytes
  const int t = threadIdx.x;
  const long long w0 = (long long)blockIdx.x * wpb;
  const long long w1 = min(words, w0 + wpb);

  // 1. Load and count.
  int c = 0;
  for (long long w = w0 + t; w < w1; w += (long long)kThreads * kBatch) {
    uint4 q[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const long long wk = w + (long long)k * kThreads;
      q[k] = wk < w1 ? mask.load(wk) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const long long wk = w + (long long)k * kThreads;
      if (in_smem && wk < w1) stash[wk - w0] = q[k];
      c += __popc(set_bits(q[k]));
    }
  }
  const int block_count = block_sum2(c, 0).x;
  if (t == 0) counts[blockIdx.x] = block_count;

  // 2. Every block's count is written (this is also the barrier between the
  // two block_sum2 calls).
  cg::this_grid().sync();

  // 3. This block's offset and the total, summed in block order.
  int all = 0, mine = 0;
#pragma unroll 4
  for (int b = t; b < (int)gridDim.x; b += kThreads) {
    const int v = __ldcg(counts + b);
    all += v;
    mine += b < (int)blockIdx.x ? v : 0;
  }
  const int2 sums = block_sum2(all, mine);
  const int total = sums.x, before = sums.y;

  // 4. Write rank and idx, a round of kThreads words at a time; both go out
  // in consecutive 16- or 4-byte pieces per thread, so each warp's stores
  // are coalesced.
  const bool rank_vec = (mask.mis & 3) == 0;
  int run = before;
  for (long long wr = w0; wr < w1; wr += kThreads) {
    const long long w = wr + t;
    const int nw = (int)min((long long)kThreads, w1 - wr);
    const unsigned bits = w < w1 ? set_bits(in_smem ? stash[w - w0] : mask.load(w)) : 0u;
    int round;
    const int r = block_scan(__popc(bits), &round);  // ends with a barrier
    word_rank[t] = run + r;
    word_bits[t] = bits;
    int k = r;  // this word's set bytes' flat indices, in slot order
    for (unsigned b = bits; b != 0; b &= b - 1, ++k)
      slots[k] = (int)(16 * w - mask.mis + __ffs(b) - 1);
    __syncthreads();
    if (rank != nullptr) {
      // Thread q of the round takes elements 4q..4q+3 of its 16 * nw.
      for (int q = t; q < 4 * nw; q += kThreads) {
        const unsigned b = word_bits[q >> 2];
        const int r0 = word_rank[q >> 2], g = 4 * (q & 3);
        const long long e = 16 * (wr + (q >> 2)) - mask.mis + g;
        int rk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) rk[i] = r0 + __popc(b & ((1u << (g + i)) - 1u));
        if (rank_vec && e >= 0 && e + 4 <= mask.n) {
          *reinterpret_cast<int4*>(rank + e) = make_int4(rk[0], rk[1], rk[2], rk[3]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (e + i >= 0 && e + i < mask.n) rank[e + i] = rk[i];
        }
      }
    }
    // The round's set elements take slots [run, run + round): copy those
    // below capacity out.
    const int lim = min(round, capacity - min(run, capacity));
    for (int q = t; q < lim; q += kThreads) idx[run + q] = slots[q];
    run += round;
    // The next round's block_scan starts with a barrier before anything
    // in shared memory is overwritten.
  }

  // The fill slots, split over the blocks.
  for (long long k = (long long)min(total, capacity) + (long long)blockIdx.x * kThreads + t;
       k < capacity; k += (long long)gridDim.x * kThreads)
    idx[k] = fill;
}

// Per device, once: whether it takes cooperative launches (1 yes, -1 no, 0
// not asked yet) and the dynamic shared memory the kernel may use there.
constexpr int kMaxDevices = 64;
int coop_checked[kMaxDevices];
int smem_allowed[kMaxDevices];

}  // namespace

// mask: [n] u8 (nonzero = set), any alignment; idx: [capacity] i32; rank:
// [n] i32 16-B aligned, or null for no rank; counts: [counts_len >= blocks]
// i32 scratch. wpb, blocks, stash_bytes: the plan of ops/compact.py
// (`compact_plan`): words per block, blocks (at most one per SM), and the
// shared memory a block keeps its words in (16 * wpb, or 0 to re-read the
// mask). Returns a CUDA error code (0 = ok).
extern "C" int cs_compact(const void* mask, long long n, int capacity, int fill,
                          long long wpb, int blocks, int stash_bytes, void* idx,
                          void* rank, void* counts, int counts_len, void* stream) {
  const int mis = (int)((uintptr_t)mask & 15);
  long long words = n > 0 ? (mis + n + 15) / 16 : 0;
  if (n < 0 || n > 0x7fffffffLL || capacity < 0 || blocks < 1 ||
      blocks > counts_len || wpb < 0 ||
      (long long)blocks * wpb < words || stash_bytes < 0 ||
      (stash_bytes != 0 && stash_bytes < 16 * wpb))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)rank & 15) return (int)cudaErrorMisalignedAddress;
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
  const int smem = (int)(kRoundElems * sizeof(int)) + stash_bytes;
  if (smem > smem_allowed[dev]) {
    e = cudaFuncSetAttribute(compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed[dev] = smem;
  }
  Words m{(const uint8_t*)mask - mis, n, mis};
  int in_smem = stash_bytes != 0;
  int* idx_p = (int*)idx;
  int* rank_p = (int*)rank;
  int* counts_p = (int*)counts;
  void* args[] = {&m, &words, &wpb, &in_smem, &capacity, &fill,
                  &idx_p, &rank_p, &counts_p};
  e = cudaLaunchCooperativeKernel((const void*)compact_kernel, dim3(blocks),
                                  dim3(kThreads), args, (size_t)smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
