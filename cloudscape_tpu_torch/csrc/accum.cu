// K1: fused phase-3 accumulation of the dense cloud march, for Hopper (sm_90a).
//
// Replaces the TPU kernel `accumulate_pallas` (`_kernel`) in
// cloudscape_tpu/ops/accum_pallas.py. Per ray, over its steps:
//
//   dt = exp(A), T = exclusive cumprod(dt)
//   beers = exp(cd3), powder = 1 - exp(2*cd3) = 1 - beers^2, occ = (A < 0)
//   L_c = sum T*(1-dt)*occ*(ambient_c(hf) + 2*beers*powder*phase*sun_c)
//   alpha = clip(1 - prod(dt))
//
// with ambient_c(hf) = ground_c + (ambient_c - ground_c)*smoothstep(hf).
// Rays whose `above` flag is 0 (below the horizon, redirected straight up by
// the ray setup, so their A need not be 0) write exact zeros.
//
// Bound: memory. Three [n, steps] f32 planes are read once and 16 B per ray
// written: at the serving tile (9,216 rays x 128 steps) that is 14.3 MB,
// 4.3 us at 3.35 TB/s; the arithmetic is ~30 flops per sample. The TPU
// kernel also read a fourth plane, phase broadcast to the step lanes for its
// (8, 128) layout; here phase is one float per ray.
//
// Design: a ray's steps are cut into windows of 4*width steps, width lanes
// (a power of two, at most 32) per ray: lane j of a ray's group takes steps
// 4j..4j+3 of the window with one 16-byte load per plane, so a warp's 3 x
// 512 B of a 128-step window are all in flight before any math. The lane
// multiplies its 4 dt serially, one __shfl_up_sync scan over the group
// (width = the group) gives each lane the product of the lanes before it,
// and the lane walks its 4 steps with that prefix. A row of 128 steps is one
// window per warp; 64 steps put two rays in one warp, 16 steps eight, so no
// lane idles at config 4's 64 steps; longer rows take several windows with
// the product carried between them. Rows whose step count is no multiple of
// 4, or planes not 16-B aligned, take the same kernel with scalar loads
// (kVec false); past the row's end a lane reads A = 0 (dt = 1, occ = 0),
// which adds nothing. The three radiance sums finish with __shfl_xor_sync
// butterflies inside the group, and the group's first lane stores the ray's
// 16 B at once.
//
// The planes' loads are issued before the ray's `above` flag arrives (it
// only picks the output), so a warp waits on one memory latency, not two,
// and the exponentials are __expf (ex2.approx; ~5e-7 from the plain
// version's torch.exp at the serving tile, gate 2e-5): the kernel is about
// half instruction issue, and each window's ~40 instructions a sample run
// while other warps' loads are in flight. A persistent grid that prefetched
// each warp's next window measured slower on the H100 at both main-path
// shapes (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// Steps s..s+3 of one plane's row into v; 0 for a ray past n or a step past
// the row's end.
template <bool kVec>
__device__ __forceinline__ void load4(const float* __restrict__ p, size_t row,
                                      int s, int steps, bool in, float v[4]) {
  if (kVec) {
    // steps % 4 == 0, so s < steps means all four steps are in the row.
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (in && s < steps) x = __ldg(reinterpret_cast<const float4*>(p + row + s));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = (in && s + k < steps) ? __ldg(p + row + s + k) : 0.0f;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
accumulate_kernel(const float* __restrict__ A, const float* __restrict__ cd3,
                  const float* __restrict__ hf,
                  const float* __restrict__ phase,
                  const uint8_t* __restrict__ above,
                  const float* __restrict__ scal, float4* __restrict__ out,
                  int n, int steps, int width) {
  const int lane = threadIdx.x & 31;
  const int j = lane & (width - 1);  // this lane's place in its ray's group
  const long long warp = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const long long ray = warp * (32 / width) + lane / width;
  const bool in = ray < n;
  const size_t row = (size_t)ray * steps;
  // The planes' loads do not wait for `above`: it only picks the output.
  float a[4], c3[4], h[4];
  load4<kVec>(A, row, 4 * j, steps, in, a);
  load4<kVec>(cd3, row, 4 * j, steps, in, c3);
  load4<kVec>(hf, row, 4 * j, steps, in, h);
  const float ph = in ? __ldg(phase + ray) : 0.0f;
  const bool live = in && __ldg(above + ray) != 0;
  const float sun0 = __ldg(scal + 0), sun1 = __ldg(scal + 1), sun2 = __ldg(scal + 2);
  const float amb0 = __ldg(scal + 3), amb1 = __ldg(scal + 4), amb2 = __ldg(scal + 5);
  const float gnd0 = __ldg(scal + 6), gnd1 = __ldg(scal + 7), gnd2 = __ldg(scal + 8);

  // Every lane of the warp runs the same windows (steps and width are the
  // launch's), so the full-mask shuffles below are legal.
  float carry = 1.0f;  // product of dt over the earlier windows
  float l0 = 0.0f, l1 = 0.0f, l2 = 0.0f;
  for (int s0 = 0; s0 < steps; s0 += 4 * width) {
    if (s0 > 0) {  // a row longer than one window: its next window
      load4<kVec>(A, row, s0 + 4 * j, steps, in, a);
      load4<kVec>(cd3, row, s0 + 4 * j, steps, in, c3);
      load4<kVec>(hf, row, s0 + 4 * j, steps, in, h);
    }
    float dt[4], inc = 1.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      dt[k] = __expf(a[k]);
      inc *= dt[k];
    }
    // Inclusive product over the group's lanes up to this one.
    for (int d = 1; d < width; d <<= 1) {
      const float up = __shfl_up_sync(kFull, inc, d, width);
      if (j >= d) inc *= up;
    }
    float t = __shfl_up_sync(kFull, inc, 1, width);
    t = carry * (j == 0 ? 1.0f : t);  // transmittance before step s0 + 4j

#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float occ = a[k] < 0.0f ? 1.0f : 0.0f;
      const float beers = __expf(c3[k]);
      const float powder = 1.0f - beers * beers;  // 1 - exp(2*cd3)
      const float bt_phase = 2.0f * beers * powder * occ * ph;
      const float x = fminf(fmaxf(h[k], 0.0f), 1.0f);
      const float sm = x * x * (3.0f - 2.0f * x);
      const float shared = t * (1.0f - dt[k]) * occ;
      l0 += shared * ((gnd0 + (amb0 - gnd0) * sm) + bt_phase * sun0);
      l1 += shared * ((gnd1 + (amb1 - gnd1) * sm) + bt_phase * sun1);
      l2 += shared * ((gnd2 + (amb2 - gnd2) * sm) + bt_phase * sun2);
      t *= dt[k];
    }
    carry *= __shfl_sync(kFull, inc, width - 1, width);
  }
  for (int d = width >> 1; d > 0; d >>= 1) {
    l0 += __shfl_xor_sync(kFull, l0, d, width);
    l1 += __shfl_xor_sync(kFull, l1, d, width);
    l2 += __shfl_xor_sync(kFull, l2, d, width);
  }
  if (in && j == 0)
    out[ray] = live ? make_float4(l0, l1, l2, fminf(fmaxf(1.0f - carry, 0.0f), 1.0f))
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

}  // namespace

// A, cd3, hf: [n, steps] f32; phase: [n] f32; above: [n] u8; scal: [>= 9] f32
// (sun rgb, ambient rgb, ground rgb); out: [n, 4] f32, 16-B aligned. width:
// lanes per ray, a power of two <= 32; vec: 16-byte loads (steps % 4 == 0
// and the three planes 16-B aligned). Returns the CUDA error code of the
// launch (0 on success).
extern "C" int cs_accumulate(const void* A, const void* cd3, const void* hf,
                             const void* phase, const void* above,
                             const void* scal, void* out, int n, int steps,
                             int width, int vec, void* stream) {
  if (n <= 0) return 0;
  if (steps < 0 || width < 1 || width > 32 || (width & (width - 1)))
    return (int)cudaErrorInvalidValue;
  const uintptr_t planes = (uintptr_t)A | (uintptr_t)cd3 | (uintptr_t)hf;
  if (((uintptr_t)out & 15) || (vec && ((steps & 3) || (planes & 15))))
    return (int)cudaErrorMisalignedAddress;
  const long long rays_per_block = (long long)kWarpsPerBlock * (32 / width);
  const unsigned blocks = (unsigned)((n + rays_per_block - 1) / rays_per_block);
  auto kernel = vec ? accumulate_kernel<true> : accumulate_kernel<false>;
  kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const float*)A, (const float*)cd3, (const float*)hf,
      (const float*)phase, (const uint8_t*)above, (const float*)scal,
      (float4*)out, n, steps, width);
  return (int)cudaGetLastError();
}
