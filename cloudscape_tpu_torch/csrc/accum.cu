// K1: fused phase-3 accumulation of the dense cloud march, for Hopper (sm_90a).
//
// Replaces the TPU kernel `accumulate_pallas` (`_kernel`) in
// cloudscape_tpu/ops/accum_pallas.py. Per ray, over its steps:
//
//   dt = exp(A), T = exclusive cumprod(dt)
//   beers = exp(cd3), powder = 1 - exp(2*cd3), occ = (A < 0)
//   L_c = sum T*(1-dt)*occ*(ambient_c(hf) + 2*beers*powder*phase*sun_c)
//   alpha = clip(1 - prod(dt))
//
// with ambient_c(hf) = ground_c + (ambient_c - ground_c)*smoothstep(hf).
// Rays whose `above` flag is 0 (below the horizon, redirected straight up by
// the ray setup, so their A need not be 0) write exact zeros.
//
// Bound: memory. Three [n, steps] f32 planes are read once and 16 B per ray
// written: at the serving tile (9,216 rays x 128 steps) that is ~14 MB, a
// few microseconds at 3.35 TB/s; the arithmetic is ~30 flops per sample.
// The TPU kernel also read a fourth plane, phase broadcast to the step lanes
// for its (8, 128) layout; here phase is one float per ray.
//
// Design: one warp per ray. Lane k reads step s0 + k of each 32-step chunk,
// so a warp's loads of a 128-step row are four coalesced 128-byte lines per
// plane. The transmittance prefix is a multiplicative warp scan
// (__shfl_up_sync) whose running product carries from chunk to chunk, so any
// step count works (padding lanes see A = 0: dt = 1, occ = 0). The three
// radiance sums finish with __shfl_xor_sync butterflies. Nothing goes
// through shared memory; 8 warps per block keep enough rays in flight.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
accumulate_kernel(const float* __restrict__ A, const float* __restrict__ cd3,
                  const float* __restrict__ hf,
                  const float* __restrict__ phase,
                  const uint8_t* __restrict__ above,
                  const float* __restrict__ scal, float* __restrict__ out,
                  int n, int steps) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (ray >= n) return;  // warp-uniform: the whole warp leaves together
  float* o = out + (size_t)ray * 4;
  if (!above[ray]) {
    if (lane < 4) o[lane] = 0.0f;
    return;
  }
  const float sun0 = scal[0], sun1 = scal[1], sun2 = scal[2];
  const float amb0 = scal[3], amb1 = scal[4], amb2 = scal[5];
  const float gnd0 = scal[6], gnd1 = scal[7], gnd2 = scal[8];
  const float ph = phase[ray];
  const size_t row = (size_t)ray * steps;

  float carry = 1.0f;  // product of dt over all earlier chunks
  float l0 = 0.0f, l1 = 0.0f, l2 = 0.0f;
  for (int s0 = 0; s0 < steps; s0 += 32) {
    const int s = s0 + lane;
    const bool valid = s < steps;
    const float a = valid ? A[row + s] : 0.0f;
    const float c3 = valid ? cd3[row + s] : 0.0f;
    const float h = valid ? hf[row + s] : 0.0f;

    const float dt = expf(a);
    float inc = dt;  // inclusive product over this chunk's lanes
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const float up = __shfl_up_sync(kFull, inc, k);
      if (lane >= k) inc *= up;
    }
    float excl = __shfl_up_sync(kFull, inc, 1);
    if (lane == 0) excl = 1.0f;
    const float t_prefix = carry * excl;

    const float occ = a < 0.0f ? 1.0f : 0.0f;
    const float beers = expf(c3);
    const float powder = 1.0f - expf(2.0f * c3);
    const float bt_phase = 2.0f * beers * powder * occ * ph;
    const float x = fminf(fmaxf(h, 0.0f), 1.0f);
    const float sm = x * x * (3.0f - 2.0f * x);
    const float shared = t_prefix * (1.0f - dt) * occ;
    l0 += shared * ((gnd0 + (amb0 - gnd0) * sm) + bt_phase * sun0);
    l1 += shared * ((gnd1 + (amb1 - gnd1) * sm) + bt_phase * sun1);
    l2 += shared * ((gnd2 + (amb2 - gnd2) * sm) + bt_phase * sun2);
    carry *= __shfl_sync(kFull, inc, 31);
  }
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) {
    l0 += __shfl_xor_sync(kFull, l0, k);
    l1 += __shfl_xor_sync(kFull, l1, k);
    l2 += __shfl_xor_sync(kFull, l2, k);
  }
  if (lane == 0) {
    o[0] = l0;
    o[1] = l1;
    o[2] = l2;
    o[3] = fminf(fmaxf(1.0f - carry, 0.0f), 1.0f);
  }
}

}  // namespace

// A, cd3, hf: [n, steps] f32; phase: [n] f32; above: [n] u8; scal: [>= 9] f32
// (sun rgb, ambient rgb, ground rgb); out: [n, 4] f32. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int cs_accumulate(const void* A, const void* cd3, const void* hf,
                             const void* phase, const void* above,
                             const void* scal, void* out, int n, int steps,
                             void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  accumulate_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const float*)A, (const float*)cd3, (const float*)hf,
      (const float*)phase, (const uint8_t*)above, (const float*)scal,
      (float*)out, n, steps);
  return (int)cudaGetLastError();
}
