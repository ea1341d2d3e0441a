// K4–K6: procedural noise volumes, for Hopper (sm_90a).
//
// Replaces the TPU kernels of cloudscape_tpu/ops/noise_pallas.py:
//
//   K4 generate_base_noise_pallas (_base_noise_kernel): [n, n, n, 4] f32,
//      R = Perlin FBM (period 4, 7 octaves) remapped by a low Worley FBM,
//      G/B/A = Worley FBM at periods 8/16/32;
//   K5 generate_detail_noise_pallas (_detail_noise_kernel): [n, n, n, 3]
//      f32, Worley at periods 2/4/8;
//   K6 generate_weather_pallas (_weather_kernel): [n, n, 3] f32 at z = 0.37,
//      Perlin FBM cloud type, spare field and smoothstepped coverage.
//
// The math is ops/noise.py's (same PCG3D lattice hash, same wrapping, same
// octave weights and seeds), which is the plain version the wrappers in
// ops/noise_kernel.py hold these kernels against.
//
// Bound: integer ALU. A base texel evaluates ~380 PCG3D hashes (7 octaves
// x 8 Perlin corners + 4 Worley FBMs x 3 octaves x 27 neighbours), each
// ~9 32-bit multiplies; nothing is read and 16 bytes are written per
// texel, so memory is idle.
//
// Design: one thread per output texel, all channels of the texel in that
// thread, written channel-interleaved in the [D, H, W, C] layout the pack
// takes (the TPU kernel's per-channel planes and stack are not needed).
// Hashing is native uint32 arithmetic. The lattice coordinates are wrapped
// (floor modulo, as jnp.remainder) once per axis for each octave, outside
// the corner/neighbour loops, so the 27-neighbour Worley loop does no
// integer division. Texel centres, divisions and square roots are
// IEEE-rounded (the build has no fast-math): a floor of a coordinate that
// rounds differently would pick another lattice cell.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void pcg3d(uint32_t& x, uint32_t& y, uint32_t& z) {
  x = x * 1664525u + 1013904223u;
  y = y * 1664525u + 1013904223u;
  z = z * 1664525u + 1013904223u;
  x += y * z;
  y += z * x;
  z += x * y;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  x += y * z;
  y += z * x;
  z += x * y;
}

// uint32 hash → [0, 1): the top 24 bits, exact in f32.
__device__ __forceinline__ float to_unit(uint32_t h) {
  return (float)(h >> 8) * (1.0f / 16777216.0f);
}

// Wrapped lattice coordinate plus the seed mix: floor modulo, so the
// neighbour at -1 of the first cell hashes as period - 1.
__device__ __forceinline__ uint32_t lattice(int i, int period, uint32_t mix) {
  int m = i % period;
  if (m < 0) m += period;
  return (uint32_t)m + mix;
}

__device__ __forceinline__ float fade(float t) {
  return t * t * t * (t * (t * 6.0f - 15.0f) + 10.0f);
}

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

// Periodic Perlin gradient noise at p (lattice units).
__device__ float perlin3(float px, float py, float pz, int period,
                         uint32_t seed) {
  const float flx = floorf(px), fly = floorf(py), flz = floorf(pz);
  const float fx = px - flx, fy = py - fly, fz = pz - flz;
  const int ix = (int)flx, iy = (int)fly, iz = (int)flz;
  const float ux = fade(fx), uy = fade(fy), uz = fade(fz);
  const uint32_t mix = seed * 0x9E3779B9u;
  const uint32_t wx[2] = {lattice(ix, period, mix), lattice(ix + 1, period, mix)};
  const uint32_t wy[2] = {lattice(iy, period, mix), lattice(iy + 1, period, mix)};
  const uint32_t wz[2] = {lattice(iz, period, mix), lattice(iz + 1, period, mix)};
  float total = 0.0f;
#pragma unroll
  for (int cz = 0; cz < 2; ++cz)
#pragma unroll
    for (int cy = 0; cy < 2; ++cy)
#pragma unroll
      for (int cx = 0; cx < 2; ++cx) {
        uint32_t hx = wx[cx], hy = wy[cy], hz = wz[cz];
        pcg3d(hx, hy, hz);
        float gx = to_unit(hx) * 2.0f - 1.0f;
        float gy = to_unit(hy) * 2.0f - 1.0f;
        float gz = to_unit(hz) * 2.0f - 1.0f;
        const float norm = fmaxf(sqrtf(gx * gx + gy * gy + gz * gz), 1e-5f);
        gx = gx / norm;
        gy = gy / norm;
        gz = gz / norm;
        const float v = gx * (fx - (float)cx) + gy * (fy - (float)cy) +
                        gz * (fz - (float)cz);
        const float w = (cx ? ux : 1.0f - ux) * (cy ? uy : 1.0f - uy) *
                        (cz ? uz : 1.0f - uz);
        total += v * w;
      }
  return total;
}

// Perlin FBM over [0,1)³ coordinates; octave o has period base·2^o and
// seed seed·31 + o (uint32 wrap-around, as the plain version's mask).
__device__ float perlin_fbm3(float x, float y, float z, int base_period,
                             int octaves, uint32_t seed) {
  float acc = 0.0f, amp = 1.0f, norm = 0.0f;
  int freq = base_period;
  for (int o = 0; o < octaves; ++o) {
    const float f = (float)freq;
    acc += perlin3(x * f, y * f, z * f, freq, seed * 31u + (uint32_t)o) * amp;
    norm += amp;
    amp *= 0.5f;
    freq *= 2;
  }
  return acc / norm;
}

// Periodic inverted Worley over [0,1)³ coordinates: 1 at feature points.
__device__ float worley3(float x, float y, float z, int period, uint32_t seed) {
  const float p = (float)period;
  const float qx = x * p, qy = y * p, qz = z * p;
  const float flx = floorf(qx), fly = floorf(qy), flz = floorf(qz);
  const float fx = qx - flx, fy = qy - fly, fz = qz - flz;
  const int ix = (int)flx, iy = (int)fly, iz = (int)flz;
  const uint32_t mix = seed * 0x9E3779B9u;
  uint32_t wx[3], wy[3], wz[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    wx[k] = lattice(ix + k - 1, period, mix);
    wy[k] = lattice(iy + k - 1, period, mix);
    wz[k] = lattice(iz + k - 1, period, mix);
  }
  float min_d2 = INFINITY;
#pragma unroll
  for (int cz = 0; cz < 3; ++cz)
#pragma unroll
    for (int cy = 0; cy < 3; ++cy)
#pragma unroll
      for (int cx = 0; cx < 3; ++cx) {
        uint32_t hx = wx[cx], hy = wy[cy], hz = wz[cz];
        pcg3d(hx, hy, hz);
        const float dx = to_unit(hx) + (float)(cx - 1) - fx;
        const float dy = to_unit(hy) + (float)(cy - 1) - fy;
        const float dz = to_unit(hz) + (float)(cz - 1) - fz;
        min_d2 = fminf(min_d2, dx * dx + dy * dy + dz * dz);
      }
  return 1.0f - fminf(sqrtf(min_d2), 1.0f);
}

// Three-octave Worley FBM with the Schneider weights.
__device__ float worley_fbm3(float x, float y, float z, int base_period,
                             uint32_t seed) {
  return worley3(x, y, z, base_period, seed) * 0.625f +
         worley3(x, y, z, base_period * 2, seed + 7u) * 0.25f +
         worley3(x, y, z, base_period * 4, seed + 13u) * 0.125f;
}

// Texel centre of index i on an n-texel axis, in [0, 1).
__device__ __forceinline__ float centre(long long i, int n) {
  return ((float)i + 0.5f) / (float)n;
}

__global__ void __launch_bounds__(kThreads)
base_kernel(float4* __restrict__ out, int n, uint32_t seed) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long plane = (long long)n * n;
  if (i >= plane * n) return;
  const float x = centre(i % n, n);
  const float y = centre((i / n) % n, n);
  const float z = centre(i / plane, n);
  // remap(v, lo, hi, 0, 1) = (v - lo) / (hi - lo), the spans rounded from
  // the same double constants as the plain version's.
  float pfbm = perlin_fbm3(x, y, z, 4, 7, seed) * 0.5f + 0.5f;
  pfbm = clamp01((pfbm - 0.32f) / (float)(0.68 - 0.32));
  const float wlow = worley_fbm3(x, y, z, 4, seed + 101u);
  const float lo = wlow - 1.0f;
  const float raw = (pfbm - lo) / (1.0f - lo);
  float4 v;
  v.x = clamp01((raw - 0.45f) / (float)(0.95 - 0.45));
  v.y = worley_fbm3(x, y, z, 8, seed + 211u);
  v.z = worley_fbm3(x, y, z, 16, seed + 307u);
  v.w = worley_fbm3(x, y, z, 32, seed + 401u);
  out[i] = v;
}

__global__ void __launch_bounds__(kThreads)
detail_kernel(float* __restrict__ out, int n, uint32_t seed) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long plane = (long long)n * n;
  if (i >= plane * n) return;
  const float x = centre(i % n, n);
  const float y = centre((i / n) % n, n);
  const float z = centre(i / plane, n);
  out[3 * i + 0] = worley3(x, y, z, 2, seed + 17u);
  out[3 * i + 1] = worley3(x, y, z, 4, seed + 23u);
  out[3 * i + 2] = worley3(x, y, z, 8, seed + 29u);
}

__global__ void __launch_bounds__(kThreads)
weather_kernel(float* __restrict__ out, int n, uint32_t seed) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)n * n) return;
  const float x = centre(i % n, n);
  const float y = centre(i / n, n);
  const float z = 0.37f;
  const float cloud_type = perlin_fbm3(x, y, z, 3, 4, seed + 5u) * 0.5f + 0.5f;
  const float spare = perlin_fbm3(x, y, z, 6, 4, seed + 11u) * 0.5f + 0.5f;
  const float cov = perlin_fbm3(x, y, z, 4, 5, seed + 3u) * 0.5f + 0.5f;
  const float t = clamp01((cov - 0.35f) / (float)(0.85 - 0.35));
  out[3 * i + 0] = cloud_type;
  out[3 * i + 1] = spare;
  out[3 * i + 2] = t * t * (3.0f - 2.0f * t);
}

// Blocks for `texels` threads, or 0 when the grid would not fit.
unsigned blocks_for(long long texels) {
  const long long b = (texels + kThreads - 1) / kThreads;
  return b > 0x7fffffffLL ? 0u : (unsigned)b;
}

}  // namespace

// out: [n, n, n, 4] f32, 16-byte aligned. Returns a CUDA error code.
extern "C" int cs_noise_base(void* out, int n, unsigned seed, void* stream) {
  const unsigned b = n > 0 ? blocks_for((long long)n * n * n) : 0u;
  if (b == 0) return (int)cudaErrorInvalidValue;
  base_kernel<<<b, kThreads, 0, (cudaStream_t)stream>>>((float4*)out, n, seed);
  return (int)cudaGetLastError();
}

// out: [n, n, n, 3] f32. Returns a CUDA error code.
extern "C" int cs_noise_detail(void* out, int n, unsigned seed, void* stream) {
  const unsigned b = n > 0 ? blocks_for((long long)n * n * n) : 0u;
  if (b == 0) return (int)cudaErrorInvalidValue;
  detail_kernel<<<b, kThreads, 0, (cudaStream_t)stream>>>((float*)out, n, seed);
  return (int)cudaGetLastError();
}

// out: [n, n, 3] f32. Returns a CUDA error code.
extern "C" int cs_noise_weather(void* out, int n, unsigned seed, void* stream) {
  const unsigned b = n > 0 ? blocks_for((long long)n * n) : 0u;
  if (b == 0) return (int)cudaErrorInvalidValue;
  weather_kernel<<<b, kThreads, 0, (cudaStream_t)stream>>>((float*)out, n, seed);
  return (int)cudaGetLastError();
}
