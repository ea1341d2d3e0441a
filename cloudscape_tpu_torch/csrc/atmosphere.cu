// K10–K11: the atmosphere LUTs, for Hopper (sm_90a).
//
// The port's own kernels for code the JAX package leaves to XLA (it jits
// the eager math of cloudscape_tpu/models/atmosphere.py; no pallas_call):
//
//   K10 sky_kernel (sky_lut_rows, cloudscape_tpu/models/atmosphere.py:208):
//       a row band [row0, row0 + rows) of the [height, width, 4] sky-view
//       LUT: per texel the 30-step single + pseudo-multiple in-scattering
//       march against the transmittance LUT, spectral -> linear sRGB,
//       alpha 1;
//   K11 transmittance_kernel (transmittance_lut, atmosphere.py:122): the
//       [height, width, 4] spectral sun transmittance, a 40-step
//       optical-depth march per texel.
//
// The math is models/atmosphere.py's plain versions (`_sky_lut_rows_plain`,
// `_transmittance_lut_plain`), which the wrappers in ops/atmosphere_kernel.py
// hold these kernels against, op for op in the same order: every constant
// is the float32 that eager torch rounds it to; a division by a Python
// scalar is, as torch's CUDA kernels compute it, a product with the
// float32 reciprocal; `c / x` with c a Python scalar is torch's
// reciprocal(x) * c. This source is built with -fmad=false (ops/_cuda.py):
// eager torch rounds every product and sum on its own, and a contracted
// a*b + c would move a grazing ray's ray-sphere discriminant, and with it
// the ground hit, from the plain version's. So built, both kernels gave
// their plain versions' bits on an H100 (chip_smoke.py phase 4c).
//
// Bound: float32 ALU and the special-function unit. Per sky texel 30 steps
// of ~13 expf/logf/powf, 3 IEEE divisions, a sqrtf and four bilinear
// fetches from the 256 KB transmittance LUT (through __ldg, L1/L2-resident
// after the first texels); 16 bytes written a texel, so memory is idle.
//
// Design: one thread per texel, every step of its march in registers; no
// thread shares work with another, so a texel's bits do not depend on its
// position in the launch, and a band equals the same rows of a whole call
// bitwise (the engine's prebaked sky equals its synchronous one). At the
// engine's bands (a few rows of 200 texels) a launch is a few blocks and
// its time is the march's latency, not its throughput.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTransmittanceSteps = 40;  // transmittance-lut.glsl:45
constexpr int kInScatteringSteps = 30;   // sky-lut.glsl:53

constexpr float kEarthRadius = 6371.0f;
constexpr float kEarthRadius2 = 40589640.0f;       // f32(6371.0 ** 2)
constexpr float kAtmosphereRadius2 = 41873840.0f;  // f32(6471.0 * 6471.0)
constexpr float kEyeDistance = 6371.5f;
constexpr float kInvThickness = 0.01f;  // 1 / f32(100.0), as torch divides
constexpr float kTwoPi = 6.2831855f;
constexpr float kHalfPi = 1.5707964f;
constexpr float kRayleighPhase = 0.059683103f;  // (3 / 16) / pi
constexpr float kAerosolDen0 = 1.64f;           // 1 + g^2
constexpr float kAerosolDen1 = 1.6f;            // 2 g
constexpr float kAerosolPhase = 0.02864789f;    // (1 / 4pi) (1 - g^2)
constexpr float kIsotropic = 0.07957747f;       // 1 / 4pi
constexpr float kAlbedoOverPi = 0.09549297f;    // 0.3 / pi

__device__ __constant__ float kSunIrradiance[4] = {1.679f, 1.828f, 1.986f, 1.307f};
__device__ __constant__ float kMolecularScattering[4] = {0.006605f, 0.01067f,
                                                         0.01842f, 0.03156f};
// f32(f32(f32(ozone cross section) * 1e-4) * 350 Dobson)
__device__ __constant__ float kOzoneAbsorption[4] = {1.2152e-22f, 1.3699e-22f,
                                                     4.7214998e-23f, 3.8605e-24f};
__device__ __constant__ float kAerosolAbsorption[4] = {2.8722e-24f, 4.6168e-24f,
                                                       7.9706e-24f, 1.3578e-23f};
__device__ __constant__ float kAerosolScattering[4] = {1.5908e-22f, 1.7711e-22f,
                                                       2.0942e-22f, 2.4033e-22f};
// f32(f32(ms spectrum) * 0.02)
__device__ __constant__ float kMsSpectrum[4] = {0.00434f, 0.0069399998f,
                                                0.011879999f, 0.02f};
// Spectral -> linear sRGB, rgb = M @ L (sky-lut.glsl:207-217).
__device__ __constant__ float kSpectralToSrgb[3][4] = {
    {137.6724f, 32.549095f, -38.914284f, 8.5728445f},
    {-8.632905f, 91.29801f, 34.316654f, -11.103385f},
    {-1.7181567f, -12.005406f, 29.890448f, 117.47585f}};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// First hit of the sphere of squared radius r2 (r2 as the plain version
// rounds radius * radius), or -1 (sky-lut.glsl:100-109).
__device__ __forceinline__ float ray_sphere(V3 ro, V3 rd, float r2) {
  const float b = dot3(ro, rd);
  const float c = dot3(ro, ro) - r2;
  const float d = b * b - c;
  const float sqrt_d = sqrtf(fmaxf(d, 0.0f));
  const float hit = d > b * b ? -b + sqrt_d : -b - sqrt_d;
  const bool miss = (c > 0.0f && b > 0.0f) || d < 0.0f;
  return miss ? -1.0f : hit;
}

// The aerosol and molecular scattering and the extinction at altitude h
// (sky-lut.glsl:188-202).
__device__ __forceinline__ void coefficients(float h, float aer_scat[4],
                                             float mol_scat[4], float ext[4]) {
  h = fmaxf(h, 0.0f);
  const float aer_density =
      1.3681e+20f * (expf(-h * 1.369863f) + 1.4618815e-14f);
  const float hh = h + 1e-4f;
  const float t = logf(hh) - 3.22261f;
  const float ozone_density = 3.785474e+20f * (1.0f / hh) * expf(-t * t * 5.5555553f);
  const float mol = expf(powf(h, 1.1636424f) * -0.07771971f);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float aa = kAerosolAbsorption[c] * aer_density;
    aer_scat[c] = kAerosolScattering[c] * aer_density;
    mol_scat[c] = kMolecularScattering[c] * mol;
    ext[c] = aa + aer_scat[c] + kOzoneAbsorption[c] * ozone_density + mol_scat[c];
  }
}

// Clamp-to-edge bilinear fetch of the [lut_h, lut_w, 4] transmittance LUT
// at (cos_theta, normalized altitude), as ops/sampling.py's sample2d.
__device__ __forceinline__ float4 transmittance_at(const float4* __restrict__ lut,
                                                   int lut_h, int lut_w,
                                                   float cos_theta, float alt) {
  const float u = fminf(fmaxf(cos_theta * 0.5f + 0.5f, 0.0f), 1.0f);
  const float v = fminf(fmaxf(alt, 0.0f), 1.0f);
  const float cx = u * (float)lut_w - 0.5f;
  const float cy = v * (float)lut_h - 0.5f;
  const float x0f = floorf(cx), y0f = floorf(cy);
  const float fx = cx - x0f, fy = cy - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int x1 = min(max(x0 + 1, 0), lut_w - 1), y1 = min(max(y0 + 1, 0), lut_h - 1);
  const int xa = min(max(x0, 0), lut_w - 1), ya = min(max(y0, 0), lut_h - 1);
  const float4 c00 = __ldg(lut + ya * lut_w + xa);
  const float4 c10 = __ldg(lut + ya * lut_w + x1);
  const float4 c01 = __ldg(lut + y1 * lut_w + xa);
  const float4 c11 = __ldg(lut + y1 * lut_w + x1);
  float4 top, bot, out;
  top.x = c00.x + (c10.x - c00.x) * fx;
  top.y = c00.y + (c10.y - c00.y) * fx;
  top.z = c00.z + (c10.z - c00.z) * fx;
  top.w = c00.w + (c10.w - c00.w) * fx;
  bot.x = c01.x + (c11.x - c01.x) * fx;
  bot.y = c01.y + (c11.y - c01.y) * fx;
  bot.z = c01.z + (c11.z - c01.z) * fx;
  bot.w = c01.w + (c11.w - c01.w) * fx;
  out.x = top.x + (bot.x - top.x) * fy;
  out.y = top.y + (bot.y - top.y) * fy;
  out.z = top.z + (bot.z - top.z) * fy;
  out.w = top.w + (bot.w - top.w) * fy;
  return out;
}

__device__ __forceinline__ void as_array(float4 v, float a[4]) {
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

// Ground bounce + fitted Earth term (sky-lut.glsl:144-164).
__device__ __forceinline__ void multiple_scattering(const float4* __restrict__ lut,
                                                    int lut_h, int lut_w,
                                                    float cos_theta, float alt,
                                                    float d, float out[4]) {
  const float omega =
      kTwoPi * (1.0f - sqrtf(fmaxf(d * d - kEarthRadius2, 0.0f)) / d);
  float to_ground[4], ground0[4], ground_alt[4];
  as_array(transmittance_at(lut, lut_h, lut_w, cos_theta, 0.0f), to_ground);
  as_array(transmittance_at(lut, lut_h, lut_w, 1.0f, 0.0f), ground0);
  as_array(transmittance_at(lut, lut_h, lut_w, 1.0f, alt), ground_alt);
  const float ground = kIsotropic * omega * kAlbedoOverPi;
  const float fit = 1.0f / (1.0f + 5.0f * expf(-17.92f * cos_theta));
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float l_ground = ground * to_ground[c] * (ground0[c] / ground_alt[c]) * cos_theta;
    out[c] = kMsSpectrum[c] * fit + l_ground;
  }
}

// The sky-view texel (x, row) of a [height, width] LUT (sky-lut.glsl:278-315).
__device__ __forceinline__ float4 sky_texel(const float4* __restrict__ lut, int lut_h,
                                            int lut_w, V3 sun_dir, int x, int row,
                                            int width, int height) {
  const float u = (float)x * (1.0f / (float)width);
  const float v = (float)row * (1.0f / (float)height);
  const float azimuth = kTwoPi * u;
  const float lv = v * 2.0f - 1.0f;
  const float sign = (float)((0.0f < lv) - (lv < 0.0f));
  const float elev = lv * lv * sign * kHalfPi;
  const float cos_elev = cosf(elev);
  const V3 rd = {cos_elev * cosf(azimuth), cos_elev * sinf(azimuth), sinf(elev)};
  const V3 ro = {0.0f, 0.0f, kEyeDistance};

  const float atmos_dist = ray_sphere(ro, rd, kAtmosphereRadius2);
  const float ground_dist = ray_sphere(ro, rd, kEarthRadius2);
  const float t_d = ground_dist < 0.0f ? atmos_dist : ground_dist;

  const float cos_theta = dot3(V3{-rd.x, -rd.y, -rd.z}, sun_dir);
  const float molecular_phase = kRayleighPhase * (1.0f + cos_theta * cos_theta);
  const float den = kAerosolDen0 + kAerosolDen1 * cos_theta;
  const float aerosol_phase = (1.0f / (den * sqrtf(den))) * kAerosolPhase;

  const float dt = t_d * (1.0f / (float)kInScatteringSteps);
  float l_in[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float trans[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  for (int i = 0; i < kInScatteringSteps; ++i) {
    const float t = dt * ((float)i + 0.5f);
    const V3 p = {ro.x + rd.x * t, ro.y + rd.y * t, ro.z + rd.z * t};
    const float dist = sqrtf(dot3(p, p));
    const V3 zenith = {p.x / dist, p.y / dist, p.z / dist};
    const float altitude = dist - kEarthRadius;
    const float alt = altitude * kInvThickness;
    const float sample_cos = dot3(zenith, sun_dir);

    float aer_scat[4], mol_scat[4], ext[4], t_sun[4], ms[4];
    coefficients(altitude, aer_scat, mol_scat, ext);
    as_array(transmittance_at(lut, lut_h, lut_w, sample_cos, alt), t_sun);
    multiple_scattering(lut, lut_h, lut_w, sample_cos, alt, dist, ms);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float s_term = kSunIrradiance[c] *
          (mol_scat[c] * (molecular_phase * t_sun[c] + ms[c]) +
           aer_scat[c] * (aerosol_phase * t_sun[c] + ms[c]));
      const float step = expf(-dt * ext[c]);
      // Hillaire's energy-conserving analytic step (sky-lut.glsl:261-272).
      const float s_int = (s_term - s_term * step) / fmaxf(ext[c], 1e-7f);
      l_in[c] = l_in[c] + trans[c] * s_int;
      trans[c] = trans[c] * step;
    }
  }
  float rgb[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    // The plain version's Python sum: ((0 + a0) + a1 + a2) + a3.
    rgb[k] = 0.0f + l_in[0] * kSpectralToSrgb[k][0] + l_in[1] * kSpectralToSrgb[k][1] +
             l_in[2] * kSpectralToSrgb[k][2] + l_in[3] * kSpectralToSrgb[k][3];
  }
  return make_float4(rgb[0], rgb[1], rgb[2], 1.0f);
}

// The transmittance texel (x, y) of a [height, width] LUT
// (transmittance-lut.glsl:157-196).
__device__ __forceinline__ float4 transmittance_texel(int x, int y, int width,
                                                      int height) {
  const float u = (float)x * (1.0f / (float)width);
  const float v = (float)y * (1.0f / (float)height);
  const float sun_cos = u * 2.0f - 1.0f;
  const V3 sun_dir = {-sqrtf(fmaxf(1.0f - sun_cos * sun_cos, 0.0f)), 0.0f, sun_cos};
  const float dist = 100.0f * v + kEarthRadius;
  const V3 ro = {0.0f, 0.0f, dist};
  const float t_d = ray_sphere(ro, sun_dir, kAtmosphereRadius2);
  const float dt = t_d * (1.0f / (float)kTransmittanceSteps);
  float tau[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < kTransmittanceSteps; ++i) {
    const float t = dt * ((float)i + 0.5f);
    const V3 p = {ro.x + sun_dir.x * t, ro.y + sun_dir.y * t, ro.z + sun_dir.z * t};
    const float altitude = sqrtf(dot3(p, p)) - kEarthRadius;
    float aer_scat[4], mol_scat[4], ext[4];
    coefficients(altitude, aer_scat, mol_scat, ext);
#pragma unroll
    for (int c = 0; c < 4; ++c) tau[c] = tau[c] + ext[c] * dt;
  }
  return make_float4(expf(-tau[0]), expf(-tau[1]), expf(-tau[2]), expf(-tau[3]));
}

// ---- kernels and C entry points

__global__ void __launch_bounds__(kThreads)
sky_kernel(const float4* __restrict__ lut, int lut_h, int lut_w,
           const float* __restrict__ sun, int row0, int rows, int width, int height,
           float4* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows * width) return;
  const int r = i / width, x = i - r * width;
  // The world (y-up) sun vector in the LUT's z-up frame.
  const V3 sun_dir = {-__ldg(sun), -__ldg(sun + 2), __ldg(sun + 1)};
  out[i] = sky_texel(lut, lut_h, lut_w, sun_dir, x, row0 + r, width, height);
}

__global__ void __launch_bounds__(kThreads)
transmittance_kernel(int width, int height, float4* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= width * height) return;
  const int y = i / width, x = i - y * width;
  out[i] = transmittance_texel(x, y, width, height);
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// K10. lut: [lut_h, lut_w, 4] f32; sun: 3 f32 (the world sun vector);
// out: [rows, width, 4] f32, the LUT rows [row0, row0 + rows) of a
// [height, width] sky-view LUT. Returns a CUDA error code.
extern "C" int cs_sky_lut(const void* lut, int lut_h, int lut_w, const void* sun,
                          int row0, int rows, int width, int height, void* out,
                          void* stream) {
  if (rows < 1 || width < 1 || height < 1 || lut_h < 1 || lut_w < 1 ||
      (long long)rows * width > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  sky_kernel<<<blocks_for((long long)rows * width), kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)lut, lut_h, lut_w, (const float*)sun, row0, rows, width, height,
      (float4*)out);
  return (int)cudaGetLastError();
}

// K11. out: [height, width, 4] f32. Returns a CUDA error code.
extern "C" int cs_transmittance_lut(int width, int height, void* out, void* stream) {
  if (width < 1 || height < 1 || (long long)width * height > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  transmittance_kernel<<<blocks_for((long long)width * height), kThreads, 0,
                         (cudaStream_t)stream>>>(width, height, (float4*)out);
  return (int)cudaGetLastError();
}
