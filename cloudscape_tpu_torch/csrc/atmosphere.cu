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
// Bound: the float32 issue rate. The work is frozen at what one thread a
// texel executes at the least on this source's first form (chip_smoke.py's
// SERIAL_WORK: K10 21,224 SASS instructions a texel, 664 of them MUFU; K11
// 5,909 and 167), and the issue rate binds, not the special-function unit
// (K10's LUT: 12.67 us at 33.5 T/s against 3.18 us at 4.18 T/s). Per sky
// step ~13 expf/logf/powf, 3 IEEE divisions, a sqrtf and four bilinear
// fetches from the 256 KB transmittance LUT (through __ldg); 16 bytes
// written a texel, so memory is idle.
//
// Design: a texel's steps are independent but for two running sums (K10
// l_in += trans * s_int, trans *= step; K11 tau += ext * dt), so a group of
// G lanes takes a texel, lane j its steps j, j + G, ..., each computed as
// the one-thread march computed it, and the sums run afterwards in step
// order: the same operations in the same order, so the same bits, whatever
// a texel's place in the launch (a band equals the same rows of a whole
// call bitwise). A block runs three phases between two barriers: the
// prologue (ray, dt, phases) a thread a texel into shared memory; the
// steps, thread t lane t / T of texel t % T (T = kThreads / G texels a
// block), so one warp instruction marches 32 G / kThreads steps of adjacent
// texels and its LUT fetches stay close; the sums a thread a (texel,
// channel). One thread a texel was latency-bound: the engine's 20,000
// texels are 1.2 warps a scheduler, each a 21,224-instruction chain.
// tools/bench_atmosphere.py measured G and the phases on an H100 (PERF.md
// §6).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTransmittanceSteps = 40;  // transmittance-lut.glsl:45
constexpr int kInScatteringSteps = 30;   // sky-lut.glsl:53
// Lanes a texel: a group of G lanes takes a texel, lane j its steps j,
// j + G, j + 2G, ... (ops/atmosphere_kernel.py's LANES mirrors them).
constexpr int kSkyLanes = 8;
constexpr int kTransmittanceLanes = 8;
// A texel's row of per-step terms in shared memory: K10 s_int and step (8
// floats a step), K11 ext * dt (4); 4 floats of padding put the summing
// threads of a warp (8 texels, 4 channels) on distinct banks.
constexpr int kSkyRow = 8 * kInScatteringSteps + 4;
constexpr int kTransmittanceRow = 4 * kTransmittanceSteps + 4;

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

// ---- the marches, cut into a prologue and single steps

// What every step of a sky-view texel's march reads (sky-lut.glsl:278-300).
struct SkyRay {
  V3 rd;
  float dt, molecular_phase, aerosol_phase;
};

// The prologue of the sky-view texel (x, row) of a [height, width] LUT.
__device__ __forceinline__ SkyRay sky_ray(V3 sun_dir, int x, int row, int width,
                                          int height) {
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
  const float den = kAerosolDen0 + kAerosolDen1 * cos_theta;
  SkyRay r;
  r.rd = rd;
  r.dt = t_d * (1.0f / (float)kInScatteringSteps);
  r.molecular_phase = kRayleighPhase * (1.0f + cos_theta * cos_theta);
  r.aerosol_phase = (1.0f / (den * sqrtf(den))) * kAerosolPhase;
  return r;
}

// Step i of a sky-view texel's march: per channel the light it scatters in
// and its transmittance (sky-lut.glsl:240-272).
__device__ __forceinline__ void sky_step(const float4* __restrict__ lut, int lut_h,
                                         int lut_w, V3 sun_dir, const SkyRay& r, int i,
                                         float s_int[4], float step[4]) {
  const V3 ro = {0.0f, 0.0f, kEyeDistance};
  const float t = r.dt * ((float)i + 0.5f);
  const V3 p = {ro.x + r.rd.x * t, ro.y + r.rd.y * t, ro.z + r.rd.z * t};
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
        (mol_scat[c] * (r.molecular_phase * t_sun[c] + ms[c]) +
         aer_scat[c] * (r.aerosol_phase * t_sun[c] + ms[c]));
    step[c] = expf(-r.dt * ext[c]);
    // Hillaire's energy-conserving analytic step (sky-lut.glsl:261-272).
    s_int[c] = (s_term - s_term * step[c]) / fmaxf(ext[c], 1e-7f);
  }
}

// What every step of a transmittance texel's march reads.
struct SunRay {
  V3 ro, rd;
  float dt;
};

// The prologue of the transmittance texel (x, y) of a [height, width] LUT
// (transmittance-lut.glsl:157-196).
__device__ __forceinline__ SunRay sun_ray(int x, int y, int width, int height) {
  const float u = (float)x * (1.0f / (float)width);
  const float v = (float)y * (1.0f / (float)height);
  const float sun_cos = u * 2.0f - 1.0f;
  SunRay r;
  r.rd = {-sqrtf(fmaxf(1.0f - sun_cos * sun_cos, 0.0f)), 0.0f, sun_cos};
  r.ro = {0.0f, 0.0f, 100.0f * v + kEarthRadius};
  r.dt = ray_sphere(r.ro, r.rd, kAtmosphereRadius2) * (1.0f / (float)kTransmittanceSteps);
  return r;
}

// Step i of a transmittance texel's march: its optical depth per channel.
__device__ __forceinline__ void sun_step(const SunRay& r, int i, float tau[4]) {
  const float t = r.dt * ((float)i + 0.5f);
  const V3 p = {r.ro.x + r.rd.x * t, r.ro.y + r.rd.y * t, r.ro.z + r.rd.z * t};
  const float altitude = sqrtf(dot3(p, p)) - kEarthRadius;
  float aer_scat[4], mol_scat[4], ext[4];
  coefficients(altitude, aer_scat, mol_scat, ext);
#pragma unroll
  for (int c = 0; c < 4; ++c) tau[c] = ext[c] * r.dt;
}

// ---- kernels and C entry points

// A thread's place in the step phase of a launch of G lanes a texel: a
// block holds kThreads / G texels, and thread t is lane t / (kThreads / G) of
// texel t % (kThreads / G), so the lanes of one warp instruction march the
// same step (or, where a block holds fewer than 32 texels, 32 G / kThreads
// steps) of adjacent texels, and their LUT fetches stay close.
template <int G>
struct Group {
  static_assert(G >= 4 && kThreads % G == 0, "a whole group and a thread a channel");
  static constexpr int kTexels = kThreads / G;  // texels a block
  int lane;  // the lane in its group: its first step
  int slot;  // the group's texel in the block

  __device__ __forceinline__ Group()
      : lane(threadIdx.x / kTexels), slot(threadIdx.x % kTexels) {}
};

// In both kernels every thread reaches both barriers and the shuffles, and
// a texel past the launch's last is marched as that last one and not
// stored. The sums put a texel's four channels in four consecutive lanes,
// which shuffle them to the first.

__global__ void __launch_bounds__(kThreads)
sky_kernel(const float4* __restrict__ lut, int lut_h, int lut_w,
           const float* __restrict__ sun, int row0, int rows, int width, int height,
           float4* __restrict__ out) {
  using G = Group<kSkyLanes>;
  __shared__ SkyRay rays[G::kTexels];
  __shared__ __align__(16) float terms[G::kTexels][kSkyRow];
  const int n = rows * width;
  const int base = blockIdx.x * G::kTexels;
  // The world (y-up) sun vector in the LUT's z-up frame.
  const V3 sun_dir = {-__ldg(sun), -__ldg(sun + 2), __ldg(sun + 1)};
  if (threadIdx.x < G::kTexels) {
    const int texel = min(base + (int)threadIdx.x, n - 1);
    const int r = texel / width;
    rays[threadIdx.x] = sky_ray(sun_dir, texel - r * width, row0 + r, width, height);
  }
  __syncthreads();
  const G g;
  const SkyRay ray = rays[g.slot];
  float* row = terms[g.slot];
  for (int s = g.lane; s < kInScatteringSteps; s += kSkyLanes) {
    float s_int[4], step[4];
    sky_step(lut, lut_h, lut_w, sun_dir, ray, s, s_int, step);
    reinterpret_cast<float4*>(row + 8 * s)[0] = make_float4(s_int[0], s_int[1], s_int[2],
                                                            s_int[3]);
    reinterpret_cast<float4*>(row + 8 * s)[1] = make_float4(step[0], step[1], step[2],
                                                            step[3]);
  }
  __syncthreads();
  // Channel c's sums over the steps in order: the products and sums of the
  // one-thread march, so its bits.
  const int slot = threadIdx.x / 4, c = threadIdx.x % 4;
  float l_in = 0.0f;
  if (slot < G::kTexels) {
    const float* sums = terms[slot];
    float trans = 1.0f;
#pragma unroll
    for (int s = 0; s < kInScatteringSteps; ++s) {
      l_in = l_in + trans * sums[8 * s + c];
      trans = trans * sums[8 * s + 4 + c];
    }
  }
  float l[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) l[k] = __shfl_sync(0xffffffffu, l_in, (threadIdx.x & 28) + k);
  if (c != 0 || slot >= G::kTexels || base + slot >= n) return;
  float rgb[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    // The plain version's Python sum: ((0 + a0) + a1 + a2) + a3.
    rgb[k] = 0.0f + l[0] * kSpectralToSrgb[k][0] + l[1] * kSpectralToSrgb[k][1] +
             l[2] * kSpectralToSrgb[k][2] + l[3] * kSpectralToSrgb[k][3];
  }
  out[base + slot] = make_float4(rgb[0], rgb[1], rgb[2], 1.0f);
}

__global__ void __launch_bounds__(kThreads)
transmittance_kernel(int width, int height, float4* __restrict__ out) {
  using G = Group<kTransmittanceLanes>;
  __shared__ SunRay rays[G::kTexels];
  __shared__ __align__(16) float terms[G::kTexels][kTransmittanceRow];
  const int n = width * height;
  const int base = blockIdx.x * G::kTexels;
  if (threadIdx.x < G::kTexels) {
    const int texel = min(base + (int)threadIdx.x, n - 1);
    const int y = texel / width;
    rays[threadIdx.x] = sun_ray(texel - y * width, y, width, height);
  }
  __syncthreads();
  const G g;
  const SunRay ray = rays[g.slot];
  float* row = terms[g.slot];
  for (int s = g.lane; s < kTransmittanceSteps; s += kTransmittanceLanes) {
    float tau[4];
    sun_step(ray, s, tau);
    reinterpret_cast<float4*>(row)[s] = make_float4(tau[0], tau[1], tau[2], tau[3]);
  }
  __syncthreads();
  const int slot = threadIdx.x / 4, c = threadIdx.x % 4;
  float e = 0.0f;
  if (slot < G::kTexels) {
    const float* sums = terms[slot];
    float tau = 0.0f;
#pragma unroll
    for (int s = 0; s < kTransmittanceSteps; ++s) tau = tau + sums[4 * s + c];
    e = expf(-tau);
  }
  float t[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) t[k] = __shfl_sync(0xffffffffu, e, (threadIdx.x & 28) + k);
  if (c == 0 && slot < G::kTexels && base + slot < n)
    out[base + slot] = make_float4(t[0], t[1], t[2], t[3]);
}

// The launch geometry ops/atmosphere_kernel.py's `launch_geometry` gives:
// `blocks` blocks of kThreads threads, `per_block` texels a block, `lanes`
// lanes a texel. True if it is the kernel's (`kernel_lanes`) and covers
// `texels` texels with no block to spare.
bool geometry_ok(long long texels, int blocks, int per_block, int lanes,
                 int kernel_lanes) {
  return lanes == kernel_lanes && per_block == kThreads / kernel_lanes && blocks >= 1 &&
         (long long)blocks * per_block >= texels &&
         (long long)(blocks - 1) * per_block < texels;
}

}  // namespace

// K10. lut: [lut_h, lut_w, 4] f32; sun: 3 f32 (the world sun vector);
// out: [rows, width, 4] f32, the LUT rows [row0, row0 + rows) of a
// [height, width] sky-view LUT; blocks, per_block, lanes: the launch
// geometry. Returns a CUDA error code.
extern "C" int cs_sky_lut(const void* lut, int lut_h, int lut_w, const void* sun,
                          int row0, int rows, int width, int height, int blocks,
                          int per_block, int lanes, void* out, void* stream) {
  if (rows < 1 || width < 1 || height < 1 || lut_h < 1 || lut_w < 1 ||
      (long long)rows * width > 0x7fffffffLL ||
      !geometry_ok((long long)rows * width, blocks, per_block, lanes, kSkyLanes))
    return (int)cudaErrorInvalidValue;
  sky_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)lut, lut_h, lut_w, (const float*)sun, row0, rows, width, height,
      (float4*)out);
  return (int)cudaGetLastError();
}

// K11. out: [height, width, 4] f32; blocks, per_block, lanes: as K10's.
// Returns a CUDA error code.
extern "C" int cs_transmittance_lut(int width, int height, int blocks, int per_block,
                                    int lanes, void* out, void* stream) {
  if (width < 1 || height < 1 || (long long)width * height > 0x7fffffffLL ||
      !geometry_ok((long long)width * height, blocks, per_block, lanes,
                   kTransmittanceLanes))
    return (int)cudaErrorInvalidValue;
  transmittance_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      width, height, (float4*)out);
  return (int)cudaGetLastError();
}
