// K12: the serving tick's display composite, for Hopper (sm_90a).
//
// Replaces no pallas_call: the JAX package jits `composite_display`
// (cloudscape_tpu/models/compositor.py) and XLA fuses it. The port's own
// kernel for the fused tick's composite over the cycle's display-pair
// textures (`models/compositor.py` `composite_display`, the engine's form:
// 8-channel cloud and sky pair textures, the raw transmittance LUT). Its
// plain version is that function's eager body, `_composite_display_plain`,
// which ops/composite_kernel.py takes for CPU tensors; eager, it is ~200
// small launches (two of them K8) and host-to-device copies of the sun and
// the view position, whose pageable copies wait for the stream, so the
// host could launch the composite only after the tick's tile had run.
//
// Per pixel, in the plain version's order (clouds.gdshader:104-116): the
// view direction clamped to the upper hemisphere and normalised (the
// [1, 0, 0] fallback), its octahedral uv (the xzy swizzle), one bilinear
// fetch of the cloud pair then the lerp by blend_amount; the equirect uv,
// one fetch of the sky pair, the lerp and /50; the sun disk and bloom and
// their smoothstep; the ground hit from the constant view position; the
// transmittance at the view position (the same for every pixel: each
// thread fetches it from the 64 x 256 LUT, which stays in L1); then the
// over-blend, the clamps, the horizon fade and, with deband, the Jimenez
// dither. The sun, its disk scale and blend_amount are launch arguments
// from the host's values: nothing is copied to the card and nothing waits.
//
// Rounding: every step is the plain version's eager op, so this source is
// built with -fmad=false (ops/_cuda.py): eager torch rounds each product
// and sum on its own. A division by a Python scalar is, as torch's CUDA
// kernels compute it, a product with the float32 reciprocal; a Python
// scalar is the float32 it rounds to; `1.0 / x` is torch's reciprocal. The
// pair fetches are K8's device code (texture.cuh `tex_axis`,
// `weigh_texels`), so they are K8's samples bit for bit. The libm calls
// (atan2f, asinf, expf, cosf, sqrtf) are those torch's CUDA kernels call.
//
// Bound: bytes. A pixel reads 12 B of direction and writes 12 B; the
// distinct texels read are at most the two pair textures (18.9 MB for the
// 768^2 clouds, 0.64 MB for the 100 x 200 sky) and the LUT (0.26 MB). At
// 1280 x 720 that is <= 42 MB, ~12.5 us at 3.35 TB/s.
//
// Design: one launch. Neighbouring threads take neighbouring pixels, and a
// thread takes kPixels of them, a block's span apart (pixel i and i +
// kThreads), so a warp's direction loads and stores cover contiguous
// bytes. A texel's 8 channels are read as two float4 (texture.cuh). No
// shared-memory staging: the cloud texture fits the 50 MB L2 and
// neighbouring pixels fetch neighbouring texels. The kernel is bound by
// its instructions, not its bytes (a cold L2 and a warm one time alike on
// an H100): the pairs' clamp wrap and weight stride are compile-time
// constants, which took a call from 31.8 to 29.7 us (PERF.md §6); the
// frame's constants once a block in shared memory, or 4 pixels a thread,
// timed no better.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "texture.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPixels = 2;
// The pairs' wrap and weight strides: clamp, and the JAX package's brick
// stride of an 8-channel 2-D table (ops/brick.py WEIGHT_STRIDES), which the
// C entry checks against the wrapper's. As compile-time constants they
// spare each fetch its wrap branches and two integer divisions.
constexpr int kClamp = 1;
constexpr int kStride = 3;

constexpr double kPi = 3.14159265358979323846;  // the shader's PI, in full
constexpr double kGroundRadius = 6.360;          // megameters (compositor.py)
constexpr double kAtmosphereRadius = 6.460;

// A Python scalar as the float32 torch rounds it to, and the float32
// reciprocal of a Python scalar divisor, as torch takes it.
constexpr float f32(double x) { return (float)x; }
constexpr float recip(double x) { return 1.0f / (float)x; }

constexpr float kViewY = f32(kGroundRadius + 0.0002);  // the view position's y
constexpr float kGround = f32(kGroundRadius);
constexpr float kGround2 = f32(kGroundRadius * kGroundRadius);
constexpr float kInvShell = recip(kAtmosphereRadius - kGroundRadius);
constexpr float kInvPi = recip(kPi);
constexpr float kInvHalfPi = recip(kPi * 0.5);
constexpr float kInv50 = recip(50.0);
constexpr float kInv255 = recip(255.0);
constexpr float kMinLen = f32(1e-12);
constexpr float kDiskRadians = f32(0.53 * kPi / 180.0);
constexpr float kBloomBase = f32(0.02), kBloomScale = f32(0.01);
constexpr float kSunEdge = f32(0.002), kInvSunRange = recip(1.0 - 0.002);
constexpr float kFadeEdge = f32(0.6), kInvFadeRange = recip(1.0 - 0.6);
constexpr float kDitherX = f32(0.06711056), kDitherY = f32(0.00583715);
constexpr float kDitherK = f32(52.9829189);

struct Composite {
  int cloud_h, cloud_w, sky_h, sky_w;
  int lut_h, lut_w, lut_c;
  int width, height;  // the image's last two dims: the dither's lattice
  float sun[3];
  float disk_scale, blend;
  int deband;
};

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// GLSL smoothstep(e0, e1, x), inv = the reciprocal of (e1 - e0).
__device__ __forceinline__ float smoothstep(float e0, float inv, float x) {
  const float t = clamp01((x - e0) * inv);
  return (t * t) * (3.0f - 2.0f * t);
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// A bilinear fetch of an 8-channel clamp pair texture at (u, v): K8's.
__device__ __forceinline__ void fetch_pair(const float* tex, int h, int w, float u,
                                           float v, float* out) {
  int xi[2], yi[2];
  float wx[2], wy[2];
  tex_axis(u, w, kClamp, kStride, xi, wx);
  tex_axis(v, h, kClamp, kStride, yi, wy);
  int off[4];
  float wk[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // corner order: y, then x
    const int dy = k >> 1, dx = k & 1;
    off[k] = yi[dy] * w + xi[dx];
    wk[k] = __fmul_rn(wx[dx], wy[dy]);
  }
  weigh_texels<8, 4>(tex, off, wk, out);
}

// The transmittance at the view position toward the sun
// (`transmittance_lookup`): a clamp-wrap bilinear fetch of the raw LUT
// (`ops/sampling.py` `sample2d`), its first three channels.
__device__ void transmittance(const float* __restrict__ lut, const Composite& g,
                              float tl[3]) {
  const float pos[3] = {0.0f, kViewY, 0.0f};
  const float height = sqrtf(dot3(pos, pos));
  const float up[3] = {pos[0] / height, pos[1] / height, pos[2] / height};
  const float u = clamp01(dot3(up, g.sun) * 0.5f + 0.5f);
  const float v = clamp01((height - kGround) * kInvShell);
  const float cx = u * (float)g.lut_w - 0.5f;
  const float cy = v * (float)g.lut_h - 0.5f;
  const float x0f = floorf(cx), y0f = floorf(cy);
  const float fx = cx - x0f, fy = cy - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int x1 = min(max(x0 + 1, 0), g.lut_w - 1), y1 = min(max(y0 + 1, 0), g.lut_h - 1);
  const int xa = min(max(x0, 0), g.lut_w - 1), ya = min(max(y0, 0), g.lut_h - 1);
  const float* c00 = lut + (ya * g.lut_w + xa) * g.lut_c;
  const float* c10 = lut + (ya * g.lut_w + x1) * g.lut_c;
  const float* c01 = lut + (y1 * g.lut_w + xa) * g.lut_c;
  const float* c11 = lut + (y1 * g.lut_w + x1) * g.lut_c;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float a = __ldg(c00 + k), b = __ldg(c10 + k);
    const float c = __ldg(c01 + k), d = __ldg(c11 + k);
    const float top = a + (b - a) * fx;
    const float bot = c + (d - c) * fx;
    tl[k] = top + (bot - top) * fy;
  }
}

__device__ __forceinline__ void pixel(const float* __restrict__ eyedir,
                                      const float* __restrict__ cloud,
                                      const float* __restrict__ sky, const float tl[3],
                                      float min_cos, float* __restrict__ out, int i,
                                      const Composite& g) {
  const float e[3] = {__ldg(eyedir + 3 * i), __ldg(eyedir + 3 * i + 1),
                      __ldg(eyedir + 3 * i + 2)};

  // The cloud direction (`_cloud_dir`) and its octahedral uv
  // (`world_dir_to_uv`: `vec3_to_oct` of the xzy swizzle).
  const float nrm[3] = {e[0], fmaxf(e[1], 0.0f), e[2]};
  const float len = sqrtf(dot3(nrm, nrm));
  float d[3] = {1.0f, 0.0f, 0.0f};
  if (len > 0.0f) {
    const float c = fmaxf(len, kMinLen);
    d[0] = nrm[0] / c;
    d[1] = nrm[1] / c;
    d[2] = nrm[2] / c;
  }
  const float o[3] = {d[0], d[2], d[1]};
  const float s = (fabsf(o[0]) + fabsf(o[1])) + fabsf(o[2]);
  const float ox = o[0] / s, oy = o[1] / s, oz = o[2] / s;
  float px = ox, py = oy;
  if (!(oz >= 0.0f)) {  // the lower-hemisphere fold (`_oct_wrap`)
    px = (1.0f - fabsf(oy)) * (ox >= 0.0f ? 1.0f : -1.0f);
    py = (1.0f - fabsf(ox)) * (oy >= 0.0f ? 1.0f : -1.0f);
  }
  const float vy = py * 0.5f + 0.5f;
  const float cu = px * 0.5f + vy;
  const float cv = px * -0.5f + vy;
  alignas(16) float cp[8];
  fetch_pair(cloud, g.cloud_h, g.cloud_w, cu, cv, cp);
  float clouds[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) clouds[k] = cp[k] + (cp[k + 4] - cp[k]) * g.blend;

  // The sky (`sky_lut_blend`): equirect uv, one pair fetch, lerp, /50.
  const float phi = atan2f(e[2], e[0]);
  const float theta = asinf(fminf(fmaxf(e[1], -1.0f), 1.0f));
  const float su = (phi * kInvPi) * 0.5f + 0.5f;
  const float sign = (float)((0.0f < theta) - (theta < 0.0f));
  const float sv = (sqrtf(fabsf(theta) * kInvHalfPi) * sign) * 0.5f + 0.5f;
  alignas(16) float sp[8];
  fetch_pair(sky, g.sky_h, g.sky_w, su, sv, sp);
  float col[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) col[k] = (sp[k] + (sp[k + 4] - sp[k]) * g.blend) * kInv50;

  // The sun disk and bloom (`sun_with_bloom`), then its smoothstep.
  const float cos_theta = dot3(e, g.sun);
  const float offset = fmaxf(min_cos - cos_theta, 0.0f);
  const float gaussian = expf(-offset * 50000.0f) * 0.5f;
  const float inv = (1.0f / (offset * 300.0f + kBloomBase)) * kBloomScale;
  const float lum = cos_theta >= min_cos ? 1.0f : gaussian + inv;
  const float sun = smoothstep(kSunEdge, kInvSunRange, lum);

  // The ground hit from the view position (`ray_sphere_first` >= 0).
  const float ro[3] = {0.0f, kViewY, 0.0f};
  const float b = dot3(ro, e);
  const float c = dot3(ro, ro) - kGround2;
  const float disc = b * b - c;
  const float sqrt_d = sqrtf(fmaxf(disc, 0.0f));
  const float hit = disc > b * b ? -b + sqrt_d : -b - sqrt_d;
  const bool miss = (c > 0.0f && b > 0.0f) || disc < 0.0f;
  const bool ground = (miss ? -1.0f : hit) >= 0.0f;
  const bool has_sun = sqrtf(sun * sun + sun * sun + sun * sun) > 0.0f;

  // The background (`get_atmo`), then `_finish`.
  const float fade = smoothstep(kFadeEdge, kInvFadeRange, 1.0f - e[1]);
  float dither = 0.0f;
  if (g.deband) {
    const float x = (float)(i % g.width);
    const float y = (float)((i / g.width) % g.height);
    const float t = x * kDitherX + y * kDitherY;
    const float f = (t - truncf(t)) * kDitherK;
    dither = ((f - truncf(f)) - 0.5f) * kInv255;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float sun_k = has_sun ? (ground ? 0.0f : sun * tl[k]) : sun;
    const float bg = col[k] + sun_k;
    const float color = bg * (1.0f - clouds[3]) + clouds[k];
    const float cc = fminf(fmaxf(color, 0.0f), 100.0f);
    const float bc = fminf(fmaxf(bg, 0.0f), 100.0f);
    float v = cc + (bc - cc) * fade;
    if (g.deband) v = fmaxf(v + dither, 0.0f);
    out[3 * i + k] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
composite_kernel(const float* __restrict__ eyedir, const float* __restrict__ cloud,
                 const float* __restrict__ sky, const float* __restrict__ lut,
                 float* __restrict__ out, int n, Composite g) {
  float tl[3];
  transmittance(lut, g, tl);
  const float min_cos = cosf(g.disk_scale * kDiskRadians);
  const int first = blockIdx.x * (kThreads * kPixels) + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kPixels; ++j) {
    const int i = first + j * kThreads;
    if (i < n) pixel(eyedir, cloud, sky, tl, min_cos, out, i, g);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// K12. eyedir: [n, 3] f32, contiguous; geom: cloud h, w, clamp, sy, sx; sky
// h, w, clamp, sy, sx (each an [h, w, 8] f32 pair texture, contiguous and
// 16-B aligned; clamp must be 1 and sy, sx, its weight strides, 3); LUT h,
// w, channels (an [h, w, C >= 3] f32 image, contiguous); the image's last
// two dims (width, height; height 1 for a row of pixels); scalars: sun x,
// y, z, sun_disk_scale, blend_amount (host memory); deband 0 or 1; out:
// [n, 3] f32. Returns a CUDA error code (0 on success).
extern "C" int cs_composite(const float* eyedir, long long n, const int* geom,
                            const float* cloud, const float* sky, const float* lut,
                            const float* scalars, int deband, float* out, void* stream) {
  if (n <= 0) return 0;
  for (int k = 0; k < 15; ++k)
    if (geom[k] < 1) return (int)cudaErrorInvalidValue;
  for (int k : {2, 7})
    if (geom[k] != kClamp || geom[k + 1] != kStride || geom[k + 2] != kStride)
      return (int)cudaErrorInvalidValue;
  const Composite g{geom[0],  geom[1],  geom[5],  geom[6],
                    geom[10], geom[11], geom[12], geom[13], geom[14],
                    {scalars[0], scalars[1], scalars[2]}, scalars[3], scalars[4], deband};
  if (g.lut_c < 3 || (deband != 0 && deband != 1) ||
      n * 3 >= (1LL << 31) || (long long)g.cloud_h * g.cloud_w * 8 >= (1LL << 31) ||
      (long long)g.sky_h * g.sky_w * 8 >= (1LL << 31) ||
      (long long)g.lut_h * g.lut_w * g.lut_c >= (1LL << 31) || !aligned16(cloud) ||
      !aligned16(sky))
    return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)kThreads * kPixels;
  composite_kernel<<<(unsigned)((n + per_block - 1) / per_block), kThreads, 0,
                     (cudaStream_t)stream>>>(eyedir, cloud, sky, lut, out, (int)n, g);
  return (int)cudaGetLastError();
}
