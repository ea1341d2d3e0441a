// K7–K9: filtered fetches from the brick tables, for Hopper (sm_90a).
//
// Replaces no pallas_call: the JAX package leaves these to XLA's gather and
// a lane-weight reduce (cloudscape_tpu/ops/brick.py):
//
//   K7 sample_brick3_xyz (:282): trilinear fetch from a [n_bricks, C*L]
//      table of 3-D bricks (L = bz*by*bx = 64 or 128 lanes a channel);
//   K8 sample_brick2_xy (:323): bilinear fetch from a table of 2-D bricks;
//   K9 sample_tiny3_xyz (:351): trilinear fetch, modular wrap, from a whole
//      volume of <= 128 values held as one channel-major row.
//
// The plain versions (ops/brick.py) keep the TPU's form: per sample they
// gather a whole 128-lane row (512 B), build three [m, L] hat-weight
// planes and their product, and multiply and sum all 128 lanes, of which
// 8 (4 in 2-D) carry weight.
//
// Bound: bytes, and here the bytes are gathered sectors. A sample reads
// 12 B of coordinates (8 B in 2-D) and writes 4*C B; its 8 corner texels
// of a channel lie in one brick row, the x pair in one 16-B row of the
// brick, the y pair 16 B (4x4x4) apart, the z pair 64 B apart, so a
// channel costs 2-4 sectors of 32 B rather than the plain version's 512-B
// row plus its weight planes.
//
// Design: one thread per sample reads only the texels that carry weight,
// straight out of the brick row through the read-only path (__ldg), weighs
// and sums them in registers and writes its C channels: no rows, weights or
// chunks are materialised. Consecutive samples of a ray fall into the same
// brick, so neighbouring threads share sectors in L1. The index math is
// 32-bit (a 64-bit division is a long software routine on the card); the
// coordinate planes are contiguous; the channel count and table type are
// template arguments, compiled only for the pairs the tables use (below);
// a bfloat16 table's texels are widened to f32 (exact) before the product,
// as torch's type promotion does in the plain version.
//
// The arithmetic is the plain version's, step by step, so that the kernel
// agrees with it to a few ulps:
//   - cx = q*n - 0.5 rounds the product and then the difference: written
//     with __fmul_rn / __fsub_rn, which nvcc never contracts into an FMA
//     (a contracted q*n - 0.5 would move f and, at a texel boundary, i0 and
//     the brick row);
//   - the hat weights are max(0, 1 - |a - lane|) with a = float(l0) + f
//     rounded (so not exactly 1 - f and f), for lanes l0 and l0 + 1;
//     K9 takes 1 - f at i0 and f at (i0 + 1) % n, summed where the two
//     coincide (n = 1);
//   - repeat wrap is a floor modulo of i0 (32-bit, and 64-bit as the plain
//     version's int64 past 2^31); clamp wrap sets f = 0 below the volume
//     and f = 1 past n - 2 and clamps i0 to [0, n - 2];
//   - each corner is ((wx * wy) * wz) * texel, and a channel's 8 corners
//     are summed in lane order (z, then y, then x). torch.sum reduces the
//     128 lanes in another tree, so the two agree within a few ulps, not
//     bitwise. The plain version multiplies every lane, so a non-finite
//     texel anywhere in the row would make its sample NaN; the tables are
//     finite, and the kernel reads only the 8 corners.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Brick3 {
  int d, h, w;     // volume dims (z, y, x)
  int bz, by, bx;  // brick dims
  int sz, sy, sx;  // brick strides
  int ny, nx;      // brick grid (z is outermost)
  int channels;
  int clamp;       // 0: repeat, 1: clamp
};

struct Brick2 {
  int h, w, by, bx, sy, sx, nx, channels, clamp;
};

struct Tiny3 {
  int d, h, w, channels;
};

__device__ __forceinline__ float texel(const float* p) { return __ldg(p); }

// bfloat16 → f32 is the top half of the float's bits: exact.
__device__ __forceinline__ float texel(const uint16_t* p) {
  return __uint_as_float(((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}

// GL filtering coordinates of one axis (ops/brick.py `_axis_coords`):
// cell i0 >= 0 and fraction f. i0f is integral and n small, so the clamp
// tests are exact in float.
__device__ __forceinline__ void axis_coords(float q, int n, int clamp, int& i0,
                                            float& f) {
  const float cx = __fsub_rn(__fmul_rn(q, (float)n), 0.5f);
  const float i0f = floorf(cx);
  f = __fsub_rn(cx, i0f);
  if (clamp) {
    if (i0f < 0.0f) {
      f = 0.0f;
      i0 = 0;
    } else if (i0f > (float)(n - 2)) {
      f = 1.0f;
      i0 = n - 2 > 0 ? n - 2 : 0;
    } else {
      i0 = (int)i0f;
    }
  } else if (fabsf(i0f) < 2147483648.0f) {
    const int r = (int)i0f % n;
    i0 = r < 0 ? r + n : r;
  } else {
    const long long r = (long long)i0f % n;
    i0 = (int)(r < 0 ? r + n : r);
  }
}

// The hat weights max(0, 1 - |a - lane|), a = float(l0) + f, at lanes l0
// and l0 + 1 (`_axis_weight`).
__device__ __forceinline__ void hat(int l0, float f, float w[2]) {
  const float lf = (float)l0;
  const float a = __fadd_rn(lf, f);
  w[0] = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(a, lf))));
  w[1] = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(a, __fadd_rn(lf, 1.0f)))));
}

// Each of the kC channels' kK corners of one brick row (or tiny row),
// weighted and summed in corner order, written to out[0, kC).
template <int kC, int kK, typename T>
__device__ __forceinline__ void weigh(const T* row, int L, const int off[kK],
                                      const float w[kK], float* __restrict__ out) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kK; ++k)
      acc = __fadd_rn(acc, __fmul_rn(w[k], texel(row + c * L + off[k])));
    out[c] = acc;
  }
}

// K7.
template <int kC, typename T>
__global__ void __launch_bounds__(kThreads)
brick3_kernel(const T* __restrict__ table, const float* __restrict__ qx,
              const float* __restrict__ qy, const float* __restrict__ qz,
              float* __restrict__ out, long long n, Brick3 g) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int ix, iy, iz;
  float fx, fy, fz;
  axis_coords(__ldg(qx + i), g.w, g.clamp, ix, fx);
  axis_coords(__ldg(qy + i), g.h, g.clamp, iy, fy);
  axis_coords(__ldg(qz + i), g.d, g.clamp, iz, fz);
  const int fb = ((iz / g.sz) * g.ny + iy / g.sy) * g.nx + ix / g.sx;
  const int lx = ix % g.sx, ly = iy % g.sy, lz = iz % g.sz;
  float wx[2], wy[2], wz[2];
  hat(lx, fx, wx);
  hat(ly, fy, wy);
  hat(lz, fz, wz);
  const int L = g.bz * g.by * g.bx;
  const int base = (lz * g.by + ly) * g.bx + lx;
  int off[8];
  float w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {  // lane order: z, then y, then x
    const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
    off[k] = base + (dz * g.by + dy) * g.bx + dx;
    w[k] = __fmul_rn(__fmul_rn(wx[dx], wy[dy]), wz[dz]);
  }
  weigh<kC, 8>(table + (long long)fb * (kC * L), L, off, w, out + i * kC);
}

// K8.
template <int kC, typename T>
__global__ void __launch_bounds__(kThreads)
brick2_kernel(const T* __restrict__ table, const float* __restrict__ qu,
              const float* __restrict__ qv, float* __restrict__ out, long long n,
              Brick2 g) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int ix, iy;
  float fx, fy;
  axis_coords(__ldg(qu + i), g.w, g.clamp, ix, fx);
  axis_coords(__ldg(qv + i), g.h, g.clamp, iy, fy);
  const int fb = (iy / g.sy) * g.nx + ix / g.sx;
  const int lx = ix % g.sx, ly = iy % g.sy;
  float wx[2], wy[2];
  hat(lx, fx, wx);
  hat(ly, fy, wy);
  const int L = g.by * g.bx;
  const int base = ly * g.bx + lx;
  int off[4];
  float w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // lane order: y, then x
    const int dy = k >> 1, dx = k & 1;
    off[k] = base + dy * g.bx + dx;
    w[k] = __fmul_rn(wx[dx], wy[dy]);
  }
  weigh<kC, 4>(table + (long long)fb * (kC * L), L, off, w, out + i * kC);
}

// K9's axis: lanes i0 and (i0 + 1) % n with weights 1 - f and f; for n = 1
// both are lane 0, whose weight is then (1 - f) + f, and the second corner
// weighs 0.
__device__ __forceinline__ void tiny_axis(float q, int n, int idx[2], float w[2]) {
  float f;
  axis_coords(q, n, 0, idx[0], f);
  idx[1] = (idx[0] + 1) % n;
  if (n == 1) {
    w[0] = __fadd_rn(__fsub_rn(1.0f, f), f);
    w[1] = 0.0f;
  } else {
    w[0] = __fsub_rn(1.0f, f);
    w[1] = f;
  }
}

// K9.
template <int kC, typename T>
__global__ void __launch_bounds__(kThreads)
tiny3_kernel(const T* __restrict__ row, const float* __restrict__ qx,
             const float* __restrict__ qy, const float* __restrict__ qz,
             float* __restrict__ out, long long n, Tiny3 g) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int xi[2], yi[2], zi[2];
  float wx[2], wy[2], wz[2];
  tiny_axis(__ldg(qx + i), g.w, xi, wx);
  tiny_axis(__ldg(qy + i), g.h, yi, wy);
  tiny_axis(__ldg(qz + i), g.d, zi, wz);
  const int L = g.d * g.h * g.w;
  int off[8];
  float w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {  // corner order: z, then y, then x
    const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
    off[k] = (zi[dz] * g.h + yi[dy]) * g.w + xi[dx];
    w[k] = __fmul_rn(__fmul_rn(wx[dx], wy[dy]), wz[dz]);
  }
  weigh<kC, 8>(row, L, off, w, out + i * kC);
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

bool positive(const int* v, int k) {
  for (int j = 0; j < k; ++j)
    if (v[j] < 1) return false;
  return true;
}

}  // namespace

// The (channels, type) pairs compiled, those of the tables the marches,
// the baked field and the composite sample (ops/brick.py `KERNEL_KINDS`):
// K7 and K9 1 and 2 channels, f32 or bfloat16 (the noise mips, the cone
// cache and the field; the opt-in bfloat16 noise tables); K8 2 and 8
// channels, f32 (weather, the display pairs). Any other pair returns
// cudaErrorInvalidValue.

// table: [n_bricks, C*L] f32 (bf16 = 0) or bfloat16 (bf16 = 1), lanes
// channel-major blocks of (z*by + y)*bx + x; geom: d, h, w, bz, by, bx, sz,
// sy, sx, ny, nx, C, clamp (0 repeat, 1 clamp); qx, qy, qz: contiguous f32
// planes of n samples; out: [n, C] f32. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int cs_sample_brick3(const void* table, int bf16, const int* geom,
                                const float* qx, const float* qy, const float* qz,
                                float* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const Brick3 g{geom[0], geom[1], geom[2], geom[3], geom[4],  geom[5], geom[6],
                 geom[7], geom[8], geom[9], geom[10], geom[11], geom[12]};
  if (!positive(geom, 12) || g.sz > g.bz - 1 || g.sy > g.by - 1 || g.sx > g.bx - 1)
    return (int)cudaErrorInvalidValue;
  const unsigned b = blocks_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  const uint16_t* h = (const uint16_t*)table;
  const float* f = (const float*)table;
  if (g.channels == 1 && bf16)
    brick3_kernel<1, uint16_t><<<b, kThreads, 0, s>>>(h, qx, qy, qz, out, n, g);
  else if (g.channels == 2 && bf16)
    brick3_kernel<2, uint16_t><<<b, kThreads, 0, s>>>(h, qx, qy, qz, out, n, g);
  else if (g.channels == 1)
    brick3_kernel<1, float><<<b, kThreads, 0, s>>>(f, qx, qy, qz, out, n, g);
  else if (g.channels == 2)
    brick3_kernel<2, float><<<b, kThreads, 0, s>>>(f, qx, qy, qz, out, n, g);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// table: [n_bricks, C*L] f32 (bf16 must be 0; L = by*bx), lanes
// channel-major blocks of y*bx + x; geom: h, w, by, bx, sy, sx, nx, C,
// clamp; qu, qv: contiguous f32 planes; out: [n, C] f32.
extern "C" int cs_sample_brick2(const void* table, int bf16, const int* geom,
                                const float* qu, const float* qv, float* out,
                                long long n, void* stream) {
  if (n <= 0) return 0;
  const Brick2 g{geom[0], geom[1], geom[2], geom[3], geom[4],
                 geom[5], geom[6], geom[7], geom[8]};
  if (bf16 || !positive(geom, 8) || g.sy > g.by - 1 || g.sx > g.bx - 1)
    return (int)cudaErrorInvalidValue;
  const unsigned b = blocks_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  const float* f = (const float*)table;
  if (g.channels == 2)
    brick2_kernel<2, float><<<b, kThreads, 0, s>>>(f, qu, qv, out, n, g);
  else if (g.channels == 8)
    brick2_kernel<8, float><<<b, kThreads, 0, s>>>(f, qu, qv, out, n, g);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// row: [C * d*h*w] f32 or bfloat16, channel-major, texels (z*h + y)*w + x;
// geom: d, h, w, C; modular wrap; qx, qy, qz: contiguous f32 planes; out:
// [n, C] f32.
extern "C" int cs_sample_tiny3(const void* row, int bf16, const int* geom,
                               const float* qx, const float* qy, const float* qz,
                               float* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const Tiny3 g{geom[0], geom[1], geom[2], geom[3]};
  if (!positive(geom, 4)) return (int)cudaErrorInvalidValue;
  const unsigned b = blocks_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  const uint16_t* h = (const uint16_t*)row;
  const float* f = (const float*)row;
  if (g.channels == 1 && bf16)
    tiny3_kernel<1, uint16_t><<<b, kThreads, 0, s>>>(h, qx, qy, qz, out, n, g);
  else if (g.channels == 2 && bf16)
    tiny3_kernel<2, uint16_t><<<b, kThreads, 0, s>>>(h, qx, qy, qz, out, n, g);
  else if (g.channels == 1)
    tiny3_kernel<1, float><<<b, kThreads, 0, s>>>(f, qx, qy, qz, out, n, g);
  else if (g.channels == 2)
    tiny3_kernel<2, float><<<b, kThreads, 0, s>>>(f, qx, qy, qz, out, n, g);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
