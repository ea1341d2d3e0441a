// K7–K9: filtered fetches from the engine's textures and brick tables, for
// Hopper (sm_90a).
//
// Replaces no pallas_call: the JAX package leaves these to XLA's gather and
// a lane-weight reduce (cloudscape_tpu/ops/brick.py):
//
//   K7 sample_brick3_xyz (:282): trilinear fetch, repeat or clamp wrap;
//   K8 sample_brick2_xy (:323): bilinear fetch;
//   K9 sample_tiny3_xyz (:351): trilinear fetch, modular wrap, from a whole
//      volume of <= 128 values held as one channel-major row.
//
// K7 and K8 have two forms here. The engine's tables are channel-last
// textures ([D, H, W, C] or [H, W, C], contiguous), sampled by tex3_kernel
// (K7) and tex2_kernel (K8). brick3_kernel and brick2_kernel sample the
// JAX package's brick tables ([n_bricks, C*L], L = 64 or 128 lanes a
// channel, texels repeated where bricks overlap), which the public
// sample_brick*_xyz API still takes.
//
// Bound: bytes. A sample reads 12 B of coordinates (8 B in 2-D), writes
// 4*C B and weighs 8 texels (4 in 2-D) of C channels. On a texture a
// corner's C channels are C*4 contiguous bytes (a 32-B sector for 8-ch
// f32), the x pair lies in one or two sectors, and the texels are stored
// once. In a brick row a corner's channels lie 64 or 256 B apart, so an
// 8-ch sample costs 32 scattered sectors, and overlapping bricks store a
// texel up to (16/9)x (2-D) or 2.03x (the (7, 3, 3) cone cache).
//
// Design: one thread per sample reads only the texels that carry weight
// through the read-only path (__ldg), weighs and sums them in registers
// and writes its C channels: no rows, weights or chunks are materialised.
// The texture kernels load a corner's channels as one vector (float4 pair
// for 8 channels, float2 or one 32-bit word of two bfloat16 for 2, a
// scalar for 1) and store a sample's outputs as one vector (two float4 for
// 8 channels, a float2 for 2), so a warp's stores cover contiguous bytes;
// the texture and the output must be 16-B aligned. Neighbouring threads
// take neighbouring samples (blocks of 256). The index math is 32-bit (a
// 64-bit division is a long software routine on the card); the channel
// count and texel type are template arguments, compiled only for the pairs
// the tables use (below); a bfloat16 texel is widened to f32 (exact)
// before the product, as torch's type promotion does in the plain version.
//
// K9 (tiny3_kernel) samples a whole volume of <= 128 values (the noise
// mips' 4^3, 2^3 and 1^3 levels). Its row, 512 B at most, stays in L1, so
// its bound is the stream: 12 B of coordinates in and 4*C B out a sample.
// Its first form (one sample a thread, dims at run time) took the same time
// on a 1^3 volume as on a 4^3 one, 0.37 of that bound on an H100: the index
// math set its pace, six runtime 32-bit modulos a sample (a software
// division each), not the texels. So the dims are template arguments for
// 4^3, 2^3 and 1^3, where each wrap is a mask of a power of two, with one
// instantiation of runtime dims for any other shape; and a thread takes 4
// samples, its planes read and its outputs written as float4 (one at a time
// where a plane is not 16-B aligned, and in the ragged tail). The row is
// read through __ldg: staging it in shared memory once a block timed the
// same within the runs' spread, and would cap the row's size.
//
// The arithmetic is the plain version's, step by step:
//   - cx = q*n - 0.5 rounds the product and then the difference: written
//     with __fmul_rn / __fsub_rn, which nvcc never contracts into an FMA
//     (a contracted q*n - 0.5 would move f and, at a texel boundary, i0);
//   - the hat weights are max(0, 1 - |a - lane|) with a = float(l0) + f
//     rounded (so not exactly 1 - f and f), for lanes l0 and l0 + 1. In a
//     brick table l0 is i0's lane in its brick; a texture takes l0 = i0
//     mod s, s the brick stride of the JAX package's table of the same
//     channel count, which the caller passes in geom (ops/brick.py's
//     WEIGHT_STRIDES), so a texture's sample equals the brick table's
//     bitwise and JAX's within a few ulps. K9 takes 1 - f at i0 and
//     f at (i0 + 1) % n, summed where the two coincide (n = 1);
//   - repeat wrap is a floor modulo of i0 (32-bit, and 64-bit as the plain
//     version's int64 past 2^31); clamp wrap sets f = 0 below the volume
//     and f = 1 past n - 2 and clamps i0 to [0, n - 2]. The second texel is
//     i0 + 1, or past the edge n - 1 (clamp) or 0 (repeat);
//   - each corner is ((wx * wy) * wz) * texel, and a channel's 8 corners
//     are summed from 0 in corner order (z, then y, then x). The texture
//     and tiny plain versions do the same, so they and the kernels agree
//     bitwise; the brick tables' plain version sums all 128 lanes with
//     torch.sum in another tree, within a few ulps. That plain version
//     multiplies every lane, so a non-finite texel anywhere in the row
//     would make its sample NaN; the tables are finite, and the kernels
//     read only the corners.

#include <cuda_runtime.h>
#include <stdint.h>

// axis_coords, hat and the texture fetch (tex_axis, weigh_texels), which
// K12 (composite.cu) shares.
#include "texture.cuh"

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

// Each of the kC channels' kK corners of one brick row, weighted and
// summed in corner order, written to out[0, kC).
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

// ---- whole tiny volumes (K9 tiny3_kernel) --------------------------------

// Samples a K9 thread takes: one float4 of each coordinate plane in, one
// float4 of output (two for 2 channels) out.
constexpr int kTinyPer = 4;

struct Tiny3 {
  int d, h, w, channels;
  int vec;  // planes and output 16-B aligned: float4 loads and stores
};

// One K9 axis of n texels: lanes i0 and (i0 + 1) mod n, weights 1 - f and
// f; an n = 1 axis reads lane 0 twice, weighing (1 - f) + f and 0. kN > 0
// is n at compile time, a power of two: the floor modulo is then the low
// bits of the two's-complement index (64-bit past 2^31, as the plain
// version's int64). kN = 0 takes n at run time and axis_coords' modulo.
template <int kN>
__device__ __forceinline__ void tiny_axis(float q, int n, int idx[2], float w[2]) {
  float f;
  if constexpr (kN > 0) {
    static_assert((kN & (kN - 1)) == 0, "compile-time dims are powers of two");
    constexpr int m = kN - 1;
    n = kN;
    const float cx = __fsub_rn(__fmul_rn(q, (float)kN), 0.5f);
    const float i0f = floorf(cx);
    f = __fsub_rn(cx, i0f);
    if (fabsf(i0f) < 2147483648.0f)
      idx[0] = (int)i0f & m;
    else
      idx[0] = (int)((long long)i0f & m);
    idx[1] = (idx[0] + 1) & m;
  } else {
    axis_coords(q, n, 0, idx[0], f);
    idx[1] = idx[0] + 1 < n ? idx[0] + 1 : 0;
  }
  if (n == 1) {
    w[0] = __fadd_rn(__fsub_rn(1.0f, f), f);
    w[1] = 0.0f;
  } else {
    w[0] = __fsub_rn(1.0f, f);
    w[1] = f;
  }
}

// One K9 sample's kC channels: 8 corners weighed ((wx * wy) * wz) and
// summed from 0 in corner order (z, then y, then x).
template <int kC, int kD, int kH, int kW, typename T>
__device__ __forceinline__ void tiny_sample(const T* row, const Tiny3& g, float qx,
                                            float qy, float qz, float* o) {
  const int h = kH ? kH : g.h, w = kW ? kW : g.w;
  const int L = (kD ? kD : g.d) * h * w;
  int xi[2], yi[2], zi[2];
  float wx[2], wy[2], wz[2];
  tiny_axis<kW>(qx, g.w, xi, wx);
  tiny_axis<kH>(qy, g.h, yi, wy);
  tiny_axis<kD>(qz, g.d, zi, wz);
  int off[8];
  float wk[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
    off[k] = (zi[dz] * h + yi[dy]) * w + xi[dx];
    wk[k] = __fmul_rn(__fmul_rn(wx[dx], wy[dy]), wz[dz]);
  }
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      acc = __fadd_rn(acc, __fmul_rn(wk[k], texel(row + c * L + off[k])));
    o[c] = acc;
  }
}

// K9: kTinyPer samples a thread, the planes read and the output written as
// float4 where g.vec and the thread's samples are all in range (else one
// sample at a time, the ragged tail included). kD, kH, kW: the volume's
// dims, or 0 for the runtime dims of g.
template <int kC, typename T, int kD, int kH, int kW>
__global__ void __launch_bounds__(kThreads)
tiny3_kernel(const T* __restrict__ row, const float* __restrict__ qx,
             const float* __restrict__ qy, const float* __restrict__ qz,
             float* __restrict__ out, long long n, Tiny3 g) {
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * kTinyPer;
  if (i >= n) return;
  const bool vec = g.vec && i + kTinyPer <= n;
  float x[kTinyPer], y[kTinyPer], z[kTinyPer];
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(qx + i));
    const float4 b = __ldg(reinterpret_cast<const float4*>(qy + i));
    const float4 c = __ldg(reinterpret_cast<const float4*>(qz + i));
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    y[0] = b.x; y[1] = b.y; y[2] = b.z; y[3] = b.w;
    z[0] = c.x; z[1] = c.y; z[2] = c.z; z[3] = c.w;
  } else {
#pragma unroll
    for (int j = 0; j < kTinyPer; ++j) {
      const long long k = i + j < n ? i + j : i;
      x[j] = __ldg(qx + k);
      y[j] = __ldg(qy + k);
      z[j] = __ldg(qz + k);
    }
  }
  float o[kTinyPer][kC];
#pragma unroll
  for (int j = 0; j < kTinyPer; ++j)
    tiny_sample<kC, kD, kH, kW>(row, g, x[j], y[j], z[j], o[j]);
  if (vec) {
    float4* v = reinterpret_cast<float4*>(out + i * kC);
    if constexpr (kC == 1) {
      v[0] = make_float4(o[0][0], o[1][0], o[2][0], o[3][0]);
    } else {
      v[0] = make_float4(o[0][0], o[0][1], o[1][0], o[1][1]);
      v[1] = make_float4(o[2][0], o[2][1], o[3][0], o[3][1]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kTinyPer; ++j) {
      if (i + j >= n) break;
#pragma unroll
      for (int c = 0; c < kC; ++c) out[(i + j) * kC + c] = o[j][c];
    }
  }
}

// Launches K9 on the instantiation of the volume's dims: 4^3, 2^3 and 1^3
// (the noise mips' tiny levels) at compile time, any other at run time.
template <int kC, typename T>
void launch_tiny3(const T* row, const float* qx, const float* qy, const float* qz,
                  float* out, long long n, const Tiny3& g, cudaStream_t s) {
  const long long per_block = (long long)kThreads * kTinyPer;
  const unsigned b = (unsigned)((n + per_block - 1) / per_block);
  if (g.d == 4 && g.h == 4 && g.w == 4)
    tiny3_kernel<kC, T, 4, 4, 4><<<b, kThreads, 0, s>>>(row, qx, qy, qz, out, n, g);
  else if (g.d == 2 && g.h == 2 && g.w == 2)
    tiny3_kernel<kC, T, 2, 2, 2><<<b, kThreads, 0, s>>>(row, qx, qy, qz, out, n, g);
  else if (g.d == 1 && g.h == 1 && g.w == 1)
    tiny3_kernel<kC, T, 1, 1, 1><<<b, kThreads, 0, s>>>(row, qx, qy, qz, out, n, g);
  else
    tiny3_kernel<kC, T, 0, 0, 0><<<b, kThreads, 0, s>>>(row, qx, qy, qz, out, n, g);
}

// ---- channel-last textures (K7 tex3_kernel, K8 tex2_kernel) -------------

// K7 on a texture.
template <int kC, typename T>
__global__ void __launch_bounds__(kThreads)
tex3_kernel(const T* __restrict__ tex, const float* __restrict__ qx,
            const float* __restrict__ qy, const float* __restrict__ qz,
            float* __restrict__ out, long long n, Tex g) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int xi[2], yi[2], zi[2];
  float wx[2], wy[2], wz[2];
  tex_axis(__ldg(qx + i), g.w, g.clamp, g.sx, xi, wx);
  tex_axis(__ldg(qy + i), g.h, g.clamp, g.sy, yi, wy);
  tex_axis(__ldg(qz + i), g.d, g.clamp, g.sz, zi, wz);
  int off[8];
  float w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {  // corner order: z, then y, then x
    const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
    off[k] = (zi[dz] * g.h + yi[dy]) * g.w + xi[dx];
    w[k] = __fmul_rn(__fmul_rn(wx[dx], wy[dy]), wz[dz]);
  }
  weigh_texels<kC, 8>(tex, off, w, out + i * kC);
}

// K8 on a texture.
template <int kC, typename T>
__global__ void __launch_bounds__(kThreads)
tex2_kernel(const T* __restrict__ tex, const float* __restrict__ qu,
            const float* __restrict__ qv, float* __restrict__ out, long long n, Tex g) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int xi[2], yi[2];
  float wx[2], wy[2];
  tex_axis(__ldg(qu + i), g.w, g.clamp, g.sx, xi, wx);
  tex_axis(__ldg(qv + i), g.h, g.clamp, g.sy, yi, wy);
  int off[4];
  float w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // corner order: y, then x
    const int dy = k >> 1, dx = k & 1;
    off[k] = yi[dy] * g.w + xi[dx];
    w[k] = __fmul_rn(wx[dx], wy[dy]);
  }
  weigh_texels<kC, 4>(tex, off, w, out + i * kC);
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

bool positive(const int* v, int k) {
  for (int j = 0; j < k; ++j)
    if (v[j] < 1) return false;
  return true;
}

// The texture geometry from geom (d, h, w, C, clamp, sz, sy, sx), or false
// if it is not one: dims and strides >= 1, the texture's values inside
// 32-bit indices, the texture and output 16-B aligned.
bool tex_geom(const int* geom, const void* tex, const float* out, Tex& g) {
  g = Tex{geom[0], geom[1], geom[2], geom[4], geom[5], geom[6], geom[7]};
  if (!positive(geom, 4) || !positive(geom + 5, 3) || (g.clamp != 0 && g.clamp != 1))
    return false;
  if ((long long)g.d * g.h * g.w * geom[3] >= (1LL << 31)) return false;
  return (reinterpret_cast<uintptr_t>(tex) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
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
// [n, C] f32. Planes and output at any 4-B alignment (float4 where all
// are 16-B aligned).
extern "C" int cs_sample_tiny3(const void* row, int bf16, const int* geom,
                               const float* qx, const float* qy, const float* qz,
                               float* out, long long n, void* stream) {
  if (n <= 0) return 0;
  if (!positive(geom, 4)) return (int)cudaErrorInvalidValue;
  const uintptr_t any = reinterpret_cast<uintptr_t>(qx) | reinterpret_cast<uintptr_t>(qy)
                        | reinterpret_cast<uintptr_t>(qz) | reinterpret_cast<uintptr_t>(out);
  const Tiny3 g{geom[0], geom[1], geom[2], geom[3], any % 16 == 0};
  cudaStream_t s = (cudaStream_t)stream;
  const uint16_t* h = (const uint16_t*)row;
  const float* f = (const float*)row;
  if (g.channels == 1 && bf16)
    launch_tiny3<1>(h, qx, qy, qz, out, n, g, s);
  else if (g.channels == 2 && bf16)
    launch_tiny3<2>(h, qx, qy, qz, out, n, g, s);
  else if (g.channels == 1)
    launch_tiny3<1>(f, qx, qy, qz, out, n, g, s);
  else if (g.channels == 2)
    launch_tiny3<2>(f, qx, qy, qz, out, n, g, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// tex: [d, h, w, C] f32 (bf16 = 0) or bfloat16 (bf16 = 1), contiguous and
// 16-B aligned, under 2^31 values; geom: d, h, w, C, clamp (0 repeat, 1
// clamp), and the weight strides sz, sy, sx; qx, qy, qz: contiguous f32
// planes of n samples; out: [n, C] f32, 16-B aligned.
extern "C" int cs_sample_tex3(const void* tex, int bf16, const int* geom,
                              const float* qx, const float* qy, const float* qz,
                              float* out, long long n, void* stream) {
  if (n <= 0) return 0;
  Tex g;
  if (!tex_geom(geom, tex, out, g)) return (int)cudaErrorInvalidValue;
  const unsigned b = blocks_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  const uint16_t* h = (const uint16_t*)tex;
  const float* f = (const float*)tex;
  const int channels = geom[3];
  if (channels == 1 && bf16)
    tex3_kernel<1, uint16_t><<<b, kThreads, 0, s>>>(h, qx, qy, qz, out, n, g);
  else if (channels == 2 && bf16)
    tex3_kernel<2, uint16_t><<<b, kThreads, 0, s>>>(h, qx, qy, qz, out, n, g);
  else if (channels == 1)
    tex3_kernel<1, float><<<b, kThreads, 0, s>>>(f, qx, qy, qz, out, n, g);
  else if (channels == 2)
    tex3_kernel<2, float><<<b, kThreads, 0, s>>>(f, qx, qy, qz, out, n, g);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// tex: [h, w, C] f32 (bf16 must be 0), contiguous and 16-B aligned; geom:
// h, w, C, clamp, sy, sx (as cs_sample_tex3's); qu, qv: contiguous f32
// planes; out: [n, C] f32, 16-B aligned.
extern "C" int cs_sample_tex2(const void* tex, int bf16, const int* geom,
                              const float* qu, const float* qv, float* out,
                              long long n, void* stream) {
  if (n <= 0) return 0;
  const int g3[8] = {1, geom[0], geom[1], geom[2], geom[3], 1, geom[4], geom[5]};
  Tex g;
  if (bf16 || !tex_geom(g3, tex, out, g)) return (int)cudaErrorInvalidValue;
  const unsigned b = blocks_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  const float* f = (const float*)tex;
  if (geom[2] == 2)
    tex2_kernel<2, float><<<b, kThreads, 0, s>>>(f, qu, qv, out, n, g);
  else if (geom[2] == 8)
    tex2_kernel<8, float><<<b, kThreads, 0, s>>>(f, qu, qv, out, n, g);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
