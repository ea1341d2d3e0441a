// The bilinear and trilinear texel fetch of csrc/sample.cu's texture kernels
// (K7 tex3_kernel, K8 tex2_kernel), shared with csrc/composite.cu (K12),
// whose two display-pair fetches are K8's fetch bit for bit. sample.cu's
// header says why each step rounds as it does.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

struct Tex {
  int d, h, w;     // dims (d = 1 in 2-D)
  int clamp;       // 0: repeat, 1: clamp
  int sz, sy, sx;  // the strides at which the hat weights are rounded
};

// One axis of a texture: texels i0 and i0 + 1 (past the edge n - 1 under
// clamp, 0 under repeat) and their hat weights, rounded at lane i0 mod s.
__device__ __forceinline__ void tex_axis(float q, int n, int clamp, int s, int idx[2],
                                         float w[2]) {
  float f;
  axis_coords(q, n, clamp, idx[0], f);
  idx[1] = idx[0] + 1 < n ? idx[0] + 1 : (clamp ? n - 1 : 0);
  hat((int)((unsigned)idx[0] % (unsigned)s), f, w);
}

// The kC channels of one texel as f32, in one load: a scalar, a float2, a
// 32-bit word of two bfloat16 (channel 0 in its low half), or two float4.
template <int kC, typename T> struct Texel;
template <> struct Texel<1, float> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
};
template <> struct Texel<2, float> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x;
    v[1] = a.y;
  }
};
template <> struct Texel<8, float> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};
template <> struct Texel<1, uint16_t> {
  static __device__ __forceinline__ void load(const uint16_t* p, float* v) {
    v[0] = texel(p);
  }
};
template <> struct Texel<2, uint16_t> {
  static __device__ __forceinline__ void load(const uint16_t* p, float* v) {
    const uint32_t b = __ldg(reinterpret_cast<const unsigned int*>(p));
    v[0] = __uint_as_float(b << 16);
    v[1] = __uint_as_float(b & 0xffff0000u);
  }
};

// A sample's kC outputs in one store.
template <int kC>
__device__ __forceinline__ void store(float* out, const float* v) {
  if constexpr (kC == 8) {
    reinterpret_cast<float4*>(out)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(out)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else if constexpr (kC == 2) {
    *reinterpret_cast<float2*>(out) = make_float2(v[0], v[1]);
  } else {
    out[0] = v[0];
  }
}

// Each channel's kK corners, weighted and summed from 0 in corner order.
template <int kC, int kK, typename T>
__device__ __forceinline__ void weigh_texels(const T* tex, const int off[kK],
                                             const float w[kK], float* __restrict__ out) {
  float v[kK][kC];
#pragma unroll
  for (int k = 0; k < kK; ++k) Texel<kC, T>::load(tex + off[k] * kC, v[k]);
  float acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    acc[c] = 0.0f;
#pragma unroll
    for (int k = 0; k < kK; ++k) acc[c] = __fadd_rn(acc[c], __fmul_rn(w[k], v[k][c]));
  }
  store<kC>(out, acc);
}

}  // namespace
