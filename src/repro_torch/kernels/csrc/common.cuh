// Helpers shared by the hand-written kernels: element conversion and
// 16-byte vector loads that widen to float.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float NEG_INF = -1e30f;

// dtype codes of the plain C interface
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

// returned (instead of a cudaError_t) when the shape/dtype is not one the
// kernels are instantiated for
constexpr int ERR_UNSUPPORTED = -1;

// one 16-byte global load, kept as raw bits until it is used
__device__ __forceinline__ uint4 load_raw16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int VEC = 4;  // elements per 16-byte load
  static __device__ __forceinline__ void unpack(const uint4& x, float* out) {
    out[0] = __uint_as_float(x.x); out[1] = __uint_as_float(x.y);
    out[2] = __uint_as_float(x.z); out[3] = __uint_as_float(x.w);
  }
  static __device__ __forceinline__ void load16(const float* p, float* out) {
    unpack(load_raw16(p), out);
  }
  static __device__ __forceinline__ float from_float(float x) { return x; }
  // probabilities are cast to V's dtype before the PV product
  static __device__ __forceinline__ float round_through(float x) { return x; }
};

template <> struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static __device__ __forceinline__ void unpack(const uint4& x, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                                float* out) {
    unpack(load_raw16(p), out);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
  static __device__ __forceinline__ float round_through(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

}  // namespace repro
