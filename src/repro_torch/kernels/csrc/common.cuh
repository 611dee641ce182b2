// Helpers shared by the hand-written kernels: element conversion,
// 16-byte vector loads that widen to float, a row copy into padded shared
// memory, and the warp-level tensor-core pieces of the bf16 kernels
// (mma.sync m16n8k16, ldmatrix, cp.async).
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

// the attention kernels' common shape limits (grid dimensions included)
inline bool shape_ok(int B, int S, int T, int H, int K) {
  return B > 0 && S > 0 && T > 0 && K > 0 && H % K == 0 && B <= 65535 &&
         K <= 65535;
}

// which design of an attention kernel serves a (head dim, dtype): the
// dispatch switches on it, and the C entry points *_design report it
constexpr int DESIGN_NONE = 0;        // not instantiated
constexpr int DESIGN_CUDA_CORES = 1;  // fp32, register-tiled
constexpr int DESIGN_MMA_SYNC = 2;    // bf16, warp-level mma.sync
constexpr int DESIGN_WGMMA = 3;       // bf16, warpgroup wgmma fed by TMA

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

// Copy `rows` rows of D elements (row i at base + row_offset(i)) into shared
// memory as floats, row i at dst + i * (D + 4) (the padding keeps 16-byte
// accesses and spreads a column over the banks); rows for which valid(i) is
// false are zero-filled.  All NTHREADS threads of the block take part.
template <typename T, int D, int NTHREADS, typename Off, typename Valid>
__device__ __forceinline__ void load_rows(float* dst, const T* base, int rows,
                                          Off row_offset, Valid valid) {
  constexpr int VEC = Elem<T>::VEC;
  constexpr int LD = D + 4;
  constexpr int VPR = D / VEC;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < rows * VPR; idx += NTHREADS) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * VEC;
    float x[VEC];
    if (valid(r)) {
      Elem<T>::load16(base + row_offset(r) + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      *reinterpret_cast<float4*>(dst + r * LD + c + e) =
          make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    }
  }
}

// ---- bf16 tensor cores, warp level ----

__device__ __forceinline__ void mma_m16n8k16(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed on the way into the fragments; lane l
// passes the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same without the transpose
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// asynchronous 16-byte copy global -> shared; `bytes` of them are read and
// the rest of the 16 are written as zeros (0 for a row past the end)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

}  // namespace repro
