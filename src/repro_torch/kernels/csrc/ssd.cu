// Mamba-2 chunked SSD scan (state-space duality) for sm_90a.
//
// Replaces the TPU kernel repro/kernels/ssd.py (ssd / _ssd_kernel): the same
// function -- per head h of group g = h / (H / G), with a_t = dt_t * A_h and
// acum the running sum of a over a chunk,
//   y_l   = sum_{m <= l} (C_l . B_m) exp(clip(acum_l - acum_m, -60, 0)) dt_m x_m
//           + exp(acum_l) C_l h
//   h_new = exp(acum_end) h + sum_m B_m (dt_m exp(clip(acum_end - acum_m, -60)))
//           x_m^T
// chunk after chunk, all math in fp32 -- but laid out for this card.
//
// What bounds it here: operations.  The reference algorithm at chunk 256
// does per head S((c+1)P + 4NP) flops plus S(c+1)N per group on inputs of
// S(P + 2N) elements: about 4.9 GFLOP against 41 MB for the served mamba2
// prefill (S = 2048, H = 48, P = 64, N = 128), and the reference asks for
// fp32 math, so the peak is the CUDA cores' 67 TFLOP/s, not the tensor
// cores'.
//
// What the design does about it:
//   * The TPU kernel keeps a chunk of all H heads (~30 MB at c = 256) in
//     VMEM; no SM holds that.  Here one block owns one (batch, head) and
//     walks the sequence in sub-chunks of L = 64 steps, keeping the (N, P)
//     fp32 state (32 KB at N = 128, P = 64) in shared memory for the whole
//     sequence beside the sub-chunk's x, B, C tiles and the (L, L) weights.
//     SSD results do not depend on the chunk length beyond rounding (the
//     duality); the -60 clip then differs only where a decay is below e^-60.
//   * Every product is register-tiled on the CUDA cores (4 x 4 outputs a
//     thread, operands as 16-byte shared-memory loads from padded rows), so
//     fp32 never rounds through TF32.  The (L, L) weight tile skips the
//     tiles above the diagonal, and the intra-chunk product stops at the
//     diagonal.
//   * Positions >= S act as dt = 0 (zero input, decay 1): the state passes
//     through them unchanged, as the reference's own padding does, so any S
//     is legal -- a superset of the TPU kernel, which asserts S % chunk == 0.
//   * G > 1 works: a block reads the B/C rows of its head's group.
//   * At batch 1 the served shape gives only H = 48 blocks for 132 SMs;
//     splitting a head's P columns over blocks is later work.

#include "common.cuh"

namespace {

using namespace repro;

constexpr int SSD_L = 64;    // sub-chunk length
constexpr int SSD_NT = 256;  // threads per block: 16 x 16 tiles of 4 x 4

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

int smem_bytes(int P, int N) {
  constexpr int L = SSD_L;
  return (int)sizeof(float) *
         (L * (P + 4) + 2 * L * (N + 4) + L * (L + 4) + N * (P + 4) + 2 * L);
}

template <typename T>
__global__ void __launch_bounds__(SSD_NT)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ h0,
           float* __restrict__ y, float* __restrict__ hout, int S, int H,
           int P, int G, int N) {
  constexpr int L = SSD_L;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const int LDX = P + 4, LDN = N + 4, LDW = L + 4, LDH = P + 4;
  const int CQ = P / 4;  // column quads of x, y and the state

  extern __shared__ __align__(16) float sm[];
  float* Xs = sm;             // (L, P)  this sub-chunk's x
  float* Bs = Xs + L * LDX;   // (L, N)  its B rows (later scaled in place)
  float* Cs = Bs + L * LDN;   // (L, N)  its C rows
  float* Ws = Cs + L * LDN;   // (L, L)  intra-chunk weights
  float* Hs = Ws + L * LDW;   // (N, P)  the carried state
  float* dts = Hs + N * LDH;  // (L,)
  float* acs = dts + L;       // (L,)   running sum of dt * A

  const int tid = threadIdx.x;
  const float a_h = A[h];
  const size_t hoff = ((size_t)b * H + h) * (size_t)N * P;
  for (int i = tid; i < N * P; i += SSD_NT)
    Hs[(i / P) * LDH + i % P] = h0 != nullptr ? h0[hoff + i] : 0.f;

  for (int c0 = 0; c0 < S; c0 += L) {
    const int live = min(L, S - c0);
    __syncthreads();  // the previous sub-chunk is done with every tile
    for (int i = tid; i < L * P; i += SSD_NT) {
      const int l = i / P, p = i % P;
      Xs[l * LDX + p] =
          l < live ? as_float(x[(((size_t)b * S + c0 + l) * H + h) * P + p])
                   : 0.f;
    }
    for (int i = tid; i < L * N; i += SSD_NT) {
      const int l = i / N, n = i % N;
      const size_t o = (((size_t)b * S + c0 + l) * G + g) * N + n;
      Bs[l * LDN + n] = l < live ? as_float(Bm[o]) : 0.f;
      Cs[l * LDN + n] = l < live ? as_float(Cm[o]) : 0.f;
    }
    if (tid < L)
      dts[tid] = tid < live ? dt[((size_t)b * S + c0 + tid) * H + h] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int l = 0; l < L; ++l) {
        s += dts[l] * a_h;
        acs[l] = s;
      }
    }
    __syncthreads();

    // ---- W[l][m] = (C_l . B_m) * decay(l, m) * dt_m for m <= l ----
    {
      const int ti = tid >> 4, tj = tid & 15;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      if (tj <= ti) {
        for (int n = 0; n < N; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            cv[i] = *reinterpret_cast<const float4*>(Cs + (ti * 4 + i) * LDN + n);
            bv[i] = *reinterpret_cast<const float4*>(Bs + (tj * 4 + i) * LDN + n);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[i][j] += cv[i].x * bv[j].x;
              acc[i][j] += cv[i].y * bv[j].y;
              acc[i][j] += cv[i].z * bv[j].z;
              acc[i][j] += cv[i].w * bv[j].w;
            }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int l = ti * 4 + i, m = tj * 4 + j;
          float w = 0.f;
          if (m <= l) {
            const float d = fminf(fmaxf(acs[l] - acs[m], -60.f), 0.f);
            w = acc[i][j] * expf(d) * dts[m];
          }
          Ws[l * LDW + m] = w;
        }
    }
    __syncthreads();

    // ---- y = W x + exp(acum) C h (the state before this sub-chunk) ----
    for (int u = tid; u < (L / 4) * CQ; u += SSD_NT) {
      const int ti = u / CQ, p0 = (u % CQ) * 4;
      float yi[4][4], yc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yi[i][j] = yc[i][j] = 0.f;
      const int m_end = min(ti * 4 + 4, live);  // W is 0 past the diagonal
      for (int m = 0; m < m_end; ++m) {
        const float4 xv = *reinterpret_cast<const float4*>(Xs + m * LDX + p0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w = Ws[(ti * 4 + i) * LDW + m];
          yi[i][0] += w * xv.x;
          yi[i][1] += w * xv.y;
          yi[i][2] += w * xv.z;
          yi[i][3] += w * xv.w;
        }
      }
      for (int n = 0; n < N; ++n) {
        const float4 hv = *reinterpret_cast<const float4*>(Hs + n * LDH + p0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float c = Cs[(ti * 4 + i) * LDN + n];
          yc[i][0] += c * hv.x;
          yc[i][1] += c * hv.y;
          yc[i][2] += c * hv.z;
          yc[i][3] += c * hv.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = ti * 4 + i;
        if (l < live) {
          const float e = expf(acs[l]);
          *reinterpret_cast<float4*>(
              y + (((size_t)b * S + c0 + l) * H + h) * P + p0) =
              make_float4(yi[i][0] + e * yc[i][0], yi[i][1] + e * yc[i][1],
                          yi[i][2] + e * yc[i][2], yi[i][3] + e * yc[i][3]);
        }
      }
    }
    __syncthreads();  // every reader of the old state is done

    // ---- B_m *= dt_m * exp(clip(acum_end - acum_m, -60)) ----
    const float a_end = acs[L - 1];
    for (int i = tid; i < live * N; i += SSD_NT) {
      const int l = i / N, n = i % N;
      Bs[l * LDN + n] *= dts[l] * expf(fmaxf(a_end - acs[l], -60.f));
    }
    __syncthreads();

    // ---- h = exp(acum_end) h + sum_m B_m x_m^T (each thread its tile) ----
    const float e_end = expf(a_end);
    for (int u = tid; u < (N / 4) * CQ; u += SSD_NT) {
      const int n0 = (u / CQ) * 4, p0 = (u % CQ) * 4;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int m = 0; m < live; ++m) {
        const float4 bv = *reinterpret_cast<const float4*>(Bs + m * LDN + n0);
        const float4 xv = *reinterpret_cast<const float4*>(Xs + m * LDX + p0);
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] += bb[i] * xv.x;
          acc[i][1] += bb[i] * xv.y;
          acc[i][2] += bb[i] * xv.z;
          acc[i][3] += bb[i] * xv.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4* hp = reinterpret_cast<float4*>(Hs + (n0 + i) * LDH + p0);
        const float4 hv = *hp;
        *hp = make_float4(e_end * hv.x + acc[i][0], e_end * hv.y + acc[i][1],
                          e_end * hv.z + acc[i][2], e_end * hv.w + acc[i][3]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += SSD_NT)
    hout[hoff + i] = Hs[(i / P) * LDH + i % P];
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* h0, float* y, float* hout, int B,
           int S, int H, int P, int G, int N, cudaStream_t stream) {
  const int bytes = smem_bytes(P, N);
  static int configured = 0;
  if (bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    configured = bytes;
  }
  ssd_kernel<T><<<dim3(H, B), SSD_NT, bytes, stream>>>(
      (const T*)x, dt, A, (const T*)Bm, (const T*)Cm, h0, y, hout, S, H, P, G,
      N);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, S, H, P) and B/C (B, S, G, N) in one dtype (fp32 or bf16); dt
// (B, S, H), A (H,), h0 (B, H, N, P) or null, y (B, S, H, P) and hout
// (B, H, N, P) fp32; all contiguous.  Returns 0, a cudaError_t, or
// ERR_UNSUPPORTED.  Does not synchronise.
extern "C" int repro_ssd_fwd(const void* x, const float* dt, const float* A,
                             const void* Bm, const void* Cm, const float* h0,
                             float* y, float* hout, int B, int S, int H, int P,
                             int G, int N, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P < 4 ||
      P % 4 != 0 || N < 4 || N % 4 != 0 || B > 65535 ||
      smem_bytes(P, N) > 232448)
    return ERR_UNSUPPORTED;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return launch<float>(x, dt, A, Bm, Cm, h0, y, hout, B, S, H, P, G, N, st);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, y, hout, B, S, H, P, G,
                                 N, st);
  return ERR_UNSUPPORTED;
}
