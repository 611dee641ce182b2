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
// What bounds it here: operations on the CUDA cores, bytes on the tensor
// cores.  The chunked algorithm does about 3.4 GFLOP at its cheapest chunk
// length for the served mamba2 prefill (S = 2048, H = 48, P = 64, N = 128)
// against 41 MB of inputs and outputs; the reference asks for fp32 math, so
// on the CUDA cores the peak is 67 TFLOP/s (0.051 ms), while on the tensor
// cores, with the fp32 operands split as below, the same work is far under
// the time the bytes take (0.012 ms).
//
// The chunk-parallel design (repro_ssd_fwd; it replaced a serial design,
// one block per (batch, head) walking the sequence, whose time PERF.md
// keeps):
//   * Three launches from one call, on the caller's stream, over chunks of
//     SSD_C = 64 steps.  (a) ssd_state_*: one block per (head, chunk,
//     batch) -- 48 x 32 = 1536 blocks at the served shape, where the serial
//     design had 48 for 132 SMs -- computes the chunk's running sum of
//     dt * A (two warp scans) and its local state s_c = sum_m B_m (dt_m
//     exp(clip(acum_end - acum_m, -60))) x_m^T, an (N, P) fp32 array, into
//     a scratch tensor (B, chunks, H, N, P) that the wrapper allocates, and
//     acum_end into (B, chunks, H).  (b) ssd_pass_kernel: each of the N * P
//     elements of a head is an independent scalar recurrence h_c =
//     exp(acum_end) h_{c-1} + s_c; one thread owns four of them and walks
//     the chunks (98,304 threads at the served shape), overwriting each s_c
//     with the state entering chunk c and writing h_final.  (c)
//     ssd_output_*: one block per (head, chunk, batch) computes y = (C B^T o
//     decay o dt) x, causal inside the chunk, plus exp(acum_l) C_l h_c.
//     Every block runs the same arithmetic whatever order the blocks run in,
//     so two calls give bit-identical outputs.  A decoupled look-back
//     (stages a-c in one launch, chunk c waiting for chunk c-1's state) was
//     not taken: its chain of 32 dependent steps per head would serialise
//     on the latency of each hand-off, and the state traffic it saves
//     (4 x 50 MB, much of it in the 50 MB L2) is a few hundredths of a ms.
//     c = 64 rather than 128: twice the blocks, the output stage's shared
//     memory (81 KB) leaves two blocks per SM, and the causal half of C B^T
//     is skipped at a finer grain; the states cost twice the bytes.
//   * bf16 x, B, C at P and N multiples of 16 (the served path): every
//     product runs on the tensor cores with warp-level mma.sync (m16n8k16,
//     fp32 accumulate).  C B^T has two bf16 operands:
//     each product is exact in fp32, so it is fp32 math in another
//     summation order.  The products with one fp32 operand -- the weights W
//     times x, the scaled B times x, C times the state -- keep the bf16
//     operand exact and split the fp32 one into bf16 hi + lo (16
//     significant bits of its 24), one product each; the error left is
//     about 2^-17 of each fp32 operand (chip_smoke.py measures it against
//     the fp32 plain version).  W never leaves registers: the accumulator
//     layout of C B^T is the A-fragment layout of W x, as in the flash
//     kernels.  In the output stage two warps own 16 rows of the chunk
//     (each half the columns of P) and skip the key blocks above their
//     diagonal; eight warps a block, two blocks an SM.
//   * fp32 inputs (and bf16 at other P, N) keep fp32 math on the CUDA cores
//     in the same three stages: register tiles (4 x 4
//     outputs a thread, operands as 16-byte loads from padded shared
//     memory), so fp32 never rounds through TF32 or bf16.
//   * Positions >= S act as dt = 0 (zero input, decay 1): the state passes
//     through them unchanged, as the reference's own padding does, so any S
//     is legal -- a superset of the TPU kernel, which asserts S % chunk ==
//     0.  SSD results do not depend on the chunk length beyond rounding
//     (the duality); the -60 clip then differs only where a decay is below
//     e^-60.  Any G dividing H: a block reads its head's group's B/C rows.
//   * Left out: fusing the stages (above); Hopper's warpgroup products
//     (wgmma), which would speed the products, not the loads and the state
//     traffic that set the stages' times (PERF.md).


#include "common.cuh"

namespace {

using namespace repro;
using bf16 = __nv_bfloat16;

constexpr int SSD_C = 64;    // chunk length
constexpr int CC_NT = 256;   // CUDA-core blocks: 16 x 16 tiles of 4 x 4
constexpr int TC_NT = 256;   // tensor-core blocks: 8 warps
constexpr int PASS_NT = 128;
constexpr int MAX_SMEM = 232448;

// raise a kernel's dynamic shared-memory limit to `bytes` the first time a
// call needs more than it was given
template <typename KernelT>
int allow_smem(KernelT kernel, int bytes, int& configured) {
  if (bytes <= configured) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  configured = bytes;
  return 0;
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---------------------------------------------------------------------------
// a chunk on the CUDA cores, fp32 math: CC_NT threads, rows
// padded by 4 floats (16-byte loads, a column spread over the banks)
// ---------------------------------------------------------------------------

// dt of the chunk's steps (at: step 0's index in (B, S, H)); 0 past `live`
__device__ __forceinline__ void load_chunk_dt(float* dts, const float* dt,
                                              size_t at, int H, int live) {
  const int t = threadIdx.x;
  if (t < SSD_C) dts[t] = t < live ? dt[at + (size_t)t * H] : 0.f;
}

// Asynchronous 16-byte copies of SSD_C rows of `bytes_per_row` bytes (row
// r at src + r * stride bytes; rows and dst 16-byte aligned) into shared
// memory with a row stride of ld bytes; rows past `live` are zero-filled.
// All copies of the block are in flight together: the caller commits and
// waits (cp_async_commit, cp_async_wait<0>, __syncthreads).
__device__ __forceinline__ void copy_chunk_rows_async(
    void* dst, int ld, const void* src, size_t stride, int bytes_per_row,
    int live) {
  const int vpr = bytes_per_row / 16;
  for (int i = threadIdx.x; i < SSD_C * vpr; i += blockDim.x) {
    const int r = i / vpr, c = (i % vpr) * 16;
    cp_async16(static_cast<unsigned char*>(dst) + r * ld + c,
               static_cast<const unsigned char*>(src) +
                   (r < live ? r : 0) * stride + c,
               r < live ? 16 : 0);
  }
}

// SSD_C rows of `cols` elements (row r at src + r * stride) as floats into
// shared memory with row stride ld; rows past `live` are zero.  fp32 rows
// are copied asynchronously (the caller waits), bf16 rows widened here.
template <typename T>
__device__ __forceinline__ void load_chunk_rows(float* dst, int ld,
                                                const T* src, size_t stride,
                                                int cols, int live) {
  if constexpr (sizeof(T) == sizeof(float)) {
    copy_chunk_rows_async(dst, ld * 4, src, stride * 4, cols * 4, live);
  } else {
    for (int i = threadIdx.x; i < SSD_C * cols; i += blockDim.x) {
      const int r = i / cols, c = i % cols;
      dst[r * ld + c] = r < live ? as_float(src[r * stride + c]) : 0.f;
    }
  }
}

// W[l][m] = (C_l . B_m) exp(clip(acum_l - acum_m, -60, 0)) dt_m for m <= l
// and 0 above the diagonal: each of 16 x 16 threads its 4 x 4 tile, the
// tiles above the diagonal skipped
__device__ __forceinline__ void cc_weights(const float* Cs, const float* Bs,
                                           float* Ws, const float* dts,
                                           const float* acs, int N) {
  const int LDN = N + 4, LDW = SSD_C + 4;
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
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

// y_l = W_l x + exp(acum_l) C_l h for the rows l < live (row l at y + l *
// stride), h the (N, P) state entering the chunk
__device__ __forceinline__ void cc_outputs(const float* Xs, const float* Ws,
                                           const float* Cs, const float* Hs,
                                           const float* acs, float* y,
                                           size_t stride, int P, int N,
                                           int live) {
  const int LDX = P + 4, LDN = N + 4, LDW = SSD_C + 4, LDH = P + 4;
  const int CQ = P / 4;  // column quads of x, y and the state
  for (int u = threadIdx.x; u < (SSD_C / 4) * CQ; u += CC_NT) {
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
        *reinterpret_cast<float4*>(y + l * stride + p0) =
            make_float4(yi[i][0] + e * yc[i][0], yi[i][1] + e * yc[i][1],
                        yi[i][2] + e * yc[i][2], yi[i][3] + e * yc[i][3]);
      }
    }
  }
}

// B_m *= dt_m * exp(clip(acum_end - acum_m, -60)) for the rows m < live
__device__ __forceinline__ void cc_scale_b(float* Bs, const float* dts,
                                           const float* acs, int N,
                                           int live) {
  const int LDN = N + 4;
  const float a_end = acs[SSD_C - 1];
  for (int i = threadIdx.x; i < live * N; i += CC_NT) {
    const int m = i / N, n = i % N;
    Bs[m * LDN + n] *= dts[m] * expf(fmaxf(a_end - acs[m], -60.f));
  }
}

// dst (N, P; row stride ld) = [e * dst +] sum_{m < live} B_m x_m^T, B
// scaled by cc_scale_b: each thread its 4 x 4 tiles
__device__ __forceinline__ void cc_state_sum(const float* Bs,
                                             const float* Xs, float* dst,
                                             int ld, bool accumulate,
                                             float e, int P, int N,
                                             int live) {
  const int LDX = P + 4, LDN = N + 4;
  const int CQ = P / 4;
  for (int u = threadIdx.x; u < (N / 4) * CQ; u += CC_NT) {
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
      float4* d = reinterpret_cast<float4*>(dst + (size_t)(n0 + i) * ld + p0);
      float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      if (accumulate) {
        const float4 old = *d;
        v = make_float4(e * old.x + v.x, e * old.y + v.y, e * old.z + v.z,
                        e * old.w + v.w);
      }
      *d = v;
    }
  }
}

// shared memory of a chunk with its weights and state: x, B, C, W, the
// state, dt, acum (the output stage)
int cc_output_smem(int P, int N) {
  constexpr int L = SSD_C;
  return (int)sizeof(float) *
         (L * (P + 4) + 2 * L * (N + 4) + L * (L + 4) + N * (P + 4) + 2 * L);
}

// ---------------------------------------------------------------------------
// the chunk-parallel design: (a) and (c) on the CUDA cores
// ---------------------------------------------------------------------------

// acs[l] = sum_{i <= l} dts[i] * a for l < SSD_C: two warp scans, then the
// second warp adds the first's total.  Every thread of the block calls it
// (it synchronises); dts must be visible to all threads.
__device__ __forceinline__ void chunk_cumsum(const float* dts, float* acs,
                                             float a) {
  const int t = threadIdx.x;
  if (t < SSD_C) {
    float v = dts[t] * a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if ((t & 31) >= o) v += u;
    }
    acs[t] = v;
  }
  __syncthreads();
  if (t >= 32 && t < SSD_C) acs[t] += acs[31];
  __syncthreads();
}

int cc_state_smem(int P, int N) {
  return (int)sizeof(float) * (SSD_C * (P + 4) + SSD_C * (N + 4) + 2 * SSD_C);
}

template <typename T>
__global__ void __launch_bounds__(CC_NT)
ssd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 float* __restrict__ states, float* __restrict__ aend, int S,
                 int H, int P, int G, int N) {
  constexpr int L = SSD_C;
  const int h = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int c0 = j * L, live = min(L, S - c0);
  const int LDX = P + 4, LDN = N + 4;

  extern __shared__ __align__(16) float sm[];
  float* Xs = sm;             // (L, P)  the chunk's x
  float* Bs = Xs + L * LDX;   // (L, N)  its B rows, then scaled in place
  float* dts = Bs + L * LDN;  // (L,)
  float* acs = dts + L;       // (L,)   running sum of dt * A

  const size_t row0 = (size_t)b * S + c0;
  load_chunk_rows(Xs, LDX, x + (row0 * H + h) * P, (size_t)H * P, P, live);
  load_chunk_rows(Bs, LDN, Bm + (row0 * G + g) * N, (size_t)G * N, N, live);
  load_chunk_dt(dts, dt, row0 * H + h, H, live);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  chunk_cumsum(dts, acs, A[h]);
  cc_scale_b(Bs, dts, acs, N, live);
  __syncthreads();
  // s = sum_m B_m x_m^T from a zero state
  const size_t blk = ((size_t)b * gridDim.y + j) * H + h;
  cc_state_sum(Bs, Xs, states + blk * (size_t)N * P, P, false, 0.f, P, N,
               live);
  if (threadIdx.x == 0) aend[blk] = acs[L - 1];
}

template <typename T>
__global__ void __launch_bounds__(CC_NT)
ssd_output_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ states,
                  float* __restrict__ y, int S, int H, int P, int G, int N) {
  constexpr int L = SSD_C;
  const int h = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int c0 = j * L, live = min(L, S - c0);
  const int LDX = P + 4, LDN = N + 4, LDW = L + 4, LDH = P + 4;

  extern __shared__ __align__(16) float sm[];
  float* Xs = sm;             // (L, P)
  float* Bs = Xs + L * LDX;   // (L, N)
  float* Cs = Bs + L * LDN;   // (L, N)
  float* Ws = Cs + L * LDN;   // (L, L)  intra-chunk weights
  float* Hs = Ws + L * LDW;   // (N, P)  the state entering the chunk
  float* dts = Hs + N * LDH;  // (L,)
  float* acs = dts + L;       // (L,)

  const size_t row0 = (size_t)b * S + c0;
  load_chunk_rows(Xs, LDX, x + (row0 * H + h) * P, (size_t)H * P, P, live);
  load_chunk_rows(Bs, LDN, Bm + (row0 * G + g) * N, (size_t)G * N, N, live);
  load_chunk_rows(Cs, LDN, Cm + (row0 * G + g) * N, (size_t)G * N, N, live);
  load_chunk_dt(dts, dt, row0 * H + h, H, live);
  const float* hin =
      states + (((size_t)b * gridDim.y + j) * H + h) * (size_t)N * P;
  for (int i = threadIdx.x; i < N * P / 4; i += CC_NT)
    cp_async16(Hs + ((4 * i) / P) * LDH + (4 * i) % P, hin + 4 * i, 16);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  chunk_cumsum(dts, acs, A[h]);
  cc_weights(Cs, Bs, Ws, dts, acs, N);
  __syncthreads();
  cc_outputs(Xs, Ws, Cs, Hs, acs, y + (row0 * H + h) * P, (size_t)H * P, P,
             N, live);
}

// (b) state passing: h_c = exp(acum_end,c) h_{c-1} + s_c over the chunks,
// from h0 (or zero).  Each s_c is overwritten with the state entering chunk
// c; hout gets the last.  One thread per four elements of a head's (N, P)
// state; eight chunks' loads are issued before their updates.
__global__ void __launch_bounds__(PASS_NT)
ssd_pass_kernel(float* __restrict__ states, const float* __restrict__ aend,
                const float* __restrict__ h0, float* __restrict__ hout,
                int nc, int H, int NP) {
  constexpr int U = 8;
  const int i = blockIdx.x * PASS_NT + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (4 * i >= NP) return;
  const size_t head = ((size_t)b * H + h) * NP;
  float4 st = h0 != nullptr ? reinterpret_cast<const float4*>(h0 + head)[i]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = 0; j0 < nc; j0 += U) {
    float4 s[U];
    float e[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      e[u] = 0.f;
      if (j0 + u < nc) {
        const size_t blk = ((size_t)b * nc + j0 + u) * H + h;
        s[u] = reinterpret_cast<const float4*>(states + blk * NP)[i];
        e[u] = expf(aend[blk]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j0 + u < nc) {
        const size_t blk = ((size_t)b * nc + j0 + u) * H + h;
        reinterpret_cast<float4*>(states + blk * NP)[i] = st;
        st = make_float4(e[u] * st.x + s[u].x, e[u] * st.y + s[u].y,
                         e[u] * st.z + s[u].z, e[u] * st.w + s[u].w);
      }
    }
  }
  reinterpret_cast<float4*>(hout + head)[i] = st;
}

// ---------------------------------------------------------------------------
// (a) and (c) on the tensor cores: bf16 x, B, C; P and N multiples of 16
// ---------------------------------------------------------------------------

// (a, b) ~ hi + lo, each a bf16 pair: 16 significant bits of an fp32 value
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// rows padded by 8 bf16 (16 bytes): the 8 row addresses of an ldmatrix
// fall on distinct banks
int tc_state_smem(int P, int N) {
  return 3 * SSD_C * 4 + SSD_C * (P + 8) * 2 + 2 * SSD_C * (N + 8) * 2;
}
int tc_output_smem(int P, int N) {
  return 2 * SSD_C * 4 + SSD_C * (P + 8) * 2 + 2 * SSD_C * (N + 8) * 2 +
         2 * N * (P + 8) * 2;
}

__global__ void __launch_bounds__(TC_NT)
ssd_state_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ Bm,
                    float* __restrict__ states, float* __restrict__ aend,
                    int S, int H, int P, int G, int N) {
  constexpr int L = SSD_C;
  const int h = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int c0 = j * L, live = min(L, S - c0);
  const int LDX = P + 8, LDN = N + 8;

  extern __shared__ __align__(16) unsigned char smem[];
  float* dts = reinterpret_cast<float*>(smem);  // (L,)
  float* acs = dts + L;                         // (L,)
  float* ws = acs + L;                          // (L,) dt_m exp(...)
  bf16* Xs = reinterpret_cast<bf16*>(ws + L);   // (L, P)
  bf16* Bh = Xs + L * LDX;                      // (L, N) B, then hi(B w)
  bf16* Bl = Bh + L * LDN;                      // (L, N) lo(B w)

  const size_t row0 = (size_t)b * S + c0;
  copy_chunk_rows_async(Xs, LDX * 2, x + (row0 * H + h) * P,
                        (size_t)H * P * 2, P * 2, live);
  copy_chunk_rows_async(Bh, LDN * 2, Bm + (row0 * G + g) * N,
                        (size_t)G * N * 2, N * 2, live);
  load_chunk_dt(dts, dt, row0 * H + h, H, live);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  chunk_cumsum(dts, acs, A[h]);
  const int t = threadIdx.x;
  if (t < L) ws[t] = dts[t] * expf(fmaxf(acs[L - 1] - acs[t], -60.f));
  __syncthreads();
  for (int i = t; i < L * (N / 2); i += TC_NT) {
    const int m = i / (N / 2), n = (i % (N / 2)) * 2;
    uint32_t* at = reinterpret_cast<uint32_t*>(Bh + m * LDN + n);
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
    uint32_t hi, lo;
    split_bf16x2(f.x * ws[m], f.y * ws[m], hi, lo);
    *at = hi;
    *reinterpret_cast<uint32_t*>(Bl + m * LDN + n) = lo;
  }
  __syncthreads();

  // ---- s (N x P) = (B w)^T x: 16 x 16 output units over the 8 warps; A
  // fragments of (B w)^T read transposed from the (L, N) rows ----
  const int warp = t >> 5, lane = t & 31, mat = lane >> 3;
  const int g8 = lane >> 2, t2 = (lane & 3) * 2;
  const size_t blk = ((size_t)b * gridDim.y + j) * H + h;
  float* out = states + blk * (size_t)N * P;
  const int pu = P / 16;
  for (int u = warp; u < (N / 16) * pu; u += TC_NT / 32) {
    const int n0 = (u / pu) * 16, p0 = (u % pu) * 16;
    float acc[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < L / 16; ++ks) {
      const int a_off = (ks * 16 + (mat >> 1) * 8 + (lane & 7)) * LDN + n0 +
                        (mat & 1) * 8;
      uint32_t ah[4], al[4], bx[4];
      ldmatrix_x4_trans(ah, Bh + a_off);
      ldmatrix_x4_trans(al, Bl + a_off);
      ldmatrix_x4_trans(bx, Xs + (ks * 16 + (mat & 1) * 8 + (lane & 7)) * LDX +
                                p0 + (mat >> 1) * 8);
      mma_m16n8k16(acc[0], ah, bx[0], bx[1]);
      mma_m16n8k16(acc[0], al, bx[0], bx[1]);
      mma_m16n8k16(acc[1], ah, bx[2], bx[3]);
      mma_m16n8k16(acc[1], al, bx[2], bx[3]);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(out + (size_t)(n0 + g8 + 8 * r) * P + p0 +
                                   q * 8 + t2) =
            make_float2(acc[q][2 * r], acc[q][2 * r + 1]);
  }
  if (t == 0) aend[blk] = acs[L - 1];
}

__global__ void __launch_bounds__(TC_NT)
ssd_output_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const bf16* __restrict__ Bm,
                     const bf16* __restrict__ Cm,
                     const float* __restrict__ states, float* __restrict__ y,
                     int S, int H, int P, int G, int N) {
  constexpr int L = SSD_C;
  const int h = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int c0 = j * L, live = min(L, S - c0);
  const int LDX = P + 8, LDN = N + 8;

  extern __shared__ __align__(16) unsigned char smem[];
  float* dts = reinterpret_cast<float*>(smem);  // (L,)
  float* acs = dts + L;                         // (L,)
  bf16* Xs = reinterpret_cast<bf16*>(acs + L);  // (L, P)
  bf16* Bs = Xs + L * LDX;                      // (L, N)
  bf16* Cs = Bs + L * LDN;                      // (L, N)
  bf16* Hh = Cs + L * LDN;                      // (N, P) hi(state entering)
  bf16* Hl = Hh + N * LDX;                      // (N, P) lo(state entering)

  const size_t row0 = (size_t)b * S + c0;
  copy_chunk_rows_async(Xs, LDX * 2, x + (row0 * H + h) * P,
                        (size_t)H * P * 2, P * 2, live);
  copy_chunk_rows_async(Bs, LDN * 2, Bm + (row0 * G + g) * N,
                        (size_t)G * N * 2, N * 2, live);
  copy_chunk_rows_async(Cs, LDN * 2, Cm + (row0 * G + g) * N,
                        (size_t)G * N * 2, N * 2, live);
  cp_async_commit();
  load_chunk_dt(dts, dt, row0 * H + h, H, live);
  // the state entering the chunk, split into hi / lo halves: U float4 loads
  // a thread in flight at a time
  constexpr int U = 8;
  const float4* hin = reinterpret_cast<const float4*>(
      states + (((size_t)b * gridDim.y + j) * H + h) * (size_t)N * P);
  const int n4 = N * P / 4;
  for (int i0 = threadIdx.x; i0 < n4; i0 += U * TC_NT) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      v[u] = i0 + u * TC_NT < n4 ? hin[i0 + u * TC_NT]
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * TC_NT;
      if (i < n4) {
        const int n = (4 * i) / P, p = (4 * i) % P;
        uint32_t h0, l0, h1, l1;
        split_bf16x2(v[u].x, v[u].y, h0, l0);
        split_bf16x2(v[u].z, v[u].w, h1, l1);
        *reinterpret_cast<uint2*>(Hh + n * LDX + p) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(Hl + n * LDX + p) = make_uint2(l0, l1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  chunk_cumsum(dts, acs, A[h]);

  // warps rw and rw + 4 own rows r0 .. r0+15 of the chunk, each half of
  // the 16-column groups of P; this thread rows lr[0] and lr[1], columns
  // t2, t2 + 1 of each 8-column block
  const int t = threadIdx.x, lane = t & 31, mat = lane >> 3;
  const int rw = (t >> 5) & 3, half = t >> 7;
  const int g8 = lane >> 2, t2 = (lane & 3) * 2;
  const int r0 = rw * 16;
  const int lr[2] = {r0 + g8, r0 + g8 + 8};
  // this lane's ldmatrix row of the A fragments of C (rows r0 ..)
  const bf16* c_frag =
      Cs + (r0 + (lane & 7) + (mat & 1) * 8) * LDN + (mat >> 1) * 8;

  // ---- C B^T on the key blocks m < 16 (rw + 1): [jb][e] is row
  // lr[e >> 1], key jb * 8 + t2 + (e & 1) ----
  float cb[8][4];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[q][e] = 0.f;
  for (int ks = 0; ks < N / 16; ++ks) {
    uint32_t ca[4];
    ldmatrix_x4(ca, c_frag + ks * 16);
#pragma unroll
    for (int jb2 = 0; jb2 < 4; ++jb2) {
      if (jb2 <= rw) {
        uint32_t bb[4];
        ldmatrix_x4(bb, Bs + (jb2 * 16 + (mat >> 1) * 8 + (lane & 7)) * LDN +
                            ks * 16 + (mat & 1) * 8);
        mma_m16n8k16(cb[2 * jb2], ca, bb[0], bb[1]);
        mma_m16n8k16(cb[2 * jb2 + 1], ca, bb[2], bb[3]);
      }
    }
  }

  // ---- W = C B^T * exp(clip(acum_l - acum_m, -60, 0)) * dt_m on m <= l,
  // split into hi / lo bf16 A fragments of W x, one per 16 keys ----
  uint32_t wh[4][4], wl[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int jb = 2 * kk + (r >> 1), e = (r & 1) * 2;
      const int l = lr[r & 1];
      float w[2] = {0.f, 0.f};
      if (kk <= rw) {
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int m = jb * 8 + t2 + v;
          const float d = fminf(fmaxf(acs[l] - acs[m], -60.f), 0.f);
          w[v] = m <= l ? cb[jb][e + v] * expf(d) * dts[m] : 0.f;
        }
      }
      split_bf16x2(w[0], w[1], wh[kk][r], wl[kk][r]);
    }

  // ---- y = W x + exp(acum_l) C h, 16 columns of P at a time ----
  const float ex[2] = {expf(acs[lr[0]]), expf(acs[lr[1]])};
  for (int p0 = half * 16; p0 < P; p0 += 32) {
    float yi[2][4], yc[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) yi[q][e] = yc[q][e] = 0.f;
    const int b_off = ((mat & 1) * 8 + (lane & 7)) * LDX + p0 + (mat >> 1) * 8;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk <= rw) {
        uint32_t bx[4];
        ldmatrix_x4_trans(bx, Xs + kk * 16 * LDX + b_off);
        mma_m16n8k16(yi[0], wh[kk], bx[0], bx[1]);
        mma_m16n8k16(yi[0], wl[kk], bx[0], bx[1]);
        mma_m16n8k16(yi[1], wh[kk], bx[2], bx[3]);
        mma_m16n8k16(yi[1], wl[kk], bx[2], bx[3]);
      }
    }
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t ca[4], hh[4], hl[4];
      ldmatrix_x4(ca, c_frag + ks * 16);
      ldmatrix_x4_trans(hh, Hh + ks * 16 * LDX + b_off);
      ldmatrix_x4_trans(hl, Hl + ks * 16 * LDX + b_off);
      mma_m16n8k16(yc[0], ca, hh[0], hh[1]);
      mma_m16n8k16(yc[0], ca, hl[0], hl[1]);
      mma_m16n8k16(yc[1], ca, hh[2], hh[3]);
      mma_m16n8k16(yc[1], ca, hl[2], hl[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (lr[r] < live) {
        float* yrow = y + ((row0 + lr[r]) * H + h) * P + p0 + t2;
#pragma unroll
        for (int q = 0; q < 2; ++q)
          *reinterpret_cast<float2*>(yrow + q * 8) =
              make_float2(yi[q][2 * r] + ex[r] * yc[q][2 * r],
                          yi[q][2 * r + 1] + ex[r] * yc[q][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the backward: the three stages mirrored, fp32 math on the CUDA cores
// ---------------------------------------------------------------------------
//
// No TPU kernel: the reference differentiates its XLA scan (ssd_chunked,
// repro/models/ssm.py:38).  With G_c the gradient of the state leaving chunk
// c, h_c the state entering it (the forward's `states`), W_lm = (C_l . B_m)
// D_lm dt_m, D_lm = exp(clip(acum_l - acum_m, -60, 0)) (m <= l), K_lm =
// (dy_l . x_m) D_lm dt_m and R_m = exp(max(acum_end - acum_m, -60)):
//   G_{c-1} = exp(acum_end,c) G_c + u_c,  u_c = sum_l exp(acum_l) C_l dy_l^T
//   dx = W^T dy + dt R B G_c     dB = K^T C + dt R x G_c^T
//   dC = K B + exp(acum) dy h_c^T
// and ddt = A ga + (direct terms), ga the reverse cumsum over the chunk of
// the gradient of acum (the header of ssd_bwd_plain in ssd.py lists its
// terms).  Five launches from one call:
//   (a') ssd_bwd_state_kernel: u_c per (head, chunk, batch), into the
//        scratch `gstates` (B, chunks, H, N, P);
//   (b') ssd_bwd_pass_kernel: each element of a head's (N, P) state walks
//        the chunks from the last, overwriting u_c with G_c; dh0 at the end;
//   (c') ssd_bwd_chunk_kernel: per (head, chunk, batch) dx and ddt, dB and
//        dC of this head into fp32 partials (B, S, H, N), dA's share into
//        (B, chunks, H);
//   (d') ssd_bwd_group_kernel sums the partials over the heads of each
//        group, and ssd_bwd_da_kernel dA over (batch, chunk), each in a
//        fixed order: two calls give bit-identical outputs (no atomics).
// This design serves fp32 inputs (and bf16 at widths the tensor-core design
// below is not instantiated for): every product fp32 on the CUDA cores, in
// the register tiles of the forward's CUDA-core stages; stage (c') holds x,
// dy, B, C, h_c, G_c and three L x L arrays in shared memory (226,336 bytes
// at P = 64, N = 128: one block an SM).  Its bf16 instantiation served
// mamba2's bf16 training until the tensor-core design replaced it (4.33 ms
// at the trained shape, stage (c') 3.65 of it, PERF.md).

constexpr int BW_NT = 256;

// (a') u_c = sum_l exp(acum_l) C_l dy_l^T, an (N, P) fp32 array
template <typename T>
__global__ void __launch_bounds__(CC_NT)
ssd_bwd_state_kernel(const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Cm,
                     const float* __restrict__ dy,
                     float* __restrict__ gstates, int S, int H, int P, int G,
                     int N) {
  constexpr int L = SSD_C;
  const int h = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int c0 = j * L, live = min(L, S - c0);
  const int LDX = P + 4, LDN = N + 4;

  extern __shared__ __align__(16) float sm[];
  float* DYs = sm;              // (L, P)  the chunk's dy
  float* Cs = DYs + L * LDX;    // (L, N)  its C rows, then exp(acum) C
  float* dts = Cs + L * LDN;    // (L,)
  float* acs = dts + L;         // (L,)

  const size_t row0 = (size_t)b * S + c0;
  load_chunk_rows(DYs, LDX, dy + (row0 * H + h) * P, (size_t)H * P, P, live);
  load_chunk_rows(Cs, LDN, Cm + (row0 * G + g) * N, (size_t)G * N, N, live);
  load_chunk_dt(dts, dt, row0 * H + h, H, live);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  chunk_cumsum(dts, acs, A[h]);
  for (int i = threadIdx.x; i < live * N; i += CC_NT) {
    const int l = i / N, n = i % N;
    Cs[l * LDN + n] *= expf(acs[l]);
  }
  __syncthreads();
  const size_t blk = ((size_t)b * gridDim.y + j) * H + h;
  cc_state_sum(Cs, DYs, gstates + blk * (size_t)N * P, P, false, 0.f, P, N,
               live);
}

// (b') G_{c-1} = exp(acum_end,c) G_c + u_c from G_last = dh_final (or zero):
// each u_c is overwritten with G_c; dh0 (if asked for) gets the last.  One
// thread per four elements of a head's (N, P) state.
__global__ void __launch_bounds__(PASS_NT)
ssd_bwd_pass_kernel(float* __restrict__ gstates,
                    const float* __restrict__ aend,
                    const float* __restrict__ dh_final,
                    float* __restrict__ dh0, int nc, int H, int NP) {
  constexpr int U = 8;
  const int i = blockIdx.x * PASS_NT + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (4 * i >= NP) return;
  const size_t head = ((size_t)b * H + h) * NP;
  float4 st = dh_final != nullptr
                  ? reinterpret_cast<const float4*>(dh_final + head)[i]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = nc - 1; j0 >= 0; j0 -= U) {
    float4 s[U];
    float e[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      e[u] = 0.f;
      if (j0 - u >= 0) {
        const size_t blk = ((size_t)b * nc + j0 - u) * H + h;
        s[u] = reinterpret_cast<const float4*>(gstates + blk * NP)[i];
        e[u] = expf(aend[blk]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j0 - u >= 0) {
        const size_t blk = ((size_t)b * nc + j0 - u) * H + h;
        reinterpret_cast<float4*>(gstates + blk * NP)[i] = st;
        st = make_float4(e[u] * st.x + s[u].x, e[u] * st.y + s[u].y,
                         e[u] * st.z + s[u].z, e[u] * st.w + s[u].w);
      }
    }
  }
  if (dh0 != nullptr) reinterpret_cast<float4*>(dh0 + head)[i] = st;
}

// shared memory of stage (c'), in floats: x, dy (L, P); B, C (L, N); h_c,
// G_c (N, P); W, K (L, L); a third L x L array that also holds the row
// partials of two (L, N) reductions; eight vectors of L; the block's warp
// sums
constexpr int BW_VECS = 8;
__host__ __device__ constexpr int bw_scratch(int N) {
  return SSD_C * (SSD_C + 4) > 2 * SSD_C * (N / 4) ? SSD_C * (SSD_C + 4)
                                                   : 2 * SSD_C * (N / 4);
}
__host__ __device__ constexpr int bw_chunk_floats(int P, int N) {
  return 2 * SSD_C * (P + 4) + 2 * SSD_C * (N + 4) + 2 * N * (P + 4) +
         2 * SSD_C * (SSD_C + 4) + bw_scratch(N) + BW_VECS * SSD_C +
         BW_NT / 32;
}
int bw_chunk_smem(int P, int N) {
  return (int)sizeof(float) * bw_chunk_floats(P, N);
}
int bw_state_smem(int P, int N) {
  return (int)sizeof(float) * (SSD_C * (P + 4) + SSD_C * (N + 4) + 2 * SSD_C);
}
// mamba2's P = 64, N = 128 fits one block an SM
static_assert(sizeof(float) * bw_chunk_floats(64, 128) <= MAX_SMEM,
              "ssd_bwd_chunk_kernel: shared memory at P = 64, N = 128");
static_assert(BW_NT == 4 * SSD_C && CC_NT == BW_NT,
              "ssd backward: 256 threads, 16 x 16 tiles of the L x L arrays");

// (c') one block per (head, chunk, batch)
template <typename T>
__global__ void __launch_bounds__(BW_NT)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const float* __restrict__ dy,
                     const float* __restrict__ states,
                     const float* __restrict__ gstates, T* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dB_part,
                     float* __restrict__ dC_part, float* __restrict__ dA_part,
                     int S, int H, int P, int G, int N) {
  constexpr int L = SSD_C;
  const int h = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int c0 = j * L, live = min(L, S - c0);
  const int LDX = P + 4, LDN = N + 4, LDW = L + 4, LDH = P + 4;
  const int NQ = N / 4, PQ = P / 4;
  const int t = threadIdx.x;

  extern __shared__ __align__(16) float sm[];
  float* Xs = sm;                 // (L, P)  x
  float* DYs = Xs + L * LDX;      // (L, P)  dy
  float* Bs = DYs + L * LDX;      // (L, N)  B
  float* Cs = Bs + L * LDN;       // (L, N)  C
  float* Hs = Cs + L * LDN;       // (N, P)  h_c, the state entering
  float* Gs = Hs + N * LDH;       // (N, P)  G_c, the gradient leaving
  float* Ws = Gs + N * LDH;       // (L, L)  W
  float* Ks = Ws + L * LDW;       // (L, L)  K
  float* Es = Ks + L * LDW;       // (L, L)  E, then V, then row partials
  float* dts = Es + bw_scratch(N);
  float* acs = dts + L;           // running sum of dt * A
  float* rowE = acs + L;          // sum_m E_lm
  float* colE = rowE + L;         // sum_l E_lm
  float* colV = colE + L;         // sum_l V_lm
  float* zv = colV + L;           // R_m (B_m . G_c x_m)
  float* sv = zv + L;             // dt_m z_m where the clip passes it
  float* gac = sv + L;            // gradient of acum, then of a
  float* red = gac + L;           // (BW_NT / 32) warp sums

  const size_t row0 = (size_t)b * S + c0;
  const size_t blk = ((size_t)b * gridDim.y + j) * H + h;
  load_chunk_rows(Xs, LDX, x + (row0 * H + h) * P, (size_t)H * P, P, live);
  load_chunk_rows(DYs, LDX, dy + (row0 * H + h) * P, (size_t)H * P, P, live);
  load_chunk_rows(Bs, LDN, Bm + (row0 * G + g) * N, (size_t)G * N, N, live);
  load_chunk_rows(Cs, LDN, Cm + (row0 * G + g) * N, (size_t)G * N, N, live);
  load_chunk_dt(dts, dt, row0 * H + h, H, live);
  {
    const float* hin = states + blk * (size_t)N * P;
    const float* gin = gstates + blk * (size_t)N * P;
    for (int i = t; i < N * P / 4; i += BW_NT) {
      const int n = (4 * i) / P, p = (4 * i) % P;
      cp_async16(Hs + n * LDH + p, hin + 4 * i, 16);
      cp_async16(Gs + n * LDH + p, gin + 4 * i, 16);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const float a_h = A[h];
  chunk_cumsum(dts, acs, a_h);
  const float a_end = acs[L - 1];

  // ---- the L x L arrays: thread (ti, tj) its 4 x 4 tile of C B^T and of
  // dy x^T (tiles above the diagonal are zero), then W, K, E and V ----
  const int ti = t >> 4, tj = t & 15;
  float v[4][4];
  {
    float cb[4][4], q[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) cb[i][k] = q[i][k] = 0.f;
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
          for (int k = 0; k < 4; ++k)
            cb[i][k] += cv[i].x * bv[k].x + cv[i].y * bv[k].y +
                        cv[i].z * bv[k].z + cv[i].w * bv[k].w;
      }
      for (int p = 0; p < P; p += 4) {
        float4 dv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i] = *reinterpret_cast<const float4*>(DYs + (ti * 4 + i) * LDX + p);
          xv[i] = *reinterpret_cast<const float4*>(Xs + (tj * 4 + i) * LDX + p);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            q[i][k] += dv[i].x * xv[k].x + dv[i].y * xv[k].y +
                       dv[i].z * xv[k].z + dv[i].w * xv[k].w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int l = ti * 4 + i, m = tj * 4 + k;
        float w = 0.f, kk = 0.f, e = 0.f;
        v[i][k] = 0.f;
        if (m <= l) {
          const float d = acs[l] - acs[m];
          const float D = expf(fminf(fmaxf(d, -60.f), 0.f));
          v[i][k] = cb[i][k] * D * q[i][k];
          w = cb[i][k] * D * dts[m];
          kk = q[i][k] * D * dts[m];
          // a clipped exp passes no gradient to its argument
          if (d >= -60.f && d <= 0.f) e = v[i][k] * dts[m];
        }
        Ws[l * LDW + m] = w;
        Ks[l * LDW + m] = kk;
        Es[l * LDW + m] = e;
      }
  }
  __syncthreads();
  if (t < L) {
    float r = 0.f;
    for (int m = 0; m < L; ++m) r += Es[t * LDW + m];
    rowE[t] = r;
  } else if (t < 2 * L) {
    float c = 0.f;
    for (int l = 0; l < L; ++l) c += Es[l * LDW + (t - L)];
    colE[t - L] = c;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) Es[(ti * 4 + i) * LDW + tj * 4 + k] = v[i][k];
  __syncthreads();
  if (t < L) {
    float c = 0.f;
    for (int l = 0; l < L; ++l) c += Es[l * LDW + t];
    colV[t] = c;
  }
  __syncthreads();

  // ---- dx = W^T dy + dt R B G_c: 4 x 4 tiles of (m, p) ----
  for (int u = t; u < (L / 4) * PQ; u += BW_NT) {
    const int m0 = (u / PQ) * 4, p0 = (u % PQ) * 4;
    float acc[4][4], st[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = st[i][k] = 0.f;
    for (int l = m0; l < live; ++l) {      // W_lm = 0 for l < m
      const float4 wv = *reinterpret_cast<const float4*>(Ws + l * LDW + m0);
      const float4 dv = *reinterpret_cast<const float4*>(DYs + l * LDX + p0);
      const float ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] += ww[i] * dv.x;
        acc[i][1] += ww[i] * dv.y;
        acc[i][2] += ww[i] * dv.z;
        acc[i][3] += ww[i] * dv.w;
      }
    }
    for (int n = 0; n < N; ++n) {
      const float4 gv = *reinterpret_cast<const float4*>(Gs + n * LDH + p0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float bb = Bs[(m0 + i) * LDN + n];
        st[i][0] += bb * gv.x;
        st[i][1] += bb * gv.y;
        st[i][2] += bb * gv.z;
        st[i][3] += bb * gv.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + i;
      if (m < live) {
        const float f = dts[m] * expf(fmaxf(a_end - acs[m], -60.f));
        T* o = dx + ((row0 + m) * H + h) * P + p0;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          o[k] = Elem<T>::from_float(acc[i][k] + f * st[i][k]);
      }
    }
  }

  // ---- dB = K^T C + dt R x G_c^T and dC = K B + exp(acum) dy h_c^T: 4 x 4
  // tiles of (row, n); the row partials of B . (x G_c^T) and C . (dy h_c^T)
  // over each tile's four columns go to Es ----
  float* zpart = Es;              // (L, N / 4)
  float* gpart = Es + L * NQ;     // (L, N / 4)
  for (int u = t; u < (L / 4) * NQ; u += BW_NT) {
    const int r0 = (u / NQ) * 4, nq = u % NQ, n0 = nq * 4;
    float kc[4][4], xg[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) kc[i][k] = xg[i][k] = 0.f;
    for (int l = r0; l < live; ++l) {      // K_lm = 0 for l < m
      const float4 kv = *reinterpret_cast<const float4*>(Ks + l * LDW + r0);
      const float4 cv = *reinterpret_cast<const float4*>(Cs + l * LDN + n0);
      const float k4[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kc[i][0] += k4[i] * cv.x;
        kc[i][1] += k4[i] * cv.y;
        kc[i][2] += k4[i] * cv.z;
        kc[i][3] += k4[i] * cv.w;
      }
    }
    for (int p = 0; p < P; p += 4) {
      float4 xv[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xv[i] = *reinterpret_cast<const float4*>(Xs + (r0 + i) * LDX + p);
        gv[i] = *reinterpret_cast<const float4*>(Gs + (n0 + i) * LDH + p);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          xg[i][k] += xv[i].x * gv[k].x + xv[i].y * gv[k].y +
                      xv[i].z * gv[k].z + xv[i].w * gv[k].w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = r0 + i;
      const float4 bv = *reinterpret_cast<const float4*>(Bs + m * LDN + n0);
      zpart[m * NQ + nq] = bv.x * xg[i][0] + bv.y * xg[i][1] +
                           bv.z * xg[i][2] + bv.w * xg[i][3];
      if (m < live) {
        const float f = dts[m] * expf(fmaxf(a_end - acs[m], -60.f));
        *reinterpret_cast<float4*>(dB_part + ((row0 + m) * H + h) * N + n0) =
            make_float4(kc[i][0] + f * xg[i][0], kc[i][1] + f * xg[i][1],
                        kc[i][2] + f * xg[i][2], kc[i][3] + f * xg[i][3]);
      }
    }
    // reuse the registers: kc <- K B, xg <- dy h_c^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) kc[i][k] = xg[i][k] = 0.f;
    const int m_end = min(r0 + 4, live);   // K_lm = 0 for m > l
    for (int m = 0; m < m_end; ++m) {
      const float4 bv = *reinterpret_cast<const float4*>(Bs + m * LDN + n0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float k1 = Ks[(r0 + i) * LDW + m];
        kc[i][0] += k1 * bv.x;
        kc[i][1] += k1 * bv.y;
        kc[i][2] += k1 * bv.z;
        kc[i][3] += k1 * bv.w;
      }
    }
    for (int p = 0; p < P; p += 4) {
      float4 dv[4], hv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dv[i] = *reinterpret_cast<const float4*>(DYs + (r0 + i) * LDX + p);
        hv[i] = *reinterpret_cast<const float4*>(Hs + (n0 + i) * LDH + p);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          xg[i][k] += dv[i].x * hv[k].x + dv[i].y * hv[k].y +
                      dv[i].z * hv[k].z + dv[i].w * hv[k].w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = r0 + i;
      const float4 cv = *reinterpret_cast<const float4*>(Cs + l * LDN + n0);
      gpart[l * NQ + nq] = cv.x * xg[i][0] + cv.y * xg[i][1] +
                           cv.z * xg[i][2] + cv.w * xg[i][3];
      if (l < live) {
        const float e = expf(acs[l]);
        *reinterpret_cast<float4*>(dC_part + ((row0 + l) * H + h) * N + n0) =
            make_float4(kc[i][0] + e * xg[i][0], kc[i][1] + e * xg[i][1],
                        kc[i][2] + e * xg[i][2], kc[i][3] + e * xg[i][3]);
      }
    }
  }

  // ---- <G_c, h_c>: a fixed split over the threads, then the warps ----
  float gh = 0.f;
  for (int i = t; i < N * P; i += BW_NT) {
    const int n = i / P, p = i % P;
    gh += Gs[n * LDH + p] * Hs[n * LDH + p];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) gh += __shfl_xor_sync(0xffffffffu, gh, o);
  if ((t & 31) == 0) red[t >> 5] = gh;
  __syncthreads();

  // ---- the gradient of acum, its reverse cumsum (the gradient of a), ddt
  // and this block's share of dA ----
  if (t < L) {
    float z = 0.f, gi = 0.f;
    for (int k = 0; k < NQ; ++k) {
      z += zpart[t * NQ + k];
      gi += gpart[t * NQ + k];
    }
    const float rest = a_end - acs[t];
    z *= expf(fmaxf(rest, -60.f));
    const float s = rest >= -60.f ? dts[t] * z : 0.f;
    zv[t] = z;
    sv[t] = s;
    gac[t] = rowE[t] - colE[t] + expf(acs[t]) * gi - s;
  }
  __syncthreads();
  if (t == 0) {
    float ghs = 0.f, ss = 0.f;
    for (int w = 0; w < BW_NT / 32; ++w) ghs += red[w];
    for (int l = 0; l < L; ++l) ss += sv[l];
    gac[L - 1] += expf(a_end) * ghs + ss;
    float run = 0.f, da = 0.f;
    for (int l = L - 1; l >= 0; --l) {
      run += gac[l];
      gac[l] = run;
      da += dts[l] * run;
    }
    dA_part[blk] = da;
  }
  __syncthreads();
  if (t < live) ddt[(row0 + t) * H + h] = a_h * gac[t] + colV[t] + zv[t];
}

// (d') dB / dC (B, S, G, N) = the nsl partials of each group, (B, S, G,
// nsl, N) -- one per head (CUDA cores) or per slice of heads (tensor cores)
// -- summed in order; one thread per four elements
template <typename T>
__global__ void __launch_bounds__(PASS_NT)
ssd_bwd_group_kernel(const float* __restrict__ dB_part,
                     const float* __restrict__ dC_part, T* __restrict__ dB,
                     T* __restrict__ dC, size_t n4, int nsl, int G, int N) {
  const size_t i = (size_t)blockIdx.x * PASS_NT + threadIdx.x;
  if (i >= n4) return;
  const size_t e = 4 * i;
  const size_t row = e / ((size_t)G * N);
  const int rem = (int)(e % ((size_t)G * N));
  const int g = rem / N, n = rem % N;
  float4 sb = make_float4(0.f, 0.f, 0.f, 0.f), sc = sb;
  for (int k = 0; k < nsl; ++k) {
    const size_t at = ((row * G + g) * nsl + k) * N + n;
    const float4 pb = *reinterpret_cast<const float4*>(dB_part + at);
    const float4 pc = *reinterpret_cast<const float4*>(dC_part + at);
    sb = make_float4(sb.x + pb.x, sb.y + pb.y, sb.z + pb.z, sb.w + pb.w);
    sc = make_float4(sc.x + pc.x, sc.y + pc.y, sc.z + pc.z, sc.w + pc.w);
  }
  const float vb[4] = {sb.x, sb.y, sb.z, sb.w};
  const float vc[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    dB[e + k] = Elem<T>::from_float(vb[k]);
    dC[e + k] = Elem<T>::from_float(vc[k]);
  }
}

// (d') dA_h = sum over (batch, chunk) of the blocks' shares, in order
__global__ void __launch_bounds__(PASS_NT)
ssd_bwd_da_kernel(const float* __restrict__ dA_part, float* __restrict__ dA,
                  int n_rows, int H) {
  const int h = blockIdx.x * PASS_NT + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int r = 0; r < n_rows; ++r) s += dA_part[(size_t)r * H + h];
  dA[h] = s;
}

// ---------------------------------------------------------------------------
// the backward on the tensor cores: bf16 x, B, C at the (P, N) that
// bw_tc_smem names
// ---------------------------------------------------------------------------
//
// The same five launches, with (a') and (c') on mma.sync m16n8k16 (fp32
// accumulate).  x, B, C are bf16 and enter the products exactly; every
// fp32 operand -- dy, the chunk states h_c and their gradients G_c, the
// weights W and K -- is split into bf16 hi + lo (split_bf16x2), a product
// with one fp32 operand taken as two products, with two as three (hi hi,
// hi lo, lo hi); a scale is applied to the fp32 operand (exp(acum) dy in
// (a')) or to the accumulator, never to a bf16 one.  E, V and their row
// and column sums (the ddt and dA terms) stay fp32.
//   (a') ssd_bwd_state_tc_kernel: u_c = C^T (exp(acum) dy), one block per
//        (head, chunk, batch) as the forward's ssd_state_tc_kernel;
//   (c') ssd_bwd_tc_kernel: one block per (slice of k heads of a group,
//        chunk, batch) -- k = ssd_bwd_heads(H / G) -- walks its heads in
//        order.  The group's B C^T is computed once per block; each head's
//        L x L products are taken in the (m, l) orientation (x dy^T), so
//        W^T and K^T come out row-major for the A operands of W^T dy and
//        K^T C, and K B reads K^T with ldmatrix.trans.  The running dB and
//        dC of the slice stay in registers across its heads and go out once
//        as one fp32 partial per slice, (B, S, G * H / (G k), N);
//   (d') ssd_bwd_group_kernel adds the slices in order (one slice where
//        k = H / G), ssd_bwd_da_kernel dA.  No atomics: two calls are
//        bit-identical.
// Stage (c') at P = 64, N = 128 holds x, dy (hi, lo), B, C, h_c and G_c
// (hi, lo), W^T and K^T (hi, lo), B C^T in fp32 and the row sums in 197 KB of
// shared memory: one block of 16 warps an SM (two blocks of 8 warps would
// need the running sums in shared memory, 64 KB more).  Sending for the
// next head's inputs while a head computes (cp.async into 48 KB of fp32
// staging), B C^T in registers and 16 x 32 dB / dC tiles a warp gained
// under 2 %, and spilled (PERF.md, the SSD backward's findings).  What
// bounds it: at mamba2's trained shape stage (c') moves ~615 MB (0.18 ms
// at 3.35 TB/s) and its products take well under that on the tensor
// cores, yet it runs 0.53 ms: the time spreads over the products, the hi
// / lo splits and the block-wide barriers of one block an SM (nine a
// head), none of them dominant.  Positions past S act as dt = 0, as in the
// forward.

constexpr int BT_NT = 512;   // stage (c'): 16 warps
constexpr int BT_W = BT_NT / 32;
// the largest number of heads a block of stage (c') walks: at H / G = 48,
// 16, 24 and 48 (every head of a group: the group sum then converts one
// partial) were within 1.3 % of each other, 8 2.5-3.3 % slower
// (scripts/probe_variant.py ssd_bwd_heads; PERF.md)
constexpr int BW_HEADS = 48;

// heads per block of stage (c'): the largest divisor of H / G up to
// BW_HEADS
int ssd_bwd_heads(int hpg) {
  int k = 1;
  for (int d = 1; d <= hpg && d <= BW_HEADS; ++d)
    if (hpg % d == 0) k = d;
  return k;
}

template <int P, int N>
struct BwTc {
  static constexpr int L = SSD_C;
  static constexpr int LDN = N + 8, LDP = P + 8, LDL = L + 8;  // bf16
  static constexpr int LDCB = L + 4;                           // fp32
  // output units of 16 rows x 16 columns a warp: dx (m, p), dB (m, n) and
  // dC (l, n); the dB / dC units a warp owns for the whole block
  static constexpr int DX_UNITS = 4 * (P / 16);
  static constexpr int BC_UNITS = 4 * (N / 16);
  static constexpr int UB = (BC_UNITS + BT_W - 1) / BT_W;
  // byte offsets into the dynamic shared memory
  static constexpr int B_OFF = 0;
  static constexpr int C_OFF = B_OFF + L * LDN * 2;
  static constexpr int X_OFF = C_OFF + L * LDN * 2;
  static constexpr int DYH_OFF = X_OFF + L * LDP * 2;
  static constexpr int DYL_OFF = DYH_OFF + L * LDP * 2;
  static constexpr int GH_OFF = DYL_OFF + L * LDP * 2;
  static constexpr int GL_OFF = GH_OFF + N * LDP * 2;
  static constexpr int HH_OFF = GL_OFF + N * LDP * 2;
  static constexpr int HL_OFF = HH_OFF + N * LDP * 2;
  static constexpr int WH_OFF = HL_OFF + N * LDP * 2;
  static constexpr int WL_OFF = WH_OFF + L * LDL * 2;
  static constexpr int KH_OFF = WL_OFF + L * LDL * 2;
  static constexpr int KL_OFF = KH_OFF + L * LDL * 2;
  static constexpr int CB_OFF = KL_OFF + L * LDL * 2;
  static constexpr int V_OFF = CB_OFF + L * LDCB * 4;
  // fp32 vectors: dt, acum; colV, colE partials by l-block, rowE partials
  // by m-block (4 x L each); z partials by dx unit column (P / 16 x L), gi
  // partials by dC unit column (N / 16 x L); 16 warp sums of <G_c, h_c>
  // and 8 scratch
  static constexpr int VEC = 2 * L + 3 * 4 * L + (P / 16) * L +
                             (N / 16) * L + BT_W + 8;
  static constexpr int SMEM = V_OFF + VEC * 4;
};

template <int P, int N>
constexpr bool bw_tc_fits() {
  return BwTc<P, N>::SMEM <= MAX_SMEM;
}
static_assert(bw_tc_fits<64, 128>() && bw_tc_fits<16, 16>(),
              "ssd_bwd_tc_kernel: shared memory of the instantiated (P, N)");
static_assert(BwTc<64, 128>::SMEM == 197216,
              "ssd_bwd_tc_kernel: 197,216 bytes at P = 64, N = 128");
static_assert(SSD_C == 64 && BT_NT == 512,
              "ssd_bwd_tc_kernel: 4 row blocks of 16, 16 warps, two warps "
              "for the L-long vectors");

// the (m-block, l-block) tile of the causal L x L products (l >= m) that
// warp w < 10 owns
__device__ __forceinline__ void bw_tile(int w, int& i, int& j) {
  if (w < 4) {
    i = 0; j = w;
  } else if (w < 7) {
    i = 1; j = w - 3;
  } else if (w < 9) {
    i = 2; j = w - 5;
  } else {
    i = 3; j = 3;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (a') u_c = C^T (exp(acum) dy), an (N, P) fp32 array: C exact, the scaled
// dy split into hi / lo
__global__ void __launch_bounds__(TC_NT)
ssd_bwd_state_tc_kernel(const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const bf16* __restrict__ Cm,
                        const float* __restrict__ dy,
                        float* __restrict__ gstates, int S, int H, int P,
                        int G, int N) {
  constexpr int L = SSD_C;
  const int h = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int c0 = j * L, live = min(L, S - c0);
  const int LDP = P + 8, LDN = N + 8;

  extern __shared__ __align__(16) unsigned char smem[];
  float* dts = reinterpret_cast<float*>(smem);  // (L,)
  float* acs = dts + L;                         // (L,)
  bf16* Cs = reinterpret_cast<bf16*>(acs + L);  // (L, N)
  bf16* Dh = Cs + L * LDN;                      // (L, P) hi(exp(acum) dy)
  bf16* Dl = Dh + L * LDP;                      // (L, P) lo

  const size_t row0 = (size_t)b * S + c0;
  copy_chunk_rows_async(Cs, LDN * 2, Cm + (row0 * G + g) * N,
                        (size_t)G * N * 2, N * 2, live);
  cp_async_commit();
  load_chunk_dt(dts, dt, row0 * H + h, H, live);
  // dy's rows in flight while the running sum is taken: U float4 loads a
  // thread at a time
  constexpr int U = 4;
  const int n4 = L * P / 4, t = threadIdx.x;
  for (int i0 = 0; i0 < n4; i0 += U * TC_NT) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + t + u * TC_NT, r = (4 * i) / P, c = (4 * i) % P;
      v[u] = i < n4 && r < live
                 ? *reinterpret_cast<const float4*>(
                       dy + ((row0 + r) * H + h) * P + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (i0 == 0) {
      __syncthreads();
      chunk_cumsum(dts, acs, A[h]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + t + u * TC_NT, r = (4 * i) / P, c = (4 * i) % P;
      if (i < n4) {
        const float e = expf(acs[r]);
        uint32_t h0, l0, h1, l1;
        split_bf16x2(e * v[u].x, e * v[u].y, h0, l0);
        split_bf16x2(e * v[u].z, e * v[u].w, h1, l1);
        *reinterpret_cast<uint2*>(Dh + r * LDP + c) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(Dl + r * LDP + c) = make_uint2(l0, l1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- u (N x P) = C^T (e dy): 16 x 16 output units over the 8 warps; A
  // fragments of C^T and B fragments of e dy both read transposed ----
  const int warp = t >> 5, lane = t & 31, mat = lane >> 3;
  const int g8 = lane >> 2, t2 = (lane & 3) * 2;
  float* out = gstates + (((size_t)b * gridDim.y + j) * H + h) * (size_t)N * P;
  const int pu = P / 16;
  for (int u = warp; u < (N / 16) * pu; u += TC_NT / 32) {
    const int n0 = (u / pu) * 16, p0 = (u % pu) * 16;
    float acc[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < L / 16; ++ks) {
      uint32_t ca[4], bh[4], bl[4];
      ldmatrix_x4_trans(ca, Cs + (ks * 16 + (mat >> 1) * 8 + (lane & 7)) *
                                     LDN + n0 + (mat & 1) * 8);
      const int b_off = (ks * 16 + (mat & 1) * 8 + (lane & 7)) * LDP + p0 +
                        (mat >> 1) * 8;
      ldmatrix_x4_trans(bh, Dh + b_off);
      ldmatrix_x4_trans(bl, Dl + b_off);
      mma_m16n8k16(acc[0], ca, bh[0], bh[1]);
      mma_m16n8k16(acc[0], ca, bl[0], bl[1]);
      mma_m16n8k16(acc[1], ca, bh[2], bh[3]);
      mma_m16n8k16(acc[1], ca, bl[2], bl[3]);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(out + (size_t)(n0 + g8 + 8 * r) * P + p0 +
                                   q * 8 + t2) =
            make_float2(acc[q][2 * r], acc[q][2 * r + 1]);
  }
}

int bw_state_tc_smem(int P, int N) {
  return 2 * SSD_C * 4 + SSD_C * (N + 8) * 2 + 2 * SSD_C * (P + 8) * 2;
}

// rows r0 .. r0 + 15 of an (rows, ld) bf16 array as the A fragment of
// k-step ks (16 columns), stored row-major (M x K)
__device__ __forceinline__ void a_rows(uint32_t (&a)[4], const bf16* s,
                                       int ld, int r0, int ks, int lane) {
  const int mat = lane >> 3;
  ldmatrix_x4(a, s + (r0 + (lane & 7) + (mat & 1) * 8) * ld + ks * 16 +
                     (mat >> 1) * 8);
}
// the A fragment of rows (M) m0 .. m0 + 15, k-step ks, of a matrix stored
// transposed (K x M, row-major)
__device__ __forceinline__ void a_cols(uint32_t (&a)[4], const bf16* s,
                                       int ld, int m0, int ks, int lane) {
  const int mat = lane >> 3;
  ldmatrix_x4_trans(a, s + (ks * 16 + (mat >> 1) * 8 + (lane & 7)) * ld +
                           m0 + (mat & 1) * 8);
}
// B fragments of two n8 blocks (n0 .. n0 + 15), k-step ks, of a matrix
// stored N x K row-major: b[0], b[1] the first block, b[2], b[3] the second
__device__ __forceinline__ void b_rows(uint32_t (&b)[4], const bf16* s,
                                       int ld, int n0, int ks, int lane) {
  const int mat = lane >> 3;
  ldmatrix_x4(b, s + (n0 + (mat >> 1) * 8 + (lane & 7)) * ld + ks * 16 +
                     (mat & 1) * 8);
}
// the same of a matrix stored K x N row-major
__device__ __forceinline__ void b_cols(uint32_t (&b)[4], const bf16* s,
                                       int ld, int n0, int ks, int lane) {
  const int mat = lane >> 3;
  ldmatrix_x4_trans(b, s + (ks * 16 + (mat & 1) * 8 + (lane & 7)) * ld + n0 +
                           (mat >> 1) * 8);
}

// acc[2] (two n8 blocks) += a (bf16) times b (hi, lo)
__device__ __forceinline__ void mma_1split(float (&acc)[2][4],
                                           const uint32_t (&a)[4],
                                           const uint32_t (&bh)[4],
                                           const uint32_t (&bl)[4]) {
  mma_m16n8k16(acc[0], a, bh[0], bh[1]);
  mma_m16n8k16(acc[0], a, bl[0], bl[1]);
  mma_m16n8k16(acc[1], a, bh[2], bh[3]);
  mma_m16n8k16(acc[1], a, bl[2], bl[3]);
}
// acc[2] += (ah + al) (bh + bl) without al bl
__device__ __forceinline__ void mma_2split(float (&acc)[2][4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[4],
                                           const uint32_t (&bl)[4]) {
  mma_1split(acc, ah, bh, bl);
  mma_m16n8k16(acc[0], al, bh[0], bh[1]);
  mma_m16n8k16(acc[1], al, bh[2], bh[3]);
}
// acc[2] += (ah + al) b, b bf16
__device__ __forceinline__ void mma_asplit(float (&acc)[2][4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&b)[4]) {
  mma_m16n8k16(acc[0], ah, b[0], b[1]);
  mma_m16n8k16(acc[0], al, b[0], b[1]);
  mma_m16n8k16(acc[1], ah, b[2], b[3]);
  mma_m16n8k16(acc[1], al, b[2], b[3]);
}

__device__ __forceinline__ void zero_acc(float (&acc)[2][4]) {
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
}

// (c') one block per (slice of k heads of a group, chunk, batch)
template <int P, int N>
__global__ void __launch_bounds__(BT_NT, 1)
ssd_bwd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const bf16* __restrict__ Bm,
                  const bf16* __restrict__ Cm, const float* __restrict__ dy,
                  const float* __restrict__ states,
                  const float* __restrict__ gstates, bf16* __restrict__ dx,
                  float* __restrict__ ddt, float* __restrict__ dB_part,
                  float* __restrict__ dC_part, float* __restrict__ dA_part,
                  int S, int H, int G, int k) {
  using Lay = BwTc<P, N>;
  constexpr int L = SSD_C;
  constexpr int LDN = Lay::LDN, LDP = Lay::LDP, LDL = Lay::LDL;
  constexpr int LDCB = Lay::LDCB;
  const int hpg = H / G, nsl = hpg / k;
  const int g = blockIdx.x / nsl, j = blockIdx.y, b = blockIdx.z;
  const int c0 = j * L, live = min(L, S - c0);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g8 = lane >> 2, t2 = (lane & 3) * 2;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Bs = reinterpret_cast<bf16*>(smem + Lay::B_OFF);     // (L, N)
  bf16* Cs = reinterpret_cast<bf16*>(smem + Lay::C_OFF);     // (L, N)
  bf16* Xs = reinterpret_cast<bf16*>(smem + Lay::X_OFF);     // (L, P)
  bf16* DYh = reinterpret_cast<bf16*>(smem + Lay::DYH_OFF);  // (L, P)
  bf16* DYl = reinterpret_cast<bf16*>(smem + Lay::DYL_OFF);
  bf16* Gh = reinterpret_cast<bf16*>(smem + Lay::GH_OFF);    // (N, P) G_c
  bf16* Gl = reinterpret_cast<bf16*>(smem + Lay::GL_OFF);
  bf16* Hh = reinterpret_cast<bf16*>(smem + Lay::HH_OFF);    // (N, P) h_c
  bf16* Hl = reinterpret_cast<bf16*>(smem + Lay::HL_OFF);
  bf16* WTh = reinterpret_cast<bf16*>(smem + Lay::WH_OFF);   // (m, l) W^T
  bf16* WTl = reinterpret_cast<bf16*>(smem + Lay::WL_OFF);
  bf16* KTh = reinterpret_cast<bf16*>(smem + Lay::KH_OFF);   // (m, l) K^T
  bf16* KTl = reinterpret_cast<bf16*>(smem + Lay::KL_OFF);
  float* CBs = reinterpret_cast<float*>(smem + Lay::CB_OFF); // (m, l) B C^T
  float* dts = reinterpret_cast<float*>(smem + Lay::V_OFF);  // (L,)
  float* acs = dts + L;                // running sum of dt * A
  float* vpart = acs + L;              // [l-block][m] sums of V over l
  float* ecpart = vpart + 4 * L;       // [l-block][m] sums of E over l
  float* erpart = ecpart + 4 * L;      // [m-block][l] sums of E over m
  float* zpart = erpart + 4 * L;       // [p-block][m] x . (B G_c)
  float* gpart = zpart + (P / 16) * L; // [n-block][l] C . (dy h_c^T)
  float* red = gpart + (N / 16) * L;   // (16,) warp sums of <G_c, h_c>
  float* scr = red + BT_W;             // (8,)

  const size_t row0 = (size_t)b * S + c0;
  copy_chunk_rows_async(Bs, LDN * 2, Bm + (row0 * G + g) * N,
                        (size_t)G * N * 2, N * 2, live);
  copy_chunk_rows_async(Cs, LDN * 2, Cm + (row0 * G + g) * N,
                        (size_t)G * N * 2, N * 2, live);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ---- the group's B C^T in the (m, l) orientation, causal tiles only,
  // once for the block's heads ----
  if (warp < 10) {
    int i, jt;
    bw_tile(warp, i, jt);
    float acc[2][4];
    zero_acc(acc);
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t a[4], bb[4];
      a_rows(a, Bs, LDN, i * 16, ks, lane);
      b_rows(bb, Cs, LDN, jt * 16, ks, lane);
      mma_m16n8k16(acc[0], a, bb[0], bb[1]);
      mma_m16n8k16(acc[1], a, bb[2], bb[3]);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(CBs + (i * 16 + g8 + 8 * r) * LDCB +
                                   jt * 16 + q * 8 + t2) =
            make_float2(acc[q][2 * r], acc[q][2 * r + 1]);
  }

  // the running dB (rows m) and dC (rows l) of this warp's units: unit u =
  // warp + 16 i is rows 16 (u % 4) .., columns 16 (u / 4) .. of N
  constexpr int UB = Lay::UB;
  float dB_run[UB][2][4], dC_run[UB][2][4];
#pragma unroll
  for (int i = 0; i < UB; ++i) {
    zero_acc(dB_run[i]);
    zero_acc(dC_run[i]);
  }

  constexpr int NT = BT_NT;
  constexpr int NDY = L * P / 4, NST = N * P / 4;  // float4s of dy, a state
  constexpr int UDY = (NDY + NT - 1) / NT, UST = (NST + NT - 1) / NT;

  for (int hk = 0; hk < k; ++hk) {
    const int h = g * hpg + (blockIdx.x % nsl) * k + hk;
    const size_t blk = ((size_t)b * gridDim.y + j) * H + h;
    __syncthreads();   // the previous head is done with the shared memory
    copy_chunk_rows_async(Xs, LDP * 2, x + (row0 * H + h) * P,
                          (size_t)H * P * 2, P * 2, live);
    cp_async_commit();
    load_chunk_dt(dts, dt, row0 * H + h, H, live);
    {
      // dy, G_c and h_c: every load of the thread in flight, then split
      float4 vd[UDY], vg[UST], vh[UST];
      const float4* gin =
          reinterpret_cast<const float4*>(gstates + blk * (size_t)N * P);
      const float4* hin =
          reinterpret_cast<const float4*>(states + blk * (size_t)N * P);
#pragma unroll
      for (int u = 0; u < UDY; ++u) {
        const int i = t + u * NT, r = (4 * i) / P, c = (4 * i) % P;
        vd[u] = i < NDY && r < live
                    ? *reinterpret_cast<const float4*>(
                          dy + ((row0 + r) * H + h) * P + c)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < UST; ++u) {
        const int i = t + u * NT;
        const bool in = i < NST;
        vg[u] = in ? gin[i] : make_float4(0.f, 0.f, 0.f, 0.f);
        vh[u] = in ? hin[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float gh = 0.f;
#pragma unroll
      for (int u = 0; u < UDY; ++u) {
        const int i = t + u * NT, r = (4 * i) / P, c = (4 * i) % P;
        if (i < NDY) {
          uint32_t h0, l0, h1, l1;
          split_bf16x2(vd[u].x, vd[u].y, h0, l0);
          split_bf16x2(vd[u].z, vd[u].w, h1, l1);
          *reinterpret_cast<uint2*>(DYh + r * LDP + c) = make_uint2(h0, h1);
          *reinterpret_cast<uint2*>(DYl + r * LDP + c) = make_uint2(l0, l1);
        }
      }
#pragma unroll
      for (int u = 0; u < UST; ++u) {
        const int i = t + u * NT, n = (4 * i) / P, c = (4 * i) % P;
        if (i < NST) {
          gh += vg[u].x * vh[u].x + vg[u].y * vh[u].y + vg[u].z * vh[u].z +
                vg[u].w * vh[u].w;
          uint32_t h0, l0, h1, l1;
          split_bf16x2(vg[u].x, vg[u].y, h0, l0);
          split_bf16x2(vg[u].z, vg[u].w, h1, l1);
          *reinterpret_cast<uint2*>(Gh + n * LDP + c) = make_uint2(h0, h1);
          *reinterpret_cast<uint2*>(Gl + n * LDP + c) = make_uint2(l0, l1);
          split_bf16x2(vh[u].x, vh[u].y, h0, l0);
          split_bf16x2(vh[u].z, vh[u].w, h1, l1);
          *reinterpret_cast<uint2*>(Hh + n * LDP + c) = make_uint2(h0, h1);
          *reinterpret_cast<uint2*>(Hl + n * LDP + c) = make_uint2(l0, l1);
        }
      }
      gh = warp_sum(gh);
      if (lane == 0) red[warp] = gh;
    }
    cp_async_wait<0>();
    __syncthreads();
    const float a_h = A[h];
    chunk_cumsum(dts, acs, a_h);
    const float a_end = acs[L - 1];

    // ---- (m, l) tiles: x dy^T, then W^T, K^T (split, to shared memory),
    // V and E with their partial sums ----
    if (warp < 10) {
      int i, jt;
      bw_tile(warp, i, jt);
      float q[2][4];
      zero_acc(q);
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        uint32_t a[4], bh[4], bl[4];
        a_rows(a, Xs, LDP, i * 16, ks, lane);
        b_rows(bh, DYh, LDP, jt * 16, ks, lane);
        b_rows(bl, DYl, LDP, jt * 16, ks, lane);
        mma_1split(q, a, bh, bl);
      }
      float rowv[2] = {0.f, 0.f}, rowe[2] = {0.f, 0.f};
      float cole[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int qq = 0; qq < 2; ++qq)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = i * 16 + g8 + 8 * r;
          const float dtm = dts[m], am = acs[m];
          const float2 cb = *reinterpret_cast<const float2*>(
              CBs + m * LDCB + jt * 16 + qq * 8 + t2);
          const float cbv[2] = {cb.x, cb.y};
          float w[2], kk[2];
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int l = jt * 16 + qq * 8 + t2 + v;
            const float d = acs[l] - am;
            const float D = expf(fminf(fmaxf(d, -60.f), 0.f));
            const bool on = l >= m;
            const float qv = q[qq][2 * r + v];
            w[v] = on ? cbv[v] * D * dtm : 0.f;
            kk[v] = on ? qv * D * dtm : 0.f;
            const float vv = on ? cbv[v] * D * qv : 0.f;
            // a clipped exp passes no gradient to its argument
            const float ee = on && d >= -60.f && d <= 0.f ? vv * dtm : 0.f;
            rowv[r] += vv;
            rowe[r] += ee;
            cole[qq][v] += ee;
          }
          uint32_t hi, lo;
          const int at = m * LDL + jt * 16 + qq * 8 + t2;
          split_bf16x2(w[0], w[1], hi, lo);
          *reinterpret_cast<uint32_t*>(WTh + at) = hi;
          *reinterpret_cast<uint32_t*>(WTl + at) = lo;
          split_bf16x2(kk[0], kk[1], hi, lo);
          *reinterpret_cast<uint32_t*>(KTh + at) = hi;
          *reinterpret_cast<uint32_t*>(KTl + at) = lo;
        }
      // sums over this tile's l (the 4 lanes of a row) and over its m (the
      // 8 row groups of a column)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          rowv[r] += __shfl_xor_sync(0xffffffffu, rowv[r], o);
          rowe[r] += __shfl_xor_sync(0xffffffffu, rowe[r], o);
        }
        if ((lane & 3) == 0) {
          vpart[jt * L + i * 16 + g8 + 8 * r] = rowv[r];
          ecpart[jt * L + i * 16 + g8 + 8 * r] = rowe[r];
        }
      }
#pragma unroll
      for (int qq = 0; qq < 2; ++qq)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          float c = cole[qq][v];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1)
            c += __shfl_xor_sync(0xffffffffu, c, o);
          if (g8 == 0) erpart[i * L + jt * 16 + qq * 8 + t2 + v] = c;
        }
    }
    __syncthreads();

    // ---- dx = W^T dy + dt R (B G_c), with z's partial x . (B G_c) ----
    for (int u = warp; u < Lay::DX_UNITS; u += BT_W) {
      const int m0 = (u & 3) * 16, p0 = (u >> 2) * 16;
      float acc[2][4], st[2][4];
      zero_acc(acc);
      zero_acc(st);
      for (int kb = u & 3; kb < 4; ++kb) {     // W^T is 0 below l = m
        uint32_t wh[4], wl[4], bh[4], bl[4];
        a_rows(wh, WTh, LDL, m0, kb, lane);
        a_rows(wl, WTl, LDL, m0, kb, lane);
        b_cols(bh, DYh, LDP, p0, kb, lane);
        b_cols(bl, DYl, LDP, p0, kb, lane);
        mma_2split(acc, wh, wl, bh, bl);
      }
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks) {
        uint32_t a[4], bh[4], bl[4];
        a_rows(a, Bs, LDN, m0, ks, lane);
        b_cols(bh, Gh, LDP, p0, ks, lane);
        b_cols(bl, Gl, LDP, p0, ks, lane);
        mma_1split(st, a, bh, bl);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = m0 + g8 + 8 * r;
        const float f = dts[m] * expf(fmaxf(a_end - acs[m], -60.f));
        float zp = 0.f;
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {
          const int p = p0 + qq * 8 + t2;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(Xs + m * LDP + p));
          zp += xv.x * st[qq][2 * r] + xv.y * st[qq][2 * r + 1];
          if (m < live)
            *reinterpret_cast<uint32_t*>(dx + ((row0 + m) * H + h) * P + p) =
                pack_bf16(acc[qq][2 * r] + f * st[qq][2 * r],
                          acc[qq][2 * r + 1] + f * st[qq][2 * r + 1]);
        }
        zp += __shfl_xor_sync(0xffffffffu, zp, 1);
        zp += __shfl_xor_sync(0xffffffffu, zp, 2);
        if ((lane & 3) == 0) zpart[(u >> 2) * L + m] = zp;
      }
    }

    // ---- dB += K^T C + dt R (x G_c^T); dC += K B + exp(acum) (dy h_c^T),
    // with gi's partial C . (dy h_c^T) ----
#pragma unroll
    for (int ui = 0; ui < UB; ++ui) {
      const int u = warp + BT_W * ui;
      if (u >= Lay::BC_UNITS) break;
      const int rb = u & 3, r0 = rb * 16, n0 = (u >> 2) * 16;
      for (int kb = rb; kb < 4; ++kb) {        // K^T is 0 below l = m
        uint32_t kh[4], kl[4], cb[4];
        a_rows(kh, KTh, LDL, r0, kb, lane);
        a_rows(kl, KTl, LDL, r0, kb, lane);
        b_cols(cb, Cs, LDN, n0, kb, lane);
        mma_asplit(dB_run[ui], kh, kl, cb);
      }
      float tmp[2][4];
      zero_acc(tmp);
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        uint32_t a[4], bh[4], bl[4];
        a_rows(a, Xs, LDP, r0, ks, lane);
        b_rows(bh, Gh, LDP, n0, ks, lane);
        b_rows(bl, Gl, LDP, n0, ks, lane);
        mma_1split(tmp, a, bh, bl);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = r0 + g8 + 8 * r;
        const float f = dts[m] * expf(fmaxf(a_end - acs[m], -60.f));
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {
          dB_run[ui][qq][2 * r] += f * tmp[qq][2 * r];
          dB_run[ui][qq][2 * r + 1] += f * tmp[qq][2 * r + 1];
        }
      }
      for (int kb = 0; kb <= rb; ++kb) {       // K is 0 past m = l
        uint32_t kh[4], kl[4], bb[4];
        a_cols(kh, KTh, LDL, r0, kb, lane);
        a_cols(kl, KTl, LDL, r0, kb, lane);
        b_cols(bb, Bs, LDN, n0, kb, lane);
        mma_asplit(dC_run[ui], kh, kl, bb);
      }
      zero_acc(tmp);
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        uint32_t ah[4], al[4], bh[4], bl[4];
        a_rows(ah, DYh, LDP, r0, ks, lane);
        a_rows(al, DYl, LDP, r0, ks, lane);
        b_rows(bh, Hh, LDP, n0, ks, lane);
        b_rows(bl, Hl, LDP, n0, ks, lane);
        mma_2split(tmp, ah, al, bh, bl);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int l = r0 + g8 + 8 * r;
        const float e = expf(acs[l]);
        float gp = 0.f;
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {
          const float2 cv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  Cs + l * LDN + n0 + qq * 8 + t2));
          gp += cv.x * tmp[qq][2 * r] + cv.y * tmp[qq][2 * r + 1];
          dC_run[ui][qq][2 * r] += e * tmp[qq][2 * r];
          dC_run[ui][qq][2 * r + 1] += e * tmp[qq][2 * r + 1];
        }
        gp += __shfl_xor_sync(0xffffffffu, gp, 1);
        gp += __shfl_xor_sync(0xffffffffu, gp, 2);
        if ((lane & 3) == 0) gpart[(u >> 2) * L + l] = gp;
      }
    }
    __syncthreads();

    // ---- the gradient of acum, its reverse cumsum over the chunk (two
    // warp scans), ddt and this head's share of dA; every sum in a fixed
    // order ----
    float gac = 0.f, zz = 0.f, colv = 0.f;
    if (t < L) {
      float zs = 0.f, gi = 0.f, cole = 0.f, rowe = 0.f;
#pragma unroll
      for (int pb = 0; pb < P / 16; ++pb) zs += zpart[pb * L + t];
#pragma unroll
      for (int nb = 0; nb < N / 16; ++nb) gi += gpart[nb * L + t];
      for (int jb = t >> 4; jb < 4; ++jb) {
        colv += vpart[jb * L + t];
        cole += ecpart[jb * L + t];
      }
      for (int ib = 0; ib <= (t >> 4); ++ib) rowe += erpart[ib * L + t];
      const float rest = a_end - acs[t];
      zz = expf(fmaxf(rest, -60.f)) * zs;
      const float s = rest >= -60.f ? dts[t] * zz : 0.f;
      gac = rowe - cole + expf(acs[t]) * gi - s;
      const float ss = warp_sum(s);
      if (lane == 0) scr[warp] = ss;
    }
    __syncthreads();
    float ga = 0.f;
    if (t < L) {
      if (t == L - 1) {
        float ghs = 0.f;
        for (int w = 0; w < BT_W; ++w) ghs += red[w];
        gac += expf(a_end) * ghs + scr[0] + scr[1];
      }
      ga = gac;   // suffix sums inside each warp
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, ga, o);
        if (lane + o < 32) ga += v;
      }
      if (lane == 0) scr[2 + warp] = ga;
    }
    __syncthreads();
    if (t < L) {
      if (warp == 0) ga += scr[3];
      if (t < live) ddt[(row0 + t) * H + h] = a_h * ga + colv + zz;
      const float da = warp_sum(dts[t] * ga);
      if (lane == 0) scr[4 + warp] = da;
    }
    __syncthreads();
    if (t == 0) dA_part[blk] = scr[4] + scr[5];
  }

  // ---- the slice's dB and dC, one fp32 partial ----
  const int GS = G * nsl;
#pragma unroll
  for (int ui = 0; ui < UB; ++ui) {
    const int u = warp + BT_W * ui;
    if (u >= Lay::BC_UNITS) break;
    const int r0 = (u & 3) * 16, n0 = (u >> 2) * 16;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g8 + 8 * r;
      if (row >= live) continue;
      const size_t at = ((row0 + row) * GS + blockIdx.x) * N + n0 + t2;
#pragma unroll
      for (int qq = 0; qq < 2; ++qq) {
        *reinterpret_cast<float2*>(dB_part + at + qq * 8) =
            make_float2(dB_run[ui][qq][2 * r], dB_run[ui][qq][2 * r + 1]);
        *reinterpret_cast<float2*>(dC_part + at + qq * 8) =
            make_float2(dC_run[ui][qq][2 * r], dC_run[ui][qq][2 * r + 1]);
      }
    }
  }
}

int bw_tc_smem(int P, int N) {
  if (P == 64 && N == 128) return BwTc<64, 128>::SMEM;
  if (P == 16 && N == 16) return BwTc<16, 16>::SMEM;
  return 0;
}

// Which design serves the backward at (P, N, dtype): bf16 on the tensor
// cores (DESIGN_MMA_SYNC) at the (P, N) the stage (c') kernel is
// instantiated for -- mamba2's (64, 128) and the reference's test widths
// (16, 16); fp32, and bf16 at other P and N (multiples of 4),
// on the CUDA cores with fp32 math, where stage (c') fits the shared
// memory.  No launch falls back to another.
int ssd_bwd_design(int P, int N, int dtype) {
  if (P < 4 || P % 4 != 0 || N < 4 || N % 4 != 0) return DESIGN_NONE;
  if (dtype == DTYPE_BF16 && bw_tc_smem(P, N) > 0) return DESIGN_MMA_SYNC;
  if ((dtype == DTYPE_F32 || dtype == DTYPE_BF16) &&
      bw_chunk_smem(P, N) <= MAX_SMEM)
    return DESIGN_CUDA_CORES;
  return DESIGN_NONE;
}

// the number of dB / dC partials per group of the design at (H / G, P, N,
// dtype): one per head on the CUDA cores, one per slice of heads on the
// tensor cores
int ssd_bwd_slices(int hpg, int P, int N, int dtype) {
  switch (ssd_bwd_design(P, N, dtype)) {
    case DESIGN_MMA_SYNC:
      return hpg / ssd_bwd_heads(hpg);
    case DESIGN_CUDA_CORES:
      return hpg;
  }
  return 0;
}

struct SsdBwdArgs {
  const void *x, *Bm, *Cm;
  const float *dt, *A, *dy, *dh_final, *states, *aend;
  void *dx, *dB, *dC;
  float *ddt, *dA, *dh0, *gstates, *dB_part, *dC_part, *dA_part;
  int B, S, H, P, G, N, nc;
};

// the shared-memory limit of ssd_bwd_state_tc_kernel, which every (P, N)
// launches: one record of what it was raised to, so that it only grows
int allow_state_tc_smem(int bytes) {
  static int configured = 0;
  return allow_smem(ssd_bwd_state_tc_kernel, bytes, configured);
}

template <int P, int N>
int launch_bwd_tc(const SsdBwdArgs& a, cudaStream_t st) {
  static int cfg_c = 0;
  const int ba = bw_state_tc_smem(a.P, a.N), bc = BwTc<P, N>::SMEM;
  int rc = allow_state_tc_smem(ba);
  if (rc == 0) rc = allow_smem(ssd_bwd_tc_kernel<P, N>, bc, cfg_c);
  if (rc != 0) return rc;
  ssd_bwd_state_tc_kernel<<<dim3(a.H, a.nc, a.B), TC_NT, ba, st>>>(
      a.dt, a.A, (const bf16*)a.Cm, a.dy, a.gstates, a.S, a.H, a.P, a.G,
      a.N);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  ssd_bwd_pass_kernel<<<dim3((a.N * a.P / 4 + PASS_NT - 1) / PASS_NT, a.H,
                             a.B),
                        PASS_NT, 0, st>>>(a.gstates, a.aend, a.dh_final,
                                          a.dh0, a.nc, a.H, a.N * a.P);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int hpg = a.H / a.G, k = ssd_bwd_heads(hpg), nsl = hpg / k;
  ssd_bwd_tc_kernel<P, N><<<dim3(a.G * nsl, a.nc, a.B), BT_NT, bc, st>>>(
      (const bf16*)a.x, a.dt, a.A, (const bf16*)a.Bm, (const bf16*)a.Cm,
      a.dy, a.states, a.gstates, (bf16*)a.dx, a.ddt, a.dB_part, a.dC_part,
      a.dA_part, a.S, a.H, a.G, k);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const size_t n4 = (size_t)a.B * a.S * a.G * a.N / 4;
  ssd_bwd_group_kernel<bf16><<<(unsigned)((n4 + PASS_NT - 1) / PASS_NT),
                               PASS_NT, 0, st>>>(a.dB_part, a.dC_part,
                                                 (bf16*)a.dB, (bf16*)a.dC,
                                                 n4, nsl, a.G, a.N);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  ssd_bwd_da_kernel<<<(a.H + PASS_NT - 1) / PASS_NT, PASS_NT, 0, st>>>(
      a.dA_part, a.dA, a.B * a.nc, a.H);
  return (int)cudaGetLastError();
}

int launch_tensor_cores_bwd(const SsdBwdArgs& a, cudaStream_t st) {
  if (a.P == 64 && a.N == 128) return launch_bwd_tc<64, 128>(a, st);
  if (a.P == 16 && a.N == 16) return launch_bwd_tc<16, 16>(a, st);
  return ERR_UNSUPPORTED;
}

template <typename T>
int launch_bwd(const SsdBwdArgs& a, cudaStream_t st) {
  static int cfg_a = 0, cfg_c = 0;
  const int ba = bw_state_smem(a.P, a.N), bc = bw_chunk_smem(a.P, a.N);
  int rc = allow_smem(ssd_bwd_state_kernel<T>, ba, cfg_a);
  if (rc == 0) rc = allow_smem(ssd_bwd_chunk_kernel<T>, bc, cfg_c);
  if (rc != 0) return rc;
  const dim3 grid(a.H, a.nc, a.B);
  ssd_bwd_state_kernel<T><<<grid, CC_NT, ba, st>>>(
      a.dt, a.A, (const T*)a.Cm, a.dy, a.gstates, a.S, a.H, a.P, a.G, a.N);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  ssd_bwd_pass_kernel<<<dim3((a.N * a.P / 4 + PASS_NT - 1) / PASS_NT, a.H,
                             a.B),
                        PASS_NT, 0, st>>>(a.gstates, a.aend, a.dh_final,
                                          a.dh0, a.nc, a.H, a.N * a.P);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  ssd_bwd_chunk_kernel<T><<<grid, BW_NT, bc, st>>>(
      (const T*)a.x, a.dt, a.A, (const T*)a.Bm, (const T*)a.Cm, a.dy,
      a.states, a.gstates, (T*)a.dx, a.ddt, a.dB_part, a.dC_part, a.dA_part,
      a.S, a.H, a.P, a.G, a.N);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const size_t n4 = (size_t)a.B * a.S * a.G * a.N / 4;
  ssd_bwd_group_kernel<T><<<(unsigned)((n4 + PASS_NT - 1) / PASS_NT),
                            PASS_NT, 0, st>>>(a.dB_part, a.dC_part,
                                              (T*)a.dB, (T*)a.dC, n4,
                                              a.H / a.G, a.G, a.N);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  ssd_bwd_da_kernel<<<(a.H + PASS_NT - 1) / PASS_NT, PASS_NT, 0, st>>>(
      a.dA_part, a.dA, a.B * a.nc, a.H);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

// Which design serves (P, N, dtype): bf16 at P and N multiples of 16 on the
// tensor cores (DESIGN_MMA_SYNC), fp32 -- and bf16 at other P and N -- on
// the CUDA cores; both chunk-parallel.  No launch falls back to another.
int ssd_design(int P, int N, int dtype) {
  if (P < 4 || P % 4 != 0 || N < 4 || N % 4 != 0) return DESIGN_NONE;
  if (dtype == DTYPE_BF16 && P % 16 == 0 && N % 16 == 0 &&
      tc_output_smem(P, N) <= MAX_SMEM)
    return DESIGN_MMA_SYNC;
  if ((dtype == DTYPE_F32 || dtype == DTYPE_BF16) &&
      cc_output_smem(P, N) <= MAX_SMEM)
    return DESIGN_CUDA_CORES;
  return DESIGN_NONE;
}

struct SsdArgs {
  const void *x, *Bm, *Cm;
  const float *dt, *A, *h0;
  float *y, *hout, *states, *aend;
  int B, S, H, P, G, N, nc;
};

template <typename T>
int launch_cuda_cores(const SsdArgs& a, cudaStream_t st) {
  static int cfg_a = 0, cfg_c = 0;
  const int ba = cc_state_smem(a.P, a.N), bc = cc_output_smem(a.P, a.N);
  int rc = allow_smem(ssd_state_kernel<T>, ba, cfg_a);
  if (rc == 0) rc = allow_smem(ssd_output_kernel<T>, bc, cfg_c);
  if (rc != 0) return rc;
  const dim3 grid(a.H, a.nc, a.B);
  ssd_state_kernel<T><<<grid, CC_NT, ba, st>>>(
      (const T*)a.x, a.dt, a.A, (const T*)a.Bm, a.states, a.aend, a.S, a.H,
      a.P, a.G, a.N);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  ssd_pass_kernel<<<dim3((a.N * a.P / 4 + PASS_NT - 1) / PASS_NT, a.H, a.B),
                    PASS_NT, 0, st>>>(a.states, a.aend, a.h0, a.hout, a.nc,
                                      a.H, a.N * a.P);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  ssd_output_kernel<T><<<grid, CC_NT, bc, st>>>(
      (const T*)a.x, a.dt, a.A, (const T*)a.Bm, (const T*)a.Cm, a.states,
      a.y, a.S, a.H, a.P, a.G, a.N);
  return (int)cudaGetLastError();
}

int launch_tensor_cores(const SsdArgs& a, cudaStream_t st) {
  static int cfg_a = 0, cfg_c = 0;
  const int ba = tc_state_smem(a.P, a.N), bc = tc_output_smem(a.P, a.N);
  int rc = allow_smem(ssd_state_tc_kernel, ba, cfg_a);
  if (rc == 0) rc = allow_smem(ssd_output_tc_kernel, bc, cfg_c);
  if (rc != 0) return rc;
  const dim3 grid(a.H, a.nc, a.B);
  ssd_state_tc_kernel<<<grid, TC_NT, ba, st>>>(
      (const bf16*)a.x, a.dt, a.A, (const bf16*)a.Bm, a.states, a.aend, a.S,
      a.H, a.P, a.G, a.N);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  ssd_pass_kernel<<<dim3((a.N * a.P / 4 + PASS_NT - 1) / PASS_NT, a.H, a.B),
                    PASS_NT, 0, st>>>(a.states, a.aend, a.h0, a.hout, a.nc,
                                      a.H, a.N * a.P);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  ssd_output_tc_kernel<<<grid, TC_NT, bc, st>>>(
      (const bf16*)a.x, a.dt, a.A, (const bf16*)a.Bm, (const bf16*)a.Cm,
      a.states, a.y, a.S, a.H, a.P, a.G, a.N);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, S, H, P) and B/C (B, S, G, N) in one dtype (fp32 or bf16); dt
// (B, S, H), A (H,), h0 (B, H, N, P) or null, y (B, S, H, P) and hout
// (B, H, N, P) fp32; scratch: states (B, n_chunks, H, N, P) and aend (B,
// n_chunks, H) fp32, n_chunks = ceil(S / 64) (repro_ssd_chunk()).  All
// contiguous and 16-byte aligned.  Three launches on `stream`.  Returns 0,
// a cudaError_t, or ERR_UNSUPPORTED.  Does not synchronise.
extern "C" int repro_ssd_fwd(const void* x, const float* dt, const float* A,
                             const void* Bm, const void* Cm, const float* h0,
                             float* y, float* hout, float* states,
                             float* aend, int n_chunks, int B, int S, int H,
                             int P, int G, int N, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || B > 65535 ||
      H > 65535 || n_chunks != (S + SSD_C - 1) / SSD_C || n_chunks > 65535)
    return ERR_UNSUPPORTED;
  const SsdArgs a{x, Bm, Cm, dt, A, h0, y, hout, states, aend,
                  B, S, H, P, G, N, n_chunks};
  cudaStream_t st = (cudaStream_t)stream;
  switch (ssd_design(P, N, dtype)) {
    case DESIGN_MMA_SYNC:
      return launch_tensor_cores(a, st);
    case DESIGN_CUDA_CORES:
      return dtype == DTYPE_F32 ? launch_cuda_cores<float>(a, st)
                                : launch_cuda_cores<bf16>(a, st);
  }
  return ERR_UNSUPPORTED;
}

// The chunk length of repro_ssd_fwd's scratch tensors.
extern "C" int repro_ssd_chunk() { return SSD_C; }

// The design that repro_ssd_fwd launches for (P, N, dtype): one of the
// DESIGN_* codes of common.cuh.
extern "C" int repro_ssd_design(int P, int N, int dtype) {
  return ssd_design(P, N, dtype);
}

// x, B/C in one dtype (fp32 or bf16) as repro_ssd_fwd took them, dt, A, h0
// likewise; dy (B, S, H, P) fp32; dh_final (B, H, N, P) fp32 or null (zero);
// states and aend: repro_ssd_fwd's scratch after the call (the state
// entering each chunk, each chunk's acum_end).  Outputs: dx (x's dtype), ddt
// (B, S, H) fp32, dA (H,) fp32, dB / dC (B's dtype), dh0 (B, H, N, P) fp32
// or null.  Scratch: gstates (B, n_chunks, H, N, P), dB_part / dC_part (B,
// S, G * repro_ssd_bwd_slices(), N), dA_part (B, n_chunks, H), all fp32.
// All contiguous and 16-byte aligned.  Five launches on `stream`.  Returns
// 0, a cudaError_t, or ERR_UNSUPPORTED.  Does not synchronise.
extern "C" int repro_ssd_bwd(const void* x, const float* dt, const float* A,
                             const void* Bm, const void* Cm, const float* dy,
                             const float* dh_final, const float* states,
                             const float* aend, void* dx, float* ddt,
                             float* dA, void* dB, void* dC, float* dh0,
                             float* gstates, float* dB_part, float* dC_part,
                             float* dA_part, int n_chunks, int B, int S,
                             int H, int P, int G, int N, int dtype,
                             void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || B > 65535 ||
      H > 65535 || n_chunks != (S + SSD_C - 1) / SSD_C || n_chunks > 65535)
    return ERR_UNSUPPORTED;
  const SsdBwdArgs a{x,     Bm,      Cm,      dt,      A,       dy,
                     dh_final, states, aend,  dx,      dB,      dC,
                     ddt,   dA,      dh0,     gstates, dB_part, dC_part,
                     dA_part, B,     S,       H,       P,       G,
                     N,     n_chunks};
  cudaStream_t st = (cudaStream_t)stream;
  switch (ssd_bwd_design(P, N, dtype)) {
    case DESIGN_MMA_SYNC:
      return launch_tensor_cores_bwd(a, st);
    case DESIGN_CUDA_CORES:
      return dtype == DTYPE_F32 ? launch_bwd<float>(a, st)
                                : launch_bwd<bf16>(a, st);
  }
  return ERR_UNSUPPORTED;
}

// The design that repro_ssd_bwd launches for (P, N, dtype).
extern "C" int repro_ssd_bwd_design(int P, int N, int dtype) {
  return ssd_bwd_design(P, N, dtype);
}

// The number of dB / dC partials per group (the slices of repro_ssd_bwd's
// scratch) for H / G heads a group at (P, N, dtype); 0 where no design
// serves it.
extern "C" int repro_ssd_bwd_slices(int hpg, int P, int N, int dtype) {
  return hpg > 0 ? ssd_bwd_slices(hpg, P, N, dtype) : 0;
}
