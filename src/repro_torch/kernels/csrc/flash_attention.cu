// Fused GQA attention forward (online softmax) for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py (_flash_kernel):
// same function -- 1/sqrt(D) scale, optional tanh soft-cap, causal and/or
// sliding-window mask (0 <= q - k < window), fp32 accumulation,
// NEG_INF = -1e30, division by max(l, 1e-30) -- but laid out for this card.
//
// What bounds it here: operations.  Prefill attention does 4*S*T*D flops per
// head on S*D-sized inputs, far above the card's flops-per-byte ridge, so
// the score matrix must never reach device memory and every K/V byte read
// must be reused as often as possible.
//
// What the design does about it:
//   * The TPU kernel's sequential innermost grid axis with (m, l, acc) in
//     scratch memory becomes a loop over key tiles inside one thread block;
//     m, l and the output accumulator live in registers for the whole loop.
//   * A block owns BM = 64 consecutive rows of the flattened (position,
//     group-head) axis of one KV head: row r is position r / G, query head
//     kv_head * G + r % G.  With q laid out (B, S, H, D) those rows are
//     contiguous in memory, every G is legal (MQA included), and all G
//     heads of a group share each K/V tile in shared memory.
//   * fp32 inputs: both products are register-tiled on the CUDA cores (each
//     of 16 x 16 threads owns a 4 x 4 score tile and a 4 x D/16 output
//     tile), reading operands from padded shared memory with 16-byte loads,
//     so fp32 never rounds through TF32.
//   * bf16 inputs at D = 64, 128 (flash_fwd_wgmma_kernel; llama's heads),
//     160 (stablelm-12b's) and 256 (recurrentgemma-2b's), served and
//     trained: warpgroup products fed by the TMA, below.
//   * bf16 inputs at D = 32 (flash_fwd_mma_kernel): both products run on
//     the tensor cores with warp-level
//     mma.sync (m16n8k16, fp32 accumulate).  Each of 4 warps owns 16 query
//     rows: its Q fragments stay in registers for the whole key loop, the
//     score tile never leaves registers (the accumulator layout of QK^T is
//     the A-operand layout of PV, so the probabilities are packed to bf16
//     in place, as the reference casts them before the PV product), K
//     and V fragments come from padded shared memory with ldmatrix (V
//     transposed on the way), and the next K/V tile is copied in with
//     cp.async while the current one is computed.
//   * The fp32 path takes D = 160 and 256 as it is (its tiles fill 143 /
//     212 KB of shared memory); its threads own D / 16 output columns in
//     float4 slices, or float2 slices where D / 16 is not a multiple of 4
//     (D = 32, 160).
//   * Key tiles that the causal or window mask kills entirely are never
//     loaded (the loop's bounds skip them); ragged last tiles in S*G and T
//     are masked, so no divisibility is required (a superset of the
//     reference, which asserts it).
//   * Heaviest causal row tiles are scheduled first.
//
// flash_fwd_wgmma_kernel<D> (bf16, D = 64, 128, 160 and 256).  Also bounded
// by operations; mma.sync cannot reach Hopper's tensor-core rate, and in the
// design above each K fragment loaded by ldmatrix feeds only 16 query rows
// (at D = 160 it ran at 6.5x its bound, 2.5x the library's attention; at
// D = 256 6.9x).  What this design does about it:
//   * One block owns BM = 128 query positions of ONE query head and walks
//     the live key tiles (BN = 128, 64 at D = 256) of its KV head.  Per-head
//     tiles are TMA
//     boxes: q is the 3-D tensor map (H*D, S, B) with boxes (64, 128, 1) at
//     column h*D (+64), k and v the maps (K*D, T, B).  The G heads of a
//     group re-read each K/V tile from L2, not from device memory.  Ragged
//     S and T are zero-filled by the TMA; the mask decides what counts.
//   * D = 160 is not a multiple of the 64-column panel: the head is five
//     32-column panels, boxes (32, rows, 1) with the 64-byte swizzle
//     (hopper.cuh).  Q K^T walks all ten k-steps, two a panel; O += P V is
//     one m64n160k16 per 16 keys over the five panels, its descriptor's LBO
//     stepping from panel to panel -- 9 % faster than one m64n32k16 a
//     panel, timed in turns on the H100 (PERF.md).  A consumer
//     thread holds 80 fp32 of output, 64 of S and 32 packed P.  Shared
//     memory: Q takes 40,960 bytes, and three stages of 128 keys (245,760)
//     do not fit beside it; two stages of 128 keys (205,864 bytes in all)
//     were 2.5 % (1 x 2048) and 5.7 % (2 x 4096) faster than three of 64
//     in the same probe, so two of 128 it is.
//   * D = 256 is four 64-column panels.  The output accumulator is 128 fp32
//     a thread, and Q takes 65,536 bytes; one stage of 128 keys of K and V
//     would take 131,072, so the key tiles are 64 keys (S = Q K^T is
//     m64n64k16 over 16 k-steps, O += P V one m64n64k16 per panel and 16
//     keys) in two stages: 197 KB of shared memory, and 128 + 32 of S + 16
//     of packed P registers a consumer thread.  O += P V is one m64n256k16
//     per 16 keys over the four panels, the descriptor's LBO stepping from
//     panel to panel: bit-identical to one m64n64k16 a panel and 2.2 %
//     faster, timed in turns on the H100 by scripts/probe_variant.py
//     (fwd_d256_pv; PERF.md).
//   * Three warpgroups (384 threads).  Warpgroup 0 is the producer: it
//     gives registers back (setmaxnreg 24) and one thread keeps a ring of
//     STAGES K/V tiles in flight (three; two at D = 160 and 256), each
//     completed through a "full" mbarrier and released through an "empty"
//     one.
//     Warpgroups 1 and 2 are consumers (setmaxnreg 240), 64 query rows each.
//   * S = Q K^T is wgmma m64nBNk16 with both operands in shared memory
//     (K-major, 128-byte swizzle, D/16 k-steps); O += P V is wgmma
//     m64n64k16 per 64-column panel of V (at D = 160 the 64-byte swizzle
//     and one m64n160k16, above) with P as the A operand from
//     registers (the accumulator layout of S is the A-fragment layout, as
//     with mma.sync) and V MN-major (the transposed-B flag).  m, l and the
//     output accumulator stay in registers; masks are evaluated only on the
//     tiles that the causal / window / ragged edges cross.
//   * The softmax of one consumer warpgroup overlaps the other's products.
//     Within a warpgroup the two products and the softmax run in turn
//     (issuing S_j = Q K_j^T with O += P_{j-1} V_{j-1} and computing the
//     softmax of S_j under the second product was slower on the H100, and
//     so were explicit turns of the two warpgroups on the tensor cores
//     through named barriers, by 1.2-1.6x; PERF.md).
//   * The elementwise passes (scale and soft-cap, mask, exponentials) are
//     branch-free blocks: the soft-cap and the mask are decided once per
//     tile.  Per-element branches on them cost about a fifth of the
//     kernel's time (PERF.md, the bring-up of this design).
//   * The tensor maps are encoded per call on the host and passed as
//     __grid_constant__ kernel parameters; the encoder comes from
//     cudaGetDriverEntryPoint (hopper.cuh), the link line is unchanged.
//   * ptxas (sm_90a, -Xptxas -v, nvcc 12.9): 168 registers at D = 64, 128
//     and 160 -- the bound of a 384-thread block; setmaxnreg then moves the
//     producer to 24 and the consumers to 240 -- and 0 bytes of spill.
//     chip_smoke.py prints both (kernel_cases, ptxas) and fails on a spill.
//
// repro_flash_attention_fwd_stats is the same launch that also writes each
// row's softmax statistics (m, l) for the backward kernels in
// flash_attention_bwd.cu; it replaces the TPU kernel
// repro/kernels/flash_attention_bwd.py (_fwd / _fwd_kernel).  The kernels
// keep m and l in registers anyway, so only the flush changes: 8 bytes per
// query row against 2*D bytes of q and o.  With null statistics pointers
// (repro_flash_attention_fwd, the serving path) nothing else changes.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;

constexpr int BM = 64;    // query rows per block
constexpr int BN = 64;    // keys per tile
constexpr int NT = 256;   // threads per block: 16 (rows) x 16 (columns)
constexpr int RPT = 4;    // rows per thread
constexpr int KPT = 4;    // keys per thread

template <int D> constexpr int smem_floats() {
  return (BM + 2 * BN) * (D + 4) + BM * (BN + 4);
}
static_assert(smem_floats<256>() * 4 <= 232448, "fp32 tiles exceed the SM");
static_assert(smem_floats<160>() * 4 <= 232448, "fp32 tiles exceed the SM");

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out, int S,
                 int Tk, int H, int K, int G, int causal, int window,
                 float scale, float softcap) {
  constexpr int LD = D + 4;    // padded strides keep 16-byte loads
  constexpr int LDP = BN + 4;  // conflict-free across a quarter warp
  constexpr int CPT = D / 16;  // output columns per thread
  constexpr int VW = CPT % 4 == 0 ? 4 : 2;  // float4 or float2 slices
  constexpr int NG = CPT / VW;
  static_assert(D % 32 == 0 && CPT % VW == 0,
                "the column split must cover all D columns");

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * LD;
  float* Vs = Ks + BN * LD;
  float* Ps = Vs + BN * LD;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int M = S * G;  // flattened (position, group-head) rows
  const int r0 = tile * BM;

  const size_t q_row = (size_t)H * D;  // stride between positions
  const size_t kv_row = (size_t)K * D;
  const T* qb = q + (size_t)b * S * q_row + (size_t)kh * G * D;
  const T* kb = k + (size_t)b * Tk * kv_row + (size_t)kh * D;
  const T* vb = v + (size_t)b * Tk * kv_row + (size_t)kh * D;
  T* ob = o + (size_t)b * S * q_row + (size_t)kh * G * D;

  load_rows<T, D, NT>(
      Qs, qb, BM,
      [&](int r) {
        const int rr = r0 + r;
        return (size_t)(rr / G) * q_row + (size_t)(rr % G) * D;
      },
      [&](int r) { return r0 + r < M; });

  int pos[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = min(r0 + ty + 16 * i, M - 1);
    pos[i] = r / G;
  }
  const int p_lo = r0 / G;
  const int p_hi = min(r0 + BM - 1, M - 1) / G;

  // key range that any row of this tile can see
  int n_begin = 0;
  int n_end = Tk;
  if (causal) n_end = min(Tk, p_hi + 1);
  if (window > 0) {
    const int lo = p_lo - window + 1;
    if (lo > 0) n_begin = (lo / BN) * BN;
  }

  float m_i[RPT], l_i[RPT], acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;  // partial over this thread's key columns
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    __syncthreads();  // previous tile's PV product has finished with Vs, Ps
    load_rows<T, D, NT>(
        Ks, kb, BN, [&](int r) { return (size_t)(n0 + r) * kv_row; },
        [&](int r) { return n0 + r < Tk; });
    load_rows<T, D, NT>(
        Vs, vb, BN, [&](int r) { return (size_t)(n0 + r) * kv_row; },
        [&](int r) { return n0 + r < Tk; });
    __syncthreads();

    // ---- scores: 4 x 4 tile per thread, rows ty + 16 i, keys tx + 16 j ----
    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;

#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[RPT], ka[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        ka[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          s[i][j] += qa[i].x * ka[j].x;
          s[i][j] += qa[i].y * ka[j].y;
          s[i][j] += qa[i].z * ka[j].z;
          s[i][j] += qa[i].w * ka[j].w;
        }
    }

    // ---- scale, soft-cap, mask; online-softmax update ----
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kpos = n0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const int diff = pos[i] - kpos;
        bool dead = kpos >= Tk;
        if (causal) dead = dead || diff < 0;
        if (window > 0) dead = dead || diff >= window;
        x = dead ? NEG_INF : x;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 threads of a row are the 16 lanes of a half warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = expf(m_i[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = Elem<T>::round_through(p);
      }
      l_i[i] = l_i[i] * corr + psum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // ---- acc += P V: rows ty + 16 i, columns g*16*VW + tx*VW + e ----
#pragma unroll 2
    for (int n = 0; n < BN; n += 4) {
      float pa[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * LDP + n);
        pa[i][0] = p4.x; pa[i][1] = p4.y; pa[i][2] = p4.z; pa[i][3] = p4.w;
      }
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        float vv[CPT];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float* vp = Vs + (n + nn) * LD + g * 16 * VW + tx * VW;
          if constexpr (VW == 4) {
            const float4 x = *reinterpret_cast<const float4*>(vp);
            vv[g * VW + 0] = x.x; vv[g * VW + 1] = x.y;
            vv[g * VW + 2] = x.z; vv[g * VW + 3] = x.w;
          } else {
            const float2 x = *reinterpret_cast<const float2*>(vp);
            vv[g * VW + 0] = x.x; vv[g * VW + 1] = x.y;
          }
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] += pa[i][nn] * vv[c];
      }
    }
  }

  // ---- flush: out = acc / max(l, 1e-30) ----
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float l = l_i[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    const int r = r0 + ty + 16 * i;
    if (r < M) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      T* orow = ob + (size_t)(r / G) * q_row + (size_t)(r % G) * D;
      if (m_out != nullptr && tx == 0) {
        const size_t st = ((size_t)b * S + r / G) * H + (size_t)kh * G + r % G;
        m_out[st] = m_i[i];
        l_out[st] = fmaxf(l, 1e-30f);
      }
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < VW; ++e)
          orow[g * 16 * VW + tx * VW + e] =
              Elem<T>::from_float(acc[i][g * VW + e] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, D = 32: mma.sync
// ---------------------------------------------------------------------------
constexpr int MMA_NT = 128;  // 4 warps x 16 query rows = BM

template <int D>
__global__ void __launch_bounds__(MMA_NT)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int S, int Tk, int H, int K, int G, int causal,
                     int window, float scale, float softcap) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + 8;    // padded row (bf16): conflict-free fragments
  constexpr int KS = D / 16;   // k-steps of QK^T
  constexpr int NB = BN / 8;   // 8-key column blocks of the score tile
  constexpr int DB = D / 8;    // 8-wide column blocks of the output
  constexpr int VPR = D / 8;   // 16-byte vectors per row

  static_assert(KS % 2 == 0 && DB % 2 == 0, "k-steps and column blocks "
                "are taken in pairs");

  constexpr int TILE = BN * LD;  // one K or V tile; two buffers of each
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ksm = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vsm = Ksm + 2 * TILE;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qr = lane >> 2;         // fragment row (and row + 8)
  const int qc = (lane & 3) * 2;    // fragment column pair
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int M = S * G;
  const int r0 = tile * BM;

  const size_t q_row = (size_t)H * D;
  const size_t kv_row = (size_t)K * D;
  const bf16* qb = q + (size_t)b * S * q_row + (size_t)kh * G * D;
  const bf16* kb = k + (size_t)b * Tk * kv_row + (size_t)kh * D;
  const bf16* vb = v + (size_t)b * Tk * kv_row + (size_t)kh * D;
  bf16* ob = o + (size_t)b * S * q_row + (size_t)kh * G * D;

  // this thread's two query rows (flattened), their positions and memory
  int row[2], pos[2];
  const bf16* qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = r0 + warp * 16 + qr + 8 * h;
    const int rr = min(row[h], M - 1);
    pos[h] = rr / G;
    qp[h] = qb + (size_t)(rr / G) * q_row + (size_t)(rr % G) * D;
  }

  // Q fragments: a0 (row, k..k+1), a1 (row+8, same), a2 (row, k+8..9), a3;
  // held in registers for the whole key loop
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool live = row[h] < M;
      const uint32_t* p =
          reinterpret_cast<const uint32_t*>(qp[h] + ks * 16 + qc);
      qa[ks][h] = live ? p[0] : 0u;
      qa[ks][2 + h] = live ? p[4] : 0u;  // 8 elements further
    }

  const int p_lo = r0 / G;
  const int p_hi = min(r0 + BM - 1, M - 1) / G;
  int n_begin = 0;
  int n_end = Tk;
  if (causal) n_end = min(Tk, p_hi + 1);
  if (window > 0) {
    const int lo = p_lo - window + 1;
    if (lo > 0) n_begin = (lo / BN) * BN;
  }

  float m_i[2] = {NEG_INF, NEG_INF};
  float l_i[2] = {0.f, 0.f};  // partial over this thread's key columns
  float acc[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // copy the K and V tiles that start at key n0 into buffer `buf`
  auto fetch = [&](int n0, int buf) {
    for (int idx = threadIdx.x; idx < BN * VPR; idx += MMA_NT) {
      const int r = idx / VPR;
      const int c = (idx % VPR) * 8;
      const bool live = n0 + r < Tk;
      const size_t src = (size_t)(live ? n0 + r : 0) * kv_row + c;
      cp_async16(Ksm + buf * TILE + r * LD + c, kb + src, live ? 16 : 0);
      cp_async16(Vsm + buf * TILE + r * LD + c, vb + src, live ? 16 : 0);
    }
    cp_async_commit();
  };

  if (n_begin < n_end) fetch(n_begin, 0);
  int buf = 0;
  for (int n0 = n_begin; n0 < n_end; n0 += BN, buf ^= 1) {
    // the next tile travels while this one is computed
    if (n0 + BN < n_end) {
      fetch(n0 + BN, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Ks = Ksm + buf * TILE;
    const bf16* Vs = Vsm + buf * TILE;

    // ---- scores: S = Q K^T, 16 x BN per warp ----
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int ks = 0; ks < KS; ks += 2) {
        // B fragments of K^T for two k-steps: matrices (keys nb*8.., d
        // ks*16 + 0, 8, 16, 24..): (k pair, n = key) is a row-major 8x8
        // read
        uint32_t kf[4];
        ldmatrix_x4(kf, Ks + (nb * 8 + (lane & 7)) * LD + ks * 16 +
                            (lane >> 3) * 8);
        mma_m16n8k16(s[nb], qa[ks], kf[0], kf[1]);
        mma_m16n8k16(s[nb], qa[ks + 1], kf[2], kf[3]);
      }
    }

    // ---- scale, soft-cap, mask; online-softmax update ----
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = n0 + nb * 8 + qc + e;
          float x = s[nb][2 * h + e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          const int diff = pos[h] - kpos;
          bool dead = kpos >= Tk;
          if (causal) dead = dead || diff < 0;
          if (window > 0) dead = dead || diff >= window;
          x = dead ? NEG_INF : x;
          s[nb][2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      // a row's columns are spread over the 4 lanes of a quad
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[h], mx);
      corr[h] = __expf(m_i[h] - m_new);
      m_i[h] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = __expf(s[nb][2 * h + e] - m_new);
          s[nb][2 * h + e] = p;
          psum += p;
        }
      l_i[h] = l_i[h] * corr[h] + psum;
    }
#pragma unroll
    for (int j = 0; j < DB; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // ---- acc += P V: the score accumulators are PV's A fragments ----
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      pa[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      pa[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pa[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
      for (int j = 0; j < DB; j += 2) {
        // matrices: (keys 0-7, cols j), (keys 8-15, cols j),
        //           (keys 0-7, cols j+1), (keys 8-15, cols j+1)
        const int mat = lane >> 3;
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vs + (ks * 16 + (mat & 1) * 8 + (lane & 7)) * LD +
                                  (j + (mat >> 1)) * 8);
        mma_m16n8k16(acc[j], pa, vf[0], vf[1]);
        mma_m16n8k16(acc[j + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer: it may refill
  }

  // ---- flush: out = acc / max(l, 1e-30) ----
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_i[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (row[h] < M) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      bf16* orow = ob + (size_t)(row[h] / G) * q_row +
                   (size_t)(row[h] % G) * D;
      if (m_out != nullptr && (lane & 3) == 0) {
        const size_t st = ((size_t)b * S + row[h] / G) * H +
                          (size_t)kh * G + row[h] % G;
        m_out[st] = m_i[h];
        l_out[st] = fmaxf(l, 1e-30f);
      }
#pragma unroll
      for (int j = 0; j < DB; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8 + qc) =
            pack_bf16(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* m_out, float* l_out, int B, int S, int Tk, int H, int K,
               int causal, int window, float softcap, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr int bytes = 4 * BN * (D + 8) * (int)sizeof(bf16);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int G = H / K;
  const dim3 grid((S * G + BM - 1) / BM, K, B);
  flash_fwd_mma_kernel<D><<<grid, MMA_NT, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, m_out, l_out,
      S, Tk, H, K, G, causal, window, 1.0f / sqrtf((float)D), softcap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, D = 64, 128, 160 and 256: warpgroup products fed by the TMA
// ---------------------------------------------------------------------------
constexpr int WG_BM = 128;     // query positions per block: 2 warpgroups x 64
constexpr int WG_NT = 384;     // producer warpgroup + 2 consumer warpgroups

// byte offsets from the block's 1024-aligned shared-memory base: Q (NP
// panels of 128 rows), then STAGES x NP panels of K, the same of V, then
// the barriers.  A panel is PW columns (hopper.cuh): 64 at D = 64 / 128 /
// 256, 32 at D = 160.  K/V tiles in flight: three of 128 keys at D <= 128;
// at D = 160 three (245,760 bytes) do not fit beside Q (40,960), so two
// (see the note at the top for why not three of 64 keys); at D = 256 one
// stage of 128 keys is 131,072 bytes beside Q's 65,536, so two of 64.
template <int D> struct FwdLayout {
  static constexpr int PW = hopper::kPanelCols<D>;
  static constexpr int NP = D / PW;             // column panels
  static constexpr int RB = 2 * PW;             // bytes of a panel row
  static constexpr int BN = D > 160 ? 64 : 128; // keys per tile
  static constexpr int STAGES = D > 128 ? 2 : 3;
  static constexpr int Q_PANEL = WG_BM * RB;
  static constexpr int KV_PANEL = BN * RB;
  static constexpr int Q = 0;
  static constexpr int K = Q + NP * Q_PANEL;
  static constexpr int V = K + STAGES * NP * KV_PANEL;
  static constexpr int BAR = V + STAGES * NP * KV_PANEL;
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8 + 1024;
};
static_assert(FwdLayout<256>::BYTES <= 232448, "D = 256 tiles exceed the SM");
static_assert(FwdLayout<160>::BYTES <= 232448, "D = 160 tiles exceed the SM");
static_assert(FwdLayout<128>::BYTES <= 232448, "D = 128 tiles exceed the SM");

template <int D>
__global__ void __launch_bounds__(WG_NT, 1)
flash_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                       __grid_constant__ const CUtensorMap tk,
                       __grid_constant__ const CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       int S, int Tk, int H, int G, int causal, int window,
                       float scale, float softcap) {
  using namespace hopper;
  using Lay = FwdLayout<D>;
  constexpr int NP = Lay::NP;
  constexpr int PW = Lay::PW;
  constexpr int RB = Lay::RB;
  constexpr int STAGES = Lay::STAGES;
  constexpr int BN = Lay::BN;
  constexpr int KSP = PW / 16;      // k-steps of Q K^T per panel
  constexpr int NB = BN / 8;        // 8-key column blocks of S
  constexpr int PK = BN / 16;       // k-steps of P V
  constexpr int CB = PW / 8;        // 8-column blocks of a panel
  static_assert(NP * PW == D, "the panels must cover all D columns");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Lay::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;

  const int hq = blockIdx.x % H;                          // query head
  const int b = blockIdx.x / H;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * WG_BM;    // heaviest first
  const int kh = hq / G;
  int n_begin, n_end;
  live_key_tiles(m0, WG_BM, BN, Tk, causal, window, n_begin, n_end);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);    // lane 0 of each consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the K/V ring full ----
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      prefetch_tensor_map(&tq);
      prefetch_tensor_map(&tk);
      prefetch_tensor_map(&tv);
      mbar_arrive_expect_tx(q_full, WG_BM * D * 2);
      for (int p = 0; p < NP; ++p)
        tma_load_3d(sm + Lay::Q + p * Lay::Q_PANEL, &tq, q_full,
                    hq * D + p * PW, m0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int n0 = n_begin; n0 < n_end; n0 += BN) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], 2 * BN * D * 2);
        for (int p = 0; p < NP; ++p) {
          const int at = (stage * NP + p) * Lay::KV_PANEL;
          tma_load_3d(sm + Lay::K + at, &tk, &full[stage], kh * D + p * PW,
                      n0, b);
          tma_load_3d(sm + Lay::V + at, &tv, &full[stage], kh * D + p * PW,
                      n0, b);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    regs_alloc<240>();
    const int t = threadIdx.x - 128;
    const int cw = t >> 7;                // consumer warpgroup
    const int warp = (t >> 5) & 3;
    const int lane = t & 31;
    const int qc = (lane & 3) * 2;        // fragment column pair
    const int r_lo = m0 + cw * 64;        // this warpgroup's first row
    int row[2];
    row[0] = r_lo + warp * 16 + (lane >> 2);
    row[1] = row[0] + 8;

    float m_i[2] = {NEG_INF, NEG_INF};
    float l_i[2] = {0.f, 0.f};  // partial over this thread's key columns
    // output accumulator per panel: [j * 4 + e] is row row[e >> 1], column
    // p * PW + j * 8 + qc + (e & 1)
    float acc[NP][CB * 4];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < CB * 4; ++i) acc[p][i] = 0.f;

    const uint32_t q_addr = smem_u32(sm + Lay::Q) + cw * 64 * RB;
    mbar_wait(q_full, 0);
    // Per tile: S = Q K^T, the softmax, O += P V, in turn; the other
    // consumer warpgroup's products fill the tensor cores meanwhile.
    int stage = 0;
    uint32_t phase = 0;
    for (int n0 = n_begin; n0 < n_end; n0 += BN) {
      mbar_wait(&full[stage], phase);
      const uint32_t k_addr =
          smem_u32(sm + Lay::K) + stage * NP * Lay::KV_PANEL;
      const uint32_t v_addr =
          smem_u32(sm + Lay::V) + stage * NP * Lay::KV_PANEL;

      // ---- S = Q K^T (64 x BN per warpgroup), both operands K-major in
      // shared memory, all D / 16 k-steps over the NP panels; [nb * 4 + e]
      // is row row[e >> 1], key n0 + nb * 8 + qc + (e & 1) ----
      float s[NB * 4];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t kofs = (ks % KSP) * 32;
        wgmma_ss(s,
                 panel_desc<PW>(q_addr + (ks / KSP) * Lay::Q_PANEL + kofs, 16),
                 panel_desc<PW>(k_addr + (ks / KSP) * Lay::KV_PANEL + kofs,
                                16),
                 ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // ---- scale, soft-cap, mask; online-softmax update.  Each pass over
      // s is one branch-free block (the soft-cap and the mask are decided
      // once per tile), so the elements' arithmetic can interleave ----
      if (softcap > 0.f) {
        const float to_t = scale / softcap;
#pragma unroll
        for (int i = 0; i < NB * 4; ++i) s[i] = softcap * tanhf(s[i] * to_t);
      } else {
#pragma unroll
        for (int i = 0; i < NB * 4; ++i) s[i] *= scale;
      }
      const bool edge = n0 + BN > Tk ||
                        (causal && n0 + BN - 1 > r_lo) ||
                        (window > 0 && r_lo + 63 - n0 >= window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < NB * 4; ++i) {
          const int kpos = n0 + (i >> 2) * 8 + qc + (i & 1);
          const int diff = row[(i >> 1) & 1] - kpos;
          const bool dead = (kpos >= Tk) | ((causal != 0) & (diff < 0)) |
                            ((window > 0) & (diff >= window));
          s[i] = dead ? NEG_INF : s[i];
        }
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = NEG_INF;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          mx = fmaxf(mx, fmaxf(s[nb * 4 + 2 * h], s[nb * 4 + 2 * h + 1]));
        // a row's columns are spread over the 4 lanes of a quad
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_i[h], mx);
        corr[h] = __expf(m_i[h] - m_new);
        m_i[h] = m_new;
        float psum = 0.f;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = __expf(s[nb * 4 + 2 * h + e] - m_new);
            s[nb * 4 + 2 * h + e] = p;
            psum += p;
          }
        l_i[h] = l_i[h] * corr[h] + psum;
      }
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < CB; ++j) {
          acc[p][j * 4 + 0] *= corr[0];
          acc[p][j * 4 + 1] *= corr[0];
          acc[p][j * 4 + 2] *= corr[1];
          acc[p][j * 4 + 3] *= corr[1];
        }

      // ---- O += P V: P's bf16 A fragments straight from the accumulator
      // layout of S; V MN-major, per 16 keys one m64n64k16 per panel (D =
      // 64, 128), or one m64n160k16 / m64n256k16 over all the panels (D =
      // 160, 256) ----
      uint32_t pa[PK][4];
#pragma unroll
      for (int kk = 0; kk < PK; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PK; ++kk)
        wgmma_rs_panels<PW, NP>(acc, pa[kk], v_addr + kk * 16 * RB,
                                Lay::KV_PANEL);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
      if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // ---- flush: out = acc / max(l, 1e-30); statistics (B, S, H) ----
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_i[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (row[h] < S) {
        const float inv = 1.f / fmaxf(l, 1e-30f);
        const size_t at = ((size_t)b * S + row[h]) * H + hq;
        if (m_out != nullptr && (lane & 3) == 0) {
          m_out[at] = m_i[h];
          l_out[at] = fmaxf(l, 1e-30f);
        }
        __nv_bfloat16* orow = o + at * D;
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < CB; ++j)
            *reinterpret_cast<uint32_t*>(orow + p * PW + j * 8 + qc) =
                pack_bf16(acc[p][j * 4 + 2 * h] * inv,
                          acc[p][j * 4 + 2 * h + 1] * inv);
      }
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* m_out, float* l_out, int B, int S, int Tk, int H,
                 int K, int causal, int window, float softcap,
                 cudaStream_t stream) {
  constexpr int PW = FwdLayout<D>::PW;
  constexpr int BN = FwdLayout<D>::BN;
  CUtensorMap tq, tk, tv;
  int rc = hopper::make_tensor_map(&tq, q, B, S, H * D, WG_BM, PW);
  if (rc == 0) rc = hopper::make_tensor_map(&tk, k, B, Tk, K * D, BN, PW);
  if (rc == 0) rc = hopper::make_tensor_map(&tv, v, B, Tk, K * D, BN, PW);
  if (rc != 0) return rc;
  constexpr int bytes = FwdLayout<D>::BYTES;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(H * B, (S + WG_BM - 1) / WG_BM);
  flash_fwd_wgmma_kernel<D><<<grid, WG_NT, bytes, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, m_out, l_out, S, Tk, H, H / K, causal,
      window, 1.0f / sqrtf((float)D), softcap);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* m_out,
           float* l_out, int B, int S, int Tk, int H, int K, int causal,
           int window, float softcap, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int G = H / K;
  const dim3 grid((S * G + BM - 1) / BM, K, B);
  flash_fwd_kernel<T, D><<<grid, NT, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, m_out, l_out, S, Tk, H, K,
      G, causal, window, 1.0f / sqrtf((float)D), softcap);
  return (int)cudaGetLastError();
}

// Which design serves (D, dtype): fp32 on the CUDA cores at every D; bf16
// on warpgroup products fed by the TMA at D = 64, 128 (llama's heads), 160
// (stablelm-12b) and 256 (recurrentgemma-2b), on mma.sync at D = 32.  No
// launch falls back to another design.
int fwd_design(int D, int dtype) {
  const bool any_d =
      D == 32 || D == 64 || D == 128 || D == 160 || D == 256;
  if (dtype == DTYPE_F32) return any_d ? DESIGN_CUDA_CORES : DESIGN_NONE;
  if (dtype != DTYPE_BF16 || !any_d) return DESIGN_NONE;
  return D == 32 ? DESIGN_MMA_SYNC : DESIGN_WGMMA;
}

int dispatch(const void* q, const void* k, const void* v, void* o,
             float* m_out, float* l_out, int B, int S, int T, int H, int K,
             int D, int dtype, int causal, int window, float softcap,
             void* stream) {
  if (!shape_ok(B, S, T, H, K)) return ERR_UNSUPPORTED;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_FWD_ARGS \
  q, k, v, o, m_out, l_out, B, S, T, H, K, causal, window, softcap, st
  switch (fwd_design(D, dtype)) {
    case DESIGN_CUDA_CORES:
      switch (D) {
        case 32: return launch<float, 32>(REPRO_FWD_ARGS);
        case 64: return launch<float, 64>(REPRO_FWD_ARGS);
        case 128: return launch<float, 128>(REPRO_FWD_ARGS);
        case 160: return launch<float, 160>(REPRO_FWD_ARGS);
        case 256: return launch<float, 256>(REPRO_FWD_ARGS);
      }
      break;
    case DESIGN_MMA_SYNC:
      switch (D) {
        case 32: return launch_mma<32>(REPRO_FWD_ARGS);
      }
      break;
    case DESIGN_WGMMA:
      switch (D) {
        case 64: return launch_wgmma<64>(REPRO_FWD_ARGS);
        case 128: return launch_wgmma<128>(REPRO_FWD_ARGS);
        case 160: return launch_wgmma<160>(REPRO_FWD_ARGS);
        case 256: return launch_wgmma<256>(REPRO_FWD_ARGS);
      }
      break;
  }
#undef REPRO_FWD_ARGS
  return ERR_UNSUPPORTED;
}

}  // namespace

// q, o: (B, S, H, D); k, v: (B, T, K, D); all contiguous, same dtype.
// Returns 0, a cudaError_t, or ERR_UNSUPPORTED.  Does not synchronise.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int B, int S,
                                         int T, int H, int K, int D, int dtype,
                                         int causal, int window, float softcap,
                                         void* stream) {
  return dispatch(q, k, v, o, nullptr, nullptr, B, S, T, H, K, D, dtype,
                  causal, window, softcap, stream);
}

// The same, also writing each query row's softmax statistics for the
// backward kernels: m (running max of the masked, capped, scaled scores) and
// l = max(sum exp(s - m), 1e-30), both fp32 (B, S, H) -- the layout of q
// without its last axis, so the rows of one KV head are ordered as the
// kernels' flattened (position, group-head) axis.
extern "C" int repro_flash_attention_fwd_stats(
    const void* q, const void* k, const void* v, void* o, float* m, float* l,
    int B, int S, int T, int H, int K, int D, int dtype, int causal,
    int window, float softcap, void* stream) {
  return dispatch(q, k, v, o, m, l, B, S, T, H, K, D, dtype, causal, window,
                  softcap, stream);
}

// The design that repro_flash_attention_fwd(_stats) launches for (D, dtype):
// one of the DESIGN_* codes of common.cuh.
extern "C" int repro_flash_attention_fwd_design(int D, int dtype) {
  return fwd_design(D, dtype);
}
