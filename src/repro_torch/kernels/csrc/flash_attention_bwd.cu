// Fused GQA attention backward (dK/dV and dQ) for sm_90a.
//
// Replaces the TPU kernels of repro/kernels/flash_attention_bwd.py
// (_bwd_dkv_kernel and _bwd_dq_kernel, launched from _bwd): the
// FlashAttention-2 recipe -- each probability tile is recomputed from the
// row statistics (m, l) that the forward wrote (flash_attention.cu,
// repro_flash_attention_fwd_stats), delta = rowsum(dO * O) comes in
// precomputed, and no (S, T) matrix ever reaches device memory:
//
//   s  = scale * q k^T, soft-capped (c tanh(s / c)), masked
//   p  = exp(s - m) / l                 (0 where the mask kills the pair)
//   dp = dO v^T
//   dS = p (dp - delta) (1 - (s / c)^2) scale
//   dV = sum p^T dO,   dK = sum dS^T q,   dQ = sum dS k
//
// (1 - (s/c)^2) is the exact derivative of the soft-cap at the capped score
// s; the reference kernel applies tanh to the capped score once more
// (1 - tanh^2(s/c)), which is wrong by up to a few percent at small c.
//
// What bounds it here: operations.  Four products per (query, key) pair in
// the dK/dV kernel (q k^T again, dO v^T, p^T dO, dS^T q) and three in the
// dQ kernel, against inputs of S*D size.
//
// What the design does about it:
//   * The TPU kernels' sequential innermost grid axis, with the gradient
//     tile in scratch memory, becomes a loop inside one thread block with
//     the accumulators in registers.
//   * dK/dV: one block per (batch, KV head, tile of BN keys).  It loops
//     over the tiles of BM rows of the flattened (position, group-head) axis
//     that the causal and window masks leave live -- the axis of the forward
//     kernel, contiguous in q's (B, S, H, D) layout -- so the sum over the G
//     query heads of a group happens inside the block: no atomics, no
//     second pass.
//   * dQ: one block per (batch, KV head, tile of BM flattened rows), looping
//     over the live key tiles, heaviest causal tiles first.
//   * Tiles that the mask kills entirely are never loaded; ragged tiles in
//     S*G and T are masked, so no divisibility is required.
//   * fp32 inputs: all products run on the CUDA cores in fp32, operands
//     widened to float in padded shared memory (16-byte loads, no bank
//     conflicts on the score products), so fp32 never rounds through TF32.
//   * bf16 inputs at D = 64, 128, 160 (stablelm-12b) and 256
//     (recurrentgemma-2b): warpgroup products fed by the TMA
//     (flash_bwd_dkv_wgmma_kernel and flash_bwd_dq_wgmma_kernel, below; at
//     D = 256 flash_bwd_dkv_d256_kernel and flash_bwd_dq_d256_kernel).
//   * bf16 at D = 32: all products run on the tensor cores with warp-level
//     mma.sync (m16n8k16, fp32 accumulate), as the forward kernel does.
//     dK/dV: each of 4 warps owns 16 keys and computes the transposed tiles
//     S^T = K Q^T and dP^T = V dO^T for 16 query rows at a time, so that
//     their accumulators are already the A operands of dV += P^T dO and
//     dK += dS^T Q (P and dS are packed to bf16 in registers, as the
//     forward packs P); K and V stay in shared memory for the block's life,
//     the next tile of q / dO rows arrives by cp.async while the current
//     one is computed, and the dK and dV tiles live in registers.  dQ: each
//     warp owns 16 query rows whose q and dO fragments stay in registers;
//     S, dP, then dQ += dS K with K read transposed by ldmatrix, K and V
//     tiles double-buffered by cp.async.
//   * fp32 at D = 32 and 160: a thread's D / 16 gradient columns are taken
//     in float2 slices (D / 16 is not a multiple of 4), elsewhere float4.
//     The fp32 tiles are 64 x 64 (a thread owns 4 x 4 scores), and 32 x 32
//     (2 x 2) at D = 256, where 64 x 64 tiles would need 301,824 bytes of
//     shared memory (kFTile).
//   * m, l and delta live in (B, S, H) fp32, q's layout without its last
//     axis, so no transpose is paid per layer; the outputs are written in
//     the input dtype from fp32 accumulators.
//
// flash_bwd_dkv_wgmma_kernel<D> (bf16, D = 64, 128 and 160).  Bounded by
// operations (four products per live (query, key) pair).  The mma.sync
// design above spends 512 bytes of shared-memory traffic on each 4096-flop
// mma (its K and V fragments are re-read for every row block) and cannot
// reach the tensor-core rate (at D = 160: 13x its bound, 2.6x the
// library's whole backward).  What this design does about it:
//   * One block owns BN = 128 keys of one (batch, KV head): K and V arrive
//     once by TMA and stay in shared memory for the block's life.  Two
//     consumer warpgroups own 64 keys each.  The block loops over the
//     (query tile of BM = 64 positions -- 32 above D = 128 -- group head g)
//     pairs that the masks leave live (live_query_tiles), so the sum over
//     the G heads of a group stays in registers: no atomics, no second
//     pass.  The heaviest key tiles (n0 = 0 under causal) of every (batch,
//     KV head) come first.
//   * A producer warpgroup (setmaxnreg 24) streams the pairs' Q and dO
//     tiles through a ring of DKV_STAGES stages by TMA (the forward's
//     per-head tensor maps, boxes of BM positions); its first warp also
//     brings each pair's m, 1/l and delta -- strided by H in (B, S, H), too
//     narrow for a TMA box -- into shared memory with plain loads, and its
//     32 lanes arrive on the stage's "full" mbarrier with the TMA bytes.
//   * Per pair and consumer warpgroup (setmaxnreg 240), four wgmma: S^T =
//     K Q^T and dP^T = V dO^T (m64n64k16, both operands in shared memory,
//     K-major), then P^T and dS^T in registers, packed to bf16 as the A
//     operands of dV += P^T dO and dK += dS^T Q (m64n64k16 per 64-column
//     panel, dO and Q MN-major through the transposed-B flag).  dK and dV
//     accumulate in fp32 registers, 64 x D each per warpgroup.
//   * The elementwise passes are branch-free blocks: the soft-cap and the
//     mask (a bit per element, built only where an edge crosses the tile)
//     are decided once per pair; per-element branches on them cost about a
//     third of the kernel's time (PERF.md, the bring-up of this design).
//   * D = 160: registers are the limit.  A consumer thread's dK and dV
//     accumulators alone are 2 x 80 fp32; with 64-query tiles S^T and dP^T
//     would add 32 + 32 and their packed forms 16 + 16, past setmaxnreg
//     240.  So at D = 160 the pairs' query tiles are BM = 32 positions: S^T
//     and dP^T are m64n32k16 (16 + 16 fp32, 8 + 8 packed), about 210 live
//     registers.  Splitting D across blocks that each recompute S and dP
//     was slower (the mma.sync design's probe), and so was giving dV and
//     dK to different warpgroups over the same 64 keys, P^T's factor
//     passed through shared memory, at 64-query tiles: 1.38x, as the two
//     wait on each other once a pair (PERF.md).  The columns are five
//     32-column panels with the 64-byte swizzle on all four operands
//     (hopper.cuh): the score products walk all ten k-steps, and dV += P^T
//     dO and dK += dS^T Q are one m64n160k16 each per 16 queries, q and dO
//     MN-major with the descriptor's LBO stepping from panel to panel --
//     3.9 % faster than one m64n32k16 a panel, timed in turns on the
//     H100 (PERF.md).  Shared memory: K and V 81,920 bytes,
//     three stages of q, dO and statistics 62,592.
//   * ptxas (sm_90a, -Xptxas -v, nvcc 12.9): 168 registers at D = 64, 128
//     and 160 -- the bound of a 384-thread block; setmaxnreg moves the
//     producer to 24 and the consumers to 240 -- and 0 bytes of spill.
//     chip_smoke.py prints both (kernel_cases, ptxas) and fails on a spill.
//
// flash_bwd_dq_wgmma_kernel<D> (bf16, D = 64, 128 and 160).  Bounded by
// operations (three products per live pair).  The mma.sync design above
// re-reads its K and V fragments through ldmatrix for every 16 query rows
// and cannot reach the tensor-core rate (at D = 160: 4.2x its bound).
// What this design does about it:
//   * The forward's iteration space: one block owns DQ_BM = 128 query
//     positions of one query head (per-head 3-D tensor maps on q and dO,
//     boxes of 128 positions, loaded once) and walks the key tiles of
//     live_key_tiles, heaviest causal blocks first.  The G heads of a group
//     re-read each K/V tile from L2.
//   * A producer warpgroup (setmaxnreg 24) keeps a ring of DQ_STAGES = 3
//     K/V tiles in flight by TMA, each completed through a "full" mbarrier
//     and released through an "empty" one.  Two consumer warpgroups
//     (setmaxnreg 240) own 64 query rows each, with their q and dO panels
//     resident in shared memory; m, 1/l and delta of their rows come once,
//     by plain loads (strided by H).
//   * Per key tile: S = Q K^T and dP = dO V^T as SS-wgmma m64n64k16 in two
//     commit groups -- p and its soft-cap factor are computed while dP is
//     still in flight -- then dS = p (dP - delta) (1 - (x/c)^2) scale,
//     packed to bf16 in registers as the A operand of dQ += dS K
//     (m64n64k16 per 64-column panel, K MN-major through the transposed-B
//     flag: the forward's P V form).  dQ accumulates in fp32 registers and
//     is written once, in bf16.
//   * Key tiles of DqLayout::BN = 64: S, dP and dQ at BN = 128, D = 128
//     would hold 3 x 64 fp32 a thread next to the packed dS, too many under
//     setmaxnreg 240; at 64 they hold 32 + 32 + 64.  ptxas: 168 registers
//     (the launch bound; the consumers then take 240) and 0 bytes of spill.
//   * D = 160: five 32-column panels with the 64-byte swizzle on all four
//     operands (hopper.cuh), as in the forward and dK/dV.  S and dP walk
//     all ten k-steps, two a panel; dQ += dS K is one m64n160k16 per 16
//     keys, K MN-major with the descriptor's LBO stepping from panel to
//     panel.  A consumer thread holds 80 fp32 of dQ, 32 of S, 32 of dP and
//     16 packed dS, so the 64-key tile stays; shared memory: q and dO
//     81,920 bytes, three stages of K and V 122,880.
//   * The mask and the soft-cap are decided once per tile and each
//     elementwise pass is branch-free, as in the other warpgroup kernels.
//   * Left out: fusing dQ into the dK/dV kernel with fp32 atomics (the
//     gradients would no longer be deterministic), and a dS tile shared
//     through shared memory between the two kernels.
//
// flash_bwd_dkv_d256_kernel (bf16, D = 256: recurrentgemma-2b's 10 query
// heads over one KV head, trained under its 2048 window).  The earlier
// design (two blocks per 128 keys, one per column half, each recomputing
// the scores; deleted once this one was timed against it) spent its time,
// measured by leaving each part out in turn
// (scripts/probe_variant.py dkv_d256_parts; PERF.md), on the score
// products (0.39 of 1.27 ms: each of the two column-half blocks recomputes
// them), the elementwise pass (0.30: no product runs beside it) and the
// gradient products (0.17); its 128 blocks on 132 SMs wait for the
// heaviest (680 pairs against a mean of 510); the q / dO loads cost 0.02
// (so no TMA multicast).  What this design does:
//   * One block per work item: 64 keys of one (batch, KV head) and one
//     slice of the group's heads (dkv256_slices: enough items for about
//     three per SM, four slices of 3, 3, 2, 2 heads at the trained shape:
//     512 items), key tiles in order, so the heaviest come first; without
//     the slices it is 0.25 ms slower.  With more than one slice each
//     writes an fp32 partial of dK and dV, and flash_bwd_dkv_sum_kernel
//     sums them in slice order: no atomics, bit-identical calls.
//   * Pairs of (64 query positions, head): warpgroup cw computes S^T = K
//     Q^T and dP^T = V dO^T for queries cw * 32 .. cw * 32 + 31 (two
//     m64n32k16 chains over the four panels), its elementwise pass (p,
//     dS^T), and P^T split into bf16 hi + lo (dV's first keys sum some
//     20,000 terms; the dkv_d256_split probe) -- each score product
//     once a pair, 10 D flops a live pair against the earlier 14 D.
//   * Each warpgroup writes its queries' P^T hi, lo and dS^T to the
//     exchange by stmatrix (K-major rows of 128 bytes, the 128-byte
//     swizzle) between two named barriers, then accumulates dK and dV for
//     128 of the 256 columns (64 + 64 fp32 a thread) over all 64 queries:
//     three m64n128k16 per 16 queries, A from the exchange, B MN-major over
//     two panels.
//   * Tried and dropped (PERF.md): 32-query pairs with warpgroup 0
//     computing S^T, P^T and dS^T and warpgroup 1 dP^T, handed over through
//     shared memory (0.98 ms: warpgroup 0's elementwise pass and exchange
//     in series while the other waits); issuing the next pair's score
//     products before this pair's gradient products (ptxas serialised
//     them: C7515); each warpgroup's own queries' gradient products from
//     registers before the exchange (no gain).
//   * Shared memory: K and V 65,536 bytes, two stages of q, dO (64
//     positions) and statistics 132,608, the exchange 24,576: 223,784 in
//     all.  ptxas: 168 registers (the launch bound), 0 spill.
//
// flash_bwd_dq_d256_kernel (bf16, D = 256).  The earlier dQ (32-key
// tiles, deleted) spent 0.17 of
// 0.43 ms on its m64n32k16 score products, 0.08 on the elementwise pass,
// 0.004 on K / V loads.  This design takes 48-key tiles (m64n48k16 score
// products, three m64n256k16 for dS K) in two stages: 131,072 + 98,304
// bytes.  Tried and dropped (PERF.md): the warpgroups taking turns
// to issue their score products (0.014 ms slower); each tile's dQ product
// issued behind the next tile's score products, with its A fragments in
// registers (ptxas held them, C7519: 0.44 ms) or dS through shared memory
// (32-key tiles: 0.48 ms).

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;

constexpr int BM = 64;   // flattened query rows per tile (mma.sync)
constexpr int BN = 64;   // keys per tile (mma.sync)
constexpr int NT = 256;  // threads per block: 16 (rows) x 16 (columns)

// The fp32 kernels' tiles: kFTile<D> flattened query rows x kFTile<D> keys,
// a thread owning kFTile / 16 of each; 32 at D = 256, where 64 x 64 tiles
// need 301,824 bytes of shared memory.
template <int D> constexpr int kFTile = D > 160 ? 32 : 64;

// Q, dO (BM rows); K, V (BN rows); P, dS (BM x BN); m, l, delta (BM)
template <int D> constexpr int smem_floats() {
  constexpr int BM = kFTile<D>, BN = kFTile<D>;
  return 2 * BM * (D + 4) + 2 * BN * (D + 4) + 2 * BM * (BN + 4) + 3 * BM;
}
static_assert(smem_floats<160>() * 4 <= 232448, "fp32 tiles exceed the SM");
static_assert(smem_floats<256>() * 4 <= 232448, "fp32 tiles exceed the SM");

struct Smem {
  float *Q, *dO, *K, *V, *P, *dS, *m, *l, *delta;
};

template <int D> __device__ __forceinline__ Smem carve(float* base) {
  constexpr int BM = kFTile<D>, BN = kFTile<D>;
  Smem s;
  s.Q = base;
  s.dO = s.Q + BM * (D + 4);
  s.K = s.dO + BM * (D + 4);
  s.V = s.K + BN * (D + 4);
  s.P = s.V + BN * (D + 4);
  s.dS = s.P + BM * (BN + 4);
  s.m = s.dS + BM * (BN + 4);
  s.l = s.m + BM;
  s.delta = s.l + BM;
  return s;
}

// Rows r0 .. r0+BM-1 of one KV head's flattened axis: q and dO rows into
// shared memory, and their statistics (a row past the end gets m = 0,
// l = 1, delta = 0 and zero q / dO; the mask zeroes its p).
template <typename T, int D>
__device__ __forceinline__ void load_row_tile(
    const Smem& sm, const T* qb, const T* dob, const float* mb,
    const float* lb, const float* db, int r0, int M, int G, size_t q_row,
    int H) {
  constexpr int BM = kFTile<D>;
  auto off = [&](int r) {
    const int rr = r0 + r;
    return (size_t)(rr / G) * q_row + (size_t)(rr % G) * D;
  };
  auto valid = [&](int r) { return r0 + r < M; };
  load_rows<T, D, NT>(sm.Q, qb, BM, off, valid);
  load_rows<T, D, NT>(sm.dO, dob, BM, off, valid);
  for (int r = threadIdx.x; r < BM; r += NT) {
    const int rr = r0 + r;
    const bool live = rr < M;
    const size_t st = (size_t)(rr / G) * H + rr % G;
    sm.m[r] = live ? mb[st] : 0.f;
    sm.l[r] = live ? lb[st] : 1.f;
    sm.delta[r] = live ? db[st] : 0.f;
  }
}

// Keys n0 .. n0+BN-1: k and v rows into shared memory (zero past Tk).
template <typename T, int D>
__device__ __forceinline__ void load_key_tile(const Smem& sm, const T* kb,
                                              const T* vb, int n0, int Tk,
                                              size_t kv_row) {
  constexpr int BN = kFTile<D>;
  auto off = [&](int r) { return (size_t)(n0 + r) * kv_row; };
  auto valid = [&](int r) { return n0 + r < Tk; };
  load_rows<T, D, NT>(sm.K, kb, BN, off, valid);
  load_rows<T, D, NT>(sm.V, vb, BN, off, valid);
}

// P and dS of the (BM rows from r0) x (BN keys from n0) tile, from the
// operands in shared memory, written to sm.P and sm.dS.  Thread (tx, ty)
// computes rows ty + 16 i and keys tx + 16 j.
template <int D>
__device__ __forceinline__ void p_and_ds(const Smem& sm, int r0, int n0,
                                         int M, int G, int Tk, int causal,
                                         int window, float scale,
                                         float softcap) {
  constexpr int BN = kFTile<D>;
  constexpr int RPT = kFTile<D> / 16;  // score-tile rows per thread
  constexpr int KPT = kFTile<D> / 16;  // score-tile keys per thread
  constexpr int LD = D + 4;
  constexpr int LDP = BN + 4;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  float s[RPT][KPT], dp[RPT][KPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[i][j] = dp[i][j] = 0.f;

#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 qa[RPT], oa[RPT], ka[KPT], va[KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      qa[i] = *reinterpret_cast<const float4*>(sm.Q + (ty + 16 * i) * LD + d);
      oa[i] = *reinterpret_cast<const float4*>(sm.dO + (ty + 16 * i) * LD + d);
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      ka[j] = *reinterpret_cast<const float4*>(sm.K + (tx + 16 * j) * LD + d);
      va[j] = *reinterpret_cast<const float4*>(sm.V + (tx + 16 * j) * LD + d);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[i][j] += qa[i].x * ka[j].x;
        s[i][j] += qa[i].y * ka[j].y;
        s[i][j] += qa[i].z * ka[j].z;
        s[i][j] += qa[i].w * ka[j].w;
        dp[i][j] += oa[i].x * va[j].x;
        dp[i][j] += oa[i].y * va[j].y;
        dp[i][j] += oa[i].z * va[j].z;
        dp[i][j] += oa[i].w * va[j].w;
      }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int ri = ty + 16 * i;
    const int row = r0 + ri;
    const int pos = row / G;
    const float m = sm.m[ri];
    const float inv_l = 1.f / sm.l[ri];
    const float delta = sm.delta[ri];
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kj = tx + 16 * j;
      const int kpos = n0 + kj;
      float x = s[i][j] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      const int diff = pos - kpos;
      bool dead = row >= M || kpos >= Tk;
      if (causal) dead = dead || diff < 0;
      if (window > 0) dead = dead || diff >= window;
      const float p = dead ? 0.f : expf(x - m) * inv_l;
      float ds = p * (dp[i][j] - delta);
      if (softcap > 0.f) {
        const float t = x / softcap;
        ds *= 1.f - t * t;
      }
      sm.P[ri * LDP + kj] = p;
      sm.dS[ri * LDP + kj] = ds * scale;
    }
  }
}

// One block an SM (the fp32 tiles above D = 64 fill most of its shared
// memory anyway) lets ptxas give a thread all the registers it needs: with
// the default bound it capped the D = 160 kernels at 128 and spilled.
template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int Tk, int H, int K, int G,
                     int causal, int window, float scale, float softcap) {
  constexpr int BM = kFTile<D>, BN = kFTile<D>;
  constexpr int KPT = BN / 16;  // keys per thread
  constexpr int LD = D + 4;
  constexpr int LDP = BN + 4;
  constexpr int CPT = D / 16;  // gradient columns per thread
  constexpr int VW = CPT % 4 == 0 ? 4 : 2;  // float4 or float2 slices
  constexpr int NG = CPT / VW;
  static_assert(D % 32 == 0 && CPT % VW == 0,
                "the column split must cover all D columns");

  extern __shared__ float smem[];
  const Smem sm = carve<D>(smem);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int n0 = blockIdx.x * BN;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int M = S * G;

  const size_t q_row = (size_t)H * D;
  const size_t kv_row = (size_t)K * D;
  const T* qb = q + (size_t)b * S * q_row + (size_t)kh * G * D;
  const T* dob = dout + (size_t)b * S * q_row + (size_t)kh * G * D;
  const T* kb = k + (size_t)b * Tk * kv_row + (size_t)kh * D;
  const T* vb = v + (size_t)b * Tk * kv_row + (size_t)kh * D;
  const size_t st0 = (size_t)b * S * H + (size_t)kh * G;

  load_key_tile<T, D>(sm, kb, vb, n0, Tk, kv_row);

  // rows that any key of this tile is live for
  int r_begin = 0;
  int r_end = M;
  if (causal) r_begin = (min(n0, S) * G / BM) * BM;  // position >= n0
  if (window > 0) r_end = min(M, (n0 + BN - 1 + window) * G);

  float dk_acc[KPT][CPT], dv_acc[KPT][CPT];  // keys ty + 16 i
#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += BM) {
    __syncthreads();  // the previous tile's products are done with Q, dO, P
    load_row_tile<T, D>(sm, qb, dob, m + st0, l + st0, delta + st0, r0, M, G,
                        q_row, H);
    __syncthreads();
    p_and_ds<D>(sm, r0, n0, M, G, Tk, causal, window, scale, softcap);
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q: keys ty + 16 i, columns
    // g*16*VW + tx*VW + e
#pragma unroll 2
    for (int r = 0; r < BM; ++r) {
      float pa[KPT], sa[KPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        pa[i] = sm.P[r * LDP + ty + 16 * i];
        sa[i] = sm.dS[r * LDP + ty + 16 * i];
      }
      float oo[CPT], qq[CPT];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int c = g * 16 * VW + tx * VW;
        if constexpr (VW == 4) {
          const float4 x = *reinterpret_cast<const float4*>(sm.dO + r * LD + c);
          const float4 y = *reinterpret_cast<const float4*>(sm.Q + r * LD + c);
          oo[g * VW + 0] = x.x; oo[g * VW + 1] = x.y;
          oo[g * VW + 2] = x.z; oo[g * VW + 3] = x.w;
          qq[g * VW + 0] = y.x; qq[g * VW + 1] = y.y;
          qq[g * VW + 2] = y.z; qq[g * VW + 3] = y.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(sm.dO + r * LD + c);
          const float2 y = *reinterpret_cast<const float2*>(sm.Q + r * LD + c);
          oo[g * VW + 0] = x.x; oo[g * VW + 1] = x.y;
          qq[g * VW + 0] = y.x; qq[g * VW + 1] = y.y;
        }
      }
#pragma unroll
      for (int i = 0; i < KPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          dv_acc[i][c] += pa[i] * oo[c];
          dk_acc[i][c] += sa[i] * qq[c];
        }
    }
  }

#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int key = n0 + ty + 16 * i;
    if (key < Tk) {
      T* dkr = dk + (size_t)b * Tk * kv_row + (size_t)key * kv_row +
               (size_t)kh * D;
      T* dvr = dv + (size_t)b * Tk * kv_row + (size_t)key * kv_row +
               (size_t)kh * D;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const int c = g * 16 * VW + tx * VW + e;
          dkr[c] = Elem<T>::from_float(dk_acc[i][g * VW + e]);
          dvr[c] = Elem<T>::from_float(dv_acc[i][g * VW + e]);
        }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ delta, T* __restrict__ dq, int S,
                    int Tk, int H, int K, int G, int causal, int window,
                    float scale, float softcap) {
  constexpr int BM = kFTile<D>, BN = kFTile<D>;
  constexpr int RPT = BM / 16;  // rows per thread
  constexpr int LD = D + 4;
  constexpr int LDP = BN + 4;
  constexpr int CPT = D / 16;
  constexpr int VW = CPT % 4 == 0 ? 4 : 2;
  constexpr int NG = CPT / VW;
  static_assert(D % 32 == 0 && CPT % VW == 0,
                "the column split must cover all D columns");

  extern __shared__ float smem[];
  const Smem sm = carve<D>(smem);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int M = S * G;
  const int r0 = tile * BM;

  const size_t q_row = (size_t)H * D;
  const size_t kv_row = (size_t)K * D;
  const T* qb = q + (size_t)b * S * q_row + (size_t)kh * G * D;
  const T* dob = dout + (size_t)b * S * q_row + (size_t)kh * G * D;
  const T* kb = k + (size_t)b * Tk * kv_row + (size_t)kh * D;
  const T* vb = v + (size_t)b * Tk * kv_row + (size_t)kh * D;
  const size_t st0 = (size_t)b * S * H + (size_t)kh * G;

  load_row_tile<T, D>(sm, qb, dob, m + st0, l + st0, delta + st0, r0, M, G,
                      q_row, H);

  // keys that any row of this tile can see (as the forward kernel)
  const int p_lo = r0 / G;
  const int p_hi = min(r0 + BM - 1, M - 1) / G;
  int n_begin = 0;
  int n_end = Tk;
  if (causal) n_end = min(Tk, p_hi + 1);
  if (window > 0) {
    const int lo = p_lo - window + 1;
    if (lo > 0) n_begin = (lo / BN) * BN;
  }

  float acc[RPT][CPT];  // rows ty + 16 i, columns g*16*VW + tx*VW + e
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    __syncthreads();  // the previous tile's product is done with K, dS
    load_key_tile<T, D>(sm, kb, vb, n0, Tk, kv_row);
    __syncthreads();
    p_and_ds<D>(sm, r0, n0, M, G, Tk, causal, window, scale, softcap);
    __syncthreads();

    // dQ += dS K
#pragma unroll 2
    for (int n = 0; n < BN; n += 4) {
      float sa[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 s4 =
            *reinterpret_cast<const float4*>(sm.dS + (ty + 16 * i) * LDP + n);
        sa[i][0] = s4.x; sa[i][1] = s4.y; sa[i][2] = s4.z; sa[i][3] = s4.w;
      }
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        float kk[CPT];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float* kp = sm.K + (n + nn) * LD + g * 16 * VW + tx * VW;
          if constexpr (VW == 4) {
            const float4 x = *reinterpret_cast<const float4*>(kp);
            kk[g * VW + 0] = x.x; kk[g * VW + 1] = x.y;
            kk[g * VW + 2] = x.z; kk[g * VW + 3] = x.w;
          } else {
            const float2 x = *reinterpret_cast<const float2*>(kp);
            kk[g * VW + 0] = x.x; kk[g * VW + 1] = x.y;
          }
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] += sa[i][nn] * kk[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r < M) {
      T* row = dq + (size_t)b * S * q_row + (size_t)(r / G) * q_row +
               (size_t)(kh * G + r % G) * D;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < VW; ++e)
          row[g * 16 * VW + tx * VW + e] =
              Elem<T>::from_float(acc[i][g * VW + e]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core path
// ---------------------------------------------------------------------------
constexpr int MMA_NT = 128;  // 4 warps

template <int D> constexpr int kMmaTile = 64 * (D + 8);  // bf16 elements

// dK/dV: K, V (one tile each); q, dO rows (two buffers each); m, l, delta
// of the rows (two buffers)
template <int D> constexpr int dkv_mma_smem_bytes() {
  return 6 * kMmaTile<D> * 2 + 2 * 3 * BM * 4;
}

template <int D>
__global__ void __launch_bounds__(MMA_NT)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ m,
                         const float* __restrict__ l,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int S, int Tk, int H,
                         int K, int G, int causal, int window, float scale,
                         float softcap) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + 8;  // padded row: conflict-free ldmatrix
  constexpr int KS = D / 16;
  constexpr int DB = D / 8;
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  constexpr int TILE = kMmaTile<D>;
  static_assert(KS % 2 == 0 && DB % 2 == 0,
                "k-steps and column blocks are taken in pairs");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;        // two buffers
  bf16* dOs = Qs + 2 * TILE;   // two buffers
  float* stats = reinterpret_cast<float*>(dOs + 2 * TILE);  // 2 x (m, l, delta)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qr = lane >> 2;
  const int qc = (lane & 3) * 2;
  const int n0 = blockIdx.x * BN;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int M = S * G;

  const size_t q_row = (size_t)H * D;
  const size_t kv_row = (size_t)K * D;
  const bf16* qb = q + (size_t)b * S * q_row + (size_t)kh * G * D;
  const bf16* dob = dout + (size_t)b * S * q_row + (size_t)kh * G * D;
  const bf16* kb = k + (size_t)b * Tk * kv_row + (size_t)kh * D;
  const bf16* vb = v + (size_t)b * Tk * kv_row + (size_t)kh * D;
  const size_t st0 = (size_t)b * S * H + (size_t)kh * G;

  for (int idx = threadIdx.x; idx < BN * VPR; idx += MMA_NT) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * 8;
    const bool live = n0 + r < Tk;
    const size_t src = (size_t)(live ? n0 + r : 0) * kv_row + c;
    cp_async16(Ks + r * LD + c, kb + src, live ? 16 : 0);
    cp_async16(Vs + r * LD + c, vb + src, live ? 16 : 0);
  }
  cp_async_commit();

  int r_begin = 0;
  int r_end = M;
  if (causal) r_begin = (min(n0, S) * G / BM) * BM;  // position >= n0
  if (window > 0) r_end = min(M, (n0 + BN - 1 + window) * G);

  // rows r0 .. r0+BM-1 of q and dO, and their statistics, into buffer buf
  auto fetch = [&](int r0, int buf) {
    for (int idx = threadIdx.x; idx < BM * VPR; idx += MMA_NT) {
      const int r = idx / VPR;
      const int c = (idx % VPR) * 8;
      const int rr = r0 + r;
      const bool live = rr < M;
      const size_t src =
          (live ? (size_t)(rr / G) * q_row + (size_t)(rr % G) * D : 0) + c;
      cp_async16(Qs + buf * TILE + r * LD + c, qb + src, live ? 16 : 0);
      cp_async16(dOs + buf * TILE + r * LD + c, dob + src, live ? 16 : 0);
    }
    cp_async_commit();
    float* st = stats + buf * 3 * BM;
    for (int r = threadIdx.x; r < BM; r += MMA_NT) {
      const int rr = r0 + r;
      const bool live = rr < M;
      const size_t i = st0 + (size_t)(rr / G) * H + rr % G;
      st[r] = live ? m[i] : 0.f;
      st[BM + r] = live ? 1.f / l[i] : 1.f;
      st[2 * BM + r] = live ? delta[i] : 0.f;
    }
  };

  float dk_acc[DB][4], dv_acc[DB][4];  // keys warp*16 + qr (+8), cols j*8+qc
#pragma unroll
  for (int j = 0; j < DB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  const int kw = warp * 16;  // this warp's first key in the tile
  if (r_begin < r_end) fetch(r_begin, 0);
  int buf = 0;
  for (int r0 = r_begin; r0 < r_end; r0 += BM, buf ^= 1) {
    if (r0 + BM < r_end) {
      fetch(r0 + BM, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Q = Qs + buf * TILE;
    const bf16* dO = dOs + buf * TILE;
    const float* ms = stats + buf * 3 * BM;
    const float* inv_ls = ms + BM;
    const float* deltas = ms + 2 * BM;

#pragma unroll 1
    for (int np = 0; np < BM / 16; ++np) {  // 16 query rows: one k-step
      // S^T and dP^T for row blocks 2np, 2np+1 (8 rows each)
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[h][e] = dpt[h][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ks += 2) {
        uint32_t ka[2][4], va[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int off = (kw + (lane & 15)) * LD + (ks + t) * 16 +
                          (lane >> 4) * 8;
          ldmatrix_x4(ka[t], Ks + off);
          ldmatrix_x4(va[t], Vs + off);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int off = ((2 * np + h) * 8 + (lane & 7)) * LD + ks * 16 +
                          (lane >> 3) * 8;
          uint32_t qf[4], of[4];
          ldmatrix_x4(qf, Q + off);
          ldmatrix_x4(of, dO + off);
          mma_m16n8k16(st[h], ka[0], qf[0], qf[1]);
          mma_m16n8k16(st[h], ka[1], qf[2], qf[3]);
          mma_m16n8k16(dpt[h], va[0], of[0], of[1]);
          mma_m16n8k16(dpt[h], va[1], of[2], of[3]);
        }
      }

      // P^T and dS^T, then their A fragments (keys x these 16 rows)
      uint32_t pa[4], dsa[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = n0 + kw + qr + (e >> 1) * 8;
          const int rl = (2 * np + h) * 8 + qc + (e & 1);
          const int row = r0 + rl;
          const int diff = row / G - kpos;
          float x = st[h][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          bool dead = row >= M || kpos >= Tk;
          if (causal) dead = dead || diff < 0;
          if (window > 0) dead = dead || diff >= window;
          const float pv = dead ? 0.f : __expf(x - ms[rl]) * inv_ls[rl];
          float ds = pv * (dpt[h][e] - deltas[rl]);
          if (softcap > 0.f) {
            const float t = x / softcap;
            ds *= 1.f - t * t;
          }
          st[h][e] = pv;
          dpt[h][e] = ds * scale;
        }
        pa[2 * h] = pack_bf16(st[h][0], st[h][1]);
        pa[2 * h + 1] = pack_bf16(st[h][2], st[h][3]);
        dsa[2 * h] = pack_bf16(dpt[h][0], dpt[h][1]);
        dsa[2 * h + 1] = pack_bf16(dpt[h][2], dpt[h][3]);
      }

      // dV += P^T dO, dK += dS^T Q over these 16 rows: dO and Q read
      // transposed by ldmatrix, as the forward reads V
#pragma unroll
      for (int j = 0; j < DB; j += 2) {
        const int mat = lane >> 3;
        const int off = (np * 16 + (mat & 1) * 8 + (lane & 7)) * LD +
                        (j + (mat >> 1)) * 8;
        uint32_t of[4], qf[4];
        ldmatrix_x4_trans(of, dO + off);
        mma_m16n8k16(dv_acc[j], pa, of[0], of[1]);
        mma_m16n8k16(dv_acc[j + 1], pa, of[2], of[3]);
        ldmatrix_x4_trans(qf, Q + off);
        mma_m16n8k16(dk_acc[j], dsa, qf[0], qf[1]);
        mma_m16n8k16(dk_acc[j + 1], dsa, qf[2], qf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer: it may refill
  }
  cp_async_wait<0>();  // the K/V copy, where no row tile was live

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = n0 + kw + qr + 8 * h;
    if (key < Tk) {
      const size_t at = ((size_t)b * Tk + key) * kv_row + (size_t)kh * D;
#pragma unroll
      for (int j = 0; j < DB; ++j) {
        *reinterpret_cast<uint32_t*>(dk + at + j * 8 + qc) =
            pack_bf16(dk_acc[j][2 * h], dk_acc[j][2 * h + 1]);
        *reinterpret_cast<uint32_t*>(dv + at + j * 8 + qc) =
            pack_bf16(dv_acc[j][2 * h], dv_acc[j][2 * h + 1]);
      }
    }
  }
}

// dQ: K and V tiles, two buffers each
template <int D> constexpr int dq_mma_smem_bytes() {
  return 4 * kMmaTile<D> * 2;
}

template <int D>
__global__ void __launch_bounds__(MMA_NT)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ m,
                        const float* __restrict__ l,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int S, int Tk, int H,
                        int K, int G, int causal, int window, float scale,
                        float softcap) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;
  constexpr int DB = D / 8;
  constexpr int VPR = D / 8;
  constexpr int TILE = kMmaTile<D>;
  static_assert(KS % 2 == 0 && DB % 2 == 0,
                "k-steps and column blocks are taken in pairs");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ksm = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vsm = Ksm + 2 * TILE;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qr = lane >> 2;
  const int qc = (lane & 3) * 2;
  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int M = S * G;
  const int r0 = tile * BM;

  const size_t q_row = (size_t)H * D;
  const size_t kv_row = (size_t)K * D;
  const bf16* qb = q + (size_t)b * S * q_row + (size_t)kh * G * D;
  const bf16* dob = dout + (size_t)b * S * q_row + (size_t)kh * G * D;
  const bf16* kb = k + (size_t)b * Tk * kv_row + (size_t)kh * D;
  const bf16* vb = v + (size_t)b * Tk * kv_row + (size_t)kh * D;
  const size_t st0 = (size_t)b * S * H + (size_t)kh * G;

  // this thread's two rows, their positions, statistics and fragments
  int row[2], pos[2];
  float m_r[2], inv_l[2], delta_r[2];
  uint32_t qa[KS][4], oa[KS][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = r0 + warp * 16 + qr + 8 * h;
    const bool live = row[h] < M;
    const int rr = min(row[h], M - 1);
    pos[h] = rr / G;
    const size_t at = (size_t)(rr / G) * q_row + (size_t)(rr % G) * D;
    const size_t i = st0 + (size_t)(rr / G) * H + rr % G;
    m_r[h] = live ? m[i] : 0.f;
    inv_l[h] = live ? 1.f / l[i] : 1.f;
    delta_r[h] = live ? delta[i] : 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t* qp =
          reinterpret_cast<const uint32_t*>(qb + at + ks * 16 + qc);
      const uint32_t* op =
          reinterpret_cast<const uint32_t*>(dob + at + ks * 16 + qc);
      qa[ks][h] = live ? qp[0] : 0u;
      qa[ks][2 + h] = live ? qp[4] : 0u;
      oa[ks][h] = live ? op[0] : 0u;
      oa[ks][2 + h] = live ? op[4] : 0u;
    }
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

  float acc[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

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
    if (n0 + BN < n_end) {
      fetch(n0 + BN, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Ks = Ksm + buf * TILE;
    const bf16* Vs = Vsm + buf * TILE;

#pragma unroll 1
    for (int kk = 0; kk < BN / 16; ++kk) {  // 16 keys: one k-step of dS K
      float s[2][4], dp[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[h][e] = dp[h][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ks += 2) {
          const int off = ((2 * kk + h) * 8 + (lane & 7)) * LD + ks * 16 +
                          (lane >> 3) * 8;
          uint32_t kf[4], vf[4];
          ldmatrix_x4(kf, Ks + off);
          ldmatrix_x4(vf, Vs + off);
          mma_m16n8k16(s[h], qa[ks], kf[0], kf[1]);
          mma_m16n8k16(s[h], qa[ks + 1], kf[2], kf[3]);
          mma_m16n8k16(dp[h], oa[ks], vf[0], vf[1]);
          mma_m16n8k16(dp[h], oa[ks + 1], vf[2], vf[3]);
        }
      }
      uint32_t dsa[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;  // c0, c1: row qr; c2, c3: row qr + 8
          const int kpos = n0 + (2 * kk + h) * 8 + qc + (e & 1);
          const int diff = pos[r] - kpos;
          float x = s[h][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          bool dead = row[r] >= M || kpos >= Tk;
          if (causal) dead = dead || diff < 0;
          if (window > 0) dead = dead || diff >= window;
          const float pv = dead ? 0.f : __expf(x - m_r[r]) * inv_l[r];
          float ds = pv * (dp[h][e] - delta_r[r]);
          if (softcap > 0.f) {
            const float t = x / softcap;
            ds *= 1.f - t * t;
          }
          s[h][e] = ds * scale;
        }
        dsa[2 * h] = pack_bf16(s[h][0], s[h][1]);
        dsa[2 * h + 1] = pack_bf16(s[h][2], s[h][3]);
      }
      // dQ += dS K: K read transposed by ldmatrix, as the forward reads V
#pragma unroll
      for (int j = 0; j < DB; j += 2) {
        const int mat = lane >> 3;
        uint32_t kf[4];
        ldmatrix_x4_trans(kf, Ks + (kk * 16 + (mat & 1) * 8 + (lane & 7)) *
                                       LD + (j + (mat >> 1)) * 8);
        mma_m16n8k16(acc[j], dsa, kf[0], kf[1]);
        mma_m16n8k16(acc[j + 1], dsa, kf[2], kf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer: it may refill
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] < M) {
      bf16* out = dq + (size_t)b * S * q_row + (size_t)(row[h] / G) * q_row +
                  (size_t)(kh * G + row[h] % G) * D;
#pragma unroll
      for (int j = 0; j < DB; ++j)
        *reinterpret_cast<uint32_t*>(out + j * 8 + qc) =
            pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dK/dV, D = 64, 128 and 160: warpgroup products fed by the TMA
// ---------------------------------------------------------------------------
constexpr int DKV_BN = 128;    // keys per block: 2 consumer warpgroups x 64
constexpr int DKV_STAGES = 3;  // (q, dO, statistics) tiles in flight
constexpr int WG_NT = 384;     // producer warpgroup + 2 consumer warpgroups

// byte offsets from the block's 1024-aligned shared-memory base: K and V (NP
// panels of 128 keys each), then DKV_STAGES x NP panels of q, the same of
// dO, DKV_STAGES x (m, 1/l, delta) x BM floats, the barriers.  A panel is
// PW columns (hopper.cuh): 64 at D = 64 / 128, 32 at D = 160.  BM query
// positions a tile: 64, and 32 above D = 128, where the dK and dV
// accumulators alone take 160 fp32 registers a thread.
template <int D> struct DkvLayout {
  static_assert(D <= 160, "D = 256 has flash_bwd_dkv_d256_kernel");
  static constexpr int PW = hopper::kPanelCols<D>;
  static constexpr int NP = D / PW;
  static constexpr int RB = 2 * PW;             // bytes of a panel row
  static constexpr int BM = D > 128 ? 32 : 64;
  static constexpr int KV_PANEL = DKV_BN * RB;
  static constexpr int Q_PANEL = BM * RB;
  static constexpr int K = 0;
  static constexpr int V = K + NP * KV_PANEL;
  static constexpr int Q = V + NP * KV_PANEL;
  static constexpr int DO = Q + DKV_STAGES * NP * Q_PANEL;
  static constexpr int STATS = DO + DKV_STAGES * NP * Q_PANEL;
  static constexpr int BAR = STATS + DKV_STAGES * 3 * BM * 4;
  static constexpr int BYTES = BAR + (2 * DKV_STAGES + 1) * 8 + 1024;
};
static_assert(DkvLayout<160>::BYTES <= 232448, "D = 160 tiles exceed the SM");

template <int D>
__global__ void __launch_bounds__(WG_NT, 1)
flash_bwd_dkv_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                           __grid_constant__ const CUtensorMap tk,
                           __grid_constant__ const CUtensorMap tv,
                           __grid_constant__ const CUtensorMap tdo,
                           const float* __restrict__ m,
                           const float* __restrict__ l,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int S, int Tk,
                           int H, int K, int G, int causal, int window,
                           float scale, float softcap) {
  using namespace hopper;
  using Lay = DkvLayout<D>;
  constexpr int NP = Lay::NP;
  constexpr int PW = Lay::PW;
  constexpr int RB = Lay::RB;
  constexpr int BM = Lay::BM;
  constexpr int KS = D / 16;        // k-steps of S^T and dP^T
  constexpr int KSP = PW / 16;      // of them per panel
  constexpr int QB = BM / 8;        // 8-query column blocks of S^T
  constexpr int PK = BM / 16;       // k-steps of the gradient products
  constexpr int CB = PW / 8;        // 8-column blocks of a panel
  static_assert(NP * PW == D, "the panels must cover all D columns");
  static_assert(QB * 4 <= 32, "the live mask is one bit per element");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Lay::BAR);
  uint64_t* empty = full + DKV_STAGES;
  uint64_t* kv_full = empty + DKV_STAGES;
  float* stats = reinterpret_cast<float*>(sm + Lay::STATS);

  const int kh = blockIdx.x % K;
  const int b = blockIdx.x / K;
  const int n0 = blockIdx.y * DKV_BN;   // n0 = 0 (heaviest) first
  int m_begin, m_end;
  live_query_tiles(n0, DKV_BN, BM, S, causal, window, m_begin, m_end);
  // (query tile, group head) pairs: pair i is tile m_begin + (i / G) * BM,
  // head kh * G + i % G
  const int n_pairs =
      m_begin < m_end ? (m_end - m_begin + BM - 1) / BM * G : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(&full[s], 32);    // the producer warp's lanes
      mbar_init(&empty[s], 8);    // lane 0 of each consumer warp
    }
    mbar_init(kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: K, V once; then q, dO and statistics per pair ----
    regs_dealloc<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        prefetch_tensor_map(&tq);
        prefetch_tensor_map(&tk);
        prefetch_tensor_map(&tv);
        prefetch_tensor_map(&tdo);
        mbar_arrive_expect_tx(kv_full, 2 * DKV_BN * D * 2);
        for (int p = 0; p < NP; ++p) {
          tma_load_3d(sm + Lay::K + p * Lay::KV_PANEL, &tk, kv_full,
                      kh * D + p * PW, n0, b);
          tma_load_3d(sm + Lay::V + p * Lay::KV_PANEL, &tv, kv_full,
                      kh * D + p * PW, n0, b);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_pairs; ++i) {
        const int m0 = m_begin + (i / G) * BM;
        const int hq = kh * G + i % G;
        mbar_wait(&empty[stage], phase ^ 1);
        // rows past S: m = 0, 1/l = 1, delta = 0 (the mask zeroes their p)
        float* st = stats + stage * 3 * BM;
        for (int r = lane; r < BM; r += 32) {
          const bool live = m0 + r < S;
          const size_t at = ((size_t)b * S + (live ? m0 + r : 0)) * H + hq;
          st[r] = live ? m[at] : 0.f;
          st[BM + r] = live ? 1.f / l[at] : 1.f;
          st[2 * BM + r] = live ? delta[at] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[stage], 2 * BM * D * 2);
          for (int p = 0; p < NP; ++p) {
            const int at = (stage * NP + p) * Lay::Q_PANEL;
            tma_load_3d(sm + Lay::Q + at, &tq, &full[stage],
                        hq * D + p * PW, m0, b);
            tma_load_3d(sm + Lay::DO + at, &tdo, &full[stage],
                        hq * D + p * PW, m0, b);
          }
        } else {
          mbar_arrive(&full[stage]);
        }
        if (++stage == DKV_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 keys per warpgroup ----
    regs_alloc<240>();
    const int t = threadIdx.x - 128;
    const int cw = t >> 7;
    const int warp = (t >> 5) & 3;
    const int lane = t & 31;
    const int qc = (lane & 3) * 2;
    const int k_lo = n0 + cw * 64;        // this warpgroup's first key
    int key[2];
    key[0] = k_lo + warp * 16 + (lane >> 2);
    key[1] = key[0] + 8;

    // gradient accumulators per panel: [j * 4 + e] is key key[e >> 1],
    // column p * PW + j * 8 + qc + (e & 1)
    float dk_acc[NP][CB * 4], dv_acc[NP][CB * 4];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < CB * 4; ++i) dk_acc[p][i] = dv_acc[p][i] = 0.f;

    const uint32_t k_addr = smem_u32(sm + Lay::K) + cw * 64 * RB;
    const uint32_t v_addr = smem_u32(sm + Lay::V) + cw * 64 * RB;
    mbar_wait(kv_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int i = 0; i < n_pairs; ++i) {
      const int m0 = m_begin + (i / G) * BM;
      mbar_wait(&full[stage], phase);
      const uint32_t q_addr =
          smem_u32(sm + Lay::Q) + stage * NP * Lay::Q_PANEL;
      const uint32_t do_addr =
          smem_u32(sm + Lay::DO) + stage * NP * Lay::Q_PANEL;
      const float* ms = stats + stage * 3 * BM;
      const float* inv_ls = ms + BM;
      const float* deltas = ms + 2 * BM;

      // ---- S^T = K Q^T, dP^T = V dO^T (64 keys x BM queries), all D / 16
      // k-steps over the NP panels; [j * 4 + e] is key key[e >> 1], query
      // m0 + j * 8 + qc + (e & 1) ----
      float st[QB * 4], dpt[QB * 4];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t kofs = (ks % KSP) * 32;
        wgmma_ss(st,
                 panel_desc<PW>(k_addr + (ks / KSP) * Lay::KV_PANEL + kofs,
                                16),
                 panel_desc<PW>(q_addr + (ks / KSP) * Lay::Q_PANEL + kofs, 16),
                 ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t kofs = (ks % KSP) * 32;
        wgmma_ss(dpt,
                 panel_desc<PW>(v_addr + (ks / KSP) * Lay::KV_PANEL + kofs,
                                16),
                 panel_desc<PW>(do_addr + (ks / KSP) * Lay::Q_PANEL + kofs,
                                16),
                 ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // ---- P^T and dS^T, each pass one branch-free block: the soft-cap
      // and the mask are decided once per pair ----
      if (softcap > 0.f) {
        const float to_t = scale / softcap;
#pragma unroll
        for (int i = 0; i < QB * 4; ++i)
          st[i] = softcap * tanhf(st[i] * to_t);
      } else {
#pragma unroll
        for (int i = 0; i < QB * 4; ++i) st[i] *= scale;
      }
      // bit i: element i is live (a tile that no edge crosses is all live)
      uint32_t live = 0xffffffffu;
      const bool edge = m0 + BM > S || k_lo + 64 > Tk ||
                        (causal && k_lo + 63 > m0) ||
                        (window > 0 && m0 + BM - 1 - k_lo >= window);
      if (edge) {
        live = 0u;
#pragma unroll
        for (int i = 0; i < QB * 4; ++i) {
          const int qpos = m0 + (i >> 2) * 8 + qc + (i & 1);
          const int kpos = key[(i >> 1) & 1];
          const int diff = qpos - kpos;
          const bool dead = (qpos >= S) | (kpos >= Tk) |
                            ((causal != 0) & (diff < 0)) |
                            ((window > 0) & (diff >= window));
          live |= (uint32_t)!dead << i;
        }
      }
      // the soft-cap's derivative at the capped score x is 1 - (x / c)^2;
      // without a cap the factor is exactly 1
      const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
#pragma unroll
      for (int j = 0; j < QB; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = j * 8 + qc + e;    // query within the tile
          const float mq = ms[ql];
          const float il = inv_ls[ql];
          const float dq = deltas[ql];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int idx = j * 4 + 2 * h + e;
            const float x = st[idx];
            const float pv = (live >> idx) & 1u ? __expf(x - mq) * il : 0.f;
            const float tc = x * inv_cap;
            st[idx] = pv;
            dpt[idx] = pv * (dpt[idx] - dq) * (1.f - tc * tc) * scale;
          }
        }

      // ---- dV += P^T dO, dK += dS^T Q over all panels: bf16 A fragments
      // straight from the accumulators; per 16 queries one m64n64k16 per
      // panel (D = 64, 128) or one m64n160k16 over the five panels (D =
      // 160) ----
      uint32_t pa[PK][4], da[PK][4];
#pragma unroll
      for (int kk = 0; kk < PK; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
          da[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PK; ++kk) {
        wgmma_rs_panels<PW, NP>(dv_acc, pa[kk], do_addr + kk * 16 * RB,
                                Lay::Q_PANEL);
        wgmma_rs_panels<PW, NP>(dk_acc, da[kk], q_addr + kk * 16 * RB,
                                Lay::Q_PANEL);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        fence_regs(dv_acc[p]);
        fence_regs(dk_acc[p]);
      }
      if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done
      if (++stage == DKV_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (key[h] < Tk) {
        const size_t at = ((size_t)b * Tk + key[h]) * K * D + (size_t)kh * D;
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < CB; ++j) {
            const int c = p * PW + j * 8 + qc;
            *reinterpret_cast<uint32_t*>(dk + at + c) = pack_bf16(
                dk_acc[p][j * 4 + 2 * h], dk_acc[p][j * 4 + 2 * h + 1]);
            *reinterpret_cast<uint32_t*>(dv + at + c) = pack_bf16(
                dv_acc[p][j * 4 + 2 * h], dv_acc[p][j * 4 + 2 * h + 1]);
          }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dQ, D = 64, 128 and 160: warpgroup products fed by the TMA
// ---------------------------------------------------------------------------
constexpr int DQ_BM = 128;     // query positions per block: 2 warpgroups x 64
constexpr int DQ_STAGES = 3;   // K/V tiles in flight

// byte offsets from the block's 1024-aligned shared-memory base: q and dO
// (NP panels of 128 rows each), then DQ_STAGES x NP panels of K, the same
// of V, then the barriers.  A panel is PW columns (hopper.cuh): 64 at D =
// 64 / 128, 32 at D = 160 (q and dO 81,920 bytes, three stages of K and V
// 122,880).  BN = 64 keys a tile.
template <int D> struct DqLayout {
  static_assert(D <= 160, "D = 256 has flash_bwd_dq_d256_kernel");
  static constexpr int PW = hopper::kPanelCols<D>;
  static constexpr int NP = D / PW;
  static constexpr int BN = 64;
  static constexpr int RB = 2 * PW;             // bytes of a panel row
  static constexpr int Q_PANEL = DQ_BM * RB;
  static constexpr int KV_PANEL = BN * RB;
  static constexpr int Q = 0;
  static constexpr int DO = Q + NP * Q_PANEL;
  static constexpr int K = DO + NP * Q_PANEL;
  static constexpr int V = K + DQ_STAGES * NP * KV_PANEL;
  static constexpr int BAR = V + DQ_STAGES * NP * KV_PANEL;
  static constexpr int BYTES = BAR + (2 * DQ_STAGES + 1) * 8 + 1024;
};
static_assert(DqLayout<160>::BYTES <= 232448, "D = 160 tiles exceed the SM");
static_assert(DqLayout<128>::BYTES <= 232448, "D = 128 tiles exceed the SM");

template <int D>
__global__ void __launch_bounds__(WG_NT, 1)
flash_bwd_dq_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                          __grid_constant__ const CUtensorMap tk,
                          __grid_constant__ const CUtensorMap tv,
                          __grid_constant__ const CUtensorMap tdo,
                          const float* __restrict__ m,
                          const float* __restrict__ l,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int S, int Tk,
                          int H, int G, int causal, int window, float scale,
                          float softcap) {
  using namespace hopper;
  using Lay = DqLayout<D>;
  constexpr int NP = Lay::NP;
  constexpr int PW = Lay::PW;
  constexpr int RB = Lay::RB;
  constexpr int BN = Lay::BN;
  constexpr int KS = D / 16;        // k-steps of S and dP
  constexpr int KSP = PW / 16;      // of them per panel
  constexpr int NB = BN / 8;        // 8-key column blocks of S and dP
  constexpr int PK = BN / 16;       // k-steps of dS K
  constexpr int CB = PW / 8;        // 8-column blocks of a panel
  static_assert(NP * PW == D, "the panels must cover all D columns");
  static_assert(NB * 4 <= 32, "the live mask is one bit per element");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Lay::BAR);
  uint64_t* empty = full + DQ_STAGES;
  uint64_t* q_full = empty + DQ_STAGES;

  const int hq = blockIdx.x % H;                          // query head
  const int b = blockIdx.x / H;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * DQ_BM;    // heaviest first
  const int kh = hq / G;
  int n_begin, n_end;
  live_key_tiles(m0, DQ_BM, BN, Tk, causal, window, n_begin, n_end);

  if (threadIdx.x == 0) {
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);    // lane 0 of each consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: q and dO once, then one thread keeps the K/V ring
    // full ----
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      prefetch_tensor_map(&tq);
      prefetch_tensor_map(&tk);
      prefetch_tensor_map(&tv);
      prefetch_tensor_map(&tdo);
      mbar_arrive_expect_tx(q_full, 2 * DQ_BM * D * 2);
      for (int p = 0; p < NP; ++p) {
        tma_load_3d(sm + Lay::Q + p * Lay::Q_PANEL, &tq, q_full,
                    hq * D + p * PW, m0, b);
        tma_load_3d(sm + Lay::DO + p * Lay::Q_PANEL, &tdo, q_full,
                    hq * D + p * PW, m0, b);
      }
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
        if (++stage == DQ_STAGES) {
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

    // the two rows' statistics, strided by H in (B, S, H): plain loads.
    // Rows past S get m = 0, 1/l = 1, delta = 0 (their q and dO are zero
    // from the TMA, so dS is 0) and are not written.
    float m_r[2], il_r[2], dl_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool live = row[h] < S;
      const size_t at = ((size_t)b * S + (live ? row[h] : 0)) * H + hq;
      m_r[h] = live ? m[at] : 0.f;
      il_r[h] = live ? 1.f / l[at] : 1.f;
      dl_r[h] = live ? delta[at] : 0.f;
    }
    // the soft-cap's derivative at the capped score x is 1 - (x / c)^2;
    // without a cap the factor is exactly 1
    const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

    // dQ per panel: [j * 4 + e] is row row[e >> 1], column
    // p * PW + j * 8 + qc + (e & 1)
    float acc[NP][CB * 4];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < CB * 4; ++i) acc[p][i] = 0.f;

    const uint32_t q_addr = smem_u32(sm + Lay::Q) + cw * 64 * RB;
    const uint32_t do_addr = smem_u32(sm + Lay::DO) + cw * 64 * RB;
    mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int n0 = n_begin; n0 < n_end; n0 += BN) {
      mbar_wait(&full[stage], phase);
      const uint32_t k_addr =
          smem_u32(sm + Lay::K) + stage * NP * Lay::KV_PANEL;
      const uint32_t v_addr =
          smem_u32(sm + Lay::V) + stage * NP * Lay::KV_PANEL;

      // ---- S = Q K^T and dP = dO V^T (64 x BN per warpgroup), all
      // operands K-major in shared memory, all D / 16 k-steps over the NP
      // panels, as two commit groups: the probabilities are computed while
      // dP is still in flight.  [nb * 4 + e] is row row[e >> 1], key n0 +
      // nb * 8 + qc + (e & 1) ----
      float s[NB * 4], dp[NB * 4];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t kofs = (ks % KSP) * 32;
        wgmma_ss(
            s,
            panel_desc<PW>(q_addr + (ks / KSP) * Lay::Q_PANEL + kofs, 16),
            panel_desc<PW>(k_addr + (ks / KSP) * Lay::KV_PANEL + kofs, 16),
            ks > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t kofs = (ks % KSP) * 32;
        wgmma_ss(
            dp,
            panel_desc<PW>(do_addr + (ks / KSP) * Lay::Q_PANEL + kofs, 16),
            panel_desc<PW>(v_addr + (ks / KSP) * Lay::KV_PANEL + kofs, 16),
            ks > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // ---- p (1 - (x/c)^2) scale, each pass one branch-free block: the
      // soft-cap and the mask are decided once per tile ----
      if (softcap > 0.f) {
        const float to_t = scale / softcap;
#pragma unroll
        for (int i = 0; i < NB * 4; ++i) s[i] = softcap * tanhf(s[i] * to_t);
      } else {
#pragma unroll
        for (int i = 0; i < NB * 4; ++i) s[i] *= scale;
      }
      // bit i: element i is live (a tile that no edge crosses is all live)
      uint32_t live = 0xffffffffu;
      const bool edge = n0 + BN > Tk ||
                        (causal && n0 + BN - 1 > r_lo) ||
                        (window > 0 && r_lo + 63 - n0 >= window);
      if (edge) {
        live = 0u;
#pragma unroll
        for (int i = 0; i < NB * 4; ++i) {
          const int kpos = n0 + (i >> 2) * 8 + qc + (i & 1);
          const int diff = row[(i >> 1) & 1] - kpos;
          const bool dead = (kpos >= Tk) | ((causal != 0) & (diff < 0)) |
                            ((window > 0) & (diff >= window));
          live |= (uint32_t)!dead << i;
        }
      }
#pragma unroll
      for (int i = 0; i < NB * 4; ++i) {
        const int h = (i >> 1) & 1;
        const float x = s[i];
        const float pv =
            (live >> i) & 1u ? __expf(x - m_r[h]) * il_r[h] : 0.f;
        const float tc = x * inv_cap;
        s[i] = pv * (1.f - tc * tc) * scale;
      }

      // ---- dS = p (dP - delta) (1 - (x/c)^2) scale, packed to bf16 as
      // the A fragments of dQ += dS K ----
      wgmma_wait<0>();
      fence_regs(dp);
      uint32_t da[PK][4];
#pragma unroll
      for (int kk = 0; kk < PK; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r;
          const float dl = dl_r[r & 1];
          da[kk][r] = pack_bf16(s[i] * (dp[i] - dl),
                                s[i + 1] * (dp[i + 1] - dl));
        }

      // ---- dQ += dS K: K MN-major (the transposed-B flag), per 16 keys
      // one m64n64k16 per panel (D = 64, 128) or one m64n160k16 over the
      // five panels (D = 160) ----
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PK; ++kk)
        wgmma_rs_panels<PW, NP>(acc, da[kk], k_addr + kk * 16 * RB,
                                Lay::KV_PANEL);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
      if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done
      if (++stage == DQ_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] < S) {
        __nv_bfloat16* orow = dq + (((size_t)b * S + row[h]) * H + hq) * D;
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < CB; ++j)
            *reinterpret_cast<uint32_t*>(orow + p * PW + j * 8 + qc) =
                pack_bf16(acc[p][j * 4 + 2 * h], acc[p][j * 4 + 2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dK/dV at D = 256: the score products once per pair, split between the
// consumer warpgroups by queries; key tiles in head slices, heaviest first
// ---------------------------------------------------------------------------
constexpr int D256_KV_BN = 64;      // keys of a work item: both warpgroups'
constexpr int D256_KV_BM = 64;      // query positions of a pair: 32 each
constexpr int D256_KV_STAGES = 2;   // (q, dO, statistics) tiles in flight
constexpr int D256_ITEMS = 396;     // work items aimed at: 3 per H100 SM

// byte offsets from the 1024-aligned base: K and V (four 64-column panels
// of 64 keys), the stages' q and dO panels (64 positions), then the pair's
// exchange: P^T hi, P^T lo and dS^T in bf16 (64 keys x 64 queries each,
// K-major rows of 128 bytes under the 128-byte swizzle: the A operands of
// the gradient products), the stages' statistics, the barriers.
struct Dkv256Layout {
  static constexpr int NP = 4, RB = 128, BM = D256_KV_BM;
  static constexpr int KV_PANEL = D256_KV_BN * RB;
  static constexpr int Q_PANEL = BM * RB;
  static constexpr int X_TILE = D256_KV_BN * BM * 2;
  static constexpr int K = 0;
  static constexpr int V = K + NP * KV_PANEL;
  static constexpr int Q = V + NP * KV_PANEL;
  static constexpr int DO = Q + D256_KV_STAGES * NP * Q_PANEL;
  static constexpr int XP = DO + D256_KV_STAGES * NP * Q_PANEL;
  static constexpr int STATS = XP + 3 * X_TILE;
  static constexpr int BAR = STATS + D256_KV_STAGES * 3 * BM * 4;
  static constexpr int BYTES = BAR + (2 * D256_KV_STAGES + 1) * 8 + 1024;
};
static_assert(Dkv256Layout::BYTES <= 232448, "D = 256 dK/dV exceeds the SM");
static_assert(Dkv256Layout::X_TILE % 1024 == 0,
              "each exchanged tile starts on a 128-byte swizzle boundary");

// Head slices per key tile: enough work items for about D256_ITEMS (three
// per SM of an H100), at most one slice per head of the group.  Python's
// flash_attention_bwd.dkv_d256_slices is the same rule.
inline int dkv256_slices(int B, int T, int K, int G) {
  const int tiles = B * K * ((T + D256_KV_BN - 1) / D256_KV_BN);
  const int n = (D256_ITEMS + tiles - 1) / tiles;
  return n < G ? n : G;
}

// S^T = K Q^T or dP^T = V dO^T of the 64 keys and one warpgroup's 32
// queries (b_addr: their first row), over the 16 k-steps of the four
// panels; one commit group
__device__ __forceinline__ void dkv256_score(float (&acc)[16],
                                             uint32_t a_addr,
                                             uint32_t b_addr) {
  using namespace hopper;
  using Lay = Dkv256Layout;
#pragma unroll
  for (int ks = 0; ks < 16; ++ks)
    wgmma_ss(acc,
             panel_desc<64>(a_addr + (ks >> 2) * Lay::KV_PANEL +
                                (ks & 3) * 32, 16),
             panel_desc<64>(b_addr + (ks >> 2) * Lay::Q_PANEL +
                                (ks & 3) * 32, 16),
             ks > 0);
  wgmma_commit();
}

// dV += P_hi^T dO + P_lo^T dO and dK += dS^T Q over one warpgroup's 128
// columns (two 64-column panels, MN-major, the descriptor's LBO stepping
// between them) and all 64 queries of the pair: per 16 queries three
// m64n128k16, A from the exchange
__device__ __forceinline__ void dkv256_grads(float (&dv)[64],
                                             float (&dk)[64], uint32_t xp,
                                             uint32_t q_cols,
                                             uint32_t do_cols) {
  using namespace hopper;
  using Lay = Dkv256Layout;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Lay::BM / 16; ++kk) {
    const uint64_t bo = panel_desc<64>(do_cols + kk * 16 * Lay::RB,
                                       Lay::Q_PANEL);
    wgmma_ss_n128<1>(dv, panel_desc<64>(xp + kk * 32, 16), bo, 1);
    wgmma_ss_n128<1>(dv, panel_desc<64>(xp + Lay::X_TILE + kk * 32, 16), bo,
                     1);
    wgmma_ss_n128<1>(dk, panel_desc<64>(xp + 2 * Lay::X_TILE + kk * 32, 16),
                     panel_desc<64>(q_cols + kk * 16 * Lay::RB, Lay::Q_PANEL),
                     1);
  }
  wgmma_commit();
}

__global__ void __launch_bounds__(WG_NT, 1)
flash_bwd_dkv_d256_kernel(__grid_constant__ const CUtensorMap tq,
                          __grid_constant__ const CUtensorMap tk,
                          __grid_constant__ const CUtensorMap tv,
                          __grid_constant__ const CUtensorMap tdo,
                          const float* __restrict__ m,
                          const float* __restrict__ l,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv,
                          float* __restrict__ ws, int B, int S, int Tk, int H,
                          int K, int G, int nsl, int causal, int window,
                          float scale, float softcap) {
  using namespace hopper;
  using Lay = Dkv256Layout;
  constexpr int D = 256, BM = Lay::BM, BN = D256_KV_BN, NP = Lay::NP;
  constexpr int STAGES = D256_KV_STAGES;
  // named barriers of the two consumer warpgroups (256 threads): both are
  // done with the exchange of the last pair; both halves of this pair's
  // exchange are written
  constexpr int X_FREE = 1, X_READY = 2;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Lay::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_full = empty + STAGES;
  float* stats = reinterpret_cast<float*>(sm + Lay::STATS);

  // the work item: key tiles in order (n0 = 0, the heaviest under causal,
  // first), within a tile the slices with one head more first
  int item = blockIdx.x;
  const int b = item % B;
  item /= B;
  const int kh = item % K;
  item /= K;
  const int sl = item % nsl;
  const int n0 = item / nsl * BN;
  const int gs = G / nsl + (sl < G % nsl);              // heads of the slice
  const int g0 = sl * (G / nsl) + min(sl, G % nsl);     // its first head
  int m_begin, m_end;
  live_query_tiles(n0, BN, BM, S, causal, window, m_begin, m_end);
  // (query tile, head of the slice) pairs: pair i is tile m_begin + (i /
  // gs) * BM, head kh * G + g0 + i % gs
  const int n_pairs =
      m_begin < m_end ? (m_end - m_begin + BM - 1) / BM * gs : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);    // the producer warp's lanes
      mbar_init(&empty[s], 8);    // lane 0 of each consumer warp
    }
    mbar_init(kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: K, V once; then q, dO and statistics per pair ----
    regs_dealloc<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        prefetch_tensor_map(&tq);
        prefetch_tensor_map(&tk);
        prefetch_tensor_map(&tv);
        prefetch_tensor_map(&tdo);
        mbar_arrive_expect_tx(kv_full, 2 * BN * D * 2);
        for (int p = 0; p < NP; ++p) {
          tma_load_3d(sm + Lay::K + p * Lay::KV_PANEL, &tk, kv_full,
                      kh * D + p * 64, n0, b);
          tma_load_3d(sm + Lay::V + p * Lay::KV_PANEL, &tv, kv_full,
                      kh * D + p * 64, n0, b);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_pairs; ++i) {
        const int m0 = m_begin + (i / gs) * BM;
        const int hq = kh * G + g0 + i % gs;
        mbar_wait(&empty[stage], phase ^ 1);
        // rows past S: m = 0, 1/l = 1, delta = 0 (the mask zeroes their p)
        float* st = stats + stage * 3 * BM;
        for (int r = lane; r < BM; r += 32) {    // two rows a lane
          const bool live = m0 + r < S;
          const size_t at = ((size_t)b * S + (live ? m0 + r : 0)) * H + hq;
          st[r] = live ? m[at] : 0.f;
          st[BM + r] = live ? 1.f / l[at] : 1.f;
          st[2 * BM + r] = live ? delta[at] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[stage], BM * D * 4);  // q, dO
          for (int p = 0; p < NP; ++p) {
            const int o = (stage * NP + p) * Lay::Q_PANEL;
            tma_load_3d(sm + Lay::Q + o, &tq, &full[stage], hq * D + p * 64,
                        m0, b);
            tma_load_3d(sm + Lay::DO + o, &tdo, &full[stage],
                        hq * D + p * 64, m0, b);
          }
        } else {
          mbar_arrive(&full[stage]);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: both own the same 64 keys.  Per pair warpgroup cw
  // computes S^T and dP^T, P^T and dS^T for queries cw * 32 .. cw * 32 +
  // 31 of the tile and writes them to the exchange; then it accumulates dK
  // and dV of columns cw * 128 .. cw * 128 + 127 over all 64 queries ----
  regs_alloc<240>();
  const int t = threadIdx.x - 128;
  // the warpgroup, made warp-uniform for the compiler (ptxas serialises
  // wgmma in code it cannot prove warp-uniform, C7518)
  const int cw = __shfl_sync(0xffffffffu, t >> 7, 0);
  const int warp = (t >> 5) & 3;
  const int lane = t & 31;
  const int qc = (lane & 3) * 2;
  const int row0 = warp * 16 + (lane >> 2);   // key n0 + row0 (+ 8)
  const int qo = cw * 32;                     // this warpgroup's queries

  // [j * 4 + e] is key n0 + row0 + 8 * (e >> 1), column cw * 128 + j * 8 +
  // qc + (e & 1)
  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  const uint32_t base = smem_u32(sm);
  const uint32_t col_ofs = cw * 2 * Lay::Q_PANEL;   // this warpgroup's panels
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  mbar_wait(kv_full, 0);

  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < n_pairs; ++i) {
    const int m0 = m_begin + (i / gs) * BM;
    const int mq0 = m0 + qo;                  // this warpgroup's first query
    const float* ms = stats + stage * 3 * BM + qo;
    const uint32_t q_st = base + Lay::Q + stage * NP * Lay::Q_PANEL;
    const uint32_t do_st = base + Lay::DO + stage * NP * Lay::Q_PANEL;
    mbar_wait(&full[stage], phase);

    // ---- S^T and dP^T (64 keys x 32 queries): [j * 4 + e] is key n0 +
    // row0 + 8 * (e >> 1), query mq0 + j * 8 + qc + (e & 1) ----
    float sc[16], dpt[16];
    wgmma_fence();
    dkv256_score(sc, base + Lay::K, q_st + qo * Lay::RB);
    dkv256_score(dpt, base + Lay::V, do_st + qo * Lay::RB);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dpt);

    // ---- P^T and dS^T: soft-cap, mask and exp branch-free, decided once
    // per pair; the queries' statistics two at a time ----
    if (softcap > 0.f) {
      const float to_t = scale / softcap;
#pragma unroll
      for (int i2 = 0; i2 < 16; ++i2)
        sc[i2] = softcap * tanhf(sc[i2] * to_t);
    } else {
#pragma unroll
      for (int i2 = 0; i2 < 16; ++i2) sc[i2] *= scale;
    }
    uint32_t live = 0xffffu;
    if (mq0 + 32 > S || n0 + BN > Tk || (causal && n0 + BN - 1 > mq0) ||
        (window > 0 && mq0 + 31 - n0 >= window)) {
      live = 0u;
#pragma unroll
      for (int i2 = 0; i2 < 16; ++i2) {
        const int qpos = mq0 + (i2 >> 2) * 8 + qc + (i2 & 1);
        const int kpos = n0 + row0 + 8 * ((i2 >> 1) & 1);
        const int diff = qpos - kpos;
        const bool dead = (qpos >= S) | (kpos >= Tk) |
                          ((causal != 0) & (diff < 0)) |
                          ((window > 0) & (diff >= window));
        live |= (uint32_t)!dead << i2;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 mq = *reinterpret_cast<const float2*>(ms + j * 8 + qc);
      const float2 il =
          *reinterpret_cast<const float2*>(ms + BM + j * 8 + qc);
      const float2 dl =
          *reinterpret_cast<const float2*>(ms + 2 * BM + j * 8 + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i2 = j * 4 + e;
        const float x = sc[i2];
        const float tc = x * inv_cap;
        const float pv = (live >> i2) & 1u
                             ? __expf(x - (e & 1 ? mq.y : mq.x)) *
                                   (e & 1 ? il.y : il.x)
                             : 0.f;
        sc[i2] = pv;
        dpt[i2] = pv * (dpt[i2] - (e & 1 ? dl.y : dl.x)) * (1.f - tc * tc) *
                  scale;
      }
    }

    // ---- this warpgroup's queries of P^T hi, lo and dS^T in bf16 into the
    // exchange, once both warpgroups' gradient products of the last pair
    // are done: row r (key), 16-byte chunk c (8 queries) of the row at
    // c ^ (r % 8); per tile and 8-key half one stmatrix of the four 8 x 8
    // blocks of the 32 queries ----
    uint32_t hi[2][4], lo[2][4], dsb[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i2 = j * 4 + 2 * h;
        hi[h][j] = pack_bf16(sc[i2], sc[i2 + 1]);
        const __nv_bfloat162 h2 =
            *reinterpret_cast<const __nv_bfloat162*>(&hi[h][j]);
        lo[h][j] = pack_bf16(sc[i2] - __low2float(h2),
                             sc[i2 + 1] - __high2float(h2));
        dsb[h][j] = pack_bf16(dpt[i2], dpt[i2 + 1]);
      }
    named_bar_sync(X_FREE, 256);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // lane 8 i + rr: row rr of the block of queries qo + i * 8
      const int r = warp * 16 + 8 * h + (lane & 7);
      const uint32_t at = base + Lay::XP + r * 128 +
                          (((cw * 4 + (lane >> 3)) ^ (lane & 7)) << 4);
      stmatrix_x4(at, hi[h][0], hi[h][1], hi[h][2], hi[h][3]);
      stmatrix_x4(at + Lay::X_TILE, lo[h][0], lo[h][1], lo[h][2], lo[h][3]);
      stmatrix_x4(at + 2 * Lay::X_TILE, dsb[h][0], dsb[h][1], dsb[h][2],
                  dsb[h][3]);
    }
    fence_proxy_async();
    named_bar_sync(X_READY, 256);

    // ---- dV += P^T dO, dK += dS^T Q over this warpgroup's columns ----
    dkv256_grads(dv_acc, dk_acc, base + Lay::XP, q_st + col_ofs,
                 do_st + col_ofs);
    wgmma_wait<0>();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // ---- dK and dV of this warpgroup's columns: bf16 with one slice, else
  // the slice's fp32 partial (summed in slice order by
  // flash_bwd_dkv_sum_kernel) ----
  const size_t n_all = (size_t)B * Tk * K * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = n0 + row0 + 8 * h;
    if (key >= Tk) continue;
    const size_t at = ((size_t)b * Tk + key) * K * D + (size_t)kh * D;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = cw * 128 + j * 8 + qc;
      const float k0 = dk_acc[j * 4 + 2 * h], k1 = dk_acc[j * 4 + 2 * h + 1];
      const float v0 = dv_acc[j * 4 + 2 * h], v1 = dv_acc[j * 4 + 2 * h + 1];
      if (nsl == 1) {
        *reinterpret_cast<uint32_t*>(dk + at + c) = pack_bf16(k0, k1);
        *reinterpret_cast<uint32_t*>(dv + at + c) = pack_bf16(v0, v1);
      } else {
        *reinterpret_cast<float2*>(ws + sl * n_all + at + c) =
            make_float2(k0, k1);
        *reinterpret_cast<float2*>(ws + (nsl + sl) * n_all + at + c) =
            make_float2(v0, v1);
      }
    }
  }
}

// dK and dV (n elements each, bf16) from the nsl fp32 partials of
// flash_bwd_dkv_d256_kernel, summed in slice order: four elements a thread
__global__ void flash_bwd_dkv_sum_kernel(const float* __restrict__ ws,
                                         __nv_bfloat16* __restrict__ dk,
                                         __nv_bfloat16* __restrict__ dv,
                                         size_t n, int nsl) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const float* p = ws + (size_t)w * nsl * n + i;
    float4 a = *reinterpret_cast<const float4*>(p);
    for (int s = 1; s < nsl; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(p + s * n);
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    uint2 o;
    o.x = pack_bf16(a.x, a.y);
    o.y = pack_bf16(a.z, a.w);
    *reinterpret_cast<uint2*>((w == 0 ? dk : dv) + i) = o;
  }
}

// ---------------------------------------------------------------------------
// bf16 dQ at D = 256: 48-key tiles in two stages
// ---------------------------------------------------------------------------
constexpr int D256_Q_BN = 48;       // keys per tile
constexpr int D256_Q_STAGES = 2;    // K/V tiles in flight

// byte offsets from the 1024-aligned base: q and dO (four 64-column panels
// of DQ_BM = 128 positions), two stages of K and V (48 keys a panel, 6144
// bytes: six swizzle periods), the barriers
struct Dq256Layout {
  static constexpr int NP = 4, RB = 128, BN = D256_Q_BN;
  static constexpr int Q_PANEL = DQ_BM * RB;
  static constexpr int KV_PANEL = BN * RB;
  static constexpr int Q = 0;
  static constexpr int DO = Q + NP * Q_PANEL;
  static constexpr int K = DO + NP * Q_PANEL;
  static constexpr int V = K + D256_Q_STAGES * NP * KV_PANEL;
  static constexpr int BAR = V + D256_Q_STAGES * NP * KV_PANEL;
  static constexpr int BYTES = BAR + (2 * D256_Q_STAGES + 1) * 8 + 1024;
};
static_assert(Dq256Layout::BYTES <= 232448, "D = 256 dQ exceeds the SM");
static_assert(Dq256Layout::KV_PANEL % 1024 == 0,
              "each K/V panel starts on a 128-byte swizzle boundary");

__global__ void __launch_bounds__(WG_NT, 1)
flash_bwd_dq_d256_kernel(__grid_constant__ const CUtensorMap tq,
                         __grid_constant__ const CUtensorMap tk,
                         __grid_constant__ const CUtensorMap tv,
                         __grid_constant__ const CUtensorMap tdo,
                         const float* __restrict__ m,
                         const float* __restrict__ l,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int S, int Tk, int H,
                         int G, int causal, int window, float scale,
                         float softcap) {
  using namespace hopper;
  using Lay = Dq256Layout;
  constexpr int D = 256, NP = Lay::NP, RB = Lay::RB, BN = Lay::BN;
  constexpr int NB = BN / 8;          // 8-key column blocks of S and dP
  constexpr int PK = BN / 16;         // k-steps of dS K
  constexpr int STAGES = D256_Q_STAGES;
  static_assert(NB * 4 <= 32, "the live mask is one bit per element");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Lay::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;

  const int hq = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * DQ_BM;    // heaviest first
  const int kh = hq / G;
  int n_begin, n_end;
  live_key_tiles(m0, DQ_BM, BN, Tk, causal, window, n_begin, n_end);
  const int n_tiles = n_begin < n_end ? (n_end - n_begin + BN - 1) / BN : 0;

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
    // ---- producer: q and dO once, then the K/V ring ----
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      prefetch_tensor_map(&tq);
      prefetch_tensor_map(&tk);
      prefetch_tensor_map(&tv);
      prefetch_tensor_map(&tdo);
      mbar_arrive_expect_tx(q_full, 2 * DQ_BM * D * 2);
      for (int p = 0; p < NP; ++p) {
        tma_load_3d(sm + Lay::Q + p * Lay::Q_PANEL, &tq, q_full,
                    hq * D + p * 64, m0, b);
        tma_load_3d(sm + Lay::DO + p * Lay::Q_PANEL, &tdo, q_full,
                    hq * D + p * 64, m0, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        const int n0 = n_begin + j * BN;
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], BN * D * 4);  // K, V
        for (int p = 0; p < NP; ++p) {
          const int o = (stage * NP + p) * Lay::KV_PANEL;
          tma_load_3d(sm + Lay::K + o, &tk, &full[stage], kh * D + p * 64,
                      n0, b);
          tma_load_3d(sm + Lay::V + o, &tv, &full[stage], kh * D + p * 64,
                      n0, b);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: 64 query rows per warpgroup ----
  regs_alloc<240>();
  const int t = threadIdx.x - 128;
  const int cw = t >> 7;
  const int warp = (t >> 5) & 3;
  const int lane = t & 31;
  const int qc = (lane & 3) * 2;
  const int r_lo = m0 + cw * 64;
  int row[2];
  row[0] = r_lo + warp * 16 + (lane >> 2);
  row[1] = row[0] + 8;
  float m_r[2], il_r[2], dl_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool live = row[h] < S;
    const size_t at = ((size_t)b * S + (live ? row[h] : 0)) * H + hq;
    m_r[h] = live ? m[at] : 0.f;
    il_r[h] = live ? 1.f / l[at] : 1.f;
    dl_r[h] = live ? delta[at] : 0.f;
  }
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  // dQ per panel: [p][j * 4 + e] is row row[e >> 1], column p * 64 + j * 8
  // + qc + (e & 1)
  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

  const uint32_t q_addr = smem_u32(sm + Lay::Q) + cw * 64 * RB;
  const uint32_t do_addr = smem_u32(sm + Lay::DO) + cw * 64 * RB;
  mbar_wait(q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = n_begin + j * BN;
    mbar_wait(&full[stage], phase);
    const uint32_t k_addr =
        smem_u32(sm + Lay::K) + stage * NP * Lay::KV_PANEL;
    const uint32_t v_addr =
        smem_u32(sm + Lay::V) + stage * NP * Lay::KV_PANEL;

    // ---- S = Q K^T, dP = dO V^T (64 x 48), two commit groups: p is
    // computed while dP is in flight; [nb * 4 + e] is row row[e >> 1], key
    // n0 + nb * 8 + qc + (e & 1) ----
    float s[NB * 4];
    float dp[NB * 4];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 16; ++ks)
      wgmma_ss(s,
               panel_desc<64>(q_addr + (ks >> 2) * Lay::Q_PANEL +
                                  (ks & 3) * 32, 16),
               panel_desc<64>(k_addr + (ks >> 2) * Lay::KV_PANEL +
                                  (ks & 3) * 32, 16),
               ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < 16; ++ks)
      wgmma_ss(dp,
               panel_desc<64>(do_addr + (ks >> 2) * Lay::Q_PANEL +
                                  (ks & 3) * 32, 16),
               panel_desc<64>(v_addr + (ks >> 2) * Lay::KV_PANEL +
                                  (ks & 3) * 32, 16),
               ks > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // ---- p (1 - (x/c)^2) scale, branch-free: the soft-cap and the mask
    // are decided once per tile ----
    if (softcap > 0.f) {
      const float to_t = scale / softcap;
#pragma unroll
      for (int i = 0; i < NB * 4; ++i)
        s[i] = softcap * tanhf(s[i] * to_t);
    } else {
#pragma unroll
      for (int i = 0; i < NB * 4; ++i) s[i] *= scale;
    }
    uint32_t live = 0xffffffffu;
    if (n0 + BN > Tk || (causal && n0 + BN - 1 > r_lo) ||
        (window > 0 && r_lo + 63 - n0 >= window)) {
      live = 0u;
#pragma unroll
      for (int i = 0; i < NB * 4; ++i) {
        const int kpos = n0 + (i >> 2) * 8 + qc + (i & 1);
        const int diff = row[(i >> 1) & 1] - kpos;
        const bool dead = (kpos >= Tk) | ((causal != 0) & (diff < 0)) |
                          ((window > 0) & (diff >= window));
        live |= (uint32_t)!dead << i;
      }
    }
#pragma unroll
    for (int i = 0; i < NB * 4; ++i) {
      const int h = (i >> 1) & 1;
      const float x = s[i];
      const float pv = (live >> i) & 1u ? __expf(x - m_r[h]) * il_r[h] : 0.f;
      const float tc = x * inv_cap;
      s[i] = pv * (1.f - tc * tc) * scale;
    }

    // ---- dS, packed to bf16 as the A fragments of dQ += dS K ----
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t da[PK][4];
#pragma unroll
    for (int kk = 0; kk < PK; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        const float dl = dl_r[r & 1];
        da[kk][r] =
            pack_bf16(s[i] * (dp[i] - dl), s[i + 1] * (dp[i + 1] - dl));
      }

    // ---- dQ += dS K: one m64n256k16 per 16 keys over the four panels ----
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PK; ++kk)
      wgmma_rs_panels<64, NP>(acc, da[kk], k_addr + kk * 16 * RB,
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

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] < S) {
      __nv_bfloat16* orow = dq + (((size_t)b * S + row[h]) * H + hq) * D;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + p * 64 + j * 8 + qc) =
              pack_bf16(acc[p][j * 4 + 2 * h], acc[p][j * 4 + 2 * h + 1]);
    }
  }
}

template <typename KernelT>
int configure(KernelT kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* m, const float* l, const float* delta, void* dk,
               void* dv, int B, int S, int Tk, int H, int K, int causal,
               int window, float softcap, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  constexpr int BN = kFTile<D>;
  static bool configured = false;
  const int rc = configure(flash_bwd_dkv_kernel<T, D>, bytes, configured);
  if (rc != 0) return rc;
  const dim3 grid((Tk + BN - 1) / BN, K, B);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, m, l, delta,
      (T*)dk, (T*)dv, S, Tk, H, K, H / K, causal, window,
      1.0f / sqrtf((float)D), softcap);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* m, const float* l, const float* delta, void* dq,
              int B, int S, int Tk, int H, int K, int causal, int window,
              float softcap, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  constexpr int BM = kFTile<D>;
  static bool configured = false;
  const int rc = configure(flash_bwd_dq_kernel<T, D>, bytes, configured);
  if (rc != 0) return rc;
  const int G = H / K;
  const dim3 grid((S * G + BM - 1) / BM, K, B);
  flash_bwd_dq_kernel<T, D><<<grid, NT, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, m, l, delta,
      (T*)dq, S, Tk, H, K, G, causal, window, 1.0f / sqrtf((float)D),
      softcap);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_mma(const void* q, const void* k, const void* v,
                   const void* dout, const float* m, const float* l,
                   const float* delta, void* dk, void* dv, int B, int S,
                   int Tk, int H, int K, int causal, int window,
                   float softcap, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr int bytes = dkv_mma_smem_bytes<D>();
  static_assert(bytes <= 232448, "dK/dV tiles exceed the SM");
  static bool configured = false;
  const int rc = configure(flash_bwd_dkv_mma_kernel<D>, bytes, configured);
  if (rc != 0) return rc;
  const dim3 grid((Tk + BN - 1) / BN, K, B);
  flash_bwd_dkv_mma_kernel<D><<<grid, MMA_NT, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, m, l,
      delta, (bf16*)dk, (bf16*)dv, S, Tk, H, K, H / K, causal, window,
      1.0f / sqrtf((float)D), softcap);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const float* m, const float* l,
                     const float* delta, void* dk, void* dv, int B, int S,
                     int Tk, int H, int K, int causal, int window,
                     float softcap, cudaStream_t stream) {
  using Lay = DkvLayout<D>;
  CUtensorMap tq, tk, tv, tdo;
  int rc = hopper::make_tensor_map(&tq, q, B, S, H * D, Lay::BM, Lay::PW);
  if (rc == 0)
    rc = hopper::make_tensor_map(&tdo, dout, B, S, H * D, Lay::BM, Lay::PW);
  if (rc == 0)
    rc = hopper::make_tensor_map(&tk, k, B, Tk, K * D, DKV_BN, Lay::PW);
  if (rc == 0)
    rc = hopper::make_tensor_map(&tv, v, B, Tk, K * D, DKV_BN, Lay::PW);
  if (rc != 0) return rc;
  constexpr int bytes = Lay::BYTES;
  static bool configured = false;
  rc = configure(flash_bwd_dkv_wgmma_kernel<D>, bytes, configured);
  if (rc != 0) return rc;
  const dim3 grid(K * B, (Tk + DKV_BN - 1) / DKV_BN);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, WG_NT, bytes, stream>>>(
      tq, tk, tv, tdo, m, l, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
      S, Tk, H, K, H / K, causal, window, 1.0f / sqrtf((float)D), softcap);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_mma(const void* q, const void* k, const void* v,
                  const void* dout, const float* m, const float* l,
                  const float* delta, void* dq, int B, int S, int Tk, int H,
                  int K, int causal, int window, float softcap,
                  cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr int bytes = dq_mma_smem_bytes<D>();
  static bool configured = false;
  const int rc = configure(flash_bwd_dq_mma_kernel<D>, bytes, configured);
  if (rc != 0) return rc;
  const int G = H / K;
  const dim3 grid((S * G + BM - 1) / BM, K, B);
  flash_bwd_dq_mma_kernel<D><<<grid, MMA_NT, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, m, l,
      delta, (bf16*)dq, S, Tk, H, K, G, causal, window,
      1.0f / sqrtf((float)D), softcap);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const float* m, const float* l,
                    const float* delta, void* dq, int B, int S, int Tk,
                    int H, int K, int causal, int window, float softcap,
                    cudaStream_t stream) {
  constexpr int PW = DqLayout<D>::PW;
  constexpr int BN = DqLayout<D>::BN;
  CUtensorMap tq, tk, tv, tdo;
  int rc = hopper::make_tensor_map(&tq, q, B, S, H * D, DQ_BM, PW);
  if (rc == 0)
    rc = hopper::make_tensor_map(&tdo, dout, B, S, H * D, DQ_BM, PW);
  if (rc == 0) rc = hopper::make_tensor_map(&tk, k, B, Tk, K * D, BN, PW);
  if (rc == 0) rc = hopper::make_tensor_map(&tv, v, B, Tk, K * D, BN, PW);
  if (rc != 0) return rc;
  constexpr int bytes = DqLayout<D>::BYTES;
  static bool configured = false;
  rc = configure(flash_bwd_dq_wgmma_kernel<D>, bytes, configured);
  if (rc != 0) return rc;
  const dim3 grid(H * B, (S + DQ_BM - 1) / DQ_BM);
  flash_bwd_dq_wgmma_kernel<D><<<grid, WG_NT, bytes, stream>>>(
      tq, tk, tv, tdo, m, l, delta, (__nv_bfloat16*)dq, S, Tk, H, H / K,
      causal, window, 1.0f / sqrtf((float)D), softcap);
  return (int)cudaGetLastError();
}

// bf16 dK/dV at D = 256: one launch over the work items, then (with more
// than one head slice) the fixed-order sum of the slices' partials from
// ws, 2 * nsl * B * Tk * K * 256 floats (dkv256_slices)
int launch_dkv_d256(const void* q, const void* k, const void* v,
                    const void* dout, const float* m, const float* l,
                    const float* delta, void* dk, void* dv, float* ws, int B,
                    int S, int Tk, int H, int K, int causal, int window,
                    float softcap, cudaStream_t stream) {
  using Lay = Dkv256Layout;
  const int G = H / K;
  const int nsl = dkv256_slices(B, Tk, K, G);
  if (nsl > 1 && ws == nullptr) return ERR_UNSUPPORTED;
  CUtensorMap tq, tk, tv, tdo;
  int rc = hopper::make_tensor_map(&tq, q, B, S, H * 256, Lay::BM);
  if (rc == 0)
    rc = hopper::make_tensor_map(&tdo, dout, B, S, H * 256, Lay::BM);
  if (rc == 0)
    rc = hopper::make_tensor_map(&tk, k, B, Tk, K * 256, D256_KV_BN);
  if (rc == 0)
    rc = hopper::make_tensor_map(&tv, v, B, Tk, K * 256, D256_KV_BN);
  if (rc != 0) return rc;
  static bool configured = false;
  rc = configure(flash_bwd_dkv_d256_kernel, Lay::BYTES, configured);
  if (rc != 0) return rc;
  const int items = (Tk + D256_KV_BN - 1) / D256_KV_BN * nsl * K * B;
  flash_bwd_dkv_d256_kernel<<<items, WG_NT, Lay::BYTES, stream>>>(
      tq, tk, tv, tdo, m, l, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
      ws, B, S, Tk, H, K, G, nsl, causal, window, 1.0f / 16.0f, softcap);
  rc = (int)cudaGetLastError();
  if (rc != 0 || nsl == 1) return rc;
  const size_t n = (size_t)B * Tk * K * 256;
  flash_bwd_dkv_sum_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0,
                             stream>>>(ws, (__nv_bfloat16*)dk,
                                       (__nv_bfloat16*)dv, n, nsl);
  return (int)cudaGetLastError();
}

int launch_dq_d256(const void* q, const void* k, const void* v,
                   const void* dout, const float* m, const float* l,
                   const float* delta, void* dq, int B, int S, int Tk, int H,
                   int K, int causal, int window, float softcap,
                   cudaStream_t stream) {
  using Lay = Dq256Layout;
  CUtensorMap tq, tk, tv, tdo;
  int rc = hopper::make_tensor_map(&tq, q, B, S, H * 256, DQ_BM);
  if (rc == 0) rc = hopper::make_tensor_map(&tdo, dout, B, S, H * 256, DQ_BM);
  if (rc == 0) rc = hopper::make_tensor_map(&tk, k, B, Tk, K * 256, Lay::BN);
  if (rc == 0) rc = hopper::make_tensor_map(&tv, v, B, Tk, K * 256, Lay::BN);
  if (rc != 0) return rc;
  static bool configured = false;
  rc = configure(flash_bwd_dq_d256_kernel, Lay::BYTES, configured);
  if (rc != 0) return rc;
  const dim3 grid(H * B, (S + DQ_BM - 1) / DQ_BM);
  flash_bwd_dq_d256_kernel<<<grid, WG_NT, Lay::BYTES, stream>>>(
      tq, tk, tv, tdo, m, l, delta, (__nv_bfloat16*)dq, S, Tk, H, H / K,
      causal, window, 1.0f / 16.0f, softcap);
  return (int)cudaGetLastError();
}

// Which design serves dK/dV and dQ at (D, dtype): fp32 on the CUDA cores;
// bf16 on warpgroup products fed by the TMA at D = 64, 128 (llama's heads),
// 160 (stablelm-12b) and 256 (recurrentgemma-2b), on mma.sync at D = 32.
// No launch falls back to another design.
int bwd_design(int D, int dtype) {
  const bool any_d = D == 32 || D == 64 || D == 128 || D == 160 || D == 256;
  if (dtype == DTYPE_F32) return any_d ? DESIGN_CUDA_CORES : DESIGN_NONE;
  if (dtype != DTYPE_BF16 || !any_d) return DESIGN_NONE;
  return D == 32 ? DESIGN_MMA_SYNC : DESIGN_WGMMA;
}

}  // namespace

// q, dout: (B, S, H, D); k, v: (B, T, K, D); m, l, delta: (B, S, H) fp32;
// dk, dv: (B, T, K, D) in the inputs' dtype; ws: fp32 scratch of
// 2 * repro_flash_attention_bwd_dkv_slices(...) * B * T * K * D floats
// where that is above 1, else unused (may be null).  All contiguous.
// Returns 0, a cudaError_t, or ERR_UNSUPPORTED.  Does not synchronise.
extern "C" int repro_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* m, const float* l, const float* delta, void* dk, void* dv,
    float* ws, int B, int S, int T, int H, int K, int D, int dtype,
    int causal, int window, float softcap, void* stream) {
  if (!shape_ok(B, S, T, H, K)) return ERR_UNSUPPORTED;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 256 && bwd_design(D, dtype) == DESIGN_WGMMA)
    return launch_dkv_d256(q, k, v, dout, m, l, delta, dk, dv, ws, B, S, T,
                           H, K, causal, window, softcap, st);
#define REPRO_DKV_ARGS                                                      \
  q, k, v, dout, m, l, delta, dk, dv, B, S, T, H, K, causal, window,       \
      softcap, st
  switch (bwd_design(D, dtype)) {
    case DESIGN_CUDA_CORES:
      switch (D) {
        case 32: return launch_dkv<float, 32>(REPRO_DKV_ARGS);
        case 64: return launch_dkv<float, 64>(REPRO_DKV_ARGS);
        case 128: return launch_dkv<float, 128>(REPRO_DKV_ARGS);
        case 160: return launch_dkv<float, 160>(REPRO_DKV_ARGS);
        case 256: return launch_dkv<float, 256>(REPRO_DKV_ARGS);
      }
      break;
    case DESIGN_MMA_SYNC:
      switch (D) {
        case 32: return launch_dkv_mma<32>(REPRO_DKV_ARGS);
      }
      break;
    case DESIGN_WGMMA:
      switch (D) {
        case 64: return launch_dkv_wgmma<64>(REPRO_DKV_ARGS);
        case 128: return launch_dkv_wgmma<128>(REPRO_DKV_ARGS);
        case 160: return launch_dkv_wgmma<160>(REPRO_DKV_ARGS);
      }
      break;
  }
#undef REPRO_DKV_ARGS
  return ERR_UNSUPPORTED;
}

// The same inputs; dq: (B, S, H, D) in the inputs' dtype.
extern "C" int repro_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* m, const float* l, const float* delta, void* dq, int B,
    int S, int T, int H, int K, int D, int dtype, int causal, int window,
    float softcap, void* stream) {
  if (!shape_ok(B, S, T, H, K)) return ERR_UNSUPPORTED;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_DQ_ARGS                                                       \
  q, k, v, dout, m, l, delta, dq, B, S, T, H, K, causal, window, softcap, st
  switch (bwd_design(D, dtype)) {
    case DESIGN_CUDA_CORES:
      switch (D) {
        case 32: return launch_dq<float, 32>(REPRO_DQ_ARGS);
        case 64: return launch_dq<float, 64>(REPRO_DQ_ARGS);
        case 128: return launch_dq<float, 128>(REPRO_DQ_ARGS);
        case 160: return launch_dq<float, 160>(REPRO_DQ_ARGS);
        case 256: return launch_dq<float, 256>(REPRO_DQ_ARGS);
      }
      break;
    case DESIGN_MMA_SYNC:
      switch (D) {
        case 32: return launch_dq_mma<32>(REPRO_DQ_ARGS);
      }
      break;
    case DESIGN_WGMMA:
      switch (D) {
        case 64: return launch_dq_wgmma<64>(REPRO_DQ_ARGS);
        case 128: return launch_dq_wgmma<128>(REPRO_DQ_ARGS);
        case 160: return launch_dq_wgmma<160>(REPRO_DQ_ARGS);
        case 256: return launch_dq_d256(REPRO_DQ_ARGS);
      }
      break;
  }
#undef REPRO_DQ_ARGS
  return ERR_UNSUPPORTED;
}

// The design that repro_flash_attention_bwd_dkv launches for (D, dtype): one
// of the DESIGN_* codes of common.cuh.
extern "C" int repro_flash_attention_bwd_dkv_design(int D, int dtype) {
  return bwd_design(D, dtype);
}

// The design that repro_flash_attention_bwd_dq launches for (D, dtype).
extern "C" int repro_flash_attention_bwd_dq_design(int D, int dtype) {
  return bwd_design(D, dtype);
}

// Head slices of the bf16 D = 256 dK/dV's key tiles (each slice's fp32
// partial lies in the scratch, two floats per slice and element of dK / dV);
// 1 wherever no scratch is read.
extern "C" int repro_flash_attention_bwd_dkv_slices(int B, int T, int H,
                                                    int K, int D, int dtype) {
  if (D != 256 || bwd_design(D, dtype) != DESIGN_WGMMA || K <= 0 ||
      H % K != 0)
    return 1;
  return dkv256_slices(B, T, K, H / K);
}
