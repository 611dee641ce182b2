// One-token decode attention read through block tables from the page pool,
// for sm_90a.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py (_paged_kernel):
// q (B, H, D) attends over the first lengths[b] token slots of sequence b,
// whose K/V live in pool pages (N, page_size, K, D) named by tables (B, P).
// Slot t is live iff t < lengths[b]; a zero-length row gives zeros.
//
// What bounds it here: bytes.  Each K/V element is used by only the G query
// heads of its group, so the kernel can do nothing better than stream the
// live K/V bytes once at the memory rate.
//
// What the design does about it (split-KV, repro_paged_decode_attention):
//   * The TPU kernel's scalar-prefetched tables steering a sequential grid
//     of page copies become blocks that read their own table rows.  Each
//     row's token axis is cut into pieces of a whole number of pages
//     (paged_attention.py split_pieces: about 128 tokens), and one block
//     runs per (piece, kv head, sequence): 568 live blocks at 8 served
//     sequences of up to 2048 tokens on 8 kv heads, where one block per
//     (sequence, kv head) gave 64 on 132 SMs and the longest row set the
//     time.  The number of pieces comes from the table width P, which the
//     host knows; lengths stay on the device.  A block whose piece starts
//     at or past lengths[b] returns at once; no page past lengths[b] is
//     read.
//   * A block reads its piece's page ids once, then walks the piece in
//     tiles of TILE_ROWS = 32 K and V rows through a two-stage ring in
//     shared memory: it issues every 16-byte copy of a tile at once with
//     cp.async, and computes tile j while tile j + 1 travels.  Keeping the loads out
//     of registers leaves room for several blocks on an SM.
//   * Each tile is computed in three passes, each with independent work for
//     every thread: (a) scores -- each K row is read in 16-byte slices by a
//     group of RG neighbouring lanes, RG the smallest power of two that
//     covers the row's slices, at most a warp (fp32 at D = 160 has 40
//     slices: lanes stride over them; bf16 at D = 160 has 20: 12 lanes of a
//     warp idle), and the dot product with each of the G query heads, held
//     in registers, is reduced over exactly the lanes of one row; (b) the
//     online softmax of each head over the tile's 32 rows, one row a lane,
//     the running max and sum in the registers of the warp that owns the
//     head; (c) acc = corr * acc + sum_r p_r V_r, each thread owning pairs
//     of output columns.  K and V are read once per group: the G heads use
//     each row from shared memory.  An online softmax per round of rows,
//     with K/V in registers, was latency-bound (PERF.md).
//   * A second launch from the same C entry point merges the live pieces of
//     each (sequence, kv head): out = sum_i f_i acc_i / max(sum_i f_i l_i,
//     1e-30) with f_i = exp(m_i - max m), in q's dtype.  It reads only the
//     pieces below lengths[b], so a zero-length row gives zeros and a piece
//     with no live token never reaches the sum.  No atomics: every call
//     computes the same sums in the same order.
//
// The design it replaced (one block per (sequence, kv head), 16 warps over
// the whole row: 0.0745 ms at llama's served shape against 0.0316) is
// deleted; PERF.md keeps its times.

#include "common.cuh"

namespace {

using namespace repro;

// ---------------------------------------------------------------------------
// split-KV: one block per (piece, kv head, sequence), then a merge
// ---------------------------------------------------------------------------
constexpr int SPLIT_NT = 128;  // 4 warps a piece
constexpr int SPLIT_NW = SPLIT_NT / 32;
constexpr int MERGE_NT = 128;
constexpr int TILE_ROWS = 32;  // K/V rows of one stage of the tile ring
constexpr int MAX_PIECE_PAGES = 128;  // page ids a block stages

// How the lanes of a warp cover K/V rows of D elements of type T when they
// score them: NS 16-byte slices a row, RG lanes a row (the smallest power of
// two >= NS, at most 32), SPL slices a lane (lanes stride by RG), TPW rows a
// warp at a time, STEPS times for the warp's RPW rows of a tile.
template <typename T, int D> struct RowSplit {
  static constexpr int VEC = Elem<T>::VEC;
  static constexpr int NS = D / VEC;
  static constexpr int RG = NS <= 1 ? 1 : NS <= 2 ? 2 : NS <= 4 ? 4
                          : NS <= 8 ? 8 : NS <= 16 ? 16 : 32;
  static constexpr int SPL = (NS + RG - 1) / RG;
  static constexpr int TPW = 32 / RG;
  static constexpr int RPW = TILE_ROWS / SPLIT_NW;
  static constexpr int STEPS = RPW / TPW;
  static constexpr int TILE = TILE_ROWS * D;  // elements of a K or V tile
  // dynamic shared memory: two stages of a K tile and a V tile
  static constexpr int SMEM = 2 * 2 * TILE * (int)sizeof(T);
  static_assert(D % VEC == 0, "a row is whole 16-byte slices");
  static_assert(RPW % TPW == 0, "a warp scores whole rounds of rows");
};
static_assert(TILE_ROWS == 32, "the softmax pass gives one row to a lane");

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The partial of one piece: m, l and acc[G][D] (acc not yet divided by l)
// for its live tokens, into ws.  ws holds acc of every (sequence, kv head,
// piece, head of the group) first, D floats each, then their (m, l) pairs.
// The bound's second argument (at least one block an SM) leaves ptxas free
// to give a thread the registers it needs: without it, ptxas (nvcc 12.9)
// capped several instantiations at 56-96 registers and spilled a few bytes.
// The shared memory of a block (33-82 KB) allows several blocks an SM.
template <typename T, int D, int GT>
__global__ void __launch_bounds__(SPLIT_NT, 1)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ tables,
                   const int* __restrict__ lengths, float* __restrict__ ws,
                   int H, int K, int G, int ps, int P, int piece_tokens,
                   float scale, float softcap) {
  using R = RowSplit<T, D>;
  constexpr int VEC = R::VEC, NS = R::NS, RG = R::RG, SPL = R::SPL;
  constexpr int TPW = R::TPW, RPW = R::RPW, STEPS = R::STEPS;
  constexpr int NW = SPLIT_NW;
  constexpr int HPW = (GT + NW - 1) / NW;  // heads whose softmax a warp keeps
  constexpr int NPAIR = GT * D / 2;        // output column pairs of a chunk
  constexpr int PAIRS = (NPAIR + SPLIT_NT - 1) / SPLIT_NT;  // per thread

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // 2 stages of (TILE_ROWS, D)
  T* Vs = Ks + 2 * R::TILE;
  __shared__ int pages[MAX_PIECE_PAGES];   // the page ids of the piece
  __shared__ float sm_s[GT][TILE_ROWS];    // scores, then probabilities
  __shared__ float sm_corr[GT];            // each head's rescale of acc

  const int piece = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int len = min(lengths[b], P * ps);
  const int t_begin = piece * piece_tokens;
  if (t_begin >= len) return;  // no live token: the merge never reads it
  const int t_end = min(len, t_begin + piece_tokens);
  const int n_tiles = (t_end - t_begin + TILE_ROWS - 1) / TILE_ROWS;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / RG;  // which row of a round
  const int sub = lane % RG;  // first 16-byte slice of the row
  // the lane's slices: sub + s * RG where that exists; a lane without one
  // reads the row's last slice (its q is zero there)
  bool has[SPL];
  int col[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    has[s] = sub + s * RG < NS;
    col[s] = min(sub + s * RG, NS - 1) * VEC;
  }
  const size_t n_parts = (size_t)gridDim.z * K * gridDim.x * G;
  const size_t part0 = (((size_t)b * K + kh) * gridDim.x + piece) * G;
  // the piece's page ids, read once (the piece starts on a page boundary)
  const int p_begin = t_begin / ps;
  for (int i = threadIdx.x; i <= (t_end - 1) / ps - p_begin; i += SPLIT_NT)
    pages[i] = tables[(size_t)b * P + p_begin + i];
  __syncthreads();

  // tile j's K and V rows into stage j % 2, every 16-byte copy in flight at
  // once (committed as one group)
  auto load_tile = [&](int j) {
    const int tile0 = t_begin + j * TILE_ROWS;
    const int n = min(TILE_ROWS, t_end - tile0);
    T* ks = Ks + (j & 1) * R::TILE;
    T* vs = Vs + (j & 1) * R::TILE;
    for (int i = threadIdx.x; i < n * NS; i += SPLIT_NT) {
      const int r = i / NS, c = (i % NS) * VEC;
      const int tt = tile0 + r;
      const size_t off =
          (((size_t)pages[tt / ps - p_begin] * ps + tt % ps) * K + kh) * D +
          c;
      cp_async16(ks + r * D + c, kp + off, 16);
      cp_async16(vs + r * D + c, vp + off, 16);
    }
    cp_async_commit();
  };

  for (int g0 = 0; g0 < G; g0 += GT) {
    float qr[GT][SPL][VEC];
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int s = 0; s < SPL; ++s) {
        if (g0 + g < G && has[s]) {
          Elem<T>::load16(
              q + ((size_t)b * H + (size_t)kh * G + g0 + g) * D + col[s],
              qr[g][s]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) qr[g][s][e] = 0.f;
        }
      }
    float m[HPW], l[HPW];
#pragma unroll
    for (int k = 0; k < HPW; ++k) {
      m[k] = NEG_INF;
      l[k] = 0.f;
    }
    float acc[PAIRS][2];
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) acc[i][0] = acc[i][1] = 0.f;

    load_tile(0);
    for (int j = 0; j < n_tiles; ++j) {
      // the next tile travels while this one is computed
      if (j + 1 < n_tiles) {
        load_tile(j + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int n = min(TILE_ROWS, t_end - (t_begin + j * TILE_ROWS));
      const T* ks = Ks + (j & 1) * R::TILE;
      const T* vs = Vs + (j & 1) * R::TILE;

      // (a) the scores of this warp's RPW rows for every head of the chunk;
      // the dot product is reduced over exactly the RG lanes of one row
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        const int r = warp * RPW + st * TPW + grp;
        float kr[SPL][VEC];
#pragma unroll
        for (int s = 0; s < SPL; ++s)
          Elem<T>::unpack(load_raw16(ks + r * D + col[s]), kr[s]);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int s = 0; s < SPL; ++s)
#pragma unroll
            for (int e = 0; e < VEC; ++e) dot += qr[g][s][e] * kr[s][e];
#pragma unroll
          for (int off = RG / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          float x = dot * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          // a row past the piece's live tokens holds stale bits: never used
          if (sub == 0) sm_s[g][r] = r < n ? x : NEG_INF;
        }
      }
      __syncthreads();

      // (b) the online softmax of each head over the tile, one row a lane:
      // warp w keeps the running max and sum of heads w, w + NW, ...
#pragma unroll
      for (int k = 0; k < HPW; ++k) {
        const int g = warp + k * NW;
        if (g < GT) {
          const float x = sm_s[g][lane];
          const float m_new = fmaxf(m[k], warp_max(x));
          const float corr = expf(m[k] - m_new);
          const float p = expf(x - m_new);  // row 0 is live: m_new finite
          l[k] = l[k] * corr + warp_sum(p);
          m[k] = m_new;
          // probabilities are cast to V's dtype before the PV product
          sm_s[g][lane] = Elem<T>::round_through(p);
          if (lane == 0) sm_corr[g] = corr;
        }
      }
      __syncthreads();

      // (c) acc = corr * acc + sum_r p_r V_r: a thread owns column pairs
#pragma unroll
      for (int i = 0; i < PAIRS; ++i) {
        const int pi = threadIdx.x + i * SPLIT_NT;
        if (NPAIR % SPLIT_NT == 0 || pi < NPAIR) {
          const int g = pi / (D / 2);
          const int d = (pi % (D / 2)) * 2;
          const float corr = sm_corr[g];
          float a0 = acc[i][0] * corr, a1 = acc[i][1] * corr;
#pragma unroll 8
          for (int r = 0; r < n; ++r) {
            const float p = sm_s[g][r];
            const float2 v = load2(vs + r * D + d);
            a0 += p * v.x;
            a1 += p * v.y;
          }
          acc[i][0] = a0;
          acc[i][1] = a1;
        }
      }
      __syncthreads();  // the stage and the scores are free again
    }

    // the piece's partials of the chunk's heads
#pragma unroll
    for (int k = 0; k < HPW; ++k) {
      const int g = warp + k * NW;
      if (g < GT && g0 + g < G && lane == 0) {
        const size_t part = part0 + g0 + g;
        ws[n_parts * D + 2 * part] = m[k];
        ws[n_parts * D + 2 * part + 1] = l[k];
      }
    }
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int pi = threadIdx.x + i * SPLIT_NT;
      const int g = pi / (D / 2);
      if (pi < NPAIR && g0 + g < G) {
        float* dst = ws + (part0 + g0 + g) * D + (pi % (D / 2)) * 2;
        dst[0] = acc[i][0];
        dst[1] = acc[i][1];
      }
    }
  }
}

// out[b, kh*G + g] = sum_i f_i acc_i / max(sum_i f_i l_i, 1e-30) over the
// pieces i that hold a live token, f_i = exp(m_i - max m): one thread per
// output element, MERGE_NT of them a block over the (kv head, sequence)'s
// G * D outputs.  The max is kept running (the sums rescaled when it
// rises), so the pieces are read in one pass, their loads issued ahead.
template <typename T>
__global__ void __launch_bounds__(MERGE_NT)
paged_merge_kernel(const float* __restrict__ ws,
                   const int* __restrict__ lengths, T* __restrict__ out,
                   int H, int K, int G, int D, int ps, int P,
                   int piece_tokens, int n_pieces) {
  const int idx = blockIdx.x * MERGE_NT + threadIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  if (idx >= G * D) return;
  const int g = idx / D;
  const int d = idx % D;
  const int len = max(0, min(lengths[b], P * ps));
  const int n_live = (len + piece_tokens - 1) / piece_tokens;
  const size_t n_parts = (size_t)gridDim.z * K * n_pieces * G;
  const float* ml = ws + n_parts * D;
  const size_t part0 = ((size_t)b * K + kh) * n_pieces * G + g;
  float mm = NEG_INF, num = 0.f, den = 0.f;
#pragma unroll 4
  for (int i = 0; i < n_live; ++i) {
    const size_t part = part0 + (size_t)i * G;
    const float mi = ml[2 * part];
    const float li = ml[2 * part + 1];
    const float ai = ws[part * D + d];
    const float m_new = fmaxf(mm, mi);
    const float c = expf(mm - m_new);  // 0 at the first piece
    const float f = expf(mi - m_new);
    num = num * c + f * ai;
    den = den * c + f * li;
    mm = m_new;
  }
  out[((size_t)b * H + (size_t)kh * G + g) * D + d] =
      Elem<T>::from_float(num / fmaxf(den, 1e-30f));
}

struct SplitArgs {
  const void *q, *kp, *vp;
  const int *tables, *lengths;
  void* out;
  float* ws;
  int B, H, K, D, ps, P, pages_per_piece, n_pieces;
  float softcap;
};

template <typename T, int D, int GT>
int launch_split(const SplitArgs& a, cudaStream_t stream) {
  constexpr int bytes = RowSplit<T, D>::SMEM;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel<T, D, GT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int G = a.H / a.K;
  const int piece_tokens = a.pages_per_piece * a.ps;
  paged_split_kernel<T, D, GT>
      <<<dim3(a.n_pieces, a.K, a.B), SPLIT_NT, bytes, stream>>>(
          (const T*)a.q, (const T*)a.kp, (const T*)a.vp, a.tables, a.lengths,
          a.ws, a.H, a.K, G, a.ps, a.P, piece_tokens,
          1.0f / sqrtf((float)D), a.softcap);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_merge_kernel<T><<<dim3((G * D + MERGE_NT - 1) / MERGE_NT, a.K, a.B),
                          MERGE_NT, 0, stream>>>(
      a.ws, a.lengths, (T*)a.out, a.H, a.K, G, D, a.ps, a.P, piece_tokens,
      a.n_pieces);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_split_g(const SplitArgs& a, cudaStream_t stream) {
  const int G = a.H / a.K;  // heads per chunk: smallest of 1, 2, 4, 8
  if (G <= 1) return launch_split<T, D, 1>(a, stream);
  if (G <= 2) return launch_split<T, D, 2>(a, stream);
  if (G <= 4) return launch_split<T, D, 4>(a, stream);
  return launch_split<T, D, 8>(a, stream);
}

template <typename T>
int launch_split_d(const SplitArgs& a, cudaStream_t stream) {
  switch (a.D) {
    case 32: return launch_split_g<T, 32>(a, stream);
    case 64: return launch_split_g<T, 64>(a, stream);
    case 128: return launch_split_g<T, 128>(a, stream);
    case 160: return launch_split_g<T, 160>(a, stream);
    default: return ERR_UNSUPPORTED;
  }
}

}  // namespace

// q, out: (B, H, D); k_pages, v_pages: (N, ps, K, D); tables: (B, P) int32;
// lengths: (B,) int32; ws: B * K * n_pieces * (H / K) * (D + 2) fp32, the
// pieces' partials; a piece is pages_per_piece pages of the table, n_pieces
// = ceil(P / pages_per_piece).  All contiguous.  Two launches on `stream`
// (the pieces, then their merge).  Returns 0, a cudaError_t, or
// ERR_UNSUPPORTED.  Does not synchronise.
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, float* ws, int B,
    int H, int K, int D, int ps, int P, int pages_per_piece, int n_pieces,
    int dtype, float softcap, void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0 || ps <= 0 || P <= 0 || B > 65535 ||
      K > 65535 || pages_per_piece <= 0 ||
      pages_per_piece > MAX_PIECE_PAGES ||
      n_pieces != (P + pages_per_piece - 1) / pages_per_piece)
    return ERR_UNSUPPORTED;
  const SplitArgs a{q, k_pages, v_pages, (const int*)tables,
                    (const int*)lengths, out, ws, B, H, K, D, ps, P,
                    pages_per_piece, n_pieces, softcap};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_F32) return launch_split_d<float>(a, st);
  if (dtype == DTYPE_BF16) return launch_split_d<__nv_bfloat16>(a, st);
  return ERR_UNSUPPORTED;
}
