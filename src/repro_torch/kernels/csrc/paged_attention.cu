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
// What the design does about it:
//   * The TPU kernel's scalar-prefetched tables steering a sequential grid
//     of page copies become a block that reads its own table row: one block
//     per (sequence, kv head), 16 warps striding over that row's live token
//     slots, so pages past lengths[b] are never touched.
//   * Every K/V row is fetched with 16-byte loads by D*sizeof(T)/16
//     neighbouring lanes and is used for all G heads of the group from
//     registers: K/V is read once per group.  The loads of a warp's next
//     round are issued (and held as raw bits) before the current round is
//     computed, so memory latency hides behind the arithmetic.
//   * Each warp keeps its own online-softmax state (m shared by its lanes,
//     l and acc partial per lane) in registers; the warps are merged once
//     at the end through shared memory -- the block-local form of the TPU
//     kernel's (m, l, acc) scratch carried along the kv axis.
//   * One block per (b, kv_head) leaves SMs idle when B*K is below the SM
//     count (64 blocks for 8 sequences of an 8-kv-head model on 132 SMs);
//     splitting the token axis across blocks (split-KV) is later work.

#include "common.cuh"

namespace {

using namespace repro;

// 16 warps for up to 4 heads per chunk; 8 where 8 heads' state needs the
// registers
template <int GT> constexpr int kThreads = GT >= 8 ? 256 : 512;

template <typename T, int D, int GT>
__global__ void __launch_bounds__(kThreads<GT>)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int H, int K, int G, int ps, int P, float scale,
                    float softcap) {
  constexpr int VEC = Elem<T>::VEC;   // elements per 16-byte load
  constexpr int LPT = D / VEC;        // lanes that share one token row
  constexpr int TPW = 32 / LPT;       // token rows per warp per round
  constexpr int U = 2;                // token rows per lane per round
  constexpr int NT = kThreads<GT>;
  constexpr int NW = NT / 32;
  constexpr int STEP = NW * TPW * U;  // token rows per block per round
  static_assert(LPT >= 1 && LPT <= 32, "row must fit one warp");

  __shared__ float sm_m[NW][GT];
  __shared__ float sm_l[NW][GT];
  __shared__ float sm_acc[NW][GT][D];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / LPT;  // which token row of the round
  const int sub = lane % LPT;  // which 16-byte slice of the row
  const int len = min(lengths[b], P * ps);
  const int* tab = tables + (size_t)b * P;

  for (int g0 = 0; g0 < G; g0 += GT) {
    float qr[GT][VEC];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g0 + g < G) {
        Elem<T>::load16(
            q + ((size_t)b * H + (size_t)kh * G + g0 + g) * D + sub * VEC,
            qr[g]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qr[g][e] = 0.f;
      }
    }

    float m[GT], l[GT], acc[GT][VEC];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
    }

    // raw K/V bits of round `t`: rows t + u*TPW + grp (zeros past len)
    auto fetch = [&](int t, uint4 (&kraw)[U], uint4 (&vraw)[U]) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int tt = t + u * TPW + grp;
        if (tt < len) {
          const int page = tab[tt / ps];
          const size_t off =
              (((size_t)page * ps + (tt % ps)) * K + kh) * D + sub * VEC;
          kraw[u] = load_raw16(kp + off);
          vraw[u] = load_raw16(vp + off);
        } else {
          kraw[u] = make_uint4(0u, 0u, 0u, 0u);
          vraw[u] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    };

    uint4 k_next[U], v_next[U];
    int t0 = warp * TPW * U;
    if (t0 < len) fetch(t0, k_next, v_next);
    for (; t0 < len; t0 += STEP) {
      float kr[U][VEC], vr[U][VEC];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ok[u] = t0 + u * TPW + grp < len;
        Elem<T>::unpack(k_next[u], kr[u]);
        Elem<T>::unpack(v_next[u], vr[u]);
      }
      if (t0 + STEP < len) fetch(t0 + STEP, k_next, v_next);

#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float s[U];
        float mx = NEG_INF;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot += qr[g][e] * kr[u][e];
#pragma unroll
          for (int off = LPT / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          float x = dot * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          s[u] = ok[u] ? x : NEG_INF;
          mx = fmaxf(mx, s[u]);
        }
        // one running max per warp: combine the token rows of the round
#pragma unroll
        for (int off = 16; off >= LPT; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[g], mx);
        const float corr = expf(m[g] - m_new);
        m[g] = m_new;
        l[g] *= corr;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] *= corr;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = ok[u] ? expf(s[u] - m_new) : 0.f;
          l[g] += p;
          const float pr = Elem<T>::round_through(p);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] += pr * vr[u][e];
        }
      }
    }

    // sum the per-lane partials over the token rows of a warp
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int off = LPT; off < 32; off <<= 1) {
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
      }
      if (grp == 0) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) sm_acc[warp][g][sub * VEC + e] = acc[g][e];
      }
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
    __syncthreads();

    // merge the warps: out = sum_w f_w acc_w / max(sum_w f_w l_w, 1e-30)
    for (int idx = threadIdx.x; idx < GT * D; idx += NT) {
      const int g = idx / D;
      const int d = idx % D;
      if (g0 + g < G) {
        float mm = NEG_INF;
#pragma unroll
        for (int w = 0; w < NW; ++w) mm = fmaxf(mm, sm_m[w][g]);
        float num = 0.f, den = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const float f = expf(sm_m[w][g] - mm);
          num += f * sm_acc[w][g][d];
          den += f * sm_l[w][g];
        }
        out[((size_t)b * H + (size_t)kh * G + g0 + g) * D + d] =
            Elem<T>::from_float(num / fmaxf(den, 1e-30f));
      }
    }
    __syncthreads();  // shared memory is reused by the next head chunk
  }
}

template <typename T, int D, int GT>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* lengths, void* out, int B, int H, int K, int ps, int P,
           float softcap, cudaStream_t stream) {
  const dim3 grid(K, B);
  paged_decode_kernel<T, D, GT><<<grid, kThreads<GT>, 0, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, tables, lengths, (T*)out, H, K,
      H / K, ps, P, 1.0f / sqrtf((float)D), softcap);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_g(const void* q, const void* kp, const void* vp, const int* tables,
             const int* lengths, void* out, int B, int H, int K, int ps, int P,
             float softcap, cudaStream_t stream) {
  const int G = H / K;  // heads per chunk: smallest of 1, 2, 4, 8 covering G
  if (G <= 1)
    return launch<T, D, 1>(q, kp, vp, tables, lengths, out, B, H, K, ps, P,
                           softcap, stream);
  if (G <= 2)
    return launch<T, D, 2>(q, kp, vp, tables, lengths, out, B, H, K, ps, P,
                           softcap, stream);
  if (G <= 4)
    return launch<T, D, 4>(q, kp, vp, tables, lengths, out, B, H, K, ps, P,
                           softcap, stream);
  return launch<T, D, 8>(q, kp, vp, tables, lengths, out, B, H, K, ps, P,
                         softcap, stream);
}

template <typename T>
int launch_d(int D, const void* q, const void* kp, const void* vp,
             const int* tables, const int* lengths, void* out, int B, int H,
             int K, int ps, int P, float softcap, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_g<T, 32>(q, kp, vp, tables, lengths, out, B, H, K, ps, P,
                             softcap, stream);
    case 64:
      return launch_g<T, 64>(q, kp, vp, tables, lengths, out, B, H, K, ps, P,
                             softcap, stream);
    case 128:
      return launch_g<T, 128>(q, kp, vp, tables, lengths, out, B, H, K, ps, P,
                              softcap, stream);
    default:
      return ERR_UNSUPPORTED;
  }
}

}  // namespace

// q, out: (B, H, D); k_pages, v_pages: (N, ps, K, D); tables: (B, P) int32;
// lengths: (B,) int32; all contiguous.  Returns 0, a cudaError_t, or
// ERR_UNSUPPORTED.  Does not synchronise.
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, int B, int H, int K,
    int D, int ps, int P, int dtype, float softcap, void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0 || ps <= 0 || P <= 0 || B > 65535)
    return ERR_UNSUPPORTED;
  cudaStream_t st = (cudaStream_t)stream;
  const int* tab = (const int*)tables;
  const int* len = (const int*)lengths;
  if (dtype == DTYPE_F32)
    return launch_d<float>(D, q, k_pages, v_pages, tab, len, out, B, H, K, ps,
                           P, softcap, st);
  if (dtype == DTYPE_BF16)
    return launch_d<__nv_bfloat16>(D, q, k_pages, v_pages, tab, len, out, B,
                                   H, K, ps, P, softcap, st);
  return ERR_UNSUPPORTED;
}
