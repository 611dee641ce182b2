// RG-LRU linear recurrence h_t = exp(log_a_t) * h_{t-1} + gated_t for sm_90a.
//
// Replaces the TPU kernel repro/kernels/rglru.py (rglru / _rglru_kernel):
// the same function, fp32, h starting from zero (or from a given h0).
//
// What bounds it here: bytes.  Per step and channel it reads two fp32
// values and writes one, and does one exp and one FMA: 3 * S * W * 4 bytes,
// about 126 MB (38 us at 3.35 TB/s) for the served recurrentgemma prefill
// (S = 4096, W = 2560).
//
// What the design does about it (a chunked scan, repro_rglru_fwd): one
// thread per channel walking all S steps gave 20 blocks of 128 threads at
// batch 1 on 132 SMs, and the chain of S dependent exp-FMA steps, not the
// bytes, set the time.  Here the sequence is cut into chunks of RG_CHUNK =
// 64 steps, three launches from one call:
//   (a) rglru_chunk_kernel, one thread per (chunk, channel): the chunk's
//       composite, A_c = prod exp(log_a_t) multiplied step by step and e_c,
//       the chunk's scan from zero, into a small fp32 workspace (B, chunks,
//       W) x 2 that the wrapper allocates (the last chunk's is not needed);
//   (b) rglru_carry_kernel, one thread per (batch, channel): the carries
//       h_c = A_c h_{c-1} + e_c from h0 (or zero) over the chunks, each
//       chunk's entering carry written over its e_c -- 64 dependent steps
//       at the served shape, their loads issued ahead of the chain;
//   (c) rglru_scan_kernel, one thread per (chunk, channel): the chunk again
//       from its entering carry with the serial arithmetic h = exp(log_a_t)
//       h + gated_t, writing y.
// 64 chunks x 20 channel tiles = 1280 blocks at the served shape.  The
// threads of a warp own neighbouring channels, so every load and store is
// coalesced across them; each thread loads AHEAD steps of both inputs
// before it runs their dependent FMA chain.  The inputs are read twice
// (about 210 MB, 63 us at 3.35 TB/s).  Chunk 0 is the serial arithmetic
// exactly; a later chunk's entering carry differs from the serial one by
// the rounding of A_c h + e_c.  Any S, any B.  The serial design it
// replaced (one thread per channel over all S steps, 0.5258 ms at the served
// shape against 0.0854) is deleted; PERF.md keeps its times.
//
// The backward (repro_rglru_bwd; no TPU kernel: the reference differentiates
// rglru_scan_chunked, repro/models/rglru.py:134, through XLA).  With
// a_t = exp(log_a_t), dy the gradient of hs and the adjoint
//   lam_t = dy_t + a_{t+1} lam_{t+1},   lam_{S-1} = dy_{S-1},
// the gradients are d gated_t = lam_t, d log_a_t = lam_t a_t h_{t-1} (h_{-1}
// = h0, or zero) and d h0 = a_0 lam_0.  lam is the forward's recurrence run
// from the end with the decay shifted by one step, so the same three
// launches serve it, mirrored: (a) rglru_bwd_chunk_kernel, each chunk's
// composite from its end (the product of a_{t+1} over the chunk and its
// reverse scan from zero; the first chunk's is not needed); (b)
// rglru_bwd_carry_kernel, the adjoint entering each chunk from the right;
// (c) rglru_bwd_scan_kernel, each chunk again from its carry, writing both
// gradients as it goes (it reads h_{t-1} from the forward's saved hs) and,
// in chunk 0, d h0.  Bounded by bytes: log_a, hs and dy read, two outputs
// written, 5 * S * W * 4 bytes (419 MB, 0.125 ms at 3.35 TB/s for the
// trained recurrentgemma shape, 2 x 4096 x 2560); log_a and dy are read
// twice by design.

#include "common.cuh"

namespace {

using namespace repro;

constexpr int RG_NT = 128;     // threads (channels) per block
constexpr int RG_CHUNK = 64;   // steps per chunk
constexpr int AHEAD = 16;      // steps loaded before their FMA chain runs

// Steps t0 .. t0+n-1 of one channel (element `base` at step 0, stride W)
// from h: h = exp(log_a_t) h + gated_t, with the product of the exp(log_a_t)
// kept in a when A is true and each h written to y when Y is true.
template <bool A, bool Y>
__device__ __forceinline__ void walk(const float* __restrict__ log_a,
                                     const float* __restrict__ gated,
                                     float* __restrict__ y, size_t base,
                                     int W, int n, float& a, float& h) {
  int t = 0;
  for (; t + AHEAD <= n; t += AHEAD) {
    float la[AHEAD], gg[AHEAD];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      const size_t o = base + (size_t)(t + i) * W;
      la[i] = log_a[o];
      gg[i] = gated[o];
    }
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      const float at = expf(la[i]);
      if (A) a *= at;
      h = at * h + gg[i];
      if (Y) y[base + (size_t)(t + i) * W] = h;
    }
  }
  for (; t < n; ++t) {
    const size_t o = base + (size_t)t * W;
    const float at = expf(log_a[o]);
    if (A) a *= at;
    h = at * h + gated[o];
    if (Y) y[o] = h;
  }
}

// (a) chunk c's composite (A_c, e_c) into ca, ce at (b, c, w)
__global__ void __launch_bounds__(RG_NT)
rglru_chunk_kernel(const float* __restrict__ log_a,
                   const float* __restrict__ gated, float* __restrict__ ca,
                   float* __restrict__ ce, int S, int W) {
  const int w = blockIdx.x * RG_NT + threadIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.y + 1;  // the last chunk has no launch here
  if (w >= W) return;
  const int t0 = c * RG_CHUNK;
  float a = 1.f, h = 0.f;
  walk<true, false>(log_a, gated, nullptr, ((size_t)b * S + t0) * W + w, W,
                    RG_CHUNK, a, h);
  const size_t at = ((size_t)b * nc + c) * W + w;
  ca[at] = a;
  ce[at] = h;
}

// (b) the carries: ce[b, c, w] becomes the state entering chunk c
__global__ void __launch_bounds__(RG_NT)
rglru_carry_kernel(const float* __restrict__ ca, float* __restrict__ ce,
                   const float* __restrict__ h0, int nc, int W) {
  const int w = blockIdx.x * RG_NT + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const size_t base = (size_t)b * nc * W + w;
  float h = h0 != nullptr ? h0[(size_t)b * W + w] : 0.f;
  int c = 0;
  for (; c + AHEAD <= nc - 1; c += AHEAD) {
    float aa[AHEAD], ee[AHEAD];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      aa[i] = ca[base + (size_t)(c + i) * W];
      ee[i] = ce[base + (size_t)(c + i) * W];
    }
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      ce[base + (size_t)(c + i) * W] = h;
      h = aa[i] * h + ee[i];
    }
  }
  for (; c < nc - 1; ++c) {
    const size_t o = base + (size_t)c * W;
    const float a = ca[o], e = ce[o];
    ce[o] = h;
    h = a * h + e;
  }
  ce[base + (size_t)(nc - 1) * W] = h;
}

// (c) chunk c from its entering carry, writing y
__global__ void __launch_bounds__(RG_NT)
rglru_scan_kernel(const float* __restrict__ log_a,
                  const float* __restrict__ gated,
                  const float* __restrict__ ce, float* __restrict__ y, int S,
                  int W) {
  const int w = blockIdx.x * RG_NT + threadIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  if (w >= W) return;
  const int t0 = c * RG_CHUNK;
  float a = 1.f;
  float h = ce[((size_t)b * gridDim.y + c) * W + w];
  walk<false, true>(log_a, gated, y, ((size_t)b * S + t0) * W + w, W,
                    min(RG_CHUNK, S - t0), a, h);
}

// ---------------------------------------------------------------------------
// the backward
// ---------------------------------------------------------------------------

// Steps t1-1 down to t0 of one channel (element `base` at step 0, stride W):
// lam = a_next lam + dy_t, then a_next = exp(log_a_t), from lam = the
// adjoint at t1 and a_next = a_{t1}.  With P true the product of the a_next
// is kept in prod; with G true d gated_t = lam and d log_a_t = lam a_t
// h_{t-1} are written (h_{t-1} from hs, or h_first at t = 0).
template <bool P, bool G>
__device__ __forceinline__ void walk_back(
    const float* __restrict__ log_a, const float* __restrict__ dy,
    const float* __restrict__ hs, float* __restrict__ dla,
    float* __restrict__ dg, size_t base, int W, int t0, int t1,
    float h_first, float& a_next, float& prod, float& lam) {
  int t = t1;
  for (; t - AHEAD >= t0; t -= AHEAD) {
    float la[AHEAD], dd[AHEAD], hp[AHEAD];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      const int tt = t - 1 - i;
      const size_t o = base + (size_t)tt * W;
      la[i] = log_a[o];
      dd[i] = dy[o];
      if (G) hp[i] = tt > 0 ? hs[o - W] : h_first;
    }
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      if (P) prod *= a_next;
      lam = a_next * lam + dd[i];
      const float at = expf(la[i]);
      if (G) {
        const size_t o = base + (size_t)(t - 1 - i) * W;
        dg[o] = lam;
        dla[o] = lam * at * hp[i];
      }
      a_next = at;
    }
  }
  for (; t > t0; --t) {
    const int tt = t - 1;
    const size_t o = base + (size_t)tt * W;
    if (P) prod *= a_next;
    lam = a_next * lam + dy[o];
    const float at = expf(log_a[o]);
    if (G) {
      dg[o] = lam;
      dla[o] = lam * at * (tt > 0 ? hs[o - W] : h_first);
    }
    a_next = at;
  }
}

// a_{t1}, the decay that carries the adjoint at t1 back into step t1 - 1
// (zero past the end, where the adjoint is zero)
__device__ __forceinline__ float decay_at(const float* __restrict__ log_a,
                                          size_t base, int W, int t1,
                                          int S) {
  return t1 < S ? expf(log_a[base + (size_t)t1 * W]) : 0.f;
}

// (a) chunk c's composite from its end, c >= 1, into ca, ce at (b, c, w):
// lam at its first step = ca lam at its end + ce
__global__ void __launch_bounds__(RG_NT)
rglru_bwd_chunk_kernel(const float* __restrict__ log_a,
                       const float* __restrict__ dy, float* __restrict__ ca,
                       float* __restrict__ ce, int S, int W) {
  const int w = blockIdx.x * RG_NT + threadIdx.x;
  const int c = blockIdx.y + 1;  // chunk 0 has no launch here
  const int b = blockIdx.z;
  const int nc = gridDim.y + 1;
  if (w >= W) return;
  const int t0 = c * RG_CHUNK;
  const int t1 = min(t0 + RG_CHUNK, S);
  const size_t base = (size_t)b * S * W + w;
  float a_next = decay_at(log_a, base, W, t1, S);
  float prod = 1.f, lam = 0.f;
  walk_back<true, false>(log_a, dy, nullptr, nullptr, nullptr, base, W, t0,
                         t1, 0.f, a_next, prod, lam);
  const size_t at = ((size_t)b * nc + c) * W + w;
  ca[at] = prod;
  ce[at] = lam;
}

// (b) the carries, from the last chunk back: ce[b, c, w] becomes the
// adjoint at the first step of chunk c + 1 (zero for the last chunk)
__global__ void __launch_bounds__(RG_NT)
rglru_bwd_carry_kernel(const float* __restrict__ ca, float* __restrict__ ce,
                       int nc, int W) {
  const int w = blockIdx.x * RG_NT + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const size_t base = (size_t)b * nc * W + w;
  float lam = 0.f;
  int c = nc - 1;
  for (; c - AHEAD >= 0; c -= AHEAD) {
    float aa[AHEAD], ee[AHEAD];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      aa[i] = ca[base + (size_t)(c - i) * W];
      ee[i] = ce[base + (size_t)(c - i) * W];
    }
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      ce[base + (size_t)(c - i) * W] = lam;
      lam = aa[i] * lam + ee[i];
    }
  }
  for (; c > 0; --c) {
    const size_t o = base + (size_t)c * W;
    const float a = ca[o], e = ce[o];
    ce[o] = lam;
    lam = a * lam + e;
  }
  ce[base] = lam;
}

// (c) chunk c again from its carry, writing d gated and d log_a (and, in
// chunk 0, d h0 where dh0 is not null)
__global__ void __launch_bounds__(RG_NT)
rglru_bwd_scan_kernel(const float* __restrict__ log_a,
                      const float* __restrict__ hs,
                      const float* __restrict__ dy,
                      const float* __restrict__ h0,
                      const float* __restrict__ ce, float* __restrict__ dla,
                      float* __restrict__ dg, float* __restrict__ dh0, int S,
                      int W) {
  const int w = blockIdx.x * RG_NT + threadIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  if (w >= W) return;
  const int t0 = c * RG_CHUNK;
  const int t1 = min(t0 + RG_CHUNK, S);
  const size_t base = (size_t)b * S * W + w;
  float a_next = decay_at(log_a, base, W, t1, S);
  float prod = 1.f;
  float lam = ce[((size_t)b * gridDim.y + c) * W + w];
  const float h_first = h0 != nullptr ? h0[(size_t)b * W + w] : 0.f;
  walk_back<false, true>(log_a, dy, hs, dla, dg, base, W, t0, t1, h_first,
                         a_next, prod, lam);
  // a_next is now a_{t0}: in chunk 0, d h0 = a_0 lam_0
  if (c == 0 && dh0 != nullptr) dh0[(size_t)b * W + w] = a_next * lam;
}

}  // namespace

// log_a, gated, y (B, S, W) fp32; h0 (B, W) fp32 or null; ws 2 * B *
// n_chunks * W fp32, n_chunks = ceil(S / RG_CHUNK) (rglru.py CHUNK); all
// contiguous.  Three launches on `stream`.  Returns 0, a cudaError_t, or
// ERR_UNSUPPORTED.  Does not synchronise.
extern "C" int repro_rglru_fwd(const float* log_a, const float* gated,
                               const float* h0, float* y, float* ws,
                               int n_chunks, int B, int S, int W,
                               void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535 ||
      n_chunks != (S + RG_CHUNK - 1) / RG_CHUNK || n_chunks > 65535)
    return ERR_UNSUPPORTED;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (W + RG_NT - 1) / RG_NT;
  float* ca = ws;
  float* ce = ws + (size_t)B * n_chunks * W;
  if (n_chunks > 1) {
    rglru_chunk_kernel<<<dim3(tiles, n_chunks - 1, B), RG_NT, 0, st>>>(
        log_a, gated, ca, ce, S, W);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  rglru_carry_kernel<<<dim3(tiles, B), RG_NT, 0, st>>>(ca, ce, h0, n_chunks,
                                                       W);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rglru_scan_kernel<<<dim3(tiles, n_chunks, B), RG_NT, 0, st>>>(
      log_a, gated, ce, y, S, W);
  return (int)cudaGetLastError();
}


// The backward of repro_rglru_fwd.  log_a, hs (the forward's output), dy,
// dlog_a, dgated (B, S, W) fp32; h0, dh0 (B, W) fp32 or both null; ws as
// the forward's.  Three launches on `stream`.  Returns 0, a cudaError_t, or
// ERR_UNSUPPORTED.  Does not synchronise.
extern "C" int repro_rglru_bwd(const float* log_a, const float* hs,
                               const float* dy, const float* h0,
                               float* dlog_a, float* dgated, float* dh0,
                               float* ws, int n_chunks, int B, int S, int W,
                               void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535 ||
      n_chunks != (S + RG_CHUNK - 1) / RG_CHUNK || n_chunks > 65535 ||
      (h0 == nullptr) != (dh0 == nullptr))
    return ERR_UNSUPPORTED;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (W + RG_NT - 1) / RG_NT;
  float* ca = ws;
  float* ce = ws + (size_t)B * n_chunks * W;
  if (n_chunks > 1) {
    rglru_bwd_chunk_kernel<<<dim3(tiles, n_chunks - 1, B), RG_NT, 0, st>>>(
        log_a, dy, ca, ce, S, W);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  rglru_bwd_carry_kernel<<<dim3(tiles, B), RG_NT, 0, st>>>(ca, ce, n_chunks,
                                                           W);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rglru_bwd_scan_kernel<<<dim3(tiles, n_chunks, B), RG_NT, 0, st>>>(
      log_a, hs, dy, h0, ce, dlog_a, dgated, dh0, S, W);
  return (int)cudaGetLastError();
}
