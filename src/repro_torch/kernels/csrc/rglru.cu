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

