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
// What the design does about it: one thread owns one (batch, channel) and
// walks the sequence, so the recurrence never leaves a register; the
// threads of a warp own neighbouring channels, so every load and store is
// coalesced across them; the exp is fused; and each thread loads AHEAD steps
// of both inputs before it runs their dependent FMA chain, so that many
// loads are in flight per thread while the chain runs.  Any S works.  At
// batch 1 and W = 2560 this is only 20 blocks of 128 threads on 132 SMs:
// the chain of S dependent steps, not the bytes, sets the time.  A chunked
// two-pass scan (local scans, then a carry fix-up) is the later fix.

#include "common.cuh"

namespace {

using namespace repro;

constexpr int RG_NT = 128;   // threads (channels) per block
constexpr int AHEAD = 16;    // steps loaded before their FMA chain runs

__global__ void __launch_bounds__(RG_NT)
rglru_kernel(const float* __restrict__ log_a, const float* __restrict__ gated,
             const float* __restrict__ h0, float* __restrict__ y, int S,
             int W) {
  const int w = blockIdx.x * RG_NT + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const size_t base = (size_t)b * S * W + w;
  float h = h0 != nullptr ? h0[(size_t)b * W + w] : 0.f;
  int t = 0;
  for (; t + AHEAD <= S; t += AHEAD) {
    float la[AHEAD], gg[AHEAD];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      const size_t o = base + (size_t)(t + i) * W;
      la[i] = log_a[o];
      gg[i] = gated[o];
    }
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      h = expf(la[i]) * h + gg[i];
      y[base + (size_t)(t + i) * W] = h;
    }
  }
  for (; t < S; ++t) {
    const size_t o = base + (size_t)t * W;
    h = expf(log_a[o]) * h + gated[o];
    y[o] = h;
  }
}

}  // namespace

// log_a, gated, y (B, S, W) fp32; h0 (B, W) fp32 or null; all contiguous.
// Returns 0, a cudaError_t, or ERR_UNSUPPORTED.  Does not synchronise.
extern "C" int repro_rglru_fwd(const float* log_a, const float* gated,
                               const float* h0, float* y, int B, int S, int W,
                               void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return ERR_UNSUPPORTED;
  const dim3 grid((W + RG_NT - 1) / RG_NT, B);
  rglru_kernel<<<grid, RG_NT, 0, (cudaStream_t)stream>>>(log_a, gated, h0, y,
                                                        S, W);
  return (int)cudaGetLastError();
}
