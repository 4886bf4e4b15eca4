// Fused history cross-attention for the CA actor (paper Eq. 24), Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ca_attention.py
// (`_kernel`, launched by `_ca_forward`'s pallas_call). It computes, per
// batch row b, only the current-state query row of the attention:
//
//   q      = obs[b] @ wq_s                           (C,)
//   K, V   = hist[b] @ wk, hist[b] @ wv              (I, C)
//   s_i    = <q, K_i> / sqrt(C), -FLT_MAX where mask[b, i] <= 0
//   w      = softmax(s)                              (max-subtracted)
//   out[b] = [obs[b], sum_i w_i V_i]  or  [obs[b], 0] if no valid entry
//
// All arithmetic is f32 (FMA accumulation), whatever the storage type
// (f32, f16 or bf16); the output is written in the storage type.
//
// K and V are never formed. The products reassociate:
//
//   <q, K_i>        = <hist_i, u>        with u    = wk q        (Dp,)
//   sum_i w_i V_i   = hbar @ wv          with hbar = sum_i w_i hist_i
//
// so a row costs Do*C + 2*Dp*C + 2*I*Dp multiply-adds instead of
// Do*C + 2*I*Dp*C, and its longest dependent chain is max(Do, C, Dp)
// instead of I*Dp.
//
// What bounds it on an H100: at the SAC update shape (B = 128, obs_dim 28,
// pair_dim 52, I = 4, C = 64, f32) one call must move 203 776 B, 0.061 us
// at 3.35 TB/s; its least work, 1.52 MFLOP of f32 multiply-adds, is
// 0.023 us at the card's 67 TFLOP/s f32 (non-tensor-core) rate. The bytes
// bound it, and both are far below a kernel launch, so the call is
// latency-bound. The design cuts latency, not work: one warp per batch
// row, four rows per CTA; the three projection matrices staged once per
// CTA in shared memory as f32 with many loads in flight per thread (the
// staging is a few round trips to L2, not one per element); the row's
// obs and history staged per warp; the reassociated products above, each
// a short chain over shared memory; scores reduced with warp shuffles.
// wk is staged with an odd row stride so the lane-per-pair-feature reads
// of u = wk q hit 32 different banks. Hiding the launch (CUDA graphs,
// fusion into the actor trunk) is left to later work.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <float.h>

namespace {

constexpr int kWarpsPerBlock = 4;   // batch rows per CTA
constexpr int kMaxHist = 8;         // largest supported history length I
constexpr int kMaxChanPerLane = 4;  // C <= 32 * 4 = 128
constexpr int kMaxPairPerLane = 4;  // pair_dim <= 32 * 4 = 128
constexpr int kLoadsInFlight = 16;  // staging loads issued before any store

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Row stride of the staged wk: odd, so 32 lanes reading one column of 32
// different rows hit 32 different banks.
__host__ __device__ __forceinline__ int wk_stride(int C) { return C | 1; }

// Copy a row-major (rows, cols) matrix into f32 shared memory with row
// stride ld. Each of the `nthreads` threads issues kLoadsInFlight global
// loads before it stores any of them.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int rows, int cols, int ld, int tid,
                                      int nthreads) {
  const int n = rows * cols;
  for (int base = tid; base < n; base += kLoadsInFlight * nthreads) {
    float r[kLoadsInFlight];
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int j = base + u * nthreads;
      r[u] = j < n ? to_f32(src[j]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int j = base + u * nthreads;
      if (j < n) dst[(j / cols) * ld + j % cols] = r[u];
    }
  }
}

// Shared memory layout (f32): wq_s (Do*C) | wk (Dp*wk_stride(C)) |
// wv (Dp*C) | per warp: obs row (Do), history rows (I*Dp), q (C), hbar (Dp).
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ca_attention_kernel(const T* __restrict__ obs, const T* __restrict__ hist,
                    const T* __restrict__ mask, const T* __restrict__ wq_s,
                    const T* __restrict__ wk, const T* __restrict__ wv,
                    T* __restrict__ out, int B, int Do, int Dp, int I, int C,
                    float scale) {
  extern __shared__ float smem[];
  const int ldk = wk_stride(C);
  float* s_wq = smem;
  float* s_wk = s_wq + Do * C;
  float* s_wv = s_wk + Dp * ldk;
  float* s_row_base = s_wv + Dp * C;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  stage(s_wq, wq_s, Do, C, C, tid, blockDim.x);
  stage(s_wk, wk, Dp, C, ldk, tid, blockDim.x);
  stage(s_wv, wv, Dp, C, C, tid, blockDim.x);
  __syncthreads();

  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // ragged last tile: the row guard replaces padding

  float* s_obs = s_row_base + warp * (Do + I * Dp + C + Dp);
  float* s_hist = s_obs + Do;
  float* s_q = s_hist + I * Dp;
  float* s_hbar = s_q + C;
  const T* obs_b = obs + (size_t)b * Do;
  T* out_b = out + (size_t)b * (Do + C);
  for (int j = lane; j < Do; j += 32) {
    const T x = obs_b[j];
    s_obs[j] = to_f32(x);
    out_b[j] = x;  // the observation half of [obs, s']
  }
  stage(s_hist, hist + (size_t)b * I * Dp, 1, I * Dp, I * Dp, lane, 32);

  bool valid[kMaxHist];
  bool any_valid = false;
#pragma unroll
  for (int i = 0; i < kMaxHist; ++i) {
    valid[i] = i < I && to_f32(mask[(size_t)b * I + i]) > 0.0f;
    any_valid |= valid[i];
  }
  __syncwarp();

  float acc[kMaxChanPerLane];
#pragma unroll
  for (int t = 0; t < kMaxChanPerLane; ++t) acc[t] = 0.0f;

  // any_valid is the same on every lane: the branch is warp-uniform
  if (any_valid) {
    // q = (obs @ wq_s) / sqrt(C); lane owns channels lane, lane+32, ...
    float q[kMaxChanPerLane];
#pragma unroll
    for (int t = 0; t < kMaxChanPerLane; ++t) q[t] = 0.0f;
    for (int d = 0; d < Do; ++d) {
      const float x = s_obs[d];
#pragma unroll
      for (int t = 0; t < kMaxChanPerLane; ++t) {
        const int c = lane + 32 * t;
        if (c < C) q[t] = fmaf(x, s_wq[d * C + c], q[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kMaxChanPerLane; ++t) {
      const int c = lane + 32 * t;
      if (c < C) s_q[c] = q[t] * scale;
    }
    __syncwarp();

    // u = wk q; lane owns pair features lane, lane+32, ...
    float u[kMaxPairPerLane];
#pragma unroll
    for (int r = 0; r < kMaxPairPerLane; ++r) u[r] = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float x = s_q[c];
#pragma unroll
      for (int r = 0; r < kMaxPairPerLane; ++r) {
        const int p = lane + 32 * r;
        if (p < Dp) u[r] = fmaf(x, s_wk[p * ldk + c], u[r]);
      }
    }

    // scores s_i = <hist_i, u>: lane partials, then one warp sum per i
    float s[kMaxHist];
    float mx = -FLT_MAX;
#pragma unroll
    for (int i = 0; i < kMaxHist; ++i) {
      float part = 0.0f;
      if (i < I) {
#pragma unroll
        for (int r = 0; r < kMaxPairPerLane; ++r) {
          const int p = lane + 32 * r;
          if (p < Dp) part = fmaf(s_hist[i * Dp + p], u[r], part);
        }
      }
      s[i] = part;
    }
#pragma unroll
    for (int i = 0; i < kMaxHist; ++i) {
      if (i < I) {
        const float dot = warp_sum(s[i]);
        s[i] = valid[i] ? dot : -FLT_MAX;
        mx = fmaxf(mx, s[i]);
      }
    }

    float denom = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxHist; ++i) {
      if (i < I) {
        s[i] = expf(s[i] - mx);
        denom += s[i];
      }
    }
    const float inv = 1.0f / denom;

    // hbar = sum_i w_i hist_i, lane owns pair features
#pragma unroll
    for (int r = 0; r < kMaxPairPerLane; ++r) {
      const int p = lane + 32 * r;
      if (p < Dp) {
        float h = 0.0f;
#pragma unroll
        for (int i = 0; i < kMaxHist; ++i)
          if (i < I) h = fmaf(s[i] * inv, s_hist[i * Dp + p], h);
        s_hbar[p] = h;
      }
    }
    __syncwarp();

    // s' = hbar @ wv, lane owns channels
    for (int p = 0; p < Dp; ++p) {
      const float x = s_hbar[p];
#pragma unroll
      for (int t = 0; t < kMaxChanPerLane; ++t) {
        const int c = lane + 32 * t;
        if (c < C) acc[t] = fmaf(x, s_wv[p * C + c], acc[t]);
      }
    }
  }

#pragma unroll
  for (int t = 0; t < kMaxChanPerLane; ++t) {
    const int c = lane + 32 * t;
    if (c < C) out_b[Do + c] = from_f32<T>(acc[t]);
  }
}

template <typename T>
cudaError_t launch(const void* obs, const void* hist, const void* mask,
                   const void* wq_s, const void* wk, const void* wv, void* out,
                   int B, int Do, int Dp, int I, int C, float scale,
                   size_t smem_bytes, cudaStream_t stream) {
  const int grid = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ca_attention_kernel<T><<<grid, kWarpsPerBlock * 32, smem_bytes, stream>>>(
      static_cast<const T*>(obs), static_cast<const T*>(hist),
      static_cast<const T*>(mask), static_cast<const T*>(wq_s),
      static_cast<const T*>(wk), static_cast<const T*>(wv),
      static_cast<T*>(out), B, Do, Dp, I, C, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int ca_attention_max_hist() { return kMaxHist; }
int ca_attention_max_channels() { return 32 * kMaxChanPerLane; }
int ca_attention_max_pair() { return 32 * kMaxPairPerLane; }

// Dynamic shared memory one launch needs, in bytes.
size_t ca_attention_smem_bytes(int Do, int Dp, int I, int C) {
  return sizeof(float) *
         ((size_t)Do * C + (size_t)Dp * wk_stride(C) + (size_t)Dp * C +
          (size_t)kWarpsPerBlock * (Do + (size_t)I * Dp + C + Dp));
}

// dtype: 0 = f32, 1 = f16, 2 = bf16. All tensors contiguous, row-major:
// obs (B, Do), hist (B, I, Dp), mask (B, I), wq_s (Do, C), wk/wv (Dp, C),
// out (B, Do + C). Returns the cudaError_t of the launch (0 = success).
int ca_attention_launch(int dtype, const void* obs, const void* hist,
                        const void* mask, const void* wq_s, const void* wk,
                        const void* wv, void* out, int B, int Do, int Dp, int I,
                        int C, float scale, void* stream) {
  if (B <= 0 || Do <= 0 || Dp <= 0 || Dp > 32 * kMaxPairPerLane || I <= 0 ||
      I > kMaxHist || C <= 0 || C > 32 * kMaxChanPerLane)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ca_attention_smem_bytes(Do, Dp, I, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(obs, hist, mask, wq_s, wk, wv, out, B, Do, Dp, I, C, scale, smem, s);
    case 1: return (int)launch<__half>(obs, hist, mask, wq_s, wk, wv, out, B, Do, Dp, I, C, scale, smem, s);
    case 2: return (int)launch<__nv_bfloat16>(obs, hist, mask, wq_s, wk, wv, out, B, Do, Dp, I, C, scale, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
