// Fused residual MLP half-block of the split executor, Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/stage_block.py
// (`_kernel_gated` / `_kernel_plain`, launched by `_forward`'s
// pallas_call). With x (R, D) rows in the activation type T (f32, f16 or
// bf16) and the weights in their stored type W (f32 master weights on the
// split executor's path), it computes, with the Pallas body's rounding
// points:
//
//   h      = T(T(x32 * rsqrt(mean(x32^2) + eps)) * T(norm_w))
//   g, u   = h @ T(w_gate), h @ T(w_up)          (f32 accumulation)
//   hc     = T(act(g, u))                          (act in f32)
//   out    = T(x32 + hc @ T(w_down))               (f32 accumulation)
//
// where T(.) rounds to the activation type, element by element, as the
// weights are read (no separate cast pass over them). act is swiglu
// (silu(g) * u), gelu (tanh form), relu2 or silu.
//
// What bounds it on an H100: at the split executor's shape (R = 512 rows
// of a 2x256-token microbatch, D = 2048, F = 11008, swiglu, bf16
// activations, f32 weights) one call must read 270.5 MB of f32 weights,
// 0.081 ms at 3.35 TB/s, and do 69.3 GFLOP of bf16-operand products,
// 0.070 ms at 989 TFLOP/s: the weight bytes bound it.
//
// The TPU kernel keeps the whole (D, F) weights in VMEM; on Hopper they
// do not fit in a block's 227 KB, so the work is tiled over F and the
// row tile's (rows, D) down-product accumulator is not kept on chip.
// This first version is three simple launches on one stream:
//   1. rms_norm_rows: one block per row, f32 statistics, writes h (R, D)
//      in T (R*D*sizeof(T) bytes, 2 MB at the shape above);
//   2. up_act: a 64x64 output tile of g and u per block over the (R, F)
//      grid, K = D, f32 FMA on operands rounded to T, the activation in
//      the epilogue, writes hc (R, F) in T (11 MB);
//   3. down_residual: a 64x64 tile of (R, D), K = F, adds x32 in the
//      epilogue and writes out in T.
// Blocks walk row tiles fastest so the blocks that share a weight tile
// run together and hit it in L2; weights cross HBM about once. hc and h
// cost ~26 MB of extra traffic (10% of the weights). The products run on
// the f32 FMA units (bf16 products are exact in f32), not the tensor
// cores: simple and right first; wgmma/TMA tiles are later work.
// Ragged R, D and F take guards, not padding.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kBM = 64;        // rows per tile
constexpr int kBN = 64;        // output columns per tile
constexpr int kBK = 16;        // reduction depth per smem stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLdA = kBM + 1;  // transposed A tile row stride (odd)

enum Act { kSwiglu = 0, kGelu = 1, kRelu2 = 2, kSilu = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// round an f32 value to T and back (the identity for T = float)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float silu(float x) { return x * (1.0f / (1.0f + expf(-x))); }

__device__ __forceinline__ float activate(int act, float g, float u) {
  switch (act) {
    case kSwiglu: return silu(g) * u;
    case kGelu: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return u * (0.5f * (1.0f + tanhf(c * (u + 0.044715f * (u * u * u)))));
    }
    case kRelu2: { const float r = fmaxf(u, 0.0f); return r * r; }
    default: return silu(u);
  }
}

// ---------------------------------------------------------------------------
// 1. h = T(T(x32 * rsqrt(mean(x32^2) + eps)) * T(norm_w)), one block per row
// ---------------------------------------------------------------------------

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rms_norm_rows(const T* __restrict__ x, const W* __restrict__ nw,
              T* __restrict__ h, int d, float eps) {
  __shared__ float part[kThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  float ss = 0.0f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float tot = 0.0f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) tot += part[w];
  const float r = 1.0f / sqrtf(tot / (float)d + eps);
  T* hr = h + row * d;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float xn = round_to<T>(to_f32(xr[i]) * r);
    hr[i] = from_f32<T>(xn * round_to<T>(to_f32(nw[i])));
  }
}

// ---------------------------------------------------------------------------
// tiled product: acc[q] += A[m0:m0+64, :] @ T(B_q)[:, n0:n0+64]
// A (M, K) row-major in T; B_q (K, N) row-major in W, rounded to T as
// staged. Global loads for the next K stage are issued before the current
// stage is consumed (register double buffering).
// ---------------------------------------------------------------------------

template <typename T, typename W, int NB>
struct Tile {
  float a[kBM * kBK / kThreads];
  float b[NB][kBK * kBN / kThreads];

  __device__ __forceinline__ void load(const T* __restrict__ A,
                                       const W* const* __restrict__ B,
                                       int M, int N, int K, int m0, int n0,
                                       int k0) {
#pragma unroll
    for (int e = 0; e < kBM * kBK / kThreads; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int r = idx / kBK, c = idx % kBK;
      const int m = m0 + r, k = k0 + c;
      a[e] = (m < M && k < K) ? to_f32(A[(size_t)m * K + k]) : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kBK * kBN / kThreads; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int r = idx / kBN, c = idx % kBN;
      const int k = k0 + r, n = n0 + c;
      const bool ok = k < K && n < N;
#pragma unroll
      for (int q = 0; q < NB; ++q)
        b[q][e] = ok ? round_to<T>(to_f32(B[q][(size_t)k * N + n])) : 0.0f;
    }
  }

  __device__ __forceinline__ void store(float* As, float* Bs) const {
#pragma unroll
    for (int e = 0; e < kBM * kBK / kThreads; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      As[(idx % kBK) * kLdA + idx / kBK] = a[e];
    }
#pragma unroll
    for (int e = 0; e < kBK * kBN / kThreads; ++e) {
      const int idx = threadIdx.x + e * kThreads;
#pragma unroll
      for (int q = 0; q < NB; ++q) Bs[q * kBK * kBN + idx] = b[q][e];
    }
  }
};

template <typename T, typename W, int NB>
__device__ __forceinline__ void gemm_tile(const T* __restrict__ A,
                                          const W* const* __restrict__ B,
                                          int M, int N, int K, int m0, int n0,
                                          float (&acc)[NB][4][4]) {
  __shared__ float As[kBK * kLdA];
  __shared__ float Bs[NB * kBK * kBN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int q = 0; q < NB; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q][i][j] = 0.0f;

  Tile<T, W, NB> t;
  t.load(A, B, M, N, K, m0, n0, 0);
  t.store(As, Bs);
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) t.load(A, B, M, N, K, m0, n0, k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[NB][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk * kLdA + ty + 16 * i];
#pragma unroll
      for (int q = 0; q < NB; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j) b[q][j] = Bs[q * kBK * kBN + kk * kBN + tx + 16 * j];
#pragma unroll
      for (int q = 0; q < NB; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[q][i][j] = fmaf(a[i], b[q][j], acc[q][i][j]);
    }
    __syncthreads();
    if (more) {
      t.store(As, Bs);
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// 2. hc = T(act(h @ T(w_gate), h @ T(w_up)))        (NB = 2: gated)
//    hc = T(act(h @ T(w_up)))                        (NB = 1)
// ---------------------------------------------------------------------------

template <typename T, typename W, int NB>
__global__ void __launch_bounds__(kThreads)
up_act(const T* __restrict__ h, const W* __restrict__ w0,
       const W* __restrict__ w1, T* __restrict__ hc, int rows, int d, int f,
       int act) {
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const W* B[2] = {w0, w1};
  float acc[NB][4][4];
  gemm_tile<T, W, NB>(h, B, rows, f, d, m0, n0, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= f) continue;
      const float y = NB == 2 ? activate(act, acc[0][i][j], acc[NB - 1][i][j])
                              : activate(act, 0.0f, acc[0][i][j]);
      hc[(size_t)m * f + n] = from_f32<T>(y);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. out = T(x32 + hc @ T(w_down))
// ---------------------------------------------------------------------------

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
down_residual(const T* __restrict__ hc, const W* __restrict__ wd,
              const T* __restrict__ x, T* __restrict__ out, int rows, int d,
              int f) {
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const W* B[1] = {wd};
  float acc[1][4][4];
  gemm_tile<T, W, 1>(hc, B, rows, d, f, m0, n0, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= d) continue;
      const size_t o = (size_t)m * d + n;
      out[o] = from_f32<T>(to_f32(x[o]) + acc[0][i][j]);
    }
  }
}

template <typename T, typename W>
cudaError_t launch(int act, const void* x, const void* nw, const void* wg,
                   const void* wu, const void* wd, void* h, void* hc, void* out,
                   int rows, int d, int f, float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ht = static_cast<T*>(h);
  T* hct = static_cast<T*>(hc);
  rms_norm_rows<T, W><<<rows, kThreads, 0, stream>>>(
      xt, static_cast<const W*>(nw), ht, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_up((rows + kBM - 1) / kBM, (f + kBN - 1) / kBN);
  if (act == kSwiglu)
    up_act<T, W, 2><<<grid_up, kThreads, 0, stream>>>(
        ht, static_cast<const W*>(wg), static_cast<const W*>(wu), hct, rows, d, f, act);
  else
    up_act<T, W, 1><<<grid_up, kThreads, 0, stream>>>(
        ht, static_cast<const W*>(wu), nullptr, hct, rows, d, f, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_down((rows + kBM - 1) / kBM, (d + kBN - 1) / kBN);
  down_residual<T, W><<<grid_down, kThreads, 0, stream>>>(
      hct, static_cast<const W*>(wd), xt, static_cast<T*>(out), rows, d, f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_w(int wdtype, int act, const void* x, const void* nw,
                     const void* wg, const void* wu, const void* wd, void* h,
                     void* hc, void* out, int rows, int d, int f, float eps,
                     cudaStream_t s) {
  switch (wdtype) {
    case 0: return launch<T, float>(act, x, nw, wg, wu, wd, h, hc, out, rows, d, f, eps, s);
    case 1: return launch<T, __half>(act, x, nw, wg, wu, wd, h, hc, out, rows, d, f, eps, s);
    case 2: return launch<T, __nv_bfloat16>(act, x, nw, wg, wu, wd, h, hc, out, rows, d, f, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = f32, 1 = f16, 2 = bf16; act codes as enum Act. h
// (rows, d) and hc (rows, f) are caller-allocated scratch in the
// activation type. w_gate is read only for swiglu. Returns the
// cudaGetLastError() after the launches.
extern "C" int stage_mlp_block_launch(int dtype, int wdtype, int act,
                                      const void* x, const void* norm_w,
                                      const void* w_gate, const void* w_up,
                                      const void* w_down, void* h, void* hc,
                                      void* out, int rows, int d, int f,
                                      float eps, void* stream) {
  if (rows <= 0 || d <= 0 || f <= 0 || act < kSwiglu || act > kSilu)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_w<float>(wdtype, act, x, norm_w, w_gate, w_up, w_down, h, hc, out, rows, d, f, eps, s);
    case 1: return (int)launch_w<__half>(wdtype, act, x, norm_w, w_gate, w_up, w_down, h, hc, out, rows, d, f, eps, s);
    case 2: return (int)launch_w<__nv_bfloat16>(wdtype, act, x, norm_w, w_gate, w_up, w_down, h, hc, out, rows, d, f, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
