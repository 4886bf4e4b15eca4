// Grouped expert FFN of the dropless MoE dispatch, Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_dispatch.py
// (`_kernel_gated` / `_kernel_plain`, launched by `_forward`'s
// pallas_call). The buffer buf (R, D) in the activation type T (f32, f16
// or bf16) holds the routed tokens sorted by expert, each expert's rows
// padded to whole blocks of `blk` rows, and block_eid (R / blk,) names
// the expert of every block. With the expert weights in their stored type
// W (f32 master weights on the model's path), it computes for every row r
// of a block owned by expert e, with the Pallas body's rounding points:
//
//   g, u = T(buf_r @ T(w_gate[e])), T(buf_r @ T(w_up[e]))   (f32 sums)
//   h    = T(act(g, u))                                     (act in f32)
//   out  = T(h @ T(w_down[e]))                              (f32 sum)
//
// where T(.) rounds to the activation type, the weights element by
// element as they are staged (no separate cast pass). act is swiglu
// (silu(g) * u), gelu (tanh form), relu2 or silu (no gate). The Pallas
// body takes the activation in T, one rounding per operation; here it is
// taken in f32 on the rounded g and u and rounded once, at most about one
// ulp of T apart. Padding rows are zero and computed like the others, as
// on the TPU: FFN(0) = 0 for all four activations, and they are never
// gathered back.
//
// What bounds it on an H100: at one Qwen3-MoE-30B-A3B layer on 2 048
// tokens (top-8 of 128 experts: 16 384 routed rows, 32 640 padded rows in
// 255 blocks of 128; D 2048, F 768, swiglu, bf16 activations, f32
// weights) a call must read the 2.42 GB of f32 expert weights and move
// about 0.33 GB of buffer, h and output, 0.82 ms at 3.35 TB/s, against
// 154.6 GFLOP for the routed rows, 0.16 ms at 989 TFLOP/s bf16: the
// weight bytes bound it.
//
// The TPU kernel loads the whole (E, D, F) stacks into VMEM; on Hopper
// they do not fit (2.4 GB), so the work is tiled like the stage kernel
// (stage_mlp_block.cu) and each block of threads offsets into its own
// expert's weights:
//   1. up_act: a (BM rows x 64 columns of F) tile of g and u per block of
//      threads over the (R, F) grid, K = D, the activation in the
//      epilogue, writes h (R, F) in T;
//   2. down: a (BM x 64 columns of D) tile of the down product, K = F,
//      writes out (R, D) in T.
// A row tile never straddles two expert blocks: BM is the largest of 64,
// 32 and 8 that divides blk (the wrapper refuses a blk that is not a
// multiple of 8), so every tile reads one expert id. Blocks of threads
// walk row tiles fastest, so the tiles that share a weight tile run
// together and hit it in L2: the weights cross HBM about once. The
// products run on the f32 FMA units (products of T values are exact in
// f32); bf16 mma/wgmma and TMA-fed weight tiles are later work.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kBN = 64;        // output columns per tile
constexpr int kBK = 16;        // reduction depth per shared-memory stage
constexpr int kThreads = 256;

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

// thread layout of a (BM x kBN) output tile: RT x CT threads, each
// owning TM rows (stride RT) and TN columns (stride CT)
template <int BM>
struct Layout {
  static constexpr int TM = BM >= 16 ? BM / 16 : 1;
  static constexpr int RT = BM / TM;
  static constexpr int CT = kThreads / RT;
  static constexpr int TN = kBN / CT;
  static constexpr int LdA = BM + 1;  // transposed A tile row stride
  static constexpr int EA = (BM * kBK + kThreads - 1) / kThreads;
  static constexpr int EB = kBK * kBN / kThreads;
  static_assert(RT * CT == kThreads && TN * CT == kBN, "tile layout");
};

// Register-staged tiles: a thread's share of the next (BM x kBK) A tile
// and (kBK x kBN) B tiles, loaded from global memory while the current
// stage is consumed.
template <typename T, typename W, int BM, int NB>
struct Stage {
  using Lo = Layout<BM>;
  float a[Lo::EA];
  float b[NB][Lo::EB];

  __device__ __forceinline__ void load(const T* __restrict__ A,
                                       const W* const* __restrict__ B, int M,
                                       int N, int K, int m0, int n0, int k0) {
#pragma unroll
    for (int e = 0; e < Lo::EA; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int r = idx / kBK, c = idx % kBK;
      const int m = m0 + r, k = k0 + c;
      a[e] = (idx < BM * kBK && m < M && k < K) ? to_f32(A[(size_t)m * K + k]) : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < Lo::EB; ++e) {
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
    for (int e = 0; e < Lo::EA; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      if (idx < BM * kBK) As[(idx % kBK) * Lo::LdA + idx / kBK] = a[e];
    }
#pragma unroll
    for (int e = 0; e < Lo::EB; ++e) {
      const int idx = threadIdx.x + e * kThreads;
#pragma unroll
      for (int q = 0; q < NB; ++q) Bs[q * kBK * kBN + idx] = b[q][e];
    }
  }
};

// acc[q] = A[m0:m0+BM, :] @ T(B_q)[:, n0:n0+kBN]; A (M, K) row-major in T,
// B_q (K, N) row-major in W, rounded to T as staged.
template <typename T, typename W, int BM, int NB>
__device__ __forceinline__ void gemm_tile(
    const T* __restrict__ A, const W* const* __restrict__ B, int M, int N,
    int K, int m0, int n0,
    float (&acc)[NB][Layout<BM>::TM][Layout<BM>::TN]) {
  using Lo = Layout<BM>;
  __shared__ float As[kBK * Lo::LdA];
  __shared__ float Bs[NB * kBK * kBN];
  const int tr = threadIdx.x / Lo::CT, tc = threadIdx.x % Lo::CT;
#pragma unroll
  for (int q = 0; q < NB; ++q)
#pragma unroll
    for (int i = 0; i < Lo::TM; ++i)
#pragma unroll
      for (int j = 0; j < Lo::TN; ++j) acc[q][i][j] = 0.0f;

  Stage<T, W, BM, NB> st;
  st.load(A, B, M, N, K, m0, n0, 0);
  st.store(As, Bs);
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) st.load(A, B, M, N, K, m0, n0, k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[Lo::TM], b[NB][Lo::TN];
#pragma unroll
      for (int i = 0; i < Lo::TM; ++i) a[i] = As[kk * Lo::LdA + tr + Lo::RT * i];
#pragma unroll
      for (int q = 0; q < NB; ++q)
#pragma unroll
        for (int j = 0; j < Lo::TN; ++j)
          b[q][j] = Bs[q * kBK * kBN + kk * kBN + tc + Lo::CT * j];
#pragma unroll
      for (int q = 0; q < NB; ++q)
#pragma unroll
        for (int i = 0; i < Lo::TM; ++i)
#pragma unroll
          for (int j = 0; j < Lo::TN; ++j) acc[q][i][j] = fmaf(a[i], b[q][j], acc[q][i][j]);
    }
    __syncthreads();
    if (more) {
      st.store(As, Bs);
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// 1. h = T(act(T(buf @ T(w_gate[e])), T(buf @ T(w_up[e]))))   (NB = 2)
//    h = T(act(T(buf @ T(w_up[e]))))                          (NB = 1)
// ---------------------------------------------------------------------------

template <typename T, typename W, int BM, int NB>
__global__ void __launch_bounds__(kThreads)
up_act(const T* __restrict__ buf, const int* __restrict__ block_eid,
       const W* __restrict__ w0, const W* __restrict__ w1, T* __restrict__ h,
       int rows, int blk, int d, int f, int act) {
  using Lo = Layout<BM>;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const size_t off = (size_t)block_eid[m0 / blk] * d * f;
  const W* B[2] = {w0 + off, NB == 2 ? w1 + off : w0 + off};
  float acc[NB][Lo::TM][Lo::TN];
  gemm_tile<T, W, BM, NB>(buf, B, rows, f, d, m0, n0, acc);
  const int tr = threadIdx.x / Lo::CT, tc = threadIdx.x % Lo::CT;
#pragma unroll
  for (int i = 0; i < Lo::TM; ++i) {
    const int m = m0 + tr + Lo::RT * i;
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < Lo::TN; ++j) {
      const int n = n0 + tc + Lo::CT * j;
      if (n >= f) continue;
      const float u = round_to<T>(acc[NB - 1][i][j]);
      const float g = NB == 2 ? round_to<T>(acc[0][i][j]) : 0.0f;
      h[(size_t)m * f + n] = from_f32<T>(activate(act, g, u));
    }
  }
}

// ---------------------------------------------------------------------------
// 2. out = T(h @ T(w_down[e]))
// ---------------------------------------------------------------------------

template <typename T, typename W, int BM>
__global__ void __launch_bounds__(kThreads)
down(const T* __restrict__ h, const int* __restrict__ block_eid,
     const W* __restrict__ wd, T* __restrict__ out, int rows, int blk, int d,
     int f) {
  using Lo = Layout<BM>;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const W* B[1] = {wd + (size_t)block_eid[m0 / blk] * f * d};
  float acc[1][Lo::TM][Lo::TN];
  gemm_tile<T, W, BM, 1>(h, B, rows, d, f, m0, n0, acc);
  const int tr = threadIdx.x / Lo::CT, tc = threadIdx.x % Lo::CT;
#pragma unroll
  for (int i = 0; i < Lo::TM; ++i) {
    const int m = m0 + tr + Lo::RT * i;
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < Lo::TN; ++j) {
      const int n = n0 + tc + Lo::CT * j;
      if (n < d) out[(size_t)m * d + n] = from_f32<T>(acc[0][i][j]);
    }
  }
}

template <typename T, typename W, int BM>
cudaError_t launch(int act, const void* buf, const int* eid, const void* wg,
                   const void* wu, const void* wd, void* h, void* out,
                   int rows, int blk, int d, int f, cudaStream_t s) {
  const T* bt = static_cast<const T*>(buf);
  T* ht = static_cast<T*>(h);
  const dim3 grid_up((rows + BM - 1) / BM, (f + kBN - 1) / kBN);
  if (act == kSwiglu)
    up_act<T, W, BM, 2><<<grid_up, kThreads, 0, s>>>(
        bt, eid, static_cast<const W*>(wg), static_cast<const W*>(wu), ht,
        rows, blk, d, f, act);
  else
    up_act<T, W, BM, 1><<<grid_up, kThreads, 0, s>>>(
        bt, eid, static_cast<const W*>(wu), nullptr, ht, rows, blk, d, f, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_down((rows + BM - 1) / BM, (d + kBN - 1) / kBN);
  down<T, W, BM><<<grid_down, kThreads, 0, s>>>(
      ht, eid, static_cast<const W*>(wd), static_cast<T*>(out), rows, blk, d, f);
  return cudaGetLastError();
}

template <typename T, int BM>
cudaError_t launch_w(int wdtype, int self_code, int act, const void* buf,
                     const int* eid, const void* wg, const void* wu,
                     const void* wd, void* h, void* out, int rows, int blk,
                     int d, int f, cudaStream_t s) {
  if (wdtype == 0)
    return launch<T, float, BM>(act, buf, eid, wg, wu, wd, h, out, rows, blk, d, f, s);
  if (wdtype == self_code)
    return launch<T, T, BM>(act, buf, eid, wg, wu, wd, h, out, rows, blk, d, f, s);
  return cudaErrorInvalidValue;
}

template <int BM>
cudaError_t launch_t(int dtype, int wdtype, int act, const void* buf,
                     const int* eid, const void* wg, const void* wu,
                     const void* wd, void* h, void* out, int rows, int blk,
                     int d, int f, cudaStream_t s) {
  switch (dtype) {
    case 0: return launch_w<float, BM>(wdtype, 0, act, buf, eid, wg, wu, wd, h, out, rows, blk, d, f, s);
    case 1: return launch_w<__half, BM>(wdtype, 1, act, buf, eid, wg, wu, wd, h, out, rows, blk, d, f, s);
    case 2: return launch_w<__nv_bfloat16, BM>(wdtype, 2, act, buf, eid, wg, wu, wd, h, out, rows, blk, d, f, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = f32, 1 = f16, 2 = bf16; the weights are f32 or of the
// activation type. act codes as enum Act. row_tile is 64, 32 or 8 and
// divides blk, which divides rows. block_eid (rows / blk,) int32 holds
// expert ids in [0, E). h (rows, f) is caller-allocated scratch in the
// activation type; w_gate is read only for swiglu. Returns the
// cudaGetLastError() after the launches.
extern "C" int grouped_moe_ffn_launch(int dtype, int wdtype, int act,
                                      int row_tile, const void* buf,
                                      const void* block_eid, const void* w_gate,
                                      const void* w_up, const void* w_down,
                                      void* h, void* out, int rows, int blk,
                                      int d, int f, void* stream) {
  if (rows <= 0 || d <= 0 || f <= 0 || blk <= 0 || rows % blk ||
      blk % row_tile || act < kSwiglu || act > kSilu)
    return (int)cudaErrorInvalidValue;
  const int* eid = static_cast<const int*>(block_eid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (row_tile) {
    case 64: return (int)launch_t<64>(dtype, wdtype, act, buf, eid, w_gate, w_up, w_down, h, out, rows, blk, d, f, s);
    case 32: return (int)launch_t<32>(dtype, wdtype, act, buf, eid, w_gate, w_up, w_down, h, out, rows, blk, d, f, s);
    case 8: return (int)launch_t<8>(dtype, wdtype, act, buf, eid, w_gate, w_up, w_down, h, out, rows, blk, d, f, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
