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
// Two bodies; the activation dtype picks one (a fixed route, not a
// fallback). Both start with rms_norm_rows, one block per row, f32
// statistics, writing h (R, D) in T (2 MB at the shape above).
//
// * f16 / bf16 activations: the tensor-core body, namespace tc. Two
//   warp-specialised wgmma GEMMs, each CTA two consumer warpgroups of
//   2 x 64 rows (256 rows a CTA) and one producer warp that keeps TMA
//   loads in flight through a ring of stages (mbarriers `full` on the TMA
//   bytes, `empty` on the consumer warps' release):
//   1. up + activation, h (R, D) x [w_gate | w_up] (D, F): one m64n128k16
//      per 64 rows and k16 step covers 64 gate and 64 up columns (B's two
//      64-column chunks), so A is read once for both. The activation runs
//      in f32 on the accumulators and hc (R, F) is rounded to T once.
//      Blocks walk row tiles fastest, so the two row tiles that share a
//      weight tile run together and the weights cross HBM about once.
//   2. down, hc (R, F) x w_down (F, D): 128-column tiles with F split into
//      contiguous runs of 64-deep k-tiles (kernels/stage_block.py
//      split_k_plan: at the shape above only 32 output tiles exist, so F
//      is split 8 ways, 256 CTAs); each split writes its f32 partial sum
//      to scratch, and split_k_sum adds the splits in a fixed order, adds
//      x32 and rounds once. No atomics: the result does not vary from run
//      to run.
//   A tiles come by TMA with the 128-byte swizzle (K-major). Weights come
//   in their stored type W: when W is T, TMA writes the swizzled MN-major
//   B tile directly; otherwise (f32 master weights) TMA stages the raw
//   tile and both consumer warpgroups convert it to T into the swizzled B
//   tile, each stage's conversion overlapping the previous stage's wgmma,
//   so every weight element is read from HBM once and rounded once. The
//   rounding points are the plain version's; only the order of the f32
//   sums differs. Ragged R, D and F: TMA fills out-of-range rows and
//   columns with zeros and the epilogues store in-range elements only.
//   TMA needs 16-byte aligned bases and row strides (D and F multiples of
//   8 for 16-bit, of 4 for f32 weights); the wrapper checks them.
// * f32 activations: the f32 FMA body (TF32 would not meet the f32 gate of
//   1e-4), three launches on one stream:
//   1. rms_norm_rows as above;
//   2. up_act: a 64x64 output tile of g and u per block over the (R, F)
//      grid, K = D, f32 FMA on operands rounded to T, the activation in
//      the epilogue, writes hc (R, F) in T;
//   3. down_residual: a 64x64 tile of (R, D), K = F, adds x32 in the
//      epilogue and writes out in T.
//   Blocks walk row tiles fastest so the blocks that share a weight tile
//   run together and hit it in L2. Ragged R, D and F take guards.
#include <math.h>

#include <type_traits>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// tensor-core body (f16 / bf16 activations): TMA-fed, warp-specialised
// wgmma GEMMs. The tile sizes here and kernels/stage_block.py's
// TC_TILE / split_k_plan must agree.
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kMB = 2;                     // m64 row blocks per warpgroup
constexpr int kBM = 2 * kMB * 64;          // rows per CTA (two warpgroups)
constexpr int kBN = 128;                   // B tile columns = wgmma N
constexpr int kBK = 64;                    // reduction depth per stage
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kRow = 128;                  // bytes of a swizzled 64-wide T row

enum Mode { kUpGated = 0, kUpPlain = 1, kDown = 2 };

// Shared memory: a ring of kStages stages, each the A tile and the weight
// tile as TMA brings it (the swizzled B tile itself when W is T, else the
// raw W tile in 128-byte swizzled boxes), then, when W is not T, two
// converted B tiles (the one wgmma reads, the one being converted).
template <typename T, typename W> struct Cfg {
  static constexpr bool kConvert = !std::is_same<T, W>::value;
  static constexpr int kABytes = kBM * kBK * 2;          // (kBM, kBK) in T
  static constexpr int kBBytes = kBK * kBN * 2;          // (kBK, kBN) in T, 2 chunks
  static constexpr int kWCols = 128 / (int)sizeof(W);    // columns of a staging box
  static constexpr int kWBoxes = kBN / kWCols;
  static constexpr int kWBytes = kConvert ? kBK * kBN * (int)sizeof(W) : kBBytes;
  static constexpr int kStageBytes = kABytes + kWBytes;
  static constexpr int kBBufs = kConvert ? 2 : 0;
  // as many stages (at most 4) as the 227 KB a block may have allow
  static constexpr int kBudget = 232448 - 1024 - 256 - kBBufs * kBBytes;
  static constexpr int kStages = kBudget / kStageBytes < 4 ? kBudget / kStageBytes : 4;
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * kStageBytes + (size_t)kBBufs * kBBytes + 16 * kStages;
};

// One CTA computes a (kBM rows) x (kBN columns of B) product over its
// k-tiles [kt0, kt1): A (rows, K) in T, K-major; B = the weights (K, N)
// as stored, MN-major. Modes:
//   kUpGated: B = [w_gate | w_up] columns n0 .. n0 + 63 of each;
//             hc[:, n0 .. n0 + 63] = T(act(gate, up))
//   kUpPlain: B = w_up columns n0 .. n0 + 127; hc = T(act(up))
//   kDown:    B = w_down columns n0 .. n0 + 127; part[z] = the f32 sum of
//             split z's k-tiles (no atomics: a later pass sums the splits)
template <typename T, typename W, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
gemm_tc(const __grid_constant__ CUtensorMap amap,
        const __grid_constant__ CUtensorMap w0map,
        const __grid_constant__ CUtensorMap w1map, T* __restrict__ hc,
        float* __restrict__ part, int rows, int n_out, int k_tiles,
        int tiles_per_split, int act) {
  using C = Cfg<T, W>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);  // per stage: A | W (or B)
  uint8_t* bconv = base + C::kStages * C::kStageBytes;  // converted B tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(bconv + C::kBBufs * C::kBBytes);
  uint64_t* empty = full + C::kStages;

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * (MODE == kUpGated ? kBN / 2 : kBN);
  const int kt0 = blockIdx.z * tiles_per_split;
  const int n_k = min(k_tiles, kt0 + tiles_per_split) - kt0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumers / 32) {
    // producer warp: one lane issues every load
    if (lane == 0) {
      prefetch_map(&amap);
      prefetch_map(&w0map);
      if (MODE == kUpGated) prefetch_map(&w1map);
      for (int i = 0; i < n_k; ++i) {
        const int s = i % C::kStages;
        uint8_t* st = base + s * C::kStageBytes;
        mbar_wait(&empty[s], ((i / C::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], C::kStageBytes);
        const int k = (kt0 + i) * kBK;
        tma_load_2d(st, &amap, &full[s], k, m0);
        // the weights in their stored type, 128-byte swizzled boxes (when W
        // is T, box q is column chunk q of the B tile itself)
        for (int q = 0; q < C::kWBoxes; ++q) {
          const int half = C::kWBoxes / 2;
          const bool second = MODE == kUpGated && q >= half;
          const int col = MODE == kUpGated ? n0 + (q % half) * C::kWCols
                                           : n0 + q * C::kWCols;
          tma_load_2d(st + C::kABytes + q * kBK * 128, second ? &w1map : &w0map,
                      &full[s], col, k);
        }
      }
    }
    return;
  }

  const int t = threadIdx.x;    // 0 .. 255
  const int g = warp / 4;       // consumer warpgroup
  float acc[kMB][kBN / 2];
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j) acc[mb][j] = 0.0f;

  // the raw W tile of k-tile i -> converted B tile i % 2, by both
  // consumer warpgroups
  auto convert = [&](int i) {
    convert_b_tile<T, W, kBK, kBN, kConsumers>(
        base + (i % C::kStages) * C::kStageBytes + C::kABytes,
        bconv + (i % 2) * C::kBBytes, t);
  };

  if (C::kConvert && n_k > 0) {
    mbar_wait(&full[0], 0);
    convert(0);
    named_sync(1, kConsumers);
  }
  for (int i = 0; i < n_k; ++i) {
    const int s = i % C::kStages;
    uint8_t* st = base + s * C::kStageBytes;
    const uint8_t* btile = C::kConvert ? bconv + (i % 2) * C::kBBytes : st + C::kABytes;
    if (!C::kConvert) mbar_wait(&full[s], (i / C::kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = make_desc(st + (g * kMB + mb) * 64 * kRow + kk * 32, 16,
                                      8 * kRow, 128);
        const uint64_t db = make_desc(btile + kk * 16 * kRow, kBK * kRow, 8 * kRow, 128);
        Wgmma<T, kBN>::template ss<1>(acc[mb], da, db, 1);
      }
    }
    wgmma_commit();
    // convert the next k-tile's weights while the tensor cores run
    if (C::kConvert && i + 1 < n_k) {
      mbar_wait(&full[(i + 1) % C::kStages], ((i + 1) / C::kStages) & 1);
      convert(i + 1);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) fence_regs<kBN / 2>(acc[mb]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    // both warpgroups' halves of the next B tile are written, and both
    // are done reading this one
    if (C::kConvert) named_sync(1, kConsumers);
  }

  const int t4 = lane % 4;
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb) {
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int row = m0 + (g * kMB + mb) * 64 + 16 * (warp % 4) + lane / 4 + 8 * i2;
      if (row >= rows) continue;
      if (MODE == kUpGated) {
#pragma unroll
        for (int c = 0; c < kBN / 16; ++c) {
          const int col = n0 + 8 * c + 2 * t4;
          if (col >= n_out) continue;
          const int gi = 4 * c + 2 * i2, ui = gi + 4 * (kBN / 16);
          *reinterpret_cast<uint32_t*>(hc + (size_t)row * n_out + col) =
              pack<T>(activate(act, acc[mb][gi], acc[mb][ui]),
                      activate(act, acc[mb][gi + 1], acc[mb][ui + 1]));
        }
      } else if (MODE == kUpPlain) {
#pragma unroll
        for (int c = 0; c < kBN / 8; ++c) {
          const int col = n0 + 8 * c + 2 * t4;
          if (col >= n_out) continue;
          const int ui = 4 * c + 2 * i2;
          *reinterpret_cast<uint32_t*>(hc + (size_t)row * n_out + col) =
              pack<T>(activate(act, 0.0f, acc[mb][ui]),
                      activate(act, 0.0f, acc[mb][ui + 1]));
        }
      } else {
        float* dst = part + ((size_t)blockIdx.z * rows + row) * n_out;
#pragma unroll
        for (int c = 0; c < kBN / 8; ++c) {
          const int col = n0 + 8 * c + 2 * t4;
          if (col >= n_out) continue;
          *reinterpret_cast<float2*>(dst + col) =
              make_float2(acc[mb][4 * c + 2 * i2], acc[mb][4 * c + 2 * i2 + 1]);
        }
      }
    }
  }
}

// out = T(x32 + sum over the splits of part), the splits summed in order
template <typename T>
__global__ void __launch_bounds__(256)
split_k_sum(const float* __restrict__ part, const T* __restrict__ x,
            T* __restrict__ out, int splits, size_t n) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  float4 y = *reinterpret_cast<const float4*>(part + i);
  for (int z = 1; z < splits; ++z) {
    const float4 p = *reinterpret_cast<const float4*>(part + z * n + i);
    y.x += p.x; y.y += p.y; y.z += p.z; y.w += p.w;
  }
  out[i] = from_f32<T>(to_f32(x[i]) + y.x);
  out[i + 1] = from_f32<T>(to_f32(x[i + 1]) + y.y);
  out[i + 2] = from_f32<T>(to_f32(x[i + 2]) + y.z);
  out[i + 3] = from_f32<T>(to_f32(x[i + 3]) + y.w);
}

template <typename T, typename W, int MODE>
cudaError_t gemm(const CUtensorMap& a, const CUtensorMap& w0,
                 const CUtensorMap& w1, T* hc, float* part, int rows, int n_out,
                 int k_tiles, int splits, int tiles_per_split, int act,
                 cudaStream_t stream) {
  using C = Cfg<T, W>;
  // opt in to more than 48 KB of dynamic shared memory once per
  // instantiation, outside any stream capture that follows
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm_tc<T, W, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)C::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int bn = MODE == kUpGated ? kBN / 2 : kBN;
  const dim3 grid((rows + kBM - 1) / kBM, (n_out + bn - 1) / bn, splits);
  gemm_tc<T, W, MODE><<<grid, kThreads, C::kSmem, stream>>>(
      a, w0, w1, hc, part, rows, n_out, k_tiles, tiles_per_split, act);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch(int act, const void* x, const void* nw, const void* wg,
                   const void* wu, const void* wd, void* h, void* hc,
                   void* part, void* out, int rows, int d, int f, float eps,
                   int splits, int tiles_per_split, cudaStream_t stream) {
  const int k_down = (f + kBK - 1) / kBK;
  if (splits < 1 || tiles_per_split < 1 || (splits - 1) * tiles_per_split >= k_down
      || splits * tiles_per_split < k_down)
    return cudaErrorInvalidValue;
  // A tiles (kBM rows x kBK) and weight boxes (kBK rows x 128 bytes)
  const bool gated = act == kSwiglu;
  CUtensorMap hmap, hcmap, gmap, umap, dmap;
  if (!matrix_map<T>(&hmap, h, rows, d, kBM) || !matrix_map<T>(&hcmap, hc, rows, f, kBM)
      || !matrix_map<W>(&umap, wu, d, f, kBK)
      || (gated && !matrix_map<W>(&gmap, wg, d, f, kBK))
      || !matrix_map<W>(&dmap, wd, f, d, kBK))
    return cudaErrorInvalidValue;

  const T* xt = static_cast<const T*>(x);
  T* hct = static_cast<T*>(hc);
  rms_norm_rows<T, W><<<rows, ::kThreads, 0, stream>>>(
      xt, static_cast<const W*>(nw), static_cast<T*>(h), d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int k_up = (d + kBK - 1) / kBK;
  err = gated ? gemm<T, W, kUpGated>(hmap, gmap, umap, hct, nullptr, rows, f,
                                     k_up, 1, k_up, act, stream)
              : gemm<T, W, kUpPlain>(hmap, umap, umap, hct, nullptr, rows, f,
                                     k_up, 1, k_up, act, stream);
  if (err != cudaSuccess) return err;
  float* pt = static_cast<float*>(part);
  err = gemm<T, W, kDown>(hcmap, dmap, dmap, nullptr, pt, rows, d, k_down,
                          splits, tiles_per_split, act, stream);
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)rows * d;
  split_k_sum<T><<<(unsigned)((n / 4 + 255) / 256), 256, 0, stream>>>(
      pt, xt, static_cast<T*>(out), splits, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_w(int wdtype, int act, const void* x, const void* nw,
                     const void* wg, const void* wu, const void* wd, void* h,
                     void* hc, void* part, void* out, int rows, int d, int f,
                     float eps, int splits, int tiles_per_split, cudaStream_t s) {
  switch (wdtype) {
    case 0: return launch<T, float>(act, x, nw, wg, wu, wd, h, hc, part, out, rows, d, f, eps, splits, tiles_per_split, s);
    case 1: return launch<T, __half>(act, x, nw, wg, wu, wd, h, hc, part, out, rows, d, f, eps, splits, tiles_per_split, s);
    case 2: return launch<T, __nv_bfloat16>(act, x, nw, wg, wu, wd, h, hc, part, out, rows, d, f, eps, splits, tiles_per_split, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// The f32 FMA body (x in f32). Weight dtype codes: 0 = f32, 1 = f16,
// 2 = bf16; act codes as enum Act. h (rows, d) and hc (rows, f) are
// caller-allocated scratch in f32. w_gate is read only for swiglu.
// Returns the cudaGetLastError() after the launches.
extern "C" int stage_mlp_block_fma(int wdtype, int act, const void* x,
                                   const void* norm_w, const void* w_gate,
                                   const void* w_up, const void* w_down,
                                   void* h, void* hc, void* out, int rows,
                                   int d, int f, float eps, void* stream) {
  if (rows <= 0 || d <= 0 || f <= 0 || act < kSwiglu || act > kSilu)
    return (int)cudaErrorInvalidValue;
  return (int)launch_w<float>(wdtype, act, x, norm_w, w_gate, w_up, w_down, h,
                              hc, out, rows, d, f, eps,
                              static_cast<cudaStream_t>(stream));
}

// dynamic shared memory (bytes) of the tensor-core GEMMs for activation
// and weight dtype codes as below
extern "C" int stage_mlp_block_wgmma_smem(int dtype, int wdtype) {
  if (dtype == 2) {
    switch (wdtype) {
      case 0: return (int)tc::Cfg<__nv_bfloat16, float>::kSmem;
      case 1: return (int)tc::Cfg<__nv_bfloat16, __half>::kSmem;
      case 2: return (int)tc::Cfg<__nv_bfloat16, __nv_bfloat16>::kSmem;
    }
  } else if (dtype == 1) {
    switch (wdtype) {
      case 0: return (int)tc::Cfg<__half, float>::kSmem;
      case 1: return (int)tc::Cfg<__half, __half>::kSmem;
      case 2: return (int)tc::Cfg<__half, __nv_bfloat16>::kSmem;
    }
  }
  return 0;
}

// The tensor-core body; activation dtype codes 1 = f16, 2 = bf16, weight
// codes as above. Scratch from the caller: h (rows, d) and hc (rows, f)
// in the activation type, part (splits, rows, d) in f32. The down product
// runs as `splits` splits of `tiles_per_split` 64-deep k-tiles of f, which
// must cover [0, f) exactly once. TMA needs 16-byte aligned bases and row
// strides. Returns the cudaGetLastError() after the launches, or
// cudaErrorInvalidValue if the plan or a tensor map is refused.
extern "C" int stage_mlp_block_wgmma(int dtype, int wdtype, int act,
                                     const void* x, const void* norm_w,
                                     const void* w_gate, const void* w_up,
                                     const void* w_down, void* h, void* hc,
                                     void* part, void* out, int rows, int d,
                                     int f, float eps, int splits,
                                     int tiles_per_split, void* stream) {
  if (rows <= 0 || d <= 0 || f <= 0 || act < kSwiglu || act > kSilu)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return (int)tc::launch_w<__half>(wdtype, act, x, norm_w, w_gate, w_up, w_down, h, hc, part, out, rows, d, f, eps, splits, tiles_per_split, s);
    case 2: return (int)tc::launch_w<__nv_bfloat16>(wdtype, act, x, norm_w, w_gate, w_up, w_down, h, hc, part, out, rows, d, f, eps, splits, tiles_per_split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
