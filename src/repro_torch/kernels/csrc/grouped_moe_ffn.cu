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
// (stage_mlp_block.cu) in two GEMMs, each tile offsetting into its own
// expert's weights:
//   1. up + activation: buf (R, D) x [w_gate | w_up][e] (D, F), the
//      activation in the epilogue, writes h (R, F) in T;
//   2. down: h (R, F) x w_down[e] (F, D), writes out (R, D) in T.
// Two bodies; the activation dtype picks one (a fixed route, not a
// fallback):
//
// * f16 / bf16 rows: the tensor-core body, namespace tc. The stage
//   kernel's warp-specialised GEMM shape: two consumer warpgroups (one
//   m64 row block each, 128 rows a CTA) and one producer warp that keeps
//   TMA loads in flight through a ring of stages (mbarriers `full` on the
//   TMA bytes, `empty` on the consumers' release). A CTA takes one row
//   tile of ONE expert from a tile schedule that two small grids compute
//   on the device from block_eid (no host sync): every expert's blocks
//   are contiguous, so each expert's row range is cut into 128-row tiles,
//   and rows of a tile past its expert's range are loaded (they belong to
//   the next expert) but never stored. So any blk that is a multiple of 8
//   takes this body. A tile whose rows are all zero (the trailing padding
//   blocks, a quarter of the rows at the shape above) loads nothing and
//   stores zeros: FFN(0) = 0 for every activation. The weights are 3-D tensor maps
//   (E, K, N) whose outer coordinate is the tile's expert. f32 master
//   weights come raw by TMA and both consumer warpgroups convert them to
//   the swizzled, MN-major bf16/f16 B tile while the previous k-tile's
//   wgmma runs; weights already in T go straight to the B tile. In the up
//   GEMM one m64n128k16 covers 64 gate and 64 up columns. Blocks walk the
//   column tiles fastest: the CTAs that share a row tile's A rows run
//   together (A crosses HBM about once), and an expert's row tiles are
//   neighbours, so its weight tiles are read by CTAs in flight at the
//   same time (the weights cross HBM about once). Rows past R read as
//   zero (TMA fill).
// * f32 rows: the f32 FMA body (TF32 would not meet the f32 gate of
//   1e-5): up_act and down, a (BM rows x 64 columns) tile per block of
//   threads, K staged through shared memory. A row tile never straddles
//   two expert blocks: BM is the largest of 64, 32 and 8 that divides
//   blk (the wrapper refuses a blk that is not a multiple of 8), so every
//   tile reads one expert id. Blocks walk row tiles fastest, so the tiles
//   that share a weight tile run together and hit it in L2.
#include <math.h>

#include <type_traits>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// tensor-core body (f16 / bf16 rows): TMA-fed, warp-specialised wgmma
// GEMMs over a tile schedule of one expert per row tile. The tile sizes
// here and kernels/moe_dispatch.py's TC_ROWS must agree.
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kBM = 128;                   // rows per CTA: two warpgroups x m64
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

// One CTA computes a (kBM rows) x (kBN columns of B) product of row tile
// blockIdx.y of the schedule: sched[4 t .. 4 t + 3] = (expert, first row,
// end row of the expert's range, live); a tile with first row >= end row
// is past the last tile and does nothing; a tile that is not live (its
// rows are all zero) loads nothing and stores act(0, 0) = 0 or 0. A
// (rows, K) in T, K-major; the expert's weights (K, N) as stored,
// MN-major, through a 3-D map (E, K, N). Modes:
//   kUpGated: B = [w_gate | w_up] columns n0 .. n0 + 63 of each;
//             out[:, n0 .. n0 + 63] = T(act(T(gate), T(up)))
//   kUpPlain: B = w_up columns n0 .. n0 + 127; out = T(act(T(up)))
//   kDown:    B = w_down columns n0 .. n0 + 127; out = T(sum)
// Only rows in [first row, end row) are stored.
template <typename T, typename W, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
grouped_gemm_tc(const __grid_constant__ CUtensorMap amap,
                const __grid_constant__ CUtensorMap w0map,
                const __grid_constant__ CUtensorMap w1map,
                const int* __restrict__ sched, T* __restrict__ out, int n_out,
                int k_tiles, int act) {
  using C = Cfg<T, W>;
  const int4 tile = reinterpret_cast<const int4*>(sched)[blockIdx.y];
  const int expert = tile.x, m0 = tile.y, m_end = tile.z;
  if (m0 >= m_end) return;  // the whole CTA: past the last tile
  const int n_k = tile.w ? k_tiles : 0;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);  // per stage: A | W (or B)
  uint8_t* bconv = base + C::kStages * C::kStageBytes;  // converted B tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(bconv + C::kBBufs * C::kBBytes);
  uint64_t* empty = full + C::kStages;

  const int n0 = blockIdx.x * (MODE == kUpGated ? kBN / 2 : kBN);

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
        const int k = i * kBK;
        tma_load_2d(st, &amap, &full[s], k, m0);
        // the expert's weights in their stored type, 128-byte swizzled
        // boxes (when W is T, box q is column chunk q of the B tile itself)
        for (int q = 0; q < C::kWBoxes; ++q) {
          const int half = C::kWBoxes / 2;
          const bool second = MODE == kUpGated && q >= half;
          const int col = MODE == kUpGated ? n0 + (q % half) * C::kWCols
                                           : n0 + q * C::kWCols;
          tma_load_3d(st + C::kABytes + q * kBK * 128, second ? &w1map : &w0map,
                      &full[s], col, k, expert);
        }
      }
    }
    return;
  }

  const int t = threadIdx.x;    // 0 .. 255
  const int g = warp / 4;       // consumer warpgroup: rows m0 + 64 g ..
  float acc[kBN / 2];
#pragma unroll
  for (int j = 0; j < kBN / 2; ++j) acc[j] = 0.0f;

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
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = make_desc(st + g * 64 * kRow + kk * 32, 16, 8 * kRow, 128);
      const uint64_t db = make_desc(btile + kk * 16 * kRow, kBK * kRow, 8 * kRow, 128);
      Wgmma<T, kBN>::template ss<1>(acc, da, db, 1);
    }
    wgmma_commit();
    // convert the next k-tile's weights while the tensor cores run
    if (C::kConvert && i + 1 < n_k) {
      mbar_wait(&full[(i + 1) % C::kStages], ((i + 1) / C::kStages) & 1);
      convert(i + 1);
    }
    wgmma_wait<0>();
    fence_regs<kBN / 2>(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    // both warpgroups' halves of the next B tile are written, and both
    // are done reading this one
    if (C::kConvert) named_sync(1, kConsumers);
  }

  const int t4 = lane % 4;
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    const int row = m0 + g * 64 + 16 * (warp % 4) + lane / 4 + 8 * i2;
    if (row >= m_end) continue;
    T* dst = out + (size_t)row * n_out;
    if (MODE == kUpGated) {
#pragma unroll
      for (int c = 0; c < kBN / 16; ++c) {
        const int col = n0 + 8 * c + 2 * t4;
        if (col >= n_out) continue;
        const int gi = 4 * c + 2 * i2, ui = gi + 4 * (kBN / 16);
        *reinterpret_cast<uint32_t*>(dst + col) = pack<T>(
            activate(act, round_to<T>(acc[gi]), round_to<T>(acc[ui])),
            activate(act, round_to<T>(acc[gi + 1]), round_to<T>(acc[ui + 1])));
      }
    } else if (MODE == kUpPlain) {
#pragma unroll
      for (int c = 0; c < kBN / 8; ++c) {
        const int col = n0 + 8 * c + 2 * t4;
        if (col >= n_out) continue;
        const int ui = 4 * c + 2 * i2;
        *reinterpret_cast<uint32_t*>(dst + col) =
            pack<T>(activate(act, 0.0f, round_to<T>(acc[ui])),
                    activate(act, 0.0f, round_to<T>(acc[ui + 1])));
      }
    } else {
#pragma unroll
      for (int c = 0; c < kBN / 8; ++c) {
        const int col = n0 + 8 * c + 2 * t4;
        if (col >= n_out) continue;
        *reinterpret_cast<uint32_t*>(dst + col) =
            pack<T>(acc[4 * c + 2 * i2], acc[4 * c + 2 * i2 + 1]);
      }
    }
  }
}

// an (experts, rows, cols) stack of row-major matrices as a 3-D tensor
// map with a box of (one expert, kBK rows, 128 bytes of columns)
template <typename E>
bool expert_map(CUtensorMap* map, const void* p, int experts, int rows, int cols) {
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)rows, (uint64_t)experts};
  const uint64_t strides[2] = {(uint64_t)cols * sizeof(E),
                               (uint64_t)rows * cols * sizeof(E)};
  const uint32_t box[3] = {128 / (uint32_t)sizeof(E), (uint32_t)kBK, 1};
  return make_map(map, MapType<E>::v, 3, p, dims, strides, box, 128);
}

template <typename T, typename W, int MODE>
cudaError_t gemm(const CUtensorMap& a, const CUtensorMap& w0,
                 const CUtensorMap& w1, const int* sched, int n_tiles, T* out,
                 int n_out, int k_tiles, int act, cudaStream_t stream) {
  using C = Cfg<T, W>;
  // opt in to more than 48 KB of dynamic shared memory once per
  // instantiation, outside any stream capture that follows
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        grouped_gemm_tc<T, W, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)C::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int bn = MODE == kUpGated ? kBN / 2 : kBN;
  const dim3 grid((n_out + bn - 1) / bn, n_tiles);
  grouped_gemm_tc<T, W, MODE><<<grid, kThreads, C::kSmem, stream>>>(
      a, w0, w1, sched, out, n_out, k_tiles, act);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch(int act, const void* buf, const int* sched, int n_tiles,
                   const void* wg, const void* wu, const void* wd, void* h,
                   void* out, int rows, int d, int f, int experts,
                   cudaStream_t stream) {
  const bool gated = act == kSwiglu;
  CUtensorMap bmap, hmap, gmap, umap, dmap;
  if (!matrix_map<T>(&bmap, buf, rows, d, kBM) || !matrix_map<T>(&hmap, h, rows, f, kBM)
      || !expert_map<W>(&umap, wu, experts, d, f)
      || (gated && !expert_map<W>(&gmap, wg, experts, d, f))
      || !expert_map<W>(&dmap, wd, experts, f, d))
    return cudaErrorInvalidValue;
  T* ht = static_cast<T*>(h);
  const int k_up = (d + kBK - 1) / kBK, k_down = (f + kBK - 1) / kBK;
  cudaError_t err =
      gated ? gemm<T, W, kUpGated>(bmap, gmap, umap, sched, n_tiles, ht, f, k_up, act, stream)
            : gemm<T, W, kUpPlain>(bmap, umap, umap, sched, n_tiles, ht, f, k_up, act, stream);
  if (err != cudaSuccess) return err;
  return gemm<T, W, kDown>(hmap, dmap, dmap, sched, n_tiles, static_cast<T*>(out),
                           d, k_down, act, stream);
}

// ---------------------------------------------------------------------------
// the tile schedule (kernels/moe_dispatch.py tile_schedule is its plain
// version), two small grids before the GEMMs
// ---------------------------------------------------------------------------

constexpr int kSchedThreads = 1024;
constexpr int kMaxExperts = 2048;  // three int arrays of it in static shared memory

// One block. block_eid is non-decreasing, so each expert's blocks are
// contiguous: per expert its first block and block count, its kBM-row
// tiles (an inclusive prefix sum over the experts), then tile t ->
// (expert, first row, end row of the expert's range, live = 0). Tiles past
// the last one are (E - 1, rows, rows, 0).
__global__ void __launch_bounds__(kSchedThreads)
schedule_tiles(const int* __restrict__ eid, int nb, int blk, int experts,
               int n_tiles, int4* __restrict__ sched) {
  __shared__ int first[kMaxExperts];
  __shared__ int count[kMaxExperts];
  __shared__ int tend[kMaxExperts];
  __shared__ int part[kSchedThreads / 32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int e = tid; e < experts; e += kSchedThreads) {
    first[e] = 0;
    count[e] = 0;
  }
  __syncthreads();
  for (int i = tid; i < nb; i += kSchedThreads)
    if (i == 0 || eid[i - 1] != eid[i]) first[eid[i]] = i;
  __syncthreads();
  for (int i = tid; i < nb; i += kSchedThreads)
    if (i == nb - 1 || eid[i + 1] != eid[i]) count[eid[i]] = i + 1 - first[eid[i]];
  __syncthreads();
  // tiles per expert, inclusive prefix: each thread a run of experts,
  // then a block-wide scan of the runs' totals
  const int per = (experts + kSchedThreads - 1) / kSchedThreads;
  const int e0 = min(tid * per, experts), e1 = min(e0 + per, experts);
  int run = 0;
  for (int e = e0; e < e1; ++e) {
    run += (count[e] * blk + kBM - 1) / kBM;
    tend[e] = run;
  }
  int v = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = part[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += u;
    }
    part[lane] = w;
  }
  __syncthreads();
  const int before = v - run + (warp > 0 ? part[warp - 1] : 0);
  for (int e = e0; e < e1; ++e) tend[e] += before;
  __syncthreads();
  const int total = tend[experts - 1], rows = nb * blk;
  for (int t = tid; t < n_tiles; t += kSchedThreads) {
    int4 st = make_int4(experts - 1, rows, rows, 0);
    if (t < total) {
      int lo = 0, hi = experts - 1;  // the first expert whose tiles end past t
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (tend[mid] > t) hi = mid; else lo = mid + 1;
      }
      const int tiles = (count[lo] * blk + kBM - 1) / kBM;
      st = make_int4(lo, first[lo] * blk + (t - (tend[lo] - tiles)) * kBM,
                     (first[lo] + count[lo]) * blk, 0);
    }
    sched[t] = st;
  }
}

// One block per tile: live = 1 iff a row of the tile has a non-zero
// element (16-bit rows: any bit but the sign; a NaN counts). It stops at
// the first one, so a live tile costs one pass of 16 KB and only the all-
// zero tiles (the trailing padding blocks) are read whole.
__global__ void __launch_bounds__(256)
mark_live_tiles(const uint16_t* __restrict__ buf, int d, int4* __restrict__ sched) {
  int4* st = sched + blockIdx.x;
  const int r0 = st->y, r1 = min(st->y + kBM, st->z);
  if (r0 >= r1) return;
  const uint4* base = reinterpret_cast<const uint4*>(buf + (size_t)r0 * d);
  const int n = (r1 - r0) * (d / 8);
  int found = 0;
  for (int i0 = 0; i0 < n; i0 += 4 * 256) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * 256 + threadIdx.x;
      if (i < n) {
        const uint4 w = __ldg(base + i);
        found |= ((w.x | w.y | w.z | w.w) & 0x7FFF7FFFu) != 0;
      }
    }
    if (__syncthreads_or(found)) {
      if (threadIdx.x == 0) st->w = 1;
      return;
    }
  }
}

template <typename T>
cudaError_t launch_w(int wdtype, int self_code, int act, const void* buf,
                     const int* sched, int n_tiles, const void* wg,
                     const void* wu, const void* wd, void* h, void* out,
                     int rows, int d, int f, int experts, cudaStream_t s) {
  if (wdtype == 0)
    return launch<T, float>(act, buf, sched, n_tiles, wg, wu, wd, h, out, rows, d, f, experts, s);
  if (wdtype == self_code)
    return launch<T, T>(act, buf, sched, n_tiles, wg, wu, wd, h, out, rows, d, f, experts, s);
  return cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

// The f32 FMA body: f32 rows and f32 weights. act codes as enum Act.
// row_tile is 64, 32 or 8 and divides blk, which divides rows. block_eid
// (rows / blk,) int32 holds expert ids in [0, E). h (rows, f) is
// caller-allocated f32 scratch; w_gate is read only for swiglu. Returns
// the cudaGetLastError() after the launches.
extern "C" int grouped_moe_ffn_fma(int act, int row_tile, const void* buf,
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
    case 64: return (int)launch<float, float, 64>(act, buf, eid, w_gate, w_up, w_down, h, out, rows, blk, d, f, s);
    case 32: return (int)launch<float, float, 32>(act, buf, eid, w_gate, w_up, w_down, h, out, rows, blk, d, f, s);
    case 8: return (int)launch<float, float, 8>(act, buf, eid, w_gate, w_up, w_down, h, out, rows, blk, d, f, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dynamic shared memory (bytes) of the tensor-core GEMMs for activation
// and weight dtype codes as above
extern "C" int grouped_moe_ffn_wgmma_smem(int dtype, int wdtype) {
  if (dtype == 2) {
    if (wdtype == 0) return (int)tc::Cfg<__nv_bfloat16, float>::kSmem;
    if (wdtype == 2) return (int)tc::Cfg<__nv_bfloat16, __nv_bfloat16>::kSmem;
  } else if (dtype == 1) {
    if (wdtype == 0) return (int)tc::Cfg<__half, float>::kSmem;
    if (wdtype == 1) return (int)tc::Cfg<__half, __half>::kSmem;
  }
  return 0;
}

// The tile schedule of the tensor-core body into sched (n_tiles, 4) int32
// (16-byte aligned): (expert, first row, end row, live) of 128-row tiles,
// from block_eid (n_blocks,) int32, non-decreasing, with ids in [0,
// experts), and the 16-bit rows buf (n_blocks * blk, d), d a multiple of
// 8. Returns the cudaGetLastError() after the launches.
extern "C" int grouped_moe_ffn_schedule(const void* block_eid, int n_blocks,
                                        int blk, int experts, const void* buf,
                                        int d, void* sched, int n_tiles,
                                        void* stream) {
  if (n_blocks <= 0 || blk <= 0 || experts <= 0 || experts > tc::kMaxExperts ||
      d <= 0 || d % 8 || n_tiles <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int4* st = static_cast<int4*>(sched);
  tc::schedule_tiles<<<1, tc::kSchedThreads, 0, s>>>(
      static_cast<const int*>(block_eid), n_blocks, blk, experts, n_tiles, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tc::mark_live_tiles<<<n_tiles, 256, 0, s>>>(static_cast<const uint16_t*>(buf), d, st);
  return (int)cudaGetLastError();
}

// The tensor-core body; activation dtype codes 1 = f16, 2 = bf16, weights
// f32 (0) or of the activation type. sched (n_tiles, 4) is the tile
// schedule that grouped_moe_ffn_schedule wrote; h (rows, f) is
// caller-allocated scratch in the activation type. TMA needs 16-byte
// aligned bases and row strides. Returns the cudaGetLastError() after the
// launches, or cudaErrorInvalidValue if a tensor map is refused.
extern "C" int grouped_moe_ffn_wgmma(int dtype, int wdtype, int act,
                                     const void* buf, const void* sched,
                                     int n_tiles, const void* w_gate,
                                     const void* w_up, const void* w_down,
                                     void* h, void* out, int rows, int d,
                                     int f, int experts, void* stream) {
  if (rows <= 0 || d <= 0 || f <= 0 || experts <= 0 || n_tiles <= 0 ||
      n_tiles > 65535 || act < kSwiglu || act > kSilu)
    return (int)cudaErrorInvalidValue;
  const int* st = static_cast<const int*>(sched);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return (int)tc::launch_w<__half>(wdtype, 1, act, buf, st, n_tiles, w_gate, w_up, w_down, h, out, rows, d, f, experts, s);
    case 2: return (int)tc::launch_w<__nv_bfloat16>(wdtype, 2, act, buf, st, n_tiles, w_gate, w_up, w_down, h, out, rows, d, f, experts, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
