// Causal GQA flash attention, forward and backward, Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`_kernel`, launched by `flash_attention`'s pallas_call). For q
// (B, Sq, H, hd) and k, v (B, Skv, KH, hd) in T (f32, f16 or bf16) it
// computes, for every query row at absolute position q_offset + i,
//
//   o = softmax_j(<q, k_j> * scale) @ v     over the keys j with
//       j <= q_offset + i (causal) and j > q_offset + i - window (window)
//
// with f32 scores, softmax and accumulation, and writes o in T. GQA reads
// kv head h / (H / KH) in place: no repeated K/V is formed.
//
// What bounds it on an H100: at the evaluation shape (B = 8, S = 1024,
// H = 16, KH = 2, hd = 128, bf16, causal) a call must move 75.5 MB
// (q, k, v, o once each), 0.023 ms at 3.35 TB/s, and do 34.4 GFLOP over
// the causally reachable (query, key) pairs, 0.035 ms at the bf16 tensor
// core rate of 989 TFLOP/s: the operations bound it.
//
// Two bodies; the input dtype picks one (a fixed route, not a fallback):
//
// * f16 / bf16: `flash_fwd_tc`, on the tensor cores. One CTA per (128
//   query rows, head, batch row): two consumer warpgroups of 64 rows and
//   one producer warp. The producer loads the Q tile once by TMA, then
//   K and V tiles (64 keys, 32 at hd 256) into a ring of stages
//   (mbarriers: `full` completes on the TMA bytes, `empty` on the consumer
//   warps' release). Tiles are swizzled rows of the widest of 128, 64 and
//   32 bytes that divides a row, in column chunks of that width: hd 16,
//   32, 64, 96, 128, 192 and 256 all take this body (hd 96 is three
//   64-byte chunks, 192 and 256 three and four of 128 bytes; the wrapper
//   pads any other hd up to 256 with zero columns). S = Q K^T is one wgmma
//   chain with both operands in
//   shared memory (K row-major is K-major). The online softmax runs on the
//   accumulator fragments in registers (scores in the log2 domain, running
//   max and sum per row reduced over the 4 lanes of a quad); P is cast to
//   T in registers and is the register A operand of O += P V, with V's
//   (keys, hd) row-major tile as the MN-major ("transposed") B operand.
//   P is cast as two terms, T(P) and T(P - T(P)), each its own wgmma
//   chain: with T(P) alone (as SDPA and a TPU at default precision
//   round) the outputs moved by up to 2^-9 relative and flipped the bf16
//   rounding of outputs above 4 on the held-out call's real activations
//   (0.03125 > the 2e-2 gate), while the second term leaves only the f32
//   sums' order (~2^-17 relative), for one more P V chain a tile. The row
//   sum l is taken from the unrounded f32 P. Masks are
//   applied only on tiles that cross the causal diagonal, the window's
//   edge or Skv; tiles that no row of the CTA reaches are never loaded,
//   and a warpgroup skips the tiles none of its rows reaches. Query tiles
//   are scheduled longest first (grid z reversed) to even out the causal
//   triangle. Ragged Sq and Skv: TMA fills rows past the end with zeros,
//   the mask drops keys past Skv and the epilogue stores rows < Sq only.
// * f32: `flash_fwd`, the f32 FMA body, at the same head dims (exact f32
//   products; the tensor cores' TF32 would not meet the f32 gate of
//   1e-5). One block of 256
//   threads per (64 query rows, head, batch row), walking 64-key tiles
//   with an online softmax in registers; Q and each K/V tile staged in
//   shared memory as f32, the probability tile through shared memory to
//   the p @ v product, never rounded (kernels/ref.py flash_attention_ref).
//
// Backward (f16 / bf16 at hd 64 and 128; padded widths reach it through
// the wrapper). It replaces no TPU kernel: the Pallas kernel has no VJP,
// so the reference trains attention through XLA's dense form. It lets the
// training step's attention half (models/layers.py `_attention_core`,
// impl "auto" on card tensors) run forward and backward by hand. Given
// q, k, v, the forward's o, its second term o_lo = T(o - T(o)) and the
// rows' log-sum-exp (log2 domain, written by `flash_fwd_tc` when asked),
// and dO, it computes with f32 accumulation everywhere
//
//   P = exp2(S log2e scale - lse), S = Q K^T   (recomputed, not stored)
//   D = rowsum(dO (o + o_lo)),  dP = dO V^T,  dS = P (dP - D)
//   dV = P^T dO,  dK = scale dS^T Q,  dQ = scale dS K
//
// What bounds it on an H100: at the dense training cell's shape
// (B 2, S 2048, H 16, KH 2, hd 128, causal) five products over the
// reachable pairs (S, dP, dV, dK, dQ; 17.2 GFLOP each, the forward's
// 34.4 GFLOP being two), 86 GFLOP, 0.087 ms at 989 TFLOP/s (0.174 ms with
// the second bf16 terms below); the bytes (q, o, o_lo, dO, dq 16.8 MB
// each, k, v, dk, dv 2.1 MB each, the f32 group partials 67 MB written
// and read) ~230 MB, 0.069 ms: the operations bound it. Four launches on
// the stream:
// * `flash_bwd_delta`: D in f32 from the output's two terms, one warp a
//   row. D from the rounded o alone moved dS enough that dq and dk came
//   out further from f32 than the dense route's bf16 autograd (CPU
//   emulation: 4.6-5.5e-3 against 3.3-4.3e-3 of max|ref|).
// * `flash_bwd_dq_tc`: the forward's layout (128 query rows a CTA, two
//   consumer warpgroups, a producer warp streaming K/V tiles of 64 keys
//   through a 2-stage mbarrier ring; S and dP as wgmma chains on shared
//   K-major operands; dS in registers as the A operand of dQ += dS K).
//   Grid (H, B, Sq / 128): 512 CTAs at the dense cell's shape, 256 at
//   the MoE cell's (1, 1024, 32/4, 128).
// * `flash_bwd_dkdv_tc`: keys as the accumulator rows, so P^T and dS^T
//   leave S^T's wgmma fragments as register A operands (dV += P^T dO,
//   dK += dS^T Q, dO and Q the MN-major B operands) and nothing is
//   transposed through shared memory. One CTA per (64 keys, query head,
//   batch row): per kv head and 128-key tile the grid would hold only 64
//   CTAs at the dense shape (32 at the MoE one) with the causal triangle
//   loading them unevenly; per query head it holds 1 024 (512). K and V
//   are loaded once, (Q, dO, lse, D) tiles of 64 queries stream through
//   a 2-stage ring, only the tiles that reach some key, key tiles with
//   the most work first. The masks run only on tiles that cross the
//   diagonal, the window's edge or Skv.
// * `flash_bwd_sum_groups`: with H > KH each query head's dK and dV
//   partials (f32, 2 x B x Skv x H x hd) are summed over the GQA group in
//   head order and rounded once.
// No atomics: two calls on the same inputs give bit-equal dq, dk and dv.
// P (in dV) and dS (in dK, dQ) enter the products as two terms in T,
// T(x) + T(x - T(x)), as P does in the forward: with one term dq and dk
// came out further from f32 than the dense route's (CPU emulation), with
// two they read 0.30-3.05e-3 of max|ref| against its 2.4-6.1e-3 on the
// card (tests/test_torch_gpu.py). The backward is instantiated at hd 64
// and 128 only, to keep the build short: the whole file takes 22.4-22.8 s
// of nvcc on the card's host, cold.
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBKV = 64;       // keys per tile
constexpr int kThreads = 256;  // 16 x 16: 4 rows x (64/16 keys | hd/16 dims) each
constexpr int kLdP = kBKV + 1;

// the FMA body is instantiated for f32 only (16-bit inputs take the
// tensor-core body)
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// reduce over the 16 lanes that share a row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (HD + 1) + (size_t)kBKV * (HD + 1)
                          + (size_t)kBKV * HD + (size_t)kBQ * kLdP);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv, int H,
          int KH, float scale, int causal, int window, int q_offset) {
  constexpr int kLd = HD + 1;
  constexpr int kCols = HD / 16;  // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // (kBQ, kLd)
  float* Ks = Qs + kBQ * kLd;     // (kBKV, kLd)
  float* Vs = Ks + kBKV * kLd;    // (kBKV, HD)
  float* Ps = Vs + kBKV * HD;     // (kBQ, kLdP)

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  for (int e = threadIdx.x; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, dd = e % HD, qi = q0 + r;
    Qs[r * kLd + dd] = qi < Sq ? to_f32(q[(((size_t)b * Sq + qi) * H + h) * HD + dd]) : 0.0f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  }

  // keys any row of this block can reach
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, q_first - window + 1) : 0;

  for (int kv0 = kv_begin / kBKV * kBKV; kv0 < kv_end; kv0 += kBKV) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = threadIdx.x; e < kBKV * HD; e += kThreads) {
      const int r = e / HD, dd = e % HD, kj = kv0 + r;
      const size_t src = (((size_t)b * Skv + kj) * KH + kh) * HD + dd;
      const bool ok = kj < Skv;
      Ks[r * kLd + dd] = ok ? to_f32(k[src]) : 0.0f;
      Vs[r * HD + dd] = ok ? to_f32(v[src]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int dd = 0; dd < HD; ++dd) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * kLd + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = Ks[(tx + 16 * j) * kLd + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q_offset + q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kv0 + tx + 16 * j;
        bool ok = kpos < Skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      // a row with no reachable key yet keeps p and the correction at 0
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      const float corr = m[i] == -INFINITY ? 0.0f : expf(m[i] - m_safe);
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.0f : expf(s[i][j] - m_safe);
        Ps[r * kLdP + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * corr + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBKV; ++c) {
      float va[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) va[j] = Vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * kLdP + c];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(p, va[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    T* dst = o + (((size_t)b * Sq + qi) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < kCols; ++j) dst[tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Skv, int H, int KH, float scale, int causal,
                   int window, int q_offset, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // opt in to more than 48 KB of dynamic shared memory once per
  // instantiation, outside any stream capture that follows
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KH, scale,
      causal, window, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* o, int B, int Sq, int Skv, int H, int KH,
                      float scale, int causal, int window, int q_offset,
                      cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    case 96: return launch<T, 96>(q, k, v, o, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    case 192: return launch<T, 192>(q, k, v, o, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    case 256: return launch<T, 256>(q, k, v, o, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// tensor-core body (f16 / bf16): TMA-fed, warp-specialised wgmma
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kBQ = 128;                   // query rows per CTA
// P enters P V as this many terms in T: P = T(P) + T(P - T(P)) carries P
// to ~16 bits (bf16) / ~22 bits (f16), so P V is as close to the f32
// function as the f32 sums' order allows
constexpr int kPTerms = 2;
constexpr int kConsumers = 256;            // two warpgroups of 64 rows each
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = kConsumers + 32;  // + one producer warp

// Per head dim: the swizzled row (the widest of 128, 64 and 32 bytes that
// divides a row of hd values; 96 takes 64-byte rows, 192 and 256 128-byte
// ones), the keys per K/V tile and the ring depth. A CTA of 288 threads
// gets at most 168 registers a thread, and at hd 192 and 256 the O
// accumulator alone takes 96 and 128 of them. Measured on an H100: at hd
// 192, 64-key tiles stay free of spills and beat 32-key ones; at hd 256,
// 64-key tiles spill more than 32-key ones (S and the two P terms take 16
// registers each at 32 keys) and run slower, so hd 256 takes 32 keys.
// Above hd 128 the ring has 2 stages, which keeps Q and the ring inside
// 227 KB.
template <int HD> struct Geo {
  static constexpr int kRow = (HD * 2) % 128 == 0 ? 128 : (HD * 2) % 64 == 0 ? 64 : 32;
  static constexpr int kBKV = HD > 192 ? 32 : 64;           // keys per K/V tile
  static constexpr int kStages = HD > 128 ? 2 : 3;          // K/V ring depth
  static constexpr int kChunkCols = kRow / 2;               // columns per chunk
  static constexpr int kChunkQ = kBQ * kRow;                // bytes of a Q chunk
  static constexpr int kChunkKV = kBKV * kRow;              // bytes of a K/V chunk
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kKVBytes = kBKV * HD * 2;            // one K or V tile
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 2 * kStages);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, T* __restrict__ o,
             float* __restrict__ lse, T* __restrict__ o_lo, int Sq, int Skv,
             int H, int KH, float scale_log2, int causal, int window,
             int q_offset) {
  using G = Geo<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);          // [chunk][kBQ rows][kRow]
  uint8_t* Ks = Qs + G::kQBytes;              // [stage][chunk][G::kBKV rows][kRow]
  uint8_t* Vs = Ks + G::kStages * G::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + G::kStages * G::kKVBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + G::kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // longest tiles first
  const int kh = h / (H / KH);

  // key tiles any row of the CTA reaches
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int t_begin = kv_begin / G::kBKV;
  const int n_tiles = kv_end > kv_begin ? (kv_end + G::kBKV - 1) / G::kBKV - t_begin : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < G::kStages; ++s) {
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
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      mbar_expect_tx(q_full, G::kQBytes);
      for (int c = 0; c < HD / G::kChunkCols; ++c)
        tma_load_4d(Qs + c * G::kChunkQ, &qmap, q_full, c * G::kChunkCols, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % G::kStages;
        mbar_wait(&empty[s], ((i / G::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * G::kKVBytes);
        const int kv0 = (t_begin + i) * G::kBKV;
        for (int c = 0; c < HD / G::kChunkCols; ++c) {
          tma_load_4d(Ks + s * G::kKVBytes + c * G::kChunkKV, &kmap, &full[s],
                      c * G::kChunkCols, kh, kv0, b);
          tma_load_4d(Vs + s * G::kKVBytes + c * G::kChunkKV, &vmap, &full[s],
                      c * G::kChunkCols, kh, kv0, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup g: tile rows 64 g .. 64 g + 63; this thread holds
  // rows r0 and r0 + 8 of them (the accumulator fragment)
  const int g = warp / 4;
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int t4 = lane % 4;
  const int wg_first = q_offset + q0 + 64 * g;  // absolute positions
  const int wg_last = wg_first + 63;

  float oacc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % G::kStages;
    const int kv0 = (t_begin + i) * G::kBKV;
    mbar_wait(&full[s], (i / G::kStages) & 1);
    const bool reached = !(causal && kv0 > wg_last)
                         && !(window > 0 && kv0 + G::kBKV - 1 <= wg_first - window);
    if (reached) {
      // S = Q K^T (f32), both operands K-major in shared memory
      float sacc[G::kBKV / 2];
#pragma unroll
      for (int j = 0; j < G::kBKV / 2; ++j) sacc[j] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk * 16 / G::kChunkCols;
        const int off = (kk * 16 % G::kChunkCols) * 2;
        const uint64_t da = make_desc(Qs + c * G::kChunkQ + 64 * g * G::kRow + off,
                                      16, 8 * G::kRow, G::kRow);
        const uint64_t db = make_desc(Ks + s * G::kKVBytes + c * G::kChunkKV + off,
                                      16, 8 * G::kRow, G::kRow);
        Wgmma<T, G::kBKV>::template ss<0>(sacc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<G::kBKV / 2>(sacc);

      const bool masked = (causal && kv0 + G::kBKV - 1 > wg_first) || kv0 + G::kBKV > Skv
                          || (window > 0 && kv0 <= wg_last - window);
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int qpos = wg_first + r0 + 8 * i2;
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < G::kBKV / 8; ++c) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float x = sacc[4 * c + 2 * i2 + j] * scale_log2;
            if (masked) {
              const int kpos = kv0 + 8 * c + 2 * t4 + j;
              bool ok = kpos < Skv;
              if (causal) ok = ok && kpos <= qpos;
              if (window > 0) ok = ok && kpos > qpos - window;
              x = ok ? x : -INFINITY;
            }
            sacc[4 * c + 2 * i2 + j] = x;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i2], mx);
        // a row with no reachable key yet keeps p and the correction at 0
        const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
        const float corr = exp2f(m[i2] - m_safe);
        m[i2] = m_new;
        float ps = 0.0f;
#pragma unroll
        for (int c = 0; c < G::kBKV / 8; ++c) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float p = exp2f(sacc[4 * c + 2 * i2 + j] - m_safe);
            sacc[4 * c + 2 * i2 + j] = p;
            ps += p;  // l from the unrounded probabilities
          }
        }
        l[i2] = l[i2] * corr + ps;
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) {
          oacc[4 * c + 2 * i2] *= corr;
          oacc[4 * c + 2 * i2 + 1] *= corr;
        }
      }

      // P as kPTerms terms in T, each the rounding of what the earlier
      // terms left: the accumulator fragment of 16 keys is the m64k16 A
      // fragment of P V
      uint32_t pa[kPTerms][G::kBKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < G::kBKV / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float lo = sacc[8 * kk + 2 * r], hi = sacc[8 * kk + 2 * r + 1];
#pragma unroll
          for (int t = 0; t < kPTerms; ++t) {
            pa[t][kk][r] = pack<T>(lo, hi);
            const float2 back = unpack<T>(pa[t][kk][r]);
            lo -= back.x;
            hi -= back.y;
          }
        }
      }
      wgmma_fence();
#pragma unroll
      for (int t = kPTerms - 1; t >= 0; --t) {  // the small terms first
#pragma unroll
        for (int kk = 0; kk < G::kBKV / 16; ++kk) {
          const uint64_t db = make_desc(Vs + s * G::kKVBytes + kk * 16 * G::kRow,
                                        G::kChunkKV, 8 * G::kRow, G::kRow);
          Wgmma<T, HD>::template rs<1>(oacc, pa[t][kk], db, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<HD / 2>(oacc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    float lt = l[i2];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.0f / fmaxf(lt, 1e-30f);
    const int qi = q0 + 64 * g + r0 + 8 * i2;
    // the backward's log-sum-exp (log2 domain), for every row of the
    // padded length gridDim.z * kBQ; +inf where no key is reachable (p = 0)
    if (lse != nullptr && t4 == 0)
      lse[((size_t)b * H + h) * (gridDim.z * kBQ) + qi] =
          lt > 0.0f ? m[i2] + log2f(lt) : INFINITY;
    if (qi >= Sq) continue;
    const size_t row = (((size_t)b * Sq + qi) * H + h) * HD + 2 * t4;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const float x0 = oacc[4 * c + 2 * i2] * inv, x1 = oacc[4 * c + 2 * i2 + 1] * inv;
      const uint32_t hi = pack<T>(x0, x1);
      *reinterpret_cast<uint32_t*>(o + row + 8 * c) = hi;
      if (o_lo != nullptr) {  // what the rounding left, for the backward's D
        const float2 back = unpack<T>(hi);
        *reinterpret_cast<uint32_t*>(o_lo + row + 8 * c) = pack<T>(x0 - back.x, x1 - back.y);
      }
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, void* o_lo, int B, int Sq, int Skv, int H,
                   int KH, float scale, int causal, int window, int q_offset,
                   cudaStream_t stream) {
  using G = Geo<HD>;
  constexpr CUtensorMapDataType type = MapType<T>::v;
  CUtensorMap qm, km, vm;
  const uint64_t qdims[4] = {(uint64_t)HD, (uint64_t)H, (uint64_t)Sq, (uint64_t)B};
  const uint64_t qstr[3] = {(uint64_t)HD * 2, (uint64_t)H * HD * 2,
                            (uint64_t)Sq * H * HD * 2};
  const uint32_t qbox[4] = {(uint32_t)G::kChunkCols, 1, (uint32_t)kBQ, 1};
  const uint64_t kdims[4] = {(uint64_t)HD, (uint64_t)KH, (uint64_t)Skv, (uint64_t)B};
  const uint64_t kstr[3] = {(uint64_t)HD * 2, (uint64_t)KH * HD * 2,
                            (uint64_t)Skv * KH * HD * 2};
  const uint32_t kbox[4] = {(uint32_t)G::kChunkCols, 1, (uint32_t)G::kBKV, 1};
  if (!make_map(&qm, type, 4, q, qdims, qstr, qbox, G::kRow)
      || !make_map(&km, type, 4, k, kdims, kstr, kbox, G::kRow)
      || !make_map(&vm, type, 4, v, kdims, kstr, kbox, G::kRow))
    return cudaErrorInvalidValue;
  // opt in to more than 48 KB of dynamic shared memory once per
  // instantiation, outside any stream capture that follows
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tc<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)G::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  flash_fwd_tc<T, HD><<<grid, kThreads, G::kSmem, stream>>>(
      qm, km, vm, static_cast<T*>(o), lse, static_cast<T*>(o_lo), Sq, Skv, H,
      KH, scale * kLog2e, causal, window, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* o, float* lse, void* o_lo, int B, int Sq, int Skv,
                      int H, int KH, float scale, int causal, int window,
                      int q_offset, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, lse, o_lo, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    case 32: return launch<T, 32>(q, k, v, o, lse, o_lo, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, o_lo, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, o_lo, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    case 96: return launch<T, 96>(q, k, v, o, lse, o_lo, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    case 192: return launch<T, 192>(q, k, v, o, lse, o_lo, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    case 256: return launch<T, 256>(q, k, v, o, lse, o_lo, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// backward (f16 / bf16, head dims 64 and 128): four launches a call
// ---------------------------------------------------------------------------

// Consumer warpgroups of the dK/dV kernel, 64 keys each (a CTA holds
// 64 * kKVGroups keys and both their dK and dV accumulators in
// registers). Measured on an H100 at (2, 2048, 16/2, 128): two
// warpgroups (288 threads, at most 168 registers a thread) spill 724 B
// and serialize their wgmma, 0.8245 ms a backward; one (160 threads, 244
// registers, no spills) takes 0.6071 ms.
constexpr int kKVGroups = 1;
constexpr int kKVThreads = 128 * kKVGroups + 32;  // + one producer warp
// dS (and P in dV += P^T dO) enter the products as two terms in T,
// T(x) + T(x - T(x)), as P does in the forward's P V
constexpr int kSTerms = 2;

// head dims the backward is instantiated for (any other raises)
template <int HD> struct BGeo {
  static_assert(HD == 64 || HD == 128, "backward head dims: 64, 128");
  static constexpr int kRow = 128;                // swizzled row (bytes)
  static constexpr int kChunkCols = 64;           // columns per chunk
  static constexpr int kChunks = HD / kChunkCols;
  static constexpr int kBN = 64;                  // keys per K/V tile (dQ)
  static constexpr int kBM = 64;                  // queries per Q/dO tile (dK/dV)
  static constexpr int kStages = 2;               // ring depth of both kernels
  // dQ kernel: Q and dO of kBQ rows once, then a ring of K/V tiles
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kKVBytes = kBN * HD * 2;
  static constexpr size_t kSmemDQ =
      1024 + 2 * kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 2 * kStages);
  // dK/dV kernel: K and V of kKRows keys once, then a ring of Q/dO tiles
  // and their rows' log-sum-exp and D
  static constexpr int kKRows = 64 * kKVGroups;
  static constexpr int kKBytes = kKRows * HD * 2;
  static constexpr int kMBytes = kBM * HD * 2;
  static constexpr size_t kSmemKV = 1024 + 2 * kKBytes + 2 * kStages * kMBytes
                                    + 2 * kStages * kBM * 4 + 8 * (1 + 2 * kStages);
};

// The row length the forward's log-sum-exp and the backward's D are laid
// out at (B x H x this): Sq padded to the forward's 128-row tiles
__host__ __device__ inline int padded_rows(int Sq) { return (Sq + kBQ - 1) / kBQ * kBQ; }

// two f32 values (adjacent columns of one fragment word) as kSTerms = 2
// packed terms in T: big = T(x), small = T(x - T(x))
static_assert(kSTerms == 2, "split2 writes two terms");
template <typename T>
__device__ __forceinline__ void split2(float lo, float hi, uint32_t& big, uint32_t& small) {
  big = pack<T>(lo, hi);
  const float2 back = unpack<T>(big);
  small = pack<T>(lo - back.x, hi - back.y);
}

// D[b, h, i] = sum_d dO[b, i, h, d] (O + O_lo)[b, i, h, d] in f32, for
// every row of the padded length (0 past Sq): one warp a row
template <typename T, int HD>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ o_lo,
                const T* __restrict__ dout, float* __restrict__ delta, int B,
                int Sq, int H) {
  const int sq_pad = padded_rows(Sq);
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * H * sq_pad) return;
  const int i = (int)(row % sq_pad);
  const long long bh = row / sq_pad;
  const int h = (int)(bh % H), b = (int)(bh / H);
  float acc = 0.0f;
  if (i < Sq) {
    const size_t base = (((size_t)b * Sq + i) * H + h) * HD;
#pragma unroll
    for (int d = 2 * lane; d < HD; d += 64) {
      const float2 x = unpack<T>(*reinterpret_cast<const uint32_t*>(o + base + d));
      const float2 x_lo = unpack<T>(*reinterpret_cast<const uint32_t*>(o_lo + base + d));
      const float2 g = unpack<T>(*reinterpret_cast<const uint32_t*>(dout + base + d));
      acc += g.x * (x.x + x_lo.x) + g.y * (x.y + x_lo.y);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) delta[row] = acc;
}

// dQ: one CTA per (128 query rows, head, batch row), the forward's
// layout: two consumer warpgroups of 64 rows and a producer warp that
// loads Q and dO once and K/V tiles into a ring. A tile: S = Q K^T and
// dP = dO V^T (wgmma, both operands K-major in shared memory),
// P = exp2(S log2e scale - lse), dS = P (dP - D), dQ += dS K (dS in
// registers as two terms, K the MN-major B operand).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tc(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap dmap,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int Sq, int Skv, int H, int KH,
                float scale_log2, float scale, int causal, int window,
                int q_offset) {
  using G = BGeo<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);         // [chunk][kBQ rows][kRow]
  uint8_t* dOs = Qs + G::kQBytes;
  uint8_t* Ks = dOs + G::kQBytes;            // [stage][chunk][kBN rows][kRow]
  uint8_t* Vs = Ks + G::kStages * G::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + G::kStages * G::kKVBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + G::kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // longest tiles first
  const int kh = h / (H / KH);
  const int sq_pad = gridDim.z * kBQ;

  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int t_begin = kv_begin / G::kBN;
  const int n_tiles = kv_end > kv_begin ? (kv_end + G::kBN - 1) / G::kBN - t_begin : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumers / 32) {
    if (lane == 0) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      prefetch_map(&dmap);
      mbar_expect_tx(q_full, 2 * G::kQBytes);
      for (int c = 0; c < G::kChunks; ++c) {
        tma_load_4d(Qs + c * kBQ * G::kRow, &qmap, q_full, c * G::kChunkCols, h, q0, b);
        tma_load_4d(dOs + c * kBQ * G::kRow, &dmap, q_full, c * G::kChunkCols, h, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % G::kStages;
        mbar_wait(&empty[s], ((i / G::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * G::kKVBytes);
        const int kv0 = (t_begin + i) * G::kBN;
        for (int c = 0; c < G::kChunks; ++c) {
          tma_load_4d(Ks + s * G::kKVBytes + c * G::kBN * G::kRow, &kmap, &full[s],
                      c * G::kChunkCols, kh, kv0, b);
          tma_load_4d(Vs + s * G::kKVBytes + c * G::kBN * G::kRow, &vmap, &full[s],
                      c * G::kChunkCols, kh, kv0, b);
        }
      }
    }
    return;
  }

  const int g = warp / 4;
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int t4 = lane % 4;
  const int wg_first = q_offset + q0 + 64 * g;
  const int wg_last = wg_first + 63;
  float row_lse[2], row_d[2];
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    const size_t idx = ((size_t)b * H + h) * sq_pad + q0 + 64 * g + r0 + 8 * i2;
    row_lse[i2] = lse[idx];
    row_d[i2] = delta[idx];
  }

  float dqacc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqacc[i] = 0.0f;

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % G::kStages;
    const int kv0 = (t_begin + i) * G::kBN;
    mbar_wait(&full[s], (i / G::kStages) & 1);
    const bool reached = !(causal && kv0 > wg_last)
                         && !(window > 0 && kv0 + G::kBN - 1 <= wg_first - window);
    if (reached) {
      float sacc[G::kBN / 2], pacc[G::kBN / 2];
#pragma unroll
      for (int j = 0; j < G::kBN / 2; ++j) sacc[j] = pacc[j] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {  // S = Q K^T
        const int c = kk * 16 / G::kChunkCols;
        const int off = (kk * 16 % G::kChunkCols) * 2;
        const uint64_t da = make_desc(Qs + c * kBQ * G::kRow + 64 * g * G::kRow + off,
                                      16, 8 * G::kRow, G::kRow);
        const uint64_t db = make_desc(Ks + s * G::kKVBytes + c * G::kBN * G::kRow + off,
                                      16, 8 * G::kRow, G::kRow);
        Wgmma<T, G::kBN>::template ss<0>(sacc, da, db, kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {  // dP = dO V^T
        const int c = kk * 16 / G::kChunkCols;
        const int off = (kk * 16 % G::kChunkCols) * 2;
        const uint64_t da = make_desc(dOs + c * kBQ * G::kRow + 64 * g * G::kRow + off,
                                      16, 8 * G::kRow, G::kRow);
        const uint64_t db = make_desc(Vs + s * G::kKVBytes + c * G::kBN * G::kRow + off,
                                      16, 8 * G::kRow, G::kRow);
        Wgmma<T, G::kBN>::template ss<0>(pacc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<G::kBN / 2>(sacc);
      fence_regs<G::kBN / 2>(pacc);

      const bool masked = (causal && kv0 + G::kBN - 1 > wg_first) || kv0 + G::kBN > Skv
                          || (window > 0 && kv0 <= wg_last - window);
      // dS = P (dP - D), as two terms in T: the A fragments of dQ += dS K
      uint32_t da_s[kSTerms][G::kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < G::kBN / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i2 = r & 1;
          const int qpos = wg_first + r0 + 8 * i2;
          float ds[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int e = 8 * kk + 2 * r + j;
            float x = sacc[e] * scale_log2 - row_lse[i2];
            if (masked) {
              const int kpos = kv0 + 16 * kk + 8 * (r >> 1) + 2 * t4 + j;
              bool ok = kpos < Skv;
              if (causal) ok = ok && kpos <= qpos;
              if (window > 0) ok = ok && kpos > qpos - window;
              x = ok ? x : -INFINITY;
            }
            ds[j] = exp2f(x) * (pacc[e] - row_d[i2]);
          }
          split2<T>(ds[0], ds[1], da_s[0][kk][r], da_s[1][kk][r]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int t = kSTerms - 1; t >= 0; --t) {  // the small terms first
#pragma unroll
        for (int kk = 0; kk < G::kBN / 16; ++kk) {
          const uint64_t db = make_desc(Ks + s * G::kKVBytes + kk * 16 * G::kRow,
                                        G::kBN * G::kRow, 8 * G::kRow, G::kRow);
          Wgmma<T, HD>::template rs<1>(dqacc, da_s[t][kk], db, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<HD / 2>(dqacc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    const int qi = q0 + 64 * g + r0 + 8 * i2;
    if (qi >= Sq) continue;
    T* dst = dq + (((size_t)b * Sq + qi) * H + h) * HD + 2 * t4;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<uint32_t*>(dst + 8 * c) =
          pack<T>(dqacc[4 * c + 2 * i2] * scale, dqacc[4 * c + 2 * i2 + 1] * scale);
  }
}

// dK, dV: one CTA per (64 kKVGroups keys, query head, batch row), so that
// GQA groups and short batches still fill the card; consumer warpgroup g
// holds keys 64 g .. 64 g + 63 of the CTA. A producer warp loads K and V
// once and then (Q, dO, lse, D) tiles of 64 queries into a ring, only
// those tiles some key of the CTA is reached by. A tile, with keys as
// the accumulator rows: S^T = K Q^T, P^T = exp2(S^T log2e scale - lse),
// dV += P^T dO (P^T two terms in registers, dO the MN-major B operand),
// dP^T = V dO^T, dS^T = P^T (dP^T - D), dK += dS^T Q. With H > KH each
// query head writes f32 partials (dpart), summed over its group in a
// fixed order by flash_bwd_sum_groups; with H == KH the CTA writes T.
template <typename T, int HD>
__global__ void __launch_bounds__(kKVThreads, 1)
flash_bwd_dkdv_tc(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap dmap,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dpart,
                  int B, int Sq, int Skv, int H, int KH, float scale_log2,
                  float scale, int causal, int window, int q_offset) {
  using G = BGeo<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);          // [chunk][kKRows rows][kRow]
  uint8_t* Vs = Ks + G::kKBytes;
  uint8_t* Qs = Vs + G::kKBytes;              // [stage][chunk][kBM rows][kRow]
  uint8_t* dOs = Qs + G::kStages * G::kMBytes;
  float* lse_s = reinterpret_cast<float*>(dOs + G::kStages * G::kMBytes);  // [stage][kBM]
  float* d_s = lse_s + G::kStages * G::kBM;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(d_s + G::kStages * G::kBM);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + G::kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * G::kKRows;  // the first key tiles have the most work
  const int kh = h / (H / KH);
  const int sq_pad = padded_rows(Sq);

  // query rows that reach some key k0 .. k0 + kKRows - 1
  const int i_begin = causal ? max(0, k0 - q_offset) : 0;
  const int i_end = window > 0 ? min(Sq, k0 + G::kKRows - 1 + window - q_offset) : Sq;
  const int t_begin = i_begin / G::kBM;
  const int n_tiles = i_end > i_begin ? (i_end + G::kBM - 1) / G::kBM - t_begin : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kKVGroups * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kKVGroups * 4) {
    if (lane == 0) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      prefetch_map(&dmap);
      mbar_expect_tx(kv_full, 2 * G::kKBytes);
      for (int c = 0; c < G::kChunks; ++c) {
        tma_load_4d(Ks + c * G::kKRows * G::kRow, &kmap, kv_full, c * G::kChunkCols, kh, k0, b);
        tma_load_4d(Vs + c * G::kKRows * G::kRow, &vmap, kv_full, c * G::kChunkCols, kh, k0, b);
      }
      const float* lse_row = lse + ((size_t)b * H + h) * sq_pad;
      const float* d_row = delta + ((size_t)b * H + h) * sq_pad;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % G::kStages;
        mbar_wait(&empty[s], ((i / G::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * G::kMBytes + 2 * G::kBM * 4);
        const int i0 = (t_begin + i) * G::kBM;
        for (int c = 0; c < G::kChunks; ++c) {
          tma_load_4d(Qs + s * G::kMBytes + c * G::kBM * G::kRow, &qmap, &full[s],
                      c * G::kChunkCols, h, i0, b);
          tma_load_4d(dOs + s * G::kMBytes + c * G::kBM * G::kRow, &dmap, &full[s],
                      c * G::kChunkCols, h, i0, b);
        }
        bulk_load(lse_s + s * G::kBM, lse_row + i0, G::kBM * 4, &full[s]);
        bulk_load(d_s + s * G::kBM, d_row + i0, G::kBM * 4, &full[s]);
      }
    }
    return;
  }

  const int g = warp / 4;
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int t4 = lane % 4;
  const int wk_first = k0 + 64 * g;  // this warpgroup's keys
  const int wk_last = wk_first + 63;

  float dkacc[HD / 2], dvacc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dkacc[i] = dvacc[i] = 0.0f;

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % G::kStages;
    const int qt_first = q_offset + (t_begin + i) * G::kBM;  // absolute positions
    const int qt_last = qt_first + G::kBM - 1;
    mbar_wait(&full[s], (i / G::kStages) & 1);
    const bool reached = wk_first < Skv && !(causal && qt_last < wk_first)
                         && !(window > 0 && wk_last <= qt_first - window);
    if (reached) {
      const uint8_t* Qt = Qs + s * G::kMBytes;
      const uint8_t* dOt = dOs + s * G::kMBytes;
      const float* lse_t = lse_s + s * G::kBM;
      const float* d_t = d_s + s * G::kBM;
      float sacc[G::kBM / 2];
#pragma unroll
      for (int j = 0; j < G::kBM / 2; ++j) sacc[j] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {  // S^T = K Q^T
        const int c = kk * 16 / G::kChunkCols;
        const int off = (kk * 16 % G::kChunkCols) * 2;
        const uint64_t da = make_desc(Ks + c * G::kKRows * G::kRow + 64 * g * G::kRow + off,
                                      16, 8 * G::kRow, G::kRow);
        const uint64_t db = make_desc(Qt + c * G::kBM * G::kRow + off, 16, 8 * G::kRow, G::kRow);
        Wgmma<T, G::kBM>::template ss<0>(sacc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<G::kBM / 2>(sacc);

      const bool masked = (causal && qt_first < wk_last) || wk_last >= Skv
                          || (window > 0 && qt_last - window >= wk_first);
      // P^T as two terms in T: the A fragments of dV += P^T dO
      uint32_t pa[kSTerms][G::kBM / 16][4];
#pragma unroll
      for (int kk = 0; kk < G::kBM / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int kpos = wk_first + r0 + 8 * (r & 1);
          float p[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = 16 * kk + 8 * (r >> 1) + 2 * t4 + j;
            float x = sacc[8 * kk + 2 * r + j] * scale_log2 - lse_t[col];
            if (masked) {
              const int qpos = qt_first + col;
              bool ok = kpos < Skv;
              if (causal) ok = ok && kpos <= qpos;
              if (window > 0) ok = ok && kpos > qpos - window;
              x = ok ? x : -INFINITY;
            }
            p[j] = exp2f(x);
          }
          split2<T>(p[0], p[1], pa[0][kk][r], pa[1][kk][r]);
        }
      }
      float pacc[G::kBM / 2];
#pragma unroll
      for (int j = 0; j < G::kBM / 2; ++j) pacc[j] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int t = kSTerms - 1; t >= 0; --t) {  // dV += P^T dO, small terms first
#pragma unroll
        for (int kk = 0; kk < G::kBM / 16; ++kk) {
          const uint64_t db = make_desc(dOt + kk * 16 * G::kRow, G::kBM * G::kRow,
                                        8 * G::kRow, G::kRow);
          Wgmma<T, HD>::template rs<1>(dvacc, pa[t][kk], db, 1);
        }
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {  // dP^T = V dO^T
        const int c = kk * 16 / G::kChunkCols;
        const int off = (kk * 16 % G::kChunkCols) * 2;
        const uint64_t da = make_desc(Vs + c * G::kKRows * G::kRow + 64 * g * G::kRow + off,
                                      16, 8 * G::kRow, G::kRow);
        const uint64_t db = make_desc(dOt + c * G::kBM * G::kRow + off, 16, 8 * G::kRow, G::kRow);
        Wgmma<T, G::kBM>::template ss<0>(pacc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<HD / 2>(dvacc);
      fence_regs<G::kBM / 2>(pacc);

      // dS^T = P^T (dP^T - D), P^T from its two terms, as two terms in T
      uint32_t dsa[kSTerms][G::kBM / 16][4];
#pragma unroll
      for (int kk = 0; kk < G::kBM / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int col = 16 * kk + 8 * (r >> 1) + 2 * t4;
          float2 p = unpack<T>(pa[0][kk][r]);
          const float2 p_small = unpack<T>(pa[1][kk][r]);
          p.x += p_small.x;
          p.y += p_small.y;
          split2<T>(p.x * (pacc[8 * kk + 2 * r] - d_t[col]),
                    p.y * (pacc[8 * kk + 2 * r + 1] - d_t[col + 1]),
                    dsa[0][kk][r], dsa[1][kk][r]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int t = kSTerms - 1; t >= 0; --t) {  // dK += dS^T Q
#pragma unroll
        for (int kk = 0; kk < G::kBM / 16; ++kk) {
          const uint64_t db = make_desc(Qt + kk * 16 * G::kRow, G::kBM * G::kRow,
                                        8 * G::kRow, G::kRow);
          Wgmma<T, HD>::template rs<1>(dkacc, dsa[t][kk], db, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<HD / 2>(dkacc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t part = (size_t)B * Skv * H * HD;  // one of dpart's two halves
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    const int kj = wk_first + r0 + 8 * i2;
    if (kj >= Skv) continue;
    if (dpart == nullptr) {
      const size_t row = (((size_t)b * Skv + kj) * KH + kh) * HD + 2 * t4;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        *reinterpret_cast<uint32_t*>(dk + row + 8 * c) =
            pack<T>(dkacc[4 * c + 2 * i2] * scale, dkacc[4 * c + 2 * i2 + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + row + 8 * c) =
            pack<T>(dvacc[4 * c + 2 * i2], dvacc[4 * c + 2 * i2 + 1]);
      }
    } else {
      const size_t row = (((size_t)b * Skv + kj) * H + h) * HD + 2 * t4;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        *reinterpret_cast<float2*>(dpart + row + 8 * c) =
            make_float2(dkacc[4 * c + 2 * i2] * scale, dkacc[4 * c + 2 * i2 + 1] * scale);
        *reinterpret_cast<float2*>(dpart + part + row + 8 * c) =
            make_float2(dvacc[4 * c + 2 * i2], dvacc[4 * c + 2 * i2 + 1]);
      }
    }
  }
}

// dK and dV of a GQA group: the sum of its G query heads' f32 partials,
// in head order (bit-equal from call to call), rounded to T once.
// blockIdx.y: 0 dK, 1 dV; a thread takes two adjacent columns.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_sum_groups(const float* __restrict__ dpart, T* __restrict__ dk,
                     T* __restrict__ dv, long long rows, int G, int HD) {
  const long long pair = (long long)blockIdx.x * 256 + threadIdx.x;
  if (pair >= rows * (HD / 2)) return;
  const long long r = pair / (HD / 2);    // (b, key, kh)
  const int d = 2 * (int)(pair % (HD / 2));
  const float* src = dpart + (size_t)blockIdx.y * rows * G * HD + (size_t)r * G * HD + d;
  float2 acc = make_float2(0.0f, 0.0f);
  for (int j = 0; j < G; ++j) {
    const float2 x = *reinterpret_cast<const float2*>(src + (size_t)j * HD);
    acc.x += x.x;
    acc.y += x.y;
  }
  T* dst = blockIdx.y == 0 ? dk : dv;
  *reinterpret_cast<uint32_t*>(dst + (size_t)r * HD + d) = pack<T>(acc.x, acc.y);
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* o_lo, const void* dout,
                       const float* lse, float* delta, void* dq, void* dk,
                       void* dv, float* dpart, int B, int Sq, int Skv, int H,
                       int KH, float scale, int causal, int window,
                       int q_offset, cudaStream_t stream) {
  using G = BGeo<HD>;
  constexpr CUtensorMapDataType type = MapType<T>::v;
  const int sq_pad = padded_rows(Sq);
  const uint64_t qdims[4] = {(uint64_t)HD, (uint64_t)H, (uint64_t)Sq, (uint64_t)B};
  const uint64_t qstr[3] = {(uint64_t)HD * 2, (uint64_t)H * HD * 2,
                            (uint64_t)Sq * H * HD * 2};
  const uint64_t kdims[4] = {(uint64_t)HD, (uint64_t)KH, (uint64_t)Skv, (uint64_t)B};
  const uint64_t kstr[3] = {(uint64_t)HD * 2, (uint64_t)KH * HD * 2,
                            (uint64_t)Skv * KH * HD * 2};
  // the dQ kernel's maps: Q / dO boxes of kBQ rows, K / V of kBN; the dK/dV
  // kernel's: Q / dO boxes of kBM rows, K / V of kKRows
  const uint32_t q_box_dq[4] = {(uint32_t)G::kChunkCols, 1, (uint32_t)kBQ, 1};
  const uint32_t k_box_dq[4] = {(uint32_t)G::kChunkCols, 1, (uint32_t)G::kBN, 1};
  const uint32_t q_box_kv[4] = {(uint32_t)G::kChunkCols, 1, (uint32_t)G::kBM, 1};
  const uint32_t k_box_kv[4] = {(uint32_t)G::kChunkCols, 1, (uint32_t)G::kKRows, 1};
  CUtensorMap qm1, km1, vm1, dm1, qm2, km2, vm2, dm2;
  if (!make_map(&qm1, type, 4, q, qdims, qstr, q_box_dq, G::kRow)
      || !make_map(&dm1, type, 4, dout, qdims, qstr, q_box_dq, G::kRow)
      || !make_map(&km1, type, 4, k, kdims, kstr, k_box_dq, G::kRow)
      || !make_map(&vm1, type, 4, v, kdims, kstr, k_box_dq, G::kRow)
      || !make_map(&qm2, type, 4, q, qdims, qstr, q_box_kv, G::kRow)
      || !make_map(&dm2, type, 4, dout, qdims, qstr, q_box_kv, G::kRow)
      || !make_map(&km2, type, 4, k, kdims, kstr, k_box_kv, G::kRow)
      || !make_map(&vm2, type, 4, v, kdims, kstr, k_box_kv, G::kRow))
    return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_tc<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmemDQ);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dkdv_tc<T, HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmemKV);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const float scale_log2 = scale * kLog2e;
  const long long rows = (long long)B * H * sq_pad;
  flash_bwd_delta<T, HD><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(o_lo),
      static_cast<const T*>(dout), delta, B, Sq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_tc<T, HD><<<dim3(H, B, sq_pad / kBQ), kThreads, G::kSmemDQ, stream>>>(
      qm1, km1, vm1, dm1, lse, delta, static_cast<T*>(dq), Sq, Skv, H, KH,
      scale_log2, scale, causal, window, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bool grouped = H != KH;
  flash_bwd_dkdv_tc<T, HD><<<dim3(H, B, (Skv + G::kKRows - 1) / G::kKRows), kKVThreads,
                             G::kSmemKV, stream>>>(
      qm2, km2, vm2, dm2, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      grouped ? dpart : nullptr, B, Sq, Skv, H, KH, scale_log2, scale, causal,
      window, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess || !grouped) return err;
  const long long kv_rows = (long long)B * Skv * KH;
  flash_bwd_sum_groups<T><<<dim3((unsigned)((kv_rows * (HD / 2) + 255) / 256), 2), 256, 0,
                            stream>>>(dpart, static_cast<T*>(dk), static_cast<T*>(dv),
                                      kv_rows, H / KH, HD);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_hd(int hd, const void* q, const void* k, const void* v,
                          const void* o, const void* o_lo, const void* dout,
                          const float* lse, float* delta, void* dq, void* dk,
                          void* dv, float* dpart, int B, int Sq, int Skv, int H,
                          int KH, float scale, int causal, int window,
                          int q_offset, cudaStream_t s) {
  switch (hd) {
    case 64: return launch_bwd<T, 64>(q, k, v, o, o_lo, dout, lse, delta, dq, dk, dv, dpart, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    case 128: return launch_bwd<T, 128>(q, k, v, o, o_lo, dout, lse, delta, dq, dk, dv, dpart, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// dynamic shared memory (bytes) of the tensor-core body at head dim hd
extern "C" int flash_attention_wgmma_smem(int hd) {
  switch (hd) {
    case 16: return (int)tc::Geo<16>::kSmem;
    case 32: return (int)tc::Geo<32>::kSmem;
    case 64: return (int)tc::Geo<64>::kSmem;
    case 128: return (int)tc::Geo<128>::kSmem;
    case 96: return (int)tc::Geo<96>::kSmem;
    case 192: return (int)tc::Geo<192>::kSmem;
    case 256: return (int)tc::Geo<256>::kSmem;
    default: return 0;
  }
}

// The f32 FMA body. window <= 0 means no window. Returns the
// cudaGetLastError() after the launch.
extern "C" int flash_attention_fma(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Skv, int H,
                                   int KH, int hd, float scale, int causal,
                                   int window, int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KH <= 0 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  return (int)launch_hd<float>(hd, q, k, v, o, B, Sq, Skv, H, KH, scale, causal,
                               window, q_offset, static_cast<cudaStream_t>(stream));
}

// The tensor-core body; dtype codes: 1 = f16, 2 = bf16. q, k, v need
// 16-byte aligned bases (TMA). Returns the cudaGetLastError() after the
// launch, or cudaErrorInvalidValue if a tensor map cannot be made.
// lse (f32, B x H x Sq padded up to a multiple of 128) and o_lo (as o)
// may be null; where given, the kernel writes the backward's log-sum-exp
// and the output's second term T(o - T(o)).
extern "C" int flash_attention_wgmma(int dtype, const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     void* o_lo, int B, int Sq, int Skv, int H,
                                     int KH, int hd, float scale, int causal,
                                     int window, int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KH <= 0 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 1: return (int)tc::launch_hd<__half>(hd, q, k, v, o, l, o_lo, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    case 2: return (int)tc::launch_hd<__nv_bfloat16>(hd, q, k, v, o, l, o_lo, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward of the tensor-core body at head dims 64 and 128 (dtype
// codes as above): dq, dk, dv (as q, k, v) from q, k, v, the forward's o,
// o_lo and lse, and dout (as o), all contiguous with 16-byte aligned
// bases. Scratch: delta (f32, B x H x Sq padded up to a multiple of 128)
// and, where H > KH, dpart (f32, 2 x B x Skv x H x hd); dpart may be null
// where H == KH. Four launches on the stream (three where H == KH);
// returns the first error, or cudaErrorInvalidValue for another head dim
// or a tensor map that cannot be made.
extern "C" int flash_attention_bwd_wgmma(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* o_lo, const void* dout, const void* lse, void* delta, void* dq,
    void* dk, void* dv, void* dpart, int B, int Sq, int Skv, int H, int KH,
    int hd, float scale, int causal, int window, int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KH <= 0 || H % KH != 0
      || (H != KH && dpart == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  float* part = static_cast<float*>(dpart);
  switch (dtype) {
    case 1: return (int)tc::launch_bwd_hd<__half>(hd, q, k, v, o, o_lo, dout, l, d, dq, dk, dv, part, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    case 2: return (int)tc::launch_bwd_hd<__nv_bfloat16>(hd, q, k, v, o, o_lo, dout, l, d, dq, dk, dv, part, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
