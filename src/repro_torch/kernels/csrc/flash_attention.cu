// Causal GQA flash attention (forward), Hopper.
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
             int Sq, int Skv, int H, int KH, float scale_log2, int causal,
             int window, int q_offset) {
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
    if (qi >= Sq) continue;
    T* dst = o + (((size_t)b * Sq + qi) * H + h) * HD + 2 * t4;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<uint32_t*>(dst + 8 * c) =
          pack<T>(oacc[4 * c + 2 * i2] * inv, oacc[4 * c + 2 * i2 + 1] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Skv, int H, int KH, float scale, int causal,
                   int window, int q_offset, cudaStream_t stream) {
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
      qm, km, vm, static_cast<T*>(o), Sq, Skv, H, KH,
      scale * 1.4426950408889634f, causal, window, q_offset);
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
extern "C" int flash_attention_wgmma(int dtype, const void* q, const void* k,
                                     const void* v, void* o, int B, int Sq,
                                     int Skv, int H, int KH, int hd,
                                     float scale, int causal, int window,
                                     int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KH <= 0 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return (int)tc::launch_hd<__half>(hd, q, k, v, o, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    case 2: return (int)tc::launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
