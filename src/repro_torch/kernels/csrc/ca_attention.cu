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
// All arithmetic is f32 whatever the storage type (f32, f16 or bf16); the
// output is written in the storage type. K and V are never formed: the
// products reassociate,
//
//   <q, K_i>        = <hist_i, u>        with u    = wk q / sqrt(C)  (Dp,)
//   sum_i w_i V_i   = hbar @ wv          with hbar = sum_i w_i hist_i
//
// What bounds it on an H100: at the SAC update shape (B = 128, obs_dim 28,
// pair_dim 52, I = 4, C = 64, f32) one call must move 203 776 B, 0.061 us
// at 3.35 TB/s, and its least work is 0.023 us at the f32 FMA rate. Both
// are far below the time of launching a kernel (the launch floor, an empty
// kernel by CUDA-graph replay, is measured beside it by chip_smoke.py), so
// the call is bound by latency: one round trip to memory, and the
// instructions each warp issues one after another. Per-phase clock stamps
// of a CTA showed three costs beside the round trip: instruction fetch
// (every launch fetches the kernel's code anew and most of it runs once,
// so code size is time: unrolled loops and inlined copies made it slower),
// exposed latency (with one warp per scheduler nothing hides a load), and
// the ~10 instructions of a cvt.rna.tf32 split.
//
// Design, one CTA of 16 warps per tile of kRows = 16 batch rows (one mma
// row tile; 32 and 64 rows measured slower):
// 1. Staging in one round trip. Lane 0 of each warp issues 1-D bulk
//    asynchronous copies (cp.async.bulk) of some of the tile's obs, mask
//    and history rows and of wq_s, wk and wv, and arrives on one mbarrier
//    expecting their bytes; no registers, no per-element addresses. A
//    region whose address is not 16-byte aligned lands at the same offset
//    mod 16 in its shared memory slot; its (at most 15-byte) head and tail
//    are copied by plain loads of the issuing lane, the middle by the bulk
//    copy. Only obs is converted (to f32, one pass); every other operand is
//    read where it landed, in its storage type.
// 2. The three products on the tensor cores as 3xTF32 mma.sync.m16n8k8:
//    q = obs wq_s, u = q wk^T / sqrt(C) and s' = hbar wv, one 16 x 8
//    output tile per warp, all three from one copy of the code. Each value
//    is widened to f32 and split in registers (split_rz: hi = v with the
//    low 13 mantissa bits cleared, lo = v - hi, two instructions); a.b is
//    lo.hi + hi.lo + hi.hi in three accumulators (one TF32 pass would miss
//    the f32 gate of 1e-5), the next k-step's values read while the
//    current ones are multiplied. The f32 intermediates q, u and hbar have
//    row strides of 4 mod 8 words, so an A fragment's 32 reads hit 32
//    banks.
// 3. The two per-row mat-vecs on the CUDA cores, a warp per row: scores
//    <hist_i, u> four pairs at a time (partial sums over p = lane, lane +
//    32, ..., xor-shuffle reductions that leave every lane all four), the
//    -FLT_MAX mask of the reference and an online softmax over the groups
//    (the running hbar rescaled as flash attention rescales O), so rows
//    with no valid pair give exactly zero and masked pairs weight zero.
// 4. [obs, s'] written by coalesced stores in the storage type.
// Shapes of any size: where the weights and a tile's rows do not fit in
// the 227 KB a CTA may use, the plan (ca_attention_plan) streams the
// weights in chunks of rows (k-chunks accumulate in shared memory) and the
// history in chunks of pairs, with the fewest round trips.
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

// Built with -DCA_STAMPS (chip_smoke.py's phase breakdown), thread 0 of
// CTA 0 records clock64() at the phase boundaries CA_STAMP(0..7) marks;
// otherwise the marks compile to nothing.
#ifdef CA_STAMPS
__device__ long long ca_stamps[8];
#define CA_STAMP(i) \
  do { if (threadIdx.x == 0 && blockIdx.x == 0) ca_stamps[i] = clock64(); } while (0)
extern "C" int ca_attention_stamps(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, ca_stamps, sizeof(ca_stamps));
}
#else
#define CA_STAMP(i) \
  do {} while (0)
#endif

namespace {

using namespace hopper;

constexpr int kThreads = 512;             // 16 warps
constexpr int kRows = 16;                 // batch rows per CTA: one mma row tile
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;        // 227 KB, the most a CTA may use

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ int pad_to(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ __forceinline__ int cdiv(int x, int m) { return (x + m - 1) / m; }

// bytes of a shared memory slot for a region of `bytes`: 16-byte granules
// plus room to keep the source's offset mod 16
__host__ __device__ __forceinline__ int slot_bytes(int bytes) { return pad_to(bytes, 16) + 16; }

// row stride (words) of an f32 operand of `cols` columns read as an mma A
// fragment: 4 mod 8, so rows g = 0..7 and columns t = 0..3 hit 32 banks
__host__ __device__ __forceinline__ int a_stride(int cols) { return pad_to(cols, 8) + 4; }

// The plan of one launch: shapes, the staging and streaming choices, and
// the byte offsets of every shared memory region.
struct Plan {
  int R, Do, Dp, I, C, es;
  int ldx, ldq, ldu, ldh;       // row strides (words) of obs in f32, q (and s'), u, hbar
  int wrows, nq, nk, nchunks;   // weight rows per chunk; chunks of wq_s, of wk (= of wv)
  int ichunk;                   // history pairs staged at a time
  int raw_cap;                  // bytes of one stage of weight chunks
  int o_x, o_q, o_u, o_hb, o_ml;                // f32 work arrays
  int o_obs_raw, o_mask_raw, o_hist_raw, hslot;  // raw rows; bytes per history row
  int o_wraw, smem;
  int stages;
};

// chunk j: matrix (0 wq_s, 1 wk, 2 wv), its first row and its rows
__host__ __device__ __forceinline__ void chunk_of(const Plan& p, int j, int& mat,
                                                  int& row0, int& rows) {
  mat = 0;
  if (j >= p.nq) {
    j -= p.nq;
    mat = 1;
    if (j >= p.nk) { j -= p.nk; mat = 2; }
  }
  row0 = j * p.wrows;
  rows = imin(p.wrows, (mat == 0 ? p.Do : p.Dp) - row0);
}

__host__ __device__ __forceinline__ int chunk_bytes(const Plan& p, int rows) {
  return slot_bytes(rows * p.C * p.es);
}

// one past the last chunk of the stage that starts at chunk j
__host__ __device__ __forceinline__ int stage_end(const Plan& p, int j) {
  int raw = 0, e = j;
  while (e < p.nchunks) {
    int mat, row0, rows;
    chunk_of(p, e, mat, row0, rows);
    const int r = chunk_bytes(p, rows);
    if (e > j && raw + r > p.raw_cap) break;
    raw += r;
    ++e;
  }
  return e;
}

// lay out shared memory for the given choices; false if it exceeds 227 KB
bool lay_out(Plan& p, int Do, int Dp, int I, int C, int es, int wrows, int ichunk) {
  const int R = kRows;
  p.R = R; p.Do = Do; p.Dp = Dp; p.I = I; p.C = C; p.es = es;
  p.ldx = a_stride(Do); p.ldq = a_stride(C); p.ldu = a_stride(Dp); p.ldh = a_stride(Dp);
  p.wrows = wrows;
  p.nq = cdiv(Do, wrows);
  p.nk = cdiv(Dp, wrows);
  p.nchunks = p.nq + 2 * p.nk;
  p.ichunk = ichunk;
  size_t o = 16;  // two mbarriers
  auto take = [&](size_t bytes) { const size_t at = o; o = (o + bytes + 15) / 16 * 16; return (int)at; };
  p.o_x = take(4ull * R * p.ldx);
  p.o_q = take(4ull * R * p.ldq);
  p.o_u = take(4ull * R * p.ldu);
  p.o_hb = take(4ull * R * p.ldh);
  p.o_ml = take(4ull * 3 * R);
  p.o_obs_raw = take(slot_bytes(R * Do * es));
  p.o_mask_raw = take(slot_bytes(R * I * es));
  p.hslot = slot_bytes(ichunk * Dp * es);
  p.o_hist_raw = take(ichunk == I ? slot_bytes(R * I * Dp * es) : (size_t)R * p.hslot);
  if (o >= (size_t)kSmemLimit) return false;
  if (wrows >= Do && wrows >= Dp) {  // every matrix whole: one stage
    p.raw_cap = slot_bytes(Do * C * es) + 2 * slot_bytes(Dp * C * es);
  } else {  // the rest of shared memory; stages take as many chunks as fit
    p.raw_cap = (kSmemLimit - (int)o) / 16 * 16 - 16;
    if (slot_bytes(wrows * C * es) > p.raw_cap) return false;
  }
  p.o_wraw = take(p.raw_cap);
  p.smem = (int)o;
  p.stages = 0;
  for (int j = 0; j < p.nchunks; j = stage_end(p, j)) ++p.stages;
  return o <= (size_t)kSmemLimit;
}

// The plan with the fewest round trips (weight stages plus extra history
// chunks) that fits; ties go to larger history chunks. False if even the
// smallest chunks do not fit (the f32 work arrays of R rows alone).
bool make_plan(Plan& best, int Do, int Dp, int I, int C, int es) {
  int best_cost = -1;
  const int whole = imax(Do, Dp);
  for (int ic = I;; ic = cdiv(ic, 2)) {
    Plan p;
    bool ok = lay_out(p, Do, Dp, I, C, es, whole, ic);
    for (int w = pad_to(whole, 8) - 8; !ok && w >= 8; w -= 8)
      ok = lay_out(p, Do, Dp, I, C, es, w, ic);
    const int cost = p.stages + cdiv(I, ic) - 1;
    if (ok && (best_cost < 0 || cost < best_cost)) { best = p; best_cost = cost; }
    if (ic == 1) break;
  }
  return best_cost >= 0;
}

// v = hi + lo exactly, hi with the low 13 mantissa bits cleared (a TF32
// value), lo = v - hi (exact in f32, at most 2^-10 |v|). The tensor cores
// read a TF32 operand's top 19 bits, so lo enters its product truncated to
// 10 mantissa bits, ~2^-21 |v|: the 3xTF32 sum stays within ~2^-20 of the
// f32 product. Two instructions, where cvt.rna.tf32 takes about ten.
__device__ __forceinline__ void split_rz(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

template <typename T> struct BitsOf { using type = uint32_t; };
template <> struct BitsOf<__half> { using type = uint16_t; };
template <> struct BitsOf<__nv_bfloat16> { using type = uint16_t; };

// A region to stage: `bytes` at global `src` into the shared memory slot
// `slot` (slot_bytes(bytes) long), landing at slot + (src mod 16).
struct Region {
  uint8_t* slot;
  const uint8_t* src;
  int bytes;
};

__device__ __forceinline__ int misalign(const void* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) & 15);
}

// the bytes of a region that go by the bulk copy (the 16-byte granules)
__device__ __forceinline__ int bulk_part(const Region& r, int& head) {
  head = imin((16 - misalign(r.src)) & 15, r.bytes);
  return (r.bytes - head) & ~15;
}

// stage one region: plain loads for its head and tail, the bulk copy for
// the rest (completing on bar)
template <typename T>
__device__ __forceinline__ void copy_region(const Region& r, uint64_t* bar) {
  using B = typename BitsOf<T>::type;
  uint8_t* dst = r.slot + misalign(r.src);
  int head;
  const int bulk = bulk_part(r, head);
#pragma unroll 1
  for (int o = 0; o < head; o += (int)sizeof(B))
    *reinterpret_cast<B*>(dst + o) = *reinterpret_cast<const B*>(r.src + o);
  if (bulk > 0) bulk_load(dst + head, r.src + head, (uint32_t)bulk, bar);
#pragma unroll 1
  for (int o = head + bulk; o < r.bytes; o += (int)sizeof(B))
    *reinterpret_cast<B*>(dst + o) = *reinterpret_cast<const B*>(r.src + o);
}

// The CTA stages regions 0 .. n - 1 (region(j) gives each) on bar: lane 0
// of warp w takes the regions j = w (mod kWarps), so the copies go out from
// all warps at once (a bulk copy takes warp-uniform operands: one lane of
// many would serialise them), and arrives once, expecting their bulk
// bytes; the barrier's phase needs one arrival from every warp.
template <typename T, typename F>
__device__ __forceinline__ void stage_regions(int n, F region, uint64_t* bar, int warp,
                                              int lane) {
  if (lane != 0) return;
  int bytes = 0;
  for (int j = warp; j < n; j += kWarps) {
    int head;
    bytes += bulk_part(region(j), head);
  }
  mbar_expect_tx(bar, (uint32_t)bytes);
  for (int j = warp; j < n; j += kWarps) copy_region<T>(region(j), bar);
}

// out[r][n] (= or +=) scale * sum_k A[r][k] B(k, n) for r < 16 mtiles, n < N
// and k < K, in 3xTF32: A f32 in shared memory (rows of lda words, zero or
// finite past column K up to K rounded up to 8, where B is zero), B the
// staged weights in their storage type at w[k * sk + n * sn], out f32
// (rows of ldo >= N rounded up to 8 words). The kernel calls this from one
// place for all three products, and its loops stay rolled: every
// instruction of a launch is fetched anew, so code size is time. A warp
// takes one 16 x 8 output tile at a time; each value is widened to f32
// and split in registers (split_rz); lo.hi, hi.lo and hi.hi go to
// separate accumulators, and the next k-step's values are read from
// shared memory while the current ones are split and multiplied.
// Fragments (g = lane / 4, t = lane % 4): a = (g, t), (g + 8, t), (g, t +
// 4), (g + 8, t + 4); b = (t, g), (t + 4, g); d = (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
template <typename T>
__device__ __forceinline__ void product(const float* A, int lda, int K, const T* w, int sk,
                                        int sn, int N, float* out, int ldo, float scale,
                                        bool accumulate, int mtiles, int warp, int lane) {
  const int g = lane / 4, t = lane % 4;
  const int ntiles = cdiv(N, 8), ksteps = cdiv(K, 8);
#pragma unroll 1
  for (int it = warp; it < mtiles * ntiles; it += kWarps) {
    int mt = 0, nt = it;
    while (nt >= ntiles) { nt -= ntiles; ++mt; }
    const int n0 = 8 * nt, r = 16 * mt + g, n = n0 + g;
    // the fragment values of the next k-step: A's columns past K are zero
    // (or meet zero B rows), B is zero outside its matrix
    const float* a0 = A + r * lda + t;
    const float* a1 = a0 + 8 * lda;
    const T* bp = w + t * sk + n * sn;
    int k = t;
    auto load = [&](float* av, float* bv) {
      av[0] = a0[0];
      av[1] = a1[0];
      av[2] = a0[4];
      av[3] = a1[4];
      bv[0] = k < K && n < N ? to_float(bp[0]) : 0.0f;
      bv[1] = k + 4 < K && n < N ? to_float(bp[4 * sk]) : 0.0f;
      a0 += 8;
      a1 += 8;
      bp += 8 * sk;
      k += 8;
    };
    // d[term]: lo.hi, hi.lo and hi.hi in separate accumulators; the next
    // k-step's values are read while this one's are split and multiplied
    float d[3][4] = {};
    float av[4], bv[2];
    load(av, bv);
#pragma unroll 1
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t ahi[4], alo[4], bhi[2], blo[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_rz(av[i], ahi[i], alo[i]);
      split_rz(bv[0], bhi[0], blo[0]);
      split_rz(bv[1], bhi[1], blo[1]);
      if (ks + 1 < ksteps) load(av, bv);
      mma_tf32(d[0], alo, bhi);
      mma_tf32(d[1], ahi, blo);
      mma_tf32(d[2], ahi, bhi);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float2* o = reinterpret_cast<float2*>(out + (r + 8 * half) * ldo + n0 + 2 * t);
      float v[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 2 * half + j;
        // the small terms first, as one accumulator would have summed them
        v[j] = ((d[0][e] + d[1][e]) + d[2][e]) * scale;
      }
      if (accumulate) {
        const float2 old = *o;
        v[0] += old.x;
        v[1] += old.y;
      }
      *o = make_float2(v[0], v[1]);
    }
  }
}

// One staged chunk of ic history pairs (from pair i0) of the per-row
// attention, a warp a row (rows warp, warp + kWarps, ... < R), in groups of
// 4 pairs: the scores <hist_i, u> (partial sums per lane over p = lane,
// lane + 32, ..., reduced by xor shuffles, so every lane holds all 4), the
// mask (-FLT_MAX), and an online softmax update of (m, l, any valid) and of
// the unnormalised hbar, which is divided by l after the last pair. Rows
// past the batch compute on whatever their shared memory holds and are
// never stored.
template <typename T>
__device__ __forceinline__ void attend_chunk(const uint8_t* hist_raw, int hslot, bool whole,
                                             const uint8_t* hist_src, const T* mask, int R,
                                             int I, int Dp, int i0, int ic, const float* s_u,
                                             int ldu, float* s_hb, int ldh, float* ml,
                                             int warp, int lane) {
#pragma unroll 1
  for (int r = warp; r < R; r += kWarps) {
    // pair i0 of row r
    const T* hp = whole
        ? reinterpret_cast<const T*>(hist_raw + misalign(hist_src)) + ((size_t)r * I + i0) * Dp
        : reinterpret_cast<const T*>(hist_raw + r * hslot
                                     + misalign(hist_src + ((size_t)r * I + i0) * Dp * sizeof(T)));
    const float* u = s_u + r * ldu;
    float* hb = s_hb + r * ldh;
    float m = ml[3 * r], l = ml[3 * r + 1];
    bool any = ml[3 * r + 2] != 0.0f;
#pragma unroll 1
    for (int i = 0; i < ic; i += 4) {
      const int nj = imin(4, ic - i);
      const T* h0 = hp + i * Dp;
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
      for (int q = lane; q < Dp; q += 32) {
        const float uq = u[q];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nj) part[j] = fmaf(to_float(h0[j * Dp + q]), uq, part[j]);
      }
      float m_new = m;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part[j] += __shfl_xor_sync(0xffffffffu, part[j], off);
        const bool valid = j < nj && to_float(mask[r * I + i0 + i + j]) > 0.0f;
        any |= valid;
        part[j] = valid ? part[j] : -FLT_MAX;
        if (j < nj) m_new = fmaxf(m_new, part[j]);
      }
      const float corr = expf(m - m_new);  // 0 for the first group
      float e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j] = j < nj ? expf(part[j] - m_new) : 0.0f;
      l = l * corr + ((e[0] + e[1]) + (e[2] + e[3]));
      m = m_new;
#pragma unroll 1
      for (int q = lane; q < Dp; q += 32) {
        float h = hb[q] * corr;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nj) h = fmaf(e[j], to_float(h0[j * Dp + q]), h);
        hb[q] = h;
      }
    }
    if (i0 + ic == I) {  // the last pair: hbar /= l, or exactly 0 without a valid pair
      const float inv = any ? 1.0f / l : 0.0f;
#pragma unroll 1
      for (int q = lane; q < Dp; q += 32) hb[q] = any ? hb[q] * inv : 0.0f;
    } else if (lane == 0) {
      ml[3 * r] = m;
      ml[3 * r + 1] = l;
      ml[3 * r + 2] = any ? 1.0f : 0.0f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ca_attention_tc(const T* __restrict__ obs, const T* __restrict__ hist,
                const T* __restrict__ mask, const T* __restrict__ wq_s,
                const T* __restrict__ wk, const T* __restrict__ wv,
                T* __restrict__ out, int B, float scale, const Plan plan) {
  extern __shared__ __align__(128) uint8_t smem[];
  const Plan p = plan;  // a local copy: its fields stay in registers
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem);  // rows + weight stages
  uint64_t* hbar_bar = wbar + 1;                       // later history chunks
  float* s_x = reinterpret_cast<float*>(smem + p.o_x);    // obs in f32
  float* s_q = reinterpret_cast<float*>(smem + p.o_q);    // q, then s'
  float* s_u = reinterpret_cast<float*>(smem + p.o_u);
  float* s_hb = reinterpret_cast<float*>(smem + p.o_hb);
  float* s_ml = reinterpret_cast<float*>(smem + p.o_ml);  // per row: m, l, any valid
  uint8_t* obs_raw = smem + p.o_obs_raw;
  uint8_t* mask_raw = smem + p.o_mask_raw;
  uint8_t* hist_raw = smem + p.o_hist_raw;
  uint8_t* wraw = smem + p.o_wraw;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int R = p.R, Do = p.Do, Dp = p.Dp, I = p.I, C = p.C, es = p.es;
  const int b0 = blockIdx.x * R;
  const int nrows = imin(R, B - b0);
  const bool hist_whole = p.ichunk == I;

  const uint8_t* obs_src = reinterpret_cast<const uint8_t*>(obs + (size_t)b0 * Do);
  const uint8_t* mask_src = reinterpret_cast<const uint8_t*>(mask + (size_t)b0 * I);
  const uint8_t* hist_src = reinterpret_cast<const uint8_t*>(hist + (size_t)b0 * I * Dp);
  const T* o_raw = reinterpret_cast<const T*>(obs_raw + misalign(obs_src));
  const T* m_raw = reinterpret_cast<const T*>(mask_raw + misalign(mask_src));
  auto weight_src = [&](int mat, int row0) {
    const T* w = mat == 0 ? wq_s : mat == 1 ? wk : wv;
    return reinterpret_cast<const uint8_t*>(w + (size_t)row0 * C);
  };
  // region j of the weight stage that starts at chunk j0
  auto weight_region = [&](int j0, int j) {
    int off = 0, mat, row0, rows;
    for (int e = j0; e < j; ++e) {
      chunk_of(p, e, mat, row0, rows);
      off += chunk_bytes(p, rows);
    }
    chunk_of(p, j, mat, row0, rows);
    return Region{wraw + off, weight_src(mat, row0), rows * C * es};
  };
  // history pairs [i0, i0 + ic) of row r (or the whole tile's history)
  auto hist_region = [&](int i0, int ic, int r) {
    if (hist_whole) return Region{hist_raw, hist_src, nrows * I * Dp * es};
    return Region{hist_raw + r * p.hslot, hist_src + ((size_t)r * I + i0) * Dp * es,
                  ic * Dp * es};
  };

  CA_STAMP(0);  // start
  if (tid == 0) {
    mbar_init(wbar, kWarps);
    mbar_init(hbar_bar, kWarps);
    fence_barrier_init();
  }
  __syncthreads();

  // round 0: obs, mask, the first history chunk and the first weight stage
  int st_begin = 0, st_end = stage_end(p, 0);
  const int n_hist0 = hist_whole ? 1 : nrows;
  stage_regions<T>(2 + n_hist0 + st_end, [&](int j) {
    if (j == 0) return Region{obs_raw, obs_src, nrows * Do * es};
    if (j == 1) return Region{mask_raw, mask_src, nrows * I * es};
    if (j < 2 + n_hist0) return hist_region(0, p.ichunk, j - 2);
    return weight_region(0, j - 2 - n_hist0);
  }, wbar, warp, lane);
  // while the copies fly: zero the running hbar and set the softmax state
#pragma unroll 1
  for (int i = tid; i < R * p.ldh; i += kThreads) s_hb[i] = 0.0f;
#pragma unroll 1
  for (int r = tid; r < R; r += kThreads) {
    s_ml[3 * r] = -INFINITY;
    s_ml[3 * r + 1] = 0.0f;
    s_ml[3 * r + 2] = 0.0f;
  }
  uint32_t wphase = 0, hphase = 0;
  mbar_wait(wbar, wphase);
  wphase ^= 1;
  __syncthreads();  // the issuing lanes' plain head/tail stores are visible too
  CA_STAMP(1);  // staged
#pragma unroll 1
  for (int r = warp; r < R; r += kWarps)
#pragma unroll 1
    for (int c = lane; c < p.ldx; c += 32)
      s_x[r * p.ldx + c] = r < nrows && c < Do ? to_float(o_raw[r * Do + c]) : 0.0f;

  int prev_mat = -1;
  while (st_begin < p.nchunks) {
    int raw_off = 0;
    for (int j = st_begin; j < st_end; ++j) {
      int mat, row0, rows;
      chunk_of(p, j, mat, row0, rows);
      const T* w = reinterpret_cast<const T*>(wraw + raw_off + misalign(weight_src(mat, row0)));
      raw_off += chunk_bytes(p, rows);
      if (mat != prev_mat) {
        __syncthreads();  // the last product is whole (obs in f32 before the first)
        CA_STAMP(2 + mat);  // 2 obs in f32, 3 q, 4 u
      }
      if (mat == 2 && prev_mat == 1) {
        // the attention over the history, in chunks of pairs
        for (int i0 = 0; i0 < I; i0 += p.ichunk) {
          const int ic = imin(p.ichunk, I - i0);
          if (i0 > 0) {
            __syncthreads();  // the previous chunk is consumed
            stage_regions<T>(nrows, [&](int r) { return hist_region(i0, ic, r); }, hbar_bar,
                             warp, lane);
            mbar_wait(hbar_bar, hphase);
            hphase ^= 1;
            __syncthreads();
          }
          attend_chunk<T>(hist_raw, p.hslot, hist_whole, hist_src, m_raw, R, I, Dp, i0, ic,
                          s_u, p.ldu, s_hb, p.ldh, s_ml, warp, lane);
        }
        __syncthreads();
        CA_STAMP(5);  // attention
      }
      prev_mat = mat;
      // q (+)= obs[:, row0 ..] wq_s[row0 .., :];
      // u[:, row0 ..] = q wk[row0 .., :]^T / sqrt(C);
      // s' (+)= hbar[:, row0 ..] wv[row0 .., :]
      const bool by_rows = mat != 1;  // the chunk's rows are k (wq_s, wv) or n (wk)
      product<T>(mat == 0 ? s_x + row0 : mat == 1 ? s_q : s_hb + row0,
                 mat == 0 ? p.ldx : mat == 1 ? p.ldq : p.ldh, by_rows ? rows : C, w,
                 by_rows ? C : 1, by_rows ? 1 : C, by_rows ? C : rows,
                 mat == 1 ? s_u + row0 : s_q, mat == 1 ? p.ldu : p.ldq,
                 mat == 1 ? scale : 1.0f, mat != 1 && row0 > 0, R / 16, warp, lane);
    }
    __syncthreads();  // the stage's weights are consumed
    st_begin = st_end;
    if (st_begin < p.nchunks) {
      st_end = stage_end(p, st_begin);
      fence_proxy_async();
      const int j0 = st_begin;
      stage_regions<T>(st_end - j0, [&](int j) { return weight_region(j0, j0 + j); }, wbar,
                       warp, lane);
      mbar_wait(wbar, wphase);
      wphase ^= 1;
      __syncthreads();
    }
  }

  CA_STAMP(6);  // s'
  // [obs, s'] in the storage type
#pragma unroll 1
  for (int r = warp; r < nrows; r += kWarps) {
    T* dst = out + (size_t)(b0 + r) * (Do + C);
#pragma unroll 1
    for (int c = lane; c < Do + C; c += 32)
      dst[c] = c < Do ? o_raw[r * Do + c] : from_f32<T>(s_q[r * p.ldq + c - Do]);
  }
#ifdef CA_STAMPS
  __syncthreads();
  CA_STAMP(7);  // written
#endif
}

__global__ void empty_kernel() {}

template <typename T>
cudaError_t launch(const void* obs, const void* hist, const void* mask,
                   const void* wq_s, const void* wk, const void* wv, void* out,
                   int B, float scale, const Plan& p, cudaStream_t stream) {
  // opt in to the most dynamic shared memory once per instantiation,
  // outside any stream capture that follows
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ca_attention_tc<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int grid = cdiv(B, p.R);
  ca_attention_tc<T><<<grid, kThreads, p.smem, stream>>>(
      static_cast<const T*>(obs), static_cast<const T*>(hist),
      static_cast<const T*>(mask), static_cast<const T*>(wq_s),
      static_cast<const T*>(wk), static_cast<const T*>(wv),
      static_cast<T*>(out), B, scale, p);
  return cudaGetLastError();
}

int elem_size(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

extern "C" {

// The plan of a launch: info = {dynamic shared memory bytes, weight rows
// per chunk, history pairs per chunk, weight stages}. Returns 0 if no plan
// fits (the f32 work arrays of a CTA's rows alone exceed 227 KB), else 1.
int ca_attention_plan(int dtype, int Do, int Dp, int I, int C, int* info) {
  if (Do <= 0 || Dp <= 0 || I <= 0 || C <= 0) return 0;
  Plan p;
  if (!make_plan(p, Do, Dp, I, C, elem_size(dtype))) return 0;
  info[0] = p.smem;
  info[1] = p.wrows;
  info[2] = p.ichunk;
  info[3] = p.stages;
  return 1;
}

// dtype: 0 = f32, 1 = f16, 2 = bf16. All tensors contiguous, row-major:
// obs (B, Do), hist (B, I, Dp), mask (B, I), wq_s (Do, C), wk/wv (Dp, C),
// out (B, Do + C). Returns the cudaError_t of the launch (0 = success).
int ca_attention_launch(int dtype, const void* obs, const void* hist,
                        const void* mask, const void* wq_s, const void* wk,
                        const void* wv, void* out, int B, int Do, int Dp, int I,
                        int C, float scale, void* stream) {
  if (B <= 0 || Do <= 0 || Dp <= 0 || I <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  if (!make_plan(p, Do, Dp, I, C, elem_size(dtype))) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(obs, hist, mask, wq_s, wk, wv, out, B, scale, p, s);
    case 1: return (int)launch<__half>(obs, hist, mask, wq_s, wk, wv, out, B, scale, p, s);
    case 2: return (int)launch<__nv_bfloat16>(obs, hist, mask, wq_s, wk, wv, out, B, scale, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One launch of an empty kernel on the stream: the floor that any launch
// of this library pays, for timing beside the kernel.
int ca_attention_floor_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
