// Mamba-2 SSD chunk recurrence (forward, from a zero state), Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (`_kernel`,
// launched by `ssd_scan`'s pallas_call). For x (B, S, H, P), dt (B, S, H),
// a (H,), b and c (B, S, N), all f32, it walks the sequence in chunks of
// L steps and, with cum the inclusive cumulative sum of dt * a inside the
// chunk, computes for every row i of the chunk
//
//   y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) (C_i . h)
//
// and then carries the (P, N) state to the next chunk,
//
//   h <- exp(cum_{L-1}) h + sum_l exp(cum_{L-1} - cum_l) dt_l x_l B_l^T.
//
// y is written per row and the final h once. Rows past S load dt = 0 and
// x = B = C = 0 (guards, no padded copies), which leaves h unchanged, so
// h_last equals the reference's zero-padded result.
//
// What bounds it on an H100: at the held-out evaluation's shape of
// Mamba2-370m (B 8, S 1024, H 32, P 64, N 128, L 64) a call must move
// 152.0 MB (x and y 67.1 MB each, b and c 4.2 MB each, dt 1 MB, h_last
// 8.4 MB), 0.045 ms at 3.35 TB/s, and do 9.75 GFLOP of least work
// (C . B^T once per batch row and chunk and the rest per head, causal
// pairs only). On the tensor cores in 3xTF32 (below) that is 3 x 9.75
// GFLOP, 0.059 ms at 495 TFLOP/s TF32: the operations bound it, as they
// did on the f32 FMA units (0.146 ms at 67 TFLOP/s).
//
// Precision. The scan is f32 in and f32 out and is held to 1e-4 of the
// largest output. One TF32 product (10-bit mantissa) misses that by about
// 6x at Mamba's rates, so every product is taken as 3xTF32: each operand
// v is split once, as it is staged, into hi = tf32(v) and lo = tf32(v -
// hi), and a.b is summed as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b (the small
// terms first) by three mma.sync.m16n8k8 TF32 instructions into f32
// accumulators; lo_a.lo_b (~2^-22 relative) is dropped. The decays
// exp(cum_i - cum_j), the dt weights, the causal mask and cum itself stay
// in f32 on the CUDA cores (cum by a warp shuffle scan, as before).
//
// Design. Two grids on one stream:
// 1. ssd_cb_tc, one block per (chunk, batch row): CB = C . B^T (L x L,
//    K = N), the causal tiles only, written to f32 scratch (B, chunks, 64,
//    64) that the wrapper allocates (2.1 MB at the shape above). C . B^T
//    does not depend on the head, so it is computed once, not per head.
// 2. ssd_scan_tc, one block of 8 warps per (P tile of 64 columns, head,
//    batch row), 256 blocks at the shape above, two resident per SM (97 KB
//    of shared memory each), so all run in one wave. The TPU kernel's
//    sequential chunk axis is a loop inside the block; the state h never
//    leaves the block until the final store: it lives in the state
//    update's mma accumulators (32 registers a thread), and each chunk
//    its hi/lo split is staged in shared memory for the next chunk's
//    C . h^T. Per chunk:
//    a. stage x^T (64 x L) as hi/lo in shared memory, h's hi/lo from the
//       accumulators; warp 0 takes cum, w_l = exp(cum_{L-1} - cum_l) dt_l
//       and exp(cum_i);
//    b. y (L x 64) = S . x + (exp(cum) C) . h^T with S_ij = CB_ij
//       exp(cum_i - cum_j) dt_j for j <= i: the A fragments of S and of
//       exp(cum) C are built in registers from CB and C (read through L2,
//       which all 32 heads share) and split there, once per element and
//       warp; only the k-steps that reach the diagonal are taken;
//    c. h <- exp(cum_{L-1}) h + x^T . (w B): A fragments of x^T from the
//       staged x^T, B fragments of w B built from B (L2) and split.
//    The reduction index of every product is permuted (a sum does not
//    care about the order of its terms): within each pair of 8-deep
//    k-steps, lane t of a quad takes the 4 consecutive indices 4t .. 4t +
//    3. So a thread's fragment elements are contiguous: C, CB and the
//    staged x^T and h come as 16-byte loads, and every global load uses
//    whole 32-byte sectors. Shared memory rows of odd index are stored
//    with bit 4 of the column flipped (an XOR swizzle), so that these
//    16-byte loads are free of bank conflicts without padding.
#include <math.h>

#include "hopper.cuh"

namespace {

// the 3xTF32 mma.sync helpers (to_tf32, split, mma3, the fragments)
using namespace hopper;

constexpr int kThreads = 256;  // 8 warps
constexpr int kL = 64;         // max chunk length (rows of a chunk tile)
constexpr int kPT = 64;        // head_dim columns per block
constexpr int kN = 128;        // max state width

constexpr size_t kSmemWords = 2 * (size_t)kPT * kL    // x^T hi, lo
                              + 2 * (size_t)kPT * kN  // h hi, lo
                              + 4 * (size_t)kL + 4;   // dt, cum, w, exp(cum), exp(cum_{L-1})
constexpr size_t kSmemBytes = kSmemWords * 4;

// word offset of (row r, column c) of a row-major shared memory array
// with rows of `ld` words: odd rows have bit 4 of the column flipped
template <int ld>
__device__ __forceinline__ int sw(int r, int c) {
  return r * ld + (c ^ ((r & 1) << 4));
}

// columns n .. n + 3 (n a multiple of 4) of row i (< rows) of a (B, S, N)
// matrix inside the chunk; zero past the chunk's rows and past N
__device__ __forceinline__ float4 ld4_bc(const float* __restrict__ m, size_t row0,
                                         int rows, int N, int i, int n) {
  if (i >= rows) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float* r = m + (row0 + i) * N;
  if ((N & 3) == 0)
    return n < N ? __ldg(reinterpret_cast<const float4*>(r + n))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return make_float4(n < N ? __ldg(r + n) : 0.0f, n + 1 < N ? __ldg(r + n + 1) : 0.0f,
                     n + 2 < N ? __ldg(r + n + 2) : 0.0f,
                     n + 3 < N ? __ldg(r + n + 3) : 0.0f);
}

__device__ __forceinline__ float ld_bc(const float* __restrict__ m, size_t row0,
                                       int rows, int N, int i, int n) {
  return (i < rows && n < N) ? __ldg(m + (row0 + i) * N + n) : 0.0f;
}

// ---------------------------------------------------------------------------
// 1. CB[b, z] = C . B^T of chunk z of batch row b (causal tiles only)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ssd_cb_tc(const float* __restrict__ bm, const float* __restrict__ cm,
          float* __restrict__ cb, int S, int N, int L) {
  const int z = blockIdx.x, bb = blockIdx.y, nc = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % 4, wn = warp / 4;  // rows 16 wm .., columns 32 wn ..
  const int s0 = z * L;
  const int rows = min(L, S - s0);
  const size_t row0 = (size_t)bb * S + s0;
  const int i0 = 16 * wm + g;
  float acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[q][r] = 0.0f;
  const int npairs = (N + 15) / 16;
#pragma unroll 2
  for (int kk = 0; kk < npairs; ++kk) {
    const int n = 16 * kk + 4 * t;
    FragA fa;
    frag_a(ld4_bc(cm, row0, rows, N, i0, n), ld4_bc(cm, row0, rows, N, i0 + 8, n), fa);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j0 = 32 * wn + 8 * q;
      if (j0 > 16 * wm + 15) continue;  // above the diagonal: never read
      FragB fb;
      frag_b(ld4_bc(bm, row0, rows, N, j0 + g, n), fb);
      mma3_pair(acc[q], fa, fb);
    }
  }
  float* dst = cb + ((size_t)bb * nc + z) * kL * kL;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j0 = 32 * wn + 8 * q;
    if (j0 > 16 * wm + 15) continue;
    *reinterpret_cast<float2*>(dst + i0 * kL + j0 + 2 * t) = make_float2(acc[q][0], acc[q][1]);
    *reinterpret_cast<float2*>(dst + (i0 + 8) * kL + j0 + 2 * t) =
        make_float2(acc[q][2], acc[q][3]);
  }
}

// ---------------------------------------------------------------------------
// 2. the chunk recurrence, one block per (P tile, head, batch row)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_tc(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ a, const float* __restrict__ bm,
            const float* __restrict__ cm, const float* __restrict__ cb,
            float* __restrict__ y, float* __restrict__ h_last, int S, int H,
            int P, int N, int L) {
  extern __shared__ uint32_t smem[];
  uint32_t* Xhi = smem;                 // (kPT, kL): x^T[p][l], swizzled
  uint32_t* Xlo = Xhi + kPT * kL;
  uint32_t* Hhi = Xlo + kPT * kL;       // (kPT, kN): h[p][n], swizzled
  uint32_t* Hlo = Hhi + kPT * kN;
  float* dts = reinterpret_cast<float*>(Hlo + kPT * kN);  // (kL,)
  float* cum = dts + kL;                // (kL,)
  float* wst = cum + kL;                // exp(cum_{L-1} - cum_l) dt_l
  float* eout = wst + kL;               // exp(cum_l)
  float* dec = eout + kL;               // exp(cum_{L-1})

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int p0 = blockIdx.x * kPT;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int pt = min(kPT, P - p0);
  const float ah = a[hh];
  const int nc = (S + L - 1) / L;
  const int npairs_n = (N + 15) / 16;
  // state tiling: rows p 32 sm .., columns n 32 sn ..; y tiling: rows i
  // 16 ym .., columns p 32 yn ..
  const int sm = warp % 2, sn = warp / 2;
  const int ym = warp % 4, yn = warp / 4;

  float hacc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) hacc[mt][q][r] = 0.0f;

  for (int z = 0; z < nc; ++z) {
    const int s0 = z * L;
    const int rows = min(L, S - s0);
    const size_t row0 = (size_t)bb * S + s0;  // first (b, s) row of the chunk

    // ---- a. stage: h (from the accumulators), x^T, the chunk's decays ----
    if (z > 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2) {
            const int p = 32 * sm + 16 * mt + g + 8 * r2;
            const int o = sw<kN>(p, 32 * sn + 8 * q + 2 * t);
            uint2 hi, lo;
            split(hacc[mt][q][2 * r2], hi.x, lo.x);
            split(hacc[mt][q][2 * r2 + 1], hi.y, lo.y);
            *reinterpret_cast<uint2*>(Hhi + o) = hi;
            *reinterpret_cast<uint2*>(Hlo + o) = lo;
          }
    }
    // x rows l (consecutive lanes) of 4 columns each -> x^T
    for (int idx = tid; idx < kL * kPT / 4; idx += kThreads) {
      const int l = idx % kL, pc = 4 * (idx / kL);
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (l < rows) {
        const float* src = x + ((row0 + l) * H + hh) * (size_t)P + p0 + pc;
        if ((P & 3) == 0) {
          if (pc < pt) {
            const float4 f = __ldg(reinterpret_cast<const float4*>(src));
            v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) v[c] = pc + c < pt ? __ldg(src + c) : 0.0f;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int o = sw<kL>(pc + c, l);
        split(v[c], Xhi[o], Xlo[o]);
      }
    }
    if (warp == 0) {
      const float d0 = lane < rows ? __ldg(dt + (row0 + lane) * H + hh) : 0.0f;
      const float d1 = lane + 32 < rows ? __ldg(dt + (row0 + lane + 32) * H + hh) : 0.0f;
      float v0 = d0 * ah, v1 = d1 * ah;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, v0, off);
        const float u1 = __shfl_up_sync(0xffffffffu, v1, off);
        if (lane >= off) { v0 += u0; v1 += u1; }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      // rows past the chunk add 0, so cum at row 63 is cum_{L-1}
      const float last = __shfl_sync(0xffffffffu, v1, 31);
      dts[lane] = d0;
      dts[lane + 32] = d1;
      cum[lane] = v0;
      cum[lane + 32] = v1;
      wst[lane] = expf(last - v0) * d0;
      wst[lane + 32] = expf(last - v1) * d1;
      eout[lane] = expf(v0);
      eout[lane + 32] = expf(v1);
      if (lane == 0) dec[0] = expf(last);
    }
    __syncthreads();

    // ---- b. y = S . x + (exp(cum) C) . h^T ------------------------------
    if (16 * ym < rows) {
      const int i0 = 16 * ym + g;
      float yacc[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) yacc[q][r] = 0.0f;
      // S . x over the k-step pairs that reach the diagonal
      {
        const float* cbz = cb + ((size_t)bb * nc + z) * kL * kL;
        const float c0 = cum[i0], c1 = cum[i0 + 8];
        const int kmax = min(ym + 1, (rows + 15) / 16);
#pragma unroll
        for (int kk = 0; kk < kL / 16; ++kk) {
          if (kk >= kmax) break;
          const int j = 16 * kk + 4 * t;
          const float4 cb0 = *reinterpret_cast<const float4*>(cbz + i0 * kL + j);
          const float4 cb1 = *reinterpret_cast<const float4*>(cbz + (i0 + 8) * kL + j);
          const float4 cj = *reinterpret_cast<const float4*>(cum + j);
          const float4 dj = *reinterpret_cast<const float4*>(dts + j);
          // S_ij = CB_ij exp(cum_i - cum_j) dt_j for j <= i, else 0
          const float4 s0 = make_float4(
              j <= i0 ? cb0.x * expf(c0 - cj.x) * dj.x : 0.0f,
              j + 1 <= i0 ? cb0.y * expf(c0 - cj.y) * dj.y : 0.0f,
              j + 2 <= i0 ? cb0.z * expf(c0 - cj.z) * dj.z : 0.0f,
              j + 3 <= i0 ? cb0.w * expf(c0 - cj.w) * dj.w : 0.0f);
          const float4 s1 = make_float4(
              j <= i0 + 8 ? cb1.x * expf(c1 - cj.x) * dj.x : 0.0f,
              j + 1 <= i0 + 8 ? cb1.y * expf(c1 - cj.y) * dj.y : 0.0f,
              j + 2 <= i0 + 8 ? cb1.z * expf(c1 - cj.z) * dj.z : 0.0f,
              j + 3 <= i0 + 8 ? cb1.w * expf(c1 - cj.w) * dj.w : 0.0f);
          FragA fa;
          frag_a(s0, s1, fa);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int o = sw<kL>(32 * yn + 8 * q + g, j);
            FragB fb;
            frag_b_staged(*reinterpret_cast<const uint4*>(Xhi + o),
                          *reinterpret_cast<const uint4*>(Xlo + o), fb);
            mma3_pair(yacc[q], fa, fb);
          }
        }
      }
      // (exp(cum) C) . h^T over N (the incoming state; zero in chunk 0)
      if (z > 0) {
        const float e0 = eout[i0], e1 = eout[i0 + 8];
#pragma unroll 4
        for (int kk = 0; kk < npairs_n; ++kk) {
          const int n = 16 * kk + 4 * t;
          float4 v0 = ld4_bc(cm, row0, rows, N, i0, n);
          float4 v1 = ld4_bc(cm, row0, rows, N, i0 + 8, n);
          v0.x *= e0; v0.y *= e0; v0.z *= e0; v0.w *= e0;
          v1.x *= e1; v1.y *= e1; v1.z *= e1; v1.w *= e1;
          FragA fa;
          frag_a(v0, v1, fa);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int o = sw<kN>(32 * yn + 8 * q + g, n);
            FragB fb;
            frag_b_staged(*reinterpret_cast<const uint4*>(Hhi + o),
                          *reinterpret_cast<const uint4*>(Hlo + o), fb);
            mma3_pair(yacc[q], fa, fb);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = 32 * yn + 8 * q + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + 8 * half;
          if (i >= rows) continue;
          float* dst = y + ((row0 + i) * H + hh) * (size_t)P + p0 + p;
          if (p + 1 < pt) {
            if ((P & 1) == 0) {
              *reinterpret_cast<float2*>(dst) =
                  make_float2(yacc[q][2 * half], yacc[q][2 * half + 1]);
            } else {
              dst[0] = yacc[q][2 * half];
              dst[1] = yacc[q][2 * half + 1];
            }
          } else if (p < pt) {
            dst[0] = yacc[q][2 * half];
          }
        }
      }
    }

    // ---- c. h <- exp(cum_{L-1}) h + x^T . (w B) --------------------------
    {
      const float dz = dec[0];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r) hacc[mt][q][r] *= dz;
      const int npairs_l = (rows + 15) / 16;
#pragma unroll 2
      for (int kk = 0; kk < npairs_l; ++kk) {
        const int l = 16 * kk + 4 * t;
        const float4 w = *reinterpret_cast<const float4*>(wst + l);
        FragB fb[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = 32 * sn + 8 * q + g;
          frag_b(make_float4(ld_bc(bm, row0, rows, N, l, n) * w.x,
                             ld_bc(bm, row0, rows, N, l + 1, n) * w.y,
                             ld_bc(bm, row0, rows, N, l + 2, n) * w.z,
                             ld_bc(bm, row0, rows, N, l + 3, n) * w.w),
                 fb[q]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int p = 32 * sm + 16 * mt + g;
          const int o0 = sw<kL>(p, l), o1 = sw<kL>(p + 8, l);
          FragA fa;
          frag_a_staged(*reinterpret_cast<const uint4*>(Xhi + o0),
                        *reinterpret_cast<const uint4*>(Xhi + o1),
                        *reinterpret_cast<const uint4*>(Xlo + o0),
                        *reinterpret_cast<const uint4*>(Xlo + o1), fa);
#pragma unroll
          for (int q = 0; q < 4; ++q) mma3_pair(hacc[mt][q], fa, fb[q]);
        }
      }
    }
    __syncthreads();  // every read of this chunk's x, h and decays is done
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = 32 * sm + 16 * mt + g + 8 * (r / 2);
        const int n = 32 * sn + 8 * q + 2 * t + (r % 2);
        if (p < pt && n < N)
          h_last[(((size_t)bb * H + hh) * P + p0 + p) * N + n] = hacc[mt][q][r];
      }
}

}  // namespace

// x (B, S, H, P), dt (B, S, H), a (H,), b and c (B, S, N), y (B, S, H, P)
// and h_last (B, H, P, N): f32, contiguous, on one device; cb is f32
// scratch of B * ceil(S / chunk) * 64 * 64 floats. chunk <= 64, N <= 128,
// any P (split over blocks of 64 columns), any S. Returns the
// cudaGetLastError() after the launches.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* b, const void* c, void* cb, void* y,
                               void* h_last, int B, int S, int H, int P,
                               int N, int chunk, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || N > kN ||
      chunk <= 0 || chunk > kL || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (S + chunk - 1) / chunk;
  ssd_cb_tc<<<dim3(nc, B), kThreads, 0, s>>>(
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<float*>(cb), S, N, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + kPT - 1) / kPT, H, B);
  ssd_scan_tc<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(cb),
      static_cast<float*>(y), static_cast<float*>(h_last), S, H, P, N, chunk);
  return (int)cudaGetLastError();
}

// dynamic shared memory (bytes) of the chunk recurrence's blocks
extern "C" int ssd_scan_smem() { return (int)kSmemBytes; }
