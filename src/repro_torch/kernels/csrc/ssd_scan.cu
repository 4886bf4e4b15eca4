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
// pairs only), 0.146 ms at the 67 TFLOP/s f32 rate outside the tensor
// cores: the operations bound it.
//
// Design (simple and right first). The TPU kernel's sequential chunk grid
// axis, with h in VMEM scratch, becomes a loop inside one block: one
// block of 256 threads per (P tile of 64 columns, head, batch row), 256
// blocks at the shape above. The state h (64 x N f32), the chunk's B and
// C (L x N), x (L x 64) and the L x L score tile live in shared memory
// (130 KB at N = 128, L = 64, through the dynamic shared memory opt-in);
// h never leaves the block until the final store. Per chunk: stage
// x, dt, B, C; one warp takes cum by a shuffle scan; the score tile
// (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i; y from the score tile
// and the incoming state; then h in place, each thread owning a 4 x 8
// patch of it. Every product is a 4 x 4 (4 x 8 for h) register tile on
// the f32 FMA units; rows of B, C and h are padded to N + 1 floats so the
// lane-per-row reads are free of bank conflicts. C . B^T is recomputed per
// head (and per P tile) over the whole L x L tile, 4.3 GFLOP above the
// least work at the shape above; tensor cores (TF32 mma/wgmma) are later
// work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kL = 64;         // max chunk length
constexpr int kPT = 64;        // head_dim columns per block
constexpr int kN = 128;        // max state width
constexpr int kLdN = kN + 1;   // padded row stride of B, C and h
constexpr int kLdS = kL + 1;   // padded row stride of the score tile

constexpr size_t kSmemFloats = (size_t)kPT * kLdN   // h
                               + 2 * (size_t)kL * kLdN  // B, C
                               + (size_t)kL * kPT       // x
                               + (size_t)kL * kLdS      // scores
                               + 4 * (size_t)kL;        // dt, cum, w, exp(cum)
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

__global__ void __launch_bounds__(kThreads)
ssd_scan_fwd(const float* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ a, const float* __restrict__ bm,
             const float* __restrict__ cm, float* __restrict__ y,
             float* __restrict__ h_last, int S, int H, int P, int N, int L) {
  extern __shared__ float smem[];
  float* Hs = smem;                       // (kPT, kLdN)
  float* Bs = Hs + kPT * kLdN;            // (kL, kLdN)
  float* Cs = Bs + kL * kLdN;             // (kL, kLdN)
  float* Xs = Cs + kL * kLdN;             // (kL, kPT)
  float* Ss = Xs + kL * kPT;              // (kL, kLdS)
  float* dts = Ss + kL * kLdS;            // (kL,)
  float* cum = dts + kL;                  // (kL,)
  float* wst = cum + kL;                  // exp(cum_{L-1} - cum_l) dt_l
  float* eout = wst + kL;                 // exp(cum_l)

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int p0 = blockIdx.x * kPT;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int pt = min(kPT, P - p0);
  const float ah = a[hh];
  const size_t row0 = (size_t)bb * S;  // first (b, s) row

  for (int i = tid; i < kPT * kLdN; i += kThreads) Hs[i] = 0.0f;

  for (int s0 = 0; s0 < S; s0 += L) {
    // ---- stage the chunk (rows past S read as zero) ----------------------
    for (int idx = tid; idx < L * kPT; idx += kThreads) {
      const int l = idx / kPT, p = idx % kPT;
      const int s = s0 + l;
      Xs[idx] = (s < S && p < pt)
                    ? x[((row0 + s) * H + hh) * (size_t)P + p0 + p] : 0.0f;
    }
    for (int idx = tid; idx < L * N; idx += kThreads) {
      const int l = idx / N, n = idx % N;
      const int s = s0 + l;
      const bool ok = s < S;
      Bs[l * kLdN + n] = ok ? bm[(row0 + s) * N + n] : 0.0f;
      Cs[l * kLdN + n] = ok ? cm[(row0 + s) * N + n] : 0.0f;
    }
    if (tid < L) {
      const int s = s0 + tid;
      dts[tid] = s < S ? dt[(row0 + s) * H + hh] : 0.0f;
    }
    __syncthreads();

    // ---- cum: inclusive scan of dt * a over the chunk (warp 0) -----------
    if (tid < 32) {
      float v0 = tid < L ? dts[tid] * ah : 0.0f;
      float v1 = tid + 32 < L ? dts[tid + 32] * ah : 0.0f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t0 = __shfl_up_sync(0xffffffffu, v0, off);
        const float t1 = __shfl_up_sync(0xffffffffu, v1, off);
        if (tid >= off) { v0 += t0; v1 += t1; }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      if (tid < L) cum[tid] = v0;
      if (tid + 32 < L) cum[tid + 32] = v1;
    }
    __syncthreads();
    if (tid < L) {
      wst[tid] = expf(cum[L - 1] - cum[tid]) * dts[tid];
      eout[tid] = expf(cum[tid]);
    }

    // ---- score tile: (C_i . B_j) exp(cum_i - cum_j) dt_j, j <= i ---------
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * kLdN + n];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = Bs[(tx + 16 * q) * kLdN + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(cv[r], bv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = tx + 16 * q;
          float v = 0.0f;
          if (j <= i && i < L) v = acc[r][q] * expf(cum[i] - cum[j]) * dts[j];
          Ss[i * kLdS + j] = v;
        }
      }
    }
    __syncthreads();

    // ---- y = scores @ x + exp(cum_i) (C @ h^T) ---------------------------
    {
      float ad[4][4], ao[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) { ad[r][q] = 0.0f; ao[r][q] = 0.0f; }
      for (int j = 0; j < L; ++j) {
        float sv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) sv[r] = Ss[(ty + 16 * r) * kLdS + j];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = Xs[j * kPT + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) ad[r][q] = fmaf(sv[r], xv[q], ad[r][q]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * kLdN + n];
#pragma unroll
        for (int q = 0; q < 4; ++q) hv[q] = Hs[(tx + 16 * q) * kLdN + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) ao[r][q] = fmaf(cv[r], hv[q], ao[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        const int s = s0 + i;
        if (i >= L || s >= S) continue;
        const float e = eout[i];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = tx + 16 * q;
          if (p < pt)
            y[((row0 + s) * H + hh) * (size_t)P + p0 + p] = ad[r][q] + ao[r][q] * e;
        }
      }
    }
    __syncthreads();  // every read of the incoming h is done

    // ---- h <- exp(cum_{L-1}) h + (x * w)^T @ B, a 4 x 8 patch per thread --
    {
      const float dec = expf(cum[L - 1]);
      float acc[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = 0.0f;
      for (int l = 0; l < L; ++l) {
        const float w = wst[l];
        float xv[4], bv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) xv[r] = Xs[l * kPT + ty + 16 * r] * w;
#pragma unroll
        for (int q = 0; q < 8; ++q) bv[q] = Bs[l * kLdN + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(xv[r], bv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = ty + 16 * r;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int n = tx + 16 * q;
          if (n < N) {
            float* hp = &Hs[p * kLdN + n];
            *hp = fmaf(*hp, dec, acc[r][q]);
          }
        }
      }
    }
    __syncthreads();  // h is whole again; the chunk's buffers may be reused
  }

  for (int idx = tid; idx < pt * N; idx += kThreads) {
    const int p = idx / N, n = idx % N;
    h_last[(((size_t)bb * H + hh) * P + p0 + p) * N + n] = Hs[p * kLdN + n];
  }
}

}  // namespace

// x (B, S, H, P), dt (B, S, H), a (H,), b and c (B, S, N), y (B, S, H, P)
// and h_last (B, H, P, N): f32, contiguous, on one device. chunk <= 64,
// N <= 128, any P (split over blocks of 64 columns), any S. Returns the
// cudaGetLastError() after the launch.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* b, const void* c, void* y,
                               void* h_last, int B, int S, int H, int P,
                               int N, int chunk, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || N > kN ||
      chunk <= 0 || chunk > kL || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((P + kPT - 1) / kPT, H, B);
  ssd_scan_fwd<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(y),
      static_cast<float*>(h_last), S, H, P, N, chunk);
  return (int)cudaGetLastError();
}
