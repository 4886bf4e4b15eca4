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
// in f32 whatever T is (inputs are converted exactly; the probabilities
// are never rounded to T before p @ v, as in kernels/ref.py
// flash_attention_ref, the function this matches), and writes o in T.
// GQA reads kv head h / (H / KH) in place: no repeated K/V is formed.
//
// What bounds it on an H100: at the evaluation shape (B = 8, S = 1024,
// H = 16, KH = 2, hd = 128, bf16, causal) a call must move 75.5 MB
// (q, k, v, o once each), 0.023 ms at 3.35 TB/s, and do 34.4 GFLOP over
// the causally reachable (query, key) pairs, 0.035 ms at the bf16 tensor
// core rate of 989 TFLOP/s: the operations bound it.
//
// Design (simple and right first): one block of 256 threads per
// (query tile of 64 rows, head, batch row), walking 64-key tiles with an
// online softmax (running max m, sum l, accumulator acc) in registers.
// The query tile and each K/V tile are staged in shared memory as f32
// (K with an odd row stride so the lane-per-key dot products are free of
// bank conflicts); the block's 64x64 probability tile goes through shared
// memory to the p @ v product. Key tiles past the causal diagonal of the
// block's last row, and before the window of its first row, are never
// visited. Rows and keys past Sq / Skv take guards, so any ragged length
// works. All products run on the f32 FMA units, not the tensor cores; a
// wgmma/TMA version is later work.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBKV = 64;       // keys per tile
constexpr int kThreads = 256;  // 16 x 16: 4 rows x (64/16 keys | hd/16 dims) each
constexpr int kLdP = kBKV + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

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
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// head dims the kernel is instantiated for
extern "C" int flash_attention_supports_head_dim(int hd) {
  return hd == 16 || hd == 32 || hd == 64 || hd == 128;
}

// dtype codes: 0 = f32, 1 = f16, 2 = bf16. window <= 0 means no window.
// Returns the cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int KH, int hd,
                                      float scale, int causal, int window,
                                      int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KH <= 0 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_hd<float>(hd, q, k, v, o, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    case 1: return (int)launch_hd<__half>(hd, q, k, v, o, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    case 2: return (int)launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Skv, H, KH, scale, causal, window, q_offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
