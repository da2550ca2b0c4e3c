// Flash attention forward (K5) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _flash_kernel of the reference
// (src/repro/kernels/flash_attention.py, launched from flash_attention), whose
// function is models/attention.py blockwise_attention: online-softmax
// attention with f32 state, scores masked to the finite NEG_INF = -1e30 for
// padding keys (k_pos >= T), causality (k_pos > q_pos) and the sliding
// window (k_pos <= q_pos - window), l clamped to 1e-30, output in q's dtype.
// The plain PyTorch version, with the same blocking, is flash_attention_plain
// in repro_torch/kernels/flash_attention.py.
//
// Layout: q (B, S, H, D), k and v (B, T, KVH, D), read through their batch,
// sequence and head strides (the last dimension must be contiguous). Query
// head h reads KV head h / (H / KVH): no repeat of K and V for GQA and no
// head-major transpose, unlike the reference's ops.flash_mha. Outputs: o
// (B, S, H, D) contiguous in q's dtype and the f32 row log-sum-exp
// lse (B, H, S) = m + log(max(l, 1e-30)) that the backward needs.
//
// Bound on an H100: at the federated LM path's shape (S = T = 32, D = 64,
// bf16, 448 (batch, head) rows of work per launch) the kernel reads ~2.3 MB
// and writes ~1.9 MB, about 1.3 us at 3.35 TB/s; its 60 MFLOP take 0.06 us
// even at the f32 rate, so it is memory- and, in practice, launch-bound. At
// S = T = 4096 causal it is compute-bound: 4*D flops per unmasked (q, k)
// pair. This first version does them in f32 on the CUDA cores, with
// operands from shared memory. The library is built with --fmad=false (see
// _build.py), so each multiply-add is a separate multiply and add: the
// kernel can reach at most half of the 67 TFLOP/s f32 FMA peak its bound is
// taken at. Tensor cores (wgmma), TMA and a pipeline of KV tiles are later
// work.
//
// Design:
//  * One CTA of 256 threads (8 warps) per (batch, head, 32-row query tile).
//    The TPU grid walked (bh, q tile, kv tile) in order, carrying m, l and
//    acc in VMEM scratch across the kv steps; here the kv tiles are a loop
//    inside the CTA and m, l, acc live in registers.
//  * Each warp owns 4 query rows; lane j owns key j of the 32-key tile for
//    the scores, and columns d = lane + 32c (c < ceil(D/32) <= 8) of the
//    accumulator. Row max and sum are warp shuffles; p_j is broadcast with a
//    shuffle for acc += p_j * v_j.
//  * Q (scaled by 1/sqrt(D) after the cast to f32, as the reference does),
//    the K tile (rows padded to D+1 floats, so the 32 lanes reading 32 keys
//    at one d hit 32 banks) and the V tile sit in dynamic shared memory:
//    4 * (32*D + 32*(D+1) + 32*D) bytes, 98 KB at D = 256.
//  * Causal: kv tiles wholly above the query tile's last row are skipped, as
//    the Pallas kernel skips them. A skipped or all-masked tile after a live
//    one adds exactly nothing (p = exp(-1e30 - m) = 0, corr = 1). Keeping
//    NEG_INF finite matters for a row whose first tiles are all masked (the
//    sliding window): its junk p = 1 is wiped by corr = exp(-1e30 - m) = 0 at
//    the first live tile, where -inf would give exp(-inf + inf) = NaN.
//  * Arithmetic in f32 with IEEE division and expf (no fast math,
//    --fmad=false): the output differs from the plain version only through
//    the order of the sums.
//
// C interface (loaded with ctypes): fa_forward returns cudaGetLastError()
// after its launch, 0 on success. The launch goes to the caller's stream;
// nothing is allocated or synchronized here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 32;
constexpr int kBlockK = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kBlockQ / kWarps;  // query rows per warp
constexpr int kMaxD = 256;
constexpr int kMaxChunks = kMaxD / 32;
constexpr float kNegInf = -1e30f;

struct Shape {
  int B, S, T, H, KVH, D;
  long long qsb, qss, qsh;
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  float scale;
  int causal, window;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Shape sh) {
  extern __shared__ float smem[];
  const int D = sh.D;
  float* qs = smem;                    // [kBlockQ][D]
  float* ks = qs + kBlockQ * D;        // [kBlockK][D + 1]
  float* vs = ks + kBlockK * (D + 1);  // [kBlockK][D]

  const int b = blockIdx.x / sh.H;
  const int h = blockIdx.x % sh.H;
  const int kvh = h / (sh.H / sh.KVH);
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nchunks = (D + 31) / 32;

  const T* qb = q + b * sh.qsb + h * sh.qsh;
  const T* kb = k + b * sh.ksb + kvh * sh.ksh;
  const T* vb = v + b * sh.vsb + kvh * sh.vsh;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qp = q0 + r;
    qs[i] = qp < sh.S ? to_f32(qb[qp * sh.qss + d]) * sh.scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kMaxChunks];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) acc[i][c] = 0.f;
  }

  const int nkv = (sh.T + kBlockK - 1) / kBlockK;
  // Causal: tile kt is live while its first key <= the tile's last query row.
  const int kt_end = sh.causal ? min(nkv, (q0 + kBlockQ - 1) / kBlockK + 1) : nkv;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int j0 = kt * kBlockK;
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const int kp = j0 + j;
      const bool in = kp < sh.T;
      ks[j * (D + 1) + d] = in ? to_f32(kb[kp * sh.kss + d]) : 0.f;
      vs[j * D + d] = in ? to_f32(vb[kp * sh.vss + d]) : 0.f;
    }
    __syncthreads();

    // Scores of this warp's rows against key j0 + lane.
    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = 0.f;
    const float* krow = ks + lane * (D + 1);
    const float* qrow = qs + warp * kRows * D;
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) s[i] += qrow[i * D + d] * kd;
    }

    const int kp = j0 + lane;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + warp * kRows + i;
      bool valid = kp < sh.T;
      if (sh.causal) valid = valid && kp <= qp;
      if (sh.window) valid = valid && kp > qp - sh.window;
      const float si = valid ? s[i] : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(si));
      const float p = expf(si - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) acc[i][c] *= corr;
      for (int j = 0; j < kBlockK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float* vrow = vs + j * D;
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c) {
          const int d = c * 32 + lane;
          if (c < nchunks && d < D) acc[i][c] += pj * vrow[d];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + warp * kRows + i;
    if (qp >= sh.S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * sh.S + qp) * sh.H + h) * D;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int d = c * 32 + lane;
      if (c < nchunks && d < D) store(orow + d, acc[i][c] / lc);
    }
    if (lane == 0)
      lse[(static_cast<long long>(b) * sh.H + h) * sh.S + qp] = m[i] + logf(lc);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const Shape& sh, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kBlockQ) * sh.D + kBlockK * (sh.D + 1) + kBlockK * sh.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sh.B * sh.H, (sh.S + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike). Strides are in
// elements; the last dimension of q, k and v is contiguous.
int fa_forward(int dtype, const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int T, int H, int KVH, int D,
               long long qsb, long long qss, long long qsh,
               long long ksb, long long kss, long long ksh,
               long long vsb, long long vss, long long vsh,
               float scale, int causal, int window, void* stream) {
  if (D < 1 || D > kMaxD || H % KVH != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{B, S, T, H, KVH, D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
                 scale, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, o, lse, sh, st);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, o, lse, sh, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
