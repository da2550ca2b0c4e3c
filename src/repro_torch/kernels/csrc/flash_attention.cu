// Flash attention forward (K5) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _flash_kernel of the reference
// (src/repro/kernels/flash_attention.py:31, launched from flash_attention),
// whose function is models/attention.py blockwise_attention: online-softmax
// attention with f32 state, scores masked to the finite NEG_INF = -1e30 for
// padding keys (k_pos >= T), causality (k_pos > q_pos) and the sliding
// window (k_pos <= q_pos - window), l clamped to 1e-30, output in q's dtype.
// The plain PyTorch version is flash_attention_plain in
// repro_torch/kernels/flash_attention.py.
//
// Layout: q (B, S, H, D), k and v (B, T, KVH, D), read through their batch,
// sequence and head strides (the last dimension must be contiguous). Query
// head h reads KV head h / G, G = H / KVH: no repeat of K and V for GQA.
// Outputs: o (B, S, H, D) contiguous in q's dtype and the f32 row
// log-sum-exp lse (B, H, S) = m + log(max(l, 1e-30)) the backward reads.
//
// Bounds on an H100 (3.35 TB/s, 989 TFLOP/s bf16), bf16, 4·D flops per
// unmasked (query, key) pair, each operand read once and o written once:
//  * the dense LM path (B 32, S = T 32, H 14 / KVH 2, D 64, causal): 4.3 MB,
//    1.3 us; 61 MFLOP, 0.06 us. Bound by bytes, and in practice by the
//    launch and the latency of one pass.
//  * the MoE path (H 64 / KVH 8, D 112): 33 MB, 10 us; 0.48 GFLOP, 0.5 us.
//  * a 4096-token causal prefill (B 1, H 14 / KVH 2, D 64): 30.1 GFLOP,
//    30 us; 16 MB, 5 us. Bound by operations: only the tensor cores reach it.
//
// bf16 design (flash_fwd_kernel_wgmma):
//  * One CTA per (batch, KV head, query tile). The G query heads of the KV
//    head are packed into the tile's rows, row r = (position r / G, head
//    r % G), so each K/V tile crosses from memory once for the whole group,
//    not G times. A tile has 64 rows per consumer warpgroup: 4 warpgroups
//    (256 rows: 36 positions x 7 heads, or 32 x 8) for D <= 64, 2 for
//    D <= 128 and 1 above (registers); fewer when S·G needs fewer rows or
//    the grid would not fill the card once (the LM paths' 32-token rows).
//  * A producer warp loads the query tile by TMA, then streams 64-key K and
//    V tiles into a 2-stage ring, each stage guarded by a "full" and an
//    "empty" mbarrier. Every box is 8 columns wide (16 bytes), so it lands
//    in wgmma's core-matrix layout without a swizzle. An operand whose
//    base or strides are not 16-byte aligned is copied with ordinary loads
//    into the same layout instead (q by all threads, k and v by the
//    producer warp). D is zero-padded to 64, 128 or 256 in shared memory.
//  * Q·Kᵀ on the tensor cores: wgmma m64n64k16, bf16 -> f32, Q and K from
//    shared memory; the f32 product is scaled by 1/sqrt(D) afterwards. bf16
//    products are exact in f32, so the scores differ from the plain version
//    (f32 Q·scale, then the product) only by summation order and one f32
//    rounding of the scale.
//  * P·V on the tensor cores without rounding P to bf16: P = P_hi + P_mid +
//    P_lo, each the bf16 nearest to what the ones before leave, so the three
//    carry P to ~2^-25 of itself; three wgmma m64nDk16 with A from registers
//    (the score accumulators' layout is the A fragment's) and V MN-major
//    from shared memory, f32 accumulation. Two terms (~2^-17) moved outputs
//    that cancel to ~1e-5 by 2e-6, past the check's one bf16 ulp + 1e-6; a
//    single bf16 P would move o by up to ~2^-9 of a term.
//  * Online softmax in registers, each thread holding two rows' partial sums
//    (quad shuffles for the row max; l reduced once at the end); p as
//    exp2f((s - m) log2 e) (2 ulp: far inside one bf16 ulp of o), IEEE
//    division. o is staged in bf16 in the warpgroup's own rows of the Q
//    tile and leaves in 16-byte row pieces. Causally dead KV tiles, and
//    tiles wholly before every row's window, are skipped: they add exactly
//    nothing (p = exp(-1e30 - m) = 0 after a live tile; before one, its junk
//    is wiped by corr = 0). Only tiles that cross the diagonal, the window
//    edge or T are masked. Query tiles are issued longest first (causal).
//  * A row with no valid key at all (S > T with a window) is junk that
//    depends on the blocking, as in the reference.
//
// f32 (flash_fwd_kernel, CUDA cores; no tensor-core f32 product is exact
// with TF32 off): one CTA of 256 threads per (batch, head, 32-row query
// tile); each warp owns 4 rows, lane j key j of a 32-key tile for the scores
// and columns lane + 32c of the accumulator; Q (scaled), K (rows padded to
// D + 1 floats) and V in shared memory; multiply-adds in f32 on the CUDA
// cores (the library is built with --fmad=false), expf, IEEE division.
//
// C interface (loaded with ctypes): fa_forward returns cudaGetLastError()
// after its launch, 0 on success. The launch goes to the caller's stream;
// nothing is allocated or synchronized here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

#include "hopper.cuh"

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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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


// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma kernel (see the header note)
// ---------------------------------------------------------------------------

constexpr int kBN = 64;      // keys per K/V tile
constexpr int kStages = 2;   // K/V tiles in flight
constexpr int kChunk = 16;   // bytes of a core-matrix row: 8 bf16
constexpr float kLog2e = 1.4426950408889634f;

struct WShape {
  int B, S, T, H, KVH, D, G;
  int GC, SQ, nqt, nhc;      // heads and positions per CTA, query tiles, head chunks
  long long qsb, qss, qsh;
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  float scale;
  int causal, window;
  int q_tma, k_tma, v_tma;   // q, k, v are read by TMA (else by ordinary loads)
};

// The bf16 pair nearest (x0, x1), packed as an A-fragment register; x0 and
// x1 keep what it leaves (exact in f32).
__device__ __forceinline__ uint32_t split_bf16(float& x0, float& x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  x0 -= __low2float(h);
  x1 -= __high2float(h);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One K or V tile ([chunk][key][8 elements]) by a warp's ordinary loads, for
// an operand TMA cannot read; keys past T and columns past D are zeros.
__device__ void copy_tile(uint8_t* dst, const __nv_bfloat16* src, long long row_stride,
                          int j0, int T, int D, int nch, int lane) {
  for (int i = lane; i < kBN * nch; i += 32) {
    const int j = i / nch, c = i % nch;
    const int kp = j0 + j;
    hopper::Vec8 e;
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int d = c * 8 + x;
      e.h[x] = (kp < T && d < D) ? __bfloat16_as_ushort(src[kp * row_stride + d]) : 0;
    }
    *reinterpret_cast<uint4*>(dst + (c * kBN + j) * kChunk) = e.u;
  }
}

template <int DP, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, WShape sh) {
  using namespace hopper;
  constexpr int NCH = DP / 8;               // 16-byte chunks of a padded row
  constexpr int kTile = kBN * DP * 2;       // bytes of one K or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int nwg = (blockDim.x - 32) / 128;
  const int M = nwg * 64;                   // rows of the query tile
  uint8_t* qs = smem;                       // [NCH][M][8]
  uint8_t* kv = qs + M * DP * 2;            // [stage][K, V][NCH][kBN][8]
  uint64_t* full = reinterpret_cast<uint64_t*>(kv + kStages * 2 * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;         // the query tile, by TMA

  // CTA -> (batch, KV head, head chunk, query tile); the last query tiles,
  // the longest under causality, are issued first.
  int idx = blockIdx.x;
  const int qt = sh.nqt - 1 - idx % sh.nqt;
  idx /= sh.nqt;
  const int hc = idx % sh.nhc;
  idx /= sh.nhc;
  const int kvh = idx % sh.KVH;
  const int b = idx / sh.KVH;
  const int q0 = qt * sh.SQ, g0 = hc * sh.GC;
  const int tid = threadIdx.x, lane = tid & 31;
  const int nch = (sh.D + 7) / 8;           // chunks that hold data

  const int last = min(q0 + sh.SQ, sh.S) - 1;
  const int nkv = (sh.T + kBN - 1) / kBN;
  const int kt_end = sh.causal ? min(nkv, last / kBN + 1) : nkv;
  const int kt_begin = sh.window ? min(kt_end, max(0, q0 - sh.window + 1) / kBN) : 0;
  const int ntiles = kt_end - kt_begin;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], nwg * 4);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  // Chunks past D are never loaded: zeros, once.
  for (int i = tid; i < kStages * 2 * (NCH - nch) * kBN; i += blockDim.x) {
    const int row = i % kBN, rest = i / kBN;
    const int c = nch + rest % (NCH - nch), t = rest / (NCH - nch);
    *reinterpret_cast<uint4*>(kv + t * kTile + (c * kBN + row) * kChunk) = make_uint4(0, 0, 0, 0);
  }
  // The query tile, rows r = (position r / GC, head r % GC) of this KV
  // head's group: by TMA (the producer's first loads, one 8-column box of
  // GC heads x SQ positions per chunk), or here by ordinary loads when q's
  // base or strides are not 16-byte aligned. Chunks past D are zeros.
  for (int i = tid; i < M * (NCH - nch); i += blockDim.x)
    *reinterpret_cast<uint4*>(qs + ((nch + i / M) * M + i % M) * kChunk) = make_uint4(0, 0, 0, 0);
  if (!sh.q_tma) {
    const __nv_bfloat16* qb = q + b * sh.qsb + static_cast<long long>(kvh) * sh.G * sh.qsh;
    for (int i = tid; i < M * nch; i += blockDim.x) {
      const int r = i / nch, c = i % nch;
      const int si = r / sh.GC, g = g0 + r % sh.GC, pos = q0 + si;
      hopper::Vec8 e;
#pragma unroll
      for (int x = 0; x < 8; ++x)
        e.h[x] = (si < sh.SQ && pos < sh.S && g < sh.G && c * 8 + x < sh.D)
            ? __bfloat16_as_ushort(qb[pos * sh.qss + g * sh.qsh + c * 8 + x]) : 0;
      *reinterpret_cast<uint4*>(qs + (c * M + r) * kChunk) = e.u;
    }
  }
  fence_proxy_async();
  __syncthreads();

  if (tid >= nwg * 128) {   // producer warp
    const __nv_bfloat16* kb = k + b * sh.ksb + kvh * sh.ksh;
    const __nv_bfloat16* vb = v + b * sh.vsb + kvh * sh.vsh;
    const uint32_t tx = (sh.k_tma + sh.v_tma) * nch * kBN * kChunk;
    if (sh.q_tma && lane == 0) {
      mbar_arrive_expect_tx(qbar, nch * sh.GC * sh.SQ * kChunk);
      for (int c = 0; c < nch; ++c)
        tma_load_4d(qs + c * M * kChunk, &qmap, qbar, c * 8, kvh * sh.G + g0, q0, b);
    }
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % kStages;
      mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
      const int j0 = (kt_begin + i) * kBN;
      uint8_t* kd = kv + st * 2 * kTile;
      uint8_t* vd = kd + kTile;
      if (!sh.k_tma) copy_tile(kd, kb, sh.kss, j0, sh.T, sh.D, nch, lane);
      if (!sh.v_tma) copy_tile(vd, vb, sh.vss, j0, sh.T, sh.D, nch, lane);
      if (!sh.k_tma || !sh.v_tma) {
        fence_proxy_async();
        __syncwarp();
      }
      if (lane == 0) {
        if (tx) mbar_arrive_expect_tx(&full[st], tx);
        else mbar_arrive(&full[st]);
        for (int c = 0; c < nch; ++c) {
          if (sh.k_tma) tma_load_4d(kd + c * kBN * kChunk, &kmap, &full[st], c * 8, j0, kvh, b);
          if (sh.v_tma) tma_load_4d(vd + c * kBN * kChunk, &vmap, &full[st], c * 8, j0, kvh, b);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63; this thread rows
  // r0 and r0 + 8 of its warp's 16, columns 8 j + 2 (lane % 4) + {0, 1}.
  const int wg = tid / 128, warp = (tid % 128) / 32;
  const int r0 = wg * 64 + warp * 16 + lane / 4, r1 = r0 + 8;
  const int pos0 = q0 + r0 / sh.GC, pos1 = q0 + r1 / sh.GC;
  const int ksteps = (sh.D + 15) / 16;
  const uint64_t qdesc = wgmma_desc(qs + wg * 64 * kChunk, M * kChunk, 128);

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float s[kBN / 2];
  if (sh.q_tma) mbar_wait(qbar, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int st = i % kStages;
    mbar_wait(&full[st], (i / kStages) & 1);
    const uint8_t* kd = kv + st * 2 * kTile;
    const uint8_t* vd = kd + kTile;

    // S = Q · Kᵀ over the 16-deep steps that hold data.
    wgmma_fence();
    for (int kk = 0; kk < ksteps; ++kk)
      wgmma_ss_n64(s, qdesc + ((2 * kk * M * kChunk) >> 4),
                   wgmma_desc(kd + 2 * kk * kBN * kChunk, kBN * kChunk, 128), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const int j0 = (kt_begin + i) * kBN;
    const bool edge = j0 + kBN > sh.T || (sh.causal && j0 + kBN - 1 > q0) ||
                      (sh.window && j0 <= last - sh.window);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int x = 0; x < kBN / 2; ++x) {
      float sv = s[x] * sh.scale;
      if (edge) {
        const int kp = j0 + (x / 4) * 8 + 2 * (lane % 4) + (x & 1);
        const int pos = (x & 2) ? pos1 : pos0;
        bool valid = kp < sh.T;
        if (sh.causal) valid = valid && kp <= pos;
        if (sh.window) valid = valid && kp > pos - sh.window;
        if (!valid) sv = kNegInf;
      }
      s[x] = sv;
      if (x & 2) mx1 = fmaxf(mx1, sv);
      else mx0 = fmaxf(mx0, sv);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float corr0 = exp2f((m0 - mx0) * kLog2e), corr1 = exp2f((m1 - mx1) * kLog2e);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int x = 0; x < kBN / 2; ++x) {
      const float p = exp2f((s[x] - ((x & 2) ? mx1 : mx0)) * kLog2e);
      s[x] = p;
      if (x & 2) sum1 += p;
      else sum0 += p;
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int x = 0; x < DP / 2; ++x) acc[x] *= (x & 2) ? corr1 : corr0;

    // P = P_hi + P_mid + P_lo, three bf16 A fragments: step kk takes n8
    // blocks 2 kk and 2 kk + 1; a = (row r0 | r1) x (block).
    uint32_t ph[kBN / 16][4], pm[kBN / 16][4], pl[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int x = (2 * kk + a / 2) * 4 + (a % 2) * 2;
        ph[kk][a] = split_bf16(s[x], s[x + 1]);
        pm[kk][a] = split_bf16(s[x], s[x + 1]);
        pl[kk][a] = split_bf16(s[x], s[x + 1]);
      }
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t vdesc = wgmma_desc(vd + kk * 16 * kChunk, 8 * kChunk, kBN * kChunk);
      if constexpr (DP == 64) {
        wgmma_rs_n64_tb(acc, ph[kk], vdesc);
        wgmma_rs_n64_tb(acc, pm[kk], vdesc);
        wgmma_rs_n64_tb(acc, pl[kk], vdesc);
      } else if constexpr (DP == 128) {
        wgmma_rs_n128_tb(acc, ph[kk], vdesc);
        wgmma_rs_n128_tb(acc, pm[kk], vdesc);
        wgmma_rs_n128_tb(acc, pl[kk], vdesc);
      } else {
        wgmma_rs_n256_tb(acc, ph[kk], vdesc);
        wgmma_rs_n256_tb(acc, pm[kk], vdesc);
        wgmma_rs_n256_tb(acc, pl[kk], vdesc);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // o = acc / l in bf16, staged in this warpgroup's own rows of the Q tile
  // (its last Q·Kᵀ has completed) and copied out in 16-byte row pieces.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    const float lc = fmaxf(half ? l1 : l0, 1e-30f);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(acc[j * 4 + half * 2] / lc,
                                                        acc[j * 4 + half * 2 + 1] / lc);
      *reinterpret_cast<__nv_bfloat162*>(qs + (j * M + r) * kChunk + (lane % 4) * 4) = pair;
    }
    const int si = r / sh.GC, g = g0 + r % sh.GC, pos = q0 + si;
    if (lane % 4 == 0 && si < sh.SQ && pos < sh.S && g < sh.G)
      lse[(static_cast<long long>(b) * sh.H + kvh * sh.G + g) * sh.S + pos] =
          (half ? m1 : m0) + logf(lc);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  for (int i = tid % 128; i < 64 * nch; i += 128) {
    const int r = wg * 64 + i / nch, c = i % nch;
    const int si = r / sh.GC, g = g0 + r % sh.GC, pos = q0 + si;
    if (si >= sh.SQ || pos >= sh.S || g >= sh.G) continue;
    __nv_bfloat16* orow =
        o + ((static_cast<long long>(b) * sh.S + pos) * sh.H + kvh * sh.G + g) * sh.D + c * 8;
    const uint8_t* src = qs + (c * M + r) * kChunk;
    if (sh.D % 8 == 0) {
      *reinterpret_cast<uint4*>(orow) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int x = 0; x < 8 && c * 8 + x < sh.D; ++x)
        orow[x] = reinterpret_cast<const __nv_bfloat16*>(src)[x];
    }
  }
}

// A 4-D tensor map (D, T, KVH, B) of k or v in 8-column boxes of kBN keys.
// Dimensions of size 1 get a nominal aligned stride: they are never stepped.
cudaError_t kv_map(CUtensorMap* map, const void* base, int B, int T, int KVH, int D,
                   long long sb, long long ss, long long sh) {
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(T),
                            static_cast<uint64_t>(KVH), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(ss) * 2, static_cast<uint64_t>(sh) * 2,
                               static_cast<uint64_t>(sb) * 2};
  const uint32_t box[4] = {8, kBN, 1, 1};
  return hopper::make_bf16_map(map, base, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// q, k or v (B, L, NH, D) is read by TMA when its base and every stepped
// stride are 16-byte aligned; a dimension of size 1 is never stepped and
// gets a nominal stride.
bool tma_strides_ok(const void* base, int B, int L, int NH, long long& sb, long long& sl,
                    long long& sh) {
  if (L == 1) sl = 8;
  if (NH == 1) sh = 8;
  if (B == 1) sb = 8;
  const long long strides[3] = {sl, sh, sb};
  return hopper::tma_ok(base, strides, 3);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <int DP, int NWG>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                 WShape sh, cudaStream_t stream) {
  // w consumer warpgroups: 64 w rows of (position, head) a CTA; the CTAs.
  auto plan = [&sh](int w) {
    sh.GC = std::min(sh.G, 64 * w);
    sh.SQ = 64 * w / sh.GC;
    sh.nqt = (sh.S + sh.SQ - 1) / sh.SQ;
    sh.nhc = (sh.G + sh.GC - 1) / sh.GC;
    return static_cast<long long>(sh.B) * sh.KVH * sh.nhc * sh.nqt;
  };
  // As many warpgroups as the rows need, up to NWG; fewer while the grid
  // would not fill the card once (short sequences: more, smaller tiles).
  const long long rows = static_cast<long long>(sh.S) * std::min(sh.G, 64 * NWG);
  int nwg = static_cast<int>(std::min<long long>(NWG, (rows + 63) / 64));
  while (nwg > 1 && plan(nwg) < sm_count()) --nwg;
  const long long grid = plan(nwg);
  CUtensorMap qmap, kmap, vmap;
  memset(&qmap, 0, sizeof(qmap));
  memset(&kmap, 0, sizeof(kmap));
  memset(&vmap, 0, sizeof(vmap));
  long long qsb = sh.qsb, qss = sh.qss, qsh = sh.qsh;
  long long ksb = sh.ksb, kss = sh.kss, ksh = sh.ksh, vsb = sh.vsb, vss = sh.vss, vsh = sh.vsh;
  // q as (D, H, S, B) in boxes of 8 columns x GC heads x SQ positions.
  sh.q_tma = tma_strides_ok(q, sh.B, sh.S, sh.H, qsb, qss, qsh);
  sh.k_tma = tma_strides_ok(k, sh.B, sh.T, sh.KVH, ksb, kss, ksh);
  sh.v_tma = tma_strides_ok(v, sh.B, sh.T, sh.KVH, vsb, vss, vsh);
  cudaError_t err;
  if (sh.q_tma) {
    const uint64_t dims[4] = {static_cast<uint64_t>(sh.D), static_cast<uint64_t>(sh.H),
                              static_cast<uint64_t>(sh.S), static_cast<uint64_t>(sh.B)};
    const uint64_t strides[3] = {static_cast<uint64_t>(qsh) * 2, static_cast<uint64_t>(qss) * 2,
                                 static_cast<uint64_t>(qsb) * 2};
    const uint32_t box[4] = {8, static_cast<uint32_t>(sh.GC), static_cast<uint32_t>(sh.SQ), 1};
    err = hopper::make_bf16_map(&qmap, q, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (sh.k_tma && (err = kv_map(&kmap, k, sh.B, sh.T, sh.KVH, sh.D, ksb, kss, ksh)) != cudaSuccess)
    return static_cast<int>(err);
  if (sh.v_tma && (err = kv_map(&vmap, v, sh.B, sh.T, sh.KVH, sh.D, vsb, vss, vsh)) != cudaSuccess)
    return static_cast<int>(err);
  const size_t smem = 1024 + static_cast<size_t>(64 * nwg) * DP * 2 +
                      static_cast<size_t>(kStages) * 2 * kBN * DP * 2 + (2 * kStages + 1) * 8;
  err = cudaFuncSetAttribute(flash_fwd_kernel_wgmma<DP, NWG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_kernel_wgmma<DP, NWG><<<static_cast<unsigned>(grid), nwg * 128 + 32, smem, stream>>>(
      qmap, kmap, vmap, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, sh);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Shape sh{B, S, T, H, KVH, D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
                   scale, causal, window};
    return launch<float>(q, k, v, o, lse, sh, st);
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const WShape sh{B, S, T, H, KVH, D, H / KVH, 0, 0, 0, 0, qsb, qss, qsh, ksb, kss, ksh,
                  vsb, vss, vsh, scale, causal, window, 0, 0, 0};
  if (D <= 64) return launch_wgmma<64, 4>(q, k, v, o, lse, sh, st);
  if (D <= 128) return launch_wgmma<128, 2>(q, k, v, o, lse, sh, st);
  return launch_wgmma<256, 1>(q, k, v, o, lse, sh, st);
}

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
