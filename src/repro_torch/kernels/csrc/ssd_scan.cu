// SSD chunk (K7) for Hopper (sm_90a): the intra-chunk part of Mamba-2's
// chunked SSD scan.
//
// Replaces the Pallas TPU kernel _ssd_chunk_kernel of the reference
// (src/repro/kernels/ssd_scan.py, launched from ssd_chunk). For each
// (batch row, chunk, head), with cum = cumsum(dt * a) over the chunk:
//   y_intra[i]  = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j
//   state[p, n] = sum_j (x_jp * v_j) * b_jn,  v_j = exp(cum_last - cum_j) * dt_j
//   cum_last    = cum[CL - 1]
// The plain PyTorch version is ssd_chunk_plain in
// repro_torch/kernels/ssd_scan.py.
//
// Layout: x (B, NC, CL, NH, HP), dt (B, NC, CL, NH), a (B, NH) (one A per
// batch row: a vmapped cohort has one per client), b and c (B, NC, CL, N),
// all f32 and read through their strides (the last dimension of x, b and c
// contiguous). There is no head-major transpose of x and no per-head copy of
// b and c, unlike the reference's ssd_chunk. Outputs, contiguous: y_intra
// (B, NC, CL, NH, HP), states (B, NC, NH, HP, N), cum_last (B, NC, NH).
//
// Bound on an H100: at the federated mamba2 path's shape (B 32, CL 256,
// NC 1, NH 32, HP 64, N 128) the function must move 177 MB (53 us at
// 3.35 TB/s) and do ~9 GFLOP (the causal half of C.B^T once per (batch,
// chunk), the causal half of W.x and the state product per head), 0.13 ms
// at the 67 TFLOP/s f32 rate with TF32 off: operations bound it. This
// first version does them on the CUDA cores with operands from shared
// memory, and recomputes C.B^T for every head as the Pallas kernel does
// (NH times the necessary work of that product). The library is built with
// --fmad=false (see _build.py), so each multiply-add is a multiply and an
// add: at most half of the f32 peak. Tensor cores (3xTF32 or split bf16,
// since TF32 alone would break parity), TMA and a C.B^T shared across heads
// are later work.
//
// Design:
//  * One CTA of 256 threads per (batch row, chunk, head), heads fastest, so
//    the CTAs that read the same b and c run side by side (L2 reuse). The
//    TPU grid walked (batch*chunk, head) in order with the whole chunk in
//    VMEM; a 256 x 128 f32 tile of C or B is 128 KB, so here the chunk is
//    walked in 64-row tiles instead.
//  * cum: thread 0 sums dt_l * a (an f32 product, as the reference forms
//    da) in f64, in order, rounding each partial sum to f32 once; the plain
//    version's chunk_cumsum does the same, so both see the same cum on
//    every device. v_j is formed once per row into shared memory.
//  * y: for each 64-row tile i of the output and each causal 64-row tile
//    j <= i (tiles above the diagonal are skipped), the 64 x 64 tile of
//    C.B^T is summed over N in slices of 32 (each thread a 4 x 4 block of
//    it, in registers), turned into W_ij = (S_ij * exp(cum_i - cum_j)) * dt_j
//    for j <= i and exactly 0 otherwise, and written to shared memory; then
//    each thread adds W.x into its 4 rows x ceil(HP/16) columns of y, kept in
//    registers across the j tiles. The exponent is evaluated only where
//    j <= i: the reference takes exp of every (i, j) and masks afterwards,
//    which overflows to inf (and inf * 0 = NaN) above the diagonal once a
//    chunk's log-decay spread passes ~88.
//  * state: for each 64-column slice of N, each thread owns ceil(HP/16) rows
//    x 4 columns of the (HP, N) state in registers and adds (x_j * v_j) b_j
//    over all rows j in order.
//  * Shared-memory rows of 33 and 65 floats keep the lanes that read one
//    column of a tile on distinct banks. Dynamic shared memory:
//    4 * (3 * 256 + 2 * 64 * 33 + 64 * 65 + 64 * HP) bytes, 53 KB at HP 64.
//  * Arithmetic in f32 with expf (no fast math, --fmad=false), sums over N
//    and over j in order: the outputs differ from the plain version (whose
//    products are cuBLAS GEMMs) only through the order of the sums.
//
// C interface (loaded with ctypes): ssd_chunk_forward returns
// cudaGetLastError() after its launch, 0 on success. The launch goes to the
// caller's stream; nothing is allocated or synchronized here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;      // rows of a y tile and of a j tile
constexpr int kSlice = 32;     // N per slice of the C.B^T tile
constexpr int kStateCols = 64; // N per slice of the state
constexpr int kMaxChunk = 256;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxState = 256;
constexpr int kMaxCols = kMaxHeadDim / 16;  // y columns (state rows) per thread
constexpr int kPadS = kSlice + 1;
constexpr int kPadW = kTile + 1;

struct Args {
  const float* x;
  const float* dt;
  const float* a;
  const float* b;
  const float* c;
  float* y;
  float* states;
  float* cum_last;
  int B, NC, CL, NH, HP, N;
  long long xsb, xsc, xsl, xsh;
  long long dsb, dsc, dsl, dsh;
  long long asb, ash;
  long long bsb, bsc, bsl;
  long long csb, csc, csl;
};

__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(Args g) {
  extern __shared__ float smem[];
  float* cum = smem;                        // [kMaxChunk]
  float* dts = cum + kMaxChunk;             // [kMaxChunk]
  float* vs = dts + kMaxChunk;              // [kMaxChunk]
  float* work = vs + kMaxChunk;
  // y phase
  float* cs = work;                         // [kTile][kPadS]
  float* bs = cs + kTile * kPadS;           // [kTile][kPadS]
  float* ws = bs + kTile * kPadS;           // [kTile][kPadW]
  float* xs = ws + kTile * kPadW;           // [kTile][HP]
  // state phase (reuses the same space)
  float* xvs = work;                        // [kTile][HP]
  float* bst = xvs + kTile * g.HP;          // [kTile][kPadW]

  const int CL = g.CL, HP = g.HP, N = g.N, NH = g.NH;
  const int h = blockIdx.x % NH;
  const int bc = blockIdx.x / NH;
  const int ci = bc % g.NC;
  const int bi = bc / g.NC;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  const float* xb = g.x + bi * g.xsb + ci * g.xsc + h * g.xsh;
  const float* db = g.dt + bi * g.dsb + ci * g.dsc + h * g.dsh;
  const float* bb = g.b + bi * g.bsb + ci * g.bsc;
  const float* cb = g.c + bi * g.csb + ci * g.csc;
  const float a = g.a[bi * g.asb + h * g.ash];

  for (int l = tid; l < CL; l += kThreads) dts[l] = db[l * g.dsl];
  __syncthreads();
  if (tid == 0) {
    double run = 0.0;
    for (int l = 0; l < CL; ++l) {
      run += static_cast<double>(dts[l] * a);
      cum[l] = static_cast<float>(run);
    }
    g.cum_last[static_cast<long long>(bc) * NH + h] = cum[CL - 1];
  }
  __syncthreads();
  const float clast = cum[CL - 1];
  for (int l = tid; l < CL; l += kThreads) vs[l] = expf(clast - cum[l]) * dts[l];

  const int ntiles = (CL + kTile - 1) / kTile;
  float* yb = g.y + (static_cast<long long>(bc) * CL * NH + h) * HP;

  // ---- y_intra, one 64-row tile at a time ----
  for (int it = 0; it < ntiles; ++it) {
    const int i0 = it * kTile;
    float acc[4][kMaxCols];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < kMaxCols; ++k) acc[r][k] = 0.f;

    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kTile;
      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) s[r][k] = 0.f;

      for (int n0 = 0; n0 < N; n0 += kSlice) {
        __syncthreads();  // every thread is done with cs, bs, ws and xs
        for (int e = tid; e < kTile * kSlice; e += kThreads) {
          const int r = e / kSlice, nn = e % kSlice, n = n0 + nn;
          const int i = i0 + r, j = j0 + r;
          cs[r * kPadS + nn] = (i < CL && n < N) ? cb[i * g.csl + n] : 0.f;
          bs[r * kPadS + nn] = (j < CL && n < N) ? bb[j * g.bsl + n] : 0.f;
        }
        __syncthreads();
        const int nlen = min(kSlice, N - n0);
        for (int nn = 0; nn < nlen; ++nn) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = cs[(ty * 4 + r) * kPadS + nn];
#pragma unroll
          for (int k = 0; k < 4; ++k) bv[k] = bs[(tx + 16 * k) * kPadS + nn];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k) s[r][k] += cv[r] * bv[k];
        }
      }

      // W tile, exponent only where j <= i; and the x rows of this j tile.
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = j0 + tx + 16 * k;
          float w = 0.f;
          if (j <= i && i < CL) w = (s[r][k] * expf(cum[i] - cum[j])) * dts[j];
          ws[(ty * 4 + r) * kPadW + tx + 16 * k] = w;
        }
      }
      for (int e = tid; e < kTile * HP; e += kThreads) {
        const int r = e / HP, p = e % HP, j = j0 + r;
        xs[r * HP + p] = j < CL ? xb[j * g.xsl + p] : 0.f;
      }
      __syncthreads();
      const int jlen = min(kTile, CL - j0);
      for (int jj = 0; jj < jlen; ++jj) {
        float wv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) wv[r] = ws[(ty * 4 + r) * kPadW + jj];
#pragma unroll
        for (int k = 0; k < kMaxCols; ++k) {
          const int p = tx + 16 * k;
          if (p < HP) {
            const float xv = xs[jj * HP + p];
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r][k] += wv[r] * xv;
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      if (i >= CL) continue;
#pragma unroll
      for (int k = 0; k < kMaxCols; ++k) {
        const int p = tx + 16 * k;
        if (p < HP) yb[static_cast<long long>(i) * NH * HP + p] = acc[r][k];
      }
    }
  }

  // ---- terminal state, one 64-column slice of N at a time ----
  float* sb = g.states + (static_cast<long long>(bc) * NH + h) * HP * N;
  for (int n0 = 0; n0 < N; n0 += kStateCols) {
    float acc[kMaxCols][4];
#pragma unroll
    for (int r = 0; r < kMaxCols; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;

    for (int jt = 0; jt < ntiles; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();  // every thread is done with the previous tiles
      for (int e = tid; e < kTile * HP; e += kThreads) {
        const int r = e / HP, p = e % HP, j = j0 + r;
        xvs[r * HP + p] = j < CL ? xb[j * g.xsl + p] * vs[j] : 0.f;
      }
      for (int e = tid; e < kTile * kStateCols; e += kThreads) {
        const int r = e / kStateCols, nn = e % kStateCols, j = j0 + r, n = n0 + nn;
        bst[r * kPadW + nn] = (j < CL && n < N) ? bb[j * g.bsl + n] : 0.f;
      }
      __syncthreads();
      const int jlen = min(kTile, CL - j0);
      for (int jj = 0; jj < jlen; ++jj) {
        float bv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) bv[k] = bst[jj * kPadW + tx + 16 * k];
#pragma unroll
        for (int r = 0; r < kMaxCols; ++r) {
          const int p = ty + 16 * r;
          if (p < HP) {
            const float xv = xvs[jj * HP + p];
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[r][k] += xv * bv[k];
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kMaxCols; ++r) {
      const int p = ty + 16 * r;
      if (p >= HP) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = n0 + tx + 16 * k;
        if (n < N) sb[static_cast<long long>(p) * N + n] = acc[r][k];
      }
    }
  }
}

}  // namespace

extern "C" {

// Strides are in elements: x (B, NC, CL, NH), dt (B, NC, CL, NH), a (B, NH),
// b and c (B, NC, CL); the last dimension of x, b and c is contiguous.
int ssd_chunk_forward(const float* x, const float* dt, const float* a, const float* b,
                      const float* c, float* y, float* states, float* cum_last,
                      int B, int NC, int CL, int NH, int HP, int N,
                      long long xsb, long long xsc, long long xsl, long long xsh,
                      long long dsb, long long dsc, long long dsl, long long dsh,
                      long long asb, long long ash,
                      long long bsb, long long bsc, long long bsl,
                      long long csb, long long csc, long long csl, void* stream) {
  if (CL < 1 || CL > kMaxChunk || HP < 1 || HP > kMaxHeadDim || N < 1 || N > kMaxState)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{x, dt, a, b, c, y, states, cum_last, B, NC, CL, NH, HP, N,
                  xsb, xsc, xsl, xsh, dsb, dsc, dsl, dsh, asb, ash,
                  bsb, bsc, bsl, csb, csc, csl};
  const size_t smem = sizeof(float) *
      (3 * kMaxChunk + 2 * kTile * kPadS + kTile * kPadW + static_cast<size_t>(kTile) * HP);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ctas = static_cast<long long>(B) * NC * NH;
  ssd_chunk_kernel<<<static_cast<unsigned>(ctas), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
