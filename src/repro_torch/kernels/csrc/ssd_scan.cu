// SSD chunk (K7) for Hopper (sm_90a): the intra-chunk part of Mamba-2's
// chunked SSD scan, on the tensor cores.
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
// batch row: a vmapped cohort has one per client), b and c (B, NC, CL, N)
// with one B/C group for all heads, all f32 and read through their strides
// (the last dimension of x, b and c contiguous). Outputs, contiguous:
// y_intra (B, NC, CL, NH, HP), states (B, NC, NH, HP, N), cum_last
// (B, NC, NH). The caller also passes a scratch S of (B * NC, CLP, CLP) f32,
// CLP = CL rounded up to 64.
//
// Bound on an H100: at the federated mamba2 path's shape (B 32, CL 256,
// NC 1, NH 32, HP 64, N 128) the function must move 177 MB (53 us at
// 3.35 TB/s) and do ~9.0 GFLOP: the causal half of C.B^T once per (batch,
// chunk), the causal half of W.x and the state product per head. On the
// CUDA cores (67 TFLOP/s f32) that is 0.135 ms. Here the products run on the
// tensor cores as 3xTF32 (TF32 alone, ~2^-11, would break the parity with
// the plain version): three TF32 products each, 3 x 9.0 GFLOP at 494.7
// TFLOP/s = 0.055 ms, level with the byte bound. Each operand is split into
// hi (rounded to TF32) and lo (the rest, which the mma truncates to TF32);
// against the plain version in f64 the kernel's outputs err as far as the
// f32 plain version's own (PERF.md).
//
// What holds it back (scripts/k7_variants.py on one H100 at 700 W, the
// path's shape, PERF.md): issue slots and latency at three CTAs (12 warps)
// an SM more than the tensor cores. Of 0.251 ms a call, the second and third
// TF32 passes take 0.066 (one pass: 0.185 ms, but 3.6e-2 off) and the tile
// loads after the first 0.040; the rest is the TF32 splits (each warp splits
// the same x fragments), expf and shared loads. mma.sync reaches about half
// the TF32 rate; wgmma, which reaches all of it, takes TF32 operands only
// K-major from shared memory, and x is (j, p) with p contiguous: staging it
// transposed is later work.
//
// Design, two launches per call:
//  1. ssd_chunk_cb_kernel: S = C.B^T once per (batch row, chunk), one CTA of
//     four warps per causal 64 x 64 tile (tiles above the diagonal are never
//     read), N staged in slices of 32 with cp.async, double-buffered. All
//     heads read S from the scratch (8.4 MB at the path: it stays in L2)
//     instead of forming it again, NH times less work for this product than
//     one CTA per head forming its own. The same launch writes each head's
//     cum, dt and v rows (below).
//  2. ssd_chunk_heads_kernel<HPT>: four warps a CTA, two roles by blockIdx.
//     First one CTA per (batch row, chunk, head, 128-column slice of N; 64
//     at HP > 64) for the terminal state, then one per (batch row, chunk,
//     head, 64-row tile i of y), the row tiles with the most causal j tiles
//     first. Heads run fastest, so the CTAs that share S, b and c run side
//     by side. (Grouping a head's CTAs instead, so that x would come from
//     device memory once, cut the loads but slowed the call.)
//     * cum, dt and v: launch 1 also writes, one warp per head, the head's
//       cum (dt_l * a, an f32 product as the reference forms da, summed in
//       f64 and each partial sum rounded to f32 once: each lane its 8
//       consecutive terms in order, then a shuffle scan over the lanes), dt
//       and v_j = exp(cum_last - cum_j) * dt_j, and cum_last. A CTA of
//       launch 2 copies the rows it needs with its first tile, instead of
//       each of a head's six CTAs summing cum again from dt read with a
//       stride of NH. The plain version's chunk_cumsum
//       (torch.cumsum in f64) sums in another order. f64 sums of f32 terms
//       are exact while the terms and partial sums span fewer than
//       53 - 24 - 8 = 21 binary orders of magnitude (256 terms), so there
//       the order is free and the two agree bitwise; dt = softplus(.) > 0
//       and one a per head keep the model's terms of one sign and like
//       magnitude. Outside that the two can differ in the last bit of cum.
//     * y: for each causal 64-row tile j of the row tile i (x rows and the
//       S tile staged with cp.async, the next tile in flight during the
//       products), each warp owns 16 rows i and all HP columns. It forms
//       W = (S_ij * exp(cum_i - cum_j)) * dt_j in registers directly in the
//       mma A-fragment layout, on the diagonal tile the exponent evaluated
//       only where j <= i (exactly 0 above the diagonal: the reference takes
//       exp of every (i, j) and masks afterwards, which overflows to inf, and
//       inf * 0 to NaN, once a chunk's log-decay spread passes ~88), splits
//       W and x into TF32 hi + lo and adds lo.hi + hi.lo + hi.hi with
//       mma.sync.m16n8k8 into f32 accumulators, each pass over all of the
//       warp's tiles before the next. On the diagonal tile a warp stops at
//       its last row; below it the k loop is unrolled.
//     * state: x and b staged in 32-row tiles; each warp owns 32 columns n
//       of the slice (16 at HP > 64) and all HP rows p; A = x_jp * v_j (f32,
//       as the plain version) and B = b_jn, split and multiplied the same
//       way over all j.
//     HPT (8-column tiles of HP: 4, 8 or 16 for HP <= 32, 64, 128) sizes the
//     accumulators at compile time. Shared-memory rows of 36, 68 and
//     HPT * 8 + 8 or state columns + 8 floats keep the lanes (g, t) of a
//     fragment load on distinct banks. Dynamic shared memory at HPT 8:
//     2 KB of cum and dt plus two stages of 35 KB, with the largest
//     shared-memory carveout: three CTAs per SM (168 registers).
//  * TF32 rounding of hi is done on the integer pipe ((bits + 0x1000) &
//    ~0x1fff, what cvt.rna.tf32.f32 gives): cvt runs on the conversion pipe
//    at a quarter of the rate (0.272 ms a call with cvt, 0.251 without).
//  * Operands whose rows are 16-byte aligned (base and strides multiples
//    of four floats, HP or N a multiple of 4) are copied in 16-byte pieces;
//    others (a vmap fold or a caller's strided view) in 4-byte pieces, into
//    the same layout. Rows past CL and columns past HP or N read as zeros.
//  * Elementwise arithmetic in f32 with expf, no fast math and
//    --fmad=false (see _build.py), so W, v and x_j * v_j round as the plain
//    version's do; the products differ from the plain version's GEMMs only
//    by the order of their sums and the ~2^-21 relative error of a 3xTF32
//    product.
//
// C interface (loaded with ctypes): ssd_chunk_forward returns
// cudaGetLastError() after its launches, 0 on success. Both launches go to
// the caller's stream; nothing is allocated or synchronized here.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 128;          // four warps
constexpr int kTile = 64;              // rows of an i, j or S tile; N per state CTA
constexpr int kSlice = 32;             // N per staged slice of C and B
constexpr int kPadCB = kSlice + 4;     // shared row of a C or B slice
constexpr int kPadS = kTile + 4;       // shared row of an S tile
constexpr int kStateRows = 32;         // rows j per staged x and b tile (state)
constexpr int kMaxChunk = 256;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxState = 256;
constexpr int kHead = 2 * kMaxChunk;   // shared cum and dt (y), or v (state)

struct CbArgs {
  const float* b;
  const float* c;
  float* s;
  int NC, CL, N, CLP, ntri;
  long long bsb, bsc, bsl;
  long long csb, csc, csl;
  bool vec;   // b and c rows in 16-byte pieces
};

struct HeadArgs {
  const float* x;
  const float* dt;
  const float* a;
  const float* b;
  const float* s;
  float* cdv;   // (B * NC, NH, 3, CLP): cum, dt and v of each head, from launch 1
  float* y;
  float* states;
  float* cum_last;
  int B, NC, CL, NH, HP, N, CLP, ntiles, nslices;
  long long xsb, xsc, xsl, xsh;
  long long dsb, dsc, dsl, dsh;
  long long asb, ash;
  long long bsb, bsc, bsl;
  bool vec_x, vec_b;
};

// Issues the copies of a NROWS x width tile, rows [r0, r0 + NROWS) and
// columns [c0, c0 + width) of a row-major source with row stride `ld_src`,
// into dst with row stride `ld`; entries at rows >= rows or columns >= cols
// are zeros. `vec`: 16-byte pieces (width, c0, cols, the base and ld_src
// multiples of four floats), else 4-byte ones.
template <int NROWS = kTile>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, long long ld_src,
                                      int r0, int rows, int c0, int cols, int width, bool vec) {
  if (vec) {
    const int q = width / 4;
    for (int e = threadIdx.x; e < NROWS * q; e += kThreads) {
      const int r = e / q, col = (e % q) * 4;
      const bool ok = r0 + r < rows && c0 + col < cols;
      cp_async_16(dst + r * ld + col, ok ? src + (r0 + r) * ld_src + c0 + col : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < NROWS * width; e += kThreads) {
      const int r = e / width, col = e % width;
      const bool ok = r0 + r < rows && c0 + col < cols;
      cp_async_4(dst + r * ld + col, ok ? src + (r0 + r) * ld_src + c0 + col : src, ok);
    }
  }
}

// ---- launch 1: S = C.B^T, one causal 64 x 64 tile per CTA; each head's
// cum, dt and v ----

// smem: 2 stages x (C, B) x [kTile][kPadCB].
__device__ __forceinline__ void cb_tile(const CbArgs& g, float* smem, int tile) {
  const int bc = tile / g.ntri;
  int jt = tile % g.ntri, it = 0;
  while (jt > it) {   // the causal tiles (it, jt <= it) in row order
    jt -= it + 1;
    ++it;
  }
  const int ci = bc % g.NC, bi = bc / g.NC;
  const float* cb = g.c + bi * g.csb + ci * g.csc;
  const float* bb = g.b + bi * g.bsb + ci * g.bsc;
  const int i0 = it * kTile, j0 = jt * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
  constexpr int kStage = 2 * kTile * kPadCB;
  const int nsl = (g.N + kSlice - 1) / kSlice;

  auto load = [&](int sl, int st) {
    float* cs = smem + st * kStage;
    stage(cs, kPadCB, cb, g.csl, i0, g.CL, sl * kSlice, g.N, kSlice, g.vec);
    stage(cs + kTile * kPadCB, kPadCB, bb, g.bsl, j0, g.CL, sl * kSlice, g.N, kSlice, g.vec);
    cp_async_commit();
  };

  float acc[1][8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[0][nt][q] = 0.f;

  load(0, 0);
  for (int sl = 0; sl < nsl; ++sl) {
    if (sl + 1 < nsl) {
      load(sl + 1, (sl + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cs = smem + (sl & 1) * kStage;
    const float* bs = cs + kTile * kPadCB;
    const float* ca = cs + (16 * warp + gr) * kPadCB + tq;
#pragma unroll
    for (int k = 0; k < kSlice; k += 8) {
      uint32_t ah[1][4], al[1][4], bh[8][2], bl[8][2];
      split_tf32(ca[k], ah[0][0], al[0][0]);
      split_tf32(ca[8 * kPadCB + k], ah[0][1], al[0][1]);
      split_tf32(ca[k + 4], ah[0][2], al[0][2]);
      split_tf32(ca[8 * kPadCB + k + 4], ah[0][3], al[0][3]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float* bp = bs + (8 * nt + gr) * kPadCB + k + tq;
        split_tf32(bp[0], bh[nt][0], bl[nt][0]);
        split_tf32(bp[4], bh[nt][1], bl[nt][1]);
      }
      mma_3xtf32(acc, ah, al, bh, bl);
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }

  // The whole tile, padding rows and columns included (zeros there).
  float* sb = g.s + static_cast<long long>(bc) * g.CLP * g.CLP;
  const int r = i0 + 16 * warp + gr;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = j0 + 8 * nt + 2 * tq;
    *reinterpret_cast<float2*>(sb + static_cast<long long>(r) * g.CLP + col) =
        make_float2(acc[0][nt][0], acc[0][nt][1]);
    *reinterpret_cast<float2*>(sb + static_cast<long long>(r + 8) * g.CLP + col) =
        make_float2(acc[0][nt][2], acc[0][nt][3]);
  }
}

// Launch 1's per-head pass: one warp per head of one (batch row, chunk)
// writes the head's cum, dt and v rows of CLP floats to g.cdv, and cum_last.
// cum[l] = f32(sum_{l' <= l} f64(dt_l' * a)): each lane sums its 8
// consecutive terms in order, a shuffle scan adds the lanes before it (see
// the header for when the order of the f64 sums is free). Past CL, dt and v
// are 0 and cum stays cum[CL - 1].
__device__ __forceinline__ void cum_head(const HeadArgs& g, long long bc, int h) {
  constexpr int E = kMaxChunk / 32;
  const int lane = threadIdx.x % 32, CL = g.CL, CLP = g.CLP;
  const long long ci = bc % g.NC, bi = bc / g.NC;
  const float* db = g.dt + bi * g.dsb + ci * g.dsc + h * g.dsh;
  const float a = g.a[bi * g.asb + h * g.ash];
  float d[E];
  double run[E], s = 0.0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int l = lane * E + e;
    d[e] = l < CL ? db[l * g.dsl] : 0.f;
    s += static_cast<double>(d[e] * a);
    run[e] = s;
  }
  double incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  double before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.0;
  float cum[E], mine = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    cum[e] = static_cast<float>(before + run[e]);
    if (lane * E + e == CL - 1) mine = cum[e];
  }
  const float clast = __shfl_sync(0xffffffffu, mine, (CL - 1) / E);
  float v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = lane * E + e < CL ? expf(clast - cum[e]) * d[e] : 0.f;
  // Each lane's 8 entries as two 16-byte stores per row (CLP is a multiple
  // of 64, so a lane's entries are all inside the row or all past it).
  float* row = g.cdv + (bc * g.NH + h) * 3 * CLP + lane * E;
  if (lane * E < CLP) {
#pragma unroll
    for (int q = 0; q < E; q += 4) {
      *reinterpret_cast<float4*>(row + q) = make_float4(cum[q], cum[q + 1], cum[q + 2], cum[q + 3]);
      *reinterpret_cast<float4*>(row + CLP + q) = make_float4(d[q], d[q + 1], d[q + 2], d[q + 3]);
      *reinterpret_cast<float4*>(row + 2 * CLP + q) = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
    }
  }
  if (lane == 0) g.cum_last[bc * g.NH + h] = clast;
}

// ---- launch 2: per head, y_intra row tiles and state slices ----

// Copies `n` floats (a multiple of 4, 16-byte aligned on both sides).
__device__ __forceinline__ void stage_row(float* dst, const float* src, int n) {
  for (int e = 4 * threadIdx.x; e < n; e += 4 * kThreads) cp_async_16(dst + e, src + e, true);
}

// Stores a pair of adjacent entries (row r, columns col and col + 1) of a
// row-major output with `cols` columns; 8-byte stores when cols is even.
__device__ __forceinline__ void put2(float* row, int col, int cols, float v0, float v1) {
  if (cols % 2 == 0) {
    if (col < cols) *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
  } else {
    if (col < cols) row[col] = v0;
    if (col + 1 < cols) row[col + 1] = v1;
  }
}

template <int HPT>
__device__ __forceinline__ void y_tile(const HeadArgs& g, float* smem, long long bc, int h,
                                       int it) {
  constexpr int XS = HPT * 8 + 8;
  constexpr int kStage = kTile * kPadS + kTile * XS;
  const int CL = g.CL, HP = g.HP, NH = g.NH;
  const long long ci = bc % g.NC, bi = bc / g.NC;
  float* cum = smem;
  float* dts = smem + kMaxChunk;
  float* work = smem + kHead;
  const float* xb = g.x + bi * g.xsb + ci * g.xsc + h * g.xsh;
  const float* sb = g.s + bc * g.CLP * g.CLP;
  const float* cdv = g.cdv + (bc * NH + h) * 3 * g.CLP;
  const int i0 = it * kTile;

  auto load = [&](int jt, int st) {
    float* ss = work + st * kStage;
    stage(ss, kPadS, sb, g.CLP, i0, g.CLP, jt * kTile, g.CLP, kTile, true);
    stage(ss + kTile * kPadS, XS, xb, g.xsl, jt * kTile, CL, 0, HP, HPT * 8, g.vec_x);
    cp_async_commit();
  };

  stage_row(cum, cdv, g.CLP);   // cum and dt, in the first tile's group
  stage_row(dts, cdv + g.CLP, g.CLP);
  load(0, 0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
  const int ra = 16 * warp + gr;        // this lane's rows ra and ra + 8 of the tile
  const int ia = i0 + ra, ib = ia + 8;
  float cia = 0.f, cib = 0.f;           // cum_i of the two rows, once cum has landed
  const bool live = i0 + 16 * warp < CL;   // some row of this warp is in the chunk

  float acc[1][HPT][4];
#pragma unroll
  for (int nt = 0; nt < HPT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[0][nt][q] = 0.f;

  for (int jt = 0; jt <= it; ++jt) {
    if (jt < it) {
      load(jt + 1, (jt + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (jt == 0) {
      cia = cum[ia];
      cib = cum[ib];
    }
    const float* ss = work + (jt & 1) * kStage;
    const float* xs = ss + kTile * kPadS;
    const int j0 = jt * kTile;
    const int kend = live ? (jt == it ? 16 * warp + 16 : kTile) : 0;
    // W on the diagonal tile is masked (j <= i) before its exponent; below
    // it every j < i. Rows past CL are formed but never stored.
    auto step = [&](int k, bool diag) {
      const int ja = j0 + k + tq, jb = ja + 4;
      const float cja = cum[ja], cjb = cum[jb], dja = dts[ja], djb = dts[jb];
      const float* sp = ss + ra * kPadS + k + tq;
      float w[4];
      w[0] = (!diag || ja <= ia) ? (sp[0] * expf(cia - cja)) * dja : 0.f;
      w[1] = (!diag || ja <= ib) ? (sp[8 * kPadS] * expf(cib - cja)) * dja : 0.f;
      w[2] = (!diag || jb <= ia) ? (sp[4] * expf(cia - cjb)) * djb : 0.f;
      w[3] = (!diag || jb <= ib) ? (sp[8 * kPadS + 4] * expf(cib - cjb)) * djb : 0.f;
      uint32_t ah[1][4], al[1][4], bh[HPT][2], bl[HPT][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(w[q], ah[0][q], al[0][q]);
      const float* xp = xs + (k + tq) * XS + gr;
#pragma unroll
      for (int nt = 0; nt < HPT; ++nt) {
        split_tf32(xp[8 * nt], bh[nt][0], bl[nt][0]);
        split_tf32(xp[4 * XS + 8 * nt], bh[nt][1], bl[nt][1]);
      }
      mma_3xtf32(acc, ah, al, bh, bl);
    };
    if (jt < it && live) {   // unrolled, so loads run ahead of the products
#pragma unroll
      for (int k = 0; k < kTile; k += 8) step(k, false);
    } else {
      for (int k = 0; k < kend; k += 8) step(k, true);
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }

  float* yb = g.y + (bc * CL * NH + h) * HP;
#pragma unroll
  for (int nt = 0; nt < HPT; ++nt) {
    const int p = 8 * nt + 2 * tq;
    if (ia < CL)
      put2(yb + static_cast<long long>(ia) * NH * HP, p, HP, acc[0][nt][0], acc[0][nt][1]);
    if (ib < CL)
      put2(yb + static_cast<long long>(ib) * NH * HP, p, HP, acc[0][nt][2], acc[0][nt][3]);
  }
}

// 8-column tiles of n per warp in the state role, and the columns of n a
// state CTA covers (four warps side by side).
template <int HPT>
__host__ __device__ constexpr int state_tiles() { return HPT <= 8 ? 4 : 2; }
template <int HPT>
__host__ __device__ constexpr int state_cols() { return 4 * 8 * state_tiles<HPT>(); }

template <int HPT>
__device__ __forceinline__ void state_tile(const HeadArgs& g, float* smem, long long bc, int h,
                                           int ns) {
  constexpr int XS = HPT * 8 + 8;
  constexpr int MT = HPT / 2;                   // 16-row tiles of p
  constexpr int NT = state_tiles<HPT>();        // 8-column tiles of n per warp
  constexpr int PB = state_cols<HPT>() + 8;     // shared row of a b tile
  constexpr int JS = kStateRows;
  constexpr int kStage = JS * XS + JS * PB;
  const int CL = g.CL, HP = g.HP, N = g.N, NH = g.NH;
  const long long ci = bc % g.NC, bi = bc / g.NC;
  float* vs = smem;
  float* work = smem + kHead;
  const float* xb = g.x + bi * g.xsb + ci * g.xsc + h * g.xsh;
  const float* bb = g.b + bi * g.bsb + ci * g.bsc;
  const float* cdv = g.cdv + (bc * NH + h) * 3 * g.CLP;
  const int n0 = ns * state_cols<HPT>();
  const int njt = (CL + JS - 1) / JS;

  auto load = [&](int jt, int st) {
    float* xs = work + st * kStage;
    stage<JS>(xs, XS, xb, g.xsl, jt * JS, CL, 0, HP, HPT * 8, g.vec_x);
    stage<JS>(xs + JS * XS, PB, bb, g.bsl, jt * JS, CL, n0, N, state_cols<HPT>(), g.vec_b);
    cp_async_commit();
  };

  stage_row(vs, cdv + 2 * g.CLP, g.CLP);   // v, in the first tile's group
  load(0, 0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
  const int nw = 8 * NT * warp;            // this warp's first column of the slice
  const bool live = n0 + nw < N;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  for (int jt = 0; jt < njt; ++jt) {
    if (jt + 1 < njt) {
      load(jt + 1, (jt + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xs = work + (jt & 1) * kStage;
    const float* bs = xs + JS * XS;
    const int j0 = jt * JS;
    const int kend = live ? min(JS, (CL - j0 + 7) & ~7) : 0;
    auto step = [&](int k) {
      const float va = vs[j0 + k + tq], vb = vs[j0 + k + tq + 4];
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* bp = bs + (k + tq) * PB + nw + 8 * nt + gr;
        split_tf32(bp[0], bh[nt][0], bl[nt][0]);
        split_tf32(bp[4 * PB], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* xp = xs + (k + tq) * XS + 16 * mt + gr;
        split_tf32(xp[0] * va, ah[mt][0], al[mt][0]);
        split_tf32(xp[8] * va, ah[mt][1], al[mt][1]);
        split_tf32(xp[4 * XS] * vb, ah[mt][2], al[mt][2]);
        split_tf32(xp[4 * XS + 8] * vb, ah[mt][3], al[mt][3]);
      }
      mma_3xtf32(acc, ah, al, bh, bl);
    };
    if (kend == JS) {
#pragma unroll
      for (int k = 0; k < JS; k += 8) step(k);
    } else {
      for (int k = 0; k < kend; k += 8) step(k);
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }

  float* sb = g.states + (bc * NH + h) * HP * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int p = 16 * mt + gr, n = n0 + nw + 8 * nt + 2 * tq;
      if (p < HP) put2(sb + static_cast<long long>(p) * N, n, N, acc[mt][nt][0], acc[mt][nt][1]);
      if (p + 8 < HP)
        put2(sb + static_cast<long long>(p + 8) * N, n, N, acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// ---- the two kernels ----

// Launch 1: the causal tiles of S, then cum, dt and v of every head (four
// heads, one a warp, per CTA).
__global__ void __launch_bounds__(kThreads) ssd_chunk_cb_kernel(CbArgs cb, HeadArgs g) {
  extern __shared__ __align__(16) float smem[];
  const long long tiles = static_cast<long long>(g.B) * g.NC * cb.ntri;
  if (blockIdx.x < tiles) {
    cb_tile(cb, smem, static_cast<int>(blockIdx.x));
  } else {
    const int groups = (g.NH + 3) / 4;
    const long long r = blockIdx.x - tiles;
    const int h = static_cast<int>(r % groups) * 4 + static_cast<int>(threadIdx.x / 32);
    if (h < g.NH) cum_head(g, r / groups, h);
  }
}

// Launch 2: the state slices, then the row tiles of y, those with the most
// causal j tiles first; in one launch, so the two parts overlap.
template <int HPT>
__global__ void __launch_bounds__(kThreads, HPT == 16 ? 2 : 3) ssd_chunk_heads_kernel(HeadArgs g) {
  extern __shared__ __align__(16) float smem[];
  const long long heads = static_cast<long long>(g.B) * g.NC * g.NH;
  long long r = blockIdx.x;
  if (r < heads * g.nslices) {
    const long long q = r % heads;
    state_tile<HPT>(g, smem, q / g.NH, static_cast<int>(q % g.NH), static_cast<int>(r / heads));
  } else {
    r -= heads * g.nslices;
    const long long q = r % heads;
    y_tile<HPT>(g, smem, q / g.NH, static_cast<int>(q % g.NH),
                g.ntiles - 1 - static_cast<int>(r / heads));
  }
}

constexpr size_t kCbSmem = sizeof(float) * 2 * 2 * kTile * kPadCB;

template <int HPT>
constexpr size_t heads_smem() {
  constexpr int XS = HPT * 8 + 8;
  constexpr int y = kTile * kPadS + kTile * XS;
  constexpr int st = kStateRows * (XS + state_cols<HPT>() + 8);
  return sizeof(float) * (kHead + 2 * (y > st ? y : st));
}

// A kernel's dynamic shared memory, and the largest carveout of shared
// memory from L1, so that three heads CTAs fit an SM at HPT 8.
template <typename K>
cudaError_t configure(K kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int HPT>
cudaError_t launch(const CbArgs& cb, HeadArgs g, cudaStream_t stream) {
  cudaError_t err = configure(ssd_chunk_cb_kernel, kCbSmem);
  if (err != cudaSuccess) return err;
  const long long ctas1 = static_cast<long long>(g.B) * g.NC * (cb.ntri + (g.NH + 3) / 4);
  ssd_chunk_cb_kernel<<<static_cast<unsigned>(ctas1), kThreads, kCbSmem, stream>>>(cb, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = configure(ssd_chunk_heads_kernel<HPT>, heads_smem<HPT>());
  if (err != cudaSuccess) return err;
  g.nslices = (g.N + state_cols<HPT>() - 1) / state_cols<HPT>();
  const long long ctas = static_cast<long long>(g.B) * g.NC * g.NH * (g.nslices + g.ntiles);
  ssd_chunk_heads_kernel<HPT><<<static_cast<unsigned>(ctas), kThreads, heads_smem<HPT>(),
                                stream>>>(g);
  return cudaGetLastError();
}

// CTAs of the heads kernel an SM holds.
template <int HPT>
int occupancy() {
  int n = 0;
  if (configure(ssd_chunk_heads_kernel<HPT>, heads_smem<HPT>()) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssd_chunk_heads_kernel<HPT>, kThreads,
                                                    heads_smem<HPT>()) != cudaSuccess)
    return -1;
  return n;
}

bool aligned16(const void* p, std::initializer_list<long long> strides) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (long long s : strides)
    if (s % 4) return false;
  return true;
}

}  // namespace

extern "C" {

// Strides are in elements: x (B, NC, CL, NH), dt (B, NC, CL, NH), a (B, NH),
// b and c (B, NC, CL); the last dimension of x, b and c is contiguous.
// scratch: (B * NC, CLP, CLP) f32, CLP = CL rounded up to 64; cdv:
// (B * NC, NH, 3, CLP) f32.
int ssd_chunk_forward(const float* x, const float* dt, const float* a, const float* b,
                      const float* c, float* y, float* states, float* cum_last, float* scratch,
                      float* cdv,
                      int B, int NC, int CL, int NH, int HP, int N,
                      long long xsb, long long xsc, long long xsl, long long xsh,
                      long long dsb, long long dsc, long long dsl, long long dsh,
                      long long asb, long long ash,
                      long long bsb, long long bsc, long long bsl,
                      long long csb, long long csc, long long csl, void* stream) {
  if (CL < 1 || CL > kMaxChunk || HP < 1 || HP > kMaxHeadDim || N < 1 || N > kMaxState)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = (CL + kTile - 1) / kTile, CLP = ntiles * kTile;
  const bool vec_b = N % 4 == 0 && aligned16(b, {bsb, bsc, bsl});
  const bool vec_c = N % 4 == 0 && aligned16(c, {csb, csc, csl});

  const CbArgs cb{b, c, scratch, NC, CL, N, CLP, ntiles * (ntiles + 1) / 2,
                  bsb, bsc, bsl, csb, csc, csl, vec_b && vec_c};
  const HeadArgs g{x, dt, a, b, scratch, cdv, y, states, cum_last,
                   B, NC, CL, NH, HP, N, CLP, ntiles, 0,
                   xsb, xsc, xsl, xsh, dsb, dsc, dsl, dsh, asb, ash, bsb, bsc, bsl,
                   HP % 4 == 0 && aligned16(x, {xsb, xsc, xsl, xsh}), vec_b};
  const cudaError_t err = HP <= 32   ? launch<4>(cb, g, st)
                          : HP <= 64 ? launch<8>(cb, g, st)
                                     : launch<16>(cb, g, st);
  return static_cast<int>(err);
}

// CTAs of the heads kernel an SM holds at head dim HP; -1 on an error.
int ssd_occupancy(int HP) {
  return HP <= 32 ? occupancy<4>() : HP <= 64 ? occupancy<8>() : occupancy<16>();
}

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
