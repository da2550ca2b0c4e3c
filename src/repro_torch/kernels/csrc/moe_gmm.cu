// Grouped matmul (K6) for Hopper (sm_90a): the MoE expert products.
//
// Replaces the Pallas TPU kernel _gmm_kernel of the reference
// (src/repro/kernels/moe_gmm.py, launched from gmm_padded through
// grouped_matmul), the grouped matmul a deployment swaps in for the
// jax.lax.ragged_dot calls of models/moe.py _grouped_ffn. For every row of
// xs (M, K), sorted by group, it computes row(f32) @ rhs[group](f32) with f32
// accumulation and rounds once to xs's dtype; rows past the last group are
// zero (ragged_dot's contract). The plain PyTorch version, with the same
// layout, is gmm_plain in repro_torch/kernels/moe_gmm.py.
//
// Layout. The rows are cut into the reference's group-aligned padded layout:
// each group's rows padded to a multiple of block_m, so every block of
// block_m rows belongs to one group. Here the layout is never materialized:
// each CTA finds its block's group, first row and row count from the group
// sizes (locate), reads those rows of xs in place and writes those rows of
// out; padding rows are neither read, multiplied nor written. The cohort is
// folded in: `clients` row ranges of `rows` rows each, client c's group g
// reading rhs at c*rc + g*rg (rc = 0 when the clients share the weights), so
// client c's expert g is group c*G + g of one launch. Rows of a client past
// its last group form a trailing block of zeros: written, not multiplied.
// rhs is read through its strides; the k and n strides may be swapped, so
// the backward's dX = dY @ rhs[g]^T is the same kernel on a transposed view.
//
// Bound on an H100: at the federated kimi-k2 share's shape (4 clients x 8
// experts, K 7168 -> N 2048 and 2048 -> 7168, ~5 rows per (client, expert)
// of 8192 pair rows) the launch must read every expert's weights once,
// 940 MB, 0.28 ms at 3.35 TB/s; its ~5 GFLOP take 5 us at the bf16 tensor
// rate. It is bound by bytes: the design keeps many weight loads in flight
// and spends no work on padding.
//
// Design (bf16):
//  * One CTA of 128 threads (4 warps) per (block, 64-column tile). A loop
//    over K in 64-deep chunks takes the place of the TPU's whole-K block.
//    Each chunk's xs rows (only the block's live 16-row slabs) and its rhs
//    tile are staged through shared memory; the next chunk's global loads
//    are issued into registers before the current chunk is multiplied.
//  * Each warp owns 16 columns (two n8 tiles) and every live m16 slab:
//    mma.sync m16n8k16 bf16 -> f32, accumulators in registers. bf16
//    products are exact in f32, so the result differs from the plain
//    version (f32 matmul of the upcast operands) only by summation order.
//  * Shared tiles are stored k-contiguous (the B fragment's order) with an
//    XOR swizzle of 4-word groups by row, so the fragment reads and the
//    transposing stores of an n-contiguous rhs are free of bank conflicts.
//  * Slabs past the block's row count are skipped: a block of 5 rows costs
//    one slab. Blocks past the last group exit at once.
// The f32 path (tests and f32 parity; no tensor-core f32 product is exact)
// is a plain tiled FMA loop; the library is built with --fmad=false, so each
// multiply-add is a separate multiply and add.
//
// C interface (loaded with ctypes): gmm_forward returns cudaGetLastError()
// after its launch, 0 on success. The launch goes to the caller's stream;
// nothing is allocated or synchronized here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBlockM = 128;
constexpr int kBN = 64;                  // output columns per CTA
constexpr int kBK = 64;                  // K per chunk
constexpr int kWords = kBK / 2;          // 32-bit words per shared row (32: one per bank)
constexpr int kThreads = 128;
constexpr int kSlabs = kMaxBlockM / 16;  // m16 slabs of a block
constexpr int kAVecs = kMaxBlockM * kBK / 8 / kThreads;  // 16-byte vectors per thread
constexpr int kBVecs = kBN * kBK / 8 / kThreads;
// f32 path
constexpr int kFBK = 32;
constexpr int kFRows = kMaxBlockM / (kThreads / kBN);    // rows per thread

struct Shape {
  int clients, groups, rows, K, N, block_m;
  long long xs_stride;      // elements between rows of xs (last dim contiguous)
  long long rc, rg, rk, rn; // rhs strides: client, group, k, n
  int a_vec;                // xs rows load as aligned 16-byte vectors
  int b_mode;               // 0: rn == 1, vectors along n; 1: rk == 1, along k; 2: scalar
};

struct Block {
  int group;   // c * groups + g; -1: rows past a client's last group (zeros)
  int row0;    // first row of xs / out
  int nrows;   // rows of the block that hold data; 0: nothing to do
};

// Block b of the padded layout: client by client, each of its groups and
// then its rest, each padded to a multiple of block_m. Sizes are clamped so
// that a client's groups never run past its rows.
__device__ Block locate(const int* __restrict__ sizes, const Shape& sh, int b) {
  const long long start = static_cast<long long>(b) * sh.block_m;
  long long poff = 0;
  int roff = 0;
  for (int c = 0; c < sh.clients; ++c) {
    int left = sh.rows;
    for (int g = 0; g <= sh.groups; ++g) {
      int size = g < sh.groups ? sizes[c * sh.groups + g] : left;
      size = max(0, min(size, left));
      left -= size;
      const long long padded =
          static_cast<long long>((size + sh.block_m - 1) / sh.block_m) * sh.block_m;
      if (start < poff + padded) {
        const int r = static_cast<int>(start - poff);
        return {g < sh.groups ? c * sh.groups + g : -1, roff + r, min(sh.block_m, size - r)};
      }
      poff += padded;
      roff += size;
    }
  }
  return {-1, 0, 0};
}

// Physical 32-bit word of word w in shared row `row` (kWords words a row).
__device__ __forceinline__ int swz(int row, int w) {
  return w ^ (((row & 7) ^ ((row >> 3) & 7)) << 2);
}

union Vec {
  uint4 u;
  uint32_t w[4];
  unsigned short h[8];   // bf16 bit patterns
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void set_zero(float* p) { *p = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16* p) { *p = __float2bfloat16(0.f); }

template <typename T>
__device__ void write_zeros(T* __restrict__ out, const Block& blk, int n0, int N) {
  for (int i = threadIdx.x; i < blk.nrows * kBN; i += kThreads) {
    const int r = i / kBN, n = n0 + i % kBN;
    if (n < N) set_zero(out + static_cast<long long>(blk.row0 + r) * N + n);
  }
}

__global__ void __launch_bounds__(kThreads)
gmm_bf16_kernel(const __nv_bfloat16* __restrict__ xs, const __nv_bfloat16* __restrict__ rhs,
                const int* __restrict__ sizes, __nv_bfloat16* __restrict__ out, Shape sh) {
  __shared__ __align__(16) uint32_t As[kMaxBlockM * kWords];
  __shared__ __align__(16) uint32_t Bs[kBN * kWords];
  __shared__ Block s_blk;
  if (threadIdx.x == 0) s_blk = locate(sizes, sh, blockIdx.x);
  __syncthreads();
  const Block blk = s_blk;
  if (blk.nrows <= 0) return;
  const int n0 = blockIdx.y * kBN;
  if (blk.group < 0) {
    write_zeros(out, blk, n0, sh.N);
    return;
  }

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int live = (blk.nrows + 15) / 16;   // m16 slabs with data
  const __nv_bfloat16* w = rhs + (blk.group / sh.groups) * sh.rc +
                           static_cast<long long>(blk.group % sh.groups) * sh.rg;
  const __nv_bfloat16* x = xs + static_cast<long long>(blk.row0) * sh.xs_stride;

  Vec areg[kAVecs], breg[kBVecs];

  // Global -> registers for chunk kc: xs rows of the live slabs (vector v:
  // row v / 8, k offset (v % 8) * 8), then the rhs tile.
  auto load = [&](int kc) {
#pragma unroll
    for (int i = 0; i < kAVecs; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / 8, k = kc + (v % 8) * 8;
      if (r >= live * 16) continue;
      if (sh.a_vec) {
        areg[i].u = (r < blk.nrows && k < sh.K)
            ? *reinterpret_cast<const uint4*>(x + r * sh.xs_stride + k) : make_uint4(0, 0, 0, 0);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          areg[i].h[j] = (r < blk.nrows && k + j < sh.K)
              ? __bfloat16_as_ushort(x[r * sh.xs_stride + k + j]) : 0;
      }
    }
#pragma unroll
    for (int i = 0; i < kBVecs; ++i) {
      const int v = tid + i * kThreads;
      if (sh.b_mode == 1) {           // k-contiguous: row n = v / 8, k offset (v % 8) * 8
        const int n = n0 + v / 8, k = kc + (v % 8) * 8;
        breg[i].u = (n < sh.N && k < sh.K)
            ? *reinterpret_cast<const uint4*>(w + n * sh.rn + k) : make_uint4(0, 0, 0, 0);
      } else {                        // row k = v / 8, n offset (v % 8) * 8
        const int k = kc + v / 8, n = n0 + (v % 8) * 8;
        if (sh.b_mode == 0) {
          breg[i].u = (k < sh.K && n < sh.N)
              ? *reinterpret_cast<const uint4*>(w + k * sh.rk + n) : make_uint4(0, 0, 0, 0);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            breg[i].h[j] = (k < sh.K && n + j < sh.N)
                ? __bfloat16_as_ushort(w[k * sh.rk + (n + j) * sh.rn]) : 0;
        }
      }
    }
  };

  // Registers -> shared, k-contiguous rows with the swizzle.
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < kAVecs; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / 8;
      if (r >= live * 16) continue;
      *reinterpret_cast<uint4*>(As + r * kWords + swz(r, (v % 8) * 4)) = areg[i].u;
    }
#pragma unroll
    for (int i = 0; i < kBVecs; ++i) {
      const int v = tid + i * kThreads;
      if (sh.b_mode == 1) {
        const int n = v / 8;
        *reinterpret_cast<uint4*>(Bs + n * kWords + swz(n, (v % 8) * 4)) = breg[i].u;
      } else {
        const int k = v / 8, nb = (v % 8) * 8;
        unsigned short* b16 = reinterpret_cast<unsigned short*>(Bs);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = nb + j;
          b16[(n * kWords + swz(n, k / 2)) * 2 + (k & 1)] = breg[i].h[j];
        }
      }
    }
  };

  float acc[kSlabs][2][4];
#pragma unroll
  for (int s = 0; s < kSlabs; ++s)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][t][e] = 0.f;

  const int nk = (sh.K + kBK - 1) / kBK;
  load(0);
  store();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) * kBK);
#pragma unroll
    for (int ks = 0; ks < kWords; ks += 8) {   // 16-deep k steps, in words
      uint32_t b[2][2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int n = warp * 16 + t * 8 + gid;
        b[t][0] = Bs[n * kWords + swz(n, ks + tig)];
        b[t][1] = Bs[n * kWords + swz(n, ks + tig + 4)];
      }
#pragma unroll
      for (int s = 0; s < kSlabs; ++s) {
        if (s >= live) break;
        const int r0 = s * 16 + gid, r1 = r0 + 8;
        uint32_t a[4];
        a[0] = As[r0 * kWords + swz(r0, ks + tig)];
        a[1] = As[r1 * kWords + swz(r1, ks + tig)];
        a[2] = As[r0 * kWords + swz(r0, ks + tig + 4)];
        a[3] = As[r1 * kWords + swz(r1, ks + tig + 4)];
        mma_bf16(acc[s][0], a, b[0]);
        mma_bf16(acc[s][1], a, b[1]);
      }
    }
    __syncthreads();
    if (kt + 1 < nk) {
      store();
      __syncthreads();
    }
  }

#pragma unroll
  for (int s = 0; s < kSlabs; ++s) {
    if (s >= live) break;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = s * 16 + gid + (e >= 2 ? 8 : 0);
        const int n = n0 + warp * 16 + t * 8 + tig * 2 + (e & 1);
        if (r < blk.nrows && n < sh.N)
          out[static_cast<long long>(blk.row0 + r) * sh.N + n] = __float2bfloat16_rn(acc[s][t][e]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gmm_f32_kernel(const float* __restrict__ xs, const float* __restrict__ rhs,
               const int* __restrict__ sizes, float* __restrict__ out, Shape sh) {
  __shared__ float As[kMaxBlockM][kFBK + 1];
  __shared__ float Bs[kFBK][kBN];
  __shared__ Block s_blk;
  if (threadIdx.x == 0) s_blk = locate(sizes, sh, blockIdx.x);
  __syncthreads();
  const Block blk = s_blk;
  if (blk.nrows <= 0) return;
  const int n0 = blockIdx.y * kBN;
  if (blk.group < 0) {
    write_zeros(out, blk, n0, sh.N);
    return;
  }
  const float* w = rhs + (blk.group / sh.groups) * sh.rc +
                   static_cast<long long>(blk.group % sh.groups) * sh.rg;
  const float* x = xs + static_cast<long long>(blk.row0) * sh.xs_stride;
  const int col = threadIdx.x % kBN, rp = threadIdx.x / kBN;  // rows rp, rp + 2, ...

  float acc[kFRows];
#pragma unroll
  for (int i = 0; i < kFRows; ++i) acc[i] = 0.f;

  for (int kc = 0; kc < sh.K; kc += kFBK) {
    for (int i = threadIdx.x; i < blk.nrows * kFBK; i += kThreads) {
      const int r = i / kFBK, k = kc + i % kFBK;
      As[r][i % kFBK] = k < sh.K ? x[r * sh.xs_stride + k] : 0.f;
    }
    for (int i = threadIdx.x; i < kFBK * kBN; i += kThreads) {
      const int k = kc + i / kBN, n = n0 + i % kBN;
      Bs[i / kBN][i % kBN] = (k < sh.K && n < sh.N) ? w[k * sh.rk + n * sh.rn] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kFBK; ++kk) {
      const float b = Bs[kk][col];
#pragma unroll
      for (int i = 0; i < kFRows; ++i) {
        const int r = rp + 2 * i;
        if (r < blk.nrows) acc[i] += As[r][kk] * b;
      }
    }
    __syncthreads();
  }
  const int n = n0 + col;
#pragma unroll
  for (int i = 0; i < kFRows; ++i) {
    const int r = rp + 2 * i;
    if (r < blk.nrows && n < sh.N) out[static_cast<long long>(blk.row0 + r) * sh.N + n] = acc[i];
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (xs, rhs and out alike). xs is
// (clients * rows, K) with row stride xs_stride and a contiguous last
// dimension; rhs is read at c * rc + g * rg + k * rk + n * rn (elements);
// sizes is (clients, groups) int32; out is (clients * rows, N) contiguous.
int gmm_forward(int dtype, const void* xs, const void* rhs, const int* sizes, void* out,
                int clients, int groups, int rows, int K, int N, int block_m,
                long long xs_stride, long long rc, long long rg, long long rk,
                long long rn, void* stream) {
  if (clients < 1 || groups < 1 || rows < 0 || K < 1 || N < 1 || block_m < 1 ||
      block_m > kMaxBlockM)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(clients) * rows;
  const long long nblocks = (total + block_m - 1) / block_m +
                            static_cast<long long>(clients) * (groups + 1);
  const long long ntiles = (N + kBN - 1) / kBN;
  if (nblocks > 0x7fffffffLL || ntiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Shape sh{clients, groups, rows, K, N, block_m, xs_stride, rc, rg, rk, rn, 0, 2};
  const dim3 grid(static_cast<unsigned>(nblocks), static_cast<unsigned>(ntiles));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    gmm_f32_kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(xs),
                                             static_cast<const float*>(rhs), sizes,
                                             static_cast<float*>(out), sh);
  } else if (dtype == 1) {
    const bool strides8 = rc % 8 == 0 && rg % 8 == 0;
    sh.a_vec = K % 8 == 0 && xs_stride % 8 == 0 && aligned16(xs);
    if (rn == 1 && N % 8 == 0 && rk % 8 == 0 && strides8 && aligned16(rhs))
      sh.b_mode = 0;
    else if (rk == 1 && K % 8 == 0 && rn % 8 == 0 && strides8 && aligned16(rhs))
      sh.b_mode = 1;
    gmm_bf16_kernel<<<grid, kThreads, 0, st>>>(static_cast<const __nv_bfloat16*>(xs),
                                              static_cast<const __nv_bfloat16*>(rhs), sizes,
                                              static_cast<__nv_bfloat16*>(out), sh);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
