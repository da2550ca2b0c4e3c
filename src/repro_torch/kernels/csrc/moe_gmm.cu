// Grouped matmul (K6) for Hopper (sm_90a): the MoE expert products.
//
// Replaces the Pallas TPU kernel _gmm_kernel of the reference
// (src/repro/kernels/moe_gmm.py:32, launched from gmm_padded through
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
// out; padding rows are neither multiplied nor written. The cohort is
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
// rate. It is bound by bytes, and what sets the pace is how many weight
// bytes are in flight on each SM: ~3.35 TB/s x ~1 us / 132 SMs = 25 KB.
//
// bf16 design (gmm_bf16_kernel):
//  * One CTA per (block, 64-column tile): 4 consumer warps and 1 producer
//    warp. The producer streams the weight tile (64 k x 64 n, 8 KB) and the
//    block's live 16-row slabs of xs (64 k each) of every 64-deep K chunk
//    with TMA into a 4-stage ring, each stage guarded by a "full" and an
//    "empty" mbarrier: 32 KB of weights in flight per CTA, two CTAs per SM.
//    Tiles land with the 128-byte swizzle, so fragment loads are free of
//    bank conflicts. An n-contiguous rhs and a k-contiguous one (the dX
//    view) each get their own tensor map; an operand whose base or strides
//    are not 16-byte aligned is copied by the producer warp with ordinary
//    loads into the same swizzled layout.
//  * Each consumer warp owns 16 columns (two n8 tiles) and every live m16
//    slab: ldmatrix (transposed for an n-contiguous rhs) and mma.sync
//    m16n8k16 bf16 -> f32, accumulators in registers. bf16 products are
//    exact in f32, so the result differs from the plain version (f32
//    matmul of the upcast operands) only by summation order. A slab's rows
//    past the block are multiplied but never stored.
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
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxBlockM = 128;
constexpr int kBN = 64;                  // output columns per CTA
constexpr int kBK = 64;                  // K per chunk: one 128-byte swizzled row
constexpr int kStages = 4;               // chunks in flight
constexpr int kConsumers = 128;          // 4 warps
constexpr int kThreads = kConsumers + 32;
constexpr int kSlabs = kMaxBlockM / 16;  // m16 slabs of a block
constexpr int kBTile = kBN * kBK * 2;    // bytes of a weight tile
constexpr int kSlabBytes = 16 * kBK * 2; // bytes of a 16-row slab of xs
// f32 path
constexpr int kFThreads = 128;
constexpr int kFBK = 32;
constexpr int kFRows = kMaxBlockM / (kFThreads / kBN);   // rows per thread

struct Shape {
  int clients, groups, rows, K, N, block_m;
  long long xs_stride;      // elements between rows of xs (last dim contiguous)
  long long rc, rg, rk, rn; // rhs strides: client, group, k, n
  int a_tma;                // xs slabs stream by TMA
  int b_mode;               // 0: TMA, n-contiguous; 1: TMA, k-contiguous; 2: copied
  int slabs;                // slabs of a stage: ceil(block_m / 16)
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

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of 128-byte
// rows with TMA's 128-byte swizzle (the tile 1024-byte aligned).
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void set_zero(float* p) { *p = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16* p) { *p = __float2bfloat16(0.f); }

// Rows of a block past its client's last group: zeros, in 16-byte stores
// where the row allows them.
template <typename T>
__device__ void write_zeros(T* __restrict__ out, const Block& blk, int n0, int N) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = N % kVec == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int i = threadIdx.x; i < blk.nrows * (kBN / kVec); i += blockDim.x) {
    const int r = i / (kBN / kVec), n = n0 + (i % (kBN / kVec)) * kVec;
    T* o = out + static_cast<long long>(blk.row0 + r) * N + n;
    if (vec && n + kVec <= N) {
      *reinterpret_cast<uint4*>(o) = make_uint4(0, 0, 0, 0);
    } else {
      for (int j = 0; j < kVec && n + j < N; ++j) set_zero(o + j);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gmm_bf16_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                const __nv_bfloat16* __restrict__ xs, const __nv_bfloat16* __restrict__ rhs,
                const int* __restrict__ sizes, __nv_bfloat16* __restrict__ out, Shape sh) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int stage_bytes = kBTile + sh.slabs * kSlabBytes;   // [weights][xs slabs]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * stage_bytes);
  uint64_t* empty = full + kStages;
  __shared__ Block s_blk;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    s_blk = locate(sizes, sh, blockIdx.x);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const Block blk = s_blk;
  if (blk.nrows <= 0) return;
  const int n0 = blockIdx.y * kBN;
  if (blk.group < 0) {
    write_zeros(out, blk, n0, sh.N);
    return;
  }
  const int c = blk.group / sh.groups, g = blk.group % sh.groups;
  const int live = (blk.nrows + 15) / 16;   // m16 slabs with data
  const int nk = (sh.K + kBK - 1) / kBK;

  if (tid >= kConsumers) {   // producer warp
    const __nv_bfloat16* w = rhs + c * sh.rc + static_cast<long long>(g) * sh.rg;
    const __nv_bfloat16* x = xs + static_cast<long long>(blk.row0) * sh.xs_stride;
    const int cm = sh.rc ? c : 0;   // client coordinate of the weights' map
    const uint32_t tx = (sh.b_mode < 2 ? kBTile : 0) + (sh.a_tma ? live * kSlabBytes : 0);
    for (int i = 0; i < nk; ++i) {
      const int st = i % kStages, kc = i * kBK;
      mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
      uint8_t* bs = smem + st * stage_bytes;
      uint8_t* as = bs + kBTile;
      if (sh.b_mode == 2) {   // rows n, k contiguous, as the k-contiguous map lays them
        for (int v = lane; v < kBN * 8; v += 32) {
          const int n = v / 8, ch = v % 8;
          hopper::Vec8 e;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int k = kc + ch * 8 + j;
            e.h[j] = (k < sh.K && n0 + n < sh.N)
                ? __bfloat16_as_ushort(w[k * sh.rk + (n0 + n) * sh.rn]) : 0;
          }
          *reinterpret_cast<uint4*>(bs + swz(n, ch)) = e.u;
        }
      }
      if (!sh.a_tma) {
        for (int v = lane; v < live * 16 * 8; v += 32) {
          const int r = v / 8, ch = v % 8;
          hopper::Vec8 e;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int k = kc + ch * 8 + j;
            e.h[j] = (r < blk.nrows && k < sh.K) ? __bfloat16_as_ushort(x[r * sh.xs_stride + k]) : 0;
          }
          *reinterpret_cast<uint4*>(as + swz(r, ch)) = e.u;
        }
      }
      if (sh.b_mode == 2 || !sh.a_tma) {
        fence_proxy_async();
        __syncwarp();
      }
      if (lane == 0) {
        if (tx) mbar_arrive_expect_tx(&full[st], tx);
        else mbar_arrive(&full[st]);
        if (sh.b_mode == 0) tma_load_4d(bs, &bmap, &full[st], n0, kc, g, cm);
        if (sh.b_mode == 1) tma_load_4d(bs, &bmap, &full[st], kc, n0, g, cm);
        if (sh.a_tma)
          for (int s = 0; s < live; ++s)
            tma_load_2d(as + s * kSlabBytes, &amap, &full[st], kc, blk.row0 + s * 16);
      }
    }
    return;
  }

  const int warp = tid / 32, gid = lane / 4, tig = lane % 4;
  const int mat = lane / 8, mr = lane % 8;   // ldmatrix: matrix and row this lane addresses
  float acc[kSlabs][2][4];
#pragma unroll
  for (int s = 0; s < kSlabs; ++s)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][t][e] = 0.f;

  for (int i = 0; i < nk; ++i) {
    const int st = i % kStages;
    mbar_wait(&full[st], (i / kStages) & 1);
    const uint32_t bs = smem_addr(smem + st * stage_bytes);
    const uint32_t as = bs + kBTile;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t b[4];   // (n8 tile 0: k 0-7, k 8-15), (n8 tile 1: k 0-7, k 8-15)
      if (sh.b_mode == 0) {
        const int k = ks * 16 + (mat % 2) * 8 + mr;
        ldmatrix_x4_trans(b, bs + swz(k, warp * 2 + mat / 2));
      } else {
        const int n = warp * 16 + (mat / 2) * 8 + mr;
        ldmatrix_x4(b, bs + swz(n, ks * 2 + mat % 2));
      }
#pragma unroll
      for (int s = 0; s < kSlabs; ++s) {
        if (s >= live) break;
        uint32_t a[4];
        const int r = s * 16 + (mat % 2) * 8 + mr;
        ldmatrix_x4(a, as + swz(r, ks * 2 + mat / 2));
        mma_bf16(acc[s][0], a, b[0], b[1]);
        mma_bf16(acc[s][1], a, b[2], b[3]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  const bool pairs = sh.N % 2 == 0;
#pragma unroll
  for (int s = 0; s < kSlabs; ++s) {
    if (s >= live) break;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = s * 16 + gid + h * 8;
        const int n = n0 + warp * 16 + t * 8 + tig * 2;
        if (r >= blk.nrows) continue;
        __nv_bfloat16* o = out + static_cast<long long>(blk.row0 + r) * sh.N + n;
        if (pairs && n + 1 < sh.N) {
          *reinterpret_cast<__nv_bfloat162*>(o) =
              __floats2bfloat162_rn(acc[s][t][2 * h], acc[s][t][2 * h + 1]);
        } else {
          if (n < sh.N) o[0] = __float2bfloat16_rn(acc[s][t][2 * h]);
          if (n + 1 < sh.N) o[1] = __float2bfloat16_rn(acc[s][t][2 * h + 1]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kFThreads)
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
    for (int i = threadIdx.x; i < blk.nrows * kFBK; i += kFThreads) {
      const int r = i / kFBK, k = kc + i % kFBK;
      As[r][i % kFBK] = k < sh.K ? x[r * sh.xs_stride + k] : 0.f;
    }
    for (int i = threadIdx.x; i < kFBK * kBN; i += kFThreads) {
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

// Tensor maps of the operands that TMA can read; the others are copied by
// the producer warp. Dimensions of size 1 get a nominal aligned stride.
cudaError_t make_maps(Shape& sh, const void* xs, const void* rhs, CUtensorMap* amap,
                      CUtensorMap* bmap) {
  const long long total = static_cast<long long>(sh.clients) * sh.rows;
  long long xstride = total > 1 ? sh.xs_stride : 8;
  sh.a_tma = hopper::tma_ok(xs, &xstride, 1);
  if (sh.a_tma) {
    const uint64_t dims[2] = {static_cast<uint64_t>(sh.K), static_cast<uint64_t>(total)};
    const uint64_t strides[1] = {static_cast<uint64_t>(xstride) * 2};
    const uint32_t box[2] = {kBK, 16};
    cudaError_t err = hopper::make_bf16_map(amap, xs, 2, dims, strides, box,
                                            CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  const int cdim = sh.rc != 0 ? sh.clients : 1;
  const long long rc = cdim > 1 ? sh.rc : 8, rg = sh.groups > 1 ? sh.rg : 8;
  const long long rk = sh.K > 1 ? sh.rk : 8, rn = sh.N > 1 ? sh.rn : 8;
  sh.b_mode = 2;
  long long s0 = 0;
  uint64_t d0 = 0, d1 = 0;
  if (sh.rn == 1) {           // rows k, n contiguous
    sh.b_mode = 0;
    s0 = rk;
    d0 = sh.N;
    d1 = sh.K;
  } else if (sh.rk == 1) {    // rows n, k contiguous
    sh.b_mode = 1;
    s0 = rn;
    d0 = sh.K;
    d1 = sh.N;
  }
  const long long bstrides[3] = {s0, rg, rc};
  if (sh.b_mode < 2 && !hopper::tma_ok(rhs, bstrides, 3)) sh.b_mode = 2;
  if (sh.b_mode < 2) {
    const uint64_t dims[4] = {d0, d1, static_cast<uint64_t>(sh.groups),
                              static_cast<uint64_t>(cdim)};
    const uint64_t strides[3] = {static_cast<uint64_t>(s0) * 2, static_cast<uint64_t>(rg) * 2,
                                 static_cast<uint64_t>(rc) * 2};
    const uint32_t box[4] = {64, 64, 1, 1};
    return hopper::make_bf16_map(bmap, rhs, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  return cudaSuccess;
}

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
  Shape sh{clients, groups, rows, K, N, block_m, xs_stride, rc, rg, rk, rn, 0, 2,
           (block_m + 15) / 16};
  const dim3 grid(static_cast<unsigned>(nblocks), static_cast<unsigned>(ntiles));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    gmm_f32_kernel<<<grid, kFThreads, 0, st>>>(static_cast<const float*>(xs),
                                              static_cast<const float*>(rhs), sizes,
                                              static_cast<float*>(out), sh);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap amap, bmap;
  memset(&amap, 0, sizeof(amap));
  memset(&bmap, 0, sizeof(bmap));
  cudaError_t err = make_maps(sh, xs, rhs, &amap, &bmap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = 1024 + static_cast<size_t>(kStages) * (kBTile + sh.slabs * kSlabBytes) +
                      2 * kStages * sizeof(uint64_t);
  err = cudaFuncSetAttribute(gmm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gmm_bf16_kernel<<<grid, kThreads, smem, st>>>(
      amap, bmap, static_cast<const __nv_bfloat16*>(xs), static_cast<const __nv_bfloat16*>(rhs),
      sizes, static_cast<__nv_bfloat16*>(out), sh);
  return static_cast<int>(cudaGetLastError());
}

const char* gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
