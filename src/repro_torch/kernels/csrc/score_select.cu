// Fused HeteRo-Select scoring, softmax and Gumbel-top-m selection for Hopper
// (sm_90a).
//
// Replaces four Pallas TPU kernels of the reference
// (src/repro/kernels/score_select.py):
//   K1  stats_kernel                <- _stats_kernel (launched from _run_stats)
//   K2  select_kernel<T, true>      <- _select_kernel (with _score_body and
//                                      _block_scores; fused_score_select)
//   K3  select_kernel<T, false>     <- _score_kernel (fused_score_probs): K2
//                                      with the sampling compiled out
//   K4  segment_kernel              <- _segment_kernel (segmented_score_probs)
// K8 (sharded_score_select) runs K1 and K2 on each client shard with the
// shard's global column offset, as the reference runs the same two bodies
// with SC_OFF != 0; its collectives live in the Python wrapper.
// The plain PyTorch versions live beside the wrappers in
// repro_torch/kernels/score_select.py (score_stats_plain, score_select_plain,
// score_probs_plain, segment_probs_plain).
//
// Operand: one stacked (9, kpad) row-major array of f32 or bf16, rows in
// core.state.score_inputs order plus the staleness-override row. For K1-K3
// kpad is a whole number of blocks; local column c holds global client
// off + c, a client while off + c < klim, the rest padding (off = 0 except
// on a K8 shard). Loads and stores stay local; the candidate ids K2 writes
// are global. For K4 kpad = E * seg, edge-major: edge e owns columns
// [e*seg, e*seg + sizes[e]), the rest of its slice is padding.
//
// Bound on an H100 (3.35 TB/s HBM): all four kernels are memory-bound.
// Per client K1 reads 4 rows (16 B in f32, 8 B in bf16); K2 reads 8 rows (9
// with the override) plus 4 B of Gumbel noise and writes 8 B (score, exp),
// so ~44 B in f32 and ~28 B in bf16; K3 is K2 without the noise and the
// candidates (~40 B / ~24 B). K4 reads the 8 (9) rows of each valid client
// once and writes probs and scores for every slot of the (E*seg,) layout.
// Arithmetic is a few dozen flops per client, far below the card's 67
// TFLOP/s of f32. At K = 2^20 that is ~5 us for K1 and ~12-14 us for K2, K3
// and K4 in f32. At the paper's K = 12 every kernel is launch-latency bound.
//
// Design:
//  * K1-K3: one CTA of 256 threads per block of BLOCK <= 2048 clients. The
//    TPU version streamed 32768-client blocks through VMEM; on Hopper a
//    block keeps its z in shared memory (2048 x 4 B = 8 KB) and K = 2^20
//    must give enough CTAs (512) to cover 132 SMs several times. The
//    selected set does not depend on BLOCK: a global top-m element is
//    beaten by at most m-1 others, so it survives its block's top-min(m, B).
//  * Threads walk a block with stride 256, so a warp reads 32 neighbouring
//    columns of a row: coalesced. bf16 rows are widened with
//    __bfloat162float in registers; no f32 copy of the state is made.
//  * Block reductions (min/max/sum) use warp shuffles, then one shared-memory
//    slot per warp.
//  * K2 keeps z = s/tau in shared memory between its passes, so scores are
//    computed once, then overwrites it with the perturbed logits z + g. Its
//    candidates are the block's top mb = min(m, B) by (value descending in
//    IEEE total order, column ascending), written in column order; the host
//    merge orders them (kernels/score_select.py merge_candidates), so no
//    sort is needed. A radix select finds them: the values' order-preserving
//    uint32 bits, 8 at a time from the top, each round a 256-bin histogram
//    (shared-memory atomics, aggregated over a warp's equal bins with
//    __match_any_sync, so the -1e30 padding keys of a block do not
//    serialise) of the entries that still match the prefix, scanned by one
//    warp for the bin that holds the mb-th largest. It stops once the bin's
//    entries are exactly the ones still wanted. What is left: every entry
//    above the prefix, and the first `want` entries on it by column. Each
//    warp then compacts a contiguous span of columns with ballots and popc
//    prefixes, after one exchange of the warps' counts. mb = B takes every
//    column. K3 stops after the exps and the block's (m_b, l_b); the host
//    merges the normalizers.
//  * K4: one CTA per edge. An edge slice can hold 32768 clients (K = 2^20,
//    E = 32), more than a pass of shared memory, so a block-stride loop
//    over the slice takes the place of the TPU's one-shot VMEM block:
//    pass A reduces the edge's statistics, pass B writes the scores and
//    keeps the running max of z, pass C writes e = exp(z - max) and sums it,
//    and a last pass rescales in place to e / max(sum e, 1e-30). Passes C
//    and D reread what the same thread wrote (L1/L2 hits). Padding slots
//    are written as 0.0 and their state is never read. With few edges most
//    SMs idle; the kernel is simple and right first.
//  * Arithmetic follows the plain version op for op (IEEE division, expf,
//    log1pf) and the library is built with --fmad=false, so a score differs
//    from the plain version's only through the order of the sums.
//
// C interface (loaded with ctypes): every entry returns cudaGetLastError()
// after its launch, 0 on success. Launches go to the caller's stream; nothing
// is allocated or synchronized here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 1e30f;

enum Row { ROW_LOSS, ROW_LOSS2, ROW_JS, ROW_CNT, ROW_LAST, ROW_SQ, ROW_HASL,
           ROW_HASM, ROW_STALE };
enum Glob { G_LMIN, G_LMAX, G_AVGSQ, G_HMAX };
enum Stat { ST_LMIN, ST_LMAX, ST_SUMSQ, ST_NOBS, ST_HMAX, NSTATS };

}  // namespace

// Score weights, in HeteRoScoreConfig order; the host passes a pointer to it.
struct ScoreCfg {
  float w_value, w_diversity, w_momentum, w_fairness, w_staleness, w_norm;
  float eta, gamma, alpha, t_max;
};

namespace {

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

struct MinOp { __device__ float operator()(float a, float b) const { return fminf(a, b); } };
struct MaxOp { __device__ float operator()(float a, float b) const { return fmaxf(a, b); } };
struct SumOp { __device__ float operator()(float a, float b) const { return a + b; } };

// Reduce one value per thread over the CTA; every thread gets the result.
// red must hold kWarps + 1 floats.
template <typename Op>
__device__ float block_reduce(float v, float identity, Op op, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : identity;
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[kWarps] = v;
  }
  __syncthreads();
  const float out = red[kWarps];
  __syncthreads();  // red may be reused by the next reduction
  return out;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ st, int64_t kpad, int block, int64_t off,
             int64_t klim, float* __restrict__ out) {
  __shared__ float red[kWarps + 1];
  const int64_t base = (int64_t)blockIdx.x * block;
  float lmin = kBig, lmax = -kBig, sumsq = 0.f, nobs = 0.f, hmax = 0.f;
  for (int i = threadIdx.x; i < block; i += kThreads) {
    const int64_t c = base + i;
    const bool valid = off + c < klim;
    const float loss = load(st + ROW_LOSS * kpad + c);
    const float sq = load(st + ROW_SQ * kpad + c);
    const float cnt = load(st + ROW_CNT * kpad + c);
    const bool obs = valid && load(st + ROW_HASL * kpad + c) > 0.f;
    if (obs) {
      lmin = fminf(lmin, loss);
      lmax = fmaxf(lmax, loss);
      sumsq += sq;
      nobs += 1.f;
    }
    if (valid) hmax = fmaxf(hmax, cnt);
  }
  lmin = block_reduce(lmin, kBig, MinOp(), red);
  lmax = block_reduce(lmax, -kBig, MaxOp(), red);
  sumsq = block_reduce(sumsq, 0.f, SumOp(), red);
  nobs = block_reduce(nobs, 0.f, SumOp(), red);
  hmax = block_reduce(hmax, 0.f, MaxOp(), red);
  if (threadIdx.x == 0) {
    float* o = out + (int64_t)blockIdx.x * NSTATS;
    o[ST_LMIN] = lmin;
    o[ST_LMAX] = lmax;
    o[ST_SUMSQ] = sumsq;
    o[ST_NOBS] = nobs;
    o[ST_HMAX] = hmax;
  }
}

// Additive score of one client (reference: _block_scores), op for op as
// score_select.py:_block_scores_plain.
template <typename T>
__device__ __forceinline__ float client_score(const T* st, int64_t kpad, int64_t c,
                                              const float* g, float t, float decay,
                                              int use_ov, const ScoreCfg& cfg) {
  const float loss = load(st + ROW_LOSS * kpad + c);
  const float loss2 = load(st + ROW_LOSS2 * kpad + c);
  const bool has_loss = load(st + ROW_HASL * kpad + c) > 0.f;
  const bool has_mom = load(st + ROW_HASM * kpad + c) > 0.f;

  // Eq (3): min-max normalized information value (neutral 0.5 if unseen)
  float v = (loss - g[G_LMIN]) / (g[G_LMAX] - g[G_LMIN] + 1e-8f);
  v = fminf(fmaxf(v, 0.f), 1.f);
  v = has_loss ? v : 0.5f;
  // Eq (4): diversity with decaying weight
  const float div = load(st + ROW_JS * kpad + c) * decay;
  // Eq (5): sigmoid momentum
  const float m = has_mom ? (loss2 - loss) / (loss2 + 1e-8f) : 0.f;
  const float mom = 2.f / (1.f + expf(-5.f * m)) - 0.5f;
  // Eq (6): fairness
  const float f = 1.f + cfg.eta * load(st + ROW_CNT * kpad + c) / g[G_HMAX];
  const float fair = 1.f / (f * f);
  // Eq (7): staleness — round-counter delta or the override row
  float delta = use_ov ? fmaxf(load(st + ROW_STALE * kpad + c), 0.f)
                       : fmaxf(t - load(st + ROW_LAST * kpad + c), 0.f);
  delta = fminf(delta, cfg.t_max);
  const float stl = 1.f + cfg.gamma * log1pf(delta);
  // Eq (11): update-norm penalty
  const float r = has_loss ? load(st + ROW_SQ * kpad + c) / (g[G_AVGSQ] + 1e-8f) : 1.f;
  const float npen = 1.f - cfg.alpha * (2.f / (1.f + expf(-3.f * r)) - 1.f);
  // Eq (1) additive combination
  return cfg.w_value * v + cfg.w_diversity * div + cfg.w_momentum * mom
         + cfg.w_fairness * (fair - 1.f) + cfg.w_staleness * (stl - 1.f)
         + cfg.w_norm * (npen - 1.f);
}

// Order-preserving bits: ord(a) > ord(b) iff a > b in IEEE total order (-0.0
// below +0.0, NaN above +inf), the order of score_select.py's order_keys.
__device__ __forceinline__ uint32_t order_bits(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// K2's candidates: the block's top mb keys by (value descending, column
// ascending), written to cval/cidx in column order (see the header).
// key[0, block) holds z + g; block is a multiple of 32 and >= mb.
__device__ void block_candidates(const float* key, int block, int mb, int64_t first,
                                 float* __restrict__ cval, int* __restrict__ cidx) {
  __shared__ int hist[256];
  __shared__ uint32_t sel_prefix, sel_mask;
  __shared__ int sel_want, sel_done;
  __shared__ int warp_gt[kWarps], warp_eq[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Entries whose bits under `mask` equal `prefix` are still in play; `want`
  // of them are to be taken. mask = 0 takes every column (mb == block).
  uint32_t prefix = 0u, mask = 0u;
  int want = mb;
  if (mb < block) {
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int b = threadIdx.x; b < 256; b += kThreads) hist[b] = 0;
      __syncthreads();
      for (int i = threadIdx.x; i < block; i += kThreads) {  // whole warps
        const uint32_t u = order_bits(key[i]);
        const int bin = (u & mask) == prefix ? (int)((u >> shift) & 255u) : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, bin);
        if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
      }
      __syncthreads();
      if (warp == 0) {
        // Lane l holds bins 255-8l down to 248-8l; a prefix sum over the
        // lanes counts the entries in higher bins.
        int c[8], sum = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) { c[j] = hist[255 - 8 * lane - j]; sum += c[j]; }
        int incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += v;
        }
        const int excl = incl - sum;
        if (excl < want && want <= incl) {  // exactly one lane
          int above = excl, j = 0;
          while (above + c[j] < want) above += c[j++];
          sel_prefix = prefix | ((uint32_t)(255 - 8 * lane - j) << shift);
          sel_mask = mask | (255u << shift);
          sel_want = want - above;
          sel_done = c[j] == want - above;
        }
      }
      __syncthreads();
      prefix = sel_prefix;
      mask = sel_mask;
      want = sel_want;
      if (sel_done) break;  // read by every thread before the next write
    }
  }

  // Compaction in column order. Warp w owns columns [w*span, (w+1)*span).
  const int span = max(32, block / kWarps);
  const int lo = warp * span;
  const bool owns = lo < block;
  int ngt = 0, neq = 0;
  if (owns) {
    for (int s = 0; s < span; s += 32) {
      const uint32_t um = order_bits(key[lo + s + lane]) & mask;
      ngt += __popc(__ballot_sync(0xffffffffu, um > prefix));
      neq += __popc(__ballot_sync(0xffffffffu, um == prefix));
    }
  }
  if (lane == 0) { warp_gt[warp] = ngt; warp_eq[warp] = neq; }
  __syncthreads();
  if (!owns) return;
  int gt_before = 0, eq_seen = 0;
  for (int w = 0; w < warp; ++w) { gt_before += warp_gt[w]; eq_seen += warp_eq[w]; }
  int pos = gt_before + min(eq_seen, want);
  const unsigned below = (1u << lane) - 1u;
  for (int s = 0; s < span; s += 32) {
    const int i = lo + s + lane;
    const float v = key[i];
    const uint32_t um = order_bits(v) & mask;
    const unsigned eq = __ballot_sync(0xffffffffu, um == prefix);
    const bool take = um > prefix || (um == prefix && eq_seen + __popc(eq & below) < want);
    const unsigned takers = __ballot_sync(0xffffffffu, take);
    if (take) {
      const int p = pos + __popc(takers & below);
      cval[p] = v;
      cidx[p] = (int)(first + i);
    }
    pos += __popc(takers);
    eq_seen += __popc(eq);
  }
}

// kSample = true is K2, false is K3 (no noise, no candidates).
template <typename T, bool kSample>
__global__ void __launch_bounds__(kThreads)
select_kernel(const T* __restrict__ st, const float* __restrict__ gumbel,
              const float* __restrict__ glob, int64_t kpad, int block, int64_t off,
              int64_t klim, float t, float tau, int use_ov, float decay, ScoreCfg cfg, int mb,
              float* __restrict__ scores, float* __restrict__ e_out,
              float* __restrict__ part, float* __restrict__ cval,
              int* __restrict__ cidx) {
  extern __shared__ float key[];                  // [block] z, then z + g
  __shared__ float red[kWarps + 1];
  __shared__ float g[4];
  if (threadIdx.x < 4) g[threadIdx.x] = glob[threadIdx.x];
  __syncthreads();

  const int64_t base = (int64_t)blockIdx.x * block;
  float zmax = -kBig;
  for (int i = threadIdx.x; i < block; i += kThreads) {
    const int64_t c = base + i;
    const float s = client_score(st, kpad, c, g, t, decay, use_ov, cfg);
    scores[c] = s;
    const float z = off + c < klim ? s / tau : -kBig;
    key[i] = z;
    zmax = fmaxf(zmax, z);
  }
  const float m_b = block_reduce(zmax, -kBig, MaxOp(), red);

  float lsum = 0.f;
  for (int i = threadIdx.x; i < block; i += kThreads) {
    const int64_t c = base + i;
    const float z = key[i];
    const float e = off + c < klim ? expf(z - m_b) : 0.f;
    e_out[c] = e;
    lsum += e;
    // Ranking z + g ranks log p + g: the softmax shift is common to all.
    if constexpr (kSample) key[i] = z + gumbel[c];
  }
  const float l_b = block_reduce(lsum, 0.f, SumOp(), red);  // syncs: key is complete
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = m_b;
    part[2 * blockIdx.x + 1] = l_b;
  }
  if constexpr (kSample) {
    block_candidates(key, block, mb, off + base, cval + (int64_t)blockIdx.x * mb,
                     cidx + (int64_t)blockIdx.x * mb);
  }
}

// K4: one CTA per edge; stats, scores and softmax inside the edge's slice.
template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_kernel(const T* __restrict__ st, const int* __restrict__ sizes,
               int64_t kpad, int seg, float t, float tau, int use_ov,
               float decay, ScoreCfg cfg, float* __restrict__ probs,
               float* __restrict__ scores) {
  __shared__ float red[kWarps + 1];
  const int64_t base = (int64_t)blockIdx.x * seg;
  const int n = min(max(sizes[blockIdx.x], 0), seg);

  // Pass A: the edge's statistics over its n valid members.
  float lmin = kBig, lmax = -kBig, sumsq = 0.f, nobs = 0.f, hmax = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int64_t c = base + i;
    if (load(st + ROW_HASL * kpad + c) > 0.f) {
      const float loss = load(st + ROW_LOSS * kpad + c);
      lmin = fminf(lmin, loss);
      lmax = fmaxf(lmax, loss);
      sumsq += load(st + ROW_SQ * kpad + c);
      nobs += 1.f;
    }
    hmax = fmaxf(hmax, load(st + ROW_CNT * kpad + c));
  }
  lmin = block_reduce(lmin, kBig, MinOp(), red);
  lmax = block_reduce(lmax, -kBig, MaxOp(), red);
  sumsq = block_reduce(sumsq, 0.f, SumOp(), red);
  nobs = block_reduce(nobs, 0.f, SumOp(), red);
  hmax = block_reduce(hmax, 0.f, MaxOp(), red);
  const float g[4] = {lmin, lmax, sumsq / fmaxf(nobs, 1.f), fmaxf(hmax, 1.f)};

  // Pass B: scores; padding slots get 0.0 in both outputs.
  float zmax = -kBig;
  for (int i = threadIdx.x; i < seg; i += kThreads) {
    const int64_t c = base + i;
    if (i < n) {
      const float s = client_score(st, kpad, c, g, t, decay, use_ov, cfg);
      scores[c] = s;
      zmax = fmaxf(zmax, s / tau);
    } else {
      scores[c] = 0.f;
      probs[c] = 0.f;
    }
  }
  const float m = block_reduce(zmax, -kBig, MaxOp(), red);

  // Pass C: exponentials and their sum (each thread rereads its own scores).
  float lsum = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int64_t c = base + i;
    const float e = expf(scores[c] / tau - m);
    probs[c] = e;
    lsum += e;
  }
  const float l = fmaxf(block_reduce(lsum, 0.f, SumOp(), red), 1e-30f);

  // Pass D: normalize in place.
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int64_t c = base + i;
    probs[c] = probs[c] / l;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 rows, 1 = bfloat16 rows.
int hs_stats(int dtype, const void* stacked, long long kpad, int block,
             int nblocks, long long off, long long klim, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    stats_kernel<float><<<nblocks, kThreads, 0, s>>>(
        static_cast<const float*>(stacked), kpad, block, off, klim, out);
  } else {
    stats_kernel<__nv_bfloat16><<<nblocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(stacked), kpad, block, off, klim, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int hs_select(int dtype, const void* stacked, const float* gumbel,
              const float* glob, long long kpad, int block, int nblocks,
              long long off, long long klim, float t, float tau, int use_ov,
              float decay, const ScoreCfg* cfg, int mb, float* scores, float* e,
              float* part, float* cval, int* cidx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(block) * sizeof(float);
  if (dtype == 0) {
    select_kernel<float, true><<<nblocks, kThreads, smem, s>>>(
        static_cast<const float*>(stacked), gumbel, glob, kpad, block, off, klim,
        t, tau, use_ov, decay, *cfg, mb, scores, e, part, cval, cidx);
  } else {
    select_kernel<__nv_bfloat16, true><<<nblocks, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(stacked), gumbel, glob, kpad, block,
        off, klim, t, tau, use_ov, decay, *cfg, mb, scores, e, part, cval, cidx);
  }
  return static_cast<int>(cudaGetLastError());
}

int hs_score(int dtype, const void* stacked, const float* glob, long long kpad,
             int block, int nblocks, long long klim, float t, float tau,
             int use_ov, float decay, const ScoreCfg* cfg, float* scores,
             float* e, float* part, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(block) * sizeof(float);
  if (dtype == 0) {
    select_kernel<float, false><<<nblocks, kThreads, smem, s>>>(
        static_cast<const float*>(stacked), nullptr, glob, kpad, block, 0, klim,
        t, tau, use_ov, decay, *cfg, 0, scores, e, part, nullptr, nullptr);
  } else {
    select_kernel<__nv_bfloat16, false><<<nblocks, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(stacked), nullptr, glob, kpad, block,
        0, klim, t, tau, use_ov, decay, *cfg, 0, scores, e, part, nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

int hs_segment(int dtype, const void* stacked, const int* sizes, long long kpad,
               int num_edges, int seg, float t, float tau, int use_ov,
               float decay, const ScoreCfg* cfg, float* probs, float* scores,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    segment_kernel<float><<<num_edges, kThreads, 0, s>>>(
        static_cast<const float*>(stacked), sizes, kpad, seg, t, tau, use_ov,
        decay, *cfg, probs, scores);
  } else {
    segment_kernel<__nv_bfloat16><<<num_edges, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(stacked), sizes, kpad, seg, t, tau,
        use_ov, decay, *cfg, probs, scores);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* hs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
