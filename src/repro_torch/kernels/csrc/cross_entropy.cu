// Vocab-blockwise cross-entropy forward for Hopper (sm_90a).  Plain CUDA
// with C entry points: bindings.cpp launches them and checks the launches.
//
// Replaces the TPU kernel repro/kernels/cross_entropy.py::
// cross_entropy_pallas (body _ce_kernel): logits = hidden @ w_vocab^T per
// (token tile, vocab tile), reduced at once into online (max, sumexp,
// target logit) statistics per token, so the (T, V) logits never reach
// device memory; vocab columns past V count as -1e30.  It returns the
// per-token nll = lse - target logit and lse = m + log(max(l, 1e-30)),
// in f32.  Products are of the inputs' own values with f32 accumulation:
// a bf16 x bf16 product is exact in f32, so on bf16 inputs this computes
// both cross_entropy_pallas (which upcasts) and the forward of
// train/loss.py::ce_blockwise with ce_dtype=bfloat16 (bf16 inputs, f32
// accumulation).
//
// Bound on the card: operations.  At the yi-6b training shape (T=2048,
// D=4096, V=64000) the product is 1.07 TFLOP, 1.09 ms at the bf16
// tensor-core peak, against 0.16 ms for the bytes.
//
// Parallelism.  The TPU grid walked the vocab axis in order, carrying the
// statistics in VMEM scratch.  Here the token tiles alone give too few
// blocks for 132 SMs (16 at the training shape), so the vocab is split
// across blocks too: block (token tile, vocab split) walks its run of
// vocab tiles and writes one partial (m, l, target logit) triple per
// (split, token); a second small kernel merges the splits' triples per
// token.  No float atomics, the same result on every run.
//
// bf16 (the training path): tensor cores, wgmma.  A block of two
// warpgroups owns 128 tokens x 256 vocab entries; each warpgroup
// multiplies its 64 tokens by the 256 entries as wgmma.m64n256k16 (both
// operands read from shared memory through descriptors, f32 sums, 128
// accumulators a thread).  h and w tiles, 64 deep, stream through a
// 4-stage ring by cp.async into the 128-byte-swizzled layout wgmma reads
// (tc.cuh); the block's (vocab tile, depth step) pairs are walked as one
// sequence, so the next vocab tile's loads overlap this one's epilogue.
// The epilogue folds each 256-wide tile into per-thread online (m, l,
// target) statistics of the thread's two rows, in registers; at the end
// of the run they are merged over the 4 lanes that share a row, in a
// fixed order.  One block a SM (254 registers a thread, 194 KB of shared
// memory); the vocab split is sized to one wave of 132 blocks.  The
// 128 x 256 tile is as large as the register file holds, and each 64-deep
// step moves 48 KB from L2 for 4.2 MFLOP: that L2-to-SM traffic, not the
// tensor cores, bounds this design (PERF.md).
//
// f32 (the 3e-5 sweeps, no main path): f32 FMAs on the CUDA cores (TF32
// cannot meet 3e-5): 256 threads (16 x 16) each own an 8 x 8 block of a
// 128 x 128 logit tile, the D axis walked 32 at a time through shared
// memory, stored transposed (depth-major) as f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc.cuh"


namespace {

constexpr int kBT = 128;      // tokens per tile
constexpr int kBV = 128;      // vocab entries per tile
constexpr int kBD = 32;       // depth per shared-memory step
constexpr int kPad = kBT + 4; // row stride of the transposed tiles
constexpr int kThreads = 256;
constexpr int kTargetBlocks = 2 * 132;  // two blocks on each of 132 SMs
constexpr float kNegInf = -1e30f;

static_assert(kBT == kBV, "one row stride serves both tiles");

// Reductions over the 16 lanes that share one ty (one set of rows).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Row (or column) of the tile that slot i in 0..7 of thread t in 0..15
// owns.
__device__ __forceinline__ int owned(int t, int i) {
  return (i < 4 ? 0 : 64) + t * 4 + (i & 3);
}

// Loads rows row0 .. row0 + 127, depth d0 .. d0 + kBD - 1 of a row-major
// (n_rows, D) matrix into dst[depth][row] as f32, zero outside.
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           int row0, int n_rows, int d0,
                                           int D) {
  for (int e = threadIdx.x; e < kBT * kBD; e += kThreads) {
    const int r = e / kBD, dd = e % kBD;
    const int g = row0 + r, d = d0 + dd;
    dst[dd * kPad + r] =
        g < n_rows && d < D ? src[(long long)g * D + d] : 0.f;
  }
}

// f32.  Block (token tile, vocab split).  part: (n_split, T, 3) f32
// triples (m, l, target logit) of this split's vocab tiles.
__global__ void __launch_bounds__(kThreads, 2)
ce_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
              const long long* __restrict__ targets,
              float* __restrict__ part, int n_tok, int V, int D,
              int tiles_per_split) {
  __shared__ __align__(16) float sH[kBD * kPad];
  __shared__ __align__(16) float sW[kBD * kPad];
  __shared__ long long sT[kBT];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int t0 = blockIdx.x * kBT;
  const int n_vtiles = (V + kBV - 1) / kBV;
  const int vt_begin = blockIdx.y * tiles_per_split;
  const int vt_end = min(vt_begin + tiles_per_split, n_vtiles);
  for (int r = threadIdx.x; r < kBT; r += kThreads)
    sT[r] = t0 + r < n_tok ? targets[t0 + r] : -1;

  float m[8], l[8], tg[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    tg[i] = 0.f;
  }

  for (int vt = vt_begin; vt < vt_end; ++vt) {
    const int v0 = vt * kBV;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += kBD) {
      __syncthreads();  // the previous chunk's reads are done
      load_chunk(sH, h, t0, n_tok, d0, D);
      load_chunk(sW, w, v0, V, d0, D);
      __syncthreads();
#pragma unroll 4
      for (int dd = 0; dd < kBD; ++dd) {
        const float* hr = sH + dd * kPad;
        const float* wr = sW + dd * kPad;
        const float4 a0 = *reinterpret_cast<const float4*>(hr + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(hr + 64 + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(wr + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(wr + 64 + tx * 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

    // Online update of each owned row's statistics with this tile.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long tgt = sT[owned(ty, i)];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = v0 + owned(tx, j);
        if (col >= V) acc[i][j] = kNegInf;
        if (col == tgt) tg[i] += acc[i][j];
        mx = fmaxf(mx, acc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) ps += expf(acc[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + row_sum(ps);
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float t_sum = row_sum(tg[i]);  // one lane holds the target
    const int row = t0 + owned(ty, i);
    if (tx == 0 && row < n_tok) {
      float* p = part + ((long long)blockIdx.y * n_tok + row) * 3;
      p[0] = m[i];
      p[1] = l[i];
      p[2] = t_sum;
    }
  }
}

// Merges the splits' triples: one thread per token.
__global__ void __launch_bounds__(kThreads)
ce_merge_kernel(const float* __restrict__ part, float* __restrict__ nll,
                float* __restrict__ lse, int n_tok, int n_split) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_tok) return;
  float M = kNegInf;
  for (int s = 0; s < n_split; ++s)
    M = fmaxf(M, part[((long long)s * n_tok + t) * 3]);
  float L = 0.f, tgt = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float* p = part + ((long long)s * n_tok + t) * 3;
    L += p[1] * expf(p[0] - M);
    tgt += p[2];
  }
  const float z = M + logf(fmaxf(L, 1e-30f));
  lse[t] = z;
  nll[t] = z - tgt;
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcBT = 128;      // tokens per block
constexpr int kTcBV = 256;      // vocab entries per tile
constexpr int kTcBD = 64;       // depth per ring stage
constexpr int kTcThreads = 256; // 2 warpgroups: 64 tokens x 256 each
constexpr int kTcTargetBlocks = 132;  // one block on each of 132 SMs
constexpr int kTcStageElems = (kTcBT + kTcBV) * kTcBD;

// Merges online statistics (m2, l2, t2) into (m, l, t).
__device__ __forceinline__ void merge_stats(float& m, float& l, float& t,
                                            float m2, float l2, float t2) {
  const float M = fmaxf(m, m2);
  l = l * __expf(m - M) + l2 * __expf(m2 - M);
  m = M;
  t += t2;
}

constexpr int kWgStages = 4;
// the ring, the targets, and slack to align the ring to 1024 bytes
constexpr size_t kWgSmem = sizeof(bf16) * kWgStages * kTcStageElems +
                           sizeof(long long) * kTcBT + 1024;

// Block (token tile, vocab split), as ce_fwd_kernel, with 256-wide vocab
// tiles on wgmma: warpgroup wg of the two owns tokens wg * 64 .. wg * 64 +
// 63 of the tile and all 256 vocab entries, as one m64n256k16 accumulator
// (128 f32 a thread).  h: (n_tok, D), w: (V, D), 16-byte aligned, D a
// multiple of 8.
__global__ void __launch_bounds__(kTcThreads, 1)
ce_fwd_wgmma_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                    const long long* __restrict__ targets,
                    float* __restrict__ part, int n_tok, int V, int D,
                    int tiles_per_split) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t s0 = tc::smem_u32(smem_raw);
  bf16* ring =
      reinterpret_cast<bf16*>(smem_raw + ((1024 - (s0 & 1023)) & 1023));
  long long* sT =
      reinterpret_cast<long long*>(ring + kWgStages * kTcStageElems);

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = wg * 64 + warp * 16 + g;  // this thread's rows: row0, +8
  const int t0 = blockIdx.x * kTcBT;
  const int n_vtiles = (V + kTcBV - 1) / kTcBV;
  const int vt_begin = blockIdx.y * tiles_per_split;
  const int vt_end = min(vt_begin + tiles_per_split, n_vtiles);
  const int KT = (D + kTcBD - 1) / kTcBD;
  const int n_steps = (vt_end - vt_begin) * KT;
  for (int r = threadIdx.x; r < kTcBT; r += kTcThreads)
    sT[r] = t0 + r < n_tok ? targets[t0 + r] : -1;

  auto load_step = [&](int i, int slot) {
    const int v0 = (vt_begin + i / KT) * kTcBV;
    const int d0 = (i % KT) * kTcBD;
    bf16* sA = ring + slot * kTcStageElems;
    bf16* sB = sA + kTcBT * kTcBD;
    for (int e = threadIdx.x; e < (kTcBT + kTcBV) * (kTcBD / 8);
         e += kTcThreads) {
      const int r = e >> 3, c = e & 7;
      const int d = d0 + c * 8;
      const bool is_a = r < kTcBT;
      const int row = is_a ? t0 + r : v0 + r - kTcBT;
      const bool ok = d < D && row < (is_a ? n_tok : V);
      const bf16* src = is_a ? h : w;
      tc::cp_async16((is_a ? sA : sB) + tc::swz<kTcBD>(is_a ? r : r - kTcBT, c),
                     ok ? src + (long long)row * D + d : src, ok ? 16 : 0);
    }
  };

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, tg[2] = {0.f, 0.f};

#pragma unroll
  for (int i = 0; i < kWgStages - 1; ++i) {
    if (i < n_steps) load_step(i, i);
    tc::cp_async_commit();
  }
  for (int i = 0; i < n_steps; ++i) {
    tc::cp_async_wait<kWgStages - 2>();
    tc::fence_proxy_async();  // this thread's copies, visible to wgmma
    __syncthreads();          // everyone's; step i - 1's slot is free
    const int nx = i + kWgStages - 1;
    if (nx < n_steps) load_step(nx, nx % kWgStages);
    tc::cp_async_commit();

    const int kt = i % KT;
    const bf16* sA = ring + (i % kWgStages) * kTcStageElems + wg * 64 * kTcBD;
    const bf16* sB = ring + (i % kWgStages) * kTcStageElems + kTcBT * kTcBD;
    tc::wgmma_pin(acc);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBD / 16; ++kk)
      tc::wgmma_m64n256k16(acc, tc::wgmma_desc(sA + kk * 16),
                           tc::wgmma_desc(sB + kk * 16), kt > 0 || kk > 0);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::wgmma_pin(acc);

    if (kt == KT - 1) {  // fold this vocab tile into the statistics
      const int c0 = (vt_begin + i / KT) * kTcBV + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long tgt = sT[row0 + 8 * r];
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + j * 8 + e;
            const float x = acc[4 * j + 2 * r + e];
            if (col == tgt) tg[r] += x;
            if (col < V) mx = fmaxf(mx, x);
          }
        const float m_new = fmaxf(m[r], mx);
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (c0 + j * 8 + e < V)
              ps += __expf(acc[4 * j + 2 * r + e] - m_new);
        l[r] = l[r] * __expf(m[r] - m_new) + ps;
        m[r] = m_new;
      }
    }
  }
  tc::cp_async_wait<0>();

  // Merge over the 4 lanes of a row; the warp covers all 256 columns.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      merge_stats(m[r], l[r], tg[r], __shfl_xor_sync(0xffffffffu, m[r], off),
                  __shfl_xor_sync(0xffffffffu, l[r], off),
                  __shfl_xor_sync(0xffffffffu, tg[r], off));
    const int row = t0 + row0 + 8 * r;
    if (t == 0 && row < n_tok) {
      float* p = part + ((long long)blockIdx.y * n_tok + row) * 3;
      p[0] = m[r];
      p[1] = l[r];
      p[2] = tg[r];
    }
  }
}

// Splits the vocab tiles of width `bv` into runs, so that about `target`
// blocks cover every (token tile, run).
void split_vocab(int n_tok, int V, int bt, int bv, int target, int* n_split,
                 int* tiles_per_split) {
  const int n_ttiles = (n_tok + bt - 1) / bt;
  const int n_vtiles = (V + bv - 1) / bv;
  int want = target / n_ttiles;
  want = want < 1 ? 1 : (want > n_vtiles ? n_vtiles : want);
  *tiles_per_split = (n_vtiles + want - 1) / want;
  *n_split = (n_vtiles + *tiles_per_split - 1) / *tiles_per_split;
}

void split_for(int n_tok, int V, int bf16, int* n_split,
               int* tiles_per_split) {
  if (bf16)
    split_vocab(n_tok, V, kTcBT, kTcBV, kTcTargetBlocks, n_split,
                tiles_per_split);
  else
    split_vocab(n_tok, V, kBT, kBV, kTargetBlocks, n_split, tiles_per_split);
}

}  // namespace

// Number of vocab splits, so the caller can size the (n_split, T, 3) f32
// scratch `part` of repro_ce_fwd for inputs of that dtype.
extern "C" int repro_ce_splits(int n_tok, int V, int bf16) {
  int n_split, tiles_per_split;
  split_for(n_tok, V, bf16, &n_split, &tiles_per_split);
  return n_split;
}

// hidden: (T, D), w: (V, D), both contiguous, bf16 (bf16 != 0) or f32; for
// bf16 both 16-byte aligned and D a multiple of 8.  targets: (T,) int64;
// part: repro_ce_splits(T, V, bf16) x T x 3 f32 scratch; nll, lse: (T,)
// f32 outputs.  Two launches on `stream`; errors are left to
// cudaGetLastError.  Requires T, V, D > 0.
extern "C" void repro_ce_fwd(const void* hidden, const void* w,
                             const long long* targets, float* part,
                             float* nll, float* lse, int n_tok, int V, int D,
                             int bf16, cudaStream_t s) {
  int n_split, tiles_per_split;
  split_for(n_tok, V, bf16, &n_split, &tiles_per_split);
  if (bf16) {
    static bool configured = false;
    if (!configured) {
      if (cudaFuncSetAttribute(ce_fwd_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kWgSmem) != cudaSuccess)
        return;
      configured = true;
    }
    dim3 grid((n_tok + kTcBT - 1) / kTcBT, n_split);
    ce_fwd_wgmma_kernel<<<grid, kTcThreads, kWgSmem, s>>>(
        static_cast<const __nv_bfloat16*>(hidden),
        static_cast<const __nv_bfloat16*>(w), targets, part, n_tok, V, D,
        tiles_per_split);
  } else {
    dim3 grid((n_tok + kBT - 1) / kBT, n_split);
    ce_fwd_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(hidden), static_cast<const float*>(w),
        targets, part, n_tok, V, D, tiles_per_split);
  }
  ce_merge_kernel<<<(n_tok + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      part, nll, lse, n_tok, n_split);
}

// Facts about the bf16 kernel for reports (idx 0; tc::kernel_info).
// Returns false past it or on a CUDA error.
extern "C" bool repro_ce_info(int idx, const char** name, int* out) {
  if (idx != 0) return false;
  *name = "ce_fwd_wgmma_kernel";
  return tc::kernel_info(ce_fwd_wgmma_kernel, kTcThreads, kWgSmem, out);
}
