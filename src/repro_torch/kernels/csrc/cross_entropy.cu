// Vocab-blockwise cross-entropy forward for Hopper (sm_90a).  Plain CUDA
// with C entry points: bindings.cpp launches them and checks the launches.
//
// Replaces the TPU kernel repro/kernels/cross_entropy.py::
// cross_entropy_pallas (body _ce_kernel): logits = hidden @ w_vocab^T per
// (token tile, vocab tile), reduced at once into online (max, sumexp,
// target logit) statistics per token, so the (T, V) logits never reach
// device memory; vocab columns past V count as -1e30.  It returns the
// per-token nll = lse - target logit and lse = m + log(max(l, 1e-30)),
// in f32.  Inputs are read in their own dtype (bf16 or f32) and multiplied
// in f32: a bf16 x bf16 product is exact in f32, so on bf16 inputs this
// computes both cross_entropy_pallas (which upcasts) and the forward of
// train/loss.py::ce_blockwise with ce_dtype=bfloat16 (bf16 inputs, f32
// accumulation).
//
// Bound on the card: operations.  At the yi-6b training shape (T=2048,
// D=4096, V=64000) the product is 1.07 TFLOP, 1.09 ms at the bf16
// tensor-core peak, against 0.16 ms for the bytes.  This first version
// runs f32 FMAs on the CUDA cores (no tensor cores), so it is bound by
// that arithmetic, far above either; wgmma and TMA are later work.
//
// Design.  The TPU grid walked the vocab axis in order, carrying the
// statistics in VMEM scratch.  Here T / 128 token tiles alone give too
// few blocks for 132 SMs (16 at the training shape), so the vocab is split
// across blocks too: block (token tile, vocab split) walks its run of
// 128-wide vocab tiles, keeps (m, l, target logit) per row in registers
// and writes them as one partial triple per (split, token); a second small
// kernel merges the splits' triples per token.  No float atomics, the
// same result on every run.  Inside a block, 256 threads (16 x 16) each
// own an 8 x 8 block of the 128 x 128 logit tile (rows ty*4 + {0..3} and
// 64 + ty*4 + {0..3}, columns likewise with tx), so that the 16-byte
// shared-memory reads of neighbouring threads are neighbouring.  The D
// axis is walked 32 at a time through shared memory, stored transposed
// (depth-major) as f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBT = 128;      // tokens per tile
constexpr int kBV = 128;      // vocab entries per tile
constexpr int kBD = 32;       // depth per shared-memory step
constexpr int kPad = kBT + 4; // row stride of the transposed tiles
constexpr int kThreads = 256;
constexpr int kTargetBlocks = 2 * 132;  // two blocks on each of 132 SMs
constexpr float kNegInf = -1e30f;

static_assert(kBT == kBV, "one row stride serves both tiles");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, const T* src,
                                           int row0, int n_rows, int d0,
                                           int D) {
  for (int e = threadIdx.x; e < kBT * kBD; e += kThreads) {
    const int r = e / kBD, dd = e % kBD;
    const int g = row0 + r, d = d0 + dd;
    dst[dd * kPad + r] =
        g < n_rows && d < D ? to_f32(src[(long long)g * D + d]) : 0.f;
  }
}

// Block (token tile, vocab split).  part: (n_split, T, 3) f32 triples
// (m, l, target logit) of this split's vocab tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ce_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
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
      load_chunk<T>(sH, h, t0, n_tok, d0, D);
      load_chunk<T>(sW, w, v0, V, d0, D);
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

void split_vocab(int n_tok, int V, int* n_split, int* tiles_per_split) {
  const int n_ttiles = (n_tok + kBT - 1) / kBT;
  const int n_vtiles = (V + kBV - 1) / kBV;
  int want = kTargetBlocks / n_ttiles;
  want = want < 1 ? 1 : (want > n_vtiles ? n_vtiles : want);
  *tiles_per_split = (n_vtiles + want - 1) / want;
  *n_split = (n_vtiles + *tiles_per_split - 1) / *tiles_per_split;
}

}  // namespace

// Number of vocab splits, so the caller can size the (n_split, T, 3) f32
// scratch `part` of repro_ce_fwd.
extern "C" int repro_ce_splits(int n_tok, int V) {
  int n_split, tiles_per_split;
  split_vocab(n_tok, V, &n_split, &tiles_per_split);
  return n_split;
}

// hidden: (T, D), w: (V, D), both contiguous, bf16 (bf16 != 0) or f32;
// targets: (T,) int64; part: repro_ce_splits(T, V) x T x 3 f32 scratch;
// nll, lse: (T,) f32 outputs.  Two launches on `stream`; errors are left
// to cudaGetLastError.  Requires T, V, D > 0.
extern "C" void repro_ce_fwd(const void* hidden, const void* w,
                             const long long* targets, float* part,
                             float* nll, float* lse, int n_tok, int V, int D,
                             int bf16, cudaStream_t s) {
  int n_split, tiles_per_split;
  split_vocab(n_tok, V, &n_split, &tiles_per_split);
  dim3 grid((n_tok + kBT - 1) / kBT, n_split);
  if (bf16)
    ce_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(hidden),
        static_cast<const __nv_bfloat16*>(w), targets, part, n_tok, V, D,
        tiles_per_split);
  else
    ce_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(hidden), static_cast<const float*>(w),
        targets, part, n_tok, V, D, tiles_per_split);
  ce_merge_kernel<<<(n_tok + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      part, nll, lse, n_tok, n_split);
}
