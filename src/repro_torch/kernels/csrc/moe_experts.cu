// Grouped expert products of the dropless MoE for Hopper (sm_90a).  Plain
// CUDA with C entry points: bindings.cpp launches them and checks the
// launches.
//
// Replaces no TPU kernel: the JAX package's MoE fills a capacity slot
// grid and leaves the products to XLA.  Here the T * K (token, k) pairs
// of a dropless top-K route come sorted by expert (expert e's pairs are
// the sorted rows offsets[e] .. offsets[e + 1] - 1), and two launches
// compute every expert's SwiGLU on exactly its rows:
//   1. H[j] = silu(X[token[j]] Wg[e]) * (X[token[j]] Wu[e]), X gathered
//      row by row as it is loaded, SiLU and the product in f32 in the
//      epilogue, H rounded to bf16 once;
//   2. Y[j] = H[j] Wd[e].
// The caller combines each token's K rows of Y in expert order (no
// atomics anywhere: the same bits on every run).
//
// Bound on the card.  6 d f FLOPs a pair against every expert's 3 d f
// weights, the routed rows of X, H written and read and Y written.  At
// granite-4.0-h-small's prefill of 16 x 4096 tokens (d 4096, f 768, 72
// experts top 10): 12.4 TFLOP (12.5 ms at the bf16 peak) against 13.5
// GB (4.0 ms): the tensor cores.  At decode (16 tokens, 160 pairs) the
// weights, 1.36 GB a layer (0.41 ms): the bytes.
//
// Design.  A block computes a 128-row x 256-column tile of one expert:
// 8 warps, 2 along the rows (64 each) x 4 along the columns (64 each),
// mma.sync.m16n8k16 (bf16 in, f32 sums) from ldmatrix fragments of
// swizzled tiles (tc.cuh) that cp.async fills through a ring of 3 steps
// of depth 64 (144 KB, one block a SM), so two steps load while one
// multiplies.  The first launch's 256 columns are 128 of Wg and the same
// 128 of Wu, interleaved so that each warp holds the gate and up sums of
// its 32 columns in one thread's registers (its n8 blocks 0-3: gate;
// 4-7: up).
// The row tiles of all experts form one list (an expert with c rows has
// ceil(c / 128) tiles; one with none has none); grid y runs over a bound
// of its length, ceil(pairs / 128) + E, and a block finds its expert by
// walking the offsets, so the host reads nothing back.  Grid x runs over
// the column tiles, so the blocks of one row tile run together and read
// its gathered rows of X from L2.  Rows past an expert's end load zeros
// and are not written.
//
// Decode launches the same code under other names (moe_*_decode_kernel),
// so that a trace tells prefill's launches from decode's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;     // sorted pair rows of a tile
constexpr int kBN = 256;     // columns of a tile (gated: 128 of Wg + 128 of Wu)
constexpr int kBK = 64;      // depth of a step
constexpr int kWN = kBN / 4; // columns of a warp
constexpr int kNJ = kWN / 8; // n8 blocks of a warp
constexpr int kStages = 3;   // ring depth
constexpr int kThreads = 256;
constexpr size_t kSmem = sizeof(bf16) * kStages * (kBM * kBK + kBK * kBN);

struct Args {
  const bf16* a;        // gated: X (T, d); else H (pairs, f)
  const int* token;     // gated: the token of each sorted pair; else null
  const int* offsets;   // (E + 1,)
  const bf16* w0;       // gated: Wg (E, d, f); else Wd (E, f, d)
  const bf16* w1;       // gated: Wu (E, d, f); else null
  bf16* out;            // gated: H (pairs, f); else Y (pairs, d)
  int E;
  int depth;            // d (gated) or f
  int ldw;              // columns of a weight matrix: f (gated) or d
  long long lda;        // row stride of a
};

// Expert e of row tile `tile`, its first sorted row and the end of its
// rows; false past the last tile.
__device__ __forceinline__ bool find_tile(const int* offsets, int E,
                                          int tile, int& e, int& row0,
                                          int& row_end) {
  int acc = 0;
  for (int i = 0; i < E; ++i) {
    const int lo = offsets[i], hi = offsets[i + 1];
    const int nt = (hi - lo + kBM - 1) / kBM;
    if (tile < acc + nt) {
      e = i;
      row0 = lo + (tile - acc) * kBM;
      row_end = hi;
      return true;
    }
    acc += nt;
  }
  return false;
}

template <bool kGated>
__device__ __forceinline__ void grouped_tile(const Args& g, bf16* smem) {
  int e, row0, row_end;
  if (!find_tile(g.offsets, g.E, blockIdx.y, e, row0, row_end)) return;
  bf16* sA = smem;                          // kStages x [kBM][kBK]
  bf16* sB = smem + kStages * kBM * kBK;    // kStages x [kBK][kBN]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = blockIdx.x * (kGated ? kBN / 2 : kBN);

  // This thread's rows of the A tile (chunk tid % 8 of rows tid / 8 + 32 j)
  // and of the B tile (chunk tid % 32 of rows tid / 32 + 8 j).
  constexpr int kCB = kBN / 8;                  // chunks of a B row
  constexpr int kRB = kThreads / kCB;           // B rows a pass
  const int ca = tid & 7, cb = tid % kCB;
  const bf16* a_src[4];
  int a_bytes[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = (tid >> 3) + 32 * j;
    const int row = row0 + r;
    const bool ok = row < row_end;
    const long long src = ok ? (g.token ? g.token[row] : row) : 0;
    a_src[j] = g.a + src * g.lda + ca * 8;
    a_bytes[j] = ok ? 16 : 0;
  }
  const long long w_off = (long long)e * g.depth * g.ldw;
  const bf16* b_src;
  if (kGated) {  // chunk cb: warp cb / kNJ; its first half Wg, second Wu
    const int q = cb % kNJ, half = kNJ / 2;
    b_src = (q < half ? g.w0 : g.w1) + w_off + n0 + (cb / kNJ) * (kWN / 2) +
            (q % half) * 8;
  } else {
    b_src = g.w0 + w_off + n0 + cb * 8;
  }

  auto load = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    bf16* a_dst = sA + stage * kBM * kBK;
    bf16* b_dst = sB + stage * kBK * kBN;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      tc::cp_async16(a_dst + tc::swz<kBK>((tid >> 3) + 32 * j, ca),
                     a_src[j] + k0, a_bytes[j]);
#pragma unroll
    for (int j = 0; j < kBK / kRB; ++j) {
      const int r = tid / kCB + kRB * j;
      tc::cp_async16(b_dst + tc::swz<kBN>(r, cb),
                     b_src + (long long)(k0 + r) * g.ldw, 16);
    }
  };

  float acc[4][kNJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  const int steps = g.depth / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nk = kt + kStages - 1;
    if (nk < steps) load(nk % kStages, nk);
    tc::cp_async_commit();
    const bf16* a_t = sA + (kt % kStages) * kBM * kBK;
    const bf16* b_t = sB + (kt % kStages) * kBK * kBN;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t b[kNJ / 2][4];
#pragma unroll
      for (int nb = 0; nb < kNJ / 2; ++nb)
        tc::load_b_kn<kBN>(b[nb], b_t, kk, wn * kWN + nb * 16);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t a[4];
        tc::load_a<kBK>(a, a_t, wm * 64 + mi * 16, kk);
#pragma unroll
        for (int nj = 0; nj < kNJ; ++nj)
          tc::mma(acc[mi][nj], a, b[nj >> 1][(nj & 1) * 2],
                  b[nj >> 1][(nj & 1) * 2 + 1]);
      }
    }
  }
  tc::cp_async_wait<0>();

  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + wm * 64 + mi * 16 + gid + half * 8;
      if (row >= row_end) continue;
      if (kGated) {
#pragma unroll
        for (int nj = 0; nj < kNJ / 2; ++nj) {
          const float g0 = acc[mi][nj][2 * half], g1 = acc[mi][nj][2 * half + 1];
          const float u0 = acc[mi][nj + kNJ / 2][2 * half];
          const float u1 = acc[mi][nj + kNJ / 2][2 * half + 1];
          const float h0 = g0 / (1.f + __expf(-g0)) * u0;
          const float h1 = g1 / (1.f + __expf(-g1)) * u1;
          const int col = n0 + wn * (kWN / 2) + nj * 8 + 2 * tig;
          *reinterpret_cast<uint32_t*>(g.out + (long long)row * g.ldw + col) =
              tc::pack_bf16(h0, h1);
        }
      } else {
#pragma unroll
        for (int nj = 0; nj < kNJ; ++nj) {
          const int col = n0 + wn * kWN + nj * 8 + 2 * tig;
          *reinterpret_cast<uint32_t*>(g.out + (long long)row * g.ldw + col) =
              tc::pack_bf16(acc[mi][nj][2 * half], acc[mi][nj][2 * half + 1]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
moe_up_prefill_kernel(const Args g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  grouped_tile<true>(g, reinterpret_cast<bf16*>(smem_raw));
}
__global__ void __launch_bounds__(kThreads, 1)
moe_down_prefill_kernel(const Args g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  grouped_tile<false>(g, reinterpret_cast<bf16*>(smem_raw));
}
__global__ void __launch_bounds__(kThreads, 1)
moe_up_decode_kernel(const Args g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  grouped_tile<true>(g, reinterpret_cast<bf16*>(smem_raw));
}
__global__ void __launch_bounds__(kThreads, 1)
moe_down_decode_kernel(const Args g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  grouped_tile<false>(g, reinterpret_cast<bf16*>(smem_raw));
}

typedef void (*Kernel)(const Args);
const Kernel kKernels[4] = {moe_up_prefill_kernel, moe_down_prefill_kernel,
                            moe_up_decode_kernel, moe_down_decode_kernel};
const char* kNames[4] = {"moe_up_prefill_kernel", "moe_down_prefill_kernel",
                         "moe_up_decode_kernel", "moe_down_decode_kernel"};
bool configured[4] = {false, false, false, false};

// Raises kernel i's dynamic shared-memory limit once, before its first
// launch.
bool allow_smem(int i) {
  if (!configured[i]) {
    if (cudaFuncSetAttribute(kKernels[i],
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem) != cudaSuccess)
      return false;
    configured[i] = true;
  }
  return true;
}

}  // namespace

// x: (T, d) bf16, rows 16-byte aligned, row stride ldx elements; token:
// (pairs,) int32, the token of each pair in expert order; offsets:
// (E + 1,) int32 on the device; w_gate, w_up: (E, d, f), w_down: (E, f,
// d), bf16 contiguous; h: (pairs, f) and y: (pairs, d) bf16 contiguous.
// Needs d % 256 == 0 and f % 128 == 0.  Two launches on `stream` (the
// decode kernels with decode != 0); errors are left to
// cudaGetLastError.  Returns false, launching nothing, on bad sizes or
// when the shared-memory limit cannot be raised.
extern "C" bool repro_moe_experts(const void* x, const int* token,
                                  const int* offsets, const void* w_gate,
                                  const void* w_up, const void* w_down,
                                  void* h, void* y, int pairs, int E, int d,
                                  int f, long long ldx, int decode,
                                  cudaStream_t stream) {
  if (d % kBN || f % (kBN / 2) || d % kBK || f % kBK || pairs <= 0)
    return false;
  const int up = decode ? 2 : 0, down = up + 1;
  if (!allow_smem(up) || !allow_smem(down)) return false;
  const int tiles = (pairs + kBM - 1) / kBM + E;
  Args g{static_cast<const bf16*>(x), token, offsets,
         static_cast<const bf16*>(w_gate), static_cast<const bf16*>(w_up),
         static_cast<bf16*>(h), E, d, f, ldx};
  kKernels[up]<<<dim3(f / (kBN / 2), tiles), kThreads, kSmem, stream>>>(g);
  Args g2{static_cast<const bf16*>(h), nullptr, offsets,
          static_cast<const bf16*>(w_down), nullptr, static_cast<bf16*>(y),
          E, f, d, (long long)f};
  kKernels[down]<<<dim3(d / kBN, tiles), kThreads, kSmem, stream>>>(g2);
  return true;
}

// Facts about kernel idx (0 up, 1 down, 2 and 3 their decode names), for
// reports: its name and out[0..5] (tc::kernel_info).  False past the
// last kernel or on a CUDA error.
extern "C" bool repro_moe_info(int idx, const char** name, int* out) {
  if (idx < 0 || idx >= 4) return false;
  *name = kNames[idx];
  return tc::kernel_info(kKernels[idx], kThreads, kSmem, out);
}
