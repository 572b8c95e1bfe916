// Flash-attention forward and backward for Hopper (sm_90a).  Plain CUDA
// with C entry points: bindings.cpp launches them and checks the launches.
//
// Forward: replaces the TPU kernel repro/kernels/flash_attention.py:80
// flash_attention_pallas (body _flash_kernel, :33): online-softmax
// attention with GQA (q head h reads kv head h / G), masks built from
// indices (k_pos < kv_len, causal k_pos <= q_offset + q_pos, sliding
// window k_pos > q_pos - window) and out = acc / max(l, 1e-30).  When
// asked (training), it also writes the f32 row statistic
// lse = m + log(max(l, 1e-30)) as (B, Sq, Hq); serving passes no buffer
// and pays nothing.
//
// Bound on the card.  The work is 4*B*Hq*pairs*D FLOPs over the visible
// (query, key) pairs (about half the full product under a causal mask)
// against reading q, k, v and writing out (and lse) once, K and V only
// over the rows some query can see.  At the three main-path shapes:
//   yi-6b training, B=4, S=512, 32/4 heads of 128, causal: 8.6 GFLOP
//     (8.7 us at the bf16 tensor-core peak) vs 38 MB (11.4 us): bytes;
//   yi-6b prefill, the same over a 552-row cache with kv_len 512: the
//     same, 11.3 us, bytes;
//   zamba2-1.2b prefill, B=4, Sq=2048 over a 2088-row cache, kv_len
//     2048, 32/32 heads of 64: 68.7 GFLOP (69.5 us) vs 134 MB (40 us):
//     operations.
// So the forward has to run its products on the tensor cores; on the
// CUDA cores' f32 FMAs (the f32 kernel below) it runs 40x its bound.
//
// bf16 (the main path): tensor cores, FA2-style.  One block of 4 warps
// per (b, q head, 64-row q tile), heaviest causal tiles launched first;
// each warp owns 16 q rows.  Q is copied once (cp.async) into a swizzled
// bf16 tile (tc.cuh) and kept as mma.sync A fragments in registers.  K
// and V walk a double-buffered cp.async ring of 64-key steps: step t + 1
// (K and V both) is issued before step t multiplies.  S = Q K^T runs as
// mma.sync.m16n8k16 (bf16 in, f32 sums) from ldmatrix B fragments of the
// [key][d] K tile; S is scaled in f32 (q is not pre-scaled in bf16:
// 128^-0.5 is no power of two) with log2(e) folded in, for ex2.approx.  The
// online softmax works on the C fragments: row max and the rescale per
// row (the 4 lanes of a row reduce with shuffles), the row sum kept per
// lane and reduced once at the end.  P is rounded to bf16 straight from
// the C fragments into the A fragments of O += P V (tc::pack_a), with V's
// B fragments read by ldmatrix.trans from the [key][d] tile; O stays in
// f32 registers (64 a thread at D = 128).  Masks come from indices and
// are applied only on steps that straddle a boundary for the warp's rows.
//
// Skipped steps and fully masked rows.  Key steps that no row of the
// block can see (wholly beyond kv_len, above the causal diagonal or
// before the sliding window) are skipped: that changes no row with at
// least one valid key.  A row with no valid key at all comes out as the
// mean of V over the steps the block visits (zero if it visits none),
// where the references average over every cached position; serving and
// training never make one.
//
// f32 (the 3e-5 sweeps, no main path): f32 FMAs on the CUDA cores from
// f32 tiles padded to D + 1 (TF32 cannot meet 3e-5): Q pre-scaled, one
// K or V tile at a time in shared memory, each thread a 4x4 block of
// scores and 4 rows x D/16 columns of the accumulator.
//
// Backward: the twin of repro/kernels/ref.py::_flash_bwd_inner (the JAX
// package has no Pallas backward).  With p = exp(s - lse) recomputed per
// tile and delta = rowsum(dO * O):
//   dv = p^T dO,  ds = p * (dO V^T - delta),  dk = ds^T (q * scale),
//   dq = scale * ds K,
// dk and dv summed over the G q heads that read each kv head.  No float
// atomics anywhere: the same bits on every run.  At the yi-6b training
// shape (B=4, S=512, 32/4 heads, D=128, causal) the work is about 21.5
// GFLOP (21.7 us at the bf16 tensor-core peak) against about 76 MB (22.6
// us): the bound is the bytes, by a hair.
//
// bf16 (the training path): tensor cores.  The five products (S = Q K^T,
// dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K) run as
// mma.sync.m16n8k16 with bf16 operands and f32 accumulators, fed by
// ldmatrix from bf16 tiles in shared memory (swizzled, tc.cuh) that
// cp.async loads through a ring (4 steps deep for dk/dv, lse and delta
// included; double-buffered for dq), so the next steps load while one
// multiplies.  S is scaled in f32; P = exp(S - lse) and dS = P * (dP -
// delta) are formed in f32 registers and rounded to bf16 only as
// operands of the dV, dK and dQ products, straight from the C fragments
// (no trip through shared memory); dK and dQ are scaled in f32 at the
// end.
//   1. delta, one warp per (b, q row, q head);
//   2. dk, dv: a cluster of C blocks of 4 warps per (64-key tile, kv
//      head, b), C the largest divisor of G up to 8 (the portable cluster
//      size); block j walks q heads j, j + C, ... of the kv head's G, and
//      the q tiles of 32 rows that can see its keys.  Each warp owns 16
//      keys and computes S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T
//      come out as the A operands of dV and dK.  At the end the cluster
//      sums its blocks' f32 dk, dv through distributed shared memory, in
//      rank order, each block writing a slice of the tile's rows.  Why
//      split the q heads: one block per (key tile, kv head, b) gives 128
//      blocks for 132 SMs at the training shape, the causal key tile 0
//      walking 8x the steps of tile 7; one block per q head (C = G = 8)
//      gives 1024 blocks, about four waves at two blocks a SM, which even
//      out the causal imbalance, and the sum stays on chip (no f32
//      partials in memory);
//   3. dq: one block of 4 warps per (64-row q tile, q head, b) walks the
//      64-key steps its rows can see; each warp owns 16 q rows.
//
// f32 backward (the 3e-5 sweeps, no main path): f32 FMAs on the CUDA
// cores over f32 tiles padded to D + 1.  Three kernels: delta; dk/dv with
// one block per (key tile, kv head, b) looping over its G q heads; dq as
// above.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Reductions over the 16 lanes that share one score row (same ty).
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
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Strides {
  long long b, s, h;  // element strides; the D axis is contiguous
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)((kBQ + kBK) * (D + 1) + kBQ * (kBK + 1));
}

// Loads a (rows x D) tile starting at sequence row `row0` into shared
// memory as f32 times `mul`, zero-filling rows at or beyond `n_rows`.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long s_stride, int row0,
                                          int n_rows, int rows, float mul) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int g = row0 + r;
    dst[r * (D + 1) + d] =
        g < n_rows ? to_f32(src[(long long)g * s_stride + d]) * mul : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int G, Strides qs,
                 Strides ks, Strides vs, Strides os, float scale, int causal,
                 int q_offset, int kv_len, int window) {
  constexpr int DP = D + 1, PP = kBK + 1, ND = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;               // kBQ x DP
  float* sKV = sQ + kBQ * DP;     // kBK x DP, K then V of one tile
  float* sP = sKV + kBK * DP;     // kBQ x PP

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  load_tile<T, D>(sQ, qb, qs.s, q0, Sq, kBQ, scale);

  float m[4], l[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  }

  // Key range any row of this tile can see.
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, Sq) - 1;
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q_last + 1);
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int t_end = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;

  __syncthreads();
  for (int t = t_begin; t < t_end; ++t) {
    const int kbase = t * kBK;
    load_tile<T, D>(sKV, kb, ks.s, kbase, Sk, kBK, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sKV[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = q_offset + q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kbase + tx + 16 * j;
        const bool ok = kp < kv_len && (!causal || kp <= qp) &&
                        (window <= 0 || kp > qp - window);
        s[i][j] = ok ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[r * PP + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * alpha + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // K reads done, P written

    load_tile<T, D>(sKV, vb, vs.s, kbase, Sk, kBK, 1.f);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const float vv = sKV[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
    __syncthreads();  // V and P reads done before the next tile
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      ob[(long long)qi * os.s + tx + 16 * j] = from_f32<T>(acc[i][j] / den);
    if (lse != nullptr && tx == 0)
      lse[((long long)b * Sq + qi) * gridDim.y + h] = m[i] + logf(den);
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// delta[r] = sum_d dout[r, d] * o[r, d] over the rows r of the contiguous
// (B * Sq * Hq, D) views of o and dout: one warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows, int D) {
  const long long r = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const T* orow = o + r * D;
  const T* drow = dout + r * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32)
    s = fmaf(to_f32(orow[d]), to_f32(drow[d]), s);
  s = warp_sum(s);
  if (lane == 0) delta[r] = s;
}

template <int D>
constexpr size_t bwd_smem_bytes(int n_ds) {
  return sizeof(float) * (size_t)(2 * (kBQ + kBK) * (D + 1) +
                                  n_ds * kBQ * (kBK + 1) + 2 * kBQ);
}

// Loads the per-row lse and delta of q rows q0 .. q0 + kBQ - 1 of head h
// ((B, Sq, Hq) f32), zero beyond Sq.
__device__ __forceinline__ void load_row_stats(
    float* sL, float* sDelta, const float* lse, const float* delta, int b,
    int h, int Hq, int Sq, int q0) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const int qi = q0 + r;
    const long long idx = ((long long)b * Sq + qi) * Hq + h;
    sL[r] = qi < Sq ? lse[idx] : 0.f;
    sDelta[r] = qi < Sq ? delta[idx] : 0.f;
  }
}

// For the 64 x 64 tile of q rows q0.. (sQ pre-scaled, sdO) against keys
// kbase.. (sK, sV): p = exp(s - lse) where the pair is visible, else 0,
// and ds = p * (dO . v - delta).  Writes p to sP (if not null) and ds to
// sdS, both [q row][key].
template <int D>
__device__ __forceinline__ void p_and_ds(
    const float* sQ, const float* sdO, const float* sK, const float* sV,
    const float* sL, const float* sDelta, float* sP, float* sdS, int q0,
    int kbase, int Sq, int causal, int q_offset, int kv_len, int window) {
  constexpr int DP = D + 1, PP = kBK + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = sQ[(ty + 16 * i) * DP + d];
      dov[i] = sdO[(ty + 16 * i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = sK[(tx + 16 * j) * DP + d];
      vv[j] = sV[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
    const int qp = q_offset + qi;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int kp = kbase + c;
      const bool ok = qi < Sq && kp < kv_len && (!causal || kp <= qp) &&
                      (window <= 0 || kp > qp - window);
      const float p = ok ? expf(s[i][j] - sL[r]) : 0.f;
      if (sP != nullptr) sP[r * PP + c] = p;
      sdS[r * PP + c] = p * (dp[i][j] - sDelta[r]);
    }
  }
}

// dk, dv: (B, Sk, Hkv, D) contiguous.  Block (key tile, kv head, batch).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Sk, int Hq, int G,
                      Strides qs, Strides ks, Strides vs, Strides dos,
                      float scale, int causal, int q_offset, int kv_len,
                      int window) {
  constexpr int DP = D + 1, PP = kBK + 1, ND = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;               // kBK x DP
  float* sV = sK + kBK * DP;      // kBK x DP
  float* sQ = sV + kBK * DP;      // kBQ x DP, pre-scaled
  float* sdO = sQ + kBQ * DP;     // kBQ x DP
  float* sP = sdO + kBQ * DP;     // kBQ x PP
  float* sdS = sP + kBQ * PP;     // kBQ x PP
  float* sL = sdS + kBQ * PP;     // kBQ
  float* sDelta = sL + kBQ;       // kBQ

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kBK, hk = blockIdx.y, b = blockIdx.z;
  const int Hkv = gridDim.y;

  float adk[4][ND], adv[4][ND];  // key rows ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) adk[i][j] = adv[i][j] = 0.f;

  // q rows that can see a key of this tile: causal needs q_offset + qi >=
  // k0; the window needs q_offset + qi < k_last + window.
  int qi_begin = 0, qi_end = 0;
  if (k0 < kv_len) {
    const int k_last = min(k0 + kBK, kv_len) - 1;
    qi_begin = causal ? max(0, k0 - q_offset) : 0;
    qi_end = window > 0 ? min(Sq, max(0, k_last + window - q_offset)) : Sq;
  }
  if (qi_begin < qi_end) {
    load_tile<T, D>(sK, k + b * ks.b + hk * ks.h, ks.s, k0, Sk, kBK, 1.f);
    load_tile<T, D>(sV, v + b * vs.b + hk * vs.h, vs.s, k0, Sk, kBK, 1.f);
    const int t_begin = qi_begin / kBQ, t_end = (qi_end + kBQ - 1) / kBQ;
    for (int g = 0; g < G; ++g) {
      const int h = hk * G + g;
      for (int t = t_begin; t < t_end; ++t) {
        const int q0 = t * kBQ;
        load_tile<T, D>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq, kBQ,
                        scale);
        load_tile<T, D>(sdO, dout + b * dos.b + h * dos.h, dos.s, q0, Sq,
                        kBQ, 1.f);
        load_row_stats(sL, sDelta, lse, delta, b, h, Hq, Sq, q0);
        __syncthreads();
        p_and_ds<D>(sQ, sdO, sK, sV, sL, sDelta, sP, sdS, q0, k0, Sq,
                    causal, q_offset, kv_len, window);
        __syncthreads();
#pragma unroll 4
        for (int c = 0; c < kBQ; ++c) {
          float pv[4], dsv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pv[i] = sP[c * PP + ty + 16 * i];
            dsv[i] = sdS[c * PP + ty + 16 * i];
          }
#pragma unroll
          for (int j = 0; j < ND; ++j) {
            const float dov = sdO[c * DP + tx + 16 * j];
            const float qv = sQ[c * DP + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              adv[i][j] = fmaf(pv[i], dov, adv[i][j]);
              adk[i][j] = fmaf(dsv[i], qv, adk[i][j]);
            }
          }
        }
        __syncthreads();  // reads done before the next q tile loads
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= Sk) continue;
    const long long base = (((long long)b * Sk + kr) * Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      dk[base + tx + 16 * j] = from_f32<T>(adk[i][j]);
      dv[base + tx + 16 * j] = from_f32<T>(adv[i][j]);
    }
  }
}

// dq: (B, Sq, Hq, D) contiguous.  Block (q tile, q head, batch).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int G, Strides qs, Strides ks,
                    Strides vs, Strides dos, float scale, int causal,
                    int q_offset, int kv_len, int window) {
  constexpr int DP = D + 1, PP = kBK + 1, ND = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;               // kBK x DP
  float* sV = sK + kBK * DP;      // kBK x DP
  float* sQ = sV + kBK * DP;      // kBQ x DP, pre-scaled
  float* sdO = sQ + kBQ * DP;     // kBQ x DP
  float* sdS = sdO + kBQ * DP;    // kBQ x PP
  float* sL = sdS + kBQ * PP;     // kBQ
  float* sDelta = sL + kBQ;       // kBQ

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int Hq = gridDim.y, hk = h / G;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  load_tile<T, D>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq, kBQ, scale);
  load_tile<T, D>(sdO, dout + b * dos.b + h * dos.h, dos.s, q0, Sq, kBQ,
                  1.f);
  load_row_stats(sL, sDelta, lse, delta, b, h, Hq, Sq, q0);

  float adq[4][ND];  // q rows ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) adq[i][j] = 0.f;

  // Key range any row of this tile can see (as in the forward).
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, Sq) - 1;
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q_last + 1);
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int t_end = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;

  for (int t = t_begin; t < t_end; ++t) {
    const int kbase = t * kBK;
    load_tile<T, D>(sK, kb, ks.s, kbase, Sk, kBK, 1.f);
    load_tile<T, D>(sV, vb, vs.s, kbase, Sk, kBK, 1.f);
    __syncthreads();
    p_and_ds<D>(sQ, sdO, sK, sV, sL, sDelta, nullptr, sdS, q0, kbase, Sq,
                causal, q_offset, kv_len, window);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sdS[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const float kv = sK[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) adq[i][j] = fmaf(dsv[i], kv, adq[i][j]);
      }
    }
    __syncthreads();  // reads done before the next key tile loads
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const long long base = (((long long)b * Sq + qi) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      dq[base + tx + 16 * j] = from_f32<T>(adq[i][j] * scale);
  }
}

// ---------------------------------------------------------------------------
// Backward on tensor cores (bf16)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;  // 4 warps, each 16 rows of the block
constexpr int kTcKeys = 64;      // keys of a dk/dv block
constexpr int kTcQStep = 32;     // q rows of one step of a dk/dv block
constexpr int kTcQ = 64;         // q rows of a dq block
constexpr int kTcKStep = 64;     // keys of one step of a dq block
constexpr int kTcQStages = 4;    // ring depth of the dk/dv block's steps
constexpr int kTcKStages = 2;    // ring depth of the dq block's steps

// K, V; a ring of Q, dO, lse, delta steps.
template <int D>
constexpr size_t tc_dkdv_smem() {
  return sizeof(bf16) * (size_t)(2 * kTcKeys * D +
                                 2 * kTcQStages * kTcQStep * D) +
         sizeof(float) * 2 * kTcQStages * kTcQStep;
}
// Q, dO; a ring of K, V steps.
template <int D>
constexpr size_t tc_dq_smem() {
  return sizeof(bf16) * (size_t)(2 * kTcQ * D +
                                 2 * kTcKStages * kTcKStep * D);
}

__device__ __forceinline__ bool visible(int qi, int Sq, int qp, int kp,
                                        int kv_len, int causal, int window) {
  return qi < Sq && kp < kv_len && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

// dk, dv (B, Sk, Hkv, D) of one 64-key tile of kv head hk.  Block y =
// hk * C + j of a cluster of C blocks (C divides G, C <= 8) walks the q
// heads hk * G + j + C * m, m = 0 .. G / C - 1, summing in registers;
// the cluster then sums its C blocks' dk, dv through distributed shared
// memory, block j writing rows j * R .. j * R + R - 1 of the tile (R =
// 64 / C rounded up), the blocks' terms added in rank order.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
                         int Sk, int G, int C, Strides qs, Strides ks,
                         Strides vs, Strides dos, float scale, int causal,
                         int q_offset, int kv_len, int window) {
  constexpr int NB = D / 8;               // n8 blocks of a D-wide output
  constexpr int QB = kTcQStep / 8;        // n8 blocks of a q step
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // kTcKeys x D
  bf16* sV = sK + kTcKeys * D;                   // kTcKeys x D
  bf16* sQ = sV + kTcKeys * D;                   // ring of kTcQStep x D
  bf16* sdO = sQ + kTcQStages * kTcQStep * D;    // ring of kTcQStep x D
  float* sL = reinterpret_cast<float*>(sdO + kTcQStages * kTcQStep * D);
  float* sDelta = sL + kTcQStages * kTcQStep;    // rings of kTcQStep

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kTcKeys, b = blockIdx.z;
  const int hk = blockIdx.y / C, j = blockIdx.y % C;
  const int Hkv = gridDim.y / C, Hq = Hkv * G;
  const int krow = warp * 16;  // this warp's keys in the tile

  float adk[NB][4], adv[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) adk[n][i] = adv[n][i] = 0.f;

  // q rows that can see a key of this tile (as in the f32 kernel)
  int qi_begin = 0, qi_end = 0;
  if (k0 < kv_len) {
    const int k_last = min(k0 + kTcKeys, kv_len) - 1;
    qi_begin = causal ? max(0, k0 - q_offset) : 0;
    qi_end = window > 0 ? min(Sq, max(0, k_last + window - q_offset)) : Sq;
  }
  if (qi_begin < qi_end) {
    tc::load_tile_async<kTcKeys, D, kTcThreads>(
        sK, k + b * ks.b + hk * ks.h, ks.s, k0, Sk);
    tc::load_tile_async<kTcKeys, D, kTcThreads>(
        sV, v + b * vs.b + hk * vs.h, vs.s, k0, Sk);
    const int t_begin = qi_begin / kTcQStep;
    const int t_end = (qi_end + kTcQStep - 1) / kTcQStep;
    for (int h = hk * G + j; h < (hk + 1) * G; h += C) {
      const bf16* qb = q + b * qs.b + h * qs.h;
      const bf16* dob = dout + b * dos.b + h * dos.h;
      auto load_step = [&](int tq, int buf) {
        const int q0 = tq * kTcQStep;
        tc::load_tile_async<kTcQStep, D, kTcThreads>(
            sQ + buf * kTcQStep * D, qb, qs.s, q0, Sq);
        tc::load_tile_async<kTcQStep, D, kTcThreads>(
            sdO + buf * kTcQStep * D, dob, dos.s, q0, Sq);
        for (int r = threadIdx.x; r < kTcQStep; r += kTcThreads) {
          const int qi = q0 + r;
          const long long idx = ((long long)b * Sq + qi) * Hq + h;
          const bool ok = qi < Sq;
          tc::cp_async4(sL + buf * kTcQStep + r, ok ? lse + idx : lse,
                        ok ? 4 : 0);
          tc::cp_async4(sDelta + buf * kTcQStep + r,
                        ok ? delta + idx : delta, ok ? 4 : 0);
        }
      };
#pragma unroll
      for (int i = 0; i < kTcQStages - 1; ++i) {  // K, V join the first
        if (t_begin + i < t_end) load_step(t_begin + i, i);
        tc::cp_async_commit();
      }
      for (int tq = t_begin; tq < t_end; ++tq) {
        const int buf = (tq - t_begin) % kTcQStages;
        tc::cp_async_wait<kTcQStages - 2>();
        __syncthreads();  // step tq landed; step tq - 1's slot is free
        const int nx = tq + kTcQStages - 1;
        if (nx < t_end) load_step(nx, (nx - t_begin) % kTcQStages);
        tc::cp_async_commit();
        const bf16* cQ = sQ + buf * kTcQStep * D;
        const bf16* cdO = sdO + buf * kTcQStep * D;
        const float* cL = sL + buf * kTcQStep;
        const float* cDelta = sDelta + buf * kTcQStep;

        // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 q rows a warp
        float s[QB][4], dp[QB][4];
#pragma unroll
        for (int n = 0; n < QB; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t ak[4], av[4];
          tc::load_a<D>(ak, sK, krow, kk * 16);
          tc::load_a<D>(av, sV, krow, kk * 16);
#pragma unroll
          for (int np = 0; np < QB / 2; ++np) {
            uint32_t bq[4], bo[4];
            tc::load_b_nk<D>(bq, cQ, np * 16, kk * 16);
            tc::load_b_nk<D>(bo, cdO, np * 16, kk * 16);
            tc::mma(s[2 * np], ak, bq[0], bq[1]);
            tc::mma(s[2 * np + 1], ak, bq[2], bq[3]);
            tc::mma(dp[2 * np], av, bo[0], bo[1]);
            tc::mma(dp[2 * np + 1], av, bo[2], bo[3]);
          }
        }
        // P^T and dS^T in f32, in place
        const int q0 = tq * kTcQStep;
#pragma unroll
        for (int n = 0; n < QB; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = n * 8 + 2 * t + (i & 1);
            const int qi = q0 + c;
            const int kp = k0 + krow + g + (i >> 1) * 8;
            const float p =
                visible(qi, Sq, q_offset + qi, kp, kv_len, causal, window)
                    ? __expf(s[n][i] * scale - cL[c])
                    : 0.f;
            s[n][i] = p;
            dp[n][i] = p * (dp[n][i] - cDelta[c]);
          }
        // dV += P^T dO, dK += dS^T Q (A operands from registers, in bf16)
#pragma unroll
        for (int kq = 0; kq < QB / 2; ++kq) {
          uint32_t ap[4], ads[4];
          tc::pack_a(ap, s[2 * kq], s[2 * kq + 1]);
          tc::pack_a(ads, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
          for (int nd = 0; nd < D / 16; ++nd) {
            uint32_t bo[4], bq[4];
            tc::load_b_kn<D>(bo, cdO, kq * 16, nd * 16);
            tc::load_b_kn<D>(bq, cQ, kq * 16, nd * 16);
            tc::mma(adv[2 * nd], ap, bo[0], bo[1]);
            tc::mma(adv[2 * nd + 1], ap, bo[2], bo[3]);
            tc::mma(adk[2 * nd], ads, bq[0], bq[1]);
            tc::mma(adk[2 * nd + 1], ads, bq[2], bq[3]);
          }
        }
      }
      tc::cp_async_wait<0>();
      __syncthreads();  // the ring is free for the next head
    }
  }

  if (C == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kr = k0 + krow + g + r * 8;
      if (kr >= Sk) continue;
      const long long o = (((long long)b * Sk + kr) * Hkv + hk) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        *reinterpret_cast<uint32_t*>(dk + o + n * 8) = tc::pack_bf16(
            adk[n][2 * r] * scale, adk[n][2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + o + n * 8) =
            tc::pack_bf16(adv[n][2 * r], adv[n][2 * r + 1]);
      }
    }
    return;
  }
  // The sum over the cluster: this block's f32 dk, dv tile into its own
  // shared memory (2 x kTcKeys x D, dk first), then each block adds up its
  // rows of every block's tile.
  float* red = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = krow + g + r * 8;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int d = n * 8 + 2 * t;
      *reinterpret_cast<float2*>(red + row * D + d) =
          make_float2(adk[n][2 * r] * scale, adk[n][2 * r + 1] * scale);
      *reinterpret_cast<float2*>(red + (kTcKeys + row) * D + d) =
          make_float2(adv[n][2 * r], adv[n][2 * r + 1]);
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's tile is in place
  const int R = (kTcKeys + C - 1) / C;
  const int r_end = min(kTcKeys, (j + 1) * R);
  for (int e = (j * R) * (D / 4) + threadIdx.x; e < r_end * (D / 4);
       e += kTcThreads) {
    const int row = e / (D / 4), d = (e % (D / 4)) * 4;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int rank = 0; rank < C; ++rank) {
      const float* peer = cluster.map_shared_rank(red, rank);
      const float4 a = *reinterpret_cast<const float4*>(peer + row * D + d);
      const float4 c = *reinterpret_cast<const float4*>(
          peer + (kTcKeys + row) * D + d);
      sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
      sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
    }
    const int kr = k0 + row;
    if (kr < Sk) {
      const long long o = (((long long)b * Sk + kr) * Hkv + hk) * D + d;
      *reinterpret_cast<uint2*>(dk + o) = make_uint2(
          tc::pack_bf16(sk.x, sk.y), tc::pack_bf16(sk.z, sk.w));
      *reinterpret_cast<uint2*>(dv + o) = make_uint2(
          tc::pack_bf16(sv.x, sv.y), tc::pack_bf16(sv.z, sv.w));
    }
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// dq of one 64-row q tile of one q head: (B, Sq, Hq, D) bf16.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int Sq, int Sk, int G, Strides qs, Strides ks,
                       Strides vs, Strides dos, float scale, int causal,
                       int q_offset, int kv_len, int window) {
  constexpr int NB = D / 8;
  constexpr int KB = kTcKStep / 8;  // n8 blocks of a key step
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // kTcQ x D
  bf16* sdO = sQ + kTcQ * D;                     // kTcQ x D
  bf16* sK = sdO + kTcQ * D;                     // ring of kTcKStep x D
  bf16* sV = sK + kTcKStages * kTcKStep * D;      // ring of kTcKStep x D

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTcQ, h = blockIdx.y, b = blockIdx.z;
  const int Hq = gridDim.y, hk = h / G;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  const int qrow = warp * 16;  // this warp's rows in the tile

  float rl[2], rd[2];  // lse, delta of rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + qrow + g + r * 8;
    const long long idx = ((long long)b * Sq + qi) * Hq + h;
    rl[r] = qi < Sq ? lse[idx] : 0.f;
    rd[r] = qi < Sq ? delta[idx] : 0.f;
  }
  float adq[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) adq[j][i] = 0.f;

  // Key range any row of this tile can see (as in the forward).
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kTcQ, Sq) - 1;
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q_last + 1);
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int t_begin = k_begin / kTcKStep;
  const int t_end = k_end > 0 ? (k_end + kTcKStep - 1) / kTcKStep : 0;

  tc::load_tile_async<kTcQ, D, kTcThreads>(sQ, q + b * qs.b + h * qs.h, qs.s,
                                           q0, Sq);
  tc::load_tile_async<kTcQ, D, kTcThreads>(
      sdO, dout + b * dos.b + h * dos.h, dos.s, q0, Sq);
  auto load_step = [&](int tk, int buf) {
    tc::load_tile_async<kTcKStep, D, kTcThreads>(
        sK + buf * kTcKStep * D, kb, ks.s, tk * kTcKStep, Sk);
    tc::load_tile_async<kTcKStep, D, kTcThreads>(
        sV + buf * kTcKStep * D, vb, vs.s, tk * kTcKStep, Sk);
  };
#pragma unroll
  for (int i = 0; i < kTcKStages - 1; ++i) {  // Q and dO join the first
    if (t_begin + i < t_end) load_step(t_begin + i, i);
    tc::cp_async_commit();
  }
  for (int tk = t_begin; tk < t_end; ++tk) {
    const int buf = (tk - t_begin) % kTcKStages;
    tc::cp_async_wait<kTcKStages - 2>();
    __syncthreads();  // step tk landed; step tk - 1's slot is free
    const int nx = tk + kTcKStages - 1;
    if (nx < t_end) load_step(nx, (nx - t_begin) % kTcKStages);
    tc::cp_async_commit();
    const bf16* cK = sK + buf * kTcKStep * D;
    const bf16* cV = sV + buf * kTcKStep * D;

    // S = Q K^T and dP = dO V^T: 16 q rows x 64 keys a warp
    float s[KB][4], dp[KB][4];
#pragma unroll
    for (int j = 0; j < KB; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      tc::load_a<D>(aq, sQ, qrow, kk * 16);
      tc::load_a<D>(ao, sdO, qrow, kk * 16);
#pragma unroll
      for (int np = 0; np < KB / 2; ++np) {
        uint32_t bk[4], bv[4];
        tc::load_b_nk<D>(bk, cK, np * 16, kk * 16);
        tc::load_b_nk<D>(bv, cV, np * 16, kk * 16);
        tc::mma(s[2 * np], aq, bk[0], bk[1]);
        tc::mma(s[2 * np + 1], aq, bk[2], bk[3]);
        tc::mma(dp[2 * np], ao, bv[0], bv[1]);
        tc::mma(dp[2 * np + 1], ao, bv[2], bv[3]);
      }
    }
    // dS in f32, in place of S
    const int kbase = tk * kTcKStep;
#pragma unroll
    for (int j = 0; j < KB; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + qrow + g + (i >> 1) * 8;
        const int kp = kbase + j * 8 + 2 * t + (i & 1);
        const float p =
            visible(qi, Sq, q_offset + qi, kp, kv_len, causal, window)
                ? __expf(s[j][i] * scale - rl[i >> 1])
                : 0.f;
        s[j][i] = p * (dp[j][i] - rd[i >> 1]);
      }
    // dQ += dS K (A operand from registers, in bf16)
#pragma unroll
    for (int kq = 0; kq < KB / 2; ++kq) {
      uint32_t ads[4];
      tc::pack_a(ads, s[2 * kq], s[2 * kq + 1]);
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bk[4];
        tc::load_b_kn<D>(bk, cK, kq * 16, nd * 16);
        tc::mma(adq[2 * nd], ads, bk[0], bk[1]);
        tc::mma(adq[2 * nd + 1], ads, bk[2], bk[3]);
      }
    }
  }
  tc::cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + qrow + g + r * 8;
    if (qi >= Sq) continue;
    bf16* o = dq + (((long long)b * Sq + qi) * Hq + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      *reinterpret_cast<uint32_t*>(o + j * 8) =
          tc::pack_bf16(adq[j][2 * r] * scale, adq[j][2 * r + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// Forward on tensor cores (bf16)
// ---------------------------------------------------------------------------

constexpr int kFwdQ = 64;       // q rows of a block, 16 a warp
constexpr int kFwdK = 64;       // keys of one step
constexpr int kFwdStages = 2;   // ring depth of the K/V steps
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// The masked score in log2 units: kNegInf in natural units, so that the
// lse of a row with no valid key stays about kNegInf, as the f32 kernel
// writes it.
constexpr float kMaskLog2 = kNegInf * kLog2e;

// 2^x by the SFU (ex2.approx: relative error about 2^-22; results below
// 2^-126 flush to zero, which only ever rounds a vanishing p).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A ring of K and V steps; Q is staged in the K slot of the last stage
// (first filled once Q's fragments are in registers).
template <int D>
constexpr size_t tc_fwd_smem() {
  static_assert(kFwdQ <= kFwdK, "Q fits a K slot");
  return sizeof(bf16) * (size_t)(2 * kFwdStages * kFwdK * D);
}

// o (B, Sq, Hq, D) bf16 (4-byte aligned rows) and lse of one 64-row q
// tile of one q head.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int Sq, int Sk, int G,
                    Strides qs, Strides ks, Strides vs, Strides os,
                    float scale, int causal, int q_offset, int kv_len,
                    int window) {
  constexpr int NB = D / 8;       // n8 blocks of the output
  constexpr int KB = kFwdK / 8;   // n8 blocks of a key step
  constexpr int KD = D / 16;      // k16 steps over D
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // ring of kFwdK x D
  bf16* sV = sK + kFwdStages * kFwdK * D;        // ring of kFwdK x D
  bf16* sQ = sK + (kFwdStages - 1) * kFwdK * D;  // last stage's K slot

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // the q tiles with the most causal key steps start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFwdQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int Hq = gridDim.y, hk = h / G;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  const int qrow = warp * 16;                  // this warp's rows
  const int qw = q_offset + q0 + qrow;         // position of its first
  const float sl2 = scale * kLog2e;

  // Key range any row of this tile can see (as in the f32 kernel).
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kFwdQ, Sq) - 1;
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q_last + 1);
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int t_begin = k_begin / kFwdK;
  const int t_end = k_end > 0 ? (k_end + kFwdK - 1) / kFwdK : 0;

  // rows g and g + 8 of the warp: running max (log2 units), this lane's
  // share of the row sum, and the f32 output accumulator
  float m[2] = {kMaskLog2, kMaskLog2}, l[2] = {0.f, 0.f};
  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  uint32_t qa[KD][4];

  auto load_step = [&](int tk, int buf) {
    tc::load_tile_async<kFwdK, D, kTcThreads>(sK + buf * kFwdK * D, kb, ks.s,
                                              tk * kFwdK, Sk);
    tc::load_tile_async<kFwdK, D, kTcThreads>(sV + buf * kFwdK * D, vb, vs.s,
                                              tk * kFwdK, Sk);
  };
  if (t_begin < t_end)
    tc::load_tile_async<kFwdQ, D, kTcThreads>(sQ, q + b * qs.b + h * qs.h,
                                              qs.s, q0, Sq);
#pragma unroll
  for (int i = 0; i < kFwdStages - 1; ++i) {  // Q joins the first
    if (t_begin + i < t_end) load_step(t_begin + i, i);
    tc::cp_async_commit();
  }
  for (int tk = t_begin; tk < t_end; ++tk) {
    const int buf = (tk - t_begin) % kFwdStages;
    tc::cp_async_wait<kFwdStages - 2>();
    __syncthreads();  // step tk landed; step tk - 1's slot is free
    if (tk == t_begin) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) tc::load_a<D>(qa[kk], sQ, qrow, kk * 16);
      __syncthreads();  // Q is in registers before a step lands on it
    }
    const int nx = tk + kFwdStages - 1;
    if (nx < t_end) load_step(nx, (nx - t_begin) % kFwdStages);
    tc::cp_async_commit();
    const bf16* cK = sK + buf * kFwdK * D;
    const bf16* cV = sV + buf * kFwdK * D;

    // S = Q K^T: 16 q rows x 64 keys a warp
    float s[KB][4];
#pragma unroll
    for (int j = 0; j < KB; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int np = 0; np < KB / 2; ++np) {
        uint32_t bk[4];
        tc::load_b_nk<D>(bk, cK, np * 16, kk * 16);
        tc::mma(s[2 * np], qa[kk], bk[0], bk[1]);
        tc::mma(s[2 * np + 1], qa[kk], bk[2], bk[3]);
      }

    // scaled to log2 units in f32; the mask only where the step straddles
    // a boundary of the warp's rows
    const int kbase = tk * kFwdK;
    const bool whole = kbase + kFwdK <= kv_len &&
                       (!causal || kbase + kFwdK - 1 <= qw) &&
                       (window <= 0 || kbase > qw + 15 - window);
#pragma unroll
    for (int j = 0; j < KB; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[j][i] * sl2;
        if (!whole) {
          const int kp = kbase + j * 8 + 2 * t + (i & 1);
          const int qp = qw + g + (i >> 1) * 8;
          if (!(kp < kv_len && (!causal || kp <= qp) &&
                (window <= 0 || kp > qp - window)))
            x = kMaskLog2;
        }
        s[j][i] = x;
      }

    // online softmax on the C fragments, P in place of S
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < KB; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2_approx(m[r] - mx);
      m[r] = mx;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < KB; ++j)
#pragma unroll
        for (int i = 2 * r; i < 2 * r + 2; ++i) {
          s[j][i] = exp2_approx(s[j][i] - mx);
          ps += s[j][i];
        }
      l[r] = l[r] * alpha + ps;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // O += P V (A operand from registers, in bf16)
#pragma unroll
    for (int kq = 0; kq < KB / 2; ++kq) {
      uint32_t ap[4];
      tc::pack_a(ap, s[2 * kq], s[2 * kq + 1]);
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bv[4];
        tc::load_b_kn<D>(bv, cV, kq * 16, nd * 16);
        tc::mma(acc[2 * nd], ap, bv[0], bv[1]);
        tc::mma(acc[2 * nd + 1], ap, bv[2], bv[3]);
      }
    }
  }
  tc::cp_async_wait<0>();  // no copy outlives the block

  bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float den = fmaxf(lr, 1e-30f), rden = 1.f / den;
    const int qi = q0 + qrow + g + r * 8;
    if (qi >= Sq) continue;
    bf16* orow = ob + (long long)qi * os.s + 2 * t;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          tc::pack_bf16(acc[n][2 * r] * rden, acc[n][2 * r + 1] * rden);
    if (lse != nullptr && t == 0)
      lse[((long long)b * Sq + qi) * Hq + h] = m[r] * kLn2 + logf(den);
  }
}

// Raises a kernel's dynamic shared-memory limit once per instantiation of
// the caller, so that launches captured into a CUDA graph make no other
// API call (a repeated call would be harmless).  Returns false if that
// failed; the error is left to cudaGetLastError, like a failed launch.
template <typename K>
bool allow_smem(K kernel, size_t smem, bool* configured) {
  if (!*configured) {
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess)
      return false;
    *configured = true;
  }
  return true;
}

// The bf16 forward: tensor cores.
template <int D>
void launch_fwd_typed(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                      float* lse, int B, int Sq, int Sk, int Hq, int Hkv,
                      Strides qs, Strides ks, Strides vs, Strides os,
                      float scale, int causal, int q_offset, int kv_len,
                      int window, cudaStream_t stream) {
  static bool configured = false;
  constexpr size_t smem = tc_fwd_smem<D>();
  if (!allow_smem(flash_fwd_tc_kernel<D>, smem, &configured)) return;
  dim3 grid((Sq + kFwdQ - 1) / kFwdQ, Hq, B);
  flash_fwd_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      q, k, v, o, lse, Sq, Sk, Hq / Hkv, qs, ks, vs, os, scale, causal,
      q_offset, kv_len, window);
}

// The f32 forward on the CUDA cores.
template <int D>
void launch_fwd_typed(const float* q, const float* k, const float* v,
                      float* o, float* lse, int B, int Sq, int Sk, int Hq,
                      int Hkv, Strides qs, Strides ks, Strides vs,
                      Strides os, float scale, int causal, int q_offset,
                      int kv_len, int window, cudaStream_t stream) {
  static bool configured = false;
  constexpr size_t smem = smem_bytes<D>();
  if (!allow_smem(flash_fwd_kernel<float, D>, smem, &configured)) return;
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, lse, Sq, Sk, Hq / Hkv, qs, ks, vs, os, scale, causal,
      q_offset, kv_len, window);
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o,
            float* lse, int B, int Sq, int Sk, int Hq, int Hkv, Strides qs,
            Strides ks, Strides vs, Strides os, float scale, int causal,
            int q_offset, int kv_len, int window, cudaStream_t stream) {
  launch_fwd_typed<D>(static_cast<const T*>(q), static_cast<const T*>(k),
                      static_cast<const T*>(v), static_cast<T*>(o), lse, B,
                      Sq, Sk, Hq, Hkv, qs, ks, vs, os, scale, causal,
                      q_offset, kv_len, window, stream);
}

// Largest divisor of G that is at most 8, the portable cluster size.
int cluster_size(int G) {
  for (int c = 8; c > 1; --c)
    if (G % c == 0) return c;
  return 1;
}

// The bf16 backward: delta; dk/dv, one cluster of C blocks per (key tile,
// kv head, b); dq.
template <int D>
void launch_bwd_typed(const bf16* q, const bf16* k, const bf16* v,
                      const bf16* o, const bf16* dout, const float* lse,
                      float* delta, bf16* dq, bf16* dk, bf16* dv, int B,
                      int Sq, int Sk, int Hq, int Hkv, Strides qs,
                      Strides ks, Strides vs, Strides dos, float scale,
                      int causal, int q_offset, int kv_len, int window,
                      cudaStream_t stream) {
  static bool dkdv_ok = false, dq_ok = false;
  constexpr size_t smem_dkdv = tc_dkdv_smem<D>();
  constexpr size_t smem_dq = tc_dq_smem<D>();
  static_assert(smem_dkdv >= sizeof(float) * 2 * kTcKeys * D,
                "the dk/dv ring also holds the f32 tile of the cluster sum");
  if (!allow_smem(flash_bwd_dkdv_tc_kernel<D>, smem_dkdv, &dkdv_ok) ||
      !allow_smem(flash_bwd_dq_tc_kernel<D>, smem_dq, &dq_ok))
    return;
  const long long rows = (long long)B * Sq * Hq;
  const int warps = kThreads / 32;
  flash_bwd_delta_kernel<bf16><<<(unsigned)((rows + warps - 1) / warps),
                                 kThreads, 0, stream>>>(o, dout, delta, rows,
                                                        D);
  const int G = Hq / Hkv, C = cluster_size(G);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Sk + kTcKeys - 1) / kTcKeys, Hkv * C, B);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = smem_dkdv;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = C;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const float* dl = delta;
  if (cudaLaunchKernelEx(&cfg, flash_bwd_dkdv_tc_kernel<D>, q, k, v, dout,
                         lse, dl, dk, dv, Sq, Sk, G, C, qs, ks, vs, dos,
                         scale, causal, q_offset, kv_len, window) !=
      cudaSuccess)
    return;  // the error stays for cudaGetLastError
  dim3 grid_q((Sq + kTcQ - 1) / kTcQ, Hq, B);
  flash_bwd_dq_tc_kernel<D><<<grid_q, kTcThreads, smem_dq, stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, G, qs, ks, vs, dos, scale,
      causal, q_offset, kv_len, window);
}

// The f32 backward on the CUDA cores: delta, dk/dv, dq.
template <int D>
void launch_bwd_typed(const float* tq, const float* tk, const float* tv,
                      const float* o, const float* tdo, const float* lse,
                      float* delta, float* dq, float* dk, float* dv, int B,
                    int Sq, int Sk, int Hq, int Hkv, Strides qs, Strides ks,
                    Strides vs, Strides dos, float scale, int causal,
                    int q_offset, int kv_len, int window,
                    cudaStream_t stream) {
  using T = float;
  static bool dkdv_ok = false, dq_ok = false;
  constexpr size_t smem_dkdv = bwd_smem_bytes<D>(2);
  constexpr size_t smem_dq = bwd_smem_bytes<D>(1);
  if (!allow_smem(flash_bwd_dkdv_kernel<T, D>, smem_dkdv, &dkdv_ok) ||
      !allow_smem(flash_bwd_dq_kernel<T, D>, smem_dq, &dq_ok))
    return;
  const long long rows = (long long)B * Sq * Hq;
  const int warps = kThreads / 32;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + warps - 1) / warps),
                              kThreads, 0, stream>>>(o, tdo, delta, rows, D);
  const int G = Hq / Hkv;
  dim3 grid_kv((Sk + kBK - 1) / kBK, Hkv, B);
  flash_bwd_dkdv_kernel<T, D><<<grid_kv, kThreads, smem_dkdv, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Sk, Hq, G, qs, ks, vs, dos, scale, causal, q_offset, kv_len,
      window);
  dim3 grid_q((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_bwd_dq_kernel<T, D><<<grid_q, kThreads, smem_dq, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), Sq, Sk, G, qs, ks,
      vs, dos, scale, causal, q_offset, kv_len, window);
}

template <typename T, int D>
void launch_bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta,
                void* dq, void* dk, void* dv, int B, int Sq,
                int Sk, int Hq, int Hkv, Strides qs, Strides ks, Strides vs,
                Strides dos, float scale, int causal, int q_offset,
                int kv_len, int window, cudaStream_t stream) {
  launch_bwd_typed<D>(static_cast<const T*>(q), static_cast<const T*>(k),
                      static_cast<const T*>(v), static_cast<const T*>(o),
                      static_cast<const T*>(dout), lse, delta,
                      static_cast<T*>(dq), static_cast<T*>(dk),
                      static_cast<T*>(dv), B, Sq, Sk, Hq, Hkv, qs, ks, vs,
                      dos, scale, causal, q_offset, kv_len, window, stream);
}

// Returns false, launching nothing, for a head_dim without an
// instantiation.
template <typename T>
bool dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Sq, int Sk, int Hq, int Hkv,
                Strides qs, Strides ks, Strides vs, Strides os, float scale,
                int causal, int q_offset, int kv_len, int window,
                cudaStream_t s) {
  decltype(&launch<T, 16>) fn;
  switch (D) {
    case 16: fn = &launch<T, 16>; break;
    case 32: fn = &launch<T, 32>; break;
    case 64: fn = &launch<T, 64>; break;
    case 128: fn = &launch<T, 128>; break;
    default: return false;
  }
  fn(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, qs, ks, vs, os, scale, causal,
     q_offset, kv_len, window, s);
  return true;
}

template <typename T>
bool dispatch_bwd_d(int D, const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const float* lse,
                    float* delta, void* dq, void* dk, void* dv, int B,
                    int Sq, int Sk, int Hq, int Hkv, Strides qs, Strides ks,
                    Strides vs, Strides dos, float scale, int causal,
                    int q_offset, int kv_len, int window, cudaStream_t s) {
  decltype(&launch_bwd<T, 16>) fn;
  switch (D) {
    case 16: fn = &launch_bwd<T, 16>; break;
    case 32: fn = &launch_bwd<T, 32>; break;
    case 64: fn = &launch_bwd<T, 64>; break;
    case 128: fn = &launch_bwd<T, 128>; break;
    default: return false;
  }
  fn(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, qs, ks,
     vs, dos, scale, causal, q_offset, kv_len, window, s);
  return true;
}

template <int D>
bool fwd_info(int idx, const char** name, int* out) {
  if (idx != 0) return false;
  *name = "flash_fwd_tc_kernel";
  return tc::kernel_info(flash_fwd_tc_kernel<D>, kTcThreads, tc_fwd_smem<D>(),
                         out);
}

template <int D>
bool bwd_info(int idx, const char** name, int* out) {
  switch (idx) {
    case 0:
      *name = "flash_bwd_dkdv_tc_kernel";
      return tc::kernel_info(flash_bwd_dkdv_tc_kernel<D>, kTcThreads,
                             tc_dkdv_smem<D>(), out);
    case 1:
      *name = "flash_bwd_dq_tc_kernel";
      return tc::kernel_info(flash_bwd_dq_tc_kernel<D>, kTcThreads,
                             tc_dq_smem<D>(), out);
    default:
      return false;
  }
}

}  // namespace

// q: (B, Sq, Hq, D), k/v: (B, Sk, Hkv, D), o: (B, Sq, Hq, D), each with a
// contiguous D axis and the given element strides for (batch, seq, head).
// bf16 != 0 selects bf16 tensors, else f32 (bf16: q, k, v 16-byte
// aligned with strides a multiple of 8, o 4-byte aligned with even
// strides).  Requires 0 <= kv_len <= Sk.
// lse: (B, Sq, Hq) f32 contiguous, or null to skip it.  Launches on
// `stream` and leaves the launch's error to cudaGetLastError; returns
// false, launching nothing, when D is not 16, 32, 64 or 128.
extern "C" bool repro_flash_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int B,
    int Sq,
    int Sk, int Hq, int Hkv, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, int q_offset,
    int kv_len, int window, int bf16, cudaStream_t s) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  if (bf16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, lse, B, Sq, Sk, Hq, Hkv,
                                     qs, ks, vs, os, scale, causal, q_offset,
                                     kv_len, window, s);
  return dispatch_d<float>(D, q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, qs, ks,
                           vs, os, scale, causal, q_offset, kv_len, window,
                           s);
}

// Backward.  q: (B, Sq, Hq, D), k/v: (B, Sk, Hkv, D), dout: (B, Sq, Hq, D),
// each with a contiguous D axis and the given (batch, seq, head) element
// strides (for bf16: 16-byte aligned pointers and strides a multiple of
// 8); o: the forward's output and lse its (B, Sq, Hq) f32 statistic,
// both contiguous; delta: (B, Sq, Hq) f32 scratch.  Writes dq
// (B, Sq, Hq, D) and dk, dv (B, Sk, Hkv, D), all contiguous, in the dtype
// of q.  Three launches on `stream`; errors are left to cudaGetLastError.
// Returns false, launching nothing, for a D without an instantiation.
extern "C" bool repro_flash_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh, float scale,
    int causal, int q_offset, int kv_len, int window, int bf16,
    cudaStream_t s) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, dos{do_sb, do_ss, do_sh};
  if (bf16)
    return dispatch_bwd_d<__nv_bfloat16>(
        D, q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, qs,
        ks, vs, dos, scale, causal, q_offset, kv_len, window, s);
  return dispatch_bwd_d<float>(D, q, k, v, o, dout, lse, delta, dq, dk, dv,
                               B, Sq, Sk, Hq, Hkv, qs, ks, vs, dos, scale,
                               causal, q_offset, kv_len, window, s);
}

// Facts about the bf16 backward kernels at head_dim D, for reports: idx
// 0 dk/dv, 1 dq.  Writes the kernel's name and
// out[0..5] (tc::kernel_info).  Returns false past the last kernel, for a
// D without an instantiation, or on a CUDA error.
extern "C" bool repro_flash_bwd_info(int idx, int D, const char** name,
                                     int* out) {
  switch (D) {
    case 16: return bwd_info<16>(idx, name, out);
    case 32: return bwd_info<32>(idx, name, out);
    case 64: return bwd_info<64>(idx, name, out);
    case 128: return bwd_info<128>(idx, name, out);
    default: return false;
  }
}

// Facts about the bf16 forward kernel at head_dim D, for reports: idx 0
// only.  Writes the kernel's name and out[0..5] (tc::kernel_info).
// Returns false past the last kernel, for a D without an instantiation,
// or on a CUDA error.
extern "C" bool repro_flash_fwd_info(int idx, int D, const char** name,
                                     int* out) {
  switch (D) {
    case 16: return fwd_info<16>(idx, name, out);
    case 32: return fwd_info<32>(idx, name, out);
    case 64: return fwd_info<64>(idx, name, out);
    case 128: return fwd_info<128>(idx, name, out);
    default: return false;
  }
}
