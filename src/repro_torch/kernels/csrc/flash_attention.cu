// Flash-attention forward and backward for Hopper (sm_90a).  Plain CUDA
// with C entry points: bindings.cpp launches them and checks the launches.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (body _flash_kernel): online-softmax attention
// with GQA (q head h reads kv head h / G), masks built from indices
// (k_pos < kv_len, causal k_pos <= q_offset + q_pos, sliding window
// k_pos > q_pos - window) and out = acc / max(l, 1e-30).
//
// Bound on the card.  The work is 4*B*Hq*Sq*Sk_valid*D FLOPs (about half
// of the full product under a causal mask) against reading q, k, v and
// writing out once (K and V only over the rows some query can see).  At
// the yi-6b prefill shape (B=4, Sq=512, kv_len=512, 32/4 heads, D=128)
// the two bounds are close: 8.6 GFLOP is 8.7 us at the bf16 tensor-core
// peak and 37.7 MB is 11.3 us at HBM rate.  This first version
// is a simple, exact one: the products run as f32 FMAs on the CUDA cores
// (no tensor cores, no TF32), so it is limited by FMA throughput far
// above either bound; wgmma, TMA and tuning are later work.
//
// Design.  The TPU kernel carries (m, l, acc) in VMEM scratch across a
// sequential KV grid axis; here one thread block owns one (batch, q head,
// 64-row q tile) and loops over 64-key K/V tiles itself.  q, k and v are
// read in the (B, S, H, D) layout through strides, so nothing is
// transposed.  Q (pre-scaled, as the reference scales it) and one K or V
// tile at a time sit in shared memory as f32 with rows padded to D + 1,
// which keeps the 16x16 thread layout free of bank conflicts.  Each
// thread owns a 4x4 block of scores and 4 rows x D/16 columns of the
// accumulator; row max and row sum are reduced with shuffles over the 16
// threads of a row.  K tiles wholly beyond kv_len, above the causal
// diagonal or before the sliding window are skipped: that changes no row
// with at least one valid key.  A row with no valid key at all comes out
// as the mean of V over the tiles the block visits (zero if it visits
// none), where the references average over every cached position.
// When asked (training), the forward also writes the f32 row statistic
// lse = m + log(max(l, 1e-30)) as (B, Sq, Hq); serving passes no buffer
// and pays nothing.
//
// Backward: the twin of repro/kernels/ref.py::_flash_bwd_inner (the JAX
// package has no Pallas backward).  With p = exp(s - lse) recomputed per
// tile and delta = rowsum(dO * O):
//   dv = p^T dO,  ds = p * (dO V^T - delta),  dk = ds^T (q * scale),
//   dq = scale * ds K,
// dk and dv summed over the G q heads that read each kv head.  Three
// kernels, no atomics, the same result on every run:
//   1. delta, one warp per (b, q row, q head);
//   2. dk, dv: one block per (b, kv head, 64-key tile) loops over its G
//      q heads and the q tiles that can see the keys, holding dk and dv
//      in registers;
//   3. dq: one block per (b, q head, 64-row q tile) loops over the key
//      tiles its rows can see, as the forward does.
// At the yi-6b training shape (B=4, S=512, 32/4 heads, D=128, causal) the
// work is about 21.5 GFLOP (21.7 us at the bf16 tensor-core peak) against
// about 76 MB (22.6 us); like the forward, these first kernels run f32
// FMAs on the CUDA cores and are bound by that arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o,
            float* lse, int B, int Sq, int Sk, int Hq, int Hkv, Strides qs,
            Strides ks, Strides vs, Strides os, float scale, int causal,
            int q_offset, int kv_len, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // Raise the dynamic shared-memory limit once per instantiation (a
  // repeated call would be harmless), so that launches captured into a
  // CUDA graph make no other API call.  A failure is left to
  // cudaGetLastError, like a failed launch.
  static bool configured = false;
  if (!configured) {
    if (cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess)
      return;
    configured = true;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, Hq / Hkv,
      qs, ks, vs, os, scale, causal, q_offset, kv_len, window);
}

// Raises a kernel's dynamic shared-memory limit once per instantiation of
// the caller (see launch above).  Returns false if that failed; the error
// is left to cudaGetLastError.
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

template <typename T, int D>
void launch_bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, int B, int Sq, int Sk, int Hq, int Hkv,
                Strides qs, Strides ks, Strides vs, Strides dos, float scale,
                int causal, int q_offset, int kv_len, int window,
                cudaStream_t stream) {
  static bool dkdv_ok = false, dq_ok = false;
  constexpr size_t smem_dkdv = bwd_smem_bytes<D>(2);
  constexpr size_t smem_dq = bwd_smem_bytes<D>(1);
  if (!allow_smem(flash_bwd_dkdv_kernel<T, D>, smem_dkdv, &dkdv_ok) ||
      !allow_smem(flash_bwd_dq_kernel<T, D>, smem_dq, &dq_ok))
    return;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const long long rows = (long long)B * Sq * Hq;
  const int warps = kThreads / 32;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + warps - 1) / warps),
                              kThreads, 0, stream>>>(
      static_cast<const T*>(o), tdo, delta, rows, D);
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

}  // namespace

// q: (B, Sq, Hq, D), k/v: (B, Sk, Hkv, D), o: (B, Sq, Hq, D), each with a
// contiguous D axis and the given element strides for (batch, seq, head).
// bf16 != 0 selects bf16 tensors, else f32.  Requires 0 <= kv_len <= Sk.
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
// strides; o: the forward's output and lse its (B, Sq, Hq) f32 statistic,
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
