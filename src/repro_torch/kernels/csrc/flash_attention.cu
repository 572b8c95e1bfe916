// Flash-attention forward for Hopper (sm_90a).  Plain CUDA with a C
// entry point: bindings.cpp launches it and checks the launch.
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
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int G, Strides qs, Strides ks, Strides vs, Strides os,
                 float scale, int causal, int q_offset, int kv_len,
                 int window) {
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
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, int B,
            int Sq, int Sk, int Hq, int Hkv, Strides qs, Strides ks,
            Strides vs, Strides os, float scale, int causal, int q_offset,
            int kv_len, int window, cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, Hq / Hkv, qs,
      ks, vs, os, scale, causal, q_offset, kv_len, window);
}

// Returns false, launching nothing, for a head_dim without an
// instantiation.
template <typename T>
bool dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
                int B, int Sq, int Sk, int Hq, int Hkv, Strides qs,
                Strides ks, Strides vs, Strides os, float scale, int causal,
                int q_offset, int kv_len, int window, cudaStream_t s) {
  decltype(&launch<T, 16>) fn;
  switch (D) {
    case 16: fn = &launch<T, 16>; break;
    case 32: fn = &launch<T, 32>; break;
    case 64: fn = &launch<T, 64>; break;
    case 128: fn = &launch<T, 128>; break;
    default: return false;
  }
  fn(q, k, v, o, B, Sq, Sk, Hq, Hkv, qs, ks, vs, os, scale, causal, q_offset,
     kv_len, window, s);
  return true;
}

}  // namespace

// q: (B, Sq, Hq, D), k/v: (B, Sk, Hkv, D), o: (B, Sq, Hq, D), each with a
// contiguous D axis and the given element strides for (batch, seq, head).
// bf16 != 0 selects bf16 tensors, else f32.  Requires 0 <= kv_len <= Sk.
// Launches on `stream` and leaves the launch's error to cudaGetLastError;
// returns false, launching nothing, when D is not 16, 32, 64 or 128.
extern "C" bool repro_flash_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, int q_offset,
    int kv_len, int window, int bf16, cudaStream_t s) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  if (bf16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, Sq, Sk, Hq, Hkv, qs,
                                     ks, vs, os, scale, causal, q_offset,
                                     kv_len, window, s);
  return dispatch_d<float>(D, q, k, v, o, B, Sq, Sk, Hq, Hkv, qs, ks, vs,
                           os, scale, causal, q_offset, kv_len, window, s);
}
