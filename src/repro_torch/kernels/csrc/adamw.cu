// AdamW for Hopper (sm_90a): the gradients' global norm and the update,
// plain CUDA with C entry points; bindings.cpp launches them and checks
// the launches.
//
// Replaces no TPU kernel: the JAX package's AdamW (repro/optim/adamw.py,
// adamw_update and clip_by_global_norm) is jnp that XLA fuses.  Run
// eagerly, the same arithmetic took a dozen elementwise kernels a chunk
// of every leaf, a norm pass and a clip pass that wrote every gradient
// back: a third of a yi-6b training step.  Bound on the card: bytes.  The
// update reads p, g, m and v once and writes p, m and v once (22 bytes an
// element with bf16 p and g and f32 moments), the norm pass reads g once
// (2 bytes), so the least time is those bytes over HBM bandwidth (yi-6b's
// 6.06 G elements: 145 GB, 43 ms at 3.35 TB/s).  Design: one launch of
// each pass a leaf, in which every thread takes 8 consecutive elements at
// a time as 16-byte vector loads and stores (two for an f32 operand) and
// nothing is read twice; the clip scale stays in device memory, so the
// step never waits on the host.  A leaf whose operands are not all 16-byte
// aligned takes the same mapping with scalar loads.
//
// Norm: adamw_norm_kernel runs a fixed grid of norm_blocks(n) <= kParts
// blocks over a leaf (chosen by the wrapper from n alone).  Thread t sums
// the squares of vectors t, t + stride, ... in f32, one accumulator a lane
// of the vector; the lanes and then the block are reduced in a fixed tree,
// and block b writes its partial to slot b of the leaf's row of a
// (leaves, kParts) f32 scratch (block 0 zeroes the slots past the grid).
// adamw_norm_final_kernel, one block, reduces each row in a fixed tree
// into the leaf's sum.  No atomics: the bits depend only on the gradients
// and the leaves' sizes.  The wrapper (under sharding rules, after
// summing each leaf's sum over its ranks) takes the norm and the clip
// scale from those sums, by the same code as the plain path.
//
// Update: adamw_update_kernel, each element in f32 in the plain path's
// order, every rounding explicit (nothing contracted into an fma):
//   g'    = round_g(g * scale)            the clip, rounded to g's dtype
//   m'    = b1 * m + (1 - b1) * g'
//   v'    = b2 * v + ((1 - b2) * g') * g'
//   delta = (m' / c1) / (sqrt(v' / c2) + eps)
//   p'    = round_p((p - lr_wd * p) - lr * delta)    decay where p.dim() >= 2
//   m, v <- round_mv(m'), round_mv(v')                delta reads m', v' unrounded
// The clipped gradient is not written back.  A persistent grid (the SM
// count times the blocks a SM holds) walks the leaf's vectors; the ragged
// tail is masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>

#include "tc.cuh"

namespace {

constexpr int kThreads = 256;     // norm and update blocks
constexpr int kVec = 8;           // elements a thread takes at once
constexpr int kParts = 1024;      // slots of a leaf's row of partials
constexpr int kFinalThreads = 1024;  // one a slot of a row
static_assert(kFinalThreads == kParts, "the finalize reads a slot a thread");

// --- 8-element vectors ------------------------------------------------------

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ void load8(const float* p, long long v,
                                      float (&x)[kVec]) {
  const float4* q = reinterpret_cast<const float4*>(p) + 2 * v;
  const float4 a = q[0], b = q[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, long long v,
                                      float (&x)[kVec]) {
  const uint4 u = reinterpret_cast<const uint4*>(p)[v];
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = bf16_bits_to_float(w[i] & 0xffffu);
    x[2 * i + 1] = bf16_bits_to_float(w[i] >> 16);
  }
}

__device__ __forceinline__ void store8(float* p, long long v,
                                       const float (&x)[kVec]) {
  float4* q = reinterpret_cast<float4*>(p) + 2 * v;
  q[0] = make_float4(x[0], x[1], x[2], x[3]);
  q[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, long long v,
                                       const float (&x)[kVec]) {
  uint4 u;
  u.x = bf16_bits(x[0]) | (bf16_bits(x[1]) << 16);
  u.y = bf16_bits(x[2]) | (bf16_bits(x[3]) << 16);
  u.z = bf16_bits(x[4]) | (bf16_bits(x[5]) << 16);
  u.w = bf16_bits(x[6]) | (bf16_bits(x[7]) << 16);
  reinterpret_cast<uint4*>(p)[v] = u;
}

__device__ __forceinline__ float load1(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load1(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store1(float* p, long long i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void store1(__nv_bfloat16* p, long long i,
                                       float x) {
  p[i] = __float2bfloat16_rn(x);
}

// x rounded to T and widened again
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Vector v of a tensor of n elements: whole and aligned as 16-byte loads,
// else element by element (zeros past n).
template <typename T>
__device__ __forceinline__ void get8(const T* p, long long v, long long n,
                                     bool vec, float (&x)[kVec]) {
  if (vec && (v + 1) * kVec <= n) {
    load8(p, v, x);
    return;
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const long long i = v * kVec + e;
    x[e] = i < n ? load1(p, i) : 0.0f;
  }
}

template <typename T>
__device__ __forceinline__ void put8(T* p, long long v, long long n,
                                     bool vec, const float (&x)[kVec]) {
  if (vec && (v + 1) * kVec <= n) {
    store8(p, v, x);
    return;
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const long long i = v * kVec + e;
    if (i < n) store1(p, i, x[e]);
  }
}

// Sum of x over the block in a fixed tree (warp shuffles, then warp 0
// over the warps' sums); the result is valid in thread 0.  `red` holds a
// float a warp.  Ends with the block synchronised, so `red` may be reused.
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < warps ? red[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  __syncthreads();
  return x;
}

// --- kernels ------------------------------------------------------------------

// One leaf's partial sums of squares: block b into part[b]; block 0 zeroes
// part[gridDim.x .. kParts).
template <typename TG>
__global__ void __launch_bounds__(kThreads, 4)
    adamw_norm_kernel(const TG* __restrict__ g, long long n, bool vec,
                      float* __restrict__ part) {
  __shared__ float red[kThreads / 32];
  const long long nv = (n + kVec - 1) / kVec;
  const long long stride = (long long)gridDim.x * kThreads;
  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.0f;
  // four vectors in flight a thread; added in the order of a plain
  // stride loop (a vector past the end adds zeros)
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < nv;
       v += 4 * stride) {
    float x[4][kVec];
#pragma unroll
    for (int u = 0; u < 4; ++u) get8(g, v + u * stride, n, vec, x[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        acc[e] = __fmaf_rn(x[u][e], x[u][e], acc[e]);
  }
  const float t = __fadd_rn(
      __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3])),
      __fadd_rn(__fadd_rn(acc[4], acc[5]), __fadd_rn(acc[6], acc[7])));
  const float s = block_sum(t, red);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
  if (blockIdx.x == 0)
    for (int i = gridDim.x + threadIdx.x; i < kParts; i += kThreads)
      part[i] = 0.0f;
}

// part: (leaves, kParts) f32.  sums[i] = the fixed-tree sum of row i.
__global__ void __launch_bounds__(kFinalThreads)
    adamw_norm_final_kernel(const float* __restrict__ part, int leaves,
                            float* __restrict__ sums) {
  __shared__ float red[kFinalThreads / 32];
  for (int i = 0; i < leaves; ++i) {
    const float s = block_sum(part[(long long)i * kParts + threadIdx.x], red);
    if (threadIdx.x == 0) sums[i] = s;
  }
}

struct Hyper {
  float lr, lr_wd, b1, omb1, b2, omb2, c1, c2, eps;
  bool decay;
};

template <typename TP, typename TG, typename TM>
__global__ void __launch_bounds__(kThreads)
    adamw_update_kernel(TP* __restrict__ p, const TG* __restrict__ g,
                        TM* __restrict__ m, TM* __restrict__ v, long long n,
                        bool vec, const float* __restrict__ scale, Hyper h) {
  const long long nv = (n + kVec - 1) / kVec;
  const bool clip = scale != nullptr;
  const float s = clip ? *scale : 1.0f;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < nv;
       i += (long long)gridDim.x * kThreads) {
    float pf[kVec], gf[kVec], mf[kVec], vf[kVec];
    get8(p, i, n, vec, pf);
    get8(g, i, n, vec, gf);
    get8(m, i, n, vec, mf);
    get8(v, i, n, vec, vf);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float gc = clip ? round_to(__fmul_rn(gf[e], s), g) : gf[e];
      const float mn = __fadd_rn(__fmul_rn(mf[e], h.b1), __fmul_rn(gc, h.omb1));
      const float vn = __fadd_rn(__fmul_rn(vf[e], h.b2),
                                 __fmul_rn(__fmul_rn(gc, h.omb2), gc));
      const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, h.c2)), h.eps);
      const float delta = __fdiv_rn(__fdiv_rn(mn, h.c1), den);
      float x = pf[e];
      if (h.decay) x = __fsub_rn(x, __fmul_rn(h.lr_wd, x));
      pf[e] = __fsub_rn(x, __fmul_rn(h.lr, delta));
      mf[e] = mn;
      vf[e] = vn;
    }
    put8(p, i, n, vec, pf);
    put8(m, i, n, vec, mf);
    put8(v, i, n, vec, vf);
  }
}

bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15u) == 0;
}

template <typename TP, typename TG, typename TM>
using UpdateKernel = void (*)(TP*, const TG*, TM*, TM*, long long, bool,
                              const float*, Hyper);

// The update's blocks a SM, queried once per instantiation (so that a
// launch captured into a CUDA graph makes no other API call); 0 if that
// failed.
template <typename TP, typename TG, typename TM>
int update_per_sm() {
  static int n = -1;
  if (n < 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &n, adamw_update_kernel<TP, TG, TM>, kThreads, 0) !=
                   cudaSuccess)
    n = 0;
  return n;
}

int sm_count() {
  static int sms = -1;
  int dev = 0;
  if (sms < 0 && (cudaGetDevice(&dev) != cudaSuccess ||
                  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev) != cudaSuccess))
    sms = 0;
  return sms;
}

template <typename TP, typename TG, typename TM>
bool launch_update(void* p, const void* g, void* m, void* v, long long n,
                   const float* scale, const Hyper& h, cudaStream_t s) {
  const int per_sm = update_per_sm<TP, TG, TM>(), sms = sm_count();
  if (per_sm <= 0 || sms <= 0) return false;
  const long long nv = (n + kVec - 1) / kVec;
  const long long need = std::max((nv + kThreads - 1) / kThreads, 1LL);
  const int grid = (int)std::min<long long>(need, (long long)sms * per_sm);
  const bool vec = aligned16(p) && aligned16(g) && aligned16(m) &&
                   aligned16(v);
  adamw_update_kernel<TP, TG, TM><<<grid, kThreads, 0, s>>>(
      static_cast<TP*>(p), static_cast<const TG*>(g), static_cast<TM*>(m),
      static_cast<TM*>(v), n, vec, scale, h);
  return true;
}

template <typename TP, typename TG>
bool launch_update_mv(int mv_bf16, void* p, const void* g, void* m, void* v,
                      long long n, const float* scale, const Hyper& h,
                      cudaStream_t s) {
  return mv_bf16
             ? launch_update<TP, TG, __nv_bfloat16>(p, g, m, v, n, scale, h, s)
             : launch_update<TP, TG, float>(p, g, m, v, n, scale, h, s);
}

// (name, facts) of the kernels for reports, in a fixed order.
bool kernels_info(int idx, const char** name, int* out) {
  static char buf[64];
  *name = buf;
  if (idx < 8) {
    const int pb = idx & 1, gb = (idx >> 1) & 1, mb = (idx >> 2) & 1;
    snprintf(buf, sizeof buf, "adamw_update_kernel<%s,%s,%s>",
             pb ? "bf16" : "f32", gb ? "bf16" : "f32", mb ? "bf16" : "f32");
#define REPRO_ADAMW_INFO(TP, TG, TM) \
  tc::kernel_info(adamw_update_kernel<TP, TG, TM>, kThreads, 0, out)
    using B = __nv_bfloat16;
    switch (idx) {
      case 0: return REPRO_ADAMW_INFO(float, float, float);
      case 1: return REPRO_ADAMW_INFO(B, float, float);
      case 2: return REPRO_ADAMW_INFO(float, B, float);
      case 3: return REPRO_ADAMW_INFO(B, B, float);
      case 4: return REPRO_ADAMW_INFO(float, float, B);
      case 5: return REPRO_ADAMW_INFO(B, float, B);
      case 6: return REPRO_ADAMW_INFO(float, B, B);
      default: return REPRO_ADAMW_INFO(B, B, B);
    }
#undef REPRO_ADAMW_INFO
  }
  if (idx == 8) {
    snprintf(buf, sizeof buf, "adamw_norm_kernel<bf16>");
    return tc::kernel_info(adamw_norm_kernel<__nv_bfloat16>, kThreads, 0,
                           out);
  }
  if (idx == 9) {
    snprintf(buf, sizeof buf, "adamw_norm_kernel<f32>");
    return tc::kernel_info(adamw_norm_kernel<float>, kThreads, 0, out);
  }
  if (idx == 10) {
    snprintf(buf, sizeof buf, "adamw_norm_final_kernel");
    return tc::kernel_info(adamw_norm_final_kernel, kFinalThreads, 0, out);
  }
  return false;
}

}  // namespace

// g: n contiguous elements (bf16 if g_bf16, else f32); part: the leaf's
// row of kParts f32 slots; grid: 1..kParts blocks.  One launch on
// `stream`.  Returns false, having launched nothing, on bad arguments; a
// launch's own error is left to cudaGetLastError.
extern "C" bool repro_adamw_norm(const void* g, long long n, int g_bf16,
                                 float* part, int grid, cudaStream_t s) {
  if (grid < 1 || grid > kParts || n < 0) return false;
  const bool vec = aligned16(g);
  if (g_bf16)
    adamw_norm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), n, vec, part);
  else
    adamw_norm_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(g), n, vec, part);
  return true;
}

// part: (leaves, kParts) f32; sums: (leaves,) f32.  One launch on
// `stream`.
extern "C" bool repro_adamw_norm_final(const float* part, int leaves,
                                       float* sums, cudaStream_t s) {
  if (leaves < 0) return false;
  adamw_norm_final_kernel<<<1, kFinalThreads, 0, s>>>(part, leaves, sums);
  return true;
}

// p, g, m, v: n contiguous elements each; p and g bf16 or f32 (p_bf16,
// g_bf16), m and v both bf16 or both f32 (mv_bf16).  scale: the 0-d f32
// clip scale, or null for no clip.  One launch on `stream`.  Returns
// false, having launched nothing, on a CUDA error before the launch.
extern "C" bool repro_adamw_update(void* p, const void* g, void* m, void* v,
                                   long long n, int p_bf16, int g_bf16,
                                   int mv_bf16, const float* scale, float lr,
                                   float lr_wd, int decay, float b1,
                                   float omb1, float b2, float omb2, float c1,
                                   float c2, float eps, cudaStream_t s) {
  const Hyper h{lr, lr_wd, b1, omb1, b2, omb2, c1, c2, eps, decay != 0};
  using B = __nv_bfloat16;
  if (p_bf16 && g_bf16)
    return launch_update_mv<B, B>(mv_bf16, p, g, m, v, n, scale, h, s);
  if (p_bf16)
    return launch_update_mv<B, float>(mv_bf16, p, g, m, v, n, scale, h, s);
  if (g_bf16)
    return launch_update_mv<float, B>(mv_bf16, p, g, m, v, n, scale, h, s);
  return launch_update_mv<float, float>(mv_bf16, p, g, m, v, n, scale, h, s);
}

// Facts about the kernels, for reports: idx 0, 1, ... in the order of
// kernels_info.  Writes the kernel's name and out[0..5] (tc::kernel_info).
// Returns false past the last kernel or on a CUDA error.
extern "C" bool repro_adamw_info(int idx, const char** name, int* out) {
  return kernels_info(idx, name, out);
}
