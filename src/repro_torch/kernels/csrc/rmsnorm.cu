// Row RMSNorm forward and backward for Hopper (sm_90a).  Plain CUDA with
// C entry points: bindings.cpp launches them and checks the launches.
//
// Forward replaces the TPU kernel repro/kernels/rmsnorm.py::rmsnorm_pallas
// (body _rmsnorm_kernel): y = x * rsqrt(mean(x^2) + eps) * w, math in
// f32, output in the input dtype; on request it also writes the per-row
// f32 inv = rsqrt(mean(x^2) + eps) that the backward reads.  Bound on the
// card: bytes.  Each row is read and written once (plus the D-wide weight
// vector), so the least time is rows * D * (in + out bytes) over HBM
// bandwidth (at (2048, 4096) bf16: 33.6 MB, 10.0 us).  Design, the
// backward's: a fixed grid (fwd_plan: the SM count times the blocks a SM
// holds, from the occupancy query) walks groups of rows with a stride of
// the grid, so no tail wave is half empty.  A team of T threads (32, 64,
// 128 or 256) takes a row, each thread NV in 1..4 fixed 16-byte vectors
// of it, chosen so that D splits evenly where it can (bf16 D = 768: 96
// vectors, 3 a lane of one warp, 8 rows a block; 1536: 64 threads x 3;
// 2048: 64 x 4; 4096: 128 x 4; 8192: 256 x 4), whatever the number of
// rows, so a row comes out with the same bits in a call of any batch
// (decode and prefill agree).  w is loaded once a block
// into f32 registers; the thread's share of its rows stays in registers
// while the next group's rows load, so each row is read from device
// memory once.  The sum of squares is reduced with warp shuffles, plus one
// shared step where a row spans warps.  Any other D, or a misaligned x, w
// or y, takes a scalar kernel on the same grid (one row a block, read
// twice, the second time mostly from L1/L2).  No atomics.
//
// Backward is the twin of repro/kernels/ref.py::_rmsnorm_vjp_bwd (the JAX
// package has no Pallas backward): with xhat = x * inv,
//   dx = inv * (g*w - xhat * mean(g*w*xhat))   per row,
//   dw = sum over rows of g * xhat.
// Bound on the card: bytes, x and g read once and dx written once (at
// (2048, 4096) bf16: 50 MB, 15.0 us at HBM rate).  Design: a fixed grid
// of a few blocks a SM (bwd_plan, from the occupancy query and the SM
// count) walks the rows with a stride of the grid, so no tail wave is
// half empty.  Where D splits into at most 4 16-byte vectors a thread
// (bf16 D <= 8192, f32 D <= 4096, every model width) and the operands are
// 16-byte aligned, a thread keeps its columns of a group of rows in
// registers and loads the next group while it works on this one; one
// block reduction per group, then dx from registers: each row is read
// once.  The thread's columns are fixed, so its share of dw sums in f32
// registers; each block writes one f32 partial row (grid x D, a few MB,
// which stay in L2), and a second kernel sums them in a fixed order, a
// block per 32 columns with its warps splitting the partial rows.  Every
// other D or alignment takes a scalar path over the same grid, which
// reads a row twice and sums dw in the block's partial row.  No float
// atomics: the same bits on every run.
//
// Split rows (a row whose columns lie on several ranks: the Mamba2
// block's gated norm with its din columns split over the model axis).
// Both kernels take a mode on the same grid and team plan: stat_out
// writes each row's f32 partial statistic over the columns this call
// holds (forward: sum(x^2); backward: sum(g*w*xhat)) and nothing else;
// stat_in reads the statistic summed over the ranks in its place, and
// divides it by Dn, the whole row's width, where a whole row divides its
// own sum by D.  The caller all-reduces the statistic between the two
// launches.  A row's partial sum is reduced in the order a whole row's
// is, so with one rank (Dn = D) the two launches give the whole-row
// results bit for bit.  Extra bytes: the (rows,) f32 statistic written
// and read once, and the row read once more by the second launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstdio>
#include <type_traits>

#include "tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFwdBlocksPerSm = 4;  // forward: most blocks a SM
constexpr int kBwdBlocksPerSm = 2;  // backward: most blocks a SM

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Backward, vector path.  One thread's share of a row: slot j covers
// columns (j * kThreads + threadIdx.x) * V .. + V - 1, V = 8 bf16 or 4 f32
// values loaded as one 16-byte vector.
template <typename TX>
struct Slot {
  static constexpr int V = 16 / sizeof(TX);
  uint4 raw;
  __device__ __forceinline__ void load(const TX* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ float get(int i) const {
    return to_f32(reinterpret_cast<const TX*>(&raw)[i]);
  }
  static __device__ __forceinline__ void store(TX* p, const float (&f)[V]) {
    uint4 out;
    TX* e = reinterpret_cast<TX*>(&out);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f32<TX>(f[i]);
    *reinterpret_cast<uint4*>(p) = out;
  }
};

// V values of w from column c on, as f32: bf16 if w_bf16, else f32; one
// vector load (through L1, where w stays) when V > 1, which needs w
// 16-byte aligned.
template <int V>
__device__ __forceinline__ void load_w(const void* w, int w_bf16, int c,
                                       float (&f)[V]) {
  if (w_bf16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(w) + c;
    if constexpr (V == 8) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = to_f32(e[i]);
    } else if constexpr (V == 4) {
      const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = to_f32(e[i]);
    } else {
      f[0] = to_f32(p[0]);
    }
  } else {
    const float* p = static_cast<const float*>(w) + c;
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int i = 0; i < V; i += 4) {
        const float4 r = __ldg(reinterpret_cast<const float4*>(p + i));
        f[i] = r.x;
        f[i + 1] = r.y;
        f[i + 2] = r.z;
        f[i + 3] = r.w;
      }
    } else {
      f[0] = p[0];
    }
  }
}

// Sums of v[0..R-1] over the block's threads, returned to every thread
// (each thread adds the warps' sums in the same order).  `red` holds R x
// kThreads / 32 floats; the call ends with a barrier, so `red` may be
// reused right after.
template <int R>
__device__ __forceinline__ void block_sums(float (&v)[R],
                                           float (*red)[kThreads / 32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float t = warp_sum(v[r]);
    if (lane == 0) red[r][warp] = t;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) t += red[r][w];
    v[r] = t;
  }
  __syncthreads();
}

// Forward, vector path: D a multiple of V, x, w and y 16-byte aligned, a
// team of T threads a row (T a multiple of 32 dividing kThreads) and NV
// 16-byte slots a thread (slot j of team lane l: vector j * T + l of the
// row, absent past D).  A team takes rt <= RT = max(1, 4 / NV) rows of
// each group, so a thread holds at most 4 vectors of a group; the block's
// group is kThreads / T * rt rows, and block b takes groups b, b +
// gridDim.x, ...  The next group's vectors load while this group's are
// reduced and written.  w (bf16 if w_bf16, else f32) sits in f32
// registers for the whole kernel.  Bounded to two blocks a SM (128
// registers): without that bound ptxas picks 64 and spills.
template <typename TX, int NV>
__global__ void __launch_bounds__(kThreads, 2)
rmsnorm_fwd_kernel(const TX* __restrict__ x, const void* __restrict__ w,
                   int w_bf16, TX* __restrict__ y, float* __restrict__ inv_out,
                   const float* __restrict__ stat_in,
                   float* __restrict__ stat_out, int rows, int D, int Dn,
                   float eps, int T, int rt) {
  using S = Slot<TX>;
  constexpr int V = S::V;
  constexpr int RT = NV >= 4 ? 1 : 4 / NV;
  __shared__ float red[2][RT][kThreads / 32];
  const int team = threadIdx.x / T, l = threadIdx.x % T;
  const int group = kThreads / T * rt;
  const int nvec = D / V;
  float wf[NV][V];
  bool has[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    has[j] = j * T + l < nvec;
    if (has[j]) load_w<V>(w, w_bf16, (j * T + l) * V, wf[j]);
  }
  S xs[RT][NV];
  auto load_group = [&](int r0, S (&xr)[RT][NV]) {
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      const int row = r0 + team * rt + k;
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (has[j] && k < rt && row < rows)
          xr[k][j].load(x + (size_t)row * D + (j * T + l) * V);
    }
  };
  if (blockIdx.x * group < rows) load_group(blockIdx.x * group, xs);
  int it = 0;
  for (int r0 = blockIdx.x * group; r0 < rows;
       r0 += gridDim.x * group, ++it) {
    const int rn = r0 + gridDim.x * group;
    S xn[RT][NV];
    if (rn < rows) load_group(rn, xn);  // in flight
    float ss[RT];
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      ss[k] = 0.f;
      if (k >= rt || stat_in != nullptr) continue;
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (has[j])
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float f = xs[k][j].get(i);
            ss[k] = fmaf(f, f, ss[k]);
          }
      ss[k] = warp_sum(ss[k]);
    }
    // a row spans T / 32 warps: one shared step, in order
    if (T > 32 && stat_in == nullptr) {
      const int warp = threadIdx.x >> 5, wpt = T / 32;
      float (*rd)[kThreads / 32] = red[it & 1];
      if ((threadIdx.x & 31) == 0)
#pragma unroll
        for (int k = 0; k < RT; ++k) rd[k][warp] = ss[k];
      __syncthreads();
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        float v = 0.f;
        for (int q = 0; q < wpt; ++q) v += rd[k][team * wpt + q];
        ss[k] = v;
      }
    }
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      const int row = r0 + team * rt + k;
      if (k >= rt || row >= rows) continue;
      if (stat_out != nullptr) {
        if (l == 0) stat_out[row] = ss[k];
        continue;
      }
      const float sum = stat_in != nullptr ? stat_in[row] : ss[k];
      const float inv = rsqrtf(sum / (float)Dn + eps);
      if (inv_out != nullptr && l == 0) inv_out[row] = inv;
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (has[j]) {
          float o[V];
#pragma unroll
          for (int i = 0; i < V; ++i) o[i] = xs[k][j].get(i) * inv * wf[j][i];
          S::store(y + (size_t)row * D + (j * T + l) * V, o);
        }
    }
#pragma unroll
    for (int k = 0; k < RT; ++k)
#pragma unroll
      for (int j = 0; j < NV; ++j) xs[k][j] = xn[k][j];
  }
}

// Forward, scalar path: any D and any alignment.  The same fixed grid
// walks single rows; a row is read twice, for its sum and for y (the
// second read mostly hits L1/L2).
template <typename TX>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_any_kernel(const TX* __restrict__ x, const void* __restrict__ w,
                       int w_bf16, TX* __restrict__ y,
                       float* __restrict__ inv_out,
                       const float* __restrict__ stat_in,
                       float* __restrict__ stat_out, int rows, int D, int Dn,
                       float eps, int /*T*/, int /*rt*/) {
  __shared__ float red[1][kThreads / 32];
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const TX* xr = x + (size_t)r * D;
    float s[1] = {0.f};
    if (stat_in == nullptr) {
      for (int c = threadIdx.x; c < D; c += kThreads) {
        const float f = to_f32(xr[c]);
        s[0] = fmaf(f, f, s[0]);
      }
      block_sums<1>(s, red);
    } else {
      s[0] = stat_in[r];
    }
    if (stat_out != nullptr) {
      if (threadIdx.x == 0) stat_out[r] = s[0];
      continue;
    }
    const float inv = rsqrtf(s[0] / (float)Dn + eps);
    if (inv_out != nullptr && threadIdx.x == 0) inv_out[r] = inv;
    TX* yr = y + (size_t)r * D;
    for (int c = threadIdx.x; c < D; c += kThreads) {
      float wv[1];
      load_w<1>(w, w_bf16, c, wv);
      yr[c] = from_f32<TX>(to_f32(xr[c]) * inv * wv[0]);
    }
  }
}

// Backward, first pass, vector path: D a multiple of V, x, g, dx and w
// 16-byte aligned, and NV in {1, 2, 4} slots a thread (bf16 D <= 8192,
// f32 D <= 4096).  A fixed grid of blocks (bwd_plan) walks groups of R =
// 4 / NV rows, block b taking groups b, b + gridDim.x, ...  Each thread
// holds its NV slots of the group's R rows in registers (16 of x and g)
// while the next group's rows load, so x and g are read once; one block
// reduction gives the R sums of g*w*xhat, then dx is written from
// registers.  The thread's columns are fixed, so its dw share sums in f32
// registers; at the end the block writes it as the f32 partial row
// part[blockIdx.x].  w (bf16 if w_bf16, else f32) is read through L1.
template <typename TX, int NV>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const TX* __restrict__ x, const void* __restrict__ w,
                   int w_bf16, const float* __restrict__ inv,
                   const TX* __restrict__ g, TX* __restrict__ dx,
                   float* __restrict__ part, const float* __restrict__ stat_in,
                   float* __restrict__ stat_out, int rows, int D, int Dn) {
  using S = Slot<TX>;
  constexpr int V = S::V;
  constexpr int R = 4 / NV;
  __shared__ float red[R][kThreads / 32];
  float dwa[NV][V];
  bool has[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    has[j] = (j * kThreads + threadIdx.x) * V < D;
#pragma unroll
    for (int i = 0; i < V; ++i) dwa[j][i] = 0.f;
  }
  S xs[R][NV], gs[R][NV];
  float iv[R];
  auto load_group = [&](int r0, S (&xr)[R][NV], S (&gr)[R][NV],
                        float (&ir)[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ir[r] = r0 + r < rows ? inv[r0 + r] : 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (has[j] && r0 + r < rows) {
          const size_t o =
              (size_t)(r0 + r) * D + (j * kThreads + threadIdx.x) * V;
          xr[r][j].load(x + o);
          gr[r][j].load(g + o);
        }
    }
  };
  if (blockIdx.x * R < rows) load_group(blockIdx.x * R, xs, gs, iv);
  for (int r0 = blockIdx.x * R; r0 < rows; r0 += gridDim.x * R) {
    const int rn = r0 + gridDim.x * R;
    S xn[R][NV], gn[R][NV];
    float ivn[R];
    if (rn < rows) load_group(rn, xn, gn, ivn);  // in flight
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r)  // shares of sum(g*w*xhat), or the sums
      s[r] = stat_in == nullptr || r0 + r >= rows ? 0.f : stat_in[r0 + r];
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (has[j] && stat_in == nullptr) {
        float wv[V];
        load_w<V>(w, w_bf16, (j * kThreads + threadIdx.x) * V, wv);
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r0 + r < rows)
#pragma unroll
            for (int i = 0; i < V; ++i)
              s[r] = fmaf(gs[r][j].get(i) * wv[i], xs[r][j].get(i) * iv[r],
                          s[r]);
      }
    if (stat_in == nullptr) block_sums<R>(s, red);
    if (stat_out != nullptr && threadIdx.x == 0)
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r0 + r < rows) stat_out[r0 + r] = s[r];
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (has[j] && stat_out == nullptr) {
        const int c = (j * kThreads + threadIdx.x) * V;
        float wv[V];
        load_w<V>(w, w_bf16, c, wv);
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r0 + r < rows) {
            const float mean = s[r] / (float)Dn;
            float out[V];
#pragma unroll
            for (int i = 0; i < V; ++i) {
              const float xh = xs[r][j].get(i) * iv[r];
              const float gv = gs[r][j].get(i);
              out[i] = iv[r] * (gv * wv[i] - xh * mean);
              dwa[j][i] = fmaf(gv, xh, dwa[j][i]);
            }
            S::store(dx + (size_t)(r0 + r) * D + c, out);
          }
      }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      iv[r] = ivn[r];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        xs[r][j] = xn[r][j];
        gs[r][j] = gn[r][j];
      }
    }
  }
  if (stat_out != nullptr) return;
  float* pr = part + (size_t)blockIdx.x * D;
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (has[j])
#pragma unroll
      for (int i = 0; i < V; ++i)
        pr[(j * kThreads + threadIdx.x) * V + i] = dwa[j][i];
}

// Backward, first pass, scalar path: any D and any alignment (a D that
// is no multiple of V or too wide for the vector path's registers, or a
// misaligned x, g, dx or w).  The same fixed grid walks single rows; a
// row is read twice, for its sum and for dx (the second read mostly hits
// L1/L2).  Thread t owns columns t, t + kThreads, ... of every row, so it
// sums its dw share straight into the block's f32 partial row
// part[blockIdx.x], which no other thread touches: no atomics.
template <typename TX>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_any_kernel(const TX* __restrict__ x, const void* __restrict__ w,
                       int w_bf16, const float* __restrict__ inv,
                       const TX* __restrict__ g, TX* __restrict__ dx,
                       float* __restrict__ part,
                       const float* __restrict__ stat_in,
                       float* __restrict__ stat_out, int rows, int D, int Dn) {
  __shared__ float red[1][kThreads / 32];
  float* pr = stat_out == nullptr ? part + (size_t)blockIdx.x * D : nullptr;
  if (pr != nullptr)
    for (int c = threadIdx.x; c < D; c += kThreads) pr[c] = 0.f;
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const TX* xr = x + (size_t)r * D;
    const TX* gr = g + (size_t)r * D;
    const float iv = inv[r];
    float s[1] = {0.f};  // this thread's share of sum(g*w*xhat)
    if (stat_in == nullptr) {
      for (int c = threadIdx.x; c < D; c += kThreads) {
        float wv[1];
        load_w<1>(w, w_bf16, c, wv);
        s[0] = fmaf(to_f32(gr[c]) * wv[0], to_f32(xr[c]) * iv, s[0]);
      }
      block_sums<1>(s, red);
    } else {
      s[0] = stat_in[r];
    }
    if (pr == nullptr) {
      if (threadIdx.x == 0) stat_out[r] = s[0];
      continue;
    }
    const float mean = s[0] / (float)Dn;
    TX* dxr = dx + (size_t)r * D;
    for (int c = threadIdx.x; c < D; c += kThreads) {
      float wv[1];
      load_w<1>(w, w_bf16, c, wv);
      const float xh = to_f32(xr[c]) * iv;
      const float gv = to_f32(gr[c]);
      dxr[c] = from_f32<TX>(iv * (gv * wv[0] - xh * mean));
      pr[c] = fmaf(gv, xh, pr[c]);
    }
  }
}

// Backward, second pass: dw[c] = the sum over the n_part partial rows, in
// w's dtype.  A block takes 32 columns (one a lane); its 8 warps take
// the partial rows in turn, four running sums a lane, and warp 0 adds the
// warps' sums in order: the same bits on every run.
template <typename TW>
__global__ void __launch_bounds__(kThreads)
rmsnorm_dw_kernel(const float* __restrict__ part, TW* __restrict__ dw,
                  int n_part, int D) {
  constexpr int W = kThreads / 32;
  __shared__ float red[W][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  if (c < D) {
    int b = warp;
    for (; b + 3 * W < n_part; b += 4 * W)
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] += part[(size_t)(b + u * W) * D + c];
    for (; b < n_part; b += W) a[0] += part[(size_t)b * D + c];
  }
  red[warp][lane] = (a[0] + a[1]) + (a[2] + a[3]);
  __syncthreads();
  if (warp == 0 && c < D) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) s += red[i][lane];
    dw[c] = from_f32<TW>(s);
  }
}

template <typename TX>
using BwdKernel = void (*)(const TX*, const void*, int, const float*,
                           const TX*, TX*, float*, const float*, float*, int,
                           int, int);

// The first pass with NV 16-byte slots a thread (NV = 0: the scalar
// path), and in *per_sm the blocks of it that one SM holds at kThreads
// threads.  The occupancy query is made once per kernel, so that a launch
// captured into a CUDA graph makes no other API call; 0 if it failed.
template <typename TX, int NV>
BwdKernel<TX> bwd_kernel(int* per_sm) {
  BwdKernel<TX> k;
  if constexpr (NV == 0)
    k = rmsnorm_bwd_any_kernel<TX>;
  else
    k = rmsnorm_bwd_kernel<TX, NV>;
  static int n = -1;
  if (n < 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &n, k, kThreads, 0) != cudaSuccess)
    n = 0;
  *per_sm = n;
  return k;
}

// The first pass of one call: its kernel and its grid, which is also the
// number of partial rows of dw.
template <typename TX>
struct BwdPlan {
  BwdKernel<TX> kernel;  // null on a CUDA error
  int grid;
};

// The plan for `rows` rows of width D: the vector path where D splits
// into at most 4 slots of 16 bytes a thread and x, g, dx and w are
// 16-byte aligned, else the scalar path.  The grid is the SM count times
// the blocks a SM holds of that kernel, at most kBwdBlocksPerSm, and at
// most the groups of rows it takes at once (4 / NV).  The scratch size
// (repro_rmsnorm_bwd_parts) and the launch both come from here.
template <typename TX>
BwdPlan<TX> bwd_plan(const void* x, const void* w, const void* g,
                     const void* dx, int rows, int D) {
  constexpr int V = 16 / sizeof(TX);
  const int nv = (D / V + kThreads - 1) / kThreads;
  const bool vec = D % V == 0 && nv <= 4 && aligned16(x) && aligned16(w) &&
                   aligned16(g) && aligned16(dx);
  int per_sm = 0, at_once = 1;
  BwdKernel<TX> k;
  if (!vec) {
    k = bwd_kernel<TX, 0>(&per_sm);
  } else if (nv <= 1) {
    k = bwd_kernel<TX, 1>(&per_sm);
    at_once = 4;
  } else if (nv <= 2) {
    k = bwd_kernel<TX, 2>(&per_sm);
    at_once = 2;
  } else {
    k = bwd_kernel<TX, 4>(&per_sm);
  }
  int dev = 0, sms = 0;
  if (per_sm <= 0 || rows <= 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return {nullptr, 0};
  const int groups = (rows + at_once - 1) / at_once;
  return {k, std::min(groups, sms * std::min(per_sm, kBwdBlocksPerSm))};
}

template <typename TX>
using FwdKernel = void (*)(const TX*, const void*, int, TX*, float*,
                           const float*, float*, int, int, int, float, int,
                           int);

// The forward with NV 16-byte slots a thread (NV = 0: the scalar path),
// and in *per_sm the blocks of it that one SM holds, queried once per
// kernel as bwd_kernel does; 0 if that failed.
template <typename TX, int NV>
FwdKernel<TX> fwd_kernel(int* per_sm) {
  FwdKernel<TX> k;
  if constexpr (NV == 0)
    k = rmsnorm_fwd_any_kernel<TX>;
  else
    k = rmsnorm_fwd_kernel<TX, NV>;
  static int n = -1;
  if (n < 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &n, k, kThreads, 0) != cudaSuccess)
    n = 0;
  *per_sm = n;
  return k;
}

// The forward of one call: its kernel, threads a row (T), rows a team
// takes at once (rt), rows a block takes at once (group) and grid.
template <typename TX>
struct FwdPlan {
  FwdKernel<TX> kernel;  // null on a CUDA error
  int T, rt, group, grid;
};

// The plan for `rows` rows of width D.  The vector path where D is a
// multiple of V, x, w and y are 16-byte aligned and a row takes at most
// 4 slots a thread of 256: the fewest threads a row (T of 32, 64, 128,
// 256) that split its nvec vectors evenly into at most 4 a thread, else
// the fewest that hold them with some lanes idle in the last slot, and
// max(1, 4 / NV) rows a team; the row count changes only the grid.  Else
// the scalar path, T = kThreads.  The grid is the SM count
// times the blocks a SM holds, at most kFwdBlocksPerSm, and at most the
// groups of rows there are.
template <typename TX>
FwdPlan<TX> fwd_plan(const void* x, const void* w, const void* y, int rows,
                     int D) {
  constexpr int V = 16 / sizeof(TX);
  int dev = 0, sms = 0;
  if (rows <= 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return {nullptr, 0, 0, 0, 0};
  const int nvec = D / V;
  int T = 0;
  if (D % V == 0 && aligned16(x) && aligned16(w) && aligned16(y)) {
    for (int t = 32; t <= kThreads && T == 0; t *= 2)
      if (nvec % t == 0 && nvec / t <= 4) T = t;
    for (int t = 32; t <= kThreads && T == 0; t *= 2)
      if ((nvec + t - 1) / t <= 4) T = t;
  }
  const int nv = T ? (nvec + T - 1) / T : 0;
  int per_sm = 0;
  FwdKernel<TX> k;
  switch (nv) {
    case 1: k = fwd_kernel<TX, 1>(&per_sm); break;
    case 2: k = fwd_kernel<TX, 2>(&per_sm); break;
    case 3: k = fwd_kernel<TX, 3>(&per_sm); break;
    case 4: k = fwd_kernel<TX, 4>(&per_sm); break;
    default: k = fwd_kernel<TX, 0>(&per_sm); T = kThreads;
  }
  if (per_sm <= 0) return {nullptr, 0, 0, 0, 0};
  const int rt = nv == 0 || nv >= 4 ? 1 : 4 / nv;
  const int group = nv ? kThreads / T * rt : 1;
  const int groups = (rows + group - 1) / group;
  return {k, T, rt, group,
          std::min(groups, sms * std::min(per_sm, kFwdBlocksPerSm))};
}

template <typename TX>
bool launch_fwd(const void* x, const void* w, int w_bf16, void* y,
                float* inv, const float* stat_in, float* stat_out, int rows,
                int D, int Dn, float eps, cudaStream_t stream) {
  const FwdPlan<TX> plan = fwd_plan<TX>(x, w, y != nullptr ? y : x, rows, D);
  if (plan.kernel == nullptr) return false;
  plan.kernel<<<plan.grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), w, w_bf16, static_cast<TX*>(y), inv,
      stat_in, stat_out, rows, D, Dn, eps, plan.T, plan.rt);
  return true;
}

template <typename TX, typename TW>
bool launch_bwd(const void* x, const void* w, const float* inv,
                const void* g, void* dx, void* dw, float* part,
                const float* stat_in, float* stat_out, int rows, int D,
                int Dn, cudaStream_t stream) {
  const BwdPlan<TX> plan =
      bwd_plan<TX>(x, w, g, dx != nullptr ? dx : g, rows, D);
  if (plan.kernel == nullptr) return false;
  plan.kernel<<<plan.grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), w, std::is_same<TW, __nv_bfloat16>::value,
      inv, static_cast<const TX*>(g), static_cast<TX*>(dx), part, stat_in,
      stat_out, rows, D, Dn);
  if (stat_out == nullptr)
    rmsnorm_dw_kernel<TW><<<(D + 31) / 32, kThreads, 0, stream>>>(
        part, static_cast<TW*>(dw), plan.grid, D);
  return true;
}

// The first pass's kernels for x's dtype TX, for reports: i = 0, 1, 2 the
// vector path at NV 1, 2, 4, i = 3 the scalar path.
template <typename TX>
bool first_pass_info(int i, const char* dtype, char (&name)[48], int* out) {
  int per_sm = 0;
  BwdKernel<TX> k;
  if (i == 3) {
    k = bwd_kernel<TX, 0>(&per_sm);
    snprintf(name, sizeof name, "rmsnorm_bwd_any_kernel<%s>", dtype);
  } else {
    k = i == 0 ? bwd_kernel<TX, 1>(&per_sm)
               : i == 1 ? bwd_kernel<TX, 2>(&per_sm)
                        : bwd_kernel<TX, 4>(&per_sm);
    snprintf(name, sizeof name, "rmsnorm_bwd_kernel<%s,%d>", dtype, 1 << i);
  }
  return tc::kernel_info(k, kThreads, 0, out);
}

// The forward's kernels for x's dtype TX, for reports: i = 0..3 the vector
// path at NV 1..4, i = 4 the scalar path.
template <typename TX>
bool fwd_info(int i, const char* dtype, char (&name)[48], int* out) {
  int per_sm = 0;
  FwdKernel<TX> k;
  if (i == 4) {
    k = fwd_kernel<TX, 0>(&per_sm);
    snprintf(name, sizeof name, "rmsnorm_fwd_any_kernel<%s>", dtype);
  } else {
    k = i == 0   ? fwd_kernel<TX, 1>(&per_sm)
        : i == 1 ? fwd_kernel<TX, 2>(&per_sm)
        : i == 2 ? fwd_kernel<TX, 3>(&per_sm)
                 : fwd_kernel<TX, 4>(&per_sm);
    snprintf(name, sizeof name, "rmsnorm_fwd_kernel<%s,%d>", dtype, i + 1);
  }
  return tc::kernel_info(k, kThreads, 0, out);
}

// The kernels for reports, in a fixed order: the backward's first pass
// (first_pass_info) for bf16 then f32 x, its second pass for bf16 and f32
// w, then the forward's five (fwd_info) for bf16 then f32 x.  *name
// points into a buffer that the next call reuses.
bool kernels_info(int idx, const char** name, int* out) {
  static char buf[48];
  *name = buf;
  if (idx < 4) return first_pass_info<__nv_bfloat16>(idx, "bf16", buf, out);
  if (idx < 8) return first_pass_info<float>(idx - 4, "f32", buf, out);
  if (idx == 8) {
    snprintf(buf, sizeof buf, "rmsnorm_dw_kernel<bf16>");
    return tc::kernel_info(rmsnorm_dw_kernel<__nv_bfloat16>, kThreads, 0,
                           out);
  }
  if (idx == 9) {
    snprintf(buf, sizeof buf, "rmsnorm_dw_kernel<f32>");
    return tc::kernel_info(rmsnorm_dw_kernel<float>, kThreads, 0, out);
  }
  if (idx < 15) return fwd_info<__nv_bfloat16>(idx - 10, "bf16", buf, out);
  if (idx < 20) return fwd_info<float>(idx - 15, "f32", buf, out);
  return false;
}

}  // namespace

// x, y: (rows, D) contiguous; w: (D,).  *_bf16 selects bf16 (1) or f32
// (0) for each operand.  inv: (rows,) f32, or null to skip it.  Split
// rows: stat_out (rows,) f32 receives each row's partial sum of squares
// (y and inv unused, may be null); stat_in (rows,) f32 is the summed
// statistic of rows Dn wide (a whole row: both null, Dn = D).  One launch
// on `stream`.  Returns false, having launched nothing, on a CUDA error
// before the launch; a launch's own error is left to cudaGetLastError.
extern "C" bool repro_rmsnorm_fwd(const void* x, const void* w, void* y,
                                  float* inv, const float* stat_in,
                                  float* stat_out, int rows, int D, int Dn,
                                  float eps, int x_bf16, int w_bf16,
                                  cudaStream_t s) {
  if (x_bf16)
    return launch_fwd<__nv_bfloat16>(x, w, w_bf16, y, inv, stat_in, stat_out,
                                     rows, D, Dn, eps, s);
  return launch_fwd<float>(x, w, w_bf16, y, inv, stat_in, stat_out, rows, D,
                           Dn, eps, s);
}

// The forward's plan for these operands (the pointers and D pick the
// path, as in repro_rmsnorm_fwd), for tests: out[0] threads a row (T),
// out[1] rows a block takes at once, out[2] the grid.  False on a CUDA
// error.
extern "C" bool repro_rmsnorm_fwd_plan(const void* x, const void* w,
                                       const void* y, int rows, int D,
                                       int x_bf16, int* out) {
  auto put = [&](auto p) {
    out[0] = p.T;
    out[1] = p.group;
    out[2] = p.grid;
    return p.kernel != nullptr;
  };
  return x_bf16 ? put(fwd_plan<__nv_bfloat16>(x, w, y, rows, D))
                : put(fwd_plan<float>(x, w, y, rows, D));
}

// Number of f32 partial rows of dw (each D wide) that the backward's
// scratch `part` must hold for these operands (the pointers and D pick
// the path, as in repro_rmsnorm_bwd): the first pass's grid, from the
// occupancy query and the SM count.  0 on a CUDA error.
extern "C" int repro_rmsnorm_bwd_parts(const void* x, const void* w,
                                       const void* g, const void* dx,
                                       int rows, int D, int x_bf16) {
  return x_bf16 ? bwd_plan<__nv_bfloat16>(x, w, g, dx, rows, D).grid
                : bwd_plan<float>(x, w, g, dx, rows, D).grid;
}

// x, g, dx: (rows, D) contiguous in x's dtype; w, dw: (D,) in w's dtype;
// inv: (rows,) f32 from the forward; part: repro_rmsnorm_bwd_parts(x, w,
// g, dx, rows, D, x_bf16) x D f32 scratch.  Two launches on `stream`.
// Split rows: stat_out (rows,) f32 receives each row's partial
// sum(g*w*xhat), in one launch (dx, dw and part unused, may be null);
// stat_in (rows,) f32 is that sum over the ranks, of rows Dn wide (a
// whole row: both null, Dn = D).  Returns false, having launched nothing,
// on a CUDA error before the launch; a launch's own error is left to
// cudaGetLastError.
extern "C" bool repro_rmsnorm_bwd(const void* x, const void* w,
                                  const float* inv, const void* g, void* dx,
                                  void* dw, float* part, const float* stat_in,
                                  float* stat_out, int rows, int D, int Dn,
                                  int x_bf16, int w_bf16, cudaStream_t s) {
  if (x_bf16 && w_bf16)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(
        x, w, inv, g, dx, dw, part, stat_in, stat_out, rows, D, Dn, s);
  if (x_bf16)
    return launch_bwd<__nv_bfloat16, float>(x, w, inv, g, dx, dw, part,
                                            stat_in, stat_out, rows, D, Dn, s);
  if (w_bf16)
    return launch_bwd<float, __nv_bfloat16>(x, w, inv, g, dx, dw, part,
                                            stat_in, stat_out, rows, D, Dn, s);
  return launch_bwd<float, float>(x, w, inv, g, dx, dw, part, stat_in,
                                  stat_out, rows, D, Dn, s);
}

// Facts about the forward's and backward's kernels, for reports: idx 0,
// 1, ... in the order of kernels_info.  Writes the kernel's name and out[0..5]
// (tc::kernel_info).  Returns false past the last kernel or on a CUDA
// error.
extern "C" bool repro_rmsnorm_info(int idx, const char** name, int* out) {
  return kernels_info(idx, name, out);
}
