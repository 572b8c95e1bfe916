// Row RMSNorm forward and backward for Hopper (sm_90a).  Plain CUDA with
// C entry points: bindings.cpp launches them and checks the launches.
//
// Forward replaces the TPU kernel repro/kernels/rmsnorm.py::rmsnorm_pallas
// (body _rmsnorm_kernel): y = x * rsqrt(mean(x^2) + eps) * w, math in
// f32, output in the input dtype; on request it also writes the per-row
// f32 inv = rsqrt(mean(x^2) + eps) that the backward reads.
//
// Backward is the twin of repro/kernels/ref.py::_rmsnorm_vjp_bwd (the JAX
// package has no Pallas backward): with xhat = x * inv,
//   dx = inv * (g*w - xhat * mean(g*w*xhat))   per row,
//   dw = sum over rows of g * xhat.
// It is bound by bytes too: x and g are read once and dx written once.
// dx is one block per 8 rows; dw, a sum across blocks, is kept as one f32
// partial row per block in shared memory, written out, and summed over
// the blocks by a second small kernel, so no float atomics are needed
// and the result is the same on every run.
//
// Bound on the card: bytes.  Each row is read and written once (plus the
// D-wide weight vector, which stays in L1/L2), so the least time is
// rows * D * (in + out bytes) over HBM bandwidth.  The design keeps to
// that: one thread block per row, 16-byte vector loads and stores where
// the row allows them, the f32 sum of squares reduced with warp shuffles
// and one shared-memory step.  The second read of the row, for the
// output, hits L1/L2 (a 4096-wide bf16 row is 8 KB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 8;  // backward: rows per block

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

// vec != 0: D is a multiple of the 16-byte vector width and x, y are
// 16-byte aligned (checked by the caller).
// Sum of v over the block's threads, returned to every thread.  `red`
// holds kThreads / 32 floats; the call ends with a barrier so `red` may be
// reused right after.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < kThreads / 32 ? red[lane] : 0.f;
  t = warp_sum(t);
  __syncthreads();
  return t;
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TX* __restrict__ y, float* __restrict__ inv_out, int D,
               float eps, int vec) {
  constexpr int V = 16 / sizeof(TX);
  const TX* xr = x + (size_t)blockIdx.x * D;
  TX* yr = y + (size_t)blockIdx.x * D;

  float ss = 0.f;
  if (vec) {
    for (int i = threadIdx.x; i < D / V; i += kThreads) {
      uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const TX* e = reinterpret_cast<const TX*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float f = to_f32(e[j]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int i = threadIdx.x; i < D; i += kThreads) {
      float f = to_f32(xr[i]);
      ss = fmaf(f, f, ss);
    }
  }

  __shared__ float red[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  const float inv = rsqrtf(red[0] / (float)D + eps);
  if (inv_out != nullptr && threadIdx.x == 0) inv_out[blockIdx.x] = inv;

  if (vec) {
    for (int i = threadIdx.x; i < D / V; i += kThreads) {
      uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const TX* e = reinterpret_cast<const TX*>(&raw);
      uint4 out;
      TX* o = reinterpret_cast<TX*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = from_f32<TX>(to_f32(e[j]) * inv * to_f32(w[i * V + j]));
      reinterpret_cast<uint4*>(yr)[i] = out;
    }
  } else {
    for (int i = threadIdx.x; i < D; i += kThreads)
      yr[i] = from_f32<TX>(to_f32(xr[i]) * inv * to_f32(w[i]));
  }
}

// Backward, first pass: one block per kRowsPerBlock rows.  Writes dx
// (x's dtype) and the block's f32 partial of dw into part[blockIdx.x].
// Dynamic shared memory: D floats for the dw partial.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   const float* __restrict__ inv, const TX* __restrict__ g,
                   TX* __restrict__ dx, float* __restrict__ part, int rows,
                   int D) {
  extern __shared__ float dw_acc[];
  __shared__ float red[kThreads / 32];
  for (int i = threadIdx.x; i < D; i += kThreads) dw_acc[i] = 0.f;
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int r1 = min(r0 + kRowsPerBlock, rows);
  for (int r = r0; r < r1; ++r) {
    const TX* xr = x + (size_t)r * D;
    const TX* gr = g + (size_t)r * D;
    const float iv = inv[r];
    float s = 0.f;  // sum over the row of g*w*xhat
    for (int i = threadIdx.x; i < D; i += kThreads)
      s = fmaf(to_f32(gr[i]) * to_f32(w[i]), to_f32(xr[i]) * iv, s);
    const float mean = block_sum(s, red) / (float)D;
    TX* dxr = dx + (size_t)r * D;
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float xh = to_f32(xr[i]) * iv;
      const float gv = to_f32(gr[i]);
      dxr[i] = from_f32<TX>(iv * (gv * to_f32(w[i]) - xh * mean));
      dw_acc[i] = fmaf(gv, xh, dw_acc[i]);  // only this thread's columns
    }
  }
  float* pr = part + (size_t)blockIdx.x * D;
  for (int i = threadIdx.x; i < D; i += kThreads) pr[i] = dw_acc[i];
}

// Backward, second pass: dw[i] = sum over the blocks' partials, in w's
// dtype.  One thread per column; neighbouring threads read neighbouring
// columns of each partial row.
template <typename TW>
__global__ void __launch_bounds__(kThreads)
rmsnorm_dw_kernel(const float* __restrict__ part, TW* __restrict__ dw,
                  int n_part, int D) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= D) return;
  float s = 0.f;
  for (int b = 0; b < n_part; ++b) s += part[(size_t)b * D + i];
  dw[i] = from_f32<TW>(s);
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* y, float* inv, int rows,
            int D, float eps, int vec, cudaStream_t stream) {
  rmsnorm_kernel<TX, TW><<<rows, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(y), inv, D, eps, vec);
}

template <typename TX, typename TW>
void launch_bwd(const void* x, const void* w, const float* inv,
                const void* g, void* dx, void* dw, float* part, int rows,
                int D, cudaStream_t stream) {
  const int n_part = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const size_t smem = sizeof(float) * (size_t)D;
  // D floats of dynamic shared memory; above 48 KB (D > 12288) the limit
  // has to be raised first.  A failure is left to cudaGetLastError.
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(rmsnorm_bwd_kernel<TX, TW>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return;
  rmsnorm_bwd_kernel<TX, TW><<<n_part, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), inv,
      static_cast<const TX*>(g), static_cast<TX*>(dx), part, rows, D);
  rmsnorm_dw_kernel<TW><<<(D + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(part, static_cast<TW*>(dw), n_part, D);
}

}  // namespace

// x, y: (rows, D) contiguous; w: (D,).  *_bf16 selects bf16 (1) or f32
// (0) for each operand.  inv: (rows,) f32, or null to skip it.  Launches
// on `stream` and leaves the launch's error to cudaGetLastError.
extern "C" void repro_rmsnorm_fwd(const void* x, const void* w, void* y,
                                  float* inv, int rows, int D, float eps,
                                  int x_bf16, int w_bf16, int vec,
                                  cudaStream_t s) {
  if (x_bf16 && w_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, inv, rows, D, eps, vec, s);
  else if (x_bf16)
    launch<__nv_bfloat16, float>(x, w, y, inv, rows, D, eps, vec, s);
  else if (w_bf16)
    launch<float, __nv_bfloat16>(x, w, y, inv, rows, D, eps, vec, s);
  else
    launch<float, float>(x, w, y, inv, rows, D, eps, vec, s);
}

// Number of f32 partial rows of dw (each D wide) that the backward's
// scratch `part` must hold.
extern "C" int repro_rmsnorm_bwd_parts(int rows) {
  return (rows + kRowsPerBlock - 1) / kRowsPerBlock;
}

// x, g, dx: (rows, D) contiguous in x's dtype; w, dw: (D,) in w's dtype;
// inv: (rows,) f32 from the forward; part: repro_rmsnorm_bwd_parts(rows)
// x D f32 scratch.  Two launches on `stream`; errors are left to
// cudaGetLastError.
extern "C" void repro_rmsnorm_bwd(const void* x, const void* w,
                                  const float* inv, const void* g, void* dx,
                                  void* dw, float* part, int rows, int D,
                                  int x_bf16, int w_bf16, cudaStream_t s) {
  if (x_bf16 && w_bf16)
    launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, w, inv, g, dx, dw, part,
                                             rows, D, s);
  else if (x_bf16)
    launch_bwd<__nv_bfloat16, float>(x, w, inv, g, dx, dw, part, rows, D,
                                     s);
  else if (w_bf16)
    launch_bwd<float, __nv_bfloat16>(x, w, inv, g, dx, dw, part, rows, D,
                                     s);
  else
    launch_bwd<float, float>(x, w, inv, g, dx, dw, part, rows, D, s);
}
