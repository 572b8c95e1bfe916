// Row RMSNorm forward for Hopper (sm_90a).  Plain CUDA with a C entry
// point: bindings.cpp launches it and checks the launch.
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py::rmsnorm_pallas (body
// _rmsnorm_kernel): y = x * rsqrt(mean(x^2) + eps) * w, math in f32,
// output in the input dtype.
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
template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TX* __restrict__ y, int D, float eps, int vec) {
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

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* y, int rows, int D,
            float eps, int vec, cudaStream_t stream) {
  rmsnorm_kernel<TX, TW><<<rows, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(y), D, eps, vec);
}

}  // namespace

// x, y: (rows, D) contiguous; w: (D,).  *_bf16 selects bf16 (1) or f32
// (0) for each operand.  Launches on `stream` and leaves the launch's
// error to cudaGetLastError.
extern "C" void repro_rmsnorm_fwd(const void* x, const void* w, void* y,
                                  int rows, int D, float eps, int x_bf16,
                                  int w_bf16, int vec, cudaStream_t s) {
  if (x_bf16 && w_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, D, eps, vec, s);
  else if (x_bf16)
    launch<__nv_bfloat16, float>(x, w, y, rows, D, eps, vec, s);
  else if (w_bf16)
    launch<float, __nv_bfloat16>(x, w, y, rows, D, eps, vec, s);
  else
    launch<float, float>(x, w, y, rows, D, eps, vec, s);
}
