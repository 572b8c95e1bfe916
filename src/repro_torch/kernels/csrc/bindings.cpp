// PyTorch bindings of the hand-written CUDA kernels in this directory.
//
// The only source that includes PyTorch's headers: rmsnorm.cu and
// flash_attention.cu are plain CUDA with C entry points taking pointers,
// strides and a stream.  Each function here launches on the current
// stream of its tensors' device and checks the launch.  The Python
// wrappers (kernels/rmsnorm.py, kernels/flash_attention.py) check devices,
// dtypes, shapes and contiguity and allocate the outputs.
#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

#include <cstdint>

extern "C" void repro_rmsnorm_fwd(const void* x, const void* w, void* y,
                                  int rows, int D, float eps, int x_bf16,
                                  int w_bf16, int vec, cudaStream_t s);

extern "C" bool repro_flash_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, int q_offset,
    int kv_len, int window, int bf16, cudaStream_t s);

namespace {

int is_bf16(const at::Tensor& t) { return t.scalar_type() == at::kBFloat16; }

bool aligned16(const at::Tensor& t) {
  return reinterpret_cast<std::uintptr_t>(t.data_ptr()) % 16 == 0;
}

// x, y: (..., D) contiguous, one dtype; w: (D,).  Writes y.
void rmsnorm_fwd(const at::Tensor& x, const at::Tensor& w, at::Tensor y,
                 double eps) {
  const c10::cuda::CUDAGuard guard(x.device());
  const int64_t D = x.size(-1);
  const int vec = D % (16 / x.element_size()) == 0 && aligned16(x) &&
                  aligned16(y);
  repro_rmsnorm_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                    static_cast<int>(x.numel() / D), static_cast<int>(D),
                    static_cast<float>(eps), is_bf16(x), is_bf16(w), vec,
                    at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// q, o: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D); one dtype, D axis
// contiguous, any other strides.  Writes o.
void flash_fwd(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
               at::Tensor o, double scale, bool causal, int64_t q_offset,
               int64_t kv_len, int64_t window) {
  const c10::cuda::CUDAGuard guard(q.device());
  const bool launched = repro_flash_fwd(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), q.size(0),
      q.size(1), k.size(1), q.size(2), k.size(2), q.size(3), q.stride(0),
      q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
      v.stride(0), v.stride(1), v.stride(2), o.stride(0), o.stride(1),
      o.stride(2), static_cast<float>(scale), causal, q_offset, kv_len,
      window, is_bf16(q), at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(launched, "flash_fwd: no kernel for head_dim ", q.size(3));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("rmsnorm_fwd", &rmsnorm_fwd, "row RMSNorm forward into y");
  m.def("flash_fwd", &flash_fwd, "flash-attention forward into o");
}
