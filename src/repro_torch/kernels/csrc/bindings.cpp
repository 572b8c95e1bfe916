// PyTorch bindings of the hand-written CUDA kernels in this directory.
//
// The only source that includes PyTorch's headers: rmsnorm.cu,
// flash_attention.cu, cross_entropy.cu, ssd_scan.cu and adamw.cu are
// plain CUDA with C entry points taking pointers, strides and a stream.
// Each function here launches on the current stream of its tensors'
// device and checks the launch.  The Python wrappers (kernels/rmsnorm.py,
// kernels/flash_attention.py, kernels/cross_entropy.py,
// kernels/ssd_scan.py, kernels/adamw.py) check devices, dtypes, shapes
// and contiguity and allocate the outputs and scratch.
#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

#include <cstdint>
#include <string>
#include <utility>
#include <vector>

extern "C" bool repro_rmsnorm_fwd(const void* x, const void* w, void* y,
                                  float* inv, const float* stat_in,
                                  float* stat_out, int rows, int D, int Dn,
                                  float eps, int x_bf16, int w_bf16,
                                  cudaStream_t s);
extern "C" bool repro_rmsnorm_fwd_plan(const void* x, const void* w,
                                       const void* y, int rows, int D,
                                       int x_bf16, int* out);
extern "C" int repro_rmsnorm_bwd_parts(const void* x, const void* w,
                                       const void* g, const void* dx,
                                       int rows, int D, int x_bf16);
extern "C" bool repro_rmsnorm_bwd(const void* x, const void* w,
                                  const float* inv, const void* g, void* dx,
                                  void* dw, float* part, const float* stat_in,
                                  float* stat_out, int rows, int D, int Dn,
                                  int x_bf16, int w_bf16, cudaStream_t s);
extern "C" bool repro_rmsnorm_info(int idx, const char** name, int* out);

extern "C" bool repro_flash_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int B,
    int Sq, int Sk, int Hq, int Hkv, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, int q_offset,
    int kv_len, int window, int bf16, cudaStream_t s);
extern "C" bool repro_flash_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh, float scale,
    int causal, int q_offset, int kv_len, int window, int bf16,
    cudaStream_t s);
extern "C" bool repro_flash_fwd_info(int idx, int D, const char** name,
                                     int* out);
extern "C" bool repro_flash_bwd_info(int idx, int D, const char** name,
                                     int* out);

extern "C" int repro_ce_splits(int n_tok, int V, int bf16);
extern "C" void repro_ce_fwd(const void* hidden, const void* w,
                             const long long* targets, float* part,
                             float* nll, float* lse, float* stats, int n_tok,
                             int V, int D, int bf16, cudaStream_t s);
extern "C" void repro_ce_merge(const float* part, float* nll, float* lse,
                               int n_tok, int n_split, cudaStream_t s);
extern "C" bool repro_ce_info(int idx, const char** name, int* out);

extern "C" bool repro_ssd_fwd(
    const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, const float* h0, float* cb, void* y, float* hout,
    int Bsz, int S, int H, int P, int G, int N, int Q, long long x_sb,
    long long x_ss, long long x_sh, long long dt_sb, long long dt_ss,
    long long dt_sh, long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg, long long y_sb,
    long long y_ss, long long y_sh, int bf16, cudaStream_t s);
extern "C" int repro_ssd_bwd_slots(int Bsz, int S, int H, int G, int N,
                                   int Q);
extern "C" bool repro_ssd_bwd(
    const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, const float* h0, const void* dy, const float* dh,
    void* hs, void* gs, float* db_part, float* dc_part, float* da_part,
    float* wpart, float* rvec, float* dvec, void* dx, float* ddt, float* dA,
    void* dB, void* dC, float* dinit, int Bsz, int S, int H, int P, int G,
    int N, int Q, int HP, long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb,
    long long b_ss, long long b_sg, long long c_sb, long long c_ss,
    long long c_sg, int bf16, cudaStream_t s);
extern "C" bool repro_ssd_info(int idx, const char** name, int* out);

extern "C" bool repro_adamw_norm(const void* g, long long n, int g_bf16,
                                 float* part, int grid, cudaStream_t s);
extern "C" bool repro_adamw_norm_final(const float* part, int leaves,
                                       float* sums, cudaStream_t s);
extern "C" bool repro_adamw_update(void* p, const void* g, void* m, void* v,
                                   long long n, int p_bf16, int g_bf16,
                                   int mv_bf16, const float* scale, float lr,
                                   float lr_wd, int decay, float b1,
                                   float omb1, float b2, float omb2, float c1,
                                   float c2, float eps, cudaStream_t s);
extern "C" bool repro_adamw_info(int idx, const char** name, int* out);

namespace {

int is_bf16(const at::Tensor& t) { return t.scalar_type() == at::kBFloat16; }

template <typename T>
T* ptr_or_null(const c10::optional<at::Tensor>& t) {
  return t ? t->data_ptr<T>() : nullptr;
}

// x, y: (..., D) contiguous, one dtype; w: (D,); inv: (rows,) f32 or
// None.  Writes y (and inv); the kernel picks its path from D and the
// addresses.  Split rows (d_whole: the whole row's width): with
// write_stat, writes each row's partial sum of squares into stat, (rows,)
// f32, and nothing else (y None); else reads the summed stat in place of
// the row's own sum.
void rmsnorm_fwd(const at::Tensor& x, const at::Tensor& w,
                 const c10::optional<at::Tensor>& y, double eps,
                 const c10::optional<at::Tensor>& inv,
                 const c10::optional<at::Tensor>& stat, bool write_stat,
                 int64_t d_whole) {
  const c10::cuda::CUDAGuard guard(x.device());
  const int64_t D = x.size(-1);
  TORCH_CHECK(y || write_stat, "rmsnorm_fwd: y is needed");
  float* st = ptr_or_null<float>(stat);
  const bool launched = repro_rmsnorm_fwd(
      x.data_ptr(), w.data_ptr(), y ? y->data_ptr() : nullptr,
      ptr_or_null<float>(inv), write_stat ? nullptr : st,
      write_stat ? st : nullptr, static_cast<int>(x.numel() / D),
      static_cast<int>(D), static_cast<int>(stat ? d_whole : D),
      static_cast<float>(eps), is_bf16(x), is_bf16(w),
      at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(launched, "rmsnorm_fwd: no launch (CUDA error) for D ", D);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// The forward's plan for x, y: (rows, D) and w: (D,) on x's device (their
// addresses pick the kernel, as in rmsnorm_fwd): [threads a row, rows a
// block takes at once, grid].
std::vector<int64_t> rmsnorm_fwd_plan(const at::Tensor& x, const at::Tensor& w,
                                      const at::Tensor& y) {
  const c10::cuda::CUDAGuard guard(x.device());
  const int64_t D = x.size(-1);
  int out[3];
  const bool ok = repro_rmsnorm_fwd_plan(
      x.data_ptr(), w.data_ptr(), y.data_ptr(),
      static_cast<int>(x.numel() / D), static_cast<int>(D), is_bf16(x), out);
  C10_CUDA_CHECK(cudaGetLastError());
  TORCH_CHECK(ok, "rmsnorm_fwd_plan: CUDA error");
  return {out[0], out[1], out[2]};
}

// Rows of the backward's f32 dw scratch for x, g, dx: (..., D) and w:
// (D,) on x's device (their addresses pick the kernel, as in
// rmsnorm_bwd); 0 on a CUDA error.
int64_t rmsnorm_bwd_parts(const at::Tensor& x, const at::Tensor& w,
                          const at::Tensor& g, const at::Tensor& dx) {
  const c10::cuda::CUDAGuard guard(x.device());
  const int64_t D = x.size(-1);
  const int n = repro_rmsnorm_bwd_parts(
      x.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(),
      static_cast<int>(x.numel() / D), static_cast<int>(D), is_bf16(x));
  C10_CUDA_CHECK(cudaGetLastError());
  return n;
}

// x, g, dx: (rows, D) contiguous in x's dtype; w, dw: (D,); inv: (rows,)
// f32; part: (rmsnorm_bwd_parts(x, w, g, dx), D) f32 scratch.  Writes dx,
// dw.  Split rows (d_whole: the whole row's width): with write_stat,
// writes each row's partial sum(g*w*xhat) into stat, (rows,) f32, and
// nothing else (dx, dw, part None); else reads the summed stat in place
// of the row's own sum.
void rmsnorm_bwd(const at::Tensor& x, const at::Tensor& w,
                 const at::Tensor& inv, const at::Tensor& g,
                 const c10::optional<at::Tensor>& dx,
                 const c10::optional<at::Tensor>& dw,
                 const c10::optional<at::Tensor>& part,
                 const c10::optional<at::Tensor>& stat, bool write_stat,
                 int64_t d_whole) {
  const int64_t D = x.size(-1);
  if (!write_stat) {
    TORCH_CHECK(dx && dw && part, "rmsnorm_bwd: dx, dw and part are needed");
    const int64_t n_part = rmsnorm_bwd_parts(x, w, g, *dx);
    TORCH_CHECK(n_part > 0 && part->dim() == 2 && part->size(0) == n_part &&
                    part->size(1) == D && part->is_contiguous() &&
                    part->scalar_type() == at::kFloat,
                "rmsnorm_bwd: part must be contiguous f32 (", n_part, ", ",
                D, ")");
  }
  const c10::cuda::CUDAGuard guard(x.device());
  float* st = ptr_or_null<float>(stat);
  const bool launched = repro_rmsnorm_bwd(
      x.data_ptr(), w.data_ptr(), inv.data_ptr<float>(), g.data_ptr(),
      dx ? dx->data_ptr() : nullptr, dw ? dw->data_ptr() : nullptr,
      ptr_or_null<float>(part), write_stat ? nullptr : st,
      write_stat ? st : nullptr, static_cast<int>(x.numel() / D),
      static_cast<int>(D), static_cast<int>(stat ? d_whole : D), is_bf16(x),
      is_bf16(w), at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(launched, "rmsnorm_bwd: no launch (CUDA error) for D ", D);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// q, o: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D); one dtype, D axis
// contiguous, any other strides; lse: (B, Sq, Hq) f32 contiguous or None.
// Writes o (and lse).
void flash_fwd(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
               at::Tensor o, const c10::optional<at::Tensor>& lse,
               double scale, bool causal, int64_t q_offset, int64_t kv_len,
               int64_t window) {
  const c10::cuda::CUDAGuard guard(q.device());
  const bool launched = repro_flash_fwd(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
      lse ? lse->data_ptr<float>() : nullptr, q.size(0),
      q.size(1), k.size(1), q.size(2), k.size(2), q.size(3), q.stride(0),
      q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
      v.stride(0), v.stride(1), v.stride(2), o.stride(0), o.stride(1),
      o.stride(2), static_cast<float>(scale), causal, q_offset, kv_len,
      window, is_bf16(q), at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(launched, "flash_fwd: no kernel for head_dim ", q.size(3));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// q, dout: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D); one dtype, D axis
// contiguous, any other strides (bf16: 16-byte aligned, strides a multiple
// of 8); o, lse, delta (scratch) and the outputs dq, dk, dv contiguous.
// Writes dq, dk, dv.
void flash_bwd(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
               const at::Tensor& o, const at::Tensor& lse,
               const at::Tensor& dout, at::Tensor delta, at::Tensor dq,
               at::Tensor dk, at::Tensor dv, double scale, bool causal,
               int64_t q_offset, int64_t kv_len, int64_t window) {
  const c10::cuda::CUDAGuard guard(q.device());
  const bool launched = repro_flash_bwd(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
      dout.data_ptr(), lse.data_ptr<float>(), delta.data_ptr<float>(),
      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), q.size(0), q.size(1),
      k.size(1), q.size(2), k.size(2), q.size(3), q.stride(0), q.stride(1),
      q.stride(2), k.stride(0), k.stride(1), k.stride(2), v.stride(0),
      v.stride(1), v.stride(2), dout.stride(0), dout.stride(1),
      dout.stride(2), static_cast<float>(scale), causal, q_offset, kv_len,
      window, is_bf16(q), at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(launched, "flash_bwd: no kernel for head_dim ", q.size(3));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

int64_t ce_splits(int64_t n_tok, int64_t V, bool bf16) {
  return repro_ce_splits(static_cast<int>(n_tok), static_cast<int>(V), bf16);
}

// hidden: (T, D), w: (V, D) contiguous, one dtype (bf16: 16-byte aligned,
// D a multiple of 8); targets: (T,) int64 (outside [0, V): no target);
// part: (ce_splits(T, V, bf16), T, 3) f32 scratch.  Writes nll, lse (T,)
// f32.
void ce_fwd(const at::Tensor& hidden, const at::Tensor& w,
            const at::Tensor& targets, at::Tensor part, at::Tensor nll,
            at::Tensor lse) {
  const c10::cuda::CUDAGuard guard(hidden.device());
  repro_ce_fwd(hidden.data_ptr(), w.data_ptr(),
               reinterpret_cast<const long long*>(
                   targets.data_ptr<int64_t>()),
               part.data_ptr<float>(), nll.data_ptr<float>(),
               lse.data_ptr<float>(), nullptr,
               static_cast<int>(hidden.size(0)), static_cast<int>(w.size(0)),
               static_cast<int>(hidden.size(1)), is_bf16(hidden),
               at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// As ce_fwd, but writes each token's merged (m, l, target logit) over w's
// rows into stats (T, 3) f32: a vocab shard's part of the statistics.
void ce_fwd_stats(const at::Tensor& hidden, const at::Tensor& w,
                  const at::Tensor& targets, at::Tensor part,
                  at::Tensor stats) {
  const c10::cuda::CUDAGuard guard(hidden.device());
  repro_ce_fwd(hidden.data_ptr(), w.data_ptr(),
               reinterpret_cast<const long long*>(
                   targets.data_ptr<int64_t>()),
               part.data_ptr<float>(), nullptr, nullptr,
               stats.data_ptr<float>(), static_cast<int>(hidden.size(0)),
               static_cast<int>(w.size(0)), static_cast<int>(hidden.size(1)),
               is_bf16(hidden), at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// parts: (n, T, 3) f32 contiguous, the shards' triples; writes nll, lse.
void ce_merge(const at::Tensor& parts, at::Tensor nll, at::Tensor lse) {
  const c10::cuda::CUDAGuard guard(parts.device());
  repro_ce_merge(parts.data_ptr<float>(), nll.data_ptr<float>(),
                 lse.data_ptr<float>(), static_cast<int>(parts.size(1)),
                 static_cast<int>(parts.size(0)),
                 at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// x: (B, S, H, P); Bm, Cm: (B, S, G, N), one dtype, last axis contiguous,
// any other strides (bf16: 16-byte aligned, strides and N multiples of 8);
// dt: (B, S, H) f32, last axis contiguous; A: (H,) f32; h0: (B, H, P, N)
// f32 contiguous or None; cb: f32 only, (B, G, ceil(S / chunk), chunk,
// chunk) f32 scratch (None for bf16); y: (B, S, H, P) in x's dtype; hout:
// (B, H, P, N) f32 contiguous.  Writes y and hout.
void ssd_fwd(const at::Tensor& x, const at::Tensor& dt, const at::Tensor& A,
             const at::Tensor& Bm, const at::Tensor& Cm,
             const c10::optional<at::Tensor>& h0,
             const c10::optional<at::Tensor>& cb, at::Tensor y,
             at::Tensor hout, int64_t chunk) {
  const c10::cuda::CUDAGuard guard(x.device());
  const bool launched = repro_ssd_fwd(
      x.data_ptr(), dt.data_ptr<float>(), A.data_ptr<float>(),
      Bm.data_ptr(), Cm.data_ptr(), h0 ? h0->data_ptr<float>() : nullptr,
      cb ? cb->data_ptr<float>() : nullptr, y.data_ptr(),
      hout.data_ptr<float>(),
      x.size(0), x.size(1), x.size(2), x.size(3), Bm.size(2), Bm.size(3),
      chunk, x.stride(0), x.stride(1), x.stride(2), dt.stride(0),
      dt.stride(1), dt.stride(2), Bm.stride(0), Bm.stride(1), Bm.stride(2),
      Cm.stride(0), Cm.stride(1), Cm.stride(2), y.stride(0), y.stride(1),
      y.stride(2), is_bf16(x), at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(launched, "ssd_fwd: no kernel for x", x.sizes(), " B",
              Bm.sizes(), " chunk ", chunk);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Blocks of the bf16 SSD backward's chunk kernels a group of heads (the
// partials of dB and dC a group), for N a multiple of 8; 0 where its
// kernels cannot launch.
int64_t ssd_bwd_slots(int64_t B, int64_t S, int64_t H, int64_t G,
                      int64_t N, int64_t chunk) {
  const c10::cuda::CUDAGuard guard(at::cuda::current_device());
  return repro_ssd_bwd_slots(B, S, H, G, N, chunk);
}

// The SSD backward.  x, dt, A, Bm, Cm, h0 as ssd_fwd takes them; dy: (B,
// S, H, P) contiguous in x's dtype; dh: the final state's f32 cotangent
// (B, H, P, N) contiguous or None; outputs contiguous: dx (B, S, H, P),
// dB, dC (B, S, G, N) in x's dtype, ddt (B, S, H), dA (H,), dinit (B, H,
// P, N) f32.  Scratch (f32 unless said): da_part (B, H, ceil(S / chunk));
// db_part, dc_part (B, S, HP, N) with HP / G partials a group; f32: hs, gs
// (B, H, ceil(S / chunk), P, N), HP = H, no wpart, rvec, dvec; bf16: hs,
// gs bf16 (B, H, ceil(S / chunk), 2, P, N), HP = G * ssd_bwd_slots(..),
// wpart (B, H, ceil(S / chunk)), rvec, dvec (B, H, S).
void ssd_bwd(const at::Tensor& x, const at::Tensor& dt, const at::Tensor& A,
             const at::Tensor& Bm, const at::Tensor& Cm,
             const c10::optional<at::Tensor>& h0, const at::Tensor& dy,
             const c10::optional<at::Tensor>& dh, at::Tensor hs,
             at::Tensor gs, at::Tensor db_part, at::Tensor dc_part,
             at::Tensor da_part, const c10::optional<at::Tensor>& wpart,
             const c10::optional<at::Tensor>& rvec,
             const c10::optional<at::Tensor>& dvec, at::Tensor dx,
             at::Tensor ddt, at::Tensor dA, at::Tensor dB, at::Tensor dC,
             at::Tensor dinit, int64_t chunk) {
  const c10::cuda::CUDAGuard guard(x.device());
  auto opt = [](const c10::optional<at::Tensor>& t) {
    return t ? t->data_ptr<float>() : nullptr;
  };
  const bool launched = repro_ssd_bwd(
      x.data_ptr(), dt.data_ptr<float>(), A.data_ptr<float>(),
      Bm.data_ptr(), Cm.data_ptr(), opt(h0), dy.data_ptr(), opt(dh),
      hs.data_ptr(), gs.data_ptr(), db_part.data_ptr<float>(),
      dc_part.data_ptr<float>(), da_part.data_ptr<float>(), opt(wpart),
      opt(rvec), opt(dvec), dx.data_ptr(), ddt.data_ptr<float>(),
      dA.data_ptr<float>(), dB.data_ptr(), dC.data_ptr(),
      dinit.data_ptr<float>(), x.size(0), x.size(1), x.size(2), x.size(3),
      Bm.size(2), Bm.size(3), chunk, db_part.size(2), x.stride(0),
      x.stride(1), x.stride(2), dt.stride(0), dt.stride(1), dt.stride(2),
      Bm.stride(0), Bm.stride(1), Bm.stride(2), Cm.stride(0), Cm.stride(1),
      Cm.stride(2), is_bf16(x), at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(launched, "ssd_bwd: no kernel for x", x.sizes(), " B",
              Bm.sizes(), " chunk ", chunk);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// g: one leaf's contiguous gradient, bf16 or f32; part: (leaves, 1024)
// f32 contiguous.  Writes row `leaf` of part from `grid` blocks.
void adamw_norm(const at::Tensor& g, at::Tensor part, int64_t leaf,
                int64_t grid) {
  const c10::cuda::CUDAGuard guard(g.device());
  TORCH_CHECK(leaf >= 0 && leaf < part.size(0), "adamw_norm: leaf ", leaf,
              " of ", part.size(0));
  const bool launched = repro_adamw_norm(
      g.data_ptr(), g.numel(), is_bf16(g),
      part.data_ptr<float>() + leaf * part.size(1), static_cast<int>(grid),
      at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(launched, "adamw_norm: no launch for grid ", grid);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// part: (leaves, 1024) f32; sums: (leaves,) f32.
void adamw_norm_final(const at::Tensor& part, at::Tensor sums) {
  const c10::cuda::CUDAGuard guard(part.device());
  const bool launched = repro_adamw_norm_final(
      part.data_ptr<float>(), static_cast<int>(part.size(0)),
      sums.data_ptr<float>(), at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(launched, "adamw_norm_final: no launch");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// p, g, m, v: one leaf's contiguous tensors of one size; p, g bf16 or
// f32, m and v both bf16 or both f32; scale: the 0-d f32 clip scale or
// None.  Updates p, m and v in place.
void adamw_update(at::Tensor p, const at::Tensor& g, at::Tensor m,
                  at::Tensor v, const c10::optional<at::Tensor>& scale,
                  double lr, double lr_wd, bool decay, double b1, double omb1,
                  double b2, double omb2, double c1, double c2, double eps) {
  const c10::cuda::CUDAGuard guard(p.device());
  const bool launched = repro_adamw_update(
      p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
      is_bf16(p), is_bf16(g), is_bf16(m), ptr_or_null<float>(scale),
      static_cast<float>(lr), static_cast<float>(lr_wd), decay ? 1 : 0,
      static_cast<float>(b1), static_cast<float>(omb1),
      static_cast<float>(b2), static_cast<float>(omb2),
      static_cast<float>(c1), static_cast<float>(c2),
      static_cast<float>(eps), at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(launched, "adamw_update: no launch (CUDA error)");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// (name, [registers, local bytes, static smem, dynamic smem, threads,
// blocks a SM]) of the kernels redesigned for the card: the bf16 flash
// forward and backward at every head_dim (name suffix <D>), the CE
// forward, the RMSNorm backward's two passes and its forward at each
// instantiation, the bf16 SSD scan at each padded N, the SSD
// backward's kernels and AdamW's.
std::vector<std::pair<std::string, std::vector<int64_t>>> kernel_info() {
  const c10::cuda::CUDAGuard guard(at::cuda::current_device());
  std::vector<std::pair<std::string, std::vector<int64_t>>> rows;
  int out[6];
  const char* name = nullptr;
  auto add = [&](const std::string& n) {
    rows.emplace_back(n, std::vector<int64_t>(out, out + 6));
  };
  for (int D : {16, 32, 64, 128}) {
    for (int idx = 0; repro_flash_fwd_info(idx, D, &name, out); ++idx)
      add(std::string(name) + "<" + std::to_string(D) + ">");
    for (int idx = 0; repro_flash_bwd_info(idx, D, &name, out); ++idx)
      add(std::string(name) + "<" + std::to_string(D) + ">");
  }
  for (int idx = 0; repro_ce_info(idx, &name, out); ++idx) add(name);
  for (int idx = 0; repro_rmsnorm_info(idx, &name, out); ++idx) add(name);
  for (int idx = 0; repro_ssd_info(idx, &name, out); ++idx) add(name);
  for (int idx = 0; repro_adamw_info(idx, &name, out); ++idx) add(name);
  C10_CUDA_CHECK(cudaGetLastError());
  return rows;
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("rmsnorm_fwd", &rmsnorm_fwd, "row RMSNorm forward into y (and inv)",
        py::arg("x"), py::arg("w"), py::arg("y"), py::arg("eps"),
        py::arg("inv"), py::arg("stat") = py::none(),
        py::arg("write_stat") = false, py::arg("d_whole") = 0);
  m.def("rmsnorm_fwd_plan", &rmsnorm_fwd_plan,
        "threads a row, rows a block at once and grid of the RMSNorm "
        "forward");
  m.def("rmsnorm_bwd_parts", &rmsnorm_bwd_parts,
        "rows of the RMSNorm backward's f32 dw scratch");
  m.def("rmsnorm_bwd", &rmsnorm_bwd, "RMSNorm backward into dx, dw",
        py::arg("x"), py::arg("w"), py::arg("inv"), py::arg("g"),
        py::arg("dx"), py::arg("dw"), py::arg("part"),
        py::arg("stat") = py::none(), py::arg("write_stat") = false,
        py::arg("d_whole") = 0);
  m.def("flash_fwd", &flash_fwd, "flash-attention forward into o (and lse)");
  m.def("flash_bwd", &flash_bwd, "flash-attention backward into dq, dk, dv");
  m.def("ce_splits", &ce_splits, "vocab splits of the CE forward's scratch");
  m.def("ce_fwd", &ce_fwd, "blockwise cross-entropy forward into nll, lse");
  m.def("ce_fwd_stats", &ce_fwd_stats,
        "blockwise cross-entropy forward into a shard's (m, l, target)");
  m.def("ce_merge", &ce_merge, "merge shards' (m, l, target) into nll, lse");
  m.def("ssd_fwd", &ssd_fwd, "Mamba2 SSD chunked scan into y and hout");
  m.def("ssd_bwd_slots", &ssd_bwd_slots,
        "blocks of the bf16 SSD backward's chunk kernels a group of heads");
  m.def("ssd_bwd", &ssd_bwd,
        "Mamba2 SSD backward into dx, ddt, dA, dB, dC, dinit");
  m.def("adamw_norm", &adamw_norm,
        "one leaf's partial sums of squares into its row of part");
  m.def("adamw_norm_final", &adamw_norm_final,
        "each leaf's sum of squares from its row of part");
  m.def("adamw_update", &adamw_update,
        "one leaf's AdamW step in place, clipped by scale");
  m.def("kernel_info", &kernel_info,
        "registers, spills, shared memory and occupancy of the redesigned "
        "kernels");
}
