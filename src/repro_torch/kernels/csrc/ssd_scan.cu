// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
// Plain CUDA with a C entry point: bindings.cpp launches it and checks the
// launch.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_pallas (body
// _ssd_kernel).  Per chunk of Q tokens, with cs the inclusive cumsum of
// dA = dt * A (A < 0) inside the chunk:
//   y_intra = (C B^T o L o dt) @ x,   L[i, j] = exp(cs_i - cs_j), j <= i
//   y_inter = (C o exp(cs)) @ h^T     (h: the (P, N) f32 state before it)
//   h      <- exp(cs_end) h + (x o dt o exp(cs_end - cs))^T B
// with B, C shared by the H / G heads of a group (head h reads group
// h / (H / G)), an optional initial state, and the state after the last
// token written out.  x, B and C are bf16 or f32 (one dtype), dt, A and
// the state f32; all arithmetic is f32; y comes out in x's dtype.
//
// Bound on the card: bytes.  At the zamba2-1.2b prefill shape (B=4,
// S=2048, H=64, P=64, G=1, N=64, Q=128, bf16) the call must read x, dt,
// B and C and write y and the final state once, about 143 MB, 43 us at
// HBM rate; the products it needs (C B^T once per group, the causal half
// of the intra-chunk product, the inter-chunk output and the state update)
// are about 13 GFLOP, 13 us at the bf16 tensor-core peak.  This first
// version runs f32 FMAs from shared memory on the CUDA cores, so it is
// bound by that arithmetic, well above either; wgmma, TMA and tuning are
// later work.
//
// Design.  The TPU grid carries the state in VMEM scratch along a
// sequential chunk axis; CUDA blocks run in no order.  So one block owns a
// (batch, head, P-tile) and loops over the chunks itself, holding its
// (P_tile, N) slice of the state in registers (and a copy in shared memory
// that the y product reads).  That is exact: row p of the state depends
// only on column p of x.  P-tiles of 32 (16 or 8 where P needs it) give
// enough blocks at small H (mamba2-130m: 4 x 24 x 2 = 192).  C B^T
// depends on the group and not on the head or the P-tile, so a first small
// kernel computes it once per (batch, group, chunk) into an f32 scratch
// (B, G, n_chunks, Q, Q) that the scan kernel then reads from L2.
//
// Layouts: x (B, S, H, P), dt (B, S, H), B and C (B, S, G, N) are read in
// place through their strides (the last axis contiguous); the model hands
// x over as a view of (B, S, H * P) and nothing is transposed.
//
// Ragged tails: tokens at or past S are masked, not padded; a masked token
// acts as dt = 0 (decay 1, no injection), so the state written out is the
// state after token S - 1.  dt * A <= 0, so every exp() here is of a
// number <= 0 and lies in [0, 1]: exp(cs) underflows to 0 over a long
// chunk, which is right, and nothing is divided by it.  Entries of L above
// the diagonal are never formed (no inf * 0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQMax = 128;   // largest chunk
constexpr int kNMax = 128;   // largest state size
constexpr int kThreads = 256;
constexpr int kJT = 32;      // columns of the decay-weighted M tile

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

struct Strides {
  long long b, s, h;  // element strides; the last axis is contiguous
};

// Row stride (elements) of the B/C chunk in shared memory: odd in 32-bit
// words, so that threads reading one column of different rows hit
// different banks.
template <typename T>
__host__ __device__ constexpr int bc_ld(int N) {
  return sizeof(T) == 2 ? N + 2 : N + 1;
}

// CB[b, g, c] = C_c B_c^T (Q x Q, f32) for one (chunk, group, batch) per
// block.  256 threads as 16 x 16, each owning rows ty + 16 r and columns
// tx + 16 c of the tile; N is walked 32 at a time through shared memory.
// Tokens at or past S count as zero.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_cb_kernel(const T* __restrict__ Cm, const T* __restrict__ Bm,
                  float* __restrict__ cb, int S, int G, int N, int Q,
                  int n_c, Strides cs_, Strides bs_) {
  __shared__ float c_s[kQMax][33];
  __shared__ float b_s[kQMax][33];
  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int t0 = c * Q;
  const T* cp = Cm + b * cs_.b + g * cs_.h;
  const T* bp = Bm + b * bs_.b + g * bs_.h;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[r][k] = 0.f;

  for (int n0 = 0; n0 < N; n0 += 32) {
    __syncthreads();
    for (int idx = tid; idx < kQMax * 32; idx += kThreads) {
      const int i = idx / 32, nn = idx % 32, n = n0 + nn, t = t0 + i;
      const bool ok = i < Q && t < S && n < N;
      c_s[i][nn] = ok ? to_f32(cp[t * cs_.s + n]) : 0.f;
      b_s[i][nn] = ok ? to_f32(bp[t * bs_.s + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int nn = 0; nn < 32; ++nn) {
      float cv[8], bv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) cv[r] = c_s[ty + 16 * r][nn];
#pragma unroll
      for (int k = 0; k < 8; ++k) bv[k] = b_s[tx + 16 * k][nn];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[r][k] = fmaf(cv[r], bv[k], acc[r][k]);
    }
  }
  float* out = cb + (((long long)b * G + g) * n_c + c) * Q * Q;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = ty + 16 * r, j = tx + 16 * k;
      if (i < Q && j < Q) out[i * Q + j] = acc[r][k];
    }
}

// The scan: one block per (P-tile, head, batch), 256 threads.  KP = P_tile
// / 8.  For the y products thread (ty, tx) = (tid / 8, tid % 8) owns rows
// 4 ty + r (r < 4) and columns tx * KP + k (k < KP); for the state update
// warp w owns state rows w * KP + k and lane l state columns l + 32 m.
template <typename T, int KP>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ cb,
                    const float* __restrict__ h0, T* __restrict__ y,
                    float* __restrict__ hout, int S, int H, int P, int G,
                    int N, int Q, int n_c, Strides xs_, Strides dts_,
                    Strides bs_, Strides cs_, Strides ys_) {
  constexpr int PT = 8 * KP;
  const int Qr = (Q + 3) & ~3;  // rows in shared memory, zero past Q
  const int ld_b = bc_ld<T>(N);
  extern __shared__ float smem[];
  float* dts = smem;                 // [kQMax] dt, 0 past S
  float* cs = dts + kQMax;           // [kQMax] inclusive cumsum of dt * A
  float* ecs = cs + kQMax;           // [kQMax] exp(cs)
  float* wx = ecs + kQMax;           // [kQMax] dt * exp(cs_end - cs)
  float* xs = wx + kQMax;            // [Qr][PT + 1] x tile (then x * wx)
  float* hs = xs + Qr * (PT + 1);    // [PT][N + 1] state before the chunk
  float* ms = hs + PT * (N + 1);     // [Qr][kJT + 1] M tile
  T* bc = reinterpret_cast<T*>(ms + Qr * (kJT + 1));  // [Qr][ld_b] C or B

  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ty = tid / 8, tx = tid % 8;
  const float a = A[h];
  const T zero = from_f32<T>(0.f);

  const T* xp = x + b * xs_.b + h * xs_.h + p0;
  const float* dtp = dt + b * dts_.b + h * dts_.h;
  const T* bp = Bm + b * bs_.b + g * bs_.h;
  const T* cp = Cm + b * cs_.b + g * cs_.h;
  T* yp = y + b * ys_.b + h * ys_.h + p0;
  const long long state0 = ((long long)b * H + h) * P * N;

  // the state slice this thread updates: rows warp * KP + k, columns
  // lane + 32 m
  float hreg[KP][kNMax / 32];
#pragma unroll
  for (int k = 0; k < KP; ++k)
#pragma unroll
    for (int m = 0; m < kNMax / 32; ++m) {
      const int p = warp * KP + k, n = lane + 32 * m;
      float v = 0.f;
      if (n < N && h0 != nullptr) v = h0[state0 + (long long)(p0 + p) * N + n];
      hreg[k][m] = v;
      if (n < N) hs[p * (N + 1) + n] = v;
    }

  for (int c = 0; c < n_c; ++c) {
    const int t0 = c * Q;
    __syncthreads();  // the previous chunk is done with every buffer
    if (tid < kQMax) {
      const int t = t0 + tid;
      dts[tid] = (tid < Q && t < S) ? dtp[t * dts_.s] : 0.f;
    }
    for (int idx = tid; idx < Qr * PT; idx += kThreads) {
      const int i = idx / PT, p = idx % PT, t = t0 + i;
      xs[i * (PT + 1) + p] =
          (i < Q && t < S) ? to_f32(xp[t * xs_.s + p]) : 0.f;
    }
    for (int idx = tid; idx < Qr * N; idx += kThreads) {
      const int i = idx / N, n = idx % N, t = t0 + i;
      bc[i * ld_b + n] = (i < Q && t < S) ? cp[t * cs_.s + n] : zero;
    }
    __syncthreads();
    if (warp == 0) {  // inclusive scan of dt * A over the chunk
      float v[4], run = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        run += dts[4 * lane + e] * a;
        v[e] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += o;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) cs[4 * lane + e] = tot - run + v[e];
    }
    __syncthreads();
    const float cs_end = cs[Q - 1];
    if (tid < kQMax) {
      ecs[tid] = expf(cs[tid]);
      wx[tid] = dts[tid] * expf(cs_end - cs[tid]);
    }

    // y_inter = exp(cs_i) * sum_n C[i, n] h[p, n]
    float acc[4][KP];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < KP; ++k) acc[r][k] = 0.f;
    const int i0 = 4 * ty;
    if (i0 < Qr) {
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[KP];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = to_f32(bc[(i0 + r) * ld_b + n]);
#pragma unroll
        for (int k = 0; k < KP; ++k) hv[k] = hs[(tx * KP + k) * (N + 1) + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < KP; ++k) acc[r][k] = fmaf(cv[r], hv[k], acc[r][k]);
      }
    }
    __syncthreads();  // ecs, wx written
    if (i0 < Qr) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < KP; ++k) acc[r][k] *= ecs[i0 + r];
    }

    // y_intra, kJT columns of M = CB o L o dt at a time (j <= i only)
    const float* cbp = cb + (((long long)b * G + g) * n_c + c) * Q * Q;
    for (int j0 = 0; j0 < Qr; j0 += kJT) {
      for (int idx = tid; idx < (Qr - j0) * kJT; idx += kThreads) {
        const int i = j0 + idx / kJT, jj = idx % kJT, j = j0 + jj;
        float v = 0.f;
        if (j <= i && i < Q)
          v = cbp[i * Q + j] * expf(cs[i] - cs[j]) * dts[j];
        ms[i * (kJT + 1) + jj] = v;
      }
      __syncthreads();
      if (i0 >= j0 && i0 < Qr) {
        int jn = i0 + 4 - j0;  // columns at or left of the thread's last row
        jn = jn < kJT ? jn : kJT;
        jn = jn < Qr - j0 ? jn : Qr - j0;
        for (int jj = 0; jj < jn; ++jj) {
          float mv[4], xv[KP];
#pragma unroll
          for (int r = 0; r < 4; ++r) mv[r] = ms[(i0 + r) * (kJT + 1) + jj];
#pragma unroll
          for (int k = 0; k < KP; ++k) xv[k] = xs[(j0 + jj) * (PT + 1) + tx * KP + k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < KP; ++k) acc[r][k] = fmaf(mv[r], xv[k], acc[r][k]);
        }
      }
      __syncthreads();  // the M tile is rewritten next
    }
    if (i0 < Qr) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r, t = t0 + i;
        if (i < Q && t < S) {
#pragma unroll
          for (int k = 0; k < KP; ++k)
            yp[t * ys_.s + tx * KP + k] = from_f32<T>(acc[r][k]);
        }
      }
    }

    // state update: B of the chunk replaces C; x rows weighted by wx
    for (int idx = tid; idx < Qr * N; idx += kThreads) {
      const int i = idx / N, n = idx % N, t = t0 + i;
      bc[i * ld_b + n] = (i < Q && t < S) ? bp[t * bs_.s + n] : zero;
    }
    for (int idx = tid; idx < Qr * PT; idx += kThreads) {
      const int i = idx / PT, p = idx % PT;
      xs[i * (PT + 1) + p] *= wx[i];
    }
    __syncthreads();
    const float decay = expf(cs_end);
    float upd[KP][kNMax / 32];
#pragma unroll
    for (int k = 0; k < KP; ++k)
#pragma unroll
      for (int m = 0; m < kNMax / 32; ++m) upd[k][m] = 0.f;
    for (int j = 0; j < Qr; ++j) {
      float bv[kNMax / 32], xv[KP];
#pragma unroll
      for (int m = 0; m < kNMax / 32; ++m) {
        const int n = lane + 32 * m;
        bv[m] = n < N ? to_f32(bc[j * ld_b + n]) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < KP; ++k) xv[k] = xs[j * (PT + 1) + warp * KP + k];
#pragma unroll
      for (int k = 0; k < KP; ++k)
#pragma unroll
        for (int m = 0; m < kNMax / 32; ++m)
          upd[k][m] = fmaf(xv[k], bv[m], upd[k][m]);
    }
#pragma unroll
    for (int k = 0; k < KP; ++k)
#pragma unroll
      for (int m = 0; m < kNMax / 32; ++m) {
        const int n = lane + 32 * m;
        hreg[k][m] = fmaf(hreg[k][m], decay, upd[k][m]);
        if (n < N) hs[(warp * KP + k) * (N + 1) + n] = hreg[k][m];
      }
  }

#pragma unroll
  for (int k = 0; k < KP; ++k)
#pragma unroll
    for (int m = 0; m < kNMax / 32; ++m) {
      const int p = warp * KP + k, n = lane + 32 * m;
      if (n < N) hout[state0 + (long long)(p0 + p) * N + n] = hreg[k][m];
    }
}

template <typename T>
size_t scan_smem(int Q, int N, int PT) {
  const int Qr = (Q + 3) & ~3;
  return sizeof(float) * (size_t)(4 * kQMax + Qr * (PT + 1) +
                                  PT * (N + 1) + Qr * (kJT + 1)) +
         sizeof(T) * (size_t)Qr * bc_ld<T>(N);
}

template <typename T, int KP>
bool launch_scan(const void* x, const float* dt, const float* A,
                 const void* Bm, const void* Cm, const float* cb,
                 const float* h0, void* y, float* hout, int Bsz, int S,
                 int H, int P, int G, int N, int Q, int n_c, Strides xs,
                 Strides dts, Strides bs, Strides cs, Strides ys,
                 cudaStream_t s) {
  const size_t smem = scan_smem<T>(Q, N, 8 * KP);
  auto kernel = ssd_scan_kernel<T, KP>;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return false;
  dim3 grid(P / (8 * KP), H, Bsz);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), cb, h0, static_cast<T*>(y), hout, S, H, P,
      G, N, Q, n_c, xs, dts, bs, cs, ys);
  return true;
}

template <typename T>
bool launch(const void* x, const float* dt, const float* A, const void* Bm,
            const void* Cm, const float* h0, float* cb, void* y,
            float* hout, int Bsz, int S, int H, int P, int G, int N, int Q,
            Strides xs, Strides dts, Strides bs, Strides cs, Strides ys,
            cudaStream_t s) {
  const int n_c = (S + Q - 1) / Q;
  ssd_cb_kernel<T><<<dim3(n_c, G, Bsz), kThreads, 0, s>>>(
      static_cast<const T*>(Cm), static_cast<const T*>(Bm), cb, S, G, N, Q,
      n_c, cs, bs);
  if (P % 32 == 0)
    return launch_scan<T, 4>(x, dt, A, Bm, Cm, cb, h0, y, hout, Bsz, S, H,
                             P, G, N, Q, n_c, xs, dts, bs, cs, ys, s);
  if (P % 16 == 0)
    return launch_scan<T, 2>(x, dt, A, Bm, Cm, cb, h0, y, hout, Bsz, S, H,
                             P, G, N, Q, n_c, xs, dts, bs, cs, ys, s);
  return launch_scan<T, 1>(x, dt, A, Bm, Cm, cb, h0, y, hout, Bsz, S, H, P,
                           G, N, Q, n_c, xs, dts, bs, cs, ys, s);
}

}  // namespace

// x: (B, S, H, P); dt: (B, S, H) f32; A: (H,) f32; Bm, Cm: (B, S, G, N);
// x, Bm, Cm one dtype, bf16 (bf16 != 0) or f32, any strides with the last
// axis contiguous (the *_s* arguments are element strides).  h0: (B, H, P,
// N) f32 contiguous or null (zeros).  cb: (B, G, ceil(S / Q), Q, Q) f32
// scratch.  y: (B, S, H, P) in x's dtype; hout: (B, H, P, N) f32
// contiguous.  Two launches on `stream`.  Returns false (and launches
// nothing) for a shape it does not take: S, B < 1, Q outside 1..128, N
// outside 1..128, P not a multiple of 8, H not a multiple of G; errors of
// a launch are left to cudaGetLastError.
extern "C" bool repro_ssd_fwd(
    const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, const float* h0, float* cb, void* y, float* hout,
    int Bsz, int S, int H, int P, int G, int N, int Q, long long x_sb,
    long long x_ss, long long x_sh, long long dt_sb, long long dt_ss,
    long long dt_sh, long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg, long long y_sb,
    long long y_ss, long long y_sh, int bf16, cudaStream_t s) {
  if (Bsz < 1 || S < 1 || Q < 1 || Q > kQMax || N < 1 || N > kNMax ||
      P < 8 || P % 8 != 0 || G < 1 || H % G != 0)
    return false;
  const Strides xs{x_sb, x_ss, x_sh}, dts{dt_sb, dt_ss, dt_sh},
      bs{b_sb, b_ss, b_sg}, cs{c_sb, c_ss, c_sg}, ys{y_sb, y_ss, y_sh};
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, cb, y, hout, Bsz, S,
                                 H, P, G, N, Q, xs, dts, bs, cs, ys, s);
  return launch<float>(x, dt, A, Bm, Cm, h0, cb, y, hout, Bsz, S, H, P, G,
                       N, Q, xs, dts, bs, cs, ys, s);
}
