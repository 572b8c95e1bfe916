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
// the state f32; y comes out in x's dtype.
//
// Bound on the card.  At the zamba2-1.2b prefill shape (B=4, S=2048, H=64,
// P=64, G=1, N=64, Q=128, bf16) the call must read x, dt, B and C and
// write y and the final state once, about 143 MB, 43 us at HBM rate; the
// products it needs (C B^T once per group, the causal half of the
// intra-chunk product, the inter-chunk output and the state update) are
// about 13 GFLOP, 13 us at the bf16 tensor-core peak: bytes.  At the
// mamba2-130m shape (H=24, N=128) the bound is 17 us, also bytes.
//
// Design.  The TPU grid carries the state in VMEM scratch along a
// sequential chunk axis; CUDA blocks run in no order.  So one block owns a
// (batch, head, P-tile) and loops over the chunks itself, holding its
// (P_tile, N) slice of the f32 state in registers: exact, and no
// per-chunk state goes to device memory (row p of the state depends only
// on column p of x).
//
// bf16 (the models' path): tensor cores, one launch.  8 warps; the chunk's
// x, B and C arrive through a two-stage cp.async ring (chunk c + 1 loads
// while chunk c computes) into swizzled bf16 tiles (tc.cuh), zero past Q,
// S, P and N; dt, which only warp 0's cumsum reads, is loaded into its
// registers a chunk ahead.  Warp w owns the chunk's rows 16w .. 16w + 15:
//   - y_inter = C h^T (mma.sync.m16n8k16, bf16 in, f32 sums) against hi
//     and lo bf16 copies of the state in shared memory (two products),
//     scaled by exp(cs_i) in f32 on the output fragments;
//   - for each 16-column tile j <= the warp's rows: S = C B^T over N on
//     the tensor cores, then M = S o L o dt on S's f32 C fragments (the
//     exp of cs differences in registers, j <= i only; tiles above the
//     diagonal never formed), split into hi + lo bf16 A fragments
//     straight from the registers (tc::pack_a_split) for y += M x, two
//     products into one f32 sum.
// So C B^T is recomputed in every block from the tiles it already holds
// (tensor-core time, not bytes: no f32 scratch in device memory).  The
// state update h = exp(cs_end) h + (x o w)^T B, w = dt exp(cs_end - cs),
// takes x^T's A fragments by ldmatrix.trans and folds w into them in f32
// (one fragment a k16 step, against N / 8 B fragments), split into hi +
// lo bf16 likewise; each warp owns a 16-row x (N / 8 / warps-a-row)-column
// slice of the state in f32 registers, which is never rounded, and writes
// its hi and lo copies for the next chunk's y_inter.  The P-tile is 64
// columns: every block recomputes C B^T, so a narrower tile buys SMs with
// products, and 64 was fastest at both models' shapes (zamba2-1.2b: 256
// blocks, two a SM; mamba2-130m: 96 blocks on 132 SMs, faster than 192
// of 32 columns; PERF.md).
// Precision (tests/test_torch_ssd_numerics.py emulates it): every operand
// that is not bf16 already goes in as a hi + lo pair, at one more product
// each.  Rounded once, M moved y by as much as y's own bf16 rounding and
// lost the models' end-to-end check against the plain path; x o w put
// 2^-9 into the final state that decode carries on; and the state's copy
// put 1e-3 into y at the first tokens of each chunk, where y_inter
// dominates (and decode against a longer prefill compares).  Split, y's
// rounding is the largest error left.
//
// f32 (the 3e-4 sweeps, no main path; TF32 cannot meet 3e-4): f32 FMAs on
// the CUDA cores.  A first small kernel computes C B^T once per (batch,
// group, chunk) into an f32 scratch (B, G, n_chunks, Q, Q) that the scan
// kernel reads from L2; the scan's blocks use P-tiles of 32 (16 or 8
// where P needs it) and keep a copy of the state in shared memory.
//
// Layouts: x (B, S, H, P), dt (B, S, H), B and C (B, S, G, N) are read in
// place through their strides (the last axis contiguous); the model hands
// x over as a view of (B, S, H * P) and nothing is transposed.  The bf16
// path copies 16-byte chunks, so it needs x, B and C 16-byte aligned with
// strides and N a multiple of 8 (the wrapper copies what is not).
//
// Ragged tails: tokens at or past S are masked, not padded; a masked token
// acts as dt = 0 (decay 1, no injection), so the state written out is the
// state after token S - 1.  dt * A <= 0, so every exp() here is of a
// number <= 0 and lies in [0, 1]: exp(cs) underflows to 0 over a long
// chunk, which is right, and nothing is divided by it.  Entries of L above
// the diagonal are never formed (no inf * 0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstdio>
#include <cstring>

#include "tc.cuh"

namespace {

constexpr int kQMax = 128;   // largest chunk
constexpr int kNMax = 128;   // largest state size
constexpr int kThreads = 256;
constexpr int kJT = 32;      // columns of the decay-weighted M tile

struct Strides {
  long long b, s, h;  // element strides; the last axis is contiguous
};

// Row stride (floats) of the B/C chunk in shared memory: odd, so that
// threads reading one column of different rows hit different banks.
__host__ __device__ constexpr int bc_ld(int N) { return N + 1; }

// CB[b, g, c] = C_c B_c^T (Q x Q, f32) for one (chunk, group, batch) per
// block.  256 threads as 16 x 16, each owning rows ty + 16 r and columns
// tx + 16 c of the tile; N is walked 32 at a time through shared memory.
// Tokens at or past S count as zero.
__global__ void __launch_bounds__(kThreads)
    ssd_cb_kernel(const float* __restrict__ Cm, const float* __restrict__ Bm,
                  float* __restrict__ cb, int S, int G, int N, int Q,
                  int n_c, Strides cs_, Strides bs_) {
  __shared__ float c_s[kQMax][33];
  __shared__ float b_s[kQMax][33];
  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int t0 = c * Q;
  const float* cp = Cm + b * cs_.b + g * cs_.h;
  const float* bp = Bm + b * bs_.b + g * bs_.h;
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
      c_s[i][nn] = ok ? cp[t * cs_.s + n] : 0.f;
      b_s[i][nn] = ok ? bp[t * bs_.s + n] : 0.f;
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
template <int KP>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ cb,
                    const float* __restrict__ h0, float* __restrict__ y,
                    float* __restrict__ hout, int S, int H, int P, int G,
                    int N, int Q, int n_c, Strides xs_, Strides dts_,
                    Strides bs_, Strides cs_, Strides ys_) {
  constexpr int PT = 8 * KP;
  const int Qr = (Q + 3) & ~3;  // rows in shared memory, zero past Q
  const int ld_b = bc_ld(N);
  extern __shared__ float smem[];
  float* dts = smem;                 // [kQMax] dt, 0 past S
  float* cs = dts + kQMax;           // [kQMax] inclusive cumsum of dt * A
  float* ecs = cs + kQMax;           // [kQMax] exp(cs)
  float* wx = ecs + kQMax;           // [kQMax] dt * exp(cs_end - cs)
  float* xs = wx + kQMax;            // [Qr][PT + 1] x tile (then x * wx)
  float* hs = xs + Qr * (PT + 1);    // [PT][N + 1] state before the chunk
  float* ms = hs + PT * (N + 1);     // [Qr][kJT + 1] M tile
  float* bc = ms + Qr * (kJT + 1);   // [Qr][ld_b] C or B

  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ty = tid / 8, tx = tid % 8;
  const float a = A[h];

  const float* xp = x + b * xs_.b + h * xs_.h + p0;
  const float* dtp = dt + b * dts_.b + h * dts_.h;
  const float* bp = Bm + b * bs_.b + g * bs_.h;
  const float* cp = Cm + b * cs_.b + g * cs_.h;
  float* yp = y + b * ys_.b + h * ys_.h + p0;
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
          (i < Q && t < S) ? xp[t * xs_.s + p] : 0.f;
    }
    for (int idx = tid; idx < Qr * N; idx += kThreads) {
      const int i = idx / N, n = idx % N, t = t0 + i;
      bc[i * ld_b + n] = (i < Q && t < S) ? cp[t * cs_.s + n] : 0.f;
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
        for (int r = 0; r < 4; ++r) cv[r] = bc[(i0 + r) * ld_b + n];
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
            yp[t * ys_.s + tx * KP + k] = acc[r][k];
        }
      }
    }

    // state update: B of the chunk replaces C; x rows weighted by wx
    for (int idx = tid; idx < Qr * N; idx += kThreads) {
      const int i = idx / N, n = idx % N, t = t0 + i;
      bc[i * ld_b + n] = (i < Q && t < S) ? bp[t * bs_.s + n] : 0.f;
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
        bv[m] = n < N ? bc[j * ld_b + n] : 0.f;
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

size_t scan_smem(int Q, int N, int PT) {
  const int Qr = (Q + 3) & ~3;
  return sizeof(float) * (size_t)(4 * kQMax + Qr * (PT + 1) + PT * (N + 1) +
                                  Qr * (kJT + 1) + Qr * bc_ld(N));
}

template <int KP>
bool launch_scan(const float* x, const float* dt, const float* A,
                 const float* Bm, const float* Cm, const float* cb,
                 const float* h0, float* y, float* hout, int Bsz, int S,
                 int H, int P, int G, int N, int Q, int n_c, Strides xs,
                 Strides dts, Strides bs, Strides cs, Strides ys,
                 cudaStream_t s) {
  const size_t smem = scan_smem(Q, N, 8 * KP);
  auto kernel = ssd_scan_kernel<KP>;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return false;
  dim3 grid(P / (8 * KP), H, Bsz);
  kernel<<<grid, kThreads, smem, s>>>(x, dt, A, Bm, Cm, cb, h0, y, hout, S,
                                      H, P, G, N, Q, n_c, xs, dts, bs, cs,
                                      ys);
  return true;
}

// The f32 path: C B^T into the scratch, then the scan.
bool launch_f32(const float* x, const float* dt, const float* A,
                const float* Bm, const float* Cm, const float* h0, float* cb,
                float* y, float* hout, int Bsz, int S, int H, int P, int G,
                int N, int Q, Strides xs, Strides dts, Strides bs, Strides cs,
                Strides ys, cudaStream_t s) {
  const int n_c = (S + Q - 1) / Q;
  ssd_cb_kernel<<<dim3(n_c, G, Bsz), kThreads, 0, s>>>(Cm, Bm, cb, S, G, N,
                                                        Q, n_c, cs, bs);
  if (P % 32 == 0)
    return launch_scan<4>(x, dt, A, Bm, Cm, cb, h0, y, hout, Bsz, S, H, P, G,
                          N, Q, n_c, xs, dts, bs, cs, ys, s);
  if (P % 16 == 0)
    return launch_scan<2>(x, dt, A, Bm, Cm, cb, h0, y, hout, Bsz, S, H, P, G,
                          N, Q, n_c, xs, dts, bs, cs, ys, s);
  return launch_scan<1>(x, dt, A, Bm, Cm, cb, h0, y, hout, Bsz, S, H, P, G,
                        N, Q, n_c, xs, dts, bs, cs, ys, s);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (see the head of the file)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 256;
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcPT = 64;  // the P-tile: columns of x and rows of the state
constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU (ex2.approx: relative error about 2^-22; results below
// 2^-126 flush to zero, which only ever rounds a vanishing decay).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two bf16 values times two f32 weights, as hi and lo bf16 pairs
// (tc::split_bf16).
__device__ __forceinline__ void scale_split(uint32_t v, float2 w,
                                            uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 b;
  memcpy(&b, &v, sizeof b);
  const float2 f = __bfloat1622float2(b);
  tc::split_bf16(f.x * w.x, f.y * w.y, hi, lo);
}

// Shared memory of the kernel for N padded to NP: two stages of {x
// [kQMax][PT], B and C [kQMax][NP]} (bf16, swizzled), then the state's hi
// and lo bf16 copies [PT][NP] (swizzled), the chunk's cumsum in log2 units
// and its dt (f32 [kQMax] each).  At NP = 64, zamba2-1.2b's, that is
// 113 KB: two blocks a SM, to the byte.
template <int NP>
struct TcLayout {
  static constexpr int PT = kTcPT;
  static constexpr int kX = kQMax * PT;  // bf16 elements
  static constexpr int kBC = kQMax * NP;
  static constexpr size_t kStage = sizeof(bf16) * (kX + 2 * kBC);
  static constexpr size_t kBytes =
      2 * kStage + 2 * sizeof(bf16) * PT * NP + 2 * sizeof(float) * kQMax;
  // two blocks a SM where their shared memory fits (228 KB a SM, 1 KB of
  // it reserved a block)
  static constexpr int kMinBlocks = 2 * (kBytes + 1024) <= 233472 ? 2 : 1;
};

// One block per (P-tile, head, batch), 8 warps.  N is a multiple of 8 (NP
// its padding to 32, 64 or 128); x, B, C 16-byte aligned, their strides
// multiples of 8 elements.  P past the tile's last column reads zeros and
// writes nothing.
template <int NP>
__global__ void __launch_bounds__(kTcThreads, TcLayout<NP>::kMinBlocks)
    ssd_scan_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const bf16* __restrict__ Bm,
                       const bf16* __restrict__ Cm,
                       const float* __restrict__ h0, bf16* __restrict__ y,
                       float* __restrict__ hout, int S, int H, int P, int G,
                       int N, int Q, int n_c, Strides xs_, Strides dts_,
                       Strides bs_, Strides cs_, Strides ys_) {
  using L = TcLayout<NP>;
  constexpr int PT = kTcPT;
  constexpr int MT = PT / 16;         // m16 tiles of the state's rows
  constexpr int WPM = kTcWarps / MT;  // warps on one m16 tile (update)
  constexpr int NPW = NP / 8 / WPM;   // n8 blocks of the state a warp
  static_assert(NPW == 1 || NPW % 2 == 0, "one n8 block or pairs a warp");
  constexpr int KN = NP / 16;         // k16 steps over N
  constexpr int NB = PT / 8;          // n8 blocks of a warp's y rows
  constexpr int XC = PT / 8, BC = NP / 8;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* shs = reinterpret_cast<bf16*>(smem_raw + 2 * L::kStage);  // hi
  bf16* shl = shs + PT * NP;                                        // lo
  float* scs2 = reinterpret_cast<float*>(shl + PT * NP);  // cumsum * log2e
  float* sdt = scs2 + kQMax;                              // dt

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (H / G);
  const float a = A[h];
  const int Qp = (Q + 15) & ~15;  // rows computed, zero past Q
  const bf16* xp = x + b * xs_.b + h * xs_.h + p0;
  const float* dtp = dt + b * dts_.b + h * dts_.h;
  const bf16* bp = Bm + b * bs_.b + grp * bs_.h;
  const bf16* cp = Cm + b * cs_.b + grp * cs_.h;
  bf16* yp = y + b * ys_.b + h * ys_.h + p0;
  const long long state0 = ((long long)b * H + h) * P * N;

  auto sx = [&](int st) {
    return reinterpret_cast<bf16*>(smem_raw + st * L::kStage);
  };
  auto sb = [&](int st) { return sx(st) + L::kX; };
  auto sc = [&](int st) { return sx(st) + L::kX + L::kBC; };

  // chunk c's x, B and C into stage st, zero past Q, S, P and N
  auto load_chunk = [&](int c, int st) {
    const int t0 = c * Q;
    bf16 *dx = sx(st), *db = sb(st), *dc = sc(st);
    for (int i = threadIdx.x; i < Qp * XC; i += kTcThreads) {
      const int r = i / XC, ch = i % XC, tt = t0 + r;
      const bool ok = r < Q && tt < S && p0 + ch * 8 < P;
      tc::cp_async16(dx + tc::swz<PT>(r, ch),
                     ok ? xp + (long long)tt * xs_.s + ch * 8 : xp,
                     ok ? 16 : 0);
    }
    for (int i = threadIdx.x; i < Qp * BC; i += kTcThreads) {
      const int r = i / BC, ch = i % BC, tt = t0 + r;
      const bool ok = r < Q && tt < S && ch * 8 < N;
      tc::cp_async16(db + tc::swz<NP>(r, ch),
                     ok ? bp + (long long)tt * bs_.s + ch * 8 : bp,
                     ok ? 16 : 0);
      tc::cp_async16(dc + tc::swz<NP>(r, ch),
                     ok ? cp + (long long)tt * cs_.s + ch * 8 : cp,
                     ok ? 16 : 0);
    }
  };

  // warp 0 alone reads dt: lane l's 4 values of chunk c (rows 4l .. 4l +
  // 3, zero past Q and S) into its registers, a chunk ahead of their use
  auto load_dt = [&](int c, float (&d)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * lane + e, tt = c * Q + i;
      d[e] = i < Q && tt < S ? dtp[(long long)tt * dts_.s] : 0.f;
    }
  };

  // warp 0: the inclusive cumsum of dt * A over a chunk (in log2 units)
  // and its dt into shared memory; scs2[kQMax - 1] is cs_end
  auto scan = [&](const float (&d)[4]) {
    float v[4], run = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      run += __fmul_rn(d[e], a);
      v[e] = run;
    }
    float tot = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, tot, off);
      if (lane >= off) tot += o;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      scs2[4 * lane + e] = (tot - run + v[e]) * kLog2e;
      sdt[4 * lane + e] = d[e];
    }
  };

  // this warp's slice of the state: rows 16 mt + g (+ 8) of the tile,
  // columns 8 (nb0 + j) + 2t (+ 1); f32, never rounded
  const int mt = warp / WPM, nb0 = (warp % WPM) * NPW;
  float hr[NPW][4];
#pragma unroll
  for (int j = 0; j < NPW; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = p0 + mt * 16 + g + 8 * r, n = (nb0 + j) * 8 + 2 * t;
      float2 v = make_float2(0.f, 0.f);
      if (h0 != nullptr && p < P && n < N)
        v = *reinterpret_cast<const float2*>(h0 + state0 +
                                             (long long)p * N + n);
      hr[j][2 * r] = v.x;
      hr[j][2 * r + 1] = v.y;
    }
  // its hi and lo bf16 copies, which y_inter reads
  auto write_hs = [&]() {
#pragma unroll
    for (int j = 0; j < NPW; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int o = tc::swz<NP>(mt * 16 + g + 8 * r, nb0 + j) + 2 * t;
        tc::split_bf16(hr[j][2 * r], hr[j][2 * r + 1],
                       *reinterpret_cast<uint32_t*>(shs + o),
                       *reinterpret_cast<uint32_t*>(shl + o));
      }
  };

  write_hs();
  load_chunk(0, 0);
  tc::cp_async_commit();
  if (n_c > 1) load_chunk(1, 1);
  tc::cp_async_commit();
  float dn[4];  // warp 0: dt of the next chunk to scan
  if (warp == 0) {
    load_dt(0, dn);
    scan(dn);
    if (n_c > 1) load_dt(1, dn);  // in flight through chunk 0
  }
  tc::cp_async_wait<1>();
  __syncthreads();  // chunk 0 landed, its cumsum written

  for (int c = 0; c < n_c; ++c) {
    const int st = c & 1, t0 = c * Q;
    const bf16 *cx = sx(st), *cb = sb(st), *cc = sc(st);

    if (warp * 16 < Qp) {  // y for rows 16 warp .. + 15
      const int i0 = warp * 16 + g, i1 = i0 + 8;
      float acc[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      // y_inter = exp(cs_i) (C h^T)_i, h as its hi and lo copies; C's A
      // fragments are read where used (registers are the scarcer)
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        uint32_t ca[4];
        tc::load_a<NP>(ca, cc, warp * 16, kk * 16);
#pragma unroll
        for (int np = 0; np < PT / 16; ++np) {
          uint32_t bh[4];
          tc::load_b_nk<NP>(bh, shs, np * 16, kk * 16);
          tc::mma(acc[2 * np], ca, bh[0], bh[1]);
          tc::mma(acc[2 * np + 1], ca, bh[2], bh[3]);
          tc::load_b_nk<NP>(bh, shl, np * 16, kk * 16);
          tc::mma(acc[2 * np], ca, bh[0], bh[1]);
          tc::mma(acc[2 * np + 1], ca, bh[2], bh[3]);
        }
      }
      const float c2a = scs2[i0], c2b = scs2[i1];
      const float ea = exp2_approx(c2a), eb = exp2_approx(c2b);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        acc[n][0] *= ea;
        acc[n][1] *= ea;
        acc[n][2] *= eb;
        acc[n][3] *= eb;
      }
      // y_intra, one 16-column tile of M = C B^T o L o dt at a time
      for (int jt = 0; jt <= warp; ++jt) {
        float s[2][4];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[q][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
          uint32_t ca[4], bb[4];
          tc::load_a<NP>(ca, cc, warp * 16, kk * 16);
          tc::load_b_nk<NP>(bb, cb, jt * 16, kk * 16);
          tc::mma(s[0], ca, bb[0], bb[1]);
          tc::mma(s[1], ca, bb[2], bb[3]);
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int j = jt * 16 + q * 8 + 2 * t;
          const float2 cj = *reinterpret_cast<const float2*>(scs2 + j);
          const float2 dj = *reinterpret_cast<const float2*>(sdt + j);
          s[q][0] = j <= i0 ? s[q][0] * exp2_approx(c2a - cj.x) * dj.x : 0.f;
          s[q][1] =
              j + 1 <= i0 ? s[q][1] * exp2_approx(c2a - cj.y) * dj.y : 0.f;
          s[q][2] = j <= i1 ? s[q][2] * exp2_approx(c2b - cj.x) * dj.x : 0.f;
          s[q][3] =
              j + 1 <= i1 ? s[q][3] * exp2_approx(c2b - cj.y) * dj.y : 0.f;
        }
        uint32_t mh[4], ml[4];  // M as hi + lo bf16: two products
        tc::pack_a_split(mh, ml, s[0], s[1]);
#pragma unroll
        for (int np = 0; np < PT / 16; ++np) {
          uint32_t bx[4];
          tc::load_b_kn<PT>(bx, cx, jt * 16, np * 16);
          tc::mma(acc[2 * np], mh, bx[0], bx[1]);
          tc::mma(acc[2 * np + 1], mh, bx[2], bx[3]);
          tc::mma(acc[2 * np], ml, bx[0], bx[1]);
          tc::mma(acc[2 * np + 1], ml, bx[2], bx[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = (r ? i1 : i0), tt = t0 + i;
        if (i < Q && tt < S) {
          bf16* row = yp + (long long)tt * ys_.s + 2 * t;
#pragma unroll
          for (int n = 0; n < NB; ++n)
            if (p0 + n * 8 < P)
              *reinterpret_cast<uint32_t*>(row + n * 8) =
                  tc::pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
        }
      }
    }

    // the state update: h = exp(cs_end) h + (x o w)^T B
    {
      const float c2end = scs2[kQMax - 1];
      // w = dt exp(cs_end - cs) at rows k0 + 2t (+ 1) and k0 + 2t + 8 (+ 1)
      auto weights = [&](int k0) {
        const float2 c = *reinterpret_cast<const float2*>(scs2 + k0 + 2 * t);
        const float2 d = *reinterpret_cast<const float2*>(sdt + k0 + 2 * t);
        return make_float2(d.x * exp2_approx(c2end - c.x),
                           d.y * exp2_approx(c2end - c.y));
      };
      float u[NPW][4];
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) u[j][e] = 0.f;
      for (int kk = 0; kk < Qp / 16; ++kk) {
        uint32_t ax[4];
        tc::load_a_km<PT>(ax, cx, kk * 16, mt * 16);
        const float2 w0 = weights(kk * 16), w1 = weights(kk * 16 + 8);
        uint32_t xh[4], xl[4];  // x o w as hi + lo bf16: two products
        scale_split(ax[0], w0, xh[0], xl[0]);
        scale_split(ax[1], w0, xh[1], xl[1]);
        scale_split(ax[2], w1, xh[2], xl[2]);
        scale_split(ax[3], w1, xh[3], xl[3]);
        if constexpr (NPW == 1) {
          uint32_t b1[2];
          tc::load_b_kn1<NP>(b1, cb, kk * 16, nb0 * 8);
          tc::mma(u[0], xh, b1[0], b1[1]);
          tc::mma(u[0], xl, b1[0], b1[1]);
        } else {
#pragma unroll
          for (int jp = 0; jp < NPW / 2; ++jp) {
            uint32_t bb[4];
            tc::load_b_kn<NP>(bb, cb, kk * 16, (nb0 + 2 * jp) * 8);
            tc::mma(u[2 * jp], xh, bb[0], bb[1]);
            tc::mma(u[2 * jp + 1], xh, bb[2], bb[3]);
            tc::mma(u[2 * jp], xl, bb[0], bb[1]);
            tc::mma(u[2 * jp + 1], xl, bb[2], bb[3]);
          }
        }
      }
      const float decay = exp2_approx(c2end);
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hr[j][e] = fmaf(hr[j][e], decay, u[j][e]);
    }

    tc::cp_async_wait<0>();
    __syncthreads();  // chunk c read by all, chunk c + 1 landed
    write_hs();
    if (warp == 0 && c + 1 < n_c) {
      scan(dn);
      if (c + 2 < n_c) load_dt(c + 2, dn);  // in flight through chunk c + 1
    }
    if (c + 2 < n_c) load_chunk(c + 2, st);
    tc::cp_async_commit();
    __syncthreads();  // the state copy and chunk c + 1's cumsum written
  }

#pragma unroll
  for (int j = 0; j < NPW; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = p0 + mt * 16 + g + 8 * r, n = (nb0 + j) * 8 + 2 * t;
      if (p < P && n < N)
        *reinterpret_cast<float2*>(hout + state0 + (long long)p * N + n) =
            make_float2(hr[j][2 * r], hr[j][2 * r + 1]);
    }
}

using TcKernel = decltype(&ssd_scan_tc_kernel<64>);

// The instantiated paddings of N, in the order of reports.
constexpr int kTcNp[] = {32, 64, 128};
constexpr int kNumTcNp = sizeof(kTcNp) / sizeof(kTcNp[0]);

int padded_n(int N) { return N <= 32 ? 32 : N <= 64 ? 64 : 128; }

// The kernel for N padded to np (32, 64 or 128) and its shared memory.
TcKernel tc_kernel(int np, size_t* smem) {
  switch (np) {
    case 32: *smem = TcLayout<32>::kBytes; return ssd_scan_tc_kernel<32>;
    case 64: *smem = TcLayout<64>::kBytes; return ssd_scan_tc_kernel<64>;
    default: *smem = TcLayout<128>::kBytes; return ssd_scan_tc_kernel<128>;
  }
}

// Whether the kernel for np may launch: its shared-memory limit raised
// and at least one block a SM, queried once per kernel (so that launches
// captured into a CUDA graph make no other API call); false on a CUDA
// error.
bool tc_ready(int np) {
  static int n[kNumTcNp];
  static bool queried[kNumTcNp] = {};
  const int idx = np == 32 ? 0 : np == 64 ? 1 : 2;
  if (!queried[idx]) {
    size_t smem = 0;
    const TcKernel k = tc_kernel(np, &smem);
    if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n[idx], k, kTcThreads,
                                                      smem) != cudaSuccess)
      n[idx] = 0;
    queried[idx] = true;
  }
  return n[idx] > 0;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool launch_tc(const bf16* x, const float* dt, const float* A,
               const bf16* Bm, const bf16* Cm, const float* h0, bf16* y,
               float* hout, int Bsz, int S, int H, int P, int G, int N,
               int Q, Strides xs, Strides dts, Strides bs,
               Strides cs, Strides ys, cudaStream_t s) {
  if (N % 8 != 0 || !aligned16(x) || !aligned16(Bm) || !aligned16(Cm) ||
      xs.b % 8 || xs.s % 8 || xs.h % 8 || bs.b % 8 || bs.s % 8 || bs.h % 8 ||
      cs.b % 8 || cs.s % 8 || cs.h % 8)
    return false;
  const int np = padded_n(N);
  if (!tc_ready(np)) return false;
  size_t smem = 0;
  const TcKernel k = tc_kernel(np, &smem);
  const int n_c = (S + Q - 1) / Q;
  dim3 grid((P + kTcPT - 1) / kTcPT, H, Bsz);
  k<<<grid, kTcThreads, smem, s>>>(x, dt, A, Bm, Cm, h0, y, hout, S, H, P,
                                    G, N, Q, n_c, xs, dts, bs, cs, ys);
  return true;
}

}  // namespace

// x: (B, S, H, P); dt: (B, S, H) f32; A: (H,) f32; Bm, Cm: (B, S, G, N);
// x, Bm, Cm one dtype, bf16 (bf16 != 0) or f32, any strides with the last
// axis contiguous (the *_s* arguments are element strides); bf16 also
// needs x, Bm, Cm 16-byte aligned, their strides and N multiples of 8.
// h0: (B, H, P, N) f32 contiguous or null (zeros).  cb: f32 only, (B, G,
// ceil(S / Q), Q, Q) f32 scratch (bf16: unused, may be null).  y: (B, S,
// H, P) in x's dtype; hout: (B, H, P, N) f32 contiguous.  One launch on
// `stream` for bf16, two for f32.  Returns false (and launches nothing)
// for a shape or alignment it does not take: S, B < 1, Q
// outside 1..128, N outside 1..128, P not a multiple of 8, H not a
// multiple of G; errors of a launch are left to cudaGetLastError.
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
    return launch_tc(static_cast<const __nv_bfloat16*>(x), dt, A,
                     static_cast<const __nv_bfloat16*>(Bm),
                     static_cast<const __nv_bfloat16*>(Cm), h0,
                     static_cast<__nv_bfloat16*>(y), hout, Bsz, S, H, P, G, N,
                     Q, xs, dts, bs, cs, ys, s);
  if (cb == nullptr) return false;
  return launch_f32(static_cast<const float*>(x), dt, A,
                    static_cast<const float*>(Bm),
                    static_cast<const float*>(Cm), h0, cb,
                    static_cast<float*>(y), hout, Bsz, S, H, P, G, N, Q, xs,
                    dts, bs, cs, ys, s);
}

// Facts about the bf16 kernel for reports: idx 0, 1, 2 its instantiated
// paddings of N.  Writes the kernel's name and out[0..5]
// (tc::kernel_info).  Returns false past the last one or on a CUDA error.
extern "C" bool repro_ssd_info(int idx, const char** name, int* out) {
  if (idx < 0 || idx >= kNumTcNp) return false;
  static char buf[48];
  const int np = kTcNp[idx];
  size_t smem = 0;
  const TcKernel k = tc_kernel(np, &smem);
  snprintf(buf, sizeof buf, "ssd_scan_tc_kernel<%d>", np);
  *name = buf;
  return tc::kernel_info(k, kTcThreads, smem, out);
}
