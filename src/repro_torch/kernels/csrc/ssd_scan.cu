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
//
// The backward (repro_ssd_bwd) is the twin of autodiff of
// repro/kernels/ref.py::ssd_ref, which the JAX package trains through (jnp,
// no Pallas).  For a chunk, with H_c the state before it, Ĥ the cotangent
// of the state after it, dy the cotangent of y and e_j = exp(cs_Q - cs_j)
// (the formulas in full at ref.py's ssd_bwd_ref, this package's plain
// version):
//   Ĥ_c  = exp(cs_Q) Ĥ + sum_i exp(cs_i) dy_i C_i^T,  dinit = Ĥ_0
//   dx_j = dt_j [sum_i (C_i.B_j) L_ij dy_i + e_j Ĥ B_j]
//   dC_i = sum_j (dy_i.x_j) L_ij dt_j B_j + exp(cs_i) H_c^T dy_i
//   dB_j = dt_j [sum_i (dy_i.x_j) L_ij C_i + e_j Ĥ^T x_j]  (over the group)
//   ddt_j, dA from the cotangent of cs: row and column sums of
//   s_ij = (dy_i.x_j)(C_i.B_j) L_ij dt_j, the inter-chunk terms, and a
//   reverse cumsum over the chunk.
// Bound on the card.  At zamba2-1.2b's training shape (B=4, S=2048, H=64,
// P=64, N=64, bf16) x, dy, dx, dt, ddt, B, C, dB and dC once are about
// 210 MB, 63 us at HBM rate, above the 39 GFLOP of products (three times
// the forward's) at the bf16 peak: bytes.  At mamba2-130m's (H=24, N=128)
// 86 MB (26 us) and 26 GFLOP (26 us): the two meet.
//
// bf16 (the models' path): tensor cores (mma.sync.m16n8k16, bf16 in, f32
// sums), five launches:
//   1. ssd_bwd_state_tc_kernel<NP, fwd>: the forward scan's tiling and
//      state update, y skipped: one block per (head, batch) walks the
//      chunks with the f32 state in registers, (x o w)^T B as hi + lo
//      products, and writes the state before each chunk as hi and lo bf16
//      copies (B, H, n_chunks, 2, P, N): the operands the chunk kernels
//      read, as many bytes as f32;
//   2. the same in reverse: the cotangent Ĥ after each chunk from (dy o
//      exp(cs))^T C, likewise copied, d_init = the last one in f32, and w
//      = exp(cs_Q) <Ĥ_c, H_c> per chunk;
//   3. ssd_bwd_row_tc_kernel<NP>: one block per (chunk, block of heads of
//      one group, batch); warp w owns the chunk's rows 16w .. 16w + 15 and
//      walks the block's heads, dC of the group summed over them in its
//      registers: S1 = C B^T and S2 = dy x^T over the causal 16 x 16 tiles
//      only (exact: bf16 operands), M = S2 o L o dt as hi + lo A operands
//      from the f32 fragments (dC += M B), exp(cs) dy H_c against the
//      state's copies; the row and column sums of s = S1 o S2 o L o dt on
//      the fragments, fixed-order shuffles (a column's sums over the warps
//      through shared memory in warp order); per head it writes the row
//      sums less the column sums (with the inter-chunk t) and the column
//      sums of s / dt;
//   4. ssd_bwd_col_tc_kernel<NP>: the same grid, warp w owns columns j =
//      16w .. 16w + 15, the rows of dx and dB.  These sums run over i >= j,
//      so the kernel recomputes the transposed tiles B C^T and x dy^T
//      rather than staging S1 and S2 through shared memory (the forward's
//      choice of products over bytes; a 128 x 128 f32 tile and its hi and
//      lo copies would take the shared memory of two blocks): dx += (T1 o
//      L) dy and dB += (T2 o L o dt) C as hi + lo products, Ĥ B_j and Ĥ^T
//      x_j against Ĥ's copies; warp 0 forms dcs, its reverse cumsum
//      (shuffles in a fixed order), ddt and the chunk's share of dA.  It
//      walks the block's heads twice, dx, ddt and dA first, then dB of
//      the group summed in registers: with both sums live it needed ~180
//      registers and spilled at the 128 of two blocks a SM, so x, dy and
//      Ĥ's copies are read twice.  (Warp w does w + 1 causal tiles in the
//      row kernel and 8 - w in this one: each block waits on one warp, a
//      second pass's matter);
//   5. ssd_bwd_reduce_kernel<bf16>: the partials of dB and dC, one a block
//      of heads, summed over a group's blocks in order (at most H / G / 8
//      a group: an eighth of one a head or less; the wrapper asks
//      repro_ssd_bwd_slots for the count, the fewest waves of heads over
//      the card), and dA over (batch, chunk).
// Rounding (tests/test_torch_ssd_bwd_numerics.py emulates it): every
// tensor-core operand that is not bf16 already goes in as a hi + lo pair
// (M, T1 o L, T2 o L o dt, the states' copies, x o w and dy o exp(cs));
// the states themselves, every sum and ddt, dA, d_init stay f32; dx, dB
// and dC are rounded once.  Rounded once, M moved dB and dC past half the
// tolerance; a single copy of the states or of the passes' operands moved
// ddt and dA, which nothing rounds, a hundredfold.  The chunk kernels take
// P <= 64 (one 64-column tile of x, dy and the states); N is padded to 32,
// 64 or 128 (the instantiations) with zero fill.
//
// f32 (the 3e-4 sweeps against f64, which TF32 cannot meet; no main
// path): f32 FMAs on the CUDA cores, any N and alignment, four launches:
//   1. ssd_state_pass_kernel<float, fwd, NJ>: one block per (32 state rows,
//      head, batch) walks the chunks as the f32 forward does and writes H_c
//      for every chunk to an f32 (B, H, n_chunks, P, N) scratch;
//   2. the same kernel in reverse: Ĥ for every chunk to a second scratch,
//      and Ĥ_0 (dinit);
//   3. ssd_bwd_chunk_kernel<float>: one block per (chunk, head, batch),
//      fully parallel: (dy x^T) o L and (C B^T) o L as two 128 x 128 f32
//      tiles in shared memory (with the row and column sums of s on the
//      way), then dx, the dC and dB of this head and the terms of ddt from
//      32-wide slices staged through shared memory; writes dx and ddt,
//      and f32 partials of dB, dC (a head each) and of dA (a chunk each);
//   4. ssd_bwd_reduce_kernel<float>: the partials summed over the heads of
//      a group and over (batch, chunk), in a fixed order.
// No float atomics in either: every sum has a fixed order, so the bits do
// not depend on the run.
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


// ---------------------------------------------------------------------------
// The f32 backward on the CUDA cores (see the head of the file for the
// formulas and the design)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// Warp 0: cs[i] = sum_{s <= i} dts[s] * a over kQMax entries (4 a lane,
// then a shuffle scan), rounded the same way in every backward kernel (no
// contraction into FMAs), so that they agree bit for bit.
__device__ __forceinline__ void chunk_cumsum(const float* dts, float* cs,
                                             float a, int lane) {
  float v[4], run = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    run = __fadd_rn(run, __fmul_rn(dts[4 * lane + e], a));
    v[e] = run;
  }
  float tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot = __fadd_rn(tot, o);
  }
  const float before = __fsub_rn(tot, run);
#pragma unroll
  for (int e = 0; e < 4; ++e) cs[4 * lane + e] = __fadd_rn(before, v[e]);
}

// The sum over the 16 lanes of a half warp (tx = lane % 16), in a fixed
// order.
__device__ __forceinline__ float half_sum16(float v) {
#pragma unroll
  for (int m = 8; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

constexpr int kSpPT = 32;               // state rows a block
constexpr int kSpRows = kSpPT / 8;      // rows a thread (8 warps)

size_t state_pass_smem(int Q, int N) {
  return sizeof(float) * (size_t)(3 * kQMax + Q * kSpPT + Q * N);
}

// The state passes, one block per (32 state rows, head, batch), walking the
// chunks in order (forward) or in reverse, the (32, N) slice of the f32
// state in registers: warp w holds rows w + 8 r (r < 4), lane l columns
// l + 32 j (j < NJ: 2 for N <= 64, else 4), so a step of the update
// reads 4 broadcast values of x (or dy) and NJ of B (or C) for 4 NJ FMAs.
// (A one-column instantiation for N <= 32 spilled under ptxas: such N
// takes the two-column one.)  Per chunk,
// before the update, the state is written to buf[b, h, c]; then
//   forward: H <- exp(cs_Q) H + sum_j dt_j exp(cs_Q - cs_j) x_j B_j^T
//            (u = x, v = B, s0 = the initial state or null);
//   reverse: G <- exp(cs_Q) G + sum_i exp(cs_i) dy_i C_i^T
//            (u = dy, v = C, s0 = the final state's cotangent or null),
//            and the last G (the initial state's cotangent) to s_out.
template <typename T, bool kRev, int NJ>
__global__ void __launch_bounds__(kThreads)
    ssd_state_pass_kernel(const T* __restrict__ u, const T* __restrict__ v,
                          const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const float* __restrict__ s0,
                          float* __restrict__ buf, float* __restrict__ s_out,
                          int S, int H, int P, int G, int N, int Q, int n_c,
                          Strides us_, Strides vs_, Strides dts_) {
  extern __shared__ float smem[];
  float* dts = smem;                  // [kQMax] dt, 0 past Q and S
  float* cs = dts + kQMax;            // [kQMax] inclusive cumsum of dt * A
  float* wt = cs + kQMax;             // [kQMax] the weights of the update
  float* su = wt + kQMax;             // [Q][kSpPT] x or dy
  float* sv = su + Q * kSpPT;         // [Q][N] B or C
  const int p0 = blockIdx.x * kSpPT, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (H / G);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float a = A[h];
  const T* up = u + b * us_.b + h * us_.h + p0;
  const T* vp = v + b * vs_.b + grp * vs_.h;
  const float* dtp = dt + b * dts_.b + h * dts_.h;
  const long long state0 = ((long long)b * H + h) * P * N;
  const long long chunk0 = ((long long)b * H + h) * n_c;

  // this thread's rows p0 + warp + 8 r and columns lane + 32 j
  auto inside = [&](int r, int j) {
    return p0 + warp + 8 * r < P && lane + 32 * j < N;
  };
  auto at = [&](int r, int j) {
    return (long long)(p0 + warp + 8 * r) * N + lane + 32 * j;
  };
  float st[kSpRows][NJ];
#pragma unroll
  for (int r = 0; r < kSpRows; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      st[r][j] = inside(r, j) && s0 != nullptr ? s0[state0 + at(r, j)] : 0.f;

  for (int it = 0; it < n_c; ++it) {
    const int c = kRev ? n_c - 1 - it : it, t0 = c * Q;
    __syncthreads();  // the previous chunk is done with every buffer
    if (tid < kQMax) {
      const int t = t0 + tid;
      dts[tid] = tid < Q && t < S ? dtp[(long long)t * dts_.s] : 0.f;
    }
    for (int e = tid; e < Q * kSpPT; e += kThreads) {
      const int i = e / kSpPT, pp = e % kSpPT, t = t0 + i;
      su[e] = t < S && p0 + pp < P ? to_f(up[(long long)t * us_.s + pp])
                                   : 0.f;
    }
    for (int e = tid; e < Q * N; e += kThreads) {
      const int i = e / N, n = e % N, t = t0 + i;
      sv[e] = t < S ? to_f(vp[(long long)t * vs_.s + n]) : 0.f;
    }
    __syncthreads();
    if (warp == 0) chunk_cumsum(dts, cs, a, lane);
    __syncthreads();
    const float cend = cs[Q - 1];
    if (tid < Q) wt[tid] = kRev ? expf(cs[tid])
                                : dts[tid] * expf(cend - cs[tid]);
    __syncthreads();
    float* bp = buf + (chunk0 + c) * P * N;
    float acc[kSpRows][NJ];
#pragma unroll
    for (int r = 0; r < kSpRows; ++r)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (inside(r, j)) bp[at(r, j)] = st[r][j];
        acc[r][j] = 0.f;
      }
    // columns past N read row i's next values: finite, and never stored
    const int lim = Q * N - 1;
    for (int i = 0; i < Q; ++i) {
      const float w = wt[i];
      float uv[kSpRows], vv[NJ];
#pragma unroll
      for (int r = 0; r < kSpRows; ++r)
        uv[r] = w * su[i * kSpPT + warp + 8 * r];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        vv[j] = sv[min(i * N + lane + 32 * j, lim)];
#pragma unroll
      for (int r = 0; r < kSpRows; ++r)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          acc[r][j] = fmaf(uv[r], vv[j], acc[r][j]);
    }
    const float decay = expf(cend);
#pragma unroll
    for (int r = 0; r < kSpRows; ++r)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        st[r][j] = fmaf(st[r][j], decay, acc[r][j]);
  }
  if (s_out != nullptr) {
#pragma unroll
    for (int r = 0; r < kSpRows; ++r)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (inside(r, j)) s_out[state0 + at(r, j)] = st[r][j];
  }
}

constexpr int kCT = 32;          // width of a staged slice
constexpr int kLdS = kCT + 1;    // its row stride (floats)
constexpr int kLdQ = kQMax + 1;  // the row stride of the Q x Q tiles

// Shared memory of the chunk kernel (floats): the two Q x Q tiles, two
// staged (Q, 32) slices, one (32, 32) slice of a state, nine per-row
// vectors, a reduction scratch.  170.75 KB: one block a SM.
constexpr int kChunkSmemFloats =
    2 * kQMax * kLdQ + 2 * kQMax * kLdS + kCT * kLdS + 9 * kQMax + 32;

// One block per (chunk, head, batch), 256 threads as 16 x 16 (ty, tx);
// each thread owns rows ty + 16 r of a 128-row output and columns tx +
// 16 q.  Hs, Gs: the state before the chunk and the cotangent of the state
// after it (the state passes' buffers).  Writes dx, ddt and this head's
// partials of dB and dC ((B, S, H, N) f32) and of dA ((B, H, n_c) f32).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ A,
                         const T* __restrict__ Bm, const T* __restrict__ Cm,
                         const T* __restrict__ dy,
                         const float* __restrict__ hs,
                         const float* __restrict__ gs, T* __restrict__ dx,
                         float* __restrict__ ddt, float* __restrict__ db_part,
                         float* __restrict__ dc_part,
                         float* __restrict__ da_part, int S, int H, int P,
                         int G, int N, int Q, int n_c, Strides xs_,
                         Strides dts_, Strides bs_, Strides cs_,
                         Strides dys_) {
  extern __shared__ float smem[];
  float* s1 = smem;                   // [kQMax][kLdQ] (C B^T) o L
  float* s2 = s1 + kQMax * kLdQ;      // [kQMax][kLdQ] (dy x^T) o L
  float* sa = s2 + kQMax * kLdQ;      // [kQMax][kLdS] staged slice
  float* sb = sa + kQMax * kLdS;      // [kQMax][kLdS] staged slice
  float* sh = sb + kQMax * kLdS;      // [kCT][kLdS] slice of Hs or Gs
  float* dts = sh + kCT * kLdS;       // [kQMax] dt, 0 past Q and S
  float* cs = dts + kQMax;            // [kQMax] inclusive cumsum of dt * A
  float* ecs = cs + kQMax;            // [kQMax] exp(cs_i)
  float* eend = ecs + kQMax;          // [kQMax] exp(cs_Q - cs_j)
  float* rsum = eend + kQMax;         // [kQMax] sum_j s_ij
  float* csum = rsum + kQMax;         // [kQMax] sum_i s_ij
  float* dti = csum + kQMax;          // [kQMax] sum_i s_ij / dt_j
  float* tk = dti + kQMax;            // [kQMax] t_k
  float* xv = tk + kQMax;             // [kQMax] x_j^T G B_j
  float* red = xv + kQMax;            // [32] reduction scratch

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (H / G), t0 = c * Q;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ty = tid / 16, tx = tid % 16;
  const float a = A[h];
  const T* xp = x + b * xs_.b + h * xs_.h;
  const T* dyp = dy + b * dys_.b + h * dys_.h;
  const T* bp = Bm + b * bs_.b + grp * bs_.h;
  const T* cp = Cm + b * cs_.b + grp * cs_.h;
  const float* dtp = dt + b * dts_.b + h * dts_.h;
  const long long sidx = (((long long)b * H + h) * n_c + c) * P * N;
  const float* hsp = hs + sidx;
  const float* gsp = gs + sidx;

  if (tid < kQMax) {
    const int t = t0 + tid;
    dts[tid] = tid < Q && t < S ? dtp[(long long)t * dts_.s] : 0.f;
  }
  __syncthreads();
  if (warp == 0) chunk_cumsum(dts, cs, a, lane);
  __syncthreads();
  const float cend = cs[Q - 1];
  if (tid < kQMax) {
    ecs[tid] = tid < Q ? expf(cs[tid]) : 0.f;
    eend[tid] = tid < Q ? expf(cend - cs[tid]) : 0.f;
  }

  // rows i (i < Q, token t0 + i < S) of a T tensor's (p or n) columns
  // c0 .. c0 + 31 into a staged slice, zero elsewhere
  auto stage = [&](float* dst, const T* src, long long row_stride, int c0,
                   int ncols, const float* scale) {
    for (int e = tid; e < kQMax * kCT; e += kThreads) {
      const int i = e / kCT, cc = e % kCT, t = t0 + i, col = c0 + cc;
      float v = 0.f;
      if (i < Q && t < S && col < ncols) {
        v = to_f(src[(long long)t * row_stride + col]);
        if (scale != nullptr) v *= scale[i];
      }
      dst[i * kLdS + cc] = v;
    }
  };
  // rows r0 .. r0 + 31 and columns c0 .. c0 + 31 of a (P, N) state
  auto stage_state = [&](const float* src, int r0, int c0) {
    for (int e = tid; e < kCT * kCT; e += kThreads) {
      const int rr = e / kCT, cc = e % kCT;
      const int p = r0 + rr, n = c0 + cc;
      sh[rr * kLdS + cc] = p < P && n < N ? src[(long long)p * N + n] : 0.f;
    }
  };

  // ---- the Q x Q tiles: s2 = (dy x^T) o L, then s1 = (C B^T) o L with
  // the sums of s = (dy.x)(C.B) L dt_j over rows and columns on the way
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
  for (int k0 = 0; k0 < P; k0 += kCT) {
    __syncthreads();
    stage(sa, dyp, dys_.s, k0, P, nullptr);
    stage(sb, xp, xs_.s, k0, P, nullptr);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kCT; ++kk) {
      float av[8], bv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) av[r] = sa[(ty + 16 * r) * kLdS + kk];
#pragma unroll
      for (int q = 0; q < 8; ++q) bv[q] = sb[(tx + 16 * q) * kLdS + kk];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = ty + 16 * r, j = tx + 16 * q;
      s2[i * kLdQ + j] =
          j <= i && i < Q ? acc[r][q] * expf(cs[i] - cs[j]) : 0.f;
      acc[r][q] = 0.f;
    }
  for (int k0 = 0; k0 < N; k0 += kCT) {
    __syncthreads();
    stage(sa, cp, cs_.s, k0, N, nullptr);
    stage(sb, bp, bs_.s, k0, N, nullptr);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kCT; ++kk) {
      float av[8], bv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) av[r] = sa[(ty + 16 * r) * kLdS + kk];
#pragma unroll
      for (int q = 0; q < 8; ++q) bv[q] = sb[(tx + 16 * q) * kLdS + kk];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
  }
  {
    float rp[8], cpart[8], dpart[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) cpart[q] = dpart[q] = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      rp[r] = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = ty + 16 * r, j = tx + 16 * q;
        float v1 = 0.f, sl = 0.f;
        if (j <= i && i < Q) {
          v1 = acc[r][q] * expf(cs[i] - cs[j]);
          sl = acc[r][q] * s2[i * kLdQ + j];  // (C.B)(dy.x) L
        }
        s1[i * kLdQ + j] = v1;
        const float sd = sl * dts[j];
        rp[r] += sd;
        cpart[q] += sd;
        dpart[q] += sl;
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float v = half_sum16(rp[r]);
      if (tx == 0) rsum[ty + 16 * r] = v;
    }
    __syncthreads();  // the staged slices are free
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      sa[ty * kQMax + tx + 16 * q] = cpart[q];
      sb[ty * kQMax + tx + 16 * q] = dpart[q];
    }
    __syncthreads();
    if (tid < kQMax) {
      float s = 0.f, d = 0.f;
      for (int y = 0; y < 16; ++y) {
        s += sa[y * kQMax + tid];
        d += sb[y * kQMax + tid];
      }
      csum[tid] = s;
      dti[tid] = d;
    }
  }

  // ---- dx_j = dt_j [sum_i s1_ij dy_i + eend_j (G B_j)] and x_j^T G B_j
  {
    float xvp[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) xvp[r] = 0.f;
    for (int p0 = 0; p0 < P; p0 += kCT) {
      float ai[8][2], av[8][2];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 2; ++q) ai[r][q] = av[r][q] = 0.f;
      __syncthreads();
      stage(sa, dyp, dys_.s, p0, P, nullptr);
      __syncthreads();
      for (int i = 0; i < Q; ++i) {
        const float d0 = sa[i * kLdS + tx], d1 = sa[i * kLdS + tx + 16];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float sv = s1[i * kLdQ + ty + 16 * r];
          ai[r][0] = fmaf(sv, d0, ai[r][0]);
          ai[r][1] = fmaf(sv, d1, ai[r][1]);
        }
      }
      for (int n0 = 0; n0 < N; n0 += kCT) {
        __syncthreads();
        stage(sb, bp, bs_.s, n0, N, nullptr);
        stage_state(gsp, p0, n0);
        __syncthreads();
#pragma unroll 4
        for (int nn = 0; nn < kCT; ++nn) {
          const float h0v = sh[tx * kLdS + nn];
          const float h1v = sh[(tx + 16) * kLdS + nn];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float bv = sb[(ty + 16 * r) * kLdS + nn];
            av[r][0] = fmaf(bv, h0v, av[r][0]);
            av[r][1] = fmaf(bv, h1v, av[r][1]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int j = ty + 16 * r, t = t0 + j;
        if (j < Q && t < S) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int p = p0 + tx + 16 * q;
            if (p < P) {
              xvp[r] += to_f(xp[(long long)t * xs_.s + p]) * av[r][q];
              dx[b * dys_.b + (long long)t * dys_.s + h * dys_.h + p] =
                  from_f<T>(dts[j] * (ai[r][q] + eend[j] * av[r][q]));
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float v = half_sum16(xvp[r]);
      if (tx == 0) xv[ty + 16 * r] = v;
    }
  }

  // ---- dC_i = sum_j s2_ij dt_j B_j + ecs_i (Hs^T dy_i), and t_i
  {
    float tp[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) tp[r] = 0.f;
    for (int n0 = 0; n0 < N; n0 += kCT) {
      float ai[8][2], ah[8][2];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 2; ++q) ai[r][q] = ah[r][q] = 0.f;
      __syncthreads();
      stage(sb, bp, bs_.s, n0, N, dts);
      __syncthreads();
      for (int j = 0; j < Q; ++j) {
        const float b0 = sb[j * kLdS + tx], b1 = sb[j * kLdS + tx + 16];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float sv = s2[(ty + 16 * r) * kLdQ + j];
          ai[r][0] = fmaf(sv, b0, ai[r][0]);
          ai[r][1] = fmaf(sv, b1, ai[r][1]);
        }
      }
      for (int p0 = 0; p0 < P; p0 += kCT) {
        __syncthreads();
        stage(sa, dyp, dys_.s, p0, P, nullptr);
        stage_state(hsp, p0, n0);
        __syncthreads();
#pragma unroll 4
        for (int pp = 0; pp < kCT; ++pp) {
          const float h0v = sh[pp * kLdS + tx], h1v = sh[pp * kLdS + tx + 16];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float dv = sa[(ty + 16 * r) * kLdS + pp];
            ah[r][0] = fmaf(dv, h0v, ah[r][0]);
            ah[r][1] = fmaf(dv, h1v, ah[r][1]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = ty + 16 * r, t = t0 + i;
        if (i < Q && t < S) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int n = n0 + tx + 16 * q;
            if (n < N) {
              const float inter = ecs[i] * ah[r][q];
              dc_part[(((long long)b * S + t) * H + h) * N + n] =
                  ai[r][q] + inter;
              tp[r] += to_f(cp[(long long)t * cs_.s + n]) * inter;
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float v = half_sum16(tp[r]);
      if (tx == 0) tk[ty + 16 * r] = v;
    }
  }

  // ---- dB_j = dt_j [sum_i s2_ij C_i + eend_j (Gs^T x_j)]
  for (int n0 = 0; n0 < N; n0 += kCT) {
    float ai[8][2], ah[8][2];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 2; ++q) ai[r][q] = ah[r][q] = 0.f;
    __syncthreads();
    stage(sb, cp, cs_.s, n0, N, nullptr);
    __syncthreads();
    for (int i = 0; i < Q; ++i) {
      const float c0 = sb[i * kLdS + tx], c1 = sb[i * kLdS + tx + 16];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float sv = s2[i * kLdQ + ty + 16 * r];
        ai[r][0] = fmaf(sv, c0, ai[r][0]);
        ai[r][1] = fmaf(sv, c1, ai[r][1]);
      }
    }
    for (int p0 = 0; p0 < P; p0 += kCT) {
      __syncthreads();
      stage(sa, xp, xs_.s, p0, P, nullptr);
      stage_state(gsp, p0, n0);
      __syncthreads();
#pragma unroll 4
      for (int pp = 0; pp < kCT; ++pp) {
        const float h0v = sh[pp * kLdS + tx], h1v = sh[pp * kLdS + tx + 16];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float xv_ = sa[(ty + 16 * r) * kLdS + pp];
          ah[r][0] = fmaf(xv_, h0v, ah[r][0]);
          ah[r][1] = fmaf(xv_, h1v, ah[r][1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = ty + 16 * r, t = t0 + j;
      if (j < Q && t < S) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = n0 + tx + 16 * q;
          if (n < N)
            db_part[(((long long)b * S + t) * H + h) * N + n] =
                dts[j] * (ai[r][q] + eend[j] * ah[r][q]);
        }
      }
    }
  }

  // ---- w = exp(cs_Q) <Gs, Hs>, then dcs, its reverse cumsum, ddt, dA
  float wp = 0.f;
  for (int e = tid; e < P * N; e += kThreads) wp = fmaf(gsp[e], hsp[e], wp);
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) wp += __shfl_xor_sync(0xffffffffu, wp, m);
  if (lane == 0) red[warp] = wp;
  __syncthreads();
  if (tid == 0) {
    float w = 0.f, usum = 0.f;
    for (int k = 0; k < kThreads / 32; ++k) w += red[k];
    w *= expf(cend);
    for (int k = 0; k < Q; ++k) usum += eend[k] * dts[k] * xv[k];
    float run = 0.f, da = 0.f;
    for (int k = Q - 1; k >= 0; --k) {
      float dcs = rsum[k] - csum[k] + tk[k] - eend[k] * dts[k] * xv[k];
      if (k == Q - 1) dcs += usum + w;
      run += dcs;
      rsum[k] = run;  // now d(a)_k, the reverse cumsum
      da = fmaf(dts[k], run, da);
    }
    da_part[((long long)b * H + h) * n_c + c] = da;
  }
  __syncthreads();
  if (tid < Q && t0 + tid < S)
    ddt[((long long)b * S + t0 + tid) * H + h] =
        dti[tid] + eend[tid] * xv[tid] + a * rsum[tid];
}

// dB and dC: the partials ((B, S, HP, N) f32: HP / G a group, per head
// (f32) or per block of heads (bf16)) summed over each group in order,
// rounded once to T; dA: the per-(batch, chunk) partials summed in
// (batch, chunk) order.  A grid-stride loop.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_reduce_kernel(const float* __restrict__ db_part,
                          const float* __restrict__ dc_part,
                          const float* __restrict__ da_part,
                          T* __restrict__ dB, T* __restrict__ dC,
                          float* __restrict__ dA, int Bsz, int S, int H,
                          int HP, int G, int N, int n_c) {
  const long long nbc = (long long)Bsz * S * G * N;
  const int HG = HP / G;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < 2 * nbc + H; e += (long long)gridDim.x * blockDim.x) {
    if (e < 2 * nbc) {
      const bool is_c = e >= nbc;
      const long long o = is_c ? e - nbc : e;
      const int n = (int)(o % N);
      const long long row = o / N;  // (b * S + s) * G + g
      const int g = (int)(row % G);
      const float* src = (is_c ? dc_part : db_part) +
                         ((row / G) * HP + (long long)g * HG) * N + n;
      float sum = 0.f;
      for (int k = 0; k < HG; ++k) sum += src[(long long)k * N];
      (is_c ? dC : dB)[o] = from_f<T>(sum);
    } else {
      const int h = (int)(e - 2 * nbc);
      float sum = 0.f;
      for (int b = 0; b < Bsz; ++b)
        for (int c = 0; c < n_c; ++c)
          sum += da_part[((long long)b * H + h) * n_c + c];
      dA[h] = sum;
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 backward on the tensor cores (see the head of the file)
// ---------------------------------------------------------------------------

constexpr int kBwdPT = 64;  // columns of x and dy, rows of a state: P <= 64

// Warp 0: lane l's four dt values of chunk c (rows 4l .. 4l + 3, zero past
// Q and S).
__device__ __forceinline__ void load_dt4(const float* dtp, long long ds,
                                         int c, int Q, int S, int lane,
                                         float (&d)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = 4 * lane + e, tt = c * Q + i;
    d[e] = i < Q && tt < S ? dtp[(long long)tt * ds] : 0.f;
  }
}

// Warp 0: the inclusive cumsum of dt * a over a chunk in log2 units (the
// forward scan's arithmetic) and its dt into shared memory; scs2[kQMax -
// 1] is cs_end.
__device__ __forceinline__ void chunk_cs2(const float (&d)[4], float a,
                                          float* scs2, float* sdt,
                                          int lane) {
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
}

// The chunk's rows 0 .. Qp - 1 of a (token, column) bf16 matrix into a
// swizzled [kQMax][W] tile: token t0 + r for r < Q and t0 + r < S, columns
// below ncols; zeros elsewhere.
template <int W>
__device__ __forceinline__ void load_token_tile(bf16* dst, const bf16* src,
                                                long long row_stride, int t0,
                                                int Q, int S, int Qp,
                                                int ncols) {
  constexpr int CH = W / 8;
  for (int i = threadIdx.x; i < Qp * CH; i += kTcThreads) {
    const int r = i / CH, ch = i % CH, tt = t0 + r;
    const bool ok = r < Q && tt < S && ch * 8 < ncols;
    tc::cp_async16(dst + tc::swz<W>(r, ch),
                   ok ? src + (long long)tt * row_stride + ch * 8 : src,
                   ok ? 16 : 0);
  }
}

// One bf16 copy (hi or lo) of a (P, N) state, rows of N values, into a
// swizzled [kBwdPT][NP] tile, zeros past P and N.
template <int NP>
__device__ __forceinline__ void load_state_tile(bf16* dst, const bf16* src,
                                                int P, int N) {
  constexpr int CH = NP / 8;
  for (int i = threadIdx.x; i < kBwdPT * CH; i += kTcThreads) {
    const int r = i / CH, ch = i % CH;
    const bool ok = r < P && ch * 8 < N;
    tc::cp_async16(dst + tc::swz<NP>(r, ch),
                   ok ? src + (long long)r * N + ch * 8 : src, ok ? 16 : 0);
  }
}

// Two bf16 values of a swizzled [rows][W] tile at (r, c), c even, as f32.
template <int W>
__device__ __forceinline__ float2 tile_pair(const bf16* tile, int r, int c) {
  __nv_bfloat162 v;
  memcpy(&v, tile + tc::swz<W>(r, c >> 3) + (c & 7), sizeof v);
  return __bfloat1622float2(v);
}

// Shared memory of the state passes for N padded to NP: two stages of {u
// [kQMax][kBwdPT], v [kQMax][NP]} and, in reverse, the forward pass's hi
// and lo copies of H_c [kBwdPT][NP] (bf16, swizzled), then the chunk's
// cumsum and dt (f32 [kQMax] each) and a reduction scratch: 66 / 98 KB
// (forward / reverse) at NP = 64, 97 / 161 KB at NP = 128.
template <int NP, bool kRev>
struct BwdStateLayout {
  static constexpr int kU = kQMax * kBwdPT;  // bf16 elements
  static constexpr int kV = kQMax * NP;
  static constexpr int kH = kRev ? kBwdPT * NP : 0;
  static constexpr size_t kStage = sizeof(bf16) * (kU + kV + 2 * kH);
  static constexpr size_t kBytes =
      2 * kStage + sizeof(float) * (2 * kQMax + kTcWarps);
  // two blocks a SM up to N 64, where a batch's heads (zamba2-1.2b: 256
  // blocks) fill the card twice; one at N 128, whose state and update
  // (64 f32 registers each) do not fit 128 registers
  static constexpr int kMinBlocks = NP <= 64 ? 2 : 1;
};

// The state passes on the tensor cores, the forward scan's tiling and
// state update: one block per (head, batch) holds the (P, N) f32 state in
// registers and walks the chunks, in order (forward) or in reverse.
// Before each chunk's update it writes the state to buf[b, h, c] as hi
// and lo bf16 copies ((B, H, n_c, 2, P, N)); then
//   forward: H <- exp(cs_Q) H + (x o w)^T B,  w_j = dt_j exp(cs_Q - cs_j)
//            (u = x, v = B, s0 = the initial state or null);
//   reverse: Ĥ <- exp(cs_Q) Ĥ + (dy o exp(cs))^T C
//            (u = dy, v = C, s0 = the final state's cotangent or null),
// with u o w as hi + lo bf16 A operands.  The reverse pass also writes
// w_c = exp(cs_Q) <Ĥ_c, H_c> to wpart[b, h, c] (H_c from hbuf, the
// forward pass's copies, which arrive with the chunk's u and v) and the
// last Ĥ (the initial state's cotangent) to s_out.
template <int NP, bool kRev>
__global__ void __launch_bounds__(kTcThreads,
                                  BwdStateLayout<NP, kRev>::kMinBlocks)
    ssd_bwd_state_tc_kernel(const bf16* __restrict__ u,
                            const bf16* __restrict__ v,
                            const float* __restrict__ dt,
                            const float* __restrict__ A,
                            const float* __restrict__ s0,
                            const bf16* __restrict__ hbuf,
                            bf16* __restrict__ buf, float* __restrict__ wpart,
                            float* __restrict__ s_out, int S, int H, int P,
                            int G, int N, int Q, int n_c, Strides us_,
                            Strides vs_, Strides dts_) {
  using L = BwdStateLayout<NP, kRev>;
  constexpr int PT = kBwdPT;
  constexpr int MT = PT / 16;         // m16 tiles of the state's rows
  constexpr int WPM = kTcWarps / MT;  // warps on one m16 tile
  constexpr int NPW = NP / 8 / WPM;   // n8 blocks of the state a warp
  static_assert(NPW % 2 == 0, "pairs of n8 blocks a warp");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* scs2 = reinterpret_cast<float*>(smem_raw + 2 * L::kStage);
  float* sdt = scs2 + kQMax;
  float* red = sdt + kQMax;  // [kTcWarps]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (H / G);
  const float a = A[h];
  const int Qp = (Q + 15) & ~15;
  const bf16* up = u + b * us_.b + h * us_.h;
  const bf16* vp = v + b * vs_.b + grp * vs_.h;
  const float* dtp = dt + b * dts_.b + h * dts_.h;
  const long long state0 = ((long long)b * H + h) * P * N;
  const long long chunk0 = ((long long)b * H + h) * n_c;
  auto su = [&](int st) {
    return reinterpret_cast<bf16*>(smem_raw + st * L::kStage);
  };
  auto sv = [&](int st) { return su(st) + L::kU; };
  auto sh = [&](int st) { return sv(st) + L::kV; };  // H_c hi, then lo
  auto chunk_at = [&](int it) { return kRev ? n_c - 1 - it : it; };
  auto load_chunk = [&](int it, int st) {
    const int c = chunk_at(it);
    load_token_tile<PT>(su(st), up, us_.s, c * Q, Q, S, Qp, P);
    load_token_tile<NP>(sv(st), vp, vs_.s, c * Q, Q, S, Qp, N);
    if constexpr (kRev) {
      const bf16* hp = hbuf + (chunk0 + c) * 2 * P * N;
      load_state_tile<NP>(sh(st), hp, P, N);
      load_state_tile<NP>(sh(st) + L::kH, hp + (long long)P * N, P, N);
    }
  };

  // this warp's slice: rows 16 mt + g (+ 8), columns 8 (nb0 + j) + 2t (+ 1)
  const int mt = warp / WPM, nb0 = (warp % WPM) * NPW;
  float hr[NPW][4];
#pragma unroll
  for (int j = 0; j < NPW; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = mt * 16 + g + 8 * r, n = (nb0 + j) * 8 + 2 * t;
      float2 s = make_float2(0.f, 0.f);
      if (s0 != nullptr && p < P && n < N)
        s = *reinterpret_cast<const float2*>(s0 + state0 +
                                             (long long)p * N + n);
      hr[j][2 * r] = s.x;
      hr[j][2 * r + 1] = s.y;
    }

  load_chunk(0, 0);
  tc::cp_async_commit();
  if (n_c > 1) load_chunk(1, 1);
  tc::cp_async_commit();
  float dn[4];  // warp 0: dt of the next chunk to scan
  if (warp == 0) {
    load_dt4(dtp, dts_.s, chunk_at(0), Q, S, lane, dn);
    chunk_cs2(dn, a, scs2, sdt, lane);
    if (n_c > 1) load_dt4(dtp, dts_.s, chunk_at(1), Q, S, lane, dn);
  }
  tc::cp_async_wait<1>();
  __syncthreads();  // chunk 0 landed, its cumsum written

#pragma unroll 1
  for (int it = 0; it < n_c; ++it) {
    const int st = it & 1, c = chunk_at(it);
    const bf16 *cu = su(st), *cv = sv(st);
    const float c2end = scs2[kQMax - 1];
    // the state at the chunk's start (forward) or end (reverse), as hi and
    // lo copies
    {
      bf16* hi = buf + (chunk0 + c) * 2 * P * N;
      bf16* lo = hi + (long long)P * N;
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = mt * 16 + g + 8 * r, n = (nb0 + j) * 8 + 2 * t;
          if (p < P && n < N) {
            const long long o = (long long)p * N + n;
            uint32_t vh, vl;
            tc::split_bf16(hr[j][2 * r], hr[j][2 * r + 1], vh, vl);
            *reinterpret_cast<uint32_t*>(hi + o) = vh;
            *reinterpret_cast<uint32_t*>(lo + o) = vl;
          }
        }
    }
    // the reverse pass's share of <Ĥ, H_c> (both zero past P and N)
    if constexpr (kRev) {
      float wsum = 0.f;
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = mt * 16 + g + 8 * r, n = (nb0 + j) * 8 + 2 * t;
          const float2 fa = tile_pair<NP>(sh(st), p, n);
          const float2 fb = tile_pair<NP>(sh(st) + L::kH, p, n);
          wsum += hr[j][2 * r] * (fa.x + fb.x) +
                  hr[j][2 * r + 1] * (fa.y + fb.y);
        }
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1)
        wsum += __shfl_xor_sync(0xffffffffu, wsum, m);
      if (lane == 0) red[warp] = wsum;
    }
    // the update: state = exp(cs_end) state + (u o w)^T v
    {
      // w at rows k0 + 2t (+ 1) and k0 + 2t + 8 (+ 1)
      auto weights = [&](int k0) {
        const float2 cc = *reinterpret_cast<const float2*>(scs2 + k0 + 2 * t);
        if constexpr (kRev) {
          return make_float2(exp2_approx(cc.x), exp2_approx(cc.y));
        } else {
          const float2 d = *reinterpret_cast<const float2*>(sdt + k0 + 2 * t);
          return make_float2(d.x * exp2_approx(c2end - cc.x),
                             d.y * exp2_approx(c2end - cc.y));
        }
      };
      float acc[NPW][4];
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < Qp / 16; ++kk) {
        uint32_t ax[4];
        tc::load_a_km<PT>(ax, cu, kk * 16, mt * 16);
        const float2 w0 = weights(kk * 16), w1 = weights(kk * 16 + 8);
        uint32_t xh[4], xl[4];  // u o w as hi + lo bf16: two products
        scale_split(ax[0], w0, xh[0], xl[0]);
        scale_split(ax[1], w0, xh[1], xl[1]);
        scale_split(ax[2], w1, xh[2], xl[2]);
        scale_split(ax[3], w1, xh[3], xl[3]);
#pragma unroll
        for (int jp = 0; jp < NPW / 2; ++jp) {
          uint32_t bb[4];
          tc::load_b_kn<NP>(bb, cv, kk * 16, (nb0 + 2 * jp) * 8);
          tc::mma(acc[2 * jp], xh, bb[0], bb[1]);
          tc::mma(acc[2 * jp + 1], xh, bb[2], bb[3]);
          tc::mma(acc[2 * jp], xl, bb[0], bb[1]);
          tc::mma(acc[2 * jp + 1], xl, bb[2], bb[3]);
        }
      }
      const float decay = exp2_approx(c2end);
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hr[j][e] = fmaf(hr[j][e], decay, acc[j][e]);
    }

    tc::cp_async_wait<0>();
    __syncthreads();  // chunk it read by all, chunk it + 1 landed
    if constexpr (kRev) {
      if (threadIdx.x == 0) {
        float w = 0.f;
        for (int k = 0; k < kTcWarps; ++k) w += red[k];
        wpart[chunk0 + c] = exp2_approx(c2end) * w;
      }
    }
    if (warp == 0 && it + 1 < n_c) {
      chunk_cs2(dn, a, scs2, sdt, lane);
      if (it + 2 < n_c) load_dt4(dtp, dts_.s, chunk_at(it + 2), Q, S, lane, dn);
    }
    if (it + 2 < n_c) load_chunk(it + 2, st);
    tc::cp_async_commit();
    __syncthreads();  // chunk it + 1's cumsum written
  }

  if (s_out != nullptr) {
#pragma unroll
    for (int j = 0; j < NPW; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = mt * 16 + g + 8 * r, n = (nb0 + j) * 8 + 2 * t;
        if (p < P && n < N)
          *reinterpret_cast<float2*>(s_out + state0 + (long long)p * N + n) =
              make_float2(hr[j][2 * r], hr[j][2 * r + 1]);
      }
  }
}

// Shared memory of the chunk kernels for N padded to NP: the chunk's B and
// C [kQMax][NP], a head's x and dy [kQMax][kBwdPT] and its state's hi and
// lo copies [kBwdPT][NP] (bf16, swizzled), then f32 vectors: cumsum and dt
// [kQMax] each, and 2 kTcWarps + 2 rows of kQMax (the row kernel's column
// sums a warp and its row sums; the column kernel's r, colsum and x^T Ĥ B
// vectors).  90 KB at NP = 64 (two blocks a SM), 138 KB at NP = 128.
template <int NP>
struct BwdChunkLayout {
  static constexpr int kBC = kQMax * NP, kX = kQMax * kBwdPT;
  static constexpr int kSt = kBwdPT * NP;  // bf16 elements
  static constexpr size_t kTiles =
      sizeof(bf16) * (2 * (size_t)kBC + 2 * kX + 2 * kSt);
  static constexpr size_t kBytes =
      kTiles + sizeof(float) * (4 + 2 * kTcWarps) * kQMax;
  static constexpr int kMinBlocks = 2 * (kBytes + 1024) <= 233472 ? 2 : 1;
};

// Pointers into the chunk kernels' shared memory.
template <int NP>
struct BwdChunkSmem {
  bf16 *b, *c, *x, *dy, *hi, *lo;
  float *cs2, *dt, *vec;
  __device__ explicit BwdChunkSmem(unsigned char* raw) {
    using L = BwdChunkLayout<NP>;
    b = reinterpret_cast<bf16*>(raw);
    c = b + L::kBC;
    x = c + L::kBC;
    dy = x + L::kX;
    hi = dy + L::kX;
    lo = hi + L::kSt;
    cs2 = reinterpret_cast<float*>(lo + L::kSt);
    dt = cs2 + kQMax;
    vec = dt + kQMax;
  }
};

// The row kernel: one block per (chunk, hpb heads of one group, batch),
// 8 warps, warp w owning the chunk's rows i = 16w .. 16w + 15; the block
// walks its heads in order, summing their dC in registers:
//   dC_i += exp(cs_i) (dy_i H_c)  (the state's hi + lo copies, two
//           products; t_i = C_i . that term on the way)
//   for each 16-column tile j <= i: S2 = dy x^T and S1 = C B^T, exact;
//           s / dt_j = S1 o S2 o L summed over the row and, through
//           shared memory, over the column; M = S2 o L o dt_j as hi + lo
//           A operands: dC_i += M B.
// Per head it writes rvec = rowsum(s) + t - colsum(s) and dvec =
// colsum(s / dt) ((B, H, S) f32) for the column kernel; at the end the
// heads' dC sum to dc_part[b, t, slot] ((B, S, H / hpb, N) f32).
template <int NP>
__global__ void __launch_bounds__(kTcThreads, BwdChunkLayout<NP>::kMinBlocks)
    ssd_bwd_row_tc_kernel(const bf16* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const bf16* __restrict__ Bm,
                          const bf16* __restrict__ Cm,
                          const bf16* __restrict__ dy,
                          const bf16* __restrict__ hbuf,
                          float* __restrict__ dc_part,
                          float* __restrict__ rvec, float* __restrict__ dvec,
                          int S, int H, int P, int G, int N, int Q, int n_c,
                          int hpb, Strides xs_, Strides dts_, Strides bs_,
                          Strides cs_, Strides dys_) {
  constexpr int PT = kBwdPT;
  constexpr int NB = NP / 8;            // n8 blocks of dC
  constexpr int NH = NB < 8 ? NB : 8;   // of its inter-chunk term at once
  constexpr int KN = NP / 16, KP = PT / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BwdChunkSmem<NP> sm(smem_raw);
  float* scolL = sm.vec;                      // [kTcWarps][kQMax]
  float* srow = scolL + kTcWarps * kQMax;     // [kQMax]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c = blockIdx.x, b = blockIdx.z;
  const int h_first = blockIdx.y * hpb, grp = h_first / (H / G);
  const int t0 = c * Q, Qp = (Q + 15) & ~15, nT = Qp / 16;
  const int i0 = warp * 16 + g, i1 = i0 + 8;

  load_token_tile<NP>(sm.b, Bm + b * bs_.b + grp * bs_.h, bs_.s, t0, Q, S,
                      Qp, N);
  load_token_tile<NP>(sm.c, Cm + b * cs_.b + grp * cs_.h, cs_.s, t0, Q, S,
                      Qp, N);
  float dc[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dc[j][e] = 0.f;

#pragma unroll 1
  for (int k = 0; k < hpb; ++k) {
    const int h = h_first + k;
    if (k > 0) __syncthreads();  // the last head is done with every buffer
    load_token_tile<PT>(sm.x, x + b * xs_.b + h * xs_.h, xs_.s, t0, Q, S, Qp,
                        P);
    load_token_tile<PT>(sm.dy, dy + b * dys_.b + h * dys_.h, dys_.s, t0, Q,
                        S, Qp, P);
    const bf16* hp = hbuf + (((long long)b * H + h) * n_c + c) * 2 * P * N;
    load_state_tile<NP>(sm.hi, hp, P, N);
    load_state_tile<NP>(sm.lo, hp + (long long)P * N, P, N);
    tc::cp_async_commit();
    if (warp == 0) {
      float d[4];
      load_dt4(dt + b * dts_.b + h * dts_.h, dts_.s, c, Q, S, lane, d);
      chunk_cs2(d, A[h], sm.cs2, sm.dt, lane);
    }
    tc::cp_async_wait<0>();
    __syncthreads();

    if (warp < nT) {
      const float c2a = sm.cs2[i0], c2b = sm.cs2[i1];
      const float ea = exp2_approx(c2a), eb = exp2_approx(c2b);
      float tp0 = 0.f, tp1 = 0.f;  // t_i at rows i0, i1
      // dC_i += exp(cs_i) dy_i H_c, NH n8 blocks at a time
#pragma unroll
      for (int n0 = 0; n0 < NB; n0 += NH) {
        float tmp[NH][4];
#pragma unroll
        for (int j = 0; j < NH; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) tmp[j][e] = 0.f;
#pragma unroll 1
        for (int kk = 0; kk < KP; ++kk) {
          uint32_t ya[4];
          tc::load_a<PT>(ya, sm.dy, warp * 16, kk * 16);
#pragma unroll
          for (int np = 0; np < NH / 2; ++np) {
            uint32_t bh[4];
            tc::load_b_kn<NP>(bh, sm.hi, kk * 16, (n0 + 2 * np) * 8);
            tc::mma(tmp[2 * np], ya, bh[0], bh[1]);
            tc::mma(tmp[2 * np + 1], ya, bh[2], bh[3]);
            tc::load_b_kn<NP>(bh, sm.lo, kk * 16, (n0 + 2 * np) * 8);
            tc::mma(tmp[2 * np], ya, bh[0], bh[1]);
            tc::mma(tmp[2 * np + 1], ya, bh[2], bh[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          const int n = (n0 + j) * 8 + 2 * t;
          const float2 ca = tile_pair<NP>(sm.c, i0, n);
          const float2 cb = tile_pair<NP>(sm.c, i1, n);
          const float v0 = tmp[j][0] * ea, v1 = tmp[j][1] * ea;
          const float v2 = tmp[j][2] * eb, v3 = tmp[j][3] * eb;
          tp0 += ca.x * v0 + ca.y * v1;
          tp1 += cb.x * v2 + cb.y * v3;
          dc[n0 + j][0] += v0;
          dc[n0 + j][1] += v1;
          dc[n0 + j][2] += v2;
          dc[n0 + j][3] += v3;
        }
      }
      // the causal tiles j <= i
      float rs0 = 0.f, rs1 = 0.f;  // sum_j s_ij at rows i0, i1
#pragma unroll 1
      for (int jt = 0; jt <= warp; ++jt) {
        float s2[2][4], s1[2][4];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) s2[q][e] = s1[q][e] = 0.f;
#pragma unroll 2
        for (int kk = 0; kk < KP; ++kk) {  // S2 = dy x^T
          uint32_t ya[4], xb[4];
          tc::load_a<PT>(ya, sm.dy, warp * 16, kk * 16);
          tc::load_b_nk<PT>(xb, sm.x, jt * 16, kk * 16);
          tc::mma(s2[0], ya, xb[0], xb[1]);
          tc::mma(s2[1], ya, xb[2], xb[3]);
        }
#pragma unroll 2
        for (int kk = 0; kk < KN; ++kk) {  // S1 = C B^T
          uint32_t ca[4], bb[4];
          tc::load_a<NP>(ca, sm.c, warp * 16, kk * 16);
          tc::load_b_nk<NP>(bb, sm.b, jt * 16, kk * 16);
          tc::mma(s1[0], ca, bb[0], bb[1]);
          tc::mma(s1[1], ca, bb[2], bb[3]);
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int j = jt * 16 + q * 8 + 2 * t;
          const float2 cj = *reinterpret_cast<const float2*>(sm.cs2 + j);
          const float2 dj = *reinterpret_cast<const float2*>(sm.dt + j);
          const float l0 = j <= i0 ? exp2_approx(c2a - cj.x) : 0.f;
          const float l1 = j + 1 <= i0 ? exp2_approx(c2a - cj.y) : 0.f;
          const float l2 = j <= i1 ? exp2_approx(c2b - cj.x) : 0.f;
          const float l3 = j + 1 <= i1 ? exp2_approx(c2b - cj.y) : 0.f;
          const float sl0 = s1[q][0] * s2[q][0] * l0;  // s / dt_j
          const float sl1 = s1[q][1] * s2[q][1] * l1;
          const float sl2 = s1[q][2] * s2[q][2] * l2;
          const float sl3 = s1[q][3] * s2[q][3] * l3;
          rs0 += sl0 * dj.x + sl1 * dj.y;
          rs1 += sl2 * dj.x + sl3 * dj.y;
          s2[q][0] *= l0 * dj.x;  // M = S2 o L o dt_j
          s2[q][1] *= l1 * dj.y;
          s2[q][2] *= l2 * dj.x;
          s2[q][3] *= l3 * dj.y;
          // column sums of s / dt_j over the warp's 16 rows
          float c0 = sl0 + sl2, c1 = sl1 + sl3;
#pragma unroll
          for (int m = 4; m <= 16; m <<= 1) {
            c0 += __shfl_xor_sync(0xffffffffu, c0, m);
            c1 += __shfl_xor_sync(0xffffffffu, c1, m);
          }
          if (g == 0) {
            scolL[warp * kQMax + j] = c0;
            scolL[warp * kQMax + j + 1] = c1;
          }
        }
        uint32_t mh[4], ml[4];  // M as hi + lo bf16: two products
        tc::pack_a_split(mh, ml, s2[0], s2[1]);
#pragma unroll
        for (int np = 0; np < NB / 2; ++np) {
          uint32_t bb[4];
          tc::load_b_kn<NP>(bb, sm.b, jt * 16, np * 16);
          tc::mma(dc[2 * np], mh, bb[0], bb[1]);
          tc::mma(dc[2 * np + 1], mh, bb[2], bb[3]);
          tc::mma(dc[2 * np], ml, bb[0], bb[1]);
          tc::mma(dc[2 * np + 1], ml, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int m = 1; m <= 2; m <<= 1) {
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, m);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, m);
        tp0 += __shfl_xor_sync(0xffffffffu, tp0, m);
        tp1 += __shfl_xor_sync(0xffffffffu, tp1, m);
      }
      if (t == 0) {
        srow[i0] = rs0 + tp0;
        srow[i1] = rs1 + tp1;
      }
    }
    __syncthreads();
    // r = rowsum(s) + t - colsum(s), colsum(s / dt): column j's sums come
    // from warps j / 16 .. nT - 1, added in warp order
    if (threadIdx.x < Qp) {
      const int j = threadIdx.x, tt = t0 + j;
      float cl = 0.f;
      for (int w = j / 16; w < nT; ++w) cl += scolL[w * kQMax + j];
      if (j < Q && tt < S) {
        const long long o = ((long long)b * H + h) * S + tt;
        rvec[o] = srow[j] - cl * sm.dt[j];
        dvec[o] = cl;
      }
    }
  }

  if (warp < nT) {
    const int slots = H / hpb;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r ? i1 : i0, tt = t0 + i;
      if (i < Q && tt < S) {
        float* row =
            dc_part + (((long long)b * S + tt) * slots + blockIdx.y) * N;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int n = j * 8 + 2 * t;
          if (n < N)
            *reinterpret_cast<float2*>(row + n) =
                make_float2(dc[j][2 * r], dc[j][2 * r + 1]);
        }
      }
    }
  }
}

// L_ij = exp(cs_i - cs_j) on a column-owned tile's C fragment: rows j0
// and j0 + 8 (cumsums c2a, c2b in log2 units), columns i and i + 1; zero
// where i < j (never formed, so no inf * 0).
__device__ __forceinline__ void col_decay(const float* cs2, int i, int j0,
                                          float c2a, float c2b,
                                          float (&l)[4]) {
  const float2 ci = *reinterpret_cast<const float2*>(cs2 + i);
  l[0] = i >= j0 ? exp2_approx(ci.x - c2a) : 0.f;
  l[1] = i + 1 >= j0 ? exp2_approx(ci.y - c2a) : 0.f;
  l[2] = i >= j0 + 8 ? exp2_approx(ci.x - c2b) : 0.f;
  l[3] = i + 1 >= j0 + 8 ? exp2_approx(ci.y - c2b) : 0.f;
}

// The column kernel: the row kernel's grid and heads, warp w owning the
// chunk's columns j = 16w .. 16w + 15 (rows of dx and dB).  It walks the
// block's heads twice, so that no warp holds dB's group sum and dx's
// accumulators at once (x, dy and Ĥ's copies are read twice; with both
// at once the kernel needs ~180 registers, and spilled at the 128 of two
// blocks a SM).  First pass, per head:
//   V_j = Ĥ B_j (Ĥ's hi + lo copies, two products), x_j^T V_j, then
//   dx_j = dt_j (e_j V_j + sum_{i >= j} (T1 o L)_ji dy_i) over the causal
//           16-row tiles, T1 = B C^T exact, T1 o L as hi + lo A
//           operands; dx written in bf16;
//   warp 0: dcs = r - u (+ sum u + w at the chunk's last row), its reverse
//           cumsum da, ddt = colsum(s / dt) + e x^T V + A da and the
//           chunk's share of dA, sum dt da, into da_part[b, h, c].
// Second pass, per head, dB of the group summed in registers:
//   dB_j += e_j dt_j (Ĥ^T x_j)  (Ĥ's copies, two products)
//   dB_j += sum_{i >= j} (T2 o L o dt_j)_ji C_i, T2 = x dy^T likewise.
// At the end the heads' dB sum to db_part[b, t, slot].
template <int NP>
__global__ void __launch_bounds__(kTcThreads, BwdChunkLayout<NP>::kMinBlocks)
    ssd_bwd_col_tc_kernel(const bf16* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const bf16* __restrict__ Bm,
                          const bf16* __restrict__ Cm,
                          const bf16* __restrict__ dy,
                          const bf16* __restrict__ gbuf,
                          const float* __restrict__ wpart,
                          const float* __restrict__ rvec,
                          const float* __restrict__ dvec,
                          bf16* __restrict__ dx, float* __restrict__ ddt,
                          float* __restrict__ db_part,
                          float* __restrict__ da_part, int S, int H, int P,
                          int G, int N, int Q, int n_c, int hpb,
                          Strides xs_, Strides dts_, Strides bs_,
                          Strides cs_, Strides dys_) {
  constexpr int PT = kBwdPT;
  constexpr int NB = NP / 8;            // n8 blocks of dB
  // k16 steps unrolled together and n8 blocks of dB's inter-chunk term
  // at once: more at N 128 (one block a SM, registers to spare) than
  // below (two blocks a SM within 128 registers)
  constexpr int KU = NP > 64 ? 4 : 1;
  constexpr int NH = NP > 64 ? 8 : NB < 4 ? NB : 4;
  constexpr int PB = PT / 8;            // n8 blocks of dx
  constexpr int KN = NP / 16, KP = PT / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BwdChunkSmem<NP> sm(smem_raw);
  float* srv = sm.vec;         // [kQMax] r
  float* sdv = srv + kQMax;    // [kQMax] colsum(s / dt)
  float* sxv = sdv + kQMax;    // [kQMax] x^T Ĥ B

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c = blockIdx.x, b = blockIdx.z;
  const int h_first = blockIdx.y * hpb, grp = h_first / (H / G);
  const int t0 = c * Q, Qp = (Q + 15) & ~15, nT = Qp / 16;
  const int j0 = warp * 16 + g, j1 = j0 + 8;

  load_token_tile<NP>(sm.b, Bm + b * bs_.b + grp * bs_.h, bs_.s, t0, Q, S,
                      Qp, N);
  load_token_tile<NP>(sm.c, Cm + b * cs_.b + grp * cs_.h, cs_.s, t0, Q, S,
                      Qp, N);
  // head h's x, dy and Ĥ copies, its cumsum and dt (and, in the first
  // pass, its vectors) into shared memory
  auto load_head = [&](int h, bool first) {
    load_token_tile<PT>(sm.x, x + b * xs_.b + h * xs_.h, xs_.s, t0, Q, S, Qp,
                        P);
    load_token_tile<PT>(sm.dy, dy + b * dys_.b + h * dys_.h, dys_.s, t0, Q,
                        S, Qp, P);
    const bf16* gp = gbuf + (((long long)b * H + h) * n_c + c) * 2 * P * N;
    load_state_tile<NP>(sm.hi, gp, P, N);
    load_state_tile<NP>(sm.lo, gp + (long long)P * N, P, N);
    tc::cp_async_commit();
    if (warp == 0) {
      float d[4];
      load_dt4(dt + b * dts_.b + h * dts_.h, dts_.s, c, Q, S, lane, d);
      chunk_cs2(d, A[h], sm.cs2, sm.dt, lane);
    }
    if (first && threadIdx.x < kQMax) {
      const int j = threadIdx.x, tt = t0 + j;
      const long long o = ((long long)b * H + h) * S + tt;
      const bool ok = j < Q && tt < S;
      srv[j] = ok ? rvec[o] : 0.f;
      sdv[j] = ok ? dvec[o] : 0.f;
      sxv[j] = 0.f;
    }
    tc::cp_async_wait<0>();
    __syncthreads();
  };
  // e_j = exp(cs_Q - cs_j) and dt_j at the warp's rows j0, j1
  auto row_scales = [&](float& ea, float& eb, float& da0, float& da1) {
    const float c2end = sm.cs2[kQMax - 1];
    ea = exp2_approx(c2end - sm.cs2[j0]);
    eb = exp2_approx(c2end - sm.cs2[j1]);
    da0 = sm.dt[j0];
    da1 = sm.dt[j1];
  };

  // the first pass: dx, ddt and dA
#pragma unroll 1
  for (int k = 0; k < hpb; ++k) {
    const int h = h_first + k;
    if (k > 0) __syncthreads();  // the last head is done with every buffer
    load_head(h, true);
    if (warp < nT) {
      const float c2a = sm.cs2[j0], c2b = sm.cs2[j1];
      float ea, eb, da0, da1;
      row_scales(ea, eb, da0, da1);
      {
        // V_j = Ĥ B_j, then x_j^T V_j and dx_j = e_j V_j
        float dxa[PB][4];
#pragma unroll
        for (int j = 0; j < PB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dxa[j][e] = 0.f;
#pragma unroll
        for (int np = 0; np < PB / 2; ++np) {
#pragma unroll 1
          for (int k0 = 0; k0 < KN; k0 += KU)
#pragma unroll
          for (int kk = k0; kk < k0 + KU; ++kk) {
            uint32_t ba[4], gb[4];
            tc::load_a<NP>(ba, sm.b, warp * 16, kk * 16);
            tc::load_b_nk<NP>(gb, sm.hi, np * 16, kk * 16);
            tc::mma(dxa[2 * np], ba, gb[0], gb[1]);
            tc::mma(dxa[2 * np + 1], ba, gb[2], gb[3]);
            tc::load_b_nk<NP>(gb, sm.lo, np * 16, kk * 16);
            tc::mma(dxa[2 * np], ba, gb[0], gb[1]);
            tc::mma(dxa[2 * np + 1], ba, gb[2], gb[3]);
          }
        }
        float xv0 = 0.f, xv1 = 0.f;
#pragma unroll
        for (int j = 0; j < PB; ++j) {
          const float2 xa = tile_pair<PT>(sm.x, j0, j * 8 + 2 * t);
          const float2 xb = tile_pair<PT>(sm.x, j1, j * 8 + 2 * t);
          xv0 += xa.x * dxa[j][0] + xa.y * dxa[j][1];
          xv1 += xb.x * dxa[j][2] + xb.y * dxa[j][3];
          dxa[j][0] *= ea;
          dxa[j][1] *= ea;
          dxa[j][2] *= eb;
          dxa[j][3] *= eb;
        }
#pragma unroll
        for (int m = 1; m <= 2; m <<= 1) {
          xv0 += __shfl_xor_sync(0xffffffffu, xv0, m);
          xv1 += __shfl_xor_sync(0xffffffffu, xv1, m);
        }
        if (t == 0) {
          sxv[j0] = xv0;
          sxv[j1] = xv1;
        }
        // the causal tiles i >= j: T1 = B C^T o L as hi + lo A operands
#pragma unroll 1
        for (int it = warp; it < nT; ++it) {
          float t1[2][4];
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) t1[q][e] = 0.f;
#pragma unroll 1
          for (int k0 = 0; k0 < KN; k0 += KU)
#pragma unroll
          for (int kk = k0; kk < k0 + KU; ++kk) {
            uint32_t ba[4], cb[4];
            tc::load_a<NP>(ba, sm.b, warp * 16, kk * 16);
            tc::load_b_nk<NP>(cb, sm.c, it * 16, kk * 16);
            tc::mma(t1[0], ba, cb[0], cb[1]);
            tc::mma(t1[1], ba, cb[2], cb[3]);
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float l[4];
            col_decay(sm.cs2, it * 16 + q * 8 + 2 * t, j0, c2a, c2b, l);
#pragma unroll
            for (int e = 0; e < 4; ++e) t1[q][e] *= l[e];
          }
          uint32_t th[4], tl[4];
          tc::pack_a_split(th, tl, t1[0], t1[1]);
#pragma unroll
          for (int np = 0; np < PB / 2; ++np) {
            uint32_t yb[4];
            tc::load_b_kn<PT>(yb, sm.dy, it * 16, np * 16);
            tc::mma(dxa[2 * np], th, yb[0], yb[1]);
            tc::mma(dxa[2 * np + 1], th, yb[2], yb[3]);
            tc::mma(dxa[2 * np], tl, yb[0], yb[1]);
            tc::mma(dxa[2 * np + 1], tl, yb[2], yb[3]);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = r ? j1 : j0, tt = t0 + j;
          const float d = r ? da1 : da0;
          if (j < Q && tt < S) {
            bf16* row =
                dx + b * dys_.b + (long long)tt * dys_.s + h * dys_.h;
#pragma unroll
            for (int n = 0; n < PB; ++n) {
              const int p = n * 8 + 2 * t;
              if (p < P)
                *reinterpret_cast<uint32_t*>(row + p) = tc::pack_bf16(
                    dxa[n][2 * r] * d, dxa[n][2 * r + 1] * d);
            }
          }
        }
      }
    }
    __syncthreads();
    // dcs, its reverse cumsum da, ddt and the chunk's share of dA
    if (warp == 0) {
      const float a = A[h], c2end = sm.cs2[kQMax - 1];
      float dcs[4], ek[4], us = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k2 = 4 * lane + e;
        ek[e] = exp2_approx(c2end - sm.cs2[k2]);
        const float u = ek[e] * sm.dt[k2] * sxv[k2];
        dcs[e] = srv[k2] - u;
        us += u;
      }
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1)
        us += __shfl_xor_sync(0xffffffffu, us, m);
      if (lane == 31)
        dcs[3] += us + wpart[((long long)b * H + h) * n_c + c];
      // suffix sums over lanes, then within the lane from its last row
      const float tot = dcs[0] + dcs[1] + dcs[2] + dcs[3];
      float suf = tot;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, suf, off);
        if (lane + off < 32) suf += o;
      }
      float run = __shfl_down_sync(0xffffffffu, suf, 1);
      if (lane == 31) run = 0.f;
      float dap = 0.f;
#pragma unroll
      for (int e = 3; e >= 0; --e) {
        const int k2 = 4 * lane + e, tt = t0 + k2;
        run += dcs[e];
        if (k2 < Q && tt < S)
          ddt[((long long)b * S + tt) * H + h] =
              sdv[k2] + ek[e] * sxv[k2] + a * run;
        dap += sm.dt[k2] * run;
      }
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1)
        dap += __shfl_xor_sync(0xffffffffu, dap, m);
      if (lane == 0) da_part[((long long)b * H + h) * n_c + c] = dap;
    }
  }

  // the second pass: dB of the group, summed over the heads in registers
  float db[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) db[j][e] = 0.f;
#pragma unroll 1
  for (int k = 0; k < hpb; ++k) {
    __syncthreads();  // the last head is done with every buffer
    load_head(h_first + k, false);
    if (warp < nT) {
      const float c2a = sm.cs2[j0], c2b = sm.cs2[j1];
      float ea, eb, da0, da1;
      row_scales(ea, eb, da0, da1);
      {
        // dB_j += e_j dt_j (Ĥ^T x_j), NH n8 blocks at a time
        const float wa = ea * da0, wb = eb * da1;
#pragma unroll
        for (int n0 = 0; n0 < NB; n0 += NH) {
          float tmp[NH][4];
#pragma unroll
          for (int j = 0; j < NH; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) tmp[j][e] = 0.f;
#pragma unroll 1
          for (int k0 = 0; k0 < KP; k0 += KU)
#pragma unroll
          for (int kk = k0; kk < k0 + KU; ++kk) {
            uint32_t xa[4];
            tc::load_a<PT>(xa, sm.x, warp * 16, kk * 16);
#pragma unroll
            for (int np = 0; np < NH / 2; ++np) {
              uint32_t bh[4];
              tc::load_b_kn<NP>(bh, sm.hi, kk * 16, (n0 + 2 * np) * 8);
              tc::mma(tmp[2 * np], xa, bh[0], bh[1]);
              tc::mma(tmp[2 * np + 1], xa, bh[2], bh[3]);
              tc::load_b_kn<NP>(bh, sm.lo, kk * 16, (n0 + 2 * np) * 8);
              tc::mma(tmp[2 * np], xa, bh[0], bh[1]);
              tc::mma(tmp[2 * np + 1], xa, bh[2], bh[3]);
            }
          }
#pragma unroll
          for (int j = 0; j < NH; ++j) {
            db[n0 + j][0] += tmp[j][0] * wa;
            db[n0 + j][1] += tmp[j][1] * wa;
            db[n0 + j][2] += tmp[j][2] * wb;
            db[n0 + j][3] += tmp[j][3] * wb;
          }
        }
        // the causal tiles i >= j: T2 = x dy^T o L o dt_j likewise
#pragma unroll 1
        for (int it = warp; it < nT; ++it) {
          float t2[2][4];
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) t2[q][e] = 0.f;
#pragma unroll 1
          for (int k0 = 0; k0 < KP; k0 += KU)
#pragma unroll
          for (int kk = k0; kk < k0 + KU; ++kk) {
            uint32_t xa[4], yb[4];
            tc::load_a<PT>(xa, sm.x, warp * 16, kk * 16);
            tc::load_b_nk<PT>(yb, sm.dy, it * 16, kk * 16);
            tc::mma(t2[0], xa, yb[0], yb[1]);
            tc::mma(t2[1], xa, yb[2], yb[3]);
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float l[4];
            col_decay(sm.cs2, it * 16 + q * 8 + 2 * t, j0, c2a, c2b, l);
            t2[q][0] *= l[0] * da0;
            t2[q][1] *= l[1] * da0;
            t2[q][2] *= l[2] * da1;
            t2[q][3] *= l[3] * da1;
          }
          uint32_t th[4], tl[4];
          tc::pack_a_split(th, tl, t2[0], t2[1]);
#pragma unroll
          for (int np = 0; np < NB / 2; ++np) {
            uint32_t cb[4];
            tc::load_b_kn<NP>(cb, sm.c, it * 16, np * 16);
            tc::mma(db[2 * np], th, cb[0], cb[1]);
            tc::mma(db[2 * np + 1], th, cb[2], cb[3]);
            tc::mma(db[2 * np], tl, cb[0], cb[1]);
            tc::mma(db[2 * np + 1], tl, cb[2], cb[3]);
          }
        }
      }
    }
  }

  if (warp < nT) {
    const int slots = H / hpb;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = r ? j1 : j0, tt = t0 + j;
      if (j < Q && tt < S) {
        float* row =
            db_part + (((long long)b * S + tt) * slots + blockIdx.y) * N;
#pragma unroll
        for (int n8 = 0; n8 < NB; ++n8) {
          const int n = n8 * 8 + 2 * t;
          if (n < N)
            *reinterpret_cast<float2*>(row + n) =
                make_float2(db[n8][2 * r], db[n8][2 * r + 1]);
        }
      }
    }
  }
}

template <typename T>
using StatePass = decltype(&ssd_state_pass_kernel<T, false, 2>);

// Columns of the state a lane holds: 2 for N <= 64, else 4.
int cols_a_lane(int N) { return N <= 64 ? 2 : 4; }

template <typename T>
StatePass<T> state_pass(bool rev, int nj) {
  if (nj == 2)
    return rev ? ssd_state_pass_kernel<T, true, 2>
               : ssd_state_pass_kernel<T, false, 2>;
  return rev ? ssd_state_pass_kernel<T, true, 4>
             : ssd_state_pass_kernel<T, false, 4>;
}

// Raises each backward kernel's shared-memory limit to its largest use,
// once (so that launches captured into a CUDA graph make no other API
// call); false on a CUDA error.
template <typename T>
bool bwd_ready() {
  static int state = 0;  // 0 not tried, 1 ready, -1 failed
  if (state == 0) {
    const int sp = (int)state_pass_smem(kQMax, kNMax);
    bool ok = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)(sizeof(float) * kChunkSmemFloats)) ==
              cudaSuccess;
    for (int rev = 0; rev < 2; ++rev)
      for (int nj : {2, 4})
        ok = ok && cudaFuncSetAttribute(
                       state_pass<T>(rev, nj),
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       sp) == cudaSuccess;
    state = ok ? 1 : -1;
  }
  return state > 0;
}

template <typename T>
bool launch_bwd(const T* x, const float* dt, const float* A, const T* Bm,
                const T* Cm, const float* h0, const T* dy, const float* dh,
                float* hs, float* gs, float* db_part, float* dc_part,
                float* da_part, T* dx, float* ddt, float* dA, T* dB, T* dC,
                float* dinit, int Bsz, int S, int H, int P, int G, int N,
                int Q, Strides xs, Strides dts, Strides bs, Strides cs,
                cudaStream_t s) {
  if (!bwd_ready<T>()) return false;
  const int n_c = (S + Q - 1) / Q;
  const Strides dys{(long long)S * H * P, (long long)H * P, (long long)P};
  const dim3 sp_grid((P + kSpPT - 1) / kSpPT, H, Bsz);
  const size_t sp_smem = state_pass_smem(Q, N);
  const StatePass<T> fwd = state_pass<T>(false, cols_a_lane(N));
  const StatePass<T> rev = state_pass<T>(true, cols_a_lane(N));
  fwd<<<sp_grid, kThreads, sp_smem, s>>>(x, Bm, dt, A, h0, hs, nullptr, S, H,
                                         P, G, N, Q, n_c, xs, bs, dts);
  rev<<<sp_grid, kThreads, sp_smem, s>>>(dy, Cm, dt, A, dh, gs, dinit, S, H,
                                         P, G, N, Q, n_c, dys, cs, dts);
  ssd_bwd_chunk_kernel<T>
      <<<dim3(n_c, H, Bsz), kThreads, sizeof(float) * kChunkSmemFloats, s>>>(
          x, dt, A, Bm, Cm, dy, hs, gs, dx, ddt, db_part, dc_part, da_part, S,
          H, P, G, N, Q, n_c, xs, dts, bs, cs, dys);
  const long long total = 2LL * Bsz * S * G * N + H;
  const int blocks =
      (int)std::min<long long>((total + kThreads - 1) / kThreads, 132 * 8);
  ssd_bwd_reduce_kernel<T><<<blocks, kThreads, 0, s>>>(
      db_part, dc_part, da_part, dB, dC, dA, Bsz, S, H, H, G, N, n_c);
  return true;
}

// Raises the bf16 backward's shared-memory limits for N padded to NP and
// reads the SMs and the chunk kernels' resident blocks a SM, once (so that
// launches captured into a CUDA graph make no other API call); ready is
// false on a CUDA error or where a kernel fits no block.
struct BwdTcPlan {
  bool ready = false;
  int sms = 0, blocks = 0;
};

template <typename K>
bool raise_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes) == cudaSuccess;
}

template <int NP>
const BwdTcPlan& bwd_tc_plan() {
  static BwdTcPlan plan;
  static bool queried = false;
  if (!queried) {
    queried = true;
    const size_t sf = BwdStateLayout<NP, false>::kBytes;
    const size_t sr = BwdStateLayout<NP, true>::kBytes;
    const size_t cs = BwdChunkLayout<NP>::kBytes;
    int dev = 0, rows = 0, cols = 0, fwd = 0, rev = 0;
    const bool ok =
        cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&plan.sms, cudaDevAttrMultiProcessorCount,
                               dev) == cudaSuccess &&
        raise_smem(ssd_bwd_state_tc_kernel<NP, false>, sf) &&
        raise_smem(ssd_bwd_state_tc_kernel<NP, true>, sr) &&
        raise_smem(ssd_bwd_row_tc_kernel<NP>, cs) &&
        raise_smem(ssd_bwd_col_tc_kernel<NP>, cs) &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &fwd, ssd_bwd_state_tc_kernel<NP, false>, kTcThreads, sf) ==
            cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &rev, ssd_bwd_state_tc_kernel<NP, true>, kTcThreads, sr) ==
            cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &rows, ssd_bwd_row_tc_kernel<NP>, kTcThreads, cs) ==
            cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &cols, ssd_bwd_col_tc_kernel<NP>, kTcThreads, cs) == cudaSuccess;
    plan.blocks = std::min(rows, cols);
    plan.ready = ok && plan.blocks > 0 && fwd > 0 && rev > 0;
  }
  return plan;
}

const BwdTcPlan& bwd_tc_plan_for(int np) {
  return np == 32 ? bwd_tc_plan<32>()
                  : np == 64 ? bwd_tc_plan<64>() : bwd_tc_plan<128>();
}

// Blocks of the chunk kernels a group of H / G heads: the fewest waves of
// heads over the card, with the partials of dB and dC at most an eighth
// of one per head (at most H / G / 8 blocks a group, at least one); on a
// tie the fewer partials.
int bwd_tc_slots(const BwdTcPlan& plan, int Bsz, int n_c, int H, int G) {
  const int HG = H / G, most = std::max(1, HG / 8);
  const long long resident = (long long)plan.sms * plan.blocks;
  int best = 1;
  long long best_cost = -1;
  for (int slots = 1; slots <= most; ++slots) {
    if (HG % slots) continue;
    const long long blocks = (long long)n_c * Bsz * G * slots;
    const long long cost = (blocks + resident - 1) / resident * (HG / slots);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = slots;
    }
  }
  return best;
}

// The bf16 backward: the two state passes, the row and column kernels over
// (chunk, block of H / HP heads, batch), then the reduction of the HP / G
// partials of dB and dC a group and of dA.  Five launches.
template <int NP>
bool launch_bwd_tc(const bf16* x, const float* dt, const float* A,
                   const bf16* Bm, const bf16* Cm, const float* h0,
                   const bf16* dy, const float* dh, bf16* hs, bf16* gs,
                   float* db_part, float* dc_part, float* da_part,
                   float* wpart, float* rvec, float* dvec, bf16* dx,
                   float* ddt, float* dA, bf16* dB, bf16* dC, float* dinit,
                   int Bsz, int S, int H, int P, int G, int N, int Q, int HP,
                   Strides xs, Strides dts, Strides bs, Strides cs,
                   cudaStream_t s) {
  if (!bwd_tc_plan<NP>().ready) return false;
  const int n_c = (S + Q - 1) / Q, hpb = H / HP;
  const Strides dys{(long long)S * H * P, (long long)H * P, (long long)P};
  const dim3 sgrid(1, H, Bsz), cgrid(n_c, HP, Bsz);
  const size_t csz = BwdChunkLayout<NP>::kBytes;
  ssd_bwd_state_tc_kernel<NP, false>
      <<<sgrid, kTcThreads, BwdStateLayout<NP, false>::kBytes, s>>>(
          x, Bm, dt, A, h0, nullptr, hs, nullptr, nullptr, S, H, P, G, N, Q,
          n_c, xs, bs, dts);
  ssd_bwd_state_tc_kernel<NP, true>
      <<<sgrid, kTcThreads, BwdStateLayout<NP, true>::kBytes, s>>>(
      dy, Cm, dt, A, dh, hs, gs, wpart, dinit, S, H, P, G, N, Q, n_c, dys, cs,
      dts);
  ssd_bwd_row_tc_kernel<NP><<<cgrid, kTcThreads, csz, s>>>(
      x, dt, A, Bm, Cm, dy, hs, dc_part, rvec, dvec, S, H, P, G, N, Q, n_c,
      hpb, xs, dts, bs, cs, dys);
  ssd_bwd_col_tc_kernel<NP><<<cgrid, kTcThreads, csz, s>>>(
      x, dt, A, Bm, Cm, dy, gs, wpart, rvec, dvec, dx, ddt, db_part, da_part,
      S, H, P, G, N, Q, n_c, hpb, xs, dts, bs, cs, dys);
  const long long total = 2LL * Bsz * S * G * N + H;
  const int blocks =
      (int)std::min<long long>((total + kThreads - 1) / kThreads, 132 * 8);
  ssd_bwd_reduce_kernel<bf16><<<blocks, kThreads, 0, s>>>(
      db_part, dc_part, da_part, dB, dC, dA, Bsz, S, H, HP, G, N, n_c);
  return true;
}

// The backward's kernels for reports, in the order of repro_ssd_info: the
// f32 path's state passes (forward then reverse; 2, 4 columns a lane) and
// chunk kernel, the reduce kernel (bf16, f32), then the bf16 path's
// kernels at each padding of N (32, 64, 128): the state passes (forward,
// reverse), the row and the column kernels.
constexpr int kNumF32Bwd = 7;

template <int NP>
bool bwd_tc_info(int k, const char** name, int* out) {
  static char buf[48];
  *name = buf;
  const size_t cs = BwdChunkLayout<NP>::kBytes;
  switch (k) {
    case 0:
      snprintf(buf, sizeof buf, "ssd_bwd_state_tc_kernel<%d,fwd>", NP);
      return tc::kernel_info(ssd_bwd_state_tc_kernel<NP, false>, kTcThreads,
                             BwdStateLayout<NP, false>::kBytes, out);
    case 1:
      snprintf(buf, sizeof buf, "ssd_bwd_state_tc_kernel<%d,rev>", NP);
      return tc::kernel_info(ssd_bwd_state_tc_kernel<NP, true>, kTcThreads,
                             BwdStateLayout<NP, true>::kBytes, out);
    case 2:
      snprintf(buf, sizeof buf, "ssd_bwd_row_tc_kernel<%d>", NP);
      return tc::kernel_info(ssd_bwd_row_tc_kernel<NP>, kTcThreads, cs, out);
    default:
      snprintf(buf, sizeof buf, "ssd_bwd_col_tc_kernel<%d>", NP);
      return tc::kernel_info(ssd_bwd_col_tc_kernel<NP>, kTcThreads, cs, out);
  }
}

bool bwd_info(int idx, const char** name, int* out) {
  static char buf[48];
  if (idx < 0) return false;
  if (idx < 4) {
    const bool rev = idx >= 2;
    const int nj = idx % 2 ? 4 : 2;
    snprintf(buf, sizeof buf, "ssd_state_pass_kernel<f32,%s,%d>",
             rev ? "rev" : "fwd", nj);
    *name = buf;
    return tc::kernel_info(state_pass<float>(rev, nj), kThreads,
                           state_pass_smem(kQMax, kNMax), out);
  }
  switch (idx) {
    case 4:
      *name = "ssd_bwd_chunk_kernel<f32>";
      return tc::kernel_info(ssd_bwd_chunk_kernel<float>, kThreads,
                             sizeof(float) * kChunkSmemFloats, out);
    case 5:
      *name = "ssd_bwd_reduce_kernel<bf16>";
      return tc::kernel_info(ssd_bwd_reduce_kernel<bf16>, kThreads, 0, out);
    case 6:
      *name = "ssd_bwd_reduce_kernel<f32>";
      return tc::kernel_info(ssd_bwd_reduce_kernel<float>, kThreads, 0, out);
  }
  const int k = idx - kNumF32Bwd;
  switch (k / 4) {
    case 0: return bwd_tc_info<32>(k % 4, name, out);
    case 1: return bwd_tc_info<64>(k % 4, name, out);
    case 2: return bwd_tc_info<128>(k % 4, name, out);
    default: return false;
  }
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

// Blocks of the bf16 backward's chunk kernels a group of H / G heads (the
// partials of dB and dC it needs a group), for N a multiple of 8; 0 where
// its kernels cannot launch (a CUDA error or a shape it does not take).
extern "C" int repro_ssd_bwd_slots(int Bsz, int S, int H, int G, int N,
                                   int Q) {
  if (Bsz < 1 || S < 1 || Q < 1 || Q > kQMax || N < 1 || N > kNMax ||
      G < 1 || H % G != 0)
    return 0;
  const BwdTcPlan& plan = bwd_tc_plan_for(padded_n(N));
  if (!plan.ready) return 0;
  return bwd_tc_slots(plan, Bsz, (S + Q - 1) / Q, H, G);
}

// The backward.  x, dt, A, Bm, Cm, h0 as repro_ssd_fwd takes them; dy: (B,
// S, H, P) contiguous in x's dtype; dh: the final state's f32 cotangent
// (B, H, P, N) contiguous, or null (zero).  Outputs, contiguous: dx (B, S,
// H, P) and dB, dC (B, S, G, N) in x's dtype, ddt (B, S, H), dA (H,) and
// dinit (B, H, P, N) f32.  Scratch, f32 unless said: da_part (B, H,
// ceil(S / Q)); db_part, dc_part (B, S, HP, N), HP / G partials a group;
//   f32 (any N and alignment: read element by element; four launches):
//     hs, gs (B, H, ceil(S / Q), P, N); HP = H; wpart, rvec, dvec unused;
//   bf16 (tensor cores; five launches; P <= 64, N a multiple of 8, x, Bm,
//     Cm, dy 16-byte aligned with strides multiples of 8): hs, gs bf16 (B,
//     H, ceil(S / Q), 2, P, N); HP = G * repro_ssd_bwd_slots(..); wpart
//     (B, H, ceil(S / Q)); rvec, dvec (B, H, S).
// Launches on `stream`.  Returns false (and launches nothing) for a shape
// or alignment it does not take, or on a CUDA error setting the kernels'
// shared-memory limits; errors of a launch are left to cudaGetLastError.
extern "C" bool repro_ssd_bwd(
    const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, const float* h0, const void* dy, const float* dh,
    void* hs, void* gs, float* db_part, float* dc_part, float* da_part,
    float* wpart, float* rvec, float* dvec, void* dx, float* ddt, float* dA,
    void* dB, void* dC, float* dinit, int Bsz, int S, int H, int P, int G,
    int N, int Q, int HP, long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb,
    long long b_ss, long long b_sg, long long c_sb, long long c_ss,
    long long c_sg, int bf16, cudaStream_t s) {
  if (Bsz < 1 || S < 1 || Q < 1 || Q > kQMax || N < 1 || N > kNMax ||
      P < 8 || P % 8 != 0 || G < 1 || H % G != 0 || HP < 1 || H % HP != 0 ||
      HP % G != 0)
    return false;
  const Strides xs{x_sb, x_ss, x_sh}, dts{dt_sb, dt_ss, dt_sh},
      bs{b_sb, b_ss, b_sg}, cs{c_sb, c_ss, c_sg};
  if (bf16) {
    using T = __nv_bfloat16;
    if (P > kBwdPT || N % 8 != 0 || wpart == nullptr || rvec == nullptr ||
        dvec == nullptr || !aligned16(x) || !aligned16(Bm) ||
        !aligned16(Cm) || !aligned16(dy) || xs.b % 8 || xs.s % 8 ||
        xs.h % 8 || bs.b % 8 || bs.s % 8 || bs.h % 8 || cs.b % 8 ||
        cs.s % 8 || cs.h % 8)
      return false;
    const int np = padded_n(N);
    auto launch = np == 32   ? &launch_bwd_tc<32>
                  : np == 64 ? &launch_bwd_tc<64>
                             : &launch_bwd_tc<128>;
    return launch(static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
                  static_cast<const T*>(Cm), h0, static_cast<const T*>(dy),
                  dh, static_cast<T*>(hs), static_cast<T*>(gs), db_part,
                  dc_part, da_part, wpart, rvec, dvec, static_cast<T*>(dx),
                  ddt, dA, static_cast<T*>(dB), static_cast<T*>(dC), dinit,
                  Bsz, S, H, P, G, N, Q, HP, xs, dts, bs, cs, s);
  }
  if (HP != H) return false;
  return launch_bwd<float>(
      static_cast<const float*>(x), dt, A, static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), h0, static_cast<const float*>(dy), dh,
      static_cast<float*>(hs), static_cast<float*>(gs), db_part, dc_part,
      da_part, static_cast<float*>(dx), ddt, dA, static_cast<float*>(dB),
      static_cast<float*>(dC), dinit, Bsz, S, H, P, G, N, Q, xs, dts, bs, cs,
      s);
}

// Facts about the kernels for reports: idx 0, 1, 2 the bf16 scan at its
// instantiated paddings of N, then the backward's kernels (bwd_info).
// Writes the kernel's name and out[0..5] (tc::kernel_info).  Returns false
// past the last one or on a CUDA error.
extern "C" bool repro_ssd_info(int idx, const char** name, int* out) {
  if (idx >= kNumTcNp) return bwd_info(idx - kNumTcNp, name, out);
  if (idx < 0) return false;
  static char buf[48];
  const int np = kTcNp[idx];
  size_t smem = 0;
  const TcKernel k = tc_kernel(np, &smem);
  snprintf(buf, sizeof buf, "ssd_scan_tc_kernel<%d>", np);
  *name = buf;
  return tc::kernel_info(k, kTcThreads, smem, out);
}
