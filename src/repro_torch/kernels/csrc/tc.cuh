// Tensor-core building blocks of flash_attention.cu, cross_entropy.cu and
// ssd_scan.cu (compiled for sm_90a): mma.sync.m16n8k16 with bf16 operands
// and f32 accumulators, ldmatrix fragment loads from shared memory, cp.async
// copies with zero fill, a swizzled row-major layout for bf16 tiles, and
// Hopper's wgmma.m64n256k16 reading that layout through descriptors.
//
// Fragment layouts (PTX ISA, m16n8k16, lane = 4 * g + t):
//   A (16 x 16, row-major) a[0]: (g, 2t..2t+1)  a[1]: (g+8, 2t..)
//                          a[2]: (g, 2t+8..)    a[3]: (g+8, 2t+8..)
//   B (16 x 8, k x n)      b[0]: (k 2t..2t+1, n g)  b[1]: (k 2t+8.., n g)
//   C (16 x 8, f32)        c[0..1]: (g, 2t..2t+1)   c[2..3]: (g+8, 2t..)
// So the C fragments of two neighbouring n8 blocks, rounded to bf16, are
// the A fragment of one k16 step (pack_a below): a product's output feeds
// the next product from registers.
//
// Swizzle.  A tile of R rows of W bf16 values is stored row-major, but
// the 16-byte chunk c of row r sits at chunk position c ^ f(r), where f
// spreads the eight rows that one ldmatrix phase reads over all 32 banks:
// f(r) = r & 7 for rows of 8 or more chunks, (r >> 1) & 3 for rows of 4
// chunks and (r >> 2) & 1 for rows of 2.  No padding, no bank conflicts
// on ldmatrix.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of chunk c (8 bf16 values) of row r in a swizzled tile
// whose rows hold W values.
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int C = W / 8;
  static_assert(C == 2 || C == 4 || C % 8 == 0, "row of 2, 4 or 8k chunks");
  const int x = C >= 8 ? (r & 7) : (C == 4 ? ((r >> 1) & 3) : ((r >> 2) & 1));
  return r * W + ((c ^ x) << 3);
}

// 16-byte asynchronous copy global -> shared; `bytes` in {0, 16}: 0
// writes zeros (the source is then not read, but must be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
// 4-byte asynchronous copy global -> shared; `bytes` in {0, 4} as above.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies rows row0 .. row0 + R - 1 of a bf16 matrix (row stride `ld`
// elements, W contiguous values a row) into a swizzled R x W tile;
// rows at or beyond n_rows become zeros.  Needs 16-byte aligned rows.
template <int R, int W, int NT>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long ld, int row0,
                                                int n_rows) {
  constexpr int C = W / 8;
  for (int i = threadIdx.x; i < R * C; i += NT) {
    const int r = i / C, c = i % C;
    const int g = row0 + r;
    const bool ok = g < n_rows;
    cp_async16(dst + swz<W>(r, c), ok ? src + (long long)g * ld + c * 8 : src,
               ok ? 16 : 0);
  }
}

// Four 8x8 b16 matrices; lane l supplies the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Two 8x8 b16 matrices, transposed; lanes 0-15 supply the row addresses.
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// A fragment (16 x 16) at (m0, k0) of a swizzled row-major [m][k] tile.
template <int W>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int m0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  const int r = m0 + (lane & 15);
  ldsm_x4(a, tile + swz<W>(r, (k0 >> 3) + (lane >> 4)));
}

// The same A fragment from a swizzled tile stored [k][m] (the transpose
// of the operand), by ldmatrix.trans: matrices (m, k) = (0, 0), (8, 0),
// (0, 8), (8, 8) from rows k0 .. k0 + 15, chunks m0 / 8 and m0 / 8 + 1.
template <int W>
__device__ __forceinline__ void load_a_km(uint32_t (&a)[4],
                                          const __nv_bfloat16* tile, int k0,
                                          int m0) {
  const int lane = threadIdx.x & 31;
  const int r = k0 + (lane & 7) + ((lane >> 4) << 3);
  ldsm_x4_t(a, tile + swz<W>(r, (m0 >> 3) + ((lane >> 3) & 1)));
}

// B fragments of two n8 blocks (n0 .. n0 + 15) at depth k0 .. k0 + 15,
// from a swizzled tile stored [n][k] (b[0], b[1]: block n0; b[2], b[3]:
// block n0 + 8).
template <int W>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4],
                                          const __nv_bfloat16* tile, int n0,
                                          int k0) {
  const int lane = threadIdx.x & 31;
  const int r = n0 + (lane & 7) + ((lane >> 4) << 3);
  ldsm_x4(b, tile + swz<W>(r, (k0 >> 3) + ((lane >> 3) & 1)));
}

// The same two B fragments from a swizzled tile stored [k][n].
template <int W>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4],
                                          const __nv_bfloat16* tile, int k0,
                                          int n0) {
  const int lane = threadIdx.x & 31;
  const int r = k0 + (lane & 7) + (((lane >> 3) & 1) << 3);
  ldsm_x4_t(b, tile + swz<W>(r, (n0 >> 3) + (lane >> 4)));
}

// The B fragment of one n8 block (n0 .. n0 + 7) at depth k0 .. k0 + 15
// from a swizzled tile stored [k][n].
template <int W>
__device__ __forceinline__ void load_b_kn1(uint32_t (&b)[2],
                                           const __nv_bfloat16* tile, int k0,
                                           int n0) {
  const int lane = threadIdx.x & 31;
  const int r = k0 + (lane & 7) + (((lane >> 3) & 1) << 3);
  ldsm_x2_t(b, tile + swz<W>(r, n0 >> 3));
}

// c += a * b on one m16n8k16 tile (bf16 in, f32 accumulate).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of one k16 step from the f32 C fragments of the two n8
// blocks it spans, rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Two f32 values as a pair of bf16 pairs, hi = bf16(v) and lo = bf16(v -
// hi): hi + lo carries about 16 bits of v, so two products (hi, then lo,
// into one f32 sum) lose about what an f32 operand would.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// pack_a with the operand split into hi and lo fragments (split_bf16).
__device__ __forceinline__ void pack_a_split(uint32_t (&hi)[4],
                                             uint32_t (&lo)[4],
                                             const float (&c0)[4],
                                             const float (&c1)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// Facts about a kernel for reports: out[0..5] = registers a thread, local
// (spill) bytes a thread, static shared memory, the dynamic shared memory
// it is launched with, threads a block, and blocks resident on one SM at
// that size (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Raises the
// kernel's dynamic shared-memory limit first, as its launch does.
template <typename K>
inline bool kernel_info(K kernel, int threads, size_t dyn_smem, int* out) {
  cudaFuncAttributes a;
  int blocks = 0;
  if (dyn_smem > 0 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dyn_smem) != cudaSuccess)
    return false;
  if (cudaFuncGetAttributes(&a, kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    dyn_smem) != cudaSuccess)
    return false;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)dyn_smem;
  out[4] = threads;
  out[5] = blocks;
  return true;
}

// ---------------------------------------------------------------------------
// wgmma (sm_90a): one warpgroup (4 warps) multiplies a 64 x 16 A tile by a
// 16 x 256 B tile, both read from shared memory through descriptors, into
// 128 f32 accumulators a thread (the layout of 32 mma.sync C fragments
// side by side: d[4j .. 4j+3] are n8 block j).  Tiles are K-major with the
// 128-byte swizzle, which is the tc::swz<64> layout of rows of 64 bf16
// values on a 1024-byte aligned base.
// ---------------------------------------------------------------------------

// Descriptor of a K-major, 128-byte-swizzled tile at `p`: start address,
// stride 1024 bytes between groups of 8 rows, swizzle mode 1 (128 B).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Orders shared-memory writes of this thread (st.shared, cp.async) before
// later reads by wgmma, which go through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of d across a wgmma
// wait or fence.
__device__ __forceinline__ void wgmma_pin(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B for A (64 x 16) at desc_a and B (16 x 256, stored [n][k]) at
// desc_b; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

}  // namespace tc
