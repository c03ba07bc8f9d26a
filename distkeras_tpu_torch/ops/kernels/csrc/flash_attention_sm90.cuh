// Hopper (sm_90a) pieces of the bf16 flash-attention kernels: bf16 tiles
// staged asynchronously in the 128-byte-swizzled layout that wgmma
// descriptors read, the wgmma products (operands from shared memory, or A
// from registers), the three-term bf16 split of a float32 operand
// (backward) and its one-term rounding (forward, whose p . v takes p in
// bf16).
//
// Shared layout of a staged tile of R rows (R a multiple of 64) by D
// features (D = 64 or 128, bf16): R / 64 blocks of 64 rows, each D / 64
// panels of 64 rows x 128 bytes (64 features); the 16-byte chunk c (8
// features) of row r of a panel sits at r * 128 + ((c ^ (r % 8)) * 16),
// the 128-byte swizzle (Swizzle<3,4,3>). Blocks start 1024-byte aligned.
// One such block is read two ways:
//   - K-major (rows = M or N of the product, features = K): s = q k^T,
//     dp = dout v^T and their transposes, a 16-deep slice being 32 bytes
//     of one panel;
//   - MN-major (rows = K, features = N, the descriptor's transpose bit):
//     dq += ds k, dv += p^T dout, dk += ds^T q, a 16-deep slice being 16
//     rows (2048 bytes), the next 64 features one panel on.
// So no tile is ever copied transposed.
//
// Accumulators follow wgmma's m64nN float32 layout: thread lt of a
// warpgroup holds, for every group g of 8 columns, elements 4g..4g+3 at
// rows (lt / 32) * 16 + (lt % 32) / 4 (+ 8 for the last two) and columns
// 8g + 2 (lt % 4) (+ 1). Four consecutive pairs of them are exactly the
// A fragment of a 16-deep slice (split_frags), so p and ds go from
// their product's accumulator into the next product without shared
// memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {
namespace sm90 {

constexpr int kRows = 64;         // rows of a warpgroup's block and a tile
constexpr int kWarpgroup = 128;   // threads of one warpgroup
constexpr uint32_t kPanelBytes = kRows * 128;  // 64 rows x 64 bf16

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- asynchronous staging ----------------------------------------------------

// 16 bytes from global to shared memory; zeros beyond src_bytes (0 or 16)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's writes to shared memory visible to wgmma, which
// reads through the async proxy (before the barrier that publishes them).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of chunk `chunk` (8 features) of row `row` of a staged tile.
template <int D>
__device__ __forceinline__ uint32_t tile_offset(int row, int chunk) {
  return (row / kRows) * (kRows * D * 2) + (chunk / 8) * kPanelBytes +
         (row % kRows) * 128 + (((chunk % 8) ^ (row % 8)) << 4);
}

// Start the cp.async copies of R rows at src (row stride `stride`
// elements, d features; zeros for features d..D) into the tile at dst,
// spread over `threads` threads (this one is `tid`). Commit is the
// caller's.
template <int D, int R, int threads>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int d, int tid) {
  constexpr int kChunks = D / 8;
  static_assert((R * kChunks) % threads == 0, "tile must split evenly");
#pragma unroll
  for (int it = 0; it < R * kChunks / threads; ++it) {
    const int i = tid + it * threads;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = c * 8 < d;  // d % 8 == 0: a chunk is all in or all out
    cp_async16(dst + tile_offset<D>(r, c), src + r * stride + (in ? c * 8 : 0),
               in ? 16 : 0);
  }
}

// -- wgmma ----------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at shared address addr
// (layout type 1; leading and stride byte offsets in bytes).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// 16-deep slice kk of a 64-row block read K-major (features = K): 8-row
// groups 1024 bytes apart; the leading offset is unused by this layout.
__device__ __forceinline__ uint64_t desc_k(uint32_t block, int kk) {
  return desc_sw128(block + (kk / 4) * kPanelBytes + (kk % 4) * 32, 16, 1024);
}

// Rows 16kk..16kk+15 of a 64-row block read MN-major (rows = K, features
// = N): 8-row groups 1024 bytes apart, 64-feature panels kPanelBytes.
__device__ __forceinline__ uint64_t desc_mn(uint32_t block, int kk) {
  return desc_sw128(block + kk * 16 * 128, kPanelBytes, 1024);
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

// Pin registers that an asynchronous wgmma reads or writes in place: the
// compiler may not move their reads or writes across this point, so
// calling it before wgmma_fence and after wgmma_wait keeps every other
// access outside the product's flight.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[0:32] (+)= a b over one 16-deep slice: a and b K-major in shared
// memory (descriptors); scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_ss_m64n64k16(float* d, uint64_t a,
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[0:32] += a b over one 16-deep slice: a an A fragment in registers,
// b MN-major in shared memory (descriptor, transposed read)
__device__ __forceinline__ void wgmma_rs_m64n64k16_tb(float* d,
                                                      const uint32_t* a,
                                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0:64] += a b over one 16-deep slice: a an A fragment in registers,
// b MN-major in shared memory (descriptor, transposed read)
__device__ __forceinline__ void wgmma_rs_m64n128k16_tb(float* d,
                                                      const uint32_t* a,
                                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// -- products of a warpgroup ----------------------------------------------

// d[64 x 64] = a b^T over D features: a and b 64-row blocks, K-major.
template <int D>
__device__ __forceinline__ void mma_rows(float (&d)[32], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_m64n64k16(d, desc_k(a, kk), desc_k(b, kk), kk > 0);
}

// The A fragments of a float32 accumulator (m64n64 layout), split in
// three bf16 terms: x = hi + mid + lo to float32's precision, hi =
// bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid) (each difference
// exact in float32). frag[term][kk] is the fragment of slice kk.
__device__ __forceinline__ void split_frags(const float (&acc)[32],
                                            uint32_t (&frag)[3][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x0 = acc[8 * kk + 2 * j], x1 = acc[8 * kk + 2 * j + 1];
#pragma unroll
      for (int term = 0; term < 3; ++term) {
        const __nv_bfloat162 r = __floats2bfloat162_rn(x0, x1);
        frag[term][kk][j] = *reinterpret_cast<const uint32_t*>(&r);
        const float2 f = __bfloat1622float2(r);
        x0 -= f.x;
        x1 -= f.y;
      }
    }
}

// d[64 x D] += a b over 64 rows: a the split fragments of a 64 x 64
// float32 tile, b a 64-row block read MN-major. The three terms go into
// the one float32 accumulator, the smallest first.
template <int D>
__device__ __forceinline__ void mma_split(float (&d)[D / 2],
                                          const uint32_t (&frag)[3][4][4],
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int term = 2; term >= 0; --term) {
      if constexpr (D == 64)
        wgmma_rs_m64n64k16_tb(d, frag[term][kk], desc_mn(b, kk));
      else
        wgmma_rs_m64n128k16_tb(d, frag[term][kk], desc_mn(b, kk));
    }
}

// The A fragments of a float32 accumulator (m64n64 layout) rounded to
// bf16, one cvt.rn.bf16x2 a pair (round to nearest even, as a float32 ->
// bf16 cast): frag[kk] is the fragment of slice kk.
__device__ __forceinline__ void round_frags(const float (&acc)[32],
                                            uint32_t (&frag)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 r =
          __floats2bfloat162_rn(acc[8 * kk + 2 * j], acc[8 * kk + 2 * j + 1]);
      frag[kk][j] = *reinterpret_cast<const uint32_t*>(&r);
    }
}

// d[64 x D] += a b over 64 rows: a the bf16 fragments of a 64 x 64 tile,
// b a 64-row block read MN-major.
template <int D>
__device__ __forceinline__ void mma_frags(float (&d)[D / 2],
                                          const uint32_t (&frag)[4][4],
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (D == 64)
      wgmma_rs_m64n64k16_tb(d, frag[kk], desc_mn(b, kk));
    else
      wgmma_rs_m64n128k16_tb(d, frag[kk], desc_mn(b, kk));
  }
}

// Row (0..63) and column of accumulator element e of warpgroup thread lt.
__device__ __forceinline__ int acc_row(int lt, int e) {
  return (lt / 32) * 16 + (lt % 32) / 4 + 8 * ((e / 2) % 2);
}

__device__ __forceinline__ int acc_col(int lt, int e) {
  return (e / 4) * 8 + 2 * (lt % 4) + e % 2;
}

}  // namespace sm90
}  // namespace flash
