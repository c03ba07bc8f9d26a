// Scaled int8 matrix product for Hopper (sm_90a):
//   out[m, n] = float(sum_k qx[m, k] * qw[n, k]) * sxw
// with qx int8 [M, K], qw int8 [N, K] (the nn.Linear weight layout, K
// contiguous in both), the sum exact in int32, converted to float32
// round-to-nearest and multiplied by the float32 scalar sxw (the product
// of the two per-tensor scales, read from device memory), then rounded
// once to the output dtype (float32 or bfloat16).
//
// Replaces distkeras_tpu/ops/pallas/int8_matmul.py::_matmul_kernel (the
// TPU kernel behind int8_matmul_dequant, the product of
// precision._int8_dot_impl). The result is exact up to the one rounding
// of the epilogue, so it matches the plain version bitwise.
//
// What bounds it on this card: at GPT-2-small's shapes (M = 16384,
// K in {768, 3072}, N in {2304, 768, 3072}) the 2*M*N*K int8 operations
// take 10-39 us at the 1,979 TOP/s int8 tensor-core rate, and the bytes
// (operands once, the output once) 11-35 us at 3.35 TB/s with a bfloat16
// output: the two about equal. The main loop below runs at the tensor
// cores' rate; what is left over the bound is mostly the epilogue's
// stores (PERF.md). What the design does:
//   - operands by TMA: a 128-deep K slice is 128 int8, one 128-byte
//     swizzle row, so a stage holds qx [128 rows][128] and qw [256
//     rows][128] in the layout of flash_attention_sm90.cuh (its K-major
//     descriptors read them); both operands are K-major, as int8 wgmma
//     requires. TMA fills the K tail and the ragged M and N edges with
//     zeros. Four stages of 48 KB in a ring of full/empty mbarriers;
//   - one producer warpgroup (one thread issues the copies; registers
//     given up with setmaxnreg) and two consumer warpgroups, each owning
//     64 x 256 of the 128 x 256 output tile: wgmma m64n256k32 s8 from
//     shared memory into 128 int32 accumulators a thread for the whole K
//     loop, one product group kept in flight while the previous stage is
//     released;
//   - persistent CTAs, one an SM: CTA b takes tiles b, b + grid, ... in
//     row-major tile order (the N tiles of one M panel of qx in turn,
//     while that panel stays in L2), so the producer loads the next
//     tile's stages while the consumers store this one;
//   - epilogue: int32 -> float32 (round to nearest) times sxw (read once
//     a CTA), one rounding to the output type; each warp stages its 16
//     rows 128 bytes of output at a time in a ring of two swizzled
//     buffers and lane 0 stores each by TMA, so the warp goes on to the
//     next 128 bytes and the next tile while the copy drains; TMA drops
//     what lies past the ragged rows and columns. Where the output's row
//     pitch is not a multiple of 16 bytes (N * itemsize % 16 != 0: TMA
//     cannot map it) the same kernel stores those buffers a value at a
//     time, masked.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the cudaError_t of the launch. Operands and output are
// contiguous with 16-byte aligned bases. The tensor maps are built on the
// host for each call by libcuda's cuTensorMapEncodeTiled, found with
// cudaGetDriverEntryPoint (so nothing links against libcuda), and passed
// as __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

#include "flash_attention_sm90.cuh"

namespace {

namespace sm90 = flash::sm90;

constexpr int kBM = 128;     // output rows a tile (two warpgroups of 64)
constexpr int kBN = 256;     // output columns a tile
constexpr int kBK = 128;     // int8 a K slice: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kConsumers = 2;  // warpgroups
constexpr int kThreads = (kConsumers + 1) * sm90::kWarpgroup;
constexpr uint32_t kABytes = kBM * kBK;
constexpr uint32_t kStageBytes = kABytes + kBN * kBK;
constexpr uint32_t kChunkBytes = 16 * 128;  // a warp's 16 rows x 128 bytes
constexpr int kEpiChunks = 2;               // a warp's ring of them
constexpr uint32_t kEpiBytes = 4 * kEpiChunks * kChunkBytes;  // a warpgroup
constexpr int kSmemBytes = 1024 + kStages * kStageBytes +
                           kConsumers * kEpiBytes + 2 * kStages * 8;
constexpr int kMaxTilesM = 65535;
constexpr int kMaxDevices = 64;

// The schedule of one call (int8_matmul.py ``plan`` computes the same).
struct Plan {
  int block_m, block_n, block_k, stages, tiles_m, tiles_n, grid, wide_store,
      threads, smem;
};

bool make_plan(int out_dtype, int m, int n, int k, int sms, Plan* p) {
  if ((out_dtype != 0 && out_dtype != 1) || m < 1 || n < 1 || k < 16 ||
      k % 16 || sms < 1)
    return false;
  const int itemsize = out_dtype == 0 ? 4 : 2;
  const int tiles_m = (m + kBM - 1) / kBM;
  const int tiles_n = (n + kBN - 1) / kBN;
  const long long tiles = static_cast<long long>(tiles_m) * tiles_n;
  if (tiles_m > kMaxTilesM || tiles > INT_MAX) return false;
  *p = {kBM, kBN, kBK, kStages, tiles_m, tiles_n,
        static_cast<int>(tiles < sms ? tiles : sms),
        (static_cast<long long>(n) * itemsize) % 16 == 0, kThreads,
        kSmemBytes};
  return true;
}

// -- barriers and copies ------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Box (c0 = K offset, c1 = row offset) of a 2-D tensor map into shared
// memory at dst; completion counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Box (c0 = column, c1 = row) of a 2-D tensor map from shared memory at
// src, in this thread's bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's bulk stores still read shared memory.
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// d[0:128] (+)= a b over one 32-deep slice: a (64 rows) and b (256 rows)
// int8, K-major in shared memory (descriptors); scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_m64n256k32_s8(uint32_t* d, uint64_t a,
                                                    uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
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
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

// -- epilogue -------------------------------------------------------------

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Rows row0..row0+63 (this warpgroup's) by columns n0..n0+255 of out from
// the accumulators (wgmma's m64n256 layout: element 4g + 2h + j of
// thread lt at row (lt / 32) * 16 + (lt % 32) / 4 + 8h, column 8g +
// 2 (lt % 4) + j). Each warp stores its own 16 rows, 128 bytes of each
// at a time, through a ring of kEpiChunks buffers at `buf` (16 rows of
// 128 bytes each, 16-byte chunk c of row r at chunk c ^ (r % 8): TMA's
// 128-byte swizzle), so only the warp synchronises. Where the row pitch
// allows (wide), lane 0 stores a buffer by TMA and the warp goes on; else
// the warp stores it a value at a time.
template <typename T>
__device__ __forceinline__ void store_tile(const uint32_t (&acc)[128],
                                           float scale, T* __restrict__ out,
                                           const CUtensorMap* map_out, int m,
                                           int n, int row0, int n0,
                                           uint8_t* buf, uint32_t buf_addr,
                                           int lt, bool wide) {
  const int warp = lt / 32, lane = lt % 32;
  row0 += 16 * warp;
  if (row0 >= m) return;  // the same for the whole warp
  constexpr int kItem = sizeof(T);
  constexpr int kCols = 128 / kItem;  // columns a chunk
  constexpr int kGroups = kCols / 8;  // accumulator groups a chunk
  constexpr int kVec = 16 / kItem;    // values a 16-byte piece
  static_assert((kBN / kCols) % kEpiChunks == 0, "ring must divide a tile");
  buf += warp * kEpiChunks * kChunkBytes;
  buf_addr += warp * kEpiChunks * kChunkBytes;
  const int r = lane / 4, t = lane % 4;
#pragma unroll
  for (int ch = 0; ch < kBN / kCols; ++ch) {
    const int c0 = n0 + ch * kCols;
    if (c0 >= n) break;  // the same for the whole warp
    const uint32_t slot = (ch % kEpiChunks) * kChunkBytes;
    if (lane == 0) {  // the last store from this buffer has read it
      if (ch == 0)
        tma_store_wait_read<0>();  // a tile may have had fewer chunks
      else
        tma_store_wait_read<kEpiChunks - 1>();
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 4 * (ch * kGroups + g) + 2 * h;
        const int row = r + 8 * h, byte = (8 * g + 2 * t) * kItem;
        store2(reinterpret_cast<T*>(buf + slot + row * 128 +
                                    ((((byte >> 4) ^ row % 8) << 4) |
                                     (byte & 15))),
               __fmul_rn(__int2float_rn(static_cast<int>(acc[e])), scale),
               __fmul_rn(__int2float_rn(static_cast<int>(acc[e + 1])),
                         scale));
      }
    if (wide) {
      sm90::fence_proxy_async();  // TMA reads through the async proxy
      __syncwarp();
      if (lane == 0) tma_store(map_out, buf_addr + slot, c0, row0);
      continue;
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int row = it * 4 + lane / 8, c = lane % 8;
      const int gr = row0 + row, gc = c0 + c * kVec;
      if (gr >= m || gc >= n) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(
          buf + slot + row * 128 + ((c ^ row % 8) << 4));
      const T* vals = reinterpret_cast<const T*>(&v);
      T* dst = out + static_cast<int64_t>(gr) * n + gc;
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        if (gc + j < n) dst[j] = vals[j];
    }
  }
}

// -- the kernel ---------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
int8_matmul_sm90(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_out,
                 const float* __restrict__ sxw, T* __restrict__ out, int m,
                 int n, int k, int tiles_n, int num_tiles, int wide) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = (sm90::smem_addr(smem) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem + (base - sm90::smem_addr(smem));
  const uint32_t epi = kStages * kStageBytes;  // offset from base
  const uint32_t full = base + epi + kConsumers * kEpiBytes;
  const uint32_t empty = full + kStages * 8;
  const int wg = threadIdx.x / sm90::kWarpgroup;
  const int lt = threadIdx.x % sm90::kWarpgroup;
  const int k_tiles = (k + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * 4);  // a warp's lane 0 each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring's copies in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (lt == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_x))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_w))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          const uint32_t a = base + stage * kStageBytes;
          mbar_expect_tx(bar, kStageBytes);
          tma_load(a, &map_x, bar, kt * kBK, m0);
          tma_load(a + kABytes, &map_w, bar, kt * kBK, n0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of a tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const float scale = *sxw;
    uint8_t* const buf = base_ptr + epi + cw * kEpiBytes;
    const uint32_t buf_addr = base + epi + cw * kEpiBytes;
    uint32_t acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
      int held = 0;  // the stage whose product may still be in flight
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t a =
            base + stage * kStageBytes + cw * (sm90::kRows * kBK);
        const uint32_t b = base + stage * kStageBytes + kABytes;
        sm90::fence_regs<128>(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)
          wgmma_m64n256k32_s8(acc, sm90::desc_k(a, kk), sm90::desc_k(b, kk),
                              kt > 0 || kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // the previous stage's products are done
        if (kt > 0 && lt % 32 == 0) mbar_arrive(empty + 8 * held);
        held = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs<128>(acc);
      if (lt % 32 == 0) mbar_arrive(empty + 8 * held);
      store_tile<T>(acc, scale, out, &map_out, m, n, m0 + cw * sm90::kRows,
                    n0, buf, buf_addr, lt, wide != 0);
    }
    if (lt % 32 == 0)  // this warp's stores are done
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// -- host ---------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once (null if missing).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Map of an int8 [rows, k] row-major operand in boxes of box_rows x kBK,
// 128-byte swizzled; reads outside the tensor give zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
              int rows, int k, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
                dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Map of the [m, n] output in boxes of 16 rows x 128 bytes, 128-byte
// swizzled (needs n * itemsize % 16 == 0); writes outside are dropped.
bool make_out_map(EncodeTiled encode, CUtensorMap* map, void* ptr,
                  int out_dtype, int m, int n) {
  const int item = out_dtype == 0 ? 4 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(m)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * item};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / item), 16};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map,
                out_dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, ptr, dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Streaming multiprocessors of the current device, asked once a device.
cudaError_t sm_count(int* sms, int* device) {
  static std::atomic<int> counts[kMaxDevices];
  cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  if (*device < 0 || *device >= kMaxDevices) return cudaErrorInvalidDevice;
  *sms = counts[*device].load();
  if (*sms == 0) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                 *device);
    if (err != cudaSuccess) return err;
    counts[*device].store(*sms);
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const Plan& p, int device, const CUtensorMap& map_x,
                   const CUtensorMap& map_w, const CUtensorMap& map_out,
                   const void* sxw, void* out,
                   int m, int n, int k, cudaStream_t stream) {
  static std::atomic<bool> opted_in[kMaxDevices];
  if (!opted_in[device].load()) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_matmul_sm90<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        p.smem);
    if (err != cudaSuccess) return err;
    opted_in[device].store(true);
  }
  int8_matmul_sm90<T><<<p.grid, p.threads, p.smem, stream>>>(
      map_x, map_w, map_out, static_cast<const float*>(sxw),
      static_cast<T*>(out), m, n, k, p.tiles_n, p.tiles_m * p.tiles_n,
      p.wide_store);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The schedule a launch of these arguments takes on the current device, as
// ten ints in Plan's order. Returns a cudaError_t (0 = valid).
int int8_matmul_plan(int out_dtype, int m, int n, int k, int* fields) {
  int sms = 0, device = 0;
  const cudaError_t err = sm_count(&sms, &device);
  if (err != cudaSuccess) return err;
  Plan p;
  if (!make_plan(out_dtype, m, n, k, sms, &p)) return cudaErrorInvalidValue;
  const int values[10] = {p.block_m, p.block_n,    p.block_k, p.stages,
                          p.tiles_m, p.tiles_n,    p.grid,    p.wide_store,
                          p.threads, p.smem};
  for (int i = 0; i < 10; ++i) fields[i] = values[i];
  return cudaSuccess;
}

// out_dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t
// (0 = launched).
int int8_matmul_dequant_launch(int out_dtype, const void* qx, const void* qw,
                               const void* sxw, void* out, int m, int n,
                               int k, void* stream) {
  int sms = 0, device = 0;
  cudaError_t err = sm_count(&sms, &device);
  if (err != cudaSuccess) return err;
  Plan p;
  if (!make_plan(out_dtype, m, n, k, sms, &p)) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap map_x, map_w, map_out = {};
  if (!make_map(encode, &map_x, qx, m, k, kBM) ||
      !make_map(encode, &map_w, qw, n, k, kBN) ||
      (p.wide_store && !make_out_map(encode, &map_out, out, out_dtype, m, n)))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return launch<float>(p, device, map_x, map_w, map_out, sxw, out, m, n, k,
                         s);
  return launch<__nv_bfloat16>(p, device, map_x, map_w, map_out, sxw, out, m,
                               n, k, s);
}

const char* int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
