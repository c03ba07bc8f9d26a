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
// output: the two about equal. This first version uses the tensor cores
// through mma.sync (m16n8k32 s8 x s8 -> s32), not wgmma, so it cannot
// reach the bound; wgmma with TMA is later work. What the design does:
//   - one CTA of 8 warps per 128 x 128 output tile; each warp owns a
//     64 x 32 sub-tile (4 x 4 mma tiles, 64 int32 accumulators a thread)
//     for the whole K loop, so the int32 sums never leave registers and
//     the dequant is fused into the single store (the TPU kernel's VMEM
//     accumulator);
//   - 64-deep K tiles of A and B are copied to shared memory with 16-byte
//     cp.async in two stages, the next tile in flight while the tensor
//     cores consume the current one; rows are padded to 80 bytes so the
//     32-bit fragment loads of a warp hit 32 distinct banks;
//   - ragged M and N edges are masked (zero-filled loads, guarded
//     stores); K must be a multiple of 16 (the 16-byte copies), which the
//     wrapper checks.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the cudaError_t of the launch. Operands and output are
// contiguous with 16-byte aligned bases.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kPitch = kBK + 16;  // bytes per shared-memory row

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Copy the 128 x 64 tiles of qx (rows m0..) and qw (rows n0..) at depth k0
// into one stage: 512 16-byte chunks each, two of each per thread.
__device__ __forceinline__ void load_tiles(
    uint8_t (*as)[kPitch], uint8_t (*bs)[kPitch], const int8_t* qx,
    const int8_t* qw, int M, int N, int K, int m0, int n0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kThreads;
    const int row = c >> 2;
    const int col = (c & 3) * 16;
    const int gk = k0 + col;
    const bool a_ok = m0 + row < M && gk < K;
    const bool b_ok = n0 + row < N && gk < K;
    cp_async16(&as[row][col],
               a_ok ? qx + static_cast<int64_t>(m0 + row) * K + gk : qx,
               a_ok ? 16 : 0);
    cp_async16(&bs[row][col],
               b_ok ? qw + static_cast<int64_t>(n0 + row) * K + gk : qw,
               b_ok ? 16 : 0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ qx,
                   const int8_t* __restrict__ qw,
                   const float* __restrict__ sxw, T* __restrict__ out, int M,
                   int N, int K) {
  __shared__ __align__(16) uint8_t as[2][kBM][kPitch];
  __shared__ __align__(16) uint8_t bs[2][kBN][kPitch];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma group id
  const int t = lane & 3;   // thread in group
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int k_tiles = (K + kBK - 1) / kBK;
  load_tiles(as[0], bs[0], qx, qw, M, N, K, m0, n0, 0, tid);
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < k_tiles) {
      load_tiles(as[s ^ 1], bs[s ^ 1], qx, qw, M, N, K, m0, n0,
                 (kt + 1) * kBK, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[4][4];
      uint32_t b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm + i * 16 + g;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&as[s][r][kk + 4 * t]);
        a[i][1] =
            *reinterpret_cast<const uint32_t*>(&as[s][r + 8][kk + 4 * t]);
        a[i][2] =
            *reinterpret_cast<const uint32_t*>(&as[s][r][kk + 16 + 4 * t]);
        a[i][3] = *reinterpret_cast<const uint32_t*>(
            &as[s][r + 8][kk + 16 + 4 * t]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + j * 8 + g;
        b[j][0] = *reinterpret_cast<const uint32_t*>(&bs[s][c][kk + 4 * t]);
        b[j][1] =
            *reinterpret_cast<const uint32_t*>(&bs[s][c][kk + 16 + 4 * t]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // epilogue: int32 -> float32 (round to nearest), times sxw, one rounding
  // to T; c0, c1 are (row g, cols 2t, 2t+1), c2, c3 the same at row g + 8
  const float scale = *sxw;
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + 8 * h;
        if (row >= M || col >= N) continue;
        const float v0 = __fmul_rn(__int2float_rn(acc[i][j][2 * h]), scale);
        const float v1 =
            __fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), scale);
        T* p = out + static_cast<int64_t>(row) * N + col;
        if (pairs) {
          store2(p, v0, v1);
        } else {
          store1(p, v0);
          if (col + 1 < N) store1(p + 1, v1);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* qx, const void* qw, const void* sxw,
                   void* out, int m, int n, int k, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  int8_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(qx), static_cast<const int8_t*>(qw),
      static_cast<const float*>(sxw), static_cast<T*>(out), m, n, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out_dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t
// (0 = launched).
int int8_matmul_dequant_launch(int out_dtype, const void* qx, const void* qw,
                               const void* sxw, void* out, int m, int n,
                               int k, void* stream) {
  if (m < 1 || n < 1 || k < 16 || k % 16 || (m + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return launch<float>(qx, qw, sxw, out, m, n, k, s);
  if (out_dtype == 1)
    return launch<__nv_bfloat16>(qx, qw, sxw, out, m, n, k, s);
  return cudaErrorInvalidValue;
}

const char* int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
