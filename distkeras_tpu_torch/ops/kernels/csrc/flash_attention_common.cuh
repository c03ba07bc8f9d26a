// Shared pieces of the training flash-attention kernels for Hopper
// (flash_attention_fwd.cu, flash_attention_bwd.cu).
//
// Every kernel runs one CTA of 256 threads over one (batch row, head,
// 64-row tile) and stages 64-row tiles of q, k, v or dout as float32 in
// shared memory, in one or both of two layouts:
//   - feature-major [D][64] ("tr"): the operand of a 64 x 64 product
//     over the head dimension (s = q k^T, dp = dout v^T);
//   - row-major [64][D] ("rm"): the right operand of a product over the
//     64 rows of a staged tile (o += p v, dq += ds k, dv += p^T dout,
//     dk += ds^T q).
// D is the head dimension rounded up to 64 or 128; features d..D are
// staged as zeros, so they add nothing to any product and are never
// written out. Thread (ty, tx) = (tid / 16, tid % 16) owns rows
// ty*4..ty*4+3 of a 64 x 64 tile and columns tx*4..tx*4+3 (plus 64 more
// for every further 64 features), so each product step reads two 16-byte
// vectors of shared memory for 16 (or 32) fused multiply-adds, and a row
// reduction is a shuffle over the 16 lanes that share ty.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace flash {

constexpr int kTile = 64;      // rows of every staged tile (queries or keys)
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T's precision, as a float (identity for float)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ void unpack(const uint4& v, float* out, const float*) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void unpack(const uint4& v, float* out,
                                       const __nv_bfloat16*) {
  const auto* pairs = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(pairs[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

// Stage the kTile rows at src (row stride `stride` elements, d features)
// as float32, zero beyond d, into rm[kTile][D] and/or tr[D][kTile] (a null
// pointer skips that layout). 16-byte loads, all issued before any store.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src,
                                           size_t stride, int d, float* rm,
                                           float* tr) {
  constexpr int kVec = 16 / sizeof(T);  // elements in one 16-byte load
  constexpr int kRowVecs = D / kVec;
  static_assert((kTile * kRowVecs) % kThreads == 0, "tile must split evenly");
  constexpr int kIters = kTile * kRowVecs / kThreads;
  uint4 buf[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kRowVecs, c0 = (i % kRowVecs) * kVec;
    buf[it] = make_uint4(0u, 0u, 0u, 0u);
    if (c0 < d)  // d % 8 == 0, so a vector is all in or all out
      buf[it] = *reinterpret_cast<const uint4*>(src + r * stride + c0);
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kRowVecs, c0 = (i % kRowVecs) * kVec;
    float vals[kVec];
    unpack(buf[it], vals, static_cast<const T*>(nullptr));
    if (rm != nullptr) {
#pragma unroll
      for (int e = 0; e < kVec; e += 4)
        *reinterpret_cast<float4*>(rm + r * D + c0 + e) =
            make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
    }
    if (tr != nullptr) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) tr[(c0 + e) * kTile + r] = vals[e];
    }
  }
}

// acc[i][j] += sum_{c < d} a[c][ra + i] * b[c][rb + j] over two
// feature-major tiles: a 4 x 4 block of a 64 x 64 product over features.
__device__ __forceinline__ void mm_tt(const float* __restrict__ a,
                                      const float* __restrict__ b, int d,
                                      int ra, int rb, float acc[4][4]) {
#pragma unroll 8
  for (int c = 0; c < d; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(a + c * kTile + ra);
    const float4 y = *reinterpret_cast<const float4*>(b + c * kTile + rb);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
  }
}

// acc[i][kk*4 + e] += sum_{j < kTile} p[j][rp + i] * b[j][kk*64 + cb + e]:
// p is a [kTile][kTile] tile (row j = the summed index), b row-major
// [kTile][D]; a 4-row by D/16-column block of the [64][D] result.
template <int D>
__device__ __forceinline__ void mm_pn(const float* __restrict__ p,
                                      const float* __restrict__ b, int rp,
                                      int cb, float acc[4][D / 16]) {
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    const float4 x = *reinterpret_cast<const float4*>(p + j * kTile + rp);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int kk = 0; kk < D / 64; ++kk) {
      const float4 y =
          *reinterpret_cast<const float4*>(b + j * D + kk * 64 + cb);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][kk * 4 + 0] = fmaf(xs[i], y.x, acc[i][kk * 4 + 0]);
        acc[i][kk * 4 + 1] = fmaf(xs[i], y.y, acc[i][kk * 4 + 1]);
        acc[i][kk * 4 + 2] = fmaf(xs[i], y.z, acc[i][kk * 4 + 2]);
        acc[i][kk * 4 + 3] = fmaf(xs[i], y.w, acc[i][kk * 4 + 3]);
      }
    }
  }
}

// Store the 4 x 4 block v[i][j] of rows ri + i, columns cj + j transposed
// into a [kTile][kTile] tile: out[cj + j][ri + i] (16-byte stores).
__device__ __forceinline__ void store_block_t(float* out, int ri, int cj,
                                              const float v[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(out + (cj + j) * kTile + ri) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
}

// Reductions over the 16 lanes that share ty (lanes 0-15 or 16-31).
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Write a 4-row by D/16-column register block (rows ri + i, columns
// kk*64 + cb + e, those below d only) of a [kTile][d] tile at dst (row
// stride `stride`) in T.
template <typename T, int D>
__device__ __forceinline__ void write_block(T* __restrict__ dst, size_t stride,
                                            int d, int ri, int cb,
                                            const float acc[4][D / 16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int kk = 0; kk < D / 64; ++kk) {
      const int c = kk * 64 + cb;
      if (c < d) {  // d % 8 == 0: the 4 columns are all in or all out
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dst[(ri + i) * stride + c + e] = from_f<T>(acc[i][kk * 4 + e]);
      }
    }
}

// Which devices a kernel has been opted into its dynamic shared memory
// on: cudaFuncSetAttribute acts on the current device, so a launch on
// another card opts in again. A slot a device; two threads that race on
// one device both set the same attribute.
constexpr int kMaxDevices = 64;
struct SmemOptIn {
  std::atomic<bool> done[kMaxDevices] = {};
};

// Opt a kernel into `bytes` of dynamic shared memory (above the 48 KiB
// default) on its first use on the current device.
template <typename Kernel>
__host__ cudaError_t opt_in_smem(Kernel kernel, size_t bytes,
                                 SmemOptIn* record) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (record->done[device].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess)
    record->done[device].store(true, std::memory_order_release);
  return err;
}

}  // namespace flash
