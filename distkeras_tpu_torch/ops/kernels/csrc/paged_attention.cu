// Paged attention for Hopper (sm_90a): decode and prefill attention over a
// KV page pool indexed by a page table.
//
// Replaces distkeras_tpu/ops/pallas/flash_attention.py::_paged_kernel (the
// TPU kernel behind paged_flash_attention). It computes the same function:
// for batch row b, query i of the in-call block and key position p,
//   logits = (q . k_p) rounded to the input dtype, times head_dim^-0.5,
//   masked to MASK_VALUE unless p <= cache_index[b] + i,
//   P = softmax(logits) in float32 (fixed length: exp(x - max) / sum),
//   rounded to the input dtype,
//   out = P . V accumulated in float32, stored in the input dtype,
// with key p read from pages[page_table[b, p / page_size], p % page_size].
//
// What bounds it: bytes. A decode step reads every visible K/V cell once
// (2 * keys * head_dim * itemsize per head) for 4 * head_dim flops a key per
// query; at t = 2 queries that is ~1 flop per byte, far below the card's
// ~295 flops/byte ridge. The design therefore spends nothing on tensor
// cores and aims only at reading each visible cell once:
//   - one CTA per (query tile of 16, head, batch row); it walks the row's
//     page table itself (the TPU kernel's scalar prefetch becomes a plain
//     load of page_table[b, j]);
//   - keys past the tile's last visible position (cache_index + last query)
//     have exactly zero softmax weight, so they are never read;
//   - K, then V, are staged 64 keys at a time in shared memory with 16-byte
//     loads, all of a thread's loads issued before any is used, so that
//     they overlap instead of each waiting out its page-table read; rows
//     are padded by one float so that lanes on neighbouring keys hit
//     distinct banks;
//   - the f32 logits of the tile, [16, max_len], stay in dynamic shared
//     memory (64 KiB at max_len 1024, above the 48 KiB default, hence the
//     cudaFuncSetAttribute opt-in); the wrapper's paged_fits() refuses
//     shapes whose buffer exceeds the card's opt-in limit.
// Not done here (later work): split-K over pages for small batch, online
// softmax, cp.async/TMA staging, wgmma for long prefill tiles.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the cudaError_t of the launch. The page pools must be
// 16-byte aligned (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cfloat>

namespace {

constexpr int kTileQ = 16;    // queries per CTA
constexpr int kChunk = 64;    // keys staged in shared memory at a time
constexpr int kThreads = 128;

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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

// Stage keys [c0, c0 + nk) of one head into kv[kChunk][D + 1] as floats.
// Each thread issues all of its 16-byte loads (page-table reads first)
// before it converts and stores any, so the loads are in flight together.
template <typename T, int D>
__device__ __forceinline__ void stage_chunk(float* kv, const T* __restrict__ pages,
                                            const int32_t* __restrict__ pt,
                                            int c0, int nk, int h, int hh,
                                            int page_size) {
  constexpr int kVec = 16 / sizeof(T);      // elements in one 16-byte load
  constexpr int kRowVecs = D / kVec;        // loads per key row
  static_assert((kChunk * kRowVecs) % kThreads == 0, "chunk must split evenly");
  constexpr int kIters = kChunk * kRowVecs / kThreads;
  uint4 buf[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kRowVecs, cv = i % kRowVecs;
    buf[it] = make_uint4(0u, 0u, 0u, 0u);
    if (r < nk) {
      const int p = c0 + r;
      const size_t page = static_cast<size_t>(pt[p / page_size]);
      buf[it] = *reinterpret_cast<const uint4*>(
          pages + ((page * page_size + p % page_size) * h + hh) * D + cv * kVec);
    }
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kRowVecs, cv = i % kRowVecs;
    float vals[kVec];
    unpack(buf[it], vals, static_cast<const T*>(nullptr));
#pragma unroll
    for (int e = 0; e < kVec; ++e) kv[r * (D + 1) + cv * kVec + e] = vals[e];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int32_t* __restrict__ page_table,
                       const int32_t* __restrict__ cache_index,
                       T* __restrict__ out, int t, int h, int page_size,
                       int pmax, float scale, float mask_value) {
  static_assert((kTileQ * D) % kThreads == 0, "tile must split evenly");
  constexpr int kPerThread = kTileQ * D / kThreads;
  extern __shared__ float smem[];
  const int max_len = pmax * page_size;
  float* logits = smem;                       // [kTileQ][max_len]
  float* qs = logits + kTileQ * max_len;      // [kTileQ][D]
  float* kv = qs + kTileQ * D;                // [kChunk][D + 1]

  const int q0 = blockIdx.x * kTileQ;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nq = min(kTileQ, t - q0);
  const int ci = cache_index[b];
  // the tile's last query sees keys up to ci + q0 + nq - 1; later keys
  // carry exactly zero weight and are never read
  const int n_keys = min(max_len, ci + q0 + nq);
  const int32_t* pt = page_table + static_cast<size_t>(b) * pmax;

  for (int i = tid; i < kTileQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[i] = r < nq
        ? to_f(q[((static_cast<size_t>(b) * t + q0 + r) * h + hh) * D + c])
        : 0.f;
  }

  // logits = q . k, rounded to T, scaled, masked
  for (int c0 = 0; c0 < n_keys; c0 += kChunk) {
    const int nk = min(kChunk, n_keys - c0);
    __syncthreads();  // qs written / previous chunk consumed
    stage_chunk<T, D>(kv, k_pages, pt, c0, nk, h, hh, page_size);
    __syncthreads();
    for (int i = tid; i < kTileQ * kChunk; i += kThreads) {
      const int r = i / kChunk, j = i % kChunk;
      if (r < nq && j < nk) {
        float s = 0.f;
#pragma unroll 16
        for (int c = 0; c < D; ++c) s = fmaf(qs[r * D + c], kv[j * (D + 1) + c], s);
        const int p = c0 + j;
        logits[r * max_len + p] =
            p <= ci + q0 + r ? round_to<T>(s) * scale : mask_value;
      }
    }
  }
  __syncthreads();

  // fixed-length softmax per row, one warp a row; P rounded to T
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < nq; r += kThreads / 32) {
    float* row = logits + r * max_len;
    float m = -FLT_MAX;
    for (int p = lane; p < n_keys; p += 32) m = fmaxf(m, row[p]);
    m = warp_max(m);
    float sum = 0.f;
    for (int p = lane; p < n_keys; p += 32) {
      const float e = expf(row[p] - m);
      row[p] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int p = lane; p < n_keys; p += 32) row[p] = round_to<T>(row[p] / sum);
  }

  // out = P . V, f32 accumulators; thread owns outputs tid + k * kThreads
  float acc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) acc[k] = 0.f;
  for (int c0 = 0; c0 < n_keys; c0 += kChunk) {
    const int nk = min(kChunk, n_keys - c0);
    __syncthreads();  // softmax done / previous chunk consumed
    stage_chunk<T, D>(kv, v_pages, pt, c0, nk, h, hh, page_size);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = tid + k * kThreads;
      const int r = i / D, c = i % D;
      if (r < nq) {
        const float* prow = logits + r * max_len + c0;
        float a = acc[k];
        for (int j = 0; j < nk; ++j) a = fmaf(prow[j], kv[j * (D + 1) + c], a);
        acc[k] = a;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = tid + k * kThreads;
    const int r = i / D, c = i % D;
    if (r < nq)
      out[((static_cast<size_t>(b) * t + q0 + r) * h + hh) * D + c] = from_f<T>(acc[k]);
  }
}

size_t smem_bytes(int max_len, int d) {
  return sizeof(float) *
         (static_cast<size_t>(kTileQ) * max_len + kTileQ * d + kChunk * (d + 1));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int32_t* page_table, const int32_t* cache_index,
                   void* out, int b, int t, int h, int page_size, int pmax,
                   float scale, float mask_value, cudaStream_t stream) {
  const size_t smem = smem_bytes(pmax * page_size, D);
  // opt in above the 48 KiB default once per instantiation and size
  static size_t opted_in = 0;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  const dim3 grid((t + kTileQ - 1) / kTileQ, h, b);
  paged_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), page_table, cache_index,
      static_cast<T*>(out), t, h, page_size, pmax, scale, mask_value);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k_pages,
                     const void* v_pages, const int32_t* page_table,
                     const int32_t* cache_index, void* out, int b, int t,
                     int h, int page_size, int pmax, float scale,
                     float mask_value, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k_pages, v_pages, page_table, cache_index, out, b, t,
                           h, page_size, pmax, scale, mask_value, stream);
    case 64:
      return launch<T, 64>(q, k_pages, v_pages, page_table, cache_index, out, b, t,
                           h, page_size, pmax, scale, mask_value, stream);
    case 128:
      return launch<T, 128>(q, k_pages, v_pages, page_table, cache_index, out, b,
                            t, h, page_size, pmax, scale, mask_value, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int paged_attention_launch(int dtype, const void* q, const void* k_pages,
                           const void* v_pages, const void* page_table,
                           const void* cache_index, void* out, int b, int t,
                           int h, int d, int page_size, int pmax, float scale,
                           float mask_value, void* stream) {
  const auto* pt = static_cast<const int32_t*>(page_table);
  const auto* ci = static_cast<const int32_t*>(cache_index);
  auto s = static_cast<cudaStream_t>(stream);
  if (b < 1 || t < 1 || h < 1 || page_size < 1 || pmax < 1)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_d<float>(d, q, k_pages, v_pages, pt, ci, out, b, t, h,
                           page_size, pmax, scale, mask_value, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(d, q, k_pages, v_pages, pt, ci, out, b, t,
                                   h, page_size, pmax, scale, mask_value, s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory one CTA needs at this max_len and head_dim.
size_t paged_attention_smem_bytes(int max_len, int d) {
  return smem_bytes(max_len, d);
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
