// Paged attention for Hopper (sm_90a): decode and prefill attention over a
// KV page pool indexed by a page table, split over the keys (split-K).
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
// ~295 flops/byte ridge, so nothing here uses the tensor cores. What the
// design does about the bytes, and about a context of any length:
//   - the keys of a row are cut into splits of `split` keys (64, 128 or
//     256, chosen by the wrapper from max_len and batch rows x heads), and
//     one CTA takes one (split, head and batch row, 16-query tile): at
//     decode b = 8 that is 8 splits x 96 heads and rows where one CTA per
//     head and row left most of the 132 SMs idle behind one chain of
//     dependent loads;
//   - a CTA whose split starts past the tile's last visible key
//     (cache_index + last query) exits at once: keys that carry exactly
//     zero weight are never read;
//   - K, then V, are staged 64 keys at a time by cp.async (16-byte copies
//     when a row is a whole number of 16-byte chunks, plain loads
//     otherwise), two stages deep, features d..D zero-filled, rows padded
//     by 16 bytes so that lanes on neighbouring keys hit distinct banks;
//   - no buffer grows with the context: the logits go to a float32
//     workspace in device memory, so any max_len and any head_dim up to
//     256 are taken (D = 64, 128 and 256 instantiations; at D = 256 a
//     float32 CTA stages 133 KB of K or V, under the 227 KB opt-in).
// Because P is rounded only after it is divided by the whole row's sum, a
// one-pass online softmax per split would round differently. A call is
// therefore two launches:
//   1. paged_logits_kernel: the split's logits (rounded, scaled, masked)
//      into the workspace [b, h, t, nsplit * split], and per query the split's
//      (m_s, l_s = sum exp(x - m_s)) over its visible keys;
//   2. paged_values_kernel: each CTA combines its row's split statistics
//      (m = max m_s, l = sum l_s exp(m_s - m), in one fixed order, so every
//      CTA of a row gets the same l bit for bit), forms
//      P = round(exp(x - m) / l), and accumulates P . V for its split into
//      a float32 partial; an arrival counter per (row, head, tile) lets
//      the last CTA sum the partials in split order, write out and reset
//      the counter. A tile that sees one split only writes out directly.
//      It is launched as the first kernel's programmatic dependent, so it
//      starts, and requests its first V chunk, while the first finishes.
// No spin-wait, no host read, no size from device data: the workspace and
// the grid depend on shapes only, and the result is deterministic.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the cudaError_t of the first launch that fails. The
// counters must be zero before the first call and one caller stream at a
// time may use them (each call leaves them zero).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTileQ = 16;    // queries per CTA
constexpr int kChunk = 64;    // keys staged in shared memory at a time
constexpr int kThreads = 128;
constexpr int kMaxSplit = 256;

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
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void unpack(const uint4& v, float* out,
                                       const float*) {
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d =
      static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
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

// Programmatic dependent launch (Hopper): the logits kernel lets the
// values kernel be scheduled as soon as all of its own CTAs have started,
// and the values kernel waits for the logits kernel's completion (and its
// writes) only where it first reads them. Without the launch attribute
// the wait returns at once.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Shared row stride of a staged chunk, in elements: D plus 16 bytes, so
// that the 8 lanes of a 16-byte access phase, on 8 neighbouring keys, hit
// distinct banks.
template <typename T, int D>
__host__ __device__ constexpr int row_stride() {
  return D + 16 / static_cast<int>(sizeof(T));
}

template <typename T, int D>
__host__ __device__ constexpr size_t chunk_bytes() {
  return sizeof(T) * kChunk * row_stride<T, D>();
}

// Stage keys [p0, p0 + nk) of head hh into kv[kChunk][row_stride] (T):
// zeros for features d..D and rows nk..kChunk. kVec: 16-byte cp.async
// copies (d * sizeof(T) % 16 == 0 and the pool 16-byte aligned); else
// plain element loads. Commit and wait are the caller's.
template <typename T, int D, bool kVec>
__device__ __forceinline__ void stage_chunk(T* kv, const T* __restrict__ pages,
                                            const int32_t* __restrict__ pt,
                                            int p0, int nk, int h, int hh,
                                            int d, int page_size) {
  constexpr int kStride = row_stride<T, D>();
  if constexpr (kVec) {
    constexpr int kV = 16 / sizeof(T);  // elements in one 16-byte copy
    constexpr int kRowVecs = D / kV;
    for (int i = threadIdx.x; i < kChunk * kRowVecs; i += kThreads) {
      const int r = i / kRowVecs, c = (i % kRowVecs) * kV;
      const bool in = r < nk && c < d;
      const T* src = pages;  // a valid address when nothing is copied
      if (in) {
        const int p = p0 + r;
        const size_t page = static_cast<size_t>(pt[p / page_size]);
        src = pages + ((page * page_size + p % page_size) * h + hh) * d + c;
      }
      cp_async16(kv + r * kStride + c, src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * D; i += kThreads) {
      const int r = i / D, c = i % D;
      T x = from_f<T>(0.f);
      if (r < nk && c < d) {
        const int p = p0 + r;
        const size_t page = static_cast<size_t>(pt[p / page_size]);
        x = pages[((page * page_size + p % page_size) * h + hh) * d + c];
      }
      kv[r * kStride + c] = x;
    }
  }
}

// What every CTA of a call derives from its block index and cursor.
struct Tile {
  int b, hh, s, q0, nq, ci, n_keys, k0, nk;
  size_t rows;  // (b * h + hh) * t: first row of this head in [b, h, t, .]
};

__device__ __forceinline__ Tile tile_of(const int32_t* cache_index, int t,
                                        int h, int max_len, int split) {
  Tile x;
  x.b = blockIdx.x / h;
  x.hh = blockIdx.x % h;
  x.s = blockIdx.y;
  x.q0 = blockIdx.z * kTileQ;
  x.nq = min(kTileQ, t - x.q0);
  x.ci = cache_index[x.b];
  // the tile's last query sees keys up to ci + q0 + nq - 1
  x.n_keys = min(max_len, x.ci + x.q0 + x.nq);
  x.k0 = x.s * split;
  x.nk = min(split, x.n_keys - x.k0);  // <= 0: the split is past the context
  x.rows = (static_cast<size_t>(x.b) * h + x.hh) * t;
  return x;
}

template <typename T, int D, bool kVec>
__global__ void __launch_bounds__(kThreads)
paged_logits_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ cache_index,
                    float* __restrict__ logits, float* __restrict__ split_max,
                    float* __restrict__ split_sum, int t, int h, int d,
                    int page_size, int pmax, int split, float scale,
                    float mask_value) {
  constexpr int kStride = row_stride<T, D>();
  extern __shared__ __align__(16) uint8_t smem[];
  T* kv = reinterpret_cast<T*>(smem);                         // 2 stages
  float* qs = reinterpret_cast<float*>(smem + 2 * chunk_bytes<T, D>());
  float* xs = qs + kTileQ * D;  // [kTileQ][split] this split's logits

  const int max_len = pmax * page_size;
  const int nsplit = gridDim.y;
  const size_t ld = static_cast<size_t>(nsplit) * split;  // workspace row
  launch_dependents();
  const Tile x = tile_of(cache_index, t, h, max_len, split);
  if (x.nk <= 0) return;  // nothing this tile sees: nothing read
  const int tid = threadIdx.x;
  const int32_t* pt = page_table + static_cast<size_t>(x.b) * pmax;

  stage_chunk<T, D, kVec>(kv, k_pages, pt, x.k0, min(kChunk, x.nk), h, x.hh,
                          d, page_size);
  cp_async_commit();
  for (int i = tid; i < kTileQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[i] = r < x.nq && c < d
        ? to_f(q[((static_cast<size_t>(x.b) * t + x.q0 + r) * h + x.hh) * d +
                 c])
        : 0.f;
  }

  const int n_chunks = (x.nk + kChunk - 1) / kChunk;
  for (int ic = 0; ic < n_chunks; ++ic) {
    const int c0 = ic * kChunk;  // offset of this chunk in the split
    if (ic + 1 < n_chunks) {
      stage_chunk<T, D, kVec>(kv + ((ic + 1) & 1) * kChunk * kStride,
                              k_pages, pt, x.k0 + c0 + kChunk,
                              min(kChunk, x.nk - c0 - kChunk), h, x.hh, d,
                              page_size);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kc = kv + (ic & 1) * kChunk * kStride;
    const int nk = min(kChunk, x.nk - c0);
    for (int i = tid; i < x.nq * kChunk; i += kThreads) {
      const int r = i / kChunk, j = i % kChunk;
      if (j < nk) {
        constexpr int kV = 16 / sizeof(T);
        const float* qr = qs + r * D;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < D; c += kV) {
          float vals[kV];
          unpack(*reinterpret_cast<const uint4*>(kc + j * kStride + c), vals,
                 static_cast<const T*>(nullptr));
#pragma unroll
          for (int e = 0; e < kV; ++e) acc = fmaf(qr[c + e], vals[e], acc);
        }
        const int p = x.k0 + c0 + j;
        const float lg =
            p <= x.ci + x.q0 + r ? round_to<T>(acc) * scale : mask_value;
        xs[r * split + c0 + j] = lg;
        logits[(x.rows + x.q0 + r) * ld + p] = lg;
      }
    }
    __syncthreads();  // this stage consumed before it is staged again
  }

  // the split's statistics over each query's visible keys, a warp a query
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < x.nq; r += kThreads / 32) {
    const int vis = min(x.nk, x.ci + x.q0 + r + 1 - x.k0);  // may be <= 0
    const float* row = xs + r * split;
    float m = __int_as_float(0xff800000);  // -inf: no visible key
    for (int j = lane; j < vis; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < vis; j += 32) l += expf(row[j] - m);
    l = warp_sum(l);
    if (lane == 0) {
      const size_t at = (x.rows + x.q0 + r) * nsplit + x.s;
      split_max[at] = m;
      split_sum[at] = l;
    }
  }
}

template <typename T, int D, bool kVec>
__global__ void __launch_bounds__(kThreads)
paged_values_kernel(const T* __restrict__ v_pages,
                    const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ cache_index,
                    const float* __restrict__ logits,
                    const float* __restrict__ split_max,
                    const float* __restrict__ split_sum,
                    float* __restrict__ partial, int* __restrict__ counters,
                    T* __restrict__ out, int t, int h, int d, int page_size,
                    int pmax, int split) {
  constexpr int kStride = row_stride<T, D>();
  constexpr int kPerThread = kTileQ * D / kThreads;
  extern __shared__ __align__(16) uint8_t smem[];
  T* kv = reinterpret_cast<T*>(smem);                         // 2 stages
  // two stages of the chunk's logits [kTileQ][kChunk], turned into P in
  // place
  float* xl = reinterpret_cast<float*>(smem + 2 * chunk_bytes<T, D>());
  float* m_s = xl + 2 * kTileQ * kChunk;  // [kTileQ] row max
  float* l_s = m_s + kTileQ;              // [kTileQ] row sum
  int* last = reinterpret_cast<int*>(l_s + kTileQ);

  const int max_len = pmax * page_size;
  const int nsplit = gridDim.y;
  const size_t ld = static_cast<size_t>(nsplit) * split;  // workspace row
  const Tile x = tile_of(cache_index, t, h, max_len, split);
  if (x.nk <= 0) return;
  const int n_live = (x.n_keys + split - 1) / split;  // splits with a key
  const int tid = threadIdx.x;
  const int32_t* pt = page_table + static_cast<size_t>(x.b) * pmax;

  // a chunk's V rows, and its logits rows (whole 64-key rows: the
  // workspace row is a whole number of splits); a chunk is one cp.async
  // group
  auto stage_v = [&](int ic) {
    const int c0 = ic * kChunk;
    stage_chunk<T, D, kVec>(kv + (ic & 1) * kChunk * kStride, v_pages, pt,
                            x.k0 + c0, min(kChunk, x.nk - c0), h, x.hh, d,
                            page_size);
  };
  auto stage_x = [&](int ic) {
    float* xc = xl + (ic & 1) * kTileQ * kChunk;
    for (int i = tid; i < x.nq * (kChunk / 4); i += kThreads) {
      const int r = i / (kChunk / 4), c = (i % (kChunk / 4)) * 4;
      cp_async16(xc + r * kChunk + c,
                 logits + (x.rows + x.q0 + r) * ld + x.k0 + ic * kChunk + c,
                 16);
    }
  };
  // V is not written by the logits kernel: its first chunk is requested
  // before this kernel waits for that one to finish (it may start early,
  // launched as its programmatic dependent)
  stage_v(0);
  grid_dependency_wait();
  stage_x(0);
  cp_async_commit();

  // the row's softmax statistics from its live splits, a warp a query;
  // every CTA of a row runs the same reduction on the same values
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < x.nq; r += kThreads / 32) {
    const size_t base = (x.rows + x.q0 + r) * nsplit;
    float m = __int_as_float(0xff800000);
    for (int s = lane; s < n_live; s += 32) m = fmaxf(m, split_max[base + s]);
    m = warp_max(m);
    float l = 0.f;
    for (int s = lane; s < n_live; s += 32)
      l += split_sum[base + s] * expf(split_max[base + s] - m);
    l = warp_sum(l);
    if (lane == 0) {
      m_s[r] = m;
      l_s[r] = l;
    }
  }

  float acc[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) acc[e] = 0.f;
  const int n_chunks = (x.nk + kChunk - 1) / kChunk;
  for (int ic = 0; ic < n_chunks; ++ic) {
    if (ic + 1 < n_chunks) {
      stage_v(ic + 1);
      stage_x(ic + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk landed; m_s, l_s written
    const int nk = min(kChunk, x.nk - ic * kChunk);
    float* xc = xl + (ic & 1) * kTileQ * kChunk;
    // P = exp(x - m) / l, normalized, then rounded to T
    for (int i = tid; i < x.nq * kChunk; i += kThreads) {
      const int r = i / kChunk, j = i % kChunk;
      xc[i] = j < nk ? round_to<T>(expf(xc[i] - m_s[r]) / l_s[r]) : 0.f;
    }
    __syncthreads();
    const T* vc = kv + (ic & 1) * kChunk * kStride;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const int i = tid + e * kThreads;
      const int r = i / D, c = i % D;
      if (r < x.nq) {
        const float* prow = xc + r * kChunk;
        float a = acc[e];
        for (int j = 0; j < nk; ++j)
          a = fmaf(prow[j], to_f(vc[j * kStride + c]), a);
        acc[e] = a;
      }
    }
    __syncthreads();  // this stage consumed before it is staged again
  }

  const size_t out_row = static_cast<size_t>(x.b) * t + x.q0;
  if (n_live == 1) {  // the tile sees one split: no partials
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const int i = tid + e * kThreads;
      const int r = i / D, c = i % D;
      if (r < x.nq && c < d)
        out[((out_row + r) * h + x.hh) * d + c] = from_f<T>(acc[e]);
    }
    return;
  }
  // partial [b, h, nsplit, t, d]
  const size_t part = ((static_cast<size_t>(x.b) * h + x.hh) * nsplit) * t;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int i = tid + e * kThreads;
    const int r = i / D, c = i % D;
    if (r < x.nq && c < d)
      partial[(part + static_cast<size_t>(x.s) * t + x.q0 + r) * d + c] =
          acc[e];
  }
  __threadfence();  // partials visible to the CTA that arrives last
  __syncthreads();
  int* counter = counters + x.rows / t * gridDim.z + blockIdx.z;
  if (tid == 0) *last = atomicAdd(counter, 1) == n_live - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int i = tid + e * kThreads;
    const int r = i / D, c = i % D;
    if (r < x.nq && c < d) {
      float o = 0.f;
#pragma unroll 4
      for (int s = 0; s < n_live; ++s)  // in split order
        o += __ldcg(partial + (part + static_cast<size_t>(s) * t + x.q0 + r) *
                                  d + c);
      out[((out_row + r) * h + x.hh) * d + c] = from_f<T>(o);
    }
  }
  if (tid == 0) *counter = 0;  // ready for the next call
}

template <typename T, int D>
size_t logits_smem(int split) {
  return 2 * chunk_bytes<T, D>() + sizeof(float) * kTileQ * (D + split);
}

template <typename T, int D>
size_t values_smem() {
  return 2 * chunk_bytes<T, D>() +
         sizeof(float) * (2 * kTileQ * kChunk + 2 * kTileQ) + sizeof(int);
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// cudaFuncSetAttribute acts on the current device: one slot a device
// records that an instantiation's two kernels were opted in there (two
// threads that race on one device both set the same attributes).
constexpr int kMaxDevices = 64;

struct Args {
  const void *q, *k_pages, *v_pages;
  const int32_t *page_table, *cache_index;
  void* out;
  float *logits, *stats, *partial;
  int* counters;
  int b, t, h, d, page_size, pmax, split;
  float scale, mask_value;
  cudaStream_t stream;
};

template <typename T, int D, bool kVec>
cudaError_t launch(const Args& a) {
  const int max_len = a.pmax * a.page_size;
  const int nsplit = (max_len + a.split - 1) / a.split;
  const size_t rows = static_cast<size_t>(a.b) * a.h * a.t;
  const dim3 grid(a.b * a.h, nsplit, (a.t + kTileQ - 1) / kTileQ);
  const size_t smem_k = logits_smem<T, D>(a.split);
  const size_t smem_v = values_smem<T, D>();
  static std::atomic<bool> opted_in[kMaxDevices];  // once a device
  int device = 0;
  cudaError_t dev_err = cudaGetDevice(&device);
  if (dev_err != cudaSuccess) return dev_err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[device].load(std::memory_order_acquire)) {
    cudaError_t err =
        opt_in(paged_logits_kernel<T, D, kVec>, logits_smem<T, D>(kMaxSplit));
    if (err == cudaSuccess)
      err = opt_in(paged_values_kernel<T, D, kVec>, smem_v);
    if (err != cudaSuccess) return err;
    opted_in[device].store(true, std::memory_order_release);
  }
  float* split_max = a.stats;
  float* split_sum = a.stats + rows * nsplit;
  paged_logits_kernel<T, D, kVec><<<grid, kThreads, smem_k, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pages),
      a.page_table, a.cache_index, a.logits, split_max, split_sum, a.t, a.h,
      a.d, a.page_size, a.pmax, a.split, a.scale, a.mask_value);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the values kernel as the logits kernel's programmatic dependent
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_v;
  cfg.stream = a.stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, paged_values_kernel<T, D, kVec>,
      static_cast<const T*>(a.v_pages), a.page_table, a.cache_index,
      static_cast<const float*>(a.logits),
      static_cast<const float*>(split_max),
      static_cast<const float*>(split_sum), a.partial, a.counters,
      static_cast<T*>(a.out), a.t, a.h, a.d, a.page_size, a.pmax, a.split);
}

template <typename T>
cudaError_t launch_t(const Args& a) {
  const bool vec = (a.d * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.k_pages) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.v_pages) % 16 == 0;
  if (a.d <= 64)
    return vec ? launch<T, 64, true>(a) : launch<T, 64, false>(a);
  if (a.d <= 128)
    return vec ? launch<T, 128, true>(a) : launch<T, 128, false>(a);
  return vec ? launch<T, 256, true>(a) : launch<T, 256, false>(a);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. logits: float32 [b, h, t, nsplit *
// split];
// stats: float32 [2, b, h, t, nsplit]; partial: float32 [b, h, nsplit, t,
// d]; counters: int32 [b * h * ceil(t / 16)], zero; nsplit = ceil(max_len
// / split). Returns a cudaError_t (0 = both kernels launched).
int paged_attention_launch(int dtype, const void* q, const void* k_pages,
                           const void* v_pages, const void* page_table,
                           const void* cache_index, void* out, void* logits,
                           void* stats, void* partial, void* counters, int b,
                           int t, int h, int d, int page_size, int pmax,
                           int split, float scale, float mask_value,
                           void* stream) {
  if (b < 1 || t < 1 || h < 1 || d < 1 || d > 256 || page_size < 1 ||
      pmax < 1 || split < kChunk || split > kMaxSplit || split % kChunk)
    return cudaErrorInvalidValue;
  const Args a{q,
               k_pages,
               v_pages,
               static_cast<const int32_t*>(page_table),
               static_cast<const int32_t*>(cache_index),
               out,
               static_cast<float*>(logits),
               static_cast<float*>(stats),
               static_cast<float*>(partial),
               static_cast<int*>(counters),
               b,
               t,
               h,
               d,
               page_size,
               pmax,
               split,
               scale,
               mask_value,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_t<float>(a);
  if (dtype == 1) return launch_t<__nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
