// GroupNorm forward and backward for Hopper (sm_90a) over x [B, HW, C]
// (the NHWC activation of a sample viewed as HW rows of C channels),
// G groups of Cg = C / G consecutive channels.
//
// Replaces distkeras_tpu/ops/pallas/groupnorm.py::_fwd_kernel (behind
// _pallas_fwd, the forward of group_norm / FusedGroupNorm) and
// ::_bwd_kernel (behind _pallas_bwd). The functions are those of the JAX
// module's float32 references, not of the TPU kernels' shortcuts:
//   forward  (groupnorm.py::_reference): for each (sample b, group g),
//     over its n = HW * Cg values, mu = sum / n and the TWO-PASS variance
//     var = sum((x - mu)^2) / n (the Pallas kernel's E[x^2] - mu^2
//     cancels where the mean is large), each rounded to float32, rstd =
//     1 / sqrt(var + eps); y = ((x - mu) * rstd) * gamma_c + beta_c rounded
//     once to x's dtype; stats [B, 2, G] = (mu, rstd) for the backward;
//   backward (groupnorm.py::_jnp_bwd_from_stats, the _bwd_kernel formula
//     in float32): xhat = (x - mu) * rstd, dxhat = dy * gamma_c,
//     m1 = sum(dxhat) * (1/n), m2 = sum(dxhat * xhat) * (1/n) over the
//     group, dx = rstd * (dxhat - m1 - xhat * m2) in x's dtype, and the
//     per-sample partials dgamma_p [B, C] = sum_hw dy * xhat and
//     dbeta_p [B, C] = sum_hw dy (the wrapper sums them over B, as
//     _pallas_bwd does).
//   Every sum (mu, var, m1, m2, dgamma_p, dbeta_p) is accumulated in
//   float64 from float32 terms and rounded once to float32, so its value
//   does not depend on the order of the additions; every other operation
//   is a float32 operation rounded on its own (no contraction into fused
//   multiply-adds) in the plain version's order. So the kernel reproduces
//   its plain version bitwise (the two sums would have to straddle a
//   float32 rounding boundary within float64's error to differ), and a
//   network whose gradients are discontinuous (ReLU masks, max-pool
//   choices) takes the same branches through either.
//
// What bounds it on this card: bytes. The forward reads x and writes y,
// the backward reads x and dy and writes dx (gamma, beta and the stats
// are negligible); at ResNet-50's b=128 stem, [128, 12544, 64] bf16, that
// is 0.12 ms forward and 0.18 ms backward at 3.35 TB/s. What the design
// does:
//   - one CTA per (sample, group), B * G CTAs (4,096 at b=128, G=32); the
//     group's slab (at most 25,088 values at ResNet-50 224^2: 50 KB in
//     bf16, 100 KB in float32) is read from device memory ONCE into
//     dynamic shared memory, so the exact two-pass variance (forward) and
//     the second pass over x and dy (backward) cost no second read;
//   - loads: a group's row is only Cg contiguous values (4-128 bytes) at
//     a stride of C values. Each thread owns one VEC-value chunk column
//     of the row (VEC the largest of 8/4/2/1 dividing Cg with VEC values
//     in at most 16 bytes) and walks the rows; consecutive threads take
//     consecutive chunks of a row, then the next rows, so a warp reads
//     Cg-value runs of 32 / (Cg / VEC) rows at once. Where Cg * itemsize
//     is under 32 bytes a sector carries other groups' values too: the
//     CTAs of one sample run together (the group is the fast grid index)
//     and find those sectors in L2, so device memory is read about once
//     while L2 serves up to 8x the bytes (Cg = 2, bf16). Reading whole
//     rows for several groups per CTA is the later fix;
//   - every thread keeps the same chunk column for the whole walk, so
//     the per-channel dgamma/dbeta partials are summed in registers, then
//     across the threads of a column (no atomics); block sums go through
//     warp shuffles and one shared array. The float64 adds, one or two
//     per value, are far below the card's float64 rate at these sizes.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the cudaError_t of the launch. x, y, dy, dx are contiguous
// [B, HW, C] with 16-byte aligned bases; gamma, beta float32 [C].

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The sum of v over the block, the same value in every thread. red holds
// kWarps doubles.
__device__ __forceinline__ double block_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read by the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double total = 0.0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) total += red[i];
  return total;
}

// Thread -> (chunk column cc, first row r0); rows advance by `step`.
struct Walk {
  int cpr, step, cc, r0;
  bool active;
  __device__ Walk(int cg, int vec) {
    cpr = cg / vec;
    step = kThreads / cpr;
    cc = threadIdx.x % cpr;
    r0 = threadIdx.x / cpr;
    active = static_cast<int>(threadIdx.x) < step * cpr;
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ y,
              float* __restrict__ stats, int hw, int c, int groups,
              float eps) {
  extern __shared__ float4 smem4[];
  using V = Vec<T, VEC>;
  V* slab = reinterpret_cast<V*>(smem4);  // [hw][cpr]
  __shared__ double red[kWarps];

  const int b = blockIdx.x / groups;
  const int g = blockIdx.x % groups;
  const int cg = c / groups;
  const Walk w(cg, VEC);
  const int64_t base = static_cast<int64_t>(b) * hw * c + g * cg +
                       w.cc * VEC;
  const double n = static_cast<double>(hw) * cg;

  double sum = 0.0;
  if (w.active) {
    for (int r = w.r0; r < hw; r += w.step) {
      const V v = *reinterpret_cast<const V*>(x + base +
                                              static_cast<int64_t>(r) * c);
      slab[r * w.cpr + w.cc] = v;
#pragma unroll
      for (int e = 0; e < VEC; ++e) sum += to_f32(v.v[e]);
    }
  }
  const float mu = static_cast<float>(block_sum(sum, red) / n);

  double sq = 0.0;
  if (w.active) {
    for (int r = w.r0; r < hw; r += w.step) {
      const V v = slab[r * w.cpr + w.cc];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = __fsub_rn(to_f32(v.v[e]), mu);
        sq += __fmul_rn(d, d);
      }
    }
  }
  const float var = static_cast<float>(block_sum(sq, red) / n);
  // 1 / sqrt, both correctly rounded, as torch computes them on every
  // device (rsqrtf is approximate)
  const float rstd = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));

  if (w.active) {
    float ga[VEC], be[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      ga[e] = gamma[g * cg + w.cc * VEC + e];
      be[e] = beta[g * cg + w.cc * VEC + e];
    }
    for (int r = w.r0; r < hw; r += w.step) {
      const V v = slab[r * w.cpr + w.cc];
      V o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = __fmul_rn(__fsub_rn(to_f32(v.v[e]), mu), rstd);
        o.v[e] = from_f32<T>(__fadd_rn(__fmul_rn(xh, ga[e]), be[e]));
      }
      *reinterpret_cast<V*>(y + base + static_cast<int64_t>(r) * c) = o;
    }
  }
  if (threadIdx.x == 0) {
    stats[static_cast<int64_t>(b) * 2 * groups + g] = mu;
    stats[static_cast<int64_t>(b) * 2 * groups + groups + g] = rstd;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ stats, const T* __restrict__ dy,
              T* __restrict__ dx, float* __restrict__ dgamma_p,
              float* __restrict__ dbeta_p, int hw, int c, int groups,
              float inv_n) {
  extern __shared__ float4 smem4[];
  using V = Vec<T, VEC>;
  const int b = blockIdx.x / groups;
  const int g = blockIdx.x % groups;
  const int cg = c / groups;
  const Walk w(cg, VEC);
  // [hw][cpr] slabs of x and dy, then the per-thread channel partials
  V* xs = reinterpret_cast<V*>(smem4);
  V* dys = xs + hw * w.cpr;
  double* part_g = reinterpret_cast<double*>(
      smem4 + (2 * static_cast<size_t>(hw) * w.cpr * sizeof(V) + 15) / 16);
  double* part_b = part_g + kThreads * VEC;
  __shared__ double red[kWarps];

  const int64_t base = static_cast<int64_t>(b) * hw * c + g * cg +
                       w.cc * VEC;
  const float mu = stats[static_cast<int64_t>(b) * 2 * groups + g];
  const float rstd = stats[static_cast<int64_t>(b) * 2 * groups + groups + g];
  float ga[VEC];
  double pg[VEC], pb[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    ga[e] = w.active ? gamma[g * cg + w.cc * VEC + e] : 0.f;
    pg[e] = 0.0;
    pb[e] = 0.0;
  }

  double s1 = 0.0, s2 = 0.0;
  if (w.active) {
    for (int r = w.r0; r < hw; r += w.step) {
      const int64_t off = base + static_cast<int64_t>(r) * c;
      const V xv = *reinterpret_cast<const V*>(x + off);
      const V gv = *reinterpret_cast<const V*>(dy + off);
      xs[r * w.cpr + w.cc] = xv;
      dys[r * w.cpr + w.cc] = gv;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = to_f32(gv.v[e]);
        const float xh = __fmul_rn(__fsub_rn(to_f32(xv.v[e]), mu), rstd);
        const float dxh = __fmul_rn(d, ga[e]);
        s1 += dxh;
        s2 += __fmul_rn(dxh, xh);
        pg[e] += __fmul_rn(d, xh);
        pb[e] += d;
      }
    }
  }
  const float m1 =
      __fmul_rn(static_cast<float>(block_sum(s1, red)), inv_n);
  const float m2 =
      __fmul_rn(static_cast<float>(block_sum(s2, red)), inv_n);

  // per-channel partials: thread tid's chunk column is tid % cpr, so the
  // threads of one column are tid = rr * cpr + cc for rr < step
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    part_g[threadIdx.x * VEC + e] = pg[e];
    part_b[threadIdx.x * VEC + e] = pb[e];
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < cg; ch += kThreads) {
    const int cc = ch / VEC;
    const int e = ch % VEC;
    double sg = 0.0, sb = 0.0;
    for (int rr = 0; rr < w.step; ++rr) {
      sg += part_g[(rr * w.cpr + cc) * VEC + e];
      sb += part_b[(rr * w.cpr + cc) * VEC + e];
    }
    dgamma_p[static_cast<int64_t>(b) * c + g * cg + ch] =
        static_cast<float>(sg);
    dbeta_p[static_cast<int64_t>(b) * c + g * cg + ch] =
        static_cast<float>(sb);
  }

  if (w.active) {
    for (int r = w.r0; r < hw; r += w.step) {
      const V xv = xs[r * w.cpr + w.cc];
      const V gv = dys[r * w.cpr + w.cc];
      V o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = __fmul_rn(__fsub_rn(to_f32(xv.v[e]), mu), rstd);
        const float dxh = __fmul_rn(to_f32(gv.v[e]), ga[e]);
        const float v =
            __fsub_rn(__fsub_rn(dxh, m1), __fmul_rn(xh, m2));
        o.v[e] = from_f32<T>(__fmul_rn(rstd, v));
      }
      *reinterpret_cast<V*>(dx + base + static_cast<int64_t>(r) * c) = o;
    }
  }
}

size_t fwd_smem(int hw, int cg, size_t item) {
  return static_cast<size_t>(hw) * cg * item;
}

size_t bwd_smem(int hw, int cg, int vec, size_t item) {
  const size_t slabs = 2 * static_cast<size_t>(hw) * cg * item;
  return (slabs + 15) / 16 * 16 + 2 * sizeof(double) * kThreads * vec;
}

// Opt `kernel` in to `smem` bytes of dynamic shared memory (above the
// 48 KiB default) once per instantiation and size, as far as `opted_in`
// (the instantiation's largest so far) does not cover it already.
template <typename K>
cudaError_t opt_in(K kernel, size_t smem, size_t* opted_in) {
  if (smem <= *opted_in) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) *opted_in = smem;
  return err;
}

template <typename T, int VEC>
cudaError_t fwd_v(const void* x, const float* gamma, const float* beta,
                  void* y, float* stats, int b, int hw, int c, int groups,
                  float eps, cudaStream_t stream) {
  const size_t smem = fwd_smem(hw, c / groups, sizeof(T));
  auto kernel = gn_fwd_kernel<T, VEC>;
  static size_t opted_in = 0;
  const cudaError_t err = opt_in(kernel, smem, &opted_in);
  if (err != cudaSuccess) return err;
  kernel<<<b * groups, kThreads, smem, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), stats, hw,
      c, groups, eps);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t bwd_v(const void* x, const float* gamma, const float* stats,
                  const void* dy, void* dx, float* dgamma_p, float* dbeta_p,
                  int b, int hw, int c, int groups, float inv_n,
                  cudaStream_t stream) {
  const size_t smem = bwd_smem(hw, c / groups, VEC, sizeof(T));
  auto kernel = gn_bwd_kernel<T, VEC>;
  static size_t opted_in = 0;
  const cudaError_t err = opt_in(kernel, smem, &opted_in);
  if (err != cudaSuccess) return err;
  kernel<<<b * groups, kThreads, smem, stream>>>(
      static_cast<const T*>(x), gamma, stats, static_cast<const T*>(dy),
      static_cast<T*>(dx), dgamma_p, dbeta_p, hw, c, groups, inv_n);
  return cudaGetLastError();
}

bool valid(int b, int hw, int c, int groups, int vec, size_t item) {
  if (b < 1 || hw < 1 || groups < 1 || c % groups) return false;
  const int cg = c / groups;
  if (vec < 1 || vec * item > 16 || cg % vec || cg / vec > kThreads)
    return false;
  return static_cast<int64_t>(b) * groups < 2147483647LL;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; vec: values a load (1, 2, 4, 8), as
// the wrapper picks it. Returns a cudaError_t (0 = launched).
int groupnorm_fwd_launch(int dtype, int vec, const void* x, const void* gamma,
                         const void* beta, void* y, void* stats, int b,
                         int hw, int c, int groups, float eps,
                         void* stream) {
  const size_t item = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || !valid(b, hw, c, groups, vec, item))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto ga = static_cast<const float*>(gamma);
  auto be = static_cast<const float*>(beta);
  auto st = static_cast<float*>(stats);
#define DK_GN_FWD(T, V) \
  return fwd_v<T, V>(x, ga, be, y, st, b, hw, c, groups, eps, s)
  if (dtype == 0) {
    if (vec == 4) DK_GN_FWD(float, 4);
    if (vec == 2) DK_GN_FWD(float, 2);
    DK_GN_FWD(float, 1);
  }
  if (vec == 8) DK_GN_FWD(__nv_bfloat16, 8);
  if (vec == 4) DK_GN_FWD(__nv_bfloat16, 4);
  if (vec == 2) DK_GN_FWD(__nv_bfloat16, 2);
  DK_GN_FWD(__nv_bfloat16, 1);
#undef DK_GN_FWD
}

int groupnorm_bwd_launch(int dtype, int vec, const void* x, const void* gamma,
                         const void* stats, const void* dy, void* dx,
                         void* dgamma_p, void* dbeta_p, int b, int hw, int c,
                         int groups, float inv_n, void* stream) {
  const size_t item = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || !valid(b, hw, c, groups, vec, item))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto ga = static_cast<const float*>(gamma);
  auto st = static_cast<const float*>(stats);
  auto dg = static_cast<float*>(dgamma_p);
  auto db = static_cast<float*>(dbeta_p);
#define DK_GN_BWD(T, V) \
  return bwd_v<T, V>(x, ga, st, dy, dx, dg, db, b, hw, c, groups, inv_n, s)
  if (dtype == 0) {
    if (vec == 4) DK_GN_BWD(float, 4);
    if (vec == 2) DK_GN_BWD(float, 2);
    DK_GN_BWD(float, 1);
  }
  if (vec == 8) DK_GN_BWD(__nv_bfloat16, 8);
  if (vec == 4) DK_GN_BWD(__nv_bfloat16, 4);
  if (vec == 2) DK_GN_BWD(__nv_bfloat16, 2);
  DK_GN_BWD(__nv_bfloat16, 1);
#undef DK_GN_BWD
}

const char* groupnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
