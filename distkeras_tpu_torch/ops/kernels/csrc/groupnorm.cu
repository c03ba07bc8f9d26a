// GroupNorm forward and backward for Hopper (sm_90a) over x [B, HW, C]
// (the NHWC activation of a sample viewed as HW rows of C channels),
// G groups of Cg = C / G consecutive channels.
//
// Replaces distkeras_tpu/ops/pallas/groupnorm.py::_fwd_kernel (behind
// _pallas_fwd, the forward of group_norm / FusedGroupNorm) and
// ::_bwd_kernel (behind _pallas_bwd). The functions are those of the JAX
// module's float32 references, not of the TPU kernels' shortcuts:
//   forward  (groupnorm.py::_reference): for each (sample b, group g),
//     over its n = HW * Cg values, mu = sum * (1/n) and the TWO-PASS
//     variance var = sum((x - mu)^2) * (1/n), the reciprocal in float64
//     as torch divides by a scalar on the card (the Pallas kernel's
//     E[x^2] - mu^2 cancels where the mean is large), each rounded to
//     float32, rstd = 1 / sqrt(var + eps); y = ((x - mu) * rstd) *
//     gamma_c + beta_c rounded once to x's dtype; stats [B, 2, G] =
//     (mu, rstd) for the backward;
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
// the backward reads x and dy and writes dx (gamma, beta, the stats and
// the partials are negligible); at ResNet-50's b=128 stem, [128, 12544,
// 64] bf16, that is 0.12 ms forward and 0.18 ms backward at 3.35 TB/s.
// What the design does (the plan comes from groupnorm.py::plan):
//   - coalesced tiles: a CTA owns `rows` rows of one sample by a column
//     block of `cols` channels made of whole groups (preferably one
//     128-byte line a row, at least 64 bytes). Neighbouring threads copy
//     neighbouring VEC-value chunks (16 bytes where C allows) with
//     cp.async into shared memory, in four stages whose sums start while
//     the later stages land, so every sector fetched is used and each
//     value is read from device memory once. Each thread keeps one chunk
//     column and reads back only the chunks it copied, so the tile needs
//     no CTA barrier;
//   - each thread sums its VEC channels in float64 registers; the group
//     (and, backward, the channel) partials of the CTA are then summed
//     through shared memory in a fixed order;
//   - cluster path: the `tiles` CTAs that split a (sample, column block)
//     form one thread-block cluster (up to 16 CTAs). Each publishes its
//     float64 partials in its own shared memory; after a cluster barrier
//     every CTA reads all ranks' partials through distributed shared
//     memory at once, a rank a lane, and sums them in one fixed shuffle
//     tree, so all of them finalize the same mu (then var, or m1 and m2)
//     and the channel partials. The second pass and the
//     output read the tile still resident in shared memory: one read and
//     one write of device memory, no atomics, deterministic;
//   - streaming path, where a sample's column block outgrows a cluster's
//     shared memory (a 512^2 stem in float32) or one group's row is wider
//     than a CTA's chunks: the same kernels write each tile's partials to
//     a float64 workspace and end; the next launch sums them in tile order
//     and re-reads its tile (forward: sums, squares, normalize; backward:
//     sums, dx);
//   - CTAs of 128 threads and at most 56 KB fit four to an SM, so one
//     CTA's loads run under another's reductions and writes; a sample too
//     large for 16 of them (the stem backward) takes CTAs of 256 threads
//     and 110 KB, two to an SM.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the cudaError_t of the launch. x, y, dy, dx are contiguous
// [B, HW, C] with 16-byte aligned bases; gamma, beta float32 [C].

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <vector>

namespace coop = cooperative_groups;

namespace {

// threads a CTA at most (the plan picks 64, 128 or 256)
constexpr int kMaxThreads = 256;
constexpr int kStages = 4;
constexpr int kMaxCluster = 16;
// dynamic shared memory a block may opt into on Hopper
constexpr int kSmemOptin = 232448;

// The tiling (groupnorm.py::plan). The grid is b * (c / cols) * tiles
// CTAs, `tiles` consecutive CTAs splitting the rows of one (sample,
// column block); a cluster is `cluster` consecutive CTAs: all `tiles`
// (the cluster path) or one (the streaming path, `stream`); `threads`
// threads a CTA.
struct Plan {
  int b, hw, c, groups;
  int cols, rows, tiles, cluster, stream, threads;
};

// Rows of the reduction scratch: one a warp where a row's chunks divide
// 32 (the lanes of a chunk column are summed by shuffles first), else
// one a thread row.
__host__ __device__ inline int red_rows(int cpr, int threads) {
  return 32 % cpr == 0 ? threads / 32 : threads / cpr;
}

// Byte offsets into dynamic shared memory: the tile(s) (x; backward x and
// dy), the reduction scratch ([red_rows][cols] doubles), the group
// partials (2 per group), backward the channel partials (2 per channel),
// and the finalized float32 values (2 per group).
struct Layout {
  size_t tile, red, part, chp, fl, total;
};

__host__ __device__ inline int local_groups(const Plan& p) {
  const int cg = p.c / p.groups;
  return p.cols >= cg ? p.cols / cg : 1;
}

__host__ __device__ inline Layout layout(const Plan& p, int vec,
                                         size_t item, bool bwd) {
  const int ng = local_groups(p);
  Layout l;
  l.tile = (static_cast<size_t>(p.rows) * p.cols * item + 15) / 16 * 16;
  l.red = (bwd ? 2 : 1) * l.tile;
  l.part = l.red + sizeof(double) * red_rows(p.cols / vec, p.threads) *
                       p.cols;
  l.chp = l.part + sizeof(double) * 2 * ng;
  l.fl = l.chp + (bwd ? sizeof(double) * 2 * p.cols : 0);
  l.total = l.fl + sizeof(float) * 2 * ng;
  return l;
}

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

// One CTA's tile, and this thread's place in it: chunk column cc of the
// cpr chunks a row, rows rr, rr + step, ...
struct Geom {
  int b, t, cbk, ncb, row0, nrows, col0, cpr, step, cc, rr, cg, ng;
  bool active;
};

template <int VEC>
__device__ __forceinline__ Geom make_geom(const Plan& p) {
  Geom g;
  g.ncb = p.c / p.cols;
  const int cid = blockIdx.x / p.tiles;
  g.t = blockIdx.x % p.tiles;
  g.cbk = cid % g.ncb;
  g.b = cid / g.ncb;
  g.row0 = g.t * p.rows;
  g.nrows = max(0, min(p.rows, p.hw - g.row0));
  g.col0 = g.cbk * p.cols;
  g.cpr = p.cols / VEC;
  g.step = blockDim.x / g.cpr;
  g.cc = threadIdx.x % g.cpr;
  g.rr = threadIdx.x / g.cpr;
  g.active = g.rr < g.step;
  g.cg = p.c / p.groups;
  g.ng = local_groups(p);
  return g;
}

// Rows a load stage: a multiple of step, so that a thread's rows are
// rr + k * step across the stages.
__device__ __forceinline__ int stage_rows(int nrows, int step) {
  const int per = (nrows + kStages - 1) / kStages;
  return (per + step - 1) / step * step;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This thread's copies of stage s of kStages (committed in order) have
// landed. A thread reads only the chunks it copied itself, so no CTA
// barrier is needed.
__device__ __forceinline__ void wait_stage(int s) {
  static_assert(kStages == 4, "one case a stage");
  switch (s) {
    case 0: cp_async_wait<3>(); break;
    case 1: cp_async_wait<2>(); break;
    case 2: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

// Copy this thread's chunks of rows [lo, hi) of the tile from src (the
// tile's first column of the sample's first row, in chunks; a row is cv
// chunks) into tile [rows][cpr]: chunk column cc of rows rr, rr + step,
// ..., so neighbouring threads take neighbouring chunks and each thread
// later reads what it copied. Two-byte chunks (bf16, odd widths) load
// directly.
template <typename V>
__device__ __forceinline__ void load_rows(V* tile, const V* src,
                                          const Geom& g, int cv, int lo,
                                          int hi) {
  if (!g.active) return;
  for (int r = lo + g.rr; r < hi; r += g.step) {
    const V* gp = src + static_cast<int64_t>(g.row0 + r) * cv + g.cc;
    V* sp = tile + r * g.cpr + g.cc;
    if constexpr (sizeof(V) >= 4) {
      cp_async<sizeof(V)>(sp, gp);
    } else {
      *sp = *gp;
    }
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// Every thread's per-channel sums acc into red [rows][cols], summed first
// over the lanes of a warp that share a chunk column where the row's
// chunks divide 32 (then every thread is active); returns the rows.
template <int VEC>
__device__ __forceinline__ int to_red(const double (&acc)[VEC],
                                      const Geom& g, int cols, double* red) {
  if (32 % g.cpr == 0) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      double v = acc[e];
      for (int o = g.cpr; o < 32; o <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane < g.cpr) red[(threadIdx.x >> 5) * cols + lane * VEC + e] = v;
    }
    return blockDim.x >> 5;
  }
  if (g.active) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) red[g.rr * cols + g.cc * VEC + e] = acc[e];
  }
  return g.step;
}

// The CTA's partial of each local group from every thread's per-channel
// sums acc: part[lg] for lg < ng, each summed in a fixed order (one warp
// a group: its lanes over the group's channels, row by row of the
// scratch, then a shuffle tree).
template <int VEC>
__device__ __forceinline__ void group_partials(const double (&acc)[VEC],
                                               const Geom& g, int cols,
                                               double* red, double* part) {
  const int rows = to_red<VEC>(acc, g, cols, red);
  __syncthreads();
  const int width = min(g.cg, cols);
  const int lane = threadIdx.x & 31;
  for (int lg = threadIdx.x >> 5; lg < g.ng; lg += blockDim.x >> 5) {
    double s = 0.0;
    for (int r = 0; r < rows; ++r)
      for (int ch = lane; ch < width; ch += 32)
        s += red[r * cols + lg * width + ch];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) part[lg] = s;
  }
  __syncthreads();
}

// The CTA's partial of each of its cols channels: out[ch], summed over
// the scratch rows in order.
template <int VEC>
__device__ __forceinline__ void channel_partials(const double (&acc)[VEC],
                                                 const Geom& g, int cols,
                                                 double* red, double* out) {
  const int rows = to_red<VEC>(acc, g, cols, red);
  __syncthreads();
  for (int ch = threadIdx.x; ch < cols; ch += blockDim.x) {
    double s = 0.0;
    for (int r = 0; r < rows; ++r) s += red[r * cols + ch];
    out[ch] = s;
  }
  __syncthreads();
}

// Streaming workspace: group partials [2][B][ncb][tiles][ng], then
// (backward) channel partials [2][B][tiles][C].
__device__ __forceinline__ int64_t group_slot(const Plan& p, const Geom& g,
                                              int which, int k, int t,
                                              int lg) {
  return ((((static_cast<int64_t>(which) * p.b + g.b) * g.ncb + k) *
               p.tiles + t) * g.ng + lg);
}

__device__ __forceinline__ int64_t channel_slot(const Plan& p, const Geom& g,
                                                int which, int t, int ch) {
  return ((static_cast<int64_t>(which) * p.b + g.b) * p.tiles + t) * p.c +
         ch;
}

__device__ __forceinline__ double* channel_ws(double* ws, const Plan& p,
                                              const Geom& g) {
  return ws + 2 * static_cast<int64_t>(p.b) * g.ncb * p.tiles * g.ng;
}

__device__ __forceinline__ void store_groups(double* ws, const double* part,
                                             const Plan& p, const Geom& g,
                                             int which) {
  for (int lg = threadIdx.x; lg < g.ng; lg += blockDim.x)
    ws[group_slot(p, g, which, g.cbk, g.t, lg)] = part[lg];
}

// For each of n items, the sums over the cluster's ranks of two values in
// their shared memory, src[at(i).x] and src[at(i).y]: L lanes an item (L
// the power of two at or above the ranks, at most 16), lane r reading
// rank r through distributed shared memory, then a fixed shuffle tree,
// so that every CTA gets the same bits and the ranks' latencies overlap.
// done(i, sum_x, sum_y) runs in one lane an item. Every thread of the CTA
// calls it.
template <typename At, typename Done>
__device__ __forceinline__ void cluster_sums(double* src, int n, int ranks,
                                             At at, Done done) {
  static_assert(kMaxCluster <= 16, "a rank a lane, within a half-warp");
  coop::cluster_group cl = coop::this_cluster();
  int lanes = 1;
  while (lanes < ranks) lanes <<= 1;
  const int lane = threadIdx.x & 31;
  const int r = lane & (lanes - 1);
  const int per_warp = 32 / lanes;
  for (int base = (threadIdx.x >> 5) * per_warp; base < n;
       base += (blockDim.x >> 5) * per_warp) {
    const int i = base + lane / lanes;
    double x = 0.0, y = 0.0;
    if (i < n && r < ranks) {
      const double* remote = cl.map_shared_rank(src, r);
      const int2 a = at(i);
      x = remote[a.x];
      y = remote[a.y];
    }
    for (int o = lanes >> 1; o > 0; o >>= 1) {
      x += __shfl_xor_sync(0xffffffffu, x, o);
      y += __shfl_xor_sync(0xffffffffu, y, o);
    }
    if (i < n && r == 0) done(i, x, y);
  }
}

// Total of local group lg over all tiles of the streaming path, in tile
// order, from the workspace (a group wider than the column block spans
// cg / cols blocks).
__device__ __forceinline__ double ws_total(const double* ws, const Plan& p,
                                           const Geom& g, int which,
                                           int lg) {
  double s = 0.0;
  const int sub = p.cols >= g.cg ? 1 : g.cg / p.cols;
  const int k0 = g.cbk / sub * sub;
  for (int k = k0; k < k0 + sub; ++k)
    for (int t = 0; t < p.tiles; ++t)
      s += ws[group_slot(p, g, which, k, t, lg)];
  return s;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads, 2)
gn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ y,
              float* __restrict__ stats, double* __restrict__ ws, Plan p,
              float eps, int phase) {
  using V = Vec<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Geom g = make_geom<VEC>(p);
  const Layout l = layout(p, VEC, sizeof(T), false);
  V* tile = reinterpret_cast<V*>(smem);
  double* red = reinterpret_cast<double*>(smem + l.red);
  double* part = reinterpret_cast<double*>(smem + l.part);
  float* mu_s = reinterpret_cast<float*>(smem + l.fl);
  float* rs_s = mu_s + g.ng;
  const bool resident = !p.stream;
  const int cv = p.c / VEC;
  const V* xv = reinterpret_cast<const V*>(x) +
                static_cast<int64_t>(g.b) * p.hw * cv + g.col0 / VEC;

  const int sr = stage_rows(g.nrows, g.step);
  for (int s = 0; s < kStages; ++s) {
    load_rows(tile, xv, g, cv, min(g.nrows, s * sr),
              min(g.nrows, (s + 1) * sr));
    cp_async_commit();
  }
  int lge[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    lge[e] = p.cols >= g.cg ? (g.cc * VEC + e) / g.cg : 0;
  // the plain version's sum / n runs on the card as a multiply by the
  // double reciprocal (ATen divides by a host scalar that way), which
  // rounds to float32 differently from a division about once in 10^4
  // groups: multiply the same way
  const double inv_n = 1.0 / (static_cast<double>(p.hw) * g.cg);

  if (phase == 0) {  // sums, as the stages land
    double acc[VEC] = {};
    for (int s = 0; s < kStages; ++s) {
      wait_stage(s);
      if (!g.active) continue;
      const int hi = min(g.nrows, (s + 1) * sr);
      for (int r = s * sr + g.rr; r < hi; r += g.step) {
        const V v = tile[r * g.cpr + g.cc];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += to_f32(v.v[e]);
      }
    }
    group_partials<VEC>(acc, g, p.cols, red, part);
    if (!resident) {
      store_groups(ws, part, p, g, 0);
      return;
    }
    cluster_sync();
  }
  if (resident) {
    cluster_sums(
        part, g.ng, p.cluster, [](int i) { return make_int2(i, i); },
        [&](int i, double s, double) {
          mu_s[i] = static_cast<float>(s * inv_n);
        });
  } else {
    for (int lg = threadIdx.x; lg < g.ng; lg += blockDim.x)
      mu_s[lg] = static_cast<float>(ws_total(ws, p, g, 0, lg) * inv_n);
  }
  cp_async_wait<0>();
  __syncthreads();
  float mu_e[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) mu_e[e] = mu_s[lge[e]];

  if (phase != 2) {  // squares about mu, from the resident tile
    double acc[VEC] = {};
    if (g.active) {
      for (int r = g.rr; r < g.nrows; r += g.step) {
        const V v = tile[r * g.cpr + g.cc];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float d = __fsub_rn(to_f32(v.v[e]), mu_e[e]);
          acc[e] += __fmul_rn(d, d);
        }
      }
    }
    group_partials<VEC>(acc, g, p.cols, red, part + g.ng);
    if (!resident) {
      store_groups(ws, part + g.ng, p, g, 1);
      return;
    }
    cluster_sync();
  }
  // 1 / sqrt, both correctly rounded, as torch computes them on every
  // device (rsqrtf is approximate)
  const auto finish = [&](int lg, double s) {
    const float var = static_cast<float>(s * inv_n);
    rs_s[lg] = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
  };
  if (resident) {
    const int ng = g.ng;
    cluster_sums(
        part, ng, p.cluster, [ng](int i) { return make_int2(ng + i, ng + i); },
        [&](int i, double s, double) { finish(i, s); });
  } else {
    for (int lg = threadIdx.x; lg < g.ng; lg += blockDim.x)
      finish(lg, ws_total(ws, p, g, 1, lg));
  }
  __syncthreads();
  if (resident) cluster_arrive();  // done with the other ranks' memory

  if (g.active) {
    float rs_e[VEC], ga[VEC], be[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      rs_e[e] = rs_s[lge[e]];
      ga[e] = gamma[g.col0 + g.cc * VEC + e];
      be[e] = beta[g.col0 + g.cc * VEC + e];
    }
    V* yv = reinterpret_cast<V*>(y) + static_cast<int64_t>(g.b) * p.hw * cv +
            g.col0 / VEC;
    for (int r = g.rr; r < g.nrows; r += g.step) {
      const V v = tile[r * g.cpr + g.cc];
      V o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = __fmul_rn(__fsub_rn(to_f32(v.v[e]), mu_e[e]),
                                   rs_e[e]);
        o.v[e] = from_f32<T>(__fadd_rn(__fmul_rn(xh, ga[e]), be[e]));
      }
      yv[static_cast<int64_t>(g.row0 + r) * cv + g.cc] = o;
    }
  }
  if (g.t == 0 && (p.cols >= g.cg || g.col0 % g.cg == 0)) {
    for (int lg = threadIdx.x; lg < g.ng; lg += blockDim.x) {
      const int64_t at = static_cast<int64_t>(g.b) * 2 * p.groups +
                         g.col0 / g.cg + lg;
      stats[at] = mu_s[lg];
      stats[at + p.groups] = rs_s[lg];
    }
  }
  if (resident) cluster_wait();  // the others are done with this memory
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads, 2)
gn_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ stats, const T* __restrict__ dy,
              T* __restrict__ dx, float* __restrict__ dgamma_p,
              float* __restrict__ dbeta_p, double* __restrict__ ws, Plan p,
              float inv_n, int phase) {
  using V = Vec<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Geom g = make_geom<VEC>(p);
  const Layout l = layout(p, VEC, sizeof(T), true);
  V* xt = reinterpret_cast<V*>(smem);
  V* gt = reinterpret_cast<V*>(smem + l.tile);
  double* red = reinterpret_cast<double*>(smem + l.red);
  double* part = reinterpret_cast<double*>(smem + l.part);
  double* chp = reinterpret_cast<double*>(smem + l.chp);
  float* m_s = reinterpret_cast<float*>(smem + l.fl);
  const bool resident = !p.stream;
  const int cv = p.c / VEC;
  const int64_t base = static_cast<int64_t>(g.b) * p.hw * cv + g.col0 / VEC;
  const V* xv = reinterpret_cast<const V*>(x) + base;
  const V* dyv = reinterpret_cast<const V*>(dy) + base;

  const int sr = stage_rows(g.nrows, g.step);
  for (int s = 0; s < kStages; ++s) {
    const int lo = min(g.nrows, s * sr), hi = min(g.nrows, (s + 1) * sr);
    load_rows(xt, xv, g, cv, lo, hi);
    load_rows(gt, dyv, g, cv, lo, hi);
    cp_async_commit();
  }
  int lge[VEC];
  float mu_e[VEC], rs_e[VEC], ga[VEC];
  const float* st = stats + static_cast<int64_t>(g.b) * 2 * p.groups;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int ch = g.col0 + g.cc * VEC + e;
    lge[e] = p.cols >= g.cg ? (g.cc * VEC + e) / g.cg : 0;
    mu_e[e] = st[ch / g.cg];
    rs_e[e] = st[p.groups + ch / g.cg];
    ga[e] = gamma[ch];
  }

  if (phase == 0) {  // sums, as the stages land
    double s1[VEC] = {}, s2[VEC] = {}, pg[VEC] = {}, pb[VEC] = {};
    for (int s = 0; s < kStages; ++s) {
      wait_stage(s);
      if (!g.active) continue;
      const int hi = min(g.nrows, (s + 1) * sr);
      for (int r = s * sr + g.rr; r < hi; r += g.step) {
        const V xc = xt[r * g.cpr + g.cc];
        const V gc = gt[r * g.cpr + g.cc];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float d = to_f32(gc.v[e]);
          const float xh = __fmul_rn(__fsub_rn(to_f32(xc.v[e]), mu_e[e]),
                                     rs_e[e]);
          const float dxh = __fmul_rn(d, ga[e]);
          s1[e] += dxh;
          s2[e] += __fmul_rn(dxh, xh);
          pg[e] += __fmul_rn(d, xh);
          pb[e] += d;
        }
      }
    }
    group_partials<VEC>(s1, g, p.cols, red, part);
    group_partials<VEC>(s2, g, p.cols, red, part + g.ng);
    channel_partials<VEC>(pg, g, p.cols, red, chp);
    channel_partials<VEC>(pb, g, p.cols, red, chp + p.cols);
    if (!resident) {
      store_groups(ws, part, p, g, 0);
      store_groups(ws, part + g.ng, p, g, 1);
      double* cws = channel_ws(ws, p, g);
      for (int ch = threadIdx.x; ch < p.cols; ch += blockDim.x) {
        cws[channel_slot(p, g, 0, g.t, g.col0 + ch)] = chp[ch];
        cws[channel_slot(p, g, 1, g.t, g.col0 + ch)] = chp[p.cols + ch];
      }
      return;
    }
    cluster_sync();
    // the channel partials over the ranks; rank t writes the channels
    // ch = t (mod cluster)
    const int cols = p.cols, cs = p.cluster, t = g.t;
    const int64_t out = static_cast<int64_t>(g.b) * p.c + g.col0;
    cluster_sums(
        chp, (cols - t + cs - 1) / cs, cs,
        [=](int i) { return make_int2(t + i * cs, cols + t + i * cs); },
        [&](int i, double sg, double sb) {
          dgamma_p[out + t + i * cs] = static_cast<float>(sg);
          dbeta_p[out + t + i * cs] = static_cast<float>(sb);
        });
  } else if (g.t == 0) {  // streaming: the channel partials in tile order
    const double* cws = channel_ws(ws, p, g);
    for (int ch = threadIdx.x; ch < p.cols; ch += blockDim.x) {
      double sg = 0.0, sb = 0.0;
      for (int t = 0; t < p.tiles; ++t) {
        sg += cws[channel_slot(p, g, 0, t, g.col0 + ch)];
        sb += cws[channel_slot(p, g, 1, t, g.col0 + ch)];
      }
      dgamma_p[static_cast<int64_t>(g.b) * p.c + g.col0 + ch] =
          static_cast<float>(sg);
      dbeta_p[static_cast<int64_t>(g.b) * p.c + g.col0 + ch] =
          static_cast<float>(sb);
    }
  }
  const auto finish = [&](int lg, double s1, double s2) {
    m_s[lg] = __fmul_rn(static_cast<float>(s1), inv_n);
    m_s[g.ng + lg] = __fmul_rn(static_cast<float>(s2), inv_n);
  };
  if (resident) {
    const int ng = g.ng;
    cluster_sums(part, ng, p.cluster,
                 [ng](int i) { return make_int2(i, ng + i); }, finish);
  } else {
    for (int lg = threadIdx.x; lg < g.ng; lg += blockDim.x)
      finish(lg, ws_total(ws, p, g, 0, lg), ws_total(ws, p, g, 1, lg));
  }
  cp_async_wait<0>();
  __syncthreads();
  if (resident) cluster_arrive();  // done with the other ranks' memory

  if (g.active) {
    float m1[VEC], m2[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      m1[e] = m_s[lge[e]];
      m2[e] = m_s[g.ng + lge[e]];
    }
    V* dxv = reinterpret_cast<V*>(dx) + base;
    for (int r = g.rr; r < g.nrows; r += g.step) {
      const V xc = xt[r * g.cpr + g.cc];
      const V gc = gt[r * g.cpr + g.cc];
      V o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = __fmul_rn(__fsub_rn(to_f32(xc.v[e]), mu_e[e]),
                                   rs_e[e]);
        const float dxh = __fmul_rn(to_f32(gc.v[e]), ga[e]);
        const float v = __fsub_rn(__fsub_rn(dxh, m1[e]), __fmul_rn(xh, m2[e]));
        o.v[e] = from_f32<T>(__fmul_rn(rs_e[e], v));
      }
      dxv[static_cast<int64_t>(g.row0 + r) * cv + g.cc] = o;
    }
  }
  if (resident) cluster_wait();  // the others are done with this memory
}

// Per kernel and device: the opt-in to large shared memory and to
// non-portable cluster sizes (once), and whether a cluster of the size,
// block and shared memory asked can be scheduled at all (once per shape).
struct Checked {
  const void* kernel;
  int device, cluster, threads;
  size_t smem;
  bool ok;
};
std::mutex g_mutex;
std::vector<Checked> g_checked;

template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), const Plan& p, size_t smem,
                   cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.b) * (p.c / p.cols) * p.tiles);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(kernel);
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    bool opted = false, known = false, ok = true;
    for (const Checked& c : g_checked) {
      if (c.kernel != key || c.device != device) continue;
      opted = true;
      if (c.cluster == p.cluster && c.threads == p.threads &&
          c.smem == smem) {
        known = true;
        ok = c.ok;
      }
    }
    if (!opted) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptin);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    if (!known) {
      int clusters = 1;
      if (p.cluster > 1) {
        err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
        if (err != cudaSuccess) return err;
      }
      ok = clusters >= 1;
      g_checked.push_back({key, device, p.cluster, p.threads, smem, ok});
    }
    if (!ok) return cudaErrorInvalidConfiguration;
  }
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T, int VEC>
cudaError_t fwd_v(const void* x, const float* gamma, const float* beta,
                  void* y, float* stats, double* ws, const Plan& p,
                  float eps, cudaStream_t stream) {
  const size_t smem = layout(p, VEC, sizeof(T), false).total;
  const int phases = p.stream ? 3 : 1;
  for (int phase = 0; phase < phases; ++phase) {
    const cudaError_t err = launch(
        gn_fwd_kernel<T, VEC>, p, smem, stream, static_cast<const T*>(x),
        gamma, beta, static_cast<T*>(y), stats, ws, p, eps, phase);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T, int VEC>
cudaError_t bwd_v(const void* x, const float* gamma, const float* stats,
                  const void* dy, void* dx, float* dgamma_p, float* dbeta_p,
                  double* ws, const Plan& p, float inv_n,
                  cudaStream_t stream) {
  const size_t smem = layout(p, VEC, sizeof(T), true).total;
  const int phases = p.stream ? 2 : 1;
  for (int phase = 0; phase < phases; ++phase) {
    const cudaError_t err = launch(
        gn_bwd_kernel<T, VEC>, p, smem, stream, static_cast<const T*>(x),
        gamma, stats, static_cast<const T*>(dy), static_cast<T*>(dx),
        dgamma_p, dbeta_p, ws, p, inv_n, phase);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The plan as groupnorm.py::plan makes it: a column block of whole
// groups (or a part of one group, streaming only), VEC dividing it and C,
// at most `threads` chunks a row, tiles covering HW, a cluster of all
// tiles (at most 16) or of one with a workspace, within shared memory.
bool valid(const Plan& p, int vec, size_t item, bool bwd, const void* ws) {
  if (p.b < 1 || p.hw < 1 || p.groups < 1 || p.c % p.groups) return false;
  const int cg = p.c / p.groups;
  if (p.cols < 1 || p.c % p.cols || (p.cols % cg && cg % p.cols))
    return false;
  if (p.threads < 32 || p.threads > kMaxThreads || p.threads % 32)
    return false;
  if (vec < 1 || vec * item > 16 || p.cols % vec || p.cols / vec > p.threads)
    return false;
  if (p.rows < 1 || p.tiles != (p.hw + p.rows - 1) / p.rows) return false;
  if (p.stream ? (p.cluster != 1 || ws == nullptr)
               : (p.cluster != p.tiles || p.cluster > kMaxCluster ||
                  p.cols < cg))
    return false;
  if (layout(p, vec, item, bwd).total > static_cast<size_t>(kSmemOptin))
    return false;
  return static_cast<int64_t>(p.b) * (p.c / p.cols) * p.tiles < 2147483647LL;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; vec: values a load (1, 2, 4, 8);
// cols, rows, tiles, cluster, streaming, threads: the plan
// (groupnorm.py::plan);
// ws: float64 workspace of the streaming path (null on the cluster
// path). Returns a cudaError_t (0 = launched).
int groupnorm_fwd_launch(int dtype, int vec, const void* x, const void* gamma,
                         const void* beta, void* y, void* stats, void* ws,
                         int b, int hw, int c, int groups, int cols, int rows,
                         int tiles, int cluster, int streaming, int threads,
                         float eps, void* stream) {
  const Plan p{b,    hw,    c,       groups,    cols,
               rows, tiles, cluster, streaming, threads};
  const size_t item = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || !valid(p, vec, item, false, ws))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto ga = static_cast<const float*>(gamma);
  auto be = static_cast<const float*>(beta);
  auto st = static_cast<float*>(stats);
  auto w = static_cast<double*>(ws);
#define DK_GN_FWD(T, V) return fwd_v<T, V>(x, ga, be, y, st, w, p, eps, s)
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
                         void* dgamma_p, void* dbeta_p, void* ws, int b,
                         int hw, int c, int groups, int cols, int rows,
                         int tiles, int cluster, int streaming, int threads,
                         float inv_n, void* stream) {
  const Plan p{b,    hw,    c,       groups,    cols,
               rows, tiles, cluster, streaming, threads};
  const size_t item = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || !valid(p, vec, item, true, ws))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto ga = static_cast<const float*>(gamma);
  auto st = static_cast<const float*>(stats);
  auto dg = static_cast<float*>(dgamma_p);
  auto db = static_cast<float*>(dbeta_p);
  auto w = static_cast<double*>(ws);
#define DK_GN_BWD(T, V) \
  return bwd_v<T, V>(x, ga, st, dy, dx, dg, db, w, p, inv_n, s)
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
