// Flash-attention backward for Hopper (sm_90a): dq, and dk with dv, from
// probability tiles recomputed from (q, k, lse), never stored.
//
// Replaces distkeras_tpu/ops/pallas/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (the two TPU kernels of _bwd_impl). Same function, for
// each (batch row, head), with q, k, v and dout upcast to float32
// (flash_attention.py:254-257, :302-305):
//   s = q k^T * head_dim^-0.5, MASK_VALUE where causal and i < j;
//   p = exp(s - lse)             (masked entries are exactly 0);
//   dp = dout v^T;  ds = p * (dp - delta),  delta = rowsum(dout * out)
//   computed outside (plain torch, as in the JAX package);
//   dq = (ds k) * scale,  dk = (ds^T q) * scale,  dv = p^T dout,
// every product to float32's precision, outputs in the input dtypes.
//
// bf16 inputs (the training path) run on the tensor cores. s and dp have
// bf16 operands, whose products are exact in float32: one bf16 wgmma
// with a float32 accumulator computes them. ds k, p^T dout and ds^T q
// have a float32 operand (ds or p), which one bf16 rounding would change.
// So it is split in registers into three bf16 terms, hi = bf16(x),
// mid = bf16(x - hi), lo = bf16(x - hi - mid), and the three products go
// into one float32 accumulator. The CPU emulation of that arithmetic
// (tests/test_torch_flash_attention.py) holds the split products within
// 2e-6 of max|ref| of the float32 ones, and one bf16 term misses them by
// more than 5e-4.
//
// What bounds them on this card: operations. At [8, 2048, 12, 64] causal
// bf16 (201.4M visible pairs) dq does 4 * head_dim flops a pair of
// single bf16 products (s, dp) and 3 x 2 * head_dim of split ones (ds k):
// 0.052 + 0.078 ms at the bf16 tensor-core peak; dk/dv the same two
// recomputed products and 3 x 4 * head_dim split ones (p^T dout, ds^T q):
// 0.052 + 0.156 ms (chip_smoke.py's bounds). The bytes, each input read
// once, take ~0.04 ms.
// What the design does:
//   - one CTA owns a tile of 64 rows per warpgroup (the M of every
//     wgmma): one warpgroup at head_dim <= 64, where 2-3 CTAs share an SM
//     and one CTA's products overlap another's elementwise work; two at
//     head_dim <= 128, where registers allow one CTA an SM. dq walks
//     64-key tiles up to its causal diagonal, dk/dv walks 64-query tiles
//     from its diagonal to the end with both accumulators in registers,
//     so no two CTAs write the same output, no atomics, and the result
//     is deterministic;
//   - tiles are bf16 in shared memory in the swizzled layout the wgmma
//     descriptors read (flash_attention_sm90.cuh), loaded with cp.async
//     two stages deep: the next key/value (dq) or query/dout (dk/dv)
//     tile arrives while this one is multiplied; every product over the
//     row axis reads its tile through the descriptor's transpose bit;
//   - p and ds never leave registers: the float32 accumulator of s (or
//     s^T) packs into the A fragments of the next product;
//   - p = exp(s * scale - lse), as exp2 of base-2 logits, and
//     ds = p * (dp - delta) stay elementwise float32, MASK_VALUE on the
//     diagonal tile only;
//   - CTAs are numbered longest causal strip first (the tile index is
//     the grid's slowest axis).
// float32 inputs keep the first version's kernels (every product a
// float32 FMA, 64-row CTAs, tiles staged as float32): they serve the
// float32 identity checks, not the training path.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the cudaError_t of the launch. q, k, v, dout, dq, dk, dv are
// contiguous [b, t, h, d], lse and delta contiguous float32 [b, h, t];
// bases 16-byte aligned; 8 <= d <= 128, d % 8 == 0; t % 64 == 0 for
// float32 and t % 128 == 0 for bf16 (the wrapper checks).

#include "flash_attention_common.cuh"
#include "flash_attention_sm90.cuh"

namespace {

using flash::kThreads;
using flash::kTile;

size_t dq_smem_bytes(int D) {
  // qt, dot, kt, vt [D][64], ks [64][D], dss [64][64], lse and delta [64]
  return sizeof(float) *
         (5 * static_cast<size_t>(D) * kTile + kTile * kTile + 2 * kTile);
}

size_t dkv_smem_bytes(int D) {
  // kt, vt, qt, dot [D][64], qs, dos [64][D], ps [64][64], lse, delta [64]
  return sizeof(float) *
         (6 * static_cast<size_t>(D) * kTile + kTile * kTile + 2 * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int t, int h, int d, float scale, float mask_value,
                    int causal) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][kTile]
  float* dot = qt + D * kTile;                  // [D][kTile]
  float* kt = dot + D * kTile;                  // [D][kTile]
  float* vt = kt + D * kTile;                   // [D][kTile]
  float* ks = vt + D * kTile;                   // [kTile][D]
  float* dss = ks + kTile * D;                  // [kTile keys][kTile queries]
  float* lse_s = dss + kTile * kTile;           // [kTile]
  float* delta_s = lse_s + kTile;               // [kTile]

  const int nq = t / kTile;
  const int iq = nq - 1 - blockIdx.x;  // longest causal strips first
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const size_t stride = static_cast<size_t>(h) * d;
  const size_t head = static_cast<size_t>(b) * t * stride +
                      static_cast<size_t>(hh) * d;
  const size_t rows = (static_cast<size_t>(b) * h + hh) * t;  // lse, delta
  const int q0 = iq * kTile;

  flash::stage_tile<T, D>(q + head + q0 * stride, stride, d, nullptr, qt);
  flash::stage_tile<T, D>(dout + head + q0 * stride, stride, d, nullptr, dot);
  if (tid < kTile) {
    lse_s[tid] = lse[rows + q0 + tid];
    delta_s[tid] = delta[rows + q0 + tid];
  }
  __syncthreads();
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_r[i] = lse_s[ty * 4 + i];
    delta_r[i] = delta_s[ty * 4 + i];
  }

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  const int nk = causal ? iq + 1 : nq;
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * kTile;
    __syncthreads();  // previous tile's kt, vt, ks, dss consumed
    flash::stage_tile<T, D>(k + head + k0 * stride, stride, d, ks, kt);
    flash::stage_tile<T, D>(v + head + k0 * stride, stride, d, nullptr, vt);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    flash::mm_tt(qt, kt, d, ty * 4, tx * 4, s);
    flash::mm_tt(dot, vt, d, ty * 4, tx * 4, dp);
    const bool diagonal = causal && ik == iq;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (diagonal && ty * 4 + i < tx * 4 + j) x = mask_value;
        const float p = expf(x - lse_r[i]);
        s[i][j] = p * (dp[i][j] - delta_r[i]);  // ds
      }
    flash::store_block_t(dss, ty * 4, tx * 4, s);
    __syncthreads();
    flash::mm_pn<D>(dss, ks, ty * 4, tx * 4, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] *= scale;
  flash::write_block<T, D>(dq + head + q0 * stride, stride, d, ty * 4, tx * 4,
                           acc);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int t, int h, int d, float scale,
                     float mask_value, int causal) {
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);  // [D][kTile]
  float* vt = kt + D * kTile;                   // [D][kTile]
  float* qt = vt + D * kTile;                   // [D][kTile]
  float* dot = qt + D * kTile;                  // [D][kTile]
  float* qs = dot + D * kTile;                  // [kTile][D]
  float* dos = qs + kTile * D;                  // [kTile][D]
  float* ps = dos + kTile * D;                  // [kTile queries][kTile keys]
  float* lse_s = ps + kTile * kTile;            // [kTile]
  float* delta_s = lse_s + kTile;               // [kTile]

  const int nk = t / kTile;
  const int ik = blockIdx.x;  // key tile 0 has the longest causal strip
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  // this thread's block of the transposed tiles: keys ty*4.., queries tx*4..
  const int ty = tid / 16, tx = tid % 16;
  const size_t stride = static_cast<size_t>(h) * d;
  const size_t head = static_cast<size_t>(b) * t * stride +
                      static_cast<size_t>(hh) * d;
  const size_t rows = (static_cast<size_t>(b) * h + hh) * t;
  const int k0 = ik * kTile;

  flash::stage_tile<T, D>(k + head + k0 * stride, stride, d, nullptr, kt);
  flash::stage_tile<T, D>(v + head + k0 * stride, stride, d, nullptr, vt);

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      dk_acc[i][c] = 0.f;
      dv_acc[i][c] = 0.f;
    }

  for (int iq = causal ? ik : 0; iq < nk; ++iq) {
    const int q0 = iq * kTile;
    __syncthreads();  // k, v staged / previous tile's q, dout, ps consumed
    flash::stage_tile<T, D>(q + head + q0 * stride, stride, d, qs, qt);
    flash::stage_tile<T, D>(dout + head + q0 * stride, stride, d, dos, dot);
    if (tid < kTile) {
      lse_s[tid] = lse[rows + q0 + tid];
      delta_s[tid] = delta[rows + q0 + tid];
    }
    __syncthreads();

    // st[jj][ii] = s[query tx*4+ii][key ty*4+jj], likewise dpt
    float st[4][4] = {}, dpt[4][4] = {};
    flash::mm_tt(kt, qt, d, ty * 4, tx * 4, st);
    flash::mm_tt(vt, dot, d, ty * 4, tx * 4, dpt);
    const bool diagonal = causal && iq == ik;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        float x = st[jj][ii] * scale;
        if (diagonal && tx * 4 + ii < ty * 4 + jj) x = mask_value;
        const float p = expf(x - lse_s[tx * 4 + ii]);
        st[jj][ii] = p;
        dpt[jj][ii] = p * (dpt[jj][ii] - delta_s[tx * 4 + ii]);  // ds
      }
    // dv += p^T dout: p through ps, query-major (ps[query][key])
    flash::store_block_t(ps, ty * 4, tx * 4, st);
    __syncthreads();
    flash::mm_pn<D>(ps, dos, ty * 4, tx * 4, dv_acc);
    __syncthreads();
    // dk += ds^T q
    flash::store_block_t(ps, ty * 4, tx * 4, dpt);
    __syncthreads();
    flash::mm_pn<D>(ps, qs, ty * 4, tx * 4, dk_acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk_acc[i][c] *= scale;
  flash::write_block<T, D>(dk + head + k0 * stride, stride, d, ty * 4, tx * 4,
                           dk_acc);
  flash::write_block<T, D>(dv + head + k0 * stride, stride, d, ty * 4, tx * 4,
                           dv_acc);
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int b, int t, int h, int d, float scale,
                      float mask_value, int causal, cudaStream_t stream) {
  static flash::SmemOptIn opted_in;
  const size_t smem = dq_smem_bytes(D);
  const cudaError_t err =
      flash::opt_in_smem(flash_bwd_dq_kernel<T, D>, smem, &opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid(t / kTile, h, b);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), t, h, d, scale, mask_value, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int b, int t, int h, int d,
                       float scale, float mask_value, int causal,
                       cudaStream_t stream) {
  static flash::SmemOptIn opted_in;
  const size_t smem = dkv_smem_bytes(D);
  const cudaError_t err =
      flash::opt_in_smem(flash_bwd_dkv_kernel<T, D>, smem, &opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid(t / kTile, h, b);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), t, h, d, scale, mask_value,
      causal);
  return cudaGetLastError();
}

// -- bf16: wgmma kernels ---------------------------------------------------

namespace sm90 = flash::sm90;
using bf16 = __nv_bfloat16;

// Warpgroups of a CTA, 64 rows each, by head dimension: one at D = 64,
// where a thread holds ~160-230 registers and 2-3 CTAs share an SM, so
// one CTA's products overlap another's elementwise work; two at D = 128,
// where registers allow one CTA an SM and the second warpgroup gives
// that overlap and halves the loads of the walked tiles.
template <int D>
constexpr int kWarpgroups = D == 64 ? 1 : 2;

// bytes of one staged 64-row bf16 tile of D features
template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return sm90::kRows * D * 2;
}

template <int D>
size_t dq90_smem_bytes() {
  // q, dout [W * 64][D]; two stages of k, v [64][D]; 1024 to align
  return 1024 + (2 * kWarpgroups<D> + 4) * tile_bytes<D>();
}

template <int D>
size_t dkv90_smem_bytes() {
  // k, v [W * 64][D]; two stages of q, dout [64][D] and lse, delta [64]
  return 1024 + (2 * kWarpgroups<D> + 4) * tile_bytes<D>() +
         2 * 2 * sm90::kRows * sizeof(float);
}

constexpr float kLog2e = 1.4426950408889634f;

template <int D, int W = kWarpgroups<D>>
__global__ void __launch_bounds__(W * sm90::kWarpgroup)
flash_bwd_dq_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int t, int h, int d, float scale, float mask_value,
                  int causal) {
  extern __shared__ __align__(1024) uint8_t smem[];
  constexpr uint32_t kTileBytes = tile_bytes<D>();
  const uint32_t sq = (sm90::smem_addr(smem) + 1023u) & ~1023u;
  constexpr int kCtaRows = W * sm90::kRows, kThreads = W * sm90::kWarpgroup;
  const uint32_t sdo = sq + W * kTileBytes;
  const uint32_t skv = sdo + W * kTileBytes;  // stage s: k, then v

  const int nq = t / kCtaRows;
  const int iq = nq - 1 - blockIdx.z;  // longest causal strips first
  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int wg = tid / sm90::kWarpgroup, lt = tid % sm90::kWarpgroup;
  const size_t stride = static_cast<size_t>(h) * d;
  const size_t head = static_cast<size_t>(b) * t * stride +
                      static_cast<size_t>(hh) * d;
  const size_t rows = (static_cast<size_t>(b) * h + hh) * t;  // lse, delta
  const int q0 = iq * kCtaRows;
  const int qt = W * iq + wg;  // this warpgroup's 64-query tile
  const uint32_t sq_w = sq + wg * kTileBytes, sdo_w = sdo + wg * kTileBytes;

  sm90::load_tile<D, kCtaRows, kThreads>(sq, q + head + q0 * stride, stride,
                                         d, tid);
  sm90::load_tile<D, kCtaRows, kThreads>(sdo, dout + head + q0 * stride,
                                         stride, d, tid);
  auto load_kv = [&](int ik, int stage) {
    const uint32_t sk = skv + stage * 2 * kTileBytes;
    const size_t off = head + static_cast<size_t>(ik) * sm90::kRows * stride;
    sm90::load_tile<D, sm90::kRows, kThreads>(sk, k + off, stride, d, tid);
    sm90::load_tile<D, sm90::kRows, kThreads>(sk + kTileBytes, v + off,
                                              stride, d, tid);
  };
  load_kv(0, 0);
  sm90::cp_async_commit();

  float lse_r[2], delta_r[2];  // lse in base 2
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t r = rows + q0 + wg * sm90::kRows + sm90::acc_row(lt, 2 * i);
    lse_r[i] = lse[r] * kLog2e;
    delta_r[i] = delta[r];
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  uint32_t frag[3][4][4];

  const int nk = causal ? W * (iq + 1) : t / sm90::kRows;
  for (int ik = 0; ik < nk; ++ik) {
    if (ik + 1 < nk) {
      load_kv(ik + 1, (ik + 1) & 1);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    sm90::fence_proxy_async();
    __syncthreads();
    const uint32_t sk = skv + (ik & 1) * 2 * kTileBytes;
    if (!causal || ik <= qt) {  // at W = 2, warpgroup 0 skips the last
      float s[32], dp[32];
      sm90::wgmma_fence();
      sm90::mma_rows<D>(s, sq_w, sk);
      sm90::mma_rows<D>(dp, sdo_w, sk + kTileBytes);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<32>(s);
      sm90::fence_regs<32>(dp);
      const bool diagonal = causal && ik == qt;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        float x = s[e] * scale;
        if (diagonal && sm90::acc_row(lt, e) < sm90::acc_col(lt, e))
          x = mask_value;
        const float p = exp2f(x * kLog2e - lse_r[(e / 2) % 2]);
        s[e] = p * (dp[e] - delta_r[(e / 2) % 2]);  // ds
      }
      sm90::split_frags(s, frag);
      sm90::fence_regs<48>(&frag[0][0][0]);
      sm90::fence_regs<D / 2>(acc);
      sm90::wgmma_fence();
      sm90::mma_split<D>(acc, frag, sk);  // dq += ds k
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<D / 2>(acc);
      sm90::fence_regs<48>(&frag[0][0][0]);
    }
    __syncthreads();  // every warpgroup done with this stage
  }

  const int r_base = q0 + wg * sm90::kRows;
#pragma unroll
  for (int g = 0; g < D / 8; ++g)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = sm90::acc_col(lt, 4 * g);
      if (c < d) {  // d % 8 == 0: a column pair is all in or all out
        const int r = r_base + sm90::acc_row(lt, 2 * half);
        *reinterpret_cast<__nv_bfloat162*>(dq + head + r * stride + c) =
            __floats2bfloat162_rn(acc[4 * g + 2 * half] * scale,
                                  acc[4 * g + 2 * half + 1] * scale);
      }
    }
}

template <int D, int W = kWarpgroups<D>>
__global__ void __launch_bounds__(W * sm90::kWarpgroup)
flash_bwd_dkv_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int t, int h, int d, float scale,
                   float mask_value, int causal) {
  extern __shared__ __align__(1024) uint8_t smem[];
  constexpr uint32_t kTileBytes = tile_bytes<D>();
  const uint32_t raw = sm90::smem_addr(smem);
  const uint32_t sk = (raw + 1023u) & ~1023u;
  constexpr int kCtaRows = W * sm90::kRows, kThreads = W * sm90::kWarpgroup;
  const uint32_t sv = sk + W * kTileBytes;
  const uint32_t sqd = sv + W * kTileBytes;    // stage s: q, then dout
  const uint32_t srows = sqd + 4 * kTileBytes;  // stage s: lse, then delta
  const float* rows_s = reinterpret_cast<const float*>(smem + (srows - raw));

  const int ik = blockIdx.z;  // key tile 0 has the longest causal strip
  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int wg = tid / sm90::kWarpgroup, lt = tid % sm90::kWarpgroup;
  const size_t stride = static_cast<size_t>(h) * d;
  const size_t head = static_cast<size_t>(b) * t * stride +
                      static_cast<size_t>(hh) * d;
  const size_t rows = (static_cast<size_t>(b) * h + hh) * t;
  const int k0 = ik * kCtaRows;
  const int kt = W * ik + wg;  // this warpgroup's 64-key tile
  const uint32_t sk_w = sk + wg * kTileBytes, sv_w = sv + wg * kTileBytes;

  sm90::load_tile<D, kCtaRows, kThreads>(sk, k + head + k0 * stride, stride,
                                         d, tid);
  sm90::load_tile<D, kCtaRows, kThreads>(sv, v + head + k0 * stride, stride,
                                         d, tid);
  auto load_q = [&](int iq, int stage) {
    const uint32_t s = sqd + stage * 2 * kTileBytes;
    const size_t off = head + static_cast<size_t>(iq) * sm90::kRows * stride;
    sm90::load_tile<D, sm90::kRows, kThreads>(s, q + off, stride, d, tid);
    sm90::load_tile<D, sm90::kRows, kThreads>(s + kTileBytes, dout + off,
                                              stride, d, tid);
    if (tid < 32) {  // 16 chunks of lse, then 16 of delta
      const float* src = (tid < 16 ? lse : delta) + rows +
                         iq * sm90::kRows + (tid % 16) * 4;
      sm90::cp_async16(srows + stage * 512 + tid * 16, src, 16);
    }
  };
  const int nq = t / sm90::kRows;
  const int first = causal ? W * ik : 0;
  load_q(first, 0);
  sm90::cp_async_commit();

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  uint32_t frag[3][4][4];

  for (int iq = first; iq < nq; ++iq) {
    const int stage = (iq - first) & 1;
    if (iq + 1 < nq) {
      load_q(iq + 1, stage ^ 1);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    sm90::fence_proxy_async();
    __syncthreads();
    const uint32_t sq = sqd + stage * 2 * kTileBytes, sdo = sq + kTileBytes;
    const float* lse_s = rows_s + stage * 128;
    const float* delta_s = lse_s + sm90::kRows;
    if (!causal || iq >= kt) {  // at W = 2, warpgroup 1 skips the first
      // st[key][query] = s^T, dpt = dp^T
      float st[32], dpt[32];
      sm90::wgmma_fence();
      sm90::mma_rows<D>(st, sk_w, sq);
      sm90::mma_rows<D>(dpt, sv_w, sdo);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<32>(st);
      sm90::fence_regs<32>(dpt);
      const bool diagonal = causal && iq == kt;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = sm90::acc_col(lt, e);  // query
        float x = st[e] * scale;
        if (diagonal && i < sm90::acc_row(lt, e)) x = mask_value;
        const float p = exp2f(x * kLog2e - lse_s[i] * kLog2e);
        st[e] = p;
        dpt[e] = p * (dpt[e] - delta_s[i]);  // ds^T
      }
      sm90::split_frags(st, frag);
      sm90::fence_regs<48>(&frag[0][0][0]);
      sm90::fence_regs<D / 2>(dv_acc);
      sm90::wgmma_fence();
      sm90::mma_split<D>(dv_acc, frag, sdo);  // dv += p^T dout
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<D / 2>(dv_acc);
      sm90::fence_regs<48>(&frag[0][0][0]);
      sm90::split_frags(dpt, frag);
      sm90::fence_regs<48>(&frag[0][0][0]);
      sm90::fence_regs<D / 2>(dk_acc);
      sm90::wgmma_fence();
      sm90::mma_split<D>(dk_acc, frag, sq);  // dk += ds^T q
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<D / 2>(dk_acc);
      sm90::fence_regs<48>(&frag[0][0][0]);
    }
    __syncthreads();  // every warpgroup done with this stage
  }

  const int r_base = k0 + wg * sm90::kRows;
#pragma unroll
  for (int g = 0; g < D / 8; ++g)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = sm90::acc_col(lt, 4 * g);
      if (c < d) {  // d % 8 == 0: a column pair is all in or all out
        const size_t o = head + (r_base + sm90::acc_row(lt, 2 * half)) *
                                    stride + c;
        const int e = 4 * g + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(dk + o) = __floats2bfloat162_rn(
            dk_acc[e] * scale, dk_acc[e + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + o) =
            __floats2bfloat162_rn(dv_acc[e], dv_acc[e + 1]);
      }
    }
}

template <int D>
cudaError_t launch_dq_sm90(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dq, int b, int t, int h,
                           int d, float scale, float mask_value, int causal,
                           cudaStream_t stream) {
  static flash::SmemOptIn opted_in;
  const size_t smem = dq90_smem_bytes<D>();
  const cudaError_t err =
      flash::opt_in_smem(flash_bwd_dq_sm90<D>, smem, &opted_in);
  if (err != cudaSuccess) return err;
  constexpr int W = kWarpgroups<D>;
  const dim3 grid(h, b, t / (W * sm90::kRows));
  flash_bwd_dq_sm90<D><<<grid, W * sm90::kWarpgroup, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), t, h, d, scale, mask_value, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_sm90(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv, int b,
                            int t, int h, int d, float scale,
                            float mask_value, int causal,
                            cudaStream_t stream) {
  static flash::SmemOptIn opted_in;
  const size_t smem = dkv90_smem_bytes<D>();
  const cudaError_t err =
      flash::opt_in_smem(flash_bwd_dkv_sm90<D>, smem, &opted_in);
  if (err != cudaSuccess) return err;
  constexpr int W = kWarpgroups<D>;
  const dim3 grid(h, b, t / (W * sm90::kRows));
  flash_bwd_dkv_sm90<D><<<grid, W * sm90::kWarpgroup, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), t, h, d, scale,
      mask_value, causal);
  return cudaGetLastError();
}

bool shape_ok(int dtype, int b, int t, int h, int d) {
  const int rows = dtype == 1 ? 2 * sm90::kRows : kTile;
  return b >= 1 && h >= 1 && t >= rows && t % rows == 0 && d >= 8 &&
         d <= 128 && d % 8 == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Each returns a cudaError_t (0 = launched).
int flash_attention_bwd_dq_launch(int dtype, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dq,
                                  int b, int t, int h, int d, float scale,
                                  float mask_value, int causal, void* stream) {
  if (!shape_ok(dtype, b, t, h, d)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  if (dtype == 0)
    return d <= 64 ? launch_dq<float, 64>(q, k, v, dout, l, dl, dq, b, t, h, d,
                                          scale, mask_value, causal, s)
                   : launch_dq<float, 128>(q, k, v, dout, l, dl, dq, b, t, h,
                                           d, scale, mask_value, causal, s);
  if (dtype == 1)
    return d <= 64 ? launch_dq_sm90<64>(q, k, v, dout, l, dl, dq, b, t, h, d,
                                        scale, mask_value, causal, s)
                   : launch_dq_sm90<128>(q, k, v, dout, l, dl, dq, b, t, h, d,
                                         scale, mask_value, causal, s);
  return cudaErrorInvalidValue;
}

int flash_attention_bwd_dkv_launch(int dtype, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int b, int t, int h,
                                   int d, float scale, float mask_value,
                                   int causal, void* stream) {
  if (!shape_ok(dtype, b, t, h, d)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  if (dtype == 0)
    return d <= 64 ? launch_dkv<float, 64>(q, k, v, dout, l, dl, dk, dv, b, t,
                                           h, d, scale, mask_value, causal, s)
                   : launch_dkv<float, 128>(q, k, v, dout, l, dl, dk, dv, b, t,
                                            h, d, scale, mask_value, causal, s);
  if (dtype == 1)
    return d <= 64 ? launch_dkv_sm90<64>(q, k, v, dout, l, dl, dk, dv, b, t,
                                         h, d, scale, mask_value, causal, s)
                   : launch_dkv_sm90<128>(q, k, v, dout, l, dl, dk, dv, b, t,
                                          h, d, scale, mask_value, causal, s);
  return cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
