// Flash-attention forward for Hopper (sm_90a): causal or full attention
// over [batch, t, heads, head_dim] with an online softmax, saving the
// log-sum-exp for the backward kernels (flash_attention_bwd.cu).
//
// Replaces distkeras_tpu/ops/pallas/flash_attention.py::_fwd_kernel (the
// TPU kernel behind _fwd_impl / flash_attention). It computes the same
// function, for each (batch row, head, query i):
//   s_ij = (q_i . k_j) accumulated in float32, times head_dim^-0.5,
//          MASK_VALUE where causal and i < j;
//   online softmax over key tiles in float32: running max m, denominator
//   l and accumulator acc, rescaled by alpha = exp(m_prev - m_next);
//   p = exp(s - m_next) is ROUNDED TO THE INPUT DTYPE before p . v
//   (flash_attention.py:177), which is accumulated in float32, while l
//   sums the unrounded p (:175);
//   out = acc / l in the input dtype, lse = m + log(l) as float32
//   [batch, heads, t].
//
// What bounds it on this card: operations. At the training shape
// [8, 2048, 12, 64] bf16 it does 4 * head_dim flops for each of ~2.0e8
// visible (query, key) pairs, ~52 us at the bf16 tensor-core rate,
// against ~30 us for its bytes. Its 2.0e8 exponentials take about as
// long again on the special-function units (16 a clock an SM: ~54 us at
// 1.75 GHz on 132 SMs), so at head_dim 64 a kernel that runs products
// and exponentials in turn sits near twice that bound; overlapping them
// (two warpgroups in ping-pong) is later work.
//
// bf16 inputs (the training path) run on the tensor cores
// (flash_fwd_sm90):
//   - one CTA owns 64 query rows per warpgroup (one warpgroup at
//     head_dim <= 64, two above, as the backward) and walks 64-key tiles
//     up to its causal diagonal, longest strips first; q, k and v are
//     bf16 in shared memory in the swizzled layout the wgmma descriptors
//     read (flash_attention_sm90.cuh), k and v loaded by cp.async two
//     stages deep, so the next key tile arrives while this one computes;
//   - s = q k^T is one bf16 wgmma from shared memory (K-major), exact
//     products in a float32 accumulator;
//   - the row max and sum take two shuffles (a row of the accumulator
//     lives in 4 threads); p = exp2 of base-2 logits;
//   - p is rounded to bf16 pair by pair (cvt.rn.bf16x2, the TPU kernel's
//     cast) straight into the A fragments of p . v, whose accumulator
//     layout matches: p never goes through shared memory; v is read
//     MN-major through the descriptor's transpose bit;
//   - no atomics: each CTA writes its own rows, so the result is
//     deterministic.
// float32 inputs keep the first version (flash_fwd_kernel: every product
// a float32 FMA over tiles staged as float32, p through shared memory);
// it serves the float32 identity checks, not the training path.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the cudaError_t of the launch. Tensors are contiguous
// [b, t, h, d] (lse [b, h, t]) with 16-byte aligned bases; t % 64 == 0
// (t % 128 == 0 for bf16 at d > 64), 8 <= d <= 128 and d % 8 == 0 (the
// wrapper checks).

#include "flash_attention_common.cuh"
#include "flash_attention_sm90.cuh"

namespace {

using flash::kThreads;
using flash::kTile;

size_t smem_bytes(int D) {
  // qt [D][64], kt [D][64], vs [64][D], ps [64][64]
  return sizeof(float) * (3 * static_cast<size_t>(D) * kTile + kTile * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int t, int h, int d, float scale,
                 float mask_value, int causal) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][kTile]
  float* kt = qt + D * kTile;                   // [D][kTile]
  float* vs = kt + D * kTile;                   // [kTile][D]
  float* ps = vs + kTile * D;                   // [kTile keys][kTile queries]

  const int nq = t / kTile;
  const int iq = nq - 1 - blockIdx.x;  // longest causal strips first
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t stride = static_cast<size_t>(h) * d;  // between positions
  const size_t head = static_cast<size_t>(b) * t * stride +
                      static_cast<size_t>(hh) * d;
  const int q0 = iq * kTile;

  flash::stage_tile<T, D>(q + head + q0 * stride, stride, d, nullptr, qt);

  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = __int_as_float(0xff800000);  // -inf, as the TPU kernel starts
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }

  const int nk = causal ? iq + 1 : nq;
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * kTile;
    __syncthreads();  // q staged / previous tile's kt, vs, ps consumed
    flash::stage_tile<T, D>(k + head + k0 * stride, stride, d, nullptr, kt);
    flash::stage_tile<T, D>(v + head + k0 * stride, stride, d, vs, nullptr);
    __syncthreads();

    float s[4][4] = {};
    flash::mm_tt(qt, kt, d, ty * 4, tx * 4, s);
    const bool diagonal = causal && ik == iq;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= scale;
        if (diagonal && ty * 4 + i < tx * 4 + j) s[i][j] = mask_value;
      }
      float m_cur = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      m_cur = flash::max16(m_cur);
      const float m_next = fmaxf(m[i], m_cur);
      const float alpha = expf(m[i] - m_next);  // 0 on the first tile
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_next);
        row_sum += s[i][j];
      }
      row_sum = flash::sum16(row_sum);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_next;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
      // p . v takes p in the input dtype (flash_attention.py:177)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = flash::round_to<T>(s[i][j]);
    }
    flash::store_block_t(ps, ty * 4, tx * 4, s);
    __syncthreads();
    flash::mm_pn<D>(ps, vs, ty * 4, tx * 4, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = acc[i][c] / l[i];
  flash::write_block<T, D>(out + head + q0 * stride, stride, d, ty * 4,
                           tx * 4, acc);
  if (tx == 0) {
    float* lse_row = lse + (static_cast<size_t>(b) * h + hh) * t + q0;
#pragma unroll
    for (int i = 0; i < 4; ++i) lse_row[ty * 4 + i] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int b, int t, int h, int d, float scale,
                   float mask_value, int causal, cudaStream_t stream) {
  static bool opted_in = false;
  const size_t smem = smem_bytes(D);
  const cudaError_t err =
      flash::opt_in_smem(flash_fwd_kernel<T, D>, smem, &opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid(t / kTile, h, b);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, t, h, d, scale,
      mask_value, causal);
  return cudaGetLastError();
}

// -- bf16: wgmma kernel -----------------------------------------------------

namespace sm90 = flash::sm90;
using bf16 = __nv_bfloat16;

// Warpgroups of a CTA, 64 query rows each, by head dimension: one at
// D = 64, where four CTAs share an SM and one CTA's products overlap
// another's exponentials (a probe of two ran slower); two at D = 128,
// which halves the loads of the walked key and value tiles.
template <int D>
constexpr int kWarpgroups = D == 64 ? 1 : 2;

template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return sm90::kRows * D * 2;
}

template <int D>
size_t fwd90_smem_bytes() {
  // q [W * 64][D]; two stages of k, v [64][D]; 1024 to align
  return 1024 + (kWarpgroups<D> + 4) * tile_bytes<D>();
}

constexpr float kLog2e = 1.4426950408889634f;

template <int D, int W = kWarpgroups<D>>
__global__ void __launch_bounds__(W * sm90::kWarpgroup)
flash_fwd_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out,
               float* __restrict__ lse, int t, int h, int d, float scale,
               float mask_value, int causal) {
  extern __shared__ __align__(1024) uint8_t smem[];
  constexpr uint32_t kTileBytes = tile_bytes<D>();
  const uint32_t sq = (sm90::smem_addr(smem) + 1023u) & ~1023u;
  constexpr int kCtaRows = W * sm90::kRows, kThreads = W * sm90::kWarpgroup;
  const uint32_t skv = sq + W * kTileBytes;  // stage s: k, then v

  const int nq = t / kCtaRows;
  const int iq = nq - 1 - blockIdx.z;  // longest causal strips first
  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int wg = tid / sm90::kWarpgroup, lt = tid % sm90::kWarpgroup;
  const size_t stride = static_cast<size_t>(h) * d;
  const size_t head = static_cast<size_t>(b) * t * stride +
                      static_cast<size_t>(hh) * d;
  const int q0 = iq * kCtaRows;
  const int qt = W * iq + wg;  // this warpgroup's 64-query tile
  const uint32_t sq_w = sq + wg * kTileBytes;

  sm90::load_tile<D, kCtaRows, kThreads>(sq, q + head + q0 * stride, stride,
                                         d, tid);
  auto load_kv = [&](int ik, int stage) {
    const uint32_t sk = skv + stage * 2 * kTileBytes;
    const size_t off = head + static_cast<size_t>(ik) * sm90::kRows * stride;
    sm90::load_tile<D, sm90::kRows, kThreads>(sk, k + off, stride, d, tid);
    sm90::load_tile<D, sm90::kRows, kThreads>(sk + kTileBytes, v + off,
                                              stride, d, tid);
  };
  load_kv(0, 0);
  sm90::cp_async_commit();

  // this thread's two rows (acc_row of elements 0 and 2): running max
  // (natural units), denominator
  const float neg_inf = __int_as_float(0xff800000);
  float m[2] = {neg_inf, neg_inf}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  uint32_t frag[4][4];

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
      float s[32];
      sm90::wgmma_fence();
      sm90::mma_rows<D>(s, sq_w, sk);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<32>(s);
      const bool diagonal = causal && ik == qt;
      float m_cur[2] = {neg_inf, neg_inf};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        float x = s[e] * scale;
        if (diagonal && sm90::acc_row(lt, e) < sm90::acc_col(lt, e))
          x = mask_value;
        s[e] = x;
        m_cur[(e / 2) % 2] = fmaxf(m_cur[(e / 2) % 2], x);
      }
      float alpha[2], m_l2e[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // a row lives in 4 threads (lt % 4)
        m_cur[i] = fmaxf(m_cur[i], __shfl_xor_sync(0xffffffffu, m_cur[i], 1));
        m_cur[i] = fmaxf(m_cur[i], __shfl_xor_sync(0xffffffffu, m_cur[i], 2));
        const float m_next = fmaxf(m[i], m_cur[i]);
        alpha[i] = exp2f((m[i] - m_next) * kLog2e);  // 0 on the first tile
        m[i] = m_next;
        m_l2e[i] = m_next * kLog2e;
      }
      float row_sum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float p = exp2f(fmaf(s[e], kLog2e, -m_l2e[(e / 2) % 2]));
        s[e] = p;
        row_sum[(e / 2) % 2] += p;  // l sums the unrounded p
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 1);
        row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 2);
        l[i] = l[i] * alpha[i] + row_sum[i];
      }
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e / 2) % 2];
      sm90::round_frags(s, frag);  // p . v takes p in bf16 (:177)
      sm90::fence_regs<16>(&frag[0][0]);
      sm90::fence_regs<D / 2>(acc);
      sm90::wgmma_fence();
      sm90::mma_frags<D>(acc, frag, sk + kTileBytes);  // acc += p v
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<D / 2>(acc);
      sm90::fence_regs<16>(&frag[0][0]);
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
        const int e = 4 * g + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(out + head + r * stride + c) =
            __floats2bfloat162_rn(acc[e] / l[half], acc[e + 1] / l[half]);
      }
    }
  if (lt % 4 == 0) {
    float* lse_row = lse + (static_cast<size_t>(b) * h + hh) * t + r_base;
#pragma unroll
    for (int half = 0; half < 2; ++half)
      lse_row[sm90::acc_row(lt, 2 * half)] = m[half] + logf(l[half]);
  }
}

template <int D>
cudaError_t launch_sm90(const void* q, const void* k, const void* v,
                        void* out, float* lse, int b, int t, int h, int d,
                        float scale, float mask_value, int causal,
                        cudaStream_t stream) {
  constexpr int W = kWarpgroups<D>;
  if (t % (W * sm90::kRows)) return cudaErrorInvalidValue;
  static bool opted_in = false;
  const size_t smem = fwd90_smem_bytes<D>();
  const cudaError_t err =
      flash::opt_in_smem(flash_fwd_sm90<D>, smem, &opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid(h, b, t / (W * sm90::kRows));
  flash_fwd_sm90<D><<<grid, W * sm90::kWarpgroup, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, t, h, d,
      scale, mask_value, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int flash_attention_fwd_launch(int dtype, const void* q, const void* k,
                               const void* v, void* out, void* lse, int b,
                               int t, int h, int d, float scale,
                               float mask_value, int causal, void* stream) {
  if (b < 1 || h < 1 || t < kTile || t % kTile || d < 8 || d > 128 || d % 8)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  if (dtype == 0)
    return d <= 64 ? launch<float, 64>(q, k, v, out, l, b, t, h, d, scale,
                                       mask_value, causal, s)
                   : launch<float, 128>(q, k, v, out, l, b, t, h, d, scale,
                                        mask_value, causal, s);
  if (dtype == 1)
    return d <= 64 ? launch_sm90<64>(q, k, v, out, l, b, t, h, d, scale,
                                     mask_value, causal, s)
                   : launch_sm90<128>(q, k, v, out, l, b, t, h, d, scale,
                                      mask_value, causal, s);
  return cudaErrorInvalidValue;
}

const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
