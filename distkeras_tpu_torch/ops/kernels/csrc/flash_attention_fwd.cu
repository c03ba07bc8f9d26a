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
//   (flash_attention.py:177), which is accumulated in float32;
//   out = acc / l in the input dtype, lse = m + log(l) as float32
//   [batch, heads, t].
//
// What bounds it on this card: operations. At the training shape
// [8, 2048, 12, 64] bf16 it does 4 * head_dim flops for each of ~2.0e8
// visible (query, key) pairs, ~52 us at the bf16 tensor-core rate,
// against ~30 us for its bytes. This first version does every product
// with float32 fused multiply-adds (one kernel for float32 and bfloat16
// inputs), so it runs far below that bound; wgmma, TMA and pipelining
// are later work. What the design does:
//   - the TPU kernel's sequential key-block grid axis becomes a loop
//     inside one CTA per (64-query tile, head, batch row); CTAs run in
//     parallel in no order and share nothing;
//   - causal tile skipping as on the TPU: a CTA walks key tiles only up
//     to its diagonal tile, which it masks elementwise; CTAs are numbered
//     longest strip first so that the long causal strips start early;
//   - the query tile stays in shared memory for the whole walk; each key
//     tile is staged once (16-byte loads) as k feature-major and v
//     row-major, and p goes through shared memory, key-major, for p . v.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the cudaError_t of the launch. Tensors are contiguous
// [b, t, h, d] (lse [b, h, t]) with 16-byte aligned bases; t % 64 == 0,
// 8 <= d <= 128 and d % 8 == 0 (the wrapper checks).

#include "flash_attention_common.cuh"

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

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     float* lse, int b, int t, int h, int d, float scale,
                     float mask_value, int causal, cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, out, lse, b, t, h, d, scale, mask_value,
                         causal, stream);
  return launch<T, 128>(q, k, v, out, lse, b, t, h, d, scale, mask_value,
                        causal, stream);
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
    return launch_d<float>(q, k, v, out, l, b, t, h, d, scale, mask_value,
                           causal, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, l, b, t, h, d, scale,
                                   mask_value, causal, s);
  return cudaErrorInvalidValue;
}

const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
