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
// every product in float32 (ds and p are float32, so none may take bf16
// operands without changing the function), outputs in the input dtypes.
//
// What bounds them on this card: operations. At [8, 2048, 12, 64] bf16,
// per visible (query, key) pair dq does 4 * head_dim flops of products
// whose operands are bf16 values (q k^T, dout v^T) and 2 * head_dim of
// float32 products (ds k): ~52 + ~385 us at the card's bf16 and float32
// peaks; dk/dv does the same two recomputed products plus 4 * head_dim of
// float32 products (p^T dout, ds^T q): ~52 + ~770 us. This first version
// does all of them with float32 fused multiply-adds. What the design does:
//   - dq: one CTA per (64-query tile, head, batch row) walks key tiles up
//     to its causal diagonal, the TPU kernel's sequential grid axis
//     become a loop; q and dout stay staged feature-major, each key tile
//     is staged as k (both layouts) and v (feature-major); ds goes
//     through shared memory, key-major, for ds k;
//   - dk/dv: one CTA per (64-key tile, head, batch row) walks query tiles
//     from its diagonal to the end and keeps both accumulators in
//     registers, so no two CTAs write the same output and no atomics are
//     needed; it computes the transposed tiles s^T, dp^T directly (k and
//     v staged feature-major once), and passes p, then ds, through one
//     query-major shared tile for p^T dout and ds^T q;
//   - CTAs are numbered longest causal strip first.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the cudaError_t of the launch. q, k, v, dout, dq, dk, dv are
// contiguous [b, t, h, d], lse and delta contiguous float32 [b, h, t];
// bases 16-byte aligned; t % 64 == 0, 8 <= d <= 128, d % 8 == 0 (the
// wrapper checks).

#include "flash_attention_common.cuh"

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
  static bool opted_in = false;
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
  static bool opted_in = false;
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

bool shape_ok(int b, int t, int h, int d) {
  return b >= 1 && h >= 1 && t >= kTile && t % kTile == 0 && d >= 8 &&
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
  if (!shape_ok(b, t, h, d)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  if (dtype == 0)
    return d <= 64 ? launch_dq<float, 64>(q, k, v, dout, l, dl, dq, b, t, h, d,
                                          scale, mask_value, causal, s)
                   : launch_dq<float, 128>(q, k, v, dout, l, dl, dq, b, t, h,
                                           d, scale, mask_value, causal, s);
  if (dtype == 1)
    return d <= 64 ? launch_dq<__nv_bfloat16, 64>(q, k, v, dout, l, dl, dq, b,
                                                  t, h, d, scale, mask_value,
                                                  causal, s)
                   : launch_dq<__nv_bfloat16, 128>(q, k, v, dout, l, dl, dq, b,
                                                   t, h, d, scale, mask_value,
                                                   causal, s);
  return cudaErrorInvalidValue;
}

int flash_attention_bwd_dkv_launch(int dtype, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int b, int t, int h,
                                   int d, float scale, float mask_value,
                                   int causal, void* stream) {
  if (!shape_ok(b, t, h, d)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  if (dtype == 0)
    return d <= 64 ? launch_dkv<float, 64>(q, k, v, dout, l, dl, dk, dv, b, t,
                                           h, d, scale, mask_value, causal, s)
                   : launch_dkv<float, 128>(q, k, v, dout, l, dl, dk, dv, b, t,
                                            h, d, scale, mask_value, causal, s);
  if (dtype == 1)
    return d <= 64 ? launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, l, dl, dk,
                                                   dv, b, t, h, d, scale,
                                                   mask_value, causal, s)
                   : launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, l, dl, dk,
                                                    dv, b, t, h, d, scale,
                                                    mask_value, causal, s);
  return cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
