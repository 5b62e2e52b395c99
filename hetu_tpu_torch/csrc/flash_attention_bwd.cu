// Flash attention backward for Hopper (sm_90a), dense, `key_mask` and causal
// specializations: two kernels that replace
// hetu_tpu/ops/pallas/flash_attention.py::_dq_kernel and ::_dkv_kernel
// (launched by _flash_bwd).
//
// Both recompute the probabilities from the forward's row log-sum-exp instead
// of storing them: P = exp(s - lse) on valid keys (0 elsewhere, a select, so an
// all-masked row with lse = -1e30 never forms exp(+huge)), dP = dO.V^T and
// dS = P * (dP - delta) * scale with delta = rowsum(dO * O), computed by the
// caller.
//
// 1. flash_bwd_dq_kernel: one CTA per (b*h, 64 query rows); it loops over key
//    tiles and accumulates dQ += dS.K in registers.
// 2. flash_bwd_dkv_kernel: one CTA per (b*h, 64 keys); it loops over query
//    tiles and accumulates dV += P^T.dO and dK += dS^T.Q in registers.  It
//    forms the transposed tiles directly (S^T = K.Q^T, dP^T = V.dO^T), so each
//    thread owns whole key rows of dK and dV: no atomics, and the result is the
//    same from run to run.  Keys with key_mask 0 get P = 0, so dK = dV = 0.
//
// What bounds them: at the training shapes (S = 512, D = 64) the products'
// operations, 6 * S_q * S_kv * D flops for dQ (s, dP, dQ) and 8 * ... for
// dK/dV (s, dP, dV, dK) per (b*h), against a few S * D rows of bytes.  The
// design is the forward's (flash_tile.cuh): row tiles staged once in shared
// memory and used by 64 rows, 4 x 4 register blocks for the scores, the
// probability and dS tiles passed through shared memory, never device memory.
//
// Causal (template CAUSAL; key c is visible to query row r iff
// r + (S_kv - S_q) >= c, composed with key_mask): the probability is taken
// only on visible pairs (the same select), so a query row that sees no key
// (S_q > S_kv, lse = -1e30) contributes exact zeros.  dQ's key loop ends at
// the last key its tile's last row sees; dK/dV's query loop starts at the
// first query tile that sees the key tile's first key, so tiles wholly above
// the diagonal cost nothing: about half the dense work at S_q = S_kv.  A key
// tile no query row sees runs no iteration and writes dK = dV = 0.
//
// Not yet: tensor cores, double-buffered staging, one fused kernel for dQ and
// dK/dV, the full-mask, bias and `lengths` specializations.

#include <cuda_runtime.h>

#include "flash_tile.cuh"

namespace {

using namespace hetu_flash;

// G: float4 output column groups per thread (D <= 64 G)
template <int G, bool CAUSAL>
__global__ void __launch_bounds__(TTHREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ key_mask,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq, int heads,
                    int s_q, int s_kv, int d, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ld = d + 4;
  float* q_s = smem;              // TILE x ld
  float* do_s = q_s + TILE * ld;  // TILE x ld
  float* k_s = do_s + TILE * ld;  // TILE x ld
  float* v_s = k_s + TILE * ld;   // TILE x ld
  float* ds_s = v_s + TILE * ld;  // TILE x PLD
  int* ok_s = reinterpret_cast<int*>(ds_s + TILE * PLD);  // TILE key flags

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* kb = k + (size_t)bh * s_kv * d;
  const float* vb = v + (size_t)bh * s_kv * d;
  const int* km = key_mask ? key_mask + (size_t)(bh / heads) * s_kv : nullptr;

  stage_rows(q_s, q + (size_t)bh * s_q * d, q0, s_q, d);
  stage_rows(do_s, dout + (size_t)bh * s_q * d, q0, s_q, d);
  float lse_r[4], dl_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    lse_r[i] = row < s_q ? lse[(size_t)bh * s_q + row] : 0.f;
    dl_r[i] = row < s_q ? delta[(size_t)bh * s_q + row] : 0.f;
  }
  float4 acc[4][G];
  zero_acc(acc);
  const int kv_off = s_kv - s_q;
  const int k_end = CAUSAL ? min(s_kv, min(q0 + TILE, s_q) + kv_off) : s_kv;

  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();  // the previous tile's K and dS are consumed
    stage_rows(k_s, kb, k0, s_kv, d);
    stage_rows(v_s, vb, k0, s_kv, d);
    if (tid < TILE) {
      const int key = k0 + tid;
      ok_s[tid] = key < s_kv && (km == nullptr || km[key] != 0);
    }
    cp_async_wait_all();
    __syncthreads();

    float s[4][4], dp[4][4];
    dot_rows(s, q_s, k_s, d, ty, tx);
    dot_rows(dp, do_s, v_s, d, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool okj = ok_s[c] != 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool ok = okj;
        if (CAUSAL) ok = ok && (q0 + 4 * ty + i + kv_off >= k0 + c);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        ds_s[(4 * ty + i) * PLD + c] = p * (dp[i][j] - dl_r[i]) * scale;
      }
    }
    __syncthreads();
    acc_rows(acc, ds_s, k_s, d, ty, tx);
  }
  cp_async_wait_all();  // a tile with no live key tile staged Q and dO only
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows(dq + (size_t)bh * s_q * d, acc, one, q0, s_q, d, ty, tx);
}

template <int G, bool CAUSAL>
__global__ void __launch_bounds__(TTHREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ key_mask,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int heads, int s_q, int s_kv, int d,
                     float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ld = d + 4;
  float* k_s = smem;               // TILE x ld
  float* v_s = k_s + TILE * ld;    // TILE x ld
  float* q_s = v_s + TILE * ld;    // TILE x ld
  float* do_s = q_s + TILE * ld;   // TILE x ld
  float* pt_s = do_s + TILE * ld;  // TILE x PLD: P^T (key rows)
  float* dst_s = pt_s + TILE * PLD;  // TILE x PLD: dS^T (key rows)
  float* lse_s = dst_s + TILE * PLD;  // TILE
  float* dl_s = lse_s + TILE;         // TILE
  int* qok_s = reinterpret_cast<int*>(dl_s + TILE);  // TILE query flags

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* qb = q + (size_t)bh * s_q * d;
  const float* dob = dout + (size_t)bh * s_q * d;
  const int* km = key_mask ? key_mask + (size_t)(bh / heads) * s_kv : nullptr;

  stage_rows(k_s, k + (size_t)bh * s_kv * d, k0, s_kv, d);
  stage_rows(v_s, v + (size_t)bh * s_kv * d, k0, s_kv, d);
  bool kok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    kok[i] = key < s_kv && (km == nullptr || km[key] != 0);
  }
  float4 dk_acc[4][G], dv_acc[4][G];
  zero_acc(dk_acc);
  zero_acc(dv_acc);
  // causal: the first query row that sees key k0 is k0 - kv_off; start at
  // its tile (past s_q: no iteration, dK = dV = 0)
  const int kv_off = s_kv - s_q;
  const int q_begin = CAUSAL ? (max(0, k0 - kv_off) / TILE) * TILE : 0;

  for (int q0 = q_begin; q0 < s_q; q0 += TILE) {
    __syncthreads();  // the previous tile's Q, dO, P^T and dS^T are consumed
    stage_rows(q_s, qb, q0, s_q, d);
    stage_rows(do_s, dob, q0, s_q, d);
    if (tid < TILE) {
      const int row = q0 + tid;
      const bool in = row < s_q;
      lse_s[tid] = in ? lse[(size_t)bh * s_q + row] : 0.f;
      dl_s[tid] = in ? delta[(size_t)bh * s_q + row] : 0.f;
      qok_s[tid] = in;
    }
    cp_async_wait_all();
    __syncthreads();

    float st[4][4], dpt[4][4];  // [key 4ty + i][query tx + 16j]
    dot_rows(st, k_s, q_s, d, ty, tx);
    dot_rows(dpt, v_s, do_s, d, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool qok = qok_s[c] != 0;
      const float ls = lse_s[c], dl = dl_s[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool ok = kok[i] && qok;
        if (CAUSAL) ok = ok && (q0 + c + kv_off >= k0 + 4 * ty + i);
        const float p = ok ? expf(st[i][j] * scale - ls) : 0.f;
        pt_s[(4 * ty + i) * PLD + c] = p;
        dst_s[(4 * ty + i) * PLD + c] = p * (dpt[i][j] - dl) * scale;
      }
    }
    __syncthreads();
    acc_rows(dv_acc, pt_s, do_s, d, ty, tx);
    acc_rows(dk_acc, dst_s, q_s, d, ty, tx);
  }
  cp_async_wait_all();  // a tile with no live query tile staged K and V only
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows(dk + (size_t)bh * s_kv * d, dk_acc, one, k0, s_kv, d, ty, tx);
  store_rows(dv + (size_t)bh * s_kv * d, dv_acc, one, k0, s_kv, d, ty, tx);
}

template <int G, bool CAUSAL>
int launch_dq(const float* q, const float* k, const float* v, const int* key_mask,
              const float* dout, const float* lse, const float* delta, float* dq, int bh,
              int heads, int s_q, int s_kv, int d, float scale, cudaStream_t stream) {
  static size_t configured[64] = {0};
  const size_t smem =
      (size_t)(4 * TILE * (d + 4) + TILE * PLD) * sizeof(float) + TILE * sizeof(int);
  cudaError_t err = ensure_smem((const void*)flash_bwd_dq_kernel<G, CAUSAL>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_q + TILE - 1) / TILE, bh);
  flash_bwd_dq_kernel<G, CAUSAL><<<grid, TTHREADS, smem, stream>>>(
      q, k, v, key_mask, dout, lse, delta, dq, heads, s_q, s_kv, d, scale);
  return (int)cudaGetLastError();
}

template <int G, bool CAUSAL>
int launch_dkv(const float* q, const float* k, const float* v, const int* key_mask,
               const float* dout, const float* lse, const float* delta, float* dk, float* dv,
               int bh, int heads, int s_q, int s_kv, int d, float scale,
               cudaStream_t stream) {
  static size_t configured[64] = {0};
  const size_t smem = (size_t)(4 * TILE * (d + 4) + 2 * TILE * PLD + 2 * TILE) * sizeof(float) +
                      TILE * sizeof(int);
  cudaError_t err = ensure_smem((const void*)flash_bwd_dkv_kernel<G, CAUSAL>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_kv + TILE - 1) / TILE, bh);
  flash_bwd_dkv_kernel<G, CAUSAL><<<grid, TTHREADS, smem, stream>>>(
      q, k, v, key_mask, dout, lse, delta, dk, dv, heads, s_q, s_kv, d, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int bh, int heads, int s_q, int s_kv, int d) {
  return d <= 0 || d > 128 || (d & 3) || heads <= 0 || bh <= 0 || bh > 65535 || bh % heads ||
         s_q <= 0 || s_kv <= 0;
}

template <bool CAUSAL>
int dispatch_dq(const float* q, const float* k, const float* v, const int* key_mask,
                const float* dout, const float* lse, const float* delta, float* dq, int bh,
                int heads, int s_q, int s_kv, int d, float scale, void* stream) {
  if (bad_shape(bh, heads, s_q, s_kv, d)) return (int)cudaErrorInvalidValue;
  return d <= 64 ? launch_dq<1, CAUSAL>(q, k, v, key_mask, dout, lse, delta, dq, bh, heads,
                                        s_q, s_kv, d, scale, (cudaStream_t)stream)
                 : launch_dq<2, CAUSAL>(q, k, v, key_mask, dout, lse, delta, dq, bh, heads,
                                        s_q, s_kv, d, scale, (cudaStream_t)stream);
}

template <bool CAUSAL>
int dispatch_dkv(const float* q, const float* k, const float* v, const int* key_mask,
                 const float* dout, const float* lse, const float* delta, float* dk, float* dv,
                 int bh, int heads, int s_q, int s_kv, int d, float scale, void* stream) {
  if (bad_shape(bh, heads, s_q, s_kv, d)) return (int)cudaErrorInvalidValue;
  return d <= 64 ? launch_dkv<1, CAUSAL>(q, k, v, key_mask, dout, lse, delta, dk, dv, bh,
                                         heads, s_q, s_kv, d, scale, (cudaStream_t)stream)
                 : launch_dkv<2, CAUSAL>(q, k, v, key_mask, dout, lse, delta, dk, dv, bh,
                                         heads, s_q, s_kv, d, scale, (cudaStream_t)stream);
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() after the launch
// (0 = launched).  q/dout/dq (bh, s_q, d), k/v/dk/dv (bh, s_kv, d): contiguous
// float32, 16-byte aligned; key_mask (bh / heads, s_kv) int32 or null; lse and
// delta (bh, s_q) float32.  The `_causal` entries add the causal rule.
extern "C" int hetu_flash_bwd_dq(const float* q, const float* k, const float* v,
                                 const int* key_mask, const float* dout, const float* lse,
                                 const float* delta, float* dq, int bh, int heads, int s_q,
                                 int s_kv, int d, float scale, void* stream) {
  return dispatch_dq<false>(q, k, v, key_mask, dout, lse, delta, dq, bh, heads, s_q, s_kv, d,
                            scale, stream);
}

extern "C" int hetu_flash_bwd_dq_causal(const float* q, const float* k, const float* v,
                                        const int* key_mask, const float* dout,
                                        const float* lse, const float* delta, float* dq,
                                        int bh, int heads, int s_q, int s_kv, int d,
                                        float scale, void* stream) {
  return dispatch_dq<true>(q, k, v, key_mask, dout, lse, delta, dq, bh, heads, s_q, s_kv, d,
                           scale, stream);
}

extern "C" int hetu_flash_bwd_dkv(const float* q, const float* k, const float* v,
                                  const int* key_mask, const float* dout, const float* lse,
                                  const float* delta, float* dk, float* dv, int bh, int heads,
                                  int s_q, int s_kv, int d, float scale, void* stream) {
  return dispatch_dkv<false>(q, k, v, key_mask, dout, lse, delta, dk, dv, bh, heads, s_q, s_kv,
                             d, scale, stream);
}

extern "C" int hetu_flash_bwd_dkv_causal(const float* q, const float* k, const float* v,
                                         const int* key_mask, const float* dout,
                                         const float* lse, const float* delta, float* dk,
                                         float* dv, int bh, int heads, int s_q, int s_kv,
                                         int d, float scale, void* stream) {
  return dispatch_dkv<true>(q, k, v, key_mask, dout, lse, delta, dk, dv, bh, heads, s_q, s_kv,
                            d, scale, stream);
}
