// Flash attention backward for Hopper (sm_90a), dense, `key_mask`, causal and
// additive-bias specializations: two kernels that replace
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
// Additive bias (templates BIAS, KBIAS, as in the forward): both kernels
// recompute the biased scores s * scale + bias.  With a dense bias (G, S_q,
// S_kv) the dQ kernel also writes t = P * (dP - delta), the pre-scale dS, as
// dbias (BH, S_q, S_kv) float32, the TPU kernel's per-block dbias tiles; the
// caller sums it over the bias's broadcast group.  Under causal it writes
// zeros into the key tiles past its loop (the TPU kernel's pruned-block zero
// tiles), so every entry of dbias is defined.  The dK/dV kernel reads the bias
// of its (query tile, key tile) through the shared-memory tile dS^T uses later
// (a coalesced row-major load, read back transposed), at the cost of one more
// barrier a tile.  With a key-bias strip (G, 1, S_kv) the dK/dV kernel sums t
// over the query rows into dkbias (BH, 1, S_kv): each thread keeps the partial
// sums of its 4 keys in registers across the query tiles, and the 16 threads
// of a key row combine them once at the end; the CTA owns its keys, so no
// atomics, and the result is the same from run to run.  dbias is the one
// output of S_q * S_kv floats a (b*h): at the T5 encoder shape (B*H = 256,
// S = 512) it adds 268 MB of writes to the dQ kernel.
//
// Full mask (template FMASK; Longformer's sliding window, XLNet's permutation
// masks): a uint8 mask stored unbroadcast as (G, S_q, S_kv) of group mode
// `gmode` (as the forward's), composed with key_mask, causal and either
// bias, the bias through its own group mode `bgmode`.  The dQ kernel stages
// each 64 x 64 mask tile once in shared memory beside K and V, as the
// forward does (4 KB; ragged edges read 0).  The dK/dV kernel owns keys and
// needs the tile transposed: it stages the (query, key) tile row-major,
// coalesced, into a buffer of its own (the bias already uses dS^T's), with
// rows of 68 bytes so that a thread's four keys are one aligned 4-byte read
// and the 32 threads of a warp hit 32 distinct banks.  The probability is
// the same select on validity, so a row the mask hides entirely (lse =
// -1e30; the first token of each permutation in XLNet's query stream) gives
// dQ = 0 and a dbias row of exact zeros and adds nothing to dK, dV or
// dkbias; dbias is exactly 0 on every masked pair (t = P (dP - delta) with
// P = 0).  No tile is skipped: validity is data, so at Longformer's 4096
// the kernels walk every (query tile, key tile) pair though 12.6 % of the
// pairs are visible.
//
// float32 only (template T = float): the bf16 entries run the tensor-core
// kernels of flash_attention_dq_bf16.cu and flash_attention_dkv_bf16.cu.
// The kernels and the C entries' bodies live in this header; the entries
// are compiled in flash_attention_bwd.cu.
//
// Not yet: tensor cores (TF32 would change the float32 numbers),
// double-buffered staging, one fused kernel for dQ and dK/dV, skipping the
// tiles a data mask hides, the `lengths` specialization, the group sum of
// dbias inside the kernel.

#pragma once

#include <cuda_runtime.h>

#include "flash_tile.cuh"

namespace {

using namespace hetu_flash;

// Row stride in bytes of the dK/dV kernel's transposed mask tile: 17 words,
// so the uchar4 reads of a warp land in 32 distinct banks.
constexpr int MLD = TILE + 4;

// T: the element type of q, k, v, dO and the gradients (float); G: float4
// output column groups per thread (D <= 64 G); FMASK: `mask` points to the
// (G, S_q, S_kv) uint8 mask of group mode `gmode`; BIAS / KBIAS: at most
// one, `bias` then points to the (G, S_q, S_kv) bias or the (G, S_kv) strip
// of group mode `bgmode`; `dbias` (BH, S_q, S_kv) is written with BIAS
template <typename T, int G, bool CAUSAL, bool FMASK, bool BIAS, bool KBIAS>
__global__ void __launch_bounds__(TTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ key_mask,
                    const unsigned char* __restrict__ mask, const float* __restrict__ bias,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    float* __restrict__ dbias, int heads, int gmode, int bgmode, int s_q,
                    int s_kv, int d, float scale) {
  static_assert(!(BIAS && KBIAS), "a dense bias or a key-bias strip, not both");
  extern __shared__ __align__(16) float smem[];
  const int ld = d + 4;
  float* q_s = smem;              // TILE x ld
  float* do_s = q_s + TILE * ld;  // TILE x ld
  float* k_s = do_s + TILE * ld;  // TILE x ld
  float* v_s = k_s + TILE * ld;   // TILE x ld
  float* ds_s = v_s + TILE * ld;  // TILE x PLD
  int* ok_s = reinterpret_cast<int*>(ds_s + TILE * PLD);  // TILE key flags
  unsigned char* msk_s = reinterpret_cast<unsigned char*>(ok_s + TILE);  // TILE x TILE (FMASK)

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* kb = k + (size_t)bh * s_kv * d;
  const T* vb = v + (size_t)bh * s_kv * d;
  const int* km = key_mask ? key_mask + (size_t)(bh / heads) * s_kv : nullptr;
  const unsigned char* mb = nullptr;
  if (FMASK) mb = mask + (size_t)group_row(gmode, bh, heads) * s_q * s_kv;
  const float* bb = nullptr;
  if (BIAS || KBIAS)
    bb = bias + (size_t)group_row(bgmode, bh, heads) * (BIAS ? (size_t)s_q * s_kv : s_kv);
  float* dbb = BIAS ? dbias + (size_t)bh * s_q * s_kv : nullptr;

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
    if (FMASK) {
      for (int i = tid; i < TILE * TILE; i += TTHREADS) {
        const int row = q0 + (i >> 6), key = k0 + (i & (TILE - 1));
        msk_s[i] = (row < s_q && key < s_kv) ? mb[(size_t)row * s_kv + key] : 0;
      }
    }
    cp_async_wait_all();
    __syncthreads();

    float bv[4][4];  // the bias of each score, loaded ahead of the products
    if constexpr (BIAS || KBIAS) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = q0 + 4 * ty + i;
          if constexpr (BIAS)
            bv[i][j] = (row < s_q && key < s_kv) ? bb[(size_t)row * s_kv + key] : 0.f;
          else
            bv[i][j] = key < s_kv ? bb[key] : 0.f;
        }
      }
    }
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
        if (FMASK) ok = ok && msk_s[(4 * ty + i) * TILE + c] != 0;
        float p;
        if constexpr (BIAS || KBIAS)
          p = ok ? expf(s[i][j] * scale + bv[i][j] - lse_r[i]) : 0.f;
        else
          p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        const float t = p * (dp[i][j] - dl_r[i]);  // dL/d(logit), before the scale
        // dS.K takes dS rounded to T (the TPU kernel's ds.astype(k.dtype))
        ds_s[(4 * ty + i) * PLD + c] = round_to<T>(t * scale);
        if constexpr (BIAS) {
          const int row = q0 + 4 * ty + i;
          if (row < s_q && k0 + c < s_kv) dbb[(size_t)row * s_kv + k0 + c] = t;
        }
      }
    }
    __syncthreads();
    acc_rows(acc, ds_s, k_s, d, ty, tx);
  }
  if constexpr (BIAS && CAUSAL) {
    // key tiles past the loop: no row of this tile sees them, dbias = 0
    const int kz = k_end <= 0 ? 0 : (k_end + TILE - 1) / TILE * TILE;
    for (int k0 = kz; k0 < s_kv; k0 += TILE)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + 4 * ty + i;
        if (row >= s_q) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + tx + 16 * j;
          if (key < s_kv) dbb[(size_t)row * s_kv + key] = 0.f;
        }
      }
  }
  cp_async_wait_all();  // a tile with no live key tile staged Q and dO only
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows(dq + (size_t)bh * s_q * d, acc, one, q0, s_q, d, ty, tx);
}

// FMASK, BIAS / KBIAS, `mask` and `bias` as for the dQ kernel; `dkbias`
// (BH, S_kv) is written with KBIAS
template <typename T, int G, bool CAUSAL, bool FMASK, bool BIAS, bool KBIAS>
__global__ void __launch_bounds__(TTHREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ key_mask,
                     const unsigned char* __restrict__ mask, const float* __restrict__ bias,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, float* __restrict__ dkbias, int heads, int gmode,
                     int bgmode, int s_q, int s_kv, int d, float scale) {
  static_assert(!(BIAS && KBIAS), "a dense bias or a key-bias strip, not both");
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
  // FMASK: the (query, key) mask tile, query rows of MLD bytes
  unsigned char* msk_s = reinterpret_cast<unsigned char*>(qok_s + TILE);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qb = q + (size_t)bh * s_q * d;
  const T* dob = dout + (size_t)bh * s_q * d;
  const int* km = key_mask ? key_mask + (size_t)(bh / heads) * s_kv : nullptr;
  const unsigned char* mb = nullptr;
  if (FMASK) mb = mask + (size_t)group_row(gmode, bh, heads) * s_q * s_kv;
  const float* bb = nullptr;
  if (BIAS || KBIAS)
    bb = bias + (size_t)group_row(bgmode, bh, heads) * (BIAS ? (size_t)s_q * s_kv : s_kv);

  stage_rows(k_s, k + (size_t)bh * s_kv * d, k0, s_kv, d);
  stage_rows(v_s, v + (size_t)bh * s_kv * d, k0, s_kv, d);
  bool kok[4];
  float kbv[4], dkb[4];  // KBIAS: the strip of this thread's keys, its dkbias sums
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    kok[i] = key < s_kv && (km == nullptr || km[key] != 0);
    kbv[i] = (KBIAS && key < s_kv) ? bb[key] : 0.f;
    dkb[i] = 0.f;
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
    if constexpr (BIAS) {
      // the (query, key) bias tile, row-major into dS^T's buffer
      for (int i = tid; i < TILE * TILE; i += TTHREADS) {
        const int r = i >> 6, c = i & (TILE - 1);
        dst_s[r * PLD + c] = (q0 + r < s_q && k0 + c < s_kv)
                                 ? bb[(size_t)(q0 + r) * s_kv + k0 + c] : 0.f;
      }
    }
    if (FMASK) {
      for (int i = tid; i < TILE * TILE; i += TTHREADS) {
        const int r = i >> 6, c = i & (TILE - 1);
        msk_s[r * MLD + c] = (q0 + r < s_q && k0 + c < s_kv)
                                 ? mb[(size_t)(q0 + r) * s_kv + k0 + c] : 0;
      }
    }
    cp_async_wait_all();
    __syncthreads();

    float bv[4][4];  // BIAS: [key 4ty + i][query tx + 16j]
    if constexpr (BIAS) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 b4 =
            *reinterpret_cast<const float4*>(dst_s + (tx + 16 * j) * PLD + 4 * ty);
        bv[0][j] = b4.x;
        bv[1][j] = b4.y;
        bv[2][j] = b4.z;
        bv[3][j] = b4.w;
      }
      __syncthreads();  // every thread has its bias before dS^T overwrites it
    }
    float st[4][4], dpt[4][4];  // [key 4ty + i][query tx + 16j]
    dot_rows(st, k_s, q_s, d, ty, tx);
    dot_rows(dpt, v_s, do_s, d, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool qok = qok_s[c] != 0;
      const float ls = lse_s[c], dl = dl_s[c];
      // FMASK: mask[query c][keys 4ty .. 4ty + 3], one aligned 4-byte read
      uchar4 mk = make_uchar4(1, 1, 1, 1);
      if (FMASK) mk = *reinterpret_cast<const uchar4*>(msk_s + c * MLD + 4 * ty);
      const unsigned char mki[4] = {mk.x, mk.y, mk.z, mk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool ok = kok[i] && qok;
        if (CAUSAL) ok = ok && (q0 + c + kv_off >= k0 + 4 * ty + i);
        if (FMASK) ok = ok && mki[i] != 0;
        float p;
        if constexpr (BIAS)
          p = ok ? expf(st[i][j] * scale + bv[i][j] - ls) : 0.f;
        else if constexpr (KBIAS)
          p = ok ? expf(st[i][j] * scale + kbv[i] - ls) : 0.f;
        else
          p = ok ? expf(st[i][j] * scale - ls) : 0.f;
        const float t = p * (dpt[i][j] - dl);  // dL/d(logit), before the scale
        // P^T.dO and dS^T.Q take P and dS rounded to T (the TPU kernel's
        // p.astype(do.dtype), ds.astype(q.dtype)); dkbias the unrounded t
        pt_s[(4 * ty + i) * PLD + c] = round_to<T>(p);
        dst_s[(4 * ty + i) * PLD + c] = round_to<T>(t * scale);
        if constexpr (KBIAS) dkb[i] += t;
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
  if constexpr (KBIAS) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float sum = half_sum(dkb[i]);  // over the 16 threads of key row 4ty + i
      const int key = k0 + 4 * ty + i;
      if (tx == 0 && key < s_kv) dkbias[(size_t)bh * s_kv + key] = sum;
    }
  }
}

template <typename T, int G, bool CAUSAL, bool FMASK, bool BIAS, bool KBIAS>
int launch_dq(const T* q, const T* k, const T* v, const int* key_mask, const unsigned char* mask,
              const float* bias, const T* dout, const float* lse, const float* delta, T* dq,
              float* dbias, int bh, int heads, int gmode, int bgmode, int s_q, int s_kv, int d,
              float scale, cudaStream_t stream) {
  static size_t configured[64] = {0};
  const size_t smem = (size_t)(4 * TILE * (d + 4) + TILE * PLD) * sizeof(float) +
                      TILE * sizeof(int) + (FMASK ? TILE * TILE : 0);
  cudaError_t err = ensure_smem(
      (const void*)flash_bwd_dq_kernel<T, G, CAUSAL, FMASK, BIAS, KBIAS>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_q + TILE - 1) / TILE, bh);
  flash_bwd_dq_kernel<T, G, CAUSAL, FMASK, BIAS, KBIAS><<<grid, TTHREADS, smem, stream>>>(
      q, k, v, key_mask, mask, bias, dout, lse, delta, dq, dbias, heads, gmode, bgmode, s_q,
      s_kv, d, scale);
  return (int)cudaGetLastError();
}

template <typename T, int G, bool CAUSAL, bool FMASK, bool BIAS, bool KBIAS>
int launch_dkv(const T* q, const T* k, const T* v, const int* key_mask,
               const unsigned char* mask, const float* bias, const T* dout, const float* lse,
               const float* delta, T* dk, T* dv, float* dkbias, int bh, int heads, int gmode,
               int bgmode, int s_q, int s_kv, int d, float scale, cudaStream_t stream) {
  static size_t configured[64] = {0};
  const size_t smem = (size_t)(4 * TILE * (d + 4) + 2 * TILE * PLD + 2 * TILE) * sizeof(float) +
                      TILE * sizeof(int) + (FMASK ? TILE * MLD : 0);
  cudaError_t err = ensure_smem(
      (const void*)flash_bwd_dkv_kernel<T, G, CAUSAL, FMASK, BIAS, KBIAS>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_kv + TILE - 1) / TILE, bh);
  flash_bwd_dkv_kernel<T, G, CAUSAL, FMASK, BIAS, KBIAS><<<grid, TTHREADS, smem, stream>>>(
      q, k, v, key_mask, mask, bias, dout, lse, delta, dk, dv, dkbias, heads, gmode, bgmode, s_q,
      s_kv, d, scale);
  return (int)cudaGetLastError();
}

template <typename T>
bool bad_shape(int bh, int heads, int s_q, int s_kv, int d, int gmode = 0, int bgmode = 0) {
  return bad_head_dim<T>(d) || heads <= 0 || bh <= 0 || bh > 65535 || bh % heads || s_q <= 0 ||
         s_kv <= 0 || gmode < 0 || gmode > 3 || bgmode < 0 || bgmode > 3;
}

template <typename T, bool CAUSAL, bool FMASK = false, bool BIAS = false, bool KBIAS = false>
int dispatch_dq(const T* q, const T* k, const T* v, const int* key_mask,
                const unsigned char* mask, const float* bias, const T* dout, const float* lse,
                const float* delta, T* dq, float* dbias, int bh, int heads, int gmode,
                int bgmode, int s_q, int s_kv, int d, float scale, void* stream) {
  if (bad_shape<T>(bh, heads, s_q, s_kv, d, gmode, bgmode)) return (int)cudaErrorInvalidValue;
  return d <= 64 ? launch_dq<T, 1, CAUSAL, FMASK, BIAS, KBIAS>(
                       q, k, v, key_mask, mask, bias, dout, lse, delta, dq, dbias, bh, heads,
                       gmode, bgmode, s_q, s_kv, d, scale, (cudaStream_t)stream)
                 : launch_dq<T, 2, CAUSAL, FMASK, BIAS, KBIAS>(
                       q, k, v, key_mask, mask, bias, dout, lse, delta, dq, dbias, bh, heads,
                       gmode, bgmode, s_q, s_kv, d, scale, (cudaStream_t)stream);
}

template <typename T, bool CAUSAL, bool FMASK = false, bool BIAS = false, bool KBIAS = false>
int dispatch_dkv(const T* q, const T* k, const T* v, const int* key_mask,
                 const unsigned char* mask, const float* bias, const T* dout, const float* lse,
                 const float* delta, T* dk, T* dv, float* dkbias, int bh, int heads, int gmode,
                 int bgmode, int s_q, int s_kv, int d, float scale, void* stream) {
  if (bad_shape<T>(bh, heads, s_q, s_kv, d, gmode, bgmode)) return (int)cudaErrorInvalidValue;
  return d <= 64 ? launch_dkv<T, 1, CAUSAL, FMASK, BIAS, KBIAS>(
                       q, k, v, key_mask, mask, bias, dout, lse, delta, dk, dv, dkbias, bh,
                       heads, gmode, bgmode, s_q, s_kv, d, scale, (cudaStream_t)stream)
                 : launch_dkv<T, 2, CAUSAL, FMASK, BIAS, KBIAS>(
                       q, k, v, key_mask, mask, bias, dout, lse, delta, dk, dv, dkbias, bh,
                       heads, gmode, bgmode, s_q, s_kv, d, scale, (cudaStream_t)stream);
}

// causal != 0 selects the causal rule
template <typename T, bool FMASK, bool BIAS, bool KBIAS>
int dq_sel(const T* q, const T* k, const T* v, const int* key_mask, const unsigned char* mask,
           const float* bias, const T* dout, const float* lse, const float* delta, T* dq,
           float* dbias, int bh, int heads, int s_q, int s_kv, int d, int gmode, int bgmode,
           int causal, float scale, void* stream) {
  return causal ? dispatch_dq<T, true, FMASK, BIAS, KBIAS>(q, k, v, key_mask, mask, bias, dout,
                                                           lse, delta, dq, dbias, bh, heads,
                                                           gmode, bgmode, s_q, s_kv, d, scale,
                                                           stream)
                : dispatch_dq<T, false, FMASK, BIAS, KBIAS>(q, k, v, key_mask, mask, bias, dout,
                                                            lse, delta, dq, dbias, bh, heads,
                                                            gmode, bgmode, s_q, s_kv, d, scale,
                                                            stream);
}

template <typename T, bool FMASK, bool BIAS, bool KBIAS>
int dkv_sel(const T* q, const T* k, const T* v, const int* key_mask, const unsigned char* mask,
            const float* bias, const T* dout, const float* lse, const float* delta, T* dk, T* dv,
            float* dkbias, int bh, int heads, int s_q, int s_kv, int d, int gmode, int bgmode,
            int causal, float scale, void* stream) {
  return causal ? dispatch_dkv<T, true, FMASK, BIAS, KBIAS>(q, k, v, key_mask, mask, bias, dout,
                                                            lse, delta, dk, dv, dkbias, bh,
                                                            heads, gmode, bgmode, s_q, s_kv, d,
                                                            scale, stream)
                : dispatch_dkv<T, false, FMASK, BIAS, KBIAS>(q, k, v, key_mask, mask, bias,
                                                             dout, lse, delta, dk, dv, dkbias,
                                                             bh, heads, gmode, bgmode, s_q, s_kv,
                                                             d, scale, stream);
}

// Additive bias: bias (G, s_q, s_kv) or, strip != 0, (G, 1, s_kv) float32 of
// group mode gmode; causal != 0 adds the causal rule.  dQ with a dense bias
// writes dbias (bh, s_q, s_kv) float32 (the pre-scale dS; null with a strip);
// dK/dV with a strip writes dkbias (bh, 1, s_kv) float32 (null with a dense
// bias).
template <typename T>
int entry_dq_bias(const T* q, const T* k, const T* v, const int* key_mask, const float* bias,
                  const T* dout, const float* lse, const float* delta, T* dq, float* dbias,
                  int bh, int heads, int s_q, int s_kv, int d, int gmode, int strip, int causal,
                  float scale, void* stream) {
  if (bias == nullptr || (strip != 0) != (dbias == nullptr)) return (int)cudaErrorInvalidValue;
  return strip ? dq_sel<T, false, false, true>(q, k, v, key_mask, nullptr, bias, dout, lse,
                                               delta, dq, nullptr, bh, heads, s_q, s_kv, d, 0,
                                               gmode, causal, scale, stream)
               : dq_sel<T, false, true, false>(q, k, v, key_mask, nullptr, bias, dout, lse,
                                               delta, dq, dbias, bh, heads, s_q, s_kv, d, 0,
                                               gmode, causal, scale, stream);
}

template <typename T>
int entry_dkv_bias(const T* q, const T* k, const T* v, const int* key_mask, const float* bias,
                   const T* dout, const float* lse, const float* delta, T* dk, T* dv,
                   float* dkbias, int bh, int heads, int s_q, int s_kv, int d, int gmode,
                   int strip, int causal, float scale, void* stream) {
  if (bias == nullptr || (strip != 0) != (dkbias != nullptr)) return (int)cudaErrorInvalidValue;
  return strip ? dkv_sel<T, false, false, true>(q, k, v, key_mask, nullptr, bias, dout, lse,
                                                delta, dk, dv, dkbias, bh, heads, s_q, s_kv, d,
                                                0, gmode, causal, scale, stream)
               : dkv_sel<T, false, true, false>(q, k, v, key_mask, nullptr, bias, dout, lse,
                                                delta, dk, dv, nullptr, bh, heads, s_q, s_kv, d,
                                                0, gmode, causal, scale, stream);
}

// Full mask: mask (G, s_q, s_kv) uint8 of group mode gmode, composed with
// key_mask and, causal != 0, the causal rule; optionally with an additive bias
// of its own group mode bgmode (bias null: the mask alone; strip != 0: the
// key-bias strip).  dQ writes dbias with a dense bias, dK/dV dkbias with a
// strip, as the bias entries do; each is null otherwise.
template <typename T>
int entry_dq_mask(const T* q, const T* k, const T* v, const int* key_mask,
                  const unsigned char* mask, const float* bias, const T* dout, const float* lse,
                  const float* delta, T* dq, float* dbias, int bh, int heads, int s_q, int s_kv,
                  int d, int gmode, int bgmode, int strip, int causal, float scale,
                  void* stream) {
  const bool dense = bias != nullptr && !strip;
  if (mask == nullptr || dense != (dbias != nullptr)) return (int)cudaErrorInvalidValue;
  if (bias == nullptr)
    return dq_sel<T, true, false, false>(q, k, v, key_mask, mask, nullptr, dout, lse, delta, dq,
                                         nullptr, bh, heads, s_q, s_kv, d, gmode, 0, causal,
                                         scale, stream);
  return strip ? dq_sel<T, true, false, true>(q, k, v, key_mask, mask, bias, dout, lse, delta,
                                              dq, nullptr, bh, heads, s_q, s_kv, d, gmode,
                                              bgmode, causal, scale, stream)
               : dq_sel<T, true, true, false>(q, k, v, key_mask, mask, bias, dout, lse, delta,
                                              dq, dbias, bh, heads, s_q, s_kv, d, gmode, bgmode,
                                              causal, scale, stream);
}

template <typename T>
int entry_dkv_mask(const T* q, const T* k, const T* v, const int* key_mask,
                   const unsigned char* mask, const float* bias, const T* dout, const float* lse,
                   const float* delta, T* dk, T* dv, float* dkbias, int bh, int heads, int s_q,
                   int s_kv, int d, int gmode, int bgmode, int strip, int causal, float scale,
                   void* stream) {
  const bool strip_bias = bias != nullptr && strip;
  if (mask == nullptr || strip_bias != (dkbias != nullptr)) return (int)cudaErrorInvalidValue;
  if (bias == nullptr)
    return dkv_sel<T, true, false, false>(q, k, v, key_mask, mask, nullptr, dout, lse, delta, dk,
                                          dv, nullptr, bh, heads, s_q, s_kv, d, gmode, 0, causal,
                                          scale, stream);
  return strip ? dkv_sel<T, true, false, true>(q, k, v, key_mask, mask, bias, dout, lse, delta,
                                               dk, dv, dkbias, bh, heads, s_q, s_kv, d, gmode,
                                               bgmode, causal, scale, stream)
               : dkv_sel<T, true, true, false>(q, k, v, key_mask, mask, bias, dout, lse, delta,
                                               dk, dv, nullptr, bh, heads, s_q, s_kv, d, gmode,
                                               bgmode, causal, scale, stream);
}

}  // namespace

// HETU_BWD_DQ_ENTRIES(T, SFX) and HETU_BWD_DKV_ENTRIES(T, SFX) define the dQ
// and the dK/dV C entries for element type T, each named with the suffix
// SFX; HETU_BWD_ENTRIES(T, SFX) both.  Each launches on `stream` and returns
// cudaGetLastError() after the launch (0 = launched).  q/dout/dq (bh, s_q,
// d), k/v/dk/dv (bh, s_kv, d): contiguous float32, 16-byte aligned; key_mask
// (bh / heads, s_kv) int32 or null; lse and delta (bh, s_q) float32; a bias,
// dbias and dkbias float32.  The `_causal` entries add the causal rule.
// (The `_bf16` twins run on the tensor cores: flash_attention_dq_bf16.cu,
// flash_attention_dkv_bf16.cu.)
#define HETU_BWD_DQ_ENTRIES(T, SFX)                                                             \
  extern "C" int hetu_flash_bwd_dq##SFX(const T* q, const T* k, const T* v,                    \
                                        const int* key_mask, const T* dout, const float* lse,  \
                                        const float* delta, T* dq, int bh, int heads, int s_q, \
                                        int s_kv, int d, float scale, void* stream) {          \
    return dispatch_dq<T, false>(q, k, v, key_mask, nullptr, nullptr, dout, lse, delta, dq,    \
                                 nullptr, bh, heads, 0, 0, s_q, s_kv, d, scale, stream);       \
  }                                                                                             \
  extern "C" int hetu_flash_bwd_dq_causal##SFX(                                                \
      const T* q, const T* k, const T* v, const int* key_mask, const T* dout, const float* lse, \
      const float* delta, T* dq, int bh, int heads, int s_q, int s_kv, int d, float scale,     \
      void* stream) {                                                                          \
    return dispatch_dq<T, true>(q, k, v, key_mask, nullptr, nullptr, dout, lse, delta, dq,     \
                                nullptr, bh, heads, 0, 0, s_q, s_kv, d, scale, stream);        \
  }                                                                                             \
  extern "C" int hetu_flash_bwd_dq_bias##SFX(                                                  \
      const T* q, const T* k, const T* v, const int* key_mask, const float* bias,              \
      const T* dout, const float* lse, const float* delta, T* dq, float* dbias, int bh,        \
      int heads, int s_q, int s_kv, int d, int gmode, int strip, int causal, float scale,      \
      void* stream) {                                                                          \
    return entry_dq_bias(q, k, v, key_mask, bias, dout, lse, delta, dq, dbias, bh, heads, s_q, \
                         s_kv, d, gmode, strip, causal, scale, stream);                        \
  }                                                                                             \
  extern "C" int hetu_flash_bwd_dq_mask##SFX(                                                  \
      const T* q, const T* k, const T* v, const int* key_mask, const unsigned char* mask,      \
      const float* bias, const T* dout, const float* lse, const float* delta, T* dq,           \
      float* dbias, int bh, int heads, int s_q, int s_kv, int d, int gmode, int bgmode,        \
      int strip, int causal, float scale, void* stream) {                                      \
    return entry_dq_mask(q, k, v, key_mask, mask, bias, dout, lse, delta, dq, dbias, bh,       \
                         heads, s_q, s_kv, d, gmode, bgmode, strip, causal, scale, stream);    \
  }

#define HETU_BWD_DKV_ENTRIES(T, SFX)                                                           \
  extern "C" int hetu_flash_bwd_dkv##SFX(const T* q, const T* k, const T* v,                   \
                                         const int* key_mask, const T* dout, const float* lse, \
                                         const float* delta, T* dk, T* dv, int bh, int heads,  \
                                         int s_q, int s_kv, int d, float scale,                \
                                         void* stream) {                                       \
    return dispatch_dkv<T, false>(q, k, v, key_mask, nullptr, nullptr, dout, lse, delta, dk,   \
                                  dv, nullptr, bh, heads, 0, 0, s_q, s_kv, d, scale, stream);  \
  }                                                                                             \
  extern "C" int hetu_flash_bwd_dkv_causal##SFX(                                               \
      const T* q, const T* k, const T* v, const int* key_mask, const T* dout, const float* lse, \
      const float* delta, T* dk, T* dv, int bh, int heads, int s_q, int s_kv, int d,           \
      float scale, void* stream) {                                                             \
    return dispatch_dkv<T, true>(q, k, v, key_mask, nullptr, nullptr, dout, lse, delta, dk,    \
                                 dv, nullptr, bh, heads, 0, 0, s_q, s_kv, d, scale, stream);   \
  }                                                                                             \
  extern "C" int hetu_flash_bwd_dkv_bias##SFX(                                                 \
      const T* q, const T* k, const T* v, const int* key_mask, const float* bias,              \
      const T* dout, const float* lse, const float* delta, T* dk, T* dv, float* dkbias,        \
      int bh, int heads, int s_q, int s_kv, int d, int gmode, int strip, int causal,           \
      float scale, void* stream) {                                                             \
    return entry_dkv_bias(q, k, v, key_mask, bias, dout, lse, delta, dk, dv, dkbias, bh,       \
                          heads, s_q, s_kv, d, gmode, strip, causal, scale, stream);           \
  }                                                                                             \
  extern "C" int hetu_flash_bwd_dkv_mask##SFX(                                                 \
      const T* q, const T* k, const T* v, const int* key_mask, const unsigned char* mask,      \
      const float* bias, const T* dout, const float* lse, const float* delta, T* dk, T* dv,    \
      float* dkbias, int bh, int heads, int s_q, int s_kv, int d, int gmode, int bgmode,       \
      int strip, int causal, float scale, void* stream) {                                      \
    return entry_dkv_mask(q, k, v, key_mask, mask, bias, dout, lse, delta, dk, dv, dkbias, bh, \
                          heads, s_q, s_kv, d, gmode, bgmode, strip, causal, scale, stream);   \
  }

#define HETU_BWD_ENTRIES(T, SFX) \
  HETU_BWD_DQ_ENTRIES(T, SFX)    \
  HETU_BWD_DKV_ENTRIES(T, SFX)
