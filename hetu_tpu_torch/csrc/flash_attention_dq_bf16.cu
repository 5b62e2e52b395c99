// Flash attention dQ for Hopper (sm_90a), bfloat16 on the tensor cores: the
// `_bf16` C entries hetu_flash_bwd_dq[_causal,_bias,_mask]_bf16, the TPU
// kernel's bf16 instantiation of
// hetu_tpu/ops/pallas/flash_attention.py::_dq_kernel (launched by
// _flash_bwd).  q, k, v, dO and dQ are bf16; lse, delta, the bias and dbias
// float32.  The specializations and their rules are the float32 kernel's
// (flash_attention_bwd.cuh): P = exp(s - lse) on valid pairs, 0 elsewhere
// (a select, so a row with lse = -1e30 never forms exp(+huge)),
// t = P * (dP - delta) and dQ = (t * scale).K; with a dense bias dbias = t,
// float32, zero on the key tiles a causal row never reaches.
//
// What bounds it: at the training shapes the three products, 6 * D flops per
// visible (row, key) pair: the tensor cores, not the memory (with a dense
// bias, the S_q * S_kv floats of bias read and dbias written come close).
// Design (the forward's, flash_attention_bf16.cu, on flash_mma.cuh): one CTA
// of 4 warps per (b*h, 64 query rows), 16 rows a warp.  dQ owns query rows
// as the forward's output does, and lse is known, so there is no online
// softmax: Q and dO of the warp's rows stay in registers as A fragments,
// lse and delta beside them (lse times log2 e, folded into the exponent's
// FMA with the scale), and the CTA walks the key tiles (causal: up to the
// last key its last row sees), each K and V tile double-buffered in shared
// memory with cp.async beside its key-mask words and, with FMASK, its uint8
// mask tile.  Each warp takes a tile in four chunks of 16 keys: S = Q.K^T
// and dP = dO.V^T on mma.sync (B from K and V rows through ldmatrix), then
// P and t in registers at fragment coordinates (rows g and g + 8 of the
// warp, keys 2t, 2t + 1 of each n8 tile), then dQ += dS.K with dS = t *
// scale rounded to bf16 as it becomes the A operand (the TPU kernel's
// ds.astype(k.dtype), flash_attention.py:343), B from the same K tile
// through ldmatrix.trans.  Chunks keep S and dP at 8 + 8 floats a thread,
// which leaves room for the dQ accumulator (D / 8 x 4 floats) at D = 128.
// Validity is taken before the products: a chunk that no row of the warp
// sees (causal past the diagonal, a key mask's padding, keys at or past
// `lengths`, a data mask's hidden block) runs no product; it would add
// exact zeros.  `lengths` (a nullable pointer read once a CTA) also ends
// the key-tile loop at the length, as causal ends it at the diagonal, and
// each staged tile's key flags fold the length in (the chunks past it then
// fail the chunk test and write their dbias zeros).  The dense bias
// is read and dbias written at fragment coordinates (a quad holds 8
// consecutive keys of one row: one 32-byte sector); a skipped chunk, and the
// key tiles past a causal loop, still get their zeros, so every entry of
// dbias is defined.  dQ is rounded to nearest even as it is stored
// (dq_scr.astype(dq_ref.dtype), :360).  Each CTA owns its rows: no atomics,
// and dQ and dbias are the same bit for bit from run to run.
//
// Not yet: wgmma and TMA, one fused kernel for dQ and dK/dV, skipping whole
// key tiles (their copies) a data mask hides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_mma.cuh"

namespace {

using namespace hetu_mma;

// Write v0, v1 at index i (even) and i + 1 of `dst`, each only where it is
// before n: one 8-byte store when the row is even (pair), else two.
__device__ __forceinline__ void store_pair(float* __restrict__ dst, int i, int n, bool pair,
                                           float v0, float v1) {
  if (pair) {
    if (i < n) *reinterpret_cast<float2*>(dst + i) = make_float2(v0, v1);
    return;
  }
  if (i < n) dst[i] = v0;
  if (i + 1 < n) dst[i + 1] = v1;
}

// DMAX, FMASK, BIAS / KBIAS, `lengths`, `mask`, `bias` and mask_vec as in
// the forward (flash_attention_bf16.cu); `dbias` (BH, S_q, S_kv) is written
// with BIAS
template <int DMAX, bool CAUSAL, bool FMASK, bool BIAS, bool KBIAS>
__global__ void __launch_bounds__(NTHREADS)
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ key_mask,
                    const int* __restrict__ lengths, const unsigned char* __restrict__ mask,
                    const float* __restrict__ bias, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq,
                    float* __restrict__ dbias, int heads, int gmode, int bgmode, int s_q,
                    int s_kv, int d, float scale, bool mask_vec) {
  static_assert(!(BIAS && KBIAS), "a dense bias or a key-bias strip, not both");
  constexpr int KS = DMAX / 16;  // k16 steps of Q.K^T and dO.V^T, d16 column pairs of dQ
  constexpr int ld = DMAX + 8;   // row stride of a staged tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // 2 buffers of TILE x ld; buffer 1 holds Q first
  bf16* v_s = k_s + 2 * TILE * ld;            // 2 buffers; buffer 1 holds dO first
  int* km_s = reinterpret_cast<int*>(v_s + 2 * TILE * ld);                   // 2 x TILE
  unsigned char* msk_s = reinterpret_cast<unsigned char*>(km_s + 2 * TILE);  // 2 x TILE x MLD

  const int bh = blockIdx.y, q0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const bf16* kb = k + (size_t)bh * s_kv * d;
  const bf16* vb = v + (size_t)bh * s_kv * d;
  const int* km = key_mask ? key_mask + (size_t)(bh / heads) * s_kv : nullptr;
  const unsigned char* mb = nullptr;
  if (FMASK) mb = mask + (size_t)group_row(gmode, bh, heads) * s_q * s_kv;
  const float* bb = nullptr;
  if (BIAS || KBIAS)
    bb = bias + (size_t)group_row(bgmode, bh, heads) * (BIAS ? (size_t)s_q * s_kv : s_kv);
  float* dbb = BIAS ? dbias + (size_t)bh * s_q * s_kv : nullptr;
  // keys [0, len) may be visible; causal: row r sees key c iff r + kv_off
  // >= c; the loop stops after the last key that the tile's last row sees
  const int len = lengths ? max(0, min(s_kv, lengths[bh / heads])) : s_kv;
  // the length the staging reads each tile: from shared memory, so it holds
  // no register across the loop
  __shared__ int len_s;
  if (tid == 0) len_s = len;
  const int kv_off = s_kv - s_q;
  const int k_end = CAUSAL ? min(len, min(q0 + TILE, s_q) + kv_off) : len;
  const int n_tiles = k_end > 0 ? (k_end + TILE - 1) / TILE : 0;

  auto stage = [&](int t) {
    const int buf = t & 1, k0 = t * TILE;
    stage_rows<DMAX>(k_s + buf * TILE * ld, kb, k0, s_kv, d);
    stage_rows<DMAX>(v_s + buf * TILE * ld, vb, k0, s_kv, d);
    if (lengths != nullptr && tid < TILE) {  // the length folded into the flags
      const int key = k0 + tid;
      km_s[buf * TILE + tid] = key < len_s && (km == nullptr || km[key] != 0);
    } else if (km != nullptr && tid < TILE) {
      const bool in = k0 + tid < s_kv;
      cp_async4(km_s + buf * TILE + tid, in ? km + k0 + tid : km, in);
    }
    if constexpr (FMASK) stage_mask(msk_s + buf * TILE * MLD, mb, q0, k0, s_q, s_kv, mask_vec);
  };

  // Q and dO into the second buffers (tile 1 overwrites them once they are
  // in registers), K/V tile 0 into the first; without a key mask or
  // lengths both key-flag buffers hold 1s for good
  if (km == nullptr && lengths == nullptr) km_s[tid] = 1;
  __syncthreads();  // len_s is written
  stage_rows<DMAX>(k_s + TILE * ld, q + (size_t)bh * s_q * d, q0, s_q, d);
  stage_rows<DMAX>(v_s + TILE * ld, dout + (size_t)bh * s_q * d, q0, s_q, d);
  if (n_tiles > 0) stage(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  unsigned qf[KS][4], dof[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int off = TILE * ld + (16 * warp + (lane & 15)) * ld + 16 * ks + (lane >> 4) * 8;
    ldsm_x4(qf[ks], k_s + off);
    ldsm_x4(dof[ks], v_s + off);
  }

  const int r_lo = 16 * warp + g;  // the lane's first row in the tile
  const bool warp_live = q0 + 16 * warp < s_q;  // warp-uniform: some row is before s_q
  // rows g, g + 8: before s_q; lse * log2 e (+inf past s_q, so P = 0
  // there without a validity bit of its own), delta
  bool rok[2];
  float lsel[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r_lo + 8 * h;
    rok[h] = row < s_q;
    lsel[h] = rok[h] ? lse[(size_t)bh * s_q + row] * LOG2E : INFINITY;
    dl[h] = rok[h] ? delta[(size_t)bh * s_q + row] : 0.f;
  }
  float acc[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const bool pair = (s_kv & 1) == 0;
  const float sl2 = scale * LOG2E;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t + 1 < n_tiles) stage(t + 1);
    cp_async_commit();
    const int buf = t & 1, k0 = t * TILE;
    const bf16* kt = k_s + buf * TILE * ld;
    const bf16* vt = v_s + buf * TILE * ld;
    const int* kmt = km_s + buf * TILE;
    const unsigned char* mt = msk_s + buf * TILE * MLD;
    if (!warp_live) continue;  // warp-uniform: every row of the warp is past s_q

#pragma unroll 1
    for (int kc = 0; kc < 4; ++kc) {
      const int ka = 16 * kc;  // the chunk's first key in the tile
      if (ka >= s_kv - k0) break;  // warp-uniform: the rest is past s_kv
      // validity of the lane's 8 pairs, bit 4 j + e: row r_lo + 8 (e / 2),
      // key ka + 8 j + 2 tq + e % 2
      unsigned vis = 0;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c0 = ka + 8 * j + 2 * tq;
        const int2 w = *reinterpret_cast<const int2*>(kmt + c0);
        const bool kv[2] = {c0 < s_kv - k0 && w.x != 0, c0 + 1 < s_kv - k0 && w.y != 0};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r_lo + 8 * (e >> 1), c = c0 + (e & 1);
          bool ok = kv[e & 1];
          if (CAUSAL) ok = ok && (q0 + r + kv_off >= k0 + c);
          if (FMASK) ok = ok && mt[r * MLD + c] != 0;
          vis |= (unsigned)ok << (4 * j + e);
        }
      }
      if (!__any_sync(0xffffffffu, vis)) {
        // no row of the warp sees a key of the chunk: it adds exact zeros to
        // dQ, and its dbias is 0
        if constexpr (BIAS) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (rok[h])
                store_pair(dbb + (size_t)(q0 + r_lo + 8 * h) * s_kv, k0 + ka + 8 * j + 2 * tq,
                           s_kv, pair, 0.f, 0.f);
        }
        continue;
      }
      float bv[2][4];  // the bias of each score, loaded ahead of the products
      if constexpr (BIAS || KBIAS) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = q0 + r_lo + 8 * h, key = k0 + ka + 8 * j + 2 * tq;
            float2 b2 = make_float2(0.f, 0.f);
            if (KBIAS)
              b2 = load_pair(bb, key, s_kv, pair);
            else if (rok[h])
              b2 = load_pair(bb + (size_t)row * s_kv, key, s_kv, pair);
            bv[j][2 * h] = b2.x;
            bv[j][2 * h + 1] = b2.y;
          }
      }
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int off = (ka + (lane & 7) + ((lane >> 4) << 3)) * ld + 16 * ks +
                        ((lane >> 3) & 1) * 8;
        unsigned b[4];
        ldsm_x4(b, kt + off);
        mma_bf16(s[0], qf[ks], b[0], b[1]);
        mma_bf16(s[1], qf[ks], b[2], b[3]);
        ldsm_x4(b, vt + off);
        mma_bf16(dp[0], dof[ks], b[0], b[1]);
        mma_bf16(dp[1], dof[ks], b[2], b[3]);
      }
      // P = 2^(s scale log2 e (+ bias log2 e) - lse log2 e) on visible pairs
      // (an invisible one's exponent is -inf: P = 0 exactly), t = P (dP -
      // delta), dS = t * scale
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float x;
          if constexpr (BIAS || KBIAS)
            x = fmaf(fmaf(s[j][e], scale, bv[j][e]), LOG2E, -lsel[h]);
          else
            x = fmaf(s[j][e], sl2, -lsel[h]);
          const float p = exp2_approx((vis >> (4 * j + e)) & 1u ? x : -INFINITY);
          const float tt = p * (dp[j][e] - dl[h]);  // dL/d(logit), before the scale
          s[j][e] = tt;
          dp[j][e] = tt * scale;
        }
        if constexpr (BIAS) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (rok[h])
              store_pair(dbb + (size_t)(q0 + r_lo + 8 * h) * s_kv, k0 + ka + 8 * j + 2 * tq,
                         s_kv, pair, s[j][2 * h], s[j][2 * h + 1]);
        }
      }
      // dQ += dS.K, dS rounded to bf16 as it becomes the A operand (the
      // chunk's 16 keys are its k16); B from K through ldmatrix.trans
      unsigned da[4];
      c_to_a(da, dp[0], dp[1]);
#pragma unroll
      for (int np = 0; np < KS; ++np) {
        unsigned b[4];
        ldsm_x4_trans(b, kt + (ka + (lane & 15)) * ld + 16 * np + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], da, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], da, b[2], b[3]);
      }
    }
  }

  cp_async_wait_all();  // a tile with no live key tile staged Q and dO only
  if constexpr (BIAS) {
    // key tiles past the loop (causal, lengths): no row of this tile sees
    // them, dbias = 0
    const int kz = n_tiles * TILE;
    for (int r = 16 * warp; r < 16 * warp + 16 && q0 + r < s_q; ++r)
      for (int key = kz + lane; key < s_kv; key += 32)
        dbb[(size_t)(q0 + r) * s_kv + key] = 0.f;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!rok[h]) continue;
    bf16* dqr = dq + ((size_t)bh * s_q + q0 + r_lo + 8 * h) * d;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
      const int col = 8 * n + 2 * tq;
      if (col < d)
        *reinterpret_cast<unsigned*>(dqr + col) = pack_bf16(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

template <int DMAX, bool CAUSAL, bool FMASK, bool BIAS, bool KBIAS>
int launch_dq(const bf16* q, const bf16* k, const bf16* v, const int* key_mask,
              const int* lengths, const unsigned char* mask, const float* bias, const bf16* dout,
              const float* lse,
              const float* delta, bf16* dq, float* dbias, int bh, int heads, int gmode,
              int bgmode, int s_q, int s_kv, int d, float scale, cudaStream_t stream) {
  static size_t configured[64] = {0};
  const size_t smem = (size_t)4 * TILE * (DMAX + 8) * sizeof(bf16) + 2 * TILE * sizeof(int) +
                      (FMASK ? 2 * TILE * MLD : 0);
  cudaError_t err = ensure_smem(
      (const void*)flash_dq_mma_kernel<DMAX, CAUSAL, FMASK, BIAS, KBIAS>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  const bool mask_vec = FMASK && (s_kv & 15) == 0 && ((uintptr_t)mask & 15) == 0;
  const dim3 grid((s_q + TILE - 1) / TILE, bh);
  flash_dq_mma_kernel<DMAX, CAUSAL, FMASK, BIAS, KBIAS><<<grid, NTHREADS, smem, stream>>>(
      q, k, v, key_mask, lengths, mask, bias, dout, lse, delta, dq, dbias, heads, gmode, bgmode,
      s_q, s_kv, d, scale, mask_vec);
  return (int)cudaGetLastError();
}

// CAUSAL from the entries' `causal` int; the head dim picks the instantiation
template <bool FMASK, bool BIAS, bool KBIAS>
int dq_sel(const bf16* q, const bf16* k, const bf16* v, const int* key_mask, const int* lengths,
           const unsigned char* mask, const float* bias, const bf16* dout, const float* lse,
           const float* delta, bf16* dq, float* dbias, int bh, int heads, int s_q, int s_kv,
           int d, int gmode, int bgmode, int causal, float scale, void* stream) {
  if (bad_shape(bh, heads, s_q, s_kv, d, gmode, bgmode)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define HETU_DQ_LAUNCH(DM, C)                                                               \
  launch_dq<DM, C, FMASK, BIAS, KBIAS>(q, k, v, key_mask, lengths, mask, bias, dout, lse,    \
                                       delta, dq, dbias, bh, heads, gmode, bgmode, s_q, s_kv, \
                                       d, scale, st)
  if (d <= 64) return causal ? HETU_DQ_LAUNCH(64, true) : HETU_DQ_LAUNCH(64, false);
  return causal ? HETU_DQ_LAUNCH(128, true) : HETU_DQ_LAUNCH(128, false);
#undef HETU_DQ_LAUNCH
}

}  // namespace

// The bf16 twins of flash_attention_bwd.cuh's dQ entries, with the same
// arguments: each launches on `stream` and returns cudaGetLastError() after
// the launch (0 = launched).  q/dout/dq (bh, s_q, d), k/v (bh, s_kv, d):
// contiguous bfloat16, d a multiple of 8 (at most 128), 16-byte aligned;
// key_mask (bh / heads, s_kv) int32 or null; lengths (bh / heads) int32 or
// null; lse and delta (bh, s_q) float32; a bias and dbias float32.

// dense (key_mask and lengths null), key_mask and/or lengths
extern "C" int hetu_flash_bwd_dq_bf16(const bf16* q, const bf16* k, const bf16* v,
                                      const int* key_mask, const int* lengths, const bf16* dout,
                                      const float* lse, const float* delta, bf16* dq, int bh,
                                      int heads, int s_q, int s_kv, int d, float scale,
                                      void* stream) {
  return dq_sel<false, false, false>(q, k, v, key_mask, lengths, nullptr, nullptr, dout, lse,
                                     delta, dq, nullptr, bh, heads, s_q, s_kv, d, 0, 0, 0, scale,
                                     stream);
}

// causal (bottom-right aligned), optionally with a key_mask and lengths
extern "C" int hetu_flash_bwd_dq_causal_bf16(const bf16* q, const bf16* k, const bf16* v,
                                             const int* key_mask, const int* lengths,
                                             const bf16* dout, const float* lse,
                                             const float* delta, bf16* dq, int bh, int heads,
                                             int s_q, int s_kv, int d, float scale,
                                             void* stream) {
  return dq_sel<false, false, false>(q, k, v, key_mask, lengths, nullptr, nullptr, dout, lse,
                                     delta, dq, nullptr, bh, heads, s_q, s_kv, d, 0, 0, 1, scale,
                                     stream);
}

// additive bias (G, s_q, s_kv) or, strip != 0, (G, 1, s_kv) float32 of group
// mode gmode; causal != 0 adds the causal rule.  With a dense bias, dbias
// (bh, s_q, s_kv) float32, the pre-scale dS (null with a strip).
extern "C" int hetu_flash_bwd_dq_bias_bf16(const bf16* q, const bf16* k, const bf16* v,
                                           const int* key_mask, const int* lengths,
                                           const float* bias, const bf16* dout,
                                           const float* lse, const float* delta, bf16* dq,
                                           float* dbias, int bh, int heads, int s_q, int s_kv,
                                           int d, int gmode, int strip, int causal, float scale,
                                           void* stream) {
  if (bias == nullptr || (strip != 0) != (dbias == nullptr)) return (int)cudaErrorInvalidValue;
  return strip ? dq_sel<false, false, true>(q, k, v, key_mask, lengths, nullptr, bias, dout, lse,
                                            delta, dq, nullptr, bh, heads, s_q, s_kv, d, 0, gmode,
                                            causal, scale, stream)
               : dq_sel<false, true, false>(q, k, v, key_mask, lengths, nullptr, bias, dout, lse,
                                            delta, dq, dbias, bh, heads, s_q, s_kv, d, 0, gmode,
                                            causal, scale, stream);
}

// full mask (G, s_q, s_kv) uint8 of group mode gmode, composed with key_mask,
// lengths and, causal != 0, the causal rule; optionally with a bias of its
// own group mode bgmode (null: none; strip != 0: the strip), with dbias for a
// dense one
extern "C" int hetu_flash_bwd_dq_mask_bf16(const bf16* q, const bf16* k, const bf16* v,
                                           const int* key_mask, const int* lengths,
                                           const unsigned char* mask, const float* bias,
                                           const bf16* dout, const float* lse,
                                           const float* delta, bf16* dq, float* dbias, int bh,
                                           int heads, int s_q, int s_kv, int d, int gmode,
                                           int bgmode, int strip, int causal, float scale,
                                           void* stream) {
  const bool dense = bias != nullptr && !strip;
  if (mask == nullptr || dense != (dbias != nullptr)) return (int)cudaErrorInvalidValue;
  if (bias == nullptr)
    return dq_sel<true, false, false>(q, k, v, key_mask, lengths, mask, nullptr, dout, lse,
                                      delta, dq, nullptr, bh, heads, s_q, s_kv, d, gmode, 0,
                                      causal, scale, stream);
  return strip ? dq_sel<true, false, true>(q, k, v, key_mask, lengths, mask, bias, dout, lse,
                                           delta, dq, nullptr, bh, heads, s_q, s_kv, d, gmode,
                                           bgmode, causal, scale, stream)
               : dq_sel<true, true, false>(q, k, v, key_mask, lengths, mask, bias, dout, lse,
                                           delta, dq, dbias, bh, heads, s_q, s_kv, d, gmode,
                                           bgmode, causal, scale, stream);
}
