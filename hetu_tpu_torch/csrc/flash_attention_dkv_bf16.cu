// Flash attention dK/dV for Hopper (sm_90a), bfloat16 on the tensor cores:
// the `_bf16` C entries hetu_flash_bwd_dkv[_causal,_bias,_mask]_bf16, the TPU
// kernel's bf16 instantiation of
// hetu_tpu/ops/pallas/flash_attention.py::_dkv_kernel (launched by
// _flash_bwd).  q, k, v, dO, dK and dV are bf16; lse, delta, the bias and
// dkbias float32.  The specializations and their rules are the float32
// kernel's (flash_attention_bwd.cuh): P = exp(s - lse) on valid pairs, 0
// elsewhere (a select, so a row with lse = -1e30 never forms exp(+huge)),
// t = P * (dP - delta), dV = P^T.dO and dK = (t * scale)^T.Q; with a
// key-bias strip dkbias = the column sums of t.  The bf16 dQ kernel is
// flash_attention_dq_bf16.cu.
//
// What bounds it: at the training shapes the four products, 8 * D flops per
// visible (row, key) pair: the tensor cores, not the memory.  Design
// (flash_mma.cuh): one CTA of 4 warps per (b*h, 64 keys), 16 keys a warp; K
// and V of the CTA's keys are staged once and held in registers as A
// fragments.  The CTA walks the query tiles (causal: from the first tile
// that sees its first key), each tile of Q and dO double-buffered in shared
// memory with cp.async beside its float32 lse and delta and, with FMASK, its
// uint8 mask tile.  Each warp takes a tile in four chunks of 16 queries:
// S^T = K.Q^T and dP^T = V.dO^T on mma.sync (B from Q and dO through
// ldmatrix), then P^T and t in registers at fragment coordinates (keys g and
// g + 8 of the warp, queries 2t, 2t + 1 of each n8 tile), then dV += P^T.dO
// and dK += (t * scale)^T.Q with the A operands straight from registers,
// rounded to bf16 where the TPU kernel rounds (p.astype(do.dtype),
// ds.astype(q.dtype): flash_attention.py:403, :418), B from dO and Q through
// ldmatrix.trans.  A chunk none of whose queries sees any of the warp's keys
// (causal) is skipped: it would add exact zeros.  With `lengths` (a
// nullable pointer read once a CTA) a CTA whose keys start at or past the
// length walks no query tile and writes dK = dV = 0 (dkbias 0), and the
// keys past it in the last tile take a false key flag: every padded key
// gets exact zeros.  The dense bias and the
// mask are read transposed at fragment coordinates: the bias from device
// memory (8 consecutive keys of one query row a quad-column of lanes: one
// 32-byte sector), the mask from its staged tile (rows of MLD = 80 bytes, so
// the 4 query rows a load touches start 8 banks apart).  dkbias sums the
// unrounded t per key in registers and reduces over the quad at the end.
// Each CTA owns its keys: no atomics, and dK, dV and dkbias are the same bit
// for bit from run to run.
//
// Not yet: wgmma and TMA, one fused kernel for dQ and dK/dV, skipping tiles
// a data mask hides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_mma.cuh"

namespace {

using namespace hetu_mma;

// DMAX, FMASK, BIAS / KBIAS, `lengths`, `mask`, `bias` and mask_vec as in
// the forward (flash_attention_bf16.cu); `dkbias` (BH, S_kv) is written with
// KBIAS
template <int DMAX, bool CAUSAL, bool FMASK, bool BIAS, bool KBIAS>
__global__ void __launch_bounds__(NTHREADS)
flash_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ key_mask,
                     const int* __restrict__ lengths, const unsigned char* __restrict__ mask,
                     const float* __restrict__ bias, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, float* __restrict__ dkbias, int heads, int gmode,
                     int bgmode, int s_q, int s_kv, int d, float scale, bool mask_vec) {
  static_assert(!(BIAS && KBIAS), "a dense bias or a key-bias strip, not both");
  constexpr int KS = DMAX / 16;  // k16 steps of K.Q^T, d16 column pairs of dK and dV
  constexpr int ld = DMAX + 8;   // row stride of a staged tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // 2 buffers of TILE x ld; buffer 1 holds K first
  bf16* do_s = q_s + 2 * TILE * ld;           // 2 buffers; buffer 1 holds V first
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * TILE * ld);  // 2 x TILE
  float* dl_s = lse_s + 2 * TILE;                                 // 2 x TILE
  unsigned char* msk_s = reinterpret_cast<unsigned char*>(dl_s + 2 * TILE);  // 2 x TILE x MLD

  const int bh = blockIdx.y, k0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const bf16* qb = q + (size_t)bh * s_q * d;
  const bf16* dob = dout + (size_t)bh * s_q * d;
  const float* lseb = lse + (size_t)bh * s_q;
  const float* dlb = delta + (size_t)bh * s_q;
  const int* km = key_mask ? key_mask + (size_t)(bh / heads) * s_kv : nullptr;
  const unsigned char* mb = nullptr;
  if (FMASK) mb = mask + (size_t)group_row(gmode, bh, heads) * s_q * s_kv;
  const float* bb = nullptr;
  if (BIAS || KBIAS)
    bb = bias + (size_t)group_row(bgmode, bh, heads) * (BIAS ? (size_t)s_q * s_kv : s_kv);
  // causal: the first query row that sees key k0 is k0 - kv_off; start at
  // its tile (past s_q: no iteration, dK = dV = 0); keys [0, len) may be
  // visible, and a CTA whose keys start at or past len walks no query tile
  const int len = lengths ? max(0, min(s_kv, lengths[bh / heads])) : s_kv;
  const int kv_off = s_kv - s_q;
  const int q_begin = CAUSAL ? (max(0, k0 - kv_off) / TILE) * TILE : 0;
  const int n_tiles = q_begin < s_q && k0 < len ? (s_q - q_begin + TILE - 1) / TILE : 0;

  auto stage = [&](int t) {
    const int buf = t & 1, q0 = q_begin + t * TILE;
    stage_rows<DMAX>(q_s + buf * TILE * ld, qb, q0, s_q, d);
    stage_rows<DMAX>(do_s + buf * TILE * ld, dob, q0, s_q, d);
    const int r = tid & (TILE - 1);
    const bool in = q0 + r < s_q;
    if (tid < TILE)
      cp_async4(lse_s + buf * TILE + r, in ? lseb + q0 + r : lseb, in);
    else
      cp_async4(dl_s + buf * TILE + r, in ? dlb + q0 + r : dlb, in);
    if constexpr (FMASK) stage_mask(msk_s + buf * TILE * MLD, mb, q0, k0, s_q, s_kv, mask_vec);
  };

  // K and V into the second buffers (tile 1 overwrites them once they are
  // in registers), query tile 0 into the first
  stage_rows<DMAX>(q_s + TILE * ld, k + (size_t)bh * s_kv * d, k0, s_kv, d);
  stage_rows<DMAX>(do_s + TILE * ld, v + (size_t)bh * s_kv * d, k0, s_kv, d);
  if (n_tiles > 0) stage(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  unsigned kf[KS][4], vf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int off = TILE * ld + (16 * warp + (lane & 15)) * ld + 16 * ks + (lane >> 4) * 8;
    ldsm_x4(kf[ks], q_s + off);
    ldsm_x4(vf[ks], do_s + off);
  }

  const int kr_lo = 16 * warp + g;  // the lane's first key row in the tile
  bool kok[2];
  float kbv[2], dkb[2];  // KBIAS: the strip at the lane's two keys, their dkbias sums
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + kr_lo + 8 * h;
    kok[h] = key < len && (km == nullptr || km[key] != 0);
    kbv[h] = (KBIAS && key < s_kv) ? bb[key] : 0.f;
    dkb[h] = 0.f;
  }
  float dka[2 * KS][4], dva[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t + 1 < n_tiles) stage(t + 1);
    cp_async_commit();
    const int buf = t & 1, q0 = q_begin + t * TILE;
    const bf16* qt = q_s + buf * TILE * ld;
    const bf16* dot = do_s + buf * TILE * ld;
    const float* lse_t = lse_s + buf * TILE;
    const float* dl_t = dl_s + buf * TILE;
    const unsigned char* mt = msk_s + buf * TILE * MLD;

#pragma unroll 1
    for (int qc = 0; qc < 4; ++qc) {
      const int qa = q0 + 16 * qc;  // the chunk's first query
      if (qa >= s_q) break;         // warp-uniform: the rest is past s_q
      // causal, warp-uniform: the chunk's last query sees none of the
      // warp's keys
      if (CAUSAL && qa + 15 + kv_off < k0 + 16 * warp) continue;
      float bv[2][4];  // BIAS: [query n8 tile][fragment element]
      if constexpr (BIAS) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int query = qa + 8 * j + 2 * tq + (e & 1), key = k0 + kr_lo + 8 * (e >> 1);
            bv[j][e] = (query < s_q && key < s_kv) ? __ldg(bb + (size_t)query * s_kv + key) : 0.f;
          }
      }
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int off = (16 * qc + (lane & 7) + ((lane >> 4) << 3)) * ld + 16 * ks +
                        ((lane >> 3) & 1) * 8;
        unsigned b[4];
        ldsm_x4(b, qt + off);
        mma_bf16(st[0], kf[ks], b[0], b[1]);
        mma_bf16(st[1], kf[ks], b[2], b[3]);
        ldsm_x4(b, dot + off);
        mma_bf16(dpt[0], vf[ks], b[0], b[1]);
        mma_bf16(dpt[1], vf[ks], b[2], b[3]);
      }
      // P^T and t * scale, [query n8 tile][fragment element]: key row
      // kr_lo + 8 (e / 2), query column 16 qc + 8 j + 2 tq + e % 2
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, col = 16 * qc + 8 * j + 2 * tq + (e & 1);
          const int key_row = kr_lo + 8 * h;
          bool vis = kok[h] && q0 + col < s_q;
          if (CAUSAL) vis = vis && (q0 + col + kv_off >= k0 + key_row);
          if (FMASK) vis = vis && mt[col * MLD + key_row] != 0;
          float x = st[j][e] * scale - lse_t[col];
          if constexpr (BIAS) x += bv[j][e];
          if constexpr (KBIAS) x += kbv[h];
          const float p = vis ? exp2_approx(x * LOG2E) : 0.f;
          const float tt = p * (dpt[j][e] - dl_t[col]);  // dL/d(logit), before the scale
          if constexpr (KBIAS) dkb[h] += tt;
          st[j][e] = p;
          dpt[j][e] = tt * scale;
        }
      unsigned pa[4], da[4];  // the chunk's 16 queries as the k16 of dV and dK
      c_to_a(pa, st[0], st[1]);
      c_to_a(da, dpt[0], dpt[1]);
#pragma unroll
      for (int np = 0; np < KS; ++np) {
        const int off = (16 * qc + (lane & 15)) * ld + 16 * np + (lane >> 4) * 8;
        unsigned b[4];
        ldsm_x4_trans(b, dot + off);
        mma_bf16(dva[2 * np], pa, b[0], b[1]);
        mma_bf16(dva[2 * np + 1], pa, b[2], b[3]);
        ldsm_x4_trans(b, qt + off);
        mma_bf16(dka[2 * np], da, b[0], b[1]);
        mma_bf16(dka[2 * np + 1], da, b[2], b[3]);
      }
    }
  }

  cp_async_wait_all();  // a key tile no query tile sees staged K and V only
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + kr_lo + 8 * h;
    if constexpr (KBIAS) {
      const float sum = quad_sum(dkb[h]);  // over the 4 lanes of key row kr_lo + 8h
      if (tq == 0 && key < s_kv) dkbias[(size_t)bh * s_kv + key] = sum;
    }
    if (key >= s_kv) continue;
    bf16* dkr = dk + ((size_t)bh * s_kv + key) * d;
    bf16* dvr = dv + ((size_t)bh * s_kv + key) * d;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
      const int col = 8 * n + 2 * tq;
      if (col < d) {
        *reinterpret_cast<unsigned*>(dkr + col) = pack_bf16(dka[n][2 * h], dka[n][2 * h + 1]);
        *reinterpret_cast<unsigned*>(dvr + col) = pack_bf16(dva[n][2 * h], dva[n][2 * h + 1]);
      }
    }
  }
}

template <int DMAX, bool CAUSAL, bool FMASK, bool BIAS, bool KBIAS>
int launch_dkv(const bf16* q, const bf16* k, const bf16* v, const int* key_mask,
               const int* lengths, const unsigned char* mask, const float* bias, const bf16* dout,
               const float* lse,
               const float* delta, bf16* dk, bf16* dv, float* dkbias, int bh, int heads,
               int gmode, int bgmode, int s_q, int s_kv, int d, float scale,
               cudaStream_t stream) {
  static size_t configured[64] = {0};
  const size_t smem = (size_t)4 * TILE * (DMAX + 8) * sizeof(bf16) + 4 * TILE * sizeof(float) +
                      (FMASK ? 2 * TILE * MLD : 0);
  cudaError_t err = ensure_smem(
      (const void*)flash_dkv_mma_kernel<DMAX, CAUSAL, FMASK, BIAS, KBIAS>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  const bool mask_vec = FMASK && (s_kv & 15) == 0 && ((uintptr_t)mask & 15) == 0;
  const dim3 grid((s_kv + TILE - 1) / TILE, bh);
  flash_dkv_mma_kernel<DMAX, CAUSAL, FMASK, BIAS, KBIAS><<<grid, NTHREADS, smem, stream>>>(
      q, k, v, key_mask, lengths, mask, bias, dout, lse, delta, dk, dv, dkbias, heads, gmode,
      bgmode, s_q, s_kv, d, scale, mask_vec);
  return (int)cudaGetLastError();
}

// CAUSAL from the entries' `causal` int; the head dim picks the instantiation
template <bool FMASK, bool BIAS, bool KBIAS>
int dkv_sel(const bf16* q, const bf16* k, const bf16* v, const int* key_mask,
            const int* lengths, const unsigned char* mask, const float* bias, const bf16* dout,
            const float* lse,
            const float* delta, bf16* dk, bf16* dv, float* dkbias, int bh, int heads, int s_q,
            int s_kv, int d, int gmode, int bgmode, int causal, float scale, void* stream) {
  if (bad_shape(bh, heads, s_q, s_kv, d, gmode, bgmode)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define HETU_DKV_LAUNCH(DM, C)                                                                  \
  launch_dkv<DM, C, FMASK, BIAS, KBIAS>(q, k, v, key_mask, lengths, mask, bias, dout, lse,    \
                                        delta, dk, dv, dkbias, bh, heads, gmode, bgmode, s_q,  \
                                        s_kv, d, scale, st)
  if (d <= 64) return causal ? HETU_DKV_LAUNCH(64, true) : HETU_DKV_LAUNCH(64, false);
  return causal ? HETU_DKV_LAUNCH(128, true) : HETU_DKV_LAUNCH(128, false);
#undef HETU_DKV_LAUNCH
}

}  // namespace

// The bf16 twins of flash_attention_bwd.cuh's dK/dV entries, with the same
// arguments: each launches on `stream` and returns cudaGetLastError() after
// the launch (0 = launched).  q/dout (bh, s_q, d), k/v/dk/dv (bh, s_kv, d):
// contiguous bfloat16, d a multiple of 8 (at most 128), 16-byte aligned;
// key_mask (bh / heads, s_kv) int32 or null; lengths (bh / heads) int32 or
// null; lse and delta (bh, s_q) float32; a bias and dkbias float32.

// dense (key_mask and lengths null), key_mask and/or lengths
extern "C" int hetu_flash_bwd_dkv_bf16(const bf16* q, const bf16* k, const bf16* v,
                                       const int* key_mask, const int* lengths, const bf16* dout,
                                       const float* lse, const float* delta, bf16* dk, bf16* dv,
                                       int bh, int heads, int s_q, int s_kv, int d, float scale,
                                       void* stream) {
  return dkv_sel<false, false, false>(q, k, v, key_mask, lengths, nullptr, nullptr, dout, lse,
                                      delta, dk, dv, nullptr, bh, heads, s_q, s_kv, d, 0, 0, 0,
                                      scale, stream);
}

// causal (bottom-right aligned), optionally with a key_mask and lengths
extern "C" int hetu_flash_bwd_dkv_causal_bf16(const bf16* q, const bf16* k, const bf16* v,
                                              const int* key_mask, const int* lengths,
                                              const bf16* dout, const float* lse,
                                              const float* delta, bf16* dk, bf16* dv, int bh,
                                              int heads, int s_q, int s_kv, int d, float scale,
                                              void* stream) {
  return dkv_sel<false, false, false>(q, k, v, key_mask, lengths, nullptr, nullptr, dout, lse,
                                      delta, dk, dv, nullptr, bh, heads, s_q, s_kv, d, 0, 0, 1,
                                      scale, stream);
}

// additive bias (G, s_q, s_kv) or, strip != 0, (G, 1, s_kv) float32 of group
// mode gmode; causal != 0 adds the causal rule.  With a strip, dkbias (bh, 1,
// s_kv) float32 (null with a dense bias).
extern "C" int hetu_flash_bwd_dkv_bias_bf16(const bf16* q, const bf16* k, const bf16* v,
                                            const int* key_mask, const int* lengths,
                                            const float* bias, const bf16* dout,
                                            const float* lse, const float* delta, bf16* dk,
                                            bf16* dv, float* dkbias, int bh, int heads, int s_q,
                                            int s_kv, int d, int gmode, int strip, int causal,
                                            float scale, void* stream) {
  if (bias == nullptr || (strip != 0) != (dkbias != nullptr)) return (int)cudaErrorInvalidValue;
  return strip ? dkv_sel<false, false, true>(q, k, v, key_mask, lengths, nullptr, bias, dout, lse,
                                             delta, dk, dv, dkbias, bh, heads, s_q, s_kv, d, 0,
                                             gmode, causal, scale, stream)
               : dkv_sel<false, true, false>(q, k, v, key_mask, lengths, nullptr, bias, dout, lse,
                                             delta, dk, dv, nullptr, bh, heads, s_q, s_kv, d, 0,
                                             gmode, causal, scale, stream);
}

// full mask (G, s_q, s_kv) uint8 of group mode gmode, composed with key_mask,
// lengths and, causal != 0, the causal rule; optionally with a bias of its
// own group mode bgmode (null: none; strip != 0: the strip, with dkbias)
extern "C" int hetu_flash_bwd_dkv_mask_bf16(const bf16* q, const bf16* k, const bf16* v,
                                            const int* key_mask, const int* lengths,
                                            const unsigned char* mask, const float* bias,
                                            const bf16* dout, const float* lse,
                                            const float* delta, bf16* dk, bf16* dv,
                                            float* dkbias, int bh, int heads, int s_q, int s_kv,
                                            int d, int gmode, int bgmode, int strip, int causal,
                                            float scale, void* stream) {
  const bool strip_bias = bias != nullptr && strip;
  if (mask == nullptr || strip_bias != (dkbias != nullptr)) return (int)cudaErrorInvalidValue;
  if (bias == nullptr)
    return dkv_sel<true, false, false>(q, k, v, key_mask, lengths, mask, nullptr, dout, lse,
                                       delta, dk, dv, nullptr, bh, heads, s_q, s_kv, d, gmode, 0,
                                       causal, scale, stream);
  return strip ? dkv_sel<true, false, true>(q, k, v, key_mask, lengths, mask, bias, dout, lse,
                                            delta, dk, dv, dkbias, bh, heads, s_q, s_kv, d, gmode,
                                            bgmode, causal, scale, stream)
               : dkv_sel<true, true, false>(q, k, v, key_mask, lengths, mask, bias, dout, lse,
                                            delta, dk, dv, nullptr, bh, heads, s_q, s_kv, d,
                                            gmode, bgmode, causal, scale, stream);
}
