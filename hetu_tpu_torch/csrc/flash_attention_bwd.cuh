// Flash attention backward for Hopper (sm_90a), float32, dense, `key_mask`,
// `lengths`, causal, full-mask and additive-bias specializations: two
// kernels that replace hetu_tpu/ops/pallas/flash_attention.py::_dq_kernel and
// ::_dkv_kernel (launched by _flash_bwd).
//
// Both recompute the probabilities from the forward's row log-sum-exp instead
// of storing them: P = exp(s - lse) on valid pairs (0 elsewhere, a select, so
// an all-masked row with lse = -1e30 never forms exp(+huge)), dP = dO.V^T and
// dS = P * (dP - delta) * scale with delta = rowsum(dO * O), computed by the
// caller.
//
// 1. flash_bwd_dq_kernel: one CTA per (b*h, 64 query rows); it walks key
//    tiles and accumulates dQ += dS.K in registers.
// 2. flash_bwd_dkv_kernel: one CTA per (b*h, 64 keys); it walks query tiles
//    and accumulates dV += P^T.dO and dK += dS^T.Q in registers.  It forms
//    the transposed tiles directly (S^T = K.Q^T, dP^T = V.dO^T), so each
//    thread owns whole key rows of dK and dV.
// Neither uses atomics: dQ owns its query rows, dK/dV its keys, and each sums
// in a fixed order, so every output is the same bit for bit from run to run.
//
// What bounds them on this card: the products' operations.  Per visible
// (row, key) pair dQ does 3 products of D multiply-adds (S, dP, dS.K) and
// dK/dV 4 (S^T, dP^T, P^T.dO, dS^T.Q), about 16 * S * D bytes a (b*h) against
// 6 and 8 * S_q * S_kv * D flops, so at S = 512, D = 64 they need ~100
// operations a byte, above the card's float32 balance (67 TFLOP/s over 3.35
// TB/s = 20).  They run in full float32 on the CUDA cores (no TF32: the
// float32 numbers are the contract), so each is a register-tiled SIMT
// product, and three things decide its speed: how many tiles it walks, how
// many shared-memory reads and instructions each FMA costs, and whether the
// copies hide behind the products.
//
// Which tiles: each CTA first lists, in order, the tiles that can hold a
// visible pair (list_tiles in flash_tile.cuh, the forward's list) and walks
// only those; no copy and no product for the others.
//   dQ, for its query tile, lists the key tiles below the causal end and
//   below ceil(lengths[b] / 64) whose byte in the full mask's tile map is
//   nonzero (tile_maps in ops/kernels/flash_attention.py) and that, with a
//   key mask, hold an unmasked key before the length: the forward's list.
//   dK/dV, for its key tile, reads the same map by column and lists the query
//   tiles from the first that sees its first key under causal; a key tile
//   with no unmasked key before the length (or, causal, that no row sees)
//   lists none and writes dK = dV = 0 (and dkbias = 0).
// The two kernels walk the same (query tile, key tile) pairs as the float32
// forward.  A null map walks every tile the other rules leave.  At
// Longformer's S = 4096 that is 16,176 of 98,304 pairs instead of all.
// A walked tile still masks element by element: the key flags (key mask and
// length folded in: a key at or past the length reads 0), the causal test,
// the mask tile's bytes.
//
// Long walks: the tiles with the most work start first.  Under causal the
// last query tiles of dQ and the first key tiles of dK/dV walk the most, so
// dQ's grid runs its query tiles last to first and dK/dV's its key tiles
// first to last.  Without causal both run tile 0 first: a data mask's global
// tokens (Longformer's) sit at the start, so dQ's query tile 0 and dK/dV's
// key tile 0 walk every tile (64 at S = 4096 against ~10 for the others) and
// start in the first wave instead of the last.  The grids are (b*h, tiles),
// b*h fastest, so the b*h CTAs of the heaviest tile go first.
//
// Per tile: 128-thread CTAs (16 x 8, flash_tile.cuh), an 8 x 4 register tile
// for S and dP and the same 8 rows of the accumulators: 8 rows x 4 FMAs for
// each float4 of each operand a thread reads from shared memory.  dQ owns
// query rows ty + 8i; dK/dV owns keys 8ty + i, so one 8-byte read gives a
// thread its 8 keys' mask bytes and two float4 reads its 8 keys' bias.  P and
// dS go through shared memory only in the rows of the warp that wrote them.
// The copies run under the products in cp.async groups:
//   dQ, walked key tile t (K double-buffered):
//     wait K(t); barrier; copy K(t + 1)
//     S = Q K(t)^T
//     wait V(t) and its key flags, strip values and mask tile; barrier
//     dP = dO V(t)^T; wait this warp's bias rows (a dense bias)
//     P, dS into this warp's rows of the dS tile (the bias read there first),
//       t = P (dP - delta) into dbias
//     barrier; copy V(t + 1), its flags, strip and mask tile
//     dQ += dS K(t); copy this warp's bias rows of tile t + 1
//   dK/dV, walked query tile t (Q double-buffered):
//     wait Q(t); barrier; copy the bias tile (a dense bias), Q(t + 1)
//     S^T = K Q(t)^T
//     wait dO(t), its lse, delta and mask tile; barrier
//     dP^T = V dO(t)^T (a dense bias: wait for its tile; barrier; read it;
//       barrier)
//     P^T, dS^T in registers; P^T into this warp's rows; dV += P^T dO(t)
//     barrier; copy dO(t + 1), its lse, delta and mask tile
//     dS^T into this warp's rows; dK += dS^T Q(t)
// so each kernel has three barriers a tile (five with a dense bias in
// dK/dV), and every copy has at least one product to hide behind but the
// first tile's Q and K (dO and V come in a second group, under the first
// product).  Mask tiles move in 16-byte chunks (byte loads at ragged or
// unaligned edges), bias tiles in 16-byte chunks through shared memory.  At
// D = 64 each kernel takes 102-108 KB of shared memory and up to 254
// registers a thread: two CTAs, 8 warps, an SM.  Rows past S_q read lse = +inf (so P = 0), keys past S_kv a 0 flag.
//
// Causal (template CAUSAL; key c is visible to query row r iff
// r + (S_kv - S_q) >= c, composed with every other rule): a query row that
// sees no key (S_q > S_kv, lse = -1e30) contributes exact zeros.
//
// Additive bias (templates BIAS, KBIAS, as in the forward): both kernels
// recompute the biased scores s * scale + bias.  With a dense bias (G, S_q,
// S_kv) the dQ kernel also writes t = P * (dP - delta), the pre-scale dS, as
// dbias (BH, S_q, S_kv) float32, the TPU kernel's per-block dbias tiles; the
// caller sums it over the bias's broadcast group.  It writes exact zeros
// into every key tile of its rows that it does not walk (the TPU kernel's
// pruned-block zero tiles): such a tile holds no visible pair, so every entry
// of dbias is defined and 0 on every pair no row sees.  With a key-bias strip
// (G, 1, S_kv) the dK/dV kernel sums t over the query rows into dkbias (BH,
// 1, S_kv): each thread keeps the partial sums of its 8 keys in registers
// across the query tiles, and the 16 threads of a key row combine them once
// at the end.  dbias is the one output of S_q * S_kv floats a (b*h): at the
// T5 encoder shape (B*H = 256, S = 512) it adds 268 MB of writes to dQ.
//
// Lengths (a nullable `lengths` pointer, (BH / heads) int32, read once a CTA
// and clamped to [0, S_kv]; null is S_kv): keys at or past lengths[b] are
// invisible, composed with every other rule; every padded key gets exact
// zeros in dK, dV and dkbias, and dbias is 0 past the length.
//
// Full mask (template FMASK; Longformer's sliding window, XLNet's permutation
// masks): a uint8 mask stored unbroadcast as (G, S_q, S_kv) of group mode
// `gmode`, composed with key_mask, causal and either bias, the bias through
// its own group mode `bgmode`, and its tile map (G, ceil(S_q / 64),
// ceil(S_kv / 64)) or null.  A row the mask hides entirely (lse = -1e30; the
// first token of each permutation in XLNet's query stream) gives dQ = 0 and
// a dbias row of exact zeros and adds nothing to dK, dV or dkbias.
//
// float32 only (template T = float): the bf16 entries run the tensor-core
// kernels of flash_attention_dq_bf16.cu and flash_attention_dkv_bf16.cu.
// The kernels and the C entries' bodies live in this header; the entries
// are compiled in flash_attention_bwd.cu.
//
// Not yet: tensor cores (TF32 would change the float32 numbers), one fused
// kernel for dQ and dK/dV, the group sum of dbias inside the kernel, and a
// schedule that balances walks of unequal length (a persistent grid) where a
// data mask's heavy tiles are not tile 0.

#pragma once

#include <cuda_runtime.h>

#include "flash_tile.cuh"

namespace {

using namespace hetu_flash;

constexpr int R = 8;          // score-tile rows a thread owns
constexpr int MLD = FT + 16;  // byte row stride of the dK/dV kernel's mask tile

// Shared memory of the dQ kernel: Q, dO, K (2 buffers), V, the dS tile, the
// key flags, the strip values (KBIAS), 4 warp counts, the walk list, the mask
// tile (FMASK).  The kernel lays it out in this order.
inline size_t dq_smem(int d, int n_kt, bool fmask, bool kbias) {
  const int ld = ((d + 15) & ~15) + 4;
  return (size_t)(5 * FT * ld + FT * FPLD + FT + (kbias ? FT : 0) + 4 + ((n_kt + 3) & ~3)) *
             sizeof(float) +
         (fmask ? FT * FT : 0);
}

// Shared memory of the dK/dV kernel: K, V, Q (2 buffers), dO, the P^T / dS^T
// tile, lse and delta of a query tile, 4 warp counts, the walk list, the
// mask tile (FMASK).
inline size_t dkv_smem(int d, int n_qt, bool fmask) {
  const int ld = ((d + 15) & ~15) + 4;
  return (size_t)(5 * FT * ld + FT * FPLD + 2 * FT + 4 + ((n_qt + 3) & ~3)) * sizeof(float) +
         (fmask ? FT * MLD : 0);
}

// T: the element type of q, k, v, dO and the gradients (float); G: float4
// output column groups per thread (D <= 64 G).  FMASK: `mask` points to the
// (G', S_q, S_kv) uint8 mask of group mode `gmode` and `mask_tiles` to its
// tile map or is null; BIAS / KBIAS: at most one, `bias` then points to the
// (G', S_q, S_kv) bias or the (G', S_kv) strip of group mode `bgmode`;
// `dbias` (BH, S_q, S_kv) is written with BIAS.
template <typename T, int G, bool CAUSAL, bool FMASK, bool BIAS, bool KBIAS>
__global__ void __launch_bounds__(FTHREADS, G == 1 ? 2 : 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ key_mask,
                    const int* __restrict__ lengths, const unsigned char* __restrict__ mask,
                    const unsigned char* __restrict__ mask_tiles,
                    const float* __restrict__ bias, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, float* __restrict__ dbias, int heads, int gmode,
                    int bgmode, int s_q, int s_kv, int d, float scale) {
  static_assert(!(BIAS && KBIAS), "a dense bias or a key-bias strip, not both");
  extern __shared__ __align__(16) float smem[];
  const int d16 = (d + 15) & ~15, ld = d16 + 4, d4 = d >> 2;
  const int n_qt = (s_q + FT - 1) / FT, n_kt = (s_kv + FT - 1) / FT;
  float* q_s = smem;                 // FT x ld
  float* do_s = q_s + FT * ld;       // FT x ld
  float* k_s = do_s + FT * ld;       // 2 x FT x ld: K(t) in buffer t % 2
  float* v_s = k_s + 2 * FT * ld;    // FT x ld
  float* ds_s = v_s + FT * ld;       // FT x FPLD: dS (a dense bias first)
  int* ok_s = reinterpret_cast<int*>(ds_s + FT * FPLD);          // FT key flags
  float* kb_s = reinterpret_cast<float*>(ok_s + FT);             // FT strip values
  int* wcnt = reinterpret_cast<int*>(kb_s + (KBIAS ? FT : 0));   // 4 warp counts
  int* walk = wcnt + 4;                                          // walked key tiles
  unsigned char* msk_s = reinterpret_cast<unsigned char*>(walk + ((n_kt + 3) & ~3));

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x;
  const int qt = CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // the longest walks first
  const int q0 = qt * FT;
  const T* kb = k + (size_t)bh * s_kv * d;
  const T* vb = v + (size_t)bh * s_kv * d;
  const int* km = key_mask ? key_mask + (size_t)(bh / heads) * s_kv : nullptr;
  // keys [0, len) may be visible
  const int len = lengths ? max(0, min(s_kv, lengths[bh / heads])) : s_kv;
  const unsigned char* mb = nullptr;
  const unsigned char* mt = nullptr;
  if (FMASK) {
    const int g = group_row(gmode, bh, heads);
    mb = mask + (size_t)g * s_q * s_kv;
    if (mask_tiles) mt = mask_tiles + ((size_t)g * n_qt + qt) * n_kt;
  }
  const float* bb = nullptr;
  if (BIAS || KBIAS)
    bb = bias + (size_t)group_row(bgmode, bh, heads) * (BIAS ? (size_t)s_q * s_kv : s_kv);
  float* dbb = BIAS ? dbias + (size_t)bh * s_q * s_kv : nullptr;
  const bool mvec = FMASK && (s_kv & 15) == 0 && ((size_t)mask & 15) == 0;
  const bool bvec = BIAS && (s_kv & 3) == 0 && ((size_t)bias & 15) == 0;
  // causal: row r sees key c iff r + kv_off >= c; the walk stops after the
  // last key that the tile's last row sees
  const int kv_off = s_kv - s_q;
  int last = len;  // keys [0, last)
  if (CAUSAL) last = min(last, min(q0 + FT, s_q) + kv_off);
  const int kt_end = last > 0 ? (last + FT - 1) / FT : 0;

  const int n_walk = list_tiles(walk, wcnt, 0, kt_end, [&](int kt) {
    if (mt && mt[kt] == 0) return false;
    if (km) {  // a tile whose keys are all masked holds no work
      bool any = false;
      const int k0 = kt * FT, kn = min(FT, len - k0);
#pragma unroll 16
      for (int c = 0; c < FT; ++c) any |= c < kn && km[k0 + c] != 0;
      return any;
    }
    return true;
  });

  // V(t), its key flags, its strip values and its mask tile
  auto stage_key_side = [&](int k0) {
    stage_tile(v_s, vb, k0, s_kv, d, ld, FT);
    if (tid < FT) {
      const int key = k0 + tid;
      if (km != nullptr && key < len)
        cp_async4(ok_s + tid, km + key);
      else
        ok_s[tid] = key < len;
      if (KBIAS) {
        if (key < s_kv)
          cp_async4(kb_s + tid, bb + key);
        else
          kb_s[tid] = 0.f;
      }
    }
    if (FMASK) stage_mask(msk_s, mb, q0, k0, s_q, s_kv, mvec, FT);
  };

  if (n_walk > 0) {
    if (d16 != d) {  // the pad columns [d, d16) of Q, dO, K, V: cp.async never writes them
      for (int i = tid; i < 5 * FT * (d16 - d); i += FTHREADS)
        q_s[(i / (d16 - d)) * ld + d + i % (d16 - d)] = 0.f;
    }
    stage_tile(q_s, q + (size_t)bh * s_q * d, q0, s_q, d, ld, FT);
    stage_tile(k_s, kb, walk[0] * FT, s_kv, d, ld, FT);
  }
  async_commit();  // Q, K(0)
  if (n_walk > 0) {
    stage_tile(do_s, dout + (size_t)bh * s_q * d, q0, s_q, d, ld, FT);
    stage_key_side(walk[0] * FT);
  }
  async_commit();  // dO, V(0) and its flags, strip, mask tile
  if (BIAS && n_walk > 0) stage_bias_rows<R>(ds_s, bb, q0, walk[0] * FT, s_q, s_kv, bvec);
  async_commit();  // this warp's bias rows of tile 0

  if constexpr (BIAS) {
    // every key tile this CTA does not walk holds no visible pair of its
    // rows: dbias = 0 there
    const bool zvec = (s_kv & 3) == 0 && ((size_t)dbias & 15) == 0;
    for (int kt = 0, w = 0; kt < n_kt; ++kt) {
      if (w < n_walk && walk[w] == kt) {
        ++w;
        continue;
      }
      for (int i = tid; i < FT * FT / 4; i += FTHREADS) {
        const int row = q0 + (i >> 4), key = kt * FT + 4 * (i & 15);
        if (row >= s_q) continue;
        float* p = dbb + (size_t)row * s_kv + key;
        if (zvec && key + 4 <= s_kv) {
          *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (key + u < s_kv) p[u] = 0.f;
        }
      }
    }
  }

  const float sl2 = scale * LOG2E;  // exp(x) = exp2(x log2 e)
  float lse2[R], dl[R];              // rows past S_q: lse = +inf, so P = 0
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 8 * i;
    lse2[i] = row < s_q ? lse[(size_t)bh * s_q + row] * LOG2E : __int_as_float(0x7f800000);
    dl[i] = row < s_q ? delta[(size_t)bh * s_q + row] : 0.f;
  }
  float4 acc[R][G];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[i][g] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < n_walk; ++t) {
    const int k0 = walk[t] * FT;
    const float* kt_s = k_s + (t & 1) * FT * ld;
    async_wait<2>();
    __syncthreads();  // K(t) (and Q) is in; every warp is done with K(t - 1)
    if (t + 1 < n_walk)
      stage_tile(k_s + ((t + 1) & 1) * FT * ld, kb, walk[t + 1] * FT, s_kv, d, ld, FT);
    async_commit();

    float s[R][4];  // S = Q K^T: rows ty + 8i, keys tx + 16j
    dot_tile<R, false>(s, q_s, kt_s, d16, ld, ty, tx);
    async_wait<2>();
    __syncthreads();  // V(t), its flags, strip and mask tile (and dO) are in
    float dp[R][4];
    dot_tile<R, false>(dp, do_s, v_s, d16, ld, ty, tx);
    if (BIAS) {
      async_wait<1>();  // this warp's bias rows are in (K(t + 1) may not be)
      __syncwarp();
    }

    bool okj[4];
    float kbj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      okj[j] = ok_s[tx + 16 * j] != 0;
      kbj[j] = KBIAS ? kb_s[tx + 16 * j] * LOG2E : 0.f;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 8 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        bool ok = okj[j];
        if (CAUSAL) ok = ok && (q0 + r + kv_off >= k0 + c);
        if (FMASK) ok = ok && msk_s[r * FT + c] != 0;
        float x = fmaf(s[i][j], sl2, -lse2[i]);
        if (BIAS) x = fmaf(ds_s[r * FPLD + c], LOG2E, x);
        if (KBIAS) x += kbj[j];
        const float p = ok ? exp2f(x) : 0.f;
        const float tt = p * (dp[i][j] - dl[i]);  // dL/d(logit), before the scale
        // dS.K takes dS rounded to T (the TPU kernel's ds.astype(k.dtype))
        ds_s[r * FPLD + c] = round_to<T>(tt * scale);
        if (BIAS && q0 + r < s_q && k0 + c < s_kv) dbb[(size_t)(q0 + r) * s_kv + k0 + c] = tt;
      }
    }
    __syncthreads();  // every warp is done with V(t), its flags, strip and mask tile
    if (t + 1 < n_walk) stage_key_side(walk[t + 1] * FT);
    async_commit();

    acc_tile<R, G, false>(acc, ds_s, kt_s, d4, ld, ty, tx);  // dQ += dS K(t)
    __syncwarp();  // this warp's dS rows are read
    if (BIAS && t + 1 < n_walk)
      stage_bias_rows<R>(ds_s, bb, q0, walk[t + 1] * FT, s_q, s_kv, bvec);
    async_commit();
  }
  async_wait<0>();

  float* dqb = dq + (size_t)bh * s_q * d;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 8 * i;
    if (row >= s_q) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int col4 = tx + 16 * g;
      if (col4 < d4) *reinterpret_cast<float4*>(dqb + (size_t)row * d + 4 * col4) = acc[i][g];
    }
  }
}

// FMASK, `mask_tiles`, BIAS / KBIAS, `mask` and `bias` as for the dQ kernel;
// `dkbias` (BH, S_kv) is written with KBIAS
template <typename T, int G, bool CAUSAL, bool FMASK, bool BIAS, bool KBIAS>
__global__ void __launch_bounds__(FTHREADS, G == 1 ? 2 : 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ key_mask,
                     const int* __restrict__ lengths, const unsigned char* __restrict__ mask,
                     const unsigned char* __restrict__ mask_tiles,
                     const float* __restrict__ bias, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dkbias,
                     int heads, int gmode, int bgmode, int s_q, int s_kv, int d, float scale) {
  static_assert(!(BIAS && KBIAS), "a dense bias or a key-bias strip, not both");
  extern __shared__ __align__(16) float smem[];
  const int d16 = (d + 15) & ~15, ld = d16 + 4, d4 = d >> 2;
  const int n_qt = (s_q + FT - 1) / FT, n_kt = (s_kv + FT - 1) / FT;
  float* k_s = smem;                // FT x ld
  float* v_s = k_s + FT * ld;       // FT x ld
  float* q_s = v_s + FT * ld;       // 2 x FT x ld: Q(t) in buffer t % 2
  float* do_s = q_s + 2 * FT * ld;  // FT x ld
  float* p_s = do_s + FT * ld;      // FT x FPLD: P^T, then dS^T (key rows); a dense bias first
  float* ls_s = p_s + FT * FPLD;    // FT: lse of the query tile
  float* dl_s = ls_s + FT;          // FT: delta of the query tile
  int* wcnt = reinterpret_cast<int*>(dl_s + FT);  // 4 warp counts
  int* walk = wcnt + 4;                           // walked query tiles
  // FMASK: the (query, key) mask tile, query rows of MLD bytes
  unsigned char* msk_s = reinterpret_cast<unsigned char*>(walk + ((n_qt + 3) & ~3));

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x;
  const int kt = blockIdx.y;  // key tile 0 walks the most query tiles: it starts first
  const int k0 = kt * FT;
  const T* qb = q + (size_t)bh * s_q * d;
  const T* dob = dout + (size_t)bh * s_q * d;
  const int* km = key_mask ? key_mask + (size_t)(bh / heads) * s_kv : nullptr;
  // keys [0, len) may be visible
  const int len = lengths ? max(0, min(s_kv, lengths[bh / heads])) : s_kv;
  const unsigned char* mb = nullptr;
  const unsigned char* mt = nullptr;
  if (FMASK) {
    const int g = group_row(gmode, bh, heads);
    mb = mask + (size_t)g * s_q * s_kv;
    if (mask_tiles) mt = mask_tiles + (size_t)g * n_qt * n_kt + kt;  // a column: stride n_kt
  }
  const float* bb = nullptr;
  if (BIAS || KBIAS)
    bb = bias + (size_t)group_row(bgmode, bh, heads) * (BIAS ? (size_t)s_q * s_kv : s_kv);
  const bool mvec = FMASK && (s_kv & 15) == 0 && ((size_t)mask & 15) == 0;
  const bool bvec = BIAS && (s_kv & 3) == 0 && ((size_t)bias & 15) == 0;
  const float pinf = __int_as_float(0x7f800000);

  // a key tile with no unmasked key before the length walks nothing
  const bool live =
      __syncthreads_or(tid < FT && k0 + tid < len && (km == nullptr || km[k0 + tid] != 0));
  // causal: row r sees key c iff r + kv_off >= c, so the first row that sees
  // any key of this tile is k0 - kv_off (none at or past S_q)
  const int kv_off = s_kv - s_q;
  const int first = CAUSAL ? k0 - kv_off : 0;
  const int qt_begin = max(0, first) / FT;
  const int qt_end = live && first < s_q ? n_qt : qt_begin;
  const int n_walk = list_tiles(walk, wcnt, qt_begin, qt_end,
                                [&](int t) { return mt == nullptr || mt[(size_t)t * n_kt] != 0; });

  unsigned kok = 0;  // bit i: key k0 + 8ty + i is below the length and unmasked
  float kbv[R], dkb[R];  // KBIAS: the strip at this thread's keys (times log2 e), dkbias sums
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + R * ty + i;
    if (key < len && (km == nullptr || km[key] != 0)) kok |= 1u << i;
    kbv[i] = (KBIAS && key < s_kv) ? bb[key] * LOG2E : 0.f;
    dkb[i] = 0.f;
  }

  // dO(t), its lse and delta (rows past S_q: +inf and 0, so P = 0), its mask
  // tile
  auto stage_query_side = [&](int q0) {
    stage_tile(do_s, dob, q0, s_q, d, ld, FT);
    const int row = q0 + (tid & (FT - 1));
    float* dst = (tid < FT ? ls_s : dl_s) + (tid & (FT - 1));
    if (row < s_q)
      cp_async4(dst, (tid < FT ? lse : delta) + (size_t)bh * s_q + row);
    else
      *dst = tid < FT ? pinf : 0.f;
    if (FMASK) stage_mask(msk_s, mb, q0, k0, s_q, s_kv, mvec, FT, MLD);
  };

  if (n_walk > 0) {
    if (d16 != d) {  // the pad columns [d, d16) of K, V, Q, dO: cp.async never writes them
      for (int i = tid; i < 5 * FT * (d16 - d); i += FTHREADS)
        k_s[(i / (d16 - d)) * ld + d + i % (d16 - d)] = 0.f;
    }
    stage_tile(k_s, k + (size_t)bh * s_kv * d, k0, s_kv, d, ld, FT);
    stage_tile(q_s, qb, walk[0] * FT, s_q, d, ld, FT);
  }
  async_commit();  // K, Q(0)
  if (n_walk > 0) {
    stage_tile(v_s, v + (size_t)bh * s_kv * d, k0, s_kv, d, ld, FT);
    stage_query_side(walk[0] * FT);
  }
  async_commit();  // V, dO(0) and its lse, delta, mask tile

  const float sl2 = scale * LOG2E;  // exp(x) = exp2(x log2 e)
  float4 dk_acc[R][G], dv_acc[R][G];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      dk_acc[i][g] = make_float4(0.f, 0.f, 0.f, 0.f);
      dv_acc[i][g] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  for (int t = 0; t < n_walk; ++t) {
    const int q0 = walk[t] * FT;
    const float* qt_s = q_s + (t & 1) * FT * ld;
    async_wait<1>();
    __syncthreads();  // K, Q(t) are in; every warp is done with Q(t - 1) and its dS^T rows
    if (BIAS) stage_bias_tile(p_s, bb, q0, k0, s_q, s_kv, bvec);  // (query, key), row-major
    async_commit();
    if (t + 1 < n_walk) stage_tile(q_s + ((t + 1) & 1) * FT * ld, qb, walk[t + 1] * FT, s_q, d, ld, FT);
    async_commit();

    float st[R][4];  // S^T = K Q^T: keys 8ty + i, queries tx + 16j
    dot_tile<R, true>(st, k_s, qt_s, d16, ld, ty, tx);
    async_wait<2>();
    __syncthreads();  // dO(t), its lse, delta and mask tile (and V) are in
    float dpt[R][4];
    dot_tile<R, true>(dpt, v_s, do_s, d16, ld, ty, tx);
    if (BIAS) {
      async_wait<1>();  // the bias tile is in (Q(t + 1) may not be)
      __syncthreads();
    }

    // P^T into st, dS^T into dpt, each rounded to T for its product
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float ls2 = ls_s[c] * LOG2E, dlj = dl_s[c];
      uint2 mk = make_uint2(~0u, ~0u);  // mask[query c][keys 8ty .. 8ty + 7]
      if (FMASK) mk = *reinterpret_cast<const uint2*>(msk_s + c * MLD + R * ty);
      float bj[R];
      if (BIAS) {
        const float4 b0 = *reinterpret_cast<const float4*>(p_s + c * FPLD + R * ty);
        const float4 b1 = *reinterpret_cast<const float4*>(p_s + c * FPLD + R * ty + 4);
        bj[0] = b0.x; bj[1] = b0.y; bj[2] = b0.z; bj[3] = b0.w;
        bj[4] = b1.x; bj[5] = b1.y; bj[6] = b1.z; bj[7] = b1.w;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        bool ok = (kok >> i) & 1u;
        if (CAUSAL) ok = ok && (q0 + c + kv_off >= k0 + R * ty + i);
        if (FMASK) ok = ok && (((i < 4 ? mk.x : mk.y) >> (8 * (i & 3))) & 0xffu) != 0;
        float x = fmaf(st[i][j], sl2, -ls2);
        if (BIAS) x = fmaf(bj[i], LOG2E, x);
        if (KBIAS) x += kbv[i];
        const float p = ok ? exp2f(x) : 0.f;
        const float tt = p * (dpt[i][j] - dlj);  // dL/d(logit), before the scale
        if (KBIAS) dkb[i] += tt;
        // P^T.dO and dS^T.Q take P and dS rounded to T (the TPU kernel's
        // p.astype(do.dtype), ds.astype(q.dtype)); dkbias the unrounded t
        st[i][j] = round_to<T>(p);
        dpt[i][j] = round_to<T>(tt * scale);
      }
    }
    if (BIAS) __syncthreads();  // every thread has read its bias before P^T overwrites it
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p_s[(R * ty + i) * FPLD + tx + 16 * j] = st[i][j];
    __syncwarp();
    acc_tile<R, G, true>(dv_acc, p_s, do_s, d4, ld, ty, tx);  // dV += P^T dO(t)
    __syncthreads();  // every warp is done with dO(t), its lse, delta, mask tile and P^T rows
    if (t + 1 < n_walk) stage_query_side(walk[t + 1] * FT);
    async_commit();
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p_s[(R * ty + i) * FPLD + tx + 16 * j] = dpt[i][j];
    __syncwarp();
    acc_tile<R, G, true>(dk_acc, p_s, qt_s, d4, ld, ty, tx);  // dK += dS^T Q(t)
  }
  async_wait<0>();

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + R * ty + i;
    if (KBIAS) {
      const float sum = half_sum16(dkb[i]);  // over the 16 threads of key row 8ty + i
      if (tx == 0 && key < s_kv) dkbias[(size_t)bh * s_kv + key] = sum;
    }
    if (key >= s_kv) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int col4 = tx + 16 * g;
      if (col4 < d4) {
        const size_t at = ((size_t)bh * s_kv + key) * d + 4 * col4;
        *reinterpret_cast<float4*>(dk + at) = dk_acc[i][g];
        *reinterpret_cast<float4*>(dv + at) = dv_acc[i][g];
      }
    }
  }
}

template <typename T, int G, bool CAUSAL, bool FMASK, bool BIAS, bool KBIAS>
int launch_dq(const T* q, const T* k, const T* v, const int* key_mask, const int* lengths,
              const unsigned char* mask, const unsigned char* mask_tiles, const float* bias,
              const T* dout, const float* lse, const float* delta, T* dq, float* dbias, int bh,
              int heads, int gmode, int bgmode, int s_q, int s_kv, int d, float scale,
              cudaStream_t stream) {
  static size_t configured[64] = {0};
  const size_t smem = dq_smem(d, (s_kv + FT - 1) / FT, FMASK, KBIAS);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = ensure_smem(
      (const void*)flash_bwd_dq_kernel<T, G, CAUSAL, FMASK, BIAS, KBIAS>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (s_q + FT - 1) / FT);
  flash_bwd_dq_kernel<T, G, CAUSAL, FMASK, BIAS, KBIAS><<<grid, FTHREADS, smem, stream>>>(
      q, k, v, key_mask, lengths, mask, mask_tiles, bias, dout, lse, delta, dq, dbias, heads,
      gmode, bgmode, s_q, s_kv, d, scale);
  return (int)cudaGetLastError();
}

template <typename T, int G, bool CAUSAL, bool FMASK, bool BIAS, bool KBIAS>
int launch_dkv(const T* q, const T* k, const T* v, const int* key_mask, const int* lengths,
               const unsigned char* mask, const unsigned char* mask_tiles, const float* bias,
               const T* dout, const float* lse, const float* delta, T* dk, T* dv, float* dkbias,
               int bh, int heads, int gmode, int bgmode, int s_q, int s_kv, int d, float scale,
               cudaStream_t stream) {
  static size_t configured[64] = {0};
  const size_t smem = dkv_smem(d, (s_q + FT - 1) / FT, FMASK);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = ensure_smem(
      (const void*)flash_bwd_dkv_kernel<T, G, CAUSAL, FMASK, BIAS, KBIAS>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (s_kv + FT - 1) / FT);
  flash_bwd_dkv_kernel<T, G, CAUSAL, FMASK, BIAS, KBIAS><<<grid, FTHREADS, smem, stream>>>(
      q, k, v, key_mask, lengths, mask, mask_tiles, bias, dout, lse, delta, dk, dv, dkbias,
      heads, gmode, bgmode, s_q, s_kv, d, scale);
  return (int)cudaGetLastError();
}

template <typename T>
bool bad_shape(int bh, int heads, int s_q, int s_kv, int d, int gmode = 0, int bgmode = 0) {
  return bad_head_dim<T>(d) || heads <= 0 || bh <= 0 || bh % heads || s_q <= 0 || s_kv <= 0 ||
         (s_q + FT - 1) / FT > 65535 || (s_kv + FT - 1) / FT > 65535 || gmode < 0 ||
         gmode > 3 || bgmode < 0 || bgmode > 3;
}

template <typename T, bool CAUSAL, bool FMASK = false, bool BIAS = false, bool KBIAS = false>
int dispatch_dq(const T* q, const T* k, const T* v, const int* key_mask, const int* lengths,
                const unsigned char* mask, const unsigned char* mask_tiles, const float* bias,
                const T* dout, const float* lse, const float* delta, T* dq, float* dbias, int bh,
                int heads, int gmode, int bgmode, int s_q, int s_kv, int d, float scale,
                void* stream) {
  if (bad_shape<T>(bh, heads, s_q, s_kv, d, gmode, bgmode)) return (int)cudaErrorInvalidValue;
  return d <= 64 ? launch_dq<T, 1, CAUSAL, FMASK, BIAS, KBIAS>(
                       q, k, v, key_mask, lengths, mask, mask_tiles, bias, dout, lse, delta, dq,
                       dbias, bh, heads, gmode, bgmode, s_q, s_kv, d, scale, (cudaStream_t)stream)
                 : launch_dq<T, 2, CAUSAL, FMASK, BIAS, KBIAS>(
                       q, k, v, key_mask, lengths, mask, mask_tiles, bias, dout, lse, delta, dq,
                       dbias, bh, heads, gmode, bgmode, s_q, s_kv, d, scale, (cudaStream_t)stream);
}

template <typename T, bool CAUSAL, bool FMASK = false, bool BIAS = false, bool KBIAS = false>
int dispatch_dkv(const T* q, const T* k, const T* v, const int* key_mask, const int* lengths,
                 const unsigned char* mask, const unsigned char* mask_tiles, const float* bias,
                 const T* dout, const float* lse, const float* delta, T* dk, T* dv, float* dkbias,
                 int bh, int heads, int gmode, int bgmode, int s_q, int s_kv, int d, float scale,
                 void* stream) {
  if (bad_shape<T>(bh, heads, s_q, s_kv, d, gmode, bgmode)) return (int)cudaErrorInvalidValue;
  return d <= 64 ? launch_dkv<T, 1, CAUSAL, FMASK, BIAS, KBIAS>(
                       q, k, v, key_mask, lengths, mask, mask_tiles, bias, dout, lse, delta, dk,
                       dv, dkbias, bh, heads, gmode, bgmode, s_q, s_kv, d, scale,
                       (cudaStream_t)stream)
                 : launch_dkv<T, 2, CAUSAL, FMASK, BIAS, KBIAS>(
                       q, k, v, key_mask, lengths, mask, mask_tiles, bias, dout, lse, delta, dk,
                       dv, dkbias, bh, heads, gmode, bgmode, s_q, s_kv, d, scale,
                       (cudaStream_t)stream);
}

// causal != 0 selects the causal rule
template <typename T, bool FMASK, bool BIAS, bool KBIAS>
int dq_sel(const T* q, const T* k, const T* v, const int* key_mask, const int* lengths,
           const unsigned char* mask, const unsigned char* mask_tiles, const float* bias,
           const T* dout, const float* lse, const float* delta, T* dq, float* dbias, int bh,
           int heads, int s_q, int s_kv, int d, int gmode, int bgmode, int causal, float scale,
           void* stream) {
  return causal ? dispatch_dq<T, true, FMASK, BIAS, KBIAS>(
                      q, k, v, key_mask, lengths, mask, mask_tiles, bias, dout, lse, delta, dq,
                      dbias, bh, heads, gmode, bgmode, s_q, s_kv, d, scale, stream)
                : dispatch_dq<T, false, FMASK, BIAS, KBIAS>(
                      q, k, v, key_mask, lengths, mask, mask_tiles, bias, dout, lse, delta, dq,
                      dbias, bh, heads, gmode, bgmode, s_q, s_kv, d, scale, stream);
}

template <typename T, bool FMASK, bool BIAS, bool KBIAS>
int dkv_sel(const T* q, const T* k, const T* v, const int* key_mask, const int* lengths,
            const unsigned char* mask, const unsigned char* mask_tiles, const float* bias,
            const T* dout, const float* lse, const float* delta, T* dk, T* dv, float* dkbias,
            int bh, int heads, int s_q, int s_kv, int d, int gmode, int bgmode, int causal,
            float scale, void* stream) {
  return causal ? dispatch_dkv<T, true, FMASK, BIAS, KBIAS>(
                      q, k, v, key_mask, lengths, mask, mask_tiles, bias, dout, lse, delta, dk,
                      dv, dkbias, bh, heads, gmode, bgmode, s_q, s_kv, d, scale, stream)
                : dispatch_dkv<T, false, FMASK, BIAS, KBIAS>(
                      q, k, v, key_mask, lengths, mask, mask_tiles, bias, dout, lse, delta, dk,
                      dv, dkbias, bh, heads, gmode, bgmode, s_q, s_kv, d, scale, stream);
}

// Additive bias: bias (G, s_q, s_kv) or, strip != 0, (G, 1, s_kv) float32 of
// group mode gmode; causal != 0 adds the causal rule.  dQ with a dense bias
// writes dbias (bh, s_q, s_kv) float32 (the pre-scale dS; null with a strip);
// dK/dV with a strip writes dkbias (bh, 1, s_kv) float32 (null with a dense
// bias).
template <typename T>
int entry_dq_bias(const T* q, const T* k, const T* v, const int* key_mask, const int* lengths,
                  const float* bias, const T* dout, const float* lse, const float* delta, T* dq,
                  float* dbias, int bh, int heads, int s_q, int s_kv, int d, int gmode,
                  int strip, int causal, float scale, void* stream) {
  if (bias == nullptr || (strip != 0) != (dbias == nullptr)) return (int)cudaErrorInvalidValue;
  return strip ? dq_sel<T, false, false, true>(q, k, v, key_mask, lengths, nullptr, nullptr,
                                               bias, dout, lse, delta, dq, nullptr, bh, heads,
                                               s_q, s_kv, d, 0, gmode, causal, scale, stream)
               : dq_sel<T, false, true, false>(q, k, v, key_mask, lengths, nullptr, nullptr,
                                               bias, dout, lse, delta, dq, dbias, bh, heads, s_q,
                                               s_kv, d, 0, gmode, causal, scale, stream);
}

template <typename T>
int entry_dkv_bias(const T* q, const T* k, const T* v, const int* key_mask, const int* lengths,
                   const float* bias, const T* dout, const float* lse, const float* delta, T* dk,
                   T* dv, float* dkbias, int bh, int heads, int s_q, int s_kv, int d, int gmode,
                   int strip, int causal, float scale, void* stream) {
  if (bias == nullptr || (strip != 0) != (dkbias != nullptr)) return (int)cudaErrorInvalidValue;
  return strip ? dkv_sel<T, false, false, true>(q, k, v, key_mask, lengths, nullptr, nullptr,
                                                bias, dout, lse, delta, dk, dv, dkbias, bh,
                                                heads, s_q, s_kv, d, 0, gmode, causal, scale,
                                                stream)
               : dkv_sel<T, false, true, false>(q, k, v, key_mask, lengths, nullptr, nullptr,
                                                bias, dout, lse, delta, dk, dv, nullptr, bh,
                                                heads, s_q, s_kv, d, 0, gmode, causal, scale,
                                                stream);
}

// Full mask: mask (G, s_q, s_kv) uint8 of group mode gmode and its tile map
// mask_tiles (G, ceil(s_q / 64), ceil(s_kv / 64)) uint8, 0 where a 64 x 64
// tile holds no visible pair (null: every tile), composed with key_mask,
// lengths and, causal != 0, the causal rule; optionally with an additive bias
// of its own group mode bgmode (bias null: the mask alone; strip != 0: the
// key-bias strip).  dQ writes dbias with a dense bias, dK/dV dkbias with a
// strip, as the bias entries do; each is null otherwise.
template <typename T>
int entry_dq_mask(const T* q, const T* k, const T* v, const int* key_mask, const int* lengths,
                  const unsigned char* mask, const unsigned char* mask_tiles, const float* bias,
                  const T* dout, const float* lse, const float* delta, T* dq, float* dbias,
                  int bh, int heads, int s_q, int s_kv, int d, int gmode, int bgmode, int strip,
                  int causal, float scale, void* stream) {
  const bool dense = bias != nullptr && !strip;
  if (mask == nullptr || dense != (dbias != nullptr)) return (int)cudaErrorInvalidValue;
  if (bias == nullptr)
    return dq_sel<T, true, false, false>(q, k, v, key_mask, lengths, mask, mask_tiles, nullptr,
                                         dout, lse, delta, dq, nullptr, bh, heads, s_q, s_kv, d,
                                         gmode, 0, causal, scale, stream);
  return strip ? dq_sel<T, true, false, true>(q, k, v, key_mask, lengths, mask, mask_tiles, bias,
                                              dout, lse, delta, dq, nullptr, bh, heads, s_q, s_kv,
                                              d, gmode, bgmode, causal, scale, stream)
               : dq_sel<T, true, true, false>(q, k, v, key_mask, lengths, mask, mask_tiles, bias,
                                              dout, lse, delta, dq, dbias, bh, heads, s_q, s_kv,
                                              d, gmode, bgmode, causal, scale, stream);
}

template <typename T>
int entry_dkv_mask(const T* q, const T* k, const T* v, const int* key_mask, const int* lengths,
                   const unsigned char* mask, const unsigned char* mask_tiles, const float* bias,
                   const T* dout, const float* lse, const float* delta, T* dk, T* dv,
                   float* dkbias, int bh, int heads, int s_q, int s_kv, int d, int gmode,
                   int bgmode, int strip, int causal, float scale, void* stream) {
  const bool strip_bias = bias != nullptr && strip;
  if (mask == nullptr || strip_bias != (dkbias != nullptr)) return (int)cudaErrorInvalidValue;
  if (bias == nullptr)
    return dkv_sel<T, true, false, false>(q, k, v, key_mask, lengths, mask, mask_tiles, nullptr,
                                          dout, lse, delta, dk, dv, nullptr, bh, heads, s_q, s_kv,
                                          d, gmode, 0, causal, scale, stream);
  return strip ? dkv_sel<T, true, false, true>(q, k, v, key_mask, lengths, mask, mask_tiles,
                                               bias, dout, lse, delta, dk, dv, dkbias, bh, heads,
                                               s_q, s_kv, d, gmode, bgmode, causal, scale, stream)
               : dkv_sel<T, true, true, false>(q, k, v, key_mask, lengths, mask, mask_tiles,
                                               bias, dout, lse, delta, dk, dv, nullptr, bh, heads,
                                               s_q, s_kv, d, gmode, bgmode, causal, scale, stream);
}

}  // namespace

// HETU_BWD_DQ_ENTRIES(T, SFX) and HETU_BWD_DKV_ENTRIES(T, SFX) define the dQ
// and the dK/dV C entries for element type T, each named with the suffix
// SFX; HETU_BWD_ENTRIES(T, SFX) both.  Each launches on `stream` and returns
// cudaGetLastError() after the launch (0 = launched).  q/dout/dq (bh, s_q,
// d), k/v/dk/dv (bh, s_kv, d): contiguous float32, 16-byte aligned; key_mask
// (bh / heads, s_kv) int32 or null; lengths (bh / heads) int32 or null (keys
// at or past lengths[b] invisible); the `_mask` entries' mask_tiles (G,
// ceil(s_q / 64), ceil(s_kv / 64)) uint8 or null, after the mask; lse and
// delta (bh, s_q) float32; a bias, dbias and dkbias float32.  The `_causal`
// entries add the causal rule.  (The `_bf16` twins run on the tensor cores:
// flash_attention_dq_bf16.cu, flash_attention_dkv_bf16.cu; their `_mask`
// entries take no tile map.)
#define HETU_BWD_DQ_ENTRIES(T, SFX)                                                             \
  extern "C" int hetu_flash_bwd_dq##SFX(const T* q, const T* k, const T* v,                    \
                                        const int* key_mask, const int* lengths, const T* dout, \
                                        const float* lse, const float* delta, T* dq, int bh,   \
                                        int heads, int s_q, int s_kv, int d, float scale,      \
                                        void* stream) {                                        \
    return dispatch_dq<T, false>(q, k, v, key_mask, lengths, nullptr, nullptr, nullptr, dout,  \
                                 lse, delta, dq, nullptr, bh, heads, 0, 0, s_q, s_kv, d, scale, \
                                 stream);                                                      \
  }                                                                                             \
  extern "C" int hetu_flash_bwd_dq_causal##SFX(                                                \
      const T* q, const T* k, const T* v, const int* key_mask, const int* lengths,             \
      const T* dout, const float* lse, const float* delta, T* dq, int bh, int heads, int s_q,  \
      int s_kv, int d, float scale, void* stream) {                                            \
    return dispatch_dq<T, true>(q, k, v, key_mask, lengths, nullptr, nullptr, nullptr, dout,   \
                                lse, delta, dq, nullptr, bh, heads, 0, 0, s_q, s_kv, d, scale, \
                                stream);                                                       \
  }                                                                                             \
  extern "C" int hetu_flash_bwd_dq_bias##SFX(                                                  \
      const T* q, const T* k, const T* v, const int* key_mask, const int* lengths,             \
      const float* bias, const T* dout, const float* lse, const float* delta, T* dq,           \
      float* dbias, int bh, int heads, int s_q, int s_kv, int d, int gmode, int strip,         \
      int causal, float scale, void* stream) {                                                 \
    return entry_dq_bias(q, k, v, key_mask, lengths, bias, dout, lse, delta, dq, dbias, bh,    \
                         heads, s_q, s_kv, d, gmode, strip, causal, scale, stream);            \
  }                                                                                             \
  extern "C" int hetu_flash_bwd_dq_mask##SFX(                                                  \
      const T* q, const T* k, const T* v, const int* key_mask, const int* lengths,             \
      const unsigned char* mask, const unsigned char* mask_tiles, const float* bias,           \
      const T* dout, const float* lse, const float* delta, T* dq, float* dbias, int bh,        \
      int heads, int s_q, int s_kv, int d, int gmode, int bgmode, int strip, int causal,       \
      float scale, void* stream) {                                                             \
    return entry_dq_mask(q, k, v, key_mask, lengths, mask, mask_tiles, bias, dout, lse, delta, \
                         dq, dbias, bh, heads, s_q, s_kv, d, gmode, bgmode, strip, causal,     \
                         scale, stream);                                                       \
  }

#define HETU_BWD_DKV_ENTRIES(T, SFX)                                                           \
  extern "C" int hetu_flash_bwd_dkv##SFX(const T* q, const T* k, const T* v,                   \
                                         const int* key_mask, const int* lengths,              \
                                         const T* dout, const float* lse, const float* delta,  \
                                         T* dk, T* dv, int bh, int heads, int s_q, int s_kv,   \
                                         int d, float scale, void* stream) {                   \
    return dispatch_dkv<T, false>(q, k, v, key_mask, lengths, nullptr, nullptr, nullptr, dout, \
                                  lse, delta, dk, dv, nullptr, bh, heads, 0, 0, s_q, s_kv, d,  \
                                  scale, stream);                                              \
  }                                                                                             \
  extern "C" int hetu_flash_bwd_dkv_causal##SFX(                                               \
      const T* q, const T* k, const T* v, const int* key_mask, const int* lengths,             \
      const T* dout, const float* lse, const float* delta, T* dk, T* dv, int bh, int heads,    \
      int s_q, int s_kv, int d, float scale, void* stream) {                                   \
    return dispatch_dkv<T, true>(q, k, v, key_mask, lengths, nullptr, nullptr, nullptr, dout,  \
                                 lse, delta, dk, dv, nullptr, bh, heads, 0, 0, s_q, s_kv, d,   \
                                 scale, stream);                                               \
  }                                                                                             \
  extern "C" int hetu_flash_bwd_dkv_bias##SFX(                                                 \
      const T* q, const T* k, const T* v, const int* key_mask, const int* lengths,             \
      const float* bias, const T* dout, const float* lse, const float* delta, T* dk, T* dv,    \
      float* dkbias, int bh, int heads, int s_q, int s_kv, int d, int gmode, int strip,        \
      int causal, float scale, void* stream) {                                                 \
    return entry_dkv_bias(q, k, v, key_mask, lengths, bias, dout, lse, delta, dk, dv, dkbias,  \
                          bh, heads, s_q, s_kv, d, gmode, strip, causal, scale, stream);       \
  }                                                                                             \
  extern "C" int hetu_flash_bwd_dkv_mask##SFX(                                                 \
      const T* q, const T* k, const T* v, const int* key_mask, const int* lengths,             \
      const unsigned char* mask, const unsigned char* mask_tiles, const float* bias,           \
      const T* dout, const float* lse, const float* delta, T* dk, T* dv, float* dkbias,        \
      int bh, int heads, int s_q, int s_kv, int d, int gmode, int bgmode, int strip,           \
      int causal, float scale, void* stream) {                                                 \
    return entry_dkv_mask(q, k, v, key_mask, lengths, mask, mask_tiles, bias, dout, lse,       \
                          delta, dk, dv, dkbias, bh, heads, s_q, s_kv, d, gmode, bgmode,       \
                          strip, causal, scale, stream);                                       \
  }

#define HETU_BWD_ENTRIES(T, SFX) \
  HETU_BWD_DQ_ENTRIES(T, SFX)    \
  HETU_BWD_DKV_ENTRIES(T, SFX)
