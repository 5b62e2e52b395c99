// Flash attention forward for Hopper (sm_90a): two kernels that replace
// hetu_tpu/ops/pallas/flash_attention.py::_fwd_kernel (launched by _flash_fwd).
// Both output `out` (BH, S_q, D) and the per-row log-sum-exp `lse` (BH, S_q),
// float32.  A row with no valid key outputs 0 with lse = -1e30, as the TPU
// kernel's _finish does.
//
// 1. flash_fwd_lengths_kernel, the `lengths` specialization (decode): for the
//    query rows of (b*h), keys at index >= lengths[b] are invisible.
// 2. flash_fwd_kernel, the dense, `key_mask`, causal, full-mask and additive
//    bias specializations (training and chunked prefill): keys with
//    key_mask[b, j] == 0 are invisible; under `causal` key c is visible to
//    query row r iff r + (S_kv - S_q) >= c; under a full mask iff
//    mask[g, r, c] != 0.  The three compose (logical and); none = dense.  A
//    bias is added to the scaled scores before the validity select.
//
// ---- 1. lengths (decode)
// What bounds it: at decode (S_q = 1) each valid K and V element is read once
// and used for about two multiply-adds, far below the card's operations-per-
// byte balance, so the kernel is bound by the K/V bytes it reads.  The design
// follows from that: the tile loop stops at lengths[b], so keys past the length
// cost neither bytes nor operations; each K/V row is read once, with coalesced
// 16-byte cp.async copies into shared memory; scores, the running max and sum
// and the output accumulator never touch device memory.  Nothing is padded to
// a tile multiple: the last tile is ragged and masked here.
//
// Layout: one CTA of NWARPS warps per (b*h, tile of BQ query rows).  Each key
// tile of BK = 32 * NWARPS rows is staged in shared memory.  Warp w owns keys
// [32w, 32w + 32) of every tile: lane l computes the score of key 32w + l, and
// owns output dims l, l + 32, l + 64, l + 96 for the P.V product.  Every warp
// keeps its own online-softmax state (max, sum, accumulator) per query row in
// registers; the warps' states are merged once, at the end, through shared
// memory (a two-level online softmax, so no query row waits on one warp).
//
// Not yet: wgmma, TMA, double buffering, and splitting a long cache across
// CTAs (at B*H = 96 rows the grid underfills the 132 SMs).

#include <cuda_runtime.h>

#include "flash_tile.cuh"

namespace {

using hetu_flash::cp_async16;
using hetu_flash::cp_async_wait_all;
using hetu_flash::FULL;
using hetu_flash::NEG_INF;
using hetu_flash::warp_max;
using hetu_flash::warp_sum;

constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int BK = 32 * NWARPS;  // keys per shared-memory tile
constexpr int BQ = 4;            // query rows per CTA
constexpr int DMAX = 128;        // largest head dim
constexpr int DPL = DMAX / 32;   // output dims per lane

__global__ void __launch_bounds__(NTHREADS)
flash_fwd_lengths_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ lengths,
                         float* __restrict__ out, float* __restrict__ lse,
                         int heads, int s_q, int s_kv, int d, float scale) {
  extern __shared__ __align__(16) float smem[];
  // K rows are padded to d + 4 floats: rows stay 16-byte aligned for cp.async,
  // and the lanes' float4 reads of 8 consecutive rows hit distinct banks.
  const int ks = d + 4;
  float* k_s = smem;            // BK x ks
  float* v_s = k_s + BK * ks;   // BK x d
  float* q_s = v_s + BK * d;    // BQ x d

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int d4 = d >> 2;

  int len = lengths[bh / heads];
  len = len < 0 ? 0 : (len > s_kv ? s_kv : len);

  const float* qb = q + ((size_t)bh * s_q + q0) * d;
  const float* kb = k + (size_t)bh * s_kv * d;
  const float* vb = v + (size_t)bh * s_kv * d;

  // the query tile; rows past s_q are zero (computed, never stored)
  for (int i = tid; i < BQ * d4; i += NTHREADS) {
    const int r = i / d4, c = i - r * d4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < s_q) val = reinterpret_cast<const float4*>(qb + (size_t)r * d)[c];
    reinterpret_cast<float4*>(q_s + r * d)[c] = val;
  }

  float m[BQ], l[BQ], acc[BQ][DPL];
#pragma unroll
  for (int r = 0; r < BQ; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int t0 = 0; t0 < len; t0 += BK) {
    const int rows = min(BK, len - t0);
    __syncthreads();  // the previous tile is consumed; q_s is staged
    for (int i = tid; i < rows * d4; i += NTHREADS) {
      const int r = i / d4, c = i - r * d4;
      const size_t g = (size_t)(t0 + r) * d + 4 * c;
      cp_async16(k_s + r * ks + 4 * c, kb + g);
      cp_async16(v_s + r * d + 4 * c, vb + g);
    }
    cp_async_wait_all();
    __syncthreads();

    const int nv = min(32, rows - 32 * warp);  // valid keys in this warp's slice
    if (nv <= 0) continue;                     // warp-uniform

    float s[BQ];
#pragma unroll
    for (int r = 0; r < BQ; ++r) s[r] = 0.f;
    if (lane < nv) {
      const float4* krow = reinterpret_cast<const float4*>(k_s + (32 * warp + lane) * ks);
#pragma unroll 4
      for (int c = 0; c < d4; ++c) {
        const float4 kv = krow[c];
#pragma unroll
        for (int r = 0; r < BQ; ++r) {
          const float4 qv = reinterpret_cast<const float4*>(q_s + r * d)[c];
          s[r] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < BQ; ++r) {
      const float sr = lane < nv ? s[r] * scale : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = expf(m[r] - m_new);
      const float p = lane < nv ? expf(sr - m_new) : 0.f;
      l[r] = alpha * l[r] + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      s[r] = p;  // from here on: this lane's probability
    }
    for (int j = 0; j < nv; ++j) {
      const float* vrow = v_s + (32 * warp + j) * d;
      float pj[BQ];
#pragma unroll
      for (int r = 0; r < BQ; ++r) pj[r] = __shfl_sync(FULL, s[r], j);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int dd = lane + 32 * i;
        if (dd < d) {
          const float vv = vrow[dd];
#pragma unroll
          for (int r = 0; r < BQ; ++r) acc[r][i] += pj[r] * vv;
        }
      }
    }
  }

  // merge the warps' partial states: the tiles' shared memory is reused
  __syncthreads();
  const int rs = d + 2;  // slot: max, sum, d accumulator values
  float* red = smem;
#pragma unroll
  for (int r = 0; r < BQ; ++r) {
    float* slot = red + (warp * BQ + r) * rs;
    if (lane == 0) {
      slot[0] = m[r];
      slot[1] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int dd = lane + 32 * i;
      if (dd < d) slot[2 + dd] = acc[r][i];
    }
  }
  __syncthreads();
  for (int r = warp; r < BQ; r += NWARPS) {
    if (q0 + r >= s_q) continue;
    float mx = NEG_INF;
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, red[(w * BQ + r) * rs]);
    float sum = 0.f, o[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[i] = 0.f;
    for (int w = 0; w < NWARPS; ++w) {
      const float* slot = red + (w * BQ + r) * rs;
      const float f = expf(slot[0] - mx);
      sum += f * slot[1];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int dd = lane + 32 * i;
        if (dd < d) o[i] += f * slot[2 + dd];
      }
    }
    const float l_safe = sum == 0.f ? 1.f : sum;
    const size_t row = (size_t)bh * s_q + q0 + r;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int dd = lane + 32 * i;
      if (dd < d) out[row * d + dd] = o[i] / l_safe;
    }
    if (lane == 0) lse[row] = mx + logf(l_safe);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = launched).
// q (bh, s_q, d), k/v (bh, s_kv, d), out (bh, s_q, d): contiguous float32,
// 16-byte aligned; lengths (bh / heads) int32; lse (bh, s_q) float32.
extern "C" int hetu_flash_fwd_lengths(const float* q, const float* k, const float* v,
                                      const int* lengths, float* out, float* lse, int bh,
                                      int heads, int s_q, int s_kv, int d, float scale,
                                      void* stream) {
  if (d <= 0 || d > DMAX || (d & 3) || heads <= 0 || bh <= 0 || bh % heads ||
      s_q <= 0 || s_kv < 0 || (s_q + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(BK * (d + 4) + BK * d + BQ * d) * sizeof(float);
  // above 48 KB a kernel needs an explicit opt-in, once per device
  static size_t configured[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > configured[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_lengths_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = smem;
  }
  const dim3 grid(bh, (s_q + BQ - 1) / BQ);
  flash_fwd_lengths_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      q, k, v, lengths, out, lse, heads, s_q, s_kv, d, scale);
  return (int)cudaGetLastError();
}

// ---- 2. dense, key_mask, causal and full mask (training, chunked prefill)
//
// What bounds it: at the training shapes (S_q = S_kv = 512, D = 64) every K
// and V row is used by 512 query rows, so the two products' operations, not
// bytes, bound it: 4 * S_q * S_kv * D flops against 4 * (3 S + S) * D bytes
// per (b*h).  The kernel runs in float32 on the CUDA cores (no tensor-core
// path in fp32 exact), so the design is a register-tiled product: one CTA of
// 256 threads per (b*h, 64 query rows); each 64-key tile of K and V is staged
// once in shared memory and used by all 64 rows; a thread holds a 4 x 4 block
// of scores and a 4-row slice of the output accumulator in registers
// (flash_tile.cuh).  Scores and probabilities never reach device memory: the
// probability tile goes through shared memory into the P.V product.  Ragged
// tiles are zero-filled and masked here; nothing is padded in device memory.
//
// Causal (template CAUSAL): validity is per (row, key), so it is taken with
// the scores; the key loop ends at the last key the tile's last row sees
// (bottom-right aligned diagonal, kv_off = S_kv - S_q), so key tiles wholly
// above the diagonal cost neither bytes nor operations: about half the dense
// work at S_q = S_kv.  A tile whose rows see no key at all (S_q > S_kv) runs
// no iteration and writes out = 0, lse = -1e30.
//
// Full mask (template FMASK): a uint8 mask stored unbroadcast as
// (G, S_q, S_kv), G one of 1, H, B, B*H (gmode 0..3: group 0, bh % heads,
// bh / heads, bh).  Each 64 x 64 mask tile is staged once in shared memory
// beside K and V (4 KB; ragged edges read as 0).  No tile is skipped:
// validity is data.  The mask adds S_q * S_kv bytes per group to the
// function's traffic; at the chunked-prefill shapes (S_q = 32) the K/V
// bytes still dominate.
//
// Additive bias (templates BIAS, KBIAS; the T5 relative-position bias): the
// logits are s * scale + bias before the validity select and the running
// max, as in the TPU kernel's _block_logits.  BIAS: a float32 bias stored
// unbroadcast as (G, S_q, S_kv), group `bgmode` as for the full mask; each
// thread reads its 4 x 4 entries straight from device memory before the
// Q.K^T product, so the loads overlap it (a half-warp reads 16 consecutive
// floats of one row: coalesced).  At the T5 shapes (group h, 8 x 512 x 512
// floats, 8 MB) the bias stays in L2 across the B rows that share it.
// KBIAS: a per-key strip (G, 1, S_kv), four floats a thread a tile.  Either
// composes with key_mask and causal; the causal tile skip is unchanged.
//
// Bias with a full mask (FMASK together with BIAS or KBIAS; XLNet's
// two-stream attention): the mask tile is staged as above and the bias read
// as above, each through its own group mode (`gmode` for the mask, `bgmode`
// for the bias: XLNet's permutation mask is group b, its relative-position
// bias group h, in one launch).  A row the mask hides entirely (the query
// stream's first token of each permutation) outputs 0 with lse = -1e30, as
// without a bias.
//
// Not yet: wgmma / tensor cores (bf16 or TF32 would change the numbers),
// double-buffered K/V staging, skipping key tiles that are entirely masked
// by data (key_mask, full mask: at Longformer's 4096 a row sees 12.6 % of
// the keys and every tile is walked), `lengths` together with another mask.

namespace {

using hetu_flash::group_row;
using hetu_flash::PLD;
using hetu_flash::TILE;
using hetu_flash::TTHREADS;

// G: float4 output column groups per thread (D <= 64 G); BIAS / KBIAS: at
// most one, `bias` then points to the (G, S_q, S_kv) bias or the (G, S_kv)
// strip of group mode `bgmode`
template <int G, bool CAUSAL, bool FMASK, bool BIAS, bool KBIAS>
__global__ void __launch_bounds__(TTHREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ key_mask,
                 const unsigned char* __restrict__ mask, const float* __restrict__ bias,
                 float* __restrict__ out, float* __restrict__ lse, int heads, int gmode,
                 int bgmode, int s_q, int s_kv, int d, float scale) {
  static_assert(!(BIAS && KBIAS), "a dense bias or a key-bias strip, not both");
  using namespace hetu_flash;
  extern __shared__ __align__(16) float smem[];
  const int ld = d + 4;
  float* q_s = smem;              // TILE x ld
  float* k_s = q_s + TILE * ld;   // TILE x ld
  float* v_s = k_s + TILE * ld;   // TILE x ld
  float* p_s = v_s + TILE * ld;   // TILE x PLD probabilities
  int* ok_s = reinterpret_cast<int*>(p_s + TILE * PLD);  // TILE key flags
  unsigned char* msk_s = reinterpret_cast<unsigned char*>(ok_s + TILE);  // TILE x TILE (FMASK)

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* kb = k + (size_t)bh * s_kv * d;
  const float* vb = v + (size_t)bh * s_kv * d;
  const int* km = key_mask ? key_mask + (size_t)(bh / heads) * s_kv : nullptr;
  const unsigned char* mb = nullptr;
  if (FMASK) mb = mask + (size_t)group_row(gmode, bh, heads) * s_q * s_kv;
  const float* bb = nullptr;
  if (BIAS || KBIAS)
    bb = bias + (size_t)group_row(bgmode, bh, heads) * (BIAS ? (size_t)s_q * s_kv : s_kv);
  // causal: row r sees key c iff r + kv_off >= c; the loop stops after the
  // last key that the tile's last row sees
  const int kv_off = s_kv - s_q;
  const int k_end = CAUSAL ? min(s_kv, min(q0 + TILE, s_q) + kv_off) : s_kv;

  stage_rows(q_s, q + (size_t)bh * s_q * d, q0, s_q, d);
  float m[4], l[4];
  float4 acc[4][G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  zero_acc(acc);

  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();  // the previous tile's K, V, P and mask are consumed
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

    float bv[4][4];  // the bias of each score, loaded ahead of the product
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
    float s[4][4];
    dot_rows(s, q_s, k_s, d, ty, tx);
    bool ok[4][4];  // validity per (row, key)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool okj = ok_s[c] != 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool o = okj;
        if (CAUSAL) o = o && (q0 + 4 * ty + i + kv_off >= k0 + c);
        if (FMASK) o = o && msk_s[(4 * ty + i) * TILE + c] != 0;
        ok[i][j] = o;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (BIAS || KBIAS)
          s[i][j] = ok[i][j] ? s[i][j] * scale + bv[i][j] : NEG_INF;
        else
          s[i][j] = ok[i][j] ? s[i][j] * scale : NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(mt));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // select by validity, never exp alone: while a row has seen no
        // valid key, m_new = -1e30 and exp(s - m_new) = 1
        const float p = ok[i][j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        p_s[(4 * ty + i) * PLD + tx + 16 * j] = p;
      }
      l[i] = alpha * l[i] + half_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        acc[i][g].x *= alpha;
        acc[i][g].y *= alpha;
        acc[i][g].z *= alpha;
        acc[i][g].w *= alpha;
      }
    }
    __syncthreads();
    acc_rows(acc, p_s, v_s, d, ty, tx);
  }

  cp_async_wait_all();  // a tile with no live key tile staged Q only
  float l_safe[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) l_safe[i] = l[i] == 0.f ? 1.f : l[i];
  store_rows(out + (size_t)bh * s_q * d, acc, l_safe, q0, s_q, d, ty, tx);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      if (row < s_q) lse[(size_t)bh * s_q + row] = m[i] + logf(l_safe[i]);
    }
  }
}

template <int G, bool CAUSAL, bool FMASK, bool BIAS, bool KBIAS>
int launch_fwd(const float* q, const float* k, const float* v, const int* key_mask,
               const unsigned char* mask, const float* bias, float* out, float* lse, int bh,
               int heads, int gmode, int bgmode, int s_q, int s_kv, int d, float scale,
               cudaStream_t stream) {
  static size_t configured[64] = {0};
  const size_t smem = (size_t)(3 * TILE * (d + 4) + TILE * PLD) * sizeof(float) +
                      TILE * sizeof(int) + (FMASK ? TILE * TILE : 0);
  cudaError_t err = hetu_flash::ensure_smem(
      (const void*)flash_fwd_kernel<G, CAUSAL, FMASK, BIAS, KBIAS>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_q + TILE - 1) / TILE, bh);
  flash_fwd_kernel<G, CAUSAL, FMASK, BIAS, KBIAS><<<grid, TTHREADS, smem, stream>>>(
      q, k, v, key_mask, mask, bias, out, lse, heads, gmode, bgmode, s_q, s_kv, d, scale);
  return (int)cudaGetLastError();
}

template <bool CAUSAL, bool FMASK, bool BIAS = false, bool KBIAS = false>
int dispatch_fwd(const float* q, const float* k, const float* v, const int* key_mask,
                 const unsigned char* mask, const float* bias, float* out, float* lse,
                 int bh, int heads, int gmode, int bgmode, int s_q, int s_kv, int d,
                 float scale, void* stream) {
  if (d <= 0 || d > 128 || (d & 3) || heads <= 0 || bh <= 0 || bh > 65535 ||
      bh % heads || s_q <= 0 || s_kv <= 0 || gmode < 0 || gmode > 3 || bgmode < 0 ||
      bgmode > 3)
    return (int)cudaErrorInvalidValue;
  return d <= 64 ? launch_fwd<1, CAUSAL, FMASK, BIAS, KBIAS>(
                       q, k, v, key_mask, mask, bias, out, lse, bh, heads, gmode, bgmode, s_q,
                       s_kv, d, scale, (cudaStream_t)stream)
                 : launch_fwd<2, CAUSAL, FMASK, BIAS, KBIAS>(
                       q, k, v, key_mask, mask, bias, out, lse, bh, heads, gmode, bgmode, s_q,
                       s_kv, d, scale, (cudaStream_t)stream);
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() after the launch
// (0 = launched).  q (bh, s_q, d), k/v (bh, s_kv, d), out (bh, s_q, d):
// contiguous float32, 16-byte aligned; key_mask (bh / heads, s_kv) int32 or
// null; lse (bh, s_q) float32.

// dense (key_mask null) and key_mask
extern "C" int hetu_flash_fwd(const float* q, const float* k, const float* v,
                              const int* key_mask, float* out, float* lse, int bh, int heads,
                              int s_q, int s_kv, int d, float scale, void* stream) {
  return dispatch_fwd<false, false>(q, k, v, key_mask, nullptr, nullptr, out, lse, bh, heads,
                                    0, 0, s_q, s_kv, d, scale, stream);
}

// causal (bottom-right aligned), optionally with a key_mask
extern "C" int hetu_flash_fwd_causal(const float* q, const float* k, const float* v,
                                     const int* key_mask, float* out, float* lse, int bh,
                                     int heads, int s_q, int s_kv, int d, float scale,
                                     void* stream) {
  return dispatch_fwd<true, false>(q, k, v, key_mask, nullptr, nullptr, out, lse, bh, heads,
                                   0, 0, s_q, s_kv, d, scale, stream);
}

// additive bias: bias is a dense (G, s_q, s_kv) float32 bias or, strip != 0, a
// per-key strip (G, 1, s_kv), of group mode gmode (0..3 as for the full
// mask); optionally with a key_mask and, causal != 0, the causal rule
template <bool BIAS, bool KBIAS>
static int fwd_bias(const float* q, const float* k, const float* v, const int* key_mask,
             const float* bias, float* out, float* lse, int bh, int heads, int s_q, int s_kv,
             int d, int gmode, int causal, float scale, void* stream) {
  return causal ? dispatch_fwd<true, false, BIAS, KBIAS>(q, k, v, key_mask, nullptr, bias, out,
                                                         lse, bh, heads, 0, gmode, s_q, s_kv, d,
                                                         scale, stream)
                : dispatch_fwd<false, false, BIAS, KBIAS>(q, k, v, key_mask, nullptr, bias, out,
                                                          lse, bh, heads, 0, gmode, s_q, s_kv, d,
                                                          scale, stream);
}

extern "C" int hetu_flash_fwd_bias(const float* q, const float* k, const float* v,
                                   const int* key_mask, const float* bias, float* out,
                                   float* lse, int bh, int heads, int s_q, int s_kv, int d,
                                   int gmode, int strip, int causal, float scale,
                                   void* stream) {
  if (bias == nullptr) return (int)cudaErrorInvalidValue;
  return strip ? fwd_bias<false, true>(q, k, v, key_mask, bias, out, lse, bh, heads, s_q, s_kv,
                                       d, gmode, causal, scale, stream)
               : fwd_bias<true, false>(q, k, v, key_mask, bias, out, lse, bh, heads, s_q, s_kv,
                                       d, gmode, causal, scale, stream);
}

// full mask: mask (G, s_q, s_kv) uint8, G = 1, heads, bh / heads or bh for
// gmode 0..3; optionally with an additive bias as hetu_flash_fwd_bias takes
// it, of its own group mode bgmode (bias null: the mask alone; strip != 0:
// the key-bias strip), a key_mask and, causal != 0, the causal rule
template <bool BIAS, bool KBIAS>
static int fwd_mask(const float* q, const float* k, const float* v, const int* key_mask,
                    const unsigned char* mask, const float* bias, float* out, float* lse,
                    int bh, int heads, int s_q, int s_kv, int d, int gmode, int bgmode,
                    int causal, float scale, void* stream) {
  return causal ? dispatch_fwd<true, true, BIAS, KBIAS>(q, k, v, key_mask, mask, bias, out, lse,
                                                        bh, heads, gmode, bgmode, s_q, s_kv, d,
                                                        scale, stream)
                : dispatch_fwd<false, true, BIAS, KBIAS>(q, k, v, key_mask, mask, bias, out,
                                                         lse, bh, heads, gmode, bgmode, s_q,
                                                         s_kv, d, scale, stream);
}

extern "C" int hetu_flash_fwd_mask(const float* q, const float* k, const float* v,
                                   const int* key_mask, const unsigned char* mask,
                                   const float* bias, float* out, float* lse, int bh,
                                   int heads, int s_q, int s_kv, int d, int gmode, int bgmode,
                                   int strip, int causal, float scale, void* stream) {
  if (mask == nullptr) return (int)cudaErrorInvalidValue;
  if (bias == nullptr)
    return fwd_mask<false, false>(q, k, v, key_mask, mask, nullptr, out, lse, bh, heads, s_q,
                                  s_kv, d, gmode, 0, causal, scale, stream);
  return strip ? fwd_mask<false, true>(q, k, v, key_mask, mask, bias, out, lse, bh, heads, s_q,
                                       s_kv, d, gmode, bgmode, causal, scale, stream)
               : fwd_mask<true, false>(q, k, v, key_mask, mask, bias, out, lse, bh, heads, s_q,
                                       s_kv, d, gmode, bgmode, causal, scale, stream);
}
