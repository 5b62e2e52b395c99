// Flash attention forward for Hopper (sm_90a), bfloat16 on the tensor cores:
// the `_bf16` C entries hetu_flash_fwd[_causal,_bias,_mask]_bf16, the TPU
// kernel's bf16 instantiation of
// hetu_tpu/ops/pallas/flash_attention.py::_fwd_kernel (launched by
// _flash_fwd).  q, k, v and out are bf16; lse (BH, S_q), the bias and the
// strip float32.  The specializations and their rules are the float32
// kernel's (flash_attention.cu): dense, key_mask, causal (bottom-right
// aligned, key tiles past the diagonal skipped), `lengths` (a nullable
// pointer read once a CTA: the key-tile loop ends at the length, which
// replaces S_kv in the key test of the last tile), a full uint8 mask of group
// mode `gmode`, an additive bias or key-bias strip of group mode `bgmode`,
// alone or together.  A row with no valid key outputs 0 with lse = -1e30.
//
// What bounds it: at the training shapes (S = 512 or 1024, D = 64) the two
// products, 4 * D flops per visible (row, key) pair against a few S * D rows
// of bytes: the tensor cores' 989 TFLOP/s, not the memory.  Design
// (FlashAttention-2's, on mma.sync m16n8k16, flash_mma.cuh): one CTA of 4
// warps per (b*h, 64 query rows), 16 rows a warp.  Q is staged once and held
// in registers as A fragments.  K and V tiles of 64 keys are double-buffered
// in shared memory with cp.async, so the next tile's copy runs under this
// tile's products, with the tile's key-mask words and, with FMASK, its uint8
// mask tile beside them.  S = Q.K^T takes B from K through ldmatrix; the
// flags, the scale and the bias are applied to S in registers at fragment
// coordinates (rows g and g + 8 of the warp, keys 2t, 2t + 1 of each n8
// tile), an invisible pair's logit selected to -inf so that its P is exactly
// 0; the online softmax reduces each row over the 4 lanes of its quad, and
// P = 2^(x log2 e - m log2 e) is one FMA and one ex2.approx (without a bias
// the scale folds into that FMA).
// P stays in registers: the accumulator tiles of S become the A fragments of
// O += P.V, rounded to bf16 on the way (the TPU kernel's p.astype(v.dtype),
// flash_attention.py:238) while the row sum l takes the unrounded P; B comes
// from V through ldmatrix.trans.  out = acc / l is rounded to nearest even.
// The dense bias is read from device memory at fragment coordinates, two
// floats a load, issued before the product so the loads overlap it.
//
// Not yet: wgmma and TMA (warpgroup products from shared memory), a
// persistent grid, skipping key tiles a data mask hides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_mma.cuh"

namespace {

using namespace hetu_mma;

// DMAX: the head dim the instantiation pads to (64 or 128); at 64, three
// CTAs an SM at least (at most 168 registers a thread: without the bound
// the dense-bias instantiation took 175 and ran 2 CTAs an SM, 17 % slower
// at T5's shape on an H100, tools/flash_timings.py).  BIAS / KBIAS: at
// most one, `bias` then points to the (G, S_q, S_kv) bias or the (G, S_kv)
// strip of group mode `bgmode`.  mask_vec: the mask's rows are 16-byte
// aligned (cp.async staging).  lengths (BH / heads) int32 or null: keys at
// or past lengths[bh / heads] are invisible.
template <int DMAX, bool CAUSAL, bool FMASK, bool BIAS, bool KBIAS>
__global__ void __launch_bounds__(NTHREADS, DMAX == 64 ? 3 : 1)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ key_mask,
                     const int* __restrict__ lengths, const unsigned char* __restrict__ mask,
                     const float* __restrict__ bias, bf16* __restrict__ out,
                     float* __restrict__ lse, int heads, int gmode,
                     int bgmode, int s_q, int s_kv, int d, float scale, bool mask_vec) {
  static_assert(!(BIAS && KBIAS), "a dense bias or a key-bias strip, not both");
  constexpr int KS = DMAX / 16;  // k16 steps of Q.K^T, d16 column pairs of P.V
  constexpr int ld = DMAX + 8;   // row stride of a staged tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // 2 buffers of TILE x ld
  bf16* v_s = k_s + 2 * TILE * ld;            // 2 buffers; buffer 1 holds Q first
  int* km_s = reinterpret_cast<int*>(v_s + 2 * TILE * ld);             // 2 x TILE
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
  // keys [0, len) may be visible; causal: row r sees key c iff r + kv_off
  // >= c; the loop stops after the last key that the tile's last row sees
  const int len = lengths ? max(0, min(s_kv, lengths[bh / heads])) : s_kv;
  const int kv_off = s_kv - s_q;
  const int k_end = CAUSAL ? min(len, min(q0 + TILE, s_q) + kv_off) : len;
  const int n_tiles = k_end > 0 ? (k_end + TILE - 1) / TILE : 0;

  auto stage = [&](int t) {
    const int buf = t & 1, k0 = t * TILE;
    stage_rows<DMAX>(k_s + buf * TILE * ld, kb, k0, s_kv, d);
    stage_rows<DMAX>(v_s + buf * TILE * ld, vb, k0, s_kv, d);
    if (km != nullptr && tid < TILE) {
      const bool in = k0 + tid < s_kv;
      cp_async4(km_s + buf * TILE + tid, in ? km + k0 + tid : km, in);
    }
    if constexpr (FMASK) stage_mask(msk_s + buf * TILE * MLD, mb, q0, k0, s_q, s_kv, mask_vec);
  };

  // Q into V's second buffer (tile 1's V overwrites it once Q is in
  // registers), K/V tile 0 into the first; without a key mask both key-flag
  // buffers hold 1s for good
  if (km == nullptr) km_s[tid] = 1;
  stage_rows<DMAX>(v_s + TILE * ld, q + (size_t)bh * s_q * d, q0, s_q, d);
  if (n_tiles > 0) stage(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  unsigned qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm_x4(qf[ks], v_s + TILE * ld + (16 * warp + (lane & 15)) * ld + 16 * ks + (lane >> 4) * 8);

  float o[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // rows g, g + 8 (l: this lane's keys)
  const int r_lo = 16 * warp + g;                      // the lane's first row in the tile
  const bool pair = (s_kv & 1) == 0;
  // the logits x (and m) in units of xs: the raw scores when there is no
  // bias and scale > 0 (the max commutes with the scale, which folds into
  // exp's FMA), else s * scale (+ bias), xs = 1
  const bool raw = !(BIAS || KBIAS) && scale > 0.f;
  const float xs = raw ? scale : 1.f, xl2 = xs * LOG2E;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t + 1 < n_tiles) stage(t + 1);
    cp_async_commit();
    const int buf = t & 1, k0 = t * TILE;
    const bf16* kt = k_s + buf * TILE * ld;
    const bf16* vt = v_s + buf * TILE * ld;

    float bv[8][4];  // the bias of each score, loaded ahead of the product
    if constexpr (BIAS || KBIAS) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = q0 + r_lo + 8 * h, key = k0 + 8 * j + 2 * tq;
          float2 b2 = make_float2(0.f, 0.f);
          if (KBIAS)
            b2 = load_pair(bb, key, s_kv, pair);
          else if (row < s_q)
            b2 = load_pair(bb + (size_t)row * s_kv, key, s_kv, pair);
          bv[j][2 * h] = b2.x;
          bv[j][2 * h + 1] = b2.y;
        }
    }
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        unsigned b[4];
        ldsm_x4(b, kt + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * ld + 16 * ks +
                       ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[ks], b[2], b[3]);
      }

    // Validity selects the logit: an invisible pair is -inf, so P =
    // exp(-inf) = 0 exactly whatever the running max (while a row has seen no
    // valid key, m = -1e30, and an invisible pair at -1e30 would give exp(0)
    // = 1).
    const int* kmt = km_s + buf * TILE;
    const unsigned char* mt = msk_s + buf * TILE * MLD;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c0 = 8 * j + 2 * tq;
      const int2 w = *reinterpret_cast<const int2*>(kmt + c0);
      const bool kv[2] = {c0 < len - k0 && w.x != 0, c0 + 1 < len - k0 && w.y != 0};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r_lo + 8 * (e >> 1), c = c0 + (e & 1);
        bool vis = kv[e & 1];
        if (CAUSAL) vis = vis && (q0 + r + kv_off >= k0 + c);
        if (FMASK) vis = vis && mt[r * MLD + c] != 0;
        float x = s[j][e];
        if constexpr (BIAS || KBIAS)
          x = fmaf(x, scale, bv[j][e]);
        else if (!raw)
          x *= scale;
        s[j][e] = vis ? x : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2], ml[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = exp2_approx((m[h] - m_new) * xl2);
      m[h] = m_new;
      ml[h] = m_new * xl2;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // P = 2^((x - m) xs log2(e)); l sums P as computed
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(fmaf(s[j][e], xl2, -ml[e >> 1]));
        l[e >> 1] += p;
        s[j][e] = p;
      }
    // O += P.V, P rounded to bf16 as it becomes the A operand
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < KS; ++np) {
        unsigned b[4];
        ldsm_x4_trans(b, vt + (16 * kk + (lane & 15)) * ld + 16 * np + (lane >> 4) * 8);
        mma_bf16(o[2 * np], pa, b[0], b[1]);
        mma_bf16(o[2 * np + 1], pa, b[2], b[3]);
      }
    }
  }

  cp_async_wait_all();  // a tile with no live key tile staged Q only
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l_row = quad_sum(l[h]);
    const float inv = l_row == 0.f ? 1.f : 1.f / l_row;
    const int row = q0 + r_lo + 8 * h;
    if (row >= s_q) continue;
    bf16* orow = out + ((size_t)bh * s_q + row) * d;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
      const int col = 8 * n + 2 * tq;
      if (col < d)
        *reinterpret_cast<unsigned*>(orow + col) =
            pack_bf16(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
    }
    if (tq == 0) lse[(size_t)bh * s_q + row] = l_row == 0.f ? NEG_INF : m[h] * xs + logf(l_row);
  }
}

template <int DMAX, bool CAUSAL, bool FMASK, bool BIAS, bool KBIAS>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, const int* key_mask,
               const int* lengths, const unsigned char* mask, const float* bias, bf16* out,
               float* lse, int bh,
               int heads, int gmode, int bgmode, int s_q, int s_kv, int d, float scale,
               cudaStream_t stream) {
  static size_t configured[64] = {0};
  const size_t smem = (size_t)4 * TILE * (DMAX + 8) * sizeof(bf16) + 2 * TILE * sizeof(int) +
                      (FMASK ? 2 * TILE * MLD : 0);
  cudaError_t err = ensure_smem(
      (const void*)flash_fwd_mma_kernel<DMAX, CAUSAL, FMASK, BIAS, KBIAS>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  const bool mask_vec = FMASK && (s_kv & 15) == 0 && ((uintptr_t)mask & 15) == 0;
  const dim3 grid((s_q + TILE - 1) / TILE, bh);
  flash_fwd_mma_kernel<DMAX, CAUSAL, FMASK, BIAS, KBIAS><<<grid, NTHREADS, smem, stream>>>(
      q, k, v, key_mask, lengths, mask, bias, out, lse, heads, gmode, bgmode, s_q, s_kv, d,
      scale, mask_vec);
  return (int)cudaGetLastError();
}

template <bool CAUSAL, bool FMASK, bool BIAS = false, bool KBIAS = false>
int dispatch_fwd(const bf16* q, const bf16* k, const bf16* v, const int* key_mask,
                 const int* lengths, const unsigned char* mask, const float* bias, bf16* out,
                 float* lse, int bh, int heads, int gmode, int bgmode, int s_q, int s_kv, int d,
                 float scale, void* stream) {
  if (bad_shape(bh, heads, s_q, s_kv, d, gmode, bgmode)) return (int)cudaErrorInvalidValue;
  return d <= 64 ? launch_fwd<64, CAUSAL, FMASK, BIAS, KBIAS>(
                       q, k, v, key_mask, lengths, mask, bias, out, lse, bh, heads, gmode, bgmode,
                       s_q, s_kv, d, scale, (cudaStream_t)stream)
                 : launch_fwd<128, CAUSAL, FMASK, BIAS, KBIAS>(
                       q, k, v, key_mask, lengths, mask, bias, out, lse, bh, heads, gmode, bgmode,
                       s_q, s_kv, d, scale, (cudaStream_t)stream);
}

// CAUSAL from the entries' `causal` int
template <bool FMASK, bool BIAS, bool KBIAS>
int fwd_sel(const bf16* q, const bf16* k, const bf16* v, const int* key_mask, const int* lengths,
            const unsigned char* mask, const float* bias, bf16* out, float* lse, int bh,
            int heads, int gmode, int bgmode, int s_q, int s_kv, int d, int causal, float scale,
            void* stream) {
  return causal ? dispatch_fwd<true, FMASK, BIAS, KBIAS>(q, k, v, key_mask, lengths, mask, bias,
                                                         out, lse, bh, heads, gmode, bgmode, s_q,
                                                         s_kv, d, scale, stream)
                : dispatch_fwd<false, FMASK, BIAS, KBIAS>(q, k, v, key_mask, lengths, mask, bias,
                                                          out, lse, bh, heads, gmode, bgmode, s_q,
                                                          s_kv, d, scale, stream);
}

}  // namespace

// The bf16 twins of flash_attention.cu's training entries, with the same
// arguments: each launches on `stream` and returns cudaGetLastError() after
// the launch (0 = launched).  q (bh, s_q, d), k/v (bh, s_kv, d), out (bh,
// s_q, d): contiguous bfloat16, d a multiple of 8 (at most 128), 16-byte
// aligned; key_mask (bh / heads, s_kv) int32 or null; lengths (bh / heads)
// int32 or null; lse (bh, s_q) float32; a bias float32.

// dense (key_mask and lengths null), key_mask and/or lengths
extern "C" int hetu_flash_fwd_bf16(const bf16* q, const bf16* k, const bf16* v,
                                   const int* key_mask, const int* lengths, bf16* out, float* lse,
                                   int bh, int heads, int s_q, int s_kv, int d, float scale,
                                   void* stream) {
  return dispatch_fwd<false, false>(q, k, v, key_mask, lengths, nullptr, nullptr, out, lse, bh,
                                    heads, 0, 0, s_q, s_kv, d, scale, stream);
}

// causal (bottom-right aligned), optionally with a key_mask and lengths
extern "C" int hetu_flash_fwd_causal_bf16(const bf16* q, const bf16* k, const bf16* v,
                                          const int* key_mask, const int* lengths, bf16* out,
                                          float* lse, int bh, int heads, int s_q, int s_kv, int d,
                                          float scale, void* stream) {
  return dispatch_fwd<true, false>(q, k, v, key_mask, lengths, nullptr, nullptr, out, lse, bh,
                                   heads, 0, 0, s_q, s_kv, d, scale, stream);
}

// additive bias: a dense (G, s_q, s_kv) bias or, strip != 0, a per-key strip
// (G, 1, s_kv), of group mode gmode; optionally with a key_mask, lengths and
// causal
extern "C" int hetu_flash_fwd_bias_bf16(const bf16* q, const bf16* k, const bf16* v,
                                        const int* key_mask, const int* lengths,
                                        const float* bias, bf16* out, float* lse, int bh,
                                        int heads, int s_q, int s_kv, int d, int gmode, int strip,
                                        int causal, float scale, void* stream) {
  if (bias == nullptr) return (int)cudaErrorInvalidValue;
  return strip ? fwd_sel<false, false, true>(q, k, v, key_mask, lengths, nullptr, bias, out, lse,
                                             bh, heads, 0, gmode, s_q, s_kv, d, causal, scale,
                                             stream)
               : fwd_sel<false, true, false>(q, k, v, key_mask, lengths, nullptr, bias, out, lse,
                                             bh, heads, 0, gmode, s_q, s_kv, d, causal, scale,
                                             stream);
}

// full mask (G, s_q, s_kv) uint8 of group mode gmode; optionally with a bias
// of its own group mode bgmode (null: none; strip != 0: the key-bias strip),
// a key_mask, lengths and causal
extern "C" int hetu_flash_fwd_mask_bf16(const bf16* q, const bf16* k, const bf16* v,
                                        const int* key_mask, const int* lengths,
                                        const unsigned char* mask, const float* bias, bf16* out,
                                        float* lse, int bh, int heads, int s_q, int s_kv, int d,
                                        int gmode, int bgmode, int strip, int causal,
                                        float scale, void* stream) {
  if (mask == nullptr) return (int)cudaErrorInvalidValue;
  if (bias == nullptr)
    return fwd_sel<true, false, false>(q, k, v, key_mask, lengths, mask, nullptr, out, lse, bh,
                                       heads, gmode, 0, s_q, s_kv, d, causal, scale, stream);
  return strip ? fwd_sel<true, false, true>(q, k, v, key_mask, lengths, mask, bias, out, lse, bh,
                                            heads, gmode, bgmode, s_q, s_kv, d, causal, scale,
                                            stream)
               : fwd_sel<true, true, false>(q, k, v, key_mask, lengths, mask, bias, out, lse, bh,
                                            heads, gmode, bgmode, s_q, s_kv, d, causal, scale,
                                            stream);
}
