// Flash attention forward for Hopper (sm_90a): two kernels that replace
// hetu_tpu/ops/pallas/flash_attention.py::_fwd_kernel (launched by _flash_fwd).
// Both output `out` (BH, S_q, D) and the per-row log-sum-exp `lse` (BH, S_q),
// float32; the bf16 training entries run on the tensor cores
// (flash_attention_bf16.cu).  A row with no valid key outputs 0 with lse =
// -1e30, as the TPU kernel's _finish does.
//
// 1. flash_fwd_lengths_kernel, the `lengths` specialization (decode): for the
//    query rows of (b*h), keys at index >= lengths[b] are invisible.
// 2. flash_fwd_kernel, the dense, `key_mask`, `lengths`, causal, full-mask
//    and additive bias specializations (training and chunked prefill): keys
//    with key_mask[b, j] == 0 or at or past lengths[b] are invisible; under
//    `causal` key c is visible to query row r iff r + (S_kv - S_q) >= c;
//    under a full mask iff mask[g, r, c] != 0.  They compose (logical and);
//    none = dense.  A bias is added to the scaled scores before the
//    validity select.
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

// ---- 2. dense, key_mask, causal, full mask and bias (training, chunked prefill)
//
// What bounds it: at the training shapes (S_q = S_kv = 512, D = 64) every K
// and V row is used by 512 query rows, so the two products' operations, not
// bytes, bound it: 4 * D flops per visible (row, key) pair against about
// 16 * D bytes per row.  The kernel runs in full float32 on the CUDA cores
// (no TF32: the float32 path's numbers are the contract), so it is a
// register-tiled SIMT product, and what decides its speed is how many
// shared-memory reads and instructions each FMA costs, how well the copies
// hide behind the products, and how many tiles it walks.
//
// Layout: one CTA of 128 threads (16 x 8: tx = tid % 16, ty = tid / 16) per
// (b*h, tile of FT = 64 query rows).  Thread (ty, tx) owns query rows ty + 8i
// (i < 8) and, in a 64 x 64 score tile, keys tx + 16j (j < 4): 32 scores, 8
// rows x 4 FMAs for every float4 of Q and of K it reads.  The same thread owns
// the output columns of the float4 groups tx (and tx + 16 at D > 64) of its 8
// rows, so a row's softmax state and its output live in the 16 threads of one
// half-warp, whose row reductions are 4 shuffles.  A grid of fewer than two
// 64-row CTAs an SM (chunked prefill's 32-query chunks, short sequences at
// small batch) takes 32-row CTAs instead, rows ty + 8i for i < 4, twice as
// many CTAs for the same work.  Q, K and V tiles sit in shared memory with a
// row stride of d16 + 4 floats (the head dim rounded up to 16, the pad
// zero), so every product loop unrolls by 16 without a remainder.
//
// Pipeline, per walked key tile t, with one K buffer and one V buffer:
//   wait for K(t) (+ its mask tile and key flags); barrier
//   copy V(t) (and a dense bias tile) with cp.async
//   S = Q K(t)^T in registers; validity; online softmax in base 2 (exp2f,
//     scale * log2 e folded in); P into the warp's own rows of a P tile
//   wait for V(t); barrier
//   copy K(t + 1), its mask tile and flags with cp.async
//   O += P V(t)
// so V's copy hides behind Q K^T and the next K's behind P V, with two
// barriers a tile.  P goes through shared memory, but only through the rows
// of the warp that wrote them: no barrier guards it.  The row sum l is kept
// per thread and reduced once at the end.
//
// Skipping (the data decides which tiles hold work): a plain PyTorch pass
// (ops/kernels/flash_attention.py, tile_maps) reduces the full mask to one
// byte per (group, query tile, key tile), nonzero where a pair is visible.
// Each CTA first lists, in order, the key tiles below its causal end and
// below ceil(lengths[b] / 64) whose byte is nonzero and, with a key mask,
// that hold an unmasked key before the length (a thread a tile reads the
// tile's 64 key-mask words: no launch and no map for it), and walks only
// those: no copy and no product for the others.  The key flags of a walked
// tile fold the length in (a key at or past it reads 0), so the last tile's
// columns past the length are masked at no cost.  `lengths` is a nullable
// pointer read once a CTA, not a template flag: a null one is S_kv.  Causal CTAs take
// their query tiles heaviest first.  A row that sees no key in any walked
// tile outputs 0 with lse = -1e30.
//
// Full mask (FMASK): uint8 (G, S_q, S_kv), group mode gmode (0..3: one, h,
// b, bh -> group 0, bh % heads, bh / heads, bh); each walked tile is copied
// beside K in 16-byte cp.async chunks (byte loads at ragged or unaligned
// edges).  Bias (BIAS: float32 (G, S_q, S_kv) of group mode bgmode): each
// warp copies its own rows of the tile into its rows of the P tile with
// V(t), reads them, and overwrites them with P; the logit is
// s * scale + bias before the validity select, as in the TPU kernel's
// _block_logits.  Key-bias strip (KBIAS: (G, 1, S_kv)): four floats a thread
// a tile, loaded ahead of the product.  Either composes with a full mask,
// key_mask and causal.

namespace {

constexpr int FT = 64;                  // query rows and keys of one tile
constexpr int FTHREADS = 128;           // 16 x 8 threads
constexpr int FPLD = FT + 4;            // row stride of the P tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ void async_copy16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void async_copy4(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + rows) of the row-major (n, d) float32 matrix `src` into
// `dst` (row stride ld), 16 bytes a copy; rows at or past n are zero.
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ src, int r0,
                                           int n, int d, int ld, int rows) {
  const int d4 = d >> 2;
  for (int i = threadIdx.x; i < rows * d4; i += FTHREADS) {
    const int r = i / d4, c = i - r * d4;
    float* s = dst + r * ld + 4 * c;
    if (r0 + r < n)
      async_copy16(s, src + (size_t)(r0 + r) * d + 4 * c);
    else
      *reinterpret_cast<float4*>(s) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The rows x 64 tile at (q0, k0) of one (S_q, S_kv) uint8 mask; ragged
// edges 0.
__device__ __forceinline__ void stage_mask(unsigned char* dst, const unsigned char* __restrict__ mb,
                                           int q0, int k0, int s_q, int s_kv, bool vec,
                                           int rows) {
  for (int i = threadIdx.x; i < rows * FT / 16; i += FTHREADS) {
    const int r = i >> 2, c = 16 * (i & 3);
    const int row = q0 + r, key = k0 + c;
    unsigned char* s = dst + r * FT + c;
    const unsigned char* g = mb + (size_t)row * s_kv + key;
    if (vec && row < s_q && key + 16 <= s_kv) {
      async_copy16(s, g);
    } else {
#pragma unroll
      for (int u = 0; u < 16; ++u) s[u] = (row < s_q && key + u < s_kv) ? g[u] : 0;
    }
  }
}

// This warp's 2R rows (those of its ty 2w and 2w + 1) of the bias tile at
// (q0, k0) into the same rows of p_s (stride FPLD); ragged edges 0.
template <int R>
__device__ __forceinline__ void stage_bias_rows(float* p_s, const float* __restrict__ bb,
                                                int q0, int k0, int s_q, int s_kv, bool vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int it = 0; it < R; ++it) {
    const int idx = it * 32 + lane, rr = idx >> 4, c = 4 * (idx & 15);
    const int r = 2 * warp + (rr & 1) + 8 * (rr >> 1);  // rows ty + 8i of ty 2w, 2w + 1
    const int row = q0 + r, key = k0 + c;
    float* s = p_s + r * FPLD + c;
    const float* g = bb + (size_t)row * s_kv + key;
    if (vec && row < s_q && key + 4 <= s_kv) {
      async_copy16(s, g);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (row < s_q && key + u < s_kv)
          async_copy4(s + u, g + u);
        else
          s[u] = 0.f;
      }
    }
  }
}

__device__ __forceinline__ float half_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void fma4(float4& acc, float p, const float4& m) {
  acc.x = fmaf(p, m.x, acc.x);
  acc.y = fmaf(p, m.y, acc.y);
  acc.z = fmaf(p, m.z, acc.z);
  acc.w = fmaf(p, m.w, acc.w);
}

// R: query rows per thread (8: 64-row CTAs; 4: 32-row CTAs for grids too
// small to fill the card); G: float4 output column groups per thread
// (D <= 64 G).  mask_tiles (G', n_qt, n_kt) of 64 x 64 tiles: one byte per
// tile, 0 where no pair is visible, or null (walk every tile).  BIAS / KBIAS: at
// most one, `bias` then points to the (G', S_q, S_kv) bias or the (G', S_kv)
// strip of group mode `bgmode`.  lengths (BH / heads) int32 or null: keys
// at or past lengths[bh / heads] are invisible.
template <int R, int G, bool CAUSAL, bool FMASK, bool BIAS, bool KBIAS>
__global__ void __launch_bounds__(FTHREADS, R == 8 ? (G == 1 ? 3 : 1) : (G == 1 ? 4 : 2))
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ key_mask,
                 const int* __restrict__ lengths, const unsigned char* __restrict__ mask,
                 const unsigned char* __restrict__ mask_tiles, const float* __restrict__ bias,
                 float* __restrict__ out, float* __restrict__ lse, int heads, int gmode,
                 int bgmode, int s_q, int s_kv, int d, float scale) {
  static_assert(!(BIAS && KBIAS), "a dense bias or a key-bias strip, not both");
  extern __shared__ __align__(16) float smem[];
  const int d16 = (d + 15) & ~15, ld = d16 + 4;
  constexpr int QR = 8 * R;       // query rows of the CTA
  const int n_kt = (s_kv + FT - 1) / FT;
  float* q_s = smem;              // QR x ld
  float* k_s = q_s + QR * ld;     // FT x ld
  float* v_s = k_s + FT * ld;     // FT x ld
  float* p_s = v_s + FT * ld;     // QR x FPLD: P (a dense bias first)
  int* ok_s = reinterpret_cast<int*>(p_s + QR * FPLD);  // FT key flags
  int* wcnt = ok_s + FT;                                // 4 warp counts
  int* walk = wcnt + 4;                                 // n_kt walked key tiles
  unsigned char* msk_s = reinterpret_cast<unsigned char*>(walk + ((n_kt + 3) & ~3));  // QR x FT

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the heaviest causal tiles first
  const int q0 = qt * QR;
  const int d4 = d >> 2;
  const float* kb = k + (size_t)bh * s_kv * d;
  const float* vb = v + (size_t)bh * s_kv * d;
  const int* km = key_mask ? key_mask + (size_t)(bh / heads) * s_kv : nullptr;
  // keys [0, len) may be visible
  const int len = lengths ? max(0, min(s_kv, lengths[bh / heads])) : s_kv;
  const unsigned char* mb = nullptr;
  const unsigned char* mt = nullptr;
  if (FMASK) {
    const int g = hetu_flash::group_row(gmode, bh, heads);
    mb = mask + (size_t)g * s_q * s_kv;
    if (mask_tiles) mt = mask_tiles + ((size_t)g * ((s_q + FT - 1) / FT) + q0 / FT) * n_kt;
  }
  const float* bb = nullptr;
  if (BIAS || KBIAS)
    bb = bias + (size_t)hetu_flash::group_row(bgmode, bh, heads) *
                    (BIAS ? (size_t)s_q * s_kv : (size_t)s_kv);
  const bool mvec = FMASK && (s_kv & 15) == 0 && ((size_t)mask & 15) == 0;
  const bool bvec = BIAS && (s_kv & 3) == 0 && ((size_t)bias & 15) == 0;
  // causal: row r sees key c iff r + kv_off >= c; the walk stops after the
  // last key that the tile's last row sees
  const int kv_off = s_kv - s_q;
  int last = len;  // keys [0, last)
  if (CAUSAL) last = min(last, min(q0 + QR, s_q) + kv_off);
  const int kt_end = last > 0 ? (last + FT - 1) / FT : 0;

  // zero the Q and K pad columns [d, d16) once (cp.async never writes them)
  if (d16 != d) {
    for (int i = tid; i < (QR + FT) * (d16 - d); i += FTHREADS)  // k_s follows q_s
      q_s[(i / (d16 - d)) * ld + d + i % (d16 - d)] = 0.f;
  }

  // the key tiles this CTA walks, in order (a ballot prefix)
  int n_walk = 0;
  for (int base = 0; base < kt_end; base += FTHREADS) {
    const int kt = base + tid;
    bool live = kt < kt_end;
    if (live && mt) live = mt[kt] != 0;
    if (live && km) {  // a tile whose keys are all masked holds no work
      bool any = false;
      const int k0 = kt * FT, kn = min(FT, len - k0);
#pragma unroll 16
      for (int c = 0; c < FT; ++c) any |= c < kn && km[k0 + c] != 0;
      live = any;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    __syncthreads();  // the previous round's counts are read
    if (lane == 0) wcnt[warp] = __popc(bal);
    __syncthreads();
    int at = n_walk;
#pragma unroll
    for (int w = 0; w < FTHREADS / 32; ++w) {
      if (w < warp) at += wcnt[w];
      n_walk += wcnt[w];
    }
    if (live) walk[at + __popc(bal & ((1u << lane) - 1u))] = kt;
  }
  __syncthreads();

  // K(t), its mask tile and its key flags
  auto stage_key_tile = [&](int k0) {
    stage_tile(k_s, kb, k0, s_kv, d, ld, FT);
    if (tid < FT) {
      const int key = k0 + tid;
      if (km != nullptr && key < len)
        async_copy4(ok_s + tid, km + key);
      else
        ok_s[tid] = key < len;
    }
    if (FMASK) stage_mask(msk_s, mb, q0, k0, s_q, s_kv, mvec, QR);
  };

  stage_tile(q_s, q + (size_t)bh * s_q * d, q0, s_q, d, ld, QR);
  if (n_walk > 0) stage_key_tile(walk[0] * FT);
  async_commit();

  const float sl2 = scale * LOG2E;
  const float neg_inf = __int_as_float(0xff800000);  // -inf: exp2 gives 0
  float m[R], l[R];
  float4 acc[R][G];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = hetu_flash::NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) acc[i][g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t = 0; t < n_walk; ++t) {
    const int k0 = walk[t] * FT;
    async_wait<0>();
    __syncthreads();  // K(t) is in; every warp is done with V(t - 1) and its P rows
    if (BIAS) {
      stage_bias_rows<R>(p_s, bb, q0, k0, s_q, s_kv, bvec);
      async_commit();
    }
    stage_tile(v_s, vb, k0, s_kv, d, ld, FT);
    async_commit();

    float kbv[4];  // the strip's values at this thread's keys
    if (KBIAS) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        kbv[j] = key < s_kv ? bb[key] : 0.f;
      }
    }

    // S = Q K^T: rows ty + 8i, keys tx + 16j
    float s[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c0 = 0; c0 < d16; c0 += 16) {
#pragma unroll
      for (int c = c0; c < c0 + 16; c += 4) {
        float4 a[R], b[4];
#pragma unroll
        for (int i = 0; i < R; ++i)
          a[i] = *reinterpret_cast<const float4*>(q_s + (ty + 8 * i) * ld + c);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * ld + c);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float x = s[i][j];
            x = fmaf(a[i].x, b[j].x, x);
            x = fmaf(a[i].y, b[j].y, x);
            x = fmaf(a[i].z, b[j].z, x);
            x = fmaf(a[i].w, b[j].w, x);
            s[i][j] = x;
          }
      }
    }
    if (BIAS) {
      async_wait<1>();  // this warp's bias rows are in (V(t) may not be)
      __syncwarp();
    }

    // logits in base 2 (invalid: -inf, so exp2 gives 0 and no row that has
    // seen no valid key takes a probability from its -1e30 running max);
    // online softmax; P into this warp's rows of p_s
    bool okj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) okj[j] = ok_s[tx + 16 * j] != 0;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 8 * i;
      float mt_ = neg_inf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        bool ok = okj[j];
        if (CAUSAL) ok = ok && (q0 + r + kv_off >= k0 + c);
        if (FMASK) ok = ok && msk_s[r * FT + c] != 0;
        float x = s[i][j] * sl2;
        if (BIAS) x = fmaf(p_s[r * FPLD + c], LOG2E, x);
        if (KBIAS) x = fmaf(kbv[j], LOG2E, x);
        s[i][j] = ok ? x : neg_inf;
        mt_ = fmaxf(mt_, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max16(mt_));
      const float alpha = exp2f(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        psum += p;
        p_s[r * FPLD + tx + 16 * j] = p;
      }
      l[i] = fmaf(alpha, l[i], psum);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        acc[i][g].x *= alpha;
        acc[i][g].y *= alpha;
        acc[i][g].z *= alpha;
        acc[i][g].w *= alpha;
      }
    }

    async_wait<0>();
    __syncthreads();  // V(t) is in; every warp is done with K(t), its mask and flags
    if (t + 1 < n_walk) stage_key_tile(walk[t + 1] * FT);
    async_commit();

    // O += P V(t)
#pragma unroll 4
    for (int key = 0; key < FT; key += 4) {
      float4 p[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        p[i] = *reinterpret_cast<const float4*>(p_s + (ty + 8 * i) * FPLD + key);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int col4 = tx + 16 * g;
        if (col4 < d4) {
          const float* vr = v_s + key * ld + 4 * col4;
          const float4 v0 = *reinterpret_cast<const float4*>(vr);
          const float4 v1 = *reinterpret_cast<const float4*>(vr + ld);
          const float4 v2 = *reinterpret_cast<const float4*>(vr + 2 * ld);
          const float4 v3 = *reinterpret_cast<const float4*>(vr + 3 * ld);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            fma4(acc[i][g], p[i].x, v0);
            fma4(acc[i][g], p[i].y, v1);
            fma4(acc[i][g], p[i].z, v2);
            fma4(acc[i][g], p[i].w, v3);
          }
        }
      }
    }
  }
  async_wait<0>();  // a CTA that walked no tile staged Q only

  float* ob = out + (size_t)bh * s_q * d;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float li = half_sum16(l[i]);
    const int row = q0 + ty + 8 * i;
    if (row >= s_q) continue;
    const float inv = li == 0.f ? 1.f : 1.f / li;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int col4 = tx + 16 * g;
      if (col4 < d4) {
        const float4 a = acc[i][g];
        *reinterpret_cast<float4*>(ob + (size_t)row * d + 4 * col4) =
            make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
      }
    }
    if (tx == 0)
      lse[(size_t)bh * s_q + row] = li == 0.f ? hetu_flash::NEG_INF : m[i] * LN2 + logf(li);
  }
}

template <int R, int G, bool CAUSAL, bool FMASK, bool BIAS, bool KBIAS>
int launch_fwd(const float* q, const float* k, const float* v, const int* key_mask,
               const int* lengths, const unsigned char* mask, const unsigned char* mask_tiles,
               const float* bias,
               float* out, float* lse, int bh, int heads, int gmode, int bgmode, int s_q,
               int s_kv, int d, float scale, cudaStream_t stream) {
  static size_t configured[64] = {0};
  constexpr int QR = 8 * R;
  const int d16 = (d + 15) & ~15, n_kt = (s_kv + FT - 1) / FT;
  const size_t smem = (size_t)((QR + 2 * FT) * (d16 + 4) + QR * FPLD) * sizeof(float) +
                      (FT + 4 + ((n_kt + 3) & ~3)) * sizeof(int) + (FMASK ? QR * FT : 0);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = hetu_flash::ensure_smem(
      (const void*)flash_fwd_kernel<R, G, CAUSAL, FMASK, BIAS, KBIAS>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (s_q + QR - 1) / QR);
  flash_fwd_kernel<R, G, CAUSAL, FMASK, BIAS, KBIAS><<<grid, FTHREADS, smem, stream>>>(
      q, k, v, key_mask, lengths, mask, mask_tiles, bias, out, lse, heads, gmode, bgmode, s_q,
      s_kv, d, scale);
  return (int)cudaGetLastError();
}

// a grid of fewer 64-row CTAs than this an SM takes 32-row ones: at the
// paths' shapes prefill's 96 CTAs and 192 at S = 200 gain, BERT's 384 at
// B = 4 loses (python3 -m hetu_tpu_torch.tools.kernel_variants fwd)
constexpr int WAVE_CTAS = 2;

// The SM count of the current device (read once per device).
inline cudaError_t num_sms(int* out) {
  static int count[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (count[dev] == 0) {
    err = cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *out = count[dev];
  return cudaSuccess;
}

template <bool CAUSAL, bool FMASK, bool BIAS = false, bool KBIAS = false>
int dispatch_fwd(const float* q, const float* k, const float* v, const int* key_mask,
                 const int* lengths, const unsigned char* mask, const unsigned char* mask_tiles,
                 const float* bias, float* out, float* lse, int bh, int heads, int gmode,
                 int bgmode, int s_q, int s_kv, int d, float scale, void* stream) {
  if (hetu_flash::bad_head_dim<float>(d) || heads <= 0 || bh <= 0 || bh % heads || s_q <= 0 ||
      s_kv <= 0 || (s_q + 31) / 32 > 65535 || gmode < 0 || gmode > 3 || bgmode < 0 ||
      bgmode > 3)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = num_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  // 64-row CTAs unless there are too few to keep the card busy (prefill's
  // 32-row chunks, short sequences at small batch): then 32-row ones, twice
  // as many
  const bool small = (long long)bh * ((s_q + FT - 1) / FT) < (long long)WAVE_CTAS * sms;
  cudaStream_t st = (cudaStream_t)stream;
#define HETU_FWD_LAUNCH(R_, G_)                                                               \
  launch_fwd<R_, G_, CAUSAL, FMASK, BIAS, KBIAS>(q, k, v, key_mask, lengths, mask, mask_tiles, \
                                                 bias, out, lse, bh, heads, gmode, bgmode, s_q, \
                                                 s_kv, d, scale, st)
  if (small) return d <= 64 ? HETU_FWD_LAUNCH(4, 1) : HETU_FWD_LAUNCH(4, 2);
  return d <= 64 ? HETU_FWD_LAUNCH(8, 1) : HETU_FWD_LAUNCH(8, 2);
#undef HETU_FWD_LAUNCH
}

// additive bias: a dense (G, s_q, s_kv) bias or, strip != 0, a per-key strip
// (G, 1, s_kv), of group mode gmode; optionally with a key_mask, lengths and,
// causal != 0, the causal rule
template <bool BIAS, bool KBIAS>
int fwd_bias(const float* q, const float* k, const float* v, const int* key_mask,
             const int* lengths, const float* bias, float* out, float* lse, int bh, int heads,
             int s_q, int s_kv, int d, int gmode, int causal, float scale, void* stream) {
  return causal ? dispatch_fwd<true, false, BIAS, KBIAS>(q, k, v, key_mask, lengths, nullptr,
                                                         nullptr, bias, out, lse, bh, heads, 0,
                                                         gmode, s_q, s_kv, d, scale, stream)
                : dispatch_fwd<false, false, BIAS, KBIAS>(q, k, v, key_mask, lengths, nullptr,
                                                          nullptr, bias, out, lse, bh, heads, 0,
                                                          gmode, s_q, s_kv, d, scale, stream);
}

// full mask: mask (G, s_q, s_kv) uint8, G = 1, heads, bh / heads or bh for
// gmode 0..3; optionally with an additive bias as the bias entries take it,
// of its own group mode bgmode, a key_mask, lengths and, causal != 0, the
// causal rule
template <bool BIAS, bool KBIAS>
int fwd_mask(const float* q, const float* k, const float* v, const int* key_mask,
             const int* lengths, const unsigned char* mask, const unsigned char* mask_tiles,
             const float* bias, float* out, float* lse, int bh, int heads, int s_q, int s_kv,
             int d, int gmode, int bgmode, int causal, float scale, void* stream) {
  return causal ? dispatch_fwd<true, true, BIAS, KBIAS>(q, k, v, key_mask, lengths, mask,
                                                        mask_tiles, bias, out, lse, bh, heads,
                                                        gmode, bgmode, s_q, s_kv, d, scale,
                                                        stream)
                : dispatch_fwd<false, true, BIAS, KBIAS>(q, k, v, key_mask, lengths, mask,
                                                         mask_tiles, bias, out, lse, bh, heads,
                                                         gmode, bgmode, s_q, s_kv, d, scale,
                                                         stream);
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() after the launch
// (0 = launched).  q (bh, s_q, d), k/v (bh, s_kv, d), out (bh, s_q, d):
// contiguous float32, 16-byte aligned; key_mask (bh / heads, s_kv) int32 or
// null; lengths (bh / heads) int32 or null (keys at or past lengths[b]
// invisible; <= 0: none visible, >= s_kv: all); lse (bh, s_q) float32; a
// bias float32.  The `_bf16` twins of these entries run on the tensor cores
// (flash_attention_bf16.cu).

// dense (key_mask and lengths null), key_mask and/or lengths
extern "C" int hetu_flash_fwd(const float* q, const float* k, const float* v,
                              const int* key_mask, const int* lengths, float* out, float* lse,
                              int bh, int heads, int s_q, int s_kv, int d, float scale,
                              void* stream) {
  return dispatch_fwd<false, false>(q, k, v, key_mask, lengths, nullptr, nullptr, nullptr, out,
                                    lse, bh, heads, 0, 0, s_q, s_kv, d, scale, stream);
}

// causal (bottom-right aligned), optionally with a key_mask and lengths
extern "C" int hetu_flash_fwd_causal(const float* q, const float* k, const float* v,
                                     const int* key_mask, const int* lengths, float* out,
                                     float* lse, int bh, int heads, int s_q, int s_kv, int d,
                                     float scale, void* stream) {
  return dispatch_fwd<true, false>(q, k, v, key_mask, lengths, nullptr, nullptr, nullptr, out,
                                   lse, bh, heads, 0, 0, s_q, s_kv, d, scale, stream);
}

// an additive bias: a dense bias or (strip != 0) a key-bias strip of group
// mode gmode, with an optional key_mask, lengths and (causal != 0) the causal
// rule
extern "C" int hetu_flash_fwd_bias(const float* q, const float* k, const float* v,
                                   const int* key_mask, const int* lengths, const float* bias,
                                   float* out, float* lse, int bh, int heads, int s_q, int s_kv,
                                   int d, int gmode, int strip, int causal, float scale,
                                   void* stream) {
  if (bias == nullptr) return (int)cudaErrorInvalidValue;
  return strip ? fwd_bias<false, true>(q, k, v, key_mask, lengths, bias, out, lse, bh, heads,
                                       s_q, s_kv, d, gmode, causal, scale, stream)
               : fwd_bias<true, false>(q, k, v, key_mask, lengths, bias, out, lse, bh, heads,
                                       s_q, s_kv, d, gmode, causal, scale, stream);
}

// a full mask of group mode gmode, alone or with a bias (null: none; strip
// != 0: a key-bias strip) of its own group mode bgmode, an optional key_mask,
// lengths and (causal != 0) the causal rule; mask_tiles (G, ceil(s_q / 64),
// ceil(s_kv / 64)) uint8, 0 where a 64 x 64 tile of the mask holds no
// visible pair (tile_maps in ops/kernels/flash_attention.py), or null:
// every tile is walked
extern "C" int hetu_flash_fwd_mask(const float* q, const float* k, const float* v,
                                   const int* key_mask, const int* lengths,
                                   const unsigned char* mask, const unsigned char* mask_tiles,
                                   const float* bias, float* out, float* lse, int bh, int heads,
                                   int s_q, int s_kv, int d, int gmode, int bgmode, int strip,
                                   int causal, float scale, void* stream) {
  if (mask == nullptr) return (int)cudaErrorInvalidValue;
  if (bias == nullptr)
    return fwd_mask<false, false>(q, k, v, key_mask, lengths, mask, mask_tiles, nullptr, out,
                                  lse, bh, heads, s_q, s_kv, d, gmode, 0, causal, scale, stream);
  return strip ? fwd_mask<false, true>(q, k, v, key_mask, lengths, mask, mask_tiles, bias, out,
                                       lse, bh, heads, s_q, s_kv, d, gmode, bgmode, causal, scale,
                                       stream)
               : fwd_mask<true, false>(q, k, v, key_mask, lengths, mask, mask_tiles, bias, out,
                                       lse, bh, heads, s_q, s_kv, d, gmode, bgmode, causal, scale,
                                       stream);
}
