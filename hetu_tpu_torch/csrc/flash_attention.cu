// Flash attention forward for Hopper (sm_90a): kernels that replace
// hetu_tpu/ops/pallas/flash_attention.py::_fwd_kernel (launched by _flash_fwd).
// They output `out` (BH, S_q, D) and the per-row log-sum-exp `lse` (BH, S_q),
// float32; the bf16 training entries run on the tensor cores
// (flash_attention_bf16.cu).  A row with no valid key outputs 0 with lse =
// -1e30, as the TPU kernel's _finish does.
//
// 1. flash_fwd_lengths_kernel and flash_fwd_lengths_merge_kernel, the
//    `lengths` specialization (decode): for the query rows of (b*h), keys at
//    index >= lengths[b] are invisible; the cache is split across CTAs and
//    the splits merged.
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
// byte balance, so the kernel is bound by the K/V bytes it reads (B 8, H 12,
// a full 1024-row cache, D 64: 50 MB, 15 us at 3.35 TB/s).  Its one aim is to
// keep enough of those bytes in flight, on every SM, from start to end.  The
// earlier design (one CTA a (b*h): 96 CTAs, one tile in flight, waited for
// before its scores) took 0.053 ms there on an H100 SXM at 700 W, this one
// 0.028 to 0.029 ms (chip_smoke.py phase 2, tools/flash_timings.py).
//
// Split-KV.  The grid is (BH * S_q, n_split): one CTA of 128 threads per
// (query row, split).  Split s owns the whole key tiles [s * split_tiles,
// (s + 1) * split_tiles) of DT = 64 keys, cut at lengths[b] (clamped to
// [0, S_kv]); a split that starts at or past the length writes an empty
// partial (m = -inf, l = 0) and exits, so keys past the length cost neither
// bytes nor operations.  n_split and split_tiles come from the host's plan
// (ops/kernels/flash_attention.py, decode_split_plan): from the shapes and the
// SM count alone, never from the values of lengths, which live on the card.
// It aims at three CTAs an SM (B 8, H 12, L 1024: 4 splits of 4 tiles, 384
// CTAs on 132 SMs) and keeps a cache of at most three tiles in one split.
//
// Merge.  With one split the CTA writes out and lse itself: one launch.  With
// more, each CTA writes its (m, l, acc[D]) in float32 (m in base 2, acc not
// yet divided by l) to the caller's scratch (BH, n_split, S_q, D + 2), and
// flash_fwd_lengths_merge_kernel, launched behind it on the same stream as
// its programmatic dependent (its launch overlaps the split kernel's run; it
// waits for that grid's end before it reads), merges each row's splits in
// split order, one warp a row, as an online softmax over the splits whose
// loads all go out before any is used; an empty split weighs 0 and a row
// whose splits are all empty outputs 0 with lse = -1e30.  A second launch
// rather than a last-CTA-merges ticket: the ticket needs a counter that
// outlives the call and that every stream launching the kernel would share;
// the merge reads 0.1 MB at the kernels line's shape and costs about 3 us
// there, 1 us less than a plain launch (tools/kernel_variants decode).  No
// atomics anywhere: the output is the same bits from run to run.
//
// Copies.  K and V tiles go through a ring of two slots in shared memory,
// each tile two TMA bulk copies (cp.async.bulk: the K and V rows of a tile
// are contiguous) issued by one thread and reported by the slot's mbarrier:
// tile t + 1 is in flight while tile t is computed, one barrier a tile, and
// no thread spends instructions on addresses.  The copies are marked
// evict-first in L2: the cache is streamed once, so it does not push the
// L2's other lines out (after a fill of the L2 with dirty lines, 3.5 us of
// write-back saved at the kernels line).  A row at or past the split's end
// (the length or the next split) is never copied: the ragged last tile
// copies fewer bytes, its score lanes past the end take -inf and its P.V
// loop stops at the end, so NaN in the cache rows past a length changes no
// output bit.  66 KB of shared memory a CTA at D = 64: three CTAs share an
// SM.  A first design filled the ring with 16-byte cp.async copies by every
// thread into padded rows: 0.8 to 1.1 us slower at the kernels line (the
// same tools/kernel_variants decode, before that route was removed).
//
// Compute, one query row a CTA (no dead rows).  Warp w takes keys [16w,
// 16w + 16) of each tile.  Q.K^T: two lanes a key, lanes l and l + 16 each
// take half the head dim, one shuffle joins them, reading q from shared
// memory and both halves in a rotated order (from column key % half), so
// eight consecutive unpadded rows hit eight distinct bank groups.  Each
// warp keeps its own online-softmax state (scores in base 2, scale * log2 e
// folded in).  P.V: the warp's 16 probabilities go through shared memory;
// lane l owns the float4 column group l % W (W: the head dim's float4 count
// rounded up to a power of two) for the keys of its lane group l / W, so no
// shuffle a key; the lane groups' sums are joined once, at the end, and the
// four warps' states through shared memory.
//
// S_q > 1 (not on the decode path) is correct, not fast: each query row is a
// CTA of its own and reads its keys again.

#include <climits>

#include <cuda_runtime.h>

#include "flash_tile.cuh"

namespace {

using namespace hetu_flash;

constexpr int DT = FT;       // keys of a decode tile
constexpr int DSTAGES = 2;   // tiles of the K/V ring
constexpr int DWKEYS = 16;   // keys a warp takes of each tile
constexpr int DWARPS = FTHREADS / 32;
static_assert(DWARPS * DWKEYS == DT, "the warps cover a tile");
// The merge kernel launched as a programmatic dependent of the split kernel,
// so its launch overlaps the split kernel's run (false: a plain launch, the
// variant tools/kernel_variants times).
constexpr bool DECODE_PDL = true;

// Shared memory of the split kernel: the K and V rings (unpadded rows), q,
// the warps' probabilities, the warps' states (m, l, pad, pad, acc[d]), an
// mbarrier a ring slot.
inline size_t decode_smem(int d) {
  return (size_t)(2 * DSTAGES * DT * d + d + DT + DWARPS * (d + 4)) * sizeof(float) +
         DSTAGES * sizeof(unsigned long long);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// `bytes` from global `src` into shared `dst` (both 16-byte aligned, a
// multiple of 16 bytes) by one TMA bulk copy under the L2 `policy`,
// completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar, unsigned long long policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ bool bar_done(unsigned long long* bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// DMAX: the largest head dim of the instantiation (64 or 128): a lane's
// half of q . k takes at most DMAX / 8 float4s.
template <int DMAX>
__global__ void __launch_bounds__(FTHREADS, 3)
flash_fwd_lengths_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ lengths,
                         float* __restrict__ out, float* __restrict__ lse,
                         float* __restrict__ part, int heads, int s_q, int s_kv, int d,
                         int split_tiles, float scale) {
  constexpr int QH = DMAX / 8;
  extern __shared__ __align__(16) float smem[];
  const int d4 = d >> 2;
  float* k_s = smem;                    // DSTAGES x DT x d
  float* v_s = k_s + DSTAGES * DT * d;  // DSTAGES x DT x d
  float* q_s = v_s + DSTAGES * DT * d;  // d
  float* p_s = q_s + d;                 // DT probabilities, 16 a warp
  float* red = p_s + DT;                // DWARPS x (d + 4)
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(red + DWARPS * (d + 4));

  // the merge (if any) may launch now: it waits for this grid's end
  if (DECODE_PDL) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int row = blockIdx.x;  // bh * s_q + query row
  const int split = blockIdx.y, n_split = gridDim.y;
  const int bh = row / s_q;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* pr = n_split > 1
                  ? part + (((size_t)bh * n_split + split) * s_q + (row - bh * s_q)) * (d + 2)
                  : nullptr;  // this CTA's partial

  const int len = max(0, min(s_kv, lengths[bh / heads]));
  const int k_begin = split * split_tiles * DT;
  const int k_end = min(len, k_begin + split_tiles * DT);  // keys [k_begin, k_end)
  if (n_split > 1 && k_begin >= len) {                     // an empty split
    if (tid == 0) {
      pr[0] = __int_as_float(0xff800000);  // -inf
      pr[1] = 0.f;
    }
    return;
  }
  const int nt = k_end > k_begin ? (k_end - k_begin + DT - 1) / DT : 0;
  const float* kb = k + (size_t)bh * s_kv * d;
  const float* vb = v + (size_t)bh * s_kv * d;
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  // tile t into ring slot t % DSTAGES, by thread 0; the ragged last tile's
  // rows past k_end are not copied (and never read)
  auto stage = [&](int t) {
    const int slot = t % DSTAGES, off = slot * DT * d, k0 = k_begin + t * DT;
    const unsigned bytes = (unsigned)(min(DT, k_end - k0) * d * sizeof(float));
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_u32(bars + slot)),
                 "r"(2 * bytes)
                 : "memory");
    bulk_copy(k_s + off, kb + (size_t)k0 * d, bytes, bars + slot, policy);
    bulk_copy(v_s + off, vb + (size_t)k0 * d, bytes, bars + slot, policy);
  };

  // this lane's half of q: float4 groups [c_base, c_base + c_cnt)
  const int half = lane >> 4, h0 = (d4 + 1) >> 1;
  const int c_base = half ? h0 : 0, c_cnt = half ? d4 - h0 : h0;
  const int key = DWKEYS * warp + (lane & 15);  // this lane's key in a tile (Q.K^T)
  if (tid == 0) {
    for (int s = 0; s < DSTAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bars + s)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < DSTAGES - 1 && t < nt; ++t) stage(t);
  }
  for (int i = tid; i < d4; i += FTHREADS)
    reinterpret_cast<float4*>(q_s)[i] = reinterpret_cast<const float4*>(q + (size_t)row * d)[i];
  __syncthreads();  // the mbarriers are set up before any thread waits on them
  // each lane reads its half of q and of k in a rotated order (from column
  // key % c_cnt), so the unpadded rows of 8 consecutive keys hit 8 distinct
  // bank groups
  const int rot0 = c_cnt > 0 ? key % c_cnt : 0;

  // P.V lanes: W lanes a group own the float4 columns; group g takes the
  // warp's keys [g * kpg, (g + 1) * kpg) of each tile
  int W = 2;
  while (W < d4) W <<= 1;
  const int kpg = DWKEYS * W / 32, g = lane / W, col4 = lane % W;
  const float sl2 = scale * LOG2E;

  float m_w = NEG_INF, l_w = 0.f;  // the warp's running max (base 2) and sum
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = 0; t < nt; ++t) {
    const int k0 = k_begin + t * DT, off = (t % DSTAGES) * DT * d;
    while (!bar_done(bars + t % DSTAGES, (t / DSTAGES) & 1)) {
    }
    __syncthreads();  // every warp is done with tile t - 1
    if (tid == 0 && t + DSTAGES - 1 < nt) stage(t + DSTAGES - 1);

    // S: this lane's half of q . k, joined with lane l ^ 16's
    const float* kr = k_s + off + key * d + 4 * c_base;
    const float* qh = q_s + 4 * c_base;
    float s = 0.f;
    int c = rot0;
#pragma unroll
    for (int i = 0; i < QH; ++i) {
      if (i < c_cnt) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + 4 * c);
        const float4 qq = *reinterpret_cast<const float4*>(qh + 4 * c);
        s = fmaf(qq.x, kv.x, s);
        s = fmaf(qq.y, kv.y, s);
        s = fmaf(qq.z, kv.z, s);
        s = fmaf(qq.w, kv.w, s);
        if (++c == c_cnt) c = 0;
      }
    }
    s += __shfl_xor_sync(FULL, s, 16);
    // online softmax over the warp's 16 keys; a key at or past k_end scores
    // -inf, so exp2 gives it 0 against the finite running max
    const float x = k0 + key < k_end ? s * sl2 : __int_as_float(0xff800000);
    const float m_new = fmaxf(m_w, half_max16(x));
    const float alpha = exp2f(m_w - m_new);
    const float p = exp2f(x - m_new);
    l_w = fmaf(alpha, l_w, half_sum16(p));
    m_w = m_new;
    acc.x *= alpha;
    acc.y *= alpha;
    acc.z *= alpha;
    acc.w *= alpha;
    if (lane < 16) p_s[DWKEYS * warp + lane] = p;
    __syncwarp();

    // O += P V over this lane group's keys below k_end
    const int k1 = DWKEYS * warp + g * kpg;  // the group's first key in the tile
    const int nv = min(kpg, k_end - k0 - k1);
    if (col4 < d4) {
      const float* pw = p_s + k1;
      const float* vw = v_s + off + k1 * d + 4 * col4;
#pragma unroll 8
      for (int i = 0; i < nv; ++i)
        fma4(acc, pw[i], *reinterpret_cast<const float4*>(vw + i * d));
    }
  }

  // join the lane groups' sums, then the warps' states
  for (int o = W; o < 32; o <<= 1) {
    acc.x += __shfl_xor_sync(FULL, acc.x, o);
    acc.y += __shfl_xor_sync(FULL, acc.y, o);
    acc.z += __shfl_xor_sync(FULL, acc.z, o);
    acc.w += __shfl_xor_sync(FULL, acc.w, o);
  }
  const int rs = d + 4;
  if (lane == 0) {
    red[warp * rs] = m_w;
    red[warp * rs + 1] = l_w;
  }
  if (lane < d4) *reinterpret_cast<float4*>(red + warp * rs + 4 + 4 * lane) = acc;
  __syncthreads();
  if (tid >= d4) return;
  float mx = NEG_INF;
#pragma unroll
  for (int w = 0; w < DWARPS; ++w) mx = fmaxf(mx, red[w * rs]);
  float sum = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int w = 0; w < DWARPS; ++w) {
    const float f = exp2f(red[w * rs] - mx);
    sum = fmaf(f, red[w * rs + 1], sum);
    fma4(o, f, *reinterpret_cast<const float4*>(red + w * rs + 4 + 4 * tid));
  }
  if (n_split == 1) {
    const float l_safe = sum == 0.f ? 1.f : sum;
    *reinterpret_cast<float4*>(out + (size_t)row * d + 4 * tid) =
        make_float4(o.x / l_safe, o.y / l_safe, o.z / l_safe, o.w / l_safe);
    if (tid == 0) lse[row] = sum == 0.f ? NEG_INF : mx * LN2 + logf(sum);
  } else {
    if (tid == 0) {
      pr[0] = mx;
      pr[1] = sum;
    }
    pr[2 + 4 * tid] = o.x;
    pr[3 + 4 * tid] = o.y;
    pr[4 + 4 * tid] = o.z;
    pr[5 + 4 * tid] = o.w;
  }
}

// One warp a row of BH * S_q: the row's n_split partials, in split order,
// as an online softmax over the splits.  Nothing waits on a load's value
// before the next split's loads go out (an unrolled loop, the empty splits
// dropped by selects), so four splits cost one trip to L2.  An empty split
// (m = -inf, l = 0) weighs 0, and its acc, never written, is selected away.
__global__ void __launch_bounds__(FTHREADS)
flash_fwd_lengths_merge_kernel(const float* __restrict__ part, float* __restrict__ out,
                               float* __restrict__ lse, int rows, int s_q, int d, int n_split) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the split kernel's partials are in
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * DWARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int bh = row / s_q;
  const size_t stride = (size_t)s_q * (d + 2);  // from one split's partial to the next
  const float* pr = part + ((size_t)bh * n_split * s_q + (row - bh * s_q)) * (d + 2);
  float mx = NEG_INF, sum = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) {
    const float* ps = pr + s * stride;
    const float m = ps[0], l = ps[1];
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = lane + 32 * i < d ? ps[2 + lane + 32 * i] : 0.f;
    const float mn = fmaxf(mx, m);  // an empty split's -inf leaves mx as it is
    const float fo = exp2f(mx - mn), fs = exp2f(m - mn);
    const bool live = l > 0.f;
    sum = fmaf(fo, sum, live ? fs * l : 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = live ? fmaf(fs, a[i], fo * o[i]) : o[i];
    mx = mn;
  }
  const float l_safe = sum == 0.f ? 1.f : sum;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (lane + 32 * i < d) out[(size_t)row * d + lane + 32 * i] = o[i] / l_safe;
  if (lane == 0) lse[row] = sum == 0.f ? NEG_INF : mx * LN2 + logf(sum);
}

template <int DMAX>
int launch_lengths(const float* q, const float* k, const float* v, const int* lengths,
                   float* out, float* lse, float* part, int rows, int heads, int s_q, int s_kv,
                   int d, int n_split, int split_tiles, float scale, cudaStream_t stream) {
  static size_t configured[64] = {0};
  const size_t smem = decode_smem(d);
  cudaError_t err =
      ensure_smem((const void*)flash_fwd_lengths_kernel<DMAX>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_lengths_kernel<DMAX><<<dim3(rows, n_split), FTHREADS, smem, stream>>>(
      q, k, v, lengths, out, lse, part, heads, s_q, s_kv, d, split_tiles, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + DWARPS - 1) / DWARPS);
  cfg.blockDim = dim3(FTHREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = DECODE_PDL ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, flash_fwd_lengths_merge_kernel, (const float*)part, out, lse,
                           rows, s_q, d, n_split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the last launch (0 =
// launched).  q (bh, s_q, d), k/v (bh, s_kv, d), out (bh, s_q, d):
// contiguous float32, 16-byte aligned; lengths (bh / heads) int32; lse
// (bh, s_q) float32.  The plan (n_split, split_tiles) must cover s_kv
// (n_split * split_tiles * 64 >= s_kv); with n_split > 1, part is float32
// scratch of (bh, n_split, s_q, d + 2) and the merge kernel follows the split
// kernel on the stream.
extern "C" int hetu_flash_fwd_lengths(const float* q, const float* k, const float* v,
                                      const int* lengths, float* out, float* lse, float* part,
                                      int bh, int heads, int s_q, int s_kv, int d, int n_split,
                                      int split_tiles, float scale, void* stream) {
  if (hetu_flash::bad_head_dim<float>(d) || heads <= 0 || bh <= 0 || bh % heads || s_q <= 0 ||
      s_kv < 0 || (long long)bh * s_q > INT_MAX || n_split < 1 || n_split > 65535 ||
      split_tiles < 1 || (long long)n_split * split_tiles * DT < s_kv ||
      (long long)n_split * split_tiles * DT > INT_MAX || (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int rows = bh * s_q;
  cudaStream_t st = (cudaStream_t)stream;
  return d <= 64 ? launch_lengths<64>(q, k, v, lengths, out, lse, part, rows, heads, s_q, s_kv,
                                      d, n_split, split_tiles, scale, st)
                 : launch_lengths<128>(q, k, v, lengths, out, lse, part, rows, heads, s_q, s_kv,
                                       d, n_split, split_tiles, scale, st);
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

using namespace hetu_flash;

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
    const int g = group_row(gmode, bh, heads);
    mb = mask + (size_t)g * s_q * s_kv;
    if (mask_tiles) mt = mask_tiles + ((size_t)g * ((s_q + FT - 1) / FT) + q0 / FT) * n_kt;
  }
  const float* bb = nullptr;
  if (BIAS || KBIAS)
    bb = bias + (size_t)group_row(bgmode, bh, heads) *
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

  // the key tiles this CTA walks, in order
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

  // K(t), its mask tile and its key flags
  auto stage_key_tile = [&](int k0) {
    stage_tile(k_s, kb, k0, s_kv, d, ld, FT);
    if (tid < FT) {
      const int key = k0 + tid;
      if (km != nullptr && key < len)
        cp_async4(ok_s + tid, km + key);
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
    m[i] = NEG_INF;
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
      lse[(size_t)bh * s_q + row] = li == 0.f ? NEG_INF : m[i] * LN2 + logf(li);
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
  cudaError_t err = ensure_smem(
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
  if (bad_head_dim<float>(d) || heads <= 0 || bh <= 0 || bh % heads || s_q <= 0 ||
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
