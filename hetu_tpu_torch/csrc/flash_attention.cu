// Flash attention forward, `lengths` specialization, written for Hopper (sm_90a).
//
// Replaces hetu_tpu/ops/pallas/flash_attention.py::_fwd_kernel (launched by
// _flash_fwd) with `lengths` set: for the query rows of (b*h), keys at index
// >= lengths[b] are invisible.  Outputs are `out` (BH, S_q, D) and the per-row
// log-sum-exp `lse` (BH, S_q), both float32.  A row with no valid key outputs 0
// with lse = -1e30, as the TPU kernel's _finish does.
//
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

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int BK = 32 * NWARPS;  // keys per shared-memory tile
constexpr int BQ = 4;            // query rows per CTA
constexpr int DMAX = 128;        // largest head dim
constexpr int DPL = DMAX / 32;   // output dims per lane
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

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
