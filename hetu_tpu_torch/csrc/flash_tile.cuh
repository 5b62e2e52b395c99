// Shared pieces of the port's float32 flash attention kernels (sm_90a): async
// copies, reductions, and the tile scheme of the training kernels.
//
// Tile scheme (flash_fwd_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel):
// a CTA of FTHREADS = 128 threads, seen as 16 x 8 with tx = tid % 16 and
// ty = tid / 16, works on tiles of FT = 64 query rows or keys.  Row tiles of
// Q, K, V and dO sit in shared memory with a row stride of d16 + 4 floats
// (the head dim rounded up to 16, the pad zero), so rows stay 16-byte aligned
// for cp.async, float4 reads of 8 consecutive rows hit 8 distinct bank
// groups, and every product loop unrolls by 16 without a remainder.  In a
// 64 x 64 score tile thread (ty, tx) owns 8 rows (ty + 8i, or 8ty + i in the
// dK/dV kernel, which owns keys) and the columns tx + 16j (j < 4): 32 scores,
// 8 rows x 4 FMAs for every float4 of each operand it reads.  The 16 threads
// of a row group are one half-warp, so row reductions are 4 shuffles.  In a
// 64 x d output tile the same thread owns the same rows and the float4
// column groups tx (and tx + 16 at D > 64).
//
// Which tiles a CTA walks: each CTA lists, in order and before its first
// copy, the tiles that can hold a visible pair (list_tiles, a ballot prefix),
// and walks only those.
//
// Element type: the float32 kernels built from these loops take a template
// parameter T (float); where the TPU kernel's bf16 instantiation rounds an
// operand of a product they store round_to<T>(x), the identity for float.
// The bf16 kernels run on the tensor cores (flash_mma.cuh).
#pragma once

#include <cuda_runtime.h>

namespace hetu_flash {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

constexpr int FT = 64;         // query rows and keys of one tile
constexpr int FTHREADS = 128;  // 16 x 8 threads
constexpr int FPLD = FT + 4;   // row stride of a 64-column score tile

// Row of a (G, ...) mask or bias stored unbroadcast for row `bh` of B*H:
// gmode 0..3 (one, h, b, bh) -> 0, bh % heads, bh / heads, bh.
__device__ __forceinline__ int group_row(int gmode, int bh, int heads) {
  return gmode == 0 ? 0 : gmode == 1 ? bh % heads : gmode == 2 ? bh / heads : bh;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// reductions over the 16 lanes of a row group (one half-warp)
__device__ __forceinline__ float half_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float half_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ void fma4(float4& acc, float p, const float4& m) {
  acc.x = fmaf(p, m.x, acc.x);
  acc.y = fmaf(p, m.y, acc.y);
  acc.z = fmaf(p, m.z, acc.z);
  acc.w = fmaf(p, m.w, acc.w);
}

// x as an operand of a product of T values, rounded to T: for float, x
// itself.
template <typename T>
__device__ __forceinline__ float round_to(float x);

template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
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
      cp_async16(s, src + (size_t)(r0 + r) * d + 4 * c);
    else
      *reinterpret_cast<float4*>(s) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The rows x 64 tile at (q0, k0) of one (S_q, S_kv) uint8 mask into `dst`
// (row stride ldm bytes, a multiple of 16), 16-byte copies when `vec` (byte
// loads at ragged or unaligned edges); ragged edges 0.
__device__ __forceinline__ void stage_mask(unsigned char* dst, const unsigned char* __restrict__ mb,
                                           int q0, int k0, int s_q, int s_kv, bool vec,
                                           int rows, int ldm = FT) {
  for (int i = threadIdx.x; i < rows * FT / 16; i += FTHREADS) {
    const int r = i >> 2, c = 16 * (i & 3);
    const int row = q0 + r, key = k0 + c;
    unsigned char* s = dst + r * ldm + c;
    const unsigned char* g = mb + (size_t)row * s_kv + key;
    if (vec && row < s_q && key + 16 <= s_kv) {
      cp_async16(s, g);
    } else {
#pragma unroll
      for (int u = 0; u < 16; ++u) s[u] = (row < s_q && key + u < s_kv) ? g[u] : 0;
    }
  }
}

// Four floats of the bias at (row, key) into `s` (16-byte aligned): one
// 16-byte copy when `vec` and inside the matrix, else 4-byte copies and
// zeros past its edges.
__device__ __forceinline__ void stage_bias4(float* s, const float* __restrict__ bb, int row,
                                            int key, int s_q, int s_kv, bool vec) {
  const float* g = bb + (size_t)row * s_kv + key;
  if (vec && row < s_q && key + 4 <= s_kv) {
    cp_async16(s, g);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (row < s_q && key + u < s_kv)
        cp_async4(s + u, g + u);
      else
        s[u] = 0.f;
    }
  }
}

// This warp's 2R rows (those of its ty 2w and 2w + 1: ty + 8i) of the bias
// tile at (q0, k0) into the same rows of p_s (stride FPLD); ragged edges 0.
template <int R>
__device__ __forceinline__ void stage_bias_rows(float* p_s, const float* __restrict__ bb,
                                                int q0, int k0, int s_q, int s_kv, bool vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int it = 0; it < R; ++it) {
    const int idx = it * 32 + lane, rr = idx >> 4, c = 4 * (idx & 15);
    const int r = 2 * warp + (rr & 1) + 8 * (rr >> 1);  // rows ty + 8i of ty 2w, 2w + 1
    stage_bias4(p_s + r * FPLD + c, bb, q0 + r, k0 + c, s_q, s_kv, vec);
  }
}

// The whole FT x FT bias tile at (q0, k0) into p_s (stride FPLD), by every
// thread of the CTA; ragged edges 0.
__device__ __forceinline__ void stage_bias_tile(float* p_s, const float* __restrict__ bb, int q0,
                                                int k0, int s_q, int s_kv, bool vec) {
  for (int i = threadIdx.x; i < FT * FT / 4; i += FTHREADS) {
    const int r = i >> 4, c = 4 * (i & 15);
    stage_bias4(p_s + r * FPLD + c, bb, q0 + r, k0 + c, s_q, s_kv, vec);
  }
}

// The product loops of the backward kernels (flash_attention_bwd.cuh).  The
// forward keeps its own copy of the same two loops: built through these, its
// registers and spills change (one 32-row instantiation starts to spill).
//
// acc[i][j] = A[row(i), :] . B[tx + 16j, :] over two staged row tiles
// (stride ld, d16 columns, the pad zero); row(i) = ty + 8i, or R ty + i with
// BLOCKED.
template <int R, bool BLOCKED>
__device__ __forceinline__ void dot_tile(float (&acc)[R][4], const float* A, const float* B,
                                         int d16, int ld, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int c0 = 0; c0 < d16; c0 += 16) {
#pragma unroll
    for (int c = c0; c < c0 + 16; c += 4) {
      float4 a[R], b[4];
#pragma unroll
      for (int i = 0; i < R; ++i)
        a[i] = *reinterpret_cast<const float4*>(A + (BLOCKED ? R * ty + i : ty + 8 * i) * ld + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * ld + c);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = acc[i][j];
          x = fmaf(a[i].x, b[j].x, x);
          x = fmaf(a[i].y, b[j].y, x);
          x = fmaf(a[i].z, b[j].z, x);
          x = fmaf(a[i].w, b[j].w, x);
          acc[i][j] = x;
        }
    }
  }
}

// acc[i][g] += sum over k < FT of P[row(i), k] * M[k, 4(tx + 16g) .. + 4]
// for a score tile P (stride FPLD) and a staged row tile M (stride ld, d4
// float4 columns); row(i) as in dot_tile.
template <int R, int G, bool BLOCKED>
__device__ __forceinline__ void acc_tile(float4 (&acc)[R][G], const float* P, const float* M,
                                         int d4, int ld, int ty, int tx) {
#pragma unroll 4
  for (int key = 0; key < FT; key += 4) {
    float4 p[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (BLOCKED ? R * ty + i : ty + 8 * i) * FPLD +
                                              key);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int col4 = tx + 16 * g;
      if (col4 < d4) {
        const float* m = M + key * ld + 4 * col4;
        const float4 m0 = *reinterpret_cast<const float4*>(m);
        const float4 m1 = *reinterpret_cast<const float4*>(m + ld);
        const float4 m2 = *reinterpret_cast<const float4*>(m + 2 * ld);
        const float4 m3 = *reinterpret_cast<const float4*>(m + 3 * ld);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          fma4(acc[i][g], p[i].x, m0);
          fma4(acc[i][g], p[i].y, m1);
          fma4(acc[i][g], p[i].z, m2);
          fma4(acc[i][g], p[i].w, m3);
        }
      }
    }
  }
}

// The tiles t in [begin, end) for which live(t) holds, in order, into
// walk[0 .. n); returns n, the same in every thread.  One thread a tile and
// a ballot prefix over the CTA's warps (wcnt: 4 ints of shared memory).  Every
// thread of the CTA must call it; it ends with a barrier.
template <typename Live>
__device__ __forceinline__ int list_tiles(int* walk, int* wcnt, int begin, int end, Live live) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int n = 0;
  for (int base = begin; base < end; base += FTHREADS) {
    const int t = base + tid;
    const bool on = t < end && live(t);
    const unsigned bal = __ballot_sync(FULL, on);
    __syncthreads();  // the previous round's counts are read
    if (lane == 0) wcnt[warp] = __popc(bal);
    __syncthreads();
    int at = n;
#pragma unroll
    for (int w = 0; w < FTHREADS / 32; ++w) {
      if (w < warp) at += wcnt[w];
      n += wcnt[w];
    }
    if (on) walk[at + __popc(bal & ((1u << lane) - 1u))] = t;
  }
  __syncthreads();
  return n;
}

// A head dim the training kernels take for element type T: a multiple of 4
// floats or of 8 bf16 values (one 16-byte load), at most 128.
template <typename T>
inline bool bad_head_dim(int d) {
  return d <= 0 || d > 128 || (d & (16 / (int)sizeof(T) - 1));
}

// Opt a kernel into `bytes` of dynamic shared memory (needed above 48 KB),
// once per device; `configured` is the caller's per-kernel record.
inline cudaError_t ensure_smem(const void* kernel, size_t bytes, size_t (&configured)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (bytes > configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    configured[dev] = bytes;
  }
  return cudaSuccess;
}

}  // namespace hetu_flash
