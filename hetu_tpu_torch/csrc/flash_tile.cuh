// Shared pieces of the port's flash attention kernels (sm_90a): async copies,
// warp reductions, and the 64 x 64 tile scheme of the training kernels.
//
// Tile scheme (flash_fwd_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel):
// a CTA of 256 threads, seen as 16 x 16 with ty = tid / 16 and tx = tid % 16,
// works on tiles of TILE = 64 rows.  Row tiles of Q, K, V and dO are staged in
// shared memory with a row stride of d + 4 floats, so rows stay 16-byte aligned
// for cp.async and float4 reads of 8 consecutive rows hit 8 distinct bank
// groups.  In a 64 x 64 score tile, thread (ty, tx) owns rows 4ty .. 4ty + 3
// and columns tx, tx + 16, tx + 32, tx + 48: the 16 threads of a row group are
// one half-warp, so row reductions are 4 shuffles.  In a 64 x d output tile
// the same thread owns the same rows and the float4 column groups tx and
// tx + 16, so a row's softmax state and its output live in the same thread.
//
// Element type: the kernels built from these SIMT loops are float32 (their
// template parameter T is float); where the TPU kernel's bf16 instantiation
// rounds an operand of a product, they store round_to<T>(x) into the shared
// tile, the identity for float.  The bf16 forward, dQ and dK/dV run on the
// tensor cores (flash_mma.cuh).
#pragma once

#include <cuda_runtime.h>

namespace hetu_flash {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

constexpr int TILE = 64;          // query or key rows of one tile
constexpr int TTHREADS = 256;     // 16 x 16 threads
constexpr int PLD = TILE + 4;     // row stride of a TILE x TILE score tile

// Row of a (G, ...) mask or bias stored unbroadcast for row `bh` of B*H:
// gmode 0..3 (one, h, b, bh) -> 0, bh % heads, bh / heads, bh.
__device__ __forceinline__ int group_row(int gmode, int bh, int heads) {
  return gmode == 0 ? 0 : gmode == 1 ? bh % heads : gmode == 2 ? bh / heads : bh;
}

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

// reductions over the 16 lanes of a row group (one half-warp)
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// x as an operand of a product of T values, rounded to T: for float, x
// itself.
template <typename T>
__device__ __forceinline__ float round_to(float x);

template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}

// Stage rows [r0, r0 + TILE) of the row-major (n, d) matrix `src` into `dst`
// (row stride d + 4) with cp.async; rows at or past n are zero.  The caller
// waits (cp_async_wait_all) and synchronises before reading.
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           int r0, int n, int d) {
  const int d4 = d >> 2, ld = d + 4;
  for (int i = threadIdx.x; i < TILE * d4; i += TTHREADS) {
    const int r = i / d4, c = i - r * d4;
    float* s = dst + r * ld + 4 * c;
    if (r0 + r < n)
      cp_async16(s, src + (size_t)(r0 + r) * d + 4 * c);
    else
      *reinterpret_cast<float4*>(s) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Four consecutive output values at `p` (16-byte aligned).
__device__ __forceinline__ void store4(float* p, const float4& a) {
  *reinterpret_cast<float4*>(p) = a;
}

// acc[i][j] = A[4ty + i, :d] . B[tx + 16j, :d] over two staged row tiles.
__device__ __forceinline__ void dot_rows(float (&acc)[4][4], const float* A, const float* B,
                                         int d, int ty, int tx) {
  const int ld = d + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < d; c += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (4 * ty + i) * ld + c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * ld + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

__device__ __forceinline__ void fma4(float4& acc, float p, const float4& m) {
  acc.x = fmaf(p, m.x, acc.x);
  acc.y = fmaf(p, m.y, acc.y);
  acc.z = fmaf(p, m.z, acc.z);
  acc.w = fmaf(p, m.w, acc.w);
}

// acc[i][g] += sum over key < TILE of P[4ty + i, key] * M[key, 4(tx + 16g) .. +4]
// for a score tile P (stride PLD) and a staged row tile M (stride d + 4).
template <int G>
__device__ __forceinline__ void acc_rows(float4 (&acc)[4][G], const float* P, const float* M,
                                         int d, int ty, int tx) {
  const int ld = d + 4, d4 = d >> 2;
#pragma unroll 2
  for (int key = 0; key < TILE; key += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (4 * ty + i) * PLD + key);
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
        for (int i = 0; i < 4; ++i) {
          fma4(acc[i][g], p[i].x, m0);
          fma4(acc[i][g], p[i].y, m1);
          fma4(acc[i][g], p[i].z, m2);
          fma4(acc[i][g], p[i].w, m3);
        }
      }
    }
  }
}

template <int G>
__device__ __forceinline__ void zero_acc(float4 (&acc)[4][G]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[i][g] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Write rows r0 + 4ty + i (< n) of an output tile held as acc_rows holds it
// into the row-major (n, d) matrix `dst` of T, each row divided by div[i].
template <int G, typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const float4 (&acc)[4][G],
                                           const float (&div)[4], int r0, int n, int d,
                                           int ty, int tx) {
  const int d4 = d >> 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= n) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int col4 = tx + 16 * g;
      if (col4 < d4) {
        const float4 a = acc[i][g];
        store4(dst + (size_t)row * d + 4 * col4,
               make_float4(a.x / div[i], a.y / div[i], a.z / div[i], a.w / div[i]));
      }
    }
  }
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
