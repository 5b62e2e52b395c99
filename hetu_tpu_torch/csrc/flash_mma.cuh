// Shared pieces of the port's bf16 tensor-core flash kernels (sm_90a):
// flash_attention_bf16.cu (the forward), flash_attention_dq_bf16.cu (dQ) and
// flash_attention_dkv_bf16.cu (dK/dV).  All run their products on
// mma.sync.aligned.m16n8k16 with bf16 operands and float32 accumulators,
// written with inline PTX.
//
// Tile scheme: a CTA of 4 warps owns 64 rows (query rows in the forward and
// dQ, keys in dK/dV), 16 rows a warp, and walks the other side in tiles of 64
// rows staged in shared memory with cp.async, two buffers deep, so the copy
// of the next tile runs under this tile's products.  The head dim is padded
// to the instantiation's DMAX (64 for d <= 64, else 128), so every loop over
// it is unrolled without a branch: a staged bf16 tile has DMAX columns,
// [d, DMAX) zero (zero products), and a row stride of DMAX + 8 values, 16
// bytes of padding a row, so the 8 row addresses of every ldmatrix fall in 8
// distinct 16-byte bank groups.  Rows past the matrix are zero-filled by
// cp.async (source size 0).
//
// Fragments of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//     a3 (g+8, 2t+8..): ldmatrix.x4 of the four 8 x 8 quarters.
//   B (16 x 8, k x n): b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g): from a
//     row-major (n, k) tile with ldmatrix (rows are n), from a row-major
//     (k, n) tile with ldmatrix.trans (rows are k).
//   C (16 x 8, float32): c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
// Two neighbouring n8 C tiles are one k16 A tile: a0 = (c0, c1) of the
// first, a1 = (c2, c3) of the first, a2 and a3 the same of the second; so
// a product's result feeds the next product from registers (pack_bf16 rounds
// it to nearest even on the way, where the TPU kernel rounds its operand).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tile.cuh"  // group_row, ensure_smem, bad_head_dim

namespace hetu_mma {

using bf16 = __nv_bfloat16;
using hetu_flash::ensure_smem;
using hetu_flash::group_row;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int TILE = 64;          // rows of a tile, of a CTA
constexpr int NTHREADS = 128;     // 4 warps of 16 rows
constexpr int MLD = TILE + 16;    // byte row stride of a staged uint8 mask tile

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte (4-byte) async copy; in == false writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b for one 16 x 8 tile, k = 16
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __float22bfloat162_rn(make_float2(lo, hi));
  return *reinterpret_cast<const unsigned*>(&h);
}

// the k16 A fragment made of two neighbouring n8 C tiles, rounded to bf16
__device__ __forceinline__ void c_to_a(unsigned (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// 2^x (x = -inf: 0; a result below 2^-126 flushes to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// reductions over the 4 lanes of a quad (the lanes holding one row of C)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stage rows [r0, r0 + TILE) of the row-major (n, d) bf16 matrix `src` into
// `dst` (row stride DMAX + 8) with cp.async: rows at or past n zero, columns
// [d, DMAX) zero.  Thread i copies the 16-byte chunk i % (DMAX / 8) of every
// (NTHREADS / (DMAX / 8))-th row.  The caller commits, waits and
// synchronises.
template <int DMAX>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int r0,
                                           int n, int d) {
  constexpr int CPR = DMAX / 8, RPP = NTHREADS / CPR, LD = DMAX + 8;
  const int c = threadIdx.x % CPR;
  const bool data = 8 * c < d;
#pragma unroll
  for (int r = threadIdx.x / CPR; r < TILE; r += RPP) {
    bf16* s = dst + r * LD + 8 * c;
    if (data) {
      const bool in = r0 + r < n;
      cp_async16(s, in ? src + (size_t)(r0 + r) * d + 8 * c : src, in);
    } else {
      *reinterpret_cast<uint4*>(s) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Stage the (row r0.., column c0..) TILE x TILE tile of the row-major
// (n_rows, n_cols) uint8 mask `src` into `dst` (row stride MLD bytes); out of
// range reads 0.  vec: every row of `src` is 16-byte aligned (n_cols % 16 ==
// 0 and an aligned base), so whole 16-byte chunks go by cp.async; otherwise
// byte by byte, synchronously.
__device__ __forceinline__ void stage_mask(unsigned char* dst,
                                           const unsigned char* __restrict__ src, int r0,
                                           int c0, int n_rows, int n_cols, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < TILE * (TILE / 16); i += NTHREADS) {
      const int r = i >> 2, c = (i & 3) * 16;
      const bool in = r0 + r < n_rows && c0 + c < n_cols;
      cp_async16(dst + r * MLD + c, in ? src + (size_t)(r0 + r) * n_cols + c0 + c : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < TILE * TILE; i += NTHREADS) {
      const int r = i >> 6, c = i & (TILE - 1);
      dst[r * MLD + c] = (r0 + r < n_rows && c0 + c < n_cols)
                             ? src[(size_t)(r0 + r) * n_cols + c0 + c] : 0;
    }
  }
}

// The two floats of `src` at index i (even) and i + 1, each 0 where it is at
// or past n: one 8-byte load when the row is even (pair), else two.
__device__ __forceinline__ float2 load_pair(const float* __restrict__ src, int i, int n,
                                            bool pair) {
  if (pair) {
    return i < n ? __ldg(reinterpret_cast<const float2*>(src + i)) : make_float2(0.f, 0.f);
  }
  return make_float2(i < n ? __ldg(src + i) : 0.f, i + 1 < n ? __ldg(src + i + 1) : 0.f);
}

// A shape the bf16 kernels take: head dim a multiple of 8 (one 16-byte
// copy), at most 128; the grid's bh at most 65535; group modes 0..3.
inline bool bad_shape(int bh, int heads, int s_q, int s_kv, int d, int gmode, int bgmode) {
  return hetu_flash::bad_head_dim<bf16>(d) || heads <= 0 || bh <= 0 || bh > 65535 || bh % heads ||
         s_q <= 0 || s_kv <= 0 || gmode < 0 || gmode > 3 || bgmode < 0 || bgmode > 3;
}

}  // namespace hetu_mma
