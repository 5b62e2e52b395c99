// MoE row gather for Hopper (sm_90a): out[i] = src[idx[i]], a zero row where
// idx[i] < 0, in float32 (hetu_row_gather) or bfloat16 (hetu_row_gather_bf16):
// the output has src's dtype, as the TPU kernel's does.  Replaces
// hetu_tpu/ops/pallas/moe_dispatch.py::_gather_kernel (launched by
// row_gather): every direction of the sparse MoE dispatch and combine is this
// gather, given the slot->token map (token_of_slot, -1 for an empty slot) or
// the token->slot map (slot_of_token, -1 for a dropped route), so the training
// step needs no scatter and no atomics.  Under bf16 mixed precision one step
// gathers in both dtypes: the expert buffers and their gradients are bf16,
// while the combine's output, and so the gradient its backward gathers, is
// float32 (the gate weights are float32 in both packages).
//
// What bounds it: a pure copy.  Every output row is written once; the rows read
// are the valid indices' rows, plus the int32 indices.  An empty slot's or a
// dropped route's row is written as zeros WITHOUT reading src, so the bytes are
// what this call's routing needs (the TPU kernel skips the DMA the same way).
// The design follows emb_cache.cu: one thread copies one 16-byte chunk of one
// row (4 float32 or 8 bf16 values), so a warp reads and writes whole rows with
// 16-byte accesses (a 512-wide row is 128 chunks in float32, 64 in bf16); the
// index is read once per chunk through the read-only cache, where the threads
// of a row share it.  The copy moves bits: no value is converted, so the result
// is bit-equal to its plain version in either dtype.  The TPU kernel pads the
// index to a multiple of 32 with -1 and keeps 32 row DMAs in flight per grid
// step; here the grid-stride loop needs no padding, and the 2.6 million chunks
// of a float32 dispatch at the MoE configuration keep every SM's memory
// pipeline full by themselves.  Rows whose bytes are not a multiple of 16 (or
// buffers not 16-byte aligned) take the same layout with one value per thread.
//
// Not yet: the combine gathers each of a token's k routes into its own (s, m)
// tensor, weighted and summed outside the kernel, and its backward gathers the
// same rows again for d_w (the JAX VJP recomputes them too); a fused
// gather-weight-sum kernel would write each token's row once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NTHREADS = 256;
constexpr long long MAX_BLOCKS = 132LL * 32;  // grid-stride beyond this

template <typename T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0);
}

// T is the element type: it sets nothing in the copy of 16-byte chunks, and
// names the instantiation (float or __nv_bfloat16) in a profiler's trace.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
row_gather_vec_kernel(const uint4* __restrict__ src, const int* __restrict__ idx,
                      uint4* __restrict__ out, long long n_chunks, int mc) {
  for (long long t = (long long)blockIdx.x * NTHREADS + threadIdx.x; t < n_chunks;
       t += (long long)gridDim.x * NTHREADS) {
    const long long i = t / mc;
    const int c = (int)(t - i * mc);
    const int row = __ldg(idx + i);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row >= 0) v = __ldg(src + (long long)row * mc + c);
    out[t] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
row_gather_scalar_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                         T* __restrict__ out, long long n_elems, int m) {
  for (long long t = (long long)blockIdx.x * NTHREADS + threadIdx.x; t < n_elems;
       t += (long long)gridDim.x * NTHREADS) {
    const long long i = t / m;
    const int c = (int)(t - i * m);
    const int row = __ldg(idx + i);
    T v = zero_value<T>();
    if (row >= 0) v = src[(long long)row * m + c];
    out[t] = v;
  }
}

long long blocks_for(long long threads) {
  const long long b = (threads + NTHREADS - 1) / NTHREADS;
  return b < MAX_BLOCKS ? b : MAX_BLOCKS;
}

template <typename T>
int row_gather(const T* src, const int* idx, T* out, long long n, int m, long long src_rows,
               void* stream) {
  if (n <= 0 || m <= 0 || src_rows < 0) return (int)cudaErrorInvalidValue;
  constexpr int PER_CHUNK = (int)(sizeof(uint4) / sizeof(T));
  const bool vec = (m % PER_CHUNK == 0) && ((uintptr_t)src % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  if (vec) {
    const long long chunks = n * (m / PER_CHUNK);
    row_gather_vec_kernel<T><<<(unsigned)blocks_for(chunks), NTHREADS, 0,
                               (cudaStream_t)stream>>>(reinterpret_cast<const uint4*>(src), idx,
                                                       reinterpret_cast<uint4*>(out), chunks,
                                                       m / PER_CHUNK);
  } else {
    const long long elems = n * m;
    row_gather_scalar_kernel<T><<<(unsigned)blocks_for(elems), NTHREADS, 0,
                                  (cudaStream_t)stream>>>(src, idx, out, elems, m);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// src (src_rows, m), idx (n,) int32 with every value in [-1, src_rows)
// (negative: a zero row), out (n, m) of src's dtype; all contiguous.  src_rows
// may be 0 when every index is negative.  Each returns a cudaError_t.
extern "C" int hetu_row_gather(const float* src, const int* idx, float* out, long long n, int m,
                               long long src_rows, void* stream) {
  return row_gather<float>(src, idx, out, n, m, src_rows, stream);
}

extern "C" int hetu_row_gather_bf16(const __nv_bfloat16* src, const int* idx, __nv_bfloat16* out,
                                    long long n, int m, long long src_rows, void* stream) {
  return row_gather<__nv_bfloat16>(src, idx, out, n, m, src_rows, stream);
}
