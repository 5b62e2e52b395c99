// MoE row gather for Hopper (sm_90a): out[i] = src[idx[i]], a zero row where
// idx[i] < 0, float32.  Replaces hetu_tpu/ops/pallas/moe_dispatch.py::
// _gather_kernel (launched by row_gather): every direction of the sparse MoE
// dispatch and combine is this gather, given the slot->token map (token_of_slot,
// -1 for an empty slot) or the token->slot map (slot_of_token, -1 for a dropped
// route), so the training step needs no scatter and no atomics.
//
// What bounds it: a pure copy.  Every output row is written once; the rows read
// are the valid indices' rows, plus the int32 indices.  An empty slot's or a
// dropped route's row is written as zeros WITHOUT reading src, so the bytes are
// what this call's routing needs (the TPU kernel skips the DMA the same way).
// The design follows emb_cache.cu: one thread copies one 16-byte chunk of one
// row, so a warp reads and writes whole rows with 16-byte accesses (a 512-wide
// row is 128 chunks, four warps); the index is read once per chunk through the
// read-only cache, where the threads of a row share it.  The TPU kernel pads the
// index to a multiple of 32 with -1 and keeps 32 row DMAs in flight per grid
// step; here the grid-stride loop needs no padding, and the 2.6 million chunks
// of a dispatch at the MoE configuration keep every SM's memory pipeline full by
// themselves.  Widths that are not a multiple of 4 (or buffers not 16-byte
// aligned) take the same layout with one float per thread.
//
// Not yet: the combine gathers each of a token's k routes into its own (s, m)
// tensor, weighted and summed outside the kernel, and its backward gathers the
// same rows again for d_w (the JAX VJP recomputes them too); a fused
// gather-weight-sum kernel would write each token's row once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NTHREADS = 256;
constexpr long long MAX_BLOCKS = 132LL * 32;  // grid-stride beyond this

__global__ void __launch_bounds__(NTHREADS)
row_gather_vec4_kernel(const float4* __restrict__ src, const int* __restrict__ idx,
                       float4* __restrict__ out, long long n_chunks, int m4) {
  for (long long t = (long long)blockIdx.x * NTHREADS + threadIdx.x; t < n_chunks;
       t += (long long)gridDim.x * NTHREADS) {
    const long long i = t / m4;
    const int c = (int)(t - i * m4);
    const int row = __ldg(idx + i);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row >= 0) v = __ldg(src + (long long)row * m4 + c);
    out[t] = v;
  }
}

__global__ void __launch_bounds__(NTHREADS)
row_gather_scalar_kernel(const float* __restrict__ src, const int* __restrict__ idx,
                         float* __restrict__ out, long long n_elems, int m) {
  for (long long t = (long long)blockIdx.x * NTHREADS + threadIdx.x; t < n_elems;
       t += (long long)gridDim.x * NTHREADS) {
    const long long i = t / m;
    const int c = (int)(t - i * m);
    const int row = __ldg(idx + i);
    out[t] = row >= 0 ? __ldg(src + (long long)row * m + c) : 0.f;
  }
}

long long blocks_for(long long threads) {
  const long long b = (threads + NTHREADS - 1) / NTHREADS;
  return b < MAX_BLOCKS ? b : MAX_BLOCKS;
}

}  // namespace

// src (src_rows, m) float32, idx (n,) int32 with every value in [-1, src_rows)
// (negative: a zero row), out (n, m) float32; all contiguous.  src_rows may be 0
// when every index is negative.  Returns a cudaError_t.
extern "C" int hetu_row_gather(const float* src, const int* idx, float* out, long long n, int m,
                               long long src_rows, void* stream) {
  if (n <= 0 || m <= 0 || src_rows < 0) return (int)cudaErrorInvalidValue;
  const bool vec = (m % 4 == 0) && ((uintptr_t)src % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (vec) {
    const long long chunks = n * (m / 4);
    row_gather_vec4_kernel<<<(unsigned)blocks_for(chunks), NTHREADS, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(src), idx, reinterpret_cast<float4*>(out), chunks, m / 4);
  } else {
    const long long elems = n * m;
    row_gather_scalar_kernel<<<(unsigned)blocks_for(elems), NTHREADS, 0,
                               (cudaStream_t)stream>>>(src, idx, out, elems, m);
  }
  return (int)cudaGetLastError();
}
