// Slab row gather for Hopper (sm_90a): out[i] = slab[slots[i]], float32.
// Replaces hetu_tpu/ops/pallas/emb_cache.py::_gather_kernel (launched by
// gather_rows): the device-resident HET embedding cache gathers the batch's
// rows from its (limit + scratch + 1, width) slab by slot index, every slot
// valid (the cache's slot plan guarantees it).
//
// What bounds it: a pure copy.  Every output row is written once, and the
// rows it reads are the distinct slots' rows plus the int32 slots, so the
// kernel is bound by bytes moved, with no arithmetic to speak of.  The design
// follows from that: one thread copies one 16-byte chunk of one row, so the
// threads of a warp read and write whole rows with 16-byte accesses (a row of
// width 16 is four neighbouring threads, one 64-byte segment); the slot is
// read once per chunk through the read-only cache, where the threads of a row
// share it.  The TPU kernel keeps 8 row DMAs in flight per grid step; here the
// 200,000-odd chunks of a CTR batch keep every SM's memory pipeline full by
// themselves.  Widths that are not a multiple of 4 (or buffers not 16-byte
// aligned) take the same layout with one float per thread.
//
// Not yet: nothing skips the repeated rows of a skewed batch (each occurrence
// re-reads its row; L2 absorbs most of it).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NTHREADS = 256;
constexpr long long MAX_BLOCKS = 132LL * 32;  // grid-stride beyond this

__global__ void __launch_bounds__(NTHREADS)
gather_rows_vec4_kernel(const float4* __restrict__ slab, const int* __restrict__ slots,
                        float4* __restrict__ out, long long n_chunks, int w4) {
  for (long long t = (long long)blockIdx.x * NTHREADS + threadIdx.x; t < n_chunks;
       t += (long long)gridDim.x * NTHREADS) {
    const long long i = t / w4;
    const int c = (int)(t - i * w4);
    const long long row = __ldg(slots + i);
    out[t] = __ldg(slab + row * w4 + c);
  }
}

__global__ void __launch_bounds__(NTHREADS)
gather_rows_scalar_kernel(const float* __restrict__ slab, const int* __restrict__ slots,
                          float* __restrict__ out, long long n_elems, int w) {
  for (long long t = (long long)blockIdx.x * NTHREADS + threadIdx.x; t < n_elems;
       t += (long long)gridDim.x * NTHREADS) {
    const long long i = t / w;
    const int c = (int)(t - i * w);
    const long long row = __ldg(slots + i);
    out[t] = __ldg(slab + row * w + c);
  }
}

long long blocks_for(long long threads) {
  const long long b = (threads + NTHREADS - 1) / NTHREADS;
  return b < MAX_BLOCKS ? b : MAX_BLOCKS;
}

}  // namespace

// slab (slab_rows, w) float32, slots (n,) int32 with every value in
// [0, slab_rows), out (n, w) float32; all contiguous.  Returns a cudaError_t.
extern "C" int hetu_emb_gather(const float* slab, const int* slots, float* out, long long n,
                               int w, long long slab_rows, void* stream) {
  if (n <= 0 || w <= 0 || slab_rows <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = (w % 4 == 0) && ((uintptr_t)slab % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (vec) {
    const long long chunks = n * (w / 4);
    gather_rows_vec4_kernel<<<(unsigned)blocks_for(chunks), NTHREADS, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(slab), slots, reinterpret_cast<float4*>(out), chunks,
        w / 4);
  } else {
    const long long elems = n * w;
    gather_rows_scalar_kernel<<<(unsigned)blocks_for(elems), NTHREADS, 0,
                                (cudaStream_t)stream>>>(slab, slots, out, elems, w);
  }
  return (int)cudaGetLastError();
}
