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
// The copy moves bits: no value is converted, so the result is bit-equal to
// its plain version in either dtype.
//
// The design, for the MoE path's rows (whole 16-byte units on 16-byte-aligned
// buffers: 1 KB bf16, 2 KB float32 at d 512): the Hopper form of the TPU
// kernel's 32 row DMAs in flight a grid step.  A persistent grid from the
// wrapper's plan (gather_plan in ops/kernels/moe_dispatch.py, from shapes,
// alignment and the SM count; it also picks the route) walks blocks of up to
// 32 consecutive output rows, one warp a CTA, and reads each block's indices
// once, in one coalesced load.  A block lands in one of BULK_STAGES
// shared-memory stages by one TMA bulk copy a valid row, the -1 rows zeroed
// there, and leaves in one bulk store of the contiguous output block, so the
// copy engine moves whole rows and no thread holds a byte of them.  Other
// rows (a width whose bytes are not a multiple of 16, an unaligned buffer,
// a block the shared memory cannot hold) take one 16-byte chunk, or one
// value, a thread in a grid-stride loop, each thread loading its row's index.
//
// What was measured (tools/kernel_variants.py gather, PERF.md section 6, on
// an H100 after a filling L2 flush): the chunk-a-thread kernel was this
// gather's only path before, and its note said its 2.6 million chunks of a
// float32 dispatch kept every SM's memory pipeline full.  They did not, but
// bytes in flight were not what held it either: its bf16 times are 38-52 %
// of the bytes bound, and every build measured (16-byte loads from 2-16
// rows in flight a lane, blocks in shared memory or a warp's registers,
// bulk copies through 2-4 stages of 16 or 32 KB) lands within 7 % of it at
// each MoE shape.  The copy sits near the card's floor for these bytes: an
// empty launch of the grid reads 0.005 ms, and writing the bf16 dispatch's
// 20 MB output alone 0.011 ms.  The bulk copies were the fastest at every
// MoE shape (bf16 dispatch 0.0161-0.0167 ms against the chunk kernel's
// 0.0169-0.0170, combine 0.0119-0.0124 against 0.0127); the register route
// (several rows' loads in flight a lane, 0.0171-0.0176 at the bf16
// dispatch) was deleted.
//
// Not yet: the combine gathers each of a token's k routes into its own (s, m)
// tensor, weighted and summed outside the kernel, and its backward gathers the
// same rows again for d_w (the JAX VJP recomputes them too); a fused
// gather-weight-sum kernel would write each token's row once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// The bulk route's shared-memory stages a CTA (a block of rows each).
constexpr int BULK_STAGES = 3;
// The chunk-a-thread route's CTAs, grid-stride beyond MAX_BLOCKS.
constexpr int NTHREADS = 256;
constexpr long long MAX_BLOCKS = 132LL * 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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

// The bulk route: one warp a CTA, at most 32 rows a block (one lane an index).
// Block t of the CTA (blocks blockIdx.x, blockIdx.x + gridDim.x, ...) lands
// in stage t % BULK_STAGES: the warp reads the block's indices in one
// coalesced load, each lane with a valid index issues one cp.async.bulk of
// its row into the stage (the stage's mbarrier expects the valid rows'
// bytes), and the warp zeroes the -1 rows in shared memory; once the stage is
// full, lane 0 stores all its rows in one bulk copy to the block's
// contiguous output.  A stage is refilled only after the bulk store from it
// has read it, so BULK_STAGES - 1 blocks' loads are in flight behind each
// store.  T names the instantiation (float or __nv_bfloat16) in a trace.
template <typename T>
__global__ void __launch_bounds__(32)
row_gather_bulk_kernel(const unsigned char* __restrict__ src, const int* __restrict__ idx,
                       unsigned char* __restrict__ out, long long n, int row_bytes,
                       int rows_per_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x;
  const int stage_bytes = rows_per_block * row_bytes;
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(smem + (size_t)BULK_STAGES * stage_bytes);
  const long long first = blockIdx.x, step = gridDim.x;
  // block t of this CTA starts at row0(t); it exists while row0(t) < n (no
  // division before the first index load)
  auto row0 = [&](int t) { return (first + t * step) * rows_per_block; };
  if (row0(0) >= n) return;
  // this lane's index in block t (-1 past the block or past row n)
  auto index = [&](int t) {
    const long long r = row0(t) + lane;
    return lane < rows_per_block && r < n ? __ldg(idx + r) : -1;
  };
  const int first_index = index(0);  // out before the barriers are set up
  if (lane == 0) {
    for (int s = 0; s < BULK_STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bars + s)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  // block t into its stage, `s` this lane's index there
  auto load = [&](int t, int s) {
    const int rows = (int)min((long long)rows_per_block, n - row0(t));
    const int slot = t % BULK_STAGES;
    unsigned char* st = smem + (size_t)slot * stage_bytes;
    const unsigned valid = __ballot_sync(FULL, s >= 0);
    unsigned zero = __ballot_sync(FULL, lane < rows && s < 0);
    if (lane == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                       smem_u32(bars + slot)),
                   "r"((unsigned)(__popc(valid) * row_bytes))
                   : "memory");
    __syncwarp();
    if (s >= 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_u32(st + lane * row_bytes)),
          "l"(src + (size_t)s * row_bytes), "r"(row_bytes), "r"(smem_u32(bars + slot))
          : "memory");
    for (; zero; zero &= zero - 1) {
      uint4* p = reinterpret_cast<uint4*>(st + (__ffs(zero) - 1) * row_bytes);
      for (int c = lane; c < row_bytes / 16; c += 32) p[c] = make_uint4(0u, 0u, 0u, 0u);
    }
    // the zero rows, written by the threads, before the bulk store reads them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  load(0, first_index);
  for (int t = 1; t < BULK_STAGES - 1 && row0(t) < n; ++t) load(t, index(t));
  for (int t = 0; row0(t) < n; ++t) {
    if (row0(t + BULK_STAGES - 1) < n) {
      const int s = index(t + BULK_STAGES - 1);
      // the stage of block t + BULK_STAGES - 1 was stored from at block t - 1
      if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncwarp();
      load(t + BULK_STAGES - 1, s);
    }
    const int slot = t % BULK_STAGES;
    while (!bar_done(bars + slot, (t / BULK_STAGES) & 1)) {
    }
    __syncwarp();
    if (lane == 0) {
      const long long r0 = row0(t);
      const int rows = (int)min((long long)rows_per_block, n - r0);
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                       out + r0 * row_bytes),
                   "r"(smem_u32(smem + (size_t)slot * stage_bytes)),
                   "r"((unsigned)(rows * row_bytes))
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0);
}

// The chunk-a-thread route.  T is the element type: it sets nothing in the
// copy of 16-byte chunks, and names the instantiation (float or
// __nv_bfloat16) in a profiler's trace.
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
               int ctas, int rows, void* stream) {
  if (n <= 0 || m <= 0 || src_rows < 0 || ctas < 0 || rows < 0 || rows > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long row_bytes = (long long)m * sizeof(T);
  const bool aligned = ((uintptr_t)src % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (ctas > 0) {
    // the bulk route, as the plan chose it: whole 16-byte units on aligned
    // buffers, the stages within the shared memory a CTA can have
    if (rows == 0 || row_bytes % 16 != 0 || !aligned) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)BULK_STAGES * rows * row_bytes +
                        BULK_STAGES * sizeof(unsigned long long);
    cudaError_t err = cudaFuncSetAttribute(row_gather_bulk_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    row_gather_bulk_kernel<T><<<ctas, 32, smem, st>>>(
        reinterpret_cast<const unsigned char*>(src), idx, reinterpret_cast<unsigned char*>(out),
        n, (int)row_bytes, rows);
  } else if (row_bytes % 16 == 0 && aligned) {
    const long long mc = row_bytes / 16;
    row_gather_vec_kernel<T><<<(unsigned)blocks_for(n * mc), NTHREADS, 0, st>>>(
        reinterpret_cast<const uint4*>(src), idx, reinterpret_cast<uint4*>(out), n * mc,
        (int)mc);
  } else {
    row_gather_scalar_kernel<T><<<(unsigned)blocks_for(n * m), NTHREADS, 0, st>>>(
        src, idx, out, n * m, m);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// src (src_rows, m), idx (n,) int32 with every value in [-1, src_rows)
// (negative: a zero row), out (n, m) of src's dtype; all contiguous.  src_rows
// may be 0 when every index is negative.  `ctas` and `rows` are the wrapper's
// plan (gather_plan in ops/kernels/moe_dispatch.py): the bulk route's grid and
// the rows of its blocks (at most 32), or 0 and 0 for the chunk-a-thread
// route.  Each returns a cudaError_t.
extern "C" int hetu_row_gather(const float* src, const int* idx, float* out, long long n, int m,
                               long long src_rows, int ctas, int rows, void* stream) {
  return row_gather<float>(src, idx, out, n, m, src_rows, ctas, rows, stream);
}

extern "C" int hetu_row_gather_bf16(const __nv_bfloat16* src, const int* idx, __nv_bfloat16* out,
                                    long long n, int m, long long src_rows, int ctas, int rows,
                                    void* stream) {
  return row_gather<__nv_bfloat16>(src, idx, out, n, m, src_rows, ctas, rows, stream);
}
