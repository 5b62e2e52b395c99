// Sorted segment row-sum for Hopper (sm_90a): out[s] = sum of rows[i] over
// the i with seg[i] == s, float32, for seg non-decreasing and contiguous from
// 0; rows [U, num_segments) are zero, U = seg[n - 1] + 1.  Replaces
// hetu_tpu/ops/pallas/segment_sum.py::_seg_kernel (launched by
// sorted_segment_sum): the HET grad scatter-add sums the batch's
// per-occurrence embedding gradients into one row per unique key.
//
// What bounds it: each input row is read once and added once, each output
// row written once, so the kernel is bound by bytes moved (about two float
// reads and a tenth of a write per addition).
//
// Design.  The TPU kernel forms each 128-row block's sums as one one-hot
// matmul and carries the open run from block to block through VMEM, which
// needs its sequential grid.  Hopper's blocks run in no order, so nothing is
// carried: the thread of (row r, column c) whose row starts a run (r == 0 or
// seg[r - 1] != seg[r]) finds the run's end in seg and sums the run's column
// c in sorted order, starting from the run's first row, and writes the sum
// once.  No atomics: the result is the same from run to run, and the order of
// the additions is the order of occurrences in the sorted input, which is the
// order scipy's CSR product adds them in on the host (a stable sort keeps each
// segment's occurrences in batch order), so the host cache's _segment_sum and
// this kernel agree bit for bit.  The threads of (r >= U, c) write the zero
// rows.  Neighbouring threads take neighbouring columns, so a run's rows are
// read as contiguous segments.
//
// Cost of skew: a run is summed by its d threads alone, one row after another;
// under Zipf ids the longest run (a field's most frequent id) is hundreds of
// rows, and its threads finish long after the rest.  Splitting long runs
// across threads, with a fixed-order combine to stay deterministic, is left
// for later.

#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;
constexpr long long MAX_BLOCKS = 132LL * 32;  // grid-stride beyond this

__global__ void __launch_bounds__(NTHREADS)
segment_sum_kernel(const float* __restrict__ rows, const int* __restrict__ seg,
                   float* __restrict__ out, long long n, int d, long long num_segments,
                   long long total) {
  const long long used = (long long)__ldg(seg + n - 1) + 1;  // U
  for (long long t = (long long)blockIdx.x * NTHREADS + threadIdx.x; t < total;
       t += (long long)gridDim.x * NTHREADS) {
    const long long r = t / d;
    const int c = (int)(t - r * d);
    if (r < n) {
      const int s = __ldg(seg + r);
      if (r == 0 || __ldg(seg + r - 1) != s) {
        long long e = r + 1;
        while (e < n && __ldg(seg + e) == s) ++e;
        float acc = __ldg(rows + r * d + c);
#pragma unroll 4
        for (long long j = r + 1; j < e; ++j) acc += __ldg(rows + j * d + c);
        if (s >= 0 && s < num_segments) out[(long long)s * d + c] = acc;
      }
    }
    if (r >= used && r < num_segments) out[r * d + c] = 0.f;
  }
}

}  // namespace

// rows (n, d) float32, seg (n,) int32 non-decreasing and contiguous from 0,
// out (num_segments, d) float32; all contiguous, n >= 1.  Returns a
// cudaError_t.
extern "C" int hetu_segment_sum(const float* rows, const int* seg, float* out, long long n,
                                int d, long long num_segments, void* stream) {
  if (n <= 0 || d <= 0 || num_segments <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (n > num_segments ? n : num_segments) * d;
  long long blocks = (total + NTHREADS - 1) / NTHREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  segment_sum_kernel<<<(unsigned)blocks, NTHREADS, 0, (cudaStream_t)stream>>>(
      rows, seg, out, n, d, num_segments, total);
  return (int)cudaGetLastError();
}
