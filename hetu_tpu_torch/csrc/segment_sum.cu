// Sorted segment row-sum for Hopper (sm_90a): out[s] = sum of rows[i] over
// the i with seg[i] == s, float32, for seg non-decreasing and contiguous from
// 0; rows [U, num_segments) are zero, U = seg[n - 1] + 1.  Replaces
// hetu_tpu/ops/pallas/segment_sum.py::_seg_kernel (launched by
// sorted_segment_sum): the HET grad scatter-add sums the batch's
// per-occurrence embedding gradients into one row per unique key.
//
// What bounds it: each input row is read once and added once, each output
// row written once, so the function is bound by bytes moved (about two float
// reads and a tenth of a write per addition).  What held the first design
// back was neither: under Zipf ids one run (a field's most frequent id) is
// hundreds of rows, and its d threads walked it alone, first scanning seg for
// the run's end one load at a time, then summing with a few loads in flight,
// so the kernel took that run's chain of load latencies.
//
// Order of the additions (the contract): the thread of (segment s, column c)
// adds the run's rows in sorted order, starting from the run's first row, and
// writes the sum once.  No atomics on values: the result is the same from run
// to run, and it is the order of occurrences in the sorted input, which is the
// order scipy's CSR product adds them in on the host (a stable sort keeps each
// segment's occurrences in batch order), so the host cache's _segment_sum and
// this kernel agree bit for bit.  The design changes only how the rows reach
// that thread.  One launch, two kinds of CTA:
//
// - Long runs.  The first ceil(n / SPAN) CTAs each look at SPAN rows for the
//   starts of runs of at least LONG_RUN rows (seg is sorted, so a run that
//   starts at r is that long iff seg[r + LONG_RUN - 1] == seg[r]).  A run's
//   rows are contiguous in memory: the CTA copies its long runs into shared
//   memory with cp.async as one stream of chunks, the next chunk in flight
//   while its d column threads add the current one in order.  A run ends at
//   the next run start among the CTA's rows; only the last run's end past
//   them is searched, NTHREADS rows a step (one load each thread and a barrier
//   count, no serial scan).  These CTAs come first in the grid, so the
//   longest chains start first.
// - Short runs and zero rows.  The other CTAs take one thread per (row,
//   four columns): a thread whose row starts a short run reads the next
//   LONG_RUN - 1 ids at once for the run's end, then sums the run with all
//   its float4 loads in flight before the adds.  Threads of rows in
//   [U, num_segments) write the zero rows.  Neighbouring threads take
//   neighbouring columns, so a run's rows are read as contiguous segments.
//   A width that is not a multiple of 4 takes one column a thread; rows
//   wider than a CTA have no long path, and their threads read ids
//   LONG_RUN at a time to the end of any run.
// A long run then costs one add per row at shared-memory latency, instead of
// one load latency per few rows.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int LONG_RUN = 16;    // rows: a run this long is summed by a whole CTA
constexpr int SPAN = 64;        // rows a long-run CTA looks at for run starts
constexpr int CHUNK = 2048;     // floats of one staged chunk; two in flight
constexpr long long MAX_BLOCKS = 132LL * 32;  // short path: grid-stride beyond this

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy floats [i0, i0 + cnt) of src into dst: 16-byte copies when `vec`
// (src 16-byte aligned, i0 and cnt multiples of 4), else 4-byte ones.
__device__ __forceinline__ void stage(float* dst, const float* src, long long i0, int cnt,
                                      bool vec) {
  if (vec) {
    for (int i = 4 * threadIdx.x; i < cnt; i += 4 * NTHREADS) cp_async16(dst + i, src + i0 + i);
  } else {
    for (int i = threadIdx.x; i < cnt; i += NTHREADS) cp_async4(dst + i, src + i0 + i);
  }
}

constexpr int NO_LONG_PATH = 0x7fffffff;

// Lowest thread index above `after` whose flag is set, over the CTA, from
// the per-warp ballots in `masks`; -1 if none.
__device__ __forceinline__ int lowest_after(const unsigned* masks, int after) {
  const int w0 = (after + 1) >> 5;
  for (int w = w0; w < NTHREADS / 32; ++w) {
    unsigned m = masks[w];
    if (w == w0) m &= ~0u << ((after + 1) & 31);
    if (m) return 32 * w + __ffs(m) - 1;
  }
  return -1;
}

// The runs of at least LONG_RUN rows that start in rows [r0, r0 + SPAN),
// in row order, as one stream of chunks of rows_per_chunk rows: the CTA
// copies chunk i + 1 (of whichever run) with cp.async while its d column
// threads add chunk i in order; a run's sum starts from its first row and
// is written after its last chunk.  A run ends at the next run start among
// the CTA's rows; only the last run's end past them is searched, NTHREADS rows
// a step (one load each thread and a barrier count).  d <= NTHREADS.
__device__ void long_runs(const float* __restrict__ rows, const int* __restrict__ seg,
                          float* __restrict__ out, long long n, int d, long long num_segments,
                          long long r0) {
  __shared__ __align__(16) float buf[2][CHUNK];
  __shared__ int run_b[SPAN], run_e[SPAN], run_s[SPAN];
  __shared__ unsigned masks[2][NTHREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // run starts and long run starts among this CTA's rows
  const long long r = r0 + tid;
  int s = -1;
  bool start = false, is_long = false;
  if (tid < SPAN && r < n) {  // three loads in one round
    s = __ldg(seg + r);
    const int prev = r > 0 ? __ldg(seg + r - 1) : 0;
    const int tail = r + LONG_RUN - 1 < n ? __ldg(seg + r + LONG_RUN - 1) : 0;
    start = r == 0 || prev != s;
    is_long = start && r + LONG_RUN - 1 < n && tail == s;
  }
  const unsigned start_mask = __ballot_sync(0xffffffffu, start);
  const unsigned long_mask = __ballot_sync(0xffffffffu, is_long);
  if (lane == 0) {
    masks[0][warp] = start_mask;
    masks[1][warp] = long_mask;
  }
  __syncthreads();
  int at = 0, count = 0;
  for (int w = 0; w < NTHREADS / 32; ++w) {
    if (w < warp) at += __popc(masks[1][w]);
    count += __popc(masks[1][w]);
  }
  if (count == 0) return;  // uniform
  bool past = false;  // this long run reaches past the CTA's rows
  if (is_long) {
    at += __popc(long_mask & ((1u << lane) - 1u));
    const int next = lowest_after(masks[0], tid);
    run_b[at] = (int)r;
    run_s[at] = s;
    run_e[at] = next >= 0 ? (int)(r0 + next) : -1;
    past = next < 0;
  }
  const int rows_per_chunk = CHUNK / d;
  const int chunk = rows_per_chunk * d;
  const bool vec = (d & 3) == 0 && ((uintptr_t)rows & 15) == 0;
  // chunk c of run k: rows [b + c * rows_per_chunk, ...), copied whole up to
  // n (rows past the run's end are copied and not added)
  auto fetch = [&](int k, int c, int into) {
    const long long j0 = (long long)run_b[k] + (long long)c * rows_per_chunk;
    stage(buf[into], rows, j0 * d, (int)min((long long)chunk, (n - j0) * d), vec);
    cp_async_commit();
  };
  __syncthreads();
  fetch(0, 0, 0);  // its copy overlaps the search below
  if (__syncthreads_or(past)) {
    // the last long run's end past this CTA's rows
    const int k = count - 1;
    const int s_last = run_s[k];
    long long e = r0 + SPAN > (long long)run_b[k] + LONG_RUN ? r0 + SPAN
                                                               : (long long)run_b[k] + LONG_RUN;
    if (e > n) e = n;
    for (;;) {
      const long long x = e + tid;
      const int same = __syncthreads_count(x < n && __ldg(seg + x) == s_last);
      e += same;
      if (same < NTHREADS) break;
    }
    if (tid == 0) run_e[k] = (int)e;
    __syncthreads();
  }

  float acc = 0.f;
  int k = 0, c = 0, i = 0;  // run, its chunk, the stream's chunk
  for (;;) {
    const int nch = (run_e[k] - run_b[k] + rows_per_chunk - 1) / rows_per_chunk;
    const bool last_of_run = c + 1 == nch;
    const int kn = last_of_run ? k + 1 : k, cn = last_of_run ? 0 : c + 1;
    if (kn < count) {
      fetch(kn, cn, (i + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (tid < d) {
      const float* p = buf[i & 1] + tid;
      const int nrows = min(rows_per_chunk, run_e[k] - run_b[k] - c * rows_per_chunk);
      int j = 0;
      if (c == 0) {  // from the run's first row, as before
        acc = p[0];
        j = 1;
      }
      for (; j + 16 <= nrows; j += 16) {  // sixteen loads ahead of the adds
        float x[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) x[u] = p[(j + u) * d];
#pragma unroll
        for (int u = 0; u < 16; ++u) acc += x[u];
      }
      for (; j < nrows; ++j) acc += p[j * d];
      if (last_of_run && run_s[k] < num_segments) out[(long long)run_s[k] * d + tid] = acc;
    }
    __syncthreads();  // the buffer is refilled two chunks on
    if (kn >= count) break;
    k = kn;
    c = cn;
    ++i;
  }
}

__device__ __forceinline__ void add(float& a, float b) { a += b; }
__device__ __forceinline__ void add(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// V: float4 (d % 4 == 0, four columns a thread) or float (one).
template <typename V>
__global__ void __launch_bounds__(NTHREADS)
segment_sum_kernel(const float* __restrict__ rows, const int* __restrict__ seg,
                   float* __restrict__ out, long long n, int d, long long num_segments,
                   int long_blocks, int long_min) {
  if ((int)blockIdx.x < long_blocks) {
    long_runs(rows, seg, out, n, d, num_segments, (long long)blockIdx.x * SPAN);
    return;
  }
  constexpr int W = sizeof(V) / sizeof(float);
  const int groups = d / W;  // column groups of a row
  const long long used = (long long)__ldg(seg + n - 1) + 1;  // U
  const long long total = (n > num_segments ? n : num_segments) * groups;
  const long long stride = (long long)(gridDim.x - long_blocks) * NTHREADS;
  for (long long t = (long long)(blockIdx.x - long_blocks) * NTHREADS + threadIdx.x; t < total;
       t += stride) {
    const long long r = t / groups;
    const int c = (int)(t - r * groups) * W;
    if (r < n) {
      // ids r - 1 .. r + LONG_RUN - 1 in one round of loads: whether r starts
      // a run, and its length up to LONG_RUN (the ids after r that equal
      // seg[r] form a prefix, as seg is sorted)
      int win[LONG_RUN + 1];
#pragma unroll
      for (int u = 0; u <= LONG_RUN; ++u) {
        const long long x = r - 1 + u;
        win[u] = x >= 0 && x < n ? __ldg(seg + x) : -1;
      }
      const int s = win[1];
      int len = 1;
#pragma unroll
      for (int u = 2; u <= LONG_RUN; ++u) len += win[u] == s;
      if (len == LONG_RUN && long_min == NO_LONG_PATH) {  // no long path: read on
        for (int j0 = LONG_RUN;; j0 += LONG_RUN) {
          int same = 0;
#pragma unroll
          for (int u = 0; u < LONG_RUN; ++u) {
            const long long x = r + j0 + u;
            same += x < n && __ldg(seg + x) == s;
          }
          len += same;
          if (same < LONG_RUN) break;
        }
      }
      // a run start whose run a long-run CTA does not take
      if ((r == 0 || win[0] != s) && (len < LONG_RUN || long_min == NO_LONG_PATH)) {
        const V* p = reinterpret_cast<const V*>(rows + r * d + c);
        V acc = __ldg(p);
        for (int j0 = 1; j0 < len; j0 += LONG_RUN) {  // the loads in flight, then the adds
          V x[LONG_RUN];
#pragma unroll
          for (int u = 0; u < LONG_RUN; ++u)
            x[u] = j0 + u < len ? __ldg(p + (long long)(j0 + u) * groups) : zero<V>();
#pragma unroll
          for (int u = 0; u < LONG_RUN; ++u)
            if (j0 + u < len) add(acc, x[u]);
        }
        if (s >= 0 && s < num_segments)
          *reinterpret_cast<V*>(out + (long long)s * d + c) = acc;
      }
    }
    if (r >= used && r < num_segments) *reinterpret_cast<V*>(out + r * d + c) = zero<V>();
  }
}

}  // namespace

// rows (n, d) float32, seg (n,) int32 non-decreasing and contiguous from 0,
// out (num_segments, d) float32; all contiguous, n >= 1.  Launches on
// `stream`; returns a cudaError_t.
extern "C" int hetu_segment_sum(const float* rows, const int* seg, float* out, long long n,
                                int d, long long num_segments, void* stream) {
  if (n <= 0 || n >= (1LL << 31) - 1 || d <= 0 || num_segments <= 0)
    return (int)cudaErrorInvalidValue;
  // a row wider than the CTA has no long path: its runs take the short one
  const long long long_blocks = d <= NTHREADS ? (n + SPAN - 1) / SPAN : 0;
  const int long_min = long_blocks ? LONG_RUN : NO_LONG_PATH;
  const bool vec = (d & 3) == 0 && ((uintptr_t)rows & 15) == 0 && ((uintptr_t)out & 15) == 0;
  long long short_blocks =
      ((n > num_segments ? n : num_segments) * (vec ? d / 4 : d) + NTHREADS - 1) / NTHREADS;
  if (short_blocks > MAX_BLOCKS) short_blocks = MAX_BLOCKS;
  const unsigned grid = (unsigned)(long_blocks + short_blocks);
  if (vec)
    segment_sum_kernel<float4><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        rows, seg, out, n, d, num_segments, (int)long_blocks, long_min);
  else
    segment_sum_kernel<float><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        rows, seg, out, n, d, num_segments, (int)long_blocks, long_min);
  return (int)cudaGetLastError();
}
