// NeoProf histogram unit: a 64-bin histogram of sketch row 0's live counters.
//
// Replaces the TPU kernel repro/kernels/cms_hist/cms_hist.py (_hist_kernel,
// through hist_pallas): a counter whose epoch tag != cur counts as 0, and
// bin k holds the counters in [edges[k], edges[k+1]).  Counters never
// exceed counter_max, so every value lands in a bin and this equals the
// reference's clip(searchsorted(edges, v, side="right") - 1, 0, 63); the
// kernel applies the same clip.
//
// What bounds it on an H100: bytes (W counters and W tags read once, 80 KB
// at W=16384, 2.6 MB at the paper's W=512K) and, at both sizes, launch
// latency more than either.
//
// Design.  The Pallas kernel compares each segment against all 64 bin edges
// (a dense (Wseg x 64) compare-reduce, the TPU's way round a scatter) and
// carries the sum across its sequential grid.  Here the row is split over
// the grid: a block of 256 threads takes a chunk of 1024 counters, four per
// thread, read as one 16-byte load of counters and one 4-byte word of tags
// (a warp's tag loads cover 128 contiguous bytes; a scalar loop takes a row
// that is not aligned), so 16 blocks at W=16K and 512 at W=512K.  Four
// values a thread rather than sixteen keeps each thread's chain of lookups
// and atomics short, which is what the time depends on at these sizes.
// A value is its own bin while it and the next value are edges equal to
// their index (hist_edges makes edges 0..17 so: the exact small counts
// where the hot threshold lives).  A thread whose four values are not all
// such takes a branchless binary search over the edges in shared memory
// (padded to 128 with INT_MAX) for each, which the compiler interleaves.
// Most counters of a real row read 0 (never hit, or a stale tag), so bin-0
// hits are counted in a register and summed per warp with one reduction
// instead of serialising on one shared atomic; other bins go to a per-warp
// sub-histogram.  The launcher zeroes the output with cudaMemsetAsync on
// the kernel's stream, so the caller zeroes nothing and no state outlives
// a call; each block then adds its non-zero bins into the output with
// global atomics.  Integer sums are exact in any order, so the result is
// bitwise deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVals = 4;                 // counters per thread
constexpr int kChunk = kThreads * kVals;  // counters per block
constexpr int kBins = 64;
constexpr int kPadded = 128;             // edges padded for the search

// number of edges <= v (searchsorted side="right") minus one, clipped
__device__ __forceinline__ int search(int v, const int* edges_s) {
  int pos = 0;
#pragma unroll
  for (int step = kPadded / 2; step > 0; step >>= 1)
    if (edges_s[pos + step - 1] <= v) pos += step;
  return min(max(pos - 1, 0), kBins - 1);
}

// live values -> bins in place; values below the edges' identity prefix
// (less one) are their own bins
template <int N>
__device__ __forceinline__ void to_bins(int (&v)[N], const int* edges_s, int exact) {
  bool fast = true;
#pragma unroll
  for (int k = 0; k < N; ++k) fast = fast && v[k] >= 0 && v[k] < exact - 1;
  if (fast) return;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int s = search(v[k], edges_s);
    v[k] = v[k] >= 0 && v[k] < exact - 1 ? v[k] : s;
  }
}

__global__ void __launch_bounds__(kThreads)
hist_kernel(const int* __restrict__ counts, const uint8_t* __restrict__ epochs,
            const uint8_t* __restrict__ cur_epoch, const int* __restrict__ edges,
            int* __restrict__ out, int W, int vec) {
  __shared__ int edges_s[kPadded];
  __shared__ int sub_s[kWarps][kBins];
  __shared__ int exact_s;   // index of the first edge that is not its index
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int lo = blockIdx.x * kChunk, hi = min(lo + kChunk, W);
  // with whole groups (vec: W % 4 == 0) a thread owns at most one; its
  // loads go out before the edge table is ready, so both round trips overlap
  const int g = lo / kVals + t;
  const bool mine = vec && g < hi / kVals;
  int4 c = make_int4(0, 0, 0, 0);
  unsigned tg = 0;
  if (mine) {
    c = __ldg(reinterpret_cast<const int4*>(counts) + g);
    tg = __ldg(reinterpret_cast<const unsigned*>(epochs) + g);
  }
  const uint8_t cur = *cur_epoch;
  for (int i = t; i < kPadded; i += kThreads) edges_s[i] = i <= kBins ? edges[i] : INT32_MAX;
  for (int i = t; i < kWarps * kBins; i += kThreads) (&sub_s[0][0])[i] = 0;
  if (warp == 0) {
    const unsigned a = __ballot_sync(~0u, edges[lane] != lane);
    const unsigned b = __ballot_sync(~0u, edges[lane + 32] != lane + 32);
    if (lane == 0)
      exact_s = a ? __ffs(a) - 1 : b ? 31 + __ffs(b) : edges[kBins] != kBins ? kBins : kBins + 1;
  }
  __syncthreads();
  const int exact = exact_s;
  int zeros = 0;                          // this thread's bin-0 hits
  auto count = [&](int bin) {
    if (bin == 0) ++zeros; else atomicAdd(&sub_s[warp][bin], 1);
  };
  if (mine) {
    int v[kVals] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int k = 0; k < kVals; ++k)
      if (((tg >> (8 * k)) & 0xff) != cur) v[k] = 0;
    to_bins(v, edges_s, exact);
#pragma unroll
    for (int k = 0; k < kVals; ++k) count(v[k]);
  } else if (!vec) {
    for (int i = lo + t; i < hi; i += kThreads) {
      int v[1] = {epochs[i] == cur ? counts[i] : 0};
      to_bins(v, edges_s, exact);
      count(v[0]);
    }
  }
  zeros = __reduce_add_sync(~0u, zeros);
  if (lane == 0) sub_s[warp][0] = zeros;  // bin 0 takes no atomics
  __syncthreads();
  if (t < kBins) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += sub_s[w][t];
    if (sum) atomicAdd(out + t, sum);
  }
}

}  // namespace

extern "C" int cms_hist_launch(const int* counts_row0, const uint8_t* epochs_row0,
                               const uint8_t* cur_epoch, const int* edges,
                               int* out, int W, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(out, 0, kBins * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int vec = W % kVals == 0 && reinterpret_cast<uintptr_t>(counts_row0) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(epochs_row0) % 4 == 0;
  hist_kernel<<<(W + kChunk - 1) / kChunk, kThreads, 0, s>>>(
      counts_row0, epochs_row0, cur_epoch, edges, out, W, vec);
  return (int)cudaGetLastError();
}
