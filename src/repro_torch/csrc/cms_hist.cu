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
// at W=16384) and, at that size, launch latency.
//
// Design.  The Pallas kernel compares each segment against all 64 bin edges
// (a dense (Wseg x 64) compare-reduce, the TPU's way round a scatter).
// Here each thread finds its counter's bin by binary search over the edges
// held in shared memory and adds one to a shared 64-bin histogram with an
// atomic; integer atomics make the result exact.  One block walks the whole
// row, so it can write the 64 bins itself and needs no zeroed output and no
// second pass; a row of the paper's W=512K would want the grid split with a
// global atomic reduce instead.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kBins = 64;

__global__ void __launch_bounds__(kThreads)
hist_kernel(const int* __restrict__ counts, const uint8_t* __restrict__ epochs,
            const uint8_t* __restrict__ cur_epoch, const int* __restrict__ edges,
            int* __restrict__ out, int W) {
  __shared__ int edges_s[kBins + 1];
  __shared__ int hist_s[kBins];
  for (int i = threadIdx.x; i <= kBins; i += blockDim.x) edges_s[i] = edges[i];
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) hist_s[i] = 0;
  __syncthreads();
  const uint8_t cur = *cur_epoch;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const int live = epochs[i] == cur ? counts[i] : 0;
    // number of edges <= live (searchsorted side="right")
    int lo = 0, hi = kBins + 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (edges_s[mid] <= live) lo = mid + 1; else hi = mid;
    }
    const int bin = min(max(lo - 1, 0), kBins - 1);
    atomicAdd(hist_s + bin, 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) out[i] = hist_s[i];
}

}  // namespace

extern "C" int cms_hist_launch(const int* counts_row0, const uint8_t* epochs_row0,
                               const uint8_t* cur_epoch, const int* edges,
                               int* out, int W, void* stream) {
  hist_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      counts_row0, epochs_row0, cur_epoch, edges, out, W);
  return (int)cudaGetLastError();
}
