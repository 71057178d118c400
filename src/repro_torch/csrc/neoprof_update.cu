// NeoProf sketch update and hot-bit mark.
//
// Replaces the TPU kernels repro/kernels/neoprof_update/neoprof_update.py:
// _update_kernel (through sketch_update_pallas) and _mark_kernel (through
// sketch_mark_hot_pallas).
//
// update: H3-hash each of S page ids (-1 = padding, hashed as 0 and masked
// out of every output) into D lanes of width W; entries whose epoch tag !=
// cur count as 0; add the block's bincount, saturate ONCE at counter_max,
// stamp every tag with cur; return the post-block estimate and the
// pre-block hot bit of every (lane, element).
// mark: a new hot plane, the old one with the bit set at the H3 positions
// of every valid id flagged hot (out of place, like the reference).
//
// What bounds them on an H100: bytes, and at the main path's size (D=2,
// W=16384, S=16) launch latency more than either.  The update's refresh
// pass reads and writes every counter and tag once (D*W*(4+1+4+1) bytes =
// 320 KB); mark reads and writes the D*W-byte plane once (32 KB), while the
// block itself is S ids.
//
// Design.  The Pallas kernels are segment-tiled one-hot compare-reduces, a
// workaround for the TPU's lack of scatter.  Hopper has integer atomics, so
// the update's bincount is an atomicAdd per (lane, id), which is exact and
// so bitwise deterministic.  Its block-synchronous semantics need four
// ordered phases over the whole sketch — refresh, add (reading hot_before
// in the same pass), clamp, gather est — and so one cooperative block of
// 1024 threads with __syncthreads between the phases.  Clamping the live
// value before the add equals clamping live+delta after it, because delta
// >= 0; the post-add clamp then only touches the entries the block hit.
// One block keeps one SM busy, which is right for W=16K and slow for the
// paper's W=512K: spreading the refresh over the grid is later work.
// Mark takes the reference's own decomposition (grid = plane / segment):
// each block owns one 4 KB segment of the flat D*W plane, copies it with
// 16-byte vector loads and stores (a byte loop covers a ragged end or an
// unaligned plane), then hashes the S ids itself with the seeds in shared
// memory and sets only the bits that fall in its own segment.  No block
// writes another's segment, so there is no race; 8 blocks at the main size,
// 256 at W=512K.  Neither kernel has a product to give tensor cores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kIdBits = 30;  // PAGE_ID_BITS

__device__ __forceinline__ int h3(int id, const int* seeds_lane) {
  int h = 0;
#pragma unroll
  for (int bit = 0; bit < kIdBits; ++bit)
    if ((id >> bit) & 1) h ^= seeds_lane[bit];
  return h;
}

__global__ void __launch_bounds__(kThreads)
update_kernel(const int* __restrict__ counts, const uint8_t* __restrict__ epochs,
              const uint8_t* __restrict__ hot, const int* __restrict__ ids,
              const int* __restrict__ seeds, const uint8_t* __restrict__ cur_epoch,
              int* __restrict__ out_counts, uint8_t* __restrict__ out_epochs,
              int* __restrict__ est, int* __restrict__ hot_before, int D, int W,
              int S, int counter_max) {
  __shared__ int seeds_s[8 * kIdBits];
  for (int i = threadIdx.x; i < D * kIdBits; i += blockDim.x) seeds_s[i] = seeds[i];
  const uint8_t cur = *cur_epoch;
  const int n = D * W;
  // 1. refresh: live (clamped) values back, every tag stamped
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int live = epochs[i] == cur ? counts[i] : 0;
    out_counts[i] = min(live, counter_max);
    out_epochs[i] = cur;
  }
  __syncthreads();
  // 2. add the block's bincount; read the pre-block hot bits
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    const int id = ids[j];
    const bool valid = id >= 0;
    for (int d = 0; d < D; ++d) {
      const int h = h3(valid ? id : 0, seeds_s + d * kIdBits);
      if (valid) atomicAdd(out_counts + d * W + h, 1);
      hot_before[d * S + j] = valid ? (int)hot[d * W + h] : 0;
    }
  }
  __syncthreads();
  // 3. saturate the touched entries once
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    const int id = ids[j];
    if (id < 0) continue;
    for (int d = 0; d < D; ++d)
      atomicMin(out_counts + d * W + h3(id, seeds_s + d * kIdBits), counter_max);
  }
  __syncthreads();
  // 4. post-block estimate per (lane, element)
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    const int id = ids[j];
    for (int d = 0; d < D; ++d)
      est[d * S + j] = id >= 0 ? out_counts[d * W + h3(id, seeds_s + d * kIdBits)] : 0;
  }
}

constexpr int kMarkThreads = 256;
constexpr int kMarkSeg = kMarkThreads * 16;   // plane bytes per block

__global__ void __launch_bounds__(kMarkThreads)
mark_kernel(const uint8_t* __restrict__ hot, const int* __restrict__ ids,
            const uint8_t* __restrict__ is_hot, const int* __restrict__ seeds,
            uint8_t* __restrict__ out_hot, int D, int W, int S, int vec) {
  __shared__ int seeds_s[8 * kIdBits];
  for (int i = threadIdx.x; i < D * kIdBits; i += blockDim.x) seeds_s[i] = seeds[i];
  const int lo = blockIdx.x * kMarkSeg, hi = min(lo + kMarkSeg, D * W);
  int tail = lo;                                // first byte the vector copy left
  if (vec) {
    const int nv = (hi - lo) / 16;
    for (int i = threadIdx.x; i < nv; i += blockDim.x)
      reinterpret_cast<uint4*>(out_hot + lo)[i] =
          reinterpret_cast<const uint4*>(hot + lo)[i];
    tail = lo + nv * 16;
  }
  for (int i = tail + threadIdx.x; i < hi; i += blockDim.x) out_hot[i] = hot[i];
  __syncthreads();
  for (int task = threadIdx.x; task < S * D; task += blockDim.x) {
    const int j = task / D, d = task - j * D;
    const int id = ids[j];
    if (id < 0 || !is_hot[j]) continue;
    const int at = d * W + h3(id, seeds_s + d * kIdBits);
    if (at >= lo && at < hi) out_hot[at] = 1;
  }
}

}  // namespace

extern "C" int neoprof_update_launch(const int* counts, const uint8_t* epochs,
                                     const uint8_t* hot, const int* ids,
                                     const int* seeds, const uint8_t* cur_epoch,
                                     int* out_counts, uint8_t* out_epochs,
                                     int* est, int* hot_before, int D, int W,
                                     int S, int counter_max, void* stream) {
  if (D > 8) return (int)cudaErrorInvalidValue;
  update_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      counts, epochs, hot, ids, seeds, cur_epoch, out_counts, out_epochs, est,
      hot_before, D, W, S, counter_max);
  return (int)cudaGetLastError();
}

extern "C" int neoprof_mark_launch(const uint8_t* hot, const int* ids,
                                   const uint8_t* is_hot, const int* seeds,
                                   uint8_t* out_hot, int D, int W, int S,
                                   void* stream) {
  if (D > 8) return (int)cudaErrorInvalidValue;
  const int n = D * W;
  const int vec = ((reinterpret_cast<uintptr_t>(hot) |
                    reinterpret_cast<uintptr_t>(out_hot)) % 16) == 0;
  mark_kernel<<<(n + kMarkSeg - 1) / kMarkSeg, kMarkThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(hot, ids, is_hot, seeds,
                                                     out_hot, D, W, S, vec);
  return (int)cudaGetLastError();
}
