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
// W=16384, S=16) launch latency more than either; at the simulator's
// largest block (S=16384) the hashing described below.  The update's refresh
// reads and writes every counter and tag once (D*W*(4+1+4+1) bytes =
// 320 KB, 10.5 MB at the paper's W=512K); mark reads and writes the
// D*W-byte plane once (32 KB), while the block itself is S ids.
//
// Design.  The Pallas kernels are segment-tiled one-hot compare-reduces, a
// workaround for the TPU's lack of scatter; both take the reference's own
// decomposition here: the grid runs over segments of the flat D*W plane and
// every (lane, id) lands in exactly one segment.
// Update: a block of 256 threads owns a segment of one lane (never two:
// a lane narrower than a segment is one short segment) of 2048 entries:
// 16 blocks at the main size, 512 at W=512K.  It (1) reads its counters and tags with 16-byte
// loads (a scalar loop where a plane is not 16-byte aligned), keeps the
// live values clamped at counter_max in shared memory and stamps the tags
// with cur; (2) H3-hashes every id for its own lane with the lane's seeds
// in shared memory and adds one with a shared-memory atomic for each valid
// id whose position falls in the segment; (3) saturates and writes the
// segment's counters out with 16-byte stores; (4) hashes the ids again and
// writes est and hot_before for every (lane, id) in the segment.  Each
// (lane, id) so has exactly one owner block; a padding id (-1, hashed as
// 0) is owned by the block holding position h3(0) = 0 of the lane, the
// lane's first, which writes its 0s.  No block touches another's entries,
// so there is no cooperative launch, global atomic or grid-wide barrier.
// The bincount is added once on top of the clamped live value and then
// saturated: the same as clamping live+delta, since delta >= 0.  Outputs
// are out of place, and shared-memory integer atomics keep every result
// bitwise.  Hashing all S ids in every block costs S*30 XOR-selects per
// block and pass: at the serving paths' S <= 1024 that is ~240 per thread
// over both passes, small beside the segment's loads; at the simulator's
// S = 16384 with W = 512K it is ~3,800 per thread in each of 512 blocks,
// and the call takes ~20x its byte bound (PERF.md §6).  Hashing the ids
// once up front would remove that; it is not done yet.
// Mark: each block owns one 4 KB segment of the flat D*W plane, copies it
// with 16-byte vector loads and stores (a byte loop covers a ragged end or
// an unaligned plane), then hashes the S ids itself with the seeds in
// shared memory and sets only the bits that fall in its own segment; 8
// blocks at the main size, 256 at W=512K.  Neither kernel has a product to
// give tensor cores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIdBits = 30;  // PAGE_ID_BITS

__device__ __forceinline__ int h3(int id, const int* seeds_lane) {
  int h = 0;
#pragma unroll
  for (int bit = 0; bit < kIdBits; ++bit)
    if ((id >> bit) & 1) h ^= seeds_lane[bit];
  return h;
}

constexpr int kThreads = 256;
constexpr int kSeg = 2048;   // entries of one lane per block

__global__ void __launch_bounds__(kThreads)
update_kernel(const int* __restrict__ counts, const uint8_t* __restrict__ epochs,
              const uint8_t* __restrict__ hot, const int* __restrict__ ids,
              const int* __restrict__ seeds, const uint8_t* __restrict__ cur_epoch,
              int* __restrict__ out_counts, uint8_t* __restrict__ out_epochs,
              int* __restrict__ est, int* __restrict__ hot_before, int W, int S,
              int counter_max, int vec) {
  __shared__ int seeds_s[kIdBits];
  __shared__ __align__(16) int cnt_s[kSeg];
  const int per_lane = (W + kSeg - 1) / kSeg;
  const int d = blockIdx.x / per_lane;
  const int lo = (blockIdx.x - d * per_lane) * kSeg;   // lane-local start
  const int len = min(kSeg, W - lo);
  const size_t base = (size_t)d * W + lo;
  if (threadIdx.x < kIdBits) seeds_s[threadIdx.x] = seeds[d * kIdBits + threadIdx.x];
  const uint8_t cur = *cur_epoch;
  // 1. live values, clamped, into shared memory; every tag stamped
  if (vec) {                                   // len % 16 == 0
    const unsigned c4 = cur * 0x01010101u;
    const uint4 stamp = make_uint4(c4, c4, c4, c4);
    for (int g = threadIdx.x; g < len / 16; g += kThreads) {
      int4 c[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        c[q] = __ldg(reinterpret_cast<const int4*>(counts + base) + 4 * g + q);
      const uint4 tg = __ldg(reinterpret_cast<const uint4*>(epochs + base) + g);
      const uint8_t* tv = reinterpret_cast<const uint8_t*>(&tg);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int* cv = reinterpret_cast<const int*>(&c[q]);
        int4 live;
        int* lv = reinterpret_cast<int*>(&live);
#pragma unroll
        for (int k = 0; k < 4; ++k) lv[k] = tv[4 * q + k] == cur ? min(cv[k], counter_max) : 0;
        reinterpret_cast<int4*>(cnt_s)[4 * g + q] = live;
      }
      reinterpret_cast<uint4*>(out_epochs + base)[g] = stamp;
    }
  } else {
    for (int i = threadIdx.x; i < len; i += kThreads) {
      cnt_s[i] = epochs[base + i] == cur ? min(counts[base + i], counter_max) : 0;
      out_epochs[base + i] = cur;
    }
  }
  __syncthreads();
  // 2. the block's bincount, for the ids that fall in this segment
  for (int j = threadIdx.x; j < S; j += kThreads) {
    const int id = ids[j];
    if (id < 0) continue;
    const int at = h3(id, seeds_s) - lo;
    if (at >= 0 && at < len) atomicAdd(cnt_s + at, 1);
  }
  __syncthreads();
  // 3. saturate and store the segment
  if (vec) {
    for (int v = threadIdx.x; v < len / 4; v += kThreads) {
      int4 x = reinterpret_cast<const int4*>(cnt_s)[v];
      x = make_int4(min(x.x, counter_max), min(x.y, counter_max),
                    min(x.z, counter_max), min(x.w, counter_max));
      reinterpret_cast<int4*>(out_counts + base)[v] = x;
    }
  } else {
    for (int i = threadIdx.x; i < len; i += kThreads)
      out_counts[base + i] = min(cnt_s[i], counter_max);
  }
  // 4. est and hot_before of the (lane, id) this block owns
  for (int j = threadIdx.x; j < S; j += kThreads) {
    const int id = ids[j];
    if (id < 0) {
      if (lo == 0) est[d * S + j] = hot_before[d * S + j] = 0;
      continue;
    }
    const int at = h3(id, seeds_s) - lo;
    if (at < 0 || at >= len) continue;
    est[d * S + j] = min(cnt_s[at], counter_max);
    hot_before[d * S + j] = hot[base + at];
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
  const int vec = W % 16 == 0 && ((reinterpret_cast<uintptr_t>(counts) |
                                   reinterpret_cast<uintptr_t>(epochs) |
                                   reinterpret_cast<uintptr_t>(out_counts) |
                                   reinterpret_cast<uintptr_t>(out_epochs)) % 16) == 0;
  update_kernel<<<D * ((W + kSeg - 1) / kSeg), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      counts, epochs, hot, ids, seeds, cur_epoch, out_counts, out_epochs, est,
      hot_before, W, S, counter_max, vec);
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
