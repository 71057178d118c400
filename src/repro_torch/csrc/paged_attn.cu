// Paged flash-decode attention with the per-page softmax-mass export.
//
// Replaces the TPU kernel repro/kernels/paged_attn/paged_attn.py
// (_paged_attn_kernel, reached through paged_attention_raw): one new query
// token per batch row attends over P pages of T tokens with GQA, a per-page
// valid length (0 = invalid page), an optional tanh softcap and dk != dv.
// Outputs are the unnormalised online-softmax stats (m, l, acc) and, with
// page stats on, each page's own max page_m and denominator page_l.
//
// What bounds it on an H100: bytes.  Each call reads every valid K/V token
// once (B*P*T*Hkv*(dk+dv) elements, 16.8 MB per layer at llama3.2-3b,
// B=4, P=16, T=64) and does ~2 flops per byte, far below the ~295 flop/byte
// ridge, so the floor is the K/V bytes over 3.35 TB/s (~4.9 us).  Reaching
// it takes loads in flight on every SM and compute that keeps up with them.
//
// Design.  The Pallas kernel carries (m, l, acc) across pages in output
// blocks that the TPU revisits in grid order.  Here the P pages of one
// (batch row, kv head) are split over a thread-block cluster of
// C = min(P, 8) blocks (grid (Hkv, B, C), cluster (1, 1, C)): 256 blocks at
// the main shape instead of 32, all resident at once (3 blocks per SM).
// Rank r owns a contiguous share of the pages (the first P % C ranks one
// more).  Inside a block one producer warp keeps a 2-stage ring of (K, V)
// page tiles filled, so the next page is in flight while 8 consumer warps
// compute on the current one.  A page arrives as two TMA tensor copies
// (cp.async.bulk.tensor, one box of T tokens of one kv head from a 3-D
// tensor map over K and one over V) completing on the stage's mbarrier;
// one non-tensor bulk copy per 256-byte token row would take 128 copies a
// page, and their issue rather than the memory then paces the loads.  A
// partial page's rows past its length come along in the box and are never
// read.  Rows whose byte width is not
// a multiple of 16 (or sides above 256) take a plain-load fill of the same
// ring, chosen at launch from the shapes.  Consumers: scores split each
// token's dot over 8 lanes with 16-byte shared loads, two tokens per thread
// per round, all G query heads from one K load, and a 3-step shuffle
// reduction; one warp per query head reduces the page max and sums
// (page_m, page_l: page-local, as in the reference); p @ V gives each
// thread one column pair (bf16x2 reads) over a slice of the tokens and
// keeps its accumulators for all G heads in registers across pages.
// NEG_INF stays the finite -1e30 and alpha = exp(min(m_prev - m_cur, 0)) as
// in the reference, so a rank whose pages are all masked ends with
// m = -1e30, l = 0, acc = 0.  The ranks' (m_r, l_r, acc_r) meet through
// distributed shared memory: after cluster.sync() every rank merges 1/C of
// the outputs (m = max m_r, w_r = exp(m_r - m), l = sum l_r w_r,
// acc = sum acc_r w_r), each output summed in rank order, so the result is
// the same bits on every run and a masked rank adds exactly 0.  One launch
// per call and no global workspace.
//
// No tensor cores: wgmma's 64-row tile and mma.sync's 16 rows would both
// pad the G=3 query heads of a kv head, and the kernel does ~2 flops per
// byte against a ridge of ~295; one call's 50 MFLOP take ~0.75 us at
// float32's 67 TFLOP/s against the ~4.9 us byte bound.  Everything
// accumulates in float32 on CUDA cores.
//
// Groups above kMaxG take a second kernel, chosen at launch: MLA's latent
// attention (repro/models/decode.py's MLA branch) sends all 128 query heads
// of deepseek-v3 through one latent kv head with dk = 576 (kv_lora + d_rope)
// and dv = 512.  Three limits of the grouped design fall there: the
// accumulators of 128 heads x 512 columns are the whole register file of an
// SM, two stages of 64-token pages of 1088 columns are 278,528 B of shared
// memory (the limit is 232,448), and TMA boxes take sides of at most 256.
// At page_t 64 the shape also does ~128 flop per byte of K/V, above the
// float32 CUDA-core ridge of ~20 (67 TFLOP/s over 3.35 TB/s).  So the
// head-tiled kernel (below) runs both products on the tensor cores
// (mma.sync over TF32, the float32 q and p split into hi and lo TF32 parts,
// bf16 K and V exact), splits the heads into tiles of 32 across the grid,
// streams each page as 16-row items of its K and then of its V through a
// 3-stage ring of 128-byte swizzled TMA boxes (~226 KB of shared memory,
// one block an SM), and merges the ranks as the grouped kernel does.  Its
// note says what bounds it.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kConsumers = 256;                // 8 compute warps
constexpr int kThreads = kConsumers + 32;      // + the producer warp
constexpr int kStages = 2;                     // ring of (K, V) page tiles
constexpr int kMaxCluster = 8;                 // portable cluster size
constexpr int kMaxG = 8;                       // query heads per kv head
constexpr int kMaxDv = 2 * kConsumers;         // one column pair per thread
constexpr int kLanesPerTok = 8;                // score: lanes per token dot
constexpr int kTokPerRound = kConsumers / kLanesPerTok;

__host__ __device__ __forceinline__ size_t align_to(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

// p @ V: consumer threads own (column pair, token slice); the pair lanes are
// the padded value width's pairs rounded up to a power of two (>= a warp)
__host__ __device__ __forceinline__ int pair_lanes(int pv) {
  int n = 32;
  while (n < pv / 2) n *= 2;
  return n;
}

// Shared-memory layout, the same on the host (size) and in the kernel.
struct Layout {
  int pk, pv;            // smem row pitch of K and V tiles, elements (16 B rows)
  size_t q, s, st;       // byte offsets: q [G][pk], scores [2][G][T], stats
  size_t ring;           // kStages x (K [T][pk], V [T][pv]); later acc partials
  size_t k_bytes, stage_bytes, total;
};

template <typename T>
__host__ __device__ Layout layout(int G, int T_, int dk, int dv) {
  constexpr int per16 = 16 / (int)sizeof(T);
  Layout L;
  L.pk = (dk + per16 - 1) / per16 * per16;
  L.pv = (dv + per16 - 1) / per16 * per16;
  size_t off = 2 * kStages * sizeof(uint64_t);               // mbarriers
  L.q = off;  off = align_to(off + sizeof(float) * G * L.pk, 16);
  L.s = off;  off = align_to(off + sizeof(float) * 2 * G * T_, 16);
  L.st = off; off = align_to(off + sizeof(float) * (3 + kMaxCluster) * G, 128);
  L.ring = off;
  L.k_bytes = align_to(sizeof(T) * (size_t)T_ * L.pk, 128);
  L.stage_bytes = L.k_bytes + align_to(sizeof(T) * (size_t)T_ * L.pv, 128);
  const size_t ring = kStages * L.stage_bytes;
  const size_t slices = kConsumers / pair_lanes(L.pv);
  const size_t partials = sizeof(float) * slices * G * L.pv;
  L.total = off + (ring > partials ? ring : partials);
  return L;
}

// -- PTX: mbarriers, tensor copies, the consumers' named barrier ------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}
// one box of a 3-D tensor map (TMA) into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0,
                                         int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
        "r"(c2), "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// -- element conversions ------------------------------------------------------

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// one 16-byte chunk of a shared K row, as floats
__device__ __forceinline__ void load_chunk(float (&f)[4], const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void load_chunk(float (&f)[8], const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
// two neighbouring elements of a shared V row
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Valid lengths of this rank's pages, read by a warp's lanes 32 at a time
// and handed out by shuffle; get(i) is called by the whole warp for every
// i in order.
struct PageLens {
  const int* lens;                             // this rank's first page
  int np, T_, lane, held;
  __device__ int get(int i) {
    if ((i & 31) == 0)
      held = i + lane < np ? min(max(lens[i + lane], 0), T_) : 0;
    return __shfl_sync(0xffffffffu, held, i & 31);
  }
};

// -- the producer warp: fill the ring with this rank's valid pages ------------

template <typename T, bool kTma>
__device__ void produce(const T* __restrict__ k, const T* __restrict__ v,
                        const CUtensorMap* k_map, const CUtensorMap* v_map,
                        PageLens lens, const Layout& L, unsigned char* ring,
                        uint64_t* full, uint64_t* empty, int b, int kvh, int P,
                        int Hkv, int T_, int dk, int dv, int p0) {
  const int lane = threadIdx.x & 31;
  int it = 0;                                  // valid pages issued so far
  for (int i = 0; i < lens.np; ++i) {
    const int n = lens.get(i);
    if (n == 0) continue;
    const int s = it % kStages;
    if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
    T* ks = reinterpret_cast<T*>(ring + s * L.stage_bytes);
    T* vs = reinterpret_cast<T*>(ring + s * L.stage_bytes + L.k_bytes);
    const int row = (b * P + p0 + i) * T_;    // the page's first token row
    if (kTma) {
      // one box per tensor: the page's T token rows of this kv head (the
      // rows past a partial page's length come along and are never read)
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], (uint32_t)((size_t)T_ * (dk + dv) * sizeof(T)));
        tma_load(ks, k_map, 0, kvh, row, &full[s]);
        tma_load(vs, v_map, 0, kvh, row, &full[s]);
      }
    } else {
      // no tensor map for these shapes: plain loads, zero-padded to the pitch
      const T* kg = k + ((size_t)row * Hkv + kvh) * dk;
      const T* vg = v + ((size_t)row * Hkv + kvh) * dv;
      for (int e = lane; e < n * L.pk; e += 32) {
        const int t = e / L.pk, d = e - t * L.pk;
        ks[e] = d < dk ? kg[(size_t)t * Hkv * dk + d] : zero<T>();
      }
      for (int e = lane; e < n * L.pv; e += 32) {
        const int t = e / L.pv, d = e - t * L.pv;
        vs[e] = d < dv ? vg[(size_t)t * Hkv * dv + d] : zero<T>();
      }
      mbar_arrive(&full[s]);                  // each lane releases its own stores
    }
    ++it;
  }
}

// -- the consumer warps: scores, page stats, p @ V ---------------------------

template <typename T>
__device__ void consume(const Layout& L, PageLens lens, unsigned char* ring,
                        uint64_t* full, uint64_t* empty, const float* q_s,
                        float* s_s, float* m_run, float* l_run, float* alpha_s,
                        float* pm_out, float* pl_out, int b, int P, int H, int h0,
                        int G, int T_, float scale, float softcap, int p0) {
  constexpr int per16 = 16 / (int)sizeof(T);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunks = L.pk / per16;
  const int j = tid % kLanesPerTok;            // score: lane within the token
  const int n_lanes = pair_lanes(L.pv);
  const int slices = kConsumers / n_lanes;
  const int cp = tid % n_lanes;                // p @ V: this thread's column pair
  const int slice = tid / n_lanes;             // ... over tokens slice + k*slices
  const bool has_pair = 2 * cp < L.pv;
  float acc[kMaxG][2];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g][0] = acc[g][1] = 0.f;

  int it = 0;                                  // valid pages consumed so far
  for (int i = 0; i < lens.np; ++i) {
    const int n = lens.get(i);
    const size_t stat = ((size_t)b * P + p0 + i) * H + h0;
    if (n == 0) {                              // masked page: no K/V bytes
      if (pm_out != nullptr && tid < G) {
        pm_out[stat + tid] = kNegInf;
        pl_out[stat + tid] = 0.f;
      }
      continue;
    }
    const int s = it % kStages;
    float* sc = s_s + (it & 1) * G * T_;       // scores, then p, [G][T]
    const T* ks = reinterpret_cast<const T*>(ring + s * L.stage_bytes);
    const T* vs = reinterpret_cast<const T*>(ring + s * L.stage_bytes + L.k_bytes);
    mbar_wait(&full[s], (it / kStages) & 1);

    // 1. scores: 8 lanes per token, two tokens per thread per round, 16-byte
    //    chunks, every query head from one K load
    for (int tb = 0; tb < n; tb += 2 * kTokPerRound) {
      const int t0 = tb + tid / kLanesPerTok, t1 = t0 + kTokPerRound;
      const bool live0 = t0 < n, live1 = t1 < n;
      float dot0[kMaxG], dot1[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) dot0[g] = dot1[g] = 0.f;
      if (live0) {
        for (int c = j; c < chunks; c += kLanesPerTok) {
          float kf0[per16], kf1[per16];
          load_chunk(kf0, ks + (size_t)t0 * L.pk + c * per16);
          if (live1) {
            load_chunk(kf1, ks + (size_t)t1 * L.pk + c * per16);
          } else {
            for (int w = 0; w < per16; ++w) kf1[w] = 0.f;
          }
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
              const float4* qv = reinterpret_cast<const float4*>(q_s + g * L.pk + c * per16);
#pragma unroll
              for (int w = 0; w < per16 / 4; ++w) {
                const float4 x = qv[w];
                dot0[g] += x.x * kf0[4 * w] + x.y * kf0[4 * w + 1] +
                           x.z * kf0[4 * w + 2] + x.w * kf0[4 * w + 3];
                dot1[g] += x.x * kf1[4 * w] + x.y * kf1[4 * w + 1] +
                           x.z * kf1[4 * w + 2] + x.w * kf1[4 * w + 3];
              }
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float d0 = dot0[g], d1 = dot1[g];
          for (int o = kLanesPerTok / 2; o > 0; o >>= 1) {
            d0 += __shfl_xor_sync(0xffffffffu, d0, o);
            d1 += __shfl_xor_sync(0xffffffffu, d1, o);
          }
          if (j == g) {
            float s0 = d0 * scale, s1 = d1 * scale;
            if (softcap > 0.f) {
              s0 = softcap * tanhf(s0 / softcap);
              s1 = softcap * tanhf(s1 / softcap);
            }
            if (live0) sc[g * T_ + t0] = s0;
            if (live1) sc[g * T_ + t1] = s1;
          }
        }
      }
    }
    consumer_sync();

    // 2. page max, running-max update, p = exp(s - m_cur), page partials
    if (warp < G) {
      const int g = warp;
      float mp = kNegInf;
      for (int t = lane; t < n; t += 32) mp = fmaxf(mp, sc[g * T_ + t]);
      mp = warp_max(mp);
      const float m_prev = m_run[g];
      const float m_cur = fmaxf(m_prev, mp);
      float lsum = 0.f, psum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float sv = sc[g * T_ + t];
        const float pij = expf(sv - m_cur);
        lsum += pij;
        psum += expf(sv - mp);
        sc[g * T_ + t] = pij;
      }
      lsum = warp_sum(lsum);
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(fminf(m_prev - m_cur, 0.f));
        alpha_s[g] = alpha;
        l_run[g] = l_run[g] * alpha + lsum;
        m_run[g] = m_cur;
        if (pm_out != nullptr) {
          pm_out[stat + g] = mp;
          pl_out[stat + g] = psum;
        }
      }
    }
    consumer_sync();

    // 3. acc = acc * alpha + p @ V, per (column pair, token slice) in registers
    if (has_pair) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          acc[g][0] *= alpha_s[g];
          acc[g][1] *= alpha_s[g];
        }
      }
      int t = slice;
      for (; t + 3 * slices < n; t += 4 * slices) {
        float2 vf[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) vf[u] = load_pair(vs + (size_t)(t + u * slices) * L.pv + 2 * cp);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float pg = sc[g * T_ + t + u * slices];
              acc[g][0] += pg * vf[u].x;
              acc[g][1] += pg * vf[u].y;
            }
          }
        }
      }
      for (; t < n; t += slices) {
        const float2 vf = load_pair(vs + (size_t)t * L.pv + 2 * cp);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float pg = sc[g * T_ + t];
            acc[g][0] += pg * vf.x;
            acc[g][1] += pg * vf.y;
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);     // this warp is done with stage s
    ++it;
  }

  // the slices' partials go to shared memory (over the drained ring) and are
  // summed in slice order into slice 0: this rank's acc [G][pv]
  consumer_sync();
  float* part = reinterpret_cast<float*>(ring);
  const int n_acc = G * L.pv;
  if (has_pair) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        float* dst = part + slice * n_acc + g * L.pv + 2 * cp;
        dst[0] = acc[g][0];
        dst[1] = acc[g][1];
      }
    }
  }
  consumer_sync();
  for (int e = tid; e < n_acc; e += kConsumers) {
    float a = part[e];
    for (int sl = 1; sl < slices; ++sl) a += part[sl * n_acc + e];
    part[e] = a;
  }
}

template <typename T, bool kTma>
__global__ void __launch_bounds__(kThreads, 3)
paged_attn_kernel(const float* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map, const int* __restrict__ lens,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  float* __restrict__ acc_out, float* __restrict__ pm_out,
                  float* __restrict__ pl_out, int H, int Hkv, int P, int T_,
                  int dk, int dv, float scale, float softcap) {
  cg::cluster_group cluster = cg::this_cluster();
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int G = H / Hkv;
  const int h0 = kvh * G;                      // query heads h0..h0+G-1
  const int tid = threadIdx.x;
  const Layout L = layout<T>(G, T_, dk, dv);

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* m_run = reinterpret_cast<float*>(smem + L.st);
  float* l_run = m_run + G;
  float* alpha_s = l_run + G;
  float* w_s = alpha_s + G;                    // [C][G] combine weights
  unsigned char* ring = smem + L.ring;
  const float* acc_s = reinterpret_cast<const float*>(ring);   // after the pages

  // this rank's share of the pages: the first P % C ranks take one more
  const int share = P / C, extra = P % C;
  const int p0 = rank * share + min(rank, extra);
  const PageLens page_lens{lens + (size_t)b * P + p0, share + (rank < extra ? 1 : 0),
                           T_, tid & 31, 0};

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kTma ? 1 : 32);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    produce<T, kTma>(k, v, &k_map, &v_map, page_lens, L, ring, full, empty, b, kvh,
                     P, Hkv, T_, dk, dv, p0);
  } else {
    // the query rows load while the producer's first copies fly
    for (int e = tid; e < G * L.pk; e += kConsumers) {
      const int g = e / L.pk, d = e - g * L.pk;
      q_s[e] = d < dk ? q[((size_t)b * H + h0 + g) * dk + d] : 0.f;
    }
    if (tid < G) {
      m_run[tid] = kNegInf;
      l_run[tid] = 0.f;
    }
    consumer_sync();
    consume<T>(L, page_lens, ring, full, empty, q_s, s_s, m_run, l_run, alpha_s,
               pm_out, pl_out, b, P, H, h0, G, T_, scale, softcap, p0);
  }

  // combine the ranks' (m_r, l_r, acc_r) through distributed shared memory:
  // every rank merges 1/C of the outputs, each in rank order
  cluster.sync();
  if (tid < G) {
    float mr[kMaxCluster], lr[kMaxCluster];    // all remote loads in flight
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < C) {
        mr[r] = *cluster.map_shared_rank(m_run + tid, r);
        lr[r] = *cluster.map_shared_rank(l_run + tid, r);
      }
    }
    float m = kNegInf, l = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) m = fmaxf(m, mr[r]);
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < C) {
        const float w = expf(mr[r] - m);
        w_s[r * G + tid] = w;
        l += lr[r] * w;
      }
    }
    if (rank == 0) {
      m_out[(size_t)b * H + h0 + tid] = m;
      l_out[(size_t)b * H + h0 + tid] = l;
    }
  }
  __syncthreads();
  const int n_out = G * dv, per = (n_out + C - 1) / C;
  for (int e = rank * per + tid; e < min((rank + 1) * per, n_out); e += kThreads) {
    const int g = e / dv, d = e - g * dv;
    const float* src = acc_s + g * L.pv + d;
    float x[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) x[r] = *cluster.map_shared_rank(src, r);
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) a += x[r] * w_s[r * G + g];
    acc_out[((size_t)b * H + h0) * dv + e] = a;
  }
  cluster.sync();                              // no block leaves while read
}

// == The head-tiled kernel: groups above kMaxG (MLA's latent attention) =====
//
// One block per (kv head, tile of kTileHeads = 32 query heads, batch row,
// rank); the C ranks of a cluster split the pages and merge as the grouped
// kernel's do.  Both products run on the tensor cores as
// mma.sync.m16n8k8 over TF32 with float32 accumulation:
//
//   S = q K^T   heads as M (two m16 tiles), a ring item's tokens as N, dk
//               as K: warp w takes m tile w % 2 and the k steps j = w / 2
//               (mod 4), straight-line code over at most kTileDk / 32 = 18
//               steps; the four k quarters' partials meet in shared memory
//               (two buffers, one barrier an item) and are summed in
//               quarter order, then scaled, softcapped and masked (a select
//               to -1e30 past the page's length, so a garbage K row never
//               reaches the softmax);
//   O += P V    heads as M, dv as N, the item's tokens as K: warp w owns
//               the column pairs 16 (w + 8y) .. + 16, each the n8 tiles of
//               its even and its odd columns, so one 32-bit load of a V row
//               feeds two tiles; 64 accumulators a thread, kept in
//               registers across pages.  V rows past the length, or past
//               the item, reach the mma as zeros (a load from a zeroed
//               slot): there the tokens are the reduction and 0 * NaN is
//               NaN.
//
// Why TF32 keeps float32 accuracy: bf16 pages are exact in TF32 (8
// significant bits of TF32's 11), so only the float32 side splits: q and p
// into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna, round to nearest, ties
// away; raw float32 bits would be truncated by the tensor core), ~22
// significant bits, and each product is hi*K + lo*K.  f32 pages split too
// (hi*hi + lo*hi + hi*lo, the usual 3xTF32).  The 1e-4 + 1e-4*|ref| gate
// the CUDA-core kernel met holds.  q is split once a block, each warp
// keeping the lo parts of its own fragments in 72 registers (hence dk <=
// kTileDk = 576, MLA's width); p is split once a segment.  q hi and p sit
// in shared memory with head rows g and g + 8 interleaved, so one 16-byte
// load is one A fragment.
//
// A page passes as ring items of tc = min(T, 32 B / sizeof(T)) token rows
// (16 bf16, 8 f32), its K items then its V items, in softmax segments of
// at most kTileSeg = 64 tokens: a segment's scores are all known before its
// p @ V.  The running (m, l, acc) steps once a segment; a page's own
// (page_m, page_l) are carried across its segments by the same rescale and
// written at its last (one segment unless T > 64).  Items land through TMA
// as boxes of 128 bytes (64 bf16 or 32 f32 columns) with the 128-byte
// swizzle (a row's 16-byte chunk index XORed with row % 8), so the
// fragment loads of 8 rows x 4 lanes fall on distinct banks; columns past
// d come zero-filled from the box.
//
// Shared memory at MLA's shape (dk 576, dv 512, bf16, T >= 64): q hi
// 32 x 584 x 4 = 74,752 B (the raw rows land there first, one bulk copy
// a row; acc takes it at the end); the segment's scores / p hi and p lo,
// 2 x 9,216 B; the S partials, 2 x 8,192 B; a ring of kTileStages = 6
// items of 9 boxes x 2,048 B = 110,592 B, plus 1,024 B to align it to the
// swizzle's period; 223,104 B in all, one block an SM.  64 heads a tile
// would need twice the q planes and registers; at group 128 the 4 head
// tiles read each page 4 times from L2 (the CUDA-core kernel's 16-head
// tiles, 8 times).
//
// Registers: q's lo parts (72), acc (64) and an item's fragments need
// ~190 a consumer thread; a block of 288 threads is held to 168 (the
// compiler spilled), so the block has 384 threads and setmaxnreg moves the
// producer warpgroup's registers to the consumers (224 each).  That holds
// only if ptxas gives the kernel 168 (65,536 / 384 rounded down to 8):
// with fewer, setmaxnreg.inc would wait for ever, so the launch reads the
// kernel's count and refuses it (tiled_plan).  The build reports 168
// registers, 24 B of spill stores and 156 B of spill loads for each page
// type (-Xptxas -v): the spills are not gone.
//
// The cluster size: at one block an SM the card fits fewer clusters of 8
// at once than a 16-cluster grid needs, so the launch asks how many
// clusters of each size C <= min(P, 8) fit and takes the C with the least
// waves x (pages a rank + a wave's fixed cost); chip_smoke.py prints the
// counts and the choice at each timed shape (paged_attn_tiled_plan).
//
// What bounds it: at page_t 64 the shape does ~128 flop per byte of K/V,
// and the split doubles the tensor-core work, so no form of it reaches the
// byte bound.  At B 8, P 64, T 64 its split products run at about a sixth
// of TF32's peak rate (PERF.md), and running a segment's p @ V beside the
// next segment's S, which would hide the softmax, the reduce and waits on
// loads, gained nothing: the time is
// in the item loops (mma dispatch among their fragment loads, 147 KB of q hi
// and 36 KB of K an item from shared memory), which the card's missing
// profiler counters do not split further.  wgmma (asynchronous, operands
// straight from shared memory) is the next form.

constexpr int kTileHeads = 32;                 // query heads per block: two m16 tiles
constexpr int kTileThreads = kConsumers + 128; // + a producer warpgroup (one warp works)
constexpr int kConsumerRegs = 224;             // setmaxnreg: 256 x 224 + 128 x 56 <= 64K
constexpr int kProducerRegs = 56;
constexpr int kTileStages = 6;                 // ring of K or V items
constexpr int kTileItemBytes = 32;             // an item's rows: 32 B of a column
constexpr int kTileSeg = 64;                   // softmax segment: tokens, at most
constexpr int kTileDk = 576;                   // q width: lo parts in registers
constexpr int kSwz = 128;                      // TMA box row, 128-byte swizzle
constexpr int kKSplit = 4;                     // S: k quarters, summed in order
constexpr int kQSteps = kTileDk / 8 / kKSplit; // S: k steps a warp, at most
constexpr int kTileFixedItems = 16;            // a wave's fixed cost, in ring items

struct TiledLayout {
  int tc, cps;               // token rows per ring item; items per segment
  int nbk, nbv;              // 128-byte boxes in a K and a V row
  int qp, sp, ap;            // pitches (columns): q hi and s / p (row pairs), acc
  size_t box, stage_bytes;   // one box's slot (1024-aligned), one ring stage
  size_t q, s, x, part, st, ring, total;   // byte offsets: q (raw, hi, then
                                           // acc), scores / p hi, p lo, S
                                           // partials, stats, the ring
};

template <typename T>
__host__ __device__ TiledLayout tiled_layout(int T_, int dk, int dv) {
  TiledLayout L;
  L.tc = min(T_, kTileItemBytes / (int)sizeof(T));
  L.cps = max(1, kTileSeg / L.tc);
  L.nbk = (dk * (int)sizeof(T) + kSwz - 1) / kSwz;
  L.nbv = (dv * (int)sizeof(T) + kSwz - 1) / kSwz;
  // 8 mod 16 columns: 16-byte loads of row pairs g = 0, 1 at lanes t = 0..3
  // cover 32 distinct banks; acc's float4 rows 16 mod 32 likewise
  L.qp = kTileDk + 8;
  L.sp = (min(T_, kTileSeg) + 15) / 16 * 16 + 8;
  L.ap = (dv + 31) / 32 * 32 + 16;
  L.box = align_to((size_t)L.tc * kSwz, 1024);
  L.stage_bytes = (L.nbk > L.nbv ? L.nbk : L.nbv) * L.box;
  const size_t q = sizeof(float) * kTileHeads * L.qp;
  const size_t acc = sizeof(float) * kTileHeads * L.ap;
  const size_t tile = sizeof(float) * kTileHeads * L.sp;
  size_t off = align_to((2 * kTileStages + 1) * sizeof(uint64_t), 16);   // mbarriers
  L.q = off;    off = align_to(off + (q > acc ? q : acc), 16);
  L.s = off;    off = align_to(off + tile, 16);
  L.x = off;    off = align_to(off + tile, 16);
  L.part = off; off = align_to(off + sizeof(float4) * 2 * kKSplit * 2 * 2 * 32, 16);
  L.st = off;   off = align_to(off + sizeof(float) * (6 + kMaxCluster) * kTileHeads, 128);
  L.ring = off;
  L.total = off + 1024 + kTileStages * L.stage_bytes;
  return L;
}

// -- TF32 operands and the tensor-core product --------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo in two TF32 values (|x - hi - lo| <= 2^-22 |x|)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
// d += a b, one m16n8k8 tile: a (16 x 8, row), b (8 x 8, col), d float32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// the A fragment from a row-pair plane: (g, c), (g + 8, c), (g, c + 1),
// (g + 8, c + 1), the k step's logical columns t and t + 4 at c and c + 1
// (both operands take the same order)
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  a[0] = __float_as_uint(x.x);
  a[1] = __float_as_uint(x.y);
  a[2] = __float_as_uint(x.z);
  a[3] = __float_as_uint(x.w);
}
// two neighbouring ring elements as TF32 operands: bf16 exactly (lo = 0),
// f32 split
__device__ __forceinline__ void pair_tf32(const unsigned char* p, __nv_bfloat16*,
                                          uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  hi[0] = u << 16;
  hi[1] = u & 0xffff0000u;
  lo[0] = lo[1] = 0u;
}
__device__ __forceinline__ void pair_tf32(const unsigned char* p, float*, uint32_t (&hi)[2],
                                          uint32_t (&lo)[2]) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  split_tf32(x.x, hi[0], lo[0]);
  split_tf32(x.y, hi[1], lo[1]);
}

// byte offset of element (row r, column c) in a ring item landed as
// 128-byte swizzled boxes: box c / (128 / sizeof(T)); in its 128-byte row
// the 16-byte chunk index XORed with r % 8 (box slots are 1024-aligned)
template <typename T>
__device__ __forceinline__ uint32_t swz(const TiledLayout& L, int r, int c) {
  constexpr int per_row = kSwz / (int)sizeof(T);
  const int byte = (c % per_row) * (int)sizeof(T);
  return (uint32_t)((c / per_row) * L.box + r * kSwz) +
         (uint32_t)((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15));
}

// one contiguous run of global memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
        "r"(smem_u32(bar)) : "memory");
}

// A softmax segment: items c0 .. c1 - 1 (at most cps) of this rank's page i,
// which holds n valid tokens in nc items
struct Seg {
  int i, n, nc, c0, c1;
};

// the next segment of this rank's pages, masked pages skipped; false at the
// end (every warp calls it in the same order: lens.get is warp-collective)
__device__ __forceinline__ bool next_seg(PageLens& lens, const TiledLayout& L, Seg& s) {
  if (s.i >= 0 && s.c1 < s.nc) {
    s.c0 = s.c1;
    s.c1 = min(s.nc, s.c0 + L.cps);
    return true;
  }
  while (++s.i < lens.np) {
    s.n = lens.get(s.i);
    if (s.n > 0) {
      s.nc = (s.n + L.tc - 1) / L.tc;
      s.c0 = 0;
      s.c1 = min(s.nc, L.cps);
      return true;
    }
  }
  return false;
}

// The ring's order, which producer and consumers both follow: each
// segment's K items, then its V items.
template <typename T>
__device__ void produce_tiled(const float* q_tile, float* q_raw, uint64_t* qbar,
                              const CUtensorMap* k_map, const CUtensorMap* v_map,
                              PageLens lens, const TiledLayout& L, unsigned char* ring,
                              uint64_t* full, uint64_t* empty, int b, int kvh, int P,
                              int T_, int Gt, int dk, int p0) {
  const int lane = threadIdx.x & 31;
  // the tile's query rows, one bulk copy each, at the q plane's pitch
  if (lane == 0) mbar_arrive_expect_tx(qbar, (uint32_t)(Gt * dk * sizeof(float)));
  __syncwarp();
  if (lane < Gt)
    bulk_load(q_raw + lane * L.qp, q_tile + (size_t)lane * dk,
              (uint32_t)(dk * sizeof(float)), qbar);
  int it = 0;                                  // ring items issued so far
  auto fetch = [&](const Seg& sg, int c, bool v) {
    const int s = it % kTileStages;
    if (it >= kTileStages) mbar_wait(&empty[s], (it / kTileStages - 1) & 1);
    if (lane == 0) {
      unsigned char* dst = ring + s * L.stage_bytes;
      const int nb = v ? L.nbv : L.nbk;
      const int row = (b * P + p0 + sg.i) * T_ + c * L.tc;
      mbar_arrive_expect_tx(&full[s], (uint32_t)(nb * L.tc * kSwz));
      for (int x = 0; x < nb; ++x)
        tma_load(dst + x * L.box, v ? v_map : k_map, x * (kSwz / (int)sizeof(T)), kvh, row,
                 &full[s]);
    }
    ++it;
  };
  Seg sg{-1, 0, 0, 0, 0};
  while (next_seg(lens, L, sg)) {
    for (int c = sg.c0; c < sg.c1; ++c) fetch(sg, c, false);
    for (int c = sg.c0; c < sg.c1; ++c) fetch(sg, c, true);
  }
}

// This warp's S partial over one K item: m tile mw, k steps kq + 4i, NT n
// tiles; the hi and the lo products accumulate apart.  ko: the byte offsets
// of row g's pair at columns 8 kq + 2t and 8 kq + 32 + 2t; kd2: the step of
// 64 columns.  Steps past dk load from the zeroed slot.
template <typename T, int NT>
__device__ __forceinline__ void score_item(const unsigned char* kst, const float* qa,
                                           const uint32_t (&al)[kQSteps][4],
                                           const unsigned char* zero, const uint32_t (&ko)[2],
                                           uint32_t kd2, int kq, int ks, float4* part) {
  constexpr bool kF32 = sizeof(T) == 4;
  float ch[NT][4], cl[NT][4];
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int u = 0; u < 4; ++u) ch[ni][u] = cl[ni][u] = 0.f;
#pragma unroll
  for (int i = 0; i < kQSteps; ++i) {
    uint32_t ah[4];
    frag_a(ah, qa + 64 * i);
    const bool on = kq + kKSplit * i < ks;
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      uint32_t bh[2], bl[2];
      pair_tf32(on ? kst + ko[i & 1] + (i >> 1) * kd2 + ni * 8 * kSwz : zero,
                static_cast<T*>(nullptr), bh, bl);
      mma_tf32(ch[ni], ah, bh[0], bh[1]);
      mma_tf32(cl[ni], al[i], bh[0], bh[1]);
      if (kF32) mma_tf32(cl[ni], ah, bl[0], bl[1]);
    }
  }
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
    part[ni * 32] = make_float4(ch[ni][0] + cl[ni][0], ch[ni][1] + cl[ni][1],
                                ch[ni][2] + cl[ni][2], ch[ni][3] + cl[ni][3]);
}

template <typename T>
__device__ void consume_tiled(const TiledLayout& L, PageLens lens, unsigned char* ring,
                              uint64_t* full, uint64_t* empty, uint64_t* qbar, float* q_s,
                              float* s_s, float* x_s, float4* part, float* m_run,
                              float* l_run, float* alpha_s, float* pm_s, float* pl_s,
                              const unsigned char* zero, float* pm_out, float* pl_out,
                              int b, int P, int H, int h0, int Gt, int dk, int dv,
                              float scale, float softcap, int p0) {
  constexpr bool kF32 = sizeof(T) == 4;        // f32 pages: 3xTF32
  constexpr int per_row = kSwz / (int)sizeof(T);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;       // fragment row group, lane in group
  const int ks = (dk + 7) / 8;                 // S: k steps
  const int nt = (L.tc + 7) / 8;               // S: n tiles of an item
  const int kv = (L.tc + 7) / 8;               // O: k steps of an item
  const int mw = warp & 1, kq = warp >> 1;     // S: this warp's m tile, k quarter

  // masked pages' own stats (warp 0 reads the lengths once more for them)
  if (pm_out != nullptr && warp == 0) {
    PageLens ml = lens;
    for (int i = 0; i < ml.np; ++i)
      if (ml.get(i) == 0 && lane < Gt) {
        const size_t stat = ((size_t)b * P + p0 + i) * H + h0;
        pm_out[stat + lane] = kNegInf;
        pl_out[stat + lane] = 0.f;
      }
  }

  // q: every warp reads the raw values of its own fragments (rows past Gt
  // and columns past dk are 0), then splits them: the lo parts stay in
  // registers, the hi parts go over the raw rows as row pairs
  uint32_t al[kQSteps][4];
  {
    mbar_wait(qbar, 0);
    const int r0 = 16 * mw + g, r1 = r0 + 8;
    float x[kQSteps][4];
#pragma unroll
    for (int i = 0; i < kQSteps; ++i) {
      const int c = 8 * (kq + kKSplit * i) + 2 * t;   // dk % 4 == 0: c < dk covers c + 1
      float2 v0 = make_float2(0.f, 0.f), v1 = v0;
      if (c < dk && r0 < Gt) v0 = *reinterpret_cast<const float2*>(q_s + r0 * L.qp + c);
      if (c < dk && r1 < Gt) v1 = *reinterpret_cast<const float2*>(q_s + r1 * L.qp + c);
      x[i][0] = v0.x; x[i][1] = v1.x; x[i][2] = v0.y; x[i][3] = v1.y;
    }
    consumer_sync();                           // every raw value read
    float* qh = q_s + ((mw * 8 + g) * L.qp + 8 * kq + 2 * t) * 2;
#pragma unroll
    for (int i = 0; i < kQSteps; ++i) {
      uint32_t hi[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) split_tf32(x[i][u], hi[u], al[i][u]);
      *reinterpret_cast<float4*>(qh + 64 * i) =
          make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                      __uint_as_float(hi[2]), __uint_as_float(hi[3]));
    }
  }
  consumer_sync();
  const float* qa = q_s + ((mw * 8 + g) * L.qp + 8 * kq + 2 * t) * 2;
  uint32_t ko[2] = {swz<T>(L, g, 8 * kq + 2 * t), swz<T>(L, g, 8 * kq + 32 + 2 * t)};
  const uint32_t kd2 = (uint32_t)(64 / per_row * L.box);
  const uint32_t vo[2] = {swz<T>(L, 2 * t, 16 * warp + 2 * g),
                          swz<T>(L, 2 * t + 1, 16 * warp + 2 * g)};
  const uint32_t vd = (uint32_t)(128 / per_row * L.box);   // 128 columns on

  float acc[2][4][2][4];                       // O: [m][pair warp + 8y][even, odd][frag]
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int y = 0; y < 4; ++y)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[m][y][h][u] = 0.f;

  int it = 0, kit = 0;                         // ring items, K items consumed so far

  // S = q K^T over the next ring item (a K item): this warp's partial into
  // the buffer of K item kit (two, alternating), then every warp's in
  auto s_item = [&]() -> float4* {
    const int s = it % kTileStages;
    const unsigned char* kst = ring + s * L.stage_bytes;
    float4* pb = part + (kit & 1) * (kKSplit * 2 * 2 * 32);
    mbar_wait(&full[s], (it / kTileStages) & 1);
    float4* mine = pb + (kq * 2 + mw) * 64 + lane;
    if (nt == 2) score_item<T, 2>(kst, qa, al, zero, ko, kd2, kq, ks, mine);
    else score_item<T, 1>(kst, qa, al, zero, ko, kd2, kq, ks, mine);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);     // this warp is done with stage s
    ++it;
    ++kit;
    consumer_sync();
    return pb;
  };
  // the k quarters' sum of K item c of sg, scaled, capped and masked into
  // the score tile: half a fragment position a thread (column r + hf of
  // rows g, g + 8)
  auto reduce = [&](const float4* pb, const Seg& sg, int c, float* tile) {
    if (tid >= 128 * nt) return;
    const int pos = tid >> 1, hf = tid & 1;
    const int m = pos / (32 * nt), ni = pos / 32 % nt, ln = pos & 31;
    const float* pf = reinterpret_cast<const float*>(pb) + hf;
    const int e0 = (m * 64 + ni * 32 + ln) * 4;
    float2 a = make_float2(pf[e0], pf[e0 + 2]);
#pragma unroll
    for (int k = 1; k < kKSplit; ++k) {
      const int e = ((k * 2 + m) * 64 + ni * 32 + ln) * 4;
      a.x += pf[e];
      a.y += pf[e + 2];
    }
    const int r = 8 * ni + 2 * (ln & 3) + hf;
    const bool ok = r < L.tc && c * L.tc + r < sg.n;
    float v[2] = {a.x * scale, a.y * scale};   // rows g and g + 8
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (softcap > 0.f) v[u] = softcap * tanhf(v[u] / softcap);
    *reinterpret_cast<float2*>(tile + ((m * 8 + (ln >> 2)) * L.sp + (c - sg.c0) * L.tc + r) * 2) =
        make_float2(ok ? v[0] : kNegInf, ok ? v[1] : kNegInf);
  };
  // segment max, running-max update, p = exp(s - m_cur) split into hi (over
  // the scores) and lo (x_s), 0 past ns; the page's own (page_m, page_l)
  // carried across its segments: 8 lanes a head, a warp's 4 heads at once
  auto softmax = [&](const Seg& sg, float* tile) {
    const int ns = min(sg.n, sg.c1 * L.tc) - sg.c0 * L.tc;
    const int h = 4 * warp + (lane >> 3), j8 = lane & 7;
    const int off = ((h >> 4) * 8 + (h & 7)) * L.sp * 2 + ((h >> 3) & 1);
    float* srow = tile + off;                  // element u at srow[2 u]
    float* lrow = x_s + off;
    float ms = kNegInf;
    for (int u = j8; u < ns; u += 8) ms = fmaxf(ms, srow[2 * u]);
    for (int o = 4; o > 0; o >>= 1) ms = fmaxf(ms, __shfl_xor_sync(0xffffffffu, ms, o));
    const float m_prev = m_run[h], m_cur = fmaxf(m_prev, ms);
    const float pm_prev = sg.c0 == 0 ? kNegInf : pm_s[h], pm_cur = fmaxf(pm_prev, ms);
    float lsum = 0.f, psum = 0.f;
    for (int u = j8; u < L.sp; u += 8) {
      float p = 0.f;
      if (u < ns) {
        const float sv = srow[2 * u];
        p = expf(sv - m_cur);
        lsum += p;
        psum += expf(sv - pm_cur);
      }
      uint32_t hi, lo;
      split_tf32(p, hi, lo);
      srow[2 * u] = __uint_as_float(hi);
      lrow[2 * u] = __uint_as_float(lo);
    }
    for (int o = 4; o > 0; o >>= 1) {
      lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    }
    if (j8 == 0) {
      const float alpha = expf(fminf(m_prev - m_cur, 0.f));
      alpha_s[h] = alpha;
      l_run[h] = l_run[h] * alpha + lsum;
      m_run[h] = m_cur;
      const float pl = (sg.c0 == 0 ? 0.f : pl_s[h] * expf(pm_prev - pm_cur)) + psum;
      pm_s[h] = pm_cur;
      pl_s[h] = pl;
      if (sg.c1 == sg.nc && pm_out != nullptr && h < Gt) {
        const size_t stat = ((size_t)b * P + p0 + sg.i) * H + h0;
        pm_out[stat + h] = pm_cur;
        pl_out[stat + h] = pl;
      }
    }
  };
  // acc *= alpha before the segment's p @ V
  auto rescale = [&]() {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float a0 = alpha_s[16 * m + g], a1 = alpha_s[16 * m + g + 8];
#pragma unroll
      for (int y = 0; y < 4; ++y)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[m][y][h][0] *= a0;
          acc[m][y][h][1] *= a0;
          acc[m][y][h][2] *= a1;
          acc[m][y][h][3] *= a1;
        }
    }
  };
  // acc += p V over V item c of sg (p hi in `tile`, p lo in x_s)
  auto pv_item = [&](const Seg& sg, int c, const float* tile) {
    const int s = it % kTileStages;
    const unsigned char* vst = ring + s * L.stage_bytes;
    mbar_wait(&full[s], (it / kTileStages) & 1);
    for (int kk = 0; kk < kv; ++kk) {
      // rows r0, r0 + 1 carry the k step's logical columns t, t + 4
      const int r0 = 8 * kk + 2 * t;
      const bool ok0 = r0 < L.tc && c * L.tc + r0 < sg.n;
      const bool ok1 = r0 + 1 < L.tc && c * L.tc + r0 + 1 < sg.n;
      const int pc = (c - sg.c0) * L.tc + r0;
      uint32_t ah[2][4], alo[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        frag_a(ah[m], tile + ((m * 8 + g) * L.sp + pc) * 2);
        frag_a(alo[m], x_s + ((m * 8 + g) * L.sp + pc) * 2);
      }
      const unsigned char* vrow = vst + kk * 8 * kSwz;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const bool live = 16 * (warp + 8 * y) < L.nbv * per_row;
        uint32_t b0h[2], b0l[2], b1h[2], b1l[2];   // [even, odd] columns
        pair_tf32(ok0 && live ? vrow + vo[0] + y * vd : zero, static_cast<T*>(nullptr),
                  b0h, b0l);
        pair_tf32(ok1 && live ? vrow + vo[1] + y * vd : zero, static_cast<T*>(nullptr),
                  b1h, b1l);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma_tf32(acc[m][y][h], ah[m], b0h[h], b1h[h]);
            mma_tf32(acc[m][y][h], alo[m], b0h[h], b1h[h]);
            if (kF32) mma_tf32(acc[m][y][h], ah[m], b0l[h], b1l[h]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    ++it;
  };

  // segment by segment, in the ring's order (produce_tiled); the barrier
  // in the next segment's first s_item keeps its scores off this p
  Seg sg{-1, 0, 0, 0, 0};
  while (next_seg(lens, L, sg)) {
    for (int c = sg.c0; c < sg.c1; ++c) reduce(s_item(), sg, c, s_s);
    consumer_sync();
    softmax(sg, s_s);
    consumer_sync();
    rescale();
    for (int c = sg.c0; c < sg.c1; ++c) pv_item(sg, c, s_s);
  }

  // this rank's acc [kTileHeads][ap] over q hi (every warp is past its
  // last read of q: the barrier before the last softmax)
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int col = 16 * (warp + 8 * y) + 4 * t;
      if (col < dv) {
        float* dst = q_s + (16 * m + g) * L.ap + col;
        const float (&e)[4] = acc[m][y][0];
        const float (&o)[4] = acc[m][y][1];
        *reinterpret_cast<float4*>(dst) = make_float4(e[0], o[0], e[1], o[1]);
        *reinterpret_cast<float4*>(dst + 8 * L.ap) = make_float4(e[2], o[2], e[3], o[3]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads, 1)
paged_attn_tiled_kernel(const float* __restrict__ q,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const int* __restrict__ lens, float* __restrict__ m_out,
                        float* __restrict__ l_out, float* __restrict__ acc_out,
                        float* __restrict__ pm_out, float* __restrict__ pl_out, int H,
                        int Hkv, int P, int T_, int dk, int dv, float scale,
                        float softcap) {
  cg::cluster_group cluster = cg::this_cluster();
  const int G = H / Hkv;
  const int tiles = (G + kTileHeads - 1) / kTileHeads;
  const int kvh = blockIdx.x / tiles, tile = blockIdx.x % tiles, b = blockIdx.y;
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int h0 = kvh * G + tile * kTileHeads;  // query heads h0..h0+Gt-1
  const int Gt = min(kTileHeads, G - tile * kTileHeads);
  const int tid = threadIdx.x;
  const TiledLayout L = tiled_layout<T>(T_, dk, dv);

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kTileStages;
  uint64_t* qbar = empty + kTileStages;
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* x_s = reinterpret_cast<float*>(smem + L.x);
  float4* part = reinterpret_cast<float4*>(smem + L.part);
  float* m_run = reinterpret_cast<float*>(smem + L.st);
  float* l_run = m_run + kTileHeads;
  float* alpha_s = l_run + kTileHeads;
  float* pm_s = alpha_s + kTileHeads;
  float* pl_s = pm_s + kTileHeads;
  float* zero = pl_s + kTileHeads;             // 16 zero bytes for masked loads
  float* w_s = zero + kTileHeads;              // [C][kTileHeads] combine weights
  // the ring starts at a 1024-byte boundary, the 128-byte swizzle's period
  unsigned char* ring = smem + L.ring;
  ring += (1024u - (smem_u32(ring) & 1023u)) & 1023u;
  const float* acc_s = q_s;                    // after the pages

  const int share = P / C, extra = P % C;
  const int p0 = rank * share + min(rank, extra);
  const PageLens page_lens{lens + (size_t)b * P + p0, share + (rank < extra ? 1 : 0),
                           T_, tid & 31, 0};

  if (tid == 0) {
    for (int s = 0; s < kTileStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < kTileHeads) {
    m_run[tid] = kNegInf;
    l_run[tid] = 0.f;
    zero[tid] = 0.f;
  }
  __syncthreads();

  if (tid >= kConsumers) {                     // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid < kConsumers + 32)
      produce_tiled<T>(q + ((size_t)b * H + h0) * dk, q_s, qbar, &k_map, &v_map,
                       page_lens, L, ring, full, empty, b, kvh, P, T_, Gt, dk, p0);
    cluster.sync();                            // the consumers merge
    cluster.sync();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  consume_tiled<T>(L, page_lens, ring, full, empty, qbar, q_s, s_s, x_s, part, m_run,
                   l_run, alpha_s, pm_s, pl_s, reinterpret_cast<const unsigned char*>(zero),
                   pm_out, pl_out, b, P, H, h0, Gt, dk, dv, scale, softcap, p0);

  // combine the ranks' (m_r, l_r, acc_r) through distributed shared memory,
  // every rank merging 1/C of the outputs, each in rank order
  cluster.sync();
  if (tid < Gt) {
    float mr[kMaxCluster], lr[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < C) {
        mr[r] = *cluster.map_shared_rank(m_run + tid, r);
        lr[r] = *cluster.map_shared_rank(l_run + tid, r);
      }
    }
    float m = kNegInf, l = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) m = fmaxf(m, mr[r]);
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < C) {
        const float w = expf(mr[r] - m);
        w_s[r * kTileHeads + tid] = w;
        l += lr[r] * w;
      }
    }
    if (rank == 0) {
      m_out[(size_t)b * H + h0 + tid] = m;
      l_out[(size_t)b * H + h0 + tid] = l;
    }
  }
  consumer_sync();
  // float4 by float4 (dv is a multiple of 4: its rows are 16-byte)
  const int q4 = dv / 4, n_out = Gt * q4, per = (n_out + C - 1) / C;
  float4* out4 = reinterpret_cast<float4*>(acc_out + ((size_t)b * H + h0) * dv);
  for (int e = rank * per + tid; e < min((rank + 1) * per, n_out); e += kConsumers) {
    const int g = e / q4;
    const float4* src = reinterpret_cast<const float4*>(acc_s + g * L.ap) + (e - g * q4);
    float4 x[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) x[r] = *cluster.map_shared_rank(src, r);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < C) {
        const float w = w_s[r * kTileHeads + g];
        a.x += x[r].x * w;
        a.y += x[r].y * w;
        a.z += x[r].z * w;
        a.w += x[r].w * w;
      }
    }
    out4[e] = a;
  }
  cluster.sync();                              // no block leaves while read
}

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// K (or V) pages as a 3-D tensor (d, Hkv, B*P*T token rows); one box is
// box_d of one kv head's d elements for box_t token rows, landing as a dense
// [box_t][box_d] tile (the head-tiled kernel's: 128-byte rows, swizzled);
// columns and rows past the tensor come zero-filled
template <typename T>
cudaError_t page_map(CUtensorMap* map, const void* base, int rows, int Hkv, int d,
                     int box_d, int box_t,
                     CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)Hkv, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)d * sizeof(T),
                                 (cuuint64_t)Hkv * d * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)box_d, 1u, (cuuint32_t)box_t};
  const cuuint32_t step[3] = {1u, 1u, 1u};
  const CUresult r = encode(
      map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(base), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, bool kTma>
int launch_path(const float* q, const T* k, const T* v, const CUtensorMap& k_map,
                const CUtensorMap& v_map, const int* lens, float* m, float* l,
                float* acc, float* pm, float* pl, int B, int H, int Hkv, int P,
                int T_, int dk, int dv, float scale, float softcap, size_t smem,
                cudaStream_t stream) {
  auto kern = paged_attn_kernel<T, kTma>;
  static size_t smem_set = 0;                  // per instantiation
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hkv, B, min(P, kMaxCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = min(P, kMaxCluster);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, q, k, v, k_map, v_map, lens, m, l,
                                     acc, pm, pl, H, Hkv, P, T_, dk, dv, scale,
                                     softcap);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// clusters of c blocks of the head-tiled kernel that fit on the card at
// once with `smem` bytes a block (asked once per size and count)
template <typename T>
int tiled_clusters_that_fit(size_t smem, int c) {
  static struct { size_t smem; int c, n; } seen[64];
  static int n_seen = 0;
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].smem == smem && seen[i].c == c) return seen[i].n;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, c);
  cfg.blockDim = dim3(kTileThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = c;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, paged_attn_tiled_kernel<T>, &cfg) != cudaSuccess) {
    (void)cudaGetLastError();
    n = 0;
  }
  if (n_seen < 64) seen[n_seen++] = {smem, c, n};
  return n;
}

// The head-tiled launch's plan: its shared memory set on the kernel, a
// check of the kernel's registers, and the cluster size C it takes, with
// the clusters of c = 1..kMaxCluster blocks that fit at once in fits[c - 1]
// (0 where c > min(P, kMaxCluster)).  Returns C, or a cudaError_t negated.
template <typename T>
int tiled_plan(const TiledLayout& L, int B, int H, int Hkv, int P, int T_,
               int* fits) {
  auto kern = paged_attn_tiled_kernel<T>;
  static size_t smem_set = 0;                  // per instantiation
  static int regs = -1;
  if (L.total > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (e != cudaSuccess) return -(int)e;
    smem_set = L.total;
  }
  if (regs < 0) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, kern);
    if (e != cudaSuccess) return -(int)e;
    regs = a.numRegs;
  }
  // setmaxnreg.inc waits until the producers' freed registers cover the
  // consumers' rise, 128 (R - 56) >= 256 (224 - R), so R >= 168; a build
  // that gave the kernel fewer would hang at launch, so refuse it
  if ((kTileThreads - kConsumers) * (regs - kProducerRegs) <
      kConsumers * (kConsumerRegs - regs))
    return -(int)cudaErrorInvalidConfiguration;
  // the cluster size: least waves x (ring items a rank + a wave's fixed cost)
  const int tiles = (H / Hkv + kTileHeads - 1) / kTileHeads;
  const long clusters = (long)Hkv * tiles * B;
  const long page_items = 2L * ((T_ + L.tc - 1) / L.tc);
  int C = 1;
  long best = -1;
  for (int c = kMaxCluster; c >= 1; --c) {
    const int fit = c <= P ? tiled_clusters_that_fit<T>(L.total, c) : 0;
    if (fits) fits[c - 1] = fit;
    if (fit <= 0) continue;
    const long cost = (clusters + fit - 1) / fit *
                      ((P + c - 1) / c * page_items + kTileFixedItems);
    if (best < 0 || cost < best) {
      best = cost;
      C = c;
    }
  }
  return C;
}

// the head-tiled kernel: q rows and pages through bulk and TMA copies only
// (16-byte rows on 16-byte aligned bases, dk <= kTileDk)
template <typename T>
int launch_tiled(const float* q, const void* k, const void* v, const int* lens,
                 float* m, float* l, float* acc, float* pm, float* pl, int B, int H,
                 int Hkv, int P, int T_, int dk, int dv, float scale, float softcap,
                 cudaStream_t stream) {
  const TiledLayout L = tiled_layout<T>(T_, dk, dv);
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  if ((dk * sizeof(T)) % 16 != 0 || (dv * sizeof(T)) % 16 != 0 || align % 16 != 0 ||
      dk > kTileDk)
    return (int)cudaErrorInvalidValue;
  CUtensorMap k_map{}, v_map{};
  const int rows = B * P * T_, bw = kSwz / (int)sizeof(T);
  cudaError_t e = page_map<T>(&k_map, k, rows, Hkv, dk, bw, L.tc, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = page_map<T>(&v_map, v, rows, Hkv, dv, bw, L.tc, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return (int)e;
  const int C = tiled_plan<T>(L, B, H, Hkv, P, T_, nullptr);
  if (C < 0) return -C;
  const int tiles = (H / Hkv + kTileHeads - 1) / kTileHeads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hkv * tiles, B, C);
  cfg.blockDim = dim3(kTileThreads);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = C;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, paged_attn_tiled_kernel<T>, q, k_map, v_map, lens, m, l,
                         acc, pm, pl, H, Hkv, P, T_, dk, dv, scale, softcap);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const float* q, const void* k, const void* v, const int* lens, float* m,
           float* l, float* acc, float* pm, float* pl, int B, int H, int Hkv, int P,
           int T_, int dk, int dv, float scale, float softcap, int page_stats,
           cudaStream_t stream) {
  if (P < 1 || Hkv < 1 || H % Hkv != 0 || dv > kMaxDv)
    return (int)cudaErrorInvalidValue;
  if (!page_stats) pm = pl = nullptr;
  if (H / Hkv > kMaxG)
    return launch_tiled<T>(q, k, v, lens, m, l, acc, pm, pl, B, H, Hkv, P, T_, dk, dv,
                           scale, softcap, stream);
  const size_t smem = layout<T>(H / Hkv, T_, dk, dv).total;
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  CUtensorMap k_map{}, v_map{};
  // tensor copies need 16-byte rows on 16-byte aligned bases, and box
  // sides of at most 256 elements
  const uintptr_t align = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  const bool tma = (dk * sizeof(T)) % 16 == 0 && (dv * sizeof(T)) % 16 == 0 &&
                   align % 16 == 0 && T_ <= 256 && dk <= 256 && dv <= 256;
  if (tma) {
    const int rows = B * P * T_;
    cudaError_t e = page_map<T>(&k_map, k, rows, Hkv, dk, dk, T_);
    if (e == cudaSuccess) e = page_map<T>(&v_map, v, rows, Hkv, dv, dv, T_);
    if (e != cudaSuccess) return (int)e;
    return launch_path<T, true>(q, kt, vt, k_map, v_map, lens, m, l, acc, pm, pl, B,
                                H, Hkv, P, T_, dk, dv, scale, softcap, smem, stream);
  }
  return launch_path<T, false>(q, kt, vt, k_map, v_map, lens, m, l, acc, pm, pl, B, H,
                               Hkv, P, T_, dk, dv, scale, softcap, smem, stream);
}

}  // namespace


extern "C" int paged_attn_smem_bytes(int kv_is_bf16, int G, int T_, int dk, int dv) {
  if (G > kMaxG)
    return kv_is_bf16 ? (int)tiled_layout<__nv_bfloat16>(T_, dk, dv).total
                      : (int)tiled_layout<float>(T_, dk, dv).total;
  return kv_is_bf16 ? (int)layout<__nv_bfloat16>(G, T_, dk, dv).total
                    : (int)layout<float>(G, T_, dk, dv).total;
}

// the head-tiled kernel's cluster size at a shape, and the clusters of each
// size that fit (``fits``: kMaxCluster ints), as its launch would choose
extern "C" int paged_attn_tiled_plan(int kv_is_bf16, int B, int H, int Hkv, int P,
                                     int T_, int dk, int dv, int* fits) {
  if (kv_is_bf16)
    return tiled_plan<__nv_bfloat16>(tiled_layout<__nv_bfloat16>(T_, dk, dv), B, H, Hkv, P,
                                     T_, fits);
  return tiled_plan<float>(tiled_layout<float>(T_, dk, dv), B, H, Hkv, P, T_, fits);
}

extern "C" int paged_attn_launch(const float* q, const void* k, const void* v,
                                 const int* lens, float* m, float* l, float* acc,
                                 float* page_m, float* page_l, int B, int H,
                                 int Hkv, int P, int T_, int dk, int dv,
                                 int kv_is_bf16, float scale, float softcap,
                                 int page_stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_is_bf16)
    return launch<__nv_bfloat16>(q, k, v, lens, m, l, acc, page_m, page_l, B, H,
                                 Hkv, P, T_, dk, dv, scale, softcap, page_stats, s);
  return launch<float>(q, k, v, lens, m, l, acc, page_m, page_l, B, H, Hkv, P,
                       T_, dk, dv, scale, softcap, page_stats, s);
}
