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
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c1,
                                         int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(c1),
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
        tma_load(ks, k_map, kvh, row, &full[s]);
        tma_load(vs, v_map, kvh, row, &full[s]);
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

// K (or V) pages as a 3-D tensor (d, Hkv, B*P*T token rows); one box is one
// kv head's d elements of one page's T tokens, landing as a dense [T][d] tile
template <typename T>
cudaError_t page_map(CUtensorMap* map, const void* base, int rows, int Hkv, int d,
                     int T_) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)Hkv, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)d * sizeof(T),
                                 (cuuint64_t)Hkv * d * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)d, 1u, (cuuint32_t)T_};
  const cuuint32_t step[3] = {1u, 1u, 1u};
  const CUresult r = encode(
      map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(base), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
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

template <typename T>
int launch(const float* q, const void* k, const void* v, const int* lens, float* m,
           float* l, float* acc, float* pm, float* pl, int B, int H, int Hkv, int P,
           int T_, int dk, int dv, float scale, float softcap, int page_stats,
           cudaStream_t stream) {
  if (P < 1 || Hkv < 1 || H % Hkv != 0 || H / Hkv > kMaxG || dv > kMaxDv)
    return (int)cudaErrorInvalidValue;
  const size_t smem = layout<T>(H / Hkv, T_, dk, dv).total;
  if (!page_stats) pm = pl = nullptr;
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
    cudaError_t e = page_map<T>(&k_map, k, rows, Hkv, dk, T_);
    if (e == cudaSuccess) e = page_map<T>(&v_map, v, rows, Hkv, dv, T_);
    if (e != cudaSuccess) return (int)e;
    return launch_path<T, true>(q, kt, vt, k_map, v_map, lens, m, l, acc, pm, pl, B,
                                H, Hkv, P, T_, dk, dv, scale, softcap, smem, stream);
  }
  return launch_path<T, false>(q, kt, vt, k_map, v_map, lens, m, l, acc, pm, pl, B, H,
                               Hkv, P, T_, dk, dv, scale, softcap, smem, stream);
}

}  // namespace


extern "C" int paged_attn_smem_bytes(int kv_is_bf16, int G, int T_, int dk, int dv) {
  return kv_is_bf16 ? (int)layout<__nv_bfloat16>(G, T_, dk, dv).total
                    : (int)layout<float>(G, T_, dk, dv).total;
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
