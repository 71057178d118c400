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
// ridge, so the floor is the K/V bytes over 3.35 TB/s.
//
// Design.  The Pallas kernel carries (m, l, acc) across pages in output
// blocks that the TPU revisits in grid order; a CUDA grid has no order, so
// here one block owns one (batch row, kv head) and loops over the P pages
// itself, keeping the running stats in shared memory.  Per page it stages
// the valid tokens' K and V rows (16 B vector loads where the row width
// allows) into shared memory once and serves all H/Hkv query heads of the
// kv head from that tile: one warp per token computes every group's score,
// then one warp per group reduces the page max and sums, then the block
// rescales acc and adds p @ V.  A page with no valid token touches no K/V
// and reports page_m = -1e30, page_l = 0 (the reference's fully-masked
// page; with -inf the mass would be NaN).  NEG_INF stays the finite -1e30
// and alpha = exp(min(m_prev - m_cur, 0)) as in the reference.  Everything
// accumulates in float32.  This first version is simple, not fast: the
// grid is only B*Hkv blocks and loads are not pipelined (no TMA, no wgmma).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Copy n_tok rows of `width` elements (row stride `stride` elements) into a
// dense [n_tok][width] shared tile.
template <typename T>
__device__ void stage_rows(T* dst, const T* src, int n_tok, int width,
                           long stride, bool vec) {
  if (vec) {
    const int chunks = width * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < n_tok * chunks; i += blockDim.x) {
      const int t = i / chunks, c = i - t * chunks;
      reinterpret_cast<uint4*>(dst + (size_t)t * width)[c] =
          reinterpret_cast<const uint4*>(src + t * stride)[c];
    }
  } else {
    for (int i = threadIdx.x; i < n_tok * width; i += blockDim.x) {
      const int t = i / width, d = i - t * width;
      dst[(size_t)t * width + d] = src[t * stride + d];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const float* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ lens,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  float* __restrict__ acc_out, float* __restrict__ pm_out,
                  float* __restrict__ pl_out, int H, int Hkv, int P, int T_,
                  int dk, int dv, float scale, float softcap, int page_stats,
                  int vec) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                    // [G][dk]
  float* s_s = q_s + G * dk;                                      // [G][T]
  float* acc_s = s_s + G * T_;                                    // [G][dv]
  float* m_run = acc_s + G * dv;                                  // [G]
  float* l_run = m_run + G;                                       // [G]
  float* alpha_s = l_run + G;                                     // [G]
  const size_t f_bytes = align16(sizeof(float) * (size_t)(G * dk + G * T_ + G * dv + 3 * G));
  T* k_s = reinterpret_cast<T*>(smem + f_bytes);                  // [T][dk]
  T* v_s = reinterpret_cast<T*>(smem + f_bytes + align16(sizeof(T) * (size_t)T_ * dk));

  const int h0 = kvh * G;  // query heads h0..h0+G-1 read kv head h // G
  for (int i = threadIdx.x; i < G * dk; i += blockDim.x)
    q_s[i] = q[((size_t)b * H + h0) * dk + i];
  for (int i = threadIdx.x; i < G * dv; i += blockDim.x) acc_s[i] = 0.f;
  for (int g = threadIdx.x; g < G; g += blockDim.x) { m_run[g] = kNegInf; l_run[g] = 0.f; }
  __syncthreads();

  const long tok_stride_k = (long)Hkv * dk, tok_stride_v = (long)Hkv * dv;
  for (int p = 0; p < P; ++p) {
    const int n_valid = min(max(lens[b * P + p], 0), T_);
    if (n_valid == 0) {
      // fully masked page: running stats unchanged (alpha = 1, p_ij = 0)
      if (page_stats)
        for (int g = threadIdx.x; g < G; g += blockDim.x) {
          pm_out[((size_t)b * P + p) * H + h0 + g] = kNegInf;
          pl_out[((size_t)b * P + p) * H + h0 + g] = 0.f;
        }
      continue;
    }
    const size_t page = ((size_t)b * P + p) * T_;
    stage_rows(k_s, k + (page * Hkv + kvh) * dk, n_valid, dk, tok_stride_k, vec);
    stage_rows(v_s, v + (page * Hkv + kvh) * dv, n_valid, dv, tok_stride_v, vec);
    __syncthreads();

    // scores: one warp per token, all G query heads of this kv head
    for (int t = warp; t < n_valid; t += kWarps) {
      const T* kr = k_s + (size_t)t * dk;
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
        for (int d = lane; d < dk; d += 32) dot += q_s[g * dk + d] * to_f(kr[d]);
        dot = warp_sum(dot);
        if (lane == 0) {
          float s = dot * scale;
          if (softcap > 0.f) s = softcap * tanhf(s / softcap);
          s_s[g * T_ + t] = s;
        }
      }
    }
    __syncthreads();

    // page max, running-max update, p_ij = exp(s - m_cur), page partials
    for (int g = warp; g < G; g += kWarps) {
      float mp = kNegInf;
      for (int t = lane; t < n_valid; t += 32) mp = fmaxf(mp, s_s[g * T_ + t]);
      mp = warp_max(mp);
      const float m_prev = m_run[g];
      const float m_cur = fmaxf(m_prev, mp);
      float lsum = 0.f, psum = 0.f;
      for (int t = lane; t < n_valid; t += 32) {
        const float s = s_s[g * T_ + t];
        const float pij = expf(s - m_cur);
        lsum += pij;
        psum += expf(s - mp);
        s_s[g * T_ + t] = pij;
      }
      lsum = warp_sum(lsum);
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(fminf(m_prev - m_cur, 0.f));
        alpha_s[g] = alpha;
        l_run[g] = l_run[g] * alpha + lsum;
        m_run[g] = m_cur;
        if (page_stats) {
          pm_out[((size_t)b * P + p) * H + h0 + g] = mp;
          pl_out[((size_t)b * P + p) * H + h0 + g] = psum;
        }
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ V
    for (int i = threadIdx.x; i < G * dv; i += blockDim.x) {
      const int g = i / dv, d = i - g * dv;
      float a = 0.f;
      for (int t = 0; t < n_valid; ++t) a += s_s[g * T_ + t] * to_f(v_s[(size_t)t * dv + d]);
      acc_s[i] = acc_s[i] * alpha_s[g] + a;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < G * dv; i += blockDim.x)
    acc_out[((size_t)b * H + h0) * dv + i] = acc_s[i];
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    m_out[(size_t)b * H + h0 + g] = m_run[g];
    l_out[(size_t)b * H + h0 + g] = l_run[g];
  }
}

template <typename T>
size_t smem_bytes(int G, int T_, int dk, int dv) {
  return align16(sizeof(float) * (size_t)(G * dk + G * T_ + G * dv + 3 * G)) +
         align16(sizeof(T) * (size_t)T_ * dk) + align16(sizeof(T) * (size_t)T_ * dv);
}

template <typename T>
int launch(const float* q, const void* k, const void* v, const int* lens,
           float* m, float* l, float* acc, float* pm, float* pl, int B, int H,
           int Hkv, int P, int T_, int dk, int dv, float scale, float softcap,
           int page_stats, cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t smem = smem_bytes<T>(G, T_, dk, dv);
  auto kern = paged_attn_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const uintptr_t align = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  const int vec = ((dk * sizeof(T)) % 16 == 0) && ((dv * sizeof(T)) % 16 == 0) &&
                  ((Hkv * dk * sizeof(T)) % 16 == 0) && ((Hkv * dv * sizeof(T)) % 16 == 0) &&
                  (align % 16 == 0);
  kern<<<dim3(Hkv, B), kThreads, smem, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), lens, m, l, acc, pm,
      pl, H, Hkv, P, T_, dk, dv, scale, softcap, page_stats, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_attn_smem_bytes(int kv_is_bf16, int G, int T_, int dk, int dv) {
  return kv_is_bf16 ? (int)smem_bytes<__nv_bfloat16>(G, T_, dk, dv)
                    : (int)smem_bytes<float>(G, T_, dk, dv);
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
