// One-token decode attention through a page table, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention, the Pallas
// TPU kernel whose grid is (batch, kv_head, page) with the page axis run in
// order and the page table in scalar prefetch.
//
// Bound on an H100: device-memory bytes.  Each (sequence, kv head) reads its
// K and V rows once and does 4*g*D flops per token, so the arithmetic never
// nears the card's compute rate.  At the serving driver's shapes (batch <= 4,
// <= 48 tokens, 16 kv heads of 128) a call moves well under 1 MB, which takes
// the card less time than launching the kernel: launch latency dominates.
//
// Design: one CTA per (b, kv_head).  A loop inside the CTA walks the
// sequence's tokens in order, in place of the TPU grid's sequential page
// axis; the CTA reads page_table[b, :] and lengths[b] itself.  Each step
// stages the K and V rows of up to kChunk tokens, across as many pages as
// they span, in shared memory as f32 with 16-byte vector loads, so every row
// is read from device memory once and a page of 4 tokens does not cost a
// round of barriers of its own.  One warp per (query head, token) pair takes
// the dot product over D; the online-softmax state m, l and acc of the CTA's
// g query heads stays in shared memory in f32.  Slots at or past lengths[b]
// and slots of pages with id < 0 get no weight, and a row with no valid slot
// writes zeros.  Splitting one sequence across CTAs (flash-decoding) is left
// for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 8;  // elements per vector load; D % 8 == 0
constexpr int kChunk = 32;  // tokens staged in shared memory per step

__device__ __forceinline__ void load8(const float* src, float* dst) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

size_t smem_bytes(int g, int d) {
  // q, acc: (g, d); k, v: (kChunk, d); weights: (g, kChunk);
  // m, l, alpha: (g); mapped flags: (kChunk)
  return sizeof(float) * (2 * (size_t)g * d + 2 * (size_t)kChunk * d +
                          (size_t)g * kChunk + 3 * (size_t)g + kChunk);
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                       const KT* __restrict__ v_pool,
                       const int* __restrict__ page_table,
                       const int* __restrict__ lengths, QT* __restrict__ out,
                       int n_pages, int page_size, int hkv, int g, int d,
                       float sm_scale) {
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;                 // (g, d), scaled by sm_scale
  float* acc = q_s + g * d;          // (g, d)
  float* k_s = acc + g * d;          // (kChunk, d)
  float* v_s = k_s + kChunk * d;     // (kChunk, d)
  float* w_s = v_s + kChunk * d;     // (g, kChunk) scores, then weights
  float* m_s = w_s + g * kChunk;     // (g) running max
  float* l_s = m_s + g;              // (g) running sum
  float* a_s = l_s + g;              // (g) rescale of acc for this chunk
  int* mapped = reinterpret_cast<int*>(a_s + g);  // (kChunk) page id >= 0

  const size_t heads = (size_t)hkv * g;
  const QT* q_row = q + ((size_t)b * heads + (size_t)kh * g) * d;
  for (int i = tid; i < g * d; i += blockDim.x) {
    q_s[i] = to_f32(q_row[i]) * sm_scale;
    acc[i] = 0.f;
  }
  for (int j = tid; j < g; j += blockDim.x) {
    m_s[j] = -INFINITY;
    l_s[j] = 0.f;
  }

  const int* table = page_table + (size_t)b * n_pages;
  const int limit = min(lengths[b], n_pages * page_size);
  const int chunks = d / kVec;
  const size_t token_stride = (size_t)hkv * d;
  for (int t0 = 0; t0 < limit; t0 += kChunk) {
    const int nt = min(kChunk, limit - t0);
    __syncthreads();  // the previous chunk's k_s, v_s, w_s are consumed
    for (int t = tid; t < nt; t += blockDim.x)
      mapped[t] = table[(t0 + t) / page_size] >= 0;
    for (int c = tid; c < nt * chunks; c += blockDim.x) {
      const int t = c / chunks;
      const int e = (c - t * chunks) * kVec;
      const int pos = t0 + t;
      const int page_id = table[pos / page_size];
      if (page_id < 0) {  // weight 0, but 0 * stale shared memory may be NaN
        for (int i = 0; i < kVec; ++i) k_s[t * d + e + i] = v_s[t * d + e + i] = 0.f;
        continue;
      }
      const size_t off =
          ((size_t)page_id * page_size + pos % page_size) * token_stride +
          (size_t)kh * d + e;
      load8(k_pool + off, k_s + t * d + e);
      load8(v_pool + off, v_s + t * d + e);
    }
    __syncthreads();
    for (int pair = warp; pair < g * nt; pair += n_warps) {
      const int j = pair / nt;
      const int t = pair - j * nt;
      float s = -INFINITY;
      if (mapped[t]) {  // uniform across the warp
        s = 0.f;
        for (int e = lane; e < d; e += 32) s += q_s[j * d + e] * k_s[t * d + e];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      }
      if (lane == 0) w_s[j * kChunk + t] = s;
    }
    __syncthreads();
    for (int j = tid; j < g; j += blockDim.x) {
      const float m_prev = m_s[j];
      float m_new = m_prev;
      for (int t = 0; t < nt; ++t) m_new = fmaxf(m_new, w_s[j * kChunk + t]);
      if (m_new == -INFINITY) {  // no mapped slot yet: nothing to add
        for (int t = 0; t < nt; ++t) w_s[j * kChunk + t] = 0.f;
        a_s[j] = 1.f;
        continue;
      }
      float sum = 0.f;
      for (int t = 0; t < nt; ++t) {
        const float w = expf(w_s[j * kChunk + t] - m_new);  // 0 if unmapped
        w_s[j * kChunk + t] = w;
        sum += w;
      }
      const float alpha = expf(m_prev - m_new);  // 0 on the first chunk
      l_s[j] = l_s[j] * alpha + sum;
      m_s[j] = m_new;
      a_s[j] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < g * d; i += blockDim.x) {
      const int j = i / d;
      const int e = i - j * d;
      float a = acc[i] * a_s[j];
      for (int t = 0; t < nt; ++t) a += w_s[j * kChunk + t] * v_s[t * d + e];
      acc[i] = a;
    }
  }
  __syncthreads();
  QT* o_row = out + ((size_t)b * heads + (size_t)kh * g) * d;
  for (int i = tid; i < g * d; i += blockDim.x) {
    const float l = l_s[i / d];
    store(o_row + i, l > 0.f ? acc[i] / l : 0.f);
  }
}

template <typename QT, typename KT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* page_table, const int* lengths, void* out, int batch,
           int hkv, int g, int d, int n_pages, int page_size, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(g, d);
  auto kernel = paged_attention_kernel<QT, KT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(batch, hkv), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool), page_table, lengths,
      static_cast<QT*>(out), n_pages, page_size, hkv, g, d, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int paged_attention(int q_dtype, int kv_dtype, const void* q,
                               const void* k_pool, const void* v_pool,
                               const int* page_table, const int* lengths,
                               void* out, int batch, int hkv, int g, int d,
                               int n_pages, int page_size, float sm_scale,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k_pool, v_pool, page_table, lengths, out,
                                batch, hkv, g, d, n_pages, page_size, sm_scale, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16>(q, k_pool, v_pool, page_table, lengths,
                                        out, batch, hkv, g, d, n_pages,
                                        page_size, sm_scale, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch<__nv_bfloat16, float>(q, k_pool, v_pool, page_table, lengths,
                                        out, batch, hkv, g, d, n_pages,
                                        page_size, sm_scale, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, page_table,
                                                lengths, out, batch, hkv, g, d,
                                                n_pages, page_size, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory one CTA needs, so the caller can refuse shapes that
// exceed the card's 227 KB.
extern "C" long long paged_attention_smem_bytes(int g, int d) {
  return (long long)smem_bytes(g, d);
}
