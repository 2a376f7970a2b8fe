// Causal or full GQA flash attention (forward), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention, the Pallas
// TPU kernel whose grid is (batch, q head, q block) and whose body walks the
// KV blocks of one sequence in order, keeping the running max, denominator
// and accumulator in f32 (VMEM scratch there, registers here).
//
// Bound on an H100: operations.  At the prefill shapes (S = 1024-4096, D =
// 96-128) a call does about 2*S*D flops per byte it must move, hundreds to
// thousands of flops per byte, far above the ~20 f32 (or ~295 bf16) flops
// per byte at which the card's arithmetic, not its memory, is the limit.
// This first kernel does its products on the f32 SIMT units (67 TFLOP/s
// peak), not on the tensor cores (989 TFLOP/s bf16), so it stays well over
// the bf16 bound; mma.sync/wgmma, TMA and one CTA for the g query heads of a
// KV head are left for a later change.
//
// Design: one CTA of 4 warps per (b, q head, 64-row q tile).  A loop inside
// the CTA walks 64-key KV tiles in order up to the last tile the q tile can
// see (the causal bound), in place of the TPU grid's sequential axis.  Each
// step stages the K and V tiles in shared memory in the input type with
// 16-byte loads (rows padded by 16 bytes, so the 8 rows one quarter-warp
// reads fall in distinct banks).  A warp owns 16 query rows; a lane owns 4
// of them and 8 keys of the tile, so each q and k value loaded from shared
// memory feeds 8 or 4 FMAs.  The online-softmax state (m, l) and the output
// accumulator (4 rows x the lane's D/8 columns) stay in registers in f32;
// row max and sum are reduced over the 8 lanes of a row with shuffles.  The
// probabilities go through a per-warp shared tile to the P.V product.
// Any S >= 1 is taken: keys at or past S get no weight, their staged rows
// are zeroed (0 * stale shared memory may be NaN), and rows at or past S are
// not stored.  q tiles run longest-first, so the causal tail is not left to
// a few SMs at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // 4 warps
constexpr int kBlockQ = 64;            // query rows per CTA, 16 per warp
constexpr int kBlockK = 64;            // keys per KV tile
constexpr int kRows = 4;               // query rows per lane
constexpr int kCols = kBlockK / 8;     // keys per lane per tile
constexpr int kPStride = kBlockK + 8;  // floats per row of the P tile
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
__host__ __device__ constexpr int pad() { return 16 / (int)sizeof(T); }

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

__device__ __forceinline__ void copy8(const float* src, float* dst) {
  reinterpret_cast<float4*>(dst)[0] = reinterpret_cast<const float4*>(src)[0];
  reinterpret_cast<float4*>(dst)[1] = reinterpret_cast<const float4*>(src)[1];
}

__device__ __forceinline__ void copy8(const __nv_bfloat16* src, __nv_bfloat16* dst) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

__device__ __forceinline__ void zero8(float* dst) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  reinterpret_cast<float4*>(dst)[1] = make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void zero8(__nv_bfloat16* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void store8(float* dst, const float* x) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* x) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = raw;
}

// At most 218,112 bytes (f32, D = 256): every supported D fits in a CTA.
template <typename T>
size_t smem_bytes(int d) {
  const size_t stride = (size_t)d + pad<T>();
  return (size_t)(kBlockQ + 2 * kBlockK) * stride * sizeof(T) +
         (size_t)kBlockQ * kPStride * sizeof(float);
}

// kDGroups: the lane's output columns are g*64 + (lane % 8)*8 + [0, 8) for
// g < kDGroups, so D <= 64 * kDGroups; columns at or past D are skipped.
template <typename T, int kDGroups>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int seq,
                       int h, int hkv, int d, int causal, float scale_log2) {
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = lane >> 3;  // row group: rows warp*16 + rg + 4*i
  const int cl = lane & 7;   // column lane: keys c*8 + cl, d columns cl*8...
  const int stride = d + pad<T>();
  const int chunks = d / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);         // (kBlockQ, stride)
  T* k_s = q_s + kBlockQ * stride;                 // (kBlockK, stride)
  T* v_s = k_s + kBlockK * stride;                 // (kBlockK, stride)
  float* p_s = reinterpret_cast<float*>(v_s + kBlockK * stride);  // (kBlockQ, kPStride)

  const int q0 = qt * kBlockQ;
  const size_t q_row = (size_t)h * d;    // elements between tokens of q, out
  const size_t kv_row = (size_t)hkv * d;
  const T* q_base = q + (size_t)b * seq * q_row + (size_t)head * d;
  const T* k_base = k + (size_t)b * seq * kv_row + (size_t)kvh * d;
  const T* v_base = v + (size_t)b * seq * kv_row + (size_t)kvh * d;

  for (int c = tid; c < kBlockQ * chunks; c += kThreads) {
    const int r = c / chunks;
    const int e = (c - r * chunks) * 8;
    if (q0 + r < seq) copy8(q_base + (size_t)(q0 + r) * q_row + e, q_s + r * stride + e);
    else zero8(q_s + r * stride + e);
  }

  float m[kRows], l[kRows], acc[kRows][kDGroups * 8];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int x = 0; x < kDGroups * 8; ++x) acc[i][x] = 0.f;
  }

  const int row0 = warp * 16 + rg;  // the lane's rows: row0 + 4*i
  const int kv_end = causal ? min(q0 + kBlockQ, seq) : seq;
  const int n_kv = (kv_end + kBlockK - 1) / kBlockK;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();  // the previous tiles are consumed (and Q is staged)
    for (int c = tid; c < kBlockK * chunks; c += kThreads) {
      const int t = c / chunks;
      const int e = (c - t * chunks) * 8;
      if (k0 + t < seq) {
        copy8(k_base + (size_t)(k0 + t) * kv_row + e, k_s + t * stride + e);
        copy8(v_base + (size_t)(k0 + t) * kv_row + e, v_s + t * stride + e);
      } else {
        zero8(k_s + t * stride + e);
        zero8(v_s + t * stride + e);
      }
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[i][c] = 0.f;
    for (int e = 0; e < d; e += 8) {
      float qf[kRows][8];
#pragma unroll
      for (int i = 0; i < kRows; ++i) load8(q_s + (row0 + 4 * i) * stride + e, qf[i]);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float kf[8];
        load8(k_s + (c * 8 + cl) * stride + e, kf);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int x = 0; x < 8; ++x) s[i][c] = fmaf(qf[i][x], kf[x], s[i][c]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qrow = q0 + row0 + 4 * i;
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int key = k0 + c * 8 + cl;
        const bool masked = key >= seq || (causal && key > qrow);
        s[i][c] = masked ? -INFINITY : s[i][c] * scale_log2;
        tmax = fmaxf(tmax, s[i][c]);
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m[i], tmax);
      // A row with no visible key yet adds nothing (exp2(-inf) = 0).
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[i] - m_use);
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        s[i][c] = exp2f(s[i][c] - m_use);
        rsum += s[i][c];
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int x = 0; x < kDGroups * 8; ++x) acc[i][x] *= alpha;
#pragma unroll
      for (int c = 0; c < kCols; ++c) p_s[(row0 + 4 * i) * kPStride + c * 8 + cl] = s[i][c];
    }
    __syncwarp();  // a warp reads only its own rows of P

#pragma unroll 4
    for (int t = 0; t < kBlockK; ++t) {
      float pr[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pr[i] = p_s[(row0 + 4 * i) * kPStride + t];
#pragma unroll
      for (int g = 0; g < kDGroups; ++g) {
        const int col = g * 64 + cl * 8;
        if (col < d) {
          float vf[8];
          load8(v_s + t * stride + col, vf);
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int x = 0; x < 8; ++x)
              acc[i][g * 8 + x] = fmaf(pr[i], vf[x], acc[i][g * 8 + x]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qrow = q0 + row0 + 4 * i;
    if (qrow >= seq) continue;
    const float inv = 1.f / l[i];  // > 0: key 0 is visible to every row
    T* o_row = out + ((size_t)b * seq + qrow) * q_row + (size_t)head * d;
#pragma unroll
    for (int g = 0; g < kDGroups; ++g) {
      const int col = g * 64 + cl * 8;
      if (col < d) {
        float o8[8];
#pragma unroll
        for (int x = 0; x < 8; ++x) o8[x] = acc[i][g * 8 + x] * inv;
        store8(o_row + col, o8);
      }
    }
  }
}

template <typename T, int kDGroups>
int launch_groups(const void* q, const void* k, const void* v, void* out,
                  int batch, int seq, int h, int hkv, int d, int causal,
                  float sm_scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, kDGroups>;
  const size_t smem = smem_bytes<T>(d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, h, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), seq, h, hkv, d, causal,
      sm_scale * kLog2e);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int seq, int h, int hkv, int d, int causal, float sm_scale,
           cudaStream_t stream) {
  if (d <= 64)
    return launch_groups<T, 1>(q, k, v, out, batch, seq, h, hkv, d, causal, sm_scale, stream);
  if (d <= 128)
    return launch_groups<T, 2>(q, k, v, out, batch, seq, h, hkv, d, causal, sm_scale, stream);
  return launch_groups<T, 4>(q, k, v, out, batch, seq, h, hkv, d, causal, sm_scale, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and out alike).
// q, out: (batch, seq, h, d); k, v: (batch, seq, hkv, d); h % hkv == 0,
// d % 8 == 0, d <= 256, every pointer 16-byte aligned.  Returns a
// cudaError_t.
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, int batch, int seq,
                               int h, int hkv, int d, int causal,
                               float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || seq <= 0 || hkv <= 0 || h % hkv || d % 8 || d <= 0 || d > 256)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, out, batch, seq, h, hkv, d, causal, sm_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, batch, seq, h, hkv, d, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
