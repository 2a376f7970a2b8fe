// Causal or full GQA flash attention, backward (dq, dk, dv), for Hopper
// (sm_90a).
//
// Replaces: XLA's gradient of src/repro/models/modules.py:207
// `_chunked_causal_attention`, the jnp streaming softmax that the JAX
// package differentiates with jax.value_and_grad; the Pallas kernel
// src/repro/kernels/flash_attention.py:78 has no backward.
//
// Bound on an H100: operations.  Five products of the forward's size
// (S = Q K^T, dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q) against the
// forward's two: at olmo-1b's training shape (2, 4096, 16, 128) bf16 causal
// that is 2.5 x 137,472,507,904 = 343,681,269,760 flops, 0.3475 ms at 989
// TFLOP/s, while q, k, v, o, dO read and dq, dk, dv written (~268 MB) take
// 0.080 ms at 3.35 TB/s.
//
// Design: a simple kernel that is right, deterministic and free of atomics,
// so two calls give the same bits; wgmma, TMA and a fused single pass are
// work for a redesign.  Three launches:
//   (a) delta: D_r = sum_d dO[r, d] O[r, d] in f32, one warp a (b, row,
//       head);
//   (b) dk/dv: one CTA per (key tile, KV head, batch row) keeps its tile's
//       dK and dV in registers and walks, for each of the g query heads of
//       the group, the query tiles that can see the tile: it rebuilds
//       S^T = K Q^T and dP^T = V dO^T, then P^T = exp2(S^T scale log2 e -
//       lse log2 e) and dS^T = P^T (dP^T - D), and adds P^T dO to dV and
//       dS^T Q to dK.  The GQA sum over the group stays inside the CTA;
//   (c) dq: one CTA per (query tile, head, batch row) keeps its tile's dQ in
//       registers and walks the key tiles it can see, rebuilding S, P, dP
//       and dS the same way and adding dS K.
// Masked entries (a key past the row under causal masking, a key or row at
// or past S) get P = 0, so rows and keys past S add nothing, and rows and
// keys past S are not stored.  dq and dk carry the softmax scale.
//
// Two routes for (b) and (c), chosen by dtype and D:
//   bf16 at D = 64, 96, 128 (every model's training shape): products on the
//       tensor cores with mma.sync m16n8k16, bf16 operands and f32
//       accumulators (namespace tc below); P and dS are rounded to bf16
//       before their products, as the forward rounds P before P V;
//   f32, and bf16 at other D: SIMT products in f32 (bf16 inputs widened as
//       they are staged), so f32 inputs keep f32 results.  K, V, Q and dO
//       tiles are staged in shared memory as f32 with 16-byte loads; a lane
//       owns kBlock / 32 rows and kBlock / 8 columns of each score tile (8
//       FMAs for each value read from shared memory), and P^T, dS^T and dS
//       pass through a per-warp shared tile to the accumulating products.
//       The tile is 64 rows at D <= 128 and 32 above, so every D up to 256
//       fits in a CTA (at most 170,496 bytes of shared memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void load8(const float* src, float* dst) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* dst, const float* x) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* x) {
  uint4 u;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// Rows row0 .. row0 + rows - 1 of a (seq, ., d) operand (consecutive rows
// `src_row` elements apart) into shared memory as f32, `stride` floats a
// row; rows at or past seq as zeros.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int stride, const T* src,
                                      size_t src_row, int row0, int rows,
                                      int seq, int d) {
  const int chunks = d / 8;
  for (int c = threadIdx.x; c < rows * chunks; c += kThreads) {
    const int r = c / chunks;
    const int e = (c - r * chunks) * 8;
    float x[8];
    if (row0 + r < seq) {
      load8(src + (size_t)(row0 + r) * src_row + e, x);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = 0.f;
    }
    store8(dst + r * stride + e, x);
  }
}

// acc[a][c] = sum_{e < d} A[a0 + 4a][e] * B[b0 + 8c][e], both in shared
// memory, `stride` floats a row.
template <int kA, int kC>
__device__ __forceinline__ void dot_tile(const float* A, const float* B,
                                         int stride, int a0, int b0, int d,
                                         float (&acc)[kA][kC]) {
#pragma unroll
  for (int a = 0; a < kA; ++a)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[a][c] = 0.f;
  for (int e = 0; e < d; e += 8) {
    float af[kA][8];
#pragma unroll
    for (int a = 0; a < kA; ++a) load8(A + (a0 + 4 * a) * stride + e, af[a]);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float bf[8];
      load8(B + (b0 + 8 * c) * stride + e, bf);
#pragma unroll
      for (int a = 0; a < kA; ++a)
#pragma unroll
        for (int x = 0; x < 8; ++x) acc[a][c] = fmaf(af[a][x], bf[x], acc[a][c]);
    }
  }
}

// acc[a][g * 8 + x] += sum_{t < kT} P[a0 + 4a][t] * B[t][g * 64 + cl * 8 + x]
// over the columns below d: the lane's columns are g * 64 + cl * 8 + [0, 8).
template <int kA, int kT, int kDGroups>
__device__ __forceinline__ void acc_tile(const float* P, int pstride,
                                         const float* B, int stride, int a0,
                                         int cl, int d,
                                         float (&acc)[kA][kDGroups * 8]) {
#pragma unroll 4
  for (int t = 0; t < kT; ++t) {
    float pr[kA];
#pragma unroll
    for (int a = 0; a < kA; ++a) pr[a] = P[(a0 + 4 * a) * pstride + t];
#pragma unroll
    for (int g = 0; g < kDGroups; ++g) {
      const int col = g * 64 + cl * 8;
      if (col < d) {
        float bf[8];
        load8(B + t * stride + col, bf);
#pragma unroll
        for (int a = 0; a < kA; ++a)
#pragma unroll
          for (int x = 0; x < 8; ++x)
            acc[a][g * 8 + x] = fmaf(pr[a], bf[x], acc[a][g * 8 + x]);
      }
    }
  }
}

// Writes acc * scale to rows r0 + 4a (those below seq) of a (seq, ., d)
// output whose rows are `row` elements apart, at the lane's columns.
template <typename T, int kA, int kDGroups>
__device__ __forceinline__ void store_rows(T* dst, size_t row, int r0,
                                           int seq, int cl, int d,
                                           float scale,
                                           const float (&acc)[kA][kDGroups * 8]) {
#pragma unroll
  for (int a = 0; a < kA; ++a) {
    const int r = r0 + 4 * a;
    if (r >= seq) continue;
#pragma unroll
    for (int g = 0; g < kDGroups; ++g) {
      const int col = g * 64 + cl * 8;
      if (col < d) {
        float x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = acc[a][g * 8 + i] * scale;
        store8(dst + (size_t)r * row + col, x);
      }
    }
  }
}

// (a) delta[b, head, s] = sum_d dO * O over one row of (batch, seq, h, d):
// one warp a row, rows numbered (b * seq + s) * h + head.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_delta_kernel(const T* __restrict__ out,
                                 const T* __restrict__ dout,
                                 float* __restrict__ delta, int rows, int seq,
                                 int h, int d) {
  const int row = (int)((blockIdx.x * (size_t)kThreads + threadIdx.x) / 32);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + (size_t)row * d;
  const T* g = dout + (size_t)row * d;
  float acc = 0.f;
  for (int e = lane * 8; e < d; e += 256) {
    float of[8], gf[8];
    load8(o + e, of);
    load8(g + e, gf);
#pragma unroll
    for (int x = 0; x < 8; ++x) acc = fmaf(of[x], gf[x], acc);
  }
#pragma unroll
  for (int o2 = 16; o2 > 0; o2 >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o2);
  if (lane == 0) {
    const int head = row % h;
    const int s = (row / h) % seq;
    const int b = row / (h * seq);
    delta[((size_t)b * h + head) * seq + s] = acc;
  }
}

template <int kBlock>
struct Layout {
  static constexpr int kA = kBlock / 32;        // rows of a score tile a lane owns
  static constexpr int kC = kBlock / 8;         // columns of it a lane owns
  static constexpr int kPStride = kBlock + 4;   // floats a row of a P tile
};

template <int kBlock>
size_t smem_bytes(int d, int p_tiles) {
  return ((size_t)4 * kBlock * (d + 4) + (size_t)p_tiles * kBlock * (kBlock + 4) +
          2 * kBlock) * sizeof(float);
}

// (b) One CTA per (key tile, KV head, batch row): dK and dV of its keys.
template <typename T, int kBlock, int kDGroups>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v,
                                const T* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                T* __restrict__ dk, T* __restrict__ dv, int seq,
                                int h, int hkv, int d, int causal,
                                float sm_scale) {
  using L = Layout<kBlock>;
  constexpr int kA = L::kA, kC = L::kC, kPStride = L::kPStride;
  const int kt = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = h / hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = lane >> 3;  // the lane's keys: key0 + 4a
  const int cl = lane & 7;   // the lane's q rows in a score tile: cl + 8c
  const int key0 = warp * (kBlock / 8) + rg;
  const int stride = d + 4;

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                       // (kBlock, stride)
  float* v_s = k_s + kBlock * stride;
  float* q_s = v_s + kBlock * stride;
  float* do_s = q_s + kBlock * stride;
  float* pt_s = do_s + kBlock * stride;    // P^T (kBlock keys, kPStride)
  float* dst_s = pt_s + kBlock * kPStride;  // dS^T
  float* lse_s = dst_s + kBlock * kPStride;  // (kBlock,), base 2
  float* delta_s = lse_s + kBlock;

  const int k0 = kt * kBlock;
  const size_t q_row = (size_t)h * d;
  const size_t kv_row = (size_t)hkv * d;
  const size_t kv_off = (size_t)b * seq * kv_row + (size_t)kvh * d;
  stage(k_s, stride, k + kv_off, kv_row, k0, kBlock, seq, d);
  stage(v_s, stride, v + kv_off, kv_row, k0, kBlock, seq, d);

  float dk_acc[kA][kDGroups * 8], dv_acc[kA][kDGroups * 8];
#pragma unroll
  for (int a = 0; a < kA; ++a)
#pragma unroll
    for (int x = 0; x < kDGroups * 8; ++x) dk_acc[a][x] = dv_acc[a][x] = 0.f;

  const float scale_log2 = sm_scale * kLog2e;
  const int n_tiles = (seq + kBlock - 1) / kBlock;
  // Query tiles have the key tiles' size: under causal masking the first
  // one that sees this key tile is its diagonal.
  const int first_q = causal ? kt : 0;
  for (int hh = 0; hh < group; ++hh) {
    const int head = kvh * group + hh;
    const size_t q_off = (size_t)b * seq * q_row + (size_t)head * d;
    const float* lse_h = lse + ((size_t)b * h + head) * seq;
    const float* delta_h = delta + ((size_t)b * h + head) * seq;
    for (int qt = first_q; qt < n_tiles; ++qt) {
      const int q0 = qt * kBlock;
      __syncthreads();  // the previous tile is consumed (and K, V staged)
      stage(q_s, stride, q + q_off, q_row, q0, kBlock, seq, d);
      stage(do_s, stride, dout + q_off, q_row, q0, kBlock, seq, d);
      for (int r = threadIdx.x; r < kBlock; r += kThreads) {
        const bool in = q0 + r < seq;
        lse_s[r] = in ? lse_h[q0 + r] * kLog2e : 0.f;
        delta_s[r] = in ? delta_h[q0 + r] : 0.f;
      }
      __syncthreads();

      float st[kA][kC], dpt[kA][kC];
      dot_tile<kA, kC>(k_s, q_s, stride, key0, cl, d, st);
      dot_tile<kA, kC>(v_s, do_s, stride, key0, cl, d, dpt);
#pragma unroll
      for (int a = 0; a < kA; ++a) {
        const int key = k0 + key0 + 4 * a;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int r = cl + 8 * c;
          const int row = q0 + r;
          const bool masked = key >= seq || row >= seq || (causal && key > row);
          const float p = masked ? 0.f : exp2f(fmaf(st[a][c], scale_log2, -lse_s[r]));
          pt_s[(key0 + 4 * a) * kPStride + r] = p;
          dst_s[(key0 + 4 * a) * kPStride + r] = p * (dpt[a][c] - delta_s[r]);
        }
      }
      __syncwarp();  // a warp reads only its own keys' rows of P^T and dS^T
      acc_tile<kA, kBlock, kDGroups>(pt_s, kPStride, do_s, stride, key0, cl, d, dv_acc);
      acc_tile<kA, kBlock, kDGroups>(dst_s, kPStride, q_s, stride, key0, cl, d, dk_acc);
    }
  }
  const size_t out_off = (size_t)b * seq * kv_row + (size_t)kvh * d;
  store_rows<T, kA, kDGroups>(dk + out_off, kv_row, k0 + key0, seq, cl, d, sm_scale, dk_acc);
  store_rows<T, kA, kDGroups>(dv + out_off, kv_row, k0 + key0, seq, cl, d, 1.f, dv_acc);
}

// (c) One CTA per (query tile, head, batch row): dQ of its rows.
template <typename T, int kBlock, int kDGroups>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              T* __restrict__ dq, int seq, int h, int hkv,
                              int d, int causal, float sm_scale) {
  using L = Layout<kBlock>;
  constexpr int kA = L::kA, kC = L::kC, kPStride = L::kPStride;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = lane >> 3;  // the lane's rows: row0 + 4a
  const int cl = lane & 7;   // the lane's keys in a score tile: cl + 8c
  const int row0 = warp * (kBlock / 8) + rg;
  const int stride = d + 4;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                       // (kBlock, stride)
  float* do_s = q_s + kBlock * stride;
  float* k_s = do_s + kBlock * stride;
  float* v_s = k_s + kBlock * stride;
  float* ds_s = v_s + kBlock * stride;     // dS (kBlock rows, kPStride)
  float* lse_s = ds_s + kBlock * kPStride;  // (kBlock,), base 2
  float* delta_s = lse_s + kBlock;

  const int q0 = qt * kBlock;
  const size_t q_row = (size_t)h * d;
  const size_t kv_row = (size_t)hkv * d;
  const size_t q_off = (size_t)b * seq * q_row + (size_t)head * d;
  const size_t kv_off = (size_t)b * seq * kv_row + (size_t)kvh * d;
  stage(q_s, stride, q + q_off, q_row, q0, kBlock, seq, d);
  stage(do_s, stride, dout + q_off, q_row, q0, kBlock, seq, d);
  const float* lse_h = lse + ((size_t)b * h + head) * seq;
  const float* delta_h = delta + ((size_t)b * h + head) * seq;
  for (int r = threadIdx.x; r < kBlock; r += kThreads) {
    const bool in = q0 + r < seq;
    lse_s[r] = in ? lse_h[q0 + r] * kLog2e : 0.f;
    delta_s[r] = in ? delta_h[q0 + r] : 0.f;
  }

  float dq_acc[kA][kDGroups * 8];
#pragma unroll
  for (int a = 0; a < kA; ++a)
#pragma unroll
    for (int x = 0; x < kDGroups * 8; ++x) dq_acc[a][x] = 0.f;

  const float scale_log2 = sm_scale * kLog2e;
  const int n_kv = causal ? qt + 1 : (seq + kBlock - 1) / kBlock;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBlock;
    __syncthreads();  // the previous tiles are consumed (and Q, dO staged)
    stage(k_s, stride, k + kv_off, kv_row, k0, kBlock, seq, d);
    stage(v_s, stride, v + kv_off, kv_row, k0, kBlock, seq, d);
    __syncthreads();

    float s[kA][kC], dp[kA][kC];
    dot_tile<kA, kC>(q_s, k_s, stride, row0, cl, d, s);
    dot_tile<kA, kC>(do_s, v_s, stride, row0, cl, d, dp);
#pragma unroll
    for (int a = 0; a < kA; ++a) {
      const int r = row0 + 4 * a;
      const int row = q0 + r;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int key = k0 + cl + 8 * c;
        const bool masked = key >= seq || row >= seq || (causal && key > row);
        const float p = masked ? 0.f : exp2f(fmaf(s[a][c], scale_log2, -lse_s[r]));
        ds_s[r * kPStride + cl + 8 * c] = p * (dp[a][c] - delta_s[r]);
      }
    }
    __syncwarp();  // a warp reads only its own rows of dS
    acc_tile<kA, kBlock, kDGroups>(ds_s, kPStride, k_s, stride, row0, cl, d, dq_acc);
  }
  store_rows<T, kA, kDGroups>(dq + q_off, q_row, q0 + row0, seq, cl, d, sm_scale, dq_acc);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// (a), shared by both routes.
template <typename T>
int launch_delta(const void* out, const void* dout, float* delta, int batch,
                 int seq, int h, int d, cudaStream_t stream) {
  const int rows = batch * seq * h;
  const int blocks = (int)(((size_t)rows * 32 + kThreads - 1) / kThreads);
  flash_attention_bwd_delta_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, rows,
      seq, h, d);
  return (int)cudaGetLastError();
}

// (b) and (c) on the SIMT route.
template <typename T, int kBlock, int kDGroups>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           int batch, int seq, int h, int hkv, int d, int causal,
           float sm_scale, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  auto dkdv = flash_attention_bwd_dkdv_kernel<T, kBlock, kDGroups>;
  auto dqk = flash_attention_bwd_dq_kernel<T, kBlock, kDGroups>;
  const size_t dkdv_smem = smem_bytes<kBlock>(d, 2);
  const size_t dq_smem = smem_bytes<kBlock>(d, 1);
  cudaError_t err = allow_smem(dkdv, dkdv_smem);
  if (err == cudaSuccess) err = allow_smem(dqk, dq_smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (seq + kBlock - 1) / kBlock;
  dkdv<<<dim3(n_tiles, hkv, batch), kThreads, dkdv_smem, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      seq, h, hkv, d, causal, sm_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dqk<<<dim3(n_tiles, h, batch), kThreads, dq_smem, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dq), seq, h, hkv, d,
      causal, sm_scale);
  return (int)cudaGetLastError();
}

// ---- bf16 at D = 64, 96, 128: products on the tensor cores ----
//
// One warp a 16-row strip: the dk/dv CTA's 4 warps own 16 keys each of its
// 64-key tile, the dq CTA's 4 warps 16 query rows each of its 64-row tile,
// and both walk 64-row (64-key) tiles of the other side.  Operands are
// staged in shared memory as bf16, rows padded by 16 bytes so that ldmatrix
// reads them without bank conflicts; a product whose B operand has its k
// dimension along the rows (P^T dO, dS^T Q, dS K) reads it with
// ldmatrix.trans.  S^T (S), dP^T (dP), P and dS stay in registers in the
// accumulator layout, which is also the A fragment layout of the next
// product once rounded to bf16.
namespace tc {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBlock = 64;

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b for one m16n8k16 tile.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows row0 .. row0 + kBlock - 1 of a (seq, ., kD) bf16 operand into shared
// memory, `stride` elements a row, with 16-byte copies; rows at or past
// seq as zeros.
template <int kD>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, int stride,
                                      const __nv_bfloat16* src, size_t src_row,
                                      int row0, int seq) {
  constexpr int kChunks = kD / 8;
  for (int c = threadIdx.x; c < kBlock * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int e = (c - r * kChunks) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq) x = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * src_row + e);
    *reinterpret_cast<uint4*>(dst + r * stride + e) = x;
  }
}

// acc[j] (j < 8: the 64 columns of a 16 x 64 tile, 8 per n tile) =
// A[a0 .. a0 + 15][0 .. kD) B[b0 .. b0 + 63][0 .. kD)^T, both row-major
// in shared memory (A's rows are the tile's rows, B's rows its columns).
template <int kD>
__device__ __forceinline__ void dot_tile(float (&acc)[8][4], uint32_t a_base,
                                         uint32_t b_base, int stride, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  const int m = lane >> 3;
  const int a_off = ((lane & 7) + 8 * (m & 1)) * stride + 8 * (m >> 1);
  const int b_off = ((lane & 7) + 8 * (m >> 1)) * stride + 8 * (m & 1);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t a[4];
    ldsm4(a, a_base + 2 * (a_off + 16 * kk));
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t b[4];
      ldsm4(b, b_base + 2 * (b_off + 16 * jj * stride + 16 * kk));
      mma(acc[2 * jj], a, b[0], b[1]);
      mma(acc[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

// acc[j] (j < kD / 8) += P[16 x 64] B[0 .. 64)[0 .. kD), where p holds P as
// bf16 A fragments (p[kk] for k columns 16 kk .. 16 kk + 15) and B is
// row-major in shared memory with its k dimension along the rows.
template <int kD>
__device__ __forceinline__ void acc_tile(float (&acc)[kD / 8][4],
                                         const uint32_t (&p)[4][4],
                                         uint32_t b_base, int stride, int lane) {
  const int m = lane >> 3;
  const int b_off = ((lane & 7) + 8 * (m & 1)) * stride + 8 * (m >> 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int jj = 0; jj < kD / 16; ++jj) {
      uint32_t b[4];
      ldsm4_t(b, b_base + 2 * (b_off + 16 * kk * stride + 16 * jj));
      mma(acc[2 * jj], p[kk], b[0], b[1]);
      mma(acc[2 * jj + 1], p[kk], b[2], b[3]);
    }
  }
}

// The A fragments of a 16 x 64 tile held in the accumulator layout.
__device__ __forceinline__ void to_frags(uint32_t (&p)[4][4], const float (&x)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    p[kk][0] = hopper::pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    p[kk][1] = hopper::pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    p[kk][2] = hopper::pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    p[kk][3] = hopper::pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// Writes acc * scale, the warp's 16 rows (r0 + lane / 4, + 8) of a
// (seq, ., kD) bf16 output, rows at or past seq skipped.
template <int kD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, size_t row, int r0,
                                           int seq, int lane, float scale,
                                           const float (&acc)[kD / 8][4]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + (lane >> 2) + 8 * half;
    if (r >= seq) continue;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r * row + 8 * j + 2 * (lane & 3)) =
          hopper::pack_bf16(acc[j][2 * half] * scale, acc[j][2 * half + 1] * scale);
  }
}

template <int kD>
constexpr size_t smem_bytes() {
  return (size_t)4 * kBlock * (kD + 8) * 2 + 2 * kBlock * sizeof(float);
}

// (b) One CTA per (key tile, KV head, batch row): dK and dV of its keys.
template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int seq,
    int h, int hkv, int causal, float sm_scale) {
  constexpr int stride = kD + 8;
  const int kt = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = h / hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int key_w = warp * 16;  // the warp's keys in the tile: key_w .. + 15

  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* v_s = k_s + kBlock * stride;
  __nv_bfloat16* q_s = v_s + kBlock * stride;
  __nv_bfloat16* do_s = q_s + kBlock * stride;
  float* lse_s = reinterpret_cast<float*>(do_s + kBlock * stride);  // base 2
  float* delta_s = lse_s + kBlock;

  const int k0 = kt * kBlock;
  const size_t q_row = (size_t)h * kD;
  const size_t kv_row = (size_t)hkv * kD;
  const size_t kv_off = (size_t)b * seq * kv_row + (size_t)kvh * kD;
  stage<kD>(k_s, stride, k + kv_off, kv_row, k0, seq);
  stage<kD>(v_s, stride, v + kv_off, kv_row, k0, seq);
  const uint32_t k_a = hopper::smem_addr(k_s + key_w * stride);
  const uint32_t v_a = hopper::smem_addr(v_s + key_w * stride);
  const uint32_t q_a = hopper::smem_addr(q_s);
  const uint32_t do_a = hopper::smem_addr(do_s);

  float dk_acc[kD / 8][4], dv_acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[j][i] = dv_acc[j][i] = 0.f;

  const float scale_log2 = sm_scale * kLog2e;
  const int n_tiles = (seq + kBlock - 1) / kBlock;
  const int first_q = causal ? kt : 0;
  // The thread's keys: key_w + lane / 4 and + 8; its columns of a score
  // tile: 8 j + 2 (lane % 4) and + 1.
  const int key_lo = k0 + key_w + (lane >> 2);
  for (int hh = 0; hh < group; ++hh) {
    const int head = kvh * group + hh;
    const size_t q_off = (size_t)b * seq * q_row + (size_t)head * kD;
    const float* lse_h = lse + ((size_t)b * h + head) * seq;
    const float* delta_h = delta + ((size_t)b * h + head) * seq;
    for (int qt = first_q; qt < n_tiles; ++qt) {
      const int q0 = qt * kBlock;
      __syncthreads();  // the previous tile is consumed (and K, V staged)
      stage<kD>(q_s, stride, q + q_off, q_row, q0, seq);
      stage<kD>(do_s, stride, dout + q_off, q_row, q0, seq);
      for (int r = threadIdx.x; r < kBlock; r += kThreads) {
        const bool in = q0 + r < seq;
        lse_s[r] = in ? lse_h[q0 + r] * kLog2e : 0.f;
        delta_s[r] = in ? delta_h[q0 + r] : 0.f;
      }
      __syncthreads();

      float st[8][4];
      dot_tile<kD>(st, k_a, q_a, stride, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 8 * j + 2 * (lane & 3) + (i & 1);
          const int key = key_lo + 8 * (i >> 1);
          const int row = q0 + r;
          const bool masked = key >= seq || row >= seq || (causal && key > row);
          st[j][i] = masked ? 0.f : exp2f(fmaf(st[j][i], scale_log2, -lse_s[r]));
        }
      uint32_t frag[4][4];
      to_frags(frag, st);
      acc_tile<kD>(dv_acc, frag, do_a, stride, lane);

      float dpt[8][4];
      dot_tile<kD>(dpt, v_a, do_a, stride, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dpt[j][i] = st[j][i] * (dpt[j][i] - delta_s[8 * j + 2 * (lane & 3) + (i & 1)]);
      to_frags(frag, dpt);
      acc_tile<kD>(dk_acc, frag, q_a, stride, lane);
    }
  }
  const size_t out_off = (size_t)b * seq * kv_row + (size_t)kvh * kD;
  store_rows<kD>(dk + out_off, kv_row, k0 + key_w, seq, lane, sm_scale, dk_acc);
  store_rows<kD>(dv + out_off, kv_row, k0 + key_w, seq, lane, 1.f, dv_acc);
}

// (c) One CTA per (query tile, head, batch row): dQ of its rows.
template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int seq, int h, int hkv, int causal,
    float sm_scale) {
  constexpr int stride = kD + 8;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row_w = warp * 16;  // the warp's rows in the tile: row_w .. + 15

  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* do_s = q_s + kBlock * stride;
  __nv_bfloat16* k_s = do_s + kBlock * stride;
  __nv_bfloat16* v_s = k_s + kBlock * stride;

  const int q0 = qt * kBlock;
  const size_t q_row = (size_t)h * kD;
  const size_t kv_row = (size_t)hkv * kD;
  const size_t q_off = (size_t)b * seq * q_row + (size_t)head * kD;
  const size_t kv_off = (size_t)b * seq * kv_row + (size_t)kvh * kD;
  stage<kD>(q_s, stride, q + q_off, q_row, q0, seq);
  stage<kD>(do_s, stride, dout + q_off, q_row, q0, seq);
  const uint32_t q_a = hopper::smem_addr(q_s + row_w * stride);
  const uint32_t do_a = hopper::smem_addr(do_s + row_w * stride);
  const uint32_t k_a = hopper::smem_addr(k_s);
  const uint32_t v_a = hopper::smem_addr(v_s);

  // The thread's rows: row_w + lane / 4 and + 8.
  const int row_lo = q0 + row_w + (lane >> 2);
  float lse2[2], dlt[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int row = row_lo + 8 * x;
    const size_t i = ((size_t)b * h + head) * seq + row;
    lse2[x] = row < seq ? lse[i] * kLog2e : 0.f;
    dlt[x] = row < seq ? delta[i] : 0.f;
  }

  float dq_acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq_acc[j][i] = 0.f;

  const float scale_log2 = sm_scale * kLog2e;
  const int n_kv = causal ? qt + 1 : (seq + kBlock - 1) / kBlock;
  for (int j0 = 0; j0 < n_kv; ++j0) {
    const int k0 = j0 * kBlock;
    __syncthreads();  // the previous tiles are consumed (and Q, dO staged)
    stage<kD>(k_s, stride, k + kv_off, kv_row, k0, seq);
    stage<kD>(v_s, stride, v + kv_off, kv_row, k0, seq);
    __syncthreads();

    float s[8][4], dp[8][4];
    dot_tile<kD>(s, q_a, k_a, stride, lane);
    dot_tile<kD>(dp, do_a, v_a, stride, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int x = i >> 1;
        const int row = row_lo + 8 * x;
        const int key = k0 + 8 * j + 2 * (lane & 3) + (i & 1);
        const bool masked = key >= seq || row >= seq || (causal && key > row);
        const float p = masked ? 0.f : exp2f(fmaf(s[j][i], scale_log2, -lse2[x]));
        dp[j][i] = p * (dp[j][i] - dlt[x]);
      }
    uint32_t frag[4][4];
    to_frags(frag, dp);
    acc_tile<kD>(dq_acc, frag, k_a, stride, lane);
  }
  store_rows<kD>(dq + q_off, q_row, q0 + row_w, seq, lane, sm_scale, dq_acc);
}

template <int kD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           int batch, int seq, int h, int hkv, int causal, float sm_scale,
           cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  auto dkdv = flash_attention_bwd_dkdv_tc_kernel<kD>;
  auto dqk = flash_attention_bwd_dq_tc_kernel<kD>;
  constexpr size_t smem = smem_bytes<kD>();
  cudaError_t err = allow_smem(dkdv, smem);
  if (err == cudaSuccess) err = allow_smem(dqk, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (seq + kBlock - 1) / kBlock;
  dkdv<<<dim3(n_tiles, hkv, batch), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq, h, hkv, causal,
      sm_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dqk<<<dim3(n_tiles, h, batch), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), seq, h, hkv, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

// (a), then (b) and (c): on the tensor cores for bf16 at D = 64, 96 and
// 128, on the SIMT route otherwise.
template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* out,
             const void* dout, const float* lse, void* dq, void* dk, void* dv,
             float* delta, int batch, int seq, int h, int hkv, int d,
             int causal, float sm_scale, cudaStream_t stream) {
  const int err = launch_delta<T>(out, dout, delta, batch, seq, h, d, stream);
  if (err) return err;
  if (std::is_same<T, __nv_bfloat16>::value) {
    if (d == 64)
      return tc::launch<64>(q, k, v, dout, lse, delta, dq, dk, dv, batch, seq,
                            h, hkv, causal, sm_scale, stream);
    if (d == 96)
      return tc::launch<96>(q, k, v, dout, lse, delta, dq, dk, dv, batch, seq,
                            h, hkv, causal, sm_scale, stream);
    if (d == 128)
      return tc::launch<128>(q, k, v, dout, lse, delta, dq, dk, dv, batch, seq,
                             h, hkv, causal, sm_scale, stream);
  }
  if (d <= 64)
    return launch<T, 64, 1>(q, k, v, dout, lse, delta, dq, dk, dv, batch, seq,
                            h, hkv, d, causal, sm_scale, stream);
  if (d <= 128)
    return launch<T, 64, 2>(q, k, v, dout, lse, delta, dq, dk, dv, batch, seq,
                            h, hkv, d, causal, sm_scale, stream);
  return launch<T, 32, 4>(q, k, v, dout, lse, delta, dq, dk, dv, batch, seq,
                          h, hkv, d, causal, sm_scale, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, dq, dk, dv
// alike).  q, out, dout, dq: (batch, seq, h, d); k, v, dk, dv: (batch, seq,
// hkv, d); lse: (batch, h, seq) f32 from the forward; delta: (batch, h, seq)
// f32 scratch.  h % hkv == 0, d % 8 == 0, d <= 256, every pointer 16-byte
// aligned.  Three launches on `stream`; returns a cudaError_t.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const float* lse,
                                   void* dq, void* dk, void* dv, float* delta,
                                   int batch, int seq, int h, int hkv, int d,
                                   int causal, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || seq <= 0 || hkv <= 0 || h % hkv || d % 8 || d <= 0 || d > 256)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, dout, lse, dq, dk, dv, delta, batch,
                           seq, h, hkv, d, causal, sm_scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, dout, lse, dq, dk, dv, delta,
                                   batch, seq, h, hkv, d, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
