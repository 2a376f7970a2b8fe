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
// Design: deterministic and free of atomics, so two calls give the same
// bits.  dQ sums over key tiles and dK, dV over query tiles, so one fused
// pass would need atomics (or ordered adds) for one of them; instead two
// kernels each own their output and recompute S and dP, seven products
// where a fused pass does five.  Launches:
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
//   bf16 at D = 64, 96, 128 (every model's training shape): warp-specialised
//       kernels on wgmma fed by TMA (namespace wg below), the forward's
//       machinery.  One producer warp streams tiles through a 2-stage ring
//       of 128-byte swizzled panels in shared memory (full and empty
//       mbarriers); two consumer warpgroups of 64 rows each run the score
//       products as ss wgmma (both operands K-major in shared memory) and
//       the accumulating ones as rs wgmma (P^T, dS^T or dS in registers as
//       bf16 A fragments, the other operand MN-major in shared memory), so
//       no product waits for a load and no B operand is read from shared
//       memory once per 16-row strip.  setmaxnreg gives the consumers 240
//       registers (a dk/dv thread holds dK and dV, 64 f32 each at D = 128,
//       and S^T and dP^T, 32 each).  (b) keeps 128 keys of K and V resident
//       and streams (Q, dO) tiles of 64 rows with their lse and delta; (c)
//       keeps 128 rows of Q and dO resident and streams 128-key K and V
//       tiles.  In (b) each warpgroup waits for S^T alone, forms P^T while
//       dP^T runs, and forms dS^T while dV += P^T dO runs.  D = 96 runs at
//       128 with TMA's zero fill past the tensor's extent; columns past D
//       are not stored.  Where (b) would give the card fewer CTAs than SMs
//       (few KV heads: starcoder2-3b's 2 give 32), the group's query heads
//       are split over a few CTAs that write f32 partial dK and dV, and
//       (b') sums them in split order and rounds them to bf16.  P and dS
//       are rounded to bf16 before their products, as the forward rounds P
//       before P V;
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

// ---- bf16 at D = 64, 96, 128: warp-specialised wgmma kernels fed by TMA ----
namespace wg {

using hopper::smem_addr;

constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // + one producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 2 x 240 + 24 = 504 of 512 per lane
constexpr int kStages = 2;          // ring depth
// Keys a (b) CTA, 64 per consumer warpgroup, and keys a (c) ring stage: the
// two kernels share K's and V's tensor maps.
constexpr int kKeys = 128;
constexpr int kRowsB = 64;   // (b): query rows a ring stage
constexpr int kRowsC = 128;  // (c): query rows per CTA, 64 per consumer warpgroup

// kD: the instantiated head width, 64 or 128 (D = 96 runs at 128, TMA
// filling the columns past D with zeros).  A tile is kD / 64 panels of
// 128-byte rows (64 columns), 128-byte swizzled as TMA writes them, each
// panel on a 1024-byte boundary.
template <int kD>
struct Tiles {
  static constexpr int kPanel64 = 64 * 128;    // bytes of a 64-row panel
  static constexpr int kPanel128 = 128 * 128;  // of a 128-row panel
  static constexpr int kBytes64 = kD / 64 * kPanel64;
  static constexpr int kBytes128 = kD / 64 * kPanel128;
  static constexpr int kAcc = kD / 2;  // f32 a thread holds of an m64 x kD sum
  // (b): K, V, the Q and dO ring, lse and delta a stage, 5 barriers and
  // 1 KB to align the base: 133,184 bytes at D 128, 67,648 at 64.
  static constexpr int kSmemB = 2 * kBytes128 + 2 * kStages * kBytes64 +
                                2 * kStages * kRowsB * 4 + 64 + 1024;
  // (c): Q, dO, the K and V ring, 7 barriers, 1 KB: 197,696 and 99,392.
  static constexpr int kSmemC = 2 * kBytes128 + 2 * kStages * kBytes128 + 64 + 1024;
};

// acc (=) A B^T over kD columns, issued and not waited for: A's 64 rows at
// `a` and B's kN rows at `b`, both K-major, panels a_panel and b_panel bytes
// apart.  A 16-column step is 32 bytes into the swizzled row, a 64-column
// step the next panel.
template <int kD, int kN>
__device__ __forceinline__ void product_ss(float (&acc)[kN / 2], uint32_t a,
                                           int a_panel, uint32_t b, int b_panel) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int p = kk / 4, c = (kk % 4) * 32;
    hopper::wgmma_ss<kN>(acc, hopper::sw128_desc(a + p * a_panel + c, 16, 1024),
                         hopper::sw128_desc(b + p * b_panel + c, 16, 1024), kk > 0);
  }
}

// acc += X B, issued and not waited for: X (64 x kK) as bf16 A fragments,
// B (kK rows x kD) MN-major at `b`, panels b_panel bytes apart; a 16-row
// step is 2048 bytes.
template <int kD, int kK>
__device__ __forceinline__ void product_rs(float (&acc)[kD / 2],
                                           const uint32_t (&x)[kK / 16][4],
                                           uint32_t b, int b_panel) {
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk)
    hopper::wgmma_rs<kD>(acc, x[kk], hopper::sw128_desc(b + kk * 2048, b_panel, 1024));
}

// The bf16 A fragments of a 64 x kN tile held in the accumulator layout.
template <int kN>
__device__ __forceinline__ void to_frags(uint32_t (&a)[kN / 16][4],
                                         const float (&x)[kN / 2]) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = hopper::pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

template <int kN>
__device__ __forceinline__ void zero(float (&x)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) x[i] = 0.f;
}

// Writes acc * scale, an m64 x kD sum whose thread rows are row0 and
// row0 + 8, to a bf16 output with rows `stride` elements apart from `dst`;
// rows at or past seq and columns at or past d are not stored.
template <int kD>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* dst, size_t stride,
                                           int row0, int seq, int d, int lane,
                                           float scale, const float (&acc)[kD / 2]) {
#pragma unroll
  for (int i = 0; i < kD / 2; i += 2) {
    const int row = row0 + 8 * ((i / 2) & 1);
    const int col = 8 * (i / 4) + 2 * (lane & 3);
    if (row < seq && col < d)
      *reinterpret_cast<uint32_t*>(dst + (size_t)row * stride + col) =
          hopper::pack_bf16(acc[i] * scale, acc[i + 1] * scale);
  }
}

// The same in f32, unscaled.
template <int kD>
__device__ __forceinline__ void store_f32(float* dst, size_t stride, int row0,
                                          int seq, int d, int lane,
                                          const float (&acc)[kD / 2]) {
#pragma unroll
  for (int i = 0; i < kD / 2; i += 2) {
    const int row = row0 + 8 * ((i / 2) & 1);
    const int col = 8 * (i / 4) + 2 * (lane & 3);
    if (row < seq && col < d)
      *reinterpret_cast<float2*>(dst + (size_t)row * stride + col) =
          make_float2(acc[i], acc[i + 1]);
  }
}

// (b) One CTA per (128-key tile, KV head and split, batch row): dK and dV of
// its keys, summed over the query heads of its split of the group (all of
// them when n_split is 1).  Warpgroups 0 and 1 consume (64 keys each),
// one warp of warpgroup 2 produces: K and V once, then (Q, dO, lse, delta)
// of 64 query rows a stage through the ring.
template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    float* __restrict__ part, int seq, int h, int hkv, int d, int n_split,
    int causal, float sm_scale) {
  using T = Tiles<kD>;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  // 128-byte swizzle repeats every 1024 bytes; TMA and wgmma must agree on
  // where each pattern starts, so every tile starts on a 1024-byte boundary.
  unsigned char* base = wg_smem + ((1024 - (smem_addr(wg_smem) & 1023)) & 1023);
  unsigned char* k_s = base;
  unsigned char* v_s = k_s + T::kBytes128;
  unsigned char* q_s = v_s + T::kBytes128;            // kStages tiles
  unsigned char* do_s = q_s + kStages * T::kBytes64;  // kStages tiles
  float* lse_s = reinterpret_cast<float*>(do_s + kStages * T::kBytes64);  // base 2
  float* delta_s = lse_s + kStages * kRowsB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(delta_s + kStages * kRowsB);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;             // [kStages]
  uint64_t* empty = bars + 1 + kStages;  // [kStages]

  const int k0 = blockIdx.x * kKeys;  // key tile 0, which sees every query tile, first
  const int kvh = blockIdx.y / n_split;
  const int heads = h / hkv / n_split;  // the CTA's query heads
  const int head0 = kvh * (h / hkv) + blockIdx.y % n_split * heads;
  const int b = blockIdx.z;
  const int n_q = (seq + kRowsB - 1) / kRowsB;
  // Under causal masking the first query tile that sees a key is its own.
  const int first_q = causal ? k0 / kRowsB : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: every lane of one warp stores its rows' lse (base 2) and
    // delta into the stage and arrives; lane 0's arrival also sets the bytes
    // of the Q and dO loads it issues.  A stage is reused once every
    // consumer thread has released it.
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x < kConsumers + 32) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        hopper::mbar_expect_tx(kv_full, 2 * T::kBytes128);
        for (int p = 0; p < kD / 64; ++p) {
          hopper::tma_load_4d(k_s + p * T::kPanel128, &tm_k, kv_full, p * 64, kvh, k0, b);
          hopper::tma_load_4d(v_s + p * T::kPanel128, &tm_v, kv_full, p * 64, kvh, k0, b);
        }
      }
      int it = 0;
      for (int hh = 0; hh < heads; ++hh) {
        const int head = head0 + hh;
        const float* lse_h = lse + ((size_t)b * h + head) * seq;
        const float* delta_h = delta + ((size_t)b * h + head) * seq;
        for (int qt = first_q; qt < n_q; ++qt, ++it) {
          const int s = it % kStages;
          const int q0 = qt * kRowsB;
          if (it >= kStages) hopper::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          for (int r = lane; r < kRowsB; r += 32) {
            const bool in = q0 + r < seq;
            lse_s[s * kRowsB + r] = in ? lse_h[q0 + r] * kLog2e : 0.f;
            delta_s[s * kRowsB + r] = in ? delta_h[q0 + r] : 0.f;
          }
          if (lane == 0) {
            hopper::mbar_expect_tx(&full[s], 2 * T::kBytes64);
            for (int p = 0; p < kD / 64; ++p) {
              hopper::tma_load_4d(q_s + s * T::kBytes64 + p * T::kPanel64, &tm_q,
                                  &full[s], p * 64, head, q0, b);
              hopper::tma_load_4d(do_s + s * T::kBytes64 + p * T::kPanel64, &tm_do,
                                  &full[s], p * 64, head, q0, b);
            }
          } else {
            hopper::mbar_arrive(&full[s]);
          }
        }
      }
    }
  } else {
    // Consumers: S^T = K Q^T and dP^T = V dO^T from shared memory, P^T and
    // dS^T in registers, then dV += P^T dO and dK += dS^T Q with P^T and
    // dS^T as bf16 A fragments.
    hopper::regs_inc<kConsumerRegs>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x / 32) & 3;
    const int kw = k0 + wg * 64;                   // the warpgroup's first key
    const int key_lo = kw + warp * 16 + lane / 4;  // the thread's keys: + 0, + 8
    const int col0 = 2 * (lane & 3);  // its query rows in a tile: 8 j + col0, + 1
    const float scale_log2 = sm_scale * kLog2e;
    const uint32_t k_addr = smem_addr(k_s) + wg * 64 * 128;
    const uint32_t v_addr = smem_addr(v_s) + wg * 64 * 128;

    float dk_acc[T::kAcc], dv_acc[T::kAcc];
    zero(dk_acc);
    zero(dv_acc);
    hopper::mbar_wait(kv_full, 0);

    int it = 0;
    for (int hh = 0; hh < heads; ++hh) {
      for (int qt = first_q; qt < n_q; ++qt, ++it) {
        const int s = it % kStages;
        const int q0 = qt * kRowsB;
        hopper::mbar_wait(&full[s], (it / kStages) & 1);
        // A tile whose rows all come before the warpgroup's first key adds
        // nothing under causal masking; the warpgroup branches as one.
        if (!causal || q0 + kRowsB > kw) {
          const uint32_t q_addr = smem_addr(q_s + s * T::kBytes64);
          const uint32_t do_addr = smem_addr(do_s + s * T::kBytes64);
          const float* lse2 = lse_s + s * kRowsB;
          const float* dlt = delta_s + s * kRowsB;

          float st[kRowsB / 2], dpt[kRowsB / 2];
          zero(st);
          zero(dpt);
          hopper::fence_regs(st);
          hopper::fence_regs(dpt);
          hopper::wgmma_fence();
          product_ss<kD, kRowsB>(st, k_addr, T::kPanel128, q_addr, T::kPanel64);
          hopper::wgmma_commit();
          product_ss<kD, kRowsB>(dpt, v_addr, T::kPanel128, do_addr, T::kPanel64);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();  // S^T is in; dP^T may still run
          hopper::fence_regs(st);

          // P^T = exp2(S^T scale log2 e - lse log2 e).  Mask only where a key
          // can be past a row or past S, or a row past S.
          const bool mask = (causal && kw + 63 > q0) || kw + 64 > seq || q0 + kRowsB > seq;
#pragma unroll
          for (int j = 0; j < kRowsB / 8; ++j) {
            const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + col0);
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int i = 4 * j + x;
              float p = hopper::ex2(fmaf(st[i], scale_log2, (x & 1) ? -l2.y : -l2.x));
              if (mask) {
                const int key = key_lo + 8 * (x >> 1);
                const int row = q0 + 8 * j + col0 + (x & 1);
                if (key >= seq || row >= seq || (causal && key > row)) p = 0.f;
              }
              st[i] = p;
            }
          }
          uint32_t pa[kRowsB / 16][4];
          to_frags<kRowsB>(pa, st);
          hopper::fence_regs(pa);
          hopper::fence_regs(dv_acc);
          hopper::wgmma_fence();
          product_rs<kD, kRowsB>(dv_acc, pa, do_addr, T::kPanel64);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();  // dP^T is in; dV += P^T dO may still run
          hopper::fence_regs(dpt);

          // dS^T = P^T (dP^T - delta)
          uint32_t dsa[kRowsB / 16][4];
#pragma unroll
          for (int j = 0; j < kRowsB / 8; ++j) {
            const float2 d2 = *reinterpret_cast<const float2*>(dlt + 8 * j + col0);
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int i = 4 * j + x;
              dpt[i] = st[i] * (dpt[i] - ((x & 1) ? d2.y : d2.x));
            }
          }
          to_frags<kRowsB>(dsa, dpt);
          hopper::fence_regs(dsa);
          hopper::fence_regs(dk_acc);
          hopper::wgmma_fence();
          product_rs<kD, kRowsB>(dk_acc, dsa, q_addr, T::kPanel64);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(pa);
          hopper::fence_regs(dsa);
          hopper::fence_regs(dv_acc);
          hopper::fence_regs(dk_acc);
        }
        hopper::mbar_arrive(&empty[s]);
      }
    }

    // Epilogue: bf16 dK * sm_scale and dV, or with the group split over
    // CTAs, this split's f32 partial sums for (d) to add in order.
    const size_t kv_row = (size_t)hkv * d;
    const size_t off = (size_t)b * seq * kv_row + (size_t)kvh * d;
    const int row0 = kw + warp * 16 + lane / 4;
    if (n_split == 1) {
      store_bf16<kD>(dk + off, kv_row, row0, seq, d, lane, sm_scale, dk_acc);
      store_bf16<kD>(dv + off, kv_row, row0, seq, d, lane, 1.f, dv_acc);
    } else {
      const size_t n = (size_t)gridDim.z * seq * kv_row;  // elements of dk
      float* pk = part + (size_t)(blockIdx.y % n_split) * 2 * n + off;
      store_f32<kD>(pk, kv_row, row0, seq, d, lane, dk_acc);
      store_f32<kD>(pk + n, kv_row, row0, seq, d, lane, dv_acc);
    }
  }
}

// (b') dk = sm_scale * sum of the splits' dK partials, dv = sum of their dV
// partials, in split order; four elements a thread.  part: (n_split, 2, n).
__global__ void __launch_bounds__(256)
flash_attention_bwd_dkdv_sum_kernel(const float* __restrict__ part,
                                    __nv_bfloat16* __restrict__ dk,
                                    __nv_bfloat16* __restrict__ dv, size_t n,
                                    int n_split, float sm_scale) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  float4 a = *reinterpret_cast<const float4*>(part + i);
  float4 c = *reinterpret_cast<const float4*>(part + n + i);
  for (int sp = 1; sp < n_split; ++sp) {
    const float4 x = *reinterpret_cast<const float4*>(part + sp * 2 * n + i);
    const float4 y = *reinterpret_cast<const float4*>(part + sp * 2 * n + n + i);
    a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
  }
  *reinterpret_cast<uint2*>(dk + i) =
      make_uint2(hopper::pack_bf16(a.x * sm_scale, a.y * sm_scale),
                 hopper::pack_bf16(a.z * sm_scale, a.w * sm_scale));
  *reinterpret_cast<uint2*>(dv + i) =
      make_uint2(hopper::pack_bf16(c.x, c.y), hopper::pack_bf16(c.z, c.w));
}

// (c) One CTA per (128-row query tile, head, batch row), longest causal
// rows first: dQ of its rows.  Warpgroups 0 and 1 consume (64 rows each),
// one thread of warpgroup 2 produces: Q and dO once, then K and V tiles of
// 128 keys through the ring, as the forward does.
template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int seq, int h, int hkv, int d, int causal,
    float sm_scale) {
  using T = Tiles<kD>;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* base = wg_smem + ((1024 - (smem_addr(wg_smem) & 1023)) & 1023);
  unsigned char* q_s = base;
  unsigned char* do_s = q_s + T::kBytes128;
  unsigned char* k_s = do_s + T::kBytes128;            // kStages tiles
  unsigned char* v_s = k_s + kStages * T::kBytes128;   // kStages tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + kStages * T::kBytes128);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;               // [kStages]
  uint64_t* v_full = bars + 1 + kStages;     // [kStages]
  uint64_t* empty = bars + 1 + 2 * kStages;  // [kStages]

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hkv);
  const int q0 = qt * kRowsC;
  const int kv_end = causal ? min(q0 + kRowsC, seq) : seq;
  const int n_kv = (kv_end + kKeys - 1) / kKeys;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      hopper::mbar_expect_tx(q_full, 2 * T::kBytes128);
      for (int p = 0; p < kD / 64; ++p) {
        hopper::tma_load_4d(q_s + p * T::kPanel128, &tm_q, q_full, p * 64, head, q0, b);
        hopper::tma_load_4d(do_s + p * T::kPanel128, &tm_do, q_full, p * 64, head, q0, b);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        if (j >= kStages) hopper::mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&k_full[s], T::kBytes128);
        for (int p = 0; p < kD / 64; ++p)
          hopper::tma_load_4d(k_s + s * T::kBytes128 + p * T::kPanel128, &tm_k,
                              &k_full[s], p * 64, kvh, j * kKeys, b);
        hopper::mbar_expect_tx(&v_full[s], T::kBytes128);
        for (int p = 0; p < kD / 64; ++p)
          hopper::tma_load_4d(v_s + s * T::kBytes128 + p * T::kPanel128, &tm_v,
                              &v_full[s], p * 64, kvh, j * kKeys, b);
      }
    }
  } else {
    // Consumers: S = Q K^T and dP = dO V^T from shared memory, P and dS in
    // registers, then dQ += dS K with dS as bf16 A fragments and K as the
    // MN-major B operand.
    hopper::regs_inc<kConsumerRegs>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x / 32) & 3;
    const int qw = q0 + wg * 64;                   // the warpgroup's first row
    const int row0 = qw + warp * 16 + lane / 4;   // the thread's rows: + 0, + 8
    const int col0 = 2 * (lane & 3);  // its keys in a tile: 8 j + col0, + 1
    const float scale_log2 = sm_scale * kLog2e;
    const uint32_t q_addr = smem_addr(q_s) + wg * 64 * 128;
    const uint32_t do_addr = smem_addr(do_s) + wg * 64 * 128;
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const size_t i = ((size_t)b * h + head) * seq + row;
      lse2[r] = row < seq ? lse[i] * kLog2e : 0.f;
      dlt[r] = row < seq ? delta[i] : 0.f;
    }

    float dq_acc[T::kAcc];
    zero(dq_acc);
    hopper::mbar_wait(q_full, 0);

    for (int j = 0; j < n_kv; ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const int k0 = j * kKeys;
      const uint32_t k_addr = smem_addr(k_s + s * T::kBytes128);
      const uint32_t v_addr = smem_addr(v_s + s * T::kBytes128);

      float sc[kKeys / 2], dp[kKeys / 2];
      zero(sc);
      zero(dp);
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      hopper::mbar_wait(&k_full[s], parity);
      hopper::wgmma_fence();
      product_ss<kD, kKeys>(sc, q_addr, T::kPanel128, k_addr, T::kPanel128);
      hopper::wgmma_commit();
      hopper::mbar_wait(&v_full[s], parity);  // S runs while V may still land
      product_ss<kD, kKeys>(dp, do_addr, T::kPanel128, v_addr, T::kPanel128);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // S is in; dP may still run
      hopper::fence_regs(sc);

      // P = exp2(S scale log2 e - lse log2 e), masked only where a key can
      // be past a row or past S, or a row past S.
      const bool mask = (causal && k0 + kKeys - 1 > qw) || k0 + kKeys > seq || qw + 64 > seq;
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        const int r = (i / 2) & 1;
        float p = hopper::ex2(fmaf(sc[i], scale_log2, -lse2[r]));
        if (mask) {
          const int key = k0 + 8 * (i / 4) + col0 + (i & 1);
          const int row = row0 + 8 * r;
          if (key >= seq || row >= seq || (causal && key > row)) p = 0.f;
        }
        sc[i] = p;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);

      // dS = P (dP - delta), then dQ += dS K.
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) dp[i] = sc[i] * (dp[i] - dlt[(i / 2) & 1]);
      uint32_t dsa[kKeys / 16][4];
      to_frags<kKeys>(dsa, dp);
      hopper::fence_regs(dsa);
      hopper::fence_regs(dq_acc);
      hopper::wgmma_fence();
      product_rs<kD, kKeys>(dq_acc, dsa, k_addr, T::kPanel128);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dsa);
      hopper::fence_regs(dq_acc);
      hopper::mbar_arrive(&empty[s]);
    }

    const size_t q_row = (size_t)h * d;
    store_bf16<kD>(dq + (size_t)b * seq * q_row + (size_t)head * d, q_row, row0,
                   seq, d, lane, sm_scale, dq_acc);
  }
}

inline size_t delta_floats(int batch, int seq, int h) {
  return ((size_t)batch * h * seq + 3) / 4 * 4;  // the partials start 16-byte aligned
}

// How many CTAs share a KV head's query heads in (b): the fewest (a divisor
// of the group) that give the card's SMs a CTA each, or the whole group.
inline int splits(int batch, int seq, int h, int hkv) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  const int group = h / hkv;
  const int ctas = (seq + kKeys - 1) / kKeys * hkv * batch;
  int n = 1;
  while (n < group && ctas * n < sms) {
    do ++n; while (group % n);
  }
  return n;
}

template <int kD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, float* work, void* dq, void* dk, void* dv,
           int batch, int seq, int h, int hkv, int d, int causal,
           float sm_scale, cudaStream_t stream) {
  using T = Tiles<kD>;
  using bf16 = __nv_bfloat16;
  auto dkdv = flash_attention_bwd_dkdv_wgmma_kernel<kD>;
  auto dqk = flash_attention_bwd_dq_wgmma_kernel<kD>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemB);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kSmemC);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq64, tdo64, tq128, tdo128, tk, tv;
  if (!hopper::make_map(&tq64, q, batch, seq, h, d, kRowsB) ||
      !hopper::make_map(&tdo64, dout, batch, seq, h, d, kRowsB) ||
      !hopper::make_map(&tq128, q, batch, seq, h, d, kRowsC) ||
      !hopper::make_map(&tdo128, dout, batch, seq, h, d, kRowsC) ||
      !hopper::make_map(&tk, k, batch, seq, hkv, d, kKeys) ||
      !hopper::make_map(&tv, v, batch, seq, hkv, d, kKeys))
    return (int)cudaErrorInvalidValue;
  const float* delta = work;
  float* part = work + delta_floats(batch, seq, h);
  const int n_split = splits(batch, seq, h, hkv);
  dkdv<<<dim3((seq + kKeys - 1) / kKeys, hkv * n_split, batch), kThreads,
         T::kSmemB, stream>>>(tq64, tdo64, tk, tv, lse, delta,
                              static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                              part, seq, h, hkv, d, n_split, causal, sm_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (n_split > 1) {
    const size_t n = (size_t)batch * seq * hkv * d;
    flash_attention_bwd_dkdv_sum_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0,
                                          stream>>>(
        part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, n_split, sm_scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  dqk<<<dim3((seq + kRowsC - 1) / kRowsC, h, batch), kThreads, T::kSmemC,
        stream>>>(tq128, tdo128, tk, tv, lse, delta, static_cast<bf16*>(dq), seq,
                  h, hkv, d, causal, sm_scale);
  return (int)cudaGetLastError();
}

// The route's workspace: delta, then (n_split, 2, batch, seq, hkv, d) f32
// partials of dK and dV when the group is split over CTAs.
inline size_t workspace_floats(int batch, int seq, int h, int hkv, int d) {
  const int n_split = splits(batch, seq, h, hkv);
  return delta_floats(batch, seq, h) +
         (n_split > 1 ? (size_t)n_split * 2 * batch * seq * hkv * d : 0);
}

}  // namespace wg

// The wgmma route takes bf16 at D = 64, 96 and 128; the SIMT route the rest.
inline bool on_wgmma_route(int dtype, int d) {
  return dtype == 1 && (d == 64 || d == 96 || d == 128);
}

// (a), then (b) and (c): the wgmma route or the SIMT route.
template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* out,
             const void* dout, const float* lse, void* dq, void* dk, void* dv,
             float* work, int batch, int seq, int h, int hkv, int d,
             int causal, float sm_scale, cudaStream_t stream) {
  const int err = launch_delta<T>(out, dout, work, batch, seq, h, d, stream);
  if (err) return err;
  if (on_wgmma_route(std::is_same<T, __nv_bfloat16>::value, d)) {
    if (d == 64)
      return wg::launch<64>(q, k, v, dout, lse, work, dq, dk, dv, batch, seq,
                            h, hkv, d, causal, sm_scale, stream);
    return wg::launch<128>(q, k, v, dout, lse, work, dq, dk, dv, batch, seq, h,
                           hkv, d, causal, sm_scale, stream);
  }
  if (d <= 64)
    return launch<T, 64, 1>(q, k, v, dout, lse, work, dq, dk, dv, batch, seq,
                            h, hkv, d, causal, sm_scale, stream);
  if (d <= 128)
    return launch<T, 64, 2>(q, k, v, dout, lse, work, dq, dk, dv, batch, seq,
                            h, hkv, d, causal, sm_scale, stream);
  return launch<T, 32, 4>(q, k, v, dout, lse, work, dq, dk, dv, batch, seq,
                          h, hkv, d, causal, sm_scale, stream);
}

}  // namespace

// Floats of f32 workspace that flash_attention_bwd needs for these shapes
// (dtype codes as below).
extern "C" long long flash_attention_bwd_workspace(int dtype, int batch,
                                                   int seq, int h, int hkv,
                                                   int d) {
  if (on_wgmma_route(dtype, d) && hkv > 0 && h % hkv == 0)
    return (long long)wg::workspace_floats(batch, seq, h, hkv, d);
  return (long long)batch * h * seq;
}

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, dq, dk, dv
// alike).  q, out, dout, dq: (batch, seq, h, d); k, v, dk, dv: (batch, seq,
// hkv, d); lse: (batch, h, seq) f32 from the forward; work: f32 scratch of
// flash_attention_bwd_workspace(...) floats (delta, then any partial sums).
// h % hkv == 0, d % 8 == 0, d <= 256, every pointer 16-byte aligned.  Three
// launches on `stream` (four where (b) splits a group); returns a
// cudaError_t.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const float* lse,
                                   void* dq, void* dk, void* dv, float* work,
                                   int batch, int seq, int h, int hkv, int d,
                                   int causal, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || seq <= 0 || hkv <= 0 || h % hkv || d % 8 || d <= 0 || d > 256)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, dout, lse, dq, dk, dv, work, batch,
                           seq, h, hkv, d, causal, sm_scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, dout, lse, dq, dk, dv, work,
                                   batch, seq, h, hkv, d, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
