// Causal or full GQA flash attention (forward), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention, the Pallas
// TPU kernel whose grid is (batch, q head, q block) and whose body walks the
// KV blocks of one sequence in order, keeping the running max, denominator
// and accumulator in f32 (VMEM scratch there, registers here).
//
// Bound on an H100: operations.  At the prefill shapes (S = 1024-4096, D =
// 96-128) a call does about 2*S*D flops per byte it must move, hundreds to
// thousands of flops per byte, far above the ~295 bf16 flops per byte at
// which the tensor cores (989 TFLOP/s dense bf16), not the memory, are the
// limit.
//
// The dtype chooses the kernel, and nothing else does:
//
// bf16 (the model's prefill): a warp-specialised tensor-core kernel, the
// FlashAttention-3 core without its refinements.  One CTA per (128-row q
// tile, q head, batch row), q tiles longest-first.  One producer thread
// issues TMA loads: Q once, then K and V tiles (128 keys, 64 at D = 256)
// into a 2-stage ring in shared memory with 128-byte swizzle, each stage
// with full barriers (K, V) and an empty barrier.  Two consumer warpgroups
// of 64 q rows each compute S = Q K^T with wgmma from shared memory into
// f32 registers, run the online softmax there (base 2, the scale folded in,
// row max over the 4 lanes of a row by shuffles, row sums per lane until
// the end), round P to bf16 in registers and use it as the A operand of
// O += P V, with V as the MN-major B operand, so P never touches shared
// memory.  Only the diagonal tile and a ragged last tile are masked.
// setmaxnreg moves registers from the producer to the consumers (232 each:
// at D = 128 a thread holds S and O, 64 f32 each).  D is padded to 64, 128
// or 256 by TMA's zero fill past the tensor's extent; rows past S read as
// zeros and are not stored, and keys past S are masked.  The softmax
// weights are rounded to bf16 before P V, as the plain version does.
//
// f32 (the model's f32 checks): the first, SIMT kernel, kept so its results
// stay exact f32 (TF32 would round the products).  One CTA of 4 warps per
// (b, q head, 64-row q tile) walks 64-key KV tiles staged in shared memory
// with 16-byte loads; a lane owns 4 rows and 8 keys of a tile, so each
// value read from shared memory feeds 8 or 4 FMAs; the probabilities go
// through a per-warp shared tile to the P.V product.  Keys at or past S get
// no weight (their staged rows are zeroed) and rows at or past S are not
// stored.
//
// Both kernels write each row's log-sum-exp of the scaled scores, in f32
// and natural log, to `lse` (batch, h, seq) when it is not null: the
// backward (flash_attention_bwd.cu) rebuilds P from it.  Both keep the
// running max m in base 2 (scores times sm_scale * log2 e) and the row sum
// l of 2^(s - m), so lse = (m + log2 l) * ln 2.  A null `lse` (prefill,
// serving) writes nothing more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---- f32: SIMT kernel ----

constexpr int kThreads = 128;          // 4 warps
constexpr int kBlockQ = 64;            // query rows per CTA, 16 per warp
constexpr int kBlockK = 64;            // keys per KV tile
constexpr int kRows = 4;               // query rows per lane
constexpr int kCols = kBlockK / 8;     // keys per lane per tile
constexpr int kPStride = kBlockK + 8;  // floats per row of the P tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
__host__ __device__ constexpr int pad() { return 16 / (int)sizeof(T); }

__device__ __forceinline__ void load8(const float* src, float* dst) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void copy8(const float* src, float* dst) {
  reinterpret_cast<float4*>(dst)[0] = reinterpret_cast<const float4*>(src)[0];
  reinterpret_cast<float4*>(dst)[1] = reinterpret_cast<const float4*>(src)[1];
}

__device__ __forceinline__ void zero8(float* dst) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  reinterpret_cast<float4*>(dst)[1] = make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void store8(float* dst, const float* x) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
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
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int seq, int h, int hkv, int d,
                       int causal, float scale_log2) {
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
    if (lse != nullptr && cl == 0)
      lse[((size_t)b * h + head) * seq + qrow] = (m[i] + log2f(l[i])) * kLn2;
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
                  float* lse, int batch, int seq, int h, int hkv, int d,
                  int causal, float sm_scale, cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(out), lse, seq, h, hkv, d,
      causal, sm_scale * kLog2e);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int batch, int seq, int h, int hkv, int d, int causal,
           float sm_scale, cudaStream_t stream) {
  if (d <= 64)
    return launch_groups<T, 1>(q, k, v, out, lse, batch, seq, h, hkv, d, causal, sm_scale, stream);
  if (d <= 128)
    return launch_groups<T, 2>(q, k, v, out, lse, batch, seq, h, hkv, d, causal, sm_scale, stream);
  return launch_groups<T, 4>(q, k, v, out, lse, batch, seq, h, hkv, d, causal, sm_scale, stream);
}

// ---- bf16: warp-specialised tensor-core kernel ----

namespace tc {

using hopper::smem_addr;

constexpr int kBlockM = 128;  // q rows per CTA, 64 per consumer warpgroup
constexpr int kStages = 2;    // K/V ring depth
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // + one producer warpgroup
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 2 x 232 + 40 = 504 of 512 per lane

// kD: the instantiated head width (D rounded up to 64, 128 or 256; TMA
// fills the columns past D with zeros).  The tiles are stored as panels of
// 64 columns (128-byte rows, 128-byte swizzle), the widest a swizzled TMA
// box can be.
template <int kD>
struct Tile {
  static constexpr int kBlockN = kD == 256 ? 64 : 128;  // keys per KV tile
  static constexpr int kPanels = kD / 64;
  static constexpr int kQPanel = kBlockM * 128;   // bytes of one Q panel
  static constexpr int kKVPanel = kBlockN * 128;  // bytes of one K/V panel
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kKVBytes = kPanels * kKVPanel;
  static constexpr int kOHalves = kD == 256 ? 2 : 1;  // PV as N = 128 halves
  static constexpr int kOHalf = kD == 64 ? 32 : 64;   // f32 per thread a half
  // Q, the K ring, the V ring, 7 barriers, and 1 KB to align the base:
  // 83,008 bytes at D 64, 164,928 at 128, 197,696 at 256.
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes + 64 + 1024;
};

// One CTA per (128-row q tile, q head, batch row): warpgroups 0 and 1
// consume (64 q rows each), warpgroup 2 produces (one thread issues TMA).
template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int seq, int h, int hkv,
                          int d, int causal, float scale_log2) {
  using T = Tile<kD>;
  constexpr int kN = T::kBlockN;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  // 128-byte swizzle repeats every 1024 bytes; TMA and wgmma must agree on
  // where each pattern starts, so every tile starts on a 1024-byte boundary.
  unsigned char* base = tc_smem + ((1024 - (smem_addr(tc_smem) & 1023)) & 1023);
  unsigned char* q_s = base;
  unsigned char* k_s = q_s + T::kQBytes;            // kStages tiles
  unsigned char* v_s = k_s + kStages * T::kKVBytes;  // kStages tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + kStages * T::kKVBytes);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;   // [kStages]
  uint64_t* v_full = bars + 3;   // [kStages]
  uint64_t* empty = bars + 5;    // [kStages]

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hkv);
  const int q0 = qt * kBlockM;
  const int kv_end = causal ? min(q0 + kBlockM, seq) : seq;
  const int n_kv = (kv_end + kN - 1) / kN;
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
    // Producer: Q once, then K and V tiles into the ring, each stage reused
    // once every consumer thread has released it.
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      hopper::mbar_expect_tx(q_full, T::kQBytes);
      for (int p = 0; p < T::kPanels; ++p)
        hopper::tma_load_4d(q_s + p * T::kQPanel, &tm_q, q_full, p * 64, head, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        if (j >= kStages) hopper::mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&k_full[s], T::kKVBytes);
        for (int p = 0; p < T::kPanels; ++p)
          hopper::tma_load_4d(k_s + s * T::kKVBytes + p * T::kKVPanel, &tm_k,
                              &k_full[s], p * 64, kvh, j * kN, b);
        hopper::mbar_expect_tx(&v_full[s], T::kKVBytes);
        for (int p = 0; p < T::kPanels; ++p)
          hopper::tma_load_4d(v_s + s * T::kKVBytes + p * T::kKVPanel, &tm_v,
                              &v_full[s], p * 64, kvh, j * kN, b);
      }
    }
  } else {
    // Consumers: S = Q K^T and O += P V on the tensor cores, the online
    // softmax in registers in between.
    hopper::regs_inc<kConsumerRegs>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x / 32) & 3;
    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;  // and row0 + 8
    const int col0 = 2 * (lane & 3);  // + 8 i: the thread's accumulator columns

    float o[T::kOHalves][T::kOHalf];
#pragma unroll
    for (int x = 0; x < T::kOHalves; ++x)
#pragma unroll
      for (int i = 0; i < T::kOHalf; ++i) o[x][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums

    const uint32_t q_addr = smem_addr(q_s) + wg * 64 * 128;
    hopper::mbar_wait(q_full, 0);

    for (int j = 0; j < n_kv; ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const int k0 = j * kN;

      // S = Q K^T: both K-major; a 16-column step is 32 bytes into the
      // swizzled row, a 64-column step the next panel.
      float sc[kN / 2];
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) sc[i] = 0.f;
      hopper::mbar_wait(&k_full[s], parity);
      const uint32_t k_addr = smem_addr(k_s + s * T::kKVBytes);
      hopper::fence_regs(sc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const int p = kk / 4, c = (kk % 4) * 32;
        hopper::wgmma_ss<kN>(sc,
                     hopper::sw128_desc(q_addr + p * T::kQPanel + c, 16, 1024),
                     hopper::sw128_desc(k_addr + p * T::kKVPanel + c, 16, 1024),
                     kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      // Mask only where a key can be past S or past the row (the diagonal
      // tile and the ragged last one); the warpgroup branches as one.
      if (k0 + kN > seq || (causal && k0 + kN - 1 > q0 + wg * 64)) {
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + col0 + (i & 1);
          const int row = row0 + 8 * ((i / 2) & 1);
          if (key >= seq || (causal && key > row)) sc[i] = -INFINITY;
        }
      }

      // Online softmax in base 2 with the scale folded in.  A row's 4
      // threads (lanes 4r .. 4r + 3) reduce its max with two shuffles.
      float alpha[2], mu[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < kN / 8; ++i)
          mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx * scale_log2);
        // A row with no visible key yet adds nothing (ex2(-inf) = 0).
        mu[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = hopper::ex2(m[r] - mu[r]);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int x = 0; x < T::kOHalves; ++x)
#pragma unroll
        for (int i = 0; i < T::kOHalf; ++i) o[x][i] *= alpha[(i / 2) & 1];

      // P = exp2(S scale - m), rounded to bf16 in registers: the accumulator
      // columns 16 kk .. 16 kk + 15 are the A fragment of key step kk.
      uint32_t pa[kN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int r = jj & 1;
          const float e0 = hopper::ex2(fmaf(sc[8 * kk + 2 * jj], scale_log2, -mu[r]));
          const float e1 = hopper::ex2(fmaf(sc[8 * kk + 2 * jj + 1], scale_log2, -mu[r]));
          l[r] += e0 + e1;
          pa[kk][jj] = hopper::pack_bf16(e0, e1);
        }
      }

      // O += P V: V (keys x D, D contiguous) is the MN-major B operand; a
      // 16-key step is 16 rows (2048 bytes), panels are kKVPanel apart.
      hopper::mbar_wait(&v_full[s], parity);
      const uint32_t v_addr = smem_addr(v_s + s * T::kKVBytes);
#pragma unroll
      for (int x = 0; x < T::kOHalves; ++x) hopper::fence_regs(o[x]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
#pragma unroll
        for (int x = 0; x < T::kOHalves; ++x)
          hopper::wgmma_rs<kD == 64 ? 64 : 128>(
              o[x], pa[kk],
              hopper::sw128_desc(v_addr + x * 2 * T::kKVPanel + kk * 2048,
                                 T::kKVPanel, 1024));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int x = 0; x < T::kOHalves; ++x) hopper::fence_regs(o[x]);
      hopper::mbar_arrive(&empty[s]);
    }

    // Epilogue: the row sums over the row's 4 threads, the log-sum-exp if
    // asked, O / l in bf16, rows at or past S and columns at or past D not
    // stored.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (lse != nullptr && (lane & 3) == 0 && row0 + 8 * r < seq)
        lse[((size_t)b * h + head) * seq + row0 + 8 * r] =
            (m[r] + log2f(l[r])) * kLn2;
      l[r] = 1.f / l[r];  // > 0: key 0 is visible to every row
    }
    const size_t q_row = (size_t)h * d;
#pragma unroll
    for (int x = 0; x < T::kOHalves; ++x) {
#pragma unroll
      for (int i = 0; i < T::kOHalf; i += 2) {
        const int r = (i / 2) & 1;
        const int row = row0 + 8 * r;
        const int col = x * 128 + 8 * (i / 4) + col0;
        if (row < seq && col < d) {
          __nv_bfloat16* dst = out + ((size_t)b * seq + row) * q_row + (size_t)head * d + col;
          *reinterpret_cast<uint32_t*>(dst) =
              hopper::pack_bf16(o[x][i] * l[r], o[x][i + 1] * l[r]);
        }
      }
    }
  }
}

template <int kD>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int batch, int seq, int h, int hkv, int d, int causal,
           float sm_scale, cudaStream_t stream) {
  auto kernel = flash_attention_tc_kernel<kD>;
  constexpr int smem = Tile<kD>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv;
  if (!hopper::make_map(&tq, q, batch, seq, h, d, kBlockM) ||
      !hopper::make_map(&tk, k, batch, seq, hkv, d, Tile<kD>::kBlockN) ||
      !hopper::make_map(&tv, v, batch, seq, hkv, d, Tile<kD>::kBlockN))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((seq + kBlockM - 1) / kBlockM, h, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, seq, h, hkv, d,
      causal, sm_scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and out alike).
// q, out: (batch, seq, h, d); k, v: (batch, seq, hkv, d); h % hkv == 0,
// d % 8 == 0, d <= 256, every pointer 16-byte aligned.  lse: null, or
// (batch, h, seq) f32 for each row's log-sum-exp.  Returns a cudaError_t.
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, float* lse,
                               int batch, int seq, int h, int hkv, int d,
                               int causal, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || seq <= 0 || hkv <= 0 || h % hkv || d % 8 || d <= 0 || d > 256)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, out, lse, batch, seq, h, hkv, d, causal, sm_scale, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (d <= 64)
    return tc::launch<64>(q, k, v, out, lse, batch, seq, h, hkv, d, causal, sm_scale, s);
  if (d <= 128)
    return tc::launch<128>(q, k, v, out, lse, batch, seq, h, hkv, d, causal, sm_scale, s);
  return tc::launch<256>(q, k, v, out, lse, batch, seq, h, hkv, d, causal, sm_scale, s);
}
