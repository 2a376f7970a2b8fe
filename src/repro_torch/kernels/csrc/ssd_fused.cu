// The Mamba-2 SSD layer's elementwise work on either side of the SSD scan
// (K4, K4-bwd), fused, for Hopper (sm_90a).
//
// Replaces: no Pallas kernel.  The JAX package leaves this stretch of
// src/repro/models/ssm.py::ssd_layer (the causal conv, the D skip, the
// gate and the gated RMS norm) to XLA, which fuses it; the port ran it as
// some thirty unfused PyTorch ops a layer, over strided slices of the
// packed in-projection, in each of the forward, the recompute and the
// backward.  These kernels were added to move fewer bytes there.
//
// Bound on an H100: bytes.  A few flops an element against the ~20 flops
// a byte at which f32 arithmetic (67 TFLOP/s) would start to bound at
// 3.35 TB/s.  At mamba2-370m's training shape (32,768 rows, d_inner 2,048,
// conv channels 2,304, 32 heads) the least bytes are 0.46 GB for the conv
// forward, 0.81 GB for the gated norm's forward, 1.21 GB for its backward
// and 0.88 GB for the conv's backward (kernels/cost.py), so 0.137, 0.240,
// 0.361 and 0.263 ms.
//
// Design: each kernel reads its operands once, in place, with 8- or
// 16-byte loads, and writes each result once, where the next step reads
// it.
//
//   conv_silu_fwd: one thread per (4 channels, 16 time steps) of the xBC
//     columns of the packed in-projection output (bf16 or f32, read with
//     its row stride).  The depthwise causal conv of width 4 keeps its
//     3-step history in registers, accumulates in f32 from the weights
//     rounded to the input's type, applies SiLU and rounds once to the
//     input's type, as the unfused conv's output is rounded; then writes
//     x, B and C as the scan reads them: contiguous f32.
//   dt_softplus_fwd: softplus(dt + dt_bias) of the dt columns, f32, and
//     a = -exp(a_log).
//   gated_rmsnorm_fwd: one CTA per row of d_inner channels (8 a thread):
//     ys = y + D x, g = ys silu(z), out = g rsqrt(mean g^2 + eps) gamma,
//     all in f32, one rounding to the compute type on the store; the
//     row's rsqrt is kept for the backward.
//   gated_rmsnorm_bwd: one CTA per group of rows: the row's sum of
//     d(out) gamma g is reduced first, then dy (= d ys, f32, for K4-bwd)
//     and dz, written straight into the z columns of one d(proj) buffer.
//     d(gamma) and d(D) (sum over heads' channels of dys x) are summed over
//     the CTA's rows in registers and written as one partial a CTA.
//   conv_silu_bwd: the conv's pre-activation is recomputed from the saved
//     xBC for SiLU's derivative; the gradient reaching x is K4-bwd's dx
//     plus the D skip's D dy; d(xBC) goes straight into its columns of
//     d(proj), d(conv_w) to one partial a CTA.
//   dt_softplus_bwd: d(dt) = ddt softplus'(dt + dt_bias) into the dt
//     columns of d(proj); d(dt_bias) partials; d(a_log) = da a.
//   column_sum: the partials of each CTA summed in a fixed order (16 row
//     lanes a column, then a fixed tree), so the parameters' gradients do
//     not depend on scheduling; 32 columns a CTA spread the read over the
//     card.
//
// The kernels allocate nothing; the caller hands in every output and the
// partials' scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 4;              // conv width (models/ssm.py: D_CONV)
constexpr int CV = 4;             // channels a conv thread
constexpr int LANES = 32;         // channel groups of a conv CTA
constexpr int TILES = 4;          // time tiles of a conv CTA
constexpr int TT = 16;            // time steps a conv thread
constexpr int GV = 8;             // channels a gate thread, a chunk
constexpr int GATE_THREADS = 256;
constexpr int DT_THREADS = 256;
constexpr int SUM_COLS = 32;      // columns of a column_sum CTA
constexpr int SUM_LANES = 16;     // row lanes of a column_sum CTA

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_float(from_float<T>(v));
}

// 4 or 8 consecutive values at p (aligned to their size) as floats
__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load(const bf16* p, float (&v)[4]) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void load(const bf16* p, float (&v)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store(bf16* p, const float (&v)[4]) {
  uint2 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ void store(bf16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// The conv's pre-activation at one step: w[i] times x[t - 3 + i], summed
// in f32.
__device__ __forceinline__ float conv_at(const float (&w)[K][CV],
                                         const float (&x)[K][CV], int j) {
  float u = w[0][j] * x[0][j];
#pragma unroll
  for (int i = 1; i < K; ++i) u = fmaf(w[i][j], x[i][j], u);
  return u;
}

// Where this conv thread's channels go: x, B or C, and that tensor's row
// width.
struct Segment {
  long long col;
  int width;
  int which;   // 0 x, 1 B, 2 C
};

__device__ __forceinline__ Segment segment(int c, int dx, int n) {
  if (c < dx) return {c, dx, 0};
  if (c < dx + n) return {c - dx, n, 1};
  return {c - dx - n, n, 2};
}

template <typename T>
__global__ void __launch_bounds__(LANES * TILES)
conv_silu_fwd_kernel(const T* __restrict__ xbc, long long ld,
                     const float* __restrict__ conv_w, int batch, int seq,
                     int channels, int dx, int n, float* __restrict__ x_out,
                     float* __restrict__ b_out, float* __restrict__ c_out) {
  const int c = (blockIdx.x * LANES + threadIdx.x) * CV;
  const int tiles = (seq + TT - 1) / TT;
  const int tile = blockIdx.y * TILES + threadIdx.y;
  if (c >= channels || tile >= batch * tiles) return;
  const int b = tile / tiles;
  const int t0 = (tile - b * tiles) * TT;
  float w[K][CV];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < CV; ++j) w[i][j] = rnd<T>(conv_w[i * channels + c + j]);
  const Segment sg = segment(c, dx, n);
  float* dst = (sg.which == 0 ? x_out : sg.which == 1 ? b_out : c_out) +
               (long long)b * seq * sg.width + sg.col;
  const T* src = xbc + (long long)b * seq * ld + c;
  float x[K][CV];   // x[t - 3 .. t]
#pragma unroll
  for (int i = 0; i < K - 1; ++i) {
    const int t = t0 - (K - 1) + i;
    if (t >= 0) {
      load(src + (long long)t * ld, x[i]);
    } else {
#pragma unroll
      for (int j = 0; j < CV; ++j) x[i][j] = 0.f;
    }
  }
#pragma unroll
  for (int s = 0; s < TT; ++s) {
    const int t = t0 + s;
    if (t >= seq) break;
    load(src + (long long)t * ld, x[K - 1]);
    float o[CV];
#pragma unroll
    for (int j = 0; j < CV; ++j) {
      const float u = conv_at(w, x, j);
      o[j] = rnd<T>(u * sigmoid(u));
    }
    store(dst + (long long)t * sg.width, o);
#pragma unroll
    for (int i = 0; i < K - 1; ++i)
#pragma unroll
      for (int j = 0; j < CV; ++j) x[i][j] = x[i + 1][j];
  }
}

template <typename T>
__global__ void __launch_bounds__(LANES * TILES)
conv_silu_bwd_kernel(const T* __restrict__ xbc, long long ld,
                     const float* __restrict__ conv_w,
                     const float* __restrict__ dx_scan,
                     const float* __restrict__ dy,
                     const float* __restrict__ d_skip, int p,
                     const float* __restrict__ dbm,
                     const float* __restrict__ dcm, int batch, int seq,
                     int channels, int dx, int n, T* __restrict__ dxbc,
                     long long ld_d, float* __restrict__ part_w) {
  __shared__ float red[TILES][CV][LANES + 1];
  const int c = (blockIdx.x * LANES + threadIdx.x) * CV;
  const int tiles = (seq + TT - 1) / TT;
  const int tile = blockIdx.y * TILES + threadIdx.y;
  float dw[K][CV];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < CV; ++j) dw[i][j] = 0.f;
  if (c < channels && tile < batch * tiles) {
    const int b = tile / tiles;
    const int t0 = (tile - b * tiles) * TT;
    float w[K][CV];
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j < CV; ++j) w[i][j] = rnd<T>(conv_w[i * channels + c + j]);
    // the gradient reaching the conv's output: K4-bwd's dx plus the D
    // skip's D dy for x's channels, dB or dC for the others
    const Segment sg = segment(c, dx, n);
    const long long gbase = (long long)b * seq * sg.width + sg.col;
    const float* g1 = (sg.which == 0 ? dx_scan : sg.which == 1 ? dbm : dcm) + gbase;
    const float* g2 = sg.which == 0 ? dy + gbase : nullptr;
    const float dsk = sg.which == 0 ? d_skip[c / p] : 0.f;
    const T* src = xbc + (long long)b * seq * ld + c;
    T* dst = dxbc + (long long)b * seq * ld_d + c;
    float x[K][CV];    // x[t - 3 .. t]
    float du[K][CV];   // d(pre-activation) at t - 3 .. t
#pragma unroll
    for (int i = 0; i < K - 1; ++i) {
      const int t = t0 - (K - 1) + i;
      if (t >= 0) {
        load(src + (long long)t * ld, x[i]);
      } else {
#pragma unroll
        for (int j = 0; j < CV; ++j) x[i][j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < CV; ++j) du[i][j] = 0.f;
    }
    // Step s takes the pre-activation's gradient at t = t0 + s; d(xBC) at
    // t - 3 needs it at t - 3 .. t, so the walk runs 3 steps past the
    // tile (those steps add nothing to d(conv_w): their own tile does).
#pragma unroll
    for (int s = 0; s < TT + K - 1; ++s) {
      const int t = t0 + s;
      if (t < seq) {
        load(src + (long long)t * ld, x[K - 1]);
        float go[CV];
        load(g1 + (long long)t * sg.width, go);
        if (g2 != nullptr) {
          float gy[CV];
          load(g2 + (long long)t * sg.width, gy);
#pragma unroll
          for (int j = 0; j < CV; ++j) go[j] = fmaf(dsk, gy[j], go[j]);
        }
#pragma unroll
        for (int j = 0; j < CV; ++j) {
          const float u = conv_at(w, x, j);
          const float sgm = sigmoid(u);
          du[K - 1][j] = go[j] * sgm * (1.f + u * (1.f - sgm));
        }
        if (s < TT) {
#pragma unroll
          for (int i = 0; i < K; ++i)
#pragma unroll
            for (int j = 0; j < CV; ++j) dw[i][j] = fmaf(du[K - 1][j], x[i][j], dw[i][j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < CV; ++j) du[K - 1][j] = 0.f;
      }
      if (s >= K - 1 && t - (K - 1) < seq) {
        // d xBC[t'] = sum_i w[i] du[t' + 3 - i], t' = t - 3
        float o[CV];
#pragma unroll
        for (int j = 0; j < CV; ++j) {
          float v = w[0][j] * du[K - 1][j];
#pragma unroll
          for (int i = 1; i < K; ++i) v = fmaf(w[i][j], du[K - 1 - i][j], v);
          o[j] = v;
        }
        store(dst + (long long)(t - (K - 1)) * ld_d, o);
      }
#pragma unroll
      for (int i = 0; i < K - 1; ++i)
#pragma unroll
        for (int j = 0; j < CV; ++j) {
          x[i][j] = x[i + 1][j];
          du[i][j] = du[i + 1][j];
        }
    }
  }
  // d(conv_w): the CTA's time tiles summed in order, one partial a CTA row
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < CV; ++j) red[threadIdx.y][j][threadIdx.x] = dw[i][j];
    __syncthreads();
    if (threadIdx.y == 0 && c < channels) {
      float s[CV];
#pragma unroll
      for (int j = 0; j < CV; ++j) {
        s[j] = 0.f;
#pragma unroll
        for (int q = 0; q < TILES; ++q) s[j] += red[q][j][threadIdx.x];
      }
      store(part_w + ((long long)blockIdx.y * K + i) * channels + c, s);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(DT_THREADS)
dt_softplus_fwd_kernel(const T* __restrict__ dt, long long ld,
                       const float* __restrict__ bias,
                       const float* __restrict__ a_log, long long rows, int h,
                       float* __restrict__ dt_out, float* __restrict__ a_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < h) a_out[i] = -expf(a_log[i]);
  if (i >= rows * h) return;
  const long long r = i / h;
  const int hh = (int)(i - r * h);
  const float v = to_float(dt[r * ld + hh]) + bias[hh];
  dt_out[i] = v > 20.f ? v : log1pf(expf(v));
}

// A CTA of a multiple of h threads walks the (row, head) elements with a
// stride that is a multiple of h, so each thread stays on one head.
template <typename T>
__global__ void __launch_bounds__(DT_THREADS)
dt_softplus_bwd_kernel(const float* __restrict__ ddt, const T* __restrict__ dt,
                       long long ld, const float* __restrict__ bias,
                       long long rows, int h, T* __restrict__ ddt_out,
                       long long ld_d, float* __restrict__ part_bias,
                       const float* __restrict__ da,
                       const float* __restrict__ a,
                       float* __restrict__ d_a_log) {
  extern __shared__ float acc_s[];
  const int hh = threadIdx.x % h;
  if (blockIdx.x == 0 && threadIdx.x < h) d_a_log[threadIdx.x] = da[threadIdx.x] * a[threadIdx.x];
  float acc = 0.f;
  const long long n = rows * h;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long r = i / h;
    const float v = to_float(dt[r * ld + hh]) + bias[hh];
    const float e = expf(v);
    const float d = v > 20.f ? ddt[i] : ddt[i] * e / (e + 1.f);
    ddt_out[r * ld_d + hh] = from_float<T>(d);
    acc += d;
  }
  acc_s[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < h) {
    float s = 0.f;
    for (int q = threadIdx.x; q < blockDim.x; q += h) s += acc_s[q];
    part_bias[(long long)blockIdx.x * h + threadIdx.x] = s;
  }
}

// The sum over the CTA's threads, returned to every thread.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();   // red may still be read from the previous row
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < GATE_THREADS / 32; ++q) s += red[q];
  return s;
}

template <typename T, int CH>
__global__ void __launch_bounds__(GATE_THREADS)
gated_rmsnorm_fwd_kernel(const float* __restrict__ y,
                         const float* __restrict__ x, const T* __restrict__ z,
                         long long ld, const float* __restrict__ d_skip,
                         const float* __restrict__ gamma, long long rows,
                         int di, int p, float eps, T* __restrict__ out,
                         float* __restrict__ rstd) {
  __shared__ float red[GATE_THREADS / 32];
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    float g[CH][GV];
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int c = (k * GATE_THREADS + threadIdx.x) * GV;
      if (c < di) {
        float yv[GV], xv[GV], zv[GV];
        load(y + r * di + c, yv);
        load(x + r * di + c, xv);
        load(z + r * ld + c, zv);
        const float d = d_skip[c / p];
#pragma unroll
        for (int j = 0; j < GV; ++j) {
          const float ys = fmaf(d, xv[j], yv[j]);
          g[k][j] = ys * (zv[j] * sigmoid(zv[j]));
          ss = fmaf(g[k][j], g[k][j], ss);
        }
      }
    }
    const float rs = rsqrtf(block_sum(ss, red) / (float)di + eps);
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int c = (k * GATE_THREADS + threadIdx.x) * GV;
      if (c < di) {
        float gm[GV], o[GV];
        load(gamma + c, gm);
#pragma unroll
        for (int j = 0; j < GV; ++j) o[j] = g[k][j] * rs * gm[j];
        store(out + r * di + c, o);
      }
    }
    if (threadIdx.x == 0) rstd[r] = rs;
  }
}

template <typename T, int CH>
__global__ void __launch_bounds__(GATE_THREADS)
gated_rmsnorm_bwd_kernel(const T* __restrict__ dout,
                         const float* __restrict__ y,
                         const float* __restrict__ x, const T* __restrict__ z,
                         long long ld, const float* __restrict__ d_skip,
                         const float* __restrict__ gamma,
                         const float* __restrict__ rstd, long long rows,
                         int di, int p, float* __restrict__ dy,
                         T* __restrict__ dz, long long ld_d,
                         float* __restrict__ part_gamma,
                         float* __restrict__ part_d) {
  __shared__ float red[GATE_THREADS / 32];
  __shared__ float head[CH * GATE_THREADS];
  float acc_g[CH][GV];
  float acc_d[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    acc_d[k] = 0.f;
#pragma unroll
    for (int j = 0; j < GV; ++j) acc_g[k][j] = 0.f;
  }
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const float rs = rstd[r];
    float yv[CH][GV], xv[CH][GV], zv[CH][GV], dov[CH][GV];
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int c = (k * GATE_THREADS + threadIdx.x) * GV;
      if (c < di) {
        load(y + r * di + c, yv[k]);
        load(x + r * di + c, xv[k]);
        load(z + r * ld + c, zv[k]);
        load(dout + r * di + c, dov[k]);
        float gm[GV];
        load(gamma + c, gm);
        const float d = d_skip[c / p];
#pragma unroll
        for (int j = 0; j < GV; ++j) {
          const float g = fmaf(d, xv[k][j], yv[k][j]) * (zv[k][j] * sigmoid(zv[k][j]));
          acc_g[k][j] = fmaf(dov[k][j], g * rs, acc_g[k][j]);
          dot = fmaf(dov[k][j] * gm[j], g, dot);
        }
      }
    }
    // n = g r, r = (mean g^2 + eps)^-1/2:
    // dg = r dn - r^3 g mean(dn g), dn = d(out) gamma
    const float total = block_sum(dot, red);
    const float coef = rs * rs * rs * (total / (float)di);
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int c = (k * GATE_THREADS + threadIdx.x) * GV;
      if (c < di) {
        float gm[GV], dyo[GV], dzo[GV];
        load(gamma + c, gm);
        const float d = d_skip[c / p];
#pragma unroll
        for (int j = 0; j < GV; ++j) {
          const float zz = zv[k][j];
          const float sgm = sigmoid(zz);
          const float sz = zz * sgm;
          const float ys = fmaf(d, xv[k][j], yv[k][j]);
          const float dg = rs * (dov[k][j] * gm[j]) - coef * (ys * sz);
          dyo[j] = dg * sz;
          dzo[j] = dg * ys * (sgm * (1.f + zz * (1.f - sgm)));
          acc_d[k] = fmaf(dyo[j], xv[k][j], acc_d[k]);
        }
        store(dy + r * di + c, dyo);
        store(dz + r * ld_d + c, dzo);
      }
    }
  }
  // the CTA's partials: d(gamma) by channel, d(D) by head (the P / 8
  // threads of a head summed in order)
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int c = (k * GATE_THREADS + threadIdx.x) * GV;
    if (c < di) {
      store(part_gamma + (long long)blockIdx.x * di + c, acc_g[k]);
      head[c / GV] = acc_d[k];
    }
  }
  __syncthreads();
  const int heads = di / p, per = p / GV;
  for (int hh = threadIdx.x; hh < heads; hh += GATE_THREADS) {
    float s = 0.f;
    for (int q = 0; q < per; ++q) s += head[hh * per + q];
    part_d[(long long)blockIdx.x * heads + hh] = s;
  }
}

// A CTA sums SUM_COLS columns of the partials: row lane l of SUM_LANES
// adds rows l, l + SUM_LANES, ... in order (each warp reads 128 bytes of a
// row), then the lanes' sums meet in a fixed tree.
__global__ void __launch_bounds__(SUM_COLS * SUM_LANES)
column_sum_kernel(const float* __restrict__ part, int n, int width,
                  float* __restrict__ out) {
  __shared__ float acc[SUM_LANES][SUM_COLS];
  const int j = blockIdx.x * SUM_COLS + threadIdx.x;
  float s = 0.f;
  if (j < width) {
#pragma unroll 4
    for (int i = threadIdx.y; i < n; i += SUM_LANES)
      s += part[(long long)i * width + j];
  }
  acc[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  for (int half = SUM_LANES / 2; half > 0; half /= 2) {
    if (threadIdx.y < half)
      acc[threadIdx.y][threadIdx.x] += acc[threadIdx.y + half][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.y == 0 && j < width) out[j] = acc[0][threadIdx.x];
}

int column_sum(const float* part, int n, int width, float* out, cudaStream_t s) {
  column_sum_kernel<<<(width + SUM_COLS - 1) / SUM_COLS,
                      dim3(SUM_COLS, SUM_LANES), 0, s>>>(part, n, width, out);
  return (int)cudaGetLastError();
}

// threads of a dt_softplus_bwd CTA: a multiple of h (h <= DT_THREADS)
int dt_threads(int h) { return (DT_THREADS / h) * h; }

dim3 conv_grid(int batch, int seq, int channels) {
  const int tiles = batch * ((seq + TT - 1) / TT);
  return dim3((channels / CV + LANES - 1) / LANES, (tiles + TILES - 1) / TILES);
}

bool conv_shapes_ok(int batch, int seq, int channels, int dx, int n, long long ld) {
  return batch > 0 && seq > 0 && channels > 0 && channels % 8 == 0 &&
         dx % 8 == 0 && n % 8 == 0 && dx + 2 * n == channels && ld % 8 == 0 &&
         conv_grid(batch, seq, channels).y <= 65535;
}

template <typename T>
int conv_fwd(const void* xbc, const void* dt, long long ld, const float* conv_w,
             const float* dt_bias, const float* a_log, float* x_out,
             float* b_out, float* c_out, float* dt_out, float* a_out,
             int batch, int seq, int channels, int dx, int n, int h,
             cudaStream_t s) {
  conv_silu_fwd_kernel<T><<<conv_grid(batch, seq, channels), dim3(LANES, TILES), 0, s>>>(
      static_cast<const T*>(xbc), ld, conv_w, batch, seq, channels, dx, n,
      x_out, b_out, c_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long elems = (long long)batch * seq * h;
  dt_softplus_fwd_kernel<T><<<(unsigned)((elems + DT_THREADS - 1) / DT_THREADS), DT_THREADS, 0, s>>>(
      static_cast<const T*>(dt), ld, dt_bias, a_log, (long long)batch * seq, h,
      dt_out, a_out);
  return (int)cudaGetLastError();
}

template <typename T>
int conv_bwd(const void* xbc, const void* dt, long long ld, const float* conv_w,
             const float* dx_scan, const float* dy, const float* d_skip,
             const float* dbm, const float* dcm, const float* ddt,
             const float* dt_bias, const float* da, const float* a, void* dxbc,
             void* ddt_out, long long ld_d, float* part, float* d_conv_w,
             float* d_dt_bias, float* d_a_log, int batch, int seq,
             int channels, int dx, int n, int h, int p, int dt_grid,
             cudaStream_t s) {
  const dim3 grid = conv_grid(batch, seq, channels);
  conv_silu_bwd_kernel<T><<<grid, dim3(LANES, TILES), 0, s>>>(
      static_cast<const T*>(xbc), ld, conv_w, dx_scan, dy, d_skip, p, dbm,
      dcm, batch, seq, channels, dx, n, static_cast<T*>(dxbc), ld_d, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  float* part_bias = part + (long long)grid.y * K * channels;
  const int threads = dt_threads(h);
  dt_softplus_bwd_kernel<T><<<dt_grid, threads, threads * sizeof(float), s>>>(
      ddt, static_cast<const T*>(dt), ld, dt_bias, (long long)batch * seq, h,
      static_cast<T*>(ddt_out), ld_d, part_bias, da, a, d_a_log);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int e = column_sum(part, (int)grid.y, K * channels, d_conv_w, s);
  if (e) return e;
  return column_sum(part_bias, dt_grid, h, d_dt_bias, s);
}

template <typename T, int CH>
int gate_fwd(const float* y, const float* x, const void* z, long long ld,
             const float* d_skip, const float* gamma, void* out, float* rstd,
             long long rows, int di, int p, float eps, int grid,
             cudaStream_t s) {
  gated_rmsnorm_fwd_kernel<T, CH><<<grid, GATE_THREADS, 0, s>>>(
      y, x, static_cast<const T*>(z), ld, d_skip, gamma, rows, di, p, eps,
      static_cast<T*>(out), rstd);
  return (int)cudaGetLastError();
}

template <typename T, int CH>
int gate_bwd(const void* dout, const float* y, const float* x, const void* z,
             long long ld, const float* d_skip, const float* gamma,
             const float* rstd, float* dy, void* dz, long long ld_d,
             float* part, float* d_gamma, float* d_dskip, long long rows,
             int di, int p, int grid, cudaStream_t s) {
  float* part_d = part + (long long)grid * di;
  gated_rmsnorm_bwd_kernel<T, CH><<<grid, GATE_THREADS, 0, s>>>(
      static_cast<const T*>(dout), y, x, static_cast<const T*>(z), ld, d_skip,
      gamma, rstd, rows, di, p, dy, static_cast<T*>(dz), ld_d, part, part_d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int e = column_sum(part, grid, di, d_gamma, s);
  if (e) return e;
  return column_sum(part_d, grid, di / p, d_dskip, s);
}

// d_inner a gate CTA takes: up to 4 chunks of 256 threads x 8 channels
int gate_chunks(int di) { return (di + GATE_THREADS * GV - 1) / (GATE_THREADS * GV); }

bool gate_shapes_ok(long long rows, int di, int p, long long ld, int grid) {
  return rows > 0 && di > 0 && di % GV == 0 && p > 0 && p % GV == 0 &&
         di % p == 0 && ld % GV == 0 && grid > 0 && gate_chunks(di) <= 4;
}

}  // namespace

// The forward's conv, SiLU and dt: xbc and dt point at the packed
// in-projection output's xBC and dt columns (row stride ld elements, bf16
// when bf16 is set, else f32); conv_w (4, channels) f32; x_out (rows, dx),
// b_out and c_out (rows, n), dt_out (rows, h) f32; a_out (h) f32.
// Returns a cudaError_t.
extern "C" int ssd_conv_fwd(const void* xbc, const void* dt, long long ld,
                            const float* conv_w, const float* dt_bias,
                            const float* a_log, float* x_out, float* b_out,
                            float* c_out, float* dt_out, float* a_out,
                            int batch, int seq, int channels, int dx, int n,
                            int h, int bf16_in, void* stream) {
  if (!conv_shapes_ok(batch, seq, channels, dx, n, ld) || h <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_in ? conv_fwd<bf16>(xbc, dt, ld, conv_w, dt_bias, a_log, x_out, b_out, c_out, dt_out, a_out, batch, seq, channels, dx, n, h, s)
                 : conv_fwd<float>(xbc, dt, ld, conv_w, dt_bias, a_log, x_out, b_out, c_out, dt_out, a_out, batch, seq, channels, dx, n, h, s);
}

// Floats of the partials' scratch that ssd_conv_bwd needs.
extern "C" long long ssd_conv_bwd_scratch(int batch, int seq, int channels,
                                          int h, int dt_grid) {
  return (long long)conv_grid(batch, seq, channels).y * K * channels +
         (long long)dt_grid * h;
}

// The backward's conv, SiLU and dt: dx_scan (K4-bwd's dx) and dy (the
// gradient of y + D x, whose D x term is added here) (rows, dx) f32; dbm,
// dcm (rows, n), ddt (rows, h), da and a (h) f32.  Writes d(xBC) and d(dt)
// into their columns of d(proj) (row stride ld_d), and d(conv_w),
// d(dt_bias), d(a_log).  part: ssd_conv_bwd_scratch floats.
extern "C" int ssd_conv_bwd(const void* xbc, const void* dt, long long ld,
                            const float* conv_w, const float* dx_scan,
                            const float* dy, const float* d_skip,
                            const float* dbm, const float* dcm,
                            const float* ddt, const float* dt_bias,
                            const float* da, const float* a, void* dxbc,
                            void* ddt_out, long long ld_d, float* part,
                            float* d_conv_w, float* d_dt_bias,
                            float* d_a_log, int batch, int seq, int channels,
                            int dx, int n, int h, int p, int dt_grid,
                            int bf16_in, void* stream) {
  if (!conv_shapes_ok(batch, seq, channels, dx, n, ld) || ld_d % 8 != 0 ||
      h <= 0 || h > DT_THREADS || p <= 0 || dx % p != 0 || dt_grid <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_in
             ? conv_bwd<bf16>(xbc, dt, ld, conv_w, dx_scan, dy, d_skip, dbm, dcm, ddt, dt_bias, da, a, dxbc, ddt_out, ld_d, part, d_conv_w, d_dt_bias, d_a_log, batch, seq, channels, dx, n, h, p, dt_grid, s)
             : conv_bwd<float>(xbc, dt, ld, conv_w, dx_scan, dy, d_skip, dbm, dcm, ddt, dt_bias, da, a, dxbc, ddt_out, ld_d, part, d_conv_w, d_dt_bias, d_a_log, batch, seq, channels, dx, n, h, p, dt_grid, s);
}

// The gated RMS norm's forward: y, x (rows, di) f32 (K4's y and its x);
// z the z columns of the packed in-projection (row stride ld); d_skip
// (di / p), gamma (di) f32; out (rows, di) in the input's type, rstd (rows)
// f32.  grid CTAs walk the rows.
extern "C" int ssd_gate_fwd(const float* y, const float* x, const void* z,
                            long long ld, const float* d_skip,
                            const float* gamma, void* out, float* rstd,
                            long long rows, int di, int p, float eps,
                            int grid, int bf16_in, void* stream) {
  if (!gate_shapes_ok(rows, di, p, ld, grid)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (gate_chunks(di) * 2 + (bf16_in ? 1 : 0)) {
    case 3: return gate_fwd<bf16, 1>(y, x, z, ld, d_skip, gamma, out, rstd, rows, di, p, eps, grid, s);
    case 2: return gate_fwd<float, 1>(y, x, z, ld, d_skip, gamma, out, rstd, rows, di, p, eps, grid, s);
    case 5: return gate_fwd<bf16, 2>(y, x, z, ld, d_skip, gamma, out, rstd, rows, di, p, eps, grid, s);
    case 4: return gate_fwd<float, 2>(y, x, z, ld, d_skip, gamma, out, rstd, rows, di, p, eps, grid, s);
    case 7: case 9: return gate_fwd<bf16, 4>(y, x, z, ld, d_skip, gamma, out, rstd, rows, di, p, eps, grid, s);
    default: return gate_fwd<float, 4>(y, x, z, ld, d_skip, gamma, out, rstd, rows, di, p, eps, grid, s);
  }
}

// Floats of the partials' scratch that ssd_gate_bwd needs.
extern "C" long long ssd_gate_bwd_scratch(int di, int p, int grid) {
  return (long long)grid * (di + di / p);
}

// The gated RMS norm's backward: dout (rows, di) in the input's type; y,
// x, z, d_skip, gamma as the forward's, rstd its output.  Writes dy (rows,
// di) f32 (the gradient of y + D x), dz into the z columns of d(proj)
// (row stride ld_d), d(gamma) (di) and d(D) (di / p) f32.
extern "C" int ssd_gate_bwd(const void* dout, const float* y, const float* x,
                            const void* z, long long ld, const float* d_skip,
                            const float* gamma, const float* rstd, float* dy,
                            void* dz, long long ld_d, float* part,
                            float* d_gamma, float* d_dskip, long long rows,
                            int di, int p, int grid, int bf16_in,
                            void* stream) {
  if (!gate_shapes_ok(rows, di, p, ld, grid) || ld_d % GV != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (gate_chunks(di) * 2 + (bf16_in ? 1 : 0)) {
    case 3: return gate_bwd<bf16, 1>(dout, y, x, z, ld, d_skip, gamma, rstd, dy, dz, ld_d, part, d_gamma, d_dskip, rows, di, p, grid, s);
    case 2: return gate_bwd<float, 1>(dout, y, x, z, ld, d_skip, gamma, rstd, dy, dz, ld_d, part, d_gamma, d_dskip, rows, di, p, grid, s);
    case 5: return gate_bwd<bf16, 2>(dout, y, x, z, ld, d_skip, gamma, rstd, dy, dz, ld_d, part, d_gamma, d_dskip, rows, di, p, grid, s);
    case 4: return gate_bwd<float, 2>(dout, y, x, z, ld, d_skip, gamma, rstd, dy, dz, ld_d, part, d_gamma, d_dskip, rows, di, p, grid, s);
    case 7: case 9: return gate_bwd<bf16, 4>(dout, y, x, z, ld, d_skip, gamma, rstd, dy, dz, ld_d, part, d_gamma, d_dskip, rows, di, p, grid, s);
    default: return gate_bwd<float, 4>(dout, y, x, z, ld, d_skip, gamma, rstd, dy, dz, ld_d, part, d_gamma, d_dskip, rows, di, p, grid, s);
  }
}
