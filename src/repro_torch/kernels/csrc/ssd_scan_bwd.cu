// Mamba-2 SSD chunked scan (backward), for Hopper (sm_90a).
//
// Replaces: XLA's gradient of src/repro/models/ssm.py::ssd_chunked, the
// jnp chunked scan that the JAX package differentiates (its Pallas kernel,
// src/repro/kernels/ssd_scan.py::ssd_scan, has no backward).  Given dy and
// the final state's gradient dfinal, it computes dx, ddt, da, dB, dC and
// the initial state's gradient.  Per chunk c, head h and step i, with cs
// the cumsum of dA = dt.a within the chunk, e_i = exp(cs_i),
// L_ij = exp(cs_i - cs_j) for i >= j (masked before the exp) and
// w_j = exp(cs_last - cs_j).dt_j (ref.ssd_chunked_bwd_ref has the same
// terms in plain PyTorch):
//
//   1. scores, one CTA per (chunk, batch row): C.B^T of the chunk, (L, L).
//   2. chunk gradients, one CTA per (chunk, head, batch row):
//      G_c = sum_i e_i dy_i^T C_i, (P, N), into the workspace.
//   3. reverse state passing, one CTA per (batch row, head) and slice of
//      P.N: walks the chunks backwards, elementwise,
//      D_c = G_c + exp(cs_last,c).D_{c+1} from D_nc = dfinal (or zeros),
//      overwriting G_c with D_{c+1}, the gradient of the state leaving
//      chunk c; D_0 is dinit.
//   4. state terms, one CTA per (chunk, group of heads, batch row), B and C
//      loaded once for the group: for each head (D_{c+1} B_j) and
//      (prev_c C_i), (L, P) each, with prev_c the state entering the chunk
//      from the forward's workspace; dx = w_j.(D_{c+1} B_j) (written
//      here), dw_j = x_j.(D_{c+1} B_j), e_i dy_i.(prev_c C_i) (the
//      gradient of cs_i through the carried state's term) and
//      exp(cs_last).<D_{c+1}, prev_c> (through the state passing).
//   5. intra-chunk terms, one CTA per (chunk, group of heads, batch row):
//      for each head dyx_ij = dy_i.x_j over the causal triangle, whence
//      dS_ij = L_ij dt_j dyx_ij (summed over the group in shared memory)
//      and the gradient of cs through L (row sums minus column sums of
//      dS.C.B^T); dxdt_j = sum_{i >= j} L_ij (C_i.B_j) dy_i, so dx +=
//      dt_j dxdt_j and ddt_j = x_j.dxdt_j + exp(cs_last - cs_j) dw_j
//      + a.d(dA)_j, with d(dA) the reverse cumsum of d(cs) within the
//      chunk; and the chunk's part of da, sum_j dt_j d(dA)_j.
//   6. dB and dC, one CTA per (chunk, batch row) and output: the group
//      partials of dS summed in group order, then dC = dS.B
//      + sum_{h,p} e_i dy_i prev_c and dB = dS^T.C + sum_{h,p} w_j x_j
//      D_{c+1}, over every head in order.
//   7. da, one thread per head: the chunks' parts summed in order.
//
// No atomics: every sum runs in a fixed order, so two calls on the same
// inputs give the same bits (crash/resume replays a training step).
//
// Two routes, by shape:
//   - the tensor-core route, P = 64 at chunk 64 or 128 with N a multiple
//     of 16 up to 128 (tc::takes: mamba2-370m's and jamba's widths): 4 and
//     5 are one launch (tc::ssd_bwd_fused_kernel) and, where N is 64 or
//     128, 6 is tc::ssd_bwd_dbdc_wgmma_kernel, their products on wgmma
//     m64nNk8 .tf32 in split TF32 (namespace tc below); six launches;
//   - every other shape (chunk 8-32, P other than 64), and 1, 2, 3, 7 on
//     both: products on mma.sync m16n8k8 in split TF32 (ssd_common.cuh),
//     each CTA zeroing its shared memory first, so a tile's padding (P to a
//     multiple of 8 or 16, L to 16 rows) reads as zeros; seven launches.
// Split TF32 (lo.hi + hi.lo + hi.hi of each operand's two TF32 parts)
// gives near-f32 results from f32 inputs.
//
// Bound on an H100: about twice the forward's least work, 8.P.N flops per
// (b, step, h) (the state's gradient through C and the chunk state's
// through x and B), 17.2 GFLOP at mamba2-370m's training shape (B, S, H, P,
// N) = (2, 4096, 32, 64, 128), 0.104 ms as 3xTF32 at the 495 TFLOP/s TF32
// peak; its bytes (x, dy and dx at 67 MB each, the forward's states at
// 67 MB, the rest small) take ~0.08 ms at 3.35 TB/s.  This design moves
// more: the states' gradients (67 MB) are written, read and written, then
// read again, and x, dy and the forward's states are read two or three
// times.  On the mma.sync route the products set its time (~13x the bound);
// on the tensor-core route the fused launch's latency (loads and
// barriers between its phases) sets it as much as its products
// (tools/ssd_bwd_probe.py cuts the parts out one at a time).
//
// Workspace (f32, from the caller, ssd_scan_bwd_workspace floats): G then
// D (B, H, nc, P, N); scores (B, nc, L, L); the group partials of dS
// (B, nc, groups, L, L); dw and the carried term's d(cs) (B, S, H) each;
// exp(cs_last).<D, prev> (B, H, nc); the chunks' parts of da (B, nc, H).
// The tensor-core route leaves dw, d(cs) and the dot unused: its fused
// launch keeps them in shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

using namespace ssd;

// acc[k] += A(m0 .. m0 + 15, k0 .. k1) B(k0 .. k1, n_k .. n_k + 7) with
// n_k = n0 + kStride k, for k < min(kNT, ntiles): 16 rows of a product by
// one warp, in split TF32.  fa(m, k) and fb(k, n) give the operands' f32
// values; k1 - k0 is a multiple of 8.  acc[k][r] is row m0 + g + 8 (r / 2),
// column n_k + 2 t + r % 2 (ssd_common.cuh's fragment layout).
template <int kNT, int kStride = 8, typename FA, typename FB>
__device__ __forceinline__ void warp_product(float (*acc)[4], int m0, int n0, int ntiles,
                                             int k0, int k1, FA fa, FB fb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bool on[kNT];
#pragma unroll
  for (int k = 0; k < kNT; ++k) on[k] = k < ntiles;
  // unrolled so that a step's loads and splits overlap the products before
  // it (tools/ssd_bwd_probe.py on an H100: 1.30 ms a call at mamba2-370m's
  // training shape by 4 steps, against 1.54 rolled, 1.33 by 2, 1.42 by 8)
#pragma unroll 4
  for (int kk = k0; kk < k1; kk += 8) {
    Frag<4> a;
    a.set(0, fa(m0 + g, kk + t));
    a.set(1, fa(m0 + g + 8, kk + t));
    a.set(2, fa(m0 + g, kk + t + 4));
    a.set(3, fa(m0 + g + 8, kk + t + 4));
    Frag<2> b[kNT];
#pragma unroll
    for (int k = 0; k < kNT; ++k) {
      if (on[k]) {
        b[k].set(0, fb(kk + t, n0 + kStride * k + g));
        b[k].set(1, fb(kk + t + 4, n0 + kStride * k + g));
      }
    }
    mma3<kNT>(acc, a, b, on);
  }
}

// f(row, col, value) for each accumulator element of a warp's block.
template <int kNT, typename F>
__device__ __forceinline__ void for_each_acc(float (*acc)[4], int m0, int n0,
                                             int ntiles, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k = 0; k < kNT; ++k) {
    if (k >= ntiles) continue;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      f(m0 + g + 8 * (r >> 1), n0 + 8 * k + 2 * t + (r & 1), acc[k][r]);
  }
}

// The blocks of an (rows x cols) output, 16 rows by 64 columns (8 tiles),
// taken in turn by the CTA's warps: body(m0, n0, ntiles).
template <typename Body>
__device__ __forceinline__ void for_warp_blocks(int rows, int cols, Body body) {
  const int warp = threadIdx.x / 32;
  const int mt = rows / 16, nb = (cols + 63) / 64;
  for (int blk = warp; blk < mt * nb; blk += kWarps) {
    const int m = blk / nb, nbk = blk - m * nb;
    body(16 * m, 64 * nbk, min(8, (cols - 64 * nbk + 7) / 8));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void zero_smem(float* smem, size_t floats) {
  for (size_t e = threadIdx.x; e < floats; e += kThreads) smem[e] = 0.f;
  __syncthreads();
}

template <int CL>
struct Rows {
  static constexpr int Lm = CL < 16 ? 16 : CL;   // rows of the m16 tiles
};

// The scratch's parts, as offsets in floats from its start, and its size.
struct Work {
  size_t dstate, scores, dsp, dw, dcs_off, dot, da_part, total;
  Work(int batch, int seq, int h, int p, int n, int cl, int groups) {
    const size_t nc = seq / cl;
    dstate = 0;
    scores = dstate + (size_t)batch * h * nc * p * n;
    dsp = scores + (size_t)batch * nc * cl * cl;
    dw = dsp + (size_t)batch * nc * groups * cl * cl;
    dcs_off = dw + (size_t)batch * seq * h;
    dot = dcs_off + (size_t)batch * seq * h;
    da_part = dot + (size_t)batch * h * nc;
    total = da_part + (size_t)batch * nc * h;
  }
};

// ---- 1: scores ----

// C.B^T of one chunk: M = L (i), N = L (j), K = N.  Shared memory: C and B
// (Lm, stride4(n)).
template <int CL>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_scores_kernel(const float* __restrict__ bmat, const float* __restrict__ cmat,
                      float* __restrict__ scores, int seq, int n) {
  constexpr int Lm = Rows<CL>::Lm;
  const int c = blockIdx.x, b = blockIdx.y, nc = seq / CL;
  const int sn = stride4(n);
  extern __shared__ __align__(16) float smem[];
  float* c_s = smem;
  float* b_s = c_s + Lm * sn;
  zero_smem(smem, 2 * (size_t)Lm * sn);
  const size_t t0 = (size_t)b * seq + (size_t)c * CL;
  load_tile(c_s, sn, cmat + t0 * n, n, CL, n);
  load_tile(b_s, sn, bmat + t0 * n, n, CL, n);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float* out = scores + ((size_t)b * nc + c) * CL * CL;
  for_warp_blocks(Lm, CL, [&](int m0, int n0, int ntiles) {
    float acc[8][4] = {};
    warp_product<8>(acc, m0, n0, ntiles, 0, n,
                    [&](int i, int k) { return c_s[i * sn + k]; },
                    [&](int k, int j) { return b_s[j * sn + k]; });
    for_each_acc<8>(acc, m0, n0, ntiles, [&](int i, int j, float v) {
      if (i < CL && j < CL) out[i * CL + j] = v;
    });
  });
}

// ---- 2: chunk gradients G ----

// G[p][n] = sum_i e_i dy_i[p] C_i[n]: M = P (padded to 16), N = n, K = L.
// Shared memory: C (CL, stride8(n)), dy of the head (CL, stride8(pp)), e.
template <int CL>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dstate_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                      const float* __restrict__ cmat, const float* __restrict__ dy,
                      float* __restrict__ dstate, int seq, int h, int p, int n) {
  const int c = blockIdx.x, head = blockIdx.y, b = blockIdx.z, nc = seq / CL;
  const int pp = round_up(p, 16);
  const int sc = stride8(n), sd = stride8(pp);
  extern __shared__ __align__(16) float smem[];
  float* c_s = smem;
  float* dy_s = c_s + CL * sc;
  float* e_s = dy_s + CL * sd;
  zero_smem(smem, (size_t)CL * (sc + sd) + CL);
  const size_t t0 = (size_t)b * seq + (size_t)c * CL;
  load_tile(c_s, sc, cmat + t0 * n, n, CL, n);
  load_tile(dy_s, sd, dy + (t0 * h + head) * p, (size_t)h * p, CL, p);
  cp_async_commit();
  if (threadIdx.x < 32)
    chunk_cumsum<CL>(dt + t0 * h + head, h, a[head],
                     [&](int j, float cs, float, float) { e_s[j] = expf(cs); });
  cp_async_wait<0>();
  __syncthreads();
  float* out = dstate + (((size_t)b * h + head) * nc + c) * p * n;
  for_warp_blocks(pp, n, [&](int m0, int n0, int ntiles) {
    float acc[8][4] = {};
    warp_product<8>(acc, m0, n0, ntiles, 0, CL,
                    [&](int q, int i) { return e_s[i] * dy_s[i * sd + q]; },
                    [&](int i, int k) { return c_s[i * sc + k]; });
    for_each_acc<8>(acc, m0, n0, ntiles, [&](int q, int k, float v) {
      if (q < p) out[(size_t)q * n + k] = v;
    });
  });
}

// ---- 3: reverse state passing ----

// One thread per 4 consecutive entries of a (b, h): reads a few chunks
// ahead (the loads do not depend on the running gradient), then writes
// D_{c+1} over G_c, walking the chunks backwards.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_pass_kernel(float* __restrict__ dstate, const float* __restrict__ dsum,
                          const float* __restrict__ dfinal, float* __restrict__ dinit,
                          int nc, int pn4) {
  constexpr int kAhead = 8;
  const int bh = blockIdx.x;
  const int e = blockIdx.y * kThreads + threadIdx.x;
  if (e >= pn4) return;
  float4* st = reinterpret_cast<float4*>(dstate) + (size_t)bh * nc * pn4 + e;
  const float* ds = dsum + (size_t)bh * nc;
  float4 d = dfinal ? reinterpret_cast<const float4*>(dfinal)[(size_t)bh * pn4 + e]
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c1 = nc; c1 > 0; c1 -= kAhead) {
    float4 v[kAhead];
    float f[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = c1 - 1 - k;
      if (c >= 0) {
        v[k] = st[(size_t)c * pn4];
        f[k] = expf(ds[c]);
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = c1 - 1 - k;
      if (c >= 0) {
        st[(size_t)c * pn4] = d;
        d = make_float4(fmaf(d.x, f[k], v[k].x), fmaf(d.y, f[k], v[k].y),
                        fmaf(d.z, f[k], v[k].z), fmaf(d.w, f[k], v[k].w));
      }
    }
  }
  if (dinit) reinterpret_cast<float4*>(dinit)[(size_t)bh * pn4 + e] = d;
}

// ---- 4: state terms ----

// Shared memory, in floats: B and C (Lm, stride4(n)); D_{c+1} and prev_c
// of the head (pp, stride4(n)); e, w (CL each); warp partials (kWarps);
// cs_last (1).
template <int CL>
__host__ __device__ size_t state_terms_smem_floats(int p, int n) {
  constexpr int Lm = Rows<CL>::Lm;
  return 2 * (size_t)Lm * stride4(n) + 2 * (size_t)round_up(p, 16) * stride4(n) + 2 * CL +
         kWarps + 4;
}

// For each head: DB = B.D^T and YO = C.prev^T, M = L (j or i), N = P, K = n.
template <int CL>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_state_terms_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                           const float* __restrict__ a, const float* __restrict__ bmat,
                           const float* __restrict__ cmat, const float* __restrict__ dy,
                           const float* __restrict__ states, const float* __restrict__ dstate,
                           float* __restrict__ dx, float* __restrict__ dw_out,
                           float* __restrict__ dcs_off, float* __restrict__ dot,
                           int seq, int h, int p, int n, int hg) {
  constexpr int Lm = Rows<CL>::Lm;
  const int c = blockIdx.x, h0 = blockIdx.y * hg, b = blockIdx.z, nc = seq / CL;
  const int nh = min(hg, h - h0);
  const int pp = round_up(p, 16), sn = stride4(n);
  extern __shared__ __align__(16) float smem[];
  float* b_s = smem;
  float* c_s = b_s + Lm * sn;
  float* dn_s = c_s + Lm * sn;
  float* pv_s = dn_s + pp * sn;
  float* e_s = pv_s + pp * sn;
  float* w_s = e_s + CL;
  float* red_s = w_s + CL;
  float* last_s = red_s + kWarps;
  zero_smem(smem, state_terms_smem_floats<CL>(p, n));
  const size_t t0 = (size_t)b * seq + (size_t)c * CL;
  load_tile(b_s, sn, bmat + t0 * n, n, CL, n);
  load_tile(c_s, sn, cmat + t0 * n, n, CL, n);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const size_t row = (size_t)h * p;

  for (int hi = 0; hi < nh; ++hi) {
    const int head = h0 + hi;
    const size_t sidx = (((size_t)b * h + head) * nc + c) * p * n;
    load_tile(dn_s, sn, dstate + sidx, n, p, n);
    load_tile(pv_s, sn, states + sidx, n, p, n);
    cp_async_commit();
    if (warp == 0) {
      const float last = chunk_cumsum<CL>(
          dt + t0 * h + head, h, a[head], [&](int j, float cs, float d, float cs_last) {
            e_s[j] = expf(cs);
            w_s[j] = expf(cs_last - cs) * d;
          });
      if (lane == 0) last_s[0] = last;
    }
    cp_async_wait<0>();
    __syncthreads();

    // exp(cs_last).<D, prev>: the state passing's part of d(cs_last), 16
    // bytes a thread, rows * (n / 4) threads a pass
    float part = 0.f;
    {
      const int n4 = n / 4, rows = kThreads / n4;
      const int r0 = threadIdx.x / n4, k = 4 * (threadIdx.x - r0 * n4);
      for (int q = r0; r0 < rows && q < p; q += rows) {
        const float4 d = *reinterpret_cast<const float4*>(dn_s + q * sn + k);
        const float4 v = *reinterpret_cast<const float4*>(pv_s + q * sn + k);
        part += d.x * v.x + d.y * v.y + d.z * v.z + d.w * v.w;
      }
    }
    part = warp_sum(part);
    if (lane == 0) red_s[warp] = part;

    for_warp_blocks(Lm, p, [&](int m0, int n0, int ntiles) {
      float db[8][4] = {}, yo[8][4] = {};
      warp_product<8>(db, m0, n0, ntiles, 0, n,
                      [&](int j, int k) { return b_s[j * sn + k]; },
                      [&](int k, int q) { return dn_s[q * sn + k]; });
      warp_product<8>(yo, m0, n0, ntiles, 0, n,
                      [&](int i, int k) { return c_s[i * sn + k]; },
                      [&](int k, int q) { return pv_s[q * sn + k]; });
      // rows m0 + g and m0 + g + 8: x.DB and dy.YO over the warp's columns
      float dwp[2] = {0.f, 0.f}, ysp[2] = {0.f, 0.f};
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int q = n0 + 8 * k + 2 * t;
        if (k >= ntiles || q >= p) continue;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = m0 + g + 8 * u;
          if (j >= CL) continue;
          const size_t at = (t0 + j) * row + (size_t)head * p + q;
          const float2 xv = *reinterpret_cast<const float2*>(x + at);
          const float2 dv = *reinterpret_cast<const float2*>(dy + at);
          const float d0 = db[k][2 * u], d1 = db[k][2 * u + 1];
          *reinterpret_cast<float2*>(dx + at) = make_float2(w_s[j] * d0, w_s[j] * d1);
          dwp[u] += xv.x * d0 + xv.y * d1;
          ysp[u] += dv.x * yo[k][2 * u] + dv.y * yo[k][2 * u + 1];
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        dwp[u] += __shfl_xor_sync(kFull, dwp[u], 1);
        dwp[u] += __shfl_xor_sync(kFull, dwp[u], 2);
        ysp[u] += __shfl_xor_sync(kFull, ysp[u], 1);
        ysp[u] += __shfl_xor_sync(kFull, ysp[u], 2);
        const int j = m0 + g + 8 * u;
        if (t == 0 && j < CL) {
          const size_t at = (t0 + j) * h + head;
          dw_out[at] = dwp[u];
          dcs_off[at] = e_s[j] * ysp[u];
        }
      }
    });
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red_s[w];
      dot[((size_t)b * h + head) * nc + c] = expf(last_s[0]) * s;
    }
    __syncthreads();                   // the head's tiles are refilled next
  }
}

// ---- 5: intra-chunk terms ----

// Shared memory, in floats: scores (Lm, stride8(CL)); the group's dS
// (Lm, stride8(CL)); x (Lm, stride4(pp)) and dy (Lm, stride8(pp)) of the
// head; cs, dt (Lm each); x.dxdt by group of P's tiles (kWarps, Lm); row
// sums of Q by column parity (2, Lm) and column sums by row tile
// (Lm / 16, Lm); cs_last (1).
//
// Work is split over the warps as the forward's chunk scan splits it: row
// tile m is paired with row tile MT - 1 - m, a long and a short row of the
// causal triangle, so that every warp takes the same share.
template <int CL>
struct IntraLayout {
  static constexpr int Lm = Rows<CL>::Lm;
  static constexpr int MT = Lm / 16;
  static constexpr int NPAIR = (MT + 1) / 2;   // pairs of row tiles
  int ss, sx, sy;
  __host__ __device__ IntraLayout(int p)
      : ss(stride8(CL)), sx(stride4(round_up(p, 16))), sy(stride8(round_up(p, 16))) {}
  __host__ __device__ size_t floats() const {
    return 2 * (size_t)Lm * ss + (size_t)Lm * (sx + sy) + (2 + kWarps + 2 + MT) * Lm + 4;
  }
};

template <int CL>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_intra_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ dy,
                     const float* __restrict__ scores, const float* __restrict__ dw_in,
                     const float* __restrict__ dcs_off, const float* __restrict__ dot,
                     float* __restrict__ dx, float* __restrict__ ddt,
                     float* __restrict__ dsp, float* __restrict__ da_part,
                     int seq, int h, int p, int hg) {
  using Lay = IntraLayout<CL>;
  constexpr int Lm = Lay::Lm, MT = Lay::MT, NPAIR = Lay::NPAIR;
  const Lay lay(p);
  const int ss = lay.ss, sx = lay.sx, sy = lay.sy;
  const int c = blockIdx.x, grp = blockIdx.y, h0 = grp * hg, b = blockIdx.z;
  const int nc = seq / CL, groups = gridDim.y;
  const int nh = min(hg, h - h0);
  const int pk = round_up(p, 8);
  extern __shared__ __align__(16) float smem[];
  float* sc_s = smem;
  float* acc_s = sc_s + Lm * ss;
  float* x_s = acc_s + Lm * ss;
  float* dy_s = x_s + Lm * sx;
  float* cs_s = dy_s + Lm * sy;
  float* dt_s = cs_s + Lm;
  float* xd_s = dt_s + Lm;              // (kWarps, Lm)
  float* rowp = xd_s + kWarps * Lm;     // (2, Lm)
  float* colp = rowp + 2 * Lm;          // (MT, Lm)
  float* last_s = colp + MT * Lm;
  zero_smem(smem, lay.floats());
  const size_t t0 = (size_t)b * seq + (size_t)c * CL;
  {
    const float* src = scores + ((size_t)b * nc + c) * CL * CL;
    for (int e = threadIdx.x; e < CL * CL; e += kThreads) {
      const int i = e / CL, j = e - i * CL;
      sc_s[i * ss + j] = src[e];
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t row = (size_t)h * p;

  for (int hi = 0; hi < nh; ++hi) {
    const int head = h0 + hi;
    load_tile(x_s, sx, x + t0 * row + (size_t)head * p, row, CL, p);
    load_tile(dy_s, sy, dy + t0 * row + (size_t)head * p, row, CL, p);
    cp_async_commit();
    // warp 0 reads (c)'s inputs of stage 4 now, while the products run
    constexpr int V = CL >= 32 ? CL / 32 : 1;
    float dwv[V], dco[V];
    if (warp == 0) {
      const float last = chunk_cumsum<CL>(dt + t0 * h + head, h, a[head],
                                          [&](int j, float cs, float d, float) {
                                            cs_s[j] = cs;
                                            dt_s[j] = d;
                                          });
      if (lane == 0) last_s[0] = last;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int j = lane * V + v;
        const size_t at = (t0 + j) * h + head;
        dwv[v] = j < CL ? dw_in[at] : 0.f;
        dco[v] = j < CL ? dcs_off[at] : 0.f;
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // (a) dyx_ij = dy_i.x_j over the triangle i >= j, whence Q_ij =
    // L_ij dt_j dyx_ij (C_i.B_j), its row and column sums, and dS += L dt dyx.
    // Warps 2 q and 2 q + 1 take row tiles q and MT - 1 - q, the even and
    // the odd column tiles of each.
    if (warp / 2 < NPAIR) {
      const int parity = warp & 1, n0 = 8 * parity;
      const int m0[2] = {16 * (warp / 2), 16 * (MT - 1 - warp / 2)};
      const int nts[2] = {(min(m0[0] / 8 + 2, CL / 8) - parity + 1) / 2,
                          m0[1] == m0[0] ? 0 : (min(m0[1] / 8 + 2, CL / 8) - parity + 1) / 2};
      float acc[2][8][4] = {};
#pragma unroll
      for (int side = 0; side < 2; ++side)
        warp_product<8, 16>(acc[side], m0[side], n0, nts[side], 0, nts[side] > 0 ? pk : 0,
                            [&](int i, int k) { return dy_s[i * sy + k]; },
                            [&](int k, int j) { return x_s[j * sx + k]; });
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        if (nts[side] <= 0) continue;
        const int m = m0[side] / 16;
        float rs[2] = {0.f, 0.f}, cols[8][2] = {};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (k >= nts[side]) continue;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = m0[side] + g + 8 * (r >> 1), j = n0 + 16 * k + 2 * t + (r & 1);
            if (i >= CL || j > i) continue;
            const float u = expf(cs_s[i] - cs_s[j]) * dt_s[j] * acc[side][k][r];
            acc_s[i * ss + j] += u;
            const float q = u * sc_s[i * ss + j];
            rs[r >> 1] += q;
            cols[k][r & 1] += q;
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          rs[u] += __shfl_xor_sync(kFull, rs[u], 1);
          rs[u] += __shfl_xor_sync(kFull, rs[u], 2);
          if (t == 0) rowp[parity * Lm + m0[side] + g + 8 * u] = rs[u];
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            float s = cols[k][v];
            s += __shfl_xor_sync(kFull, s, 4);
            s += __shfl_xor_sync(kFull, s, 8);
            s += __shfl_xor_sync(kFull, s, 16);
            if (g == 0 && k < nts[side]) colp[m * Lm + n0 + 16 * k + 2 * t + v] = s;
          }
        }
      }
    }

    // (b) dxdt_j = sum_{i >= j} L_ij (C_i.B_j) dy_i: M = L (j), N = P,
    // K = L (i, from the row tile's first row): dx += dt_j dxdt_j and
    // x_j.dxdt_j.  Warp w takes row tiles w % NPAIR and MT - 1 - w % NPAIR,
    // and NPAIR of P's tiles from NPAIR (w / NPAIR).
    {
      const int pair = warp % NPAIR, part = warp / NPAIR;
      const int n0 = 8 * NPAIR * part, nt = min(NPAIR, pk / 8 - NPAIR * part);
      const int m0[2] = {16 * pair, 16 * (MT - 1 - pair)};
      const int nts[2] = {nt, m0[1] == m0[0] ? 0 : nt};
      float acc[2][NPAIR][4] = {};
#pragma unroll
      for (int side = 0; side < 2; ++side)
        warp_product<NPAIR>(acc[side], m0[side], n0, nts[side], min(m0[side], CL),
                            nts[side] > 0 ? CL : min(m0[side], CL),
                            [&](int j, int i) {
                              return i >= j ? expf(cs_s[i] - cs_s[j]) * sc_s[i * ss + j]
                                            : 0.f;
                            },
                            [&](int i, int q) { return dy_s[i * sy + q]; });
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        if (nts[side] <= 0) continue;
        float xd[2] = {0.f, 0.f};
#pragma unroll
        for (int k = 0; k < NPAIR; ++k) {
          const int q = n0 + 8 * k + 2 * t;
          if (k >= nts[side] || q >= p) continue;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int j = m0[side] + g + 8 * u;
            if (j >= CL) continue;
            const float v0 = acc[side][k][2 * u], v1 = acc[side][k][2 * u + 1];
            float2* at = reinterpret_cast<float2*>(dx + (t0 + j) * row + (size_t)head * p + q);
            const float2 old = *at;
            *at = make_float2(old.x + dt_s[j] * v0, old.y + dt_s[j] * v1);
            xd[u] += x_s[j * sx + q] * v0 + x_s[j * sx + q + 1] * v1;
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          xd[u] += __shfl_xor_sync(kFull, xd[u], 1);
          xd[u] += __shfl_xor_sync(kFull, xd[u], 2);
          if (t == 0) xd_s[part * Lm + m0[side] + g + 8 * u] = xd[u];
        }
      }
    }
    __syncthreads();

    // (c) d(cs), its reverse cumsum d(dA), ddt and the chunk's part of da,
    // by one warp: lane l takes steps [l V, l V + V).
    if (warp == 0) {
      const float last = last_s[0], a_h = a[head];
      float dcs[V], wdw = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int j = lane * V + v;
        dcs[v] = 0.f;
        if (j >= CL) continue;
        const float w = expf(last - cs_s[j]) * dt_s[j];
        float r = dco[v] - w * dwv[v] + rowp[j] + rowp[Lm + j];
#pragma unroll
        for (int m = 0; m < MT; ++m) r -= colp[m * Lm + j];
        dcs[v] = r;
        wdw += w * dwv[v];
      }
      wdw = warp_sum(wdw);
      if (lane * V + V - 1 == CL - 1)      // the lane that holds the last step
        dcs[V - 1] += wdw + dot[((size_t)b * h + head) * nc + c];
      float run = 0.f;
#pragma unroll
      for (int v = V - 1; v >= 0; --v) {
        run += dcs[v];
        dcs[v] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(kFull, incl, o);
        if (lane + o < 32) incl += u;
      }
      float after = __shfl_down_sync(kFull, incl, 1);
      if (lane == 31) after = 0.f;
      float dap = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int j = lane * V + v;
        if (j >= CL) continue;
        const float dda = dcs[v] + after;
        float xd = 0.f;
#pragma unroll
        for (int q = 0; q < kWarps / NPAIR; ++q) xd += xd_s[q * Lm + j];
        ddt[(t0 + j) * h + head] = xd + expf(last - cs_s[j]) * dwv[v] + a_h * dda;
        dap += dt_s[j] * dda;
      }
      dap = warp_sum(dap);
      if (lane == 0) da_part[((size_t)b * nc + c) * h + head] = dap;
    }
    __syncthreads();                   // the head's tiles are refilled next
  }

  float* out = dsp + (((size_t)b * nc + c) * groups + grp) * CL * CL;
  for (int e = threadIdx.x; e < CL * CL; e += kThreads) {
    const int i = e / CL, j = e - i * CL;
    out[e] = acc_s[i * ss + j];
  }
}

// ---- 4 and 5 on the tensor-core route: one launch ----
//
// For P = 64, chunk 64 or 128 and N a multiple of 16 up to 128
// (tc::takes).  One CTA per (chunk, group of heads, batch row) of CL / 64
// warpgroups; warp m owns the 16-row tile m of the chunk, thread
// (g, t) = (lane / 4, lane % 4) rows 16 m + g and 16 m + g + 8 of every
// m64 product.  For each head of the group, four products on wgmma
// m64nNk8 .tf32 in split TF32 (lo.hi + hi.lo + hi.hi), each with its A
// operand in registers (split there, as it is loaded) and its B operand a
// K-major hi and lo tile in shared memory (split once, as it is staged):
//
//   (x)    dyx = dy.x^T, M = L (i), N = 64 columns (j) at a time (one
//          half for the first warpgroup, two for the second), K = P:
//          dS_ij = L_ij dt_j dyx_ij for j <= i, summed over the group in
//          shared memory, and the row and column sums of dS * (C.B^T) (the
//          gradient of cs through L);
//   (prev) YO = C.prev_c^T, M = L (i), N = P, K = N: e_i dy_i.YO_i;
//   (D)    DB = B.D_{c+1}^T, M = L (j), N = P, K = N: dw_j = x_j.DB_j; DB
//          stays in registers until dx is written;
//   (dyT)  dxdt = (L * (C.B^T)^T).dy, M = L (j), N = P, K = L (i >= j,
//          from the warpgroup's first row): dx_j = w_j DB_j + dt_j dxdt_j
//          and x_j.dxdt_j;
//
// then, by one warp, d(cs), its reverse cumsum d(dA), ddt and the chunk's
// part of da: dw and d(cs) never leave shared memory.  After the group its
// dS is written as the group's partial, which stage 6 sums in order.
//
// Tiles.  The tiles of the phases (x, prev, D, dy of each head in turn)
// are fetched whole with cp.async into two raw buffers, two phases ahead,
// so a tile's bytes are all in flight at once; before its phase the
// threads split it into the hi and lo tiles that the phase's products read
// (dy transposed to dy^T there).  A K-major f32 tile of R
// rows is panels of 32 K columns, 128 bytes a row, each 16-byte chunk
// XOR-ed with the row % 8 (wgmma's 128-byte swizzle); a k-step (8 K) is 32
// bytes on.  <D, prev> is taken as D is split over prev's tile.
//
// A operands (rows of dy, B and C; the decayed scores) are read from
// global memory, where the group's CTAs keep them in L2, two pairs of
// k-steps ahead, and so are the epilogues' x and dy in (prev) and (D).  A thread reads 16 bytes of a row, columns 16 p + 4 t .. + 3, for
// the two k-steps of pair p, so K is permuted within each 16 (column
// 16 p + 4 t + u is K position 16 p + 8 (u / 2) + 4 (u % 2) + t) and the B
// tiles x, D and prev are split in that order; dy^T takes K (the chunk's
// steps) in order.
//
// The decay is factored as in the forward's chunk scan, so there is no
// exp off the diagonal 16 x 16 blocks and every exponent is of a
// non-positive difference: in (x), L_ij dt_j = r_i W[m][j] for j < 16 m,
// r_i = exp(cs_i - cs_16m), W[m][j] = exp(cs_16m - cs_j) dt_j; in (dyT),
// L_ij = V[m][i] r'_j for i > 16 m + 15, r'_j = exp(cs_{16m+15} - cs_j),
// V[m][i] = exp(cs_i - cs_{16m+15}).
//
// Design notes, from tools/ssd_bwd_probe.py on an H100 at mamba2-370m's
// training shape: the product loops stay rolled (fully unrolled, the
// kernel was 178 KB of code and took 1.15 ms a call against 0.81); every
// branch around an exp is the warp's, not the lane's; one accumulator
// array per wgmma shape, else ptxas serializes the wgmmas.
//
// Shared memory (1024-byte aligned): the hi and lo tiles (32 KB each), two
// raw buffers (CL x (P + 4) or P x (N + 4) floats each), the group's dS
// (CL x (CL + 8)), then cs, dt, e, w (CL each), W and V (MT x CL each),
// dw, e dy.YO, the row sums and x.dxdt (CL each), the column sums by warp
// (warps x CL), the dot's warp partials, cs_last and the dot: 222,248
// bytes at chunk 128.

namespace tc {

constexpr int kP = 64;
constexpr int kTile = 32768;               // bytes of a hi or a lo tile

__host__ __device__ constexpr bool takes(int p, int n, int cl) {
  return p == kP && n % 16 == 0 && n >= 16 && n <= 128 && (cl == 64 || cl == 128);
}

template <int CL>
struct Fused {
  static constexpr int kThr = 128 * (CL / 64);
  static constexpr int kWarpsF = kThr / 32;
  static constexpr int MT = CL / 16;
  static constexpr int kRawX = CL * (kP + 4), kRawD = kP * (128 + 4);
  static constexpr int kRaw = kRawX > kRawD ? kRawX : kRawD;   // floats of a raw buffer
  static constexpr int kDsRow = CL + 8;
  // floats after the hi and lo tiles: two raw buffers, then the rest
  static constexpr int kDs = 2 * kRaw, kCs = kDs + CL * kDsRow, kDt = kCs + CL, kE = kDt + CL,
                       kW = kE + CL, kTabW = kW + CL, kTabV = kTabW + MT * CL,
                       kDw = kTabV + MT * CL, kDco = kDw + CL, kRowq = kDco + CL,
                       kXd = kRowq + CL, kColp = kXd + CL, kRed = kColp + kWarpsF * CL,
                       kLast = kRed + kWarpsF, kDot = kLast + 1, kFloats = kDot + 1;
  static constexpr size_t kBytes = 1024 + 2 * (size_t)kTile + (size_t)kFloats * 4;
};

// Byte offset of element (r, k) of a K-major tile of `rows` rows.
__device__ __forceinline__ uint32_t sw(int r, int k, int rows) {
  return (uint32_t)((k >> 5) * rows * 128 + r * 128 + ((((k & 31) >> 2) ^ (r & 7)) << 4) +
                    ((k & 3) << 2));
}

// A (rows, cols) tile from global memory (row stride gs floats) into a
// raw buffer (row stride cols + 4), 16 bytes a cp.async.
template <int kThr>
__device__ __forceinline__ void fetch(float* raw, const float* src, size_t gs, int rows,
                                      int cols) {
  const int c4 = cols / 4, rs = cols + 4;
  for (int e = threadIdx.x; e < rows * c4; e += kThr) {
    const int r = e / c4, c = 4 * (e - r * c4);
    cp_async16(raw + r * rs + c, src + (size_t)r * gs + c);
  }
}

// v split into the hi tile at `tiles` and, kTile bytes on, the lo tile:
// 16 bytes of each.
__device__ __forceinline__ void put4(unsigned char* tiles, uint32_t off, float4 v) {
  uint4 hi, lo;
  hi.x = tf32_bits(v.x); lo.x = tf32_bits(v.x - __uint_as_float(hi.x));
  hi.y = tf32_bits(v.y); lo.y = tf32_bits(v.y - __uint_as_float(hi.y));
  hi.z = tf32_bits(v.z); lo.z = tf32_bits(v.z - __uint_as_float(hi.z));
  hi.w = tf32_bits(v.w); lo.w = tf32_bits(v.w - __uint_as_float(hi.w));
  *reinterpret_cast<uint4*>(tiles + off) = hi;
  *reinterpret_cast<uint4*>(tiles + kTile + off) = lo;
}

__device__ __forceinline__ float4 got4(const unsigned char* tiles, uint32_t off) {
  const float4 hi = *reinterpret_cast<const float4*>(tiles + off);
  const float4 lo = *reinterpret_cast<const float4*>(tiles + kTile + off);
  return make_float4(hi.x + lo.x, hi.y + lo.y, hi.z + lo.z, hi.w + lo.w);
}

// The raw (rows, cols) tile into the hi and lo tiles, K = the columns
// permuted: a thread takes 16 columns of a row, whose K positions are four
// 16-byte chunks.  With `dot`, first adds the tile there (staged alike)
// times this one to *dot.
template <int kThr>
__device__ __forceinline__ void split_kmajor(unsigned char* tiles, const float* raw, int rows,
                                             int cols, float* dot) {
  const int c16 = cols / 16, rs = cols + 4;
  for (int e = threadIdx.x; e < rows * c16; e += kThr) {
    const int r = e / c16, c = 16 * (e - r * c16);
    float4 v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = *reinterpret_cast<const float4*>(raw + r * rs + c + 4 * q);
    const float4 k[4] = {make_float4(v[0].x, v[1].x, v[2].x, v[3].x),
                         make_float4(v[0].y, v[1].y, v[2].y, v[3].y),
                         make_float4(v[0].z, v[1].z, v[2].z, v[3].z),
                         make_float4(v[0].w, v[1].w, v[2].w, v[3].w)};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t off = sw(r, c + 4 * u, rows);
      if (dot) {
        const float4 o = got4(tiles, off);
        *dot += o.x * k[u].x + o.y * k[u].y + o.z * k[u].z + o.w * k[u].w;
      }
      put4(tiles, off, k[u]);
    }
  }
}

// A raw (rows, cols) tile (row stride cols + 4) into the hi and lo tiles
// transposed: `cols` rows, K = the raw rows in order; a thread takes a
// 4 x 4 block.
template <int kThr>
__device__ __forceinline__ void split_transposed(unsigned char* tiles, const float* raw, int rows,
                                                 int cols) {
  const int rs = cols + 4, r4 = rows / 4;
  for (int e = threadIdx.x; e < rows * cols / 16; e += kThr) {
    const int i = 4 * (e % r4), q = 4 * (e / r4);
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = *reinterpret_cast<const float4*>(raw + (i + u) * rs + q);
    put4(tiles, sw(q, i, cols), make_float4(v[0].x, v[1].x, v[2].x, v[3].x));
    put4(tiles, sw(q + 1, i, cols), make_float4(v[0].y, v[1].y, v[2].y, v[3].y));
    put4(tiles, sw(q + 2, i, cols), make_float4(v[0].z, v[1].z, v[2].z, v[3].z));
    put4(tiles, sw(q + 3, i, cols), make_float4(v[0].w, v[1].w, v[2].w, v[3].w));
  }
}

// One pair's six wgmmas (k-steps 2 p and 2 p + 1, lo.hi + hi.lo + hi.hi)
// on its split A values f (hi in f[0..7], lo in f[8..15]), one commit group.
template <int kN, int kLo>
__device__ __forceinline__ void issue_pair(float (&acc)[kN / 2], uint32_t (&f)[16],
                                           uint32_t tiles, int panel, int p) {
  hopper::fence_regs(f);
  hopper::wgmma_fence();
  const uint32_t off = (uint32_t)((p >> 1) * panel + (p & 1) * 64);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const uint64_t dh = hopper::sw128_desc(tiles + off + 32 * e, 16, 1024);
    const uint64_t dl = hopper::sw128_desc(tiles + kLo + off + 32 * e, 16, 1024);
    const uint32_t(&ah)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&f[4 * e]);
    const uint32_t(&al)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&f[8 + 4 * e]);
    hopper::wgmma_tf32_rs<kN>(acc, al, dh, 1);
    hopper::wgmma_tf32_rs<kN>(acc, ah, dl, 1);
    hopper::wgmma_tf32_rs<kN>(acc, ah, dh, 1);
  }
  hopper::wgmma_commit();
}

__device__ __forceinline__ void split8(uint32_t (&f)[16], const float (&v)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    f[k] = tf32_bits(v[k]);
    f[8 + k] = tf32_bits(v[k] - __uint_as_float(f[k]));
  }
}

// acc (kN columns) += A B over the k-step pairs [p0, p1) in split TF32, by
// one warpgroup; B is the hi tile at `tiles` and the lo tile kLo bytes on
// (panels `panel` bytes apart).  load(p, v) fills v[0..7] with pair p's
// raw A values (k-step 2 p's a[0..3], then 2 p + 1's), two pairs ahead;
// shape(p, v) then makes them the operand.  Two pairs are in flight, in two sets of
// registers: a set is rewritten only once the wgmmas that read it are
// done.  The loop is not unrolled, so the kernel's code stays small
// enough for the instruction cache.
template <int kN = 64, int kLo = kTile, typename Load, typename Shape>
__device__ __forceinline__ void product(float (&acc)[kN / 2], uint32_t tiles, int panel, int p0,
                                        int p1, Load load, Shape shape) {
  float cur[8], nxt[8], nxt2[8];
  uint32_t fa[16], fb[16];
  if (p0 < p1) load(p0, nxt);
  if (p0 + 1 < p1) load(p0 + 1, nxt2);
  hopper::fence_regs(acc);
  auto step = [&](int p, uint32_t (&f)[16]) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      cur[k] = nxt[k];
      nxt[k] = nxt2[k];
    }
    if (p + 2 < p1) load(p + 2, nxt2);
    shape(p, cur);
    split8(f, cur);
    issue_pair<kN, kLo>(acc, f, tiles, panel, p);
    hopper::wgmma_wait<1>();
  };
#pragma unroll 1
  for (int p = p0; p < p1; p += 2) {
    step(p, fa);
    if (p + 1 < p1) step(p + 1, fb);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
}

// 16 bytes of each of two rows as a pair's raw A values: v[0..3] k-step
// 2 p (a[0] row 0, a[1] row 1, a[2] and a[3] the same rows one column on),
// v[4..7] k-step 2 p + 1.
__device__ __forceinline__ void load_pair(float (&v)[8], const float* r0, const float* r1) {
  const float4 u0 = *reinterpret_cast<const float4*>(r0);
  const float4 u1 = *reinterpret_cast<const float4*>(r1);
  v[0] = u0.x; v[1] = u1.x; v[2] = u0.y; v[3] = u1.y;
  v[4] = u0.z; v[5] = u1.z; v[6] = u0.w; v[7] = u1.w;
}

template <int kN>
__device__ __forceinline__ void zero(float (&x)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) x[i] = 0.f;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

template <int CL>
__global__ void __launch_bounds__(Fused<CL>::kThr, 1)
ssd_bwd_fused_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ bmat,
                     const float* __restrict__ cmat, const float* __restrict__ dy,
                     const float* __restrict__ scores, const float* __restrict__ states,
                     const float* __restrict__ dstate, float* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dsp,
                     float* __restrict__ da_part, int seq, int h, int n, int hg) {
  using F = Fused<CL>;
  constexpr int P = kP, MT = F::MT, kThr = F::kThr, kWarpsF = F::kWarpsF;
  extern __shared__ __align__(16) unsigned char fused_smem[];
  unsigned char* tiles =
      fused_smem + ((1024 - (hopper::smem_addr(fused_smem) & 1023)) & 1023);
  const uint32_t ts = hopper::smem_addr(tiles);
  float* fs = reinterpret_cast<float*>(tiles + 2 * kTile);
  auto raw_of = [&](int k) { return fs + (k & 1) * F::kRaw; };   // raw buffer of tile k
  float* ds_s = fs + F::kDs;
  float *cs_s = fs + F::kCs, *dt_s = fs + F::kDt, *e_s = fs + F::kE, *w_s = fs + F::kW;
  float *tab_w = fs + F::kTabW, *tab_v = fs + F::kTabV, *dw_s = fs + F::kDw;
  float *dco_s = fs + F::kDco, *rowq = fs + F::kRowq, *xd_s = fs + F::kXd;
  float *colp = fs + F::kColp, *red = fs + F::kRed, *last_s = fs + F::kLast;
  float* dot_s = fs + F::kDot;

  const int c = blockIdx.x, grp = blockIdx.y, h0 = grp * hg, b = blockIdx.z;
  const int nc = seq / CL, groups = gridDim.y, nh = min(hg, h - h0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp / 4, m = warp;         // the warp's 16-row tile
  const int r0 = 16 * m + g, r1 = r0 + 8;    // the thread's rows
  const size_t t0 = (size_t)b * seq + (size_t)c * CL;
  const size_t row = (size_t)h * P;
  const float* sc = scores + ((size_t)b * nc + c) * CL * CL;
  const float* bm = bmat + t0 * n;
  const float* cm = cmat + t0 * n;
  auto sidx = [&](int head) { return (((size_t)b * h + head) * nc + c) * P * n; };
  auto head_x = [&](int head) { return x + t0 * row + (size_t)head * P; };
  auto head_dy = [&](int head) { return dy + t0 * row + (size_t)head * P; };
  // Tile k of the CTA's sequence: head h0 + k / 4's x, prev, D or dy
  // (k % 4), fetched whole into raw buffer k % 2, one commit group each
  // (empty past the group's last head).
  auto fetch_tile = [&](int k) {
    const int head = h0 + k / 4;
    float* raw = raw_of(k);
    if (k / 4 < nh) {
      switch (k & 3) {
        case 0: fetch<kThr>(raw, head_x(head), row, CL, P); break;
        case 1: fetch<kThr>(raw, states + sidx(head), n, P, n); break;
        case 2: fetch<kThr>(raw, dstate + sidx(head), n, P, n); break;
        default: fetch<kThr>(raw, head_dy(head), row, CL, P); break;
      }
    }
    cp_async_commit();
  };
  // Before phase k: once tile k has landed (k + 1 may be in flight) and
  // every warpgroup is done with the hi and lo tiles, split tile k into
  // them (D over prev's, adding <D, prev> to *dot), then fetch tile k + 2
  // into the raw buffer it leaves.
  auto stage = [&](int k, float* dot) {
    cp_async_wait<1>();
    __syncthreads();
    const float* raw = raw_of(k);
    switch (k & 3) {
      case 0: split_kmajor<kThr>(tiles, raw, CL, P, nullptr); break;
      case 1: split_kmajor<kThr>(tiles, raw, P, n, nullptr); break;
      case 2: split_kmajor<kThr>(tiles, raw, P, n, dot); break;
      default: split_transposed<kThr>(tiles, raw, CL, P); break;
    }
    hopper::fence_proxy_async();
    __syncthreads();
    fetch_tile(k + 2);
  };

  for (int e = tid; e < CL * F::kDsRow; e += kThr) ds_s[e] = 0.f;
  fetch_tile(0);
  fetch_tile(1);
  stage(0, nullptr);

  for (int hi = 0; hi < nh; ++hi) {
    const int head = h0 + hi;
    const float* xh = head_x(head);
    const float* dyh = head_dy(head);
    if (warp == 0) {
      const float last = chunk_cumsum<CL>(dt + t0 * h + head, h, a[head],
                                          [&](int j, float cs, float d, float) {
                                            cs_s[j] = cs;
                                            dt_s[j] = d;
                                          });
      if (lane == 0) last_s[0] = last;
    }
    __syncthreads();
    {
      const float last = last_s[0];
      for (int j = tid; j < CL; j += kThr) {
        e_s[j] = expf(cs_s[j]);
        w_s[j] = expf(last - cs_s[j]) * dt_s[j];
      }
      for (int e = tid; e < MT * CL; e += kThr) {
        const int mm = e / CL, j = e - mm * CL;
        tab_w[e] = j < 16 * mm ? expf(cs_s[16 * mm] - cs_s[j]) * dt_s[j] : 0.f;
        tab_v[e] = j > 16 * mm + 15 ? expf(cs_s[j] - cs_s[16 * mm + 15]) : 0.f;
      }
    }
    __syncthreads();

    // (x): dyx, then dS, its row sums, and its column sums by warp; by 64
    // columns (j), one half for the first warpgroup (j <= i < 64), two for
    // the second
    {
      auto load = [&](int p, float (&v)[8]) {
        load_pair(v, dyh + r0 * row + 16 * p + 4 * t, dyh + r1 * row + 16 * p + 4 * t);
      };
      auto same = [](int, float (&)[8]) {};
      const float* wrow = tab_w + m * CL;
      const float ra[2] = {expf(cs_s[r0] - cs_s[16 * m]), expf(cs_s[r1] - cs_s[16 * m])};
      float rs[2] = {0.f, 0.f};
#pragma unroll 1
      for (int half = 0; half <= wg; ++half) {
        float acc[32];
        zero(acc);
        float2 s2v[8][2];   // the epilogue's scores, loaded while the products run
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            s2v[i][u] = *reinterpret_cast<const float2*>(
                sc + (size_t)(u ? r1 : r0) * CL + 64 * half + 8 * i + 2 * t);
        product(acc, ts + half * 64 * 128, CL * 128, 0, P / 16, load, same);
        // dS and Q = dS * (C.B^T) over the half's column tiles jt = 8 half
        // + i: below the warp's diagonal block (jt < 2 m) the decay comes
        // from the table, in the block's two an exp masked to j <= i, past
        // it all is zero; the branches are the warp's, not the lane's
        float cp[8][2];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int jt = 8 * half + i, j0 = 8 * jt + 2 * t;
          cp[i][0] = cp[i][1] = 0.f;
          if (jt > 2 * m + 1) continue;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int ii = u ? r1 : r0;
            float dec[2];
            if (jt < 2 * m) {
              const float2 w2 = *reinterpret_cast<const float2*>(wrow + j0);
              dec[0] = ra[u] * w2.x;
              dec[1] = ra[u] * w2.y;
            } else {
#pragma unroll
              for (int v = 0; v < 2; ++v)
                dec[v] = j0 + v <= ii ? expf(cs_s[ii] - cs_s[j0 + v]) * dt_s[j0 + v] : 0.f;
            }
            const float2 s2 = s2v[i][u];
            float2* dsp2 = reinterpret_cast<float2*>(ds_s + ii * F::kDsRow + j0);
            float2 d2 = *dsp2;
            const float du0 = dec[0] * acc[4 * i + 2 * u], du1 = dec[1] * acc[4 * i + 2 * u + 1];
            d2.x += du0;
            d2.y += du1;
            *dsp2 = d2;
            const float q0 = du0 * s2.x, q1 = du1 * s2.y;
            rs[u] += q0 + q1;
            cp[i][0] += q0;
            cp[i][1] += q1;
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            cp[i][v] += __shfl_xor_sync(kFull, cp[i][v], 4);
            cp[i][v] += __shfl_xor_sync(kFull, cp[i][v], 8);
            cp[i][v] += __shfl_xor_sync(kFull, cp[i][v], 16);
          }
          if (g == 0)
            *reinterpret_cast<float2*>(colp + warp * CL + 64 * half + 8 * i + 2 * t) =
                make_float2(cp[i][0], cp[i][1]);
        }
      }
      rs[0] = quad_sum(rs[0]);
      rs[1] = quad_sum(rs[1]);
      if (t == 0) {
        rowq[r0] = rs[0];
        rowq[r1] = rs[1];
      }
    }
    stage(4 * hi + 1, nullptr);

    // (prev): YO = C.prev^T and e_i dy_i.YO_i
    {
      float yo[32];
      zero(yo);
      auto load = [&](int p, float (&v)[8]) {
        load_pair(v, cm + (size_t)r0 * n + 16 * p + 4 * t, cm + (size_t)r1 * n + 16 * p + 4 * t);
      };
      auto same = [](int, float (&)[8]) {};
      float2 ev[8][2];    // the epilogue's dy, loaded while the products run
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          ev[i][u] = *reinterpret_cast<const float2*>(dyh + (u ? r1 : r0) * row + 8 * i + 2 * t);
      product(yo, ts, P * 128, 0, n / 16, load, same);
      float ys[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float2 dv = ev[i][u];
          ys[u] += dv.x * yo[4 * i + 2 * u] + dv.y * yo[4 * i + 2 * u + 1];
        }
      }
      ys[0] = quad_sum(ys[0]);
      ys[1] = quad_sum(ys[1]);
      if (t == 0) {
        dco_s[r0] = e_s[r0] * ys[0];
        dco_s[r1] = e_s[r1] * ys[1];
      }
    }
    {
      float dotp = 0.f;   // <D, prev>, as D is split over prev's tiles
      stage(4 * hi + 2, &dotp);
      dotp = warp_sum(dotp);
      if (lane == 0) red[warp] = dotp;
    }

    // (D): DB = B.D^T and dw_j = x_j.DB_j
    float db[32];
    zero(db);
    {
      auto load = [&](int p, float (&v)[8]) {
        load_pair(v, bm + (size_t)r0 * n + 16 * p + 4 * t, bm + (size_t)r1 * n + 16 * p + 4 * t);
      };
      auto same = [](int, float (&)[8]) {};
      float2 ev[8][2];    // the epilogue's x, loaded while the products run
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          ev[i][u] = *reinterpret_cast<const float2*>(xh + (u ? r1 : r0) * row + 8 * i + 2 * t);
      product(db, ts, P * 128, 0, n / 16, load, same);
      float dwp[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float2 xv = ev[i][u];
          dwp[u] += xv.x * db[4 * i + 2 * u] + xv.y * db[4 * i + 2 * u + 1];
        }
      }
      dwp[0] = quad_sum(dwp[0]);
      dwp[1] = quad_sum(dwp[1]);
      if (t == 0) {
        dw_s[r0] = dwp[0];
        dw_s[r1] = dwp[1];
      }
    }
    stage(4 * hi + 3, nullptr);

    // (dyT): dxdt, then dx and x.dxdt
    {
      float acc[32];
      zero(acc);
      const float* vrow = tab_v + m * CL;
      const int edge = 16 * m + 15;
      const float rb[2] = {expf(cs_s[edge] - cs_s[r0]), expf(cs_s[edge] - cs_s[r1])};
      // v[k]: k-step 2 p + k / 4, a[k % 4]: row r0 or r1 (k odd), step
      // i = 16 p + 8 (k / 4) + t (+ 4 for a[2], a[3])
      auto load = [&](int p, float (&v)[8]) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int i = 16 * p + 8 * (k >> 2) + t + 4 * ((k >> 1) & 1);
          v[k] = sc[(size_t)i * CL + ((k & 1) ? r1 : r0)];
        }
      };
      // pair p covers steps 16 p .. 16 p + 15: before the warp's rows
      // (p < m) zero, its diagonal block (p == m) an exp masked to i >= j,
      // past it the table; the branches are the warp's, not the lane's
      auto shape = [&](int p, float (&v)[8]) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int i = 16 * p + 8 * (k >> 2) + t + 4 * ((k >> 1) & 1);
          const int j = (k & 1) ? r1 : r0;
          float f;
          if (p < m) f = 0.f;
          else if (p == m) f = i >= j ? expf(cs_s[i] - cs_s[j]) : 0.f;
          else f = vrow[i] * rb[k & 1];
          v[k] *= f;
        }
      };
      product(acc, ts, P * 128, 4 * wg, CL / 16, load, shape);
      float xd[2] = {0.f, 0.f};
      const float wj[2] = {w_s[r0], w_s[r1]}, dj[2] = {dt_s[r0], dt_s[r1]};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const size_t at = (t0 + (u ? r1 : r0)) * row + (size_t)head * P + 8 * i + 2 * t;
          const float2 xv = *reinterpret_cast<const float2*>(x + at);
          const float v0 = acc[4 * i + 2 * u], v1 = acc[4 * i + 2 * u + 1];
          *reinterpret_cast<float2*>(dx + at) =
              make_float2(wj[u] * db[4 * i + 2 * u] + dj[u] * v0,
                          wj[u] * db[4 * i + 2 * u + 1] + dj[u] * v1);
          xd[u] += xv.x * v0 + xv.y * v1;
        }
      }
      xd[0] = quad_sum(xd[0]);
      xd[1] = quad_sum(xd[1]);
      if (t == 0) {
        xd_s[r0] = xd[0];
        xd_s[r1] = xd[1];
      }
    }
    if (hi + 1 < nh)
      stage(4 * hi + 4, nullptr);
    else
      __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < kWarpsF; ++w) s += red[w];
      dot_s[0] = expf(last_s[0]) * s;
    }
    __syncthreads();

    // d(cs), its reverse cumsum d(dA), ddt and the chunk's part of da, by
    // one warp: lane l takes steps [l V, l V + V)
    if (warp == 0) {
      constexpr int V = CL / 32;
      const float last = last_s[0], a_h = a[head];
      float dcs[V], ex[V], wdw = 0.f;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int j = lane * V + k;
        ex[k] = expf(last - cs_s[j]);
        float r = dco_s[j] - w_s[j] * dw_s[j] + rowq[j];
        // a warp of warpgroup w holds columns j < 64 (w + 1)
        for (int w = 0; w < kWarpsF; ++w)
          if (j < 64 * (w / 4 + 1)) r -= colp[w * CL + j];
        dcs[k] = r;
        wdw += w_s[j] * dw_s[j];
      }
      wdw = warp_sum(wdw);
      if (lane == 31) dcs[V - 1] += wdw + dot_s[0];
      float run = 0.f;
#pragma unroll
      for (int k = V - 1; k >= 0; --k) {
        run += dcs[k];
        dcs[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(kFull, incl, o);
        if (lane + o < 32) incl += u;
      }
      float after = __shfl_down_sync(kFull, incl, 1);
      if (lane == 31) after = 0.f;
      float dap = 0.f;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int j = lane * V + k;
        const float dda = dcs[k] + after;
        ddt[(t0 + j) * h + head] = xd_s[j] + ex[k] * dw_s[j] + a_h * dda;
        dap += dt_s[j] * dda;
      }
      dap = warp_sum(dap);
      if (lane == 0) da_part[((size_t)b * nc + c) * h + head] = dap;
    }
    __syncthreads();                  // cs, dt and the sums are rewritten next
  }

  // the group's dS (zeros over j > i)
  float* out = dsp + (((size_t)b * nc + c) * groups + grp) * CL * CL;
  for (int e = tid; e < CL * CL / 4; e += kThr) {
    const int i = e / (CL / 4), j = 4 * (e - i * (CL / 4));
    *reinterpret_cast<float4*>(out + (size_t)i * CL + j) =
        *reinterpret_cast<const float4*>(ds_s + i * F::kDsRow + j);
  }
}

// ---- 6 on the tensor-core route: dB and dC ----
//
// For the shapes of tc::takes with N = 64 or 128.  One CTA per (chunk,
// batch row, output) of CL / 64 warpgroups, warpgroup w the output rows
// 64 w .. 64 w + 63, as sums on wgmma m64nNk8 .tf32 in split TF32, N the
// state's N:
//
//   dC_i = sum_j dS_ij B_j + sum_{h,p} e_i dy_i[h][p] prev_h[p]
//   dB_j = sum_i dS_ij C_i + sum_{h,p} w_j x_j[h][p] D_h[p]
//
// The first sum's A operand is dS (or dS^T), the group partials summed in
// group order as they are read, K = the chunk's steps in 64-step halves
// (a half that is all zero under the causal mask is skipped); its B operand
// is B (or C) transposed.  The second sum runs over every head in order:
// A = e dy (or w x), K = P, B = prev_h (or D_h) transposed.  Each B tile,
// (64 rows, N) in global memory, is fetched with cp.async two tiles ahead
// and split transposed into the hi and lo tiles (N rows, K = 64), as in
// the fused launch.  e or w of every head is taken once, up front.
//
// Shared memory (1024-byte aligned): the hi and lo tiles (32 KB each), two
// raw buffers (64 x (N + 4) floats), e or w (H x CL floats).
template <int CL>
struct DbDc {
  static constexpr int kThr = 128 * (CL / 64);
  static constexpr int kRaw = 64 * (128 + 4);
  static size_t bytes(int h) {
    return 1024 + 2 * (size_t)kTile + (2 * (size_t)kRaw + (size_t)h * CL) * 4;
  }
};

template <int CL, int kN>
__global__ void __launch_bounds__(DbDc<CL>::kThr, 1)
ssd_bwd_dbdc_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ a, const float* __restrict__ bmat,
                          const float* __restrict__ cmat, const float* __restrict__ dy,
                          const float* __restrict__ states, const float* __restrict__ dstate,
                          const float* __restrict__ dsp, float* __restrict__ dbm,
                          float* __restrict__ dcm, int seq, int h, int groups) {
  using D = DbDc<CL>;
  constexpr int P = kP, kThr = D::kThr, n = kN, kWarpsD = kThr / 32;
  constexpr int halves = CL / 64;
  extern __shared__ __align__(16) unsigned char dbdc_smem[];
  unsigned char* tiles =
      dbdc_smem + ((1024 - (hopper::smem_addr(dbdc_smem) & 1023)) & 1023);
  const uint32_t ts = hopper::smem_addr(tiles);
  float* fs = reinterpret_cast<float*>(tiles + 2 * kTile);
  auto raw = [&](int k) { return fs + (k & 1) * D::kRaw; };   // raw buffer of tile k
  float* f_all = fs + 2 * D::kRaw;             // (h, CL): e (dC) or w (dB)

  const int c = blockIdx.x, b = blockIdx.y, nc = seq / CL;
  const bool is_db = blockIdx.z == 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wg = warp / 4;
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  const size_t t0 = (size_t)b * seq + (size_t)c * CL;
  const size_t row = (size_t)h * P;
  const float* part = dsp + ((size_t)b * nc + c) * groups * CL * CL;
  const float* src = is_db ? x : dy;
  const float* other = (is_db ? cmat : bmat) + t0 * n;
  const float* carried = is_db ? dstate : states;
  const int ntiles = halves + h;

  for (int hh = warp; hh < h; hh += kWarpsD)
    chunk_cumsum<CL>(dt + t0 * h + hh, h, a[hh], [&](int j, float cs, float d, float last) {
      f_all[hh * CL + j] = is_db ? expf(last - cs) * d : expf(cs);
    });

  // Tile k: a 64-step half of B or C, then each head's prev or D; one
  // commit group each (empty past the last).
  auto fetch_tile = [&](int k) {
    if (k < ntiles) {
      const float* s0 = k < halves
                            ? other + (size_t)64 * k * n
                            : carried + (((size_t)b * h + (k - halves)) * nc + c) * P * n;
      fetch<kThr>(raw(k), s0, n, 64, n);
    }
    cp_async_commit();
  };
  auto stage = [&](int k) {
    cp_async_wait<1>();
    __syncthreads();
    split_transposed<kThr>(tiles, raw(k), 64, n);
    hopper::fence_proxy_async();
    __syncthreads();
    fetch_tile(k + 2);
  };
  fetch_tile(0);
  fetch_tile(1);

  float acc[kN / 2];
  zero(acc);
  auto same = [](int, float (&)[8]) {};
  // v[k]: k-step 2 p + k / 4, a[k % 4]: row r0 or r1 (k odd), column
  // 8 (2 p + k / 4) + t (+ 4 for a[2], a[3]) of the operand's 64
  auto col = [&](int p, int k) { return 16 * p + 8 * (k >> 2) + t + 4 * ((k >> 1) & 1); };
  for (int k = 0; k < ntiles; ++k) {
    stage(k);
    if (k < halves) {
      // dS over the steps of half k: rows i, K = j (dC) or rows j, K = i
      // (dB); the half is all zero past the causal mask
      const bool live = is_db ? k >= wg : k <= wg;
      auto load = [&](int p, float (&v)[8]) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int rr = (e & 1) ? r1 : r0, kk = 64 * k + col(p, e);
          const size_t at = is_db ? (size_t)kk * CL + rr : (size_t)rr * CL + kk;
          float sum = 0.f;
          for (int gi = 0; gi < groups; ++gi) sum += part[(size_t)gi * CL * CL + at];
          v[e] = sum;
        }
      };
      if (live) product<kN>(acc, ts, n * 128, 0, 4, load, same);
    } else {
      const int hh = k - halves;
      const float f0 = f_all[hh * CL + r0], f1 = f_all[hh * CL + r1];
      const float* s0 = src + (t0 + r0) * row + (size_t)hh * P;
      const float* s1 = src + (t0 + r1) * row + (size_t)hh * P;
      auto load = [&](int p, float (&v)[8]) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = ((e & 1) ? s1 : s0)[col(p, e)];
      };
      auto shape = [&](int, float (&v)[8]) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] *= (e & 1) ? f1 : f0;
      };
      product<kN>(acc, ts, n * 128, 0, P / 16, load, shape);
    }
  }

  float* out = (is_db ? dbm : dcm) + t0 * n;
#pragma unroll
  for (int i = 0; i < kN / 8; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u)
      *reinterpret_cast<float2*>(out + (size_t)(u ? r1 : r0) * n + 8 * i + 2 * t) =
          make_float2(acc[4 * i + 2 * u], acc[4 * i + 2 * u + 1]);
}

// ---- 2 on the tensor-core route: the chunk gradients G ----
//
// For the shapes of tc::takes with N = 64 or 128.  One CTA per (chunk,
// group of heads, batch row) of two warpgroups.  C^T of the chunk (N rows,
// K = the chunk's steps) is split once into hi and lo tiles; then each
// warpgroup takes every other head of the group on its own, with no
// barrier between them: G_c = (e dy)^T C, M = P (64), N = N, K = the chunk,
// on wgmma m64nNk8 .tf32 in split TF32, the A operand e_i dy_i[q] read from
// global memory into registers.  e of the group's heads is taken up front.
//
// Shared memory (1024-byte aligned): the hi and lo tiles of C^T (N x CL
// floats each), e of each head (hg x CL).
template <int CL, int kN>
struct Gs {
  static constexpr int kThr = 256;
  static constexpr int kTileG = kN * CL * 4;   // bytes of the hi or the lo tile
  static size_t bytes(int hg) { return 1024 + 2 * (size_t)kTileG + (size_t)hg * CL * 4; }
};

template <int CL, int kN>
__global__ void __launch_bounds__(256, 1)
ssd_bwd_dstate_wgmma_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                            const float* __restrict__ cmat, const float* __restrict__ dy,
                            float* __restrict__ dstate, int seq, int h, int hg) {
  using G = Gs<CL, kN>;
  constexpr int P = kP, n = kN, kThr = G::kThr;
  extern __shared__ __align__(16) unsigned char g_smem[];
  unsigned char* tiles = g_smem + ((1024 - (hopper::smem_addr(g_smem) & 1023)) & 1023);
  const uint32_t ts = hopper::smem_addr(tiles);
  float* e_all = reinterpret_cast<float*>(tiles + 2 * G::kTileG);

  const int c = blockIdx.x, h0 = blockIdx.y * hg, b = blockIdx.z, nc = seq / CL;
  const int nh = min(hg, h - h0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wg = warp / 4;
  const int q0 = 16 * (warp & 3) + g, q1 = q0 + 8;  // the thread's rows of P
  const size_t t0 = (size_t)b * seq + (size_t)c * CL;
  const size_t row = (size_t)h * P;

  for (int hh = warp; hh < nh; hh += kThr / 32)
    chunk_cumsum<CL>(dt + t0 * h + h0 + hh, h, a[h0 + hh],
                     [&](int j, float cs, float, float) { e_all[hh * CL + j] = expf(cs); });
  // C^T: a thread takes a 4 x 4 block of C (4 steps, 4 columns of N)
  const float* cm = cmat + t0 * n;
  for (int e = tid; e < CL * n / 16; e += kThr) {
    const int i = 4 * (e % (CL / 4)), k = 4 * (e / (CL / 4));
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = *reinterpret_cast<const float4*>(cm + (size_t)(i + u) * n + k);
    // the lo tile lies G::kTileG bytes on, not kTile: write both by hand
    const float4 rows[4] = {make_float4(v[0].x, v[1].x, v[2].x, v[3].x),
                            make_float4(v[0].y, v[1].y, v[2].y, v[3].y),
                            make_float4(v[0].z, v[1].z, v[2].z, v[3].z),
                            make_float4(v[0].w, v[1].w, v[2].w, v[3].w)};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t off = sw(k + u, i, n);
      const float4 x = rows[u];
      uint4 hi, lo;
      hi.x = tf32_bits(x.x); lo.x = tf32_bits(x.x - __uint_as_float(hi.x));
      hi.y = tf32_bits(x.y); lo.y = tf32_bits(x.y - __uint_as_float(hi.y));
      hi.z = tf32_bits(x.z); lo.z = tf32_bits(x.z - __uint_as_float(hi.z));
      hi.w = tf32_bits(x.w); lo.w = tf32_bits(x.w - __uint_as_float(hi.w));
      *reinterpret_cast<uint4*>(tiles + off) = hi;
      *reinterpret_cast<uint4*>(tiles + G::kTileG + off) = lo;
    }
  }
  hopper::fence_proxy_async();
  __syncthreads();

  auto same = [](int, float (&)[8]) {};
  // v[k]: k-step 2 p + k / 4, a[k % 4]: row q0 or q1 (k odd), step
  // 8 (2 p + k / 4) + t (+ 4 for a[2], a[3])
  for (int hh = wg; hh < nh; hh += 2) {
    const int head = h0 + hh;
    const float* e_h = e_all + hh * CL;
    const float* dyh = dy + t0 * row + (size_t)head * P;
    auto load = [&](int p, float (&v)[8]) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = 16 * p + 8 * (k >> 2) + t + 4 * ((k >> 1) & 1);
        v[k] = e_h[i] * dyh[(size_t)i * row + ((k & 1) ? q1 : q0)];
      }
    };
    float acc[kN / 2];
    zero(acc);
    product<kN, G::kTileG>(acc, ts, n * 128, 0, CL / 16, load, same);
    float* out = dstate + (((size_t)b * h + head) * nc + c) * P * n;
#pragma unroll
    for (int i = 0; i < kN / 8; ++i)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        *reinterpret_cast<float2*>(out + (size_t)(u ? q1 : q0) * n + 8 * i + 2 * t) =
            make_float2(acc[4 * i + 2 * u], acc[4 * i + 2 * u + 1]);
  }
}

}  // namespace tc

// ---- 6: dB and dC ----

// Shared memory, in floats: dS (Lm, stride8(CL)); B or C (CL, stride8(n));
// dy or x of the head (Lm, stride4(pk)); prev or D of the head
// (pk, stride8(n)); e or w (CL).
template <int CL>
__host__ __device__ size_t dbdc_smem_floats(int p, int n) {
  constexpr int Lm = Rows<CL>::Lm;
  const int pk = round_up(p, 8);
  return (size_t)Lm * stride8(CL) + (size_t)CL * stride8(n) + (size_t)Lm * stride4(pk) +
         (size_t)pk * stride8(n) + CL;
}

// blockIdx.z 0: dC_i = sum_j dS_ij B_j + sum_{h,p} e_i dy_i[p] prev[p];
// 1: dB_j = sum_i dS_ij C_i + sum_{h,p} w_j x_j[p] D[p].  M = L, N = n.
template <int CL>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_dbdc_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const float* __restrict__ bmat,
                    const float* __restrict__ cmat, const float* __restrict__ dy,
                    const float* __restrict__ states, const float* __restrict__ dstate,
                    const float* __restrict__ dsp, float* __restrict__ dbm,
                    float* __restrict__ dcm, int seq, int h, int p, int n, int groups) {
  constexpr int Lm = Rows<CL>::Lm;
  const int c = blockIdx.x, b = blockIdx.y, nc = seq / CL;
  const bool is_db = blockIdx.z == 1;
  const int pk = round_up(p, 8);
  const int sd = stride8(CL), so = stride8(n), sv = stride4(pk), sp = stride8(n);
  extern __shared__ __align__(16) float smem[];
  float* ds_s = smem;
  float* o_s = ds_s + Lm * sd;
  float* v_s = o_s + CL * so;
  float* s_s = v_s + Lm * sv;
  float* f_s = s_s + pk * sp;
  zero_smem(smem, dbdc_smem_floats<CL>(p, n));
  const size_t t0 = (size_t)b * seq + (size_t)c * CL;
  load_tile(o_s, so, (is_db ? cmat : bmat) + t0 * n, n, CL, n);
  cp_async_commit();
  {
    const float* src = dsp + ((size_t)b * nc + c) * groups * CL * CL;
    for (int e = threadIdx.x; e < CL * CL; e += kThreads) {
      float s = 0.f;
      for (int gi = 0; gi < groups; ++gi) s += src[(size_t)gi * CL * CL + e];
      const int i = e / CL, j = e - i * CL;
      ds_s[i * sd + j] = s;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // The warp's blocks of the (Lm x n) output, blk = warp and warp + 8 of
  // (Lm / 16) x nb: one or two (Lm / 16 <= 8 row tiles, nb = n / 64 <= 2
  // column blocks), both in column block warp % nb.
  const int warp = threadIdx.x / 32;
  const int nb = (n + 63) / 64, two = (Lm / 16) * nb > kWarps;
  const int n0 = 64 * (warp % nb), nt = min(8, (n - n0) / 8);
  const int m0[2] = {16 * (warp / nb), 16 * ((warp + kWarps) / nb)};
  const bool mine = warp < (Lm / 16) * nb;
  const int nts[2] = {mine ? nt : 0, mine && two ? nt : 0};
  float acc[2][8][4] = {};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (nts[q] <= 0) continue;
    const int m = m0[q];
    if (is_db)                         // i >= j: from the row tile's first row
      warp_product<8>(acc[q], m, n0, nt, min(m, CL), CL,
                      [&](int j, int i) { return ds_s[i * sd + j]; },
                      [&](int i, int k) { return o_s[i * so + k]; });
    else                               // j <= i: to the row tile's last row
      warp_product<8>(acc[q], m, n0, nt, 0, min(CL, m + 16),
                      [&](int i, int j) { return ds_s[i * sd + j]; },
                      [&](int j, int k) { return o_s[j * so + k]; });
  }

  const size_t row = (size_t)h * p;
  for (int head = 0; head < h; ++head) {
    __syncthreads();                   // the head's tiles are refilled here
    const size_t sidx = (((size_t)b * h + head) * nc + c) * p * n;
    load_tile(v_s, sv, (is_db ? x : dy) + t0 * row + (size_t)head * p, row, CL, p);
    load_tile(s_s, sp, (is_db ? dstate : states) + sidx, n, p, n);
    cp_async_commit();
    if (warp == 0)
      chunk_cumsum<CL>(dt + t0 * h + head, h, a[head],
                       [&](int j, float cs, float d, float cs_last) {
                         f_s[j] = is_db ? expf(cs_last - cs) * d : expf(cs);
                       });
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (nts[q] <= 0) continue;
      warp_product<8>(acc[q], m0[q], n0, nt, 0, pk,
                      [&](int i, int k) { return f_s[i < CL ? i : 0] * v_s[i * sv + k]; },
                      [&](int k, int m) { return s_s[k * sp + m]; });
    }
  }

  float* out = is_db ? dbm : dcm;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    for_each_acc<8>(acc[q], m0[q], n0, nts[q], [&](int i, int k, float v) {
      if (i < CL) out[(t0 + i) * n + k] = v;
    });
  }
}

// ---- 7: da ----

__global__ void ssd_bwd_da_kernel(const float* __restrict__ da_part, float* __restrict__ da,
                                  int parts, int h) {
  for (int head = threadIdx.x; head < h; head += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < parts; ++i) s += da_part[(size_t)i * h + head];
    da[head] = s;
  }
}

template <int CL>
cudaError_t launch(const float* x, const float* dt, const float* a, const float* bmat,
                   const float* cmat, const float* dy, const float* dfinal,
                   const float* fwd_work, float* dx, float* ddt, float* da, float* dbm,
                   float* dcm, float* dinit, float* work, int batch, int seq, int h, int p,
                   int n, cudaStream_t stream) {
  constexpr int Lm = Rows<CL>::Lm;
  const int nc = seq / CL;
  const int hg = head_group(batch, nc, h), groups = (h + hg - 1) / hg;
  const Work off(batch, seq, h, p, n, CL, groups);
  float *dstate = work + off.dstate, *scores = work + off.scores, *dsp = work + off.dsp,
        *dw = work + off.dw, *dcs_off = work + off.dcs_off, *dot = work + off.dot,
        *da_part = work + off.da_part;
  const float* states = fwd_work;
  const float* dsum = fwd_work + (size_t)batch * h * nc * p * n;
  cudaError_t err;

  const size_t smem1 = 2 * (size_t)Lm * stride4(n) * sizeof(float);
  if ((err = set_smem(ssd_bwd_scores_kernel<CL>, smem1)) != cudaSuccess) return err;
  ssd_bwd_scores_kernel<CL><<<dim3(nc, batch), kThreads, smem1, stream>>>(
      bmat, cmat, scores, seq, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // the tensor-core route's shapes, and those where its dB/dC and G run
  // on wgmma (N 64 or 128)
  bool tc_route = false, tc_n = false;
  if constexpr (CL == 64 || CL == 128) {
    tc_route = tc::takes(p, n, CL);
    tc_n = tc_route && (n == 64 || n == 128);
  }
  if (tc_n) {
    if constexpr (CL == 64 || CL == 128) {
      const size_t smem = n == 128 ? tc::Gs<CL, 128>::bytes(hg) : tc::Gs<CL, 64>::bytes(hg);
      auto kernel = n == 128 ? tc::ssd_bwd_dstate_wgmma_kernel<CL, 128>
                             : tc::ssd_bwd_dstate_wgmma_kernel<CL, 64>;
      if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
      kernel<<<dim3(nc, groups, batch), 256, smem, stream>>>(dt, a, cmat, dy, dstate, seq, h,
                                                             hg);
    }
  } else {
    const size_t smem2 =
        ((size_t)CL * (stride8(n) + stride8(round_up(p, 16))) + CL) * sizeof(float);
    if ((err = set_smem(ssd_bwd_dstate_kernel<CL>, smem2)) != cudaSuccess) return err;
    ssd_bwd_dstate_kernel<CL><<<dim3(nc, h, batch), kThreads, smem2, stream>>>(
        dt, a, cmat, dy, dstate, seq, h, p, n);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int pn4 = p * n / 4;
  ssd_bwd_state_pass_kernel<<<dim3(batch * h, (pn4 + kThreads - 1) / kThreads), kThreads, 0,
                              stream>>>(dstate, dsum, dfinal, dinit, nc, pn4);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const dim3 grid(nc, groups, batch);
  bool fused = false;
  if constexpr (CL == 64 || CL == 128) {
    if (tc_route) {
      using F = tc::Fused<CL>;
      if ((err = set_smem(tc::ssd_bwd_fused_kernel<CL>, F::kBytes)) != cudaSuccess) return err;
      tc::ssd_bwd_fused_kernel<CL><<<grid, F::kThr, F::kBytes, stream>>>(
          x, dt, a, bmat, cmat, dy, scores, states, dstate, dx, ddt, dsp, da_part, seq, h, n,
          hg);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      fused = true;
    }
  }
  if (!fused) {
    const size_t smem4 = state_terms_smem_floats<CL>(p, n) * sizeof(float);
    if ((err = set_smem(ssd_bwd_state_terms_kernel<CL>, smem4)) != cudaSuccess) return err;
    ssd_bwd_state_terms_kernel<CL><<<grid, kThreads, smem4, stream>>>(
        x, dt, a, bmat, cmat, dy, states, dstate, dx, dw, dcs_off, dot, seq, h, p, n,
        hg);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

    const size_t smem5 = IntraLayout<CL>(p).floats() * sizeof(float);
    if ((err = set_smem(ssd_bwd_intra_kernel<CL>, smem5)) != cudaSuccess) return err;
    ssd_bwd_intra_kernel<CL><<<grid, kThreads, smem5, stream>>>(
        x, dt, a, dy, scores, dw, dcs_off, dot, dx, ddt, dsp, da_part, seq, h, p,
        hg);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  bool tc_dbdc = false;
  if constexpr (CL == 64 || CL == 128) {
    const size_t smem = tc::DbDc<CL>::bytes(h);
    if (tc_n && smem <= 227 * 1024) {
      auto kernel = n == 128 ? tc::ssd_bwd_dbdc_wgmma_kernel<CL, 128>
                             : tc::ssd_bwd_dbdc_wgmma_kernel<CL, 64>;
      if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
      kernel<<<dim3(nc, batch, 2), tc::DbDc<CL>::kThr, smem, stream>>>(
          x, dt, a, bmat, cmat, dy, states, dstate, dsp, dbm, dcm, seq, h, groups);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      tc_dbdc = true;
    }
  }
  if (!tc_dbdc) {
    const size_t smem6 = dbdc_smem_floats<CL>(p, n) * sizeof(float);
    if ((err = set_smem(ssd_bwd_dbdc_kernel<CL>, smem6)) != cudaSuccess) return err;
    ssd_bwd_dbdc_kernel<CL><<<dim3(nc, batch, 2), kThreads, smem6, stream>>>(
        x, dt, a, bmat, cmat, dy, states, dstate, dsp, dbm, dcm, seq, h, p, n, groups);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  ssd_bwd_da_kernel<<<1, kThreads, 0, stream>>>(da_part, da, batch * nc, h);
  return cudaGetLastError();
}

bool shapes_ok(int batch, int seq, int h, int p, int n, int chunk) {
  const bool p_ok = p >= 4 && p <= 64 && p % 4 == 0;
  const bool n_ok = n >= 8 && n <= 128 && n % 8 == 0;
  const bool c_ok = chunk == 8 || chunk == 16 || chunk == 32 || chunk == 64 || chunk == 128;
  return batch > 0 && seq > 0 && h > 0 && p_ok && n_ok && c_ok && seq % chunk == 0;
}

}  // namespace

// Floats of the scratch that ssd_scan_bwd takes (its layout above); 0 for
// shapes it does not take.
extern "C" long long ssd_scan_bwd_workspace(int batch, int seq, int h, int p, int n,
                                            int chunk) {
  if (!shapes_ok(batch, seq, h, p, n, chunk)) return 0;
  const int hg = head_group(batch, seq / chunk, h);
  return (long long)Work(batch, seq, h, p, n, chunk, (h + hg - 1) / hg).total;
}

// All tensors float32, contiguous, 16-byte aligned, with ssd_scan's shapes:
// x, dy, dx (batch, seq, h, p); dt, ddt (batch, seq, h); a, da (h); bmat,
// cmat, dbm, dcm (batch, seq, n); dfinal (may be null: zeros) and dinit
// (null when the forward had no initial state) (batch, h, p, n); fwd_work
// the forward's workspace for the same inputs (the state entering each
// chunk, then each chunk's sum of dA); work ssd_scan_bwd_workspace floats.
// Six launches on the stream on the tensor-core route, seven on the other.
// Returns a cudaError_t.
extern "C" int ssd_scan_bwd(const float* x, const float* dt, const float* a,
                            const float* bmat, const float* cmat, const float* dy,
                            const float* dfinal, const float* fwd_work, float* dx,
                            float* ddt, float* da, float* dbm, float* dcm, float* dinit,
                            float* work, int batch, int seq, int h, int p, int n, int chunk,
                            void* stream) {
  if (!shapes_ok(batch, seq, h, p, n, chunk) || fwd_work == nullptr || work == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 8: return (int)launch<8>(x, dt, a, bmat, cmat, dy, dfinal, fwd_work, dx, ddt, da, dbm, dcm, dinit, work, batch, seq, h, p, n, s);
    case 16: return (int)launch<16>(x, dt, a, bmat, cmat, dy, dfinal, fwd_work, dx, ddt, da, dbm, dcm, dinit, work, batch, seq, h, p, n, s);
    case 32: return (int)launch<32>(x, dt, a, bmat, cmat, dy, dfinal, fwd_work, dx, ddt, da, dbm, dcm, dinit, work, batch, seq, h, p, n, s);
    case 64: return (int)launch<64>(x, dt, a, bmat, cmat, dy, dfinal, fwd_work, dx, ddt, da, dbm, dcm, dinit, work, batch, seq, h, p, n, s);
    case 128: return (int)launch<128>(x, dt, a, bmat, cmat, dy, dfinal, fwd_work, dx, ddt, da, dbm, dcm, dinit, work, batch, seq, h, p, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
