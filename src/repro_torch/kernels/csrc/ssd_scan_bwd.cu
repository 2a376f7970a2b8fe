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
// Products: mma.sync m16n8k8 in split TF32 (3xTF32, ssd_common.cuh), so
// near-f32 results from f32 inputs.  Each CTA zeroes its shared memory
// first: a tile's padding (P to a multiple of 8 or 16, L to 16 rows) is
// then zero, and a product whose reduction runs over P reads zeros there.
//
// Bound on an H100: about twice the forward's least work, 8.P.N flops per
// (b, step, h) (the state's gradient through C and the chunk state's
// through x and B), 17.2 GFLOP at mamba2-370m's training shape (B, S, H, P,
// N) = (2, 4096, 32, 64, 128), 0.104 ms as 3xTF32 at the 495 TFLOP/s TF32
// peak; its bytes (x, dy and dx at 67 MB each, the forward's states at
// 67 MB, the rest small) take ~0.08 ms at 3.35 TB/s.  This design moves
// more: the states' gradients (67 MB) are written, read and written, then
// read twice, and x, dy and the forward's states are read two or three
// times.  Yet the products set its time, not the loads: ~13x the bound,
// with ~1.5x the least work in products (tools/ssd_bwd_probe.py cuts
// them out of one launch at a time).
//
// Workspace (f32, from the caller, ssd_scan_bwd_workspace floats): G then
// D (B, H, nc, P, N); scores (B, nc, L, L); the group partials of dS
// (B, nc, groups, L, L); dw and the carried term's d(cs) (B, S, H) each;
// exp(cs_last).<D, prev> (B, H, nc); the chunks' parts of da (B, nc, H).

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

  const size_t smem2 =
      ((size_t)CL * (stride8(n) + stride8(round_up(p, 16))) + CL) * sizeof(float);
  if ((err = set_smem(ssd_bwd_dstate_kernel<CL>, smem2)) != cudaSuccess) return err;
  ssd_bwd_dstate_kernel<CL><<<dim3(nc, h, batch), kThreads, smem2, stream>>>(
      dt, a, cmat, dy, dstate, seq, h, p, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int pn4 = p * n / 4;
  ssd_bwd_state_pass_kernel<<<dim3(batch * h, (pn4 + kThreads - 1) / kThreads), kThreads, 0,
                              stream>>>(dstate, dsum, dfinal, dinit, nc, pn4);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const dim3 grid(nc, groups, batch);
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

  const size_t smem6 = dbdc_smem_floats<CL>(p, n) * sizeof(float);
  if ((err = set_smem(ssd_bwd_dbdc_kernel<CL>, smem6)) != cudaSuccess) return err;
  ssd_bwd_dbdc_kernel<CL><<<dim3(nc, batch, 2), kThreads, smem6, stream>>>(
      x, dt, a, bmat, cmat, dy, states, dstate, dsp, dbm, dcm, seq, h, p, n, groups);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

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
// Seven launches on the stream.  Returns a cudaError_t.
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
