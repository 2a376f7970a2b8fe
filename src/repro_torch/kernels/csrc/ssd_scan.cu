// Mamba-2 SSD chunked scan (forward), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan, the Pallas TPU kernel
// whose grid is (batch * head, chunk) with the chunks walked in order, the
// (P, N) state carried from chunk to chunk in VMEM scratch.  Per chunk it
// adds the intra-chunk term ((C.B^T) * L).(x.dt), the carried state's term
// (C.state^T).exp(cumsum dA), and updates the state to
// state.exp(sum dA) + (x.dt.decay)^T.B.  The TPU's grid walks the chunks in
// order only because a TPU core runs its grid in order; on this card only
// the state update is sequential, so the scan is three launches (Mamba-2's
// own chunked algorithm), with cl = chunk and nc = S / cl:
//
//   1. chunk states, one CTA per (chunk, group of heads, batch row): the
//      cumsum cs of dA = dt.a within the chunk, and for each head
//      s_c = (x.dt.exp(cs_last - cs_j))^T.B, (P, N), into the workspace;
//      and cs_last, the chunk's sum of dA.  B is loaded once for the group.
//   2. state passing, one CTA per (batch row, head) and slice of P.N: walks
//      the nc chunks in order, elementwise on the f32 SIMT units,
//      S_c = S_{c-1}.exp(sum dA_c) + s_c from the initial state (or zeros),
//      overwriting the workspace with the state that enters each chunk and
//      writing the final state.  exp(sum dA) may underflow to 0: the state
//      stays finite, so 0 times it is 0.
//   3. chunk scan, one CTA per (chunk, group of heads, batch row): C.B^T
//      once for the group (B and C do not depend on the head), kept in
//      registers; then for each head y = ((C.B^T) * L).(x.dt)
//      + exp(cs_i).(C.S_{c-1}^T).  L is masked before the exp:
//      exp(cs_i - cs_j) only for j <= i, where it is <= 1 (over the upper
//      triangle cs_i - cs_j reaches +93 in one 128-step chunk at the init's
//      dA = -0.72).  Below the diagonal 16 x 16 blocks it is a product of
//      two factors <= 1 from a per-head table, so a warp takes no exp there.
//      Each warp owns one long and one short 16-row tile of the triangle.
//
// A group is as many heads as leave about one CTA for each SM (16 at the
// prefill shape); in stages 1 and 3 one head's x (and entering state) is
// loaded with cp.async (16 bytes) into one of two buffers while the
// products of the head before it run.
//
// Products: mma.sync m16n8k8 on the tensor cores in split TF32 (3xTF32).
// Inputs and tolerance are f32 (1e-4 of the plain output's largest
// magnitude); one TF32 rounding is 2^-11 (4.9e-4) of each operand, above
// that.  So each operand v is split into hi = tf32(v) and lo = tf32(v - hi)
// and a product is lo.hi + hi.lo + hi.hi, summed in f32: near-f32 accuracy
// at three times the TF32 work.  Row strides in shared memory are padded
// (to 8 or 4 mod 32 floats, by how a fragment walks the tile) so that a
// warp's fragment loads fall in 32 distinct banks.  Widths narrower than a
// tile (chunk 8 < m16, P not a multiple of 8 or 16) read padding whose
// products land only in rows or columns that are never stored; the
// reduction dimensions (chunk, N) are multiples of 8 and never padded.
//
// Bound on an H100: bytes.  The least work is 4.B.S.H.P.N flops (each
// step's (x dt) outer B enters the state, each step's y reads it through C):
// 8.59 GFLOP at mamba2-370m's prefill (B, S, H, P, N) = (2, 4096, 32, 64,
// 128), 0.052 ms as 3xTF32 at the 495 TFLOP/s dense TF32 peak.  The
// decomposition moves about 480 MB: x read twice, y written once and the
// 67 MB of chunk states written, read and written, then read; 0.145 ms at
// 3.35 TB/s.
//
// Workspace (f32, from the caller): the states (B, H, nc, P, N), then the
// chunks' sums of dA (B, H, nc).  The kernels allocate nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

using namespace ssd;

// ---- stage 1: chunk states ----

// Shared memory, in floats: B (CL, stride8(n)); two buffers of one head's x
// (CL, stride8(p)); w of each head of the group (CL each).
template <int CL>
size_t state_smem_floats(int p, int n, int hg) {
  return (size_t)CL * stride8(n) + 2 * (size_t)CL * stride8(p) + (size_t)hg * CL;
}

// s_c[q][k] = sum_j x_j[q] w_j B_j[k], w_j = exp(cs_last - cs_j) dt_j: an
// M = P (padded to 16), N = n, K = CL product for each head of the group.
// A warp owns a 16-row tile of P and up to 8 of the n / 8 column tiles.
template <int CL>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_chunk_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                            const float* __restrict__ a, const float* __restrict__ bmat,
                            float* __restrict__ states, float* __restrict__ dsum,
                            int seq, int h, int p, int n, int hg) {
  const int c = blockIdx.x, h0 = blockIdx.y * hg, b = blockIdx.z;
  const int nh = min(hg, h - h0);
  const int nc = seq / CL;
  const int sx = stride8(p), sb = stride8(n);
  extern __shared__ __align__(16) float smem[];
  float* b_s = smem;                   // (CL, sb)  B of the chunk
  float* xbuf0 = b_s + CL * sb;        // (CL, sx)  x of one head
  float* xbuf1 = xbuf0 + CL * sx;
  float* w_s = xbuf1 + CL * sx;        // (hg, CL)  exp(cs_last - cs_j) dt_j

  const size_t t0 = (size_t)b * seq + (size_t)c * CL;
  auto load_x = [&](int hi, float* dst) {
    load_tile(dst, sx, x + (t0 * h + h0 + hi) * p, (size_t)h * p, CL, p);
    cp_async_commit();
  };
  load_tile(b_s, sb, bmat + t0 * n, n, CL, n);
  load_x(0, xbuf0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  for (int hw = warp; hw < nh; hw += kWarps) {
    float* w_h = w_s + hw * CL;
    const float last = chunk_cumsum<CL>(
        dt + t0 * h + h0 + hw, h, a[h0 + hw],
        [&](int j, float cs, float d, float cs_last) { w_h[j] = expf(cs_last - cs) * d; });
    if (lane == 0) dsum[((size_t)b * h + h0 + hw) * nc + c] = last;
  }

  const int g = lane >> 2, t = lane & 3;
  const int mtiles = (p + 15) / 16, per_m = kWarps / mtiles;
  const int mt = warp / per_m;
  const bool active = mt < mtiles;     // with 3 row tiles, 2 warps idle
  const int ntiles = n / 8, ntw = (ntiles + per_m - 1) / per_m;
  const int nt0 = (warp % per_m) * ntw;
  const int nt1 = min(ntiles, nt0 + ntw);
  const int q0 = 16 * mt + g;
  for (int hi = 0; hi < nh; ++hi) {
    if (hi + 1 < nh) {
      load_x(hi + 1, (hi & 1) ? xbuf0 : xbuf1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const float* x_s = (hi & 1) ? xbuf1 : xbuf0;
      const float* w = w_s + hi * CL;
      float acc[8][4] = {};
#pragma unroll 8
      for (int j0 = 0; j0 < CL; j0 += 8) {
        const float w0 = w[j0 + t], w1 = w[j0 + t + 4];
        const float* xr0 = x_s + (j0 + t) * sx + q0;
        const float* xr1 = xr0 + 4 * sx;
        Frag<4> fa;
        fa.set(0, xr0[0] * w0);
        fa.set(1, xr0[8] * w0);
        fa.set(2, xr1[0] * w1);
        fa.set(3, xr1[8] * w1);
        const float* br0 = b_s + (j0 + t) * sb + g;
        const float* br1 = br0 + 4 * sb;
        Frag<2> fb[8];
        bool on[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          on[k] = nt0 + k < nt1;
          if (on[k]) {
            fb[k].set(0, br0[8 * (nt0 + k)]);
            fb[k].set(1, br1[8 * (nt0 + k)]);
          }
        }
        mma3<8>(acc, fa, fb, on);
      }
      float* out = states + (((size_t)b * h + h0 + hi) * nc + c) * p * n;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int col = 8 * (nt0 + k) + 2 * t;
        if (nt0 + k >= nt1) continue;
        if (q0 < p)
          *reinterpret_cast<float2*>(out + (size_t)q0 * n + col) =
              make_float2(acc[k][0], acc[k][1]);
        if (q0 + 8 < p)
          *reinterpret_cast<float2*>(out + (size_t)(q0 + 8) * n + col) =
              make_float2(acc[k][2], acc[k][3]);
      }
    }
    __syncthreads();                   // this buffer is refilled next
  }
}

// ---- stage 2: state passing ----

// One thread per 4 consecutive state entries of a (b, h): reads a few
// chunks ahead (the loads do not depend on the running state), then writes
// each chunk's entering state over its own chunk state.
__global__ void __launch_bounds__(kThreads)
ssd_scan_state_pass_kernel(float* __restrict__ states, const float* __restrict__ dsum,
                           const float* __restrict__ init, float* __restrict__ final_state,
                           int nc, int pn4) {
  constexpr int kAhead = 8;
  const int bh = blockIdx.x;
  const int e = blockIdx.y * kThreads + threadIdx.x;
  if (e >= pn4) return;
  float4* st = reinterpret_cast<float4*>(states) + (size_t)bh * nc * pn4 + e;
  const float* ds = dsum + (size_t)bh * nc;
  float4 s = init ? reinterpret_cast<const float4*>(init)[(size_t)bh * pn4 + e]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float4 v[kAhead];
    float d[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < nc) {
        v[k] = st[(size_t)(c0 + k) * pn4];
        d[k] = expf(ds[c0 + k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < nc) {
        st[(size_t)(c0 + k) * pn4] = s;
        s = make_float4(fmaf(s.x, d[k], v[k].x), fmaf(s.y, d[k], v[k].y),
                        fmaf(s.z, d[k], v[k].z), fmaf(s.w, d[k], v[k].w));
      }
    }
  }
  reinterpret_cast<float4*>(final_state)[(size_t)bh * pn4 + e] = s;
}

// ---- stage 3: chunk scan ----

// Shared memory, in floats: C (R, stride4(n)); two head buffers of x
// (CL, stride4(p)) and the entering state (P padded to 8 rows,
// stride4(n)), the second also holding B (R, stride4(n)) until C.B^T is
// taken; cs and dt of each head of the group (R each); the decay table of
// the head at work (MT, CL).
template <int CL>
struct ScanLayout {
  static constexpr int R = CL < 16 ? 16 : CL;   // rows of the m16 tiles
  static constexpr int MT = R / 16;             // row tiles
  int sn, sx;
  size_t c_floats, buf_floats;   // B takes as many floats as C
  __host__ __device__ ScanLayout(int p, int n)
      : sn(stride4(n)), sx(stride4(p)), c_floats((size_t)R * sn),
        buf_floats((size_t)CL * sx + (size_t)round_up(p, 8) * sn) {}
  __host__ __device__ size_t buf1_floats() const {
    return buf_floats > c_floats ? buf_floats : c_floats;
  }
  __host__ __device__ size_t floats(int hg) const {
    return c_floats + buf_floats + buf1_floats() + 2 * (size_t)hg * R + (size_t)MT * CL;
  }
};

// What chunk_scan_warp reads of its CTA: shared memory, its output and
// the shapes.
struct ScanCtx {
  const float* c_s;       // (R, sn)  C of the chunk
  float* buf0;            // x (CL, sx) and the entering state (pp, sn)
  float* buf1;            //   of one head; B (R, sn) before C.B^T is taken
  const float* cs_s;      // (hg, R)  cumsum of dA
  const float* dt_s;      // (hg, R)  dt
  float* w_s;             // (MT, CL) decay table of the head at work
  float* y;
  size_t t0;              // the chunk's first row of (batch x seq)
  int h0, nh, h, p, n, sn, sx;
};

// One row tile m's A fragment of the intra-chunk product at step tile kt:
// (C.B^T)[i][j] exp(cs_i - cs_j) dt_j for j <= i, else 0, at rows
// i0 = 16 m + g, i0 + 8 and (permuted K, below) columns j = 8 kt + 2 t,
// j + 1.  Below the diagonal block (kt < 2 m) it is r_i W[m][j] with
// r_i = exp(cs_i - cs_16m) and W[m][j] = exp(cs_16m - cs_j) dt_j, both
// <= 1 as j < 16 m <= i; in the diagonal block the exp is taken masked.
__device__ __forceinline__ void decayed_scores(Frag<4>& fa, const float* gk, int kt, int m,
                                               int g, int t, const float* cs,
                                               const float* dts, const float* w_row,
                                               const float* r) {
  const int j = 8 * kt + 2 * t;
  if (kt < 2 * m) {
    const float wj = w_row[j], wj1 = w_row[j + 1];
    fa.set(0, gk[0] * (r[0] * wj));
    fa.set(1, gk[2] * (r[1] * wj));
    fa.set(2, gk[1] * (r[0] * wj1));
    fa.set(3, gk[3] * (r[1] * wj1));
  } else {
    const int i0 = 16 * m + g, i1 = i0 + 8;
    const float c0 = cs[i0], c1 = cs[i1], cj = cs[j], cj1 = cs[j + 1];
    const float dj = dts[j], dj1 = dts[j + 1];
    fa.set(0, j <= i0 ? gk[0] * (expf(c0 - cj) * dj) : 0.f);
    fa.set(1, j <= i1 ? gk[2] * (expf(c1 - cj) * dj) : 0.f);
    fa.set(2, j + 1 <= i0 ? gk[1] * (expf(c0 - cj1) * dj1) : 0.f);
    fa.set(3, j + 1 <= i1 ? gk[3] * (expf(c1 - cj1) * dj1) : 0.f);
  }
}

// What a warp does after the loads.  It owns a long row tile mB and, where
// there are two or more row tiles, a short one mA = MT - 1 - mB, so that
// every warp takes the same share of the causal triangle; and NTW of P's
// 8-wide tiles.  Its rows of C.B^T stay in registers as accumulators, which
// hold columns (2 t, 2 t + 1) of each 8-wide tile where an A fragment
// wants (t, t + 4): so the K index of the intra-chunk product is permuted
// within each 8 (slot t is step 2 t, slot t + 4 is step 2 t + 1) and x's
// rows are read in the same order.  One code path for every warp: the
// tiles are indexed at compile time and guarded at run time.
template <int CL, typename LoadHead>
__device__ __forceinline__ void chunk_scan_warp(const ScanCtx& s, LoadHead load_head) {
  constexpr int R = ScanLayout<CL>::R;
  constexpr int MT = ScanLayout<CL>::MT;
  constexpr int KT = CL / 8;                  // 8-wide step tiles
  constexpr bool TWO = MT >= 2;
  constexpr int NPAIR = TWO ? MT / 2 : 1;     // warps of one P part
  constexpr int NTW = NPAIR;                  // P tiles a warp: 8 / (kWarps / NPAIR)
  constexpr int KA = TWO ? MT : 1;            // most step tiles the short row tile needs
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mA = warp % NPAIR, mB = MT - 1 - mA;
  const int kA = TWO ? 2 * mA + 2 : 0;        // step tiles with j <= i
  const int kB = min(KT, 2 * mB + 2);
  const int pt0 = (warp / NPAIR) * NTW;
  const int sn = s.sn, sx = s.sx, p = s.p;
  const float* caA = s.c_s + (16 * mA + g) * sn;
  const float* caB = s.c_s + (16 * mB + g) * sn;

  float gA[KA][4] = {}, gB[KT][4] = {};       // C.B^T of the two row tiles
  {
    const float* b_s = s.buf1;
    for (int k0 = 0; k0 < s.n; k0 += 8) {
      Frag<4> faA, faB;
      load_a_rows(faB, caB + k0, caB + 8 * sn + k0, t);
      if (TWO) load_a_rows(faA, caA + k0, caA + 8 * sn + k0, t);
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        if (kt < kB) {
          Frag<2> fb;
          load_b_row(fb, b_s + (8 * kt + g) * sn + k0, t);
          mma3(gB[kt], faB, fb);
          if (TWO && kt < KA && kt < kA) mma3(gA[kt < KA ? kt : 0], faA, fb);
        }
      }
    }
  }
  __syncthreads();                            // buffer 1 holds no B from here

  for (int hi = 0; hi < s.nh; ++hi) {
    const float* cs = s.cs_s + hi * R;
    const float* dts = s.dt_s + hi * R;
    if (hi + 1 < s.nh) load_head(hi + 1, (hi & 1) ? s.buf0 : s.buf1);
    // this head's decay table W[m][j] = exp(cs_16m - cs_j) dt_j, j < 16 m
    for (int e = threadIdx.x; e < MT * CL; e += kThreads) {
      const int m = e / CL, j = e - m * CL;
      if (j < 16 * m) s.w_s[e] = expf(cs[16 * m] - cs[j]) * dts[j];
    }
    if (hi + 1 < s.nh) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    const float* x_s = (hi & 1) ? s.buf1 : s.buf0;
    const float* s_s = x_s + CL * sx;
    float accA[NTW][4] = {}, accB[NTW][4] = {};
    bool on[NTW];
#pragma unroll
    for (int k = 0; k < NTW; ++k) on[k] = 8 * (pt0 + k) < p;

    // The carried state: C.S^T over N, then each row times exp(cs_i).
#pragma unroll 4
    for (int k0 = 0; k0 < s.n; k0 += 8) {
      Frag<4> faA, faB;
      load_a_rows(faB, caB + k0, caB + 8 * sn + k0, t);
      if (TWO) load_a_rows(faA, caA + k0, caA + 8 * sn + k0, t);
      Frag<2> fb[NTW];
#pragma unroll
      for (int k = 0; k < NTW; ++k)
        if (on[k]) load_b_row(fb[k], s_s + (8 * (pt0 + k) + g) * sn + k0, t);
      mma3<NTW>(accB, faB, fb, on);
      if (TWO) mma3<NTW>(accA, faA, fb, on);
    }
    // rA, rB: exp(cs_i - cs_16m) of the two rows of each tile
    float rA[2], rB[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int iB = 16 * mB + g + 8 * u, iA = 16 * mA + g + 8 * u;
      const float eB = expf(cs[iB]), eA = expf(cs[iA]);
      rB[u] = expf(cs[iB] - cs[16 * mB]);
      rA[u] = expf(cs[iA] - cs[16 * mA]);
#pragma unroll
      for (int k = 0; k < NTW; ++k) {
        accB[k][2 * u] *= eB; accB[k][2 * u + 1] *= eB;
        accA[k][2 * u] *= eA; accA[k][2 * u + 1] *= eA;
      }
    }

    // The intra-chunk term: (C.B^T * L).(x dt), L masked before the exp.
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kt < kB) {
        const float* xr = x_s + (8 * kt + 2 * t) * sx + g;
        Frag<2> fb[NTW];
#pragma unroll
        for (int k = 0; k < NTW; ++k) {
          if (on[k]) {
            fb[k].set(0, xr[8 * (pt0 + k)]);
            fb[k].set(1, xr[8 * (pt0 + k) + sx]);
          }
        }
        Frag<4> fa;
        decayed_scores(fa, gB[kt], kt, mB, g, t, cs, dts, s.w_s + mB * CL, rB);
        mma3<NTW>(accB, fa, fb, on);
        if (TWO && kt < KA && kt < kA) {
          decayed_scores(fa, gA[kt < KA ? kt : 0], kt, mA, g, t, cs, dts,
                         s.w_s + mA * CL, rA);
          mma3<NTW>(accA, fa, fb, on);
        }
      }
    }

    float* yh = s.y + (s.t0 * s.h + s.h0 + hi) * p;
    const size_t row = (size_t)s.h * p;
#pragma unroll
    for (int k = 0; k < NTW; ++k) {
      const int col = 8 * (pt0 + k) + 2 * t;
      if (col >= p) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int iB = 16 * mB + g + 8 * u, iA = 16 * mA + g + 8 * u;
        if (iB < CL)
          *reinterpret_cast<float2*>(yh + iB * row + col) =
              make_float2(accB[k][2 * u], accB[k][2 * u + 1]);
        if (TWO)
          *reinterpret_cast<float2*>(yh + iA * row + col) =
              make_float2(accA[k][2 * u], accA[k][2 * u + 1]);
      }
    }
    __syncthreads();                          // this buffer is refilled next
  }
}

template <int CL>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_chunk_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                           const float* __restrict__ a, const float* __restrict__ bmat,
                           const float* __restrict__ cmat, const float* __restrict__ states,
                           float* __restrict__ y, int seq, int h, int p, int n, int hg) {
  using L = ScanLayout<CL>;
  constexpr int R = L::R;
  const L lay(p, n);
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x, b = blockIdx.z, nc = seq / CL;
  ScanCtx s;
  s.h0 = blockIdx.y * hg;
  s.nh = min(hg, h - s.h0);
  s.h = h; s.p = p; s.n = n; s.sn = lay.sn; s.sx = lay.sx;
  s.y = y;
  s.t0 = (size_t)b * seq + (size_t)c * CL;
  float* c_s = smem;
  s.c_s = c_s;
  s.buf0 = c_s + lay.c_floats;
  s.buf1 = s.buf0 + lay.buf_floats;
  float* cs_s = s.buf1 + lay.buf1_floats();
  float* dt_s = cs_s + hg * R;
  s.cs_s = cs_s;
  s.dt_s = dt_s;
  s.w_s = dt_s + hg * R;

  auto load_head = [&](int hi, float* dst) {
    const int head = s.h0 + hi;
    load_tile(dst, s.sx, x + (s.t0 * h + head) * p, (size_t)h * p, CL, p);
    load_tile(dst + CL * s.sx, s.sn, states + (((size_t)b * h + head) * nc + c) * p * n,
              n, p, n);
    cp_async_commit();
  };
  load_tile(c_s, s.sn, cmat + s.t0 * n, n, CL, n);
  load_tile(s.buf1, s.sn, bmat + s.t0 * n, n, CL, n);
  load_head(0, s.buf0);
  const int warp = threadIdx.x / 32;
  for (int hw = warp; hw < s.nh; hw += kWarps) {
    float* cs_h = cs_s + hw * R;
    float* dt_h = dt_s + hw * R;
    chunk_cumsum<CL>(dt + s.t0 * h + s.h0 + hw, h, a[s.h0 + hw],
                     [&](int j, float cs, float d, float) { cs_h[j] = cs; dt_h[j] = d; });
  }
  cp_async_wait<0>();
  __syncthreads();

  chunk_scan_warp<CL>(s, load_head);
}

template <int CL>
cudaError_t launch(const float* x, const float* dt, const float* a, const float* bmat,
                   const float* cmat, const float* init, float* y, float* final_state,
                   float* workspace, int batch, int seq, int h, int p, int n,
                   cudaStream_t stream) {
  const int nc = seq / CL;
  const int hg = head_group(batch, nc, h);
  const dim3 grid(nc, (h + hg - 1) / hg, batch);
  float* states = workspace;
  float* dsum = workspace + (size_t)batch * h * nc * p * n;

  const size_t smem1 = state_smem_floats<CL>(p, n, hg) * sizeof(float);
  cudaError_t err = set_smem(ssd_scan_chunk_state_kernel<CL>, smem1);
  if (err != cudaSuccess) return err;
  ssd_scan_chunk_state_kernel<CL><<<grid, kThreads, smem1, stream>>>(
      x, dt, a, bmat, states, dsum, seq, h, p, n, hg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int pn4 = p * n / 4;
  ssd_scan_state_pass_kernel<<<dim3(batch * h, (pn4 + kThreads - 1) / kThreads),
                               kThreads, 0, stream>>>(states, dsum, init, final_state,
                                                      nc, pn4);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem3 = ScanLayout<CL>(p, n).floats(hg) * sizeof(float);
  if ((err = set_smem(ssd_scan_chunk_scan_kernel<CL>, smem3)) != cudaSuccess) return err;
  ssd_scan_chunk_scan_kernel<CL><<<grid, kThreads, smem3, stream>>>(
      x, dt, a, bmat, cmat, states, y, seq, h, p, n, hg);
  return cudaGetLastError();
}

}  // namespace

// All tensors float32, contiguous, 16-byte aligned: x, y (batch, seq, h, p);
// dt (batch, seq, h); a (h); bmat, cmat (batch, seq, n); init (may be null:
// zeros) and final_state (batch, h, p, n); workspace
// batch.h.(seq/chunk).(p.n + 1) floats.  p % 4 == 0 and 4 <= p <= 64;
// n % 8 == 0 and 8 <= n <= 128; chunk a power of two in [8, 128] dividing
// seq.  Three launches on the stream.  Returns a cudaError_t.
extern "C" int ssd_scan(const float* x, const float* dt, const float* a,
                        const float* bmat, const float* cmat, const float* init,
                        float* y, float* final_state, float* workspace, int batch,
                        int seq, int h, int p, int n, int chunk, void* stream) {
  const bool p_ok = p >= 4 && p <= 64 && p % 4 == 0;
  const bool n_ok = n >= 8 && n <= 128 && n % 8 == 0;
  if (batch <= 0 || seq <= 0 || h <= 0 || !p_ok || !n_ok || chunk <= 0 ||
      seq % chunk || workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 8: return (int)launch<8>(x, dt, a, bmat, cmat, init, y, final_state, workspace, batch, seq, h, p, n, s);
    case 16: return (int)launch<16>(x, dt, a, bmat, cmat, init, y, final_state, workspace, batch, seq, h, p, n, s);
    case 32: return (int)launch<32>(x, dt, a, bmat, cmat, init, y, final_state, workspace, batch, seq, h, p, n, s);
    case 64: return (int)launch<64>(x, dt, a, bmat, cmat, init, y, final_state, workspace, batch, seq, h, p, n, s);
    case 128: return (int)launch<128>(x, dt, a, bmat, cmat, init, y, final_state, workspace, batch, seq, h, p, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
