// Mamba-2 SSD chunked scan (forward), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan, the Pallas TPU kernel
// whose grid is (batch * head, chunk) with the chunks walked in order, the
// (P, N) state carried from chunk to chunk in VMEM scratch.  Per chunk it
// adds the intra-chunk term ((C.B^T) * L).(x.dt), the carried state's term
// (C.state^T).exp(cumsum dA), and updates the state to
// state.exp(sum dA) + (x.dt.decay)^T.B.
//
// Bound on an H100: operations.  Whatever the chunking, every step's x.dt
// outer B enters the state and every step's y reads the state through C:
// 4 flops per (p, n) state entry a step, 4.B.S.H.P.N in all, with the
// chunked form's intra-chunk triangle on top.  At mamba2-370m's prefill
// (B, S, H, P, N) = (2, 4096, 32, 64, 128) that is 8.6 GFLOP against 146 MB
// to move: ~59 flops a byte, above the ~20 f32 flops a byte at which the
// card's arithmetic, not its memory, is the limit.  This first kernel does
// its products on the f32 SIMT units (67 TFLOP/s peak) from shared memory;
// TF32 or wgmma tensor cores and TMA are left for a later change.
//
// Design: one CTA of 8 warps per (p tile, head, batch row), where a p tile
// is min(P, 32) rows of P.  The state rows p are independent, so splitting
// P = 64 in two gives 128 CTAs at batch 2 for 132 SMs in place of 64; each
// CTA then recomputes its chunk's C.B^T, which costs less than the idle
// half of the card would (at the prefill shape on an H100, tiles of 16 rows
// and of 64 were both slower than 32).  A loop inside the CTA walks the
// sequence in order, in place of the TPU grid's sequential axis, and keeps
// the (p tile, N) state in shared memory.  It walks sub-chunks of
// min(chunk, 64) steps: y and the final state do not depend on the chunking
// beyond f32 rounding, and 64 steps keep a sub-chunk's B, C, x, scores and
// the state within one CTA's shared memory (116,880 bytes at N = 128 and a
// p tile of 32) while halving the C.B^T work of 128-step chunks.  B and C
// are read by batch row, never broadcast over heads.  The decay matrix is
// masked before the exp: exp(cs_i - cs_j) is taken only for j <= i, where
// it is <= 1 (cs_i - cs_j over the upper triangle reaches +93 in one chunk
// at dA = -0.72).
// Each product runs as register tiles of 2x4 or 4x4 outputs a thread, with
// row strides padded to odd counts of floats so that the rows a warp reads
// fall in distinct banks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kMaxSub = 64;     // steps in a sub-chunk
constexpr int kPTile = 32;      // state rows per CTA (fewer when P < 32)

struct Layout {
  int sub, pt, n;               // sub-chunk steps, state rows, state width
  int ns, xs, gs;               // row strides (floats) of B/C/state, x/y, scores
  __host__ __device__ Layout(int sub_, int pt_, int n_)
      : sub(sub_), pt(pt_), n(n_), ns(n_ + 1), xs(pt_ + 1), gs(sub_ + 1) {}
  // b_s, c_s (sub, ns); x_s, y_s (sub, xs); g_s (sub, gs); s_s (pt, ns);
  // cs, w, in_decay (sub); one float for exp(sum dA).
  __host__ __device__ size_t floats() const {
    return (size_t)2 * sub * ns + (size_t)2 * sub * xs + (size_t)sub * gs +
           (size_t)pt * ns + 3 * (size_t)sub + 1;
  }
};

// out(i, j, sum_k a(i, k) * b(k, j)) for i < m, j < n, as register tiles of
// RM x RN outputs: a thread owns rows ti + (m/RM)*r and columns
// tj + (n/RN)*c, so neighbouring lanes read neighbouring rows or columns.
template <int RM, int RN, typename A, typename B, typename Out>
__device__ __forceinline__ void tile_product(int m, int n, int k, A a, B b, Out out) {
  const int tm = m / RM, tn = n / RN;
  for (int t = threadIdx.x; t < tm * tn; t += kThreads) {
    const int ti = t / tn, tj = t - ti * tn;
    float acc[RM][RN];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) acc[r][c] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < k; ++kk) {
      float av[RM], bv[RN];
#pragma unroll
      for (int r = 0; r < RM; ++r) av[r] = a(ti + tm * r, kk);
#pragma unroll
      for (int c = 0; c < RN; ++c) bv[c] = b(kk, tj + tn * c);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) out(ti + tm * r, tj + tn * c, acc[r][c]);
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ bmat,
                const float* __restrict__ cmat, const float* __restrict__ init,
                float* __restrict__ y, float* __restrict__ final_state, int seq,
                int h, int p, int n, int sub, int pt) {
  const int p0 = blockIdx.x * pt;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const Layout L(sub, pt, n);
  const int ns = L.ns, xs = L.xs, gs = L.gs;

  extern __shared__ __align__(16) float smem[];
  float* b_s = smem;                 // (sub, ns)  B rows of the sub-chunk
  float* c_s = b_s + sub * ns;       // (sub, ns)  C rows
  float* x_s = c_s + sub * ns;       // (sub, xs)  x * dt
  float* y_s = x_s + sub * xs;       // (sub, xs)  the carried state's term
  float* g_s = y_s + sub * xs;       // (sub, gs)  (C.B^T) * L
  float* s_s = g_s + sub * gs;       // (pt, ns)   the state rows p0 + [0, pt)
  float* cs_s = s_s + pt * ns;       // (sub)      cumsum of dA in the sub-chunk
  float* w_s = cs_s + sub;           // (sub)      exp(cs_last - cs_j)
  float* in_s = w_s + sub;           // (sub)      exp(cs_i)
  float* tot_s = in_s + sub;         // exp(cs_last)

  const float a_h = a[head];
  const size_t state_off = (((size_t)b * h + head) * p + p0) * n;
  for (int e = tid; e < pt * n; e += kThreads) {
    const int r = e / n, c = e - r * n;
    s_s[r * ns + c] = init ? init[state_off + e] : 0.f;
  }

  const int n4 = n / 4, pt4 = pt / 4;
  for (int t0 = 0; t0 < seq; t0 += sub) {
    // Stage B, C and x.dt (16-byte loads); warp 0 takes the cumsum of dA.
    const size_t bc_off = ((size_t)b * seq + t0) * n;
    for (int e = tid; e < sub * n4; e += kThreads) {
      const int j = e / n4, c = (e - j * n4) * 4;
      const float4 bv = reinterpret_cast<const float4*>(bmat + bc_off)[e];
      const float4 cv = reinterpret_cast<const float4*>(cmat + bc_off)[e];
      float* bd = b_s + j * ns + c;
      float* cd = c_s + j * ns + c;
      bd[0] = bv.x; bd[1] = bv.y; bd[2] = bv.z; bd[3] = bv.w;
      cd[0] = cv.x; cd[1] = cv.y; cd[2] = cv.z; cd[3] = cv.w;
    }
    for (int e = tid; e < sub * pt4; e += kThreads) {
      const int j = e / pt4, c = (e - j * pt4) * 4;
      const size_t row = ((size_t)b * seq + t0 + j) * h + head;
      const float d = dt[row];
      const float4 xv = *reinterpret_cast<const float4*>(x + row * p + p0 + c);
      float* xd = x_s + j * xs + c;
      xd[0] = xv.x * d; xd[1] = xv.y * d; xd[2] = xv.z * d; xd[3] = xv.w * d;
    }
    if (tid < 32) {
      const size_t row0 = ((size_t)b * seq + t0) * h + head;
      float v0 = tid < sub ? dt[row0 + (size_t)tid * h] * a_h : 0.f;
      float v1 = tid + 32 < sub ? dt[row0 + (size_t)(tid + 32) * h] * a_h : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, v0, o);
        const float u1 = __shfl_up_sync(0xffffffffu, v1, o);
        if (tid >= o) { v0 += u0; v1 += u1; }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      const float last = sub > 32 ? __shfl_sync(0xffffffffu, v1, sub - 33)
                                  : __shfl_sync(0xffffffffu, v0, sub - 1);
      if (tid < sub) {
        cs_s[tid] = v0;
        w_s[tid] = expf(last - v0);
        in_s[tid] = expf(v0);
      }
      if (tid + 32 < sub) {
        cs_s[tid + 32] = v1;
        w_s[tid + 32] = expf(last - v1);
        in_s[tid + 32] = expf(v1);
      }
      if (tid == 0) *tot_s = expf(last);
    }
    __syncthreads();

    // Scores, masked before the exp: g[i][j] = (C_i . B_j) exp(cs_i - cs_j)
    // for j <= i, else 0.
    tile_product<4, 4>(
        sub, sub, n, [&](int i, int k) { return c_s[i * ns + k]; },
        [&](int k, int j) { return b_s[j * ns + k]; },
        [&](int i, int j, float v) {
          g_s[i * gs + j] = j <= i ? v * expf(cs_s[i] - cs_s[j]) : 0.f;
        });
    // The carried state's term: y_off[i][q] = exp(cs_i) C_i . state_q.
    tile_product<2, 4>(
        sub, pt, n, [&](int i, int k) { return c_s[i * ns + k]; },
        [&](int k, int q) { return s_s[q * ns + k]; },
        [&](int i, int q, float v) { y_s[i * xs + q] = v * in_s[i]; });
    __syncthreads();

    // y = g.(x dt) + y_off; and, independently (the state was last read
    // above), state = state exp(sum dA) + (x dt w)^T.B.
    float* y_base = y + ((size_t)b * seq + t0) * h * p + (size_t)head * p + p0;
    const size_t y_row = (size_t)h * p;
    tile_product<2, 4>(
        sub, pt, sub, [&](int i, int j) { return g_s[i * gs + j]; },
        [&](int j, int q) { return x_s[j * xs + q]; },
        [&](int i, int q, float v) { y_base[i * y_row + q] = v + y_s[i * xs + q]; });
    const float tot = *tot_s;
    tile_product<4, 4>(
        pt, n, sub, [&](int q, int j) { return x_s[j * xs + q] * w_s[j]; },
        [&](int j, int c) { return b_s[j * ns + c]; },
        [&](int q, int c, float v) { s_s[q * ns + c] = s_s[q * ns + c] * tot + v; });
    __syncthreads();
  }

  for (int e = tid; e < pt * n; e += kThreads) {
    const int r = e / n, c = e - r * n;
    final_state[state_off + e] = s_s[r * ns + c];
  }
}

}  // namespace

// All tensors float32, contiguous, 16-byte aligned: x, y (batch, seq, h, p);
// dt (batch, seq, h); a (h); bmat, cmat (batch, seq, n); init (may be null:
// zeros) and final_state (batch, h, p, n).  p % 4 == 0 and p <= 64; n % 8
// == 0 and 8 <= n <= 128; chunk a power of two in [8, 128] dividing seq;
// p <= 32 or p == 64 (the p tile, min(p, 32), divides p).  Returns a
// cudaError_t.
extern "C" int ssd_scan(const float* x, const float* dt, const float* a,
                        const float* bmat, const float* cmat, const float* init,
                        float* y, float* final_state, int batch, int seq, int h,
                        int p, int n, int chunk, void* stream) {
  const int pt = p < kPTile ? p : kPTile;
  const bool p_ok = p >= 4 && p <= 2 * kPTile && p % 4 == 0 && p % pt == 0;
  const bool n_ok = n >= 8 && n <= 128 && n % 8 == 0;
  const bool chunk_ok = chunk >= 8 && chunk <= 128 && (chunk & (chunk - 1)) == 0;
  if (batch <= 0 || seq <= 0 || h <= 0 || !p_ok || !n_ok || !chunk_ok || seq % chunk)
    return (int)cudaErrorInvalidValue;
  const int sub = chunk < kMaxSub ? chunk : kMaxSub;
  const size_t smem = Layout(sub, pt, n).floats() * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(p / pt, h, batch);
  ssd_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, dt, a, bmat, cmat, init, y, final_state, seq, h, p, n, sub, pt);
  return (int)cudaGetLastError();
}
