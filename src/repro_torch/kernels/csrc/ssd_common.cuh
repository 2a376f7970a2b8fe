// Helpers shared by the SSD scan's forward (ssd_scan.cu) and backward
// (ssd_scan_bwd.cu) kernels: the CTA shape, padded shared-memory strides,
// cp.async tile loads, products in split TF32 on mma.sync m16n8k8, the
// cumsum of dA within a chunk, and the head group of a CTA.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace ssd {

constexpr int kThreads = 256;       // 8 warps, in every kernel
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadGroup = 16;   // heads of one chunk-state or chunk-scan CTA
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
// Row strides in floats.  A fragment that walks a tile's rows with the
// lane's thread-in-group t (0..3) and its columns with its group g (0..7)
// reads a row stride of 8 mod 32 without bank conflicts (8 t + g); one that
// walks rows with g and columns with t, or rows with 2 t (the permuted K
// of the forward's chunk scan), reads a stride of 4 mod 32 without conflicts (4 g + t, 8 t + g).
__host__ __device__ constexpr int stride8(int w) { return round_up(w, 32) + 8; }
__host__ __device__ constexpr int stride4(int w) { return round_up(w, 32) + 4; }

// ---- cp.async ----

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(hopper::smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// rows x cols floats from global memory (row stride gs floats) to shared
// memory (row stride ss floats), 16 bytes a thread; cols % 4 == 0.
__device__ __forceinline__ void load_tile(float* dst, int ss, const float* src,
                                          size_t gs, int rows, int cols) {
  const int c4 = cols / 4;
  for (int e = threadIdx.x; e < rows * c4; e += kThreads) {
    const int r = e / c4, q = 4 * (e - r * c4);
    cp_async16(dst + r * ss + q, src + r * gs + q);
  }
}

// ---- split-TF32 products on mma.sync m16n8k8 ----
//
// Fragments of lane (g, t) = (lane / 4, lane % 4), as PTX lays out
// m16n8k8 .tf32: A (16 x 8, row) a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); B (8 x 8, col) b0 (t, g), b1 (t + 4, g); the f32
// accumulator d0 (g, 2 t), d1 (g, 2 t + 1), d2 (g + 8, 2 t),
// d3 (g + 8, 2 t + 1).
//
// A value v is split into hi, v with its low 13 bits cleared (TF32's 10
// mantissa bits), and lo = v - hi, exact in f32, whose low bits the tensor
// core drops (cleared here too): |v - hi - lo| < 2^-20 |v|.  Masks, not
// cvt.rna.tf32.f32, which the card runs as a slower conversion.

__device__ __forceinline__ uint32_t tf32_bits(float v) {
  return __float_as_uint(v) & 0xffffe000u;
}

template <int kN>
struct Frag {
  uint32_t hi[kN], lo[kN];
  __device__ __forceinline__ void set(int i, float v) {
    hi[i] = tf32_bits(v);
    lo[i] = tf32_bits(v - __uint_as_float(hi[i]));
  }
};

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[k] += a.b[k] for each k < kN with on[k], in split TF32 (lo.hi + hi.lo
// + hi.hi, small terms first): one pass of each of the three products over
// all k, so that no product waits on the one before it.
template <int kN>
__device__ __forceinline__ void mma3(float (*acc)[4], const Frag<4>& a,
                                     const Frag<2>* b, const bool* on) {
#pragma unroll
  for (int k = 0; k < kN; ++k) if (on[k]) mma_tf32(acc[k], a.lo, b[k].hi);
#pragma unroll
  for (int k = 0; k < kN; ++k) if (on[k]) mma_tf32(acc[k], a.hi, b[k].lo);
#pragma unroll
  for (int k = 0; k < kN; ++k) if (on[k]) mma_tf32(acc[k], a.hi, b[k].hi);
}

__device__ __forceinline__ void mma3(float* acc, const Frag<4>& a, const Frag<2>& b) {
  const bool on = true;
  mma3<1>(reinterpret_cast<float(*)[4]>(acc), a, &b, &on);
}

// A fragment of a product whose K runs along rows r0 (rows g) and r1
// (rows g + 8) of shared memory; and a B fragment whose K runs along row r.
__device__ __forceinline__ void load_a_rows(Frag<4>& fa, const float* r0, const float* r1,
                                            int t) {
  fa.set(0, r0[t]); fa.set(1, r1[t]); fa.set(2, r0[t + 4]); fa.set(3, r1[t + 4]);
}
__device__ __forceinline__ void load_b_row(Frag<2>& fb, const float* r, int t) {
  fb.set(0, r[t]); fb.set(1, r[t + 4]);
}

// The cumsum of dA = dt.a over one chunk's CL steps of one head, by one
// warp: lane l takes steps [l V, l V + V), V = max(1, CL / 32), in order,
// then adds the lanes before it.  Calls out(j, cs_j, dt_j, cs_last) for
// each step; returns cs_last to every lane.
template <int CL, typename Out>
__device__ __forceinline__ float chunk_cumsum(const float* dt_col, int stride,
                                              float a_h, Out out) {
  constexpr int V = CL >= 32 ? CL / 32 : 1;
  const int lane = threadIdx.x & 31;
  float d[V], cs[V], run = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = lane * V + v;
    d[v] = j < CL ? dt_col[(size_t)j * stride] : 0.f;
    run += d[v] * a_h;
    cs[v] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  float before = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) before = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) cs[v] += before;
  const float last = __shfl_sync(kFull, cs[V - 1], (CL - 1) / V);
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (lane * V + v < CL) out(lane * V + v, cs[v], d[v], last);
  return last;
}

// Heads of one chunk-state or chunk-scan CTA: about one CTA for each SM,
// so that B (stage 1) and C, B and C.B^T (stage 3) are loaded and taken
// once for as many heads as the card leaves each CTA.
inline int head_group(int batch, int nc, int h) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long units = (long)batch * nc * h;
  int hg = (int)((units + sms - 1) / sms);
  hg = hg < 1 ? 1 : hg > kMaxHeadGroup ? kMaxHeadGroup : hg;
  return hg < h ? hg : h;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace ssd
