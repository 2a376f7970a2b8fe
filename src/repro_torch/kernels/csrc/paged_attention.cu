// One-token decode attention through a page table, for Hopper (sm_90a):
// split-KV flash-decoding in one launch.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention, the Pallas
// TPU kernel whose grid is (batch, kv_head, page) with the page axis run in
// order and the page table in scalar prefetch.
//
// Bound on an H100 (NVIDIA H100 80GB HBM3, 700 W power limit): device-memory
// bytes.  Each (sequence, kv head) reads its K and V rows once (4*D bytes a
// token from a bf16 pool) and does 4*g*D flops a token: at 67 TFLOP/s of
// f32 against 3.35 TB/s the flops take less time up to g = 20, and g <= 12
// at the widths here.  At the serving driver's shapes (batch
// <= 4, <= 48 tokens, 16 kv heads of 128) a call moves under 1 MB, which the
// card moves in less time than a launch takes; at thousands of tokens of
// context the bytes bound it.
//
// Design.  The grid is (split, kv head, batch row), flattened, split
// fastest.  The wrapper (plan_splits) cuts the padded context (n_pages *
// page_size) into splits of pages_per_split pages, aiming at about 16 CTAs
// an SM, so one sequence is read by many CTAs at once, with splits of at
// least 128 tokens (one split at the serve shape).  A CTA loads lengths[b],
// its slice of page_table[b] and its q rows at once, then streams its
// tokens in tiles of 32: each tile's K and V rows (D * elem contiguous bytes
// each) are issued as 16-byte cp.async copies, lane r of a warp finding
// token r's pool offset and the others taking it by shuffle, into a ring of
// 3 stages of raw pool-dtype rows padded by 16 bytes, so two tiles are in
// flight while one computes (2 stages where 3 do not fit, and 1, with no
// tile ahead and no padding, where large g * d leaves room for no more).  Rows of unmapped pages and
// slots past the length are never read: cp.async writes them as zeros, and
// they get weight 0.  Scores: lane t of a warp takes token t of the tile and
// a warp takes every fourth query head of the kv head, up to 4 heads a pass
// over the K row, so each K element read from shared memory serves them
// all; q sits in shared memory as f32, scaled by sm_scale * log2(e).  The
// tile's max and sum are warp shuffles (base 2), with m and l per head in
// shared memory.  P.V: a thread owns one column of D for up to 16 heads
// (fewer where that leaves threads idle), in registers, and reads each V
// element once for all of them; the f32 accumulator stays in shared memory
// between tiles.  With one split the CTA writes the output.  With more,
// each CTA writes its partial (acc, m, l) in f32 to a workspace, and the
// last CTA of a (b, kv head), found by an atomic counter after
// __threadfence(), merges the partials in split order (so the result does
// not depend on which CTA finishes last), writes the output in q's dtype
// and sets the counter back to 0.  A row with no valid slot writes zeros;
// a split with no valid slot contributes nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;        // tokens a tile: one a lane in the scores
constexpr int kScoreHeads = 4;   // query heads a warp scores per pass
constexpr int kPvHeads = 16;     // query heads a thread accumulates per pass
constexpr size_t kMaxSmem = 232448;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* page_table;
  const int* lengths;
  void* out;
  float* ws;        // (B * Hkv, splits, part) partials; unused at one split
  int* counters;    // (B * Hkv) arrivals, 0 between calls
  int n_pages, page_size, hkv, g, d, splits, pages_per_split, stages;
  float scale;      // sm_scale * log2(e)
};

// Floats of one split's partial in the workspace: acc (g, d), then m (g)
// and l (g), padded so every partial starts on 16 bytes.
__host__ __device__ inline int partial_floats(int g, int d) {
  return g * d + ((2 * g + 3) & ~3);
}

// Shared memory of one CTA, in bytes from its start.
struct Layout {
  size_t q, acc, p, m, l, a, tbl, flag, ring, total;
  int row_stride;   // bytes of one K or V row in the ring
};

__host__ __device__ inline Layout layout(int g, int d, int elem,
                                         int pages_per_split, int splits,
                                         int stages) {
  Layout s;
  size_t off = 0;
  s.q = off;   off += sizeof(float) * g * d;        // (g, d) scaled q
  s.acc = off; off += sizeof(float) * g * d;        // (g, d) accumulator
  s.p = off;   off += sizeof(float) * g * kTile;    // (g, kTile) weights
  s.m = off;   off += sizeof(float) * g;            // running max (base 2)
  s.l = off;   off += sizeof(float) * g;            // running sum
  s.a = off;   off += sizeof(float) * g;            // this tile's rescale
  s.tbl = off; off += sizeof(int) * pages_per_split;
  s.flag = off; off += sizeof(int);
  off = (off + 15) & ~size_t(15);
  // 16 bytes of padding against bank conflicts, but none in the 1-stage
  // ring, which is there to fit where nothing else does
  s.row_stride = d * elem + (stages > 1 ? 16 : 0);
  s.ring = off;
  // (stage, k/v, token) rows; the merge reuses it for (splits, g) m and l
  const size_t ring = (size_t)stages * 2 * kTile * s.row_stride;
  const size_t merge = splits > 1 ? 2 * sizeof(float) * splits * g : 0;
  off += ring > merge ? ring : merge;
  s.total = off;
  return s;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes of K as floats: 8 bf16 or 4 f32.
__device__ __forceinline__ void unpack(const uint4 raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void unpack(const uint4 raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

// Scores of the lane's token (its K row in shared memory) against kNh query
// heads, h0, h0 + kWarps, ...: each K element read once for all of them,
// and a partial sum for each element of a chunk, so no FMA waits on another.
template <int kNh, typename KT>
__device__ __forceinline__ void score_heads(const unsigned char* k_row,
                                            const float* q_s, int h0, int d,
                                            int vecs, float (&s)[kScoreHeads]) {
  constexpr int kEpc = 16 / sizeof(KT);
  float part[kNh][kEpc];
#pragma unroll
  for (int j = 0; j < kNh; ++j)
#pragma unroll
    for (int e = 0; e < kEpc; ++e) part[j][e] = 0.f;
#pragma unroll 4
  for (int v = 0; v < vecs; ++v) {
    float kf[kEpc];
    unpack(*reinterpret_cast<const uint4*>(k_row + v * 16), kf);
#pragma unroll
    for (int j = 0; j < kNh; ++j) {
      const float* qh = q_s + (h0 + j * kWarps) * d + v * kEpc;
#pragma unroll
      for (int e = 0; e < kEpc; e += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qh + e);
        part[j][e] = fmaf(qv.x, kf[e], part[j][e]);
        part[j][e + 1] = fmaf(qv.y, kf[e + 1], part[j][e + 1]);
        part[j][e + 2] = fmaf(qv.z, kf[e + 2], part[j][e + 2]);
        part[j][e + 3] = fmaf(qv.w, kf[e + 3], part[j][e + 3]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kNh; ++j) {
    float t = 0.f;
#pragma unroll
    for (int e = 0; e < kEpc; ++e) t += part[j][e];
    s[j] = t;
  }
}

// acc[h0 .. h0 + kNh) column e = acc * alpha + the tile's weights . V: each
// V element read once for the kNh heads, two partial sums a head.
template <int kNh, typename KT>
__device__ __forceinline__ void pv_heads(float* acc_s, const float* p_s,
                                         const float* a_s,
                                         const unsigned char* v_col,
                                         int row_stride, int h0, int d, int e) {
  float acc[kNh][2];
#pragma unroll
  for (int j = 0; j < kNh; ++j) {
    acc[j][0] = acc_s[(h0 + j) * d + e] * a_s[h0 + j];
    acc[j][1] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < kTile; t += 4) {
    float vf[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      vf[u] = to_f32(*reinterpret_cast<const KT*>(v_col + (t + u) * row_stride));
#pragma unroll
    for (int j = 0; j < kNh; ++j) {
      const float4 w = *reinterpret_cast<const float4*>(p_s + (h0 + j) * kTile + t);
      acc[j][0] = fmaf(w.x, vf[0], acc[j][0]);
      acc[j][1] = fmaf(w.y, vf[1], acc[j][1]);
      acc[j][0] = fmaf(w.z, vf[2], acc[j][0]);
      acc[j][1] = fmaf(w.w, vf[3], acc[j][1]);
    }
  }
#pragma unroll
  for (int j = 0; j < kNh; ++j) acc_s[(h0 + j) * d + e] = acc[j][0] + acc[j][1];
}

template <typename KT>
__device__ __forceinline__ void pv_dispatch(int nh, float* acc_s, const float* p_s,
                                            const float* a_s,
                                            const unsigned char* v_col,
                                            int row_stride, int h0, int d, int e) {
  switch (nh) {
#define PV_CASE(n) \
    case n: pv_heads<n, KT>(acc_s, p_s, a_s, v_col, row_stride, h0, d, e); break;
    PV_CASE(1) PV_CASE(2) PV_CASE(3) PV_CASE(4) PV_CASE(5) PV_CASE(6)
    PV_CASE(7) PV_CASE(8) PV_CASE(9) PV_CASE(10) PV_CASE(11) PV_CASE(12)
    PV_CASE(13) PV_CASE(14) PV_CASE(15) PV_CASE(16)
#undef PV_CASE
    default: break;
  }
}

// kOneStage: the 1-stage ring (p.stages == 1), which loads a tile only once
// the previous one is done with the ring.
template <typename QT, typename KT, bool kOneStage>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Params p) {
  constexpr int kEpc = 16 / sizeof(KT);   // elements of a 16-byte chunk
  const QT* q = static_cast<const QT*>(p.q);
  const KT* k_pool = static_cast<const KT*>(p.k_pool);
  const KT* v_pool = static_cast<const KT*>(p.v_pool);
  const int split = blockIdx.x % p.splits;
  const int unit = blockIdx.x / p.splits;     // b * hkv + kh
  const int kh = unit % p.hkv;
  const int b = unit / p.hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = p.g;
  const int d = p.d;
  const int vecs = d / kEpc;                  // 16-byte chunks of a row

  const Layout lay = layout(g, d, sizeof(KT), p.pages_per_split, p.splits,
                            p.stages);
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  float* acc_s = reinterpret_cast<float*>(smem + lay.acc);
  float* p_s = reinterpret_cast<float*>(smem + lay.p);
  float* m_s = reinterpret_cast<float*>(smem + lay.m);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);
  float* a_s = reinterpret_cast<float*>(smem + lay.a);
  int* tbl_s = reinterpret_cast<int*>(smem + lay.tbl);
  int* flag_s = reinterpret_cast<int*>(smem + lay.flag);
  unsigned char* ring = smem + lay.ring;
  const int row_stride = lay.row_stride;
  const int stage_bytes = 2 * kTile * row_stride;

  // This split's tokens, [t_begin, t_begin + n_tok), and its pages.
  const int split_tokens = p.pages_per_split * p.page_size;
  const int t_begin = split * split_tokens;
  const int limit = min(p.lengths[b], p.n_pages * p.page_size);
  const int n_tok = max(min(split_tokens, limit - t_begin), 0);
  const int n_tiles = (n_tok + kTile - 1) / kTile;
  // The slice is read whatever the length, so it does not wait for it.
  const int first_page = split * p.pages_per_split;
  const int n_tbl = max(min(p.pages_per_split, p.n_pages - first_page), 0);
  const int* table = p.page_table + (size_t)b * p.n_pages + first_page;
  for (int i = tid; i < n_tbl; i += kThreads) tbl_s[i] = table[i];

  const size_t o_base = ((size_t)b * p.hkv + kh) * g * d;
  for (int i = tid; i < g * d; i += kThreads) {
    q_s[i] = to_f32(q[o_base + i]) * p.scale;
    acc_s[i] = 0.f;
  }
  for (int j = tid; j < g; j += kThreads) {
    m_s[j] = -INFINITY;
    l_s[j] = 0.f;
  }
  __syncthreads();   // the table slice is in place before the first copy

  // The copies of a tile: a warp issues rows_per_step rows (of 2 * kTile:
  // K then V) at a time, lane -> (row in the step, 16-byte chunk).  Lane r
  // finds token r's pool offset once a tile; the others take it by shuffle.
  const int rows_per_step = vecs >= 32 ? 1 : 32 / vecs;
  const int sub = vecs >= 32 ? 0 : lane / vecs;
  const int v0 = vecs >= 32 ? lane : lane % vecs;
  const int vstep = vecs >= 32 ? 32 : vecs;
  const int steps = (2 * kTile + kWarps * rows_per_step - 1) / (kWarps * rows_per_step);
  const size_t token_stride = (size_t)p.hkv * d;
  auto issue = [&](int tile) {
    if (tile < n_tiles) {
      const int rel = tile * kTile + lane;
      long long off = -1;   // elements from the pool's start; -1: not read
      if (rel < n_tok) {
        const int page = tbl_s[rel / p.page_size];
        if (page >= 0)
          off = (long long)(((size_t)page * p.page_size + rel % p.page_size) *
                                token_stride + (size_t)kh * d);
      }
      unsigned char* st = ring + (size_t)(tile % p.stages) * stage_bytes;
      for (int i = 0; i < steps; ++i) {
        const int row = (i * kWarps + warp) * rows_per_step + sub;
        const long long o = __shfl_sync(0xffffffffu, off, row & (kTile - 1));
        if (sub < rows_per_step && row < 2 * kTile) {
          const KT* src = row < kTile ? k_pool : v_pool;
          const uint32_t bytes = o >= 0 ? 16 : 0;
          if (o >= 0) src += o;
          for (int v = v0; v < vecs; v += vstep)
            hopper::cp_async16_zfill(st + row * row_stride + v * 16,
                                     o >= 0 ? src + v * kEpc : src, bytes);
        }
      }
    }
    hopper::cp_async_commit_group();   // empty past the last tile
  };

  for (int s = 0; s < p.stages - 1; ++s) issue(s);
  // P.V work: (column, group of pv_heads heads) items, enough to occupy
  // every thread where g allows.
  const int pv_heads = min(kPvHeads, (g + max(1, kThreads / d) - 1) / max(1, kThreads / d));
  const int pv_items = d * ((g + pv_heads - 1) / pv_heads);
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (kOneStage) {   // no tile ahead: load this one once tile - 1 is done
      __syncthreads();
      issue(tile);
    }
    hopper::cp_async_wait_pending(kOneStage ? 0 : p.stages - 2);
    __syncthreads();   // this tile's rows are in; tile - 1's stage is free
    if (!kOneStage) issue(tile + p.stages - 1);
    const unsigned char* k_s = ring + (size_t)(tile % p.stages) * stage_bytes;
    const unsigned char* v_s = k_s + kTile * row_stride;
    const int rel = tile * kTile + lane;
    const bool valid = rel < n_tok && tbl_s[rel / p.page_size] >= 0;

    // Scores and the tile's softmax: lane = token, warp = every kWarps-th
    // head, up to kScoreHeads heads a pass over the K row.
    const unsigned char* k_row = k_s + lane * row_stride;
    for (int h0 = warp; h0 < g; h0 += kWarps * kScoreHeads) {
      const int nh = min(kScoreHeads, (g - h0 + kWarps - 1) / kWarps);
      float s[kScoreHeads];
      switch (nh) {
        case 1: score_heads<1, KT>(k_row, q_s, h0, d, vecs, s); break;
        case 2: score_heads<2, KT>(k_row, q_s, h0, d, vecs, s); break;
        case 3: score_heads<3, KT>(k_row, q_s, h0, d, vecs, s); break;
        default: score_heads<4, KT>(k_row, q_s, h0, d, vecs, s); break;
      }
#pragma unroll
      for (int j = 0; j < kScoreHeads; ++j) {
        if (j >= nh) break;   // uniform across the warp
        const int h = h0 + j * kWarps;
        const float sc = valid ? s[j] : -INFINITY;
        float mx = sc;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = m_s[h];
        const float m_new = fmaxf(m_old, mx);
        const float w = m_new == -INFINITY ? 0.f : exp2f(sc - m_new);
        float sum = w;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        p_s[h * kTile + lane] = w;
        if (lane == 0) {
          const float alpha = m_new == -INFINITY ? 1.f : exp2f(m_old - m_new);
          l_s[h] = l_s[h] * alpha + sum;
          m_s[h] = m_new;
          a_s[h] = alpha;
        }
      }
    }
    __syncthreads();

    // P.V: a thread owns column e of up to kPvHeads heads and reads each V
    // element once for all of them.  Invalid rows are zeros with weight 0.
    for (int item = tid; item < pv_items; item += kThreads) {
      const int e = item % d;
      const int h0 = (item / d) * pv_heads;
      pv_dispatch<KT>(min(pv_heads, g - h0), acc_s, p_s, a_s,
                      v_s + e * sizeof(KT), row_stride, h0, d, e);
    }
  }
  hopper::cp_async_wait_pending(0);   // the empty groups
  __syncthreads();

  QT* out = static_cast<QT*>(p.out) + o_base;
  if (p.splits == 1) {
    for (int i = tid; i < g * d; i += kThreads) {
      const float l = l_s[i / d];
      store(out + i, l > 0.f ? acc_s[i] / l : 0.f);
    }
    return;
  }

  // This split's partial, then the merge by the last CTA of the (b, kv
  // head), in split order.
  const int part = partial_floats(g, d);
  float* parts = p.ws + (size_t)unit * p.splits * part;
  float* mine = parts + (size_t)split * part;
  for (int i = tid; i < g * d; i += kThreads) mine[i] = acc_s[i];
  for (int j = tid; j < g; j += kThreads) {
    mine[g * d + j] = m_s[j];
    mine[g * d + g + j] = l_s[j];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int last = atomicAdd(p.counters + unit, 1) == p.splits - 1;
    if (last) p.counters[unit] = 0;   // every split has arrived: reset
    *flag_s = last;
  }
  __syncthreads();
  if (!*flag_s) return;
  __threadfence();

  // The splits' m and l per head into shared memory, all loads at once;
  // then a warp a head turns them into each split's weight
  // exp2(m_s - max m) and the head's sum.
  float* w_s = reinterpret_cast<float*>(ring);   // (splits, g) m, then weights
  float* sl_s = w_s + p.splits * g;               // (splits, g) l
  for (int i = tid; i < p.splits * g; i += kThreads) {
    const int s = i / g;
    const int h = i - s * g;
    const float* ps = parts + (size_t)s * part + g * d;
    w_s[i] = __ldcg(ps + h);
    sl_s[i] = __ldcg(ps + g + h);
  }
  __syncthreads();
  for (int h = warp; h < g; h += kWarps) {
    float mx = -INFINITY;
    for (int s = lane; s < p.splits; s += 32) mx = fmaxf(mx, w_s[s * g + h]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float l = 0.f;
    for (int s = lane; s < p.splits; s += 32) {
      // 0 for a split with no valid slot, and for every split of a row
      // with none
      const float w = mx == -INFINITY ? 0.f : exp2f(w_s[s * g + h] - mx);
      w_s[s * g + h] = w;
      l += w == 0.f ? 0.f : sl_s[s * g + h] * w;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) l_s[h] = l;
  }
  __syncthreads();
  // Every output float4 as the weighted sum of the splits' accumulators, in
  // split order, with kBatch loads in flight a thread.
  constexpr int kBatch = 16;
  for (int i4 = tid; i4 < g * d / 4; i4 += kThreads) {
    const int h = i4 * 4 / d;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < p.splits; s0 += kBatch) {
      float4 a[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (s0 + u < p.splits)
          a[u] = __ldcg(reinterpret_cast<const float4*>(
              parts + (size_t)(s0 + u) * part) + i4);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (s0 + u < p.splits) {
          const float w = w_s[(s0 + u) * g + h];
          o.x += w * a[u].x;
          o.y += w * a[u].y;
          o.z += w * a[u].z;
          o.w += w * a[u].w;
        }
      }
    }
    const float l = l_s[h];
    const float r = l > 0.f ? 1.f / l : 0.f;
    store(out + 4 * i4, o.x * r);
    store(out + 4 * i4 + 1, o.y * r);
    store(out + 4 * i4 + 2, o.z * r);
    store(out + 4 * i4 + 3, o.w * r);
  }
}

template <typename QT, typename KT>
int launch(Params p, int batch, cudaStream_t stream) {
  // The deepest ring that fits: 3 stages, else 2, else 1 (large g * d).
  Layout lay;
  for (p.stages = 3; p.stages >= 1; --p.stages) {
    lay = layout(p.g, p.d, sizeof(KT), p.pages_per_split, p.splits, p.stages);
    if (lay.total <= kMaxSmem || p.stages == 1) break;
  }
  const long long grid = (long long)p.splits * p.hkv * batch;
  if (lay.total > kMaxSmem || grid > 0x7fffffffLL || p.splits < 1 ||
      p.pages_per_split < 1 || p.d % 8 || (p.splits > 1 && !p.ws))
    return (int)cudaErrorInvalidValue;
  auto kernel = p.stages == 1 ? paged_attention_kernel<QT, KT, true>
                              : paged_attention_kernel<QT, KT, false>;
  if (lay.total > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)grid, kThreads, lay.total, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  ws holds batch * hkv * splits *
// paged_attention_partial_floats(g, d) floats (unused, may be null, at one
// split); counters holds batch * hkv ints, all 0, and is left all 0.
// Returns a cudaError_t.
extern "C" int paged_attention(int q_dtype, int kv_dtype, const void* q,
                               const void* k_pool, const void* v_pool,
                               const int* page_table, const int* lengths,
                               void* out, float* ws, int* counters, int batch,
                               int hkv, int g, int d, int n_pages,
                               int page_size, int pages_per_split, int splits,
                               float sm_scale, void* stream) {
  Params p{q, k_pool, v_pool, page_table, lengths, out, ws, counters,
           n_pages, page_size, hkv, g, d, splits, pages_per_split, 0,
           sm_scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) return launch<float, float>(p, batch, s);
  if (q_dtype == 0 && kv_dtype == 1) return launch<float, __nv_bfloat16>(p, batch, s);
  if (q_dtype == 1 && kv_dtype == 0) return launch<__nv_bfloat16, float>(p, batch, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(p, batch, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int paged_attention_partial_floats(int g, int d) {
  return partial_floats(g, d);
}

// Dynamic shared memory one CTA needs with a ring of `stages` stages (1 to
// 3): at 1, the fewest, the caller refuses shapes that exceed the card's
// 227 KB.
extern "C" long long paged_attention_smem_bytes(int g, int d, int kv_elem_bytes,
                                                int pages_per_split, int splits,
                                                int stages) {
  return (long long)layout(g, d, kv_elem_bytes, pages_per_split, splits,
                           stages).total;
}
