// Run-coalesced page gather (GC compaction of the KV page pool), for Hopper
// (sm_90a): one launch of 1-D bulk copies.
//
// Replaces: src/repro/kernels/gc_compact.py::gather_page_blocks, the Pallas
// TPU kernel in which each grid step is one DMA of a block of block_pages
// pages, addressed through scalar-prefetched source block ids, on one
// (P, page, D) plane.
//
// Bound on an H100 (NVIDIA H100 80GB HBM3, 700 W power limit): device-memory
// bytes.  It does no arithmetic; each byte of a moved page is read once and
// written once.
//
// Design: the host plans the whole compaction as one table of copy units
// (src page, dst page, n pages): the aligned blocks first, then the
// single-page tails.  One launch moves every unit on every plane of the pool
// (each (layer, k/v) plane of the serving cache), so a unit-plane is one
// contiguous span (16-64 KB at the serve widths) from the source plane to
// the destination plane.  About two persistent CTAs an SM walk the
// (unit, plane) pairs in turn.  A CTA is one thread, since the bulk copies
// (the TMA unit) do the moving: it issues its spans in chunks of up to
// 16 KB through a ring of 4 shared-memory stages: a cp.async.bulk load into
// a stage completes on that stage's mbarrier, then a cp.async.bulk store
// writes it out, while the loads of the next three chunks are in flight; a
// stage is loaded again once its store has read it.
// The copy is out of place: source and destination never alias.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kStages = 4;
constexpr uint32_t kChunk = 16384;   // bytes a stage holds
constexpr size_t kSmem = (size_t)kStages * kChunk;

struct Cursor {
  long long item;   // unit * n_planes + plane
  long long off;    // bytes of the item already issued
};

struct Copy {
  const unsigned char* src;
  unsigned char* dst;
  uint32_t bytes;
};

__global__ void __launch_bounds__(1)
gather_page_units_kernel(const unsigned char* __restrict__ src,
                         unsigned char* __restrict__ dst,
                         const int* __restrict__ units, int n_units,
                         int n_planes, long long src_plane_bytes,
                         long long dst_plane_bytes, long long page_bytes) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[kStages];
  for (int s = 0; s < kStages; ++s) hopper::mbar_init(&bars[s], 1);
  hopper::fence_barrier_init();

  const long long n_items = (long long)n_units * n_planes;
  Cursor cur{blockIdx.x, 0};
  // The next chunk of this CTA's items, or false when they are done.
  auto next = [&](Copy& c) {
    while (cur.item < n_items) {
      const long long unit = cur.item / n_planes;
      const long long plane = cur.item - unit * n_planes;
      const int* u = units + 3 * unit;   // (src page, dst page, n pages)
      const long long bytes = (long long)u[2] * page_bytes;
      if (cur.off < bytes) {
        c.src = src + plane * src_plane_bytes + u[0] * page_bytes + cur.off;
        c.dst = dst + plane * dst_plane_bytes + u[1] * page_bytes + cur.off;
        c.bytes = (uint32_t)min((long long)kChunk, bytes - cur.off);
        cur.off += c.bytes;
        return true;
      }
      cur.item += gridDim.x;
      cur.off = 0;
    }
    return false;
  };
  unsigned char* out[kStages];
  uint32_t len[kStages];
  auto load = [&](int stage, const Copy& c) {
    out[stage] = c.dst;
    len[stage] = c.bytes;
    hopper::mbar_expect_tx(&bars[stage], c.bytes);
    hopper::bulk_load(ring + (size_t)stage * kChunk, c.src, c.bytes, &bars[stage]);
  };

  Copy c;
  int issued = 0;
  while (issued < kStages && next(c)) load(issued++, c);
  for (int k = 0; k < issued; ++k) {
    const int stage = k % kStages;
    hopper::mbar_wait(&bars[stage], (k / kStages) & 1);
    hopper::bulk_store(out[stage], ring + (size_t)stage * kChunk, len[stage]);
    hopper::bulk_commit_group();
    // Chunk k - 1's store has read its stage once only chunk k's is left.
    if (k >= 1 && next(c)) {
      hopper::bulk_wait_read<1>();
      load((k - 1) % kStages, c);
      ++issued;
    }
  }
  hopper::bulk_wait_all();
}

}  // namespace

// units: (n_units, 3) int32 on the card, (src page, dst page, n pages);
// unit i of every plane goes from src[plane][src page ...] to
// dst[plane][dst page ...].  Sizes are in bytes and multiples of 16; the
// pointers are 16-byte aligned.  Returns a cudaError_t.
extern "C" int gather_page_units(const void* src, void* dst, const int* units,
                                 int n_units, int n_planes,
                                 long long src_plane_bytes,
                                 long long dst_plane_bytes,
                                 long long page_bytes, int n_ctas,
                                 void* stream) {
  if (n_units <= 0 || n_planes <= 0 || n_ctas <= 0 ||
      (src_plane_bytes | dst_plane_bytes | page_bytes) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      gather_page_units_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)n_units * n_planes;
  const int grid = (int)(items < n_ctas ? items : n_ctas);
  gather_page_units_kernel<<<grid, 1, kSmem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst),
      units, n_units, n_planes, src_plane_bytes, dst_plane_bytes, page_bytes);
  return (int)cudaGetLastError();
}
