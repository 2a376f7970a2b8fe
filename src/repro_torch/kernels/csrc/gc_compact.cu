// Run-coalesced page-block gather (GC compaction of the KV page pool), for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gc_compact.py::gather_page_blocks, the Pallas
// TPU kernel in which each grid step is one DMA of a block of block_pages
// pages, addressed through scalar-prefetched source block ids, on one
// (P, page, D) plane.
//
// Bound on an H100: device-memory bytes.  It does no arithmetic; each byte
// of a moved block is read once and written once.
//
// Design: one launch moves a block list on every plane of the pool (each
// (layer, k/v) plane of the serving cache).  The grid is (M copy units,
// n_planes); each CTA copies one block of block_pages * page * D contiguous
// elements with 16-byte vector loads and stores, so neighbouring threads touch
// neighbouring addresses.  The CTA reads its own source block id.  The copy is
// out of place: source and destination never alias.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_page_blocks_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                          const int* __restrict__ src_block_ids,
                          long long src_plane_vecs, long long dst_plane_vecs,
                          long long block_vecs, long long dst_offset_vecs) {
  const long long unit = blockIdx.x;
  const long long plane = blockIdx.y;
  const uint4* from = src + plane * src_plane_vecs +
                      (long long)src_block_ids[unit] * block_vecs;
  uint4* to = dst + plane * dst_plane_vecs + dst_offset_vecs + unit * block_vecs;
  for (long long v = threadIdx.x; v < block_vecs; v += blockDim.x) to[v] = from[v];
}

}  // namespace

// Sizes are in bytes and multiples of 16; the pointers are 16-byte aligned.
// Block i of every plane goes from src[plane][src_block_ids[i]] to
// dst[plane][dst_offset + i * block].  Returns a cudaError_t.
extern "C" int gather_page_blocks(const void* src, void* dst,
                                  const int* src_block_ids, int m, int n_planes,
                                  long long src_plane_bytes,
                                  long long dst_plane_bytes,
                                  long long block_bytes,
                                  long long dst_offset_bytes, void* stream) {
  if (m <= 0 || n_planes <= 0 || n_planes > 65535 || (src_plane_bytes | dst_plane_bytes |
      block_bytes | dst_offset_bytes) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  gather_page_blocks_kernel<<<dim3(m, n_planes), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), src_block_ids,
      src_plane_bytes / 16, dst_plane_bytes / 16, block_bytes / 16,
      dst_offset_bytes / 16);
  return (int)cudaGetLastError();
}
