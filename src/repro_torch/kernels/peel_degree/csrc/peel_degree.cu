// Tiled weighted-degree histogram for the peel pass, Hopper (sm_90a).
//
// Replaces src/repro/kernels/peel_degree/kernel.py::tiled_degrees_pallas.
// The TPU kernel turns the scatter into one-hot [1,E]x[E,T] MXU matmuls over
// a dense [n_tiles, max_epT] layout padded to the busiest tile.  Hopper has
// fast shared-memory atomics, so this kernel scatters directly, over the
// RAGGED tile-sorted layout (graph/partition.py): no padding slots, and the
// weight gather w_alive[edge_index[s]] of the reference wrapper
// (ops.py:34-35) is fused in, so no per-pass w[S] array is materialized.
//
//   deg[tile*tile_size + target_local[s]] += w_alive[edge_index[s]]
//   for every slot s of every tile; edge_index < 0, or a target_local
//   outside [0, tile_size), adds nothing (both padding conventions of the
//   reference's dense layout).
//
// Bound: memory.  Per launch the kernel reads 8 B per slot (target_local,
// edge_index), gathers 4 B of w_alive per slot from an E-float array (28 MB
// at FLICKR scale: 7.07M edges, which stays in the 50 MB L2, so DRAM sees
// about E*4 B), and writes 4 B per node.  At FLICKR's first rung (14.1M
// slots, 976k nodes) that is about 145 MB, 43 us at 3.35 TB/s.  The adds
// are a few per byte, far from any compute limit.
//
// Design against that bound: each CTA takes one chunk of CHUNK_SLOTS
// consecutive slots of one tile (a chunk list built once per ladder rung),
// so a hub tile (21% of all slots at FLICKR scale) spreads over many SMs.
// The CTA streams its slots with coalesced int32 loads, accumulates into a
// tile_size-float histogram in shared memory with shared atomics, and then
// adds only the non-zero bins to global memory: the output traffic is
// bounded by the chunk's distinct targets, not by its slots.  Hubs make
// threads collide on one shared bin; plain shared atomics are correct, and
// warp-aggregated adds are later work.
//
// Numbers: float atomics add in no fixed order.  With integer-valued
// weights and every partial sum <= 2^24 every order gives the same bits, so
// the result equals the plain version bitwise; otherwise the two differ by
// f32 reassociation.
//
// The kernel neither allocates nor synchronizes: the caller zeroes deg on
// the stream it passes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
tiled_degree_kernel(const int64_t* __restrict__ tile_ptr,
                    const int32_t* __restrict__ chunk_tile,
                    const int64_t* __restrict__ chunk_start,
                    const int32_t* __restrict__ target_local,
                    const int32_t* __restrict__ edge_index,
                    const float* __restrict__ w_alive,
                    float* __restrict__ deg,
                    int tile_size,
                    int chunk_slots) {
  extern __shared__ float hist[];
  const int tile = chunk_tile[blockIdx.x];
  const int64_t start = chunk_start[blockIdx.x];
  const int64_t tile_end = tile_ptr[tile + 1];
  const int64_t chunk_end = start + (int64_t)chunk_slots;
  const int64_t stop = chunk_end < tile_end ? chunk_end : tile_end;

  for (int i = threadIdx.x; i < tile_size; i += kThreads) hist[i] = 0.0f;
  __syncthreads();

  for (int64_t s = start + threadIdx.x; s < stop; s += kThreads) {
    const int32_t e = edge_index[s];
    const int32_t l = target_local[s];
    if (e >= 0 && (uint32_t)l < (uint32_t)tile_size) {
      const float v = w_alive[e];
      if (v != 0.0f) atomicAdd(&hist[l], v);
    }
  }
  __syncthreads();

  float* out = deg + (int64_t)tile * tile_size;
  for (int i = threadIdx.x; i < tile_size; i += kThreads) {
    const float v = hist[i];
    if (v != 0.0f) atomicAdd(&out[i], v);
  }
}

}  // namespace

// Launches one CTA per chunk on `stream`.  Returns cudaGetLastError() (0 on
// success); the Python wrapper raises on anything else.
extern "C" int peel_degree_tiled(const void* tile_ptr, const void* chunk_tile,
                                 const void* chunk_start, int n_chunks,
                                 const void* target_local,
                                 const void* edge_index, const void* w_alive,
                                 void* deg, int tile_size, int chunk_slots,
                                 void* stream) {
  const size_t smem = (size_t)tile_size * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tiled_degree_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  tiled_degree_kernel<<<n_chunks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int64_t*)tile_ptr, (const int32_t*)chunk_tile,
      (const int64_t*)chunk_start, (const int32_t*)target_local,
      (const int32_t*)edge_index, (const float*)w_alive, (float*)deg,
      tile_size, chunk_slots);
  return (int)cudaGetLastError();
}
