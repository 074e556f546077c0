// Tiled weighted-degree histogram for the peel pass, Hopper (sm_90a).
//
// Replaces src/repro/kernels/peel_degree/kernel.py::tiled_degrees_pallas.
// The TPU kernel turns the scatter into one-hot [1,E]x[E,T] MXU matmuls over
// a dense [n_tiles, max_epT] layout padded to the busiest tile.  This kernel
// scatters into shared memory over the RAGGED tile-sorted layout
// (graph/partition.py): no padding slots, and the weight gather
// w_alive[edge_index[s]] of the reference wrapper is fused in.
//
//   deg[tile*tile_size + target_local[s]] += w_alive[edge_index[s]]
//   for every slot s of every tile; edge_index < 0, or a target_local
//   outside [0, tile_size), adds nothing (both padding conventions of the
//   reference's dense layout).
//
// Bound: bytes.  8 B a slot streamed (target_local, edge_index), w_alive
// gathered through L2 (28 MB at flickr_sm's 7.07M edges, which the 50 MB
// L2 holds, so DRAM sees it about once), 4 B a node written.  At flickr_sm's
// first rung (14,131,720 slots, 954 tiles of 1,024 nodes) that is about
// 145 MB, 0.043 ms at 3.35 TB/s.  The adds are a few per byte, far from any
// compute limit; what the old kernel of this file spent its time on was
// the shared f32 atomic (a compare-and-swap loop, ATOMS.CAST.SPIN), which
// retries on every collision, and the latency of dependent loads.
//
// Design against that bound:
//
// 1. Runs fold before they add.  A warp takes 128 consecutive slots a step
//    (a "group" is 4 slots at a multiple of 4; lane l holds group g0+l).
//    Each lane loads its 4 target_local and 4 edge_index with one 16-byte
//    load each (4 scalar loads where the group leaves the chunk or the
//    arrays are not 16-byte aligned: the grouping is by slot index, so the
//    adds do not depend on alignment), then issues all 4 w_alive gathers
//    before any add.  Equal targets that are neighbours fold: inside the
//    lane, then across the warp's 128 slots with a segmented shuffle scan
//    over the lanes' trailing runs (K2's fold, count_sketch.cu, here over
//    4 slots a lane).  The last slot of each run adds the run's sum; a run
//    whose sum is 0 adds nothing.  Edges are stored in (lo, hi) order, so
//    each tile's lower-endpoint half is sorted: at flickr_sm's first rung
//    46.6% of slots repeat the target before them, and folding leaves
//    7,604,230 adds for 14,131,720 slots (0.54 a slot; the count of
//    kernels/peel_degree/ref.py::fold_runs, the rule's plain version).
// 2. No compare-and-swap on the common path.  Each warp adds into its own
//    copy of the tile's histogram in shared memory (8 warps x 4 KB = 32 KB
//    a CTA at tile_size 1,024), with a plain load and store.  Adds of one
//    warp go out in 4 rounds (a lane's 1st..4th slot), each round's bins
//    held against each other with __match_any_sync, and lanes that share a
//    bin add their sum once, from the lowest lane (a step whose 128
//    targets never decrease, the sorted half of a tile, cannot share a bin
//    and skips the match).  The CTA runs as many warps as copies fit in
//    shared memory: 8, fewer only for tile sizes near the 58,112 limit.
//    At the end the CTA sums the copies in warp order.
// 3. Whole tiles per CTA; only large tiles split.  The chunk plan
//    (graph/partition.py::TiledEdges.from_ragged) gives a tile of at most
//    chunk_slots slots one CTA, which stores all its bins with plain
//    stores: no global atomics.  A larger tile is cut into chunk_slots
//    pieces, each of which adds its non-zero bins with red.global.add.f32
//    (native on global memory, unlike the shared f32 add).  chunk_slots is
//    the power of two that cuts the slots into about 1,024 pieces, at least
//    1,024: 16,384 at flickr_sm's first rung, where 121 of 954 tiles split,
//    1,471 CTAs run and at most 653,312 global reds are made (301,900 on
//    the first pass's weights; the old kernel, 4,096-slot chunks of any
//    tile: 3,885 CTAs, 2,223,425 global atomics).  The plan is padded to
//    n_tiles + ceil(S / chunk_slots) entries so that no count is read back
//    to the host; a padding entry (chunk_tile -1) returns at once.
// 4. L1 for the gathers.  With the adds folded and free of atomics, the
//    loads set the pace: the loads and gathers alone take most of the
//    kernel's time.  Left to itself, CUDA gives shared memory all it can
//    use (6 CTAs of 33 KB an SM), which leaves L1 too small to keep the
//    w_alive sectors that neighbouring slots of a tile share, so each
//    gather goes to L2.  The kernel asks for half the SM as shared memory:
//    4 CTAs (32 warps) an SM and about 124 KB of L1.  (The loadonly,
//    nocarve and carve75 cuts of scripts/torch_port_k1_ab.py measure this
//    point; PERF.md has their times.)
//
// Numbers: the split tiles' global adds come in no fixed order.  With
// integer-valued weights and every partial sum <= 2^24 every order gives
// the same bits, so the result equals the plain version bitwise; otherwise
// the two differ by f32 reassociation.
//
// The kernel neither allocates nor synchronizes: the caller zeroes deg on
// the stream it passes (the split tiles' adds need it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr uint32_t kFull = 0xffffffffu;
constexpr int kMaxSmemBytes = 232448;  // Hopper's dynamic shared memory per CTA
// Half of the SM's unified 256 KB as shared memory (the 132 KB setting), the
// rest left to L1 for the w_alive gathers (design point 4).  It is a
// preference: a tile size whose one CTA needs more shared memory gets it.
constexpr int kCarveoutPercent = 50;

// One histogram copy's stride in floats: tile_size rounded up to 4, so the
// copies can be zeroed with 16-byte stores.
__host__ __device__ inline int copy_stride(int tile_size) { return (tile_size + 3) & ~3; }

__device__ __forceinline__ void red_add(float* p, float v) {
  asm volatile("red.global.add.f32 [%0], %1;" ::"l"(p), "f"(v) : "memory");
}

// Loads group g: slots 4g..4g+3, of which those in [start, stop) are the
// chunk's.  key = target_local where the slot is the chunk's and adds
// (edge_index >= 0, target in the tile), else -1; e = its edge_index.
__device__ __forceinline__ void load_group(const int32_t* __restrict__ target_local,
                                           const int32_t* __restrict__ edge_index,
                                           int64_t g, int64_t start, int64_t stop,
                                           bool aligned, int tile_size, int32_t (&key)[4],
                                           int32_t (&e)[4]) {
  const int64_t s0 = g * 4;
  if (aligned && s0 >= start && s0 + 4 <= stop) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(target_local + s0));
    const int4 x = __ldg(reinterpret_cast<const int4*>(edge_index + s0));
    key[0] = t.x; key[1] = t.y; key[2] = t.z; key[3] = t.w;
    e[0] = x.x; e[1] = x.y; e[2] = x.z; e[3] = x.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = s0 + j >= start && s0 + j < stop;
      key[j] = in ? __ldg(target_local + s0 + j) : -1;
      e[j] = in ? __ldg(edge_index + s0 + j) : -1;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (e[j] < 0 || (uint32_t)key[j] >= (uint32_t)tile_size) key[j] = -1;
  }
}

// h[k] += v for each lane's (k, v); lanes whose k < 0 take no part.  Lanes
// that share a bin add their sum (in lane order) once, from the lowest of
// them, so each bin sees one plain load and store.
__device__ __forceinline__ void add_round(float* h, int32_t k, float v, int lane,
                                          bool distinct) {
  if (__ballot_sync(kFull, k >= 0) == 0u) return;
  if (!distinct) {
    const uint32_t peers = __match_any_sync(kFull, k >= 0 ? k : -1 - lane);
    if (peers != (1u << lane)) {
      float sum = 0.0f;
      for (uint32_t rest = peers; rest != 0u; rest &= rest - 1u) {
        sum += __shfl_sync(peers, v, __ffs(rest) - 1);
      }
      v = sum;
      if (__ffs(peers) - 1 != lane) k = -1;
    }
  }
  if (k >= 0) h[k] += v;
  __syncwarp();
}

// One step of one warp: lane `lane` holds 4 consecutive slots (keys k,
// weights w).  Folds each run of equal keys into its last slot and adds the
// runs' sums into the warp's histogram h.
__device__ __forceinline__ void add_step(float* h, const int32_t (&k)[4], const float (&w)[4],
                                         int lane) {
  // Inside the lane: s[j] is the sum of the run through slot j so far.
  float s[4];
  s[0] = w[0];
#pragma unroll
  for (int j = 1; j < 4; ++j) s[j] = (k[j] == k[j - 1] ? s[j - 1] : 0.0f) + w[j];
  const bool p1 = k[1] == k[0], p2 = p1 && k[2] == k[1], p3 = p2 && k[3] == k[2];
  const int32_t prev = __shfl_up_sync(kFull, k[3], 1);
  const int32_t next = __shfl_down_sync(kFull, k[0], 1);
  const bool cont = lane > 0 && k[0] == prev;  // the lane's first run began before it
  // Across lanes: segmented inclusive scan of the lanes' trailing-run sums;
  // a lane continues its predecessor's segment when it is one run that
  // continues the one before it.
  float tail = s[3];
  const uint32_t heads = __ballot_sync(kFull, !(p3 && cont));
  if (heads != kFull) {  // warp-uniform: some run crosses a lane boundary
    const int seg = 31 - __clz(heads & ((2u << lane) - 1u));
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float y = __shfl_up_sync(kFull, tail, d);
      if (lane - d >= seg) tail += y;
    }
  }
  float carry = __shfl_up_sync(kFull, tail, 1);
  if (!cont) carry = 0.0f;
  const float total[4] = {s[0] + carry, s[1] + (p1 ? carry : 0.0f), s[2] + (p2 ? carry : 0.0f),
                          s[3] + (p3 ? carry : 0.0f)};
  const bool ends[4] = {k[0] != k[1], k[1] != k[2], k[2] != k[3], lane == 31 || next != k[3]};
  // Targets that never decrease over the step cannot meet again in a bin.
  const bool rising = k[0] <= k[1] && k[1] <= k[2] && k[2] <= k[3] && (lane == 31 || k[3] <= next);
  const bool distinct = __all_sync(kFull, rising);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool adds = ends[j] && k[j] >= 0 && total[j] != 0.0f;
    add_round(h, adds ? k[j] : -1, total[j], lane, distinct);
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32)
tiled_degree_kernel(const int64_t* __restrict__ tile_ptr, const int32_t* __restrict__ chunk_tile,
                    const int64_t* __restrict__ chunk_start,
                    const int32_t* __restrict__ target_local,
                    const int32_t* __restrict__ edge_index, const float* __restrict__ w_alive,
                    float* __restrict__ deg, int tile_size, int chunk_slots, bool aligned) {
  extern __shared__ float4 smem4[];
  float* hist = reinterpret_cast<float*>(smem4);
  const int tile = chunk_tile[blockIdx.x];
  if (tile < 0) return;  // padding of the plan
  const int n_warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = copy_stride(tile_size);
  const int64_t start = chunk_start[blockIdx.x];
  const int64_t tile_lo = tile_ptr[tile], tile_hi = tile_ptr[tile + 1];
  const int64_t chunk_end = start + (int64_t)chunk_slots;
  const int64_t stop = chunk_end < tile_hi ? chunk_end : tile_hi;
  const bool split = tile_hi - tile_lo > (int64_t)chunk_slots;

  for (int i = threadIdx.x; i < n_warps * stride / 4; i += blockDim.x) {
    smem4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  float* h = hist + warp * stride;
  const int64_t g0 = start >> 2;
  const int64_t n_steps = (((stop - 1) >> 2) - g0 + 32) / 32;
  for (int64_t step = warp; step < n_steps; step += n_warps) {
    int32_t k[4], e[4];
    load_group(target_local, edge_index, g0 + step * 32 + lane, start, stop, aligned, tile_size,
               k, e);
    float w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = k[j] >= 0 ? __ldg(w_alive + e[j]) : 0.0f;
    add_step(h, k, w, lane);
  }
  __syncthreads();

  float* out = deg + (int64_t)tile * tile_size;
  for (int i = threadIdx.x; i < tile_size; i += blockDim.x) {
    float v = 0.0f;
    for (int c = 0; c < n_warps; ++c) v += hist[c * stride + i];
    if (!split) {
      out[i] = v;
    } else if (v != 0.0f) {
      red_add(out + i, v);
    }
  }
}

}  // namespace

// Launches one CTA per entry of the chunk plan on `stream`, with as many
// warps (histogram copies) as fit in shared memory, at most 8.  Returns
// cudaGetLastError() (0 on success); the Python wrapper raises on anything
// else.
extern "C" int peel_degree_tiled(const void* tile_ptr, const void* chunk_tile,
                                 const void* chunk_start, int n_chunks,
                                 const void* target_local, const void* edge_index,
                                 const void* w_alive, void* deg, int tile_size,
                                 int chunk_slots, void* stream) {
  const size_t copy_bytes = (size_t)copy_stride(tile_size) * sizeof(float);
  if (tile_size < 1 || chunk_slots < 1 || copy_bytes > (size_t)kMaxSmemBytes) {
    return (int)cudaErrorInvalidValue;
  }
  int warps = (int)(kMaxSmemBytes / copy_bytes);
  if (warps > kMaxWarps) warps = kMaxWarps;
  const size_t smem = (size_t)warps * copy_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      tiled_degree_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(tiled_degree_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             kCarveoutPercent);
  if (err != cudaSuccess) return (int)err;
  const bool aligned = ((uintptr_t)target_local % 16u) == 0u && ((uintptr_t)edge_index % 16u) == 0u;
  tiled_degree_kernel<<<n_chunks, warps * 32, smem, (cudaStream_t)stream>>>(
      (const int64_t*)tile_ptr, (const int32_t*)chunk_tile, (const int64_t*)chunk_start,
      (const int32_t*)target_local, (const int32_t*)edge_index, (const float*)w_alive,
      (float*)deg, tile_size, chunk_slots, aligned);
  return (int)cudaGetLastError();
}
