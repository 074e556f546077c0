// Count-Sketch counter update from an edge stream, Hopper (sm_90a).
//
// Replaces src/repro/kernels/count_sketch/kernel.py::count_sketch_update_pallas.
// The TPU kernel keeps each table's b counters in VMEM and turns the scatter
// into one-hot [1,E]x[E,b] MXU matmuls, column chunk by column chunk, and
// walks the t tables as a grid axis, so it reads the endpoints t times.
// Hopper has fast shared-memory atomics, so this kernel scatters directly:
//
//   c[i, bucket32(mix32(a_h[i], c_h[i], x), b)] += sign32(mix32(a_g[i], c_g[i], x)) * w[e]
//   for every edge e, each endpoint x of e (x0[e], and x1[e] when x1 is
//   given), and each table i.
//
// Bound: memory.  Per launch the kernel reads 12 B per edge (src, dst,
// w_alive, each once) and writes the t*b float counters: at livejournal_md
// (64.2M edges) about 0.77 GB, 0.23 ms at 3.35 TB/s; chip_smoke.py
// computes the bound from the E it runs.  The work is 2*t hashed
// shared-memory adds per edge, and those, not the bytes, set the pace.
//
// Design against that bound:
//
// * Equal endpoints fold before they add.  A warp reads 32 consecutive
//   edges a step.  Within a step, each run of lanes holding the same
//   endpoint x (lanes l..m, x[l-1] != x[l] = ... = x[m] != x[m+1]) is
//   summed by a segmented shuffle scan, and its last lane hashes x once
//   and adds g_i(x) * sum(w) into each table; a run whose sum is 0 adds
//   nothing.  An edge list sorted by its lower endpoint puts a node's
//   edges in one run, so its adds, which would pile 32 lanes onto one
//   shared counter a table, become one add a step; a step whose 32
//   endpoints all differ skips the scan.  src and dst fold apart.
//   (kernels/count_sketch/ref.py::combine_runs is the rule's plain
//   version.)  g_i(x) = +-1, so g*sum(w) differs from sum(g*w) only by
//   the reassociation the float contract below allows.
// * Whole warp instructions.  The f32 shared add is a compare-and-swap
//   loop (ATOMS.CAST.SPIN in the SASS), and its cost goes by warp
//   instructions more than by lanes.  A step whose 32 lanes all end a run
//   adds at once; in any other step the runs' last lanes queue their
//   (x, sum) in the warp's shared queue, and the warp adds 32 queued
//   pairs at a time (the rest at the end).  A sorted stream's folded
//   adds, one to three lanes a step, so take a whole instruction per 32.
// * Loads in flight: each warp loads four steps (128 edges) before it
//   adds, 12 loads a thread.
// * Windows: the flat t*b counter index is cut into windows that fit one
//   CTA's shared memory (227 KB on Hopper, less the warps' 16 KB of
//   queues).  At the defaults (t=5, b=8192: 160 KB) one window holds all
//   tables, so each edge is read ONCE.  Where t*b does not fit, the
//   windows hold whole tables (or, for b above 54,016, parts of one
//   table), and each window's group of CTAs reads the edges again:
//   n_groups reads in all.  About one CTA per SM per group strides over
//   the edges, accumulates into its window, then adds its non-zero
//   counters to global memory: at most t*b global adds a CTA, 0.07 ms of
//   the main path's launch (PERF.md).
//
// Numbers: float atomics add in no fixed order.  With integer-valued weights
// and every partial sum <= 2^24 every order gives the same bits, so the
// counters equal the plain version bitwise; otherwise they differ by f32
// reassociation.
//
// The kernel neither allocates nor synchronizes: the caller zeroes `out` on
// the stream it passes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hashing.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 4;  // 32-edge steps a warp loads before it adds
constexpr int kEdgesPerWarp = 32 * kSteps;
constexpr int kMaxTables = 16;
constexpr uint32_t kFull = 0xffffffffu;

// The hash parameters, by value in the kernel's argument block.
struct SketchHash {
  uint32_t a_h[kMaxTables];
  uint32_t c_h[kMaxTables];
  uint32_t a_g[kMaxTables];
  uint32_t c_g[kMaxTables];
};

// What one CTA's window covers: counters [lo, hi) of the flat t*b index,
// tables t0..t1.
struct Window {
  int lo, hi, t0, t1;
  uint32_t b, pow2_mask;
};

// h mod b, with a mask when b is a power of two (b is uniform, so the
// branch never diverges).
__device__ __forceinline__ int32_t bucket(uint32_t h, const Window& win) {
  return win.pow2_mask != 0u || win.b == 1u ? (int32_t)(h & win.pow2_mask)
                                            : repro_hash::bucket32(h, win.b);
}

__device__ __forceinline__ void add_endpoint(float* cnt, const SketchHash& p, uint32_t x,
                                             float w, const Window& win) {
  for (int i = win.t0; i <= win.t1; ++i) {
    const int flat = i * (int)win.b + bucket(repro_hash::mix32(p.a_h[i], p.c_h[i], x), win);
    if (flat >= win.lo && flat < win.hi) {
      const float s = repro_hash::sign32(repro_hash::mix32(p.a_g[i], p.c_g[i], x));
      atomicAdd(&cnt[flat - win.lo], s * w);
    }
  }
}

// A warp's queue of folded adds in shared memory: up to 63 (x, sum)
// pairs; `len` is warp-uniform.
struct Queue {
  uint32_t x[64];
  float w[64];
};

// One step: lane `lane` holds endpoint x and weight w of edge base+lane.
// Each run of equal x folds into its last lane (segmented inclusive scan).
// Where every lane ends a run with a non-zero sum, all 32 add at once;
// else the runs' last lanes queue their (x, sum), and the warp adds 32
// queued pairs at a time, so folded adds take whole warp instructions.
__device__ __forceinline__ void add_step(float* cnt, Queue& q, int& len,
                                         const SketchHash& p, uint32_t x, float w,
                                         int lane, const Window& win) {
  const uint32_t prev = __shfl_up_sync(kFull, x, 1);
  const uint32_t heads = __ballot_sync(kFull, lane == 0 || x != prev);
  bool last = true;
  if (heads != kFull) {  // warp-uniform: some run is longer than one lane
    const int start = 31 - __clz(heads & ((2u << lane) - 1u));
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float y = __shfl_up_sync(kFull, w, d);
      if (lane - d >= start) w += y;
    }
    last = lane == 31 || ((heads >> (lane + 1)) & 1u) != 0u;
  }
  const bool adds = last && w != 0.0f;
  const uint32_t lead = __ballot_sync(kFull, adds);
  if (lead == kFull) {
    add_endpoint(cnt, p, x, w, win);
    return;
  }
  if (adds) {
    const int pos = len + __popc(lead & ((1u << lane) - 1u));
    q.x[pos] = x;
    q.w[pos] = w;
  }
  len += __popc(lead);
  if (len < 32) return;
  __syncwarp();
  const uint32_t qx = q.x[lane];
  const float qw = q.w[lane];
  const bool moves = lane < len - 32;
  const uint32_t mx = moves ? q.x[32 + lane] : 0u;
  const float mw = moves ? q.w[32 + lane] : 0.0f;
  __syncwarp();
  if (moves) {
    q.x[lane] = mx;
    q.w[lane] = mw;
  }
  len -= 32;
  __syncwarp();
  add_endpoint(cnt, p, qx, qw, win);
}

__global__ void __launch_bounds__(kThreads)
count_sketch_kernel(const int32_t* __restrict__ x0,
                    const int32_t* __restrict__ x1,
                    const float* __restrict__ w,
                    int64_t n_edges,
                    float* __restrict__ out,
                    const SketchHash p,
                    int n_tables,
                    uint32_t n_buckets,
                    int window) {
  extern __shared__ float cnt[];
  __shared__ Queue queues[kWarps];
  const int total = n_tables * (int)n_buckets;
  Window win;
  win.lo = (int)blockIdx.y * window;
  win.hi = min(win.lo + window, total);
  win.t0 = win.lo / (int)n_buckets;
  win.t1 = (win.hi - 1) / (int)n_buckets;
  win.b = n_buckets;
  win.pow2_mask = (n_buckets & (n_buckets - 1u)) == 0u ? n_buckets - 1u : 0u;
  const int lane = threadIdx.x & 31;
  Queue& q = queues[threadIdx.x >> 5];
  int len = 0;

  for (int i = threadIdx.x; i < win.hi - win.lo; i += kThreads) cnt[i] = 0.0f;
  __syncthreads();

  const int64_t n_chunks = (n_edges + kEdgesPerWarp - 1) / kEdgesPerWarp;
  const int64_t warp_stride = (int64_t)gridDim.x * kWarps;
  for (int64_t c = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); c < n_chunks;
       c += warp_stride) {
    const int64_t base = c * kEdgesPerWarp + lane;
    uint32_t a[kSteps], b[kSteps];
    float we[kSteps];
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int64_t e = base + 32 * k;
      const bool in = e < n_edges;
      a[k] = in ? (uint32_t)x0[e] : 0u;
      b[k] = in && x1 != nullptr ? (uint32_t)x1[e] : 0u;
      we[k] = in ? w[e] : 0.0f;  // past the end: weight 0, adds nothing
    }
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      add_step(cnt, q, len, p, a[k], we[k], lane, win);
      if (x1 != nullptr) add_step(cnt, q, len, p, b[k], we[k], lane, win);
    }
  }
  __syncwarp();
  if (lane < len) add_endpoint(cnt, p, q.x[lane], q.w[lane], win);
  __syncthreads();

  for (int i = threadIdx.x; i < win.hi - win.lo; i += kThreads) {
    const float v = cnt[i];
    if (v != 0.0f) atomicAdd(&out[win.lo + i], v);
  }
}

}  // namespace

// Launches n_groups x (about one CTA per SM, fewer for short streams) on
// `stream`.  `hash_params` is a host array of 4*n_tables uint32 words:
// a_h, c_h, a_g, c_g, table by table within each.  x1 may be null (one
// endpoint array).  Returns cudaGetLastError() (0 on success); the Python
// wrapper raises on anything else.
extern "C" int count_sketch_update(const void* x0, const void* x1, const void* w,
                                   long long n_edges, void* out,
                                   const uint32_t* hash_params, int n_tables,
                                   int n_buckets, int window, int n_groups,
                                   void* stream) {
  if (n_tables < 1 || n_tables > kMaxTables || n_buckets < 1 || window < 1 ||
      n_groups < 1) {
    return (int)cudaErrorInvalidValue;
  }
  SketchHash p = {};
  for (int i = 0; i < n_tables; ++i) {
    p.a_h[i] = hash_params[i];
    p.c_h[i] = hash_params[n_tables + i];
    p.a_g[i] = hash_params[2 * n_tables + i];
    p.c_g[i] = hash_params[3 * n_tables + i];
  }
  const size_t smem = (size_t)window * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      count_sketch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess) {
    return (int)err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, count_sketch_kernel, kThreads, smem)) != cudaSuccess) {
    return (int)err;
  }
  const long long slots = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  long long per_group = (slots + n_groups - 1) / n_groups;
  const long long needed =
      (n_edges + (long long)kEdgesPerWarp * kWarps - 1) / ((long long)kEdgesPerWarp * kWarps);
  if (per_group > needed) per_group = needed;
  if (per_group < 1) per_group = 1;
  const dim3 grid((unsigned)per_group, (unsigned)n_groups);
  count_sketch_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)x0, (const int32_t*)x1, (const float*)w, (int64_t)n_edges,
      (float*)out, p, n_tables, (uint32_t)n_buckets, window);
  return (int)cudaGetLastError();
}
