// Count-Sketch counter update from an edge stream, Hopper (sm_90a).
//
// Replaces src/repro/kernels/count_sketch/kernel.py::count_sketch_update_pallas.
// The TPU kernel keeps each table's b counters in VMEM and turns the scatter
// into one-hot [1,E]x[E,b] MXU matmuls, column chunk by column chunk, and
// walks the t tables as a grid axis, so it reads the endpoints t times.
// Hopper has fast shared-memory atomics, so this kernel scatters directly:
//
//   c[i, bucket32(mix32(a_h[i], c_h[i], x), b)] += sign32(mix32(a_g[i], c_g[i], x)) * w[e]
//   for every edge e with w[e] != 0, each endpoint x of e (x0[e], and x1[e]
//   when x1 is given), and each table i.
//
// A zero weight adds +-0, which leaves every counter as the plain version's
// index_add_ leaves it, so such edges are skipped.
//
// Bound: memory.  Per launch the kernel reads 12 B per edge (src, dst,
// w_alive, each once) and writes the t*b float counters: at livejournal_md
// (68.9M edges drawn) about 0.8 GB, 0.25 ms at 3.35 TB/s; chip_smoke.py
// computes the bound from the E it runs.  The work is 2*t hashed
// shared-memory atomic adds per edge, 689M at livejournal_md's t=5; the
// shared atomics, not the bytes, may set the pace, and a hub's endpoints
// all land on one counter per table (plain shared atomics are correct;
// warp-aggregated adds are later work).
//
// Design against that bound: the flat t*b counter index is cut into
// windows that fit one CTA's shared memory (227 KB on Hopper).  At the
// defaults (t=5, b=8192: 160 KB) one window holds all tables, so each edge
// is read ONCE.  Where t*b does not fit, the windows hold whole tables (or,
// for b above 58,112, parts of one table), and each window's group of CTAs
// reads the edges again: n_groups reads in all.  About one CTA per SM per
// group strides over the edges, accumulates into its window in shared
// memory, then adds only its non-zero counters to global memory, so the
// flush (t*b atomics per CTA at most) stays small against the 2*E*t shared
// adds at the main path's sizes.
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
constexpr int kMaxTables = 16;

// The hash parameters, by value in the kernel's argument block.
struct SketchHash {
  uint32_t a_h[kMaxTables];
  uint32_t c_h[kMaxTables];
  uint32_t a_g[kMaxTables];
  uint32_t c_g[kMaxTables];
};

// h mod b, with a mask when b is a power of two (b is uniform, so the
// branch never diverges).
__device__ __forceinline__ int32_t bucket(uint32_t h, uint32_t b, uint32_t pow2_mask) {
  return pow2_mask != 0u || b == 1u ? (int32_t)(h & pow2_mask) : repro_hash::bucket32(h, b);
}

__device__ __forceinline__ void add_endpoint(float* cnt, const SketchHash& p,
                                             uint32_t x, float w, int t0, int t1,
                                             int lo, int hi, uint32_t b,
                                             uint32_t pow2_mask) {
  for (int i = t0; i <= t1; ++i) {
    const int flat =
        i * (int)b + bucket(repro_hash::mix32(p.a_h[i], p.c_h[i], x), b, pow2_mask);
    if (flat >= lo && flat < hi) {
      const float s = repro_hash::sign32(repro_hash::mix32(p.a_g[i], p.c_g[i], x));
      atomicAdd(&cnt[flat - lo], s * w);
    }
  }
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
  const int total = n_tables * (int)n_buckets;
  const int lo = (int)blockIdx.y * window;
  const int hi = min(lo + window, total);
  const int t0 = lo / (int)n_buckets;
  const int t1 = (hi - 1) / (int)n_buckets;
  const uint32_t pow2_mask = (n_buckets & (n_buckets - 1u)) == 0u ? n_buckets - 1u : 0u;

  for (int i = threadIdx.x; i < hi - lo; i += kThreads) cnt[i] = 0.0f;
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < n_edges; e += stride) {
    const float we = w[e];
    if (we == 0.0f) continue;
    add_endpoint(cnt, p, (uint32_t)x0[e], we, t0, t1, lo, hi, n_buckets, pow2_mask);
    if (x1 != nullptr) {
      add_endpoint(cnt, p, (uint32_t)x1[e], we, t0, t1, lo, hi, n_buckets, pow2_mask);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < hi - lo; i += kThreads) {
    const float v = cnt[i];
    if (v != 0.0f) atomicAdd(&out[lo + i], v);
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
  const long long needed = (n_edges + kThreads - 1) / kThreads;
  if (per_group > needed) per_group = needed;
  if (per_group < 1) per_group = 1;
  const dim3 grid((unsigned)per_group, (unsigned)n_groups);
  count_sketch_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)x0, (const int32_t*)x1, (const float*)w, (int64_t)n_edges,
      (float*)out, p, n_tables, (uint32_t)n_buckets, window);
  return (int)cudaGetLastError();
}
