// l0-sampler sketch update from a signed edge batch, Hopper (sm_90a).
//
// Replaces src/repro/kernels/l0_sampler/kernel.py::l0_delta_pallas.
// The TPU kernel turns the scatter into a dense one-hot accumulate on the
// VPU (int32 has no MXU path), Theta(E * L*C) work per table, with the
// output blocked over columns in VMEM.  Hopper has native integer atomics,
// so this kernel scatters directly, one thread per row of the batch:
//
//   u = min(src, dst), v = max(src, dst), s = (u == v) ? 0 : sgn
//   for each table j:  T[level(u,v), j, cell_j(u,v), :] += (s, s*u, s*v, s*fp(u,v))
//
// with level, cell and fingerprint from the shared hash family
// (hashing.cuh).  Rows with s == 0 (padding, self-loops) are skipped.  The
// four adds are atomicAdd on the table reinterpreted as unsigned int, so
// the wrap mod 2^32 is defined; integer addition mod 2^32 commutes, so the
// result is bitwise equal to the plain version whatever the order.  The
// kernel adds into the table it is given: a zeroed delta (l0_delta) or the
// live sketch itself (l0_update), which spares a 25.2 MB delta and its add
// at the defaults.
//
// Bound: per launch the kernel reads 12 B per row (src, dst, sgn) and
// does 4*d atomic adds of 4 B per non-zero row (d=3 at the defaults).
// Those atomics resolve in L2: the table, 25.2 MB at L=32, d=3, C=16384,
// fits the 50 MB L2, and the DRAM bytes a batch must move are one read and
// one write of the 16 B of each distinct cell it touches, not 16*d B per
// row (chip_smoke.py counts the cells of its batch and bounds the kernel
// by these bytes).  L2 atomic throughput, not DRAM bytes, is
// the likely limit.  Level 0 holds half the edges, so its d*C cells take
// most of the traffic; plain global atomics are right for a first kernel.
//
// The kernel neither allocates nor synchronizes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hashing.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTables = 16;

// The hash parameters, by value in the kernel's argument block.
struct L0Hash {
  uint32_t a_lvl[2];
  uint32_t c_lvl;
  uint32_t a_fp[2];
  uint32_t c_fp;
  uint32_t a_cell[kMaxTables][2];
  uint32_t c_cell[kMaxTables];
};

__global__ void __launch_bounds__(kThreads)
l0_update_kernel(const int32_t* __restrict__ src,
                 const int32_t* __restrict__ dst,
                 const int32_t* __restrict__ sgn,
                 int64_t n_rows,
                 unsigned int* __restrict__ table,
                 const L0Hash p,
                 int n_levels,
                 int n_tables,
                 uint32_t n_cells) {
  const uint32_t pow2_mask = (n_cells & (n_cells - 1u)) == 0u ? n_cells - 1u : 0u;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x; r < n_rows; r += stride) {
    const int32_t a = src[r];
    const int32_t b = dst[r];
    const int32_t u = a < b ? a : b;
    const int32_t v = a < b ? b : a;
    if (u == v || sgn[r] == 0) continue;
    const uint32_t s = (uint32_t)sgn[r];
    const uint32_t uu = (uint32_t)u;
    const uint32_t vv = (uint32_t)v;
    const int32_t lvl = repro_hash::level_from_hash(
        repro_hash::mix32_pair(p.a_lvl[0], p.a_lvl[1], p.c_lvl, uu, vv), n_levels);
    const uint32_t fp = repro_hash::mix32_pair(p.a_fp[0], p.a_fp[1], p.c_fp, uu, vv);
    const uint32_t su = s * uu, sv = s * vv, sf = s * fp;
    for (int j = 0; j < n_tables; ++j) {
      const uint32_t h =
          repro_hash::mix32_pair(p.a_cell[j][0], p.a_cell[j][1], p.c_cell[j], uu, vv);
      const int32_t cell =
          pow2_mask != 0u || n_cells == 1u ? (int32_t)(h & pow2_mask)
                                           : repro_hash::bucket32(h, n_cells);
      unsigned int* f =
          table + ((((int64_t)lvl * n_tables + j) * (int64_t)n_cells + cell) * 4);
      atomicAdd(f + 0, s);
      atomicAdd(f + 1, su);
      atomicAdd(f + 2, sv);
      atomicAdd(f + 3, sf);
    }
  }
}

}  // namespace

// Adds the batch into `table` (int32[n_levels, n_tables, n_cells, 4]) on
// `stream`.  `hash_words` is a host array of uint32 words: a_lvl[2], c_lvl,
// a_fp[2], c_fp, a_cell[n_tables][2], c_cell[n_tables].  Returns
// cudaGetLastError() (0 on success); the Python wrapper raises on anything
// else.
extern "C" int l0_sampler_update(const void* src, const void* dst, const void* sgn,
                                 long long n_rows, void* table,
                                 const uint32_t* hash_words, int n_levels,
                                 int n_tables, int n_cells, void* stream) {
  if (n_tables < 1 || n_tables > kMaxTables || n_levels < 1 || n_cells < 1) {
    return (int)cudaErrorInvalidValue;
  }
  L0Hash p = {};
  p.a_lvl[0] = hash_words[0];
  p.a_lvl[1] = hash_words[1];
  p.c_lvl = hash_words[2];
  p.a_fp[0] = hash_words[3];
  p.a_fp[1] = hash_words[4];
  p.c_fp = hash_words[5];
  for (int j = 0; j < n_tables; ++j) {
    p.a_cell[j][0] = hash_words[6 + 2 * j];
    p.a_cell[j][1] = hash_words[6 + 2 * j + 1];
    p.c_cell[j] = hash_words[6 + 2 * n_tables + j];
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess) {
    return (int)err;
  }
  long long blocks = (n_rows + kThreads - 1) / kThreads;
  const long long cap = 8LL * sms;  // 2048 resident threads per SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  l0_update_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)dst, (const int32_t*)sgn, (int64_t)n_rows,
      (unsigned int*)table, p, n_levels, n_tables, (uint32_t)n_cells);
  return (int)cudaGetLastError();
}
