// l0-sampler sketch update from a signed edge batch, Hopper (sm_90a).
//
// Replaces src/repro/kernels/l0_sampler/kernel.py::l0_delta_pallas.
// The TPU kernel turns the scatter into a dense one-hot accumulate on the
// VPU (int32 has no MXU path), Theta(E * L*C) work per table, with the
// output blocked over columns in VMEM.  Hopper has native integer atomics,
// so this kernel scatters directly:
//
//   u = min(src, dst), v = max(src, dst), s = (u == v) ? 0 : sgn
//   for each table j:  T[level(u,v), j, cell_j(u,v), :] += (s, s*u, s*v, s*fp(u,v))
//
// with level, cell and fingerprint from the shared hash family
// (hashing.cuh).  The adds are red.global.add.u32 on the table read as
// unsigned int, so the wrap mod 2^32 is defined; integer addition mod 2^32
// commutes, so the result is bitwise equal to the plain version whatever
// the order.  The kernel adds into the table it is given: a zeroed delta
// (l0_delta) or the live sketch itself (l0_update), which spares a 25.2 MB
// delta and its add at the defaults.
//
// Bound: per launch the kernel reads 12 B per row (src, dst, sgn), and
// the DRAM bytes a batch must move are one read and one write of the 16 B
// of each distinct cell it touches (chip_smoke.py counts them).  The table
// (25.2 MB at L=32, d=3, C=16384) sits in the 50 MB L2, where the 4*d
// adds of a row resolve: the L2's atomic units, which work on 32-byte
// sectors, set the pace.
//
// Design against that: the four fields of a cell are one 16-byte run, so
// the four adds of a (row, table) pair go to four neighbouring lanes.
// Each warp takes 128 consecutive rows, four per lane (int4 loads of src,
// dst and sgn where all three are 16-byte aligned; scalar loads for the
// tail and for misaligned views).  For each of a lane's four rows in turn,
// the lanes canonicalize their row and hash its level, fingerprint and d
// cells once; the rows with s != 0 are compacted (ballot, prefix count)
// into a per-warp shared stage, so dropped rows take no lanes.  Then lanes
// 4k..4k+3 read fields 0..3 of staged row k, and one red instruction
// covers 8 cells, 8 sectors, where one thread per row touched 32: a
// quarter of the L2 sector operations for the same count of
// instructions.  Equal cells inside a warp are not combined: at C=16384 a
// warp's cells almost never meet (chip_smoke.py logs the rate).
//
// The kernel neither allocates nor synchronizes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hashing.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerLane = 4;
constexpr int kRowsPerWarp = 32 * kRowsPerLane;
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

// One warp's staged rows: fields [row][4] (so lane 4k+f reads word
// 4*(r+k)+f, all 32 lanes on consecutive words), level, and the cell of
// every table ([table][row], 8 consecutive words per red round).
struct Stage {
  uint32_t val[32][4];
  uint32_t lvl[32];
  uint32_t cell[kMaxTables][32];
};

__device__ __forceinline__ void red_add(unsigned int* addr, uint32_t v) {
  asm volatile("red.global.add.u32 [%0], %1;" ::"l"(addr), "r"(v) : "memory");
}

__global__ void __launch_bounds__(kThreads)
l0_update_kernel(const int32_t* __restrict__ src,
                 const int32_t* __restrict__ dst,
                 const int32_t* __restrict__ sgn,
                 int64_t n_rows,
                 unsigned int* __restrict__ table,
                 const L0Hash p,
                 int n_levels,
                 int n_tables,
                 uint32_t n_cells,
                 bool vec) {
  __shared__ Stage stages[kWarps];
  const int lane = threadIdx.x & 31;
  Stage& st = stages[threadIdx.x >> 5];
  const uint32_t lt_mask = (1u << lane) - 1u;
  const uint32_t pow2_mask = (n_cells & (n_cells - 1u)) == 0u ? n_cells - 1u : 0u;
  const int64_t n_chunks = (n_rows + kRowsPerWarp - 1) / kRowsPerWarp;
  const int64_t warp_stride = (int64_t)gridDim.x * kWarps;

  for (int64_t c = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); c < n_chunks;
       c += warp_stride) {
    // This lane's four rows, base..base+3 (sign 0 past the end).
    const int64_t base = c * kRowsPerWarp + lane * kRowsPerLane;
    int32_t ra[kRowsPerLane], rb[kRowsPerLane], rs[kRowsPerLane];
    if (vec && base + kRowsPerLane <= n_rows) {
      const int4 a4 = *reinterpret_cast<const int4*>(src + base);
      const int4 b4 = *reinterpret_cast<const int4*>(dst + base);
      const int4 s4 = *reinterpret_cast<const int4*>(sgn + base);
      ra[0] = a4.x; ra[1] = a4.y; ra[2] = a4.z; ra[3] = a4.w;
      rb[0] = b4.x; rb[1] = b4.y; rb[2] = b4.z; rb[3] = b4.w;
      rs[0] = s4.x; rs[1] = s4.y; rs[2] = s4.z; rs[3] = s4.w;
    } else {
#pragma unroll
      for (int k = 0; k < kRowsPerLane; ++k) {
        const bool in = base + k < n_rows;
        ra[k] = in ? src[base + k] : 0;
        rb[k] = in ? dst[base + k] : 0;
        rs[k] = in ? sgn[base + k] : 0;
      }
    }

#pragma unroll
    for (int k = 0; k < kRowsPerLane; ++k) {
      const int32_t u = ra[k] < rb[k] ? ra[k] : rb[k];
      const int32_t v = ra[k] < rb[k] ? rb[k] : ra[k];
      const bool live = u != v && rs[k] != 0;
      const uint32_t mask = __ballot_sync(0xffffffffu, live);
      if (mask == 0u) continue;  // warp-uniform
      const int n = __popc(mask);
      if (live) {
        const int slot = __popc(mask & lt_mask);
        const uint32_t s = (uint32_t)rs[k];
        const uint32_t uu = (uint32_t)u;
        const uint32_t vv = (uint32_t)v;
        const uint32_t fp = repro_hash::mix32_pair(p.a_fp[0], p.a_fp[1], p.c_fp, uu, vv);
        *reinterpret_cast<uint4*>(st.val[slot]) = make_uint4(s, s * uu, s * vv, s * fp);
        st.lvl[slot] = (uint32_t)repro_hash::level_from_hash(
            repro_hash::mix32_pair(p.a_lvl[0], p.a_lvl[1], p.c_lvl, uu, vv), n_levels);
        for (int j = 0; j < n_tables; ++j) {
          const uint32_t h =
              repro_hash::mix32_pair(p.a_cell[j][0], p.a_cell[j][1], p.c_cell[j], uu, vv);
          st.cell[j][slot] = pow2_mask != 0u || n_cells == 1u
                                 ? (h & pow2_mask)
                                 : (uint32_t)repro_hash::bucket32(h, n_cells);
        }
      }
      __syncwarp();
      // Lanes 4k..4k+3 add fields 0..3 of staged row r+k: 8 cells a round.
      const int f = lane & 3;
      for (int r = lane >> 2; r < n; r += 8) {
        const uint32_t val = st.val[r][f];
        const int64_t lvl_row = (int64_t)st.lvl[r] * n_tables;
        for (int j = 0; j < n_tables; ++j) {
          const int64_t cell = (lvl_row + j) * (int64_t)n_cells + st.cell[j][r];
          red_add(table + cell * 4 + f, val);
        }
      }
      __syncwarp();
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
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess) {
    return (int)err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, l0_update_kernel,
                                                           kThreads, 0)) != cudaSuccess) {
    return (int)err;
  }
  // One pass over the batch where the card holds enough warps for it,
  // else as many CTAs as fit at once, each striding over 128-row chunks.
  const long long chunks = (n_rows + kRowsPerWarp - 1) / kRowsPerWarp;
  long long blocks = (chunks + kWarps - 1) / kWarps;
  const long long cap = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const bool vec = ((uintptr_t)src | (uintptr_t)dst | (uintptr_t)sgn) % 16 == 0;
  l0_update_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)dst, (const int32_t*)sgn, (int64_t)n_rows,
      (unsigned int*)table, p, n_levels, n_tables, (uint32_t)n_cells, vec);
  return (int)cudaGetLastError();
}
