// The float32 routes of K4 (flash_attention/csrc/flash_attention.cu) and
// K4b (flash_attention/csrc/flash_attention_bwd.cu) on the tensor cores:
// every product is split TF32, three wgmma m64nNk8 .tf32 products into one
// f32 accumulator.  One kernel body serves the forward and the three
// backward passes (dV, dK, dQ); each library instantiates its own.
//
// The split.  x = hi + lo, hi = x rounded to TF32 (10 mantissa bits, round
// to nearest, ties away from zero, computed on the bits: (x + 0x1000) &
// ~0x1fff), lo = x - hi (exact in f32) rounded the same way.  A B is taken
// as lo(A) hi(B) + hi(A) lo(B) + hi(A) hi(B), the small products first;
// the dropped lo lo term and lo's own rounding are ~2^-22 of |A||B|, so
// the result keeps f32-level error where one TF32 product keeps 2^-11.
// Both halves are exact TF32 values, so what the tensor core does with the
// low 13 bits of an f32 operand does not matter.
// flash_attention/ref.py::tf32_split_matmul is the plain emulation.
//
// What bounds it.  The split costs 3x the FLOPs at 495 TFLOP/s dense TF32
// (about 165 effective, against 67 for f32 FMA outside the tensor cores),
// and every operand tile twice its f32 bytes in shared memory (hi and lo):
// a 64 x 128 f32 tile with its lo is 64 KB.  So the CTA is one warpgroup
// (64 rows, 128 threads, up to 255 registers) and each step takes 32
// columns; shared memory, not registers, sets the ring's depth (one stage
// where two A operands are kept: dK and dQ at D > 64).  Each step runs its
// products and its elementwise work in turn.  A software pipeline (the
// next step's score products issued before this step's output product,
// from two rings) was built and ran slower: ptxas serialized every wgmma
// (C7518) around the consumers' ring waits, and with those waits as asm
// loops the dK and dQ passes spilled.
//
// Layout.  TF32 wgmma has no transpose flag: both shared-memory operands
// are K-major (the summed dimension contiguous).  A pre-pass
// (flash_split_tf32, one launch a tensor) writes each input's hi and lo
// into a scratch the wrapper allocates, as [B*H, S, DP] rows (the
// "natural" copy: A operands and the B operands of the score products) or
// as [B*H, DP, S8] columns (the "transposed" copy: the B operand of the
// product that sums over the sequence).  DP is D rounded up to 32 (a
// 128-byte swizzle atom of f32) and padded with zeros; S8 is S rounded up
// to 8.  The transposed copy stores sequence index s at 8 (s / 8) + (s & 1)
// * 4 + (s & 7) / 2: the order in which an m64nNk8 accumulator's thread
// holds its columns (2 t4, 2 t4 + 1) as the TF32 A fragment's k indices
// (t4, t4 + 4).  So P and dS go from the accumulator to A fragments in
// registers with no shuffle: only the k order of A and B changes, and the
// sum does not depend on it.
//
// The kernel body, per mode (rows: the CTA's 64; cols: a step's 32):
//   fwd: rows q, cols keys.  A = Q, score B = K, output B = V^T.  Online
//        softmax in base 2; O = sum P V / l; optional log-sum-exp.
//   dV:  rows keys, cols q (over the group's q heads).  A = K, score B =
//        Q, output B = dO^T.  P^T = exp2(S^T c - lse2); dV += P^T dO.
//   dK:  as dV with A = K, V; score B = Q, dO; output B = Q^T.
//        dS^T = P^T (dP^T - delta); dK += dS^T Q, times the scale.
//   dQ:  rows q, cols keys.  A = Q, dO; score B = K, V; output B = K^T.
//        dQ += dS K, times the scale.
// Thread 0 feeds a ring of steps by TMA (no producer warp), as the bf16
// backward does; the walk skips a step whose pairs are all masked and
// masks per element only a step that is not whole (flash_plan32's bounds
// of each 32 positions, tile_kind as the bf16 routes).  A mask writes -inf
// into the scores before the exponentials.  Each step's output product
// goes into a fresh accumulator that is added to the running one in f32:
// the tensor core's own accumulation drifts over thousands of steps.  dK
// and dV accumulate over the group's q heads in registers and dQ over the
// kv tiles: no atomics, the same bits from run to run.
//
// The kernels neither allocate nor synchronize the host.  A wait on a
// barrier that outlasts ~10 s traps (a launch error) instead of hanging.

#pragma once

#include "flash_common.cuh"

namespace {

constexpr int kTf32Rows = 64;     // rows of a CTA: one warpgroup's wgmma M
constexpr int kTf32Cols = 32;     // columns of a step
constexpr int kTf32Threads = 128;
constexpr int kTf32Box = 32;      // f32 columns of a 128-byte swizzle atom
constexpr int kTf32MaxSmem = 232448;

enum Tf32Mode { kTf32Fwd = 0, kTf32Dv = 1, kTf32Dk = 2, kTf32Dq = 3 };

// D padded to a whole number of swizzle atoms: 32, 64 or 128.
__host__ __device__ constexpr int tf32_dp(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : 128; }
__host__ __device__ constexpr int round8(int n) { return (n + 7) & ~7; }
__host__ __device__ constexpr int n32(int n) { return (n + 31) / 32; }

__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// Where the transposed copy keeps sequence index s (see the note above).
__host__ __device__ constexpr int tf32_col_slot(int s) {
  return (s & ~7) | ((s & 1) << 2) | ((s & 7) >> 1);
}

// ------------------------------ the pre-passes ----------------------------

// Each 32 positions' (min, max) over their real entries: the kv tiles'
// first (blocks below n_kt), then the q blocks'.  ref.py::tile_bounds_ref
// at 32 x 32 is its plain version.
__global__ void __launch_bounds__(32)
flash_plan32(const int32_t* __restrict__ qpos, const int32_t* __restrict__ kpos, int Sq, int Sk,
             int n_kt, int32_t* __restrict__ bounds) {
  const bool kv = (int)blockIdx.x < n_kt;
  const int i = (kv ? (int)blockIdx.x : (int)blockIdx.x - n_kt) * 32 + (int)threadIdx.x;
  const int n = kv ? Sk : Sq;
  int lo = INT_MAX, hi = INT_MIN;
  if (i < n) lo = hi = (kv ? kpos : qpos)[i];
  lo = warp_min(lo);
  hi = warp_max(hi);
  if (threadIdx.x == 0) {
    bounds[2 * blockIdx.x] = lo;
    bounds[2 * blockIdx.x + 1] = hi;
  }
}

// hi and lo of x [B, S, H, D] (element strides sb, ss, sh; last dim
// contiguous) into nat [B*H, S, DP] and/or tr [B*H, DP, S8] (either may be
// null).  One 32 x 32 tile of (s, d) a block of 32 x 8 threads, staged in
// shared memory so both copies are written along their contiguous dim.
__global__ void __launch_bounds__(256)
flash_split_tf32(const float* __restrict__ x, long long sb, long long ss, long long sh, int B,
                 int S, int H, int D, int DP, float* nat_hi, float* nat_lo, float* tr_hi,
                 float* tr_lo) {
  __shared__ float tile[32][33];
  const int n_st = n32(S), n_dt = DP / 32;
  const long long blk = blockIdx.x;
  const int st = (int)(blk % n_st), dt = (int)((blk / n_st) % n_dt);
  const int bh = (int)(blk / ((long long)n_st * n_dt));
  const int b = bh / H, h = bh % H;
  const int s0 = st * 32, d0 = dt * 32, tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const float* xb = x + (long long)b * sb + (long long)h * sh;
  for (int r = ty; r < 32; r += 8) {
    const int s = s0 + r, d = d0 + tx;
    const float v = (s < S && d < D) ? xb[(long long)s * ss + d] : 0.f;
    tile[r][tx] = v;
    if (nat_hi != nullptr && s < S) {
      const float hv = tf32_round(v);
      const long long o = ((long long)bh * S + s) * DP + d;
      nat_hi[o] = hv;
      nat_lo[o] = tf32_round(v - hv);
    }
  }
  if (tr_hi == nullptr) return;
  __syncthreads();
  const int S8 = round8(S);
  for (int r = ty; r < 32; r += 8) {
    const int d = d0 + r, s = s0 + tx;
    if (s >= S8) continue;
    const float v = tile[tx][r];
    const float hv = tf32_round(v);
    const long long o = ((long long)bh * DP + d) * S8 + tf32_col_slot(s);
    tr_hi[o] = hv;
    tr_lo[o] = tf32_round(v - hv);
  }
}

// --------------------------------- wgmma ----------------------------------

#define WG_F16(d) WG_F8(d, 0), WG_F8(d, 8)
#define WG_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (+)= A B^T over 64 x 32 x 8: A and B K-major TF32 in shared memory.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " WG_R16 ", %16, %17, p, 1, 1;\n}\n"
      : WG_F16(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B over 64 x N x 8: A the m64k8 TF32 fragment from registers,
// B K-major in shared memory.  accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " WG_R16
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : WG_F16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WG_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : WG_F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (+)= A B^T split three ways over the DP columns of K-major tiles whose
// hi and lo copies lie `a_lo` / `b_lo` bytes after the hi copy, in boxes
// of 32 columns `a_box` / `b_box` bytes apart.  Not fenced or committed.
template <int DP>
__device__ __forceinline__ void split_ss(float (&d)[16], uint32_t a, uint32_t a_box, uint32_t a_lo,
                                         uint32_t b, uint32_t b_box, uint32_t b_lo) {
#pragma unroll
  for (int part = 0; part < 3; ++part) {  // lo hi, hi lo, hi hi
    const uint32_t ap = a + (part == 0 ? a_lo : 0u), bp = b + (part == 1 ? b_lo : 0u);
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
      wgmma_tf32_ss(d, smem_desc(ap + (kk >> 2) * a_box + (kk & 3) * 32, 16, 1024),
                    smem_desc(bp + (kk >> 2) * b_box + (kk & 3) * 32, 16, 1024),
                    part > 0 || kk > 0);
  }
}

// The split A fragments of a 64 x 32 accumulator x (k step j: columns 8j
// .. 8j + 7 in the transposed copy's slot order).
__device__ __forceinline__ void split_fragments(const float (&x)[16], uint32_t (&hi)[4][4],
                                                uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float v[4] = {x[4 * j], x[4 * j + 2], x[4 * j + 1], x[4 * j + 3]};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float h = tf32_round(v[u]);
      hi[j][u] = __float_as_uint(h);
      lo[j][u] = __float_as_uint(tf32_round(v[u] - h));
    }
  }
}

// d = X T over the step's 32 columns, split three ways (d overwritten):
// X's fragments from registers, T the transposed tile (DP rows of 32
// columns) at t, its lo `t_lo` bytes after.  Not fenced or committed.
template <int N>
__device__ __forceinline__ void split_rs(float (&d)[N], const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4], uint32_t t, uint32_t t_lo) {
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_tf32_rs(d, lo[j], smem_desc(t + j * 32, 16, 1024), j > 0);
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_tf32_rs(d, hi[j], smem_desc(t + t_lo + j * 32, 16, 1024), 1);
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_tf32_rs(d, hi[j], smem_desc(t + j * 32, 16, 1024), 1);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// ------------------------------- the kernel -------------------------------

struct Tf32Params {
  void* out;  // fwd: out; dV: dv; dK: dk; dQ: dq (f32, strides below)
  long long o_sb, o_ss, o_sh;
  float* lse;          // fwd: written when non-null; bwd: read, [B, Hq, Sq], natural log
  const float* delta;  // dK, dQ: [B, Hq, Sq]
  const int32_t* qpos;
  const int32_t* kpos;
  const int32_t* kv_b32;  // flash_plan32: (min, max) of each 32 keys
  const int32_t* q_b32;   // then of each 32 q rows
  int B, Sq, Sk, Hq, Hkv, D;
  int window;  // <= 0: no window
  float scale;
};

template <int MODE>
struct Tf32Shape {
  // Persistent A tiles (64 rows) and the score products' B tiles of a
  // step (32 rows): one each for fwd and dV, two for dK and dQ.
  static constexpr int kA = (MODE == kTf32Dk || MODE == kTf32Dq) ? 2 : 1;
  static constexpr bool kRowsQ = MODE == kTf32Fwd || MODE == kTf32Dq;
};

// Dynamic shared memory of one CTA, from a 1024-byte aligned base: the A
// tiles (hi, lo of each; DP/32 boxes of 64 rows), then the ring's stages
// (hi, lo of each score B tile in boxes of 32 rows; hi, lo of the
// transposed tile, one box of DP rows), then the barriers (a_full,
// full[S], empty[S]).  Two stages where they fit, else one.
template <int MODE, int DP>
struct Tf32Smem {
  static constexpr int kA = Tf32Shape<MODE>::kA;
  static constexpr int kACopy = kTf32Rows * DP * 4;  // one copy of one A tile
  static constexpr int kBCopy = kTf32Cols * DP * 4;  // of a B tile (either layout)
  static constexpr int kABytes = 2 * kA * kACopy;
  static constexpr int kStageBytes = 2 * (kA + 1) * kBCopy;
  static constexpr int kFixed = kABytes + 8 * 5 + 1024;
  static constexpr int kStages = kFixed + 2 * kStageBytes <= kTf32MaxSmem ? 2 : 1;
  static constexpr int kBarOffset = kABytes + kStages * kStageBytes;
  static constexpr int kBytes = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kBytes <= kTf32MaxSmem, "a TF32 CTA does not fit in shared memory");
};

// A step of the CTA's walk: fwd/dQ the kv tile `inner` (outer stays 0);
// dV/dK q step `inner` of the group's q head `outer`.  kind: 1 masked per
// element, 2 whole.  outer == n_outer: done.
struct Tf32Walk {
  int outer, inner, kind;
};

template <bool ROWS_Q>
__device__ __forceinline__ void tf32_walk_next(Tf32Walk& w, const Tf32Params& p, int n_outer,
                                               int lo, int hi, bool whole) {
  const int n_inner = n32(ROWS_Q ? p.Sk : p.Sq);
  for (;;) {
    if (++w.inner == n_inner) {
      w.inner = 0;
      if (++w.outer == n_outer) return;
    }
    if (ROWS_Q) {
      const int32_t* kb = p.kv_b32 + 2 * w.inner;
      w.kind = tile_kind(kb[0], kb[1], (w.inner + 1) * kTf32Cols <= p.Sk, lo, hi, p.window);
    } else {
      const int32_t* qb = p.q_b32 + 2 * w.inner;
      w.kind = tile_kind(lo, hi, whole, qb[0], qb[1], p.window);
    }
    if (w.kind) return;
  }
}

// The body of flash_fwd_f32, flash_bwd_dkdv_f32 and flash_bwd_dq_f32.
// Maps: ta0/ta1 the A tiles (natural, boxes of 64 rows), tb0/tb1 the score
// B tiles (natural, 32 rows), tt the transposed tile (32 columns x DP).
template <int MODE, int DP, bool LSE>
__device__ __forceinline__ void tf32_body(const CUtensorMap* ta0, const CUtensorMap* ta1,
                                          const CUtensorMap* tb0, const CUtensorMap* tb1,
                                          const CUtensorMap* tt, const Tf32Params& p) {
  using L = Tf32Smem<MODE, DP>;
  constexpr int KA = L::kA, S = L::kStages, NB = DP / kTf32Box;
  constexpr bool ROWS_Q = Tf32Shape<MODE>::kRowsQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t a_full = base + L::kBarOffset;
  const uint32_t full0 = a_full + 8, empty0 = a_full + 8 * (1 + S);

  // The CTA's 64 rows: q rows of head h (fwd, dQ: heaviest q block first)
  // or keys of kv head hk (dV, dK: kv tile 0, the most q steps, first).
  const int g = p.Hq / p.Hkv;
  const int BH = ROWS_Q ? p.B * p.Hq : p.B * p.Hkv;  // also the planes of the A maps
  const int n_rows = ROWS_Q ? p.Sq : p.Sk;
  const int n_rb = (n_rows + kTf32Rows - 1) / kTf32Rows;
  const int rb = ROWS_Q ? n_rb - 1 - (int)(blockIdx.x / (unsigned)BH)
                        : (int)(blockIdx.x / (unsigned)BH);
  const int bh = (int)(blockIdx.x % (unsigned)BH);
  const int b = ROWS_Q ? bh / p.Hq : bh / p.Hkv;
  const int h = ROWS_Q ? bh % p.Hq : -1;  // the q head (fwd, dQ)
  const int hk = ROWS_Q ? h / g : bh % p.Hkv;
  const int row0 = rb * kTf32Rows;
  // Bounds of the 64 rows from their two 32-position blocks.
  const int32_t* rbnd = (ROWS_Q ? p.q_b32 : p.kv_b32) + 4 * rb;
  const bool two = row0 + 32 < n_rows;
  const int rlo = two ? min(rbnd[0], rbnd[2]) : rbnd[0];
  const int rhi = two ? max(rbnd[1], rbnd[3]) : rbnd[1];
  const bool rwhole = row0 + kTf32Rows <= n_rows;
  const int n_outer = ROWS_Q ? 1 : g;

  if (threadIdx.x == 0) {
    mbar_init(a_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kTf32Threads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  Tf32Walk w{0, -1, 0};
  tf32_walk_next<ROWS_Q>(w, p, n_outer, rlo, rhi, rwhole);
  Tf32Walk pw = w;
  int ps = 0, issued = 0;
  uint32_t pph = 0;
  // Every map spans a copy's hi planes [0, B*H) and then its lo planes
  // [B*H, 2 B*H) (hi and lo are adjacent in the scratch).  The A tiles are
  // the CTA's rows of its head bh.
  if (threadIdx.x == 0) {
    mbar_expect_tx(a_full, L::kABytes);
#pragma unroll
    for (int a = 0; a < KA; ++a) {
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        const CUtensorMap* m = a == 0 ? ta0 : ta1;
        const uint32_t dst = base + 2 * a * L::kACopy + c * (kTf32Rows * 128);
        tma_load_3d(dst, m, a_full, c * kTf32Box, row0, bh);
        tma_load_3d(dst + L::kACopy, m, a_full, c * kTf32Box, row0, bh + BH);
      }
    }
  }

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  // This thread's rows: r0 and r0 + 8 (the accumulators' rows).
  const int r0 = row0 + 16 * warp + g8, r1 = r0 + 8;
  const int* rpos = ROWS_Q ? p.qpos : p.kpos;
  const int* cpos = ROWS_Q ? p.kpos : p.qpos;
  const int rp0 = r0 < n_rows ? rpos[r0] : (ROWS_Q ? INT_MIN : INT_MAX);
  const int rp1 = r1 < n_rows ? rpos[r1] : (ROWS_Q ? INT_MIN : INT_MAX);
  const int n_cols = ROWS_Q ? p.Sk : p.Sq;
  const float c = p.scale * kLog2e;
  // dQ: each row's lse2 and delta (+inf and 0 past Sq).
  float rl0 = 0.f, rl1 = 0.f, rd0 = 0.f, rd1 = 0.f;
  if (MODE == kTf32Dq) {
    const long long rowb = ((long long)b * p.Hq + h) * p.Sq;
    rl0 = r0 < p.Sq ? p.lse[rowb + r0] * kLog2e : INFINITY;
    rl1 = r1 < p.Sq ? p.lse[rowb + r1] * kLog2e : INFINITY;
    rd0 = r0 < p.Sq ? p.delta[rowb + r0] : 0.f;
    rd1 = r1 < p.Sq ? p.delta[rowb + r1] : 0.f;
  }

  // acc: the output over the steps so far; part: one step's product.  The
  // tensor core's accumulation does not round to nearest, so a sum over
  // thousands of wgmma steps drifts (past the f32 limits at 4,096 keys):
  // each step's 12 products go into part, and acc takes it with one f32
  // add, rounded to nearest.
  float acc[DP / 2], part[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = part[i] = 0.f;
  float s[16], dp[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // fwd

  // This warpgroup's A tiles: all 64 rows, boxes of 64 rows.
  const uint32_t a0 = base, a1 = base + 2 * L::kACopy;
  const uint32_t ring = base + L::kABytes;
  mbar_wait(a_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int step = 0; w.outer < n_outer; ++step) {
    // Thread 0 fills the ring: S steps at first, then, before step i, step
    // S + i - 1 into the stage step i - 1 released.
    if (threadIdx.x == 0) {
      while (pw.outer < n_outer && issued < S + step) {
        const uint32_t full = full0 + 8 * ps;
        const uint32_t dst = ring + ps * L::kStageBytes;
        const int col0 = pw.inner * kTf32Cols;
        // The step's head in the B maps: the kv head (fwd, dQ) or the q
        // head of the group (dV, dK).
        const int bhead = ROWS_Q ? b * p.Hkv + hk : b * p.Hq + hk * g + pw.outer;
        const int bplanes = ROWS_Q ? p.B * p.Hkv : p.B * p.Hq;
        mbar_wait(empty0 + 8 * ps, pph ^ 1);
        mbar_expect_tx(full, L::kStageBytes);
#pragma unroll
        for (int a = 0; a < KA; ++a) {
          const CUtensorMap* m = a == 0 ? tb0 : tb1;
#pragma unroll
          for (int cc = 0; cc < NB; ++cc) {
            const uint32_t d = dst + 2 * a * L::kBCopy + cc * (kTf32Cols * 128);
            tma_load_3d(d, m, full, cc * kTf32Box, col0, bhead);
            tma_load_3d(d + L::kBCopy, m, full, cc * kTf32Box, col0, bhead + bplanes);
          }
        }
        const uint32_t td = dst + 2 * KA * L::kBCopy;
        tma_load_3d(td, tt, full, col0, 0, bhead);
        tma_load_3d(td + L::kBCopy, tt, full, col0, 0, bhead + bplanes);
        tf32_walk_next<ROWS_Q>(pw, p, n_outer, rlo, rhi, rwhole);
        ++issued;
        if (++ps == S) {
          ps = 0;
          pph ^= 1;
        }
      }
    }
    const int col0 = w.inner * kTf32Cols;
    const bool masked = w.kind != 2;
    float sc0 = 1.f, sc1 = 1.f;  // fwd: the rows' rescaling of acc
    const uint32_t sb = ring + stage * L::kStageBytes;
    const uint32_t b0 = sb, b1 = sb + 2 * L::kBCopy, tt_addr = sb + 2 * KA * L::kBCopy;
    // dV, dK: the step's q head and its rows' lse2 / delta per column.
    const int hq = hk * g + w.outer;
    const long long colb = ((long long)b * p.Hq + hq) * p.Sq;
    mbar_wait(full0 + 8 * stage, phase);

    // The score products: S (= Q K^T, or S^T = K Q^T), and dP (dK, dQ) as
    // a second group, so the exponentials run while it does.
    reg_fence(s);
    wgmma_fence();
    split_ss<DP>(s, a0, kTf32Rows * 128, L::kACopy, b0, kTf32Cols * 128, L::kBCopy);
    wgmma_commit();
    if (KA == 2) {
      reg_fence(dp);
      split_ss<DP>(dp, a1, kTf32Rows * 128, L::kACopy, b1, kTf32Cols * 128, L::kBCopy);
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    reg_fence(s);

    // Element e of n8 chunk j: row r0 (e < 2) or r1, column col0 + 8j +
    // 2*t4 + (e & 1).  A masked step first sets the scores to -inf where
    // the pair is not allowed.
    if (masked) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * j + 2 * t4 + e;
          const int cp = col < n_cols ? __ldg(cpos + col) : (ROWS_Q ? INT_MAX : INT_MIN);
          const bool ok0 = ROWS_Q ? allowed(rp0, cp, p.window) : allowed(cp, rp0, p.window);
          const bool ok1 = ROWS_Q ? allowed(rp1, cp, p.window) : allowed(cp, rp1, p.window);
          if (!ok0) s[4 * j + e] = -INFINITY;
          if (!ok1) s[4 * j + 2 + e] = -INFINITY;
        }
      }
    }

    if (MODE == kTf32Fwd) {
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // m in base 2 (scores times scale * log2(e)); no allowed key yet: p = 0.
      const float n0 = fmaxf(m0, mx0 * c), n1 = fmaxf(m1, mx1 * c);
      const float mu0 = n0 == -INFINITY ? 0.f : n0, mu1 = n1 == -INFINITY ? 0.f : n1;
      const float alpha0 = exp2f(m0 - mu0), alpha1 = exp2f(m1 - mu1);
      m0 = n0;
      m1 = n1;
      l0 *= alpha0;
      l1 *= alpha1;
      sc0 = alpha0;
      sc1 = alpha1;
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = exp2f(fmaf(s[i], c, (i & 2) ? -mu1 : -mu0));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        l0 += s[4 * j] + s[4 * j + 1];
        l1 += s[4 * j + 2] + s[4 * j + 3];
      }
    } else if (MODE == kTf32Dq) {
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = exp2f(fmaf(s[i], c, (i & 2) ? -rl1 : -rl0));
    } else {  // dV, dK: lse2 of each column (q row), +inf past Sq
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * j + 2 * t4 + e;
          const float l2 = col < p.Sq ? __ldg(p.lse + colb + col) * kLog2e : INFINITY;
          s[4 * j + e] = exp2f(fmaf(s[4 * j + e], c, -l2));
          s[4 * j + 2 + e] = exp2f(fmaf(s[4 * j + 2 + e], c, -l2));
        }
      }
    }
    if (KA == 2) {  // dS = P (dP - delta): delta per row (dQ) or column (dK)
      wgmma_wait<0>();
      reg_fence(dp);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float d0 = rd0, d1 = rd1;
          if (MODE == kTf32Dk) {
            const int col = col0 + 8 * j + 2 * t4 + e;
            d0 = d1 = col < p.Sq ? __ldg(p.delta + colb + col) : 0.f;
          }
          s[4 * j + e] *= dp[4 * j + e] - d0;
          s[4 * j + 2 + e] *= dp[4 * j + 2 + e] - d1;
        }
      }
    }

    // The output product: part = X T, X = P (fwd, dV) or dS (dK, dQ) split
    // into fragments, T the step's transposed tile; then acc = acc * alpha
    // + part (alpha: the forward's rescaling sc0/sc1, else 1).
    uint32_t xh[4][4], xl[4][4];
    split_fragments(s, xh, xl);
    reg_fence(part);
    wgmma_fence();
    split_rs(part, xh, xl, tt_addr, L::kBCopy);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(part);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[4 * j] = fmaf(acc[4 * j], sc0, part[4 * j]);
      acc[4 * j + 1] = fmaf(acc[4 * j + 1], sc0, part[4 * j + 1]);
      acc[4 * j + 2] = fmaf(acc[4 * j + 2], sc1, part[4 * j + 2]);
      acc[4 * j + 3] = fmaf(acc[4 * j + 3], sc1, part[4 * j + 3]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);
    tf32_walk_next<ROWS_Q>(w, p, n_outer, rlo, rhi, rwhole);
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }

  // Epilogue: acc's element (r0 or r1, column 8j + 2*t4 + e).
  float f0 = 1.f, f1 = 1.f;
  if (MODE == kTf32Fwd) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    f0 = 1.f / fmaxf(l0, 1e-30f);
    f1 = 1.f / fmaxf(l1, 1e-30f);
    if (LSE && t4 == 0) {  // natural log: (m + log2 l) ln 2; +inf for a row with no key
      float* lg = p.lse + ((long long)b * p.Hq + h) * p.Sq;
      if (r0 < p.Sq) lg[r0] = l0 > 0.f ? (m0 + log2f(l0)) * kLn2 : INFINITY;
      if (r1 < p.Sq) lg[r1] = l1 > 0.f ? (m1 + log2f(l1)) * kLn2 : INFINITY;
    }
  } else if (MODE != kTf32Dv) {
    f0 = f1 = p.scale;
  }
  float* og = (float*)p.out + (long long)b * p.o_sb + (long long)(ROWS_Q ? h : hk) * p.o_sh;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * t4 + e;
      if (col >= p.D) continue;
      if (r0 < n_rows) og[(long long)r0 * p.o_ss + col] = acc[4 * j + e] * f0;
      if (r1 < n_rows) og[(long long)r1 * p.o_ss + col] = acc[4 * j + 2 + e] * f1;
    }
  }
}

// ------------------------------- host side --------------------------------

// The scratch of the f32 route, carved in this order from one allocation
// (each part rounded up to 256 bytes; ops.py::f32_scratch_bytes mirrors
// it): flash_plan32's bounds, then each copy, its hi and lo adjacent.  Forward: Q, K
// natural, V transposed.  Backward: Q natural and transposed, dO natural
// and transposed, K natural and transposed, V natural.
struct Tf32Scratch {
  char* ptr;
  long long used;
  template <typename T>
  T* take(long long bytes) {
    T* out = ptr == nullptr ? nullptr : reinterpret_cast<T*>(ptr + used);
    used += (bytes + 255) / 256 * 256;
    return out;
  }
};

// One copy of `floats` values: hi, then lo right after it (one part), so a
// tensor map of 2 B*H planes spans both.
inline float* take_copy(Tf32Scratch& s, long long floats) { return s.take<float>(8 * floats); }

// The tensor map of a scratch copy: `planes` planes (hi, then lo) of
// `rows` rows of `inner` f32 values, boxes of 32 values x `box_rows` rows,
// 128-byte swizzle, zeros outside.
int encode_f32(CUtensorMap* map, const float* ptr, int inner, int rows, int planes, int box_rows) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return kTensorMapError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 4, (cuuint64_t)inner * rows * 4};
  const cuuint32_t box[3] = {kTf32Box, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

int launch_plan32(const int32_t* qpos, const int32_t* kpos, int Sq, int Sk, int32_t* bounds,
                  cudaStream_t stream) {
  flash_plan32<<<n32(Sk) + n32(Sq), 32, 0, stream>>>(qpos, kpos, Sq, Sk, n32(Sk), bounds);
  return (int)cudaGetLastError();
}

// Splits x [B, S, H, D] into nat (hi, then lo: 2 B*H planes of S x DP)
// and/or tr (2 B*H planes of DP x S8).
template <int DP>
int launch_split(const float* x, long long sb, long long ss, long long sh, int B, int S, int H,
                 int D, float* nat, float* tr, cudaStream_t stream) {
  const long long blocks = (long long)n32(S) * (DP / 32) * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const long long nat_plane = (long long)B * H * S * DP, tr_plane = (long long)B * H * DP * round8(S);
  flash_split_tf32<<<(unsigned)blocks, 256, 0, stream>>>(
      x, sb, ss, sh, B, S, H, D, DP, nat, nat == nullptr ? nullptr : nat + nat_plane, tr,
      tr == nullptr ? nullptr : tr + tr_plane);
  return (int)cudaGetLastError();
}

template <int MODE, int DP, typename Kernel>
int launch_tf32(Kernel kernel, const CUtensorMap& a0, const CUtensorMap& a1, const CUtensorMap& b0,
                const CUtensorMap& b1, const CUtensorMap& t, const Tf32Params& p, long long ctas,
                cudaStream_t stream) {
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;  // gridDim.x's limit
  const int smem = Tf32Smem<MODE, DP>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)ctas, kTf32Threads, smem, stream>>>(a0, a1, b0, b1, t, p);
  return (int)cudaGetLastError();
}

}  // namespace
