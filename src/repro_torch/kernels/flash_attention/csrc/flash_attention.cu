// Causal (optionally sliding-window) GQA flash attention forward, Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::
// flash_attention_fwd_pallas (the body _flash_kernel).  The TPU kernel runs
// a (batch*q_head, q_block, kv_block) grid with the kv axis sequential, keeps
// the q block and the running (m, l, acc) in VMEM scratch across it, and
// finalizes acc / l on the last kv step.  Its wrapper pads Sq and Sk to the
// block size and materializes K and V repeated per query head
// (ops.py::_to_flat_heads, jnp.repeat), and every (q, kv) block pair takes a
// grid step even when the mask removes all of it.
//
//   s = q . k / sqrt(D) in f32; allowed where kpos <= qpos (and, with a
//   window W, kpos > qpos - W); p = exp(s - m) online over the kv tiles;
//   out = acc / max(l, 1e-30), in the input dtype.
//
// Bound: operations.  At the main path's shape (B=1, S=8192, 24 q heads, 8
// kv heads, D=128, bf16) the allowed pairs are S(S+1)/2 = 33.6M per head,
// 4*D FLOPs each (two products), 4.12e11 FLOPs: 0.417 ms at the 989 TFLOP/s
// bf16 tensor-core peak.  The bytes (q, k, v, out: 134 MB) take 0.040 ms at
// 3.35 TB/s.  The S^2 score matrix never reaches device memory.
//
// Design against that bound (bf16).  On an NVIDIA H100 80GB HBM3 at its
// 700 W limit it takes 0.82-0.87 ms at the main path's shape (48-51% of the
// bound; 1.15x the time of scaled_dot_product_attention in the same runs)
// and 11.4-12.3 ms at S=32768 (PERF.md, chip_smoke.py):
// * Two launches on the caller's stream.  flash_plan reduces each 128-key
//   tile's and each 128-row q block's positions to their min and max (over
//   real entries) into a scratch the wrapper allocates.  From these bounds
//   a kv tile is skipped (every pair masked), full (every pair allowed, no
//   ragged edge: no per-element mask) or mixed, without assuming that
//   pos == arange.  Causal masking then halves the work and a window bounds
//   it by the window.
// * flash_fwd_bf16: one CTA per (128-row q block, batch*q head), heaviest q
//   blocks first over one linear grid (so B*Hq is not held to gridDim.y's
//   65,535).  384 threads: a producer warpgroup and two consumer
//   warpgroups of 64 q rows each; setmaxnreg moves registers from the
//   producer (40; at 24 its loop spilled) to the consumers (232).  Each
//   consumer runs S, softmax, P V in turn; the two consumers' turns
//   interleave on the tensor cores.  (Issuing the next tile's S beside
//   this tile's P V, FA3's in-warpgroup overlap, keeps o, s and p live at
//   once; ptxas did not give the consumers more than the kernel's 168
//   registers for it, and those builds spilled and ran slower: PERF.md.)
// * The producer's first warp classifies the tiles from the bounds (32 at a
//   time, by ballot) and, for each tile it keeps, waits for a free stage of
//   a 2-deep ring in dynamic shared memory, writes the tile's index and
//   kind beside it and has TMA load K and V there (mbarrier full/empty
//   pairs): loads stay in flight while the consumers compute.  An end
//   marker in the ring stops the consumers, so both sides walk one list.
// * TMA reads q, k and v through their [B, S, H, D] strides (a 4-d tensor
//   map each, dims (D, H, S, B), encoded on the host per call): the kv head
//   is q_head / (Hq / Hkv), so there is no transpose and no repeat of K/V.
//   Rows past S and columns past D arrive as zeros (TMA's out-of-bounds
//   fill): no padding copy.  Boxes are 64 columns (128 bytes, the 128-byte
//   swizzle) by 128 rows; a head dim <= 64 is padded to DP = 64 columns,
//   any other to DP = 128 (two boxes), by the zero fill.
// * S = Q K^T: wgmma m64n128k16 with Q and K both K-major in shared memory
//   (descriptors, 128-byte swizzle).  O += P V: wgmma m64n{DP}k16 with P
//   from registers (the S accumulator's layout is the A fragment's) and V
//   read MN-major from shared memory (the transpose flag): V is never
//   copied or transposed.
// * Online softmax in base 2: scale * log2(e) folded into one FMA before
//   exp2.  Masked scores are -inf, and a row that has seen no allowed key
//   yet keeps m = -inf and adds p = 0: the reference's -2e38 sentinel
//   instead piles up exp(0) = 1 in such a row until a real score wipes it
//   with alpha = 0.  Every row with an allowed key gets the same output
//   either way; a row with none (only padding on the model's paths) gets 0.
//   p is rounded to bf16 for P V as the reference does (p.astype(v.dtype));
//   l sums p in f32.
// * f32 keeps the first design: scalar FMA, 4 threads per q row, 32 x 32
//   tiles staged by every thread, each warp classifying its tiles.
//
// The kernels neither allocate nor synchronize the host.  A wait on a
// barrier that outlasts ~10 s traps (a launch error) instead of hanging.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int32_t* qpos;
  const int32_t* kpos;
  int B, Sq, Sk, Hq, Hkv, D;
  long long q_sb, q_ss, q_sh;  // strides in elements: batch, seq, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int window;  // <= 0: no window
  float scale;
};

constexpr int kThreads = 128;

__device__ __forceinline__ int warp_min(int x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The q block's min and max position over its real rows [q0, q0 + rows).
__device__ __forceinline__ void block_q_bounds(const Params& p, int q0, int rows,
                                               int* s_bounds, int& qmin, int& qmax) {
  if (threadIdx.x == 0) {
    s_bounds[0] = INT_MAX;
    s_bounds[1] = INT_MIN;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int pos = p.qpos[q0 + r];
    atomicMin(&s_bounds[0], pos);
    atomicMax(&s_bounds[1], pos);
  }
  __syncthreads();
  qmin = s_bounds[0];
  qmax = s_bounds[1];
}

// The kind of a kv tile whose real keys' positions lie in [kmin, kmax],
// against a q block whose real rows' positions lie in [qmin, qmax].  0:
// every pair masked (skip); 1: some pairs masked (mask per element); 2:
// every pair allowed and no ragged edge (`whole`: the tile has no key past
// Sk).  ref.py::tile_plan_ref is its plain version.
__device__ __forceinline__ int tile_kind(int kmin, int kmax, bool whole, int qmin, int qmax,
                                         int window) {
  const long long w = window;
  if (kmin > qmax) return 0;  // causal: every key after every query
  if (w > 0 && (long long)kmax <= (long long)qmin - w) return 0;  // all too old
  const bool full = kmax <= qmin && (w <= 0 || (long long)kmin > (long long)qmax - w) && whole;
  return full ? 2 : 1;
}

// Classifies kv tile [k0, k0 + tile) against the q block, from the tile's own
// positions (every warp computes the same answer).
__device__ __forceinline__ int classify_tile(const Params& p, int k0, int tile, int qmin,
                                             int qmax) {
  const int lane = threadIdx.x & 31;
  int lo = INT_MAX, hi = INT_MIN;
  for (int i = lane; i < tile; i += 32) {
    if (k0 + i < p.Sk) {
      const int pos = p.kpos[k0 + i];
      lo = min(lo, pos);
      hi = max(hi, pos);
    }
  }
  return tile_kind(warp_min(lo), warp_max(hi), k0 + tile <= p.Sk, qmin, qmax, p.window);
}

__device__ __forceinline__ bool allowed(int qp, int kp, int window) {
  return kp <= qp && (window <= 0 || (long long)kp > (long long)qp - window);
}

// ------------------------------ the plan --------------------------------

constexpr int kBQ = 128;   // q rows per bf16 CTA (64 per consumer warpgroup)
constexpr int kBKV = 128;  // keys per bf16 kv tile
static_assert(kBQ == kBKV, "flash_plan reduces one q block or kv tile per 128-thread block");

// Block i < n_kt: kv tile i; block n_kt + j: q block j.  Writes (min, max)
// of the block's real positions to bounds[2i], bounds[2i + 1]: the kv
// tiles' first, then the q blocks'.  ref.py::tile_bounds_ref is its plain
// version.
__global__ void __launch_bounds__(kBKV)
flash_plan(const int32_t* __restrict__ qpos, const int32_t* __restrict__ kpos, int Sq, int Sk,
           int n_kt, int32_t* __restrict__ bounds) {
  __shared__ int s_lo[kBKV / 32], s_hi[kBKV / 32];
  const bool kv = (int)blockIdx.x < n_kt;
  const int i = (kv ? (int)blockIdx.x : (int)blockIdx.x - n_kt) * kBKV + (int)threadIdx.x;
  const int n = kv ? Sk : Sq;
  int lo = INT_MAX, hi = INT_MIN;
  if (i < n) lo = hi = (kv ? kpos : qpos)[i];
  lo = warp_min(lo);
  hi = warp_max(hi);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kBKV / 32; ++w) {
      lo = min(lo, s_lo[w]);
      hi = max(hi, s_hi[w]);
    }
    bounds[2 * blockIdx.x] = lo;
    bounds[2 * blockIdx.x + 1] = hi;
  }
}

// ------------------------------- bf16 ----------------------------------

constexpr int kStages = 2;          // kv ring depth
constexpr int kBf16Threads = 384;   // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kBoxCols = 64;        // one 128-byte swizzle atom of bf16
constexpr int kBoxBytes = 128 * 128;  // a 128-row box of 64 columns

// Dynamic shared memory of one CTA, from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 8 rows of 128 bytes).  Q: DP/64 boxes of
// 128 rows; each stage: K's DP/64 boxes, then V's; then the barriers.
template <int DP>
struct Bf16Smem {
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kTileBytes = kBKV * DP * 2;
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  // q_full, full[kStages], empty[kStages] (8 bytes each), info[kStages].
  static constexpr int kBytes = kBarOffset + 8 * (1 + 2 * kStages) + 4 * kStages + 1024;
};

struct Bf16Params {
  void* out;
  const int32_t* qpos;
  const int32_t* kpos;
  const int32_t* kv_bounds;  // flash_plan's output: (min, max) per kv tile
  const int32_t* q_bounds;   // then per q block
  int B, Sq, Sk, Hq, Hkv, D;
  long long o_sb, o_ss, o_sh;
  int window;
  float scale_log2;  // the reference's scale times log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits for the phase of `bar` with this parity to complete.  Traps after
// ~10 s (2e10 cycles): a lost arrival then fails the launch, not the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = -1;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) start = now;
    if (now - start > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// A wgmma shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers across
// the asynchronous instructions (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WG_F8(d, i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),           \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_F32(d) WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16), WG_F8(d, 24)
#define WG_F64(d) WG_F32(d), WG_F8(d, 32), WG_F8(d, 40), WG_F8(d, 48), WG_F8(d, 56)
#define WG_R32                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_R64                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= A B^T over 64 rows x 128 columns x 16: A and B both K-major in
// shared memory.  accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_F64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B over 64 rows x N columns x 16: A from registers (the m64k16
// fragment), B MN-major in shared memory (transpose flag set).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo, the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// DP: D padded to 64 or 128 columns (TMA's zero fill supplies the rest).
template <int DP>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const Bf16Params p) {
  using L = Bf16Smem<DP>;
  constexpr int NB = DP / kBoxCols;  // boxes per row block
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBarOffset;
  const uint32_t full0 = q_full + 8, empty0 = q_full + 8 * (1 + kStages);
  volatile int* info = reinterpret_cast<volatile int*>(smem_raw + (base - raw) + L::kBarOffset +
                                                       8 * (1 + 2 * kStages));

  const int BH = p.B * p.Hq;
  const int n_qb = (p.Sq + kBQ - 1) / kBQ;
  const int qb = n_qb - 1 - (int)(blockIdx.x / (unsigned)BH);  // most work first
  const int bh = (int)(blockIdx.x % (unsigned)BH);
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qb * kBQ;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: its first warp walks the tiles ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    const int qmin = p.q_bounds[2 * qb], qmax = p.q_bounds[2 * qb + 1];
    if (lane == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int c = 0; c < NB; ++c) tma_load_4d(base + c * kBoxBytes, &tq, q_full, c * kBoxCols, h, q0, b);
    }
    const int n_kt = (p.Sk + kBKV - 1) / kBKV;
    int stage = 0;
    uint32_t phase = 0;
    for (int t0 = 0; t0 < n_kt; t0 += 32) {
      const int kt = t0 + lane;
      int kind = 0;
      if (kt < n_kt)
        kind = tile_kind(p.kv_bounds[2 * kt], p.kv_bounds[2 * kt + 1], (kt + 1) * kBKV <= p.Sk,
                         qmin, qmax, p.window);
      uint32_t live = __ballot_sync(0xffffffffu, kind != 0);
      const uint32_t whole = __ballot_sync(0xffffffffu, kind == 2);
      while (live) {
        const int i = __ffs(live) - 1;
        live &= live - 1;
        if (lane == 0) {
          const uint32_t full = full0 + 8 * stage;
          const uint32_t k_dst = base + L::kQBytes + stage * L::kTileBytes;
          const uint32_t v_dst = base + L::kQBytes + (kStages + stage) * L::kTileBytes;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          info[stage] = ((t0 + i) << 1) | ((whole >> i) & 1);
          mbar_expect_tx(full, 2 * L::kTileBytes);
#pragma unroll
          for (int c = 0; c < NB; ++c) {
            tma_load_4d(k_dst + c * kBoxBytes, &tk, full, c * kBoxCols, hk, (t0 + i) * kBKV, b);
            tma_load_4d(v_dst + c * kBoxBytes, &tv, full, c * kBoxCols, hk, (t0 + i) * kBKV, b);
          }
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    if (lane == 0) {  // the end marker
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      info[stage] = -1;
      mbar_arrive(full0 + 8 * stage);
    }
  } else {
    // ---- two consumer warpgroups, 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = (threadIdx.x >> 7) - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    // This thread's rows: r0 and r0 + 8 (the wgmma accumulator's layout).
    const int r0 = q0 + 64 * cw + 16 * warp + g, r1 = r0 + 8;
    const int qp0 = r0 < p.Sq ? p.qpos[r0] : INT_MIN;
    const int qp1 = r1 < p.Sq ? p.qpos[r1] : INT_MIN;
    const float c = p.scale_log2;

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float s[kBKV / 2];
#pragma unroll
    for (int i = 0; i < kBKV / 2; ++i) s[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    // Q rows of this warpgroup: 64 rows into each box (8 KB).
    const uint32_t q_addr = base + cw * 64 * 128;
    mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (;;) {
      mbar_wait(full0 + 8 * stage, phase);
      const int tinfo = info[stage];
      if (tinfo < 0) break;
      const int k0 = (tinfo >> 1) * kBKV;
      const uint32_t k_addr = base + L::kQBytes + stage * L::kTileBytes;
      const uint32_t v_addr = base + L::kQBytes + (kStages + stage) * L::kTileBytes;

      // S = Q K^T: 16 columns of d a step, 4 steps per 64-column box.
      reg_fence(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
        wgmma_ss_n128(s, smem_desc(q_addr + off, 16, 1024), smem_desc(k_addr + off, 16, 1024),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(s);

      // Element e of n8 chunk j: row r0 (e < 2) or r1, key k0 + 8j + 2*t4 + (e & 1).
      if (!(tinfo & 1)) {
#pragma unroll
        for (int j = 0; j < kBKV / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + 2 * t4 + e;
            const int kp = key < p.Sk ? __ldg(p.kpos + key) : INT_MAX;
            if (!allowed(qp0, kp, p.window)) s[4 * j + e] = -INFINITY;
            if (!allowed(qp1, kp, p.window)) s[4 * j + 2 + e] = -INFINITY;
          }
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j) {
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
      // P as the A fragments of P V: keys 16kk..16kk+15 are chunks 2kk, 2kk + 1.
      uint32_t pa[kBKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
        float e[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) e[u] = exp2f(fmaf(s[8 * kk + u], c, (u & 2) ? -mu1 : -mu0));
        l0 += e[0] + e[1] + e[4] + e[5];
        l1 += e[2] + e[3] + e[6] + e[7];
        pa[kk][0] = pack_bf16(e[0], e[1]);
        pa[kk][1] = pack_bf16(e[2], e[3]);
        pa[kk][2] = pack_bf16(e[4], e[5]);
        pa[kk][3] = pack_bf16(e[6], e[7]);
      }
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[4 * j] *= alpha0;
        o[4 * j + 1] *= alpha0;
        o[4 * j + 2] *= alpha1;
        o[4 * j + 3] *= alpha1;
      }

      // O += P V: 16 keys a step (two 8-row swizzle groups of 1024 bytes);
      // V's 64-column boxes are kBoxBytes apart (the leading byte offset).
      reg_fence(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk)
        wgmma_rs(o, pa[kk], smem_desc(v_addr + kk * 2048, kBoxBytes, 1024));
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // Finalize: the row sum over the 4 threads of the row, then acc / l.
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    __nv_bfloat16* og = (__nv_bfloat16*)p.out + (long long)b * p.o_sb + (long long)h * p.o_sh;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col >= p.D) continue;
      if (r0 < p.Sq)
        *reinterpret_cast<uint32_t*>(og + (long long)r0 * p.o_ss + col) =
            pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (r1 < p.Sq)
        *reinterpret_cast<uint32_t*>(og + (long long)r1 * p.o_ss + col) =
            pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

// ------------------------------- f32 -----------------------------------

// DP: D rounded up to a multiple of 16.  Thread (row, c) of the 4 threads of
// a q row holds the columns d = c + 4*i.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const Params p) {
  constexpr int BQ = 32, BKV = 32, NC = DP / 4;
  __shared__ float Ks[BKV * DP];
  __shared__ float Vs[BKV * DP];
  __shared__ int Kp[BKV];
  __shared__ int s_bounds[2];

  const int n_qb = (p.Sq + BQ - 1) / BQ;
  const int q0 = (n_qb - 1 - (int)(blockIdx.x % n_qb)) * BQ;
  const int bh = blockIdx.x / n_qb;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x;
  const int r = q0 + tid / 4, c = tid % 4;

  const float* qg = (const float*)p.q + (long long)b * p.q_sb + (long long)h * p.q_sh;
  const float* kg = (const float*)p.k + (long long)b * p.k_sb + (long long)hk * p.k_sh;
  const float* vg = (const float*)p.v + (long long)b * p.v_sb + (long long)hk * p.v_sh;

  int qmin, qmax;
  block_q_bounds(p, q0, min(BQ, p.Sq - q0), s_bounds, qmin, qmax);
  const int qp = r < p.Sq ? p.qpos[r] : INT_MIN;

  float qv[NC], acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int d = c + 4 * i;
    qv[i] = (r < p.Sq && d < p.D) ? qg[(long long)r * p.q_ss + d] : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int n_kt = (p.Sk + BKV - 1) / BKV;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BKV;
    const int kind = classify_tile(p, k0, BKV, qmin, qmax);
    if (kind == 0) continue;
    for (int u = tid; u < BKV * DP; u += kThreads) {
      const int key = u / DP, d = u % DP;
      const bool in = k0 + key < p.Sk && d < p.D;
      Ks[u] = in ? kg[(long long)(k0 + key) * p.k_ss + d] : 0.f;
      Vs[u] = in ? vg[(long long)(k0 + key) * p.v_ss + d] : 0.f;
    }
    if (tid < BKV) Kp[tid] = k0 + tid < p.Sk ? p.kpos[k0 + tid] : INT_MAX;
    __syncthreads();

    float s[BKV];
    float mx = -INFINITY;
#pragma unroll
    for (int kk = 0; kk < BKV; ++kk) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) part = fmaf(qv[i], Ks[kk * DP + c + 4 * i], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      float x = part * p.scale;
      if (kind == 1 && (k0 + kk >= p.Sk || !allowed(qp, Kp[kk], p.window))) x = -INFINITY;
      s[kk] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m, mx);
    const float mu = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(m - mu);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[i] *= alpha;
#pragma unroll
    for (int kk = 0; kk < BKV; ++kk) {
      const float pe = expf(s[kk] - mu);
      l += pe;
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[i] = fmaf(pe, Vs[kk * DP + c + 4 * i], acc[i]);
    }
    __syncthreads();
  }

  if (r < p.Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* og = (float*)p.out + (long long)b * p.o_sb + (long long)h * p.o_sh +
                (long long)r * p.o_ss;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int d = c + 4 * i;
      if (d < p.D) og[d] = acc[i] * inv;
    }
  }
}


template <int DP>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const long long ctas = (long long)((p.Sq + 31) / 32) * p.B * p.Hq;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;  // gridDim.x's limit
  flash_fwd_f32<DP><<<(unsigned)ctas, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------- bf16 host side -----------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library links against nothing but the CUDA runtime.
EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)ptr;
  }
  return fn;
}

// Error codes of the entry points: a cudaError_t, or kTensorMapError plus
// the CUresult of a tensor map that could not be encoded.
constexpr int kTensorMapError = 1000;

// The tensor map of a [B, S, H, D] bf16 tensor with element strides (sb, ss,
// sh) and a contiguous last dim: dims (D, H, S, B), boxes of 64 columns x 1
// head x 128 rows x 1 batch, 128-byte swizzle, zeros outside the tensor.
int encode(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, long long sb,
           long long ss, long long sh) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return kTensorMapError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, kBKV, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

int n_tiles(int n) { return (n + kBKV - 1) / kBKV; }

int launch_plan(const int32_t* qpos, const int32_t* kpos, int Sq, int Sk, int32_t* bounds,
                cudaStream_t stream) {
  flash_plan<<<n_tiles(Sk) + n_tiles(Sq), kBKV, 0, stream>>>(qpos, kpos, Sq, Sk, n_tiles(Sk),
                                                              bounds);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bf16(const Params& p, int32_t* bounds, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, p.q, p.B, p.Sq, p.Hq, p.D, p.q_sb, p.q_ss, p.q_sh);
  if (!err) err = encode(&tk, p.k, p.B, p.Sk, p.Hkv, p.D, p.k_sb, p.k_ss, p.k_sh);
  if (!err) err = encode(&tv, p.v, p.B, p.Sk, p.Hkv, p.D, p.v_sb, p.v_ss, p.v_sh);
  if (err) return err;
  const long long ctas = (long long)n_tiles(p.Sq) * p.B * p.Hq;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;  // gridDim.x's limit
  err = launch_plan(p.qpos, p.kpos, p.Sq, p.Sk, bounds, stream);
  if (err) return err;
  Bf16Params bp;
  bp.out = p.out;
  bp.qpos = p.qpos;
  bp.kpos = p.kpos;
  bp.kv_bounds = bounds;
  bp.q_bounds = bounds + 2 * n_tiles(p.Sk);
  bp.B = p.B;
  bp.Sq = p.Sq;
  bp.Sk = p.Sk;
  bp.Hq = p.Hq;
  bp.Hkv = p.Hkv;
  bp.D = p.D;
  bp.o_sb = p.o_sb;
  bp.o_ss = p.o_ss;
  bp.o_sh = p.o_sh;
  bp.window = p.window;
  bp.scale_log2 = p.scale * 1.4426950408889634f;
  const int smem = Bf16Smem<DP>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_bf16<DP><<<(unsigned)ctas, kBf16Threads, smem, stream>>>(tq, tk, tv, bp);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D], each with its last dim
// contiguous and the given element strides; qpos int32[Sq], kpos int32[Sk].
// dtype 0: float32, 1: bfloat16.  window <= 0: none.  scale multiplies
// q . k (the reference's 1/sqrt(D), rounded to f32).  bounds (bf16 only):
// int32 scratch of 2 * (ceil(Sk / 128) + ceil(Sq / 128)) values.  The
// caller checks D <= 128, D % 8 == 0, Hq % Hkv == 0, and for bf16 16-byte
// aligned bases and strides (TMA's).  Launches on `stream` (bf16: the plan,
// then the attention) and returns 0, a cudaError_t, or 1000 plus the
// CUresult of a tensor map the driver refused.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, const void* qpos,
    const void* kpos, void* bounds, int B, int Sq, int Sk, int Hq, int Hkv, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int window, float scale, int dtype, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.qpos = (const int32_t*)qpos;
  p.kpos = (const int32_t*)kpos;
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.D = D;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.o_sh = o_sh;
  p.window = window;
  p.scale = scale;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    if (D <= 64) return launch_bf16<64>(p, (int32_t*)bounds, s);
    return launch_bf16<128>(p, (int32_t*)bounds, s);
  }
  if (D <= 16) return (int)launch_f32<16>(p, s);
  if (D <= 32) return (int)launch_f32<32>(p, s);
  if (D <= 64) return (int)launch_f32<64>(p, s);
  return (int)launch_f32<128>(p, s);
}

// The plan alone (the bf16 route's first launch): bounds as above.
extern "C" int flash_attention_plan(const void* qpos, const void* kpos, int Sq, int Sk,
                                    void* bounds, void* stream) {
  return launch_plan((const int32_t*)qpos, (const int32_t*)kpos, Sq, Sk, (int32_t*)bounds,
                     (cudaStream_t)stream);
}

// Dynamic shared memory of one bf16 CTA at head dim D.
extern "C" int flash_attention_bf16_smem(int D) {
  return D <= 64 ? Bf16Smem<64>::kBytes : Bf16Smem<128>::kBytes;
}
