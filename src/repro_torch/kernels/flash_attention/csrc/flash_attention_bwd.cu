// K4b: the backward of K4's trainable route (causal, optionally
// sliding-window GQA flash attention), Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's backward of flash_attention_
// trainable (src/repro/kernels/flash_attention/ops.py:92-103) is XLA's vjp
// of _chunked_gqa, re-run from q, k, v at 512 x 1024 chunks, and the port's
// stand-in for it (models/attention.py::chunked_vjp, torch ops) took 50 of
// the route's 51 ms at llama's training shape.  It computes the same
// function (dq, dk, dv) of (q, k, v, dout, positions, window), from what
// K4's forward keeps: its output and each row's log-sum-exp (natural log,
// +inf for a row with no allowed key).  chunked_vjp is its plain version.
//
//   p = exp(s - lse), s = q . k * scale (0 where masked); delta = rowsum(
//   dout * out); dv = p^T dout; dp = dout v^T; ds = p * (dp - delta);
//   dq = scale * ds k; dk = scale * ds^T q, summed over the Hq / Hkv query
//   heads of each kv head.
//
// Bound: operations.  10 * D FLOPs per allowed pair and query head (the
// products s, dp, dv, dq and dk, 2 * D each); at llama3.2-3b's training
// shape (B=1, S=4096, 24/8 heads, D=128) 2.58e11 FLOPs, 0.261 ms at the
// 989 TFLOP/s bf16 peak; the bytes (q, k, v, out, dout read, dq, dk, dv
// written: 134 MB) 0.040 ms.
//
// Design (bf16), four launches on the caller's stream:
// * flash_plan (the forward's) bounds each 128-key tile's and 128-row q
//   block's positions, so a kv tile against a q block is skipped, taken
//   whole (no per-element mask) or masked per element, exactly as in K4
//   and without assuming pos == arange.
// * flash_bwd_delta: delta = rowsum(dout * out) in f32, a warp a row, and
//   each row's lse2 = lse * log2 e, both into [B, Hq, Sq_pad] (Sq rounded
//   up to 128; the pad rows get lse2 = +inf, delta = 0, so p = 0 there and
//   no inf - inf reaches a product).
// * flash_bwd_dkdv_bf16, one pass: one CTA per (128-key tile, b * kv
//   head), kv tile 0 first (under a causal mask it has the most q blocks).
//   256 threads, two consumer warpgroups of 64 keys each and no producer
//   warp: a 384-thread CTA starts every thread at 168 registers, and
//   setmaxnreg lifted the consumers only part of the way (a one-pass build
//   there reached R191 and spilled 127 stores; PERF.md), while 256 threads
//   get ptxas's full 255 with no setmaxnreg.  Thread 0 loads the K and V
//   tile once by TMA, then walks the group's g query heads and, for each q
//   block the plan keeps, its 64-row halves through a 3-deep ring: Q and dO
//   by TMA, the rows' lse2 and delta by 1-D bulk copies, into the same
//   stage; it refills the stage the step before released, so its
//   warpgroup waits on the other only when that one is a whole step
//   behind.  Each step, per warpgroup: S^T = K Q^T, then dP^T = V dO^T, by
//   wgmma m64n64k16 (K, V, Q, dO all K-major, 128-byte swizzle) as two
//   groups; P^T = exp2(S^T * scale * log2 e - lse2) while the tensor cores
//   take dP^T (a masked step first sets S^T to -inf where the pair is not
//   allowed: one uniform branch a step, not one an element); dS^T = P^T *
//   (dP^T - delta), lse2 and delta per column of the accumulators; then
//   dV += P^T dO and dK += dS^T Q as one group, P^T and dS^T rounded to
//   bf16 as A operands from registers, dO and Q read MN-major through the
//   transpose flag (as K4 reads V): nothing is transposed or copied.  Both
//   64 x D f32 accumulators stay in registers across every head of the
//   group and are written once (dK times the scale): the GQA sum needs no
//   atomics.  8 * D FLOPs a pair.
// * flash_bwd_dq_bf16: one CTA per (128-row q block, b * q head), heaviest
//   first, the same 256-thread shape, thread 0 loading Q and dO once and
//   the plan's kv tiles through a 2-deep ring; each warpgroup (64 rows)
//   takes a tile as two 64-key halves: S = Q K^T and dP = dO V^T as two
//   groups, P while dP runs, dS = P * (dP - delta) with lse2 and delta per
//   row in registers, dQ += dS K (K read MN-major), the second half's S and
//   dP issued before the first half's dQ product is waited on.  It
//   recomputes S and dP (4 * D FLOPs a pair beyond the bound; 14 * D in
//   all) and is deterministic, as the whole backward is: bitwise equal from
//   run to run.  dQ summed from the dK/dV kernel into an f32 workspace in
//   kv tile order (10 * D) was built and measured more than twice as slow
//   (PERF.md); FA3's atomic dQ varies from run to run.
// * P and dS are rounded to bf16 for wgmma where chunked_vjp keeps them in
//   f32, so bf16 is held to a tolerance, not bitwise (chip_smoke.py,
//   TRAINABLE_BWD_TOL).
// * f32 (kernels/csrc/flash_tf32.cuh): on the tensor cores by split TF32,
//   three TF32 wgmma products for each f32 one: the bound is 3 x 10 * D
//   FLOPs a pair at 495 TFLOP/s, 1.56 ms at the training shape (f32 FMA's
//   67 TFLOP/s: 3.85 ms).  What limits the design is shared memory: an f32
//   operand tile with its lo copy is four times a bf16 one (64 x 128: 64
//   KB), and TF32 wgmma reads both operands K-major only, so the products
//   that sum over the sequence need transposed copies.  Nine launches:
//   flash_bwd_delta (as above, unpadded), flash_plan32, four
//   flash_split_tf32 (q and dO as rows and columns, k as rows and
//   columns, v as rows, into the wrapper's scratch), then three passes of
//   one 128-thread warpgroup each: flash_bwd_dkdv_f32<DP, false> (dV: K
//   kept, Q rows and dO columns streamed), flash_bwd_dkdv_f32<DP, true>
//   (dK: K and V kept, Q and dO rows and Q columns streamed: 230,424
//   bytes at D=128, so a one-stage ring) over 64-key tiles and the group's
//   q heads in 32-row steps, and flash_bwd_dq_f32 over 64-row q blocks and
//   32-key steps.  One dK/dV pass would keep K, V and four streamed
//   copies: 256 KB at D=128, past the 227 KB a CTA may use; so dV and dK
//   are two passes, 16 * D FLOPs a pair with dQ's recompute.
//   Deterministic as the bf16 route: no atomics, the GQA sum in registers.
//
// The kernels neither allocate nor synchronize the host.  A wait on a
// barrier that outlasts ~10 s traps (a launch error) instead of hanging.

#include "flash_tf32.cuh"

namespace {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;  // [B, Hq, Sq], natural log
  float* delta;      // written by flash_bwd_delta: f32 [B, Hq, Sq]; bf16 [B, Hq, Sq_pad]
  void* dq;
  void* dk;
  void* dv;
  const int32_t* qpos;
  const int32_t* kpos;
  const int32_t* kv_bounds;  // bf16: flash_plan's output, (min, max) per kv tile
  const int32_t* q_bounds;   // then per q block
  int B, Sq, Sk, Hq, Hkv, D;
  long long q_sb, q_ss, q_sh;  // strides in elements: batch, seq, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int window;  // <= 0: no window
  float scale;
  // bf16: each row's lse * log2 e, [B, Hq, Sq_pad], written by flash_bwd_delta
  // beside delta; rows past Sq hold +inf (and delta 0), so a 64-row step
  // never reads past a row array.  f32: Sq_pad == Sq, lse2 unused.
  float* lse2;
  int Sq_pad;
};

// Offset of row (b, h) of a [B, Hq, Sq] row array.
__device__ __forceinline__ long long row_base(const BwdParams& p, int b, int h) {
  return ((long long)b * p.Hq + h) * p.Sq;
}

// Of a [B, Hq, Sq_pad] one (bf16's lse2 and delta).
__device__ __forceinline__ long long pad_row_base(const BwdParams& p, int b, int h) {
  return ((long long)b * p.Hq + h) * p.Sq_pad;
}

// ---------------------------- delta pre-pass ----------------------------

constexpr int kDeltaThreads = 128;  // a warp a row

template <bool BF16>
__device__ __forceinline__ float load(const void* base, long long i) {
  if constexpr (BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
  } else {
    return static_cast<const float*>(base)[i];
  }
}

// bf16 also writes lse2 and the pad rows past Sq (lse2 +inf, delta 0).
template <bool BF16>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta(const BwdParams p) {
  const int rows = BF16 ? p.Sq_pad : p.Sq;
  const long long row = (long long)blockIdx.x * (kDeltaThreads / 32) + (threadIdx.x >> 5);
  if (row >= (long long)p.B * rows * p.Hq) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int h = (int)(row % p.Hq);
  const int s = (int)((row / p.Hq) % rows);
  const int b = (int)(row / ((long long)p.Hq * rows));
  float acc = 0.f;
  if (!BF16 || s < p.Sq) {
    const long long o = (long long)b * p.o_sb + (long long)s * p.o_ss + (long long)h * p.o_sh;
    const long long g = (long long)b * p.do_sb + (long long)s * p.do_ss + (long long)h * p.do_sh;
    for (int d = lane; d < p.D; d += 32)
      acc = fmaf(load<BF16>(p.out, o + d), load<BF16>(p.dout, g + d), acc);
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    if constexpr (BF16) {
      const long long r = pad_row_base(p, b, h) + s;
      p.delta[r] = acc;
      p.lse2[r] = s < p.Sq ? p.lse[row_base(p, b, h) + s] * kLog2e : INFINITY;
    } else {
      p.delta[row_base(p, b, h) + s] = acc;
    }
  }
}

// -------------------------------- bf16 ----------------------------------

constexpr int kQStep = 64;          // q rows per dK/dV step
constexpr int kBox128 = 128 * 128;  // bytes of a 128-row box of 64 bf16 columns
constexpr int kBox64 = 64 * 128;    // of a 64-row box

// Both kernels: two consumer warpgroups and no producer warp.  A
// 256-thread CTA gets ptxas's full 255 registers a thread (two warps a
// sub-partition), which one dK/dV pass needs: both 64 x D f32 accumulators
// (128 registers at D=128) beside S^T and dP^T (64).  Thread 0 issues the
// TMA loads into the ring.
constexpr int kBwdThreads = 256;
constexpr int kDkdvStages = 3;  // ring depth of dK/dV (64-row Q and dO steps)
constexpr int kDqStages = 2;    // of dQ (128-key K and V tiles)

// dK/dV CTA's dynamic shared memory, from a 1024-byte aligned base: K's
// DP/64 boxes of 128 rows, then V's; each stage: Q's DP/64 boxes of 64
// rows, then dO's; each stage's lse2 and delta (64 floats each); the
// barriers (kv_full, full[S], empty[S]).
template <int DP>
struct DkdvSmem {
  static constexpr int kKVBytes = kBKV * DP * 2;
  static constexpr int kStepBytes = kQStep * DP * 2;
  static constexpr int kRowBytes = kQStep * 4;
  static constexpr int kStageOffset = 2 * kKVBytes;
  static constexpr int kRowsOffset = kStageOffset + 2 * kDkdvStages * kStepBytes;
  static constexpr int kBarOffset = kRowsOffset + kDkdvStages * 2 * kRowBytes;
  static constexpr int kBytes = kBarOffset + 8 * (1 + 2 * kDkdvStages) + 1024;
};

// dQ CTA's: Q's DP/64 boxes of 128 rows, then dO's; each stage's K boxes,
// then each stage's V boxes; the barriers (q_full, full[S], empty[S]).
template <int DP>
struct DqSmem {
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kTileBytes = kBKV * DP * 2;
  static constexpr int kRingOffset = 2 * kQBytes;
  static constexpr int kBarOffset = kRingOffset + 2 * kDqStages * kTileBytes;
  static constexpr int kBytes = kBarOffset + 8 * (1 + 2 * kDqStages) + 1024;
};

// Barriers of a ring: `first` (one arrival), full[S] (one), empty[S] (one a
// warp).
template <int S>
__device__ __forceinline__ void init_ring(uint32_t first, uint32_t full0, uint32_t empty0) {
  if (threadIdx.x == 0) {
    mbar_init(first, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kBwdThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// d = A B^T over 64 x 64 x DP: A and B 64-row K-major operands (DP/64 boxes
// `a_box` and `b_box` bytes apart), one wgmma group of its own.
template <int DP>
__device__ __forceinline__ void wgmma_group_n64(float (&d)[32], uint32_t a, uint32_t a_box,
                                                uint32_t b, uint32_t b_box) {
  reg_fence(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss_n64(d, smem_desc(a + (kk >> 2) * a_box + (kk & 3) * 32, 16, 1024),
                 smem_desc(b + (kk >> 2) * b_box + (kk & 3) * 32, 16, 1024), kk > 0);
  wgmma_commit();
}

// d += A B over 64 rows of B (16 a k-step, two 8-row swizzle groups of
// 1024 bytes): A the m64k16 fragments from registers, B read MN-major from
// boxes of 64 columns `b_box` bytes apart.  Not fenced or committed.
template <int N>
__device__ __forceinline__ void wgmma_rs_k64(float (&d)[N], const uint32_t (&a)[4][4],
                                             uint32_t b, uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(d, a[kk], smem_desc(b + kk * 2048, b_box, 1024));
}

// The dK/dV CTA's walk: the group's q heads in order, and for each the
// 64-row halves of the q blocks the plan keeps against this kv tile.
// kind: the q block's (1 masked per element, 2 whole); hl == g: done.
struct StepWalk {
  int hl, qb, half, kind;
};

__device__ __forceinline__ void walk_next(StepWalk& w, const BwdParams& p, int g, int kmin,
                                          int kmax, bool whole) {
  if (w.half == 0 && w.qb * kBQ + kQStep < p.Sq) {
    w.half = 1;
    return;
  }
  w.half = 0;
  const int n_qb = (p.Sq + kBQ - 1) / kBQ;
  for (;;) {
    if (++w.qb == n_qb) {
      w.qb = 0;
      if (++w.hl == g) return;
    }
    w.kind = tile_kind(kmin, kmax, whole, p.q_bounds[2 * w.qb], p.q_bounds[2 * w.qb + 1],
                       p.window);
    if (w.kind) return;
  }
}

// DP: D padded to 64 or 128 columns (TMA's zero fill supplies the rest).
// One CTA per (128-key tile, b * kv head); each consumer thread keeps its
// rows of both accumulators, dK and dV, across the group's q heads.
template <int DP>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const BwdParams p) {
  using L = DkdvSmem<DP>;
  constexpr int NB = DP / kBoxCols;  // boxes per row block
  constexpr int S = kDkdvStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const float* rows = reinterpret_cast<const float*>(smem_raw + (base - raw) + L::kRowsOffset);
  const uint32_t kv_full = base + L::kBarOffset;
  const uint32_t full0 = kv_full + 8, empty0 = kv_full + 8 * (1 + S);

  const int BH = p.B * p.Hkv;
  const int kt = (int)(blockIdx.x / (unsigned)BH);  // kv tile 0 first: the most q blocks
  const int bh = (int)(blockIdx.x % (unsigned)BH);
  const int b = bh / p.Hkv, hk = bh % p.Hkv;
  const int g = p.Hq / p.Hkv;
  const int k0 = kt * kBKV;
  const int kmin = p.kv_bounds[2 * kt], kmax = p.kv_bounds[2 * kt + 1];
  const bool whole = k0 + kBKV <= p.Sk;
  init_ring<S>(kv_full, full0, empty0);

  StepWalk w{0, -1, 1, 0};
  walk_next(w, p, g, kmin, kmax, whole);
  // Thread 0's walk: step `pw` goes to stage `ps` of phase `pph` once
  // every warp has released that stage.
  StepWalk pw = w;
  int ps = 0, issued = 0;
  uint32_t pph = 0;
  if (threadIdx.x == 0) {
    mbar_expect_tx(kv_full, 2 * L::kKVBytes);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      tma_load_4d(base + c * kBox128, &tk, kv_full, c * kBoxCols, hk, k0, b);
      tma_load_4d(base + L::kKVBytes + c * kBox128, &tv, kv_full, c * kBoxCols, hk, k0, b);
    }
  }

  const int cw = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  // This thread's keys: kr0 and kr0 + 8 (the accumulators' rows).
  const int kr0 = k0 + 64 * cw + 16 * warp + g8, kr1 = kr0 + 8;
  const int kp0 = kr0 < p.Sk ? p.kpos[kr0] : INT_MAX;
  const int kp1 = kr1 < p.Sk ? p.kpos[kr1] : INT_MAX;
  const float c = p.scale * kLog2e;

  float dk[DP / 2], dv[DP / 2];  // dK before the scale
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  float s[kQStep / 2], dp[kQStep / 2];
#pragma unroll
  for (int i = 0; i < kQStep / 2; ++i) s[i] = dp[i] = 0.f;

  // This warpgroup's 64 rows of K and V: 64 rows into each 128-row box.
  const uint32_t k_addr = base + cw * 64 * 128;
  const uint32_t v_addr = base + L::kKVBytes + cw * 64 * 128;
  mbar_wait(kv_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int step = 0; w.hl < g; ++step) {
    // Thread 0 fills the ring: S steps at first, then, before step i, step
    // S + i - 1 into the stage step i - 1 released, so its warpgroup waits
    // on the other only when that one is a whole step behind.
    if (threadIdx.x == 0) {
      while (pw.hl < g && issued < S + step) {
        const int h = hk * g + pw.hl, pq0 = pw.qb * kBQ + pw.half * kQStep;
        const uint32_t full = full0 + 8 * ps;
        const uint32_t q_dst = base + L::kStageOffset + ps * 2 * L::kStepBytes;
        const uint32_t r_dst = base + L::kRowsOffset + ps * 2 * L::kRowBytes;
        const long long r = pad_row_base(p, b, h) + pq0;
        mbar_wait(empty0 + 8 * ps, pph ^ 1);
        mbar_expect_tx(full, 2 * L::kStepBytes + 2 * L::kRowBytes);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(q_dst + c * kBox64, &tq, full, c * kBoxCols, h, pq0, b);
          tma_load_4d(q_dst + L::kStepBytes + c * kBox64, &tdo, full, c * kBoxCols, h, pq0, b);
        }
        bulk_load_1d(r_dst, p.lse2 + r, L::kRowBytes, full);
        bulk_load_1d(r_dst + L::kRowBytes, p.delta + r, L::kRowBytes, full);
        walk_next(pw, p, g, kmin, kmax, whole);
        ++issued;
        if (++ps == S) {
          ps = 0;
          pph ^= 1;
        }
      }
    }
    const int q0 = w.qb * kBQ + w.half * kQStep;
    const bool masked = w.kind != 2;
    const uint32_t q_addr = base + L::kStageOffset + stage * 2 * L::kStepBytes;
    const uint32_t do_addr = q_addr + L::kStepBytes;
    const float* lse_s = rows + stage * 2 * kQStep;
    const float* delta_s = lse_s + kQStep;
    mbar_wait(full0 + 8 * stage, phase);

    // S^T = K Q^T, then dP^T = V dO^T: two groups, so the exponentials
    // below run while the tensor cores take dP^T.
    wgmma_group_n64<DP>(s, k_addr, kBox128, q_addr, kBox64);
    wgmma_group_n64<DP>(dp, v_addr, kBox128, do_addr, kBox64);
    wgmma_wait<1>();
    reg_fence(s);

    // Element e of n8 chunk j: key kr0 (e < 2) or kr1, q row q0 + 8j +
    // 2*t4 + (e & 1).  A masked step first sets S^T to -inf where the pair
    // is not allowed (one uniform branch a step, not one an element), then
    // P^T = exp2(S^T * scale * log2 e - lse2) into s: 0 where masked, and
    // 0 in the rows past Sq (lse2 = +inf) with no inf - inf.
    if (masked) {
#pragma unroll
      for (int j = 0; j < kQStep / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = q0 + 8 * j + 2 * t4 + (e & 1);
          const int qp = qr < p.Sq ? __ldg(p.qpos + qr) : INT_MIN;
          if (!allowed(qp, e < 2 ? kp0 : kp1, p.window)) s[4 * j + e] = -INFINITY;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kQStep / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] = exp2f(fmaf(s[4 * j + e], c, -((e & 1) ? l2.y : l2.x)));
    }
    // dS^T = P^T * (dP^T - delta) into dp.
    wgmma_wait<0>();
    reg_fence(dp);
#pragma unroll
    for (int j = 0; j < kQStep / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
    }
    // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16 as the A
    // operands from registers, dO and Q read MN-major through the
    // transpose flag (as K4 reads V); one group, issued once s and dp are
    // spent, so no fragment is held while the elementwise work runs.
    uint32_t pa[kQStep / 16][4], da[kQStep / 16][4];
    to_a_fragments<kQStep / 16>(s, pa);
    to_a_fragments<kQStep / 16>(dp, da);
    reg_fence(dv);
    reg_fence(dk);
    wgmma_fence();
    wgmma_rs_k64(dv, pa, do_addr, kBox64);
    wgmma_rs_k64(dk, da, q_addr, kBox64);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dv);
    reg_fence(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);
    walk_next(w, p, g, kmin, kmax, whole);
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }

  __nv_bfloat16* dkg = (__nv_bfloat16*)p.dk + (long long)b * p.dk_sb + (long long)hk * p.dk_sh;
  __nv_bfloat16* dvg = (__nv_bfloat16*)p.dv + (long long)b * p.dv_sb + (long long)hk * p.dv_sh;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    if (col >= p.D) continue;
    if (kr0 < p.Sk) {
      *reinterpret_cast<uint32_t*>(dkg + (long long)kr0 * p.dk_ss + col) =
          pack_bf16(dk[4 * j] * p.scale, dk[4 * j + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvg + (long long)kr0 * p.dv_ss + col) =
          pack_bf16(dv[4 * j], dv[4 * j + 1]);
    }
    if (kr1 < p.Sk) {
      *reinterpret_cast<uint32_t*>(dkg + (long long)kr1 * p.dk_ss + col) =
          pack_bf16(dk[4 * j + 2] * p.scale, dk[4 * j + 3] * p.scale);
      *reinterpret_cast<uint32_t*>(dvg + (long long)kr1 * p.dv_ss + col) =
          pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
    }
  }
}

// The next kv tile after `t` that the plan keeps against the q block
// [qmin, qmax] (n_kt: none), and its kind.
__device__ __forceinline__ int next_tile(const BwdParams& p, int t, int qmin, int qmax,
                                         int& kind) {
  const int n_kt = (p.Sk + kBKV - 1) / kBKV;
  for (++t; t < n_kt; ++t) {
    kind = tile_kind(p.kv_bounds[2 * t], p.kv_bounds[2 * t + 1], (t + 1) * kBKV <= p.Sk, qmin,
                     qmax, p.window);
    if (kind) return t;
  }
  return n_kt;
}

// One CTA per (128-row q block, b * q head), heaviest first; each consumer
// warpgroup keeps its 64 rows of dQ over the plan's kv tiles.
template <int DP>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                  const BwdParams p) {
  using L = DqSmem<DP>;
  constexpr int NB = DP / kBoxCols;
  constexpr int S = kDqStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBarOffset;
  const uint32_t full0 = q_full + 8, empty0 = q_full + 8 * (1 + S);

  const int BH = p.B * p.Hq;
  const int n_qb = (p.Sq + kBQ - 1) / kBQ;
  const int n_kt = (p.Sk + kBKV - 1) / kBKV;
  const int qb = n_qb - 1 - (int)(blockIdx.x / (unsigned)BH);  // most work first
  const int bh = (int)(blockIdx.x % (unsigned)BH);
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qb * kBQ;
  const int qmin = p.q_bounds[2 * qb], qmax = p.q_bounds[2 * qb + 1];
  init_ring<S>(q_full, full0, empty0);

  int kind = 0, pkind = 0;
  int kt = next_tile(p, -1, qmin, qmax, kind);
  // Thread 0's walk: tile `pt` goes to stage `ps` of phase `pph` once every
  // warp has released that stage.
  int pt = kt, ps = 0, issued = 0;
  uint32_t pph = 0;
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, 2 * L::kQBytes);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      tma_load_4d(base + c * kBox128, &tq, q_full, c * kBoxCols, h, q0, b);
      tma_load_4d(base + L::kQBytes + c * kBox128, &tdo, q_full, c * kBoxCols, h, q0, b);
    }
  }

  const int cw = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  // This thread's rows: r0 and r0 + 8 (the accumulators' rows).
  const int r0 = q0 + 64 * cw + 16 * warp + g8, r1 = r0 + 8;
  const int qp0 = r0 < p.Sq ? p.qpos[r0] : INT_MIN;
  const int qp1 = r1 < p.Sq ? p.qpos[r1] : INT_MIN;
  // lse2 and delta of rows r0, r1 (+inf and 0 past Sq).
  const long long rb = pad_row_base(p, b, h);
  const float l0 = p.lse2[rb + r0], l1 = p.lse2[rb + r1];
  const float d0 = p.delta[rb + r0], d1 = p.delta[rb + r1];
  const float c = p.scale * kLog2e;

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  // Q and dO rows of this warpgroup: 64 rows into each box.
  const uint32_t q_addr = base + cw * 64 * 128;
  const uint32_t do_addr = base + L::kQBytes + cw * 64 * 128;
  mbar_wait(q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int step = 0; kt < n_kt; ++step) {
    // Thread 0 fills the ring: S tiles at first, then, before step i, tile
    // S + i - 1 into the stage step i - 1 released.
    if (threadIdx.x == 0) {
      while (pt < n_kt && issued < S + step) {
        const uint32_t full = full0 + 8 * ps;
        const uint32_t k_dst = base + L::kRingOffset + ps * L::kTileBytes;
        const uint32_t v_dst = k_dst + S * L::kTileBytes;
        mbar_wait(empty0 + 8 * ps, pph ^ 1);
        mbar_expect_tx(full, 2 * L::kTileBytes);
#pragma unroll
        for (int cc = 0; cc < NB; ++cc) {
          tma_load_4d(k_dst + cc * kBox128, &tk, full, cc * kBoxCols, hk, pt * kBKV, b);
          tma_load_4d(v_dst + cc * kBox128, &tv, full, cc * kBoxCols, hk, pt * kBKV, b);
        }
        pt = next_tile(p, pt, qmin, qmax, pkind);
        ++issued;
        if (++ps == S) {
          ps = 0;
          pph ^= 1;
        }
      }
    }
    const bool masked = kind != 2;
    mbar_wait(full0 + 8 * stage, phase);
    // The tile's two 64-key halves, 64 rows into each 128-row box of K
    // (and of V, S tiles further).  Half 1's S = Q K^T and dP = dO V^T go
    // out before half 0's dQ product is waited on.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k0 = kt * kBKV + 64 * half;
      const uint32_t kh = base + L::kRingOffset + stage * L::kTileBytes + half * 64 * 128;
      wgmma_group_n64<DP>(s, q_addr, kBox128, kh, kBox128);
      wgmma_group_n64<DP>(dp, do_addr, kBox128, kh + S * L::kTileBytes, kBox128);
      wgmma_wait<1>();  // S (and half 0's dQ product)
      reg_fence(s);
      // Element e of n8 chunk j: row r0 (e < 2) or r1, key k0 + 8j + 2*t4
      // + (e & 1).  S to -inf where masked (a masked tile only), P into s,
      // then dS into s.
      if (masked) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t4 + (e & 1);
            const int kp = key < p.Sk ? __ldg(p.kpos + key) : INT_MAX;
            if (!allowed(e < 2 ? qp0 : qp1, kp, p.window)) s[4 * j + e] = -INFINITY;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = exp2f(fmaf(s[i], c, (i & 3) < 2 ? -l0 : -l1));
      wgmma_wait<0>();
      reg_fence(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= dp[i] - ((i & 3) < 2 ? d0 : d1);
      uint32_t da[4][4];
      to_a_fragments<4>(s, da);
      // dQ += dS K: 16 keys a step, K read MN-major.
      reg_fence(dq);
      wgmma_fence();
      wgmma_rs_k64(dq, da, kh, kBox128);
      wgmma_commit();
    }
    wgmma_wait<0>();
    reg_fence(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);
    kt = next_tile(p, kt, qmin, qmax, kind);
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }

  __nv_bfloat16* dqg = (__nv_bfloat16*)p.dq + (long long)b * p.dq_sb + (long long)h * p.dq_sh;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    if (col >= p.D) continue;
    if (r0 < p.Sq)
      *reinterpret_cast<uint32_t*>(dqg + (long long)r0 * p.dq_ss + col) =
          pack_bf16(dq[4 * j] * p.scale, dq[4 * j + 1] * p.scale);
    if (r1 < p.Sq)
      *reinterpret_cast<uint32_t*>(dqg + (long long)r1 * p.dq_ss + col) =
          pack_bf16(dq[4 * j + 2] * p.scale, dq[4 * j + 3] * p.scale);
  }
}

// ------------------------------ host side -------------------------------

template <bool BF16>
int launch_delta(const BwdParams& p, cudaStream_t stream) {
  const long long rows = (long long)p.B * (BF16 ? p.Sq_pad : p.Sq) * p.Hq;
  const long long blocks = (rows + kDeltaThreads / 32 - 1) / (kDeltaThreads / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_bwd_delta<BF16><<<(unsigned)blocks, kDeltaThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// -------------------------------- f32 -----------------------------------

// The dV (DK false) and dK (DK true) passes of flash_tf32.cuh: A = K (ta0)
// and V (ta1, dK), score B = Q (tb0) and dO (tb1, dK), output B = dO^T
// (dV) or Q^T (dK), one CTA per (64-key tile, b * kv head).
template <int DP, bool DK>
__global__ void __launch_bounds__(kTf32Threads, 1)
flash_bwd_dkdv_f32(const __grid_constant__ CUtensorMap ta0, const __grid_constant__ CUtensorMap ta1,
                   const __grid_constant__ CUtensorMap tb0, const __grid_constant__ CUtensorMap tb1,
                   const __grid_constant__ CUtensorMap tt, const Tf32Params p) {
  tf32_body<DK ? kTf32Dk : kTf32Dv, DP, false>(&ta0, &ta1, &tb0, &tb1, &tt, p);
}

// dQ: A = Q, dO; score B = K, V; output B = K^T; one CTA per (64-row q
// block, b * q head), heaviest first.
template <int DP>
__global__ void __launch_bounds__(kTf32Threads, 1)
flash_bwd_dq_f32(const __grid_constant__ CUtensorMap ta0, const __grid_constant__ CUtensorMap ta1,
                 const __grid_constant__ CUtensorMap tb0, const __grid_constant__ CUtensorMap tb1,
                 const __grid_constant__ CUtensorMap tt, const Tf32Params p) {
  tf32_body<kTf32Dq, DP, false>(&ta0, &ta1, &tb0, &tb1, &tt, p);
}

// The scratch's parts (ptr == nullptr: sizes only).
struct BwdScratch {
  int32_t* bounds;
  float *qn, *qt, *dn, *dt, *kn, *kt, *vn;
  long long bytes;
};

BwdScratch bwd_scratch(void* ptr, int B, int Sq, int Sk, int Hq, int Hkv, int D) {
  const int DP = tf32_dp(D);
  const long long qn = (long long)B * Hq * Sq * DP, qt = (long long)B * Hq * DP * round8(Sq);
  const long long kn = (long long)B * Hkv * Sk * DP, kt = (long long)B * Hkv * DP * round8(Sk);
  Tf32Scratch sc{(char*)ptr, 0};
  BwdScratch f;
  f.bounds = sc.take<int32_t>(8LL * (n32(Sk) + n32(Sq)));
  f.qn = take_copy(sc, qn);
  f.qt = take_copy(sc, qt);
  f.dn = take_copy(sc, qn);
  f.dt = take_copy(sc, qt);
  f.kn = take_copy(sc, kn);
  f.kt = take_copy(sc, kt);
  f.vn = take_copy(sc, kn);
  f.bytes = sc.used;
  return f;
}

template <int DP>
int launch_f32(const BwdParams& p, void* scratch, cudaStream_t stream) {
  const BwdScratch f = bwd_scratch(scratch, p.B, p.Sq, p.Sk, p.Hq, p.Hkv, p.D);
  const int bq = 2 * p.B * p.Hq, bk = 2 * p.B * p.Hkv;  // planes: hi, then lo
  CUtensorMap qa, qb, da, db, qt, dt, ka, kb, kt, va, vb;
  int err = encode_f32(&qa, f.qn, DP, p.Sq, bq, kTf32Rows);
  if (!err) err = encode_f32(&qb, f.qn, DP, p.Sq, bq, kTf32Cols);
  if (!err) err = encode_f32(&da, f.dn, DP, p.Sq, bq, kTf32Rows);
  if (!err) err = encode_f32(&db, f.dn, DP, p.Sq, bq, kTf32Cols);
  if (!err) err = encode_f32(&qt, f.qt, round8(p.Sq), DP, bq, DP);
  if (!err) err = encode_f32(&dt, f.dt, round8(p.Sq), DP, bq, DP);
  if (!err) err = encode_f32(&ka, f.kn, DP, p.Sk, bk, kTf32Rows);
  if (!err) err = encode_f32(&kb, f.kn, DP, p.Sk, bk, kTf32Cols);
  if (!err) err = encode_f32(&kt, f.kt, round8(p.Sk), DP, bk, DP);
  if (!err) err = encode_f32(&va, f.vn, DP, p.Sk, bk, kTf32Rows);
  if (!err) err = encode_f32(&vb, f.vn, DP, p.Sk, bk, kTf32Cols);
  if (err) return err;
  const long long dkdv_ctas = (long long)((p.Sk + kTf32Rows - 1) / kTf32Rows) * p.B * p.Hkv;
  const long long dq_ctas = (long long)((p.Sq + kTf32Rows - 1) / kTf32Rows) * p.B * p.Hq;
  if (dkdv_ctas > 0x7fffffffLL || dq_ctas > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;  // gridDim.x's limit
  err = launch_delta<false>(p, stream);
  if (!err) err = launch_plan32(p.qpos, p.kpos, p.Sq, p.Sk, f.bounds, stream);
  if (!err)
    err = launch_split<DP>((const float*)p.q, p.q_sb, p.q_ss, p.q_sh, p.B, p.Sq, p.Hq, p.D, f.qn,
                           f.qt, stream);
  if (!err)
    err = launch_split<DP>((const float*)p.dout, p.do_sb, p.do_ss, p.do_sh, p.B, p.Sq, p.Hq, p.D,
                           f.dn, f.dt, stream);
  if (!err)
    err = launch_split<DP>((const float*)p.k, p.k_sb, p.k_ss, p.k_sh, p.B, p.Sk, p.Hkv, p.D, f.kn,
                           f.kt, stream);
  if (!err)
    err = launch_split<DP>((const float*)p.v, p.v_sb, p.v_ss, p.v_sh, p.B, p.Sk, p.Hkv, p.D, f.vn,
                           nullptr, stream);
  if (err) return err;
  Tf32Params tp;
  tp.lse = const_cast<float*>(p.lse);
  tp.delta = p.delta;
  tp.qpos = p.qpos;
  tp.kpos = p.kpos;
  tp.kv_b32 = f.bounds;
  tp.q_b32 = f.bounds + 2 * n32(p.Sk);
  tp.B = p.B;
  tp.Sq = p.Sq;
  tp.Sk = p.Sk;
  tp.Hq = p.Hq;
  tp.Hkv = p.Hkv;
  tp.D = p.D;
  tp.window = p.window;
  tp.scale = p.scale;
  tp.out = p.dv;
  tp.o_sb = p.dv_sb;
  tp.o_ss = p.dv_ss;
  tp.o_sh = p.dv_sh;
  err = launch_tf32<kTf32Dv, DP>(flash_bwd_dkdv_f32<DP, false>, ka, ka, qb, qb, dt, tp, dkdv_ctas,
                                 stream);
  if (err) return err;
  tp.out = p.dk;
  tp.o_sb = p.dk_sb;
  tp.o_ss = p.dk_ss;
  tp.o_sh = p.dk_sh;
  err = launch_tf32<kTf32Dk, DP>(flash_bwd_dkdv_f32<DP, true>, ka, va, qb, db, qt, tp, dkdv_ctas,
                                 stream);
  if (err) return err;
  tp.out = p.dq;
  tp.o_sb = p.dq_sb;
  tp.o_ss = p.dq_ss;
  tp.o_sh = p.dq_sh;
  return launch_tf32<kTf32Dq, DP>(flash_bwd_dq_f32<DP>, qa, da, kb, vb, kt, tp, dq_ctas, stream);
}

template <int DP>
int launch_bf16(const BwdParams& p, int32_t* bounds, cudaStream_t stream) {
  CUtensorMap tq128, tdo128, tq64, tdo64, tk, tv;
  int err = encode(&tq128, p.q, p.B, p.Sq, p.Hq, p.D, p.q_sb, p.q_ss, p.q_sh, kBQ);
  if (!err) err = encode(&tq64, p.q, p.B, p.Sq, p.Hq, p.D, p.q_sb, p.q_ss, p.q_sh, kQStep);
  if (!err)
    err = encode(&tdo128, p.dout, p.B, p.Sq, p.Hq, p.D, p.do_sb, p.do_ss, p.do_sh, kBQ);
  if (!err)
    err = encode(&tdo64, p.dout, p.B, p.Sq, p.Hq, p.D, p.do_sb, p.do_ss, p.do_sh, kQStep);
  if (!err) err = encode(&tk, p.k, p.B, p.Sk, p.Hkv, p.D, p.k_sb, p.k_ss, p.k_sh, kBKV);
  if (!err) err = encode(&tv, p.v, p.B, p.Sk, p.Hkv, p.D, p.v_sb, p.v_ss, p.v_sh, kBKV);
  if (err) return err;
  const long long dkdv_ctas = (long long)n_tiles(p.Sk) * p.B * p.Hkv;
  const long long dq_ctas = (long long)n_tiles(p.Sq) * p.B * p.Hq;
  if (dkdv_ctas > 0x7fffffffLL || dq_ctas > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;  // gridDim.x's limit
  err = launch_plan(p.qpos, p.kpos, p.Sq, p.Sk, bounds, stream);
  if (!err) err = launch_delta<true>(p, stream);
  if (err) return err;
  BwdParams bp = p;
  bp.kv_bounds = bounds;
  bp.q_bounds = bounds + 2 * n_tiles(p.Sk);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_bf16<DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       DkdvSmem<DP>::kBytes);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_bf16<DP><<<(unsigned)dkdv_ctas, kBwdThreads, DkdvSmem<DP>::kBytes, stream>>>(
      tq64, tdo64, tk, tv, bp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dq_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DqSmem<DP>::kBytes);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_bf16<DP><<<(unsigned)dq_ctas, kBwdThreads, DqSmem<DP>::kBytes, stream>>>(
      tq128, tdo128, tk, tv, bp);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out, dout, dq: [B, Sq, Hq, D]; k, v, dk, dv: [B, Sk, Hkv, D], each with
// its last dim contiguous and the given element strides (q, k, v, out,
// dout, dq, dk, dv in that order); lse: f32 [B, Hq, Sq] from K4's forward
// (natural log); qpos int32[Sq], kpos int32[Sk].  dtype 0: float32, 1:
// bfloat16 (every tensor but lse in it).  window <= 0: none.  scale
// multiplies q . k (the reference's 1/sqrt(D), rounded to f32).  bounds:
// bf16, int32 scratch of 2 * (ceil(Sk / 128) + ceil(Sq / 128)) values;
// f32, a 256-byte aligned scratch of flash_attention_bwd_f32_scratch
// bytes.  delta: f32 scratch of the rows, B * Hq * Sq values (f32), or 2 *
// B * Hq * Sq_pad with Sq_pad = 128 * ceil(Sq / 128) (bf16: each row's
// lse2, then its delta; ops.py::bwd_rows_scratch).  The caller checks D <=
// 128, Hq % Hkv == 0, and for bf16 D % 8 == 0 and 16-byte aligned bases
// and strides (TMA's).  Launches on `stream` (bf16: the plan, delta, dK/dV,
// dQ; f32: delta, the plan, four splits, dV, dK, dQ) and returns 0, a
// cudaError_t, or 1000 plus the CUresult of a tensor map
// cuTensorMapEncodeTiled refused.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, void* dq, void* dk, void* dv, const void* qpos, const void* kpos,
    void* bounds, void* delta, int B, int Sq, int Sk, int Hq, int Hkv, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, long long do_sb, long long do_ss, long long do_sh, long long dq_sb,
    long long dq_ss, long long dq_sh, long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh, int window, float scale, int dtype,
    void* stream) {
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.dout = dout;
  p.lse = (const float*)lse;
  p.delta = (float*)delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.qpos = (const int32_t*)qpos;
  p.kpos = (const int32_t*)kpos;
  p.kv_bounds = nullptr;
  p.q_bounds = nullptr;
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
  p.do_sb = do_sb;
  p.do_ss = do_ss;
  p.do_sh = do_sh;
  p.dq_sb = dq_sb;
  p.dq_ss = dq_ss;
  p.dq_sh = dq_sh;
  p.dk_sb = dk_sb;
  p.dk_ss = dk_ss;
  p.dk_sh = dk_sh;
  p.dv_sb = dv_sb;
  p.dv_ss = dv_ss;
  p.dv_sh = dv_sh;
  p.window = window;
  p.scale = scale;
  p.lse2 = nullptr;
  p.Sq_pad = Sq;
  const cudaStream_t s = (cudaStream_t)stream;
  if (const int err = bind_context()) return err;
  if (dtype == 1) {
    p.Sq_pad = n_tiles(Sq) * kBQ;
    p.lse2 = (float*)delta;
    p.delta = p.lse2 + (long long)B * Hq * p.Sq_pad;
    if (D <= 64) return launch_bf16<64>(p, (int32_t*)bounds, s);
    return launch_bf16<128>(p, (int32_t*)bounds, s);
  }
  if (D <= 32) return launch_f32<32>(p, bounds, s);
  if (D <= 64) return launch_f32<64>(p, bounds, s);
  return launch_f32<128>(p, bounds, s);
}

// Dynamic shared memory of one bf16 CTA at head dim D: kernel 0 the dK/dV
// kernel, 1 the dQ kernel.
extern "C" int flash_attention_bwd_smem(int D, int kernel) {
  if (kernel == 0) return D <= 64 ? DkdvSmem<64>::kBytes : DkdvSmem<128>::kBytes;
  return D <= 64 ? DqSmem<64>::kBytes : DqSmem<128>::kBytes;
}

// Dynamic shared memory of one f32 CTA at head dim D: kernel 0 the dV
// pass, 1 the dK pass, 2 the dQ kernel.
extern "C" int flash_attention_bwd_f32_smem(int D, int kernel) {
  const int mode = kernel == 0 ? kTf32Dv : kernel == 1 ? kTf32Dk : kTf32Dq;
#define TF32_SMEM(M)                                                          \
  (D <= 32 ? Tf32Smem<M, 32>::kBytes : D <= 64 ? Tf32Smem<M, 64>::kBytes \
                                               : Tf32Smem<M, 128>::kBytes)
  return mode == kTf32Dv ? TF32_SMEM(kTf32Dv) : mode == kTf32Dk ? TF32_SMEM(kTf32Dk)
                                                                 : TF32_SMEM(kTf32Dq);
#undef TF32_SMEM
}

// Bytes of the f32 route's scratch (the `bounds` argument for dtype 0).
extern "C" long long flash_attention_bwd_f32_scratch(int B, int Sq, int Sk, int Hq, int Hkv,
                                                     int D) {
  return bwd_scratch(nullptr, B, Sq, Sk, Hq, Hkv, D).bytes;
}
