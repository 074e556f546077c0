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
// * f32 (flash_fwd_f32, kernels/csrc/flash_tf32.cuh): on the tensor cores
//   by split TF32, three TF32 wgmma products for each f32 one, so the
//   bound is 3 x 4 * D FLOPs a pair at 495 TFLOP/s (0.63 ms at the
//   trainable route's shape, B=1, S=4096, 24/8, D=128), not 4 * D at the
//   67 TFLOP/s of f32 FMA (1.54 ms).  A hi and a lo copy of every operand
//   double its shared memory, so a CTA is one warpgroup of 64 q rows over
//   32-key steps through a 2-deep TMA ring (197,672 bytes at D=128); TF32
//   wgmma has no transpose flag, so a pre-pass writes q's and k's TF32
//   halves as rows and v's as columns into the wrapper's scratch (four
//   launches before the attention: flash_plan32, three splits).  Each
//   step's P V goes into a fresh accumulator added to O in f32: the
//   tensor core's own accumulation drifts over thousands of steps.
// * On request (the trainable route's forward) each row's log-sum-exp, f32
//   [B, Hq, Sq], in natural log as the reference's _chunked_gqa keeps it:
//   (m + log2 l) * ln 2 from the base-2 running max and sum; +inf for a
//   row with no allowed key.  The backward K4b
//   (flash_attention_bwd.cu) reads it.  Each kernel is a template on it, so
//   the instantiation the no-grad route launches is the code it was, and
//   its output is bitwise the same.
//
// The mask rules, the tile plan and the TMA / mbarrier / wgmma blocks are in
// kernels/csrc/flash_common.cuh, shared with the backward.
//
// The kernels neither allocate nor synchronize the host.  A wait on a
// barrier that outlasts ~10 s traps (a launch error) instead of hanging.

#include "flash_tf32.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;  // nullptr, or f32 [B, Hq, Sq]
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

// ------------------------------- bf16 ----------------------------------

constexpr int kStages = 2;          // kv ring depth
constexpr int kBf16Threads = 384;   // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;
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
  float* lse;  // written when the kernel's LSE is true
  const int32_t* qpos;
  const int32_t* kpos;
  const int32_t* kv_bounds;  // flash_plan's output: (min, max) per kv tile
  const int32_t* q_bounds;   // then per q block
  int B, Sq, Sk, Hq, Hkv, D;
  long long o_sb, o_ss, o_sh;
  int window;
  float scale_log2;  // the reference's scale times log2(e)
};

// DP: D padded to 64 or 128 columns (TMA's zero fill supplies the rest).
// LSE: also write each row's log-sum-exp (the instantiation without it is
// the no-grad route's).
template <int DP, bool LSE>
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
    if (LSE && t4 == 0) {  // natural log: (m + log2 l) ln 2; +inf for a row with no key
      float* lg = p.lse + ((long long)b * p.Hq + h) * p.Sq;
      if (r0 < p.Sq) lg[r0] = l0 > 0.f ? (m0 + log2f(l0)) * kLn2 : INFINITY;
      if (r1 < p.Sq) lg[r1] = l1 > 0.f ? (m1 + log2f(l1)) * kLn2 : INFINITY;
    }
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

// The forward body of flash_tf32.cuh: A = Q (tq), score B = K (tk), output
// B = V^T (tvt); the second A and B maps are not read.
template <int DP, bool LSE>
__global__ void __launch_bounds__(kTf32Threads, 1)
flash_fwd_f32(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap unused_a,
              const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap unused_b,
              const __grid_constant__ CUtensorMap tvt, const Tf32Params p) {
  tf32_body<kTf32Fwd, DP, LSE>(&tq, &unused_a, &tk, &unused_b, &tvt, p);
}

// The scratch's parts (ptr == nullptr: sizes only).
struct FwdScratch {
  int32_t* bounds;
  float *qn, *kn, *vt;
  long long bytes;
};

FwdScratch fwd_scratch(void* ptr, int B, int Sq, int Sk, int Hq, int Hkv, int D) {
  const int DP = tf32_dp(D);
  Tf32Scratch sc{(char*)ptr, 0};
  FwdScratch f;
  f.bounds = sc.take<int32_t>(8LL * (n32(Sk) + n32(Sq)));
  f.qn = take_copy(sc, (long long)B * Hq * Sq * DP);
  f.kn = take_copy(sc, (long long)B * Hkv * Sk * DP);
  f.vt = take_copy(sc, (long long)B * Hkv * DP * round8(Sk));
  f.bytes = sc.used;
  return f;
}

template <int DP>
int launch_f32(const Params& p, void* scratch, cudaStream_t stream) {
  const FwdScratch f = fwd_scratch(scratch, p.B, p.Sq, p.Sk, p.Hq, p.Hkv, p.D);
  const int bq = p.B * p.Hq, bk = p.B * p.Hkv;
  CUtensorMap tq, tk, tvt;
  int err = encode_f32(&tq, f.qn, DP, p.Sq, 2 * bq, kTf32Rows);
  if (!err) err = encode_f32(&tk, f.kn, DP, p.Sk, 2 * bk, kTf32Cols);
  if (!err) err = encode_f32(&tvt, f.vt, round8(p.Sk), DP, 2 * bk, DP);
  if (err) return err;
  const long long ctas = (long long)((p.Sq + kTf32Rows - 1) / kTf32Rows) * bq;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;  // gridDim.x's limit
  err = launch_plan32(p.qpos, p.kpos, p.Sq, p.Sk, f.bounds, stream);
  if (!err)
    err = launch_split<DP>((const float*)p.q, p.q_sb, p.q_ss, p.q_sh, p.B, p.Sq, p.Hq, p.D, f.qn,
                           nullptr, stream);
  if (!err)
    err = launch_split<DP>((const float*)p.k, p.k_sb, p.k_ss, p.k_sh, p.B, p.Sk, p.Hkv, p.D, f.kn,
                           nullptr, stream);
  if (!err)
    err = launch_split<DP>((const float*)p.v, p.v_sb, p.v_ss, p.v_sh, p.B, p.Sk, p.Hkv, p.D,
                           nullptr, f.vt, stream);
  if (err) return err;
  Tf32Params tp;
  tp.out = p.out;
  tp.o_sb = p.o_sb;
  tp.o_ss = p.o_ss;
  tp.o_sh = p.o_sh;
  tp.lse = p.lse;
  tp.delta = nullptr;
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
  auto kernel = p.lse != nullptr ? flash_fwd_f32<DP, true> : flash_fwd_f32<DP, false>;
  return launch_tf32<kTf32Fwd, DP>(kernel, tq, tq, tk, tk, tvt, tp, ctas, stream);
}

// ---------------------------- bf16 host side -----------------------------

template <int DP>
int launch_bf16(const Params& p, int32_t* bounds, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, p.q, p.B, p.Sq, p.Hq, p.D, p.q_sb, p.q_ss, p.q_sh, kBQ);
  if (!err) err = encode(&tk, p.k, p.B, p.Sk, p.Hkv, p.D, p.k_sb, p.k_ss, p.k_sh, kBKV);
  if (!err) err = encode(&tv, p.v, p.B, p.Sk, p.Hkv, p.D, p.v_sb, p.v_ss, p.v_sh, kBKV);
  if (err) return err;
  const long long ctas = (long long)n_tiles(p.Sq) * p.B * p.Hq;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;  // gridDim.x's limit
  err = launch_plan(p.qpos, p.kpos, p.Sq, p.Sk, bounds, stream);
  if (err) return err;
  Bf16Params bp;
  bp.out = p.out;
  bp.lse = p.lse;
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
  bp.scale_log2 = p.scale * kLog2e;
  const int smem = Bf16Smem<DP>::kBytes;
  auto kernel = p.lse != nullptr ? flash_fwd_bf16<DP, true> : flash_fwd_bf16<DP, false>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)ctas, kBf16Threads, smem, stream>>>(tq, tk, tv, bp);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D], each with its last dim
// contiguous and the given element strides; qpos int32[Sq], kpos int32[Sk].
// lse: nullptr, or f32 [B, Hq, Sq] for each row's log-sum-exp (natural log).
// dtype 0: float32, 1: bfloat16.  window <= 0: none.  scale multiplies
// q . k (the reference's 1/sqrt(D), rounded to f32).  bounds: bf16, int32
// scratch of 2 * (ceil(Sk / 128) + ceil(Sq / 128)) values; f32, a 256-byte
// aligned scratch of flash_attention_f32_scratch bytes.  The caller checks
// D <= 128, Hq % Hkv == 0, and for bf16 D % 8 == 0 and 16-byte aligned
// bases and strides (TMA's).  Launches on `stream` (bf16: the plan, then
// the attention; f32: the plan, the splits of q, k and v, the attention)
// and returns 0, a cudaError_t, or 1000 plus the CUresult of a tensor map
// cuTensorMapEncodeTiled refused.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse, const void* qpos,
    const void* kpos, void* bounds, int B, int Sq, int Sk, int Hq, int Hkv, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int window, float scale, int dtype, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = (float*)lse;
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
  if (const int err = bind_context()) return err;
  if (dtype == 1) {
    if (D <= 64) return launch_bf16<64>(p, (int32_t*)bounds, s);
    return launch_bf16<128>(p, (int32_t*)bounds, s);
  }
  if (D <= 32) return launch_f32<32>(p, bounds, s);
  if (D <= 64) return launch_f32<64>(p, bounds, s);
  return launch_f32<128>(p, bounds, s);
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

// Of one f32 CTA at head dim D.
extern "C" int flash_attention_f32_smem(int D) {
  return D <= 32 ? Tf32Smem<kTf32Fwd, 32>::kBytes
                 : D <= 64 ? Tf32Smem<kTf32Fwd, 64>::kBytes : Tf32Smem<kTf32Fwd, 128>::kBytes;
}

// Bytes of the f32 route's scratch (the `bounds` argument for dtype 0).
extern "C" long long flash_attention_f32_scratch(int B, int Sq, int Sk, int Hq, int Hkv, int D) {
  return fwd_scratch(nullptr, B, Sq, Sk, Hq, Hkv, D).bytes;
}
