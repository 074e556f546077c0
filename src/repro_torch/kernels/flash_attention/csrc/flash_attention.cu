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
// Design against that bound:
// * One CTA per (q block, batch*q head); the q tile's fragments and the
//   running (m, l, acc) stay in registers; a loop over kv tiles, staged
//   through shared memory, takes the place of the TPU's sequential kv axis.
//   The q blocks with the most work are launched first.
// * q, k, v and out are read and written through their [B, S, H, D]
//   strides: the kv head is q_head / (Hq / Hkv), so there is no transpose
//   copy and no repeat of K/V.  Ragged edges (S not a multiple of the tile)
//   are masked in the kernel: no padding copy.
// * A kv tile whose every pair is masked is skipped, decided from the
//   tile's own min/max kv position against the q block's min/max position
//   (no assumption that pos == arange).  Causal masking then halves the
//   work, and a window bounds it by the window.  A tile that is allowed for
//   every pair skips the per-element mask.
// * Masked scores are -inf, and a row that has seen no allowed key yet
//   keeps m = -inf and adds p = 0: the reference's -2e38 sentinel instead
//   piles up exp(0) = 1 in such a row until a real score wipes it with
//   alpha = 0.  Every row with an allowed key gets the same output either
//   way; a row with none (only padding on the model's paths) gets 0.
// * bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate) for q.k and p.v,
//   4 warps of 16 q rows, 64-key tiles; p is rounded to bf16 for p.v as
//   the reference does (p.astype(v.dtype)), l sums p in f32.  V is staged
//   transposed so that both products read 32-bit fragment pairs from shared
//   memory without bank conflicts.  f32: scalar FMA, 4 threads per q row,
//   32-key tiles.  wgmma/TMA is later work.
//
// The kernel neither allocates nor synchronizes.

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

// Classifies kv tile [k0, k0 + 64) against the q block, from the tile's own
// positions (every warp computes the same answer).  Returns 0: every pair
// masked (skip); 1: some pairs masked (mask per element); 2: every pair
// allowed and no ragged edge.
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
  lo = warp_min(lo);
  hi = warp_max(hi);
  const long long w = p.window;
  if (lo > qmax) return 0;  // causal: every key after every query (or no key)
  if (w > 0 && (long long)hi <= (long long)qmin - w) return 0;  // all too old
  const bool full = hi <= qmin && (w <= 0 || (long long)lo > (long long)qmax - w) &&
                    k0 + tile <= p.Sk;
  return full ? 2 : 1;
}

__device__ __forceinline__ bool allowed(int qp, int kp, int window) {
  return kp <= qp && (window <= 0 || (long long)kp > (long long)qp - window);
}

// ------------------------------- bf16 ----------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo, the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// DP: D rounded up to a multiple of 16 (the columns past D are zeros).
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const Params p) {
  constexpr int BQ = 64, BKV = 64;
  constexpr int KSTR = DP + 8;   // Ks row stride (keys x d), bf16 elements
  constexpr int VSTR = BKV + 8;  // Vt row stride (d x keys)
  constexpr int NKC = DP / 16;   // k-chunks of q.k
  constexpr int NDT = DP / 8;    // n-tiles of p.v
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV * KSTR];
  __shared__ __align__(16) __nv_bfloat16 Vt[DP * VSTR];
  __shared__ int Kp[BKV];
  __shared__ int s_bounds[2];

  // One linear grid (q blocks fastest, then batch*head), so B*Hq is not
  // held to gridDim.y's 65,535.
  const int n_qb = (p.Sq + BQ - 1) / BQ;
  const int q0 = (n_qb - 1 - (int)(blockIdx.x % n_qb)) * BQ;  // most work first
  const int bh = blockIdx.x / n_qb;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const __nv_bfloat16* qg =
      (const __nv_bfloat16*)p.q + (long long)b * p.q_sb + (long long)h * p.q_sh;
  const __nv_bfloat16* kg =
      (const __nv_bfloat16*)p.k + (long long)b * p.k_sb + (long long)hk * p.k_sh;
  const __nv_bfloat16* vg =
      (const __nv_bfloat16*)p.v + (long long)b * p.v_sb + (long long)hk * p.v_sh;

  int qmin, qmax;
  block_q_bounds(p, q0, min(BQ, p.Sq - q0), s_bounds, qmin, qmax);

  // This thread's rows: r[0] = q0 + 16*warp + g and r[1] = r[0] + 8.
  int row[2], qp[2];
  row[0] = q0 + warp * 16 + g;
  row[1] = row[0] + 8;
  for (int i = 0; i < 2; ++i) qp[i] = row[i] < p.Sq ? p.qpos[row[i]] : INT_MIN;

  // q fragments (A of q.k), zero past Sq and past D.
  uint32_t qf[NKC][4];
#pragma unroll
  for (int kc = 0; kc < NKC; ++kc) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row[j & 1];
      const int col = kc * 16 + 2 * t4 + (j >> 1) * 8;
      uint32_t val = 0;
      if (r < p.Sq && col < p.D)
        val = *reinterpret_cast<const uint32_t*>(qg + (long long)r * p.q_ss + col);
      qf[kc][j] = val;
    }
  }

  float o[NDT][4];
#pragma unroll
  for (int i = 0; i < NDT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  const int n_kt = (p.Sk + BKV - 1) / BKV;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BKV;
    const int kind = classify_tile(p, k0, BKV, qmin, qmax);
    if (kind == 0) continue;  // uniform over the CTA: no barrier is skipped

    // Stage K (row-major, 16-byte chunks, consecutive threads along d) and
    // V (transposed, consecutive threads along the keys).
    constexpr int CH = DP / 8;
    for (int u = tid; u < BKV * CH; u += kThreads) {
      const int key = u / CH, d0 = (u % CH) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + key < p.Sk && d0 < p.D)
        val = *reinterpret_cast<const uint4*>(kg + (long long)(k0 + key) * p.k_ss + d0);
      *reinterpret_cast<uint4*>(&Ks[key * KSTR + d0]) = val;
    }
    for (int u = tid; u < BKV * CH; u += kThreads) {
      const int key = u % BKV, d0 = (u / BKV) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + key < p.Sk && d0 < p.D)
        val = *reinterpret_cast<const uint4*>(vg + (long long)(k0 + key) * p.v_ss + d0);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(d0 + i) * VSTR + key] = e[i];
    }
    if (tid < BKV) Kp[tid] = k0 + tid < p.Sk ? p.kpos[k0 + tid] : INT_MAX;
    __syncthreads();

    // s = q . k for this warp's 16 rows x 64 keys.
    float s[BKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = &Ks[(nt * 8 + g) * KSTR + 2 * t4];
#pragma unroll
      for (int kc = 0; kc < NKC; ++kc) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kc * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kc * 16 + 8);
        mma_bf16(s[nt], qf[kc], b0, b1);
      }
    }

    // Scale, mask, and the online softmax.  Element e of n-tile nt is row
    // r[e >> 1], key k0 + 8*nt + 2*t4 + (e & 1).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale;
        if (kind == 1) {
          const int key = nt * 8 + 2 * t4 + (e & 1);
          if (k0 + key >= p.Sk || !allowed(qp[e >> 1], Kp[key], p.window)) x = -INFINITY;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      mu[i] = m_new == -INFINITY ? 0.f : m_new;  // no allowed key yet: p = 0
      alpha[i] = __expf(m[i] - mu[i]);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pe[e] = __expf(s[nt][e] - mu[e >> 1]);
        l[e >> 1] += pe[e];
      }
      // A fragment of p.v: keys 16*kk..16*kk+15 are n-tiles 2kk and 2kk+1.
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(pe[0], pe[1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(pe[2], pe[3]);
    }
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
      const __nv_bfloat16* vr = &Vt[(dt * 8 + g) * VSTR + 2 * t4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vr + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vr + kk * 16 + 8);
        mma_bf16(o[dt], pa[kk], b0, b1);
      }
    }
    __syncthreads();  // the next tile's staging overwrites Ks, Vt, Kp
  }

  // Finalize: the row sum over the 4 threads of the row, then acc / l.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t = l[i];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    inv[i] = 1.f / fmaxf(t, 1e-30f);
  }
  __nv_bfloat16* og = (__nv_bfloat16*)p.out + (long long)b * p.o_sb + (long long)h * p.o_sh;
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
    const int col = dt * 8 + 2 * t4;
    if (col >= p.D) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= p.Sq) continue;
      *reinterpret_cast<uint32_t*>(og + (long long)row[i] * p.o_ss + col) =
          pack_bf16(o[dt][2 * i] * inv[i], o[dt][2 * i + 1] * inv[i]);
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
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  const long long ctas = (long long)((p.Sq + (dtype == 1 ? 63 : 31)) / (dtype == 1 ? 64 : 32)) *
                         p.B * p.Hq;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;  // gridDim.x's limit
  if (dtype == 1) {
    flash_fwd_bf16<DP><<<(unsigned)ctas, kThreads, 0, stream>>>(p);
  } else {
    flash_fwd_f32<DP><<<(unsigned)ctas, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// q, out: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D], each with its last dim
// contiguous and the given element strides; qpos int32[Sq], kpos int32[Sk].
// dtype 0: float32, 1: bfloat16.  window <= 0: none.  scale multiplies
// q . k (the reference's 1/sqrt(D), rounded to f32).  The caller checks
// D <= 128, D % 8 == 0, Hq % Hkv == 0, 16-byte aligned rows for bf16.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, const void* qpos,
    const void* kpos, int B, int Sq, int Sk, int Hq, int Hkv, int D,
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
  if (D <= 16) return (int)launch<16>(p, dtype, s);
  if (D <= 32) return (int)launch<32>(p, dtype, s);
  if (D <= 64) return (int)launch<64>(p, dtype, s);
  return (int)launch<128>(p, dtype, s);
}
