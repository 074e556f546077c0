// Shared by K4's forward (flash_attention/csrc/flash_attention.cu) and its
// backward K4b (flash_attention/csrc/flash_attention_bwd.cu): the mask
// rules, the tile plan, and the Hopper building blocks of the bf16 routes
// (mbarriers, TMA tensor maps and loads, wgmma with its shared-memory
// descriptors); flash_tf32.cuh builds the f32 routes on them.  Everything
// is in an anonymous namespace: each library keeps its own copy.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ int warp_min(int x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The kind of a kv tile whose real keys' positions lie in [kmin, kmax],
// against a q block whose real rows' positions lie in [qmin, qmax].  0:
// every pair masked (skip); 1: some pairs masked (mask per element); 2:
// every pair allowed and no ragged edge (`whole`: the tile has no key past
// Sk).  flash_attention/ref.py::tile_plan_ref is its plain version.
__device__ __forceinline__ int tile_kind(int kmin, int kmax, bool whole, int qmin, int qmax,
                                         int window) {
  const long long w = window;
  if (kmin > qmax) return 0;  // causal: every key after every query
  if (w > 0 && (long long)kmax <= (long long)qmin - w) return 0;  // all too old
  const bool full = kmax <= qmin && (w <= 0 || (long long)kmin > (long long)qmax - w) && whole;
  return full ? 2 : 1;
}

__device__ __forceinline__ bool allowed(int qp, int kp, int window) {
  return kp <= qp && (window <= 0 || (long long)kp > (long long)qp - window);
}

// ------------------------------ the plan --------------------------------

constexpr int kBQ = 128;   // q rows of a plan block (a bf16 forward CTA)
constexpr int kBKV = 128;  // keys of a plan tile (a bf16 kv tile)
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

// --------------------------- Hopper blocks ------------------------------

constexpr int kBoxCols = 64;  // one 128-byte swizzle atom of bf16

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

// A 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global memory to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load_1d(uint32_t dst, const void* src, int bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
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
// Waits until at most N committed wgmma groups of this warpgroup are still
// in flight (groups complete in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

// The same over 64 columns.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_F32(d)
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

// The m64k16 A fragments of a 64 x (16 * NK) accumulator d (m64n{16 NK}):
// k16 step kk holds columns 16kk..16kk+15, the accumulator's n8 chunks 2kk
// and 2kk + 1, rounded to bf16.
template <int NK>
__device__ __forceinline__ void to_a_fragments(const float (&d)[8 * NK], uint32_t (&a)[NK][4]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// ------------------------------ host side -------------------------------

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

// cuTensorMapEncodeTiled needs a current context.  A host thread that has
// made no CUDA runtime call yet has none (autograd's device thread, when
// it runs a backward first: the encoder then returns
// CUDA_ERROR_INVALID_CONTEXT), so an entry point that encodes first makes
// the runtime bind the current device's primary context.
inline int bind_context() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaSetDevice(dev);
  return (int)e;
}

// The tensor map of a [B, S, H, D] bf16 tensor with element strides (sb, ss,
// sh) and a contiguous last dim: dims (D, H, S, B), boxes of 64 columns x 1
// head x `rows` rows x 1 batch, 128-byte swizzle, zeros outside the tensor.
int encode(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, long long sb,
           long long ss, long long sh, int rows) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return kTensorMapError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, (cuuint32_t)rows, 1};
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

}  // namespace
