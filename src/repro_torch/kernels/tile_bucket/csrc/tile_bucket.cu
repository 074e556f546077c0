// Stable counting sort of edge slots by node tile: the rung tiling that
// feeds the tiled-degree kernel K1 (graph/partition.py::bucket_edges_by_tile),
// Hopper (sm_90a).
//
// Replaces no TPU kernel.  The reference buckets with XLA's sort and takes
// (src/repro/graph/partition.py::bucket_edges_by_tile); the port's plain
// version does the same with torch.sort(stable=True), int16 keys, a
// searchsorted and three gathers by the sort's order over three cat'ed
// slot arrays.  On an H100 that path takes about 14 ms at LiveJournal's
// first rung (137.8 M slots, 4,727 tiles of 1,024 nodes), half of a tiled
// solve's device work, and 5.4 GB of scratch and output.  These kernels
// compute the same permutation without a comparison sort or a gather.
//
// What is computed.  Slot s of S has a fixed target, source and edge index:
//   undirected (S = 2E): s < E  -> (dst[s],   src[s],   s)
//                        s >= E -> (src[s-E], dst[s-E], s-E)
//   directed   (S = E):          -> (dst[s],   src[s],   s)
// (kernels/tile_bucket/ref.py::slot_fields is the rule's plain version.)
// A slot's bucket is its tile, target / tile_size.  Slots are grouped by
// bucket and, within one, kept in increasing s: the permutation of the
// plain version's stable sort, so every field of the TiledEdges is bitwise
// the plain version's.  That order matters beyond equality: K1 folds runs
// of equal targets, and the sorted lower-endpoint half of each tile is what
// makes them long.
//
// Bound: bytes.  The least a tiling must move is src and dst read twice
// (to count, then to place), 16 B an edge, and three int32 fields written a
// slot, 12 B: 2.76 GB at the first rung, 0.82 ms at 3.35 TB/s.  These
// kernels take 4.3 ms there on an H100 (19% of it): the scatter is paced
// by its per-tile ranking, staging and barriers, not by its loads.
//
// Design against it:
//
// 1. Digits, so that writes stay whole.  A slot's place depends on 4,727
//    buckets; a one-pass scatter writes each 4-byte field on its own, and a
//    warp's stores then fall in 32 different sectors that L2 evicts
//    half-filled (a first version took 16 ms for that pass alone on an
//    H100).  So the buckets are sorted as a least-significant-digit radix
//    sort of 7-bit digits: ceil(bits(n_tiles) / 7) stable passes of 128
//    buckets each, 2 at the first rung, 1 from 128 tiles down.  Every pass
//    is stable, so the last one leaves slots in (bucket, s) order.
// 2. A pass is a count and a scatter over CTA tiles of 4,096 slots.  The
//    count kernel (persistent CTAs) counts each tile's digits in shared
//    memory and writes them to an int64 matrix [128, n_ctas]; its flat
//    inclusive scan (torch's cumsum_, in place, between the kernels) runs
//    in (digit, CTA tile) order, so the scan's entry before (d, tile) is
//    where the tile's run of digit d starts in the output.  The scatter
//    kernel ranks each slot among the slots of its digit in its tile
//    (below), stages the tile in shared memory in (digit, slot) order, and
//    writes it out so that neighbouring threads write neighbouring
//    positions: about 32 slots a digit a tile, 128 contiguous bytes a
//    field.
// 3. Ranks by ballot.  Each of the CTA's 16 warps owns 256 consecutive
//    slots of the tile, 8 rounds of 32.  The lanes of one digit in a round
//    are the AND of 7 ballots, one a digit bit; a slot's rank is its warp's
//    running count of its digit plus its peers in lower lanes.  A scan over
//    the 16 warps and the 128 digits in shared memory turns the per-warp
//    counts into the tile-local starts.  No atomics decide an order, so
//    every run gives the same bits.  The tile of a target is a multiply
//    and two shifts (a magic number made on the host), not a division.
// 4. Passes read what they need.  The first pass reads the edge arrays
//    through the slot rule: no cat, no keys, no slot-id arrays.  Later
//    passes read the previous pass's (target, source, edge index); the last
//    writes target_local.  Two buffers of S slots alternate (1.65 GB each
//    at the first rung).  The first count also counts each tile's slots
//    (in shared memory up to 16,384 tiles, else by global atomics); from
//    those one CTA writes tile_ptr and K1's chunk plan (the plan
//    TiledEdges.from_ragged builds, bitwise), in place of a dozen small
//    PyTorch ops a rung.
// 5. Targets outside [0, n_tiles * tile_size), which no graph of the port
//    holds, take bucket n_tiles: after tile_ptr[n_tiles], in slot order
//    (the plain version orders them by tile), with target_local = target -
//    floor(target / tile_size) * tile_size.
//
// The kernels neither allocate nor synchronize: the wrapper allocates the
// matrices, their scans and the buffers with torch.empty, the first count
// zeroes the tile counts (cudaMemsetAsync), and everything runs on the
// stream the wrapper passes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kFull = 0xffffffffu;
constexpr int kRadixBits = 7;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 8;                       // slots a lane holds
constexpr int kTileSlots = kThreads * kPerLane;   // 4,096 slots a CTA tile
constexpr int kWarpSlots = kTileSlots / kWarps;   // 256: a warp's 8 rounds
constexpr int kHistSmemTiles = 16384;             // tile counts in shared memory up to this

// Where a pass reads its slots: the edge arrays through the slot rule
// (first pass, `target` null), or the previous pass's slot arrays.
struct Slots {
  const int32_t* src;
  const int32_t* dst;
  const int32_t* target;
  const int32_t* source;
  const int32_t* edge_index;
  int64_t n_edges;
  int64_t n_slots;
};

struct Digits {
  int tile_size;
  int n_tiles;
  int shift;  // the pass's digit is (bucket >> shift) & (kRadix - 1)
  // n / tile_size for any uint32 n as (t + ((n - t) >> sh1)) >> sh2, t =
  // umulhi(magic, n) (Hacker's Delight 10-8): a runtime division is a
  // few dozen instructions, and it is taken once a slot a kernel.
  uint32_t magic;
  int sh1;
  int sh2;
};

__device__ __forceinline__ uint32_t bucket_of(int32_t target, const Digits& dg) {
  const uint32_t n = (uint32_t)target, t = __umulhi(dg.magic, n);
  const uint32_t tile = (t + ((n - t) >> dg.sh1)) >> dg.sh2;
  return (target >= 0 && tile < (uint32_t)dg.n_tiles) ? tile : (uint32_t)dg.n_tiles;
}

__device__ __forceinline__ int32_t load_target(const Slots& in, int64_t s) {
  if (in.target != nullptr) return __ldg(in.target + s);
  return s < in.n_edges ? __ldg(in.dst + s) : __ldg(in.src + (s - in.n_edges));
}

__device__ __forceinline__ void load_slot(const Slots& in, int64_t s, int32_t& t, int32_t& so,
                                          int32_t& ei) {
  if (in.target != nullptr) {
    t = __ldg(in.target + s);
    so = __ldg(in.source + s);
    ei = __ldg(in.edge_index + s);
    return;
  }
  const bool second = s >= in.n_edges;  // the second half of an undirected slot array
  const int64_t e = second ? s - in.n_edges : s;
  const int32_t a = __ldg(in.src + e), b = __ldg(in.dst + e);
  t = second ? a : b;
  so = second ? b : a;
  ei = (int32_t)e;
}

// Adds 1 at key for every lane whose key is valid; where the whole warp
// shares one valid key, one add of 32 from lane 0.
__device__ __forceinline__ void count_warp(uint32_t* cnt, uint32_t key, bool valid, int lane) {
  const uint32_t k = valid ? key : (0x80000000u | (uint32_t)lane);
  if (__all_sync(kFull, k == __shfl_sync(kFull, k, 0))) {
    if (lane == 0) atomicAdd(cnt + k, 32u);
  } else if (valid) {
    atomicAdd(cnt + key, 1u);
  }
}

__device__ __forceinline__ void count_warp_global(unsigned long long* hist, uint32_t key,
                                                  bool valid, int lane) {
  const uint32_t k = valid ? key : (0x80000000u | (uint32_t)lane);
  const uint32_t first = __shfl_sync(kFull, k, 0);
  const uint32_t peers = __all_sync(kFull, k == first) ? kFull : __match_any_sync(kFull, k);
  if (valid && __ffs(peers) - 1 == lane) atomicAdd(hist + key, (unsigned long long)__popc(peers));
}

// The valid lanes whose digit equals this lane's, from one ballot a bit
// (invalid lanes match none and get none).
__device__ __forceinline__ uint32_t digit_peers(uint32_t d, bool valid) {
  uint32_t peers = __ballot_sync(kFull, valid);
#pragma unroll
  for (int bit = 0; bit < kRadixBits; ++bit) {
    const uint32_t ones = __ballot_sync(kFull, (d >> bit) & 1u);
    peers &= ((d >> bit) & 1u) ? ones : ~ones;
  }
  return peers;
}

// counts[d * n_ct + ct] = slots of CTA tile ct whose digit is d; on the
// first pass (hist non-null) also hist[b] += slots of tile b.
__global__ void __launch_bounds__(kThreads)
digit_count_kernel(Slots in, Digits dg, int64_t n_ct, int64_t* __restrict__ counts,
                   unsigned long long* __restrict__ hist, int hist_in_smem) {
  extern __shared__ uint32_t smem[];
  uint32_t* cnt = smem;           // [kRadix]
  uint32_t* h = smem + kRadix;    // [n_tiles] where hist_in_smem
  const int tid = threadIdx.x, lane = tid & 31;
  const bool local_hist = hist != nullptr && hist_in_smem;
  if (local_hist) {
    for (int i = tid; i < dg.n_tiles; i += kThreads) h[i] = 0u;
  }
  for (int64_t ct = blockIdx.x; ct < n_ct; ct += gridDim.x) {
    for (int i = tid; i < kRadix; i += kThreads) cnt[i] = 0u;
    __syncthreads();
    const int64_t base = ct * kTileSlots;
    int32_t t[kPerLane];
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {
      const int64_t s = base + r * kThreads + tid;
      t[r] = s < in.n_slots ? load_target(in, s) : 0;
    }
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {
      const bool valid = base + r * kThreads + tid < in.n_slots;
      const uint32_t b = bucket_of(t[r], dg);
      count_warp(cnt, (b >> dg.shift) & (kRadix - 1), valid, lane);
      if (hist != nullptr) {
        const bool in_tile = valid && b < (uint32_t)dg.n_tiles;
        if (local_hist) {
          count_warp(h, b, in_tile, lane);
        } else {
          count_warp_global(hist, b, in_tile, lane);
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < kRadix; i += kThreads) counts[(int64_t)i * n_ct + ct] = cnt[i];
    __syncthreads();
  }
  if (local_hist) {
    for (int i = tid; i < dg.n_tiles; i += kThreads) {
      if (h[i] != 0u) atomicAdd(hist + i, (unsigned long long)h[i]);
    }
  }
}

// Places CTA tile blockIdx.x's slots: output position = the scan's entry
// before (digit, tile) + the slot's rank among the tile's slots of its digit.
__global__ void __launch_bounds__(kThreads)
digit_scatter_kernel(Slots in, Digits dg, int64_t n_ct, const int64_t* __restrict__ scan,
                     int last, int32_t* __restrict__ out_t,
                     int32_t* __restrict__ out_s, int32_t* __restrict__ out_e) {
  extern __shared__ int64_t smem64[];
  int64_t* gbase = smem64;                                       // [kRadix]
  uint32_t* wcnt = reinterpret_cast<uint32_t*>(gbase + kRadix);  // [kWarps][kRadix]
  uint32_t* dstart = wcnt + kWarps * kRadix;                     // [kRadix]
  int32_t* st_t = reinterpret_cast<int32_t*>(dstart + kRadix);   // [kTileSlots] each
  int32_t* st_s = st_t + kTileSlots;
  int32_t* st_e = st_s + kTileSlots;
  uint8_t* st_d = reinterpret_cast<uint8_t*>(st_e + kTileSlots);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t ct = blockIdx.x;
  const int64_t base = ct * kTileSlots + (int64_t)warp * kWarpSlots;
  uint32_t* mine = wcnt + warp * kRadix;

  int32_t t[kPerLane], so[kPerLane], ei[kPerLane];
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int64_t s = base + r * 32 + lane;
    if (s < in.n_slots) {
      load_slot(in, s, t[r], so[r], ei[r]);
    } else {
      t[r] = so[r] = ei[r] = 0;
    }
  }
  for (int i = lane; i < kRadix; i += 32) mine[i] = 0u;
  __syncwarp();
  // Rank each slot among its warp's slots of the same digit, in slot order.
  uint32_t packed[kPerLane];  // digit << 16 | rank in the warp
  const uint32_t below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const bool valid = base + r * 32 + lane < in.n_slots;
    const uint32_t d = (bucket_of(t[r], dg) >> dg.shift) & (kRadix - 1);
    const uint32_t peers = digit_peers(d, valid);
    const uint32_t before = valid ? mine[d] : 0u;
    __syncwarp();
    if (valid && __ffs(peers) - 1 == lane) mine[d] = before + __popc(peers);
    __syncwarp();
    packed[r] = valid ? (d << 16) | (before + __popc(peers & below)) : kFull;
  }
  __syncthreads();
  // Per digit: the warps' exclusive prefix, the tile's count, and where the
  // tile's run of the digit starts in the output.
  if (tid < kRadix) {
    uint32_t run = 0u;
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = wcnt[w * kRadix + tid];
      wcnt[w * kRadix + tid] = run;
      run += c;
    }
    dstart[tid] = run;
    const int64_t idx = (int64_t)tid * n_ct + ct;
    gbase[tid] = idx > 0 ? scan[idx - 1] : 0;
  }
  __syncthreads();
  if (tid < 32) {  // exclusive scan of the 128 digit counts, 4 a lane
    uint32_t c[kRadix / 32], sum = 0u;
#pragma unroll
    for (int j = 0; j < kRadix / 32; ++j) {
      c[j] = dstart[tid * (kRadix / 32) + j];
      sum += c[j];
    }
    uint32_t incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    uint32_t at = incl - sum;
#pragma unroll
    for (int j = 0; j < kRadix / 32; ++j) {
      dstart[tid * (kRadix / 32) + j] = at;
      at += c[j];
    }
  }
  __syncthreads();
  if (tid < kRadix) gbase[tid] -= dstart[tid];  // where staged index 0 of the digit would go
  // Stage the tile in (digit, slot) order.
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    if (packed[r] == kFull) continue;
    const uint32_t d = packed[r] >> 16;
    const uint32_t local = dstart[d] + mine[d] + (packed[r] & 0xffffu);
    int32_t value = t[r];
    if (last) {
      const uint32_t b = bucket_of(t[r], dg);
      int64_t tile = (int64_t)b;
      if (b == (uint32_t)dg.n_tiles) {  // outside the tiles: floor division
        tile = t[r] >= 0 ? t[r] / dg.tile_size
                         : -(((int64_t)dg.tile_size - 1 - t[r]) / dg.tile_size);
      }
      value = (int32_t)((int64_t)t[r] - tile * dg.tile_size);
    }
    st_t[local] = value;
    st_s[local] = so[r];
    st_e[local] = ei[r];
    st_d[local] = (uint8_t)d;
  }
  __syncthreads();
  // Write out: neighbouring threads, neighbouring positions within a digit.
  const int64_t left = in.n_slots - ct * kTileSlots;
  const int n = left < kTileSlots ? (int)left : kTileSlots;
  for (int i = tid; i < n; i += kThreads) {
    const int64_t pos = gbase[st_d[i]] + i;
    out_t[pos] = st_t[i];
    out_s[pos] = st_s[i];
    out_e[pos] = st_e[i];
  }
}

constexpr int kChunkThreads = 1024;

// tile_ptr and K1's chunk plan (TiledEdges.from_ragged, bitwise) from each
// tile's slot count, in one CTA: tile_ptr[t] = the slots of the tiles
// before t; tile t takes max(1, ceil(count / chunk_slots)) plan entries,
// (t, tile_ptr[t] + r * chunk_slots) for r = 0, 1, ..., after those of
// the tiles before it; entries past the last tile's are (-1, 0), up to
// `bound`.  Each thread takes a strip of consecutive tiles.
__global__ void __launch_bounds__(kChunkThreads)
chunk_plan_kernel(const unsigned long long* __restrict__ hist, int n_tiles, long long chunk_slots,
                  long long bound, int64_t* __restrict__ tile_ptr, int32_t* __restrict__ chunk_tile,
                  int64_t* __restrict__ chunk_start) {
  __shared__ unsigned long long warp_slots[kChunkThreads / 32], warp_pieces[kChunkThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n_tiles + kChunkThreads - 1) / kChunkThreads;
  const int t0 = tid * per < n_tiles ? tid * per : n_tiles;
  const int t1 = t0 + per < n_tiles ? t0 + per : n_tiles;
  const auto pieces = [&](unsigned long long c) {
    return c == 0ULL ? 1ULL : (c + chunk_slots - 1) / chunk_slots;
  };
  unsigned long long slots = 0ULL, n_pieces = 0ULL;
  for (int t = t0; t < t1; ++t) {
    slots += hist[t];
    n_pieces += pieces(hist[t]);
  }
  // Exclusive scan of the strips' (slots, pieces) over the CTA.
  unsigned long long a = slots, b = n_pieces;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long ya = __shfl_up_sync(kFull, a, d), yb = __shfl_up_sync(kFull, b, d);
    if (lane >= d) {
      a += ya;
      b += yb;
    }
  }
  if (lane == 31) {
    warp_slots[warp] = a;
    warp_pieces[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    unsigned long long wa = warp_slots[lane], wb = warp_pieces[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long ya = __shfl_up_sync(kFull, wa, d), yb = __shfl_up_sync(kFull, wb, d);
      if (lane >= d) {
        wa += ya;
        wb += yb;
      }
    }
    warp_slots[lane] = wa;  // inclusive over the warps
    warp_pieces[lane] = wb;
  }
  __syncthreads();
  unsigned long long slot = a - slots + (warp > 0 ? warp_slots[warp - 1] : 0ULL);
  unsigned long long entry = b - n_pieces + (warp > 0 ? warp_pieces[warp - 1] : 0ULL);
  for (int t = t0; t < t1; ++t) {
    tile_ptr[t] = (int64_t)slot;
    const unsigned long long n = pieces(hist[t]);
    for (unsigned long long r = 0; r < n; ++r) {
      chunk_tile[entry + r] = t;
      chunk_start[entry + r] = (int64_t)(slot + r * chunk_slots);
    }
    slot += hist[t];
    entry += n;
  }
  const unsigned long long total_pieces = warp_pieces[kChunkThreads / 32 - 1];
  if (tid == 0) tile_ptr[n_tiles] = (int64_t)warp_slots[kChunkThreads / 32 - 1];
  for (long long i = (long long)total_pieces + tid; i < bound; i += kChunkThreads) {
    chunk_tile[i] = -1;
    chunk_start[i] = 0;
  }
}

constexpr size_t kScatterSmem = kRadix * sizeof(int64_t) + (kWarps + 1) * kRadix * sizeof(uint32_t) +
                                (size_t)kTileSlots * (3 * sizeof(int32_t) + 1);

// One resident wave of `kernel`'s CTAs, at most n_ct.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, int64_t n_ct, long long* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess) {
    return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess) {
    return err;
  }
  *grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (*grid > n_ct) *grid = n_ct;
  return cudaSuccess;
}

Digits make_digits(int tile_size, int n_tiles, int pass) {
  int l = 0;
  while ((1LL << l) < (long long)tile_size) ++l;  // ceil(log2(tile_size))
  const unsigned long long magic =
      ((1ULL << 32) * ((1ULL << l) - (unsigned long long)tile_size)) / tile_size + 1;
  return Digits{tile_size, n_tiles, pass * kRadixBits, (uint32_t)magic, l < 1 ? l : 1,
                l > 1 ? l - 1 : 0};
}

int bit_length(long long x) {
  int n = 0;
  while (x > 0) {
    ++n;
    x >>= 1;
  }
  return n;
}

bool valid_shape(long long n_edges, int halves, int tile_size, int n_tiles) {
  return n_edges >= 0 && n_edges <= 0x7fffffffLL && (halves == 1 || halves == 2) &&
         tile_size >= 1 && n_tiles >= 0 && n_tiles < 0x7fffffff;
}

Slots make_slots(const void* src, const void* dst, const void* in_t, const void* in_s,
                 const void* in_e, long long n_edges, int halves) {
  return Slots{(const int32_t*)src, (const int32_t*)dst, (const int32_t*)in_t,
               (const int32_t*)in_s, (const int32_t*)in_e, (int64_t)n_edges,
               (int64_t)n_edges * halves};
}

}  // namespace

// The plan of a tiling into `n_tiles` tiles: plan[0] the digit passes,
// plan[1] the slots of a CTA tile (4,096), plan[2] the digits a pass
// (128).  The wrapper sizes each pass's count matrix [plan[2], ceil(S /
// plan[1])] from it.  Returns a cudaError_t.
extern "C" int tile_bucket_plan(int n_tiles, int* plan) {
  if (n_tiles < 0 || n_tiles >= 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int passes = (bit_length(n_tiles) + kRadixBits - 1) / kRadixBits;
  plan[0] = passes > 0 ? passes : 1;
  plan[1] = kTileSlots;
  plan[2] = kRadix;
  return (int)cudaSuccess;
}

// Pass `pass`'s count: counts (int64 [128, n_ct]) of the slots' digits by
// CTA tile, read from the edge arrays (in_t null) or from the previous
// pass's slot arrays; hist (int64 [n_tiles], zeroed) gets each tile's slot
// count where non-null.  Returns cudaGetLastError().
extern "C" int tile_bucket_count(const void* src, const void* dst, const void* in_t,
                                 long long n_edges, int halves, int tile_size, int n_tiles,
                                 int pass, void* counts, void* hist, void* stream) {
  if (!valid_shape(n_edges, halves, tile_size, n_tiles) || pass < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Slots in = make_slots(src, dst, in_t, nullptr, nullptr, n_edges, halves);
  const Digits dg = make_digits(tile_size, n_tiles, pass);
  const int64_t n_ct = (in.n_slots + kTileSlots - 1) / kTileSlots;
  if (n_ct == 0) {
    return hist != nullptr ? (int)cudaMemsetAsync(hist, 0, (size_t)n_tiles * sizeof(int64_t),
                                                  (cudaStream_t)stream)
                           : (int)cudaSuccess;
  }
  const int hist_in_smem = hist != nullptr && n_tiles <= kHistSmemTiles;
  const size_t smem = (size_t)(kRadix + (hist_in_smem ? n_tiles : 0)) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(digit_count_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (hist != nullptr && (err = cudaMemsetAsync(hist, 0, (size_t)n_tiles * sizeof(int64_t),
                                                (cudaStream_t)stream)) != cudaSuccess) {
    return (int)err;
  }
  long long grid = 0;
  if ((err = persistent_grid(digit_count_kernel, smem, n_ct, &grid)) != cudaSuccess) return (int)err;
  digit_count_kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(
      in, dg, n_ct, (int64_t*)counts, (unsigned long long*)hist, hist_in_smem);
  return (int)cudaGetLastError();
}

// Pass `pass`'s scatter: places every slot at the scan's entry before its
// (digit, CTA tile) plus its rank there, writing (target, source,
// edge_index), or (target_local, source, edge_index) where `last`.
// Returns cudaGetLastError().
extern "C" int tile_bucket_scatter(const void* src, const void* dst, const void* in_t,
                                   const void* in_s, const void* in_e, long long n_edges,
                                   int halves, int tile_size, int n_tiles, int pass, int last,
                                   const void* scan, void* out_t, void* out_s,
                                   void* out_e, void* stream) {
  if (!valid_shape(n_edges, halves, tile_size, n_tiles) || pass < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Slots in = make_slots(src, dst, in_t, in_s, in_e, n_edges, halves);
  const Digits dg = make_digits(tile_size, n_tiles, pass);
  const int64_t n_ct = (in.n_slots + kTileSlots - 1) / kTileSlots;
  if (n_ct == 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      digit_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kScatterSmem);
  if (err != cudaSuccess) return (int)err;
  digit_scatter_kernel<<<(unsigned)n_ct, kThreads, kScatterSmem, (cudaStream_t)stream>>>(
      in, dg, n_ct, (const int64_t*)scan, last, (int32_t*)out_t,
      (int32_t*)out_s, (int32_t*)out_e);
  return (int)cudaGetLastError();
}

// tile_ptr (int64 [n_tiles + 1]) and K1's chunk plan, chunk_tile (int32
// [bound]) and chunk_start (int64 [bound]), from hist (int64 [n_tiles], the
// first count's tile counts): the plan TiledEdges.from_ragged builds, in
// one CTA.  Returns cudaGetLastError().
extern "C" int tile_bucket_chunks(const void* hist, int n_tiles, long long chunk_slots,
                                  long long bound, void* tile_ptr, void* chunk_tile,
                                  void* chunk_start, void* stream) {
  if (n_tiles < 0 || n_tiles >= 0x7fffffff || chunk_slots < 1 || bound < 0) {
    return (int)cudaErrorInvalidValue;
  }
  chunk_plan_kernel<<<1, kChunkThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)hist, n_tiles, chunk_slots, bound, (int64_t*)tile_ptr,
      (int32_t*)chunk_tile, (int64_t*)chunk_start);
  return (int)cudaGetLastError();
}
