// ESC tail for Hopper (sm_90a): sort + accumulate + left-pack of aligned
// power-of-two segments.
//
// Replaces two TPU kernels with one body (_tail_kernel, :200):
//   * mh_spgemm_tpu/ops/esc_tail.py:234 esc_tail_flat, over flat planes
//     whose empty slots already carry the key 2^31-1;
//   * mh_spgemm_tpu/ops/esc_tail.py:286 esc_tail, over [rows, w2] slabs
//     with a per-row count row_len: slot j of row r is treated as empty
//     (key 2^31-1, value 0) when j >= row_len[r], before the sort.
// What it computes, per aligned segment of
// w2 slots (2 <= w2 <= 65536, a power of two): the distinct keys in
// ascending order with the sum of the values of each key, left-packed,
// followed by 2^31-1 keys with value 0; the key 2^31-1 marks an empty
// input slot.  It also writes each segment's output count.
//
// Bound on the card: bytes.  Each slot is read once (4 B key + 8 B f64
// value) and written once (4 + 8 B), 24 B a slot in f64; the work per
// slot is O(log^2 w2) compare-exchanges, far under the card's integer
// rate.  Every path keeps the intermediates out of device memory where
// they fit, and every path computes the same thing in the same order:
//   1. bitonic sort of each aligned segment by key, ties never swapping
//      (the XOR partner of a compare-exchange never leaves the segment,
//      so one network sorts all segments of a tile at once);
//   2. run heads: slot whose key differs from its left neighbour;
//   3. the segmented Hillis-Steele passes v[i] += v[i-d] for d = 1, 2,
//      4, ... < w2 where key[i-d] == key[i], and the inclusive count of
//      valid heads (a run's output rank + 1);
//   4. the last slot of each valid run writes (key, sum) at its rank;
//      slots at or past the segment's count write (2^31-1, 0).
// Same network and same passes give the same permutation and the same
// order of additions, so every path (and the plain version) agrees bit
// for bit.  Three paths, by width:
//
//   * warp (w2 <= 256, tail_warp): one warp holds a tile of 256 slots,
//     8 a lane (slot lane*8 + r in register r), with 256 / w2 whole
//     segments.  Block barriers and a shared-memory round trip per
//     stage would bound it (the tile path below reads and writes every
//     slot in shared memory at each of the 36 stages), so the network
//     runs in registers: partners 1-4 apart are compare-exchanges inside
//     a lane, partners 8-128 apart __shfl_xor_sync across lanes, each a
//     min or max of the keys that moves the slot index only where the
//     key changed.  The sort moves (key, slot index) only; the values
//     wait in a per-warp stage in shared memory (2 KB in f64), loaded
//     with 16-byte lane loads, and each is fetched once in sorted order.
//     A max-scan of run-head positions turns key[i-d] == key[i] into
//     i - d >= head(i), so the scan passes move values only (shuffles
//     for d >= 8).  The packed output is staged in shared memory and
//     stored with 16-byte lane stores.  Warps are independent: no
//     __syncthreads.  What bounds it is instruction issue in the
//     network, chiefly its 15 cross-lane stages; the loads, stage and
//     stores alone run near the byte bound.
//   * tile (512 <= w2 <= 8192, tail_smem): a block loads a tile of
//     max(w2, 1024) slots into dynamic shared memory once and sorts,
//     scans and packs there, with a __syncthreads per stage; bounded by
//     those barriers and the shared-memory traffic of every stage.
//   * global (w2 > 8192, tail_global): a segment does not fit one
//     block's shared memory; the same algorithm in a global scratch
//     buffer that the caller allocates, one block per segment.
//
// The slab form (row_len given) differs only in the load: the TPU kernel
// masked the keys inside the kernel too, so its callers could hand over
// slabs whose slots past a row's count hold whatever the fill left there.
//
// Plain C interface for ctypes.  Each function launches on the given
// stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEmpty = 0x7fffffff;
constexpr int kThreads = 1024;
constexpr int kMinTile = 1024;
constexpr int kSmemMaxW2 = 8192;    // widest segment held in shared memory
constexpr int kWarpMaxW2 = 256;     // widest segment of the warp path
constexpr int kWarpSlots = 256;     // slots of one warp's tile, 8 a lane
constexpr int kWarpThreads = 128;   // the warp path's blocks: 4 warps
constexpr unsigned kFullMask = 0xffffffffu;

// Slot g is live unless a row count is given and g lies at or past its
// segment's (row's) count.
__device__ __forceinline__ bool slot_live(const int* row_len, long long g,
                                          int w2) {
  return row_len == nullptr ||
         static_cast<int>(g & (w2 - 1)) < row_len[g / w2];
}

// Sort each aligned w2-wide segment of key[0..n) ascending, moving val.
template <typename V>
__device__ void bitonic_segments(int* key, V* val, int n, int w2) {
  for (int k = 2; k <= w2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (n >> 1); p += blockDim.x) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int l = i | j;
        // the final merge (k == w2) is ascending everywhere; earlier
        // stages alternate by bit k of the in-segment index, which equals
        // bit k of i because segments are aligned
        const bool asc = (k == w2) || ((i & k) == 0);
        const int ki = key[i];
        const int kl = key[l];
        if (ki != kl && ((ki > kl) == asc)) {
          key[i] = kl;
          key[l] = ki;
          const V vi = val[i];
          val[i] = val[l];
          val[l] = vi;
        }
      }
      __syncthreads();
    }
  }
}

// Steps 2-4 on sorted segments in buffers of n slots; the buffers start
// at global slot g0 of the flat arrays.  v0/c0 are input, v1/c1 scratch.
template <typename V>
__device__ void accumulate_and_pack(const int* key, V* v0, V* v1, int* c0,
                                    int* c1, int n, int w2, long long g0,
                                    long long slots, int* out_key,
                                    V* out_val, int* out_count) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int idx = i & (w2 - 1);
    const int k = key[i];
    c0[i] = (k != kEmpty && (idx == 0 || key[i - 1] != k)) ? 1 : 0;
  }
  __syncthreads();
  V* va = v0;
  V* vb = v1;
  int* ca = c0;
  int* cb = c1;
  for (int d = 1; d < w2; d <<= 1) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      V v = va[i];
      int c = ca[i];
      if ((i & (w2 - 1)) >= d) {
        if (key[i - d] == key[i]) v += va[i - d];
        c += ca[i - d];
      }
      vb[i] = v;
      cb[i] = c;
    }
    __syncthreads();
    V* tv = va; va = vb; vb = tv;
    int* tc = ca; ca = cb; cb = tc;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int idx = i & (w2 - 1);
    const int s0 = i - idx;
    const long long gs = g0 + s0;            // global start of segment
    if (gs >= slots) continue;               // padding segment of a tile
    const int count = ca[s0 + w2 - 1];
    const int k = key[i];
    const bool run_end =
        k != kEmpty && (idx == w2 - 1 || key[i + 1] != k);
    if (run_end) {
      out_key[gs + ca[i] - 1] = k;
      out_val[gs + ca[i] - 1] = va[i];
    }
    if (idx >= count) {
      out_key[g0 + i] = kEmpty;
      out_val[g0 + i] = V(0);
    }
    if (idx == 0) out_count[gs / w2] = count;
  }
}

// w2 <= kSmemMaxW2: one tile of `tile` slots per block, in shared memory.
template <typename V>
__global__ void __launch_bounds__(kThreads)
tail_smem(const int* __restrict__ keys, const V* __restrict__ vals,
          const int* __restrict__ row_len, int* out_key, V* out_val,
          int* out_count, long long slots, int w2, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  V* v0 = reinterpret_cast<V*>(smem);
  V* v1 = v0 + tile;
  int* key = reinterpret_cast<int*>(v1 + tile);
  int* c0 = key + tile;
  int* c1 = c0 + tile;
  const long long g0 = static_cast<long long>(blockIdx.x) * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const long long g = g0 + i;
    const bool live = g < slots && slot_live(row_len, g, w2);
    key[i] = live ? keys[g] : kEmpty;
    v0[i] = live ? vals[g] : V(0);
  }
  __syncthreads();
  bitonic_segments(key, v0, tile, w2);
  accumulate_and_pack(key, v0, v1, c0, c1, tile, w2, g0, slots, out_key,
                      out_val, out_count);
}

// w2 > kSmemMaxW2: one segment per block, worked in global scratch laid
// out as [v0 | v1 | key | c0 | c1], each `slots` long.
template <typename V>
__global__ void __launch_bounds__(kThreads)
tail_global(const int* __restrict__ keys, const V* __restrict__ vals,
            const int* __restrict__ row_len, int* out_key, V* out_val,
            int* out_count, long long slots, int w2,
            unsigned char* scratch) {
  const long long g0 = static_cast<long long>(blockIdx.x) * w2;
  V* v0 = reinterpret_cast<V*>(scratch) + g0;
  V* v1 = reinterpret_cast<V*>(scratch) + slots + g0;
  int* key = reinterpret_cast<int*>(reinterpret_cast<V*>(scratch) +
                                    2 * slots) + g0;
  int* c0 = key + slots;
  int* c1 = c0 + slots;
  for (int i = threadIdx.x; i < w2; i += blockDim.x) {
    const bool live = slot_live(row_len, g0 + i, w2);
    key[i] = live ? keys[g0 + i] : kEmpty;
    v0[i] = live ? vals[g0 + i] : V(0);
  }
  __syncthreads();
  bitonic_segments(key, v0, w2, w2);
  accumulate_and_pack(key, v0, v1, c0, c1, w2, w2, g0, slots, out_key,
                      out_val, out_count);
}

// Index in a warp's stage of slot s, for elements of T: 16-byte chunks
// XOR-swizzled by bits 3-5 of the chunk index, so that 32 lanes reading
// one register position of consecutive sorted slots (lane*8 + r) spread
// over the banks, while each chunk stays whole for 16-byte copies.
template <typename T>
__device__ __forceinline__ int stage_pos(int s) {
  constexpr int per = 16 / sizeof(T);
  return s ^ ((((s / per) >> 3) & 7) * per);
}

// One warp's shared-memory stage: the tile's values in load order, then
// the packed output (keys and values).
template <typename V>
struct __align__(16) WarpStage {
  V val[kWarpSlots];
  int key[kWarpSlots];
};

// w2 <= kWarpMaxW2: one tile of 256 slots per warp, in registers.  `vec`
// says that all four planes are 16-byte aligned, so that a whole tile
// moves with 16-byte lane loads and stores; the last, partial tile and
// unaligned planes go slot by slot.
template <typename V, int kLogW2>
__global__ void __launch_bounds__(kWarpThreads)
tail_warp(const int* __restrict__ keys, const V* __restrict__ vals,
          const int* __restrict__ row_len, int* __restrict__ out_key,
          V* __restrict__ out_val, int* __restrict__ out_count,
          long long slots, bool vec) {
  constexpr int kW2 = 1 << kLogW2;
  constexpr int kValChunks = kWarpSlots * sizeof(V) / 16;
  __shared__ WarpStage<V> stages[kWarpThreads / 32];
  WarpStage<V>& st = stages[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const long long g0 =
      (static_cast<long long>(blockIdx.x) * (kWarpThreads / 32) +
       (threadIdx.x >> 5)) * kWarpSlots;
  if (g0 >= slots) return;
  const int n = slots - g0 < kWarpSlots ? static_cast<int>(slots - g0)
                                        : kWarpSlots;
  const bool whole = vec && n == kWarpSlots;

  // 1. keys into registers (slot lane*8 + r), values into the stage
  int key[8];
  if (whole) {
    const int4* kp = reinterpret_cast<const int4*>(keys + g0) + 2 * lane;
    const int4 a = kp[0];
    const int4 b = kp[1];
    key[0] = a.x; key[1] = a.y; key[2] = a.z; key[3] = a.w;
    key[4] = b.x; key[5] = b.y; key[6] = b.z; key[7] = b.w;
    const int4* vp = reinterpret_cast<const int4*>(vals + g0);
    int4* sp = reinterpret_cast<int4*>(st.val);
#pragma unroll
    for (int q = 0; q < kValChunks / 32; ++q) {
      const int c = q * 32 + lane;
      sp[c ^ ((c >> 3) & 7)] = vp[c];
    }
  } else {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int s = lane * 8 + r;
      key[r] = s < n ? keys[g0 + s] : kEmpty;
    }
    for (int s = lane; s < kWarpSlots; s += 32) {
      st.val[stage_pos<V>(s)] = s < n ? vals[g0 + s] : V(0);
    }
  }
  if (row_len != nullptr) {
    if constexpr (kW2 >= 8) {           // a lane's 8 slots share one row
      const int s = lane * 8;
      const int len = s < n ? row_len[(g0 + s) >> kLogW2] : 0;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (((s + r) & (kW2 - 1)) >= len) key[r] = kEmpty;
      }
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int s = lane * 8 + r;
        if (s < n && (s & (kW2 - 1)) >= row_len[(g0 + s) >> kLogW2]) {
          key[r] = kEmpty;
        }
      }
    }
  }

  // 2. the bitonic network on (key, slot index).  Each compare-exchange
  // keeps the minimum or the maximum of the two keys and moves the slot
  // index only where its key changed, so ties never swap.
  int src[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) src[r] = lane * 8 + r;
#pragma unroll
  for (int lk = 1; lk <= kLogW2; ++lk) {
    const int k = 1 << lk;
    // a run of k slots sorts ascending where bit k of its position is
    // clear; the last merge (k == w2) ascends everywhere
    const bool lane_asc = k == kW2 || (lane & (k >> 3)) == 0;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (j >= 8) {                     // partner in lane ^ (j / 8)
        const bool keep_min = ((lane & (j >> 3)) == 0) == lane_asc;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int pk = __shfl_xor_sync(kFullMask, key[r], j >> 3);
          const int ps = __shfl_xor_sync(kFullMask, src[r], j >> 3);
          const int nk = keep_min ? min(key[r], pk) : max(key[r], pk);
          if (nk != key[r]) src[r] = ps;
          key[r] = nk;
        }
      } else {                          // partner in register r ^ j
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if ((r & j) != 0) continue;
          const int l = r | j;
          const bool asc = k >= 8 ? lane_asc : (k == kW2 || (r & k) == 0);
          const int a = key[r];
          const int b = key[l];
          key[r] = asc ? min(a, b) : max(a, b);
          key[l] = asc ? max(a, b) : min(a, b);
          if (key[r] != a) {
            const int t = src[r]; src[r] = src[l]; src[l] = t;
          }
        }
      }
    }
  }
  __syncwarp();

  // 3. values in sorted order; empty slots add nothing to a written sum
  V v[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    v[r] = key[r] == kEmpty ? V(0) : st.val[stage_pos<V>(src[r])];
  }

  // 4. run heads: head[r] is the tile position where slot r's run
  // starts, so key[i-d] == key[i] exactly when i - d >= head[r]
  const int left_key = __shfl_up_sync(kFullMask, key[7], 1);
  unsigned starts = 0;                  // bit r: slot r starts a run
  unsigned valid_starts = 0;            // ... of a key other than 2^31-1
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const bool start = ((lane * 8 + r) & (kW2 - 1)) == 0 ||
                       (r == 0 ? left_key : key[r - 1]) != key[r];
    starts |= static_cast<unsigned>(start) << r;
    valid_starts |= static_cast<unsigned>(start && key[r] != kEmpty) << r;
  }
  int head[8];
  int h = -1;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if ((starts >> r) & 1) h = lane * 8 + r;
    head[r] = h;
  }
  int rank_in = 0;                      // valid heads in the segment's
  if constexpr (kW2 > 8) {              // earlier lanes
    int hx = h;                         // max-scan of the lanes' last heads
    int cx = __popc(valid_starts);      // sum-scan of the lanes' counts
#pragma unroll
    for (int lo = 0; lo < 5; ++lo) {
      const int o = 1 << lo;
      const int hy = __shfl_up_sync(kFullMask, hx, o);
      const int cy = __shfl_up_sync(kFullMask, cx, o);
      if (lane >= o) {
        hx = max(hx, hy);
        cx += cy;
      }
    }
    int hin = __shfl_up_sync(kFullMask, hx, 1);
    if (lane == 0) hin = -1;
#pragma unroll
    for (int r = 0; r < 8; ++r) head[r] = max(head[r], hin);
    const int before = cx - __popc(valid_starts);
    rank_in = before - __shfl_sync(kFullMask, before, lane & ~(kW2 / 8 - 1));
  }

  // 5. the Hillis-Steele passes, in the order of the other paths
#pragma unroll
  for (int ld = 0; ld < kLogW2; ++ld) {
    const int d = 1 << ld;
    if (d < 8) {
      V up[8];
      if constexpr (kW2 > 8) {
#pragma unroll
        for (int r = 0; r < d; ++r) {
          up[r] = __shfl_up_sync(kFullMask, v[8 - d + r], 1);
        }
      }
#pragma unroll
      for (int r = 7; r >= 0; --r) {
        if (r < d && kW2 <= 8) continue;  // slot i - d: an earlier segment
        const V left = r >= d ? v[r - d] : up[r];
        if (lane * 8 + r - d >= head[r]) v[r] += left;
      }
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const V left = __shfl_up_sync(kFullMask, v[r], d >> 3);
        if (lane * 8 + r - d >= head[r]) v[r] += left;
      }
    }
  }

  // 6. pack into the stage (empty slots first), then store
  __syncwarp();
  {
    int4* sk = reinterpret_cast<int4*>(st.key);
    int4* sv = reinterpret_cast<int4*>(st.val);
    const int4 empty_k = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
    const int4 zero = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int q = 0; q < kWarpSlots / 4 / 32; ++q) sk[q * 32 + lane] = empty_k;
#pragma unroll
    for (int q = 0; q < kValChunks / 32; ++q) sv[q * 32 + lane] = zero;
  }
  __syncwarp();
  const int right_key = __shfl_down_sync(kFullMask, key[0], 1);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = lane * 8 + r;
    const bool seg_end = (i & (kW2 - 1)) == kW2 - 1;
    // valid heads from the segment's start through slot r: the run's
    // rank + 1, and at the segment's last slot its count
    const int rank = rank_in + __popc(valid_starts & ((2u << r) - 1) &
                                      ~((1u << (r & ~(kW2 - 1))) - 1));
    if (key[r] != kEmpty &&
        (seg_end || (r == 7 ? right_key : key[r + 1]) != key[r])) {
      const int o = (i & ~(kW2 - 1)) + rank - 1;
      st.key[stage_pos<int>(o)] = key[r];
      st.val[stage_pos<V>(o)] = v[r];
    }
    if (seg_end && i < n) out_count[(g0 + i) >> kLogW2] = rank;
  }
  __syncwarp();
  if (whole) {
    const int4* sk = reinterpret_cast<const int4*>(st.key);
    const int4* sv = reinterpret_cast<const int4*>(st.val);
    int4* ok = reinterpret_cast<int4*>(out_key + g0);
    int4* ov = reinterpret_cast<int4*>(out_val + g0);
#pragma unroll
    for (int q = 0; q < kWarpSlots / 4 / 32; ++q) {
      const int c4 = q * 32 + lane;
      ok[c4] = sk[c4 ^ ((c4 >> 3) & 7)];
    }
#pragma unroll
    for (int q = 0; q < kValChunks / 32; ++q) {
      const int c4 = q * 32 + lane;
      ov[c4] = sv[c4 ^ ((c4 >> 3) & 7)];
    }
  } else {
    for (int s = lane; s < n; s += 32) {
      out_key[g0 + s] = st.key[stage_pos<int>(s)];
      out_val[g0 + s] = st.val[stage_pos<V>(s)];
    }
  }
}

// The warp path for segments of 2^lw2 slots (1 <= lw2 <= 8).
template <typename V>
void launch_warp(int lw2, const int* keys, const V* vals,
                 const int* row_len, int* out_key, V* out_val,
                 int* out_count, long long slots, cudaStream_t stream) {
  using Kernel = void (*)(const int*, const V*, const int*, int*, V*, int*,
                          long long, bool);
  const Kernel kernels[] = {tail_warp<V, 1>, tail_warp<V, 2>,
                            tail_warp<V, 3>, tail_warp<V, 4>,
                            tail_warp<V, 5>, tail_warp<V, 6>,
                            tail_warp<V, 7>, tail_warp<V, 8>};
  const long long tiles = (slots + kWarpSlots - 1) / kWarpSlots;
  const long long blocks = (tiles + kWarpThreads / 32 - 1) /
                           (kWarpThreads / 32);
  const bool vec = ((reinterpret_cast<uintptr_t>(keys) |
                     reinterpret_cast<uintptr_t>(vals) |
                     reinterpret_cast<uintptr_t>(out_key) |
                     reinterpret_cast<uintptr_t>(out_val)) & 15) == 0;
  kernels[lw2 - 1]<<<static_cast<unsigned>(blocks), kWarpThreads, 0,
                     stream>>>(keys, vals, row_len, out_key, out_val,
                               out_count, slots, vec);
}

// The path that segments of w2 slots take; kPathNone for a width that
// no path serves.
enum Path { kPathNone = -1, kPathWarp = 0, kPathTile = 1, kPathGlobal = 2 };

Path path_for(int w2) {
  if (w2 < 2 || w2 > 65536 || (w2 & (w2 - 1)) != 0) return kPathNone;
  if (w2 <= kWarpMaxW2) return kPathWarp;
  return w2 <= kSmemMaxW2 ? kPathTile : kPathGlobal;
}

template <typename V>
int launch(const int* keys, const V* vals, const int* row_len,
           int* out_key, V* out_val, int* out_count, long long slots,
           int w2, void* scratch, cudaStream_t stream) {
  const Path path = path_for(w2);
  if (path == kPathNone || slots <= 0 || slots % w2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (path == kPathWarp) {
    launch_warp<V>(__builtin_ctz(w2), keys, vals, row_len, out_key, out_val,
                   out_count, slots, stream);
  } else if (path == kPathTile) {
    const int tile = w2 < kMinTile ? kMinTile : w2;
    const size_t smem = static_cast<size_t>(tile) * (2 * sizeof(V) + 12);
    cudaError_t err = cudaFuncSetAttribute(
        tail_smem<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long blocks = (slots + tile - 1) / tile;
    tail_smem<V><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        keys, vals, row_len, out_key, out_val, out_count, slots, w2, tile);
  } else {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    tail_global<V><<<static_cast<unsigned>(slots / w2), kThreads, 0,
                     stream>>>(keys, vals, row_len, out_key, out_val,
                               out_count, slots, w2,
                               static_cast<unsigned char*>(scratch));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The path that launch() takes for segments of w2 slots: 0 warp, 1 tile,
// 2 global, -1 for an unsupported width.  Launches nothing.
int esc_tail_path(int w2) { return static_cast<int>(path_for(w2)); }

// Bytes of global scratch the caller must pass for this shape (0 when
// the segments fit shared memory).
long long esc_tail_flat_scratch_bytes(long long slots, int w2,
                                      int value_bytes) {
  if (path_for(w2) != kPathGlobal) return 0;
  return slots * (2LL * value_bytes + 12);
}

int esc_tail_flat_f64(const int* keys, const double* vals, int* out_key,
                      double* out_val, int* out_count, long long slots,
                      int w2, void* scratch, void* stream) {
  return launch<double>(keys, vals, nullptr, out_key, out_val, out_count,
                        slots, w2, scratch, static_cast<cudaStream_t>(stream));
}

int esc_tail_flat_f32(const int* keys, const float* vals, int* out_key,
                      float* out_val, int* out_count, long long slots,
                      int w2, void* scratch, void* stream) {
  return launch<float>(keys, vals, nullptr, out_key, out_val, out_count,
                       slots, w2, scratch, static_cast<cudaStream_t>(stream));
}

// The slab form: keys/vals [rows, w2], row_len int32[rows].
int esc_tail_f64(const int* keys, const double* vals, const int* row_len,
                 int* out_key, double* out_val, int* out_count,
                 long long slots, int w2, void* scratch, void* stream) {
  if (row_len == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<double>(keys, vals, row_len, out_key, out_val, out_count,
                        slots, w2, scratch, static_cast<cudaStream_t>(stream));
}

int esc_tail_f32(const int* keys, const float* vals, const int* row_len,
                 int* out_key, float* out_val, int* out_count,
                 long long slots, int w2, void* scratch, void* stream) {
  if (row_len == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(keys, vals, row_len, out_key, out_val, out_count,
                       slots, w2, scratch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
