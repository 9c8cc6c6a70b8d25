// ESC tail for Hopper (sm_90a): sort + accumulate + left-pack of aligned
// power-of-two segments, and of rows padded to one (below).
//
// Replaces two TPU kernels with one body (_tail_kernel, :200):
//   * mh_spgemm_tpu/ops/esc_tail.py:234 esc_tail_flat, over flat planes
//     whose empty slots already carry the key 2^31-1;
//   * mh_spgemm_tpu/ops/esc_tail.py:286 esc_tail, over [rows, w2] slabs
//     with a per-row count row_len: slot j of row r is treated as empty
//     (key 2^31-1, value 0) when j >= row_len[r], before the sort.
// What it computes, per aligned segment of w2 slots (a power of two from
// 2), or per row of any W above 8192: the distinct keys in ascending
// order with the sum of the values of each key, left-packed, followed by
// 2^31-1 keys with value 0; the key 2^31-1 marks an empty input slot.
// It also writes each segment's output count.
//
// Bound on the card: bytes.  Each slot is read once (4 B key + 8 B f64
// value) and written once (4 + 8 B), 24 B a slot in f64; the work per
// slot is O(log^2 w2) compare-exchanges, far under the card's integer
// rate.  Every path keeps the intermediates out of device memory where
// they fit, and the warp and tile paths compute the same thing in the
// same order (the wide path runs the tile path on pieces of a row):
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
// order of additions, so the warp and tile paths (and the plain version)
// agree bit for bit.  Three paths, by width:
//
//   * warp (w2 <= 256, tail_warp): one warp holds a tile of 256 slots,
//     8 a lane (slot lane*8 + r in register r), with 256 / w2 whole
//     segments.  Block barriers and a shared-memory round trip per
//     stage would bound it (a network in memory reads and writes every
//     slot at each of its stages), so the network runs in
//     registers: partners 1-4 apart are compare-exchanges inside a lane,
//     partners 8-128 apart __shfl_xor_sync across lanes, each a min or
//     max of the keys that moves the slot index only where the key
//     changed.  The sort moves (key, slot index) only; the values wait in
//     a per-warp stage in shared memory (2 KB in f64), loaded with
//     16-byte lane loads, and each is fetched once in sorted order.  A
//     max-scan of run-head positions turns key[i-d] == key[i] into
//     i - d >= head(i), so the scan passes move values only (shuffles
//     for d >= 8).  The packed output is staged in shared memory and
//     stored with 16-byte lane stores.  Warps are independent: no
//     __syncthreads.  What bounds it is instruction issue in the
//     network, chiefly its 15 cross-lane stages; the loads, stage and
//     stores alone run near the byte bound.
//   * tile (512 <= w2 <= 8192, tail_tile): the warp path widened to a
//     block.  A block holds a tile of max(w2, 2048) slots, 256 a warp in
//     the warp path's register layout (8 warps, 4 segments at w2 = 512;
//     32 warps at 8192), and every warp runs the warp path's steps, the
//     same device functions, on its 256 slots.  What a warp cannot do
//     alone goes through shared memory with one __syncthreads each:
//     the network's stages with partners 256 or more apart (the partner
//     is the same lane and register of warp w ^ (j / 256); 1 stage at
//     w2 = 512, 15 at 8192), each an exchange of (key, slot index) pairs
//     in register-major order, so a warp's accesses are contiguous; the
//     keys next to each warp's edges and each warp's last head and count
//     of valid heads (two barriers), from which every warp takes the
//     carries of the earlier warps of its segment; and, only where a run
//     crosses a warp's edge (__syncthreads_or says so), each scan pass:
//     for d < 256 the last d slots of every warp, for d >= 256 every
//     slot.  The values wait in a block-wide stage of 8 B a slot in f64,
//     fetched once in sorted order; the keys wait there during the scan;
//     the packed output is staged in shared memory (any warp may write a
//     run into another warp's part of its segment) and each warp stores
//     its part with 16-byte lane stores.  Shared memory: the value stage
//     and two 8-byte exchange buffers, 24 B a slot in f64 (48 KB at w2 <=
//     2048, 192 KB at 8192), where the earlier kernel kept 28 B a slot
//     and passed every slot through it at every one of its 45-91 stages
//     and 9-13 passes, with half the threads idle in each stage.  A block
//     of 1024 threads (w2 = 8192) leaves 64 registers a thread, so there
//     the ranks' bits also wait in shared memory during the scan.  At
//     w2 = 512 it runs at about 2.3 times the byte bound on an H100 (every
//     key read, the values of live slots read, every slot written;
//     PERF.md); its in-warp network has 20 cross-lane stages there, the
//     warp path's 15.
//   * wide (rows of W > 8192 slots, any W, wide_pieces, wide_dups,
//     wide_scan, wide_merge): a row does not fit one block's shared
//     memory, and one block a row would leave most of the card idle where
//     a class holds few rows.  Each row is cut into pieces of 8192 slots
//     (the last one shorter where 8192 does not divide W), and the tile
//     path's block sorts, sums and packs each piece (wide_pieces, one
//     block a piece: the tile path's body at w2 = 8192, loading only the
//     slots below the row's count).  Then ceil(log2(pieces)) rounds merge
//     the packed runs pairwise, runs 2q and 2q+1 of a row into run q (a
//     run without a partner is copied), between a global scratch plane
//     that the caller allocates and the output planes, the last round
//     into the output.  A round's merged sequence of a pair is cut into
//     tiles of 2048 positions by merge path (ties take the left run
//     first), one block a tile, so a pair of long runs keeps many blocks
//     busy: wide_dups counts each tile's right-run keys that the left run
//     also holds, wide_scan turns the counts into each tile's offset and
//     the pair's count, and wide_merge writes the distinct keys with the
//     left value plus the right one where both runs hold a key.  A run
//     holds distinct keys, so a key meets at most one partner in a round.
//     The order of additions is fixed: the tile path's inside a piece,
//     then the merge tree's, left + right; the plain version follows it.
//     Every run of a row lies in place at its first piece's slot, so the
//     row's stride W bounds every buffer.
//
// The slab form (row_len given) differs only in the load: the TPU kernel
// masked the keys inside the kernel too, so its callers could hand over
// slabs whose slots past a row's count hold whatever the fill left there.
//
// Padded rows (warp and tile paths): rows of w slots, w2/2 < w < w2 for
// w2 the next power of two (the 1.5x width grid's 3, 6, 12, ..., 6144),
// lie back to back at stride w and are sorted in segments of w2: the
// same network and passes, with slots w..w2-1 of each segment empty in
// registers, as slots past a row's count are.  A warp stages its part of
// the tile's rows (k*w contiguous slots for k rows) with the same lane
// loads, keys beside the values, and each lane picks its 8 positions
// through (row, j) -> row*w + j; the packed rows are staged and stored at
// stride w the same way (a row keeps at most w survivors).  What bounds
// them: bytes at w (24 B a slot in f64), network work at w2 (up to 4/3
// of a power-of-two width's per slot).  The wide path takes any W above
// 8192 as it is: its last piece of a row is short instead.
//
// Plain C interface for ctypes.  Each function launches on the given
// stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEmpty = 0x7fffffff;
constexpr int kSmemMaxW2 = 8192;     // widest segment of the tile path
constexpr int kWarpMaxW2 = 256;      // widest segment of the warp path
constexpr int kWarpSlots = 256;      // slots of one warp's tile, 8 a lane
constexpr int kWarpThreads = 128;    // the warp path's blocks: 4 warps
constexpr int kTileMinSlots = 2048;  // the tile path's narrowest block tile
constexpr int kLogPiece = 13;        // the wide path's pieces: 8192 slots
constexpr int kPieceSlots = 1 << kLogPiece;
constexpr int kMergeThreads = 256;   // the wide path's merge blocks
constexpr int kMergeItems = 8;       // merged positions a thread
constexpr int kMergeTile = kMergeThreads * kMergeItems;
constexpr long long kMaxWideW2 = 1LL << 30;   // widest flat segment
constexpr unsigned kFullMask = 0xffffffffu;

// Index in a stage of slot s, for elements of T: 16-byte chunks
// XOR-swizzled by bits 3-5 of the chunk index, so that 32 lanes reading
// one register position of consecutive sorted slots (lane*8 + r) spread
// over the banks, while each chunk stays whole for 16-byte copies.  The
// swizzle stays inside each 128-byte group, so a warp's 256 slots at
// offset 256*w of a block's stage are laid out as a warp's own stage.
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

// The register tile shared by the warp and tile paths: a warp holds 256
// slots, slot pos0 + r in register r of its lane, where pos0 = lane*8 on
// the warp path and 256*warp + lane*8 on the tile path (positions count
// from the first slot of the block's tile there).  Segments are aligned
// to their width in both, so bit k of a position is bit k of the slot's
// index in its segment for every k < w2.

// Step 1: a warp's keys into registers and its values into `sval`, the
// warp's 256-value stage, from global slot g0 (n of the 256 are slots;
// the rest count as empty).  `whole`: 16-byte lane loads.
template <typename V>
__device__ __forceinline__ void load_tile(const int* __restrict__ keys,
                                          const V* __restrict__ vals,
                                          long long g0, int n, bool whole,
                                          int lane, int (&key)[8], V* sval) {
  if (whole) {
    constexpr int kValChunks = kWarpSlots * sizeof(V) / 16;
    const int4* kp = reinterpret_cast<const int4*>(keys + g0) + 2 * lane;
    const int4 a = kp[0];
    const int4 b = kp[1];
    key[0] = a.x; key[1] = a.y; key[2] = a.z; key[3] = a.w;
    key[4] = b.x; key[5] = b.y; key[6] = b.z; key[7] = b.w;
    const int4* vp = reinterpret_cast<const int4*>(vals + g0);
    int4* sp = reinterpret_cast<int4*>(sval);
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
      sval[stage_pos<V>(s)] = s < n ? vals[g0 + s] : V(0);
    }
  }
}

// Padded rows, step 1: a warp's n slots (at most 256, from the tile's
// rows back to back) into its stages, keys beside values in load order.
// `v16`: 16-byte lane copies (n and the planes' offsets multiples of 4).
template <typename V>
__device__ __forceinline__ void stage_rows(const int* __restrict__ keys,
                                           const V* __restrict__ vals, int n,
                                           bool v16, int lane, int* skey,
                                           V* sval) {
  if (v16) {
    constexpr int kValChunks = kWarpSlots * sizeof(V) / 16;
    const int4* kp = reinterpret_cast<const int4*>(keys);
    const int4* vp = reinterpret_cast<const int4*>(vals);
    int4* sk = reinterpret_cast<int4*>(skey);
    int4* sv = reinterpret_cast<int4*>(sval);
    const int vc = n * static_cast<int>(sizeof(V)) / 16;
#pragma unroll
    for (int q = 0; q < kWarpSlots / 4 / 32; ++q) {
      const int c = q * 32 + lane;
      if (c < n / 4) sk[c ^ ((c >> 3) & 7)] = kp[c];
    }
#pragma unroll
    for (int q = 0; q < kValChunks / 32; ++q) {
      const int c = q * 32 + lane;
      if (c < vc) sv[c ^ ((c >> 3) & 7)] = vp[c];
    }
  } else {
    for (int s = lane; s < n; s += 32) {
      skey[stage_pos<int>(s)] = keys[s];
      sval[stage_pos<V>(s)] = vals[s];
    }
  }
}

// Padded rows, step 1 continued: a lane's 8 keys from the tile's key
// stage.  Position p is slot j = p mod w2 of the tile's row p / w2, at
// stage slot (p / w2) * w + j; slots j >= w and rows at or past nrows are
// empty.  The slot index starts as the stage slot, where fetch_values
// finds the value.
template <int kLogW2>
__device__ __forceinline__ void pick_rows(const int* skey, int stride,
                                          int nrows, int pos0, int (&key)[8],
                                          int (&src)[8]) {
  constexpr int kW2 = 1 << kLogW2;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = (pos0 + r) >> kLogW2;
    const int j = (pos0 + r) & (kW2 - 1);
    const int s = row * stride + j;
    const bool live = j < stride && row < nrows;
    key[r] = live ? skey[stage_pos<int>(s)] : kEmpty;
    src[r] = live ? s : 0;
  }
}

// The slab form: slots at or past their row's count become empty.  pos0
// is the lane's first position (a multiple of 8) in a tile whose first
// row is row0 and which holds nrows rows.
template <int kLogW2>
__device__ __forceinline__ void mask_rows(const int* __restrict__ row_len,
                                          long long row0, int nrows,
                                          int pos0, int (&key)[8]) {
  constexpr int kW2 = 1 << kLogW2;
  if constexpr (kW2 >= 8) {             // a lane's 8 slots share one row
    const int row = pos0 >> kLogW2;
    const int len = row < nrows ? row_len[row0 + row] : 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (((pos0 + r) & (kW2 - 1)) >= len) key[r] = kEmpty;
    }
  } else {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = (pos0 + r) >> kLogW2;
      if (row < nrows &&
          ((pos0 + r) & (kW2 - 1)) >= row_len[row0 + row]) {
        key[r] = kEmpty;
      }
    }
  }
}

// Step 2 inside a warp: the compare-exchange stages j = min(k, 256)/2,
// ..., 2, 1 of the merge of runs of k = 2^lk slots, on (key, slot index).
// Each keeps the minimum or the maximum of the two keys and moves the
// slot index only where its key changed, so ties never swap.  A run of k
// slots sorts ascending where bit k of its position is clear; the last
// merge (k == w2) ascends everywhere.
template <int kW2>
__device__ __forceinline__ void warp_merge(int (&key)[8], int (&src)[8],
                                           int lane, int pos0, int lk) {
  const int k = 1 << lk;
  const bool lane_asc = k == kW2 || (pos0 & k) == 0;
#pragma unroll
  for (int lj = (lk < 8 ? lk : 8) - 1; lj >= 0; --lj) {
    const int j = 1 << lj;
    if (j >= 8) {                       // partner in lane ^ (j / 8)
      const bool keep_min = ((lane & (j >> 3)) == 0) == lane_asc;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int pk = __shfl_xor_sync(kFullMask, key[r], j >> 3);
        const int ps = __shfl_xor_sync(kFullMask, src[r], j >> 3);
        const int nk = keep_min ? min(key[r], pk) : max(key[r], pk);
        if (nk != key[r]) src[r] = ps;
        key[r] = nk;
      }
    } else {                            // partner in register r ^ j
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

// Step 3: values in sorted order, from the stage the slot indices count
// in; empty slots add nothing to a written sum.
template <typename V>
__device__ __forceinline__ void fetch_values(const int (&key)[8],
                                             const int (&src)[8],
                                             const V* sval, V (&v)[8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    v[r] = key[r] == kEmpty ? V(0) : sval[stage_pos<V>(src[r])];
  }
}

// Step 4 inside a warp: run heads.  head[r] is the position where slot
// r's run starts, so key[i-d] == key[i] exactly when i - d >= head[r];
// bit r of valid_starts says that slot r starts a run of a key other
// than 2^31-1.  left0 (tile path): the key of the slot before lane 0's
// first, read only where that slot is not a segment's first; on the warp
// path lane 0's first slot always starts a segment.  For w2 > 8, hx and
// cx come out as the lanes' inclusive max-scan of their last heads and
// sum-scan of their valid heads.
template <int kW2>
__device__ __forceinline__ void warp_runs(const int (&key)[8], int lane,
                                          int pos0, int left0,
                                          unsigned& valid_starts,
                                          int (&head)[8], int& hx, int& cx) {
  int left_key = __shfl_up_sync(kFullMask, key[7], 1);
  if constexpr (kW2 > kWarpMaxW2) {
    if (lane == 0) left_key = left0;
  }
  unsigned starts = 0;                  // bit r: slot r starts a run
  valid_starts = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const bool start = ((pos0 + r) & (kW2 - 1)) == 0 ||
                       (r == 0 ? left_key : key[r - 1]) != key[r];
    starts |= static_cast<unsigned>(start) << r;
    valid_starts |= static_cast<unsigned>(start && key[r] != kEmpty) << r;
  }
  int h = -1;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if ((starts >> r) & 1) h = pos0 + r;
    head[r] = h;
  }
  hx = h;
  cx = __popc(valid_starts);
  if constexpr (kW2 > 8) {
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
  }
}

// The heads of earlier lanes (and, on the tile path, through head_in and
// count_in, of the segment's earlier warps) into head[]; returns the
// valid heads in the segment before the lane's first slot.
template <int kW2>
__device__ __forceinline__ int run_carry(int (&head)[8], int hx, int cx,
                                         unsigned valid_starts, int lane,
                                         int head_in, int count_in) {
  if constexpr (kW2 > 8) {
    int hin = __shfl_up_sync(kFullMask, hx, 1);
    if constexpr (kW2 > kWarpMaxW2) {
      hin = lane == 0 ? head_in : max(hin, head_in);
    } else if (lane == 0) {
      hin = -1;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) head[r] = max(head[r], hin);
    const int before = cx - __popc(valid_starts);
    if constexpr (kW2 > kWarpMaxW2) return count_in + before;
    return before - __shfl_sync(kFullMask, before, lane & ~(kW2 / 8 - 1));
  } else {
    return 0;
  }
}

// Step 5: the Hillis-Steele passes d = 1, 2, ..., w2/2 in the order of
// the other paths: v[i] += v[i-d] where slot i - d lies in slot i's run.
// On the tile path (kSlots > 0) a partner may lie in another warp: with
// `cross` (a run of the block crosses a warp's boundary; the same in
// every thread), each pass passes through xv, two buffers of kSlots
// values, with a __syncthreads: for d < 256 the last d slots of each
// warp, for d >= 256 every slot.  Without `cross` no run reaches another
// warp, so the passes stay in the warp and those of d >= 256 add nothing.
template <typename V, int kLogW2, int kSlots>
__device__ __forceinline__ void scan_passes(V (&v)[8], const int (&head)[8],
                                            int lane, int pos0, int w,
                                            V* xv, bool cross) {
  constexpr int kW2 = 1 << kLogW2;
  int parity = 0;
#pragma unroll
  for (int ld = 0; ld < kLogW2; ++ld) {
    const int d = 1 << ld;
    V* buf = xv + parity * kSlots;
    if (d >= kWarpSlots) {              // partner in warp w - d / 256
      if (!cross) continue;
#pragma unroll
      for (int r = 0; r < 8; ++r) buf[(w * 8 + r) * 32 + lane] = v[r];
      __syncthreads();
      const int pw = w - (d >> 8);
      if (pw >= 0) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const V left = buf[(pw * 8 + r) * 32 + lane];
          if (pos0 + r - d >= head[r]) v[r] += left;
        }
      }
      parity ^= 1;
      continue;
    }
    const bool xwarp = kSlots > 0 && cross;
    if (xwarp) {                        // the slots the next warp reads
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (lane * 8 + r >= kWarpSlots - d) buf[(w * 8 + r) * 32 + lane] = v[r];
      }
      __syncthreads();
    }
    if (d < 8) {
      V up[8];
      if constexpr (kW2 > 8) {
#pragma unroll
        for (int r = 0; r < d; ++r) {
          up[r] = __shfl_up_sync(kFullMask, v[8 - d + r], 1);
          if (xwarp && lane == 0 && w > 0) {
            up[r] = buf[((w - 1) * 8 + 8 - d + r) * 32 + 31];
          }
        }
      }
#pragma unroll
      for (int r = 7; r >= 0; --r) {
        if (r < d && kW2 <= 8) continue;  // slot i - d: an earlier segment
        const V left = r >= d ? v[r - d] : up[r];
        if (pos0 + r - d >= head[r]) v[r] += left;
      }
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        V left = __shfl_up_sync(kFullMask, v[r], d >> 3);
        if (xwarp && w > 0 && lane < (d >> 3)) {
          left = buf[((w - 1) * 8 + r) * 32 + lane + 32 - (d >> 3)];
        }
        if (pos0 + r - d >= head[r]) v[r] += left;
      }
    }
    if (xwarp) parity ^= 1;
  }
}

// Step 6, first half: a warp's 256 slots of an output stage set empty.
template <typename V>
__device__ __forceinline__ void clear_stage(int* skey, V* sval, int lane) {
  constexpr int kValChunks = kWarpSlots * sizeof(V) / 16;
  int4* sk = reinterpret_cast<int4*>(skey);
  int4* sv = reinterpret_cast<int4*>(sval);
  const int4 empty_k = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
  const int4 zero = make_int4(0, 0, 0, 0);
#pragma unroll
  for (int q = 0; q < kWarpSlots / 4 / 32; ++q) sk[q * 32 + lane] = empty_k;
#pragma unroll
  for (int q = 0; q < kValChunks / 32; ++q) sv[q * 32 + lane] = zero;
}

// Step 6: the last slot of each valid run writes (key, sum) into the
// output stage at its row's start (row * w) + rank - 1; the last slot of
// each segment writes the row's count.  right7 (tile path): the key after
// lane 31's last slot, read only where that slot does not end a segment.
// row0 and nrows: the tile's first row and its rows.
template <typename V, int kLogW2>
__device__ __forceinline__ void pack_runs(const int (&key)[8],
                                          const V (&v)[8],
                                          unsigned valid_starts,
                                          int rank_in, int right7, int lane,
                                          int pos0, int* skey, V* sval,
                                          int* __restrict__ out_count,
                                          long long row0, int nrows,
                                          int stride) {
  constexpr int kW2 = 1 << kLogW2;
  int right_key = __shfl_down_sync(kFullMask, key[0], 1);
  if constexpr (kW2 > kWarpMaxW2) {
    if (lane == 31) right_key = right7;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = pos0 + r;
    const bool seg_end = (i & (kW2 - 1)) == kW2 - 1;
    // valid heads from the segment's start through slot r: the run's
    // rank + 1, and at the segment's last slot its count
    const int rank = rank_in + __popc(valid_starts & ((2u << r) - 1) &
                                      ~((1u << (r & ~(kW2 - 1))) - 1));
    if (key[r] != kEmpty &&
        (seg_end || (r == 7 ? right_key : key[r + 1]) != key[r])) {
      const int o = (i >> kLogW2) * stride + rank - 1;
      skey[stage_pos<int>(o)] = key[r];
      sval[stage_pos<V>(o)] = v[r];
    }
    if (seg_end && (i >> kLogW2) < nrows) {
      out_count[row0 + (i >> kLogW2)] = rank;
    }
  }
}

// Step 6, second half: a warp's first n staged slots out to global
// memory, with 16-byte lane stores where `v16` (n and the planes' offsets
// multiples of 4).
template <typename V>
__device__ __forceinline__ void store_tile(const int* skey, const V* sval,
                                           int* __restrict__ out_key,
                                           V* __restrict__ out_val, int n,
                                           bool v16, int lane) {
  if (v16) {
    constexpr int kValChunks = kWarpSlots * sizeof(V) / 16;
    const int4* sk = reinterpret_cast<const int4*>(skey);
    const int4* sv = reinterpret_cast<const int4*>(sval);
    int4* ok = reinterpret_cast<int4*>(out_key);
    int4* ov = reinterpret_cast<int4*>(out_val);
    const int vc = n * static_cast<int>(sizeof(V)) / 16;
#pragma unroll
    for (int q = 0; q < kWarpSlots / 4 / 32; ++q) {
      const int c4 = q * 32 + lane;
      if (c4 < n / 4) ok[c4] = sk[c4 ^ ((c4 >> 3) & 7)];
    }
#pragma unroll
    for (int q = 0; q < kValChunks / 32; ++q) {
      const int c4 = q * 32 + lane;
      if (c4 < vc) ov[c4] = sv[c4 ^ ((c4 >> 3) & 7)];
    }
  } else {
    for (int s = lane; s < n; s += 32) {
      out_key[s] = skey[stage_pos<int>(s)];
      out_val[s] = sval[stage_pos<V>(s)];
    }
  }
}

// w2 <= kWarpMaxW2: one tile of 256 / w2 rows of w slots per warp, in
// registers.  `vec` says that all four planes are 16-byte aligned, so
// that a tile whose slots start and end on 16-byte boundaries moves with
// 16-byte lane loads and stores; other tiles go slot by slot.
template <typename V, int kLogW2>
__global__ void __launch_bounds__(kWarpThreads)
tail_warp(const int* __restrict__ keys, const V* __restrict__ vals,
          const int* __restrict__ row_len, int* __restrict__ out_key,
          V* __restrict__ out_val, int* __restrict__ out_count,
          long long rows, int stride, bool vec) {
  constexpr int kW2 = 1 << kLogW2;
  constexpr int kRows = kWarpSlots / kW2;
  __shared__ WarpStage<V> stages[kWarpThreads / 32];
  WarpStage<V>& st = stages[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int pos0 = lane * 8;
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * (kWarpThreads / 32) +
       (threadIdx.x >> 5)) * kRows;
  if (row0 >= rows) return;
  const int nrows = rows - row0 < kRows ? static_cast<int>(rows - row0)
                                        : kRows;
  const long long g0 = row0 * stride;
  const int n = nrows * stride;
  const bool v16 = vec && ((g0 | n) & 3) == 0;

  int key[8], src[8];
  if (stride == kW2) {
    load_tile<V>(keys, vals, g0, n, v16 && n == kWarpSlots, lane, key,
                 st.val);
#pragma unroll
    for (int r = 0; r < 8; ++r) src[r] = pos0 + r;
  } else {
    stage_rows<V>(keys + g0, vals + g0, n, v16, lane, st.key, st.val);
    __syncwarp();
    pick_rows<kLogW2>(st.key, stride, nrows, pos0, key, src);
  }
  if (row_len != nullptr) mask_rows<kLogW2>(row_len, row0, nrows, pos0, key);
#pragma unroll
  for (int lk = 1; lk <= kLogW2; ++lk) {
    warp_merge<kW2>(key, src, lane, pos0, lk);
  }
  __syncwarp();
  V v[8];
  fetch_values<V>(key, src, st.val, v);
  unsigned valid_starts;
  int head[8], hx, cx;
  warp_runs<kW2>(key, lane, pos0, kEmpty, valid_starts, head, hx, cx);
  const int rank_in = run_carry<kW2>(head, hx, cx, valid_starts, lane, -1, 0);
  scan_passes<V, kLogW2, 0>(v, head, lane, pos0, 0, nullptr, false);
  __syncwarp();
  clear_stage<V>(st.key, st.val, lane);
  __syncwarp();
  pack_runs<V, kLogW2>(key, v, valid_starts, rank_in, kEmpty, lane, pos0,
                       st.key, st.val, out_count, row0, nrows, stride);
  __syncwarp();
  store_tile<V>(st.key, st.val, out_key + g0, out_val + g0, n, v16, lane);
}

// The tile path's block: a tile of max(w2, kTileMinSlots) slots, 256 a
// warp; whole segments, so only partners 256 or more apart in the
// network and the scan lie in another warp.
__host__ __device__ constexpr int tile_slots(int lw2) {
  return (1 << lw2) > kTileMinSlots ? 1 << lw2 : kTileMinSlots;
}

// Dynamic shared memory of the tile path: the values' stage (later the
// packed values), then two exchange buffers of 8 bytes a slot ((key,
// slot index) pairs, then values; the packed keys in the first).
template <typename V>
size_t tile_smem_bytes(int lw2) {
  return static_cast<size_t>(tile_slots(lw2)) * (sizeof(V) + 16);
}

// 512 <= w2 <= kSmemMaxW2: the warp path widened to a block.  Each warp
// runs the warp path's steps on its 256 slots; the network's stages with
// partners 256 or more apart, the heads' and counts' carries from the
// earlier warps of a segment, the scan's cross-warp partners and the pack
// go through shared memory, each with a __syncthreads.
//
// kPiece (the wide path's first step, w2 = kPieceSlots): the block's tile
// is piece blockIdx.x % npieces of row blockIdx.x / npieces, the slots
// [p * w2, min((p + 1) * w2, stride)) of a row of `stride` slots, and only
// those below the row's count are loaded (the rest count as empty).  The
// packed run goes out at the piece's own slots, cut at its count rounded
// up to 4 (the 16-byte stores) and at the piece's end, and its count to
// out_count[blockIdx.x].
template <typename V, int kLogW2, bool kPiece>
__device__ __forceinline__ void tile_body(
    const int* __restrict__ keys, const V* __restrict__ vals,
    const int* __restrict__ row_len, int* __restrict__ out_key,
    V* __restrict__ out_val, int* __restrict__ out_count, long long rows,
    int stride, bool vec, int npieces) {
  constexpr int kW2 = 1 << kLogW2;
  constexpr int kSlots = tile_slots(kLogW2);
  constexpr int kRows = kSlots / kW2;
  constexpr int kWarps = kSlots / kWarpSlots;
  constexpr int kSegWarps = kW2 / kWarpSlots;
  // a block of 1024 threads (w2 = 8192) leaves a thread 64 registers
  constexpr bool kTight = kSlots == 8192;
  extern __shared__ __align__(16) unsigned char smem[];
  V* sval = reinterpret_cast<V*>(smem);
  unsigned char* xraw = smem + kSlots * sizeof(V);
  __shared__ int warp_first[kWarps], warp_last[kWarps];
  __shared__ int warp_head[kWarps], warp_count[kWarps];
  __shared__ int wait_rank[kTight ? kSlots / 8 : 1];
  __shared__ unsigned wait_starts[kTight ? kSlots / 8 : 1];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pos0 = w * kWarpSlots + lane * 8;
  long long row0, gb;
  int nrows, nb, nload;
  if constexpr (kPiece) {
    static_assert(kRows == 1, "a piece is one segment");
    const long long row = blockIdx.x / npieces;
    const int ps = static_cast<int>(blockIdx.x % npieces) << kLogW2;
    row0 = blockIdx.x;
    nrows = 1;
    gb = row * stride + ps;
    nb = min(stride - ps, kW2);
    nload = row_len == nullptr ? nb : min(max(row_len[row] - ps, 0), nb);
    if (nload == 0) {                   // the whole block: nothing live
      if (threadIdx.x == 0) out_count[row0] = 0;
      return;
    }
  } else {
    row0 = static_cast<long long>(blockIdx.x) * kRows;
    nrows = rows - row0 < kRows ? static_cast<int>(rows - row0) : kRows;
    gb = row0 * stride;
    nb = nload = nrows * stride;
  }
  // the block's slots from global slot gb, the warp's n of them from g0:
  // at stride = w2 a warp's 256 positions are all slots or all padding,
  // and so is a segment's every warp
  const int n = min(max(nload - w * kWarpSlots, 0), kWarpSlots);
  const long long g0 = gb + w * kWarpSlots;
  const bool v16 = vec && ((gb | nb) & 3) == 0;

  int key[8], src[8];
  if (kPiece || stride == kW2) {
    load_tile<V>(keys, vals, g0, n, v16 && n == kWarpSlots, lane, key,
                 sval + w * kWarpSlots);
#pragma unroll
    for (int r = 0; r < 8; ++r) src[r] = pos0 + r;
  } else {
    // the keys wait in the second exchange buffer, which the network
    // first writes after its first cross-warp stage's barrier
    int* kstage = reinterpret_cast<int*>(xraw + kSlots * sizeof(int2));
    stage_rows<V>(keys + g0, vals + g0, n, v16, lane,
                  kstage + w * kWarpSlots, sval + w * kWarpSlots);
    __syncthreads();
    pick_rows<kLogW2>(kstage, stride, nrows, pos0, key, src);
  }
  if (!kPiece && row_len != nullptr) {
    mask_rows<kLogW2>(row_len, row0, nrows, pos0, key);
  }
  int2* xkey = reinterpret_cast<int2*>(xraw);
  int parity = 0;
#pragma unroll
  for (int lk = 1; lk <= kLogW2; ++lk) {
    const int k = 1 << lk;
    const bool asc = k == kW2 || (pos0 & k) == 0;
#pragma unroll
    for (int lj = lk - 1; lj >= 8; --lj) {   // partner in warp w ^ (j / 256)
      const int m = 1 << (lj - 8);
      int2* buf = xkey + parity * kSlots;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        buf[(w * 8 + r) * 32 + lane] = make_int2(key[r], src[r]);
      }
      __syncthreads();
      const bool keep_min = ((w & m) == 0) == asc;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int2 p = buf[((w ^ m) * 8 + r) * 32 + lane];
        const int nk = keep_min ? min(key[r], p.x) : max(key[r], p.x);
        if (nk != key[r]) src[r] = p.y;
        key[r] = nk;
      }
      parity ^= 1;
    }
    warp_merge<kW2>(key, src, lane, pos0, lk);
  }
  // (the network's first cross-warp stage has put every value in the
  // stage before any warp fetches)
  V v[8];
  fetch_values<V>(key, src, sval, v);
  if (lane == 0) warp_first[w] = key[0];
  if (lane == 31) warp_last[w] = key[7];
  __syncthreads();
  const bool seg_first = w % kSegWarps == 0;
  const bool seg_last = w % kSegWarps == kSegWarps - 1;
  const int left0 = seg_first ? kEmpty : warp_last[w - 1];
  unsigned valid_starts;
  int head[8], hx, cx;
  warp_runs<kW2>(key, lane, pos0, left0, valid_starts, head, hx, cx);
  if (lane == 31) {
    warp_head[w] = hx;
    warp_count[w] = cx;
  }
  const bool cross = __syncthreads_or(lane == 0 && !seg_first &&
                                      key[0] == left0 && left0 != kEmpty);
  const int w0 = w - w % kSegWarps;     // the segment's first warp
  const int head_in =
      __reduce_max_sync(kFullMask, lane < w ? warp_head[lane] : -1);
  const int count_in = __reduce_add_sync(
      kFullMask, lane >= w0 && lane < w ? warp_count[lane] : 0);
  const int rank_in =
      run_carry<kW2>(head, hx, cx, valid_starts, lane, head_in, count_in);
  // the keys wait in the values' stage (every warp has fetched) while the
  // scan holds the values, and so, where a thread has 64 registers, do
  // the run ranks' bits
  int* kwait = reinterpret_cast<int*>(sval);
#pragma unroll
  for (int r = 0; r < 8; ++r) kwait[(w * 8 + r) * 32 + lane] = key[r];
  if constexpr (kTight) {
    wait_rank[threadIdx.x] = rank_in;
    wait_starts[threadIdx.x] = valid_starts;
  }
  scan_passes<V, kLogW2, kSlots>(v, head, lane, pos0, w,
                                 reinterpret_cast<V*>(xraw), cross);
#pragma unroll
  for (int r = 0; r < 8; ++r) key[r] = kwait[(w * 8 + r) * 32 + lane];
  const int rank = kTight ? wait_rank[threadIdx.x] : rank_in;
  const unsigned starts = kTight ? wait_starts[threadIdx.x] : valid_starts;
  int* skey = reinterpret_cast<int*>(xraw);
  __syncthreads();                      // the stage and buffers are free
  clear_stage<V>(skey + w * kWarpSlots, sval + w * kWarpSlots, lane);
  __syncthreads();
  const int right7 = seg_last ? kEmpty : warp_first[w + 1];
  pack_runs<V, kLogW2>(key, v, starts, rank, right7, lane, pos0,
                       skey, sval, out_count, row0, nrows, stride);
  __syncthreads();
  int nstore = n;
  if constexpr (kPiece) {
    const int count =
        __reduce_add_sync(kFullMask, lane < kWarps ? warp_count[lane] : 0);
    const int keep = min(v16 ? (count + 3) & ~3 : count, nb);
    nstore = min(max(keep - w * kWarpSlots, 0), kWarpSlots);
  }
  store_tile<V>(skey + w * kWarpSlots, sval + w * kWarpSlots, out_key + g0,
                out_val + g0, nstore, v16, lane);
}

template <typename V, int kLogW2>
__global__ void __launch_bounds__(tile_slots(kLogW2) / 8)
tail_tile(const int* __restrict__ keys, const V* __restrict__ vals,
          const int* __restrict__ row_len, int* __restrict__ out_key,
          V* __restrict__ out_val, int* __restrict__ out_count,
          long long rows, int stride, bool vec) {
  tile_body<V, kLogW2, false>(keys, vals, row_len, out_key, out_val,
                              out_count, rows, stride, vec, 1);
}

// The wide path's first step: each piece of each row sorted, summed and
// packed by the tile path's body (above, kPiece).
template <typename V>
__global__ void __launch_bounds__(kPieceSlots / 8)
wide_pieces(const int* __restrict__ keys, const V* __restrict__ vals,
            const int* __restrict__ row_len, int* __restrict__ out_key,
            V* __restrict__ out_val, int* __restrict__ out_count,
            int stride, bool vec, int npieces) {
  tile_body<V, kLogPiece, true>(keys, vals, row_len, out_key, out_val,
                                out_count, 0, stride, vec, npieces);
}

// The wide path's merge rounds.  In a round, run g of a row starts at
// slot g * run of the row (stride slots a row) and holds cin[row * nin +
// g] keys, distinct and ascending, with their values; pair q merges runs
// 2q (left, L) and 2q + 1 (right, R; none where 2q + 1 = nin) into run q
// at slot 2q * run of the other buffer.  Block b works tile b % tiles,
// merged positions [t * kMergeTile, +kMergeTile), of pair b / tiles.

// The number of left keys among the first d merged positions (ties take
// the left key first).
__device__ __forceinline__ int merge_split(const int* L, int a, const int* R,
                                          int b, int d) {
  int lo = max(0, d - b);
  int hi = min(d, a);
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (L[mid] <= R[d - 1 - mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// A merge block's keys: its part of L and of R, the left key before the
// first and the right key after the last, the part's first indices.
struct MergeKeys {
  int l[kMergeTile];
  int r[kMergeTile];
  int l_before, r_after, i0, j0, la, lb;
};

// A pair's runs as a block of a round sees them.
struct MergePair {
  long long base;          // the pair's first slot (L's) in its buffer
  int a, b;                // keys of L and of R
  int s, e;                // the tile's merged positions [s, e)
};

__device__ __forceinline__ MergePair merge_pair(const int* cin, int stride,
                                                long long run, int nin,
                                                int nout, int tiles) {
  const long long pair = blockIdx.x / tiles;
  const int t = static_cast<int>(blockIdx.x % tiles);
  const long long row = pair / nout;
  const int q = static_cast<int>(pair % nout);
  MergePair m;
  m.base = row * stride + 2 * q * run;
  m.a = cin[row * nin + 2 * q];
  m.b = 2 * q + 1 < nin ? cin[row * nin + 2 * q + 1] : 0;
  m.s = t * kMergeTile;
  m.e = min(m.s + kMergeTile, m.a + m.b);
  return m;
}

// The block's keys into `mk` (needs m.s < m.a + m.b).
__device__ __forceinline__ void merge_keys(const int* L, const int* R,
                                           const MergePair& m,
                                           MergeKeys& mk) {
  if (threadIdx.x == 0) mk.i0 = merge_split(L, m.a, R, m.b, m.s);
  if (threadIdx.x == 32) mk.la = merge_split(L, m.a, R, m.b, m.e);
  __syncthreads();
  const int i0 = mk.i0;
  const int j0 = m.s - i0;
  const int la = mk.la - i0;
  const int lb = m.e - m.s - la;
  for (int x = threadIdx.x; x < la; x += kMergeThreads) mk.l[x] = L[i0 + x];
  for (int x = threadIdx.x; x < lb; x += kMergeThreads) mk.r[x] = R[j0 + x];
  __syncthreads();                      // every thread has read mk.la
  if (threadIdx.x == 0) {
    mk.j0 = j0;
    mk.la = la;
    mk.lb = lb;
    mk.l_before = i0 > 0 ? L[i0 - 1] : kEmpty;
    mk.r_after = j0 + lb < m.b ? R[j0 + lb] : kEmpty;
  }
  __syncthreads();
}

// A thread's walk over its kMergeItems merged positions; returns how
// many lie in the tile.  Bit k of `from_r`: position k takes a right key;
// of `twin`: that right key's left twin came before it (a duplicate,
// summed into the twin) or, for a left key, its right twin comes next.
// li/lj: the position's index into mk.l / mk.r.
__device__ __forceinline__ int merge_walk(const MergeKeys& mk,
                                          int (&li)[kMergeItems],
                                          int (&lj)[kMergeItems],
                                          unsigned& from_r, unsigned& twin) {
  const int d = threadIdx.x * kMergeItems;
  const int n = min(max(mk.la + mk.lb - d, 0), kMergeItems);
  from_r = twin = 0;
  if (n == 0) return 0;
  int i = merge_split(mk.l, mk.la, mk.r, mk.lb, d);
  int j = d - i;
#pragma unroll
  for (int k = 0; k < kMergeItems; ++k) {
    if (k >= n) break;
    li[k] = i;
    lj[k] = j;
    if (i < mk.la && (j >= mk.lb || mk.l[i] <= mk.r[j])) {
      const int other = j < mk.lb ? mk.r[j] : mk.r_after;
      twin |= static_cast<unsigned>(other == mk.l[i]) << k;
      ++i;
    } else {
      const int before = i > 0 ? mk.l[i - 1] : mk.l_before;
      from_r |= 1u << k;
      twin |= static_cast<unsigned>(before == mk.r[j]) << k;
      ++j;
    }
  }
  return n;
}

// Exclusive sum of x over a block of kMergeThreads; `total` gets the sum.
__device__ __forceinline__ int block_scan(int x, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFullMask, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[w] = inc;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int v = 0; v < kMergeThreads / 32; ++v) {
    const int ws = warp_sums[v];
    if (v < w) before += ws;
    total += ws;
  }
  __syncthreads();                      // warp_sums may be written again
  return before + inc - x;
}

// Step 1 of a round: each tile's right keys whose left twin came before
// them, into dups[blockIdx.x].
__global__ void __launch_bounds__(kMergeThreads)
wide_dups(const int* __restrict__ key, const int* __restrict__ cin,
          int* __restrict__ dups, int stride, long long run, int nin,
          int nout, int tiles) {
  __shared__ MergeKeys mk;
  __shared__ int warp_sums[kMergeThreads / 32];
  const MergePair m = merge_pair(cin, stride, run, nin, nout, tiles);
  if (m.s >= m.a + m.b) {
    if (threadIdx.x == 0) dups[blockIdx.x] = 0;
    return;
  }
  const int* L = key + m.base;
  merge_keys(L, L + run, m, mk);
  int li[kMergeItems], lj[kMergeItems];
  unsigned from_r, twin;
  merge_walk(mk, li, lj, from_r, twin);
  int total;
  block_scan(__popc(from_r & twin), warp_sums, total);
  if (threadIdx.x == 0) dups[blockIdx.x] = total;
}

// Step 2: one block a pair turns its tiles' duplicates into each tile's
// exclusive offset, in place, and writes the pair's merged count.
__global__ void __launch_bounds__(kMergeThreads)
wide_scan(int* __restrict__ dups, const int* __restrict__ cin,
          int* __restrict__ cout, int nin, int nout, int tiles) {
  __shared__ int warp_sums[kMergeThreads / 32];
  const long long pair = blockIdx.x;
  const long long row = pair / nout;
  const int q = static_cast<int>(pair % nout);
  int* d = dups + pair * tiles;
  int carry = 0;
  for (int t0 = 0; t0 < tiles; t0 += kMergeThreads) {
    const int t = t0 + threadIdx.x;
    int total;
    const int ex = block_scan(t < tiles ? d[t] : 0, warp_sums, total);
    if (t < tiles) d[t] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) {
    const int a = cin[row * nin + 2 * q];
    const int b = 2 * q + 1 < nin ? cin[row * nin + 2 * q + 1] : 0;
    cout[pair] = a + b - carry;
  }
}

// Step 3: the tile's distinct keys, each with its left value plus its
// right twin's, staged in shared memory and stored at the pair's run
// from merged position s less the duplicates before the tile.  In the
// last round (`last`, one run a row, into the output) the tile also
// writes (2^31-1, 0) over its positions at or past the row's count.
template <typename V>
__global__ void __launch_bounds__(kMergeThreads)
wide_merge(const int* __restrict__ key, const V* __restrict__ val,
           const int* __restrict__ cin, const int* __restrict__ dups,
           const int* __restrict__ cout, int* __restrict__ out_key,
           V* __restrict__ out_val, int stride, long long run, int nin,
           int nout, int tiles, bool last) {
  __shared__ MergeKeys mk;
  __shared__ int warp_sums[kMergeThreads / 32];
  __shared__ int stage_key[kMergeTile];
  __shared__ V stage_val[kMergeTile];
  const MergePair m = merge_pair(cin, stride, run, nin, nout, tiles);
  int* ok = out_key + m.base;
  V* ov = out_val + m.base;
  if (last) {
    const int count = cout[blockIdx.x / tiles];
    const int e = min(m.s + kMergeTile, stride);
    for (int x = max(m.s, count) + threadIdx.x; x < e; x += kMergeThreads) {
      ok[x] = kEmpty;
      ov[x] = V(0);
    }
  }
  if (m.s >= m.a + m.b) return;
  const int* L = key + m.base;
  const V* Lv = val + m.base;
  merge_keys(L, L + run, m, mk);
  int li[kMergeItems], lj[kMergeItems];
  unsigned from_r, twin;
  const int n = merge_walk(mk, li, lj, from_r, twin);
  const unsigned dup = from_r & twin;
  int total;
  int o = block_scan(n - __popc(dup), warp_sums, total);
  const int i0 = mk.i0;
  const int j0 = mk.j0;
#pragma unroll
  for (int k = 0; k < kMergeItems; ++k) {
    if (k >= n) break;
    if ((dup >> k) & 1) continue;
    if ((from_r >> k) & 1) {
      stage_key[o] = mk.r[lj[k]];
      stage_val[o] = Lv[run + j0 + lj[k]];
    } else {
      V v = Lv[i0 + li[k]];
      if ((twin >> k) & 1) v += Lv[run + j0 + lj[k]];
      stage_key[o] = mk.l[li[k]];
      stage_val[o] = v;
    }
    ++o;
  }
  __syncthreads();
  const int at = m.s - dups[blockIdx.x];
  for (int x = threadIdx.x; x < total; x += kMergeThreads) {
    ok[at + x] = stage_key[x];
    ov[at + x] = stage_val[x];
  }
}

// Whether all four planes are 16-byte aligned, so that whole tiles move
// with 16-byte lane loads and stores.
template <typename V>
bool aligned16(const int* keys, const V* vals, const int* out_key,
               const V* out_val) {
  return ((reinterpret_cast<uintptr_t>(keys) |
           reinterpret_cast<uintptr_t>(vals) |
           reinterpret_cast<uintptr_t>(out_key) |
           reinterpret_cast<uintptr_t>(out_val)) & 15) == 0;
}

template <typename V>
using TailKernel = void (*)(const int*, const V*, const int*, int*, V*, int*,
                            long long, int, bool);

// The warp path for rows of `stride` slots in segments of 2^lw2 (1 <=
// lw2 <= 8).
template <typename V>
void launch_warp(int lw2, const int* keys, const V* vals,
                 const int* row_len, int* out_key, V* out_val,
                 int* out_count, long long rows, int stride,
                 cudaStream_t stream) {
  const TailKernel<V> kernels[] = {tail_warp<V, 1>, tail_warp<V, 2>,
                                   tail_warp<V, 3>, tail_warp<V, 4>,
                                   tail_warp<V, 5>, tail_warp<V, 6>,
                                   tail_warp<V, 7>, tail_warp<V, 8>};
  const long long per = kWarpSlots >> lw2;          // rows of a tile
  const long long tiles = (rows + per - 1) / per;
  const long long blocks = (tiles + kWarpThreads / 32 - 1) /
                           (kWarpThreads / 32);
  kernels[lw2 - 1]<<<static_cast<unsigned>(blocks), kWarpThreads, 0,
                     stream>>>(keys, vals, row_len, out_key, out_val,
                               out_count, rows, stride,
                               aligned16(keys, vals, out_key, out_val));
}

// The tile path for rows of `stride` slots in segments of 2^lw2 (9 <=
// lw2 <= 13): one block of tile_slots(lw2) / 8 threads a tile.
template <typename V>
cudaError_t launch_tile(int lw2, const int* keys, const V* vals,
                        const int* row_len, int* out_key, V* out_val,
                        int* out_count, long long rows, int stride,
                        cudaStream_t stream) {
  const TailKernel<V> kernels[] = {tail_tile<V, 9>, tail_tile<V, 10>,
                                   tail_tile<V, 11>, tail_tile<V, 12>,
                                   tail_tile<V, 13>};
  const TailKernel<V> kernel = kernels[lw2 - 9];
  const size_t smem = tile_smem_bytes<V>(lw2);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tile = tile_slots(lw2);
  const long long per = tile >> lw2;                // rows of a tile
  const long long blocks = (rows + per - 1) / per;
  kernel<<<static_cast<unsigned>(blocks), tile / 8, smem, stream>>>(
      keys, vals, row_len, out_key, out_val, out_count, rows, stride,
      aligned16(keys, vals, out_key, out_val));
  return cudaSuccess;
}

// The path that segments of w2 slots take; kPathNone for a width that
// no path serves.
enum Path { kPathNone = -1, kPathWarp = 0, kPathTile = 1, kPathWide = 2 };

Path path_for(long long w2) {
  if (w2 < 2 || w2 > kMaxWideW2 || (w2 & (w2 - 1)) != 0) return kPathNone;
  if (w2 <= kWarpMaxW2) return kPathWarp;
  return w2 <= kSmemMaxW2 ? kPathTile : kPathWide;
}

// The segment width for rows of w slots: the next power of two.
long long pad_w2(long long w) {
  long long w2 = 1;
  while (w2 < w) w2 <<= 1;
  return w2;
}

// The wide path's buffers for rows of `stride` slots: a second pair of
// planes (values, then keys), two arrays of run counts and one of the
// tiles' duplicates, each from a 16-byte boundary of the caller's scratch.
struct WideLayout {
  long long rows, npieces, val_off, key_off, ca_off, cb_off, dups_off,
      bytes;
  int rounds;
};

long long align16(long long x) { return (x + 15) & ~15LL; }

// Merge tiles of each pair in a round whose runs hold `run` slots.
int merge_tiles(long long run, int stride) {
  const long long cap = 2 * run < stride ? 2 * run : stride;
  return static_cast<int>((cap + kMergeTile - 1) / kMergeTile);
}

WideLayout wide_layout(long long slots, int stride, int value_bytes) {
  WideLayout g;
  g.rows = slots / stride;
  g.npieces = (stride + static_cast<long long>(kPieceSlots) - 1) / kPieceSlots;
  g.rounds = 0;
  while ((1LL << g.rounds) < g.npieces) ++g.rounds;
  long long dups = 0;
  long long nin = g.npieces;
  for (long long run = kPieceSlots; nin > 1; run *= 2) {
    const long long nout = (nin + 1) / 2;
    const long long n = g.rows * nout * merge_tiles(run, stride);
    if (n > dups) dups = n;
    nin = nout;
  }
  g.val_off = 0;
  g.key_off = align16(slots * value_bytes);
  g.ca_off = g.key_off + align16(slots * 4);
  g.cb_off = g.ca_off + align16(g.rows * g.npieces * 4);
  g.dups_off = g.cb_off + align16(g.rows * ((g.npieces + 1) / 2) * 4);
  g.bytes = g.dups_off + align16(dups * 4);
  return g;
}

// Rows of `stride` > kSmemMaxW2 slots: the pieces, then the merge rounds,
// ping-ponging between the scratch planes and the output planes so that
// the last round lands in the output.
template <typename V>
cudaError_t launch_wide(const int* keys, const V* vals, const int* row_len,
                        int* out_key, V* out_val, int* out_count,
                        long long slots, int stride, unsigned char* scratch,
                        cudaStream_t stream) {
  const WideLayout g = wide_layout(slots, stride, sizeof(V));
  int* bkey[2] = {reinterpret_cast<int*>(scratch + g.key_off), out_key};
  V* bval[2] = {reinterpret_cast<V*>(scratch + g.val_off), out_val};
  int* ca = reinterpret_cast<int*>(scratch + g.ca_off);
  int* cb = reinterpret_cast<int*>(scratch + g.cb_off);
  int* dups = reinterpret_cast<int*>(scratch + g.dups_off);
  int cur = g.rounds % 2 == 1 ? 0 : 1;  // the pieces' buffer
  const size_t smem = tile_smem_bytes<V>(kLogPiece);
  cudaError_t err = cudaFuncSetAttribute(
      wide_pieces<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  wide_pieces<V><<<static_cast<unsigned>(g.rows * g.npieces),
                   kPieceSlots / 8, smem, stream>>>(
      keys, vals, row_len, bkey[cur], bval[cur], ca, stride,
      aligned16(keys, vals, bkey[cur], bval[cur]),
      static_cast<int>(g.npieces));
  int nin = static_cast<int>(g.npieces);
  int* cin = ca;
  for (int r = 1; r <= g.rounds; ++r) {
    const long long run = static_cast<long long>(kPieceSlots) << (r - 1);
    const int nout = (nin + 1) / 2;
    const int tiles = merge_tiles(run, stride);
    const bool last = r == g.rounds;
    int* cnt = last ? out_count : (r % 2 == 1 ? cb : ca);
    const unsigned pairs = static_cast<unsigned>(g.rows * nout);
    const unsigned blocks = static_cast<unsigned>(g.rows * nout * tiles);
    wide_dups<<<blocks, kMergeThreads, 0, stream>>>(
        bkey[cur], cin, dups, stride, run, nin, nout, tiles);
    wide_scan<<<pairs, kMergeThreads, 0, stream>>>(dups, cin, cnt, nin,
                                                   nout, tiles);
    wide_merge<V><<<blocks, kMergeThreads, 0, stream>>>(
        bkey[cur], bval[cur], cin, dups, cnt, bkey[cur ^ 1], bval[cur ^ 1],
        stride, run, nin, nout, tiles, last);
    cur ^= 1;
    cin = cnt;
    nin = nout;
  }
  return cudaSuccess;
}

// Rows of `stride` slots (slots / stride of them): up to kSmemMaxW2,
// sorted in segments of w2 = pad_w2(stride), a stride under w2 padded in
// registers (the warp and tile paths); wider, the wide path, any stride.
template <typename V>
int launch(const int* keys, const V* vals, const int* row_len,
           int* out_key, V* out_val, int* out_count, long long slots,
           int stride, void* scratch, cudaStream_t stream) {
  if (stride < 2 || slots <= 0 || slots % stride != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = slots / stride;
  if (stride > kSmemMaxW2) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err =
        launch_wide<V>(keys, vals, row_len, out_key, out_val, out_count,
                       slots, stride, static_cast<unsigned char*>(scratch),
                       stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  const int lw2 = __builtin_ctzll(pad_w2(stride));
  if (path_for(1LL << lw2) == kPathWarp) {
    launch_warp<V>(lw2, keys, vals, row_len, out_key, out_val, out_count,
                   rows, stride, stream);
  } else {
    const cudaError_t err =
        launch_tile<V>(lw2, keys, vals, row_len, out_key, out_val,
                       out_count, rows, stride, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The path that launch() takes for segments of w2 slots (and rows of w2
// / 2 < W <= w2 slots): 0 warp, 1 tile, 2 wide, -1 for an unsupported
// width.  Launches nothing.
int esc_tail_path(long long w2) { return static_cast<int>(path_for(w2)); }

// Bytes of global scratch the caller must pass for `slots` slots in rows
// of `w` (0 when the rows fit shared memory).
long long esc_tail_flat_scratch_bytes(long long slots, int w,
                                      int value_bytes) {
  if (w <= kSmemMaxW2 || slots <= 0) return 0;
  return wide_layout(slots, w, value_bytes).bytes;
}

// The flat form: aligned segments of w2 slots, a power of two.
int esc_tail_flat_f64(const int* keys, const double* vals, int* out_key,
                      double* out_val, int* out_count, long long slots,
                      int w2, void* scratch, void* stream) {
  if (path_for(w2) == kPathNone) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<double>(keys, vals, nullptr, out_key, out_val, out_count,
                        slots, w2, scratch, static_cast<cudaStream_t>(stream));
}

int esc_tail_flat_f32(const int* keys, const float* vals, int* out_key,
                      float* out_val, int* out_count, long long slots,
                      int w2, void* scratch, void* stream) {
  if (path_for(w2) == kPathNone) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<float>(keys, vals, nullptr, out_key, out_val, out_count,
                       slots, w2, scratch, static_cast<cudaStream_t>(stream));
}

// The slab form: keys/vals [rows, w], row_len int32[rows]; any w from 2:
// up to 8192 padded to the next power of two in registers, wider on the
// wide path.
int esc_tail_f64(const int* keys, const double* vals, const int* row_len,
                 int* out_key, double* out_val, int* out_count,
                 long long slots, int w, void* scratch, void* stream) {
  if (row_len == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<double>(keys, vals, row_len, out_key, out_val, out_count,
                        slots, w, scratch, static_cast<cudaStream_t>(stream));
}

int esc_tail_f32(const int* keys, const float* vals, const int* row_len,
                 int* out_key, float* out_val, int* out_count,
                 long long slots, int w, void* scratch, void* stream) {
  if (row_len == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(keys, vals, row_len, out_key, out_val, out_count,
                       slots, w, scratch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
