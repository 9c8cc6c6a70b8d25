// Gather frontend of the bucketed engine for Hopper (sm_90a): one class's
// keys and A*B products, written slot by slot from the plan's entries.
//
// Replaces no TPU kernel.  The JAX package's gather frontend
// (mh_spgemm_tpu/ops/bucketed.py, _front_gather) is plain jnp takes, and
// the port's plain version (ops/bucketed.py, front_gather_plain) is about
// seventy torch operations a class: five [rows, W] planes seeded one
// scatter at a time, a running max that holds each entry's fields down
// its span, then the per-plane gathers, masks and the product.  This
// kernel computes the same three outputs in one launch.
//
// What it computes, for each chunk c of the class and each slot s < rb*W
// of that chunk (row s / W of the chunk, column s % W of the slab):
//
//   an entry e of the chunk covers s when
//       ent_dst[e] <= s < ent_dst[e] + ent_len[e];
//   then, with o = s - ent_dst[e] and i = ent_src[e] + o,
//       K[c, s]    = b_col[i]
//       prod[c, s] = a_val[ent_aidx[e]] * b_val[i]   (one IEEE multiply)
//   and where no entry covers s
//       K[c, s] = 2^31 - 1,  prod[c, s] = +0.0;
//   row_len[c, r] = the slots of row r that entries cover.
//
// The entries are the planner's (ops/bucketed.py, _entries_numpy and the
// native builder): within a chunk sorted by ent_dst, never overlapping,
// a row's entries packed from its offset 0, so a row's covered slots are
// a prefix of it; pad entries sit at ent_dst = rb*W with length 0.  An
// entry of length 0 covers nothing and is skipped.
//
// Bound on the card: bytes.  Each covered slot reads B's column and value
// (12 B in f64) and each slot writes its key and product (12 B); the
// entry arrays and A's values are read once an entry.  On er_s17_ef16's
// warm plan that is about 0.9 GB, 0.27 ms at 3.35 TB/s.  The design keeps
// every load and store on neighbouring addresses and no row on one
// block, since rows run from 192 slots (er_s17_ef16) to 786,432
// (g500_s15_ef16) and one B row may hold 10^4 entries of a hub:
//
// - a block takes a tile of kTile slots of one chunk, whatever the row
//   boundaries; two warps find, by a 32-way search over the chunk's
//   sorted ent_dst, the last entry that starts at or before the tile and
//   the first that starts past it;
// - the block marks each entry's first slot in the tile in shared memory
//   (the entry before the tile at slot 0) and a block-wide running max
//   gives each slot the entry that covers it, if any;
// - then thread t takes slots t, t + kThreads, ...: neighbouring threads
//   store neighbouring slots, and the slots of one entry read
//   neighbouring B elements; the entry's fields and A's value are the
//   same for most of a warp, so their loads are broadcasts from L1;
// - row_len is written by the thread of each row's last covered slot
//   (the end of an entry that no entry of the same row continues), or by
//   the thread of the row's first slot where that slot is not covered:
//   once a row, with no atomics and no second pass.
//
// The kernel keeps nothing across calls.  Plain C interface for ctypes:
// the function launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                     // slots a thread, a tile
constexpr int kTile = kThreads * kItems;      // slots a block
constexpr int kEmptyKey = 0x7fffffff;

// First index i in [0, n) with a[i] > x, or n; a ascending.  All 32 lanes
// of the calling warp take part and get the same answer: each round the
// lanes probe 32 points of [lo, hi) and the ballot keeps the part between
// the last probe at most x and the first above it.
__device__ int warp_upper_bound(const int* __restrict__ a, int n, int x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;
  while (lo < hi) {
    const long long len = hi - lo;
    const int q = lo + static_cast<int>((lane + 1) * len / 33);
    const unsigned above = __ballot_sync(0xffffffffu, __ldg(a + q) > x);
    if (above == 0) {
      lo += static_cast<int>(32 * len / 33) + 1;
    } else {
      const int f = __ffs(above) - 1;
      const int qf = lo + static_cast<int>((f + 1) * len / 33);
      if (f > 0) lo += static_cast<int>(f * len / 33) + 1;
      hi = qf;
    }
  }
  return lo;
}

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_front(const int* __restrict__ ent_dst, const int* __restrict__ ent_src,
             const int* __restrict__ ent_len,
             const int* __restrict__ ent_aidx, int eb, int rb, int W,
             int tiles, const V* __restrict__ a_val,
             const int* __restrict__ b_col, const V* __restrict__ b_val,
             int* __restrict__ K, V* __restrict__ prod,
             int* __restrict__ row_len) {
  __shared__ int owner[kTile];
  __shared__ int bounds[2];
  __shared__ int warp_max[2][kWarps];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long chunk = blockIdx.x / tiles;
  const int RW = rb * W;
  const int s0 = static_cast<int>(blockIdx.x % tiles) * kTile;
  const int n = min(kTile, RW - s0);
  const int* dst = ent_dst + chunk * eb;
  const int* len = ent_len + chunk * eb;

  if (warp < 2) {
    const int b = warp_upper_bound(dst, eb, warp == 0 ? s0 : s0 + n - 1);
    if (lane == 0) bounds[warp] = b;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) owner[k * kThreads + tid] = -1;
  __syncthreads();
  const int e_end = bounds[1];
  for (int e = max(bounds[0] - 1, 0) + tid; e < e_end; e += kThreads) {
    if (__ldg(len + e) > 0) owner[max(__ldg(dst + e) - s0, 0)] = e;
  }
  __syncthreads();

  // running max of the marks over the tile, kThreads slots a round
  int carry = -1;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    int v = owner[k * kThreads + tid];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v = max(v, u);
    }
    if (lane == 31) warp_max[k & 1][warp] = v;
    __syncthreads();
    int before = carry;
    for (int w = 0; w < kWarps; ++w) {
      const int m = warp_max[k & 1][w];
      if (w < warp) before = max(before, m);
      carry = max(carry, m);
    }
    owner[k * kThreads + tid] = max(v, before);
  }

  const long long base = chunk * RW;
  const long long row_base = chunk * rb;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + tid;
    if (i >= n) break;
    const int s = s0 + i;
    const int e = owner[i];
    int d = 0, l = 0;
    if (e >= 0) {
      d = __ldg(dst + e);
      l = __ldg(len + e);
    }
    const int row = s / W;
    if (e >= 0 && s < d + l) {
      const long long src = static_cast<long long>(
          __ldg(ent_src + chunk * eb + e)) + (s - d);
      const V a = __ldg(a_val + __ldg(ent_aidx + chunk * eb + e));
      K[base + s] = __ldg(b_col + src);
      prod[base + s] = mul_rn(a, __ldg(b_val + src));
      const int end = d + l;
      if (s == end - 1 && !(end % W != 0 && e + 1 < eb
                            && __ldg(dst + e + 1) == end)) {
        row_len[row_base + row] = end - row * W;
      }
    } else {
      K[base + s] = kEmptyKey;
      prod[base + s] = V(0);
      if (s == row * W) row_len[row_base + row] = 0;
    }
  }
}

template <typename V>
int launch(const int* ent_dst, const int* ent_src, const int* ent_len,
           const int* ent_aidx, int nchunks, int eb, int rb, int W,
           const void* a_val, const int* b_col, const void* b_val, int* K,
           void* prod, int* row_len, cudaStream_t stream) {
  const long long RW = static_cast<long long>(rb) * W;
  const long long tiles = (RW + kTile - 1) / kTile;
  const long long blocks = tiles * nchunks;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  gather_front<V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      ent_dst, ent_src, ent_len, ent_aidx, eb, rb, W,
      static_cast<int>(tiles), static_cast<const V*>(a_val), b_col,
      static_cast<const V*>(b_val), K, static_cast<V*>(prod), row_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// ent_* int32[nchunks, eb]; a_val V[nnz(A)]; b_col int32[nnz(B)], b_val
// V[nnz(B)]; K int32[nchunks * rb, W], prod V[nchunks * rb, W], row_len
// int32[nchunks * rb].  V is double where f64 is nonzero, else float.
int gather_front_launch(const int* ent_dst, const int* ent_src,
                        const int* ent_len, const int* ent_aidx, int nchunks,
                        int eb, int rb, int W, const void* a_val,
                        const int* b_col, const void* b_val, int* K,
                        void* prod, int* row_len, int f64, void* stream) {
  if (nchunks < 0 || eb <= 0 || rb <= 0 || W <= 0
      || static_cast<long long>(rb) * W > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(ent_dst, ent_src, ent_len, ent_aidx, nchunks,
                              eb, rb, W, a_val, b_col, b_val, K, prod,
                              row_len, s)
             : launch<float>(ent_dst, ent_src, ent_len, ent_aidx, nchunks,
                             eb, rb, W, a_val, b_col, b_val, K, prod,
                             row_len, s);
}

}  // extern "C"
