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
// slot is O(log^2 w2) compares in shared memory, far under the card's
// integer rate.  The design keeps every intermediate out of device
// memory for w2 <= 8192: a block loads a tile of max(w2, 1024) slots
// (several segments when w2 < 1024) into dynamic shared memory once,
// sorts, scans and packs there, and writes each output slot once.
// Segments wider than 8192 slots (up to 65536) do not fit one block's
// shared memory; they run the same algorithm in a global scratch
// buffer that the caller allocates, one block per segment.
//
// Algorithm, all inside the block:
//   1. bitonic sort of each aligned segment by key (the XOR partner of a
//      compare-exchange never leaves the segment, so one network sorts
//      all segments of a tile at once);
//   2. run heads: valid slot whose key differs from its left neighbour;
//   3. one Hillis-Steele pass set (log2 w2 passes, double-buffered) that
//      computes both the segmented inclusive sum of each run and the
//      inclusive count of heads (a run's output rank + 1).  After the
//      sort a run start lies in (i-d, i] exactly when key[i-d] != key[i],
//      so the segmented sum needs no flag array.  No thread walks a run
//      serially: a segment whose keys are all equal takes log2 w2 passes;
//   4. the last slot of each run writes (key, sum) at its rank; slots at
//      or past the segment's count write (2^31-1, 0).
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

template <typename V>
int launch(const int* keys, const V* vals, const int* row_len,
           int* out_key, V* out_val, int* out_count, long long slots,
           int w2, void* scratch, cudaStream_t stream) {
  if (w2 < 2 || w2 > 65536 || (w2 & (w2 - 1)) != 0 || slots <= 0 ||
      slots % w2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (w2 <= kSmemMaxW2) {
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

// Bytes of global scratch the caller must pass for this shape (0 when
// the segments fit shared memory).
long long esc_tail_flat_scratch_bytes(long long slots, int w2,
                                      int value_bytes) {
  if (w2 <= kSmemMaxW2) return 0;
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
