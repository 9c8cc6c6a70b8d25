// Ragged run copy for Hopper (sm_90a): host-planned (src, dst, len) runs
// of int32 words copied from a [rows, 128] source stream into a packed
// output, once per plane.
//
// Replaces the TPU kernel mh_spgemm_tpu/ops/ragged_fill.py:156
// ragged_fill (body _fill_kernel, :67).  What it computes: for each grid
// step g of each batch entry b, and for each of the first win_row[g, 1]
// runs (src, dst, len) of runs[g] with len > 0, and for each plane
// p < nplanes:
//
//   out[b][dst + p * dst_stride + i] =
//       pairs[(win_row[g, 0] + p * src_stride_rows) * 128 + src + i]
//
// for i < len.  The descriptors keep the JAX encoding unchanged (src is
// relative to the step's window start row and carries the planner's
// +128 window bias), so the two packages' plans compare array for array.
// Output words that no run covers are left as they were (undefined);
// callers mask them.
//
// Bound on the card: bytes.  Every copied word is read once and written
// once, 8 bytes a word, with no arithmetic.  The TPU kernel needed a
// double-buffered window DMA, descriptors staged in SMEM and lane
// rotations to reach unaligned words; none of it is needed here, because
// a warp reads and writes 32 neighbouring words of any alignment
// directly.  Design: one thread block per grid step (all batch entries
// in one launch), its warps striding over the step's runs, the lanes of
// a warp copying neighbouring words of one run, so each warp access is
// one contiguous 128-byte span.  Reads and writes outside the given
// buffers are skipped, never performed.
//
// Plain C interface for ctypes.  The function launches on the given
// stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
fill_runs(const int* __restrict__ win_row, const int* __restrict__ runs,
          const int* __restrict__ pairs, long long pairs_words,
          int* __restrict__ out, long long out_words, int steps, int epg,
          int nplanes, long long src_stride_words, long long dst_stride) {
  const long long t = blockIdx.x;                 // batch * steps + step
  const long long b = t / steps;
  const long long row0 = win_row[2 * t];
  int count = win_row[2 * t + 1];
  count = count < 0 ? 0 : (count > epg ? epg : count);
  const int* step_runs = runs + t * epg * 3;
  int* out_b = out + b * out_words;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int e = warp; e < count; e += kWarps) {
    const long long src = step_runs[3 * e];
    const long long dst = step_runs[3 * e + 1];
    const int len = step_runs[3 * e + 2];
    if (len <= 0) continue;
    for (int p = 0; p < nplanes; ++p) {
      const long long s0 = row0 * 128 + p * src_stride_words + src;
      const long long d0 = dst + p * dst_stride;
      for (int i = lane; i < len; i += 32) {
        const long long s = s0 + i;
        const long long d = d0 + i;
        if (s >= 0 && s < pairs_words && d >= 0 && d < out_words) {
          out_b[d] = pairs[s];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// win_row int32[batch, steps, 2], runs int32[batch, steps, epg, 3],
// pairs int32[pairs_words], out int32[batch, out_words].
int ragged_fill(const int* win_row, const int* runs, const int* pairs,
                long long pairs_words, int* out, long long out_words,
                int batch, int steps, int epg, int nplanes,
                long long src_stride_rows, long long dst_stride,
                void* stream) {
  if (batch < 0 || steps < 0 || epg <= 0 || nplanes <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = static_cast<long long>(batch) * steps;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fill_runs<<<static_cast<unsigned>(blocks), kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(
      win_row, runs, pairs, pairs_words, out, out_words, steps, epg,
      nplanes, src_stride_rows * 128, dst_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
