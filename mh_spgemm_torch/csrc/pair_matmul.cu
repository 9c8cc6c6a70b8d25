// Pair-stream block matmul and block gather for Hopper (sm_90a).
//
// pair_matmul_f32 / pair_matmul_f64 (one template, two instantiations).
// Replace the TPU kernels mh_spgemm_tpu/ops/pallas_gather.py:108
// pair_matmul_f32 (body _pair_matmul_kernel, :83) and
// mh_spgemm_tpu/ops/ozaki.py:201 pair_matmul_f64_ozaki (body
// _ozaki_kernel, :162).  What they compute, for 128 x 128 blocks a[nab],
// b[nbb] and a pair stream (pair_a, pair_b, pair_cb, live) sorted by C
// block:
//
//     out[c] = sum over g with pair_cb[g] == c of live[g] * a[pair_a[g]] @ b[pair_b[g]]
//
// and zero for a C block with no pair.  The TPU kernels walk the pairs in
// order on one core and keep the C block's accumulator in VMEM while the
// output index map revisits it; the f64 one carries values as bf16 slices
// with a double-f32 accumulator.  The card has native f64, so the f64
// instantiation computes with DFMA directly, and the f32 one with FFMA,
// never TF32 (the TPU kernel runs at Precision.HIGHEST).
//
// Bound on the card: operations.  A pair is 2 * 128^3 flops on 2 * 128^2
// operand elements read; at the H100's FP64 and FP32 peaks (67 TFLOP/s
// each, at 700 W) the flops take far longer than the bytes at 3.35 TB/s.
// The design keeps the accumulator out of device memory, like the TPU
// kernel: one thread block owns one whole C block and loops over its own
// segment of pairs seg_start[c] .. seg_start[c+1] (the wrapper computes
// seg_start from pair_cb on the device), so blocks run in any order with
// no atomics, the result is deterministic, and every output element is
// written once.  Per pair, 128-deep products are staged in k-slices of
// BK: A's columns k0..k0+BK (transposed) and B's rows k0..k0+BK go to
// shared memory, and each of the 256 threads accumulates an 8 x 8 tile of
// the C block in registers (rows ty*4+{0..3} and 64+ty*4+{0..3}, the
// same for columns, so a warp's shared-memory reads are contiguous).
// DMMA (mma.sync f64) and cp.async/TMA double buffering are later work.
//
// block_gather.  Replaces mh_spgemm_tpu/ops/pallas_gather.py:43
// block_gather (body _gather_kernel, :38): out[g] = table[idx[g]] for
// whole blocks of a [T, r, c] table of 4- or 8-byte elements.  Bound:
// bytes (each gathered block read once and written once).  One thread
// block per gathered block copies it with 16-byte vector loads and stores
// (4-byte words when the block size or the pointers are not 16-byte
// aligned).  The TPU moved f64 as int32 pairs; the copy here is
// type-blind.  An index outside [0, T) writes a zero block.
//
// Plain C interface for ctypes.  Each function launches on the given
// stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBS = 128;        // block edge
constexpr int kThreads = 256;   // 16 x 16 threads, 8 x 8 outputs each
constexpr int kHalf = kBS / 2;

template <typename T>
struct Slice;
template <>
struct Slice<float> {
  static constexpr int BK = 16;
};
template <>
struct Slice<double> {
  static constexpr int BK = 8;
};

// Row (or column) of the i-th of a thread's 8 outputs along one axis.
__device__ __forceinline__ int tile_index(int t, int i) {
  return (i < 4 ? 0 : kHalf) + t * 4 + (i & 3);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pair_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const int* __restrict__ pair_a,
                   const int* __restrict__ pair_b,
                   const int* __restrict__ live,
                   const int* __restrict__ seg_start, T* __restrict__ out) {
  constexpr int BK = Slice<T>::BK;
  constexpr int PAD = 16 / sizeof(T);   // keeps each row 16-byte aligned
  __shared__ __align__(16) T As[BK][kBS + PAD];   // A slice, As[k][m]
  __shared__ __align__(16) T Bs[BK][kBS];         // B slice, Bs[k][n]
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  T acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = T(0);
  }

  const int g0 = seg_start[c];
  const int g1 = seg_start[c + 1];
  for (int g = g0; g < g1; ++g) {
    if (live[g] == 0) continue;          // the same for the whole block
    const T* ap = a + static_cast<size_t>(pair_a[g]) * kBS * kBS;
    const T* bp = b + static_cast<size_t>(pair_b[g]) * kBS * kBS;
    for (int k0 = 0; k0 < kBS; k0 += BK) {
      for (int i = tid; i < kBS * BK; i += kThreads) {
        const int m = i / BK;
        const int k = i % BK;
        As[k][m] = ap[m * kBS + k0 + k];
      }
      for (int i = tid; i < BK * kBS; i += kThreads) {
        const int k = i / kBS;
        const int n = i % kBS;
        Bs[k][n] = bp[(k0 + k) * kBS + n];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        T ar[8];
        T br[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) ar[i] = As[k][tile_index(ty, i)];
#pragma unroll
        for (int j = 0; j < 8; ++j) br[j] = Bs[k][tile_index(tx, j)];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fma(ar[i], br[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }

  T* op = out + static_cast<size_t>(c) * kBS * kBS;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = tile_index(ty, i);
#pragma unroll
    for (int j = 0; j < 8; ++j) op[row * kBS + tile_index(tx, j)] = acc[i][j];
  }
}

template <typename T>
int launch_pair_matmul(const T* a, const T* b, const int* pair_a,
                       const int* pair_b, const int* live,
                       const int* seg_start, T* out, int ncb,
                       cudaStream_t stream) {
  if (ncb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  pair_matmul_kernel<T><<<static_cast<unsigned>(ncb), kThreads, 0, stream>>>(
      a, b, pair_a, pair_b, live, seg_start, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
block_gather_kernel(const W* __restrict__ table, const int* __restrict__ idx,
                    W* __restrict__ out, long long ntab, long long words) {
  const long long g = blockIdx.x;
  const int t = idx[g];
  W* dst = out + g * words;
  if (t < 0 || t >= ntab) {
    const W zero{};
    for (long long i = threadIdx.x; i < words; i += blockDim.x) dst[i] = zero;
    return;
  }
  const W* src = table + static_cast<long long>(t) * words;
  for (long long i = threadIdx.x; i < words; i += blockDim.x) dst[i] = src[i];
}

}  // namespace

extern "C" {

int pair_matmul_f32(const float* a, const float* b, const int* pair_a,
                    const int* pair_b, const int* live, const int* seg_start,
                    float* out, int ncb, void* stream) {
  return launch_pair_matmul<float>(a, b, pair_a, pair_b, live, seg_start, out,
                                   ncb, static_cast<cudaStream_t>(stream));
}

int pair_matmul_f64(const double* a, const double* b, const int* pair_a,
                    const int* pair_b, const int* live, const int* seg_start,
                    double* out, int ncb, void* stream) {
  return launch_pair_matmul<double>(a, b, pair_a, pair_b, live, seg_start,
                                    out, ncb,
                                    static_cast<cudaStream_t>(stream));
}

// out[g] = table[idx[g]] for blocks of block_bytes bytes (a multiple of 4).
int block_gather(const void* table, const int* idx, void* out, long long G,
                 long long ntab, long long block_bytes, void* stream) {
  if (G <= 0 || G > 0x7fffffffLL || block_bytes <= 0 || block_bytes % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec16 = block_bytes % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec16) {
    block_gather_kernel<uint4><<<static_cast<unsigned>(G), kThreads, 0, s>>>(
        static_cast<const uint4*>(table), idx, static_cast<uint4*>(out), ntab,
        block_bytes / 16);
  } else {
    block_gather_kernel<unsigned int>
        <<<static_cast<unsigned>(G), kThreads, 0, s>>>(
            static_cast<const unsigned int*>(table), idx,
            static_cast<unsigned int*>(out), ntab, block_bytes / 4);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
