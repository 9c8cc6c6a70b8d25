// Pair-stream block matmul and block gather for Hopper (sm_90a).
//
// pair_matmul_f64 / pair_matmul_f32 (one kernel template, two value
// types).  Replace the TPU kernels mh_spgemm_tpu/ops/ozaki.py:201
// pair_matmul_f64_ozaki (body _ozaki_kernel, :162) and
// mh_spgemm_tpu/ops/pallas_gather.py:108 pair_matmul_f32 (body
// _pair_matmul_kernel, :83).  What they compute, for 128 x 128 blocks
// a[nab], b[nbb] and a pair stream (pair_a, pair_b, pair_cb, live) sorted
// by C block:
//
//     out[c] = sum over g with pair_cb[g] == c of live[g] * a[pair_a[g]] @ b[pair_b[g]]
//
// and zero for a C block with no live pair.  The TPU kernels walk the
// pairs in order on one core and keep the C block's accumulator in VMEM
// while the output index map revisits it; the f64 one carries values as
// bf16 slices with a double-f32 accumulator, the f32 one runs the MXU at
// Precision.HIGHEST (a multi-pass bf16 emulation of f32).  Here:
//   - f64 runs on the FP64 tensor cores (DMMA: mma.sync m16n8k4 .f64),
//     accumulating in f64 registers;
//   - f32 runs on the TF32 tensor cores in split form ("3xTF32"), the
//     card's counterpart of Precision.HIGHEST: each operand x is split
//     into big = tf32(x) (cvt.rna) and small = tf32(x - big), and
//     small*big + big*small + big*big (smaller terms first) go through
//     mma.sync m16n8k8 .tf32 with f32 accumulation; small*small (under
//     2^-22 |a||b|) is dropped.  The tensor cores' own additions lose
//     low bits (summing a whole segment in their accumulator measured
//     about 100 times f32 torch.bmm's error), so each k-slice's products
//     are summed in a register tile of their own, which is then added to
//     the accumulator with FADD (round to nearest).  Its error is then of
//     the order of FFMA's; for 0/1 operands small is 0 and every partial
//     sum an integer below 2^24, so the engine's pattern product is
//     exact.
//
// Bound on the card: operations.  A pair is 2 * 128^3 flops on at most
// 2 * 128^2 operand elements; at the H100's FP64 tensor-core peak (67
// TFLOP/s) or three TF32 passes at 495 TFLOP/s the flops outlast the
// bytes of the distinct blocks at 3.35 TB/s.  But a pair's operands are
// 2 x 128 KB (f64), so the blocks must stream from L2 and device memory
// while the tensor cores work: the design is a ring of k-slices.
//
// Design.  One C block is computed by kBS / ROWS thread blocks, each
// owning ROWS rows of it: the f64 kernel takes ROWS = 64 (two thread
// blocks a C block, adjacent in launch order, so the second finds B's
// slices in L2), the f32 kernel ROWS = 128 (one; its split needs the
// registers: at 64 rows and 128 registers it spilled and ran 1.2 times
// slower, PERF.md).  A thread block loops over its own segment of pairs
// seg_start[c] .. seg_start[c+1] (the wrapper computes seg_start from
// pair_cb on the device), so blocks run in any order with no atomics,
// the result is deterministic, and every output element is written
// once.  Dead pairs (live == 0) are skipped before any of their slices
// is loaded.
//   - The ring: the block's work is the flat sequence of (live pair,
//     k-slice), BK = 128 bytes deep (16 doubles or 32 floats), so the
//     next pair's first slices load while this pair's last ones compute.
//     STAGES = 3 slices are in flight in dynamic shared memory, each
//     filled by 16-byte cp.async.cg (LDGSTS) and fenced by
//     cp.async.wait_group STAGES-2 and one __syncthreads per slice.  A
//     stage is A's ROWS x BK slice in its stored row-major layout (a
//     128-byte run per row, not transposed) and B's BK x 128 slice
//     (1 KB (f64) or 512 B (f32) per row): 24 KB (f64) or 32 KB (f32), so
//     72 or 96 KB for the ring, and the launch function raises the
//     kernel's dynamic shared memory limit once per device.
//   - Warps: 8, 2 along the rows x 4 along the columns, each owning a
//     (ROWS/2) x 32 tile of C in registers: f64 32 x 32 (2 x 4 m16n8
//     tiles, 32 accumulators a thread), held to 128 registers
//     (__launch_bounds__(256, 2)) so that two blocks are resident per SM
//     and one block's prologue and epilogue (64 KB of C written per f64
//     thread block) overlap the other's products; f32 64 x 32 (4 x 4
//     tiles, 64 accumulators and 64 slice sums, 255 registers, one
//     block per SM).
//   - Fragment maps (PTX ISA, .row.col; lane = 4g + t): A element i at
//     row g + 8 (i & 1), column t + 4 (i >> 1); B element i at k = t + 4i,
//     column g; C element i at row g + 8 (i >> 1), column 2t + (i & 1).
//   - Bank arithmetic (32 banks of 4 bytes; shared memory is swizzled by
//     16-byte chunk, chunk c of a row stored at chunk c ^ s):
//     f64 A, rows of 16 doubles = 8 chunks, s = 2 (r & 3).  A 64-bit load
//     is served per half-warp: lanes g = 0..3, t = 0..3 read rows r = r0
//     + g (r0 a multiple of 8, so r & 3 = g), columns k0 + t (k0 a multiple
//     of 4), i.e. chunks k0/2 + (t >> 1): an even chunk and the next.
//     XOR with 2g in {0, 2, 4, 6} sends the four rows' chunk pairs to the
//     8 distinct chunks of the 128-byte bank line, 16 doubles on 32 banks:
//     no conflict (without it, all four rows hit the same 4 banks).
//     f64 B, rows of 128 doubles, s = 2 (k & 3): lanes t read rows k0 + t
//     (k & 3 = t), g columns n0 + g (n0 a multiple of 8), chunks n0/2 +
//     (g >> 1), an aligned pair inside an aligned group of 4; XOR with 2t
//     again covers the 8 chunks of a bank line.  f32 A, rows of 32 floats
//     = 8 chunks, s = r & 7: a 32-bit load is served per warp, lanes read
//     rows r0 + g (g = 0..7), columns k0 + t inside one chunk, so chunk ^ g
//     spreads the 8 rows over the 8 chunks, 32 floats on 32 banks.  f32 B,
//     rows of 128 floats, s = 2 (k & 3): rows k0 + t, columns n0 + g (g =
//     0..7: two chunks, an aligned pair), XOR with 2t gives 8 distinct
//     chunks.  The cp.async stores write 8 chunks of one bank line per
//     8-thread phase, a permutation of it: no conflict either.
//   - Epilogue: each lane stores its two neighbouring C elements as one
//     16-byte (f64) or 8-byte (f32) store, straight from registers.
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
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBS = 128;        // block edge
constexpr int kThreads = 256;   // 8 warps: 2 along the rows x 4 along the columns
constexpr int kWarpsM = 2;
constexpr int kWarpN = 32;      // columns of a warp's tile

// Per value type: the rows of C a thread block owns, the ring's stages
// and the mma.sync shape, M x 8 x K.
template <typename T>
struct Config;
template <>
struct Config<double> {
  static constexpr int ROWS = 64;
  static constexpr int STAGES = 3;
  static constexpr int M = 16;
  static constexpr int K = 4;
};
template <>
struct Config<float> {
  static constexpr int ROWS = 128;
  static constexpr int STAGES = 3;
  static constexpr int M = 16;
  static constexpr int K = 8;
};

// One 128-byte row of A per k-slice: 16 doubles or 32 floats deep.
template <typename T>
struct Slice {
  static constexpr int ROWS = Config<T>::ROWS;
  static constexpr int STAGES = Config<T>::STAGES;
  static_assert(ROWS == 64 || ROWS == 128, "rows per block: 64 or 128");
  static_assert(STAGES >= 2, "stages: at least 2");
  static constexpr int BK = 128 / sizeof(T);
  static constexpr int EPC = 16 / sizeof(T);      // elements per 16-byte chunk
  static constexpr int KS = kBS / BK;             // slices per pair
  static constexpr int A_ELEMS = ROWS * BK;
  static constexpr int STAGE = A_ELEMS + BK * kBS;
  static constexpr int SMEM = STAGES * STAGE * static_cast<int>(sizeof(T));
  // A slice element (r, k), [ROWS][BK], swizzled (bank arithmetic above)
  __device__ static int a_off(int r, int k) {
    const int s = sizeof(T) == 8 ? (r & 3) << 1 : r & 7;
    return r * BK + ((k / EPC) ^ s) * EPC + k % EPC;
  }
  // B slice element (k, n), [BK][kBS], swizzled
  __device__ static int b_off(int k, int n) {
    return k * kBS + ((n / EPC) ^ ((k & 3) << 1)) * EPC + n % EPC;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// m16n8k4 .f64 (PTX ISA 7.8, sm_90): a lane holds 2 A, 1 B and 4 C
// elements.
__device__ __forceinline__ void mma_f64(double (&c)[4], const double (&a)[2],
                                        const double (&b)[1]) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = big + small + (what is dropped), both TF32 (cvt.rna: to nearest,
// ties away from zero).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

__device__ __forceinline__ void store2(double* p, double x, double y) {
  *reinterpret_cast<double2*>(p) = make_double2(x, y);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ int next_live(const int* __restrict__ live, int g,
                                         int g1) {
  while (g < g1 && live[g] == 0) ++g;
  return g;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, Config<T>::ROWS == 64 ? 2 : 1)
pair_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const int* __restrict__ pair_a,
                   const int* __restrict__ pair_b,
                   const int* __restrict__ live,
                   const int* __restrict__ seg_start, T* __restrict__ out) {
  using S = Slice<T>;
  constexpr int BK = S::BK;
  constexpr int EPC = S::EPC;
  constexpr int ROWS = S::ROWS;
  constexpr int STAGES = S::STAGES;
  constexpr int M = Config<T>::M;
  constexpr int K = Config<T>::K;
  constexpr int NA = M * K / 32;          // A elements a lane holds
  constexpr int NB = K / 4;               // B elements a lane holds
  constexpr int NC = M / 4;               // C elements a lane holds
  constexpr int WTM = ROWS / kWarpsM;     // rows of a warp's tile
  constexpr int MT = WTM / M;             // m-tiles a warp
  constexpr int NT = kWarpN / 8;          // n-tiles a warp
  constexpr bool kF64 = sizeof(T) == 8;
  constexpr int CPR = kBS / EPC;          // 16-byte chunks of a B row
  static_assert((ROWS * 8) % kThreads == 0 && (BK * CPR) % kThreads == 0,
                "a slice is a whole number of chunks a thread");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  constexpr int kParts = kBS / ROWS;     // thread blocks a C block
  const int c = blockIdx.x / kParts;
  const int row0 = (blockIdx.x % kParts) * ROWS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = (warp % kWarpsM) * WTM;  // first row of the warp's tile
  const int wc = (warp / kWarpsM) * kWarpN;

  T acc[MT][NT][NC];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[mt][nt][i] = T(0);

  const int g1 = seg_start[c + 1];
  int gl = next_live(live, seg_start[c], g1);   // next slice to load
  int kl = 0;
  int gc = gl;                                   // next slice to compute
  int kc = 0;

  // Start the copies of the next slice of the flat (live pair, k-slice)
  // sequence into stage st; one commit group per call, empty past the
  // end.
  auto load = [&](int st) {
    if (gl < g1) {
      T* as = smem + st * S::STAGE;
      T* bs = as + S::A_ELEMS;
      const T* ap = a + static_cast<size_t>(pair_a[gl]) * kBS * kBS +
                    static_cast<size_t>(row0) * kBS + kl * BK;
      const T* bp = b + static_cast<size_t>(pair_b[gl]) * kBS * kBS +
                    static_cast<size_t>(kl) * BK * kBS;
#pragma unroll
      for (int j = 0; j < ROWS * 8 / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int r = i >> 3;                  // 8 chunks of an A row
        const int ch = i & 7;
        cp_async16(as + S::a_off(r, ch * EPC), ap + r * kBS + ch * EPC);
      }
#pragma unroll
      for (int j = 0; j < BK * CPR / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int k = i / CPR;
        const int ch = i % CPR;
        cp_async16(bs + S::b_off(k, ch * EPC), bp + k * kBS + ch * EPC);
      }
      if (++kl == S::KS) {
        kl = 0;
        gl = next_live(live, gl + 1, g1);
      }
    }
    cp_async_commit();
  };

  auto compute = [&](int st) {
    const T* as = smem + st * S::STAGE;
    const T* bs = as + S::A_ELEMS;
    if constexpr (kF64) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += K) {
        double af[MT][NA];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < NA; ++i)
            af[mt][i] = as[S::a_off(wr + mt * M + g + 8 * (i & 1),
                                    kk + t + 4 * (i >> 1))];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          double bf[NB];
#pragma unroll
          for (int i = 0; i < NB; ++i)
            bf[i] = bs[S::b_off(kk + t + 4 * i, wc + nt * 8 + g)];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_f64(acc[mt][nt], af[mt], bf);
        }
      }
    } else {
      float part[MT][NT][NC];   // this k-slice's products
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < NC; ++i) part[mt][nt][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK; kk += K) {
        uint32_t ab[MT][NA];
        uint32_t as_[MT][NA];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < NA; ++i)
            split_tf32(as[S::a_off(wr + mt * M + g + 8 * (i & 1),
                                   kk + t + 4 * (i >> 1))],
                       ab[mt][i], as_[mt][i]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bb[NB];
          uint32_t bs_[NB];
#pragma unroll
          for (int i = 0; i < NB; ++i)
            split_tf32(bs[S::b_off(kk + t + 4 * i, wc + nt * 8 + g)], bb[i],
                       bs_[i]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_tf32(part[mt][nt], as_[mt], bb);
            mma_tf32(part[mt][nt], ab[mt], bs_);
            mma_tf32(part[mt][nt], ab[mt], bb);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < NC; ++i) acc[mt][nt][i] += part[mt][nt][i];
    }
  };

#pragma unroll 1
  for (int st = 0; st < STAGES - 1; ++st) load(st);
  int st = 0;
  while (gc < g1) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    load(st == 0 ? STAGES - 1 : st - 1);    // the stage computed last
    compute(st);
    st = st + 1 == STAGES ? 0 : st + 1;
    if (++kc == S::KS) {
      kc = 0;
      gc = next_live(live, gc + 1, g1);
    }
  }
  cp_async_wait<0>();

  T* op = out + static_cast<size_t>(c) * kBS * kBS;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < NC / 2; ++h) {
        const int r = row0 + wr + mt * M + g + 8 * h;
        store2(op + r * kBS + wc + nt * 8 + 2 * t, acc[mt][nt][2 * h],
               acc[mt][nt][2 * h + 1]);
      }
}

// Raise the kernel's dynamic shared memory limit, once per device.
template <typename T>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < 64;
  if (known && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(pair_matmul_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Slice<T>::SMEM);
  if (err == cudaSuccess && known) done[dev] = true;
  return err;
}

template <typename T>
int launch_pair_matmul(const T* a, const T* b, const int* pair_a,
                       const int* pair_b, const int* live,
                       const int* seg_start, T* out, int ncb,
                       cudaStream_t stream) {
  constexpr int parts = kBS / Slice<T>::ROWS;
  if (ncb <= 0 || ncb > INT_MAX / parts) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = allow_smem<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_matmul_kernel<T><<<static_cast<unsigned>(ncb * parts), kThreads,
                          Slice<T>::SMEM, stream>>>(
      a, b, pair_a, pair_b, live, seg_start, out);
  return static_cast<int>(cudaGetLastError());
}

// What the runtime reports of the kernel: registers, dynamic shared
// memory bytes, local (stack and spill) bytes, resident blocks per SM.
template <typename T>
int pair_matmul_info_of(int* info) {
  cudaError_t err = allow_smem<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes at;
  err = cudaFuncGetAttributes(&at, pair_matmul_kernel<T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, pair_matmul_kernel<T>, kThreads, Slice<T>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = at.numRegs;
  info[1] = Slice<T>::SMEM;
  info[2] = static_cast<int>(at.localSizeBytes);
  info[3] = blocks;
  return 0;
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

// info[0..3] of the f64 (f64 != 0) or the f32 kernel: registers, dynamic
// shared memory bytes, local bytes, resident blocks per SM.
int pair_matmul_info(int f64, int* info) {
  return f64 ? pair_matmul_info_of<double>(info)
             : pair_matmul_info_of<float>(info);
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
