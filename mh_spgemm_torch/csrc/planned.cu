// Planned frontend kernels for Hopper (sm_90a): a host-scheduled windowed
// gather (pgather) and a host-simulated routing network (proute).
//
// pgather replaces the TPU kernel mh_spgemm_tpu/ops/planned.py:177
// pgather (body _pgather_kernel, :141; pallas_call :202).  What it
// computes, per scheduled block g (8 output rows of 128) and per plane p:
//
//   out[p][g*1024 + j*128 + l] = tab_p[(wblk[g]*64 + rowsel[g*8+j][ln])*128
//                                      + ln],   ln = lane[g*8+j][l] & 127
//
// where an index outside [0, n_p) reads 0 (the JAX kernel's zero-padded
// table).  A plane is read in place through its pointer and word stride,
// so the two words of an f64 value array are two planes of stride 2 with
// no copy.  Bound on the card: bytes (4 B of lane and 4 B of rowsel read
// per output word, each table word the schedule names read once per
// plane, one 4 B word written per plane; no arithmetic to speak of).  The
// TPU kernel needed an 8-way masked select over [8, 128] sublane gathers
// to reach 64 window rows, because Mosaic has no general gather; here
// each output word is one lane load and one table load: one thread block
// per scheduled block, its 8 rowsel rows (4 KB) in shared memory, the
// table load inside one 32 KB superwindow (L1/L2 resident), the planes
// looped inside the block.
//
// proute replaces the TPU kernel mh_spgemm_tpu/ops/planned.py:386 proute
// (body _proute_body, :355; pallas_call :408).  What it computes, per
// network (a chunk) of m words (m a power of two >= 1024) and per plane:
// for each bitonic stage s = (k, j) of _stage_list(m) in order, position
// f takes the word at f ^ j where bit (s & 31) of masks[s >> 5][f] is set
// (each position applies its own bit; no comparisons); then, when
// hold_w2 > 1, the JAX kernel's segmented hold, pass for pass: for d = 1,
// 2, 4, ... < hold_w2, a slot whose flag is 0 takes the word d slots
// before it in its aligned hold_w2 segment (0 past the segment start) and
// ORs in that slot's flag (1 past the segment start).  A slot with a
// flagged slot at or before it in its segment so ends with the word of the
// last such slot; one with none ends with 0 or a copy of an unflagged
// word, as the passes fall (the engines never read such slots).
// Bound on the card: bytes (the mask words read once, each plane read
// and written once, the flags read once).  The TPU kernel held all m
// words in VMEM and paired positions with rolls and selects; here a
// chunk's up to 131072 words x 3 planes (1.5 MB) do not fit a block's
// 227 KB of shared memory, so a tile of T words per plane (16384, or
// 8192 where 3 planes and the hold's flags would not fit) sits in
// shared memory and one launch runs each maximal run of consecutive
// stages whose partner distance j < T, one thread per pair; each stage
// with j >= T is one global-memory pass (in place, one thread per pair).
// At m = 131072 and T = 16384 that is 6 global passes and 4 shared-memory
// runs.  The hold is fused into the last shared-memory run when hold_w2
// <= T (its log2(hold_w2) passes on the tile and its flags in shared
// memory); otherwise each of its passes is one global-memory launch
// between two buffers.  Every launch covers all networks of the call.
//
// Plain C interface for ctypes.  The functions launch on the given
// stream, do not synchronise, allocate nothing and return
// cudaGetLastError() after the last launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGatherThreads = 256;
constexpr int kRouteThreads = 1024;
constexpr int kMaxTile = 16384;
constexpr int kSmallTile = 8192;
constexpr int kSmemBytes = 232448;      // a block's shared memory on sm_90

struct Planes {
  const int* tab[3];
  long long stride[3];
  long long n[3];
};

__global__ void __launch_bounds__(kGatherThreads)
gather_blocks(Planes planes, int nplanes, const int* __restrict__ wblk,
              const int* __restrict__ rowsel, const int* __restrict__ lane,
              int* __restrict__ out, long long plane_words) {
  __shared__ int rs[1024];
  const long long g = blockIdx.x;
  const int* rs_g = rowsel + g * 1024;
  for (int q = threadIdx.x; q < 1024; q += kGatherThreads) rs[q] = rs_g[q];
  __syncthreads();
  const long long base = static_cast<long long>(wblk[g]) * 64;
  for (int q = threadIdx.x; q < 1024; q += kGatherThreads) {
    const int ln = lane[g * 1024 + q] & 127;
    const long long idx = (base + rs[(q & ~127) + ln]) * 128 + ln;
    for (int p = 0; p < nplanes; ++p) {
      const bool ok = idx >= 0 && idx < planes.n[p];
      out[p * plane_words + g * 1024 + q] =
          ok ? planes.tab[p][idx * planes.stride[p]] : 0;
    }
  }
}

// The lower slot of pair p at partner distance j.
__device__ __forceinline__ int pair_lo(int p, int j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

__device__ __forceinline__ bool take_bit(const unsigned* mask_row, int f,
                                         int s) {
  return (mask_row[f] >> (s & 31)) & 1u;
}

// Stages [s0, s1) (all with j < tile) of every network on one tile of
// `tile` words per plane, in shared memory; reads src, writes dst (they
// may be the same buffer).  hold_w2 > 1: the fused hold on the way out,
// with the flags of the tile.
__global__ void __launch_bounds__(kRouteThreads)
route_tile(const int* src, int* dst, long long plane_words, int nplanes,
           const unsigned* __restrict__ masks, const int* __restrict__ flags,
           int m, int nwords, int tile, int s0, int s1, int hold_w2) {
  extern __shared__ int sm[];
  const int tiles_per_net = m / tile;
  const long long b = blockIdx.x / tiles_per_net;
  const long long g0 = b * m + static_cast<long long>(blockIdx.x %
                                                      tiles_per_net) * tile;
  for (int p = 0; p < nplanes; ++p) {
    for (int i = threadIdx.x; i < tile; i += kRouteThreads) {
      sm[p * tile + i] = src[p * plane_words + g0 + i];
    }
  }
  __syncthreads();
  const unsigned* net_masks = masks + b * nwords * static_cast<long long>(m);
  const long long off = g0 - b * m;            // tile start in its network
  int s = 0;
  for (int k = 2; k <= m && s < s1; k <<= 1) {
    for (int j = k >> 1; j >= 1 && s < s1; j >>= 1, ++s) {
      if (s < s0) continue;
      const unsigned* row = net_masks + (s >> 5) * static_cast<long long>(m)
                            + off;
      for (int q = threadIdx.x; q < (tile >> 1); q += kRouteThreads) {
        const int i = pair_lo(q, j);
        const int l = i | j;
        const bool ti = take_bit(row, i, s);
        const bool tl = take_bit(row, l, s);
        for (int p = 0; p < nplanes; ++p) {
          int* w = sm + p * tile;
          const int a = w[i];
          const int c = w[l];
          w[i] = ti ? c : a;
          w[l] = tl ? a : c;
        }
      }
      __syncthreads();
    }
  }
  if (hold_w2 <= 1) {
    for (int p = 0; p < nplanes; ++p) {
      for (int i = threadIdx.x; i < tile; i += kRouteThreads) {
        dst[p * plane_words + g0 + i] = sm[p * tile + i];
      }
    }
    return;
  }
  // fused hold: the passes on the tile, its flags in shared memory
  // (segments never cross the tile)
  int* fl = sm + nplanes * tile;
  for (int i = threadIdx.x; i < tile; i += kRouteThreads) {
    fl[i] = flags[g0 + i] != 0;
  }
  __syncthreads();
  constexpr int kPer = kMaxTile / kRouteThreads;
  for (int d = 1; d < hold_w2; d <<= 1) {
    int t[kPer];
    for (int p = 0; p <= nplanes; ++p) {       // the planes, then the flags
      int* w = sm + p * tile;
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int i = threadIdx.x + r * kRouteThreads;
        if (i >= tile) break;
        const bool inseg = (i & (hold_w2 - 1)) >= d;
        if (p < nplanes) {
          t[r] = fl[i] ? w[i] : (inseg ? w[i - d] : 0);
        } else {
          t[r] = fl[i] | (inseg ? fl[i - d] : 1);
        }
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int i = threadIdx.x + r * kRouteThreads;
        if (i >= tile) break;
        w[i] = t[r];
      }
      __syncthreads();
    }
  }
  for (int p = 0; p < nplanes; ++p) {
    for (int i = threadIdx.x; i < tile; i += kRouteThreads) {
      dst[p * plane_words + g0 + i] = sm[p * tile + i];
    }
  }
}

// One stage (k, j), j >= tile, of every network, in place in global
// memory: one thread per pair.
__global__ void route_stage(int* buf, long long plane_words, int nplanes,
                            const unsigned* __restrict__ masks, int m,
                            int nwords, int s, int j, long long npairs) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= npairs) return;
  const long long b = t / (m >> 1);
  const int q = static_cast<int>(t % (m >> 1));
  const int i = pair_lo(q, j);
  const int l = i | j;
  const unsigned* row = masks + (b * nwords + (s >> 5)) *
                                    static_cast<long long>(m);
  const bool ti = take_bit(row, i, s);
  const bool tl = take_bit(row, l, s);
  const long long g = b * m;
  for (int p = 0; p < nplanes; ++p) {
    int* w = buf + p * plane_words + g;
    const int a = w[i];
    const int c = w[l];
    w[i] = ti ? c : a;
    w[l] = tl ? a : c;
  }
}

// One pass of the hold at distance d (hold_w2 > tile), one thread per
// slot, from (src, fsrc) into (dst, fdst): different buffers.
__global__ void hold_step(const int* __restrict__ src, int* __restrict__ dst,
                          long long plane_words, int nplanes,
                          const int* __restrict__ fsrc,
                          int* __restrict__ fdst, long long slots,
                          int hold_w2, int d) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= slots) return;
  const bool inseg = static_cast<int>(t & (hold_w2 - 1)) >= d;
  const bool f = fsrc[t] != 0;
  for (int p = 0; p < nplanes; ++p) {
    const int* w = src + p * plane_words;
    dst[p * plane_words + t] = f ? w[t] : (inseg ? w[t - d] : 0);
  }
  fdst[t] = (f || !inseg || fsrc[t - d] != 0) ? 1 : 0;
}

// Tile width and whether the hold is fused, for a call's shape.
void route_shape(int nplanes, int m, int hold_w2, int* tile, bool* fuse) {
  int t = m < kMaxTile ? m : kMaxTile;
  bool f = hold_w2 > 1 && hold_w2 <= t;
  if (static_cast<long long>(nplanes + (f ? 1 : 0)) * t * 4 > kSmemBytes) {
    t = kSmallTile;
    f = hold_w2 > 1 && hold_w2 <= t;
  }
  *tile = t;
  *fuse = f;
}

int launch_tile(const int* src, int* dst, long long plane_words,
                int nplanes, const unsigned* masks, const int* flags,
                int batch, int m, int nwords, int tile, int s0, int s1,
                int hold_w2, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(nplanes + (hold_w2 > 1 ? 1 : 0)) *
                      tile * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      route_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(batch) * (m / tile);
  route_tile<<<static_cast<unsigned>(blocks), kRouteThreads, smem,
               stream>>>(src, dst, plane_words, nplanes, masks, flags, m,
                         nwords, tile, s0, s1, hold_w2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// tab_p: plane p's first word, its word stride and its length (planes
// past nplanes are ignored); wblk int32[nblocks], rowsel and lane
// int32[nblocks * 1024]; out int32[nplanes, plane_words].
int pgather(const int* tab0, long long stride0, long long n0,
            const int* tab1, long long stride1, long long n1,
            const int* tab2, long long stride2, long long n2, int nplanes,
            const int* wblk, const int* rowsel, const int* lane,
            long long nblocks, int* out, long long plane_words,
            void* stream) {
  if (nplanes < 1 || nplanes > 3 || nblocks < 0 ||
      nblocks > 0x7fffffffLL || plane_words < nblocks * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nblocks == 0) return static_cast<int>(cudaSuccess);
  Planes planes = {{tab0, tab1, tab2}, {stride0, stride1, stride2},
                   {n0, n1, n2}};
  gather_blocks<<<static_cast<unsigned>(nblocks), kGatherThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      planes, nplanes, wblk, rowsel, lane, out, plane_words);
  return static_cast<int>(cudaGetLastError());
}

// Words of scratch proute needs for this shape (0 unless the hold runs
// as its own passes: then a second set of planes and two flag buffers).
long long proute_scratch_words(int nplanes, int batch, int m, int hold_w2) {
  int tile;
  bool fuse;
  route_shape(nplanes, m, hold_w2, &tile, &fuse);
  if (hold_w2 <= 1 || fuse) return 0;
  return static_cast<long long>(nplanes + 2) * batch * m;
}

// src and out int32[nplanes, batch * m] with the given plane strides (the
// same for both), scratch as proute_scratch_words says (or null), masks
// int32[batch, nwords, m], flags int32[batch, m] (null when hold_w2 <= 1).
int proute(const int* src, long long src_plane_words, int* out,
           int* scratch, long long plane_words, int nplanes,
           const int* masks, const int* flags, int batch, int m,
           int nstages, int hold_w2, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nplanes < 1 || nplanes > 3 || batch < 0 || m < 1024 ||
      (m & (m - 1)) != 0 || src_plane_words != plane_words ||
      plane_words < static_cast<long long>(batch) * m || hold_w2 < 1 ||
      (hold_w2 & (hold_w2 - 1)) != 0 || hold_w2 > m ||
      (hold_w2 > 1 && flags == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int nst = 0;
  for (int k = 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) ++nst;
  }
  if (nst != nstages) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  const int nwords = (nstages + 31) / 32;
  int tile;
  bool fuse;
  route_shape(nplanes, m, hold_w2, &tile, &fuse);
  const bool separate = hold_w2 > 1 && !fuse;
  if (separate && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // route into `work`; the separate hold's passes then alternate between
  // the two plane buffers so that the last one writes `out`
  int npass = 0;
  for (int d = 1; d < hold_w2; d <<= 1) ++npass;
  int* work = (separate && npass % 2 == 1) ? scratch : out;
  const unsigned* mk = reinterpret_cast<const unsigned*>(masks);
  const long long npairs = static_cast<long long>(batch) * (m >> 1);
  const int gthreads = 256;
  const unsigned gblocks =
      static_cast<unsigned>((npairs + gthreads - 1) / gthreads);
  const int* from = src;
  int run0 = 0;
  int s = 0;
  int rc = 0;
  for (int k = 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1, ++s) {
      if (j < tile) continue;
      if (run0 < s) {          // flush the shared-memory run before it
        rc = launch_tile(from, work, plane_words, nplanes, mk, nullptr,
                         batch, m, nwords, tile, run0, s, 1, st);
        if (rc != 0) return rc;
        from = work;
      }
      route_stage<<<gblocks, gthreads, 0, st>>>(work, plane_words, nplanes,
                                                mk, m, nwords, s, j, npairs);
      rc = static_cast<int>(cudaGetLastError());
      if (rc != 0) return rc;
      run0 = s + 1;
    }
  }
  // the last run always exists: the final stages of a merge have j < tile
  rc = launch_tile(from, work, plane_words, nplanes, mk, fuse ? flags : nullptr,
                   batch, m, nwords, tile, run0, s, fuse ? hold_w2 : 1, st);
  if (rc != 0) return rc;
  if (separate) {
    const long long slots = static_cast<long long>(batch) * m;
    int* fbuf[2] = {scratch + nplanes * plane_words,
                    scratch + nplanes * plane_words + slots};
    const int* fsrc = flags;
    int* cur = work;
    for (int k = 0, d = 1; d < hold_w2; ++k, d <<= 1) {
      int* next = cur == out ? scratch : out;
      hold_step<<<static_cast<unsigned>((slots + 255) / 256), 256, 0, st>>>(
          cur, next, plane_words, nplanes, fsrc, fbuf[k & 1], slots, hold_w2,
          d);
      rc = static_cast<int>(cudaGetLastError());
      if (rc != 0) return rc;
      fsrc = fbuf[k & 1];
      cur = next;
    }
  }
  return rc;
}

}  // extern "C"
