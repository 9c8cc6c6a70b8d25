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
// to reach 64 window rows, because Mosaic has no general gather.  Here a
// thread makes 4 consecutive output words of one row from one 16-byte
// lane load: 4 independent rowsel loads (read-only path, no staging in
// shared memory), then the table loads of every plane, unrolled by a
// template on the plane count so the plane table is indexed by constants
// only.  Where two neighbouring planes are the low and high words of one
// f64 array (stride 2, the second one word past the first), one 8-byte
// load reads both.  The outputs go out as 16-byte stores; a grid sized to
// the card walks the scheduled blocks.
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
// ORs in that slot's flag (1 past the segment start).
// Bound on the card: bytes (the mask words read once, each plane read
// and written once, the flags read once).
//
// Design.  Every stage is a gather (position f takes f or f ^ j), so the
// stages compose: they are replayed once on one plane of source indices,
// and the planes move once, in a final gather out[f] = in[src[f]].  The
// replay is work of order m log^2 m, and carrying one index instead of 1
// to 3 planes through it is the saving that matters.  The hold's passes
// are a Hillis-Steele scan of an associative operator ("a flagged slot
// keeps its word, an unflagged one takes its left neighbour's"), with the
// segment start padded by flagged zeros; so after log2(hold_w2) passes a
// slot holds the word of the last flagged slot at or before it in its
// segment, or, with none, 0, except the segment's last slot, which holds
// the segment's first word.  The final gather computes that source with a
// prefix max of the flagged positions and reads the routed word there.
//
// The replay (route_all, one cooperative launch a call): a block owns a
// tile of T positions of one network at a time (T = 1024 to 8192, picked
// per call by tile_log: fewer passes against more SMs), 16 a
// thread, in registers with the mask word of the current 32-stage group
// beside each.  Two layouts place the position bits: layout 0 keeps bits
// 0-4 in the lane, 5-8 in the register and the rest in the warp; layout 1
// keeps bits 0-4 in the lane, the top 4 bits in the register and the
// middle in the warp.  A stage with j < 32 is one shuffle (each lane
// takes lane ^ j's word or keeps its own, by its bit); a stage whose j is
// a register bit of the current layout swaps registers inside the thread;
// only a change of layout (twice for each merge wider than 512) goes
// through shared memory, the mask words with it, so each mask word is
// read once per tile pass.  Stages with j >= T cross tiles: a high pass
// runs the up to 4 such stages of one merge in registers, each thread
// owning the positions that differ in those bits.  The passes follow one
// another behind grid barriers inside the one launch (the blocks walk
// the tiles; the grid is what the occupancy calculator says fits the card
// at once), so a call is one launch: on the H100 hosts measured a launch
// costs 5-10 us of host time, more than most passes take on the card.
// At m = 131072 and T = 8192 that is 5 tile passes and 4 high passes.
// Without the hold the last tile pass moves the planes itself (out[f] =
// in[index], coalesced stores); with it route_gather moves them (16
// consecutive slots a thread, 16-byte stores) and applies the hold, and
// hold_tile_last gives it the last flagged slot of each 4096-slot tile
// where a segment spans tiles (hold_w2 > 4096).  No launch needs more
// than 48 KB of shared memory, so none sets a function attribute.
//
// Plain C interface for ctypes.  The functions launch on the given
// stream, do not synchronise, allocate nothing and return
// cudaGetLastError() after the last launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGatherThreads = 256;
constexpr int kR = 16;                   // positions a thread owns in a tile
constexpr int kMaxTileLog = 13;
constexpr int kMaxTile = 1 << kMaxTileLog;
constexpr int kHighMax = 4;              // stages a high pass runs at most
constexpr int kSlotsPer = 16;            // slots a thread of route_gather
constexpr int kGatherTile = 256 * kSlotsPer;
constexpr unsigned kFull = 0xffffffffu;

struct Planes {
  const int* tab[3];
  long long stride[3];
  long long n[3];
};

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0) {
    int c = 0;
    cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
    count[dev] = c > 0 ? c : 132;
  }
  return count[dev];
}

// PAIR >= 0: planes PAIR and PAIR + 1 are the low and high words of one
// f64 array, read with one 8-byte load.
template <int P, int PAIR>
__global__ void __launch_bounds__(kGatherThreads)
gather_blocks(Planes planes, const int* __restrict__ wblk,
              const int* __restrict__ rowsel, const int* __restrict__ lane,
              int* __restrict__ out, long long plane_words,
              long long nblocks) {
  for (long long g = blockIdx.x; g < nblocks; g += gridDim.x) {
    const long long base = static_cast<long long>(__ldg(wblk + g)) * 64;
    const int4 l4 = __ldg(reinterpret_cast<const int4*>(lane + g * 1024) +
                          threadIdx.x);
    const int* rs = rowsel + g * 1024 + ((threadIdx.x * 4) & ~127);
    const int ln[4] = {l4.x & 127, l4.y & 127, l4.z & 127, l4.w & 127};
    long long idx[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      idx[u] = (base + __ldg(rs + ln[u])) * 128 + ln[u];
    }
    int v[4][4];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (PAIR >= 0 && p == PAIR + 1) continue;     // read with its pair
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool ok = idx[u] >= 0 && idx[u] < planes.n[p];
        if (p == PAIR) {
          const long long w =
              ok ? __ldg(reinterpret_cast<const long long*>(planes.tab[p]) +
                         idx[u])
                 : 0;
          v[p][u] = static_cast<int>(w & 0xffffffffLL);
          v[p + 1][u] = static_cast<int>(w >> 32);
        } else {
          v[p][u] = ok ? __ldg(planes.tab[p] + idx[u] * planes.stride[p])
                       : 0;
        }
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      reinterpret_cast<int4*>(out + p * plane_words + g * 1024)[threadIdx.x] =
          make_int4(v[p][0], v[p][1], v[p][2], v[p][3]);
    }
  }
}

template <int P, int PAIR>
int launch_gather(const Planes& planes, const int* wblk, const int* rowsel,
                  const int* lane, int* out, long long plane_words,
                  long long nblocks, cudaStream_t st) {
  const long long cap = static_cast<long long>(sm_count()) * 8;
  const unsigned grid =
      static_cast<unsigned>(nblocks < cap ? nblocks : cap);
  gather_blocks<P, PAIR><<<grid, kGatherThreads, 0, st>>>(
      planes, wblk, rowsel, lane, out, plane_words, nblocks);
  return static_cast<int>(cudaGetLastError());
}

// Position in the tile of register r: layout 0 keeps bits 5-8 in the
// register, layout 1 the top 4 bits (lt = log2 of the tile).
__device__ __forceinline__ int tile_pos(int layout, int r, int warp, int lane,
                                        int lt) {
  return layout ? ((r << (lt - 4)) | (warp << 5) | lane)
                : ((warp << 9) | (r << 5) | lane);
}

// One stage whose partner is Q registers away: position r takes r ^ Q
// where its bit is set.
template <int Q>
__device__ __forceinline__ void reg_stage(int (&x)[kR],
                                          const unsigned (&mk)[kR],
                                          unsigned bm) {
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r & Q) continue;
    const int a = x[r];
    const int c = x[r | Q];
    x[r] = (mk[r] & bm) ? c : a;
    x[r | Q] = (mk[r | Q] & bm) ? a : c;
  }
}

// Stages [s0, s1) (all with j < T = 2^lt) of tile `tile` on the source
// index plane: idx_in (null: the identity) to idx_out, which may be the
// same buffer; or, on the last pass of a call without the hold (out not
// null), the planes themselves: out[p][f] = src[p][network + index].  The
// block's T / 16 threads run it; the index plane is read past L1 (other
// blocks wrote it before the last grid barrier).
__device__ void tile_pass(int tile, const int* idx_in, int* idx_out,
                          const unsigned* __restrict__ masks, int m,
                          int nwords, int lt, int s0, int s1,
                          const int* __restrict__ src, int* out,
                          long long plane_words, int nplanes, int* sm) {
  const int tiles = m >> lt;
  const long long b = tile / tiles;
  const int toff = (tile % tiles) << lt;
  const long long g0 = b * m + toff;       // the tile's first slot
  const unsigned* nmask = masks + b * nwords * static_cast<long long>(m) +
                          toff;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // (p, e) of stage s0: merge k = 2^p, partner distance j = 2^e
  int p = 1;
  int s = 0;
  while (s + p <= s0) {
    s += p;
    ++p;
  }
  int e = p - 1 - (s0 - s);
  int layout = e >= 9 ? 1 : 0;
  int x[kR];
  unsigned mk[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int f = tile_pos(layout, r, warp, lane, lt);
    x[r] = idx_in ? __ldcg(idx_in + g0 + f) : toff + f;
  }
  int group = -1;
  for (s = s0; s < s1; ++s) {
    if ((s >> 5) != group) {                // the next 32 stages' bits
      group = s >> 5;
      const unsigned* row = nmask + group * static_cast<long long>(m);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        mk[r] = __ldg(row + tile_pos(layout, r, warp, lane, lt));
      }
    }
    const unsigned bm = 1u << (s & 31);
    if (e < 5) {
      const int j = 1 << e;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int y = __shfl_xor_sync(kFull, x[r], j);
        x[r] = (mk[r] & bm) ? y : x[r];
      }
    } else {
      int want = layout;
      if (layout == 0 && e >= 9) want = 1;
      if (layout == 1 && e < lt - 4) want = 0;
      if (want != layout) {                 // through shared memory
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          sm[tile_pos(layout, r, warp, lane, lt)] = x[r];
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          x[r] = sm[tile_pos(want, r, warp, lane, lt)];
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          sm[tile_pos(layout, r, warp, lane, lt)] = static_cast<int>(mk[r]);
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          mk[r] = static_cast<unsigned>(sm[tile_pos(want, r, warp, lane, lt)]);
        }
        __syncthreads();
        layout = want;
      }
      switch (1 << (layout ? e - (lt - 4) : e - 5)) {
        case 1: reg_stage<1>(x, mk, bm); break;
        case 2: reg_stage<2>(x, mk, bm); break;
        case 4: reg_stage<4>(x, mk, bm); break;
        default: reg_stage<8>(x, mk, bm); break;
      }
    }
    if (--e < 0) {
      ++p;
      e = p - 1;
    }
  }
  if (out == nullptr) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      __stcg(idx_out + g0 + tile_pos(layout, r, warp, lane, lt), x[r]);
    }
  } else {
    for (int q = 0; q < nplanes; ++q) {
      const int* from = src + q * plane_words + b * m;
      int* to = out + q * plane_words + g0;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        to[tile_pos(layout, r, warp, lane, lt)] = __ldg(from + x[r]);
      }
    }
  }
  __syncthreads();                         // sm is free for the next tile
}

// H consecutive stages s_first, ... of one merge whose partner distances
// are the bits lb + H - 1 down to lb (all >= the tile), in place on the
// index plane, for unit t: the 2^H positions that differ in those bits.
template <int H>
__device__ void high_unit(long long t, int* idx,
                          const unsigned* __restrict__ masks, int m,
                          int nwords, int lb, int s_first) {
  constexpr int U = 1 << H;
  const int per = m >> H;
  const long long b = t / per;
  const int rem = static_cast<int>(t % per);
  const int f0 = ((rem >> lb) << (lb + H)) | (rem & ((1 << lb) - 1));
  int* net = idx + b * m;
  const unsigned* ma = masks + (b * nwords + (s_first >> 5)) *
                               static_cast<long long>(m);
  const unsigned* mb = ma + m;             // the next group's words
  int x[U];
  unsigned k[U];                           // the mask words of stage s
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int f = f0 | (u << lb);
    x[u] = __ldcg(net + f);
    k[u] = __ldg(ma + f);
  }
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const int s = s_first + i;
    const unsigned bm = 1u << (s & 31);
    if (s > s_first && (s & 31) == 0) {    // the stages cross a group
#pragma unroll
      for (int u = 0; u < U; ++u) k[u] = __ldg(mb + (f0 | (u << lb)));
    }
    constexpr int kTop = U >> 1;
    const int q = kTop >> i;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u & q) continue;
      const int a = x[u];
      const int c = x[u | q];
      x[u] = (k[u] & bm) ? c : a;
      x[u | q] = (k[u | q] & bm) ? a : c;
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) __stcg(net + (f0 | (u << lb)), x[u]);
}

template <int H>
__device__ void high_pass(int* idx, const unsigned* __restrict__ masks,
                          int m, int nwords, int lb, int s_first,
                          long long units) {
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < units; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    high_unit<H>(t, idx, masks, m, nwords, lb, s_first);
  }
}

// Every block of the grid waits here until all have arrived (the grid is
// co-resident: a cooperative launch).  bar[0] counts arrivals and returns
// to 0, bar[1] counts barriers; both start at 0.  A wait that lasts about
// a second (only a fault gets there) traps rather than hang the card: the
// launch fails, and the next call that synchronises with it raises.
__device__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      for (int spin = 0; *gen == g; ++spin) {
        if (spin == (1 << 24)) __trap();
        __nanosleep(64);
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// The whole replay in one launch: the merges that fit a tile, then per
// wider merge its stages with j >= T in high passes of up to 4 and its
// last lt stages on the tiles, a grid barrier between passes; each block
// walks tiles blockIdx.x, + gridDim.x, ...  Without the hold (out not
// null) the last tile pass moves the planes.
__global__ void __launch_bounds__(kMaxTile / kR)
route_all(int* perm, const unsigned* __restrict__ masks,
          unsigned* bar, int m, int n, int nwords, int lt,
          long long slots, const int* __restrict__ src, int* out,
          long long plane_words, int nplanes) {
  extern __shared__ int sm[];              // T words: a change of layout
  const int ntiles = static_cast<int>(slots >> lt);
  int s = lt * (lt + 1) / 2;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    tile_pass(t, nullptr, perm, masks, m, nwords, lt, 0, s, src,
              n == lt ? out : nullptr, plane_words, nplanes, sm);
  }
  for (int lk = lt + 1; lk <= n; ++lk) {
    for (int top = lk - 1; top >= lt;) {    // partner bits top .. lb
      const int h = top - lt + 1 < kHighMax ? top - lt + 1 : kHighMax;
      const int lb = top - h + 1;
      grid_sync(bar);
      switch (h) {
        case 1: high_pass<1>(perm, masks, m, nwords, lb, s, slots >> 1); break;
        case 2: high_pass<2>(perm, masks, m, nwords, lb, s, slots >> 2); break;
        case 3: high_pass<3>(perm, masks, m, nwords, lb, s, slots >> 3); break;
        default: high_pass<4>(perm, masks, m, nwords, lb, s, slots >> 4); break;
      }
      s += h;
      top -= h;
    }
    grid_sync(bar);
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      tile_pass(t, perm, perm, masks, m, nwords, lt, s, s + lt, src,
                lk == n ? out : nullptr, plane_words, nplanes, sm);
    }
    s += lt;
  }
}

// The last flagged slot of each route_gather tile (-1 for none).
__global__ void __launch_bounds__(256)
hold_tile_last(const int* __restrict__ flags, int* __restrict__ tile_last,
               long long slots) {
  __shared__ int wmax[8];
  const long long i0 = (static_cast<long long>(blockIdx.x) * 256 +
                        threadIdx.x) * kSlotsPer;
  int best = -1;
  if (i0 < slots) {
#pragma unroll
    for (int v = 0; v < kSlotsPer / 4; ++v) {
      const int4 f = __ldg(reinterpret_cast<const int4*>(flags + i0) + v);
      const int i = static_cast<int>(i0) + 4 * v;
      if (f.x) best = i;
      if (f.y) best = i + 1;
      if (f.z) best = i + 2;
      if (f.w) best = i + 3;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    best = max(best, __shfl_xor_sync(kFull, best, o));
  }
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = wmax[0];
    for (int w = 1; w < 8; ++w) t = max(t, wmax[w]);
    tile_last[blockIdx.x] = t;
  }
}

// out[p][i] = src[p][network base + perm[h(i)]], where h(i) = i without
// the hold, else the hold's source slot (the last flagged slot at or
// before i in its segment; with none, the segment start for its last slot
// and no source, 0, for the others).  16 consecutive slots a thread.
template <int P>
__global__ void __launch_bounds__(256)
route_gather(const int* __restrict__ src, int* __restrict__ out,
             long long plane_words, const int* __restrict__ perm,
             const int* __restrict__ flags,
             const int* __restrict__ tile_last, int m, int hold,
             long long slots) {
  __shared__ int wtot[8];
  __shared__ int carry;
  const long long i0 = (static_cast<long long>(blockIdx.x) * 256 +
                        threadIdx.x) * kSlotsPer;
  const bool active = i0 < slots;
  int hs[kSlotsPer];                       // source slot, -1 for none
#pragma unroll
  for (int u = 0; u < kSlotsPer; ++u) hs[u] = static_cast<int>(i0) + u;
  if (hold > 1) {
    // prefix max of the flagged slots: thread, warp, block, earlier tiles
    int run = -1;
#pragma unroll
    for (int v = 0; v < kSlotsPer / 4; ++v) {
      const int4 f = active
          ? __ldg(reinterpret_cast<const int4*>(flags + i0) + v)
          : make_int4(0, 0, 0, 0);
      const int i = static_cast<int>(i0) + 4 * v;
      run = f.x ? i : run;
      hs[4 * v] = run;
      run = f.y ? i + 1 : run;
      hs[4 * v + 1] = run;
      run = f.z ? i + 2 : run;
      hs[4 * v + 2] = run;
      run = f.w ? i + 3 : run;
      hs[4 * v + 3] = run;
    }
    const int lane = threadIdx.x & 31;
    int incl = run;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = max(incl, y);
    }
    int before = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) before = -1;
    if (lane == 31) wtot[threadIdx.x >> 5] = incl;
    if (threadIdx.x == 0) carry = -1;
    __syncthreads();
    if (hold > kGatherTile && threadIdx.x < 32) {
      const long long t0 = (static_cast<long long>(blockIdx.x) *
                            kGatherTile & ~static_cast<long long>(hold - 1)) /
                           kGatherTile;
      int c = -1;
      for (long long q = t0 + threadIdx.x; q < blockIdx.x; q += 32) {
        c = max(c, tile_last[q]);
      }
      for (int o = 16; o > 0; o >>= 1) c = max(c, __shfl_xor_sync(kFull, c, o));
      if (threadIdx.x == 0) carry = c;
    }
    __syncthreads();
    before = max(before, carry);
    for (int w = 0; w < (threadIdx.x >> 5); ++w) before = max(before, wtot[w]);
#pragma unroll
    for (int u = 0; u < kSlotsPer; ++u) {
      const int i = static_cast<int>(i0) + u;
      const int seg = i & ~(hold - 1);
      const int last = max(before, hs[u]);
      hs[u] = last >= seg ? last
                          : ((i & (hold - 1)) == hold - 1 ? seg : -1);
    }
  }
  if (!active) return;
  const long long base = i0 & ~static_cast<long long>(m - 1);
  int v[P][kSlotsPer];
#pragma unroll
  for (int u = 0; u < kSlotsPer; ++u) {
    const long long from = hs[u] < 0 ? -1 : base + __ldg(perm + hs[u]);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      v[p][u] = from < 0 ? 0 : __ldg(src + p * plane_words + from);
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    int4* o = reinterpret_cast<int4*>(out + p * plane_words + i0);
#pragma unroll
    for (int q = 0; q < kSlotsPer / 4; ++q) {
      o[q] = make_int4(v[p][4 * q], v[p][4 * q + 1], v[p][4 * q + 2],
                       v[p][4 * q + 3]);
    }
  }
}

int log2i(long long v) {
  int l = 0;
  while ((1LL << l) < v) ++l;
  return l;
}

// Blocks of route_all that fit the card at once for tile 2^lt (the
// cooperative launch's grid), per device and tile, from the occupancy
// calculator.
int route_grid(int lt, int* grid) {
  static int cache[64][kMaxTileLog + 1] = {{0}};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (cache[dev][lt] == 0) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, route_all, (1 << lt) / kR,
        static_cast<size_t>(1 << lt) * sizeof(int));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    cache[dev][lt] = per_sm * sm_count();
  }
  *grid = cache[dev][lt];
  return 0;
}

// log2 of the tile for a call: a wider tile needs fewer passes (a high
// pass and a tile pass, each behind a grid barrier, for each merge wider
// than the tile), a narrower one spreads the replay over more SMs.  The
// widest tile where its tiles fill half the SMs, else 2^11: the best or
// within 7 % of the best (2^12 on some of the narrower networks) on every
// shape python -m mh_spgemm_torch.bench.tune_proute times on the H100.
int tile_log(int n, long long slots) {
  const int wide = n < kMaxTileLog ? n : kMaxTileLog;
  if ((slots >> wide) * 2 >= sm_count()) return wide;
  return n < 11 ? n : 11;
}

}  // namespace

extern "C" {

// tab_p: plane p's first word, its word stride and its length (planes
// past nplanes are ignored); wblk int32[nblocks], rowsel and lane
// int32[nblocks * 1024] (lane 16-byte aligned); out int32[nplanes,
// plane_words] (16-byte aligned).  pair: -1, or p when planes p and p + 1
// are the two words of one f64 array (both of stride 2, the second one
// word past the first, the first 8-byte aligned, the same length).
int pgather(const int* tab0, long long stride0, long long n0,
            const int* tab1, long long stride1, long long n1,
            const int* tab2, long long stride2, long long n2, int nplanes,
            int pair, const int* wblk, const int* rowsel, const int* lane,
            long long nblocks, int* out, long long plane_words,
            void* stream) {
  if (nplanes < 1 || nplanes > 3 || nblocks < 0 ||
      plane_words < nblocks * 1024 || plane_words % 4 != 0 ||
      reinterpret_cast<uintptr_t>(lane) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || pair < -1 ||
      pair > nplanes - 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nblocks == 0) return static_cast<int>(cudaSuccess);
  Planes planes = {{tab0, tab1, tab2}, {stride0, stride1, stride2},
                   {n0, n1, n2}};
  if (pair >= 0) {
    const int* lo = planes.tab[pair];
    if (planes.tab[pair + 1] != lo + 1 || planes.stride[pair] != 2 ||
        planes.stride[pair + 1] != 2 ||
        planes.n[pair] != planes.n[pair + 1] ||
        reinterpret_cast<uintptr_t>(lo) % 8 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nplanes * 4 + pair + 1) {
    case 4:
      return launch_gather<1, -1>(planes, wblk, rowsel, lane, out,
                                  plane_words, nblocks, st);
    case 8:
      return launch_gather<2, -1>(planes, wblk, rowsel, lane, out,
                                  plane_words, nblocks, st);
    case 9:
      return launch_gather<2, 0>(planes, wblk, rowsel, lane, out,
                                 plane_words, nblocks, st);
    case 12:
      return launch_gather<3, -1>(planes, wblk, rowsel, lane, out,
                                  plane_words, nblocks, st);
    case 13:
      return launch_gather<3, 0>(planes, wblk, rowsel, lane, out,
                                 plane_words, nblocks, st);
    default:
      return launch_gather<3, 1>(planes, wblk, rowsel, lane, out,
                                 plane_words, nblocks, st);
  }
}

// log2 of the tile proute's replay takes for networks of 2^n words over
// `slots` slots in all (tile_log).
int proute_tile_log(int n, long long slots) { return tile_log(n, slots); }

// Words of scratch proute needs for this shape: the source index of
// every slot, two words of grid barrier, then (hold_w2 > 4096) the last
// flagged slot of each 4096-slot tile.
long long proute_scratch_words(int nplanes, int batch, int m, int hold_w2) {
  (void)nplanes;
  const long long slots = static_cast<long long>(batch) * m;
  return slots + 2 + (hold_w2 > kGatherTile
                          ? (slots + kGatherTile - 1) / kGatherTile : 0);
}

int proute_tiled(const int* src, long long src_plane_words, int* out,
                 int* scratch, long long plane_words, int nplanes,
                 const int* masks, const int* flags, int batch, int m,
                 int nstages, int hold_w2, int lt, void* stream);

// src and out int32[nplanes, batch * m] with the given plane strides (the
// same for both, a multiple of 4 words; out 16-byte aligned), scratch as
// proute_scratch_words says, masks int32[batch, nwords, m], flags
// int32[batch, m] (null when hold_w2 <= 1; 16-byte aligned).  The replay
// takes the tile tile_log picks.
int proute(const int* src, long long src_plane_words, int* out,
           int* scratch, long long plane_words, int nplanes,
           const int* masks, const int* flags, int batch, int m,
           int nstages, int hold_w2, void* stream) {
  const int lt = m >= 1024 && (m & (m - 1)) == 0 && batch > 0
                     ? tile_log(log2i(m), static_cast<long long>(batch) * m)
                     : 10;
  return proute_tiled(src, src_plane_words, out, scratch, plane_words,
                      nplanes, masks, flags, batch, m, nstages, hold_w2, lt,
                      stream);
}

// proute with the replay's tile forced to 2^lt words (10 <= lt <=
// min(log2 m, 13)), for python -m mh_spgemm_torch.bench.tune_proute.
int proute_tiled(const int* src, long long src_plane_words, int* out,
                 int* scratch, long long plane_words, int nplanes,
                 const int* masks, const int* flags, int batch, int m,
                 int nstages, int hold_w2, int lt, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nplanes < 1 || nplanes > 3 || batch < 0 || m < 1024 ||
      (m & (m - 1)) != 0 || src_plane_words != plane_words ||
      plane_words < static_cast<long long>(batch) * m ||
      plane_words % 4 != 0 || hold_w2 < 1 ||
      (hold_w2 & (hold_w2 - 1)) != 0 || hold_w2 > m ||
      (hold_w2 > 1 && (flags == nullptr ||
                       reinterpret_cast<uintptr_t>(flags) % 16 != 0)) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      static_cast<long long>(batch) * m > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = log2i(m);
  if (n * (n + 1) / 2 != nstages || lt < 10 || lt > n || lt > kMaxTileLog) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return static_cast<int>(cudaSuccess);
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int nwords = (nstages + 31) / 32;
  const unsigned* mk = reinterpret_cast<const unsigned*>(masks);
  const long long slots = static_cast<long long>(batch) * m;
  int* perm = scratch;
  unsigned* bar = reinterpret_cast<unsigned*>(scratch + slots);
  int grid = 0;
  int rc = route_grid(lt, &grid);
  if (rc != 0) return rc;
  const long long ntiles = slots >> lt;
  if (grid > ntiles) grid = static_cast<int>(ntiles);
  rc = static_cast<int>(cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned), st));
  if (rc != 0) return rc;
  // the kernel's arguments, by address
  int* fused = hold_w2 > 1 ? nullptr : out;
  int a_n = n, a_nwords = nwords, a_lt = lt;
  long long a_slots = slots;
  void* args[] = {&perm, &mk, &bar, &m, &a_n, &a_nwords, &a_lt, &a_slots,
                  &src, &fused, &plane_words, &nplanes};
  rc = static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(route_all), dim3(grid),
      dim3((1 << lt) / kR), args, static_cast<size_t>(1 << lt) * sizeof(int),
      st));
  if (rc != 0 || fused != nullptr) return rc;
  int* tile_last = scratch + slots + 2;
  const unsigned gblocks =
      static_cast<unsigned>((slots + kGatherTile - 1) / kGatherTile);
  if (hold_w2 > kGatherTile) {
    hold_tile_last<<<gblocks, 256, 0, st>>>(flags, tile_last, slots);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  const int* fl = hold_w2 > 1 ? flags : nullptr;
  switch (nplanes) {
    case 1:
      route_gather<1><<<gblocks, 256, 0, st>>>(src, out, plane_words, perm,
                                               fl, tile_last, m, hold_w2,
                                               slots);
      break;
    case 2:
      route_gather<2><<<gblocks, 256, 0, st>>>(src, out, plane_words, perm,
                                               fl, tile_last, m, hold_w2,
                                               slots);
      break;
    default:
      route_gather<3><<<gblocks, 256, 0, st>>>(src, out, plane_words, perm,
                                               fl, tile_last, m, hold_w2,
                                               slots);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
