// Halo exchange for Hopper (sm_90a): the all_to_all of the ragged B fetch
// over every shard of a mesh, or into a subset of its shards, in one
// launch.
//
// Replaces the TPU kernel mh_spgemm_tpu/ops/remote_fetch.py:67
// halo_exchange (body _exchange_kernel, :36).  What it computes: with D
// shards, each sending an int32 [D, vr, 128] tensor whose block d is its
// payload for shard d, and each receiving one of the same shape,
//
//   recv[dst][src] = send[src][dst]    for every src < D and every dst in
//                                      [dst_first, dst_first + dst_count),
//
// a shard's own block included (the TPU kernel's local copy, :42).  With
// (dst_first, dst_count) = (0, D) it equals lax.all_to_all(send, axis, 0,
// 0); a process of a multi-process mesh passes the range of the shards it
// owns and pulls only their blocks.
//
// Bound on the card: bytes.  Every word is read once and written once, 8
// bytes a word, with no arithmetic.  The TPU kernel needed DMA semaphores
// and a double buffer to keep one remote copy in flight while the last
// drained; a CUDA grid needs neither, since every (src, dst) block is an
// independent copy.  Design: blockIdx.y picks the (dst, src) pair, with
// dst = dst_first + blockIdx.y / D; the x blocks stride over the pair's
// 16-byte vectors, and neighbouring threads copy neighbouring vectors, so
// each warp moves 512 contiguous bytes a step.  The D send and dst_count
// receive pointers travel in a by-value kernel parameter (1 KB at the
// most, D <= 64), so a call copies nothing from the host.  Shards on
// several cards of one process are reached through peer pointers (the
// caller enables peer access first); the send tensors of other processes
// through CUDA IPC pointers, which on the same card need no peer access.
//
// Plain C interface for ctypes.  The function launches on the given
// stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxShards = 64;
constexpr int kThreads = 256;
constexpr int kMaxTiles = 1024;       // x blocks per (dst, src) pair

struct Ptrs {
  const int4* send[kMaxShards];       // by source shard
  int4* recv[kMaxShards];             // by dst - dst_first
};

__global__ void __launch_bounds__(kThreads)
exchange(const Ptrs p, int D, int dst_first, long long block_vecs) {
  const int pair = blockIdx.y;
  const int slot = pair / D;
  const int src = pair - slot * D;
  const int dst = dst_first + slot;
  const int4* __restrict__ from = p.send[src] + dst * block_vecs;
  int4* __restrict__ to = p.recv[slot] + src * block_vecs;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < block_vecs; i += step) {
    to[i] = from[i];
  }
}

}  // namespace

extern "C" {

// sends: a host array of D device pointers, recvs one of dst_count (the
// receive tensors of shards dst_first ...), each to an int32
// [D, block_words] tensor, 16-byte aligned; block_words a multiple of 4;
// 0 <= dst_first and dst_first + dst_count <= D.
int halo_exchange(void* const* sends, void* const* recvs, int D,
                  long long block_words, int dst_first, int dst_count,
                  void* stream) {
  if (D < 1 || D > kMaxShards || block_words < 0 || block_words % 4 != 0 ||
      dst_first < 0 || dst_count < 1 || dst_first + dst_count > D) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long block_vecs = block_words / 4;
  if (block_vecs == 0) return static_cast<int>(cudaSuccess);
  Ptrs p;
  for (int d = 0; d < D; ++d) {
    p.send[d] = static_cast<const int4*>(sends[d]);
  }
  for (int d = 0; d < dst_count; ++d) {
    p.recv[d] = static_cast<int4*>(recvs[d]);
  }
  long long tiles = (block_vecs + kThreads - 1) / kThreads;
  if (tiles > kMaxTiles) tiles = kMaxTiles;
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(dst_count * D));
  exchange<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, D, dst_first, block_vecs);
  return static_cast<int>(cudaGetLastError());
}

// Lets the current device read and write ``peer``'s memory; peer access
// that is already on is no error.
int halo_enable_peer(int peer) {
  const cudaError_t rc = cudaDeviceEnablePeerAccess(peer, 0);
  if (rc == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    return static_cast<int>(cudaSuccess);
  }
  return static_cast<int>(rc);
}

}  // extern "C"
