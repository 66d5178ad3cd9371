// probe: the legacy first-hop probe of the F2 read path on Hopper.
//
// Replaces the Pallas TPU kernel `probe` (`_probe_kernel`) of
// src/repro/kernels/f2_probe/f2_probe.py:46-90: slot hash -> hot-index
// gather -> RC-flag decode.  For each key it returns the chain head of the
// key's index slot with the read-cache tag cleared (NULL stays NULL) and
// whether the head was tagged.
//
// What bounds it: one random 4-byte gather into the index per lane, which
// costs a whole 32-byte sector, plus the keys read and two outputs written
// once; arithmetic is a few integer operations, so it is bound by bytes.
//
// What the design does about it: one thread per lane, so the gathers of a
// batch are all in flight at once; the TPU kernel tiled the index through
// VMEM (a (B tile, E tile) grid with a per-tile hit mask), which the card
// does not need: the index stays in HBM and each lane reads its one entry.
// The ragged edge of the batch is masked in the kernel.
//
// The shard axis: keys [S, B] against the indexes [S, E] of a stacked store
// resolve in one launch, grid.y = S (the reference vmaps the Pallas call over
// the shard axis).
#include <cuda_runtime.h>

#include "f2_common.cuh"

namespace {

__global__ void first_hop_probe_kernel(const int* __restrict__ keys,
                                       const int* __restrict__ index, int B, int E,
                                       int* __restrict__ addr, int* __restrict__ is_rc) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int64_t sb = static_cast<int64_t>(blockIdx.y) * B + b;
  const uint32_t slot = f2::mix32(keys[sb]) & static_cast<uint32_t>(E - 1);
  const int e = index[static_cast<int64_t>(blockIdx.y) * E + slot];
  is_rc[sb] = f2::is_rc(e) ? 1 : 0;
  addr[sb] = e >= 0 ? (e & ~f2::kRcFlag) : e;
}

}  // namespace

// keys [S, B], index [S, E] (E a power of two) int32 in; addr, is_rc [S, B]
// int32 out.  Returns 0 or a cudaError_t.
extern "C" int f2_probe(const int* keys, const int* index, int S, int B, int E,
                        int* addr, int* is_rc, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (E <= 0 || (E & (E - 1)) != 0 || S > 65535) return (int)cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  const dim3 grid((B + kThreads - 1) / kThreads, S);
  first_hop_probe_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, index, B, E, addr, is_rc);
  return (int)cudaGetLastError();
}
