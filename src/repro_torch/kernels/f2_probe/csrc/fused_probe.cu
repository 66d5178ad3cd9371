// fused_probe: the F2 read engine on Hopper.
//
// Replaces the Pallas TPU kernel `fused_probe` (`_fused_kernel`) of
// src/repro/kernels/f2_probe/f2_probe.py: slot hash -> hot-index gather (or
// caller-given chain heads) -> bounded prev-chain walk with a per-lane lower
// bound, resolving log or read-cache records by the RC_FLAG tag and skipping
// META_INVALID records -> optional `target` zero-I/O liveness fast path ->
// value/meta at the hit.
//
// What bounds it: every hop is a dependent random 4-byte gather (key, prev,
// meta of one record) into a ring of up to millions of records, and each
// costs a whole 32-byte sector.  Arithmetic is negligible, so the kernel is
// bound by HBM latency and sectors moved, not by operations: a call lasts as
// long as its longest chain (absent keys walk theirs to the end).
//
// What the design does about it:
//   * one thread per lane, so the card keeps as many independent chains in
//     flight as the batch has lanes; each thread stops as soon as its lane
//     resolves, and the columns stay in HBM at any store size;
//   * CTAs as small as lets the batch reach every SM (32 to 256 threads,
//     from the SM count), so the chains' loads spread over every SM's
//     load units instead of a quarter of them (B 8192: 128 CTAs of 64);
//   * a hop's key, prev and meta loads go out together on the read-only
//     path (f2::walk_lane), and the hit's meta comes from the hop that
//     found it, so only the value row is loaded after the walk;
//   * value rows are copied by warp: each lane posts its hit row's address
//     (or none) in shared memory, then the warp copies its 32 rows into its
//     contiguous [32, V] block of the output, consecutive lanes on
//     consecutive words (coalesced loads within a row, coalesced stores),
//     all 32 rows' loads in flight at once.
// The ragged edge of the batch is masked in the kernel, so there is no
// padding.
//
// The shard axis: a stacked store of S shards ([S, B] lanes, [S, C] columns,
// one head boundary a shard) resolves in one launch, grid.y = S, each CTA
// offsetting its pointers to its shard's slices.  Lanes of one warp always
// belong to one shard, so the value copy stays within a shard's rows.  The
// CTA size is chosen from all S * B lanes, so the grid fills the card as one
// batch of that size would (the reference runs one vmapped Pallas call over
// the shard axis).
#include <cuda_runtime.h>

#include "f2_common.cuh"

namespace {

constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads) fused_probe_walk_kernel(
    const int* __restrict__ keys, const int* __restrict__ heads_src,
    const int* __restrict__ lower, const unsigned char* __restrict__ active,
    const int* __restrict__ target, const int* __restrict__ head_boundary,
    f2::Columns cs, int B, int E, int chain_max, int rc_match, int has_rc,
    int probe_index, int has_target, unsigned char* __restrict__ found_out,
    int* __restrict__ addr_out, int* __restrict__ heads_out,
    int* __restrict__ val_out, int* __restrict__ meta_out,
    int* __restrict__ hops_out, int* __restrict__ ios_out,
    unsigned char* __restrict__ exh_out) {
  __shared__ const int* hit_row[kMaxThreads];
  // this CTA's shard: every lane input and output is [S, B], the index
  // [S, E], the caller's chain heads [S, B]
  const int s = blockIdx.y;
  const int64_t sb = static_cast<int64_t>(s) * B;
  keys += sb;
  heads_src += probe_index ? static_cast<int64_t>(s) * E : sb;
  lower += sb;
  active += sb;
  if (has_target) target += sb;
  head_boundary += s;
  const f2::Columns c = cs.shard(s);
  found_out += sb;
  addr_out += sb;
  heads_out += sb;
  val_out += sb * c.V;
  meta_out += sb;
  hops_out += sb;
  ios_out += sb;
  exh_out += sb;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;   // lane within the shard
  const int* row = nullptr;
  if (i < B) {
    const int key = keys[i];
    const int head = probe_index ? __ldg(heads_src + (f2::mix32(key) & (E - 1)))
                                 : heads_src[i];
    const bool act = active[i] != 0;
    const bool fast = has_target && act && head == target[i];
    const f2::WalkOut w = f2::walk_lane(key, head, lower[i], act, fast,
                                        head_boundary[0], c, chain_max,
                                        rc_match != 0, has_rc != 0);
    int meta = 0;
    if (w.found) {
      row = f2::hit_record(w.addr, has_rc != 0, c, fast ? &meta : nullptr);
      if (!fast) meta = w.meta;
    }
    found_out[i] = w.found;
    addr_out[i] = w.addr;
    heads_out[i] = head;
    meta_out[i] = meta;
    hops_out[i] = w.hops;
    ios_out[i] = w.ios;
    exh_out[i] = w.exhausted;
  }
  hit_row[threadIdx.x] = row;
  __syncwarp();
  // the warp's rows [row0, row0 + n) of value, as one [n, V] block: lane c
  // copies column c of all n rows, their loads in flight together
  const int row0 = i - lane;
  const int n = min(32, B - row0);
  const int* const* rows = hit_row + (threadIdx.x - lane);
  int* dst = val_out + static_cast<int64_t>(row0) * c.V;
  for (int col = lane; col < c.V; col += 32) {
    int x[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int* src = j < n ? rows[j] : nullptr;
      x[j] = src ? __ldg(src + col) : 0;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (j < n) dst[j * c.V + col] = x[j];
  }
}

// the current device's SM count, asked once per device
int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int n = 0;
    cached[dev] = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) ==
                              cudaSuccess && n > 0 ? n : 132;
  }
  return cached[dev];
}

// threads per CTA: the fewest warps (up to 8) with which B lanes fill every SM
int threads_for(int B) {
  const int sms = sm_count();
  const int warps = (B + 32 * sms - 1) / (32 * sms);
  return 32 * (warps < 1 ? 1 : warps > kMaxThreads / 32 ? kMaxThreads / 32 : warps);
}

}  // namespace

extern "C" int f2_fused_probe(
    const int* keys, const int* heads_src, const int* lower,
    const unsigned char* active, const int* target, const int* head_boundary,
    const int* log_key, const int* log_val, const int* log_prev,
    const int* log_meta, const int* rc_key, const int* rc_val,
    const int* rc_prev, const int* rc_meta, int S, int B, int E, int C, int R,
    int V, int chain_max, int rc_match, int has_rc, int probe_index,
    int has_target, unsigned char* found, int* addr, int* heads, int* value,
    int* meta, int* hops, int* ios, unsigned char* exhausted, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (S > 65535) return static_cast<int>(cudaErrorInvalidValue);
  f2::Columns c{log_key, log_val, log_prev, log_meta,
                rc_key, rc_val, rc_prev, rc_meta, C, R, V};
  const int threads = threads_for(S * B);
  const dim3 blocks((B + threads - 1) / threads, S);
  fused_probe_walk_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, heads_src, lower, active, target, head_boundary, c, B, E,
      chain_max, rc_match, has_rc, probe_index, has_target, found, addr,
      heads, value, meta, hops, ios, exhausted);
  return static_cast<int>(cudaGetLastError());
}
