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
// bound by HBM latency and sectors moved, not by operations.
//
// What the design does about it: one thread per lane, so the card keeps as
// many independent chains in flight as the batch has lanes; each thread
// stops as soon as its lane resolves (skewed batches resolve in a few hops),
// and the columns stay in HBM at any store size (no VMEM budget).  The
// ragged edge of the batch is masked in the kernel, so there is no padding.
#include <cuda_runtime.h>

#include "f2_common.cuh"

namespace {

__global__ void fused_probe_kernel(
    const int* __restrict__ keys, const int* __restrict__ heads_src,
    const int* __restrict__ lower, const unsigned char* __restrict__ active,
    const int* __restrict__ target, const int* __restrict__ head_boundary,
    f2::Columns c, int B, int E, int chain_max, int rc_match, int has_rc,
    int probe_index, int has_target, unsigned char* __restrict__ found_out,
    int* __restrict__ addr_out, int* __restrict__ heads_out,
    int* __restrict__ val_out, int* __restrict__ meta_out,
    int* __restrict__ hops_out, int* __restrict__ ios_out,
    unsigned char* __restrict__ exh_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int key = keys[i];
  const int head = probe_index ? heads_src[f2::mix32(key) & (E - 1)] : heads_src[i];
  const bool act = active[i] != 0;
  const bool fast = has_target && act && head == target[i];
  const f2::WalkOut w = f2::walk_lane(key, head, lower[i], act, fast,
                                      head_boundary[0], c, chain_max,
                                      rc_match != 0, has_rc != 0);
  int meta = 0;
  int* vrow = val_out + static_cast<int64_t>(i) * c.V;
  if (w.found) {
    const int* src = f2::hit_record(w.addr, has_rc != 0, c, &meta);
    for (int v = 0; v < c.V; ++v) vrow[v] = src[v];
  } else {
    for (int v = 0; v < c.V; ++v) vrow[v] = 0;
  }
  found_out[i] = w.found;
  addr_out[i] = w.addr;
  heads_out[i] = head;
  meta_out[i] = meta;
  hops_out[i] = w.hops;
  ios_out[i] = w.ios;
  exh_out[i] = w.exhausted;
}

}  // namespace

extern "C" int f2_fused_probe(
    const int* keys, const int* heads_src, const int* lower,
    const unsigned char* active, const int* target, const int* head_boundary,
    const int* log_key, const int* log_val, const int* log_prev,
    const int* log_meta, const int* rc_key, const int* rc_val,
    const int* rc_prev, const int* rc_meta, int B, int E, int C, int R, int V,
    int chain_max, int rc_match, int has_rc, int probe_index, int has_target,
    unsigned char* found, int* addr, int* heads, int* value, int* meta,
    int* hops, int* ios, unsigned char* exhausted, void* stream) {
  if (B <= 0) return 0;
  f2::Columns c{log_key, log_val, log_prev, log_meta,
                rc_key, rc_val, rc_prev, rc_meta, C, R, V};
  constexpr int kThreads = 256;
  const int blocks = (B + kThreads - 1) / kThreads;
  fused_probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, heads_src, lower, active, target, head_boundary, c, B, E,
      chain_max, rc_match, has_rc, probe_index, has_target, found, addr,
      heads, value, meta, hops, ios, exhausted);
  return static_cast<int>(cudaGetLastError());
}
