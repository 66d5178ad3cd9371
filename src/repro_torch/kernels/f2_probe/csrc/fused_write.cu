// fused_write: the F2 write engine on Hopper.
//
// Replaces the Pallas TPU kernel `fused_write` (`_fused_write_kernel`) of
// src/repro/kernels/f2_probe/f2_probe.py: per-key linearization of a mutate
// batch (representative lane, last Upsert/Delete, RMW sums and counts) ->
// locate walk with read-cache skip -> in-place vs RCU classification at the
// read-only address, RC invalidation -> intra-batch chaining of appends that
// share a hash slot (predecessor, last-of-slot publish, exclusive-prefix-sum
// append offsets).  It emits the 19-field write plan.
//
// What bounds it: the locate walk is dependent random 4-byte gathers into
// the hot log ring, each costing a 32-byte sector, so HBM latency and
// sectors bound it, as in fused_probe; the all-pairs key and slot compares
// are B^2 cheap integer operations that stay in shared memory.
//
// What the design does about it: the TPU ran the batch as one grid step
// with B x B masks in VMEM.  Blocks on the card run in no order, so the
// cross-lane dependences are split over three launches and the masks are
// never materialised:
//   1. one thread per lane scans all B lanes through shared-memory tiles of
//      (key, op) for its rep, last set and RMW sum, then walks its chain;
//   2. one block computes the exclusive prefix sum of the append flags;
//   3. one thread per lane scans all B lanes through shared-memory tiles of
//      (slot, append) for its predecessor and last-of-slot flag.
// B is not capped.  RMW sums are uint32 so they wrap like the reference's
// int32 sums (signed overflow is undefined in C++).
#include <cuda_runtime.h>

#include "f2_common.cuh"

namespace {

constexpr int kTile = 128;      // lanes per block and per shared-memory tile
constexpr int kScanThreads = 1024;

__device__ __forceinline__ bool is_write(int op) {
  return op == f2::kOpUpsert || op == f2::kOpRmw || op == f2::kOpDelete;
}

struct Plan {
  unsigned char* rep;
  int* rep_pos;
  int* val_nocold;
  unsigned char* final_tomb;
  unsigned char* need_cold;
  unsigned char* created_nocold;
  unsigned char* found;
  int* addr;
  unsigned char* in_place;
  unsigned char* append;
  int* new_addrs;
  int* prevs;
  int* slots;
  unsigned char* publish;
  int* heads;
  unsigned char* rc_inval;
  int* hops;
  int* ios;
  unsigned char* exhausted;
  int* eff_prev;  // scratch [B]
  int* offs;      // scratch [B]
};

// pass 1: linearize, locate, classify (one thread per lane)
__global__ void write_lanes_kernel(const int* __restrict__ keys,
                                   const int* __restrict__ ops,
                                   const int* __restrict__ vals,
                                   const int* __restrict__ index,
                                   const int* __restrict__ bounds,
                                   f2::Columns c, int B, int E, int chain_max,
                                   Plan p) {
  __shared__ int s_key[kTile];
  __shared__ int s_op[kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane = i < B;
  const int key = lane ? keys[i] : 0;
  const int op = lane ? ops[i] : 0;
  const bool wm = lane && is_write(op);
  const int V = c.V;
  // the RMW sums accumulate in this lane's own output row
  uint32_t* acc = reinterpret_cast<uint32_t*>(p.val_nocold) + static_cast<int64_t>(i) * V;
  if (lane)
    for (int v = 0; v < V; ++v) acc[v] = 0u;

  int rep_pos = -1, last_set = -1, rmw_cnt = 0;
  for (int base = 0; base < B; base += kTile) {
    const int j = base + threadIdx.x;
    s_key[threadIdx.x] = j < B ? keys[j] : 0;
    s_op[threadIdx.x] = j < B ? ops[j] : 0;
    __syncthreads();
    if (wm) {
      const int n = min(kTile, B - base);
      for (int t = 0; t < n; ++t) {
        const int oj = s_op[t];
        if (s_key[t] != key || !is_write(oj)) continue;
        const int jj = base + t;
        if (rep_pos < 0) rep_pos = jj;
        if (oj == f2::kOpRmw) {
          // RMWs after the group's last set; a later set restarts the sum
          ++rmw_cnt;
          const int* vr = vals + static_cast<int64_t>(jj) * V;
          for (int v = 0; v < V; ++v) acc[v] += static_cast<uint32_t>(vr[v]);
        } else {
          last_set = jj;
          rmw_cnt = 0;
          for (int v = 0; v < V; ++v) acc[v] = 0u;
        }
      }
    }
    __syncthreads();
  }
  if (!lane) return;

  const bool rep = wm && rep_pos == i;
  const bool has_set = last_set >= 0;
  const bool set_is_del = has_set && ops[last_set] == f2::kOpDelete;

  // locate the most recent *log* record (RC replicas skipped)
  const int begin = bounds[0], hb = bounds[1], ro = bounds[2];
  const int slot = static_cast<int>(f2::mix32(key) & static_cast<uint32_t>(E - 1));
  const int head = index[slot];
  const f2::WalkOut w = f2::walk_lane(key, head, begin, rep, false, hb, c,
                                      chain_max, false, true);
  int fmeta = 0;
  const int* fval = nullptr;
  if (w.found) fval = f2::hit_record(w.addr, true, c, &fmeta);
  const bool found_tomb = w.found && (fmeta & f2::kMetaTombstone) != 0;
  const bool found_mut = w.found && w.addr >= ro;

  // base value for pure-RMW groups
  const bool pure_rmw = rep && !has_set && rmw_cnt > 0;
  const bool base_hot = pure_rmw && w.found && !found_tomb;
  const bool need_cold = pure_rmw && !w.found;
  const bool created = pure_rmw && !base_hot;
  const int* set_row = vals + static_cast<int64_t>(has_set ? last_set : 0) * V;
  for (int v = 0; v < V; ++v) {
    const uint32_t s = acc[v];
    uint32_t out;
    if (!rep)
      out = 0u;
    else if (has_set && !set_is_del)
      out = static_cast<uint32_t>(set_row[v]) + s;
    else if (has_set && rmw_cnt > 0)
      out = s;
    else
      out = (base_hot ? static_cast<uint32_t>(fval[v]) : 0u) + s;
    acc[v] = out;
  }

  // in-place (mutable region) vs RCU append; skip + detach an RC head
  const bool in_place = rep && found_mut;
  const bool append = rep && !in_place;
  const bool head_rc = f2::is_rc(head);
  const int r = f2::rc_slot(head, c.R);
  const int rc_k = c.rc_key[r];
  const int rc_p = c.rc_prev[r];

  p.rep[i] = rep;
  p.rep_pos[i] = wm ? rep_pos : -1;
  p.final_tomb[i] = rep && has_set && set_is_del && rmw_cnt == 0;
  p.need_cold[i] = need_cold;
  p.created_nocold[i] = created;
  p.found[i] = w.found;
  p.addr[i] = w.addr;
  p.in_place[i] = in_place;
  p.append[i] = append;
  p.slots[i] = slot;
  p.heads[i] = head;
  p.rc_inval[i] = (append && head_rc) || (in_place && head_rc && rc_k == key);
  p.hops[i] = w.hops;
  p.ios[i] = w.ios;
  p.exhausted[i] = w.exhausted;
  p.eff_prev[i] = head_rc ? rc_p : head;
}

// pass 2: exclusive prefix sum of the append flags (one block)
__global__ void append_offsets_kernel(const unsigned char* __restrict__ append,
                                      int B, int* __restrict__ offs) {
  __shared__ int s_warp[kScanThreads / 32];
  __shared__ int s_carry;
  const int t = threadIdx.x, lanei = t & 31, warp = t >> 5;
  if (t == 0) s_carry = 0;
  __syncthreads();
  for (int base = 0; base < B; base += kScanThreads) {
    const int i = base + t;
    const int a = (i < B && append[i]) ? 1 : 0;
    int x = a;  // inclusive warp scan
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
      if (lanei >= d) x += y;
    }
    if (lanei == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int wsum = lanei < kScanThreads / 32 ? s_warp[lanei] : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, wsum, d);
        if (lanei >= d) wsum += y;
      }
      s_warp[lanei] = wsum;  // inclusive scan of the warp totals
    }
    __syncthreads();
    const int before = (warp > 0 ? s_warp[warp - 1] : 0) + s_carry;
    if (i < B) offs[i] = before + x - a;
    __syncthreads();
    if (t == kScanThreads - 1) s_carry = before + x;
    __syncthreads();
  }
}

// pass 3: chain appends that share a hash slot (one thread per lane)
__global__ void chain_slots_kernel(const int* __restrict__ bounds, int B, Plan p) {
  __shared__ int s_slot[kTile];
  __shared__ unsigned char s_app[kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane = i < B;
  const bool app = lane && p.append[i];
  const int slot = lane ? p.slots[i] : 0;
  int pred = -1;
  bool later = false;
  for (int base = 0; base < B; base += kTile) {
    const int j = base + threadIdx.x;
    s_slot[threadIdx.x] = j < B ? p.slots[j] : 0;
    s_app[threadIdx.x] = j < B ? p.append[j] : 0;
    __syncthreads();
    if (app) {
      const int n = min(kTile, B - base);
      for (int t = 0; t < n; ++t) {
        if (!s_app[t] || s_slot[t] != slot) continue;
        const int jj = base + t;
        if (jj < i) pred = jj;
        else if (jj > i) later = true;
      }
    }
    __syncthreads();
  }
  if (!lane) return;
  const uint32_t tail = static_cast<uint32_t>(bounds[3]);
  if (app) {
    p.new_addrs[i] = static_cast<int>(tail + static_cast<uint32_t>(p.offs[i]));
    p.prevs[i] = pred >= 0 ? static_cast<int>(tail + static_cast<uint32_t>(p.offs[pred]))
                           : p.eff_prev[i];
  } else {
    p.new_addrs[i] = f2::kNullAddr;
    p.prevs[i] = f2::kNullAddr;
  }
  p.publish[i] = app && !later;
}

}  // namespace

extern "C" int f2_fused_write(
    const int* keys, const int* ops, const int* vals, const int* index,
    const int* bounds, const int* log_key, const int* log_val,
    const int* log_prev, const int* log_meta, const int* rc_key,
    const int* rc_val, const int* rc_prev, const int* rc_meta, int B, int E,
    int C, int R, int V, int chain_max, unsigned char* rep, int* rep_pos,
    int* val_nocold, unsigned char* final_tomb, unsigned char* need_cold,
    unsigned char* created_nocold, unsigned char* found, int* addr,
    unsigned char* in_place, unsigned char* append, int* new_addrs,
    int* prevs, int* slots, unsigned char* publish, int* heads,
    unsigned char* rc_inval, int* hops, int* ios, unsigned char* exhausted,
    int* scratch, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  f2::Columns c{log_key, log_val, log_prev, log_meta,
                rc_key, rc_val, rc_prev, rc_meta, C, R, V};
  Plan p{rep, rep_pos, val_nocold, final_tomb, need_cold, created_nocold,
         found, addr, in_place, append, new_addrs, prevs, slots, publish,
         heads, rc_inval, hops, ios, exhausted, scratch, scratch + B};
  const int blocks = (B + kTile - 1) / kTile;
  write_lanes_kernel<<<blocks, kTile, 0, s>>>(keys, ops, vals, index, bounds,
                                              c, B, E, chain_max, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  append_offsets_kernel<<<1, kScanThreads, 0, s>>>(append, B, p.offs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_slots_kernel<<<blocks, kTile, 0, s>>>(bounds, B, p);
  return static_cast<int>(cudaGetLastError());
}
