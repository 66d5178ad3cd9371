// fused_write: the F2 write engine on Hopper.
//
// Replaces the Pallas TPU kernel `fused_write` (`_fused_write_kernel`) of
// src/repro/kernels/f2_probe/f2_probe.py: per-key linearization of a mutate
// batch (representative lane, last Upsert/Delete, RMW sums) -> locate walk
// with read-cache skip -> in-place vs RCU classification at the read-only
// address, RC invalidation -> intra-batch chaining of appends that share a
// hash slot (predecessor, last-of-slot publish, exclusive-prefix-sum append
// offsets).  It emits the 19-field write plan, bit for bit as
// ref.fused_write_body.
//
// What bounds it: the function needs O(B) work: each lane's key and value
// row read once, one walk per distinct key (dependent random 4-byte gathers
// into the hot log ring, each costing a 32-byte sector, as in fused_probe),
// and the plan written once.  At B = 8192 that is under 1 MB, a
// microsecond of HBM time, so what is left is latency: the walk's dependent
// loads and a handful of launches.
//
// What the design does about it: the TPU ran the batch as one grid step
// with B x B masks in VMEM; scanning all B lanes from every lane is B^2
// work on the card.  Here grouping is O(B) and no lane repeats another's
// work:
//   1. write_clear_kernel zeroes the two tables and the value rows;
//   2. write_group_kernel: each write lane's key goes into an open-addressing
//      hash table of >= 2B entries (atomicCAS on a tagged 64-bit word; the
//      table hash is independent of the slot hash, so keys that share an
//      index slot spread).  Lanes of one warp with the same key are merged
//      first (__match_any_sync), and the leader records the group's first
//      lane, last set and last RMW with integer atomicMax, so the result
//      does not depend on the order the atomics land in;
//   3. write_sum_kernel: each RMW lane after its group's last set adds its V
//      words into the representative's output row with 32-bit atomicAdd
//      (exact modulo 2^32, order-free); a warp loads its rows at once,
//      spreads the V words over its threads and sums its lanes of one group
//      first, so a hot key costs one atomic per word per warp, not per lane;
//   4. write_plan_kernel: one thread per lane; representatives walk their
//      chain and finish their value row (eight words in flight at a time),
//      classify in place vs append, and every lane writes its fields
//      (64-thread blocks spread the walks over the SMs);
//   5. write_chain_kernel (one block): each plan block numbered its appends
//      by ballot; a scan of the blocks' counts gives every append its
//      offset, in lane order.  The plan kernel also counted the appends of
//      each index slot in a second table (with the first lane): an append
//      alone on its slot has no predecessor and publishes; of two, the
//      second follows the first; the appends of slots with three or more
//      are sorted by (slot, offset) with a bitonic sort in shared memory (in
//      global memory beyond 16384 of them), so each one's predecessor on
//      its slot and its last-of-slot flag are its neighbours.  Keys drawn
//      from a large index rarely put three appends on one slot, so the sort
//      is short; keys chosen to collide cost a sort of those keys.
// B is not capped.  RMW sums are uint32 so they wrap like the reference's
// int32 sums (signed overflow is undefined in C++).
//
// The shard axis: a stacked store of S shards (lanes [S, B], columns
// [S, C], index [S, E], bounds [S, 4]) is planned by the same five launches,
// each with grid.y = S: every CTA offsets its pointers to its shard's slices
// and its shard's scratch (tables and lane scratch, `layout(B).words` int32
// words a shard), and the chain kernel runs one CTA per shard.  Shards never
// share a table, so each shard's plan is the one-store plan of its slices.
#include <cuda_runtime.h>

#include "f2_common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kLaneThreads = 256;     // clear, group and sum kernels
constexpr int kPlanThreads = 64;      // the walk: 2 warps per block, many SMs
constexpr int kChainThreads = 1024;   // the one block of the chain kernel
constexpr int kSortShared = 16384;    // appends sorted in shared memory (128 KB)

__device__ __forceinline__ bool is_write(int op) {
  return op == f2::kOpUpsert || op == f2::kOpRmw || op == f2::kOpDelete;
}

// The per-key group table.  key[h] holds (1 << 32 | key) once taken, 0 when
// free.  Per entry, each an integer maximum so the result is order-free:
// rep = B - (first lane), set = last Upsert/Delete lane + 1, rmw = last RMW
// lane + 1 (0: none).
struct Table {
  unsigned long long* key;
  int* rep;
  int* set;
  int* rmw;
  int mask;

  // the table of the shard whose scratch starts w int32 words in (w even)
  __device__ __forceinline__ Table at(int64_t w) const {
    return Table{key + w / 2, rep + w, set + w, rmw + w, mask};
  }
};

// The appends per index slot: key[h] holds slot + 1 once taken, 0 when
// free; cnt counts them, first = B - (first lane).
struct SlotTable {
  int* key;
  int* cnt;
  int* first;
  int mask;

  __device__ __forceinline__ SlotTable at(int64_t w) const {
    return SlotTable{key + w, cnt + w, first + w, mask};
  }
};

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
  int* gid;       // scratch [B]: a write lane's table entry
  int* gid2;      // scratch [B]: an append's slot-table entry
  int* eff_prev;  // scratch [B]
  int* lane_of;   // scratch [B]: append offset -> lane (sorted appends)
  int* local_off; // scratch [B]: an append's offset within its plan block
  int* block_cnt; // scratch [plan blocks]: appends per plan block
  int* block_off; // scratch [plan blocks]: offset of a plan block's first

  // the plan of the shard whose lanes start at sb (its value rows at sb * V)
  // and whose scratch starts w int32 words in
  __device__ __forceinline__ Plan at(int64_t sb, int V, int64_t w) const {
    return Plan{rep + sb, rep_pos + sb, val_nocold + sb * V, final_tomb + sb,
                need_cold + sb, created_nocold + sb, found + sb, addr + sb,
                in_place + sb, append + sb, new_addrs + sb, prevs + sb, slots + sb,
                publish + sb, heads + sb, rc_inval + sb, hops + sb, ios + sb,
                exhausted + sb, gid + w, gid2 + w, eff_prev + w, lane_of + w,
                local_off + w, block_cnt + w, block_off + w};
  }
};

// a second mixer, independent of f2::mix32 (the index slot hash)
__device__ __forceinline__ uint32_t table_hash(int key) {
  uint32_t x = static_cast<uint32_t>(key);
  x ^= x >> 16;
  x *= 0x21F0AAADu;
  x ^= x >> 15;
  x *= 0x735A2D97u;
  x ^= x >> 15;
  return x;
}

// The entry of `key`, inserting it if absent (linear probing; the table
// holds at least twice as many entries as lanes, so a free one exists).
// A stale read of 0 only leads to the CAS, which reads the truth.
__device__ __forceinline__ int table_insert(unsigned long long* tab, int mask, int key) {
  const unsigned long long want = (1ull << 32) | static_cast<uint32_t>(key);
  int h = static_cast<int>(table_hash(key) & static_cast<uint32_t>(mask));
  while (true) {
    unsigned long long cur = tab[h];
    if (cur == 0ull) {
      cur = atomicCAS(&tab[h], 0ull, want);
      if (cur == 0ull) return h;
    }
    if (cur == want) return h;
    h = (h + 1) & mask;
  }
}

__device__ __forceinline__ int slot_insert(const SlotTable& st, int slot) {
  const int want = slot + 1;
  int h = static_cast<int>(table_hash(slot) & static_cast<uint32_t>(st.mask));
  while (true) {
    int cur = st.key[h];
    if (cur == 0) {
      cur = atomicCAS(&st.key[h], 0, want);
      if (cur == 0) return h;
    }
    if (cur == want) return h;
    h = (h + 1) & st.mask;
  }
}

// 1. zero the tables and the value rows (the RMW sums accumulate there);
//    a shard's tables start `words` into the scratch after the previous one's
__global__ void write_clear_kernel(int* __restrict__ tab, int n_tab, int64_t words,
                                   int* __restrict__ val_nocold, int n_val) {
  tab += blockIdx.y * words;
  val_nocold += static_cast<int64_t>(blockIdx.y) * n_val;
  const int stride = gridDim.x * blockDim.x;
  for (int x = blockIdx.x * blockDim.x + threadIdx.x; x < n_tab; x += stride) tab[x] = 0;
  for (int x = blockIdx.x * blockDim.x + threadIdx.x; x < n_val; x += stride)
    val_nocold[x] = 0;
}

// 2. group the write lanes by key
__global__ void write_group_kernel(const int* __restrict__ keys,
                                   const int* __restrict__ ops, int B, int64_t words,
                                   Table tb, int* __restrict__ gid) {
  const int64_t sb = static_cast<int64_t>(blockIdx.y) * B;
  keys += sb;
  ops += sb;
  tb = tb.at(blockIdx.y * words);
  gid += blockIdx.y * words;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int op = i < B ? ops[i] : 0;
  const bool wm = i < B && is_write(op);
  const unsigned act = __ballot_sync(kFull, wm);
  if (!wm) return;
  const int key = keys[i];
  const unsigned peers = __match_any_sync(act, key);
  const unsigned sets = __ballot_sync(act, op != f2::kOpRmw) & peers;
  const unsigned rmws = __ballot_sync(act, op == f2::kOpRmw) & peers;
  const int leader = __ffs(peers) - 1;
  const int base = i - lane;
  int g = 0;
  if (lane == leader) {
    g = table_insert(tb.key, tb.mask, key);
    atomicMax(&tb.rep[g], B - (base + leader));
    if (sets) atomicMax(&tb.set[g], base + 32 - __clz(sets));  // highest lane + 1
    if (rmws) atomicMax(&tb.rmw[g], base + 32 - __clz(rmws));
  }
  gid[i] = __shfl_sync(act, g, leader);
}

// 3. RMW sums: the RMW lanes after their group's last set, into the
//    representative's row
__global__ void write_sum_kernel(const int* __restrict__ ops,
                                 const int* __restrict__ vals, int B, int V,
                                 int64_t words, Table tb, const int* __restrict__ gid,
                                 uint32_t* __restrict__ acc) {
  const int64_t sb = static_cast<int64_t>(blockIdx.y) * B;
  ops += sb;
  vals += sb * V;
  acc += sb * V;
  tb = tb.at(blockIdx.y * words);
  gid += blockIdx.y * words;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  bool contrib = false;
  int tgt = 0;
  if (i < B && ops[i] == f2::kOpRmw) {
    const int g = gid[i];
    contrib = i >= tb.set[g];      // set holds the last set's lane + 1
    tgt = B - tb.rep[g];
  }
  const unsigned all = __ballot_sync(kFull, contrib);
  const int base = i - lane;
  for (int v0 = 0; v0 < V && all; v0 += 32) {
    const int v = v0 + lane;
    // word v of every contributing row of the warp, all loads in flight at once
    uint32_t x[32];
#pragma unroll
    for (int l = 0; l < 32; ++l)
      x[l] = ((all >> l) & 1u) && v < V
                 ? static_cast<uint32_t>(vals[static_cast<int64_t>(base + l) * V + v])
                 : 0u;
    for (unsigned todo = all; todo;) {
      const int t = __shfl_sync(kFull, tgt, __ffs(todo) - 1);
      const unsigned peers = __ballot_sync(kFull, contrib && tgt == t);
      uint32_t sum = 0u;
#pragma unroll
      for (int l = 0; l < 32; ++l) sum += ((peers >> l) & 1u) ? x[l] : 0u;
      if (v < V) atomicAdd(acc + static_cast<int64_t>(t) * V + v, sum);
      todo &= ~peers;
    }
  }
}

// 4. per lane: locate, value, classify (one thread per lane); each block
//    also numbers its appends (the chain kernel adds the blocks' prefix)
__global__ void __launch_bounds__(kPlanThreads)
    write_plan_kernel(const int* __restrict__ keys, const int* __restrict__ ops,
                      const int* __restrict__ vals, const int* __restrict__ index,
                      const int* __restrict__ bounds, f2::Columns cs, int B, int E,
                      int chain_max, int64_t words, Table tb, SlotTable st, Plan p) {
  __shared__ int s_cnt[kPlanThreads / 32];
  // this CTA's shard: lanes [S, B], index [S, E], bounds [S, 4], columns
  // [S, C], and its own tables and scratch
  const int64_t sb = static_cast<int64_t>(blockIdx.y) * B;
  const int64_t w = blockIdx.y * words;
  const f2::Columns c = cs.shard(blockIdx.y);
  keys += sb;
  ops += sb;
  vals += sb * c.V;
  index += static_cast<int64_t>(blockIdx.y) * E;
  bounds += 4 * blockIdx.y;
  tb = tb.at(w);
  st = st.at(w);
  p = p.at(sb, c.V, w);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool append = false;
  if (i < B) {
    const int key = keys[i];
    const bool wm = is_write(ops[i]);
    const int V = c.V;
    int rep_pos = -1, last_set = -1;
    bool rmw_any = false;
    if (wm) {
      const int g = p.gid[i];
      rep_pos = B - tb.rep[g];
      last_set = tb.set[g] - 1;
      rmw_any = tb.rmw[g] - 1 > last_set;   // an RMW after the last set
    }
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

    // base value for pure-RMW groups; only the representative's row is
    // written (the others stay zero): its RMW sum plus the last set's value
    // (an Upsert's) or the hot base (a pure-RMW group's)
    const bool pure_rmw = rep && !has_set && rmw_any;
    const bool base_hot = pure_rmw && w.found && !found_tomb;
    const bool need_cold = pure_rmw && !w.found;
    const bool created = pure_rmw && !base_hot;
    if (rep) {
      uint32_t* acc = reinterpret_cast<uint32_t*>(p.val_nocold) + static_cast<int64_t>(i) * V;
      const int* add = has_set && !set_is_del ? vals + static_cast<int64_t>(last_set) * V
                       : base_hot             ? fval
                                              : nullptr;
      for (int v0 = 0; v0 < V; v0 += 8) {   // loads of 8 words in flight at once
        uint32_t a[8], b[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          if (v0 + m < V) {
            a[m] = acc[v0 + m];
            b[m] = add != nullptr ? static_cast<uint32_t>(add[v0 + m]) : 0u;
          }
        }
#pragma unroll
        for (int m = 0; m < 8; ++m)
          if (v0 + m < V) acc[v0 + m] = a[m] + b[m];
      }
    }

    // in-place (mutable region) vs RCU append; skip + detach an RC head
    const bool in_place = rep && found_mut;
    append = rep && !in_place;
    const bool head_rc = f2::is_rc(head);
    const int r = f2::rc_slot(head, c.R);
    const int rc_k = c.rc_key[r];
    const int rc_p = c.rc_prev[r];

    p.rep[i] = rep;
    p.rep_pos[i] = rep_pos;
    p.final_tomb[i] = rep && has_set && set_is_del && !rmw_any;
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
    if (append) {   // the chain kernel writes the appends' three fields
      const int h = slot_insert(st, slot);
      atomicAdd(&st.cnt[h], 1);
      atomicMax(&st.first[h], B - i);
      p.gid2[i] = h;
    } else {
      p.new_addrs[i] = f2::kNullAddr;
      p.prevs[i] = f2::kNullAddr;
      p.publish[i] = 0;
    }
  }
  // the block's appends, numbered in lane order
  const unsigned bal = __ballot_sync(kFull, append);
  if (lane == 0) s_cnt[warp] = __popc(bal);
  __syncthreads();
  int before = __popc(bal & ((1u << lane) - 1));
  for (int x = 0; x < warp; ++x) before += s_cnt[x];
  if (append) p.local_off[i] = before;
  if (threadIdx.x == 0) {
    int n = 0;
    for (int x = 0; x < kPlanThreads / 32; ++x) n += s_cnt[x];
    p.block_cnt[blockIdx.x] = n;
  }
}

// exclusive scan of one int per thread over a block of kChainThreads
__device__ __forceinline__ int block_exclusive_scan(int x, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int wsum = s_warp[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, wsum, d);
      if (lane >= d) wsum += y;
    }
    s_warp[lane] = wsum;  // inclusive scan of the warp totals
  }
  __syncthreads();
  *total = s_warp[kChainThreads / 32 - 1];
  const int ex = (warp > 0 ? s_warp[warp - 1] : 0) + incl - x;
  __syncthreads();      // s_warp may be reused
  return ex;
}

// ascending bitonic sort of keys[0, N), N a power of two, by the whole
// block; each thread loads all its pairs of a stage before it compares and
// stores any, so their loads overlap
__device__ __forceinline__ void bitonic_sort(unsigned long long* keys, int N) {
  constexpr int kPairs = 4;
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q0 = 0; q0 < N / 2; q0 += kPairs * kChainThreads) {
        unsigned long long x[kPairs], y[kPairs];
#pragma unroll
        for (int m = 0; m < kPairs; ++m) {
          const int q = q0 + m * kChainThreads + threadIdx.x;
          if (q < N / 2) {
            const int a = ((q & ~(j - 1)) << 1) | (q & (j - 1));
            x[m] = keys[a];
            y[m] = keys[a | j];
          }
        }
#pragma unroll
        for (int m = 0; m < kPairs; ++m) {
          const int q = q0 + m * kChainThreads + threadIdx.x;
          if (q < N / 2) {
            const int a = ((q & ~(j - 1)) << 1) | (q & (j - 1));
            if ((x[m] > y[m]) == ((a & k) == 0)) {
              keys[a] = y[m];
              keys[a | j] = x[m];
            }
          }
        }
        __syncthreads();
      }
    }
  }
}

// 5. append offsets, then chain the appends that share a slot (one block)
//    (one CTA per shard)
__global__ void __launch_bounds__(kChainThreads)
    write_chain_kernel(const int* __restrict__ bounds, int B, int V, int nblk,
                       int64_t words, Plan p, SlotTable st,
                       unsigned long long* gkeys) {
  extern __shared__ unsigned long long s_keys[];
  __shared__ int s_warp[kChainThreads / 32];
  __shared__ int s_nsort;
  const int64_t w = blockIdx.y * words;
  bounds += 4 * blockIdx.y;
  p = p.at(static_cast<int64_t>(blockIdx.y) * B, V, w);
  st = st.at(w);
  if (gkeys != nullptr) gkeys += w / 2;
  const int t = threadIdx.x;
  const uint32_t tail = static_cast<uint32_t>(bounds[3]);
  // the plan blocks' first offsets
  int carry = 0;
  for (int b0 = 0; b0 < nblk; b0 += kChainThreads) {
    const int b = b0 + t;
    int tot;
    const int ex = block_exclusive_scan(b < nblk ? p.block_cnt[b] : 0, s_warp, &tot);
    if (b < nblk) p.block_off[b] = carry + ex;
    carry += tot;
  }
  if (t == 0) s_nsort = 0;
  __syncthreads();
  auto offset = [&](int i) { return p.block_off[i / kPlanThreads] + p.local_off[i]; };
  // an append alone on its slot publishes with no predecessor; of two, the
  // later one follows the earlier; three or more go to the sort
  unsigned long long* keys = gkeys != nullptr ? gkeys : s_keys;
  const int lane = t & 31;
  constexpr int K = 4;   // lanes per thread whose loads are in flight together
  for (int i0 = 0; i0 < B; i0 += K * kChainThreads) {
    int off[K], h[K], n[K], first[K];
    bool app[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = i0 + k * kChainThreads + t;
      app[k] = i < B && p.append[i];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = i0 + k * kChainThreads + t;
      if (app[k]) {
        off[k] = offset(i);
        h[k] = p.gid2[i];
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (app[k]) {
        n[k] = st.cnt[h[k]];
        first[k] = B - st.first[h[k]];
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = i0 + k * kChainThreads + t;
      bool to_sort = false;
      if (app[k]) {
        p.new_addrs[i] = static_cast<int>(tail + static_cast<uint32_t>(off[k]));
        if (n[k] <= 2) {
          const bool second = n[k] == 2 && i != first[k];
          p.prevs[i] = second ? static_cast<int>(tail + static_cast<uint32_t>(offset(first[k])))
                              : p.eff_prev[i];
          p.publish[i] = n[k] == 1 || second;
        } else {
          to_sort = true;
        }
      }
      // places in the sort, one shared atomic per warp
      const unsigned m = __ballot_sync(kFull, to_sort);
      int q0 = 0;
      if (lane == 0 && m) q0 = atomicAdd(&s_nsort, __popc(m));
      q0 = __shfl_sync(kFull, q0, 0);
      if (to_sort) {
        keys[q0 + __popc(m & ((1u << lane) - 1))] =
            (static_cast<unsigned long long>(static_cast<uint32_t>(p.slots[i])) << 32) |
            static_cast<uint32_t>(off[k]);
        p.lane_of[off[k]] = i;
      }
    }
  }
  __syncthreads();
  const int n_sort = s_nsort;
  int N = 1;
  while (N < n_sort) N <<= 1;
  for (int q = n_sort + t; q < N; q += kChainThreads) keys[q] = ~0ull;  // sorts last
  __syncthreads();
  if (gkeys != nullptr)
    bitonic_sort(gkeys, N);
  else
    bitonic_sort(s_keys, N);
  // sorted by (slot, offset): the predecessor and whether a later append follows
  for (int q = t; q < n_sort; q += kChainThreads) {
    const unsigned long long x = keys[q];
    const uint32_t slot = static_cast<uint32_t>(x >> 32);
    const uint32_t off = static_cast<uint32_t>(x);
    const int i = p.lane_of[off];
    const bool has_pred = q > 0 && static_cast<uint32_t>(keys[q - 1] >> 32) == slot;
    const bool later = q + 1 < n_sort && static_cast<uint32_t>(keys[q + 1] >> 32) == slot;
    p.prevs[i] = has_pred ? static_cast<int>(tail + static_cast<uint32_t>(keys[q - 1]))
                          : p.eff_prev[i];
    p.publish[i] = !later;
  }
}

int pow2_at_least(int n) {
  int x = 1;
  while (x < n) x <<= 1;
  return x;
}

struct Layout {
  int tab;      // entries of each table
  int nblk;     // plan kernel blocks
  int64_t tab_words, gid, gid2, eff_prev, lane_of, local_off, block_cnt, block_off, gkeys,
      words;
  bool sort_in_global;
};

Layout layout(int B) {
  Layout l;
  l.tab = pow2_at_least(2 * (B > 32 ? B : 32));
  l.nblk = (B + kPlanThreads - 1) / kPlanThreads;
  l.tab_words = 8ll * l.tab;   // key (2 words), rep, set, rmw; slot key, cnt, first
  l.gid = l.tab_words;
  l.gid2 = l.gid + B;
  l.eff_prev = l.gid2 + B;
  l.lane_of = l.eff_prev + B;
  l.local_off = l.lane_of + B;
  l.block_cnt = l.local_off + B;
  l.block_off = l.block_cnt + l.nblk;
  l.gkeys = (l.block_off + l.nblk + 1) & ~1ll;  // 8-byte aligned
  const int np = pow2_at_least(B);
  l.sort_in_global = np > kSortShared;
  l.words = l.gkeys + (l.sort_in_global ? 2ll * np : 0);
  l.words = (l.words + 1) & ~1ll;   // even: the next shard's 64-bit table aligns
  return l;
}

}  // namespace

// int32 words of scratch that f2_fused_write needs per shard at batch size B
extern "C" long long f2_fused_write_scratch_words(int B) {
  return B <= 0 ? 0 : layout(B).words;
}

extern "C" int f2_fused_write(
    const int* keys, const int* ops, const int* vals, const int* index,
    const int* bounds, const int* log_key, const int* log_val,
    const int* log_prev, const int* log_meta, const int* rc_key,
    const int* rc_val, const int* rc_prev, const int* rc_meta, int S, int B,
    int E, int C, int R, int V, int chain_max, unsigned char* rep, int* rep_pos,
    int* val_nocold, unsigned char* final_tomb, unsigned char* need_cold,
    unsigned char* created_nocold, unsigned char* found, int* addr,
    unsigned char* in_place, unsigned char* append, int* new_addrs,
    int* prevs, int* slots, unsigned char* publish, int* heads,
    unsigned char* rc_inval, int* hops, int* ios, unsigned char* exhausted,
    int* scratch, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (S > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      write_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSortShared * static_cast<int>(sizeof(unsigned long long)));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(B);
  f2::Columns c{log_key, log_val, log_prev, log_meta,
                rc_key, rc_val, rc_prev, rc_meta, C, R, V};
  Table tb{reinterpret_cast<unsigned long long*>(scratch), scratch + 2ll * l.tab,
           scratch + 3ll * l.tab, scratch + 4ll * l.tab, l.tab - 1};
  SlotTable st{scratch + 5ll * l.tab, scratch + 6ll * l.tab, scratch + 7ll * l.tab,
               l.tab - 1};
  Plan p{rep, rep_pos, val_nocold, final_tomb, need_cold, created_nocold,
         found, addr, in_place, append, new_addrs, prevs, slots, publish,
         heads, rc_inval, hops, ios, exhausted, scratch + l.gid, scratch + l.gid2,
         scratch + l.eff_prev, scratch + l.lane_of, scratch + l.local_off,
         scratch + l.block_cnt, scratch + l.block_off};
  const int n_val = B * V;
  const int n_clear = static_cast<int>(l.tab_words > n_val ? l.tab_words : n_val);
  const int clear_blocks = n_clear / kLaneThreads < 1024 ? n_clear / kLaneThreads + 1 : 1024;
  const dim3 lane_blocks((B + kLaneThreads - 1) / kLaneThreads, S);
  write_clear_kernel<<<dim3(clear_blocks, S), kLaneThreads, 0, s>>>(
      scratch, static_cast<int>(l.tab_words), l.words, val_nocold, n_val);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  write_group_kernel<<<lane_blocks, kLaneThreads, 0, s>>>(keys, ops, B, l.words, tb,
                                                          p.gid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  write_sum_kernel<<<lane_blocks, kLaneThreads, 0, s>>>(
      ops, vals, B, V, l.words, tb, p.gid, reinterpret_cast<uint32_t*>(val_nocold));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  write_plan_kernel<<<dim3(l.nblk, S), kPlanThreads, 0, s>>>(
      keys, ops, vals, index, bounds, c, B, E, chain_max, l.words, tb, st, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = l.sort_in_global
                          ? 0
                          : static_cast<size_t>(pow2_at_least(B)) * sizeof(unsigned long long);
  write_chain_kernel<<<dim3(1, S), kChainThreads, smem, s>>>(
      bounds, B, V, l.nblk, l.words, p, st,
      l.sort_in_global ? reinterpret_cast<unsigned long long*>(scratch + l.gkeys) : nullptr);
  return static_cast<int>(cudaGetLastError());
}
