// Shared device code of the F2 probe and write kernels: the slot hash and
// the per-lane bounded chain walk.
//
// The walk is the body of both kernels.  One thread owns one lane and
// follows its `prev` chain through the hot (or cold) log ring and the read
// cache, stopping as soon as its lane is resolved or leaves the address
// range.  Stopping early is exact: once a lane is not live, every further
// step of the reference's fixed-trip loop leaves its state unchanged.
#pragma once

#include <cstdint>

namespace f2 {

constexpr int kNullAddr = -1;
constexpr int kRcFlag = 1 << 30;
constexpr int kMetaTombstone = 1;
constexpr int kMetaInvalid = 2;
constexpr int kOpUpsert = 2;
constexpr int kOpRmw = 3;
constexpr int kOpDelete = 4;

// murmur3-style finalizer; bit-identical to types.hash32
__device__ __forceinline__ uint32_t mix32(int key) {
  uint32_t x = static_cast<uint32_t>(key);
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ bool is_rc(int a) { return a >= 0 && (a & kRcFlag) != 0; }

__device__ __forceinline__ bool in_range(int cur, int lower) {
  return is_rc(cur) ? cur != kNullAddr : (cur != kNullAddr && cur >= lower);
}

// index into the log ring for a (possibly RC-tagged or NULL) address, as the
// reference computes it: RC lanes and negative addresses read slot 0
__device__ __forceinline__ int log_slot(int a, int C) {
  return is_rc(a) ? 0 : (a < 0 ? 0 : a) & (C - 1);
}

__device__ __forceinline__ int rc_slot(int a, int R) {
  int u = a & ~kRcFlag;
  return (u < 0 ? 0 : u) & (R - 1);
}

struct Columns {
  const int* log_key;
  const int* log_val;
  const int* log_prev;
  const int* log_meta;
  const int* rc_key;
  const int* rc_val;
  const int* rc_prev;
  const int* rc_meta;
  int C, R, V;

  // the columns of shard s of a stacked store: each column is [S, C] (the
  // values [S, C, V]), each read-cache column [S, R] ([S, R, V])
  __device__ __forceinline__ Columns shard(int s) const {
    const int64_t c = static_cast<int64_t>(s) * C, r = static_cast<int64_t>(s) * R;
    return Columns{log_key + c, log_val + c * V, log_prev + c, log_meta + c,
                   rc_key + r,  rc_val + r * V,  rc_prev + r, rc_meta + r,
                   C, R, V};
  }
};

struct WalkOut {
  bool found;
  bool exhausted;
  int addr;
  int hops;
  int ios;
  int meta;   // the hit record's meta where a hop found it (0 otherwise)
};

// Bounded walk of one lane from `head`, searching addresses >= lower.  Each
// hop issues its record's key, prev and meta loads together, on the
// read-only path (no kernel writes the columns it walks).
__device__ __forceinline__ WalkOut walk_lane(int key, int head, int lower,
                                             bool active, bool fast, int hb,
                                             const Columns& c, int chain_max,
                                             bool rc_match, bool has_rc) {
  int cur = head;
  bool done = fast;
  int faddr = fast ? head : kNullAddr;
  int hops = 0, ios = 0, fmeta = 0;
  for (int it = 0; it < chain_max; ++it) {
    if (!(active && !done && in_range(cur, lower))) break;
    const bool cur_rc = is_rc(cur);
    const bool in_rc = cur_rc && has_rc;
    const int x = in_rc ? rc_slot(cur, c.R) : log_slot(cur, c.C);
    const int k = __ldg((in_rc ? c.rc_key : c.log_key) + x);
    const int p = __ldg((in_rc ? c.rc_prev : c.log_prev) + x);
    const int m = __ldg((in_rc ? c.rc_meta : c.log_meta) + x);
    const bool match = (m & kMetaInvalid) == 0 && k == key && (rc_match || !cur_rc);
    ios += (!cur_rc && cur < hb) ? 1 : 0;
    hops += 1;
    if (match) {
      faddr = cur;
      fmeta = m;
      done = true;
    } else {
      cur = p;
    }
  }
  WalkOut o;
  o.found = done && active;
  o.exhausted = active && !done && in_range(cur, lower);
  o.addr = faddr;
  o.hops = hops;
  o.ios = ios;
  o.meta = fmeta;
  return o;
}

// value row of the record at a hit address, and its meta where `meta` is
// given
__device__ __forceinline__ const int* hit_record(int faddr, bool has_rc,
                                                 const Columns& c, int* meta) {
  if (is_rc(faddr) && has_rc) {
    const int r = rc_slot(faddr, c.R);
    if (meta) *meta = c.rc_meta[r];
    return c.rc_val + static_cast<int64_t>(r) * c.V;
  }
  const int l = log_slot(faddr, c.C);
  if (meta) *meta = c.log_meta[l];
  return c.log_val + static_cast<int64_t>(l) * c.V;
}

}  // namespace f2
