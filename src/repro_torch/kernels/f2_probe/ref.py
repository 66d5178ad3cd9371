"""Plain PyTorch versions of the three F2 kernels.

  * `probe_reference` — the legacy first hop: slot hash -> index gather ->
    RC-flag decode (the chain head untagged, and whether it was tagged).
  * `fused_probe_body` — the read engine: slot hash -> index gather (or
    caller-given heads) -> bounded chain walk with a per-lane lower bound,
    resolving log or read-cache records by the RC_FLAG tag and skipping
    META_INVALID -> value/meta at the hit.  The optional `target` input is
    the zero-I/O liveness fast path of lookup-based compaction: a lane whose
    chain head already equals its target resolves at hop 0.
  * `fused_write_body` — the write engine: per-key linearization (last-set
    selection + RMW accumulation, with B x B group masks) -> locate walk
    with RC skip -> in-place vs RCU classification -> intra-batch slot
    chaining -> the append / index-publish plan.

These are what the CUDA kernels (`csrc/`) are held against, bit for bit, and
what `ops.py` runs for tensors on the CPU.  The module is standalone: it
re-declares the address/meta/op constants (probe_engine checks them).

Each takes a leading shard axis: lanes [S, B], columns [S, N, ...],
per-shard scalars [S] (S stores resolved in one call, as the kernels do in
one launch), or one store's tensors without it.  `fused_write_body` runs
its one-store pass per shard.
"""
from __future__ import annotations

import torch

RC_FLAG = 1 << 30
NULL_ADDR = -1
META_INVALID = 2
META_TOMBSTONE = 1
OP_UPSERT = 2
OP_RMW = 3
OP_DELETE = 4

_BIG = 2**30
_M32 = 0xFFFFFFFF


def _mulmod32(x, c):
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(x):
    """murmur3 finalizer; uint32 result as int64 in [0, 2**32)."""
    x = x.to(torch.int64) & _M32
    x = x ^ (x >> 16)
    x = _mulmod32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mulmod32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _is_rc(a):
    return (a >= 0) & ((a & RC_FLAG) != 0)


def _lift(single, fn, *args, **kw):
    """fn on one store's tensors given without the shard axis: each tensor
    argument gains a leading axis of 1, each tensor result loses it."""
    if not single:
        return fn(*args, **kw)

    def up(x):
        return x.unsqueeze(0) if isinstance(x, torch.Tensor) else x
    out = fn(*map(up, args), **{k: up(v) for k, v in kw.items()})
    return tuple(o.squeeze(0) for o in out)


def probe_reference(keys, index_addr):
    """keys [S, B], index_addr [S, E] (E a power of two) int32 -> (addr
    [S, B] int32 untagged chain heads, is_rc [S, B] int32); or [B], [E]."""
    slot = _mix(keys) & (index_addr.shape[-1] - 1)
    entry = torch.gather(index_addr, -1, slot)
    is_rc = _is_rc(entry).to(torch.int32)
    untagged = torch.where(entry >= 0, entry & ~RC_FLAG, entry)
    return untagged, is_rc


def _in_range(cur, lower):
    return torch.where(_is_rc(cur), cur != NULL_ADDR,
                       (cur != NULL_ADDR) & (cur >= lower))


def fused_probe_body(keys, heads_src, lower, active, head_boundary,
                     log_key, log_val, log_prev, log_meta,
                     rc_key, rc_val, rc_prev, rc_meta, *,
                     chain_max: int, rc_match: bool = True,
                     has_rc: bool = True, probe_index: bool = True,
                     target=None, early_exit: bool = False):
    """Returns (found, addr, heads, value, meta, hops, ios, exhausted).

    keys/lower/target int32 [S, B], active bool [S, B]; heads_src is the
    int32 [S, E] hot index (probe_index) or int32 [S, B] chain heads;
    head_boundary int32 [S].  found/exhausted are bool [S, B]; addr is
    RC-tagged for a replica hit; value [S, B, V] / meta [S, B] are 0 where
    not found; hops/ios are per-lane record touches / stable-tier touches.
    One store's tensors without the shard axis give results without it.

    `early_exit` stops the loop once no lane can still progress: bit-exact,
    since every skipped iteration is a no-op for every lane."""
    return _lift(keys.ndim == 1, _fused_probe, keys, heads_src, lower, active,
                 head_boundary, log_key, log_val, log_prev, log_meta, rc_key,
                 rc_val, rc_prev, rc_meta, chain_max=chain_max,
                 rc_match=rc_match, has_rc=has_rc, probe_index=probe_index,
                 target=target, early_exit=early_exit)


def _fused_probe(keys, heads_src, lower, active, head_boundary,
                 log_key, log_val, log_prev, log_meta,
                 rc_key, rc_val, rc_prev, rc_meta, *,
                 chain_max, rc_match, has_rc, probe_index, target, early_exit):
    S, B = keys.shape
    C = log_key.shape[-1]
    R = rc_key.shape[-1]
    dev = keys.device
    rows = torch.arange(S, device=dev)[:, None]
    head_boundary = head_boundary.reshape(S, 1)
    if probe_index:
        slot = (_mix(keys) & (heads_src.shape[-1] - 1)).to(torch.int32)
        heads = heads_src[rows, slot]
    else:
        heads = heads_src.clone()
    if target is not None:
        fast = active & (heads == target)
    else:
        fast = torch.zeros((S, B), dtype=torch.bool, device=dev)

    cur = heads.clone()
    done = fast
    faddr = torch.where(fast, heads, NULL_ADDR).to(torch.int32)
    hops = torch.zeros((S, B), dtype=torch.int32, device=dev)
    ios = torch.zeros((S, B), dtype=torch.int32, device=dev)
    for _ in range(chain_max):
        cur_is_rc = _is_rc(cur)
        live = active & ~done & _in_range(cur, lower)
        if early_exit and not bool(live.any()):
            break
        log_addr = torch.where(cur_is_rc, NULL_ADDR, cur)
        log_idx = log_addr.clamp_min(0) & (C - 1)
        k = log_key[rows, log_idx]
        p = log_prev[rows, log_idx]
        m = log_meta[rows, log_idx]
        if has_rc:
            rc_idx = (cur & ~RC_FLAG).clamp_min(0) & (R - 1)
            k = torch.where(cur_is_rc, rc_key[rows, rc_idx], k)
            p = torch.where(cur_is_rc, rc_prev[rows, rc_idx], p)
            m = torch.where(cur_is_rc, rc_meta[rows, rc_idx], m)
        valid = (m & META_INVALID) == 0
        key_match = live & valid & (k == keys)
        if not rc_match:
            key_match = key_match & ~cur_is_rc
        is_io = live & ~cur_is_rc & (cur < head_boundary)
        ios = ios + is_io.to(torch.int32)
        hops = hops + live.to(torch.int32)
        faddr = torch.where(key_match, cur, faddr)
        done = done | key_match
        nxt = torch.where(live & ~key_match, p, cur)
        cur = torch.where(done | ~live, cur, nxt)

    exhausted = active & ~done & _in_range(cur, lower)
    found = done & active

    # --- value/meta resolution at the hit address ---------------------------
    f_is_rc = _is_rc(faddr)
    log_idx = torch.where(f_is_rc, NULL_ADDR, faddr).clamp_min(0) & (C - 1)
    value = log_val[rows, log_idx]
    meta = log_meta[rows, log_idx]
    if has_rc:
        rc_idx = (faddr & ~RC_FLAG).clamp_min(0) & (R - 1)
        value = torch.where(f_is_rc[..., None], rc_val[rows, rc_idx], value)
        meta = torch.where(f_is_rc, rc_meta[rows, rc_idx], meta)
    value = torch.where(found[..., None], value, 0)
    meta = torch.where(found, meta, 0)
    return found, faddr, heads, value, meta, hops, ios, exhausted


def fused_write_body(keys, ops, vals, index, begin, head_boundary, ro_addr,
                     tail, log_key, log_val, log_prev, log_meta,
                     rc_key, rc_val, rc_prev, rc_meta, *,
                     chain_max: int, early_exit: bool = False):
    """One pass over a mutate batch; returns the 19-tuple write plan

        (rep, rep_pos, val_nocold, final_tomb, need_cold, created_nocold,
         found, addr, in_place, append, new_addrs, prevs, slots, publish,
         heads, rc_inval, hops, ios, exhausted)

    aligned with `core.write_engine.WritePlan` (masks bool, the rest
    int32).  Lanes [S, B], columns [S, N, ...], begin/head_boundary/
    ro_addr/tail int32 [S]; or one store's tensors without the shard axis
    (0-d bounds).  `val_nocold` is the final value assuming the cold log
    contributes nothing; `need_cold` lanes add their cold base outside this
    pass.  RMW sums are taken in int64 and wrap to int32 like the
    reference's.  Each shard runs the one-store pass on its slices."""
    args = (keys, ops, vals, index, begin, head_boundary, ro_addr, tail,
            log_key, log_val, log_prev, log_meta, rc_key, rc_val, rc_prev,
            rc_meta)
    if keys.ndim == 1:
        return _fused_write_one(*args, chain_max=chain_max,
                                early_exit=early_exit)
    per_shard = [_fused_write_one(*(a[s] for a in args), chain_max=chain_max,
                                  early_exit=early_exit)
                 for s in range(keys.shape[0])]
    return tuple(torch.stack(x) for x in zip(*per_shard))


def _fused_write_one(keys, ops, vals, index, begin, head_boundary, ro_addr,
                     tail, log_key, log_val, log_prev, log_meta,
                     rc_key, rc_val, rc_prev, rc_meta, *,
                     chain_max: int, early_exit: bool):
    """fused_write_body on one store's tensors (no shard axis)."""
    B = keys.shape[0]
    V = vals.shape[1]
    E = index.shape[0]
    R = rc_key.shape[0]
    dev = keys.device
    pos = torch.arange(B, dtype=torch.int32, device=dev)
    pi = pos[:, None]
    pj = pos[None, :]

    wmask = (ops == OP_UPSERT) | (ops == OP_RMW) | (ops == OP_DELETE)
    is_set = (ops == OP_UPSERT) | (ops == OP_DELETE)

    # --- per-key linearization (B x B group masks) --------------------------
    eqk = wmask[:, None] & wmask[None, :] & (keys[:, None] == keys[None, :])
    rep_pos = torch.where(eqk, pj, _BIG).amin(dim=1).to(torch.int32)
    rep_pos = torch.where(wmask, rep_pos, -1)
    rep = wmask & (rep_pos == pos)
    last_set = torch.where(eqk & is_set[None, :], pj, -1).amax(dim=1)
    last_set = torch.where(wmask, last_set, -1).to(torch.int32)
    has_set = last_set >= 0
    ls = last_set.clamp_min(0)
    set_val = torch.where(has_set[:, None], vals[ls], 0)
    set_is_del = has_set & (ops[ls] == OP_DELETE)
    rmw_after = wmask & (ops == OP_RMW) & (pos > last_set)
    contrib = eqk & rmw_after[None, :]
    rmw_sum = torch.stack(
        [torch.where(contrib, vals[:, v][None, :], 0).sum(dim=1, dtype=torch.int64)
         for v in range(V)], dim=1).to(torch.int32)
    rmw_cnt = contrib.sum(dim=1, dtype=torch.int32)

    # --- locate the most recent *log* record (RC skip) ----------------------
    lower = begin.expand(B)
    found, faddr, heads, fval, fmeta, hops, ios, exhausted = fused_probe_body(
        keys, index, lower, rep, head_boundary,
        log_key, log_val, log_prev, log_meta,
        rc_key, rc_val, rc_prev, rc_meta,
        chain_max=chain_max, rc_match=False, has_rc=True, probe_index=True,
        early_exit=early_exit)
    found_tomb = found & ((fmeta & META_TOMBSTONE) != 0)
    found_mut = found & (faddr >= ro_addr)

    # --- base value for pure-RMW groups -------------------------------------
    pure_rmw = rep & ~has_set & (rmw_cnt > 0)
    base_hot = pure_rmw & found & ~found_tomb
    need_cold = pure_rmw & ~found          # hot tombstone => absent, skip cold
    created_nocold = pure_rmw & ~base_hot

    base = torch.where(base_hot[:, None], fval, 0)
    val_nocold = torch.where(
        (has_set & ~set_is_del)[:, None], set_val + rmw_sum,
        torch.where((has_set & set_is_del & (rmw_cnt > 0))[:, None],
                    rmw_sum, base + rmw_sum))
    val_nocold = torch.where(rep[:, None], val_nocold, 0).to(torch.int32)
    final_tomb = rep & has_set & set_is_del & (rmw_cnt == 0)

    # --- in-place (mutable region) vs RCU append ----------------------------
    in_place = rep & found_mut
    append = rep & ~in_place

    # effective chain head: skip + detach an RC head
    head_is_rc = _is_rc(heads)
    rc_idx = (heads & ~RC_FLAG).clamp_min(0) & (R - 1)
    rc_k = rc_key[rc_idx]
    rc_p = rc_prev[rc_idx]
    eff_prev = torch.where(head_is_rc, rc_p, heads)
    rc_inval = (append & head_is_rc) | (in_place & head_is_rc & (rc_k == keys))

    # --- intra-batch chaining by hash slot ----------------------------------
    slots = (_mix(keys) & (E - 1)).to(torch.int32)
    eqs = append[:, None] & append[None, :] & (slots[:, None] == slots[None, :])
    pred = torch.where(eqs & (pj < pi), pj, -1).amax(dim=1).to(torch.int32)
    is_last = append & ~torch.any(eqs & (pj > pi), dim=1)
    a32 = append.to(torch.int32)
    offs = torch.cumsum(a32, 0).to(torch.int32) - a32
    new_addrs = torch.where(append, tail + offs, NULL_ADDR).to(torch.int32)
    pred_addr = torch.where(pred >= 0, new_addrs[pred.clamp_min(0)], 0)
    prevs = torch.where(append, torch.where(pred >= 0, pred_addr, eff_prev),
                        NULL_ADDR).to(torch.int32)

    return (rep, rep_pos, val_nocold, final_tomb, need_cold, created_nocold,
            found, faddr, in_place, append, new_addrs, prevs, slots,
            is_last, heads, rc_inval, hops, ios, exhausted)
