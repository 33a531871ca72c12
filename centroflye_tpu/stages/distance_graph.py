"""Distance-graph recruitment of unique k-mers (the reference's 9h stage).

Reference behavior (distance_based_kmer_recruitment.py:85-149): for every
unit-distance d in [min_d, max_d] and every read, count ordered co-occurrences
of rare-k-mer pairs (i in cloud t, j in cloud t+d, i != j) into a sparse
(kmer x kmer x dist) structure of Python dicts — the 9h/800GB RAM blow-up.
filter_dist_tuples then keeps an edge (i, j, d) iff count >= min_coverage AND
that d carries >= rel_threshold (0.8) of all distance-counts for (i, j);
endpoint k-mers of surviving edges are the unique k-mers.

Device design: a pair observation is a single sortable key
    hi = i (k-mer index),  lo = (j << 8) | d     (j < 2^24, d < 2^8)
so the whole tensor is a sorted fixed-capacity (hi, lo) -> count table built
with ops/kmers.count_unique and merged associatively across key chunks and
across devices (the merge is a concat + 2-key resort + run compaction: exact,
deterministic, no hash collisions).

Pair generation is EXACT-RAGGED: clouds average far fewer k-mers than the
padded width (measured ~67 of K=245 at 400-unit scale — a dense
cloud x cloud broadcast wastes >90% of the sort volume on pad keys, and pad
keys cost exactly as much as real keys once they enter the sort; even an
8x32 tile outer product pays ~7x slack at production raggedness). The host
ships, per strip, one flat SUB-BUCKET LIST — each populated
(read, unit t, distance d) triple split along its smaller cloud side, so
a sub-bucket is (one smaller-side element, resolved to its k-mer value
ON HOST) x (the whole larger side) with a pair-count cumsum — and the
device enumerates the strip's pair-index range [0, total) in static-size
chunks: a scatter+cumsum of sub-bucket boundaries assigns each pair
index its sub-bucket and reconstructs the constant side's value; ONE
gather fetches the iterated side's code (no divmod, no second gather).
Every key entering a sort is a true pair observation; per-chunk host
traffic is two scalars. Chunks have ONE
static shape, so the whole sweep is a handful of compiles; the pair range
shards over the mesh data axis (parallel/mesh.make_pair_bucket_step)
with all_gather+fold merges across devices. The final filter is a segmented
reduction over (i, j) groups of the sorted table.

At production scale the distinct-key count exceeds any single on-device
table (measured >2^27 distinct at a 400-unit array with 62k rare k-mers —
a doubling accumulator OOMs HBM exactly like the reference's dicts OOM'd
800GB of RAM). The sweep therefore STRIPES the key space by i-range.
Strip membership is exact by construction: cloud rows are sorted, so a
strip's elements within a row form one contiguous segment (bounds read
off host value-threshold counts); A-tiles slice that segment, B-tiles
the full partner cloud, and no tile is emitted to more than one strip.
Every strip accumulates its own bounded table, and `recruit_unique_kmers`
filters each strip ON DEVICE — groups (i, j) never straddle a strip, so
the distance-consistency filter is strip-local and exact, and only the
surviving edges (a few MB) ever reach the host. Memory is O(strip), the
full table is never materialized, and strips are embarrassingly parallel
across chips.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from centroflye_tpu.config import KmerRecruitmentConfig
from centroflye_tpu.ops.kmers import (
    count_unique, merge_count_tables, SENTINEL,
)

_SENT = 0xFFFFFFFF
logger = logging.getLogger("centroflye_tpu")


class _StripOverflow(Exception):
    """A strip's distinct-key count exceeded max_capacity: the sweep
    splits the strip's i-range in half and retries (bounded device
    memory is a hard invariant — unbounded check-and-double can grow a
    table past device memory at production shape)."""


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(int(x), 1)))))


def _pairs_from_buckets_core(flat, starts, const_vals, base_iter, a_const,
                             dvals, c0, total, *, chunk: int,
                             capacity: int):
    """Count (i, j, d) keys for one chunk of the strip's flat pair range.

    EXACT ragged enumeration over SUB-BUCKETS: the host splits every
    (read, unit, distance) bucket along its SMALLER cloud side, so a
    sub-bucket is (one element of the smaller side) x (the whole larger
    side). Pair p in [c0, c0+chunk) belongs to sub-bucket e(p) = the one
    whose half-open range [starts[e], starts[e+1]) contains p; within
    it, y = p - starts[e] indexes the iterated (larger) side. The
    smaller side's k-mer value is resolved ON HOST (const_vals[e]) and
    reconstructed per pair by the same scatter-delta fill as every other
    per-bucket quantity — so the kernel performs ONE flat gather per
    pair (the iterated side) instead of two, and needs no divmod at all
    (the old formulation's f32 division). Every emitted key is a true
    pair observation (the only waste is the masked tail of the last
    chunk), unlike a tile outer product whose slack pays full sort cost
    per pad key (~7x of the volume at production cloud raggedness).

    Bucket assignment is scatter+cumsum, not searchsorted or per-pair
    table gathers: each per-sub-bucket value v[e(p)] is reconstructed by
    scattering the DELTAS v[i] - v[i-1] at the sub-bucket boundary
    positions and prefix-summing along the chunk — O(E + chunk) adds
    instead of chunk random gathers (measured ~0.7s per 33M-element
    gather on-chip vs ~0.05s per scatter+scan). Boundaries before the
    chunk clip to slot 0 (their deltas accumulate there), boundaries
    beyond it drop; empty sub-buckets' deltas land on one slot and
    collapse correctly. starts: (E+1,) int32 nondecreasing with
    starts[0] == 0, padded past the real sub-bucket count with `total`;
    const_vals: (E,) int32 k-mer index of the constant side; base_iter:
    (E,) int32 flat offset of the iterated side's cloud slice; a_const:
    (E,) int32 1 if the constant side is the A (i) side, else 0; dvals:
    (E,) int32 unit distances. c0/total are traced scalars — one compile
    serves every chunk and strip. Returns a sorted fixed-capacity
    (i, (j<<8)|d) -> count table (uhi, ulo, counts, n)."""
    p = jnp.arange(chunk, dtype=jnp.int32) + c0
    # inter-bucket boundaries only: bucket i (i >= 1) begins at starts[i];
    # starts[E] is the end of the range, not a boundary
    bpos = jnp.maximum(starts[1:-1] - c0, 0)

    # one multi-column scatter + one 2D cumsum instead of five
    # independent fills — packed to THREE columns (the scan cost is
    # linear in payload width): the gather index needs only
    # base_iter - start (plus p), and the 1-bit a_const rides with the
    # 8-bit distance in one int32 (values, not deltas, are packed, so
    # the delta-scatter + cumsum reconstructs each field exactly)
    vals3 = jnp.stack(
        [base_iter - starts[:-1], const_vals,
         (a_const << jnp.int32(8)) | dvals], axis=1)
    deltas3 = vals3[1:] - vals3[:-1]
    grid3 = jnp.zeros((chunk, 3), jnp.int32)
    grid3 = grid3.at[0].add(vals3[0])
    grid3 = grid3.at[bpos].add(deltas3, mode="drop")
    f3 = jnp.cumsum(grid3, axis=0)
    g = flat[jnp.maximum(f3[:, 0] + p, 0)]          # iterated side
    c = f3[:, 1]                                    # constant side
    fa = f3[:, 2] >> jnp.int32(8)
    a = jnp.where(fa == 1, c, g)
    b = jnp.where(fa == 1, g, c)
    dv = (f3[:, 2] & jnp.int32(0xFF)).astype(jnp.uint32)
    valid = (p < total) & (a != b)
    hi = jnp.where(valid, a.astype(jnp.uint32), jnp.uint32(_SENT))
    lo = jnp.where(
        valid, (b.astype(jnp.uint32) << jnp.uint32(8)) | dv,
        jnp.uint32(_SENT))
    return count_unique(hi, lo, capacity=capacity)


_pairs_from_buckets = jax.jit(
    _pairs_from_buckets_core, static_argnames=("chunk", "capacity"))


def _sorted_pairs_core(flat, starts, const_vals, base_iter, a_const,
                       dvals, total, *, chunk: int):
    """RAW-PAIR fast path: enumerate one whole strip's pairs (same
    sub-bucket machinery as _pairs_from_buckets_core with c0 = 0) and
    2-key sort them — NO count table, NO merge forest. When a strip
    fits one chunk (the production default: strips are sized under the
    chunk budget), per-key counts are simply RUN LENGTHS of the sorted
    stream, so the consumer's filter reads counts off nearest-boundary
    scans (_count_filter_sorted) and the whole count_unique +
    compaction + merge apparatus (two extra multi-array sorts per
    chunk plus table folds) disappears. Returns (hi, lo) sorted
    ascending, SENTINEL rows (invalid/pad) sorted to the back."""
    p = jnp.arange(chunk, dtype=jnp.int32)
    bpos = jnp.maximum(starts[1:-1], 0)
    # 3-column packed scan (see _pairs_from_buckets_core)
    vals3 = jnp.stack(
        [base_iter - starts[:-1], const_vals,
         (a_const << jnp.int32(8)) | dvals], axis=1)
    deltas3 = vals3[1:] - vals3[:-1]
    grid3 = jnp.zeros((chunk, 3), jnp.int32)
    grid3 = grid3.at[0].add(vals3[0])
    grid3 = grid3.at[bpos].add(deltas3, mode="drop")
    f3 = jnp.cumsum(grid3, axis=0)
    g = flat[jnp.maximum(f3[:, 0] + p, 0)]          # iterated side
    c = f3[:, 1]                                    # constant side
    fa = f3[:, 2] >> jnp.int32(8)
    a = jnp.where(fa == 1, c, g)
    b = jnp.where(fa == 1, g, c)
    dv = (f3[:, 2] & jnp.int32(0xFF)).astype(jnp.uint32)
    valid = (p < total) & (a != b)
    hi = jnp.where(valid, a.astype(jnp.uint32), jnp.uint32(_SENT))
    lo = jnp.where(
        valid, (b.astype(jnp.uint32) << jnp.uint32(8)) | dv,
        jnp.uint32(_SENT))
    return jax.lax.sort((hi, lo), num_keys=2)


_sorted_pairs = jax.jit(_sorted_pairs_core, static_argnames=("chunk",))


def _sorted_pairs_blocked_core(flat8, starts, const_vals, base_iter,
                               a_const, dvals, total, *, chunk: int):
    """Blocked RAW-pair enumeration: fetches the iterated side as 8-wide
    rows instead of one gather per pair (which of the two paths is
    faster on a GPU is not yet measured, ROADMAP.md). Each sub-bucket's
    pair range pads to a multiple of 8 (pads emit SENTINEL keys, <= ~13%%
    extra sort volume at production raggedness), so the stream is 8-lane
    blocks whose iterated values are one contiguous flat run f0..f0+8.
    Each block fetches TWO 8-wide rows of the (N/8, 8)-reshaped plane
    (any f0 alignment) and an 8-way where-chain selects the window — 2
    row-gathers + vector selects per 8 pairs. The scatter+cumsum bucket
    assignment also shrinks 8x (block granularity). Input contract
    matches _sorted_pairs_core except `flat8`: the flat plane padded to
    a row multiple plus one guard row, reshaped (rows, 8). Requires
    padded_total <= chunk (caller sizes chunk by total + 8 *
    n_subbuckets)."""
    W = 8
    B = chunk // W
    lens = starts[1:] - starts[:-1]
    cnt8 = ((lens + jnp.int32(W - 1)) // W) * W
    s8 = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(cnt8)])
    bs = s8[1:-1] >> jnp.int32(3)        # block boundaries of e >= 1
    q = jnp.arange(B, dtype=jnp.int32)
    vals4 = jnp.stack(
        [base_iter - s8[:-1],            # f0 = u + 8q
         lens + s8[:-1],                 # rem = v - 8q
         const_vals,
         (a_const << jnp.int32(8)) | dvals], axis=1)
    deltas4 = vals4[1:] - vals4[:-1]
    grid4 = jnp.zeros((B, 4), jnp.int32)
    grid4 = grid4.at[0].add(vals4[0])
    grid4 = grid4.at[bs].add(deltas4, mode="drop")
    f4 = jnp.cumsum(grid4, axis=0)
    n_rows = flat8.shape[0]
    f0 = jnp.clip(f4[:, 0] + (q << jnp.int32(3)), 0,
                  jnp.int32((n_rows - 2) * W + (W - 1)))
    r = f0 >> jnp.int32(3)
    s = f0 & jnp.int32(7)
    G = jnp.concatenate([flat8[r], flat8[r + 1]], axis=1)   # (B, 16)
    g = jnp.zeros((B, W), flat8.dtype)
    for k in range(W):
        g = jnp.where((s == k)[:, None],
                      jax.lax.dynamic_slice_in_dim(G, k, W, axis=1), g)
    rem = f4[:, 1] - (q << jnp.int32(3))
    lane = jnp.arange(W, dtype=jnp.int32)[None, :]
    ok = lane < rem[:, None]
    c = f4[:, 2][:, None]
    fa = (f4[:, 3] >> jnp.int32(8))[:, None]
    dv = (f4[:, 3] & jnp.int32(0xFF))[:, None].astype(jnp.uint32)
    a = jnp.where(fa == 1, c, g)
    b = jnp.where(fa == 1, g, c)
    valid = ok & (a != b)
    hi = jnp.where(valid, a.astype(jnp.uint32), jnp.uint32(_SENT))
    lo = jnp.where(
        valid,
        (b.astype(jnp.uint32) << jnp.uint32(8)) | dv,
        jnp.uint32(_SENT))
    return jax.lax.sort((hi.reshape(-1), lo.reshape(-1)), num_keys=2)


_sorted_pairs_blocked = jax.jit(
    _sorted_pairs_blocked_core, static_argnames=("chunk",))


@functools.partial(jax.jit, static_argnames=("use_frac", "out_small"))
def _count_filter_sorted(seen, hi, lo, min_cov, num, den, rel,
                         *, use_frac: bool, out_small: int):
    """Count + distance-consistency filter directly on a strip's SORTED
    raw pair stream (reference distance_based_kmer_recruitment.py:
    111-149 semantics): count(i, j, d) is the run length of identical
    (hi, lo) keys, all_occ(i, j) the (i, j)-group length — both read
    off nearest-boundary scans over positions, no csum and no gathers.
    Surviving-edge endpoints scatter straight into `seen`; edges
    compact through one single-key order-preserving sort + a bounded
    gather (the full-size fallback lives in the caller). Returns
    (seen, s_id, s_j, s_c, n_keep) with edges packed as
    ((i << 8) | d, j, count)."""
    valid = hi != jnp.uint32(_SENT)
    L = hi.shape[0]
    iota = jnp.arange(L, dtype=jnp.int32)
    knew = jnp.concatenate([
        jnp.ones((1,), jnp.bool_),
        (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])])
    kstart = knew & valid
    kend = (jnp.concatenate([knew[1:], jnp.ones((1,), jnp.bool_)])
            & valid)
    jj = lo >> jnp.uint32(8)
    gnew = jnp.concatenate([
        jnp.ones((1,), jnp.bool_),
        (hi[1:] != hi[:-1]) | (jj[1:] != jj[:-1])])
    gstart = gnew & valid
    gend = (jnp.concatenate([gnew[1:], jnp.ones((1,), jnp.bool_)])
            & valid)
    # nearest boundary positions: iota is strictly increasing, so the
    # nearest mark right/left is a reverse-cummin / forward-cummax.
    # keep/cntd are only consumed AT run-start positions, where
    # pos_kstart == iota — so the kstart cummax scan is dead (one fewer
    # 64M-element scan per strip)
    pos_kend = jax.lax.cummin(
        jnp.where(kend, iota, jnp.int32(0x7FFFFFFF)), reverse=True)
    pos_gend = jax.lax.cummin(
        jnp.where(gend, iota, jnp.int32(0x7FFFFFFF)), reverse=True)
    pos_gstart = jax.lax.cummax(jnp.where(gstart, iota, 0))
    cntd = pos_kend - iota + 1          # valid at kstart positions only
    all_occ = pos_gend - pos_gstart + 1
    if use_frac:
        ok_rel = cntd * den >= all_occ * num
    else:
        ok_rel = cntd.astype(jnp.float32) >= \
            rel * all_occ.astype(jnp.float32)
    keep = kstart & (cntd >= min_cov) & ok_rel
    n_keep = jnp.sum(keep.astype(jnp.int32))
    os_ = min(out_small, L)
    iota_u = iota.astype(jnp.uint32)
    skey = jnp.where(keep, iota_u, iota_u | jnp.uint32(1 << 31))
    perm = (jax.lax.sort(skey)[:os_]
            & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
    s_id = (hi[perm] << jnp.uint32(8)) | (lo[perm] & jnp.uint32(0xFF))
    s_j = jj[perm]
    s_c = cntd[perm]
    is_e = jnp.arange(os_, dtype=jnp.int32) < n_keep
    s_id = jnp.where(is_e, s_id, jnp.uint32(_SENT))
    s_j = jnp.where(is_e, s_j, jnp.uint32(_SENT))
    s_c = jnp.where(is_e, s_c, 0)

    def seen_small(sn):
        i_idx = jnp.where(is_e, s_id >> jnp.uint32(8),
                          jnp.uint32(_SENT))
        sn = sn.at[i_idx].max(jnp.uint8(1), mode="drop")
        return sn.at[jnp.where(is_e, s_j, jnp.uint32(_SENT))].max(
            jnp.uint8(1), mode="drop")

    def seen_full(sn):
        i_idx = jnp.where(keep, hi, jnp.uint32(_SENT))
        sn = sn.at[i_idx].max(jnp.uint8(1), mode="drop")
        return sn.at[jnp.where(keep, jj, jnp.uint32(_SENT))].max(
            jnp.uint8(1), mode="drop")

    seen = jax.lax.cond(n_keep <= jnp.int32(os_), seen_small,
                        seen_full, seen)
    return seen, s_id, s_j, s_c, n_keep


@functools.partial(jax.jit, static_argnames=("use_frac",))
def _compact_edges_full_sorted(hi, lo, min_cov, num, den, rel,
                               *, use_frac: bool):
    """Exact full-size edge compaction for a RAW strip whose edge count
    exceeded the fast-path bound (synthetic high-survival workloads):
    recompute cntd/keep with the same scans, then front-sort the whole
    stream with payloads. Runs on the background materialize thread
    only when needed."""
    valid = hi != jnp.uint32(_SENT)
    L = hi.shape[0]
    iota = jnp.arange(L, dtype=jnp.int32)
    knew = jnp.concatenate([
        jnp.ones((1,), jnp.bool_),
        (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])])
    kstart = knew & valid
    kend = (jnp.concatenate([knew[1:], jnp.ones((1,), jnp.bool_)])
            & valid)
    jj = lo >> jnp.uint32(8)
    gnew = jnp.concatenate([
        jnp.ones((1,), jnp.bool_),
        (hi[1:] != hi[:-1]) | (jj[1:] != jj[:-1])])
    gstart = gnew & valid
    gend = (jnp.concatenate([gnew[1:], jnp.ones((1,), jnp.bool_)])
            & valid)
    pos_kend = jax.lax.cummin(
        jnp.where(kend, iota, jnp.int32(0x7FFFFFFF)), reverse=True)
    pos_kstart = jax.lax.cummax(jnp.where(kstart, iota, 0))
    pos_gend = jax.lax.cummin(
        jnp.where(gend, iota, jnp.int32(0x7FFFFFFF)), reverse=True)
    pos_gstart = jax.lax.cummax(jnp.where(gstart, iota, 0))
    cntd = pos_kend - pos_kstart + 1
    all_occ = pos_gend - pos_gstart + 1
    if use_frac:
        ok_rel = cntd * den >= all_occ * num
    else:
        ok_rel = cntd.astype(jnp.float32) >= \
            rel * all_occ.astype(jnp.float32)
    keep = kstart & (cntd >= min_cov) & ok_rel
    n_keep = jnp.sum(keep.astype(jnp.int32))
    front = jnp.where(keep, jnp.uint32(0), jnp.uint32(1))
    packed = (hi << jnp.uint32(8)) | (lo & jnp.uint32(0xFF))
    _, s_id, s_j, s_c = jax.lax.sort(
        (front, packed, jj, cntd), num_keys=1, is_stable=True)
    is_e = iota < n_keep
    return (jnp.where(is_e, s_id, jnp.uint32(_SENT)),
            jnp.where(is_e, s_j, jnp.uint32(_SENT)),
            jnp.where(is_e, s_c, 0), n_keep)


@functools.partial(jax.jit, static_argnames=(
    "min_d", "d_hi", "T", "Kp", "NZCAP", "NBCAP", "Spad"))
def _prep_strip_device(flat, seg_packed, sizes_flat, nnz, nb,
                       total_subs, total_pairs, *, min_d: int,
                       d_hi: int, T: int, Kp: int, NZCAP: int,
                       NBCAP: int, Spad: int):
    """Device-side SPARSE strip prep: derive the strip's SUB-BUCKET
    arrays from its packed (seg_lo << 16 | seg_len) plane — the only
    per-strip upload (~1 MB) — enumerating ONLY the (read, unit) cells
    that hold strip elements, crossed with their valid distances.

    The dense (r, t, d) grid has R*T*d_hi buckets (~24M at production
    shape) but only ~3% are populated: a strip holds ~1/n_strips of all
    cloud entries, so most (r, t) cells carry no strip element at all.
    The dense formulation paid cumsums and boundary scatters
    proportional to the FULL grid per strip (~11s on-chip); this one
    pays proportional to populated cells x valid distances (~30x
    less). Pipeline: compact nonzero cells (one single-key sort of the
    (R*T,) plane), expand each by its valid-distance count via the
    same scatter-delta fill trick at NBCAP, then expand buckets into
    sub-buckets at Spad exactly as before. Outputs feed
    _pairs_from_buckets unchanged: (starts (Spad+1,), const_vals,
    base_iter, a_const, dvals). Bucket order is (cell-major, d-inner) —
    any order is valid: every pair is still enumerated exactly once,
    and the chunk tables sort keys anyway."""
    RT = seg_packed.shape[0]
    seg_len_p = seg_packed & jnp.int32(0xFFFF)
    iota_rt = jnp.arange(RT, dtype=jnp.int32)
    # compact nonzero-cell indices to the front (stable single-key sort)
    nzkey = jnp.where(seg_len_p > 0, iota_rt, jnp.int32(RT))
    if NZCAP > RT:          # tiny planes: pad the sort to NZCAP
        nzkey = jnp.concatenate(
            [nzkey, jnp.full((NZCAP - RT,), RT, jnp.int32)])
    nz_idx = jax.lax.sort(nzkey)[:NZCAP]
    zvalid = jnp.arange(NZCAP, dtype=jnp.int32) < nnz
    t_nz = nz_idx % jnp.int32(T)
    vd = jnp.clip(jnp.minimum(jnp.int32(d_hi), jnp.int32(T - 1) - t_nz)
                  - jnp.int32(min_d) + 1, 0, None)
    vd = jnp.where(zvalid, vd, 0)
    bcum = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(vd)])
    zpos = bcum[1:-1]     # boundaries at/past NBCAP drop in the scatter

    vals2 = jnp.stack([nz_idx, bcum[:-1]], axis=1)
    deltas2 = vals2[1:] - vals2[:-1]
    grid2 = jnp.zeros((NBCAP, 2), jnp.int32)
    grid2 = grid2.at[0].add(vals2[0])
    grid2 = grid2.at[zpos].add(deltas2, mode="drop")
    f2 = jnp.cumsum(grid2, axis=0)

    eb = jnp.arange(NBCAP, dtype=jnp.int32)
    bvalid = eb < nb
    idx_a = f2[:, 0]
    d = jnp.int32(min_d) + (eb - f2[:, 1])
    idx_b = jnp.minimum(idx_a + d, jnp.int32(RT - 1))
    seg = seg_packed[jnp.where(bvalid, idx_a, 0)]
    aseg = jnp.where(bvalid, seg & jnp.int32(0xFFFF), 0)
    # mask after the arithmetic shift: seg_lo occupies the high 16 bits
    # and can reach Kp-1; for seg_lo >= 2^15 the packed int32 is negative
    # and >> sign-extends, so the unmasked unpack would corrupt the
    # gather base below for any strip past the 32768th rare k-mer
    alo = (seg >> jnp.int32(16)) & jnp.int32(0xFFFF)
    nbv = jnp.where(bvalid, sizes_flat[idx_b], 0)
    ba = idx_a * jnp.int32(Kp) + alo
    bb = idx_b * jnp.int32(Kp)
    cnt = aseg * nbv
    nsub = jnp.minimum(aseg, nbv)
    am = (nbv >= aseg).astype(jnp.int32)
    cbase = jnp.where(am == 1, ba, bb)
    ibase = jnp.where(am == 1, bb, ba)
    ilen = jnp.where(am == 1, nbv, aseg)
    z1 = jnp.zeros((1,), jnp.int32)
    bstart = jnp.concatenate([z1, jnp.cumsum(cnt)])
    sstart = jnp.concatenate([z1, jnp.cumsum(nsub)])
    spos = sstart[1:-1]              # sub-space bucket boundaries

    vals7 = jnp.stack(
        [sstart[:-1], cbase, bstart[:-1], ilen, ibase, am,
         jnp.where(bvalid, d, 0)], axis=1)
    deltas7 = vals7[1:] - vals7[:-1]
    grid7 = jnp.zeros((Spad, 7), jnp.int32)
    grid7 = grid7.at[0].add(vals7[0])
    grid7 = grid7.at[spos].add(deltas7, mode="drop")
    f7 = jnp.cumsum(grid7, axis=0)

    e = jnp.arange(Spad, dtype=jnp.int32)
    x = e - f7[:, 0]
    cv = flat[jnp.maximum(f7[:, 1] + x, 0)]
    st = f7[:, 2] + x * f7[:, 3]
    bi = f7[:, 4]
    ac = f7[:, 5]
    dvs = f7[:, 6]
    pad = e >= total_subs
    st = jnp.where(pad, total_pairs, st)
    cv = jnp.where(pad, 0, cv)
    bi = jnp.where(pad, 0, bi)
    ac = jnp.where(pad, 0, ac)
    dvs = jnp.where(pad, 0, dvs)
    starts = jnp.concatenate(
        [st, jnp.full((1,), 1, jnp.int32) * total_pairs])
    return starts, cv, bi, ac, dvs


def _expand_subbuckets(flat_host: np.ndarray, counts: np.ndarray,
                       ba: np.ndarray, bb: np.ndarray, nbv: np.ndarray,
                       dvv: np.ndarray):
    """Split each (read, unit, distance) bucket along its smaller cloud
    side into sub-buckets of (one smaller-side element) x (whole larger
    side). The smaller side's k-mer values are gathered from the flat
    cloud array ON HOST (cheap: one value per sub-bucket); the device
    then needs a single gather per pair. Returns flat arrays over
    sub-buckets: (counts, const_vals, base_iter, a_const, dv)."""
    seg = (counts // np.maximum(nbv, 1)).astype(np.int64)  # A-side sizes
    a_major = nbv >= seg          # expand A side when B side is larger
    n_sub = np.where(a_major, seg, nbv).astype(np.int64)
    sub_of = np.repeat(np.arange(len(counts)), n_sub)
    first = np.cumsum(n_sub) - n_sub
    x = np.arange(len(sub_of), dtype=np.int64) - first[sub_of]
    am = a_major[sub_of]
    const_base = np.where(am, ba[sub_of], bb[sub_of]).astype(np.int64)
    const_vals = flat_host[const_base + x]
    base_iter = np.where(am, bb[sub_of], ba[sub_of]).astype(np.int32)
    sub_counts = np.where(am, nbv[sub_of], seg[sub_of]).astype(np.int64)
    return (sub_counts, const_vals.astype(np.int32), base_iter,
            am.astype(np.int32), dvv[sub_of])


def _strip_buckets(seg_lo: np.ndarray, seg_len: np.ndarray,
                   sizes: np.ndarray, n_units: np.ndarray,
                   min_d: int, d_hi: int, T: int, Kp: int):
    """Pair buckets of one strip: every populated (read, unit t, distance
    d) triple contributes seg_len[r, t] * sizes[r, t+d] ordered pairs
    (A = the row's contiguous strip segment, B = the full partner cloud —
    rows are sorted with -1 padding behind the valid entries, so both are
    contiguous slices). Returns (counts int64, base_a, base_b, nb, dv)
    flat arrays over nonzero buckets, or None if the strip is empty.
    Pure vectorized numpy; strip membership is exact by construction."""
    parts = []
    for d in range(min_d, min(d_hi, T - 1) + 1):
        na = seg_len[:, :T - d].astype(np.int64)
        nb = sizes[:, d:].astype(np.int64)
        ok = (np.arange(T - d, dtype=np.int64)[None, :] + d
              ) < n_units[:, None]
        cnt = np.where(ok, na * nb, 0).ravel()
        nz = np.flatnonzero(cnt)
        if nz.size == 0:
            continue
        r = nz // (T - d)
        t = nz - r * (T - d)
        parts.append((
            cnt[nz],
            ((r * T + t) * Kp
             + seg_lo[:, :T - d].ravel()[nz]).astype(np.int32),
            ((r * T + t + d) * Kp).astype(np.int32),
            nb.ravel()[nz].astype(np.int32),
            np.full(nz.size, d, np.int32),
        ))
    if not parts:
        return None
    return tuple(np.concatenate([p[i] for p in parts])
                 for i in range(5))


def estimate_pair_capacity(clouds_tensor: np.ndarray,
                           n_units: np.ndarray,
                           config: KmerRecruitmentConfig,
                           *, cap: int = 1 << 26) -> int:
    """Static table capacity from cloud-size statistics: the distinct
    (i, j, d) key count is bounded by the total pair-observation count
    sum_r sum_d sum_t |cloud_t||cloud_{t+d}|, computable from the cloud
    sizes alone. Pre-sizing from this bound gives one compile per shape —
    no recompile-on-doubling at production scale."""
    total = _pair_obs_bound(clouds_tensor, n_units, config)
    return 1 << max(16, int(np.ceil(np.log2(max(min(total, cap), 2)))))


def _strip_sweep(
    clouds_tensor: np.ndarray,        # (R, T, K) int32, -1 padded
    n_units: np.ndarray,              # (R,) int32
    config: KmerRecruitmentConfig,
    *,
    capacity: Optional[int] = None,
    tile_a: int = 8,                  # back-compat, unused: pair
    tile_b: int = 32,                 # emission is exact, not tiled
    entry_chunk: Optional[int] = None,
    element_budget: int = 63 << 20,
    strip_capacity: int = 1 << 26,
    subbucket_budget: int = 8 << 20,
    dedup_hint: int = 1,
    max_capacity: int = 1 << 27,
    mesh=None,
    adaptive: bool = True,
    yield_raw: bool = False,
):
    """Yield one sorted (i, j, d) -> count device table per i-range strip,
    strips in ascending i order (so concatenating valid prefixes yields
    the globally sorted table).

    The key space is striped by i so each strip's table is bounded. Strip
    membership is exact by construction: cloud rows are sorted, so a
    strip's elements within a row form one contiguous segment whose
    bounds the host reads off value-threshold counts. Pair emission is
    EXACT: per strip the host splits every populated (read, unit,
    distance) bucket along its smaller cloud side into SUB-BUCKETS
    (one smaller-side element, its k-mer value resolved on host, times
    the whole larger side) and ships the flat sub-bucket list with its
    pair-count cumsum; the device enumerates pair indices [0, total) in
    static chunks, assigning each index its sub-bucket by scatter+cumsum
    of the boundary deltas and fetching the iterated side with ONE flat
    gather — every key entering a sort is a true pair observation, so
    sort volume equals the pair-observation bound instead of the ~7x
    tile outer-product slack, and per-chunk host uploads shrink to two
    scalars. entry_chunk counts PAIRS per device chunk. Chunk tables are
    sized to the chunk (overflow impossible — no host syncs) and merge
    into a binary forest; doubling on overflow remains the fallback for
    capacity-saturated merges only. Sub-bucket expansion happens per
    SEGMENT (bucket slices bounded by both pair count and sub-bucket
    count), so peak host memory is O(segment), not O(strip)."""
    R, T, K = clouds_tensor.shape
    # key packing is (i) x ((j << 8) | d) and the filter regroups by
    # (i << 24) | j — both alias silently if these bounds are exceeded
    if config.max_distance >= 256:
        raise ValueError(
            f"max_distance {config.max_distance} >= 256 overflows the "
            "8-bit distance field of the packed key")
    max_idx = int(clouds_tensor.max()) if clouds_tensor.size else 0
    if max_idx >= 1 << 24:
        raise ValueError(
            "rare k-mer index >= 2^24 overflows the packed pair key")
    # canonicalize rows: ascending valid entries front-packed, -1 pads
    # behind (strip segments and B-cloud slices index contiguous valid
    # prefixes; pad_clouds already emits this layout, synthetic callers
    # may not; within-cloud order cannot change any (i, j, d) count)
    if clouds_tensor.size:
        srt = np.sort(clouds_tensor, axis=2)      # any -1 pads sort first
        n_inv = (srt < 0).sum(axis=2, keepdims=True)
        idx = (np.arange(K, dtype=np.int64)[None, None, :] + n_inv) % K
        clouds_tensor = np.take_along_axis(srt, idx, axis=2)
    bound = _pair_obs_bound(clouds_tensor, n_units, config)
    if capacity is None:
        capacity = 1 << max(
            16, int(np.ceil(np.log2(max(min(bound, strip_capacity), 2)))))
    max_capacity = max(max_capacity, capacity)
    # strip sizing: the pair-obs bound assumes every observation mints a
    # distinct (i, j, d) key, but at coverage c each key is observed by
    # ~c/2 read pairs — sizing strips by the raw bound pays the fixed
    # per-strip cost (device prep, fold, filter, edge readback dispatch)
    # c/2 times too often at production coverage. dedup_hint divides the
    # bound for STRIP COUNT only; per-table capacity is unchanged and
    # the check-and-double fallback remains correct if a skewed strip
    # overflows anyway (the no-overflow sync skip disarms itself:
    # total_strip > capacity there by construction).
    # 0.94 margin: strips whose raw pair count lands just over capacity
    # lose the no-overflow proof and pay a host sync per saturated
    # merge; sizing to 94% keeps the proof for uniform strips. The
    # blocked raw path pads every sub-bucket to a multiple of 8 pairs
    # (~13% at production raggedness), so when it is in play strips
    # size to 82% — the padded bound must also fit the chunk or the
    # strip falls back to the per-pair gather
    # opt-in until an end-to-end A/B against the per-pair gather on
    # the GPU decides between them (ROADMAP.md)
    blocked_ok = (yield_raw
                  and not (mesh is not None and mesh.devices.size > 1)
                  and os.environ.get("CENTROFLYE_BLOCKED") == "1")
    margin = 0.82 if blocked_ok else 0.94
    n_strips = max(1, -(-bound // max(
        int(capacity * margin) * max(dedup_hint, 1), 1)))
    strip_w = max(1, -(-(max_idx + 1) // n_strips))
    n_strips = max(1, -(-(max_idx + 1) // strip_w))

    n_dev = 1
    if mesh is not None and mesh.devices.size > 1:
        n_dev = int(mesh.devices.size)
    if entry_chunk is None:
        entry_chunk = max(1, min(element_budget, capacity))
    entry_chunk = -(-entry_chunk // n_dev) * n_dev
    # tail chunks use a 16x smaller shape: per-strip remainders would
    # otherwise pad up to a full chunk each (S strips x chunk wasted keys)
    tail_chunk = -(-max(n_dev, entry_chunk // 16) // n_dev) * n_dev

    Kp = max(K, 1)
    flat_host = np.ascontiguousarray(
        clouds_tensor.reshape(-1), dtype=np.int32)
    if flat_host.size == 0:
        flat_host = np.full(1, -1, np.int32)
    if int(np.int64(R) * T * Kp) >= 1 << 31:
        raise ValueError("flat cloud tensor exceeds int32 addressing")

    if n_dev > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P
        flat_dev = jax.device_put(flat_host, NamedSharding(mesh, P()))
        repl = NamedSharding(mesh, P())
        flat8_dev = None
    else:
        flat_dev = jax.device_put(flat_host)
        repl = None
        # 8-wide row view (+1 guard row) for the blocked raw
        # enumeration (fetches rows instead of per-pair elements)
        n8 = (len(flat_host) + 7) // 8 + 1
        f8 = np.zeros(n8 * 8, np.int32)
        f8[:len(flat_host)] = flat_host
        flat8_dev = jax.device_put(f8.reshape(n8, 8))

    # per-cloud sizes, masked to live unit instances
    sizes = (clouds_tensor >= 0).sum(axis=2).astype(np.int64)  # (R, T)
    live = np.arange(T, dtype=np.int64)[None, :] < \
        np.asarray(n_units, np.int64)[:, None]
    sizes = np.where(live, sizes, 0)
    d_hi = min(config.max_distance, T - 1)

    # per-strip contiguous segments of each sorted row, computed ON
    # DEMAND per strip boundary (element counts below a value threshold;
    # rows are sorted ascending with -1 padding behind, counted via the
    # >= 0 mask) — strips are now a WORKLIST of [lo, hi) value ranges so
    # an overflowing strip can split in half and retry, and boundaries
    # are arbitrary, not a precomputed uniform grid
    vmask = clouds_tensor >= 0
    zeros_rt = np.zeros_like(sizes)
    below_cache: Dict[int, np.ndarray] = {}

    def below_count(v: int) -> np.ndarray:
        if v <= 0:
            return zeros_rt
        if v > max_idx:
            return sizes
        if v not in below_cache:
            below_cache[v] = ((clouds_tensor < v) & vmask).sum(axis=2)
        return below_cache[v]

    # pair counts are LINEAR in the strip's per-(read, unit) element
    # counts: pairs(strip) = sum_{r,t} seg_len[r,t] * W[r,t] with
    # W[r,t] = sum_{d in [min_d, d_hi], t+d < T} sizes[r, t+d] — one
    # precomputed suffix-cumsum plane replaces the per-strip d-loop
    # (O(R*T) per strip instead of O(R*T*d_hi))
    _scs = np.concatenate(
        [np.cumsum(sizes[:, ::-1], axis=1)[:, ::-1],
         np.zeros((R, 1), np.int64)], axis=1)   # suffix sums, (R, T+1)
    _w_lo = np.minimum(np.arange(T) + config.min_distance, T)
    _w_hi = np.minimum(np.arange(T) + d_hi + 1, T)
    pair_weight = np.take_along_axis(_scs, _w_lo[None, :], axis=1) - \
        np.take_along_axis(_scs, _w_hi[None, :], axis=1)   # (R, T)

    def pair_count(lo: int, hi: int) -> int:
        return int(((below_count(hi) - below_count(lo))
                    .astype(np.int64) * pair_weight).sum())

    sharded_steps = {}
    # per-strip proof that capacity-saturated tables cannot overflow:
    # distinct keys <= the strip's pair-observation bound, so when that
    # bound fits the capacity, every check-and-double host sync (one
    # device round trip and a pipeline stall each) is provably dead and
    # skipped
    strip_no_ovf = [False]
    dedup_obs = [None]
    dedup_samples: List[float] = []
    sweep_grid = [None]  # once-per-sweep device sizes plane + vd counts   # adaptive-striping calibration result

    def run_chunk(bufs, c0, total, chunk):
        """One pair-range chunk -> (table, cap). The chunk table covers
        the chunk's pair count, so overflow is impossible whenever the
        strip capacity allows it and NO host sync happens — the result
        streams into the merge forest with the transfer still in
        flight. Only the bucket list (once per strip segment) and two
        scalars per chunk cross the host->device link."""
        nonlocal capacity
        cap = min(_next_pow2(chunk), capacity)
        while True:
            if n_dev > 1:
                from centroflye_tpu.parallel.mesh import (
                    make_pair_bucket_step)
                key = (int(bufs[0].shape[0]), chunk, cap)
                if key not in sharded_steps:
                    sharded_steps[key] = make_pair_bucket_step(
                        mesh, chunk=chunk, capacity=cap)
                uhi, ulo, cnt, n = sharded_steps[key](
                    flat_dev, *bufs, jnp.int32(c0), jnp.int32(total))
            else:
                uhi, ulo, cnt, n = _pairs_from_buckets(
                    flat_dev, *bufs, jnp.int32(c0), jnp.int32(total),
                    chunk=chunk, capacity=cap)
            if cap >= chunk or strip_no_ovf[0] or int(n) <= cap:
                return (uhi, ulo, cnt), cap
            cap *= 2
            if cap > max_capacity:
                raise _StripOverflow
            if cap > capacity:
                capacity = cap

    logger.info(
        "distance sweep: %d strip(s), chunk %d pairs, capacity %d, "
        "pair-obs bound %d", n_strips, entry_chunk, capacity, bound)
    # CENTROFLYE_DIST_PROFILE=1: per-strip phase breakdown with a device
    # sync after every chunk (attribution is meaningless under async
    # dispatch) — benchmarking aid, off in production
    profile = os.environ.get("CENTROFLYE_DIST_PROFILE") == "1"
    yielded = False
    # LIFO worklist of [lo, hi) i-value ranges, seeded with the uniform
    # grid and popped in ascending order (splits push their halves back
    # in order) — yields stay globally sorted by i
    work = [(s * strip_w,
             (s + 1) * strip_w if n_strips > 1 else max(max_idx + 1, 1))
            for s in range(n_strips)][::-1]
    while work:
        s_lo, s_hi = work.pop()
        ph = {"buckets": 0.0, "expand": 0.0, "upload": 0.0,
              "chunks": 0.0, "fold": 0.0}
        t_strip = time.perf_counter()
        lo_c = below_count(s_lo)
        seg_lo = lo_c
        seg_len = below_count(s_hi) - lo_c
        # cheap reductions first: strip pair/sub-bucket totals without
        # materializing the bucket grid on host
        total_strip = int((seg_len.astype(np.int64) * pair_weight).sum())
        total_subs = 0
        for d in range(config.min_distance, d_hi + 1):
            if d >= T:
                break
            total_subs += int(np.minimum(
                seg_len[:, :T - d], sizes[:, d:]).sum())
        if total_strip == 0:
            continue
        strip_no_ovf[0] = total_strip <= capacity
        # device-grid path: the bucket grid and sub-bucket expansion
        # are derived ON DEVICE from the (R, T) strip segments — the
        # per-strip upload drops from 5x|sub-buckets| arrays to two
        # (R, T) planes. Falls back to the host bucket path on meshes
        # (the sharded step consumes replicated host buffers) and when
        # a single strip exceeds int32 pair indexing.
        devgrid = (n_dev == 1 and total_strip < (1 << 31)
                   and total_subs < (1 << 31)
                   and Kp < (1 << 16)
                   and os.environ.get(
                       "CENTROFLYE_NO_DEVGRID") != "1")
        nb_buckets = sum(R * max(0, T - d) for d in range(
            config.min_distance, d_hi + 1))
        n_subs_log = total_subs
        seg_bounds = None
        if not devgrid:
            t0 = time.perf_counter()
            buckets = _strip_buckets(seg_lo, seg_len, sizes, n_units,
                                     config.min_distance, d_hi, T, Kp)
            ph["buckets"] = time.perf_counter() - t0
            if buckets is None:
                continue
            cnts_b, ba, bb, nbv, dvv = buckets
            # per-bucket sub-bucket count (the smaller cloud side): host
            # expansion memory is proportional to it, and with mostly
            # size-1 clouds it approaches the pair count — so segment
            # the BUCKET list first and expand per segment
            n_sub_b = np.minimum(cnts_b // np.maximum(nbv, 1), nbv)
            bcum = np.concatenate([[0], np.cumsum(cnts_b)])
            bscum = np.concatenate([[0], np.cumsum(n_sub_b)])
            n_subs_log = int(bscum[-1])
            total_strip = int(bcum[-1])
            if total_strip == 0:
                continue
            # segments bounded by both pair count (< 2^30: device pair
            # indices are int32) and sub-bucket count (host memory)
            seg_bounds = [0]
            nb_buckets = len(cnts_b)
            while seg_bounds[-1] < nb_buckets:
                b0 = seg_bounds[-1]
                p_lim = int(np.searchsorted(
                    bcum, bcum[b0] + (1 << 30), side="right")) - 1
                s_lim = int(np.searchsorted(
                    bscum, bscum[b0] + subbucket_budget,
                    side="right")) - 1
                nxt = max(min(p_lim, s_lim), b0 + 1)
                seg_bounds.append(min(nxt, nb_buckets))

        # binary-counter merge forest: chunk tables enter at their own
        # (power-of-two) capacity and same-sized tables merge pairwise
        # upward, so total merge cost is O(keys * log levels) — NOT
        # O(chunks * strip_capacity) as a single running accumulator
        # would cost. Sub-capacity merges cannot overflow (out capacity
        # = sum of input capacities), so they need NO host sync; only
        # capacity-saturated merges check-and-double.
        forest: Dict[int, tuple] = {}

        def merge_pair(ta, cap_a, tb, cap_b):
            nonlocal capacity
            out = min(_next_pow2(cap_a + cap_b), capacity)
            while True:
                m = merge_count_tables(ta[0], ta[1], ta[2],
                                       tb[0], tb[1], tb[2], capacity=out)
                if out >= cap_a + cap_b or strip_no_ovf[0] \
                        or int(m[3]) <= out:
                    return (m[0], m[1], m[2]), out
                out *= 2
                if out > max_capacity:
                    raise _StripOverflow
                if out > capacity:
                    capacity = out

        def insert(t, cap):
            while cap in forest:
                other = forest.pop(cap)
                t, cap = merge_pair(other, cap, t, cap)
            forest[cap] = t

        def iter_segments():
            """(bufs, total_seg) per segment — one device-prepped
            segment on the devgrid path, host-expanded slices else."""
            if devgrid:
                t0 = time.perf_counter()
                Spad = _next_pow2(total_subs)
                if sweep_grid[0] is None:
                    # once per sweep: sizes plane on device + host
                    # valid-distance counts per unit column
                    sweep_grid[0] = (
                        jnp.asarray(np.ascontiguousarray(
                            sizes.ravel(), dtype=np.int32)),
                        np.maximum(np.minimum(
                            d_hi, T - 1 - np.arange(T))
                            - config.min_distance + 1, 0))
                sizes_flat_dev, vd_plane = sweep_grid[0]
                packed = (seg_lo.astype(np.int32) << 16) | \
                    seg_len.astype(np.int32)
                nzmask = seg_len > 0
                nnz = int(nzmask.sum())
                nb = int((nzmask * vd_plane[None, :]).sum())
                bufs = _prep_strip_device(
                    flat_dev,
                    jnp.asarray(np.ascontiguousarray(packed).ravel()),
                    sizes_flat_dev,
                    jnp.int32(nnz), jnp.int32(nb),
                    jnp.int32(total_subs), jnp.int32(total_strip),
                    min_d=config.min_distance, d_hi=d_hi, T=T, Kp=Kp,
                    NZCAP=_next_pow2(max(nnz, 1)),
                    NBCAP=_next_pow2(max(nb, 1)), Spad=Spad)
                if profile:
                    jax.block_until_ready(bufs)
                ph["expand"] += time.perf_counter() - t0
                yield bufs, total_strip
                return
            for si in range(len(seg_bounds) - 1):
                b0, b1 = seg_bounds[si], seg_bounds[si + 1]
                t0 = time.perf_counter()
                counts, cvals, biter, aconst, dvs = _expand_subbuckets(
                    flat_host, cnts_b[b0:b1], ba[b0:b1], bb[b0:b1],
                    nbv[b0:b1], dvv[b0:b1])
                ph["expand"] += time.perf_counter() - t0
                cum = np.concatenate([[0], np.cumsum(counts)])
                total_seg = int(cum[-1])
                if total_seg == 0:
                    continue
                E = len(counts)
                Epad = _next_pow2(E)
                starts_h = np.full(Epad + 1, total_seg, np.int32)
                starts_h[:E + 1] = cum.astype(np.int32)
                cv_h = np.zeros(Epad, np.int32)
                cv_h[:E] = cvals
                bi_h = np.zeros(Epad, np.int32)
                bi_h[:E] = biter
                ac_h = np.zeros(Epad, np.int32)
                ac_h[:E] = aconst
                dv_h = np.zeros(Epad, np.int32)
                dv_h[:E] = dvs
                arrs = (starts_h, cv_h, bi_h, ac_h, dv_h)
                t0 = time.perf_counter()
                bufs = tuple(jax.device_put(x, repl) if repl is not None
                             else jax.device_put(x) for x in arrs)
                if profile:
                    jax.block_until_ready(bufs)
                ph["upload"] += time.perf_counter() - t0
                yield bufs, total_seg

        # RAW fast path: a strip that fits one chunk skips the count
        # table, merge forest and overflow machinery entirely — the
        # consumer reads counts as run lengths of the sorted stream
        # (_count_filter_sorted). Yield contract: cnt is None marks a
        # raw strip (hi, lo, None, -1, total_pairs).
        if yield_raw and devgrid and total_strip <= entry_chunk:
            # padded bound for the blocked kernel: every sub-bucket
            # rounds up to a multiple of 8 pairs
            pad_bound = total_strip + 8 * total_subs
            for bufs, total_seg in iter_segments():
                t0 = time.perf_counter()
                if pad_bound <= entry_chunk and entry_chunk >= 64 \
                        and flat8_dev is not None \
                        and os.environ.get(
                            "CENTROFLYE_BLOCKED") == "1":
                    # 8M-step sizing instead of the pow2 stair: the
                    # ~13% padding would otherwise double the sort
                    # volume whenever it crosses a power of two
                    # (bounded compile variety: <= entry_chunk / 8M
                    # shapes, persistently cached)
                    step = min(1 << 23, entry_chunk)
                    size = min(-(-max(tail_chunk, pad_bound, 64)
                                 // step) * step, entry_chunk)
                    rhi, rlo = _sorted_pairs_blocked(
                        flat8_dev, *bufs, jnp.int32(total_seg),
                        chunk=size)
                else:
                    size = min(max(tail_chunk, _next_pow2(total_seg)),
                               entry_chunk)
                    rhi, rlo = _sorted_pairs(
                        flat_dev, *bufs, jnp.int32(total_seg),
                        chunk=size)
                if profile:
                    jax.block_until_ready((rhi, rlo))
                ph["chunks"] += time.perf_counter() - t0
            logger.info(
                "distance strip [%d, %d): %d pairs / %d buckets "
                "(%d sub-buckets) raw, %.1fs submit%s",
                s_lo, s_hi, total_strip, nb_buckets, n_subs_log,
                time.perf_counter() - t_strip,
                " [expand %.1fs chunks %.1fs]" % (
                    ph["expand"], ph["chunks"]) if profile else "")
            yielded = True
            yield rhi, rlo, None, -1, total_strip
            continue
        try:
            for bufs, total_seg in iter_segments():
                pos = 0
                while pos < total_seg:
                    rem = total_seg - pos
                    if rem >= entry_chunk:
                        size = entry_chunk
                    else:
                        # pow2-stair tail: ONE chunk rounded up to the
                        # next power of two (floored at tail_chunk)
                        # instead of a stream of fixed small tails — at
                        # most 2x masked slack, bounded shape variety
                        # (each pow2 compiles once, reused across strips
                        # and runs)
                        size = min(max(tail_chunk, _next_pow2(rem)),
                                   entry_chunk)
                        size = -(-size // n_dev) * n_dev
                    t0 = time.perf_counter()
                    t, cap = run_chunk(bufs, pos, total_seg, size)
                    insert(t, cap)
                    if profile:
                        jax.block_until_ready(t)
                        # throwaway scalar readback closes the async gap
                        np.asarray(t[0][:1])
                    ph["chunks"] += time.perf_counter() - t0
                    pos += size

            # fold surviving forest levels (ascending) into one table
            t0 = time.perf_counter()
            acc, acc_cap = None, 0
            for cap in sorted(forest):
                if acc is None:
                    acc, acc_cap = forest[cap], cap
                else:
                    acc, acc_cap = merge_pair(acc, acc_cap,
                                              forest[cap], cap)
            ph["fold"] = time.perf_counter() - t0
        except _StripOverflow:
            mid = (s_lo + s_hi) // 2
            if mid <= s_lo:
                raise ValueError(
                    f"distance strip [{s_lo}, {s_hi}) cannot split "
                    f"further yet exceeds max_capacity {max_capacity} "
                    "distinct keys — raise max_capacity")
            logger.info(
                "distance strip [%d, %d) overflowed max capacity %d — "
                "splitting at %d and retrying", s_lo, s_hi,
                max_capacity, mid)
            work.append((mid, s_hi))
            work.append((s_lo, mid))
            continue
        # ADAPTIVE STRIPING: the uniform grid is sized by the raw
        # pair-observation bound, but every (i, j, d) key is observed
        # once per spanning read with both k-mers surviving — the
        # realized distinct/pairs ratio ("dedup") is typically 2-5x at
        # production coverage, and per-strip fixed costs (device prep,
        # fold, filter sort at capacity, readback dispatch) dominate
        # once tables stop overflowing. Calibrate the dedup on the
        # FIRST executed strip (one scalar sync, ~40 ms) and coalesce
        # the remaining uniform ranges so each future strip carries
        # ~capacity * dedup * 0.75 pairs; the overflow-split worklist
        # remains the safety net if a coalesced strip's distinct count
        # exceeds capacity after all.
        if adaptive and dedup_obs[0] is None and acc is not None \
                and work:
            n_strip = int(jnp.sum(
                (acc[0] != jnp.uint32(_SENT)).astype(jnp.int32)))
            if n_strip > 0:
                dedup_samples.append(total_strip / n_strip)
            # median of 3 strips: a single-strip sample is biased (the
            # lowest i-range holds the lexicographically smallest
            # k-mers — low-complexity sequence with inflated counts;
            # observed 2.7x overestimate at production shape)
            if len(dedup_samples) >= 3:
                dedup_obs[0] = max(
                    1.0, sorted(dedup_samples)[len(dedup_samples) // 2])
                target = int(capacity * max(1.0, 0.75 * dedup_obs[0]))
                merged, cur = [], None
                for lo, hi in reversed(work):      # ascending ranges
                    if cur is None:
                        cur = (lo, hi)
                    elif cur[1] == lo and \
                            pair_count(cur[0], hi) <= target:
                        cur = (cur[0], hi)
                    else:
                        merged.append(cur)
                        cur = (lo, hi)
                if cur is not None:
                    merged.append(cur)
                if len(merged) < len(work):
                    logger.info(
                        "distance sweep: dedup %.2f observed — "
                        "coalescing %d remaining strips into %d",
                        dedup_obs[0], len(work), len(merged))
                work[:] = merged[::-1]
        # NO distinct-count host sync here in production (beyond the
        # one calibration strip above): the strip yields with its
        # device table still in flight, so the next strip's host prep +
        # uploads overlap this strip's compute and the consumer's
        # readback. Callers needing n sync themselves.
        if profile and acc is not None:
            n_dbg = int(jnp.sum((acc[0] != jnp.uint32(_SENT))
                                .astype(jnp.int32)))
            logger.info(
                "distance strip [%d, %d): %d pairs / %d buckets "
                "(%d sub-buckets), %d distinct, %.1fs",
                s_lo, s_hi, total_strip, nb_buckets, n_subs_log,
                n_dbg, time.perf_counter() - t_strip)
            logger.info(
                "  strip phases: buckets %.2fs expand %.2fs upload "
                "%.2fs chunks %.2fs fold %.2fs",
                ph["buckets"], ph["expand"], ph["upload"],
                ph["chunks"], ph["fold"])
        else:
            logger.info(
                "distance strip [%d, %d): %d pairs / %d buckets "
                "(%d sub-buckets), %.1fs submit",
                s_lo, s_hi, total_strip, nb_buckets, n_subs_log,
                time.perf_counter() - t_strip)
        if acc is not None:
            yielded = True
            yield acc[0], acc[1], acc[2], None, acc_cap
    if not yielded:
        e = jnp.full(capacity, _SENT, jnp.uint32)
        yield e, e, jnp.zeros(capacity, jnp.int32), 0, capacity


def _pair_obs_bound(clouds_tensor, n_units, config) -> int:
    sizes = (clouds_tensor >= 0).sum(axis=2).astype(np.int64)   # (R, T)
    pos = np.arange(sizes.shape[1])[None, :]
    sizes = np.where(pos < np.asarray(n_units)[:, None], sizes, 0)
    total = 0
    for d in range(config.min_distance, config.max_distance + 1):
        if d >= sizes.shape[1]:
            break
        total += int((sizes[:, :-d] * sizes[:, d:]).sum())
    return total


def build_distance_table(
    clouds_tensor: np.ndarray,        # (R, T, K) int32, -1 padded
    n_units: np.ndarray,              # (R,) int32
    config: KmerRecruitmentConfig,
    *,
    capacity: Optional[int] = None,
    tile_a: int = 8,
    tile_b: int = 32,
    entry_chunk: Optional[int] = None,
    element_budget: int = 64 << 20,
    strip_capacity: int = 1 << 26,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Full (i, j, d) -> count table over all reads and distances,
    MATERIALIZED to host numpy (use recruit_unique_kmers for the
    production path — it filters each strip on device and never
    materializes the table).

    Returns (uhi, ulo, counts, n) sorted by (i, j, d), arrays of length
    n; decode with i = uhi, j = ulo >> 8, d = ulo & 0xFF.
    """
    parts = []
    total = 0
    for uhi, ulo, cnt, n, _cap in _strip_sweep(
            clouds_tensor, n_units, config, capacity=capacity,
            tile_a=tile_a, tile_b=tile_b,
            entry_chunk=entry_chunk, element_budget=element_budget,
            strip_capacity=strip_capacity, mesh=mesh):
        if n is None:
            n = int(jnp.sum((uhi != jnp.uint32(_SENT))
                            .astype(jnp.int32)))
        if n:
            parts.append((np.asarray(uhi[:n]), np.asarray(ulo[:n]),
                          np.asarray(cnt[:n])))
            total += n
    if not parts:
        e = np.empty(0, np.uint32)
        return e, e.copy(), np.empty(0, np.int32), 0
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]), total)


@dataclasses.dataclass
class DistanceEdges:
    """Surviving distance-consistent edges + their endpoint k-mer indices."""

    # parallel arrays of surviving edges
    dist: np.ndarray      # int32
    i: np.ndarray         # int64 k-mer index
    j: np.ndarray         # int64 k-mer index
    freq: np.ndarray      # int64
    unique_kmer_indices: np.ndarray   # sorted int64
    # the edge-coverage cutoff that produced this edge set — equals
    # config.min_coverage except under auto_min_coverage, where the
    # coverage-adaptive selection may have stepped it down
    min_coverage_used: int = 0


def filter_dist_tuples(
    uhi: np.ndarray, ulo: np.ndarray, counts: np.ndarray, n: int,
    config: KmerRecruitmentConfig,
) -> DistanceEdges:
    """Distance-consistency filter (reference
    distance_based_kmer_recruitment.py:131-149): keep (i, j, d) iff
    count >= min_coverage and count / sum_d'(count(i, j, d')) >= 0.8."""
    if n == 0:
        e = np.empty(0, np.int64)
        return DistanceEdges(dist=np.empty(0, np.int32), i=e, j=e.copy(),
                             freq=e.copy(), unique_kmer_indices=e.copy())
    i_all = uhi[:n].astype(np.int64)
    j_all = (ulo[:n] >> np.uint32(8)).astype(np.int64)
    d_all = (ulo[:n] & np.uint32(0xFF)).astype(np.int64)
    c_all = counts[:n].astype(np.int64)
    # group by (i, j): table sorted by (i, j, d) so groups are contiguous
    pair_key = (i_all << np.int64(24)) | j_all
    starts = np.concatenate([[True], pair_key[1:] != pair_key[:-1]])
    group = np.cumsum(starts) - 1
    all_occ = np.zeros(group[-1] + 1 if n else 0, np.int64)
    np.add.at(all_occ, group, c_all)
    keep = (c_all >= config.min_coverage) & \
        (c_all / np.maximum(all_occ[group], 1) >= config.rel_threshold)
    sel_i = i_all[keep]
    sel_j = j_all[keep]
    uniq = np.unique(np.concatenate([sel_i, sel_j])) if keep.any() \
        else np.empty(0, np.int64)
    return DistanceEdges(
        dist=d_all[keep].astype(np.int32), i=sel_i, j=sel_j,
        freq=c_all[keep], unique_kmer_indices=uniq)


@functools.partial(jax.jit, static_argnames=("use_frac", "out_capacity"))
def _filter_table_device(uhi, ulo, cnt, min_cov, num, den, rel,
                         *, use_frac: bool, out_capacity: int):
    """Distance-consistency filter of one sorted strip table, ON DEVICE
    (reference distance_based_kmer_recruitment.py:131-149): keep (i, j, d)
    iff count >= min_coverage and count / sum_d'(count(i, j, d')) >=
    rel_threshold. Groups (i, j) are contiguous (table sorted by (i,j,d))
    and never straddle a strip (strips partition by i), so the filter is
    strip-local and exact. When rel_threshold equals a small exact
    fraction num/den (e.g. the default 0.8 = 4/5), the ratio test is the
    integer cross-multiplication count*den >= all_occ*num — no float
    rounding at the boundary. Returns compacted PACKED edge arrays
    ((i << 8) | d, j, freq) + the surviving-edge count — i and d share
    one word (i < 2^24 and d < 2^8 are already invariants of the pair
    key) so an edge costs 12 bytes of device->host readback instead of
    16; on link-bound harnesses the edge readback is the largest e2e
    term of the sweep."""
    valid = uhi != SENTINEL
    j = ulo >> jnp.uint32(8)
    gstart = jnp.concatenate([
        jnp.ones((1,), jnp.bool_),
        (uhi[1:] != uhi[:-1]) | (j[1:] != j[:-1])]) & valid
    cnt_v = jnp.where(valid, cnt, 0)
    # per-(i, j) group total for every member: groups are contiguous, so
    # each element's group-start/group-end POSITIONS come from running
    # max/min over the boundary marks (positions are monotone — immune
    # to csum wraparound), and the total is the csum difference at those
    # two positions (uint32 modular — exact as long as each GROUP total
    # fits 32 bits)
    L = uhi.shape[0]
    iota = jnp.arange(L, dtype=jnp.int32)
    csum = jnp.cumsum(cnt_v.astype(jnp.uint32))
    gend = (jnp.concatenate([gstart[1:], jnp.zeros((1,), jnp.bool_)])
            & valid) | (valid & ~jnp.concatenate(
                [valid[1:], jnp.zeros((1,), jnp.bool_)]))
    start_pos = jax.lax.cummax(jnp.where(gstart, iota, 0))
    end_pos = jax.lax.cummin(jnp.where(gend, iota, L - 1), reverse=True)
    all_occ = (csum[end_pos]
               - jnp.where(start_pos > 0,
                           csum[jnp.maximum(start_pos - 1, 0)],
                           jnp.uint32(0))).astype(jnp.int32)
    if use_frac:
        ok_rel = cnt_v * den >= all_occ * num
    else:
        ok_rel = cnt_v.astype(jnp.float32) >= \
            rel * all_occ.astype(jnp.float32)
    keep = valid & (cnt_v >= min_cov) & ok_rel
    n_keep = jnp.sum(keep.astype(jnp.int32))
    # compaction: one stable payload sort moves kept rows (already in
    # (i, j, d) order) to the front — no argsort-permutation gathers
    front = jnp.where(keep, jnp.uint32(0), jnp.uint32(1))
    packed = (uhi << jnp.uint32(8)) | (ulo & jnp.uint32(0xFF))
    s_front, s_id, s_j, s_c = jax.lax.sort(
        (front, packed, j, cnt), num_keys=1, is_stable=True)
    L = uhi.shape[0]
    if L < out_capacity:
        pad = out_capacity - L
        s_id = jnp.concatenate([s_id, jnp.full(pad, jnp.uint32(_SENT))])
        s_j = jnp.concatenate([s_j, jnp.full(pad, jnp.uint32(_SENT))])
        s_c = jnp.concatenate([s_c, jnp.zeros(pad, cnt.dtype)])
    else:
        s_id, s_j, s_c = (s_id[:out_capacity], s_j[:out_capacity],
                          s_c[:out_capacity])
    is_e = jnp.arange(out_capacity, dtype=jnp.int32) < n_keep
    out_id = jnp.where(is_e, s_id, jnp.uint32(_SENT))
    out_j = jnp.where(is_e, s_j, jnp.uint32(_SENT))
    out_c = jnp.where(is_e, s_c, 0)
    return out_id, out_j, out_c, n_keep


@functools.partial(jax.jit, static_argnames=("use_frac",))
def _filter_keep_mask(seen, uhi, ulo, cnt, min_cov, num, den, rel,
                      *, use_frac: bool):
    """Phase A of the strip filter: the distance-consistency KEEP mask
    (same math as _filter_table_device) plus the endpoint flags of
    surviving edges scattered straight into `seen` — the unique-k-mer
    set never depends on edge materialization. No sort: scans and one
    masked scatter over the table. Returns (seen, keep, n_keep)."""
    valid = uhi != SENTINEL
    j = ulo >> jnp.uint32(8)
    gstart = jnp.concatenate([
        jnp.ones((1,), jnp.bool_),
        (uhi[1:] != uhi[:-1]) | (j[1:] != j[:-1])]) & valid
    cnt_v = jnp.where(valid, cnt, 0)
    csum = jnp.cumsum(cnt_v.astype(jnp.uint32))
    gend = (jnp.concatenate([gstart[1:], jnp.zeros((1,), jnp.bool_)])
            & valid) | (valid & ~jnp.concatenate(
                [valid[1:], jnp.zeros((1,), jnp.bool_)]))
    # group totals WITHOUT positional gathers (2x 67M random gathers
    # cost ~1.4s on-chip; two scans cost ~0.3s): csum is nondecreasing,
    # so the nearest marked value to the RIGHT is the reverse running
    # MIN over (gend ? csum : U32_MAX), and the nearest marked csum
    # STRICTLY LEFT of the group is the forward running MAX over
    # (gstart ? csum_prev : 0)
    csum_prev = jnp.concatenate(
        [jnp.zeros((1,), jnp.uint32), csum[:-1]])
    v_end = jax.lax.cummin(
        jnp.where(gend, csum, jnp.uint32(0xFFFFFFFF)), reverse=True)
    v_start = jax.lax.cummax(
        jnp.where(gstart, csum_prev, jnp.uint32(0)))
    all_occ = (v_end - v_start).astype(jnp.int32)
    if use_frac:
        ok_rel = cnt_v * den >= all_occ * num
    else:
        ok_rel = cnt_v.astype(jnp.float32) >= \
            rel * all_occ.astype(jnp.float32)
    keep = valid & (cnt_v >= min_cov) & ok_rel
    n_keep = jnp.sum(keep.astype(jnp.int32))
    j = ulo >> jnp.uint32(8)
    i_idx = jnp.where(keep, uhi, jnp.uint32(_SENT))
    j_idx = jnp.where(keep, j, jnp.uint32(_SENT))
    seen = seen.at[i_idx].max(jnp.uint8(1), mode="drop")
    seen = seen.at[j_idx].max(jnp.uint8(1), mode="drop")
    return seen, keep, n_keep


@functools.partial(jax.jit, static_argnames=("out_small",))
def _compact_edges_small(uhi, ulo, cnt, keep, n_keep, *,
                         out_small: int):
    """Phase B: compact up to `out_small` kept rows with ONE single-key
    uint32 sort ((dropped << 31) | iota — iota makes it order-preserving)
    plus a bounded gather, instead of a 4-array stable sort at full
    table capacity (~4s at 2^26 on-chip; this is ~0.3s). Exact whenever
    n_keep <= out_small; the caller falls back to the full-capacity
    compaction otherwise (production strips keep a few thousand edges —
    the fallback is for synthetic high-survival workloads)."""
    L = uhi.shape[0]
    os_ = min(out_small, L)
    iota = jnp.arange(L, dtype=jnp.uint32)
    skey = jnp.where(keep, iota, iota | jnp.uint32(1 << 31))
    perm = (jax.lax.sort(skey)[:os_]
            & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
    s_id = (uhi[perm] << jnp.uint32(8)) | (ulo[perm] & jnp.uint32(0xFF))
    s_j = ulo[perm] >> jnp.uint32(8)
    s_c = cnt[perm]
    is_e = jnp.arange(os_, dtype=jnp.int32) < n_keep
    return (jnp.where(is_e, s_id, jnp.uint32(_SENT)),
            jnp.where(is_e, s_j, jnp.uint32(_SENT)),
            jnp.where(is_e, s_c, 0))


def _rel_fraction(rel: float):
    """(num, den, exact) — an exact small-fraction representation of the
    rel threshold when one exists (the default 0.8 -> 4/5)."""
    from fractions import Fraction
    fr = Fraction(rel).limit_denominator(64)
    return fr.numerator, fr.denominator, float(fr) == float(rel)


def recruit_unique_kmers(
    clouds_tensor: np.ndarray,
    n_units: np.ndarray,
    rare_codes: np.ndarray,
    config: KmerRecruitmentConfig,
    *,
    capacity: Optional[int] = None,
    entry_chunk: Optional[int] = None,
    edge_capacity: int = 1 << 18,
    dedup_hint: int = 1,
    max_capacity: int = 1 << 27,
    mesh=None,
    return_edges: bool = True,
    out_small: Optional[int] = None,
) -> Tuple[np.ndarray, DistanceEdges]:
    """End-to-end: strip-swept distance table -> per-strip ON-DEVICE
    filter -> unique k-mer codes (sorted uint64) + surviving edges.
    The (i, j, d) count table is never materialized to the host — only
    the surviving edges cross the link (a few MB at production scale vs
    GBs for the table), packed to 12 bytes each. The unique-k-mer SET
    itself rides a separate on-device endpoint flag array (len(rare)
    bytes total readback), so `return_edges=False` skips the edge
    readback entirely for callers that only consume the k-mer set (the
    assembly path — the edge list is an artifact file, nothing more)."""
    if len(rare_codes) >= 1 << 24:
        raise ValueError(
            "rare k-mer table >= 2^24 entries overflows the packed pair key")
    if config.auto_min_coverage and config.min_coverage > 2:
        # Coverage-adaptive edge cutoff. The reference hard-codes
        # min_coverage=4 for its coverage-32 datasets (reference
        # distance_based_kmer_recruitment.py:131-149 and the exposed
        # --min-coverage flag, centroFlye.py:57-60); below ~16x UL the
        # expected count of a TRUE pair edge — (reads spanning both unit
        # copies) x survival^2 — drops under 4 and the whole stage
        # starves (measured: 401 unique k-mers / 26 placed reads of 525
        # at 9x). The d-consistency test (count/all >= 0.8) does not
        # depend on the cutoff, so one sweep at the floor cutoff 2
        # yields the exact edge set of EVERY cutoff in [2, min_coverage]
        # by host-side freq thresholding; pick the largest cutoff whose
        # unique-k-mer yield is not starved (>= auto_min_unique_frac of
        # the rare set — healthy runs sit far above, collapsed runs far
        # below).
        base = dataclasses.replace(config, auto_min_coverage=False,
                                   min_coverage=2)
        _, edges2 = recruit_unique_kmers(
            clouds_tensor, n_units, rare_codes, base, capacity=capacity,
            entry_chunk=entry_chunk, edge_capacity=edge_capacity,
            dedup_hint=dedup_hint, max_capacity=max_capacity, mesh=mesh,
            return_edges=True, out_small=out_small)
        n_rare = max(len(rare_codes), 1)
        for c in range(config.min_coverage, 1, -1):
            kept = edges2.freq >= c
            uidx = (np.unique(np.concatenate(
                [edges2.i[kept], edges2.j[kept]]))
                if kept.any() else np.empty(0, np.int64))
            if len(uidx) >= config.auto_min_unique_frac * n_rare:
                break
        if c < config.min_coverage and kept.any() \
                and config.auto_min_degree > 1:
            # endpoint-degree cleanup: at sub-reference cutoffs the edge
            # set admits chance co-occurrences of noise-minted rare
            # k-mers. A TRUE unique k-mer pairs with the unique k-mers
            # of ~2*max_distance other unit copies (tens of surviving
            # edges even at low coverage); a chance pair's endpoints are
            # nearly isolated (degree 1-2). Keeping only endpoints with
            # >= auto_min_degree incident edges removes the noise set
            # without touching the true one (measured at the 120u/10x
            # rung: placements rose and the assembly completed).
            deg = np.zeros(len(rare_codes), np.int64)
            np.add.at(deg, edges2.i[kept], 1)
            np.add.at(deg, edges2.j[kept], 1)
            good = deg >= config.auto_min_degree
            kept = kept & good[edges2.i] & good[edges2.j]
            uidx = (np.unique(np.concatenate(
                [edges2.i[kept], edges2.j[kept]]))
                if kept.any() else np.empty(0, np.int64))
        logger.info(
            "auto min_coverage: cutoff %d of [2, %d] (unique %d / rare %d"
            " = %.1f%%, edges %d)", c, config.min_coverage, len(uidx),
            n_rare, 100.0 * len(uidx) / n_rare, int(kept.sum()))
        edges = DistanceEdges(
            dist=edges2.dist[kept], i=edges2.i[kept], j=edges2.j[kept],
            freq=edges2.freq[kept], unique_kmer_indices=uidx,
            min_coverage_used=c)
        return np.sort(rare_codes[uidx]), edges
    num, den, exact = _rel_fraction(config.rel_threshold)
    import concurrent.futures as _cf
    futures = []
    seen = jnp.zeros(max(len(rare_codes), 1), jnp.uint8)
    if out_small is None:
        out_small = max(edge_capacity, 1 << 20)

    def materialize(oid, oj, oc, n_keep, fallback):
        nk = int(n_keep)          # device scalar sync, on this thread
        if nk == 0:
            return None
        if nk > oid.shape[0]:
            # small compaction truncated (synthetic high-survival
            # workloads) — re-run the exact full-size path on the
            # retained refs; production strips keep a few thousand
            # edges and never come here
            logger.info(
                "strip edges %d exceed fast-path bound %d — "
                "full compaction fallback", nk, oid.shape[0])
            oid, oj, oc = fallback(nk)
        oid_h = np.asarray(oid[:nk]).astype(np.int64)
        return (oid_h >> 8,
                np.asarray(oj[:nk]).astype(np.int64),
                oid_h & 0xFF,
                np.asarray(oc[:nk]).astype(np.int64))

    # edge readback (incl. the n_keep scalar sync) rides the
    # device->host link on a background thread while the NEXT strip's
    # host prep + device sweep proceed — the link, not compute, bounds
    # edge-heavy workloads. Throttled to 2 strips in flight so device
    # tables don't pile up in HBM.
    mc = jnp.int32(config.min_coverage)
    fnum, fden = jnp.int32(num), jnp.int32(den)
    frel = jnp.float32(config.rel_threshold)
    with _cf.ThreadPoolExecutor(max_workers=1) as ex:
        for uhi, ulo, cnt, n, cap in _strip_sweep(
                clouds_tensor, n_units, config,
                capacity=capacity, entry_chunk=entry_chunk,
                dedup_hint=dedup_hint, max_capacity=max_capacity,
                mesh=mesh, yield_raw=True):
            if n == 0:
                continue
            if cnt is None:
                # RAW strip: counts are run lengths of the sorted pair
                # stream; one fused count+filter+compact kernel
                seen, oid, oj, oc, n_keep = _count_filter_sorted(
                    seen, uhi, ulo, mc, fnum, fden, frel,
                    use_frac=exact, out_small=out_small)
                if return_edges:
                    def fb_raw(nk, _hi=uhi, _lo=ulo):
                        o1, o2, o3, _ = _compact_edges_full_sorted(
                            _hi, _lo, mc, fnum, fden, frel,
                            use_frac=exact)
                        return o1, o2, o3
                    futures.append(ex.submit(
                        materialize, oid, oj, oc, n_keep, fb_raw))
                    if len(futures) > 2:
                        futures[-3].result()
                continue
            # TABLE strip (multi-chunk / mesh / overflow-split paths):
            # phase A keep mask + endpoint flags (scans + one masked
            # scatter), phase B small compaction
            seen, keep, n_keep = _filter_keep_mask(
                seen, uhi, ulo, cnt, mc, fnum, fden, frel,
                use_frac=exact)
            if return_edges:
                oid, oj, oc = _compact_edges_small(
                    uhi, ulo, cnt, keep, n_keep, out_small=out_small)

                def fb_table(nk, _t=(uhi, ulo, cnt, cap)):
                    o1, o2, o3, _ = _filter_table_device(
                        _t[0], _t[1], _t[2], mc, fnum, fden, frel,
                        use_frac=exact,
                        out_capacity=max(_t[3], _next_pow2(nk)))
                    return o1, o2, o3
                futures.append(ex.submit(
                    materialize, oid, oj, oc, n_keep, fb_table))
                if len(futures) > 2:
                    futures[-3].result()
        parts = [p for p in (f.result() for f in futures)
                 if p is not None]
    uniq = np.flatnonzero(np.asarray(seen)).astype(np.int64)
    if not parts:
        e = np.empty(0, np.int64)
        edges = DistanceEdges(dist=np.empty(0, np.int32), i=e, j=e.copy(),
                              freq=e.copy(), unique_kmer_indices=uniq,
                              min_coverage_used=config.min_coverage)
        return rare_codes[edges.unique_kmer_indices], edges
    sel_i = np.concatenate([p[0] for p in parts])
    sel_j = np.concatenate([p[1] for p in parts])
    sel_d = np.concatenate([p[2] for p in parts])
    sel_c = np.concatenate([p[3] for p in parts])
    edges = DistanceEdges(dist=sel_d.astype(np.int32), i=sel_i, j=sel_j,
                          freq=sel_c, unique_kmer_indices=uniq,
                          min_coverage_used=config.min_coverage)
    unique_codes = rare_codes[edges.unique_kmer_indices]
    return np.sort(unique_codes), edges
