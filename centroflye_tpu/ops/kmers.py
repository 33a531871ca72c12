"""Device k-mer primitives: packing, sorting, exact counting.

The reference counts k-mers in Python dicts keyed by k-mer strings — the
9h/800GB bottleneck (reference distance_based_kmer_recruitment.py:39-63
get_kmer_freqs_from_ncrf_report, :85-128 get_kmer_dist_map). The device design
replaces every dict with sort/segment-reduce over 2-bit-packed integer codes:

- a k-mer (k <= 31) is a big-endian 2-bit code carried as an (hi, lo) uint32
  pair (JAX x64 stays disabled; multi-key ``lax.sort`` gives exact
  lexicographic = numeric order);
- counting = sort + run-boundary detection + segmented reduction, all with
  static shapes (invalid slots ride a sentinel key that sorts last);
- tables of unique k-mers are fixed-capacity (hi, lo, counts..., n) tuples,
  mergeable associatively — the cross-device reduction is a concat + resort
  (per-shard tables merged via all_gather, see parallel/).

Everything here is exact — no hashing tricks — so outputs are bit-for-bit
comparable to the reference's dict counting.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

SENTINEL = jnp.uint32(0xFFFFFFFF)


@functools.partial(jax.jit, static_argnames=("k",))
def pack_kmers(codes: jnp.ndarray, lens: jnp.ndarray, *, k: int):
    """All k-mer windows of a padded batch of base codes.

    Args:
      codes: (B, L) int8 base codes (0..3; >=4 is N/PAD).
      lens: (B,) int32 sequence lengths.
      k: k-mer length, 2 <= k <= 31.

    Returns:
      (hi, lo, valid): each (B, L-k+1); valid marks windows fully inside the
      sequence and free of N/PAD. Invalid windows have code SENTINEL pair.
    """
    B, L = codes.shape
    nwin = L - k + 1
    ok = codes < 4
    vals = jnp.where(ok, codes, 0).astype(jnp.uint32)
    hi = jnp.zeros((B, nwin), jnp.uint32)
    lo = jnp.zeros((B, nwin), jnp.uint32)
    for i in range(k):
        v = jax.lax.dynamic_slice_in_dim(vals, i, nwin, axis=1)
        s = 2 * (k - 1 - i)
        if s >= 32:
            hi = hi | (v << jnp.uint32(s - 32))
        else:
            lo = lo | (v << jnp.uint32(s))
    # valid: all k bases ok and window end within len
    bad = (~ok).astype(jnp.int32)
    cs = jnp.cumsum(bad, axis=1)
    cs = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), cs], axis=1)
    clean = (cs[:, k:] - cs[:, :-k]) == 0
    pos = jnp.arange(nwin, dtype=jnp.int32)[None, :]
    inside = pos + k <= lens[:, None]
    valid = clean & inside
    hi = jnp.where(valid, hi, SENTINEL)
    lo = jnp.where(valid, lo, SENTINEL)
    return hi, lo, valid


def sort_by_code(hi, lo, *payloads):
    """Sort flat arrays lexicographically by (hi, lo); payloads ride along."""
    ops = (hi, lo) + tuple(payloads)
    return jax.lax.sort(ops, num_keys=2)


def _run_starts(hi, lo):
    """Boolean marks of the first element of each equal-(hi,lo) run in a
    sorted flat array."""
    prev_ne = jnp.concatenate([
        jnp.ones((1,), jnp.bool_),
        (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1]),
    ])
    return prev_ne


def _compact_runs(hi, lo, starts_v, csums, capacity: int):
    """Compact the runs of a sorted (hi, lo) array into a fixed-capacity
    table WITHOUT random gathers or scatters: run-START rows move to the
    front by one stable sort carrying (hi, lo, exclusive-csum) payloads,
    run-END rows by a second stable sort carrying the inclusive csums —
    runs are ordered, so the k-th run's start and end land at the SAME
    compacted slot k, and each per-run sum is a row-wise difference of
    the two sorted csum planes. Payloads riding a sort cost ~0.1s per
    33M elements on-chip vs ~0.7s per argsort-permutation gather. csums
    are uint32 prefix sums over the sorted elements; modular uint32
    subtraction keeps the boundary differences exact even when the
    GLOBAL total overflows 32 bits (only per-run sums must fit). Valid
    entries are contiguous at the front (any valid hi < SENTINEL sorts
    before the sentinel pad).

    Returns (uhi, ulo, [per-run sums...], n_runs)."""
    n = jnp.sum(starts_v.astype(jnp.int32))
    # run ends: the element before the next run start; the final VALID
    # element ends the last run (invalid elements are all-sentinel pad
    # behind the valid prefix and form no runs)
    valid = hi != SENTINEL
    next_start = jnp.concatenate(
        [starts_v[1:], jnp.zeros((1,), jnp.bool_)])
    last_valid = valid & ~jnp.concatenate(
        [valid[1:], jnp.zeros((1,), jnp.bool_)])
    ends_v = (next_start & valid) | last_valid
    prevs = tuple(jnp.concatenate(
        [jnp.zeros((1,), csum.dtype), csum[:-1]]) for csum in csums)
    key_s = jnp.where(starts_v, jnp.uint32(0), jnp.uint32(1))
    ops_s = jax.lax.sort((key_s, hi, lo) + prevs,
                         num_keys=1, is_stable=True)
    key_e = jnp.where(ends_v, jnp.uint32(0), jnp.uint32(1))
    ops_e = jax.lax.sort((key_e,) + tuple(csums),
                         num_keys=1, is_stable=True)
    s_hi, s_lo = ops_s[1], ops_s[2]
    s_sums = tuple((e - s).astype(jnp.int32)
                   for s, e in zip(ops_s[3:], ops_e[1:]))
    L = hi.shape[0]
    if L < capacity:
        pad = capacity - L
        s_hi = jnp.concatenate([s_hi, jnp.full(pad, SENTINEL)])
        s_lo = jnp.concatenate([s_lo, jnp.full(pad, SENTINEL)])
        s_sums = tuple(jnp.concatenate(
            [s, jnp.zeros(pad, jnp.int32)]) for s in s_sums)
    else:
        s_hi = s_hi[:capacity]
        s_lo = s_lo[:capacity]
        s_sums = tuple(s[:capacity] for s in s_sums)
    k = jnp.arange(capacity, dtype=jnp.int32)
    is_run = k < n
    uhi = jnp.where(is_run, s_hi, SENTINEL)
    ulo = jnp.where(is_run, s_lo, SENTINEL)
    sums = [jnp.where(is_run, s, 0) for s in s_sums]
    return uhi, ulo, sums, n


@functools.partial(jax.jit, static_argnames=("capacity",))
def count_unique(hi, lo, *, capacity: int):
    """Unique codes + multiplicities of a flat code array.

    Invalid entries must already carry the SENTINEL pair. Returns
    (uhi, ulo, counts) of length `capacity`, sorted ascending, padded with
    SENTINEL/0 rows, plus n_unique (int32 scalar).
    """
    hi, lo = sort_by_code(hi.ravel(), lo.ravel())
    valid = hi != SENTINEL
    starts_v = _run_starts(hi, lo) & valid
    csum = jnp.cumsum(valid.astype(jnp.uint32))
    uhi, ulo, (counts,), n = _compact_runs(hi, lo, starts_v, [csum],
                                           capacity)
    return uhi, ulo, counts, n


@functools.partial(jax.jit, static_argnames=("capacity",))
def count_read_kmer_stats(hi, lo, read_ids, *, capacity: int):
    """Per-unique-k-mer read statistics for rare-k-mer recruitment.

    For each distinct k-mer code across a flat batch of (code, read_id)
    pairs (invalid = SENTINEL code), computes:
      n_reads:  number of distinct reads containing the k-mer
      n_multi:  number of distinct reads containing it more than once

    This reproduces, order-independently, the reference's sequential
    accumulation (reference distance_based_kmer_recruitment.py:44-63): a
    k-mer survives iff n_multi <= max_nonuniq, and its surviving frequency
    equals n_reads (the +=1-per-read count).

    Returns (uhi, ulo, n_reads, n_multi) each length `capacity`, sorted,
    SENTINEL-padded, plus n_unique.
    """
    hi = hi.ravel()
    lo = lo.ravel()
    read_ids = read_ids.ravel().astype(jnp.int32)
    # sort by (code, read)
    hi, lo, rid = jax.lax.sort((hi, lo, read_ids), num_keys=3)
    valid = hi != SENTINEL
    code_start = _run_starts(hi, lo)
    pair_start = code_start | jnp.concatenate([
        jnp.ones((1,), jnp.bool_), rid[1:] != rid[:-1]])
    # third-of-a-kind detector: an element is the 2nd of its (code, read)
    # pair iff not pair_start and previous is pair_start
    prev_pair_start = jnp.concatenate(
        [jnp.zeros((1,), jnp.bool_), pair_start[:-1]])
    second_of_pair = (~pair_start) & prev_pair_start

    code_start_v = code_start & valid
    cs_reads = jnp.cumsum((pair_start & valid).astype(jnp.uint32))
    cs_multi = jnp.cumsum((second_of_pair & valid).astype(jnp.uint32))
    uhi, ulo, (n_reads, n_multi), n = _compact_runs(
        hi, lo, code_start_v, [cs_reads, cs_multi], capacity)
    return uhi, ulo, n_reads, n_multi, n


@functools.partial(jax.jit, static_argnames=("capacity",))
def merge_count_tables(uhi_a, ulo_a, counts_a, uhi_b, ulo_b, counts_b,
                       *, capacity: int):
    """Merge two sorted SENTINEL-padded (code -> counts) tables by summing
    counts of equal codes. counts_* may be 1-D (n,) or 2-D (n, C) with C
    parallel counters. Associative + commutative, so usable as a psum-style
    tree reduction across shards."""
    hi = jnp.concatenate([uhi_a, uhi_b])
    lo = jnp.concatenate([ulo_a, ulo_b])
    squeeze = counts_a.ndim == 1
    ca = counts_a[:, None] if squeeze else counts_a
    cb = counts_b[:, None] if squeeze else counts_b
    cnt = jnp.concatenate([ca, cb], axis=0)
    order = (hi, lo) + tuple(cnt[:, i] for i in range(cnt.shape[1]))
    sorted_ops = jax.lax.sort(order, num_keys=2)
    hi, lo = sorted_ops[0], sorted_ops[1]
    valid = hi != SENTINEL
    starts_v = _run_starts(hi, lo) & valid
    csums = [jnp.cumsum(jnp.where(valid, c, 0).astype(jnp.uint32))
             for c in sorted_ops[2:]]
    uhi, ulo, sums, n = _compact_runs(hi, lo, starts_v, csums, capacity)
    summed = jnp.stack(sums, axis=1)
    if squeeze:
        summed = summed[:, 0]
    return uhi, ulo, summed, n


@functools.partial(jax.jit, static_argnames=())
def lookup_codes(table_hi, table_lo, hi, lo):
    """Binary-search membership of (hi, lo) codes in a sorted SENTINEL-padded
    table. Returns (found bool, index int32) per query (index valid only
    where found)."""
    n = table_hi.shape[0]
    # combine into monotone order comparisons via two-level compare
    def le(thi, tlo, qhi, qlo):
        return (thi < qhi) | ((thi == qhi) & (tlo <= qlo))

    lo_i = jnp.zeros(hi.shape, jnp.int32)
    hi_i = jnp.full(hi.shape, n, jnp.int32)
    # branchless binary search: ceil(log2(n)) iterations
    steps = max(1, int(np.ceil(np.log2(max(n, 2)))))
    for _ in range(steps):
        mid = (lo_i + hi_i) // 2
        t_hi = table_hi[mid]
        t_lo = table_lo[mid]
        go_right = le(t_hi, t_lo, hi, lo)
        lo_i = jnp.where(go_right, mid + 1, lo_i)
        hi_i = jnp.where(go_right, hi_i, mid)
    idx = jnp.maximum(lo_i - 1, 0)
    found = (table_hi[idx] == hi) & (table_lo[idx] == lo) & (hi != SENTINEL)
    return found, idx


# ---------------------------------------------------------------------------
# host-side helpers


def table_to_numpy(uhi, ulo, counts, n):
    """Device table -> (codes uint64[n], counts[n]) numpy arrays."""
    n = int(n)
    # widen on the HOST: asking jax for uint64 under disabled x64 emits a
    # truncation warning (values are uint32 so widening is lossless)
    uhi = np.asarray(uhi[:n]).astype(np.uint64)
    ulo = np.asarray(ulo[:n]).astype(np.uint64)
    return (uhi << np.uint64(32)) | ulo, np.asarray(counts[:n])
