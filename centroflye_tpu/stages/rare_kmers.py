"""Rare k-mer recruitment (stage 1 of unique-k-mer selection).

Reference behavior (distance_based_kmer_recruitment.py:39-82): count k=19-mers
over each read's tandem alignment; a k-mer is discarded once it occurs more
than once within a read in more than max_nonuniq=3 reads; surviving k-mers
keep frequency = number of reads containing them; "rare" k-mers are those
with frequency in [bottom*coverage*survival_rate, top*coverage*survival_rate].

The reference's sequential dict accumulation is order-independent in its
final result (a k-mer survives iff |{reads with in-read freq > 1}| <=
max_nonuniq, with frequency |{reads containing it}|), which is exactly what
ops/kmers.count_read_kmer_stats computes by sort/segment-reduce — so this
stage is a batched device computation with an associative cross-batch merge
(and a psum-style cross-device merge in the sharded path).
"""

from __future__ import annotations

import functools
import logging
import time
from typing import Dict, Iterable, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger("centroflye_tpu")

from centroflye_tpu.config import KmerRecruitmentConfig
from centroflye_tpu.io.encoding import encode_batch, join_u64
from centroflye_tpu.ops.kmers import (
    pack_kmers, count_read_kmer_stats, merge_count_tables, table_to_numpy,
    SENTINEL,
)


def _iter_batches(seqs: Sequence[str], batch_rows: int, pad_to: int,
                  window_budget: int = 1 << 24):
    """Length-tiered batches: rows always batch_rows (empty-padded),
    columns the BATCH's own max length rounded up to a power of two
    (floored at pad_to). Reads are visited longest-first so each batch
    is length-homogeneous — padding waste is bounded by 2x instead of
    the max/mean ratio of the corpus (a rel2-like heavy-tailed mix has
    a ~150 kb max over a ~14 kb mean: global-max padding burns ~10x
    the device windows on every pass). Column dims are powers of two,
    so shape variety (and thus compile count) is log-bounded; the
    persistent compile cache amortizes them across runs. Yields
    (row_ids, codes, lens) — row_ids are ORIGINAL sequence indices
    (the length sort permutes visit order; k-mer read-counts are
    id-agnostic but callers tag rows by original position).

    Row count per batch adapts to the tier: each batch targets
    ~`window_budget` padded elements, so short-read tiers pack
    thousands of rows per batch instead of `batch_rows` (the floor).
    Per-batch dispatch cost (dozens of ops per batch) is paid once per
    batch, so a fixed small row count pays it ~10x more often than the
    data requires. Rows are powers of two, so
    (rows, cols) shape variety stays log-bounded."""
    order = sorted(range(len(seqs)), key=lambda i: -len(seqs[i]))
    b0 = 0
    while b0 < len(order):
        L0 = max(len(seqs[order[b0]]), 1)
        Lp = max(pad_to, 1 << int(np.ceil(np.log2(L0))))
        rows = max(batch_rows, 1 << max(0, int(np.log2(
            max(window_budget // Lp, 1)))))
        idx = order[b0:b0 + rows]
        chunk = [seqs[i] for i in idx]
        # rows were sized for the tier leader; keep the batch's own max
        # (later rows are shorter — never wider)
        L = max((len(s) for s in chunk), default=1)
        L = max(pad_to, 1 << int(np.ceil(np.log2(max(L, 1)))))
        ids = np.asarray(idx, np.int32)
        if len(chunk) < rows and len(order) > rows:
            ids = np.concatenate([
                ids, np.zeros(rows - len(chunk), np.int32)])
            chunk += [""] * (rows - len(chunk))
        codes, lens = encode_batch(chunk, max_len=L)
        yield ids, codes, lens
        b0 += rows


@jax.jit
def _stack2(a, b):
    return jnp.stack([a.astype(jnp.int32), b.astype(jnp.int32)], axis=1)


_HASH_BITS = 26
_HASH_MULT = 0x9E3779B1


def _occ_hash(hi, lo):
    return ((hi.astype(jnp.uint32) * jnp.uint32(_HASH_MULT))
            ^ lo.astype(jnp.uint32)) & jnp.uint32((1 << _HASH_BITS) - 1)


@functools.partial(jax.jit, static_argnames=("k",), donate_argnums=(0,))
def _occ_accumulate(table, codes, lens, *, k):
    """Pass A of the occurrence prefilter: scatter-add
    of every valid window's hashed k-mer into a direct-address count
    table (collisions merge counts — one-sided: counts only ever
    OVER-estimate, so thresholding later keeps a superset)."""
    hi, lo, _ = pack_kmers(codes, lens, k=k)
    valid = hi != SENTINEL
    h = jnp.where(valid, _occ_hash(hi, lo), 0).ravel()
    return table.at[h].add(
        jnp.where(valid, 1, 0).ravel().astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("k",))
def _occ_mask(table, codes, lens, min_occ, *, k):
    """Pass B: SENTINEL-mask windows whose hashed occurrence count is
    below min_occ (they cannot reach the rare band's floor: a k-mer's
    read count never exceeds its occurrence count, and hash collisions
    only inflate the estimate). Returns (hi, lo, n_keep)."""
    hi, lo, _ = pack_kmers(codes, lens, k=k)
    valid = hi != SENTINEL
    keep = valid & (table[_occ_hash(hi, lo)] >= min_occ)
    s = jnp.uint32(SENTINEL)
    return (jnp.where(keep, hi, s), jnp.where(keep, lo, s),
            jnp.sum(keep.astype(jnp.int32)))


def read_kmer_table(
    seqs: Sequence[str],
    k: int,
    *,
    batch_rows: int = 64,
    capacity: int | None = None,
    min_occurrences: int = 0,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(codes uint64, n_reads, n_multi) over all sequences: for each distinct
    k-mer, the number of sequences containing it and the number containing it
    more than once. Device-computed per batch, merged associatively; with a
    `mesh` (jax.sharding.Mesh), batch rows shard over the data axis and the
    per-shard tables merge with all_gather + fold over ICI
    (parallel/mesh.make_stats_count_step) — results are bit-identical to
    the single-device path.

    min_occurrences > 1 enables the OCCURRENCE PREFILTER (single-device
    path): a first device pass scatter-adds hashed window counts into a
    direct-address table, and the exact pass then drops windows whose
    (over-)estimated count is below the threshold. A k-mer's read count
    never exceeds its occurrence count and collisions only inflate the
    estimate, so every k-mer that could reach min_occurrences survives —
    the exact tables then hold ~the genome-side k-mers instead of every
    read-error artifact (a noisy corpus mints ~k novel k-mers per error,
    ~45M distinct at the 400-unit / 8%-noise shape; the prefilter is
    what keeps the rare stage off that blow-up). Dropped k-mers are
    exactly those with total occurrences < min_occurrences — callers
    must only use the output where that set is irrelevant (the rare
    band's floor guarantees it when min_occurrences <= ceil(bottom *
    coverage * survival))."""
    if not len(seqs):
        return (np.empty(0, np.uint64), np.empty(0, np.int64),
                np.empty(0, np.int64))
    total_windows = sum(max(0, len(s) - k + 1) for s in seqs)
    # distinct k-mers are bounded by total windows (noisy corpora really
    # do approach the bound: every read error mints ~k novel k-mers), so
    # the exact-sufficient global capacity is next_pow2(total_windows) —
    # but per-BATCH tables only need their own window count, and a
    # binary-counter merge forest keeps total merge cost
    # O(keys * log batches) instead of O(batches * global_capacity),
    # with every size a power of two (bounded compile variety, no
    # doubling recompiles on the hot path)
    max_capacity = capacity or (1 << max(
        8, int(np.ceil(np.log2(max(min(total_windows, 1 << 28), 2))))))

    def _pow2(x):
        return 1 << max(8, int(np.ceil(np.log2(max(int(x), 2)))))

    steps: Dict[int, object] = {}
    n_dev = 1
    if mesh is not None and mesh.devices.size > 1:
        n_dev = int(mesh.devices.size)
        batch_rows = -(-batch_rows // n_dev) * n_dev

    def get_step(cap):
        if cap not in steps:
            from centroflye_tpu.parallel.mesh import make_stats_count_step
            steps[cap] = make_stats_count_step(mesh, k, cap)
        return steps[cap]

    forest: Dict[int, tuple] = {}

    def shrink(t, n, cap):
        """Slice a sorted SENTINEL-padded table down to pow2(n): table
        capacities must track the REALIZED distinct count, not the sum
        of input capacities — without this, capacities accumulate up
        the merge chain to pow2(total windows) (2^28 at production
        shape) and the fold concat-sorts ~0.5G-row tables holding ~5M
        real keys (observed: 222s of 'fold' and an HBM OOM)."""
        new_cap = max(256, _pow2(max(n, 1)))
        if new_cap >= cap:
            return t, cap
        return (t[0][:new_cap], t[1][:new_cap], t[2][:new_cap],
                t[3]), new_cap

    def merge_pair(ta, cap_a, tb, cap_b):
        nonlocal max_capacity
        out = min(_pow2(cap_a + cap_b), max_capacity)
        while True:
            m = merge_count_tables(ta[0], ta[1], ta[2],
                                   tb[0], tb[1], tb[2], capacity=out)
            n = int(m[3])
            if out >= cap_a + cap_b or n <= out:
                t, cap = shrink((m[0], m[1], m[2], n), n, out)
                return (t[0], t[1], t[2], n), cap
            out *= 2
            if out > max_capacity:
                max_capacity = out

    def insert(t, cap):
        t, cap = shrink(t, t[3], cap)
        while cap in forest:
            other = forest.pop(cap)
            t, cap = merge_pair(other, cap, t, cap)
        forest[cap] = t

    # occurrence prefilter pass A (single-device path): hashed window
    # counts over the whole corpus, ON DEVICE (donated accumulator)
    t_start = time.perf_counter()
    occ_table = None
    if min_occurrences > 1 and n_dev == 1:
        occ_table = jnp.zeros((1 << _HASH_BITS,), jnp.int32)
        for _ids, codes, lens in _iter_batches(seqs, batch_rows, 256):
            occ_table = _occ_accumulate(occ_table, codes, lens, k=k)
        occ_table.block_until_ready()
    t_occ = time.perf_counter()

    for ids, codes, lens in _iter_batches(seqs, batch_rows, 256):
        rid_rows = ids[:, None]
        win_b = int(np.maximum(lens.astype(np.int64) - k + 1, 0).sum())
        masked = None
        if occ_table is not None:
            hi_m, lo_m, n_keep = _occ_mask(
                occ_table, codes, lens, jnp.int32(min_occurrences), k=k)
            win_b = int(n_keep)        # survivors bound the distinct count
            if win_b == 0:
                continue
            masked = (hi_m, lo_m)
        cap_b = min(_pow2(win_b), max_capacity)
        while True:
            if n_dev > 1:
                from centroflye_tpu.parallel.mesh import pad_rows
                codes_p = pad_rows(codes, n_dev, 4)
                lens_p = pad_rows(lens, n_dev, 0)
                rid_p = pad_rows(rid_rows, n_dev, 0)
                uhi, ulo, cnt2, n = get_step(cap_b)(codes_p, lens_p, rid_p)
            else:
                if masked is not None:
                    hi, lo = masked
                else:
                    hi, lo, _ = pack_kmers(codes, lens, k=k)
                rid = np.broadcast_to(rid_rows, tuple(hi.shape))
                uhi, ulo, n_reads, n_multi, n = count_read_kmer_stats(
                    hi, lo, np.ascontiguousarray(rid), capacity=cap_b)
                cnt2 = _stack2(n_reads, n_multi)
            if cap_b >= win_b or int(n) <= cap_b:
                break
            cap_b *= 2
        # tables stay ON DEVICE across the sweep — only run-count scalars
        # sync (materializing capacity-sized tables per batch moves
        # ~100MB each way through the host link)
        insert((uhi, ulo, cnt2, int(n)), cap_b)

    if not forest:
        return (np.empty(0, np.uint64), np.empty(0, np.int64),
                np.empty(0, np.int64))
    t_count = time.perf_counter()
    acc, acc_cap = None, 0
    for cap in sorted(forest):
        if acc is None:
            acc, acc_cap = forest[cap], cap
        else:
            acc, acc_cap = merge_pair(acc, acc_cap, forest[cap], cap)
    uhi, ulo, cnt, n = acc
    codes_u64, counts = table_to_numpy(uhi, ulo, cnt, n)
    logger.info(
        "read_kmer_table phases: occ-prefilter %.1fs, count+merge %.1fs, "
        "fold+readback %.1fs (%d distinct)",
        t_occ - t_start, t_count - t_occ, time.perf_counter() - t_count,
        len(codes_u64))
    return codes_u64, counts[:, 0].astype(np.int64), \
        counts[:, 1].astype(np.int64)


def get_rare_kmers(
    seqs: Sequence[str],
    config: KmerRecruitmentConfig,
    coverage: int,
    *,
    batch_rows: int = 64,
    mesh=None,
) -> np.ndarray:
    """Sorted uint64 codes of rare k-mers (reference
    distance_based_kmer_recruitment.py:66-82 semantics, including the float
    band [bottom*coverage*survival, top*coverage*survival]).

    The band floor doubles as the occurrence-prefilter threshold: a
    k-mer with total occurrences below ceil(floor) can never reach
    n_reads >= floor, so dropping it early cannot change the rare set
    (read_kmer_table's min_occurrences contract)."""
    left = config.bottom * coverage * config.kmer_survival_rate
    right = config.top * coverage * config.kmer_survival_rate
    min_occ = int(np.ceil(left))
    codes, n_reads, n_multi = read_kmer_table(
        seqs, config.k, batch_rows=batch_rows,
        min_occurrences=min_occ, mesh=mesh)
    survive = n_multi <= config.max_nonuniq
    rare = survive & (n_reads >= left) & (n_reads <= right)
    return codes[rare]
