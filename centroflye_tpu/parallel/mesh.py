"""Multi-device execution: mesh construction + sharded pipeline steps.

The reference's entire parallel inventory is process fan-out over read
chunks with `cat` as the reduction (reference run_read_recruitment.sh:35-44,
run_ncrf_parallel.py:39-73). The design: read batches are data-parallel
over a 1-D `jax.sharding.Mesh` axis ("reads"); the unit index (Peq tables,
contig bitmaps) is replicated; per-shard k-mer count tables are merged with
an all_gather followed by a redundant-per-device associative fold
(the sort-based merge is not an elementwise psum, but it is associative, so
the collective pattern is gather + fold); recruitment needs no communication
at all. The mesh is 1-D and follows the algorithm alone: every card of a
GPU host reaches every other over NVLink at the same rate. Scaling to
several hosts is the same program — the mesh spans all processes'
devices and batches arrive host-sharded (parallel/distributed.py).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from centroflye_tpu.ops.myers import myers_distance_batch
from centroflye_tpu.ops.kmers import pack_kmers, count_unique

DATA_AXIS = "reads"


def make_mesh(n_devices: int = 0, axis: str = DATA_AXIS) -> Mesh:
    devices = jax.devices()
    if n_devices:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def auto_mesh(min_devices: int = 2) -> Optional[Mesh]:
    """Mesh over all local devices when more than one is present — the
    production pipeline's switch between single-device and sharded
    steps."""
    if jax.device_count() < min_devices:
        return None
    return make_mesh()


def pad_rows(arr: np.ndarray, multiple: int, fill) -> np.ndarray:
    """Pad axis 0 to a multiple (shard_map needs equal per-device rows)."""
    r = arr.shape[0]
    target = -(-max(r, 1) // multiple) * multiple
    if target == r:
        return arr
    pad = np.full((target - r,) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def shard_batch(mesh: Mesh, codes: np.ndarray, lens: np.ndarray):
    """Place a (B, L) batch row-sharded over the mesh data axis."""
    sh = NamedSharding(mesh, P(DATA_AXIS, None))
    sh1 = NamedSharding(mesh, P(DATA_AXIS))
    return jax.device_put(codes, sh), jax.device_put(lens, sh1)


def make_recruitment_step(mesh: Mesh, m: int):
    """Sharded recruitment distances: batch rows split over the data axis,
    Peq tables replicated; embarrassingly parallel (no collectives), XLA
    partitions the Myers scan by batch."""

    @functools.partial(
        jax.jit,
        in_shardings=(NamedSharding(mesh, P(None, None)),
                      NamedSharding(mesh, P(None, None)),
                      NamedSharding(mesh, P(DATA_AXIS, None)),
                      NamedSharding(mesh, P(DATA_AXIS))),
        out_shardings=(NamedSharding(mesh, P(DATA_AXIS)),
                       NamedSharding(mesh, P(DATA_AXIS))))
    def step(peq_fwd, peq_rc, codes, lens):
        df = myers_distance_batch(peq_fwd, codes, lens, m=m, mode="HW")
        dr = myers_distance_batch(peq_rc, codes, lens, m=m, mode="HW")
        return df["dist"], dr["dist"]

    return step


def make_perrow_myers_step(mesh: Mesh, m: int, mode: str,
                           collect: str = "best"):
    """Sharded per-row-query Myers batch (the monomer decomposition
    step's device call, mono/string_decomposer.py): rows = read x monomer
    combinations, each with its own Peq table and query length, split over
    the data axis; embarrassingly parallel like recruitment. The role of
    StringDecomposer's thread fan-out (reference README.md:184-196, ~9h on
    50 threads for cen6) over the mesh's devices instead."""

    @functools.partial(
        jax.jit,
        in_shardings=(NamedSharding(mesh, P(DATA_AXIS, None, None)),
                      NamedSharding(mesh, P(DATA_AXIS, None)),
                      NamedSharding(mesh, P(DATA_AXIS)),
                      NamedSharding(mesh, P(DATA_AXIS))))
    def step(peqs, texts, tlens, ms):
        return myers_distance_batch(
            peqs, texts, tlens, m=m, mode=mode, ms=ms, collect=collect)

    return step


def make_kmer_count_step(mesh: Mesh, k: int, capacity: int):
    """Sharded exact k-mer counting: per-shard sort/segment-reduce tables,
    merged across the mesh with an all_gather + associative fold (each
    device folds the full gathered set — the standard redundant-allreduce
    pattern for non-elementwise monoids)."""
    from jax import shard_map
    from centroflye_tpu.ops.kmers import merge_count_tables

    n_dev = mesh.devices.size

    def local(codes, lens):
        hi, lo, _ = pack_kmers(codes, lens, k=k)
        return count_unique(hi.ravel(), lo.ravel(), capacity=capacity)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS)),
        out_specs=(P(), P(), P(), P()), check_vma=False)
    def step(codes, lens):
        uhi, ulo, cnt, n = local(codes, lens)
        # gather all shards' tables, fold locally (identical on
        # every device -> replicated output)
        g_uhi = jax.lax.all_gather(uhi, DATA_AXIS)     # (n_dev, cap)
        g_ulo = jax.lax.all_gather(ulo, DATA_AXIS)
        g_cnt = jax.lax.all_gather(cnt, DATA_AXIS)
        g_n = jax.lax.all_gather(n, DATA_AXIS)
        acc = (g_uhi[0], g_ulo[0], g_cnt[0], g_n[0])
        for i in range(1, n_dev):
            acc = merge_count_tables(acc[0], acc[1], acc[2], g_uhi[i],
                                     g_ulo[i], g_cnt[i], capacity=capacity)
        return acc

    return jax.jit(step)


def make_stats_count_step(mesh: Mesh, k: int, capacity: int):
    """Sharded per-read k-mer statistics (the rare-k-mer stage's device
    step, stages/rare_kmers.py): rows (reads) split over the data axis,
    per-shard (code -> n_reads, n_multi) tables built locally, merged with
    all_gather + associative fold. Reads are disjoint across
    shards, so the two counters add exactly."""
    from jax import shard_map
    from centroflye_tpu.ops.kmers import (
        count_read_kmer_stats, merge_count_tables)

    n_dev = mesh.devices.size

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS, None)),
        out_specs=(P(), P(), P(), P()), check_vma=False)
    def step(codes, lens, rid):
        hi, lo, _ = pack_kmers(codes, lens, k=k)
        uhi, ulo, n_reads, n_multi, n = count_read_kmer_stats(
            hi, lo, jnp.broadcast_to(rid, hi.shape), capacity=capacity)
        cnt = jnp.stack([n_reads, n_multi], axis=1)
        g_uhi = jax.lax.all_gather(uhi, DATA_AXIS)
        g_ulo = jax.lax.all_gather(ulo, DATA_AXIS)
        g_cnt = jax.lax.all_gather(cnt, DATA_AXIS)
        acc = (g_uhi[0], g_ulo[0], g_cnt[0], n)
        for i in range(1, n_dev):
            acc = merge_count_tables(acc[0], acc[1], acc[2], g_uhi[i],
                                     g_ulo[i], g_cnt[i], capacity=capacity)
        return acc

    return jax.jit(step)


def make_pair_bucket_step(mesh: Mesh, *, chunk: int, capacity: int):
    """Sharded distance-pair counting (the unique-k-mer stage's device
    step, stages/distance_graph.py): the chunk's flat pair range splits
    over the data axis (each shard enumerates its consecutive sub-range
    of pair indices from the replicated bucket list), the flat cloud
    array is replicated, and per-shard (i, j, d) -> count tables merge
    with all_gather + fold — the device redesign of the
    reference's 9h serial dict loop (reference
    distance_based_kmer_recruitment.py:85-128)."""
    from jax import shard_map
    from centroflye_tpu.ops.kmers import merge_count_tables
    from centroflye_tpu.stages.distance_graph import (
        _pairs_from_buckets_core)

    n_dev = int(mesh.devices.size)
    assert chunk % n_dev == 0, (chunk, n_dev)
    local = chunk // n_dev

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P(), P()),
        out_specs=(P(), P(), P(), P()), check_vma=False)
    def step(flat, starts, const_vals, base_iter, a_const, dvals,
             c0, total):
        idx = jax.lax.axis_index(DATA_AXIS).astype(jnp.int32)
        uhi, ulo, cnt, n = _pairs_from_buckets_core(
            flat, starts, const_vals, base_iter, a_const, dvals,
            c0 + idx * jnp.int32(local), total,
            chunk=local, capacity=capacity)
        g_uhi = jax.lax.all_gather(uhi, DATA_AXIS)
        g_ulo = jax.lax.all_gather(ulo, DATA_AXIS)
        g_cnt = jax.lax.all_gather(cnt, DATA_AXIS)
        g_n = jax.lax.all_gather(n, DATA_AXIS)
        acc = (g_uhi[0], g_ulo[0], g_cnt[0], g_n[0])
        for i in range(1, n_dev):
            acc = merge_count_tables(acc[0], acc[1], acc[2], g_uhi[i],
                                     g_ulo[i], g_cnt[i], capacity=capacity)
        return acc

    return jax.jit(step)


def make_placement_score_step(mesh: Mesh):
    """Sharded placement scoring + global greedy argmax: read bitmaps are
    sharded over the data axis, the contig bitmap is replicated; the
    per-iteration winner is a global argmax over (score0, score1, pos)
    computed shard-locally and reduced across devices (the pmax
    pattern)."""
    from jax import shard_map
    from centroflye_tpu.ops.scoring import placement_scores

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(DATA_AXIS, None, None), P(None, None)),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None), P()),
        check_vma=False)
    def step(read_bitmaps, contig_bitmap):
        s0, s1 = placement_scores(read_bitmaps, contig_bitmap)
        # global lexicographic argmax of (s0, s1) over all shards: pmax on
        # s0, then pmax on s1 restricted to rows achieving the s0 max
        m0 = jax.lax.pmax(jnp.max(s0), DATA_AXIS)
        m1 = jax.lax.pmax(jnp.max(jnp.where(s0 == m0, s1, -1)), DATA_AXIS)
        best = jnp.stack([m0, m1])
        return s0, s1, best

    return jax.jit(step)
