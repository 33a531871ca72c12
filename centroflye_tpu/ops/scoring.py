"""Device placement scoring: bitmap popcount correlation.

The reference scores a read against the cloud contig with Python set
intersections per (offset, unit) pair (reference cloud_contig.py:46-76) or
an incremental dict-of-Counters index (:87-95). The device formulation:
k-mer sets become BITMAPS over the unique-k-mer index space (W = ceil(n/32)
uint32 lanes), and the score of read r at offset o is a sliding bitwise
correlation

    score1[r, o] = sum_t popcount(read[r, t] & contig[o + t])
    score0[r, o] = sum_t [popcount(read[r, t] & contig[o + t]) > 0]

— a lax.scan over unit index t of vector AND+popcount ops on (R, P, W)
tiles.
This replaces the slow validation scorer at scale (map_reads) and provides
the initial bulk scoring for the greedy placement loop (the argmax itself
stays exact and sequential).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def clouds_to_bitmaps(clouds_tensor: np.ndarray, n_kmers: int) -> np.ndarray:
    """(R, T, K) padded index tensor -> (R, T, W) uint32 bitmaps."""
    R, T, K = clouds_tensor.shape
    W = max(1, -(-n_kmers // 32))
    out = np.zeros((R, T, W), dtype=np.uint32)
    idx = clouds_tensor
    r, t, k = np.nonzero(idx >= 0)
    v = idx[r, t, k]
    np.bitwise_or.at(out, (r, t, v // 32),
                     np.uint32(1) << (v % 32).astype(np.uint32))
    return out


def contig_to_bitmap(freq_clouds: Dict[int, set], max_pos: int,
                     n_kmers: int) -> np.ndarray:
    """CloudContig.freq_clouds -> (max_pos+1, W) uint32 bitmap."""
    W = max(1, -(-n_kmers // 32))
    out = np.zeros((max_pos + 1, W), dtype=np.uint32)
    for pos, kmers in freq_clouds.items():
        if pos > max_pos:
            continue
        for v in kmers:
            out[pos, v // 32] |= np.uint32(1) << np.uint32(v % 32)
    return out


@functools.partial(jax.jit, static_argnames=())
def placement_scores(read_bitmaps: jnp.ndarray,
                     contig_bitmap: jnp.ndarray) -> Tuple[jnp.ndarray,
                                                          jnp.ndarray]:
    """All-offset placement scores.

    Args:
      read_bitmaps: (R, T, W) uint32.
      contig_bitmap: (P, W) uint32 (position 0..P-1 frequent-k-mer sets).

    Returns:
      (score0, score1): each (R, P) int32; offset o scores the read's unit t
      against contig position o + t (positions beyond P contribute nothing).
    """
    R, T, W = read_bitmaps.shape
    P = contig_bitmap.shape[0]
    pad = jnp.zeros((T, W), jnp.uint32)
    contig_pad = jnp.concatenate([contig_bitmap, pad], axis=0)  # (P+T, W)

    def body(carry, t):
        s0, s1 = carry
        window = jax.lax.dynamic_slice_in_dim(contig_pad, t, P, axis=0)
        inter = read_bitmaps[:, t, None, :] & window[None, :, :]
        pc = jax.lax.population_count(inter).astype(jnp.int32)
        cnt = jnp.sum(pc, axis=-1)              # (R, P)
        s1 = s1 + cnt
        s0 = s0 + (cnt > 0).astype(jnp.int32)
        return (s0, s1), None

    init = (jnp.zeros((R, P), jnp.int32), jnp.zeros((R, P), jnp.int32))
    (s0, s1), _ = jax.lax.scan(body, init,
                               jnp.arange(T, dtype=jnp.int32))
    return s0, s1


@functools.partial(jax.jit, static_argnames=("n_kmers", "n_pos"))
def placement_scores_matmul(clouds_tensor: jnp.ndarray,
                            contig_kmer: jnp.ndarray,
                            contig_pos: jnp.ndarray,
                            n_kmers: int, n_pos: int
                            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """All-offset placement scores as one matrix product.

    The popcount correlation above costs R*P*T*W word ops. The
    same counts are one big matmul: with A[(r,t), v] the one-hot cloud
    membership and B[v, p] the one-hot contig pair table,
    C = A @ B gives C[(r,t), p] = |cloud(r,t) & contig(p)|, and the
    offset scores are the shifted-diagonal reductions
        score1[r, o] = sum_t C[r, t, o + t]
        score0[r, o] = sum_t [C[r, t, o + t] > 0].
    bf16 operands are exact (0/1 values) and the f32 accumulation is
    exact below 2^24, so counts are bit-identical to the popcount path.

    Args:
      clouds_tensor: (R, T, K) int32 padded k-mer indices (-1 = pad;
        indices unique within a cloud).
      contig_kmer / contig_pos: flat (kmer, position) pairs of the contig
        table (unique pairs; positions >= n_pos are ignored).
      n_kmers: vocabulary size V (static).
      n_pos: number of contig positions P (static).

    Returns:
      (score0, score1): each (R, n_pos) int32.
    """
    R, T, K = clouds_tensor.shape
    P = n_pos
    flat = clouds_tensor.reshape(R * T, K)
    ok = flat >= 0
    A = jnp.zeros((R * T, n_kmers), jnp.bfloat16)
    A = A.at[jnp.arange(R * T)[:, None], jnp.where(ok, flat, 0)].add(
        ok.astype(jnp.bfloat16), mode="drop")
    pos_ok = contig_pos < P
    B = jnp.zeros((n_kmers, P + T), jnp.bfloat16)
    B = B.at[contig_kmer, jnp.where(pos_ok, contig_pos, P + T)].add(
        pos_ok.astype(jnp.bfloat16), mode="drop")
    C = jnp.dot(A, B, preferred_element_type=jnp.float32)
    C = C.reshape(R, T, P + T)

    def body(carry, t):
        s0, s1 = carry
        ct = jax.lax.dynamic_slice_in_dim(C, t, 1, axis=1)[:, 0]
        win = jax.lax.dynamic_slice_in_dim(ct, t, P, axis=1)
        cnt = win.astype(jnp.int32)
        return (s0 + (cnt > 0).astype(jnp.int32), s1 + cnt), None

    init = (jnp.zeros((R, P), jnp.int32), jnp.zeros((R, P), jnp.int32))
    (s0, s1), _ = jax.lax.scan(body, init,
                               jnp.arange(T, dtype=jnp.int32))
    return s0, s1


def device_map_reads(clouds_tensor: np.ndarray, n_units: np.ndarray,
                     freq_clouds: Dict[int, set], max_pos: int,
                     n_kmers: int, threshold=(5, 10),
                     n_contig_clouds: int | None = None):
    """Device re-mapping of all reads against a built contig — the scaled
    replacement for the reference's map_reads validation pass
    (cloud_contig.py:98-114). Placement rule mirrors map_reads_fast:
    require pos + n_units <= len(contig clouds); score must meet the
    thresholds; rightmost best offset wins.

    Returns {row_index: (pos, score0, score1)}.
    """
    read_bm = clouds_to_bitmaps(clouds_tensor, n_kmers)
    contig_bm = contig_to_bitmap(freq_clouds, max_pos, n_kmers)
    s0, s1 = placement_scores(read_bm, contig_bm)
    s0 = np.asarray(s0)
    s1 = np.asarray(s1)
    R, P = s0.shape
    limit = n_contig_clouds if n_contig_clouds is not None else max_pos + 1
    out = {}
    for r in range(R):
        best = (0, 0)
        best_pos = None
        for pos in range(P):
            if pos + int(n_units[r]) > limit:
                continue
            sc = (int(s0[r, pos]), int(s1[r, pos]))
            if sc[0] < threshold[0] or sc[1] < threshold[1]:
                continue
            if sc > best or (sc == best and best_pos is not None
                             and pos > best_pos):
                best = sc
                best_pos = pos
        if best_pos is not None:
            out[r] = (best_pos, best[0], best[1])
    return out
