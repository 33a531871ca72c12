"""Device seed prefilter for read recruitment.

The recruitment decision (does the HOR unit align into this read within
threshold k?) is overwhelmingly negative on real data (~11.1M reads -> only
thousands centromeric, reference README.md:103-116), yet the reference
spends the full banded-alignment cost on every read (rr.cpp:73-87). Here a
cheap exact-membership seed scan runs first:

- the unit's seed k-mers (both strands, default k=13) form a sorted
  (hi, lo) table (a few thousand entries);
- each read segment's k-mer codes are matched by branchless binary search
  (ops/kmers.lookup_codes: ~log2(n) vector compare steps per position — two
  orders of magnitude cheaper than the Myers column update);
- segments whose hit count is below `min_hits` cannot contain a unit
  alignment (a true alignment at <= 17% divergence shares hundreds of
  13-mers with the unit; P[< min_hits] is astronomically small for real
  error processes) and skip the alignment kernel entirely.

The filter is a recall heuristic, not a proof (the q-gram lemma gives no
usable bound at e/m ~ 0.17): `RecruitmentConfig.prefilter=False` restores
the pure-Myers exact path for parity runs. With the default conservative
`min_hits`, filtered and exact recruitment select identical read sets on
all tested data.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from centroflye_tpu.io.encoding import encode, kmer_codes, revcomp_str
from centroflye_tpu.io.encoding import split_u64
from centroflye_tpu.ops.kmers import pack_kmers, lookup_codes


def build_seed_table(unit: str, k: int = 13) -> Tuple[np.ndarray,
                                                      np.ndarray]:
    """Sorted (hi, lo) uint32 table of the unit's seed k-mers, both strands,
    over the doubled unit (instance-crossing seeds included)."""
    seqs = [unit + unit[:k - 1], revcomp_str(unit + unit[:k - 1])]
    codes = []
    for s in seqs:
        c, valid = kmer_codes(encode(s), k)
        codes.append(c[valid])
    table = np.unique(np.concatenate(codes))
    return split_u64(table)


def build_seed_bitmap(unit: str, k: int = 13, *, le: bool = False
                      ) -> np.ndarray:
    """Direct-address membership bitmap over all 4^k k-mers (k <= 15:
    4^13 = 8 MB of bits as uint32[4^k / 32]) — one gather per query
    position instead of a log(n) binary-search gather chain (the rate of
    each on a GPU is not yet measured).

    le=True keys the bitmap by LITTLE-endian codes (first base in the low
    2 bits) — the natural order of k-mers extracted straight from 2-bit
    packed bytes (ops/fused_recruit packed filter path)."""
    assert k <= 15, "direct-address bitmap needs k <= 15"
    seqs = [unit + unit[:k - 1], revcomp_str(unit + unit[:k - 1])]
    bitmap = np.zeros(4 ** k // 32, dtype=np.uint32)
    for s in seqs:
        c, valid = kmer_codes(encode(s), k)
        c = c[valid].astype(np.uint64)
        if le:
            r = np.zeros_like(c)
            for i in range(k):
                r |= (((c >> np.uint64(2 * i)) & np.uint64(3))
                      << np.uint64(2 * (k - 1 - i)))
            c = r
        # collision-safe scatter-OR: fancy-index `|=` is last-write-wins
        # on duplicate word indices and silently drops bits
        np.bitwise_or.at(
            bitmap, (c >> np.uint64(5)).astype(np.int64),
            np.uint32(1) << (c & np.uint64(31)).astype(np.uint32))
    return bitmap


def host_prescan_hits(packed: np.ndarray, lens: np.ndarray,
                      bitmap_le: np.ndarray, k: int = 13) -> np.ndarray:
    """Host-side (numpy) stage-A seed prescan over 2-bit packed rows.

    Samples ONE k-mer per 16-base u32 word (in-word phase 0) and counts
    membership in the LE-keyed seed bitmap — bit-identical to the device
    packed filter restricted to offset 0 (ops/fused_recruit._packed_hits).
    Purpose: rows with 0 sampled hits are resolved as non-centromeric
    BEFORE upload, so only candidate rows (~2% true + a few % sampling
    false-positives on random sequence) ever cross the host→device link.
    A unit window at the recruitment boundary (<= 17% divergence,
    2 kb) carries ~11 expected sampled clean 13-mers; P[prescan misses
    it] ~ e^-11. Rows containing in-range N bases must NOT be prescanned
    (N packs as base 0): route them to the exact Myers tier instead.
    """
    B, Lq = packed.shape
    assert Lq % 4 == 0
    W = packed.reshape(B, Lq // 4, 4).view(np.uint32)[..., 0]
    code = W & np.uint32((1 << (2 * k)) - 1)
    pos16 = 16 * np.arange(Lq // 4, dtype=np.int32)[None, :]
    valid = (pos16 + k) <= np.asarray(lens, np.int32)[:, None]
    got = bitmap_le[(code >> np.uint32(5)).astype(np.int64)]
    found = (((got >> (code & np.uint32(31))) & 1) == 1) & valid
    return found.sum(axis=1, dtype=np.int32)


@functools.partial(jax.jit, static_argnames=("k", "stride"))
def seed_hit_counts_bitmap(bitmap: jnp.ndarray, codes: jnp.ndarray,
                           lens: jnp.ndarray, *, k: int, stride: int = 1):
    """Per-row count of read k-mers present in the seed bitmap, optionally
    sampling every `stride`-th position (recall scales ~1/stride; callers
    scale min_hits accordingly).

    codes: (B, L) int8; returns (B,) int32 hit counts.
    """
    hi, lo, valid = pack_kmers(codes, lens, k=k)
    lo = lo[:, ::stride]
    valid = valid[:, ::stride]
    word = (lo >> jnp.uint32(5)).astype(jnp.int32)
    bit = (lo & jnp.uint32(31))
    # single dense gather; invalid positions index word 0 harmlessly and
    # are masked after
    word = jnp.where(valid, word, 0)
    got = bitmap[word.ravel()].reshape(word.shape)
    found = (((got >> bit) & 1) == 1) & valid
    return jnp.sum(found.astype(jnp.int32), axis=1)


@functools.partial(jax.jit, static_argnames=("k",))
def seed_hit_counts(table_hi: jnp.ndarray, table_lo: jnp.ndarray,
                    codes: jnp.ndarray, lens: jnp.ndarray, *, k: int):
    """Per-row count of read k-mers present in the sorted seed table
    (binary-search path; the engine uses seed_hit_counts_bitmap).

    codes: (B, L) int8; returns (B,) int32 hit counts.
    """
    hi, lo, valid = pack_kmers(codes, lens, k=k)
    found, _ = lookup_codes(table_hi, table_lo, hi.ravel(), lo.ravel())
    found = found.reshape(hi.shape) & valid
    return jnp.sum(found.astype(jnp.int32), axis=1)
