"""Batched Myers bit-parallel edit distance in plain JAX.

This is the single shared alignment primitive of the engine — the batched
re-design of the role edlib plays in the reference (vendored C++ at
scripts/read_recruitment/edlib/src/edlib.cpp: myersCalcEditDistanceSemiGlobal
at edlib.cpp:526, calculateBlock at edlib.cpp:388; consumed both by the rr
recruiter rr.cpp:74-79 and from Python in eltr_polisher.py:138 and
better_consensus_unit_reconstruction.py:184-186).

Design (not a port):
- The query bit-state lives in ``W = ceil(m/32)`` uint32 lanes per sequence;
  a batch of ``B`` sequences advances in lock-step, so every column update is
  a (B, W) elementwise vector op — no per-sequence divergence, no banding,
  no data-dependent control flow.
- The multi-word carry of the Myers addition is computed with a
  carry-lookahead (generate/propagate) ``associative_scan`` over the word
  axis: log2(W) vector steps instead of a serial word chain.
- Alignment modes follow edlib (edlib.h:21-47): HW (infix: free start+end in
  target), SHW (prefix: anchored start, free end), NW (global). Scores are
  tracked at the query's last row; HW/SHW take a running min over columns.
- Columns beyond each sequence's length are masked out, so one padded (B, L)
  int8 batch serves mixed-length reads.

The recruitment hot path scores with the CUDA kernel of ops/myers_cuda.py
on a GPU, which keeps the same bit state in registers across the whole
text; this scan is its reference and its path everywhere else.
"""

from __future__ import annotations

import functools
from typing import Literal

import jax
import jax.numpy as jnp
import numpy as np

WORD = 32
_FULL = np.uint32(0xFFFFFFFF)


def n_words(m: int) -> int:
    return (m + WORD - 1) // WORD


def build_peq(query_codes: np.ndarray, m: int | None = None) -> np.ndarray:
    """Peq bit table for a query: (5, W) uint32; row a has bit i set iff
    query[i] == a. Row 4 (PAD/N) is all zeros (mismatches everything).
    Equivalent role to edlib's buildPeq (edlib.cpp:334), laid out as uint32
    lanes little-endian (word w holds query rows 32w..32w+31)."""
    query_codes = np.asarray(query_codes)
    if m is None:
        m = len(query_codes)
    W = n_words(m)
    peq = np.zeros((5, W), dtype=np.uint32)
    for i in range(min(m, len(query_codes))):
        a = int(query_codes[i])
        if 0 <= a < 4:
            peq[a, i // WORD] |= np.uint32(1) << np.uint32(i % WORD)
    return peq


def _carry_add(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Multi-word addition a + b over little-endian uint32 word vectors
    (..., W), carries propagated with a carry-lookahead associative scan."""
    s = a + b
    g = s < a                     # carry generated out of this word
    p = s == _FULL                # carry would propagate through this word

    def combine(x, y):
        g1, p1 = x
        g2, p2 = y
        return (g2 | (p2 & g1), p2 & p1)

    G, _ = jax.lax.associative_scan(combine, (g, p), axis=-1)
    carry_in = jnp.concatenate(
        [jnp.zeros_like(G[..., :1]), G[..., :-1]], axis=-1)
    return s + carry_in.astype(a.dtype)


def _shift_left1(x: jnp.ndarray, carry_bit: jnp.ndarray) -> jnp.ndarray:
    """(x << 1) across word boundaries; carry_bit (broadcastable to
    x[..., :1]) is shifted into bit 0 of word 0."""
    hi = x >> jnp.uint32(WORD - 1)
    low_in = jnp.broadcast_to(
        carry_bit.astype(jnp.uint32), x[..., :1].shape)
    shifted_in = jnp.concatenate([low_in, hi[..., :-1]], axis=-1)
    return (x << jnp.uint32(1)) | shifted_in


def myers_column_update(eq, vp, vn, *, global_mode: bool):
    """One Myers column update. Returns (vp, vn, delta) where delta in
    {-1, 0, +1} is the change of the query-last-row score, read from the
    high bit by the caller.

    global_mode=True shifts a 1 into the horizontal-positive vector (the +1/
    column of the global top boundary; NW/SHW modes). False = HW search mode
    (free alignment start in target, top row stays 0).
    """
    d0 = (_carry_add(eq & vp, vp) ^ vp) | eq | vn
    hp = vn | ~(d0 | vp)
    hn = vp & d0
    one = jnp.ones((), jnp.uint32) if global_mode else jnp.zeros((), jnp.uint32)
    hp_s = _shift_left1(hp, one)
    hn_s = _shift_left1(hn, jnp.zeros((), jnp.uint32))
    vp_new = hn_s | ~(d0 | hp_s)
    vn_new = hp_s & d0
    return vp_new, vn_new, hp, hn


@functools.partial(
    jax.jit,
    static_argnames=("m", "mode", "collect"))
def myers_distance_batch(
    peq: jnp.ndarray,
    text: jnp.ndarray,
    lens: jnp.ndarray,
    *,
    m: int,
    mode: Literal["HW", "SHW", "NW"] = "HW",
    collect: Literal["best", "all"] = "best",
    ms: jnp.ndarray | None = None,
):
    """Edit distance of one (or per-row) query against a batch of targets.

    Args:
      peq: (5, W) uint32 shared query table, or (B, 5, W) per-row queries.
      text: (B, L) int8 target codes (0..3 bases, 4 = N/PAD).
      lens: (B,) int32 actual target lengths.
      m: query length (static).
      mode: "HW" infix / "SHW" prefix / "NW" global (edlib.h:21-47 semantics).
      collect: "best" -> (dist, end) per row, where end is the 0-based index
        of the last aligned target char (first column achieving the min;
        -1 when the empty alignment m is the min or mode="NW").
        "all" -> (scores, ) the (B, L) int32 query-last-row score after each
        column (masked columns repeat the previous score).
      ms: optional (B,) int32 per-row query lengths (each <= m); the score is
        then tracked at each row's own last query row. Peq rows at/above
        ms[b] must be zero bits.

    Returns:
      dict with "dist" (B,) int32 and "end" (B,) int32, or "scores" (B, L).
    """
    B, L = text.shape
    W = n_words(m)
    per_row_query = peq.ndim == 3
    global_mode = mode in ("SHW", "NW")

    if ms is None:
        m_rows = jnp.full((B,), m, dtype=jnp.int32)
    else:
        m_rows = ms.astype(jnp.int32)
    hw_word = (m_rows - 1) // WORD          # (B,)
    hb = ((m_rows - 1) % WORD).astype(jnp.uint32)

    vp0 = jnp.full((B, W), _FULL, dtype=jnp.uint32)
    vn0 = jnp.zeros((B, W), dtype=jnp.uint32)
    score0 = m_rows
    best0 = m_rows
    end0 = jnp.full((B,), -1, dtype=jnp.int32)
    final0 = m_rows

    text_t = text.T  # (L, B) so scan slices are contiguous per column

    def step(carry, inp):
        vp, vn, score, best, end, final = carry
        j, chars = inp
        active = j < lens
        if per_row_query:
            eq = jnp.take_along_axis(
                peq, chars.astype(jnp.int32)[:, None, None], axis=1
            )[:, 0, :]
        else:
            eq = peq[chars.astype(jnp.int32)]
        vp_new, vn_new, hp, hn = myers_column_update(
            eq, vp, vn, global_mode=global_mode)
        hp_w = jnp.take_along_axis(hp, hw_word[:, None], axis=1)[:, 0]
        hn_w = jnp.take_along_axis(hn, hw_word[:, None], axis=1)[:, 0]
        inc = ((hp_w >> hb) & 1).astype(jnp.int32) - \
              ((hn_w >> hb) & 1).astype(jnp.int32)
        score_new = score + inc

        sel = active[:, None]
        vp = jnp.where(sel, vp_new, vp)
        vn = jnp.where(sel, vn_new, vn)
        score = jnp.where(active, score_new, score)

        improved = active & (score < best)
        best = jnp.where(improved, score, best)
        end = jnp.where(improved, j, end)
        final = jnp.where(active & (j == lens - 1), score, final)
        return (vp, vn, score, best, end, final), score

    js = jnp.arange(L, dtype=jnp.int32)
    (vp, vn, score, best, end, final), scores = jax.lax.scan(
        step, (vp0, vn0, score0, best0, end0, final0), (js, text_t))

    if collect == "all":
        return {"scores": scores.T}
    if mode == "NW":
        return {"dist": final, "end": lens - 1}
    return {"dist": best, "end": end}


def edit_distance_oracle(query: str, text: str, mode: str = "HW"):
    """Reference O(mn) DP oracle (host, numpy) for tests.

    Returns (dist, end) with the same semantics as myers_distance_batch
    "best": end = 0-based index of last aligned target char, first column
    achieving the minimum; end = -1 if aligning to the empty prefix is best.
    """
    from centroflye_tpu.io.encoding import encode

    q = encode(query)
    t = encode(text)
    m, n = len(q), len(t)
    prev = np.arange(m + 1, dtype=np.int64)  # column for empty target prefix
    best, end = m, -1
    finals = []
    for j in range(n):
        cur = np.empty(m + 1, dtype=np.int64)
        cur[0] = 0 if mode == "HW" else j + 1
        for i in range(1, m + 1):
            sub = prev[i - 1] + (0 if (q[i - 1] == t[j] and q[i - 1] < 4)
                                 else 1)
            cur[i] = min(sub, prev[i] + 1, cur[i - 1] + 1)
        finals.append(int(cur[m]))
        if cur[m] < best:
            best, end = int(cur[m]), j
        prev = cur
    if mode == "NW":
        return int(prev[m]), n - 1
    return best, end
