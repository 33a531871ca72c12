"""Alignment with traceback (PATH task) — host reference + native backend.

The reference obtains alignment paths from edlib (TASK_PATH,
edlib.cpp:924 full-matrix traceback / edlib.cpp:1213 Hirschberg) and consumes
them for polishing comparisons and consensus rotation. Here:

- `align_path` computes a global (NW) / infix (HW) alignment and its aligned
  strings. Backend order: the in-repo C++ native library
  (centroflye_tpu/native, banded Myers with traceback — the high-throughput
  path), else a vectorized numpy DP (row-sweep, O(nm) with O(n+m) traceback)
  that serves tests and small inputs.
- Deterministic operation order: ties prefer diagonal, then vertical
  (gap in target), then horizontal (gap in query).

The heavy *distance* scans stay on the device (ops/myers); paths are only
needed for consensus building on short (~unit-length) sequences, which is
host work by design — the same split the reference uses (C++ edlib under a
Python driver).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from centroflye_tpu.io.encoding import encode


@dataclasses.dataclass
class PathAlignment:
    dist: int
    # aligned strings with '-' gaps; a1 = query, a2 = target (slice)
    a1: str
    a2: str
    t_start: int       # target start of the alignment (HW mode; 0 for NW)
    t_end: int         # target end (exclusive)
    cigar: str         # extended cigar over =, X, I (in a1), D


def _dp_matrix(q: np.ndarray, t: np.ndarray, mode: str) -> np.ndarray:
    m, n = len(q), len(t)
    D = np.zeros((m + 1, n + 1), dtype=np.int32)
    D[:, 0] = np.arange(m + 1)
    if mode == "NW":
        D[0, :] = np.arange(n + 1)
    # row sweep with vectorized substitution + vertical; horizontal needs a
    # prefix-min scan per row:  D[i, j] = min(best_vec[j], min_k<=j
    # (best_vec[k] + j - k)) via running minimum
    js = np.arange(n + 1, dtype=np.int32)
    for i in range(1, m + 1):
        sub = D[i - 1, :-1] + (t != q[i - 1])
        vert = D[i - 1, 1:] + 1
        # candidates before horizontal propagation: c[0] = boundary, then
        # min(sub, vert); the row solves row[j] = min_{k<=j} c[k] + (j - k),
        # i.e. j + running_min(c - k)
        c = np.empty(n + 1, dtype=np.int32)
        c[0] = i
        np.minimum(sub, vert, out=c[1:])
        D[i] = js + np.minimum.accumulate(c - js)
    return D


def align_path(query: str, target: str, mode: str = "NW",
               prefer_native: bool = True) -> PathAlignment:
    """Global (NW) or infix (HW) alignment with full traceback. Uses the
    native C++ engine when built (order-of-magnitude faster on unit-length
    sequences — the polisher hot path); falls back to the numpy DP."""
    if prefer_native and query and target:
        native = _native_align_path(query, target, mode)
        if native is not None:
            return native
    q = encode(query)
    t = encode(target)
    m, n = len(q), len(t)
    if m == 0:
        return PathAlignment(dist=0 if mode == "HW" else n, a1="-" * n,
                             a2=target, t_start=0, t_end=n if mode == "NW"
                             else 0, cigar=f"{n}D" if mode == "NW" else "")
    if n == 0:
        return PathAlignment(dist=m, a1=query, a2="-" * m, t_start=0,
                             t_end=0, cigar=f"{m}I")
    D = _dp_matrix(q, t, mode)
    if mode == "NW":
        j_end = n
    else:
        j_end = int(np.argmin(D[m]))
    dist = int(D[m, j_end])
    # traceback
    i, j = m, j_end
    a1, a2, ops = [], [], []
    while i > 0 and (j > 0 or mode == "NW"):
        if i > 0 and j > 0 and \
                D[i, j] == D[i - 1, j - 1] + (q[i - 1] != t[j - 1]):
            a1.append(query[i - 1])
            a2.append(target[j - 1])
            ops.append("=" if q[i - 1] == t[j - 1] else "X")
            i -= 1
            j -= 1
        elif i > 0 and D[i, j] == D[i - 1, j] + 1:
            a1.append(query[i - 1])
            a2.append("-")
            ops.append("I")
            i -= 1
        elif j > 0 and D[i, j] == D[i, j - 1] + 1:
            a1.append("-")
            a2.append(target[j - 1])
            ops.append("D")
            j -= 1
        else:  # pragma: no cover - defensive
            raise AssertionError("traceback stuck")
        if j == 0 and mode != "NW" and i > 0:
            # HW: remaining query aligns as leading insertions
            while i > 0:
                a1.append(query[i - 1])
                a2.append("-")
                ops.append("I")
                i -= 1
            break
    if mode == "NW":
        while j > 0:
            a1.append("-")
            a2.append(target[j - 1])
            ops.append("D")
            j -= 1
        while i > 0:
            a1.append(query[i - 1])
            a2.append("-")
            ops.append("I")
            i -= 1
    t_start = j
    a1 = "".join(reversed(a1))
    a2 = "".join(reversed(a2))
    ops = "".join(reversed(ops))
    # compress cigar
    cig = []
    k = 0
    while k < len(ops):
        k2 = k
        while k2 < len(ops) and ops[k2] == ops[k]:
            k2 += 1
        cig.append(f"{k2 - k}{ops[k]}")
        k = k2
    return PathAlignment(dist=dist, a1=a1, a2=a2, t_start=t_start,
                         t_end=j_end, cigar="".join(cig))


def _native_align_path(query: str, target: str,
                       mode: str) -> Optional[PathAlignment]:
    """PathAlignment via the native engine's cigar; None if unavailable."""
    try:
        from centroflye_tpu.native import native_align_path
    except ImportError:
        return None
    res = native_align_path(encode(query), encode(target), mode=mode)
    if res is None:
        return None
    dist, cigar, t_start, t_end = res
    from centroflye_tpu.utils.bio import parse_cigar
    target_slice = target[t_start:t_end]
    _, _, a1, a2 = parse_cigar(cigar, query, target_slice)
    return PathAlignment(dist=dist, a1=a1, a2=a2, t_start=t_start,
                         t_end=t_end, cigar=cigar)


def hw_locate(query: str, target: str) -> Tuple[int, int, int]:
    """(dist, t_start, t_end) of the best infix alignment — the role of
    edlib.align(mode='HW', task='locations') in the reference
    (better_consensus_unit_reconstruction.py:183-188). Uses the native
    backend when available, else the numpy DP."""
    try:
        from centroflye_tpu.native import native_hw_locate
        res = native_hw_locate(query, target)
        if res is not None:
            return res
    except ImportError:
        pass
    al = align_path(query, target, mode="HW")
    return al.dist, al.t_start, al.t_end
