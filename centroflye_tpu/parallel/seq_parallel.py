"""Sequence-parallel Myers edit distance: one read's DP columns sharded
across devices, the DP state handed from one device to the next.

The reference handles ultra-long reads (100kb+) only by banding inside one
process (edlib.cpp:538 initial band, :612-622 reduction); a read never
spans workers. The design here is the ring-attention analogue SURVEY §5
calls for: the target's columns are split into N contiguous chunks, chunk d
living on device d of a 1-D mesh axis. The Myers column recurrence is
sequential in the target, so chunks are *pipelined over microbatches*: at
pipeline step t, device d runs microbatch (t - d) through its chunk, then
passes the full DP carry — (VP, VN, last-row score, running best/end/final)
— to device d+1 with a single `ppermute` hop. After
`n_micro + N - 1` steps every microbatch has flowed through all N chunks;
with n_micro >= N the pipeline bubble is < half the steps and every device
does useful column work on most steps.

Exactness: the carry is the complete per-read DP state between columns
(the same tuple `myers_distance_batch` scans with), so the sharded result
is bit-identical to the single-device scan — asserted by
tests/test_seq_parallel.py on the 8-device CPU mesh.

Role in the engine: recruitment of reads too long to score whole on one
device, and a building block for mapping the ~3Mbp final contig
against the unit without host chunking.
"""

from __future__ import annotations

import functools
from typing import Dict, Literal

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from centroflye_tpu.ops.myers import (
    WORD, _FULL, myers_column_update, n_words)

SEQ_AXIS = "seq"


def make_seq_mesh(n_devices: int = 0, axis: str = SEQ_AXIS) -> Mesh:
    devices = jax.devices()
    if n_devices:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def _build_step(mesh: Mesh, axis: str, m: int, mode: str,
                B: int, L: int, n_micro: int):
    """Jitted shard_map pipeline for fixed shapes. text is column-sharded
    (P(None, axis)); peq and lens are replicated; outputs are replicated
    (psum-broadcast from the last pipeline stage)."""
    N = mesh.shape[axis]
    if L % N:
        raise ValueError(f"L={L} must be a multiple of {N} devices")
    if B % n_micro:
        raise ValueError(f"B={B} must be a multiple of n_micro={n_micro}")
    C = L // N
    b = B // n_micro
    W = n_words(m)
    hw_word = (m - 1) // WORD
    hb = np.uint32((m - 1) % WORD)
    global_mode = mode in ("SHW", "NW")
    T = n_micro + N - 1
    perm = [(i, i + 1) for i in range(N - 1)]

    def init_state():
        return (jnp.full((b, W), _FULL, jnp.uint32),     # VP
                jnp.zeros((b, W), jnp.uint32),           # VN
                jnp.full((b,), m, jnp.int32),            # last-row score
                jnp.full((b,), m, jnp.int32),            # best
                jnp.full((b,), -1, jnp.int32),           # end column
                jnp.full((b,), m, jnp.int32))            # final (NW)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, None), P(None, axis), P()),
        out_specs=(P(), P()), check_vma=False)
    def step(peq, text_local, lens):
        d = jax.lax.axis_index(axis)
        js = (d * C + jnp.arange(C, dtype=jnp.int32))
        text_t = text_local.T                       # (C, B) column-major

        def chunk_scan(state, rows_t, row_lens):
            """Run one microbatch's rows through this device's C columns."""

            def col_step(st, inp):
                vp, vn, score, best, end, final = st
                j, chars = inp
                active = j < row_lens
                eq = peq[chars.astype(jnp.int32)]
                vp_new, vn_new, hp, hn = myers_column_update(
                    eq, vp, vn, global_mode=global_mode)
                inc = ((hp[:, hw_word] >> hb) & 1).astype(jnp.int32) - \
                      ((hn[:, hw_word] >> hb) & 1).astype(jnp.int32)
                score_new = score + inc
                sel = active[:, None]
                vp = jnp.where(sel, vp_new, vp)
                vn = jnp.where(sel, vn_new, vn)
                score = jnp.where(active, score_new, score)
                improved = active & (score < best)
                best = jnp.where(improved, score, best)
                end = jnp.where(improved, j, end)
                final = jnp.where(active & (j == row_lens - 1),
                                  score, final)
                return (vp, vn, score, best, end, final), None

            out, _ = jax.lax.scan(col_step, state, (js, rows_t))
            return out

        def pipe_step(carry, t):
            recv, acc_dist, acc_end = carry
            mb = t - d
            mb_c = jnp.clip(mb, 0, n_micro - 1)
            row0 = mb_c * b
            rows_t = jax.lax.dynamic_slice(text_t, (0, row0), (C, b))
            row_lens = jax.lax.dynamic_slice(lens, (row0,), (b,))
            fresh = init_state()
            state_in = jax.tree_util.tree_map(
                lambda f, r: jnp.where(d == 0, f, r), fresh, recv)
            state_out = chunk_scan(state_in, rows_t, row_lens)
            send = jax.tree_util.tree_map(
                lambda x: jax.lax.ppermute(x, axis, perm), state_out)
            # the last stage has the finished microbatch: record its result
            _, _, _, best, end, final = state_out
            dist = final if mode == "NW" else best
            endv = row_lens - 1 if mode == "NW" else end
            valid = (d == N - 1) & (mb >= 0) & (mb < n_micro)
            cur_d = jax.lax.dynamic_slice(acc_dist, (row0,), (b,))
            cur_e = jax.lax.dynamic_slice(acc_end, (row0,), (b,))
            acc_dist = jax.lax.dynamic_update_slice(
                acc_dist, jnp.where(valid, dist, cur_d), (row0,))
            acc_end = jax.lax.dynamic_update_slice(
                acc_end, jnp.where(valid, endv, cur_e), (row0,))
            return (send, acc_dist, acc_end), None

        acc0 = jnp.zeros((B,), jnp.int32)
        (_, acc_dist, acc_end), _ = jax.lax.scan(
            pipe_step, (init_state(), acc0, acc0),
            jnp.arange(T, dtype=jnp.int32))
        # only the last stage's accumulators are real; broadcast them
        keep = (d == N - 1)
        acc_dist = jax.lax.psum(
            jnp.where(keep, acc_dist, jnp.zeros_like(acc_dist)), axis)
        acc_end = jax.lax.psum(
            jnp.where(keep, acc_end, jnp.zeros_like(acc_end)), axis)
        return acc_dist, acc_end

    return jax.jit(step)


_STEP_CACHE: Dict = {}


def myers_distance_seqparallel(
    peq: np.ndarray,
    text: np.ndarray,
    lens: np.ndarray,
    *,
    m: int,
    mesh: Mesh,
    axis: str = SEQ_AXIS,
    mode: Literal["HW", "SHW", "NW"] = "HW",
    n_micro: int | None = None,
):
    """Drop-in for `myers_distance_batch(collect="best")` with the target
    columns sharded over `mesh`'s `axis`. Pads columns to a device multiple
    (PAD code 4 never matches) and rows to a microbatch multiple; returns
    {"dist": (B,) int32, "end": (B,) int32} bit-identical to the
    single-device kernel."""
    text = np.asarray(text)
    lens = np.asarray(lens, np.int32)
    B, L = text.shape
    N = mesh.shape[axis]
    if n_micro is None:
        n_micro = max(1, min(B, 2 * N))
    Lp = -(-L // N) * N
    if Lp != L:
        text = np.pad(text, ((0, 0), (0, Lp - L)), constant_values=4)
    Bp = -(-B // n_micro) * n_micro
    if Bp != B:
        text = np.pad(text, ((0, Bp - B), (0, 0)), constant_values=4)
        lens = np.pad(lens, (0, Bp - B))

    key = (mesh, axis, m, mode, Bp, Lp, n_micro)
    step = _STEP_CACHE.get(key)
    if step is None:
        step = _build_step(mesh, axis, m, mode, Bp, Lp, n_micro)
        _STEP_CACHE[key] = step

    sh_text = jax.device_put(text, NamedSharding(mesh, P(None, axis)))
    dist, end = step(jnp.asarray(peq), sh_text, jnp.asarray(lens))
    return {"dist": np.asarray(dist)[:B], "end": np.asarray(end)[:B]}
