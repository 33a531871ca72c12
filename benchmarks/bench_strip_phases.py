"""Distance-sweep strip phase microbench (round-5 verdict item 2).

Builds ONE production-like raw strip (default 2^26 pairs, sub-bucket
structure matching the 1500u shape: iterated sides ~60 wide) and times
each device phase with hard syncs:
  prep      — _prep_strip_device (sparse device strip prep)
  enum      — pair enumeration WITHOUT the sort (scan fills + gather)
  enum+sort — _sorted_pairs (the production call)
  filter    — _count_filter_sorted on the sorted stream
plus isolated probes: the (chunk,5) scatter+cumsum alone, the flat
gather alone, and the 2-key sort alone.

Run on the GPU: python benchmarks/bench_strip_phases.py [log2_pairs]
"""

import functools
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from centroflye_tpu.stages import distance_graph as dg


def sync(x):
    jax.block_until_ready(x)
    return x


def scalarize(tree):
    """Reduce a pytree of device arrays to one traced scalar; phase
    timing ends on its device->host readback."""
    leaves = jax.tree_util.tree_leaves(tree)
    acc = jnp.float32(0)
    for x in leaves:
        acc = acc + jnp.asarray(x).ravel()[-1].astype(jnp.float32)
    return acc


def timeit(fn, n=5):
    float(fn())                # compile + warm (scalar readback)
    float(fn())
    t0 = time.perf_counter()
    for _ in range(n):
        float(fn())
    return (time.perf_counter() - t0) / n


def main():
    lg = int(sys.argv[1]) if len(sys.argv) > 1 else 26
    chunk = 1 << lg
    rng = np.random.default_rng(0)
    # sub-bucket structure: iterated side ~60 (production clouds ~67
    # entries, const side resolved on host), so E ~ chunk/60 sub-buckets
    it_w = 60
    E = chunk // it_w
    n_flat = 6 << 20          # flat cloud values plane (~24 MB int32)
    flat = rng.integers(0, 1 << 21, size=n_flat, dtype=np.int32)
    widths = np.full(E, it_w, np.int64)
    starts = np.concatenate([[0], np.cumsum(widths)]).astype(np.int32)
    total = int(starts[-1])
    const_vals = rng.integers(0, 1 << 21, size=E, dtype=np.int32)
    base_iter = rng.integers(0, n_flat - it_w - 1, size=E,
                             dtype=np.int32)
    a_const = rng.integers(0, 2, size=E, dtype=np.int32)
    dvals = rng.integers(1, 151, size=E, dtype=np.int32)

    flat_d = sync(jax.device_put(flat))
    starts_d = sync(jax.device_put(starts))
    cv_d = sync(jax.device_put(const_vals))
    bi_d = sync(jax.device_put(base_iter))
    ac_d = sync(jax.device_put(a_const))
    dv_d = sync(jax.device_put(dvals))

    print(f"chunk 2^{lg} = {chunk:,} pairs, {E:,} sub-buckets,"
          f" flat {n_flat:,}", flush=True)

    sorted_probe = jax.jit(lambda *a: scalarize(
        dg._sorted_pairs_core(*a, chunk=chunk)))
    t = timeit(lambda: sorted_probe(
        flat_d, starts_d, cv_d, bi_d, ac_d, dv_d, jnp.int32(total)))
    print(f"enum+sort (_sorted_pairs): {t:.3f}s "
          f"({chunk / t / 1e6:.1f}M pairs/s)", flush=True)

    # blocked raw enumeration (8-lane blocks, 2-row gather + selects)
    n8 = (n_flat + 7) // 8 + 1
    f8 = np.zeros(n8 * 8, np.int32)
    f8[:n_flat] = flat
    flat8_d = sync(jax.device_put(f8.reshape(n8, 8)))
    pad_bound = total + 8 * E
    chunk8 = 1 << int(np.ceil(np.log2(pad_bound)))
    blocked_probe = jax.jit(lambda *a: scalarize(
        dg._sorted_pairs_blocked_core(*a, chunk=chunk8)))
    t = timeit(lambda: blocked_probe(
        flat8_d, starts_d, cv_d, bi_d, ac_d, dv_d, jnp.int32(total)))
    print(f"enum+sort BLOCKED (chunk {chunk8:,}): {t:.3f}s "
          f"({chunk / t / 1e6:.1f}M true pairs/s)", flush=True)

    # isolated probes -----------------------------------------------
    @functools.partial(jax.jit, static_argnames=("chunk",))
    def scan_only(starts, cv, bi, ac, dv, total, *, chunk):
        p = jnp.arange(chunk, dtype=jnp.int32)
        bpos = jnp.maximum(starts[1:-1], 0)
        vals5 = jnp.stack([starts[:-1], bi, cv, ac, dv], axis=1)
        deltas5 = vals5[1:] - vals5[:-1]
        grid5 = jnp.zeros((chunk, 5), jnp.int32)
        grid5 = grid5.at[0].add(vals5[0])
        grid5 = grid5.at[bpos].add(deltas5, mode="drop")
        f5 = jnp.cumsum(grid5, axis=0)
        return (f5[:, 0] + f5[:, 1] + f5[:, 2])[-1]

    t = timeit(lambda: scan_only(
        starts_d, cv_d, bi_d, ac_d, dv_d, jnp.int32(total),
        chunk=chunk))
    print(f"scatter+cumsum (5 cols): {t:.3f}s", flush=True)

    @functools.partial(jax.jit, static_argnames=("chunk",))
    def scan3(starts, cv, bi, acdv, total, *, chunk):
        bpos = jnp.maximum(starts[1:-1], 0)
        vals3 = jnp.stack([bi - starts[:-1], cv, acdv], axis=1)
        deltas3 = vals3[1:] - vals3[:-1]
        grid3 = jnp.zeros((chunk, 3), jnp.int32)
        grid3 = grid3.at[0].add(vals3[0])
        grid3 = grid3.at[bpos].add(deltas3, mode="drop")
        f3 = jnp.cumsum(grid3, axis=0)
        return (f3[:, 0] + f3[:, 1] + f3[:, 2])[-1]

    acdv_d = sync(jax.device_put(
        (a_const.astype(np.int32) << 8) | dvals.astype(np.int32)))
    t = timeit(lambda: scan3(
        starts_d, cv_d, bi_d, acdv_d, jnp.int32(total), chunk=chunk))
    print(f"scatter+cumsum (3 cols, packed): {t:.3f}s", flush=True)

    idx = rng.integers(0, n_flat, size=chunk).astype(np.int32)
    idx_d = sync(jax.device_put(idx))

    @jax.jit
    def gather_only(flat, idx):
        return flat[idx][-1] + flat[idx][0]

    t = timeit(lambda: gather_only(flat_d, idx_d))
    print(f"flat gather ({chunk:,} from {n_flat:,}): {t:.3f}s",
          flush=True)

    # sequential-ish gather: indices ascending (piecewise-contiguous
    # runs like the real sub-bucket reads)
    idx_s = np.sort(idx).astype(np.int32)
    idx_sd = sync(jax.device_put(idx_s))
    t = timeit(lambda: gather_only(flat_d, idx_sd))
    print(f"flat gather (sorted idx): {t:.3f}s", flush=True)

    keys_h = rng.integers(0, 1 << 21, size=chunk, dtype=np.uint32)
    keys2_h = rng.integers(0, 1 << 31, size=chunk, dtype=np.uint32)
    k1 = sync(jax.device_put(keys_h))
    k2 = sync(jax.device_put(keys2_h))

    @jax.jit
    def sort2(a, b):
        s = jax.lax.sort((a, b), num_keys=2)
        return s[0][-1] + s[1][0]

    t = timeit(lambda: sort2(k1, k2))
    print(f"2-key u32 sort: {t:.3f}s ({chunk / t / 1e6:.1f}M keys/s)",
          flush=True)

    @jax.jit
    def sort_full(a, b):
        return jax.lax.sort((a, b), num_keys=2)

    hi, lo = sort_full(k1, k2)
    seen = sync(jnp.zeros(1 << 21, jnp.uint8))
    filt_probe = jax.jit(lambda *a: scalarize(dg._count_filter_sorted(
        *a, use_frac=True, out_small=1 << 20)))
    t = timeit(lambda: filt_probe(
        seen, hi, lo, jnp.int32(4), jnp.int32(4), jnp.int32(5),
        jnp.float32(0.8)))
    print(f"count+filter (_count_filter_sorted): {t:.3f}s", flush=True)


if __name__ == "__main__":
    main()
