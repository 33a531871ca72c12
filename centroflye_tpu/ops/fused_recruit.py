"""Fused single-call recruitment step: packed upload -> seed filter ->
on-device compaction -> Myers on survivors.

Each engine batch costs exactly one host->device round trip:
- the host uploads base codes packed 4-per-byte (plus an N-position bitmask,
  8-per-byte): 2.25 bits/base instead of 8, so the host->device copy moves
  a quarter of the bytes;
- the device unpacks, counts unit seed hits per row (ops/seed_filter),
  stably partitions passing rows to the front (argsort of the fail flag),
  runs the two-strand Myers scorer (ops/myers_cuda.two_strand_scorer) on
  the first K_budget rows only, and
  scatters distances back to original row order (sentinel m for filtered
  rows);
- the host receives (dist_fwd, dist_rc, hits, n_pass) and falls back to the
  unfused exact path for a batch only in the rare n_pass > K_budget case.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from centroflye_tpu.ops.kmers import pack_kmers, lookup_codes


def unpack_2bit_host(packed: np.ndarray) -> np.ndarray:
    """Host (numpy) inverse of pack_2bit for N-free rows: (B, L/4) uint8
    -> (B, L) int8 base codes. Used on the rare overflow path where
    candidate rows must re-enter the plain Myers tier as codes."""
    B, Lq = packed.shape
    out = np.empty((B, Lq * 4), np.int8)
    for i in range(4):
        out[:, i::4] = (packed >> (2 * i)) & 3
    return out


def pack_2bit(codes: np.ndarray, lens: Optional[np.ndarray] = None,
              ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(B, L) int8 base codes -> (packed (B, L/4) uint8, n_mask (B, L/8)
    uint8 or None). L must be a multiple of 8. PAD/N positions are marked
    in n_mask and packed as base 0; when the batch contains no N/PAD
    bases inside the padded region at all, n_mask is None — the device
    side then skips the mask entirely, saving a third of the upload
    (the host link is the scarce resource)."""
    B, L = codes.shape
    assert L % 8 == 0
    try:
        from centroflye_tpu.native import native_pack2bit
        res = native_pack2bit(codes, lens)
        if res is not None:
            return res
    except ImportError:
        pass
    is_n = codes >= 4
    vals = np.where(is_n, 0, codes).astype(np.uint8)
    v = vals.reshape(B, L // 4, 4)
    packed = (v[:, :, 0] | (v[:, :, 1] << 2) | (v[:, :, 2] << 4)
              | (v[:, :, 3] << 6))
    if lens is not None:
        # positions at or beyond the row length are don't-care: the seed
        # filter drops windows crossing the length boundary
        # (ops/kmers.pack_kmers `inside`) and the Myers kernels gate
        # column updates on j < len — only genuine in-range N bases need
        # the mask
        is_n = is_n & (np.arange(L, dtype=np.int32)[None, :]
                       < np.asarray(lens, np.int32)[:, None])
    if not is_n.any():
        return packed.astype(np.uint8), None
    nm = is_n.reshape(B, L // 8, 8).astype(np.uint8)
    n_mask = np.zeros((B, L // 8), np.uint8)
    for b in range(8):
        n_mask |= nm[:, :, b] << b
    return packed.astype(np.uint8), n_mask


def _unpack_2bit(packed: jnp.ndarray, n_mask: jnp.ndarray) -> jnp.ndarray:
    """Device inverse of pack_2bit -> (B, L) int8."""
    B, Lq = packed.shape
    parts = [((packed >> (2 * i)) & 3).astype(jnp.int8) for i in range(4)]
    codes = jnp.stack(parts, axis=-1).reshape(B, Lq * 4)
    bits = [((n_mask >> i) & 1).astype(jnp.bool_) for i in range(8)]
    is_n = jnp.stack(bits, axis=-1).reshape(B, Lq * 4)
    return jnp.where(is_n, jnp.int8(4), codes)


def make_fused_recruit(seed_bitmap: np.ndarray,
                       peq_fwd: np.ndarray, peq_rc: np.ndarray,
                       *, m: int, seed_k: int, min_hits: int,
                       scorer, k_budget: int = 128, stride: int = 2,
                       mesh=None, seed_bitmap_le: np.ndarray = None):
    """Returns fused(packed, n_mask, lens) -> (df, dr, hits, n_pass), all
    device-resident until the caller materializes. seed_bitmap: the
    direct-address membership bitmap (ops/seed_filter.build_seed_bitmap);
    positions are sampled every `stride`. `min_hits` is specified in
    stride-1 (all-positions) units and scaled down here so the sampled
    filter keeps the config's intended strictness — the reference computes
    exact distances on every read (rr.cpp:74-87), so the prefilter must
    only drop reads that are clearly non-centromeric. The production
    engine feeds this step only rows that already passed the HOST stage-A
    prescan (ops/seed_filter.host_prescan_hits) — non-candidate rows never
    cross the host→device link at all. `scorer` is the two-strand Myers
    function (ops/myers_cuda.two_strand_scorer for the step's devices)."""
    min_hits = max(1, min_hits // stride)

    seed_bitmap = jnp.asarray(seed_bitmap)
    peq_fwd = jnp.asarray(peq_fwd)
    peq_rc = jnp.asarray(peq_rc)
    # the packed-direct filter path extracts k-mers from u32 word pairs
    # (32-bit window => k <= 16) at in-word offsets tiling evenly
    packed_path_ok = (seed_bitmap_le is not None and seed_k <= 16
                      and stride in (1, 2, 4))
    if packed_path_ok:
        seed_bitmap_le = jnp.asarray(seed_bitmap_le)

    def _myers_top(sub_codes, sub_lens):
        both = scorer(peq_fwd, peq_rc, sub_codes, sub_lens, m=m)
        return both["dist_f"], both["dist_r"]

    def _packed_hits(W, Wn, lens, offsets):
        """Packed-direct hit counts over sampled in-word phases `offsets`:
        W/Wn are (R, nw) u32 words of 16 bases each (base 16w+j at bits
        2j, little-endian); a window at in-word offset o spans W[w] and
        W[w+1] with SCALAR shift amounts per unrolled offset — no
        misaligned byte slices in the minor dim (those cost ~40ms/batch
        as lane shuffles)."""
        nw = W.shape[1]
        mask = jnp.uint32((1 << (2 * seed_k)) - 1)
        pos16 = 16 * jnp.arange(nw, dtype=jnp.int32)[None, :]
        hits = jnp.zeros((W.shape[0],), jnp.int32)
        for o in offsets:
            code = (W >> jnp.uint32(2 * o))
            if o > 0:
                code = code | (Wn << jnp.uint32(32 - 2 * o))
            code = code & mask
            valid = (pos16 + (o + seed_k)) <= lens[:, None]
            word = jnp.where(valid, (code >> jnp.uint32(5)).astype(
                jnp.int32), 0)
            got = seed_bitmap_le[word.ravel()].reshape(word.shape)
            found = (((got >> (code & jnp.uint32(31))) & 1) == 1) & valid
            hits += jnp.sum(found.astype(jnp.int32), axis=1)
        return hits

    def _fused_body_packed(packed, lens):
        """No-N fast path: seed k-mer codes come straight from the 2-bit
        packed bytes (a u32 window holds 16 bases, so every sampled
        in-byte phase t has t + 13 <= 16), the survivor gather moves
        packed rows (4x less traffic), and only the k_budget survivor
        rows are ever unpacked. Bit-identical to the unpack path: the
        sampled position set {0, stride, ...} maps exactly onto phases
        range(0, 4, stride) of bytes 0..L/4-4, and the LE-keyed bitmap
        holds the same membership set."""
        B, Lq = packed.shape
        W = jax.lax.bitcast_convert_type(
            packed.reshape(B, Lq // 4, 4), jnp.uint32)
        Wn = jnp.pad(W[:, 1:], ((0, 0), (0, 1)))      # next word, 0-padded
        hits = _packed_hits(W, Wn, lens, range(0, 16, stride))
        fail = hits < min_hits
        order = jnp.argsort(fail, stable=True)          # passing rows first
        kb = min(k_budget, B)
        top = order[:kb]
        sub_codes = _unpack_nomask_rows(packed[top])    # unpack kb rows only
        sub_lens = lens[top]
        dist_f, dist_r = _myers_top(sub_codes, sub_lens)
        sentinel = jnp.full((B,), m, jnp.int32)
        sub_ok = ~fail[top]
        df = sentinel.at[top].set(jnp.where(sub_ok, dist_f, m))
        dr = sentinel.at[top].set(jnp.where(sub_ok, dist_r, m))
        n_pass = jnp.sum((~fail).astype(jnp.int32))
        return jnp.concatenate([df, dr, hits, n_pass.reshape(1)])

    def _fused_body(codes, lens):
        from centroflye_tpu.ops.seed_filter import seed_hit_counts_bitmap
        B = codes.shape[0]
        hits = seed_hit_counts_bitmap(seed_bitmap, codes, lens,
                                      k=seed_k, stride=stride)
        fail = hits < min_hits
        order = jnp.argsort(fail, stable=True)          # passing rows first
        kb = min(k_budget, B)
        top = order[:kb]
        sub_codes = codes[top]
        sub_lens = lens[top]
        dist_f, dist_r = _myers_top(sub_codes, sub_lens)
        sentinel = jnp.full((B,), m, jnp.int32)
        sub_ok = ~fail[top]
        df = sentinel.at[top].set(jnp.where(sub_ok, dist_f, m))
        dr = sentinel.at[top].set(jnp.where(sub_ok, dist_r, m))
        n_pass = jnp.sum((~fail).astype(jnp.int32))
        # ONE bundled output array -> one device->host transfer
        return jnp.concatenate(
            [df, dr, hits, n_pass.reshape(1)])

    def _unpack_nomask(packed):
        # no in-range N bases in this batch: unpack without the mask
        # (pack_2bit packs don't-care positions as base 0; the filter and
        # the kernels never look past `lens`)
        B, Lq = packed.shape
        parts = [((packed >> (2 * i)) & 3).astype(jnp.int8)
                 for i in range(4)]
        return jnp.stack(parts, axis=-1).reshape(B, Lq * 4)

    _unpack_nomask_rows = _unpack_nomask

    n_dev = 1
    if mesh is not None and mesh.devices.size > 1:
        # multi-chip: shard batch rows over the mesh data axis — the
        # per-shard bodies (filter + compaction + Myers on each shard's
        # survivors) are independent, the device analogue of the reference's
        # process fan-out (run_read_recruitment.sh:35-44); the bundle is
        # shard-blocked [df|dr|hits|n_pass]*n_dev and re-ordered on host
        from jax import shard_map
        from jax.sharding import PartitionSpec as SP
        n_dev = int(mesh.devices.size)

        def _body_masked(packed, n_mask, lens):
            return _fused_body(_unpack_2bit(packed, n_mask), lens)

        def _body_nomask(packed, lens):
            if packed_path_ok:
                return _fused_body_packed(packed, lens)
            return _fused_body(_unpack_nomask(packed), lens)

        axis = mesh.axis_names[0]
        fused_masked = jax.jit(shard_map(
            _body_masked, mesh=mesh,
            in_specs=(SP(axis, None), SP(axis, None), SP(axis)),
            out_specs=SP(axis), check_vma=False))
        fused_nomask = jax.jit(shard_map(
            _body_nomask, mesh=mesh,
            in_specs=(SP(axis, None), SP(axis)),
            out_specs=SP(axis), check_vma=False))
    else:
        @jax.jit
        def fused_masked(packed, n_mask, lens):
            return _fused_body(_unpack_2bit(packed, n_mask), lens)

        @jax.jit
        def fused_nomask(packed, lens):
            if packed_path_ok:
                return _fused_body_packed(packed, lens)
            return _fused_body(_unpack_nomask(packed), lens)

    def fused_raw(packed, n_mask, lens):
        """Async: returns the bundled DEVICE array (no transfer). Layout:
        [df(B), dr(B), hits(B), n_pass(1)] single-device, or that layout
        per shard block when sharded."""
        if n_mask is None:
            return fused_nomask(packed, lens)
        return fused_masked(packed, n_mask, lens)

    def unbundle(out: np.ndarray, B: int):
        """-> (df, dr, hits, n_pass); sharded n_pass is the max over the
        per-shard blocks (the host overflow rule applies per shard)."""
        blocks = out.reshape(n_dev, -1)
        Bs = B // n_dev
        df = blocks[:, :Bs].reshape(B)
        dr = blocks[:, Bs:2 * Bs].reshape(B)
        hits = blocks[:, 2 * Bs:3 * Bs].reshape(B)
        return df, dr, hits, int(blocks[:, 3 * Bs].max())

    def fused_unbundled(packed, n_mask, lens):
        out = np.asarray(fused_raw(packed, n_mask, lens))
        return unbundle(out, lens.shape[0])

    fused_unbundled.raw = fused_raw
    fused_unbundled.unbundle = unbundle
    fused_unbundled.min_hits = min_hits      # in sampled-position units
    fused_unbundled.stride = stride
    fused_unbundled.n_dev = n_dev
    return fused_unbundled
