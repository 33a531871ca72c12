"""Seed prefilter + fused recruitment step tests (CPU)."""

import numpy as np
import pytest

from centroflye_tpu.io import encode, encode_batch
from centroflye_tpu.io.encoding import revcomp_str
from centroflye_tpu.ops.seed_filter import (
    build_seed_table, build_seed_bitmap, seed_hit_counts,
    seed_hit_counts_bitmap,
)
from centroflye_tpu.ops.fused_recruit import (
    pack_2bit, _unpack_2bit, make_fused_recruit,
)
from centroflye_tpu.ops.myers import build_peq, edit_distance_oracle
from centroflye_tpu.ops.myers_cuda import myers_hw_2strand_xla
from centroflye_tpu.pipeline.simulate import gen_random_seq, add_read_noise

K = 11


def oracle_hits(unit, seq, k, stride=1):
    doubled = unit + unit[:k - 1]
    seeds = {doubled[i:i + k] for i in range(len(doubled) - k + 1)}
    rc = revcomp_str(doubled)
    seeds |= {rc[i:i + k] for i in range(len(rc) - k + 1)}
    n = 0
    for i in range(0, len(seq) - k + 1, stride):
        if seq[i:i + k] in seeds:
            n += 1
    return n


def test_seed_counts_vs_oracle(rng):
    unit = gen_random_seq(rng, 150)
    reads = [add_read_noise(rng, unit * 3, 0.1),
             gen_random_seq(rng, 400),
             revcomp_str(add_read_noise(rng, unit * 2, 0.05))]
    codes, lens = encode_batch(reads, max_len=512)
    hi, lo = build_seed_table(unit, K)
    got = np.asarray(seed_hit_counts(hi, lo, codes, lens, k=K))
    bm = build_seed_bitmap(unit, K)
    got_bm = np.asarray(seed_hit_counts_bitmap(bm, codes, lens, k=K))
    for i, r in enumerate(reads):
        want = oracle_hits(unit, r, K)
        assert got[i] == want, i
        assert got_bm[i] == want, i
    # tandem reads have many hits; random read has few
    assert got[0] > 50 and got[2] > 30
    assert got[1] < 10


def test_seed_bitmap_stride(rng):
    unit = gen_random_seq(rng, 150)
    read = add_read_noise(rng, unit * 3, 0.05)
    codes, lens = encode_batch([read], max_len=512)
    bm = build_seed_bitmap(unit, K)
    got = np.asarray(seed_hit_counts_bitmap(bm, codes, lens, k=K,
                                            stride=3))[0]
    assert got == oracle_hits(unit, read, K, stride=3)


def test_pack_unpack_roundtrip(rng):
    codes = rng.integers(0, 5, size=(4, 64)).astype(np.int8)
    packed, n_mask = pack_2bit(codes)
    # bytes per row: 64/4 = 16 codes + 8 mask
    assert packed.shape == (4, 16) and n_mask.shape == (4, 8)
    back = np.asarray(_unpack_2bit(packed, n_mask))
    want = np.where(codes >= 4, 4, codes)
    assert np.array_equal(back, want)


def test_fused_recruit_matches_plain(rng):
    unit = gen_random_seq(rng, 128)
    m = len(unit)
    from centroflye_tpu.io.encoding import revcomp, encode as enc
    peq_f = build_peq(enc(unit))
    peq_r = build_peq(revcomp(enc(unit)))
    bm = build_seed_bitmap(unit, K)

    reads = [add_read_noise(rng, unit * 3, 0.08) if i % 5 == 0
             else gen_random_seq(rng, 400) for i in range(16)]
    codes, lens = encode_batch(reads, max_len=512)
    packed, n_mask = pack_2bit(codes)
    fused = make_fused_recruit(bm, peq_f, peq_r, m=m, seed_k=K,
                               min_hits=6, k_budget=8, stride=1,
                               scorer=myers_hw_2strand_xla)
    df, dr, hits, n_pass = fused(packed, n_mask, lens)
    df, dr = np.asarray(df), np.asarray(dr)
    assert int(n_pass) <= 8
    for i, r in enumerate(reads):
        want_f, _ = edit_distance_oracle(unit, r, mode="HW")
        if i % 5 == 0:
            # tandem reads pass the filter and get exact distances
            assert df[i] == want_f, i
        else:
            # filtered rows carry the sentinel m
            assert df[i] == m and dr[i] == m


def test_engine_prefilter_equals_exact(rng):
    from centroflye_tpu.config import RecruitmentConfig
    from centroflye_tpu.stages.recruitment import RecruitmentEngine
    unit = gen_random_seq(rng, 200)
    reads = []
    for i in range(24):
        if i % 6 == 0:
            reads.append((f"cen{i}", add_read_noise(rng, unit * 5, 0.08)))
        else:
            reads.append((f"bg{i}", gen_random_seq(rng, 1200)))
    base = dict(threshold=50, batch_size=8)
    exact = RecruitmentEngine(
        unit, RecruitmentConfig(prefilter=False, **base), seg_len=2048)
    filt = RecruitmentEngine(
        unit, RecruitmentConfig(prefilter=True, min_seed_hits=4, **base),
        seg_len=2048)
    res_e = {r.r_id: r.recruited for r in exact.run(reads)}
    res_f = {r.r_id: r.recruited for r in filt.run(reads)}
    assert res_e == res_f
    assert sum(res_e.values()) == 4


def test_pack_nomask_when_pad_only_beyond_lens(rng):
    """With lens given, PAD beyond the row length must not force the N
    mask (it is don't-care for both the filter and the kernels), and the
    fused nomask path must agree with the masked path."""
    unit = gen_random_seq(rng, 128)
    m = len(unit)
    from centroflye_tpu.io.encoding import revcomp, encode as enc
    peq_f = build_peq(enc(unit))
    peq_r = build_peq(revcomp(enc(unit)))
    bm = build_seed_bitmap(unit, K)
    reads = [add_read_noise(rng, unit * 3, 0.08) if i % 4 == 0
             else gen_random_seq(rng, 300 + 13 * i) for i in range(8)]
    codes, lens = encode_batch(reads, max_len=512)
    packed_nm, n_mask_nm = pack_2bit(codes, lens)
    assert n_mask_nm is None          # no in-range Ns in these reads
    packed, n_mask = pack_2bit(codes)
    assert n_mask is not None         # PAD beyond lens without lens info
    fused = make_fused_recruit(bm, peq_f, peq_r, m=m, seed_k=K,
                               min_hits=6, k_budget=8, stride=1,
                               scorer=myers_hw_2strand_xla)
    got_masked = fused(packed, n_mask, lens)
    got_nomask = fused(packed_nm, None, lens)
    for a, b in zip(got_masked, got_nomask):
        assert np.array_equal(np.asarray(a), np.asarray(b))

    # a genuine in-range N still produces a mask
    codes2 = codes.copy()
    codes2[0, 5] = 4
    _, n_mask2 = pack_2bit(codes2, lens)
    assert n_mask2 is not None


def test_bitmap_scatter_no_bit_loss():
    """np.bitwise_or.at is collision-safe: every distinct seed k-mer of
    the unit (both strands, instance-crossing included) must have its bit
    set — fancy-index `|=` silently drops bits when two codes share a
    bitmap word (263 of DXZ1's 3670 seed bits were lost that way)."""
    from centroflye_tpu.io.encoding import kmer_codes, encode as enc
    from centroflye_tpu.io import read_seq
    import os
    unit = read_seq(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "centroflye_tpu", "data", "DXZ1_rc.fasta"))
    k = 13
    bm = build_seed_bitmap(unit, k=k)
    for s in (unit + unit[:k - 1], revcomp_str(unit + unit[:k - 1])):
        c, valid = kmer_codes(enc(s), k)
        c = c[valid].astype(np.uint64)
        assert bool(np.all(
            (bm[(c >> np.uint64(5)).astype(np.int64)]
             >> (c & np.uint64(31)).astype(np.uint32)) & 1))


def test_host_prescan_matches_device_phase0(rng):
    """The numpy host prescan must be bit-identical to the device packed
    filter restricted to in-word phase 0 (one sample per 16 bases) — the
    engine's accept set depends on this equivalence."""
    from centroflye_tpu.ops.seed_filter import host_prescan_hits
    unit = gen_random_seq(rng, 500)
    bm_le = build_seed_bitmap(unit, k=13, le=True)
    B, L = 64, 2048
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    for i in (3, 7, 20, 40):   # plant noisy unit windows
        w = encode(add_read_noise(rng, unit, 0.12))
        codes[i, 64:64 + len(w)] = w
    lens = rng.integers(16, L + 1, size=B).astype(np.int32)
    packed, n_mask = pack_2bit(codes, lens)
    assert n_mask is None
    hits = host_prescan_hits(packed, lens, bm_le, k=13)
    # oracle: brute-force over positions 0, 16, 32, ... of each row
    kmers = {unit[i:i + 13] for i in range(len(unit) - 12)}
    from centroflye_tpu.io.encoding import revcomp_str
    rc = revcomp_str(unit)
    kmers |= {rc[i:i + 13] for i in range(len(rc) - 12)}
    from centroflye_tpu.io.encoding import decode
    for r in range(B):
        s = decode(codes[r, :lens[r]])
        want = sum(s[p:p + 13] in kmers
                   for p in range(0, int(lens[r]) - 12, 16))
        assert int(hits[r]) == want, r
    assert all(int(hits[i]) > 0 for i in (3, 7, 20, 40))


def test_engine_candidate_overflow_falls_back_exact(rng):
    """When prescan candidates exceed the device batch repeatedly and the
    fused survivor budget overflows, the engine must route rows through
    the exact Myers tier — the recruited set still equals the
    no-prefilter engine's."""
    from centroflye_tpu.config import RecruitmentConfig
    from centroflye_tpu.stages.recruitment import RecruitmentEngine
    unit = gen_random_seq(rng, 200)
    reads = [(f"cen{i}", add_read_noise(rng, unit * 5, 0.08))
             for i in range(12)]           # all centromeric: every row is
    reads += [(f"bg{i}", gen_random_seq(rng, 1200)) for i in range(4)]
    # one read with N bases: must take the exact tier, not the prescan
    noisy = list(add_read_noise(rng, unit * 5, 0.08))
    noisy[37] = "N"
    reads.append(("cenN", "".join(noisy)))
    base = dict(threshold=50, batch_size=8)
    exact = RecruitmentEngine(
        unit, RecruitmentConfig(prefilter=False, **base), seg_len=2048)
    filt = RecruitmentEngine(
        unit, RecruitmentConfig(prefilter=True, min_seed_hits=4, **base),
        seg_len=2048)
    # cand_batch is already 8 here (13 candidates -> multiple flushes);
    # a tiny survivor budget forces the exact-tier overflow fallback
    filt.k_budget = 2
    res_e = {r.r_id: r.recruited for r in exact.run(reads)}
    res_f = {r.r_id: r.recruited for r in filt.run(reads)}
    assert res_e == res_f
    assert sum(res_f.values()) == 13


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_fused_packed_filter_matches_unpack_path(rng, stride):
    """The packed-direct filter (LE bitmap, u32-word k-mer extraction,
    packed survivor gather) must produce a bundle bit-identical to the
    unpack path on no-N batches — same sampled positions, same hits,
    same survivor order, same distances."""
    import jax.numpy as jnp
    from centroflye_tpu.io import read_seq, encode as enc2
    from centroflye_tpu.io.encoding import revcomp
    import os
    unit = read_seq(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "centroflye_tpu", "data", "DXZ1_rc.fasta"))
    m = len(unit)
    uc = encode(unit)
    peq_f = build_peq(uc)
    peq_r = build_peq(revcomp(uc))
    bm = build_seed_bitmap(unit, k=13)
    bm_le = build_seed_bitmap(unit, k=13, le=True)
    B, L = 32, 1024
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    codes[3, 50:50 + 800] = encode(unit)[:800]
    lens = rng.integers(500, L + 1, size=B).astype(np.int32)
    lens[0] = 0
    lens[1] = 13
    old = make_fused_recruit(bm, peq_f, peq_r, m=m, seed_k=13,
                             min_hits=8, k_budget=8, stride=stride,
                             scorer=myers_hw_2strand_xla)
    new = make_fused_recruit(bm, peq_f, peq_r, m=m, seed_k=13,
                             min_hits=8, k_budget=8, stride=stride,
                             scorer=myers_hw_2strand_xla,
                             seed_bitmap_le=bm_le)
    packed, n_mask = pack_2bit(codes, lens)
    assert n_mask is None
    a = np.asarray(old.raw(packed, None, jnp.asarray(lens)))
    b = np.asarray(new.raw(packed, None, jnp.asarray(lens)))
    assert np.array_equal(a, b)


def test_engine_numpy_fallback_fill_matches(rng, monkeypatch):
    """With the native fill disabled, the numpy accumulate-then-pack path
    must recruit the same set (covers environments without the .so)."""
    import centroflye_tpu.native as native
    from centroflye_tpu.config import RecruitmentConfig
    from centroflye_tpu.stages.recruitment import RecruitmentEngine
    unit = gen_random_seq(rng, 200)
    reads = [(f"cen{i}", add_read_noise(rng, unit * 5, 0.08))
             for i in range(6)]
    reads += [(f"bg{i}", gen_random_seq(rng, 1200)) for i in range(6)]
    noisy = list(add_read_noise(rng, unit * 5, 0.08))
    noisy[37] = "N"
    reads.append(("cenN", "".join(noisy)))
    cfg = RecruitmentConfig(threshold=50, batch_size=8, min_seed_hits=4)
    eng = RecruitmentEngine(unit, cfg, seg_len=2048)
    res_native = {r.r_id: r.recruited for r in eng.run(reads)}
    monkeypatch.setattr(native, "get_encode_pack", lambda: None)
    eng2 = RecruitmentEngine(unit, cfg, seg_len=2048)
    res_np = {r.r_id: r.recruited for r in eng2.run(reads)}
    assert res_native == res_np
    assert sum(res_np.values()) == 7
