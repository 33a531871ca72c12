"""Placement tests: mini cenX stage-3 on a simulated tandem repeat; the
greedy placement must recover every read's true unit offset, and the
incremental scorer must agree with the slow oracle (the reference's own
dual-implementation check, cloud_contig.py:146-155)."""

import numpy as np
import pytest

from centroflye_tpu.config import (
    KmerRecruitmentConfig, PlacerConfig, UnitDecompositionConfig,
)
from centroflye_tpu.pipeline.simulate import (
    gen_random_seq, simulate_tandem_repeat,
)
from centroflye_tpu.stages.unit_decomposition import UnitDecomposer
from centroflye_tpu.stages.rare_kmers import get_rare_kmers
from centroflye_tpu.stages.kmer_cloud import (
    build_read_clouds, filter_read_clouds, pad_clouds,
)
from centroflye_tpu.stages.distance_graph import recruit_unique_kmers
from centroflye_tpu.stages.cloud_contig import map_reads_fast
from centroflye_tpu.stages.read_placer import (
    ReadPlacer, read_positions_file,
)

K = 13
UNIT = 200
MULT = 40
FLANK = 6000


@pytest.fixture(scope="module")
def pipeline_state():
    rng = np.random.default_rng(7)
    unit = gen_random_seq(rng, UNIT)
    sim = simulate_tandem_repeat(rng, unit, mult=MULT, div_rate=0.02,
                                 flank_len=FLANK)
    g = sim.flanked_tr
    tr_start = FLANK
    tr_end = FLANK + len(sim.tr)

    reads = []
    true_offset = {}
    # several prefix reads (min_cloud_kmer_freq=2 needs >= 2 reads sharing
    # each position before any k-mer becomes frequent, like the real data's
    # multiple boundary-spanning reads)
    for pi, left in enumerate([3000, 2600, 2200]):
        reads.append((f"pre{pi}", g[tr_start - left:tr_start + 8 * UNIT]))
        true_offset[f"pre{pi}"] = 0
    # internal reads tiling the repeat
    i = 0
    start = tr_start + 150
    while start + 3000 < tr_end - 200:
        reads.append((f"int{i:02d}", g[start:start + 3000]))
        # first instance index: a leading partial unit longer than 0.2*UNIT
        # is kept as an instance (NCRF partial patching semantics), so the
        # read places at floor; otherwise at ceil
        lead_mod = (start - tr_start) % UNIT
        if lead_mod and (UNIT - lead_mod) > 0.2 * UNIT:
            true_offset[f"int{i:02d}"] = (start - tr_start) // UNIT
        else:
            true_offset[f"int{i:02d}"] = -((start - tr_start) // -UNIT)
        start += 700
        i += 1
    # suffix read: starts inside the repeat, long right flank
    suf_start = tr_end - 8 * UNIT
    reads.append(("suf", g[suf_start:tr_end + 3000]))
    true_offset["suf"] = (suf_start - tr_start) // UNIT

    dec = UnitDecomposer(
        unit, UnitDecompositionConfig(min_record_len=1000)).decompose(reads)
    assert set(dec.records) == {r_id for r_id, _ in reads}

    cfg = KmerRecruitmentConfig(k=K, min_distance=1, max_distance=5,
                                min_coverage=2, bottom=0.0, top=1e9)
    records = {r: dec.records[r] for r in sorted(dec.records)}
    seqs = [rec.seq for rec in records.values()]
    rare = get_rare_kmers(seqs, cfg, coverage=1, batch_rows=8)
    clouds_rare = build_read_clouds(records, rare, K)
    _, tensor, n_units, _ = pad_clouds(clouds_rare, sorted(records))
    uniq_codes, edges = recruit_unique_kmers(
        tensor, n_units, rare, cfg, capacity=1 << 20, entry_chunk=16)
    assert len(uniq_codes) > 50

    clouds = build_read_clouds(records, uniq_codes, K)
    clouds = filter_read_clouds(clouds, min_mult=2)
    return dict(unit=unit, sim=sim, dec=dec, clouds=clouds,
                true_offset=true_offset)


def test_placement_recovers_true_offsets(pipeline_state, tmp_path):
    st = pipeline_state
    placer = ReadPlacer(PlacerConfig(
        min_cloud_kmer_freq=2, min_kmer_mult=2, min_unit=2, min_inters=5,
        min_prop=3, prefix_threshold=2500, small_threshold=1000))
    placements = placer.run(st["dec"], st["clouds"])
    placed = {r: p for r, p in placements.items() if p is not None}
    # every read must be placed at its true unit offset
    assert set(placed) == set(st["true_offset"])
    for r_id, want in st["true_offset"].items():
        assert placed[r_id] == want, (r_id, placed[r_id], want)

    out_fn = str(tmp_path / "read_positions.csv")
    placer.write_positions(out_fn)
    parsed = read_positions_file(out_fn)
    assert parsed == placements


def test_fast_scorer_matches_slow_oracle(pipeline_state):
    st = pipeline_state
    placer = ReadPlacer(PlacerConfig(
        min_cloud_kmer_freq=2, min_unit=2, min_inters=5,
        prefix_threshold=2500))
    placer.run(st["dec"], st["clouds"])
    positions, scores, mismatches = map_reads_fast(
        placer.contig, st["clouds"], threshold=(2, 5), debug=True)
    # NB: the reference's fast scorer legitimately over-counts (kmer, pos)
    # pairs where a kmer is frequent somewhere else on the contig (reference
    # builds its freq list from kmer_positions, cloud_contig.py:126-128, not
    # from freq_clouds); the reference only PRINTS such mismatches
    # (cloud_contig.py:153-155). The invariant that must hold: fast never
    # undercounts the slow oracle.
    for r_id, fast_score, slow_score, fast_pos, slow_pos in mismatches:
        assert fast_score >= slow_score, (r_id, fast_score, slow_score)
    assert len(mismatches) <= 1
    # placed reads generally re-map to their placement position (ties can
    # legitimately resolve to a different equal-score position against the
    # final contig, so require a strong majority, not equality)
    placed = {r: p for r, p in placer.placements.items() if p is not None}
    same = sum(1 for r_id, pos in placed.items()
               if positions.get(r_id) == pos)
    assert same >= 0.8 * len(placed)


def test_fast_placer_matches_dict_oracle(pipeline_state):
    """The production array/device placer must reproduce the dict oracle
    (the near-verbatim reference loop) placement-for-placement,
    score-for-score."""
    st = pipeline_state
    cfg = PlacerConfig(
        min_cloud_kmer_freq=2, min_kmer_mult=2, min_unit=2, min_inters=5,
        min_prop=3, prefix_threshold=2500, small_threshold=1000)
    fast = ReadPlacer(cfg, use_fast=True)
    slow = ReadPlacer(cfg, use_fast=False)
    pf = dict(fast.run(st["dec"], st["clouds"]))
    ps = dict(slow.run(st["dec"], st["clouds"]))
    assert pf == ps
    assert fast.scores == slow.scores


def test_fast_placer_random_parity():
    """Adversarial randomized parity: synthetic clouds with heavy score
    ties exercise every tie-break branch (score, rightmost pos, smallest
    r_id) of the greedy loop."""
    from centroflye_tpu.stages.cloud_contig import CloudContig
    from centroflye_tpu.stages.kmer_cloud import ReadClouds
    from centroflye_tpu.stages.placement_fast import FastPlacer
    from centroflye_tpu.stages.read_placer import ReadPlacer as RP

    for seed in range(6):
        rng = np.random.default_rng(seed)
        n_kmers = 30
        T_contig = 12
        cfg = PlacerConfig(min_cloud_kmer_freq=2, min_unit=1, min_inters=2,
                           min_prop=1)

        def mk_read(r_id, n_units, lo=2, hi=5):
            clouds = []
            for _ in range(n_units):
                sz = int(rng.integers(lo, hi))
                clouds.append(np.sort(rng.choice(
                    n_kmers, size=sz, replace=False)).astype(np.int64))
            return ReadClouds(r_id=r_id, clouds=clouds)

        # seed contig with 3 overlapping prefix reads (freq needs 2x)
        seeds = [mk_read(f"p{i}", T_contig) for i in range(3)]
        reads_clouds = {}
        names = []
        for i in range(10):
            r = mk_read(f"r{i:02d}", int(rng.integers(3, 7)))
            reads_clouds[r.r_id] = r
            names.append(r.r_id)
        # duplicate clouds to force exact ties between different reads
        dup = ReadClouds(r_id="r99", clouds=[c.copy() for c in
                                             reads_clouds["r00"].clouds])
        reads_clouds["r99"] = dup
        names.append("r99")

        def build_contig():
            c = CloudContig(cfg.min_cloud_kmer_freq)
            for s in seeds:
                c.add_read(s, position=0)
            return c

        contig_f = build_contig()
        fp = FastPlacer(contig_f, names, reads_clouds, cfg)
        got_p, got_s = fp.run()

        slow = RP(cfg, use_fast=False)
        slow.contig = build_contig()
        slow._add_reads_oracle(names, reads_clouds)
        want_p = {r: slow.placements.get(r) for r in names}
        want_s = slow.scores
        assert got_p == want_p, (seed, got_p, want_p)
        assert got_s == want_s, (seed, got_s, want_s)


def test_matmul_scorer_matches_popcount_scorer():
    """The matmul formulation must reproduce the bitmap popcount
    correlation count-for-count (bf16 one-hots are exact 0/1, f32
    accumulation exact below 2^24)."""
    from centroflye_tpu.ops.scoring import (
        clouds_to_bitmaps, placement_scores, placement_scores_matmul)

    rng = np.random.default_rng(5)
    R, T, K, V, P = 7, 6, 5, 97, 23
    clouds = np.where(rng.random((R, T, K)) < 0.7,
                      rng.integers(0, V, size=(R, T, K)), -1).astype(np.int32)
    # dedupe within each cloud (cloud k-mer sets are unique by contract)
    for r in range(R):
        for t in range(T):
            c = clouds[r, t]
            seen = set()
            for i, v in enumerate(c):
                if v in seen:
                    c[i] = -1
                seen.add(int(v))
    n_pairs = 60
    ck = rng.integers(0, V, size=n_pairs)
    cp = rng.integers(0, P + 4, size=n_pairs)   # some beyond P: ignored
    uniq = sorted(set(zip(ck.tolist(), cp.tolist())))
    ck = np.array([u[0] for u in uniq], np.int32)
    cp = np.array([u[1] for u in uniq], np.int32)

    bm = np.zeros((P, max(1, -(-V // 32))), np.uint32)
    for v, p in uniq:
        if p < P:
            bm[p, v // 32] |= np.uint32(1) << np.uint32(v % 32)
    s0_pc, s1_pc = placement_scores(clouds_to_bitmaps(clouds, V), bm)
    s0_mm, s1_mm = placement_scores_matmul(clouds, ck, cp,
                                           n_kmers=V, n_pos=P)
    np.testing.assert_array_equal(np.asarray(s0_pc), np.asarray(s0_mm))
    np.testing.assert_array_equal(np.asarray(s1_pc), np.asarray(s1_mm))


def test_array_contig_matches_dict_contig():
    """ArrayContig (production, sorted key table) must agree with the
    dict-of-Counters CloudContig oracle on every observable: the newly
    frequent (kmer, pos) pairs returned per add_read, max_pos, the
    frequent-k-mer set, per-k-mer position sets, frequent clouds, and the
    materialized-position count."""
    from centroflye_tpu.stages.cloud_contig import CloudContig
    from centroflye_tpu.stages.kmer_cloud import ReadClouds
    from centroflye_tpu.stages.placement_fast import ArrayContig

    for seed in range(4):
        rng = np.random.default_rng(100 + seed)
        ac = ArrayContig(min_cloud_kmer_freq=2)
        cc = CloudContig(min_cloud_kmer_freq=2)
        for ridx in range(12):
            n_units = int(rng.integers(1, 8))
            clouds = []
            for _ in range(n_units):
                sz = int(rng.integers(0, 6))
                clouds.append(np.sort(rng.choice(
                    25, size=sz, replace=False)).astype(np.int64))
            rc = ReadClouds(r_id=f"r{ridx}", clouds=clouds)
            pos = int(rng.integers(0, 10))
            got = ac.add_read(rc, position=pos)
            want = cc.add_read(rc, position=pos)
            assert sorted(got) == sorted(want), (seed, ridx)
            assert ac.max_pos == cc.max_pos
        assert ac.freq_kmers == cc.freq_kmers
        kp_a, kp_c = ac.kmer_positions, cc.kmer_positions
        assert {k: v for k, v in kp_c.items() if v} == dict(kp_a)
        fc_a, fc_c = ac.freq_clouds, cc.freq_clouds
        assert {p: s for p, s in fc_c.items() if s} == dict(fc_a)
        assert len(ac.clouds) == len(cc.clouds)
        assert ac.read_positions == cc.read_positions
