"""cen6 (centroFlyeMono) benchmark at rel3-like proportions.

The reference's cen6 envelope (README.md:172-213): rel3 is a ~29M-read,
120x ultra-long set; StringDecomposer runs 9 h on 50 threads over the
recruited reads, then centroFlyeMono assembles the monomer-space reads
in ~30 min single-process. The real D6Z1 HOR is 18 monomers (~171 bp
each, supplementary_data/D6Z1_monomers.fasta); cen6 itself is a
~2.5-3 Mbp array (~800 HOR copies).

Two measured parts, matching the reference's own stage boundary (the SD
TSV handoff, centroFlyeMono.py:56-61):

A. MONOMER DECOMPOSITION (StringDecomposer role, mono/string_decomposer):
   a nucleotide slice of the array at 120x with ONT-like noise, both
   strands, decomposed with the real 18 D6Z1 monomers; reports monomer
   calls/s + reads/s, call accuracy vs ground truth, and the implied
   wall-clock for the full rel3 cen6 read set (~26k reads, 360 Mbp).
   Runs on whatever jax backend is default (the GPU where there is one);
   a multi-device mesh shards the alignment batches.

B. MONO ASSEMBLY (centroFlyeMono role): the FULL-PROPORTION array
   (n_hor HOR copies, default 800 = 14,400 monomers) at 120x in
   monomer space: error_correction -> iterative_graph(k=100..400) ->
   map_reads -> scaffolding, checked against the ground-truth symbol
   array; wall-clock vs the reference's 30-min envelope (which includes
   its per-pseudounit Flye polish; our polish is measured separately in
   part A's full-chain mode and bench_polisher.py).

Run: python benchmarks/bench_mono_cen6.py [n_hor] [coverage] [slice_hor]
Defaults: 800 120 24.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from centroflye_tpu.config import MonoConfig
from centroflye_tpu.io import read_seqs
from centroflye_tpu.io.encoding import revcomp_str
from centroflye_tpu.mono.monostring import MonoString, GAP
from centroflye_tpu.mono.string_decomposer import decompose_to_monostrings
from centroflye_tpu.mono.error_correction import error_correction
from centroflye_tpu.mono.scaffolding import (
    iterative_graph, scaffolding,
)
from centroflye_tpu.pipeline.simulate import add_read_noise

N_MONO = 18


def build_symbol_genome(rng, n_hor, variant_every=24):
    """HOR array with scattered monomer-substitution variants (the real
    D6Z1 array's HOR variation, which is what makes k in [100, 400]
    monomer-space k-mers position-unique). Spacing must stay below the
    k sweep's floor (100) for unique coverage to be contiguous —
    otherwise no edge reaches the min_uniq_len=1000 scaffold-anchor
    bar (the real array's per-copy divergence is denser still)."""
    syms = np.tile(np.arange(N_MONO, dtype=np.int16), n_hor)
    n_var = len(syms) // variant_every
    marks = rng.choice(len(syms), size=n_var, replace=False)
    for pos in marks:
        cur = int(syms[pos])
        alt = [x for x in range(N_MONO) if x != cur]
        syms[pos] = alt[int(rng.integers(0, N_MONO - 1))]
    return syms


def read_length_mix(rng, n):
    """rel3-like ULTRA-LONG mix in monomers (~171 bp each): rel3 is the
    120x ultra-long flowcell set (reference README.md:154) — recruited
    cen6 reads run ~50 kb mean with a tail past 250 kb. Length matters
    STRUCTURALLY here, not just for coverage: scaffolding connects
    unique edges through reads mapped on the FINAL k=400 graph
    (centroFlyeMono.py:78-83), and a read maps only if it is longer
    than k monomers (~68 kb) — with a short-read mix the connection
    graph starves at ~1 valid path per 4,000 reads (measured) and
    scaffolds cannot join, on the reference's algorithm as much as
    ours. ~30% of this mix exceeds 400 monomers."""
    ul = rng.random(n) < 0.3
    lens = np.where(ul,
                    rng.lognormal(np.log(700), 0.5, n),
                    rng.lognormal(np.log(280), 0.55, n))
    return np.clip(lens, 30, 2000).astype(np.int64)


def simulate_monoreads(rng, genome_syms, coverage, gap_rate=0.02):
    """Monomer-space reads as the SD handoff would deliver them:
    unreliable calls are gap symbols; '-' strand reads are flipped
    (sd_parser canonicalizes them back on read)."""
    L = len(genome_syms)
    mean_len = 430.0              # the UL mix's realized mean
    n_reads = int(coverage * L / mean_len)
    lens = read_length_mix(rng, n_reads)
    starts = rng.integers(-50, L - 20, size=n_reads)
    out = {}
    for i in range(n_reads):
        s = max(0, int(starts[i]))
        e = min(L, s + int(lens[i]))
        if e - s < 30:
            continue
        syms = genome_syms[s:e].astype(np.int16)
        gaps = rng.random(len(syms)) < gap_rate
        syms = np.where(gaps, np.int16(GAP), syms)
        nucl = np.full((len(syms), 2), -1, np.int32)
        out[f"m{i:06d}"] = MonoString(
            name=f"m{i:06d}", syms=syms, nucl=nucl,
            n_monomers=N_MONO, strand="+")
    return out


def part_a_decomposition(rng, monomers, slice_hor, coverage, noise=0.08):
    mono_seqs = list(monomers.values())
    hor_nucl = "".join(mono_seqs)
    genome = hor_nucl * slice_hor
    truth = np.tile(np.arange(N_MONO, dtype=np.int16), slice_hor)
    mono_len = len(hor_nucl) / N_MONO

    n_reads = int(coverage * len(genome) / 14_000)
    reads, spans = [], []
    for i in range(n_reads):
        s = int(rng.integers(0, max(1, len(genome) - 14_000)))
        e = min(len(genome), s + 14_000)
        seq = add_read_noise(rng, genome[s:e], noise)
        strand = "+" if rng.random() < 0.5 else "-"
        if strand == "-":
            seq = revcomp_str(seq)
        reads.append((f"r{i:04d}", seq))
        spans.append((s, e, strand))

    t0 = time.time()
    rep = decompose_to_monostrings(monomers, reads)
    dt = time.time() - t0

    # call accuracy via each call's own nucleotide span (indel-robust:
    # a dropped/extra call cannot shift the frame of later calls);
    # '+'-strand reads only — their nucl coords map straight to genome
    n_calls = n_correct = 0
    for i, (r_id, _) in enumerate(reads):
        ms = rep.monostrings.get(r_id)
        if ms is None:
            continue
        s, e, strand = spans[i]
        if strand != "+":
            continue
        for sym, (n_st, n_en) in zip(ms.syms, ms.nucl):
            if sym == GAP or n_st < 0:
                continue
            t = int(round((s + (n_st + n_en) / 2) / mono_len - 0.5))
            if 0 <= t < len(truth):
                n_calls += 1
                n_correct += int(sym % N_MONO == truth[t] % N_MONO)
    total_bp = sum(len(s) for _, s in reads)
    total_monomers = int(total_bp / mono_len)
    acc = n_correct / max(n_calls, 1)
    rel3_cen6_bp = 360e6             # ~120x over a ~3 Mbp array
    return {
        "reads": len(reads),
        "read_bp": total_bp,
        "noise": noise,
        "wall_s": round(dt, 1),
        "monomer_calls_per_s": round(total_monomers / dt, 1),
        "read_bp_per_s": round(total_bp / dt, 1),
        "call_accuracy": round(acc, 4),
        "implied_rel3_cen6_hours": round(
            rel3_cen6_bp / (total_bp / dt) / 3600, 2),
        "reference_envelope": "StringDecomposer 9 h / 50 threads "
                              "(README.md:193-196)",
    }


def part_b_assembly(rng, n_hor, coverage):
    genome_syms = build_symbol_genome(rng, n_hor)
    monoreads = simulate_monoreads(rng, genome_syms, coverage)
    total_monomers = sum(len(m.syms) for m in monoreads.values())
    cfg = MonoConfig()

    t0 = time.time()
    ec = error_correction(
        dict(monoreads), max_lowercase=cfg.max_lowercase,
        trim_max_gap=cfg.trim_max_gap, trim_ma_window=cfg.trim_ma_window,
        cut_max_gap=cfg.cut_max_gap, cut_min_length=cfg.cut_min_length,
        hor_k=cfg.hor_k, hor_min_mult=cfg.hor_min_mult,
        hor_max_gap=cfg.hor_max_gap)
    t_ec = time.time() - t0

    t0 = time.time()
    contigs_per_k, dbs = iterative_graph(
        ec, min_k=cfg.min_k, max_k=cfg.max_k, min_mult=cfg.min_mult,
        max_uniq_cov=max(cfg.max_uniq_cov, 2 * int(coverage)),
        min_uniq_len=cfg.min_uniq_len)
    db = dbs[cfg.max_k]
    t_graph = time.time() - t0

    t0 = time.time()
    mappings = db.map_reads(ec)
    scaffolds, edge_scaffolds = scaffolding(
        db, mappings, min_connections=cfg.min_connections)
    n_pre_join = len(scaffolds)
    if len(scaffolds) > 1:
        from centroflye_tpu.mono.scaffolding import (
            merge_scaffolds_with_paths)
        scaffolds, edge_scaffolds = merge_scaffolds_with_paths(
            db, scaffolds, edge_scaffolds,
            min_overlap=cfg.join_min_overlap)
    t_scaf = time.time() - t0

    # accuracy: every scaffold must be an exact run of the genome; the
    # reference joins its (two, for real cen6) scaffolds MANUALLY
    # (centroFlyeMono.py:84-87 "# TODO"), so combined union coverage of
    # all exact scaffolds is the comparable end metric
    best = max(scaffolds, key=len) if scaffolds else np.empty(0, np.int16)
    gl = "".join(chr(65 + s % N_MONO) for s in genome_syms)
    sl = "".join(chr(65 + s % N_MONO) for s in best)
    exact = sl in gl or sl in gl[::-1]
    covered = np.zeros(len(genome_syms), bool)
    n_exact = 0
    for sc in scaffolds:
        s = "".join(chr(65 + x % N_MONO) for x in sc)
        p = gl.find(s)
        if p < 0:
            p = gl.find(s[::-1])
        if p >= 0:
            covered[p:p + len(s)] = True
            n_exact += 1
    return {
        "n_hor": n_hor,
        "genome_monomers": len(genome_syms),
        "reads": len(monoreads),
        "read_monomers": total_monomers,
        "coverage": coverage,
        "wall_s": round(t_ec + t_graph + t_scaf, 1),
        "error_correction_s": round(t_ec, 1),
        "iterative_graph_s": round(t_graph, 1),
        "map_and_scaffold_s": round(t_scaf, 1),
        "n_scaffolds_pre_join": n_pre_join,
        "n_scaffolds": len(scaffolds),
        "n_exact_scaffolds": n_exact,
        "best_scaffold_monomers": int(len(best)),
        "scaffold_exact_substring_of_genome": bool(exact),
        "genome_recovered_frac": round(len(best) / len(genome_syms), 4),
        "union_recovered_frac": round(
            float(covered.sum()) / len(genome_syms), 4),
        "reference_envelope": "centroFlyeMono ~30 min single process "
                              "(README.md:210-213)",
    }


def main():
    n_hor = int(sys.argv[1]) if len(sys.argv) > 1 else 800
    coverage = int(sys.argv[2]) if len(sys.argv) > 2 else 120
    slice_hor = int(sys.argv[3]) if len(sys.argv) > 3 else 24

    data = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "centroflye_tpu", "data")
    monomers = read_seqs(os.path.join(data, "D6Z1_monomers.fasta"))
    assert len(monomers) == N_MONO
    rng = np.random.default_rng(23)

    import jax
    res = {"backend": jax.default_backend(),
           "n_devices": len(jax.devices())}
    print(f"part A: decomposing {slice_hor}-HOR slice at {coverage}x "
          f"on {res['backend']}...", flush=True)
    res["decomposition"] = part_a_decomposition(
        rng, monomers, slice_hor, coverage)
    print(json.dumps(res["decomposition"], indent=2), flush=True)

    print(f"part B: assembling {n_hor}-HOR array at {coverage}x "
          f"(monomer space)...", flush=True)
    res["assembly"] = part_b_assembly(rng, n_hor, coverage)
    print(json.dumps(res["assembly"], indent=2), flush=True)

    out_fn = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        f"mono_cen6_{n_hor}hor_c{coverage}.json")
    with open(out_fn, "w") as f:
        json.dump(res, f, indent=2)
    print("->", out_fn, flush=True)


if __name__ == "__main__":
    main()
