#!/usr/bin/env python
"""Smoke test of the whole system on one NVIDIA GPU.

    python chip_smoke.py               # phases 1-5 on one card
    python chip_smoke.py --four-gpus   # 4-card vs 1-card identity only

Phases, each through the entry points a user calls, in one process that
holds the card (data made from --seed, outputs under smoke_out/):
  1. device: require a GPU, print the card and the compile cache, build
     the native runtime and the CUDA kernel library from source;
  2. kernel: the recruitment scorer at the DXZ1 unit (m = 2055) on 256
     reads of 10,240 bp against the independent C++ engine (exact dist
     and end on both strands), then timed against the XLA scan;
  3. recruitment: bench.py's rel2 stream through RecruitmentEngine; the
     prefiltered recruited set must equal the exact tier's;
  4. cenX: a rel2-shaped DXZ1 world (52x total / 33x ultra-long, 5.5%
     uniform noise; the array cut from 1,500 units to --units) through
     run_all_cenX.assemble to final_assembly.fasta; sampled divergence
     <= 0.3% and length within 1% of the truth;
  5. cen6: a 40-HOR / 30x D6Z1 world with the 18 real monomers through
     the mono pipeline, decomposed on the device; call accuracy >= 0.99
     and a non-empty scaffold.
--four-gpus runs only phases 3-4 on a 4-card mesh and on one card and
requires byte-identical results. The pipeline's log goes to
smoke_out/smoke.log. Any failure raises: the exit code is
non-zero and the last line is not printed. The last line is one JSON
object {"ok": true, "device": {"platform", "kind", "count"}}.
"""

import argparse
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
DATA = os.path.join(ROOT, "centroflye_tpu", "data")
OUT = os.path.join(ROOT, "smoke_out")

KERNEL_READS, KERNEL_LEN = 256, 10_240
TIMING_RUNS = 10
RECRUIT_READS = 8192
# realizes 52.0x total / 32.4x on 50 kb+ reads at 300 units (rel2: 52x / 33x)
CENX_COVERAGE, CENX_NOISE = 52, 0.055
CENX_MAX_DIVERGENCE, CENX_MAX_LENGTH_ERROR = 0.003, 0.01
CEN6_HOR, CEN6_COVERAGE, CEN6_NOISE = 40, 30, 0.08
CEN6_MIN_ACCURACY = 0.99
ARTIFACTS = ("centromeric_reads.fasta",
             "recruited_unique_kmers/unique_kmers_min_edge_cov_4.txt",
             "recruited_unique_kmers/unique_edges_min_edge_cov_4.txt",
             "tr_resolution/read_positions.csv",
             "final_assembly.fasta")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def phase_device():
    """Require a GPU; print the card; build native code from source."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU "
                         f"(platform {devs[0].platform})")
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}; devices: {len(devs)} x "
        f"{devs[0].device_kind}; compile cache: "
        f"{jax.config.jax_compilation_cache_dir}")
    t0 = time.perf_counter()
    subprocess.run(["make", "-C", os.path.join(ROOT, "centroflye_tpu",
                                               "native")],
                   check=True, capture_output=True)
    from centroflye_tpu.native import load_native
    if load_native() is None:
        raise RuntimeError("native runtime did not load after make")
    from centroflye_tpu.ops.myers_cuda import build_kernels
    log(f"built native runtime and {os.path.relpath(build_kernels(), ROOT)}"
        f" in {time.perf_counter() - t0:.1f} s")
    return devs


def kernel_batch(rng, unit: str, n: int, L: int):
    """Rows as the recruitment engine sends them: noisy tandem copies on
    both strands, random sequence of mixed lengths, all-N and empty."""
    from centroflye_tpu.io import encode_batch
    from centroflye_tpu.io.encoding import revcomp_str
    from centroflye_tpu.pipeline.simulate import (
        add_read_noise, gen_random_seq)
    copies = unit * (L // len(unit) + 1)
    rows = []
    for i in range(n - 2):
        kind = i % 4
        if kind < 2:
            seq = add_read_noise(rng, copies, 0.10)[:L]
            rows.append(revcomp_str(seq) if kind else seq)
        elif kind == 2:
            rows.append(gen_random_seq(rng, L))
        else:
            rows.append(gen_random_seq(rng, int(rng.integers(1, L))))
    rows += ["N" * L, ""]
    codes, lens = encode_batch(rows, max_len=L)
    return np.asarray(codes), np.asarray(lens)


def _median_s(fn, runs: int) -> float:
    import jax
    jax.block_until_ready(fn())                       # compile + warm
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def phase_kernel(seed: int, scorer=None, n=KERNEL_READS, L=KERNEL_LEN,
                 timing_batches=(128, 2048)):
    """Exact dist/end of the engine's two-strand scorer vs the C++
    engine at m = 2055, then its warm median time vs the XLA scan."""
    import jax
    import jax.numpy as jnp
    from centroflye_tpu.io import encode, read_seq
    from centroflye_tpu.io.encoding import revcomp
    from centroflye_tpu.native import native_edit_distance_batch
    from centroflye_tpu.ops.myers import build_peq
    from centroflye_tpu.ops.myers_cuda import (
        myers_hw_2strand_xla, two_strand_scorer)

    unit = read_seq(os.path.join(DATA, "DXZ1_rc.fasta"))
    m = len(unit)
    if scorer is None:
        scorer = two_strand_scorer(jax.devices()[0].platform, m)
    log(f"kernel: {scorer.__name__} (m={m}) on {n} reads x {L} bp")
    codes, lens = kernel_batch(np.random.default_rng(seed), unit, n, L)
    u = encode(unit)
    pf, pr = build_peq(u), build_peq(revcomp(u))
    out = scorer(pf, pr, jnp.asarray(codes), jnp.asarray(lens), m=m)
    for strand, q in (("f", u), ("r", revcomp(u))):
        nd, ne = native_edit_distance_batch(q, codes, lens, "HW")
        got_d = np.asarray(out["dist_" + strand])
        got_e = np.asarray(out["end_" + strand])
        bad = np.flatnonzero((got_d != nd) | (got_e != ne))
        if bad.size:
            raise AssertionError(
                f"strand {strand}: {bad.size} rows differ from the C++ "
                f"engine, first {bad[:5].tolist()}: "
                f"{got_d[bad[:5]].tolist()} vs {nd[bad[:5]].tolist()}")
    recruited = int(np.sum(np.minimum(np.asarray(out["dist_f"]),
                                      np.asarray(out["dist_r"])) <= 350))
    log(f"kernel: dist and end equal the C++ engine on both strands "
        f"({recruited}/{n} rows within 350)")
    for B in timing_batches:
        reps = -(-B // n)
        text = jax.device_put(np.tile(codes, (reps, 1))[:B])
        tl = jax.device_put(np.tile(lens, reps)[:B])
        t_k = _median_s(lambda: scorer(pf, pr, text, tl, m=m), TIMING_RUNS)
        t_x = _median_s(lambda: myers_hw_2strand_xla(pf, pr, text, tl, m=m),
                        TIMING_RUNS)
        log(f"kernel timing B={B} L={L}: {scorer.__name__} "
            f"{t_k * 1e3:.3f} ms, myers_hw_2strand_xla {t_x * 1e3:.3f} ms "
            f"(warm median of {TIMING_RUNS})")


def phase_recruit(seed: int, n_reads=RECRUIT_READS, mesh=None):
    """bench.py's rel2 stream through RecruitmentEngine with the
    prefilter; the set must equal the exact (prefilter=False) tier's.
    Returns the recruited id set."""
    import bench
    from centroflye_tpu.config import RecruitmentConfig
    from centroflye_tpu.io import read_seq
    from centroflye_tpu.stages.recruitment import RecruitmentEngine

    unit = read_seq(os.path.join(DATA, "DXZ1_rc.fasta"))
    reads = bench.make_reads(unit, n_reads, seed=seed)
    n_dev = 1 if mesh is None else int(mesh.devices.size)

    def engine(prefilter):
        return RecruitmentEngine(
            unit, RecruitmentConfig(threshold=350, batch_size=2048,
                                    prefilter=prefilter),
            seg_len=10240, mesh=mesh)

    eng = engine(True)
    list(eng.run(reads[:272]))                        # compile both tiers
    t0 = time.perf_counter()
    got = {r.r_id for r in eng.run(reads) if r.recruited}
    dt = time.perf_counter() - t0
    exact = {r.r_id for r in engine(False).run(reads) if r.recruited}
    if got != exact:
        raise AssertionError(f"prefiltered set differs from the exact "
                             f"tier: {sorted(got ^ exact)[:10]}")
    n_cen = int(n_reads * bench.CEN_FRACTION)
    if len(got) < n_cen:
        raise AssertionError(f"recruited {len(got)} < {n_cen} centromeric")
    log(f"recruitment ({n_dev} device(s)): {len(reads)} reads in {dt:.3f} s"
        f" = {len(reads) / dt:.1f} reads/s; {len(got)} recruited, equal "
        f"to the exact tier")
    return got


def phase_cenx(seed: int, n_units: int, outdir: str, mesh="auto",
               gate: bool = True):
    """Simulated rel2-shaped cenX world through run_all_cenX.assemble;
    with `gate`, checks divergence and length against the truth. Returns
    the run directory."""
    import demo_cenx_production as demo
    from centroflye_tpu.io import write_seqs
    import run_all_cenX

    t0 = time.perf_counter()
    unit, reads, sim, cov, ul_cov = demo.build_world(
        n_units, CENX_COVERAGE, CENX_NOISE, seed=seed)
    log(f"cenX cut: {n_units} DXZ1 units ({len(sim.tr):,} bp) instead of "
        f"the rel2 array's 1,500; coverage {cov:.1f}x total / "
        f"{ul_cov:.1f}x on 50 kb+ reads, {CENX_NOISE:.1%} uniform noise; "
        f"{len(reads)} reads simulated in {time.perf_counter() - t0:.1f} s")
    os.makedirs(outdir, exist_ok=True)
    reads_fn = os.path.join(outdir, "reads.fasta")
    write_seqs(reads_fn, reads)
    t0 = time.perf_counter()
    pipe, final = run_all_cenX.assemble(
        reads_fn, os.path.join(outdir, "run"),
        coverage=max(int(round(ul_cov)), 1), mesh=mesh)
    wall = time.perf_counter() - t0
    for name, st in pipe.metrics.stages.items():
        log(f"cenX stage {name}: {st.wall_s:.3f} s ({st.items} {st.unit})")
    d, b, _ = demo.sample_divergence(final, sim.tr,
                                     np.random.default_rng(seed + 1))
    div = d / max(b, 1)
    len_err = abs(len(final) - len(sim.tr)) / len(sim.tr)
    log(f"cenX: {wall:.1f} s; assembly {len(final):,} bp vs truth "
        f"{len(sim.tr):,} bp (length error {len_err:.4%}); sampled "
        f"divergence {div:.4%}")
    if gate and (div > CENX_MAX_DIVERGENCE
                 or len_err > CENX_MAX_LENGTH_ERROR):
        raise AssertionError(f"cenX assembly off: divergence {div:.4%}, "
                             f"length error {len_err:.4%}")
    return os.path.join(outdir, "run")


def cen6_world(rng, monomers, n_hor, coverage, noise):
    """D6Z1 HOR array from the real monomers with scattered monomer
    variants (the position-unique markers the graph needs), and noisy
    ~14 kb reads on both strands. Returns (reads, spans, truth)."""
    import bench_mono_cen6
    from centroflye_tpu.io.encoding import revcomp_str
    from centroflye_tpu.pipeline.simulate import add_read_noise
    seqs = list(monomers.values())
    truth = bench_mono_cen6.build_symbol_genome(rng, n_hor)
    starts = np.concatenate(
        [[0], np.cumsum([len(seqs[s]) for s in truth])])
    genome = "".join(seqs[s] for s in truth)
    read_len = 14_000
    reads, spans = {}, {}
    for i in range(int(coverage * len(genome) / read_len)):
        s = int(rng.integers(0, len(genome) - read_len))
        seq = add_read_noise(rng, genome[s:s + read_len], noise)
        strand = "+" if rng.random() < 0.5 else "-"
        reads[f"r{i:04d}"] = seq if strand == "+" else revcomp_str(seq)
        spans[f"r{i:04d}"] = (s, strand)
    return reads, spans, truth, starts


def phase_cen6(seed: int, outdir: str):
    """cen6 through the mono pipeline: device monomer decomposition,
    then error correction, graph, scaffolding and polish."""
    from centroflye_tpu.config import MonoConfig
    from centroflye_tpu.io import read_seqs
    from centroflye_tpu.mono.monostring import GAP
    from centroflye_tpu.mono.pipeline import MonoPipeline
    from centroflye_tpu.mono.string_decomposer import (
        decompose_to_monostrings)
    from centroflye_tpu.parallel.mesh import auto_mesh

    monomers = read_seqs(os.path.join(DATA, "D6Z1_monomers.fasta"))
    rng = np.random.default_rng(seed)
    reads, spans, truth, starts = cen6_world(
        rng, monomers, CEN6_HOR, CEN6_COVERAGE, CEN6_NOISE)
    log(f"cen6: {CEN6_HOR} HOR x {len(monomers)} real D6Z1 monomers "
        f"({starts[-1]:,} bp), {len(reads)} reads at {CEN6_COVERAGE}x, "
        f"{CEN6_NOISE:.0%} noise")
    t0 = time.perf_counter()
    sd = decompose_to_monostrings(monomers, reads.items(), mesh=auto_mesh())
    t_dec = time.perf_counter() - t0
    n_calls = n_ok = 0
    for r_id, ms in sd.monostrings.items():
        s, strand = spans[r_id]
        if strand != "+":
            continue
        for sym, (n_st, n_en) in zip(ms.syms, ms.nucl):
            if sym == GAP or n_st < 0:
                continue
            t = int(np.searchsorted(starts, s + (n_st + n_en) / 2,
                                    side="right")) - 1
            if 0 <= t < len(truth):
                n_calls += 1
                n_ok += int(sym % len(monomers) == truth[t])
    acc = n_ok / max(n_calls, 1)
    log(f"cen6 decomposition: {n_calls} '+' calls in {t_dec:.3f} s, "
        f"accuracy {acc:.4f}")
    t0 = time.perf_counter()
    cfg = MonoConfig(min_k=20, max_k=60, min_uniq_len=40)
    asm = MonoPipeline(cfg, outdir=outdir).run(sd, reads)
    sizes = [len(s) for s in asm.scaffolds_mono]
    log(f"cen6 assembly: {time.perf_counter() - t0:.3f} s; scaffolds "
        f"(monomers) {sizes}, of {len(truth)} in the genome")
    if acc < CEN6_MIN_ACCURACY:
        raise AssertionError(f"cen6 call accuracy {acc:.4f}")
    if not sizes or not asm.scaffolds_nucl[0]:
        raise AssertionError("cen6 produced no scaffold")


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def four_gpus(seed: int, n_units: int):
    """Phases 3-4 on a 4-card mesh and on one card: identical results
    (the assembly's quality is phase 4's gate, not this check's)."""
    from centroflye_tpu.parallel.mesh import auto_mesh
    mesh = auto_mesh()
    if mesh is None or mesh.devices.size != 4:
        raise SystemExit("chip_smoke --four-gpus: needs 4 GPUs")
    if phase_recruit(seed, mesh=mesh) != phase_recruit(seed, mesh=None):
        raise AssertionError("recruited sets differ, 4 cards vs 1")
    log("four-gpus: recruited sets identical, 4 cards vs 1")
    runs = [phase_cenx(seed, n_units, os.path.join(OUT, tag), mesh=m,
                       gate=False)
            for tag, m in (("cenx_4", mesh), ("cenx_1", None))]
    for art in ARTIFACTS:
        a, b = (_read(os.path.join(r, art)) for r in runs)
        if a != b:
            raise AssertionError(f"artifact differs, 4 cards vs 1: {art}")
        log(f"four-gpus: {art} identical ({len(a)} bytes)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="only the 4-card vs 1-card identity check")
    ap.add_argument("--units", type=int, default=300,
                    help="cenX array depth in DXZ1 units (rel2: 1500)")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    t_all = time.perf_counter()
    devs = phase_device()
    os.makedirs(OUT, exist_ok=True)
    logging.basicConfig(filename=os.path.join(OUT, "smoke.log"),
                        level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    if args.four_gpus:
        four_gpus(args.seed, args.units)
    else:
        phase_kernel(args.seed)
        phase_recruit(args.seed)
        phase_cenx(args.seed, args.units, os.path.join(OUT, "cenx"))
        phase_cen6(args.seed, os.path.join(OUT, "cen6"))
    log(f"smoke wall: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
