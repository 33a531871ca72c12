"""Benchmark: read-recruitment throughput on one chip.

The reference's headline stage: rr/edlib HW k=350 recruitment over rel2
(~11.1M reads / ~155 Gbp in ~1h on a 50-thread server ~= 3083 reads/s,
BASELINE.md). The measurement drives the REAL recruitment engine
end-to-end (host segment packing -> device seed prefilter -> two-strand
Myers scorer on survivors) on a rel2-matched mix: ~2% centromeric
reads, lengths from an ultra-long nanopore mixture (~14 kb mean, tail
past 80 kb — rel2 is 155 Gbp / 11.1 M reads), 10% read error on the
centromeric reads.

Correctness is asserted in-bench: the recruited SET (ids, not a count)
must equal the plain exact-Myers tier's set on the same reads.

All results are materialized to host (np.asarray) before timing stops.
Reports best-of-5 as the headline and the median alongside.

Prints ONE JSON line:
{"metric": ..., "value": N, "unit": "reads/s", "vs_baseline": N}.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_READS_PER_S = 11_100_000 / 3600.0   # rel2 envelope, BASELINE.md
N_READS = 8192
CEN_FRACTION = 0.02


def rel2_lengths(rng, n):
    """rel2-like lengths: ~88% regular long reads plus a 12% ultra-long
    component; overall mean ~14 kb (155 Gbp / 11.1 M reads)."""
    ul = rng.random(n) < 0.12
    lens = np.where(ul,
                    rng.lognormal(np.log(32_000), 0.45, n),
                    rng.lognormal(np.log(10_000), 0.5, n))
    return np.clip(lens, 500, 100_000).astype(np.int64)


def make_reads(unit: str, n_reads: int = N_READS, seed: int = 0):
    from centroflye_tpu.pipeline.simulate import (
        add_read_noise, gen_random_seq)
    rng = np.random.default_rng(seed)
    lens = rel2_lengths(rng, n_reads)
    reads = []
    n_cen = max(1, int(n_reads * CEN_FRACTION))
    for i in range(n_reads):
        L = int(lens[i])
        if i % (n_reads // n_cen) == 0:
            n_copies = max(1, -(-L // len(unit)))
            seq = add_read_noise(rng, unit * n_copies, 0.10)[:L]
        else:
            seq = gen_random_seq(rng, L)
        reads.append((f"r{i:05d}", seq))
    return reads


def main():
    from centroflye_tpu.config import RecruitmentConfig
    from centroflye_tpu.io import read_seq
    from centroflye_tpu.stages.recruitment import RecruitmentEngine

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "centroflye_tpu", "data")
    unit = read_seq(os.path.join(data, "DXZ1_rc.fasta"))
    reads = make_reads(unit)
    total_bp = sum(len(s) for _, s in reads)

    # seg_len is a multiple of 8 near the regular-read mode: most
    # segments carry little dead padding through the kernels
    engine = RecruitmentEngine(
        unit, RecruitmentConfig(threshold=350, batch_size=2048),
        seg_len=10240)

    # warmup on a slice (compile both tiers)
    list(engine.run(reads[:272]))

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        results = list(engine.run(reads))
        times.append(time.perf_counter() - t0)
    dt = min(times)
    med = sorted(times)[len(times) // 2]
    recruited_set = {r.r_id for r in results if r.recruited}

    # in-bench correctness: the plain exact-Myers tier (no prefilter)
    # must recruit the SAME set of reads
    plain = RecruitmentEngine(
        unit, RecruitmentConfig(threshold=350, batch_size=2048,
                                prefilter=False),
        seg_len=10240)
    plain_set = {r.r_id for r in plain.run(reads) if r.recruited}
    assert recruited_set == plain_set, (
        sorted(recruited_set ^ plain_set)[:10])
    assert len(recruited_set) >= int(N_READS * CEN_FRACTION), \
        (len(recruited_set), "missed centromeric reads")

    reads_per_s = len(reads) / dt
    print(json.dumps({
        "metric": "recruitment_reads_per_s_1chip_e2e",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_s / BASELINE_READS_PER_S, 3),
        "median_reads_per_s": round(len(reads) / med, 1),
        "mean_read_bp": round(total_bp / len(reads)),
        "gbp_per_h": round(total_bp / dt * 3.6e-6, 1),
    }))


if __name__ == "__main__":
    main()
