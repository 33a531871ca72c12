"""cenX master pipeline: the end-to-end centroFlye assembly driver.

The reference master driver (reference centroFlye.py:137-284) subprocess-
chains six stages communicating only through files. Here the chain is one
in-process typed pipeline with per-stage artifacts (same filenames where the
reference defines them) and skip-if-exists resume, which the reference lacks
(its README only suggests deleting the whole outdir, README.md:69-70):

  1. recruitment       -> centromeric_reads.fasta
  2. decomposition     -> decomposition.json (NCRF-report role)
  3. rare + unique     -> recruited_unique_kmers/unique_kmers_min_edge_cov_{c}.txt
                          + unique_edges_min_edge_cov_{c}.txt
  4. placement         -> tr_resolution/read_positions.csv
  5. unit consensus    -> cons_unit/unit_star.fasta
  6. polishing         -> polishing{i}/final_sequence_{k}.fasta
                          -> final_assembly.fasta
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from centroflye_tpu.config import CentroFlyeConfig
from centroflye_tpu.io import (
    atomic_write, read_seq, read_seqs, write_seqs, iter_seqs)
from centroflye_tpu.io.encoding import kmer_strings
from centroflye_tpu.stages.unit_decomposition import (
    UnitDecomposer, Decomposition, DecompRecord,
)


class CenXPipeline:
    def __init__(self, unit: str, config: CentroFlyeConfig, outdir: str,
                 ncrf_report: Optional[str] = None, mesh="auto",
                 distributed: bool = False):
        """ncrf_report: optional pinned NCRF report file — when given, the
        decomposition stage parses it (stages/ncrf_compat) instead of
        running the in-repo decomposer (bit-for-bit parity configs).
        mesh: "auto" shards device stages over all local devices when more
        than one is present; pass an explicit Mesh (e.g. make_mesh(1)) to
        pin the device count.
        distributed: on a multi-process run (after
        parallel.distributed.init_distributed), stage 1 shards the read
        stream over processes with a coordinator merge; later stages run
        on the coordinator (run() returns "" on other processes)."""
        from centroflye_tpu.utils.logging_utils import MetricsRegistry
        self.unit = unit
        self.config = config
        self.outdir = outdir
        self.ncrf_report = ncrf_report
        os.makedirs(outdir, exist_ok=True)
        self.metrics = MetricsRegistry(outdir)
        # multi-chip: shard the device stages over all local devices (the
        # sharded steps are bit-identical to the single-device path, so
        # resume artifacts stay valid across device counts)
        if mesh == "auto":
            from centroflye_tpu.parallel.mesh import auto_mesh
            mesh = auto_mesh()
        if mesh is not None and mesh.devices.size <= 1:
            mesh = None
        self.mesh = mesh
        self.distributed = distributed

    # ----------------------------------------------------------------- #
    def _artifact(self, *parts) -> str:
        return os.path.join(self.outdir, *parts)

    def run_recruitment(self, reads_fn: str) -> str:
        """Stage 1: select centromeric reads (rr equivalent)."""
        out_fn = self._artifact("centromeric_reads.fasta")
        if os.path.exists(out_fn):
            return out_fn
        from centroflye_tpu.stages.recruitment import recruit_file
        with self.metrics.stage("recruitment", "reads") as m:
            m.items = recruit_file(
                self._write_unit(), reads_fn, out_fn,
                threshold=self.config.recruitment.threshold,
                batch_size=self.config.recruitment.batch_size,
                mesh=self.mesh, distributed=self.distributed)
        return out_fn

    def _write_unit(self) -> str:
        unit_fn = self._artifact("unit.fasta")
        if not os.path.exists(unit_fn):
            write_seqs(unit_fn, {"unit": self.unit})
        return unit_fn

    def run_decomposition(self, centromeric_fn: str) -> Decomposition:
        """Stage 2: tandem decomposition (NCRF-report role). With a pinned
        NCRF report, parse it instead (parity path)."""
        cache_fn = self._artifact("decomposition.json")
        if os.path.exists(cache_fn):
            return load_decomposition(cache_fn)
        if self.ncrf_report:
            from centroflye_tpu.stages.ncrf_compat import parse_ncrf_report
            dec = parse_ncrf_report(
                self.ncrf_report,
                min_record_len=self.config.decomposition.min_record_len)
        else:
            decomposer = UnitDecomposer(self.unit,
                                        self.config.decomposition)
            with self.metrics.stage("decomposition", "reads") as m:
                dec = decomposer.decompose(iter_seqs(centromeric_fn))
                m.items = len(dec.records)
        save_decomposition(dec, cache_fn)
        return dec

    def run_unique_kmers(self, dec: Decomposition) -> np.ndarray:
        """Stages 3a+3b: rare k-mers then distance-graph unique k-mers."""
        from centroflye_tpu.stages.rare_kmers import get_rare_kmers
        from centroflye_tpu.stages.kmer_cloud import (
            build_read_clouds, pad_clouds)
        from centroflye_tpu.stages.distance_graph import recruit_unique_kmers
        from centroflye_tpu.io.encoding import string_to_kmer_code

        kcfg = self.config.kmer_recruitment
        outdir = self._artifact("recruited_unique_kmers")
        kmers_fn = os.path.join(
            outdir, f"unique_kmers_min_edge_cov_{kcfg.min_coverage}.txt")
        if os.path.exists(kmers_fn):
            with open(kmers_fn) as f:
                return np.sort(np.array(
                    [string_to_kmer_code(line.strip()) for line in f
                     if line.strip()], dtype=np.uint64))
        os.makedirs(outdir, exist_ok=True)

        from centroflye_tpu.utils.logging_utils import logger

        records = {r: dec.records[r] for r in sorted(dec.records)}
        seqs = [rec.seq for rec in records.values()]
        with self.metrics.stage("unique_kmers", "kmers") as m:
            t0 = time.perf_counter()
            rare = get_rare_kmers(seqs, kcfg, self.config.coverage,
                                  mesh=self.mesh)
            t1 = time.perf_counter()
            clouds = build_read_clouds(records, rare, kcfg.k)
            _, tensor, n_units, _ = pad_clouds(clouds, sorted(records))
            t2 = time.perf_counter()
            logger.info(
                "unique_kmers phases: rare %.1fs (%d kmers), clouds %.1fs",
                t1 - t0, len(rare), t2 - t1)
            # a (i, j, d) key repeats once per read spanning both unit
            # copies with BOTH k-mers surviving that read's errors:
            # ~coverage/2 spanning reads x survival^2 joint retention —
            # the strip-count divisor that keeps per-strip tables near
            # capacity without overflowing them (overflow splits strips,
            # costing retried device work)
            surv = float(kcfg.kmer_survival_rate)
            uniq_codes, edges = recruit_unique_kmers(
                tensor, n_units, rare, kcfg, mesh=self.mesh,
                dedup_hint=max(1, int(
                    int(self.config.coverage) / 2 * surv * surv)))
            logger.info("unique_kmers phases: sweep+filter %.1fs",
                        time.perf_counter() - t2)
            m.items = len(uniq_codes)

        # artifact parity: sorted kmer strings, one per line (reference
        # distance_based_kmer_recruitment.py:158-171)
        strs = kmer_strings(uniq_codes, kcfg.k)
        with atomic_write(kmers_fn) as f:
            for s in sorted(strs):
                print(s, file=f)
        edges_fn = os.path.join(
            outdir, f"unique_edges_min_edge_cov_{kcfg.min_coverage}.txt")
        rare_strs = np.asarray(kmer_strings(rare, kcfg.k))
        # vectorized formatting: edge files reach millions of rows at
        # production scale (5.7M at the 400-unit benchmark), a per-row
        # print() loop costs minutes there
        with atomic_write(edges_fn) as f:
            for e0 in range(0, len(edges.i), 1 << 20):
                sl = slice(e0, e0 + (1 << 20))
                cols = np.char.add(np.char.add(np.char.add(np.char.add(
                    np.char.add(np.char.add(
                        edges.dist[sl].astype(str), " "),
                        rare_strs[edges.i[sl]]), " "),
                    rare_strs[edges.j[sl]]), " "),
                    edges.freq[sl].astype(str))
                f.write("\n".join(cols.tolist()))
                if len(cols):
                    f.write("\n")
        return uniq_codes

    def run_placement(self, dec: Decomposition, uniq_codes: np.ndarray):
        """Stage 4: greedy read placement."""
        from centroflye_tpu.stages.kmer_cloud import (
            build_read_clouds, filter_read_clouds)
        from centroflye_tpu.stages.read_placer import (
            ReadPlacer, read_positions_file)

        pos_fn = self._artifact("tr_resolution", "read_positions.csv")
        pcfg = self.config.placer
        records = {r: dec.records[r] for r in sorted(dec.records)}
        # the master driver forwards ONE k to both the k-mer recruitment and
        # the placer (reference centroFlye.py:40-44 -> :196,:213), so the
        # cloud k must equal the unique-k-mer k
        k_cloud = self.config.kmer_recruitment.k
        clouds = build_read_clouds(records, uniq_codes, k_cloud)
        clouds = filter_read_clouds(clouds, min_mult=pcfg.min_kmer_mult)
        if os.path.exists(pos_fn):
            return read_positions_file(pos_fn), clouds
        placer = ReadPlacer(pcfg)
        with self.metrics.stage("placement", "reads") as m:
            placements = placer.run(dec, clouds)
            m.items = sum(1 for p in placements.values() if p is not None)
        placer.write_positions(pos_fn)
        return placements, clouds

    def run_unit_consensus(self, dec: Decomposition) -> str:
        """Stage 5: consensus unit (unit*) reconstruction."""
        from centroflye_tpu.stages.consensus_unit import reconstruct_unit
        out_fn = self._artifact("cons_unit", "unit_star.fasta")
        if os.path.exists(out_fn):
            return read_seq(out_fn)
        seqs = [rec.seq for rec in dec.records.values()]
        unit_star = reconstruct_unit(seqs, self.unit,
                                     self.config.consensus_unit)
        write_seqs(out_fn, {"unit*": unit_star})
        return unit_star

    def run_polisher(self, dec: Decomposition, placements) -> str:
        """Stage 6a: per-position consensus polishing (eltr role)."""
        from centroflye_tpu.stages.polisher import EltrPolisher
        n = self.config.polisher.num_iters
        eltr_fn = self._artifact("polishing",
                                 f"final_sequence_{n}.fasta")
        if os.path.exists(eltr_fn):
            return read_seq(eltr_fn)
        unit_instances = {r_id: rec.motif_alignments()
                          for r_id, rec in dec.records.items()}
        polisher = EltrPolisher(self.config.polisher)
        with self.metrics.stage("polishing", "positions") as m:
            out = polisher.run(placements, unit_instances,
                               outdir=self._artifact("polishing"))
            m.items = len(out.final_sequences.get(n, ""))
        return out.final_sequences.get(n, "")

    def run_tandem_polish(self, dec: Decomposition, placements,
                          assembly: str) -> str:
        """Stage 6b: assembly-level re-polish from raw read spans (the
        reference's tandemQUAST --only-polish role, centroFlye.py:252-272)
        -> final_assembly.fasta."""
        from centroflye_tpu.stages.final_polish import run_final_polish
        final_fn = self._artifact("final_assembly.fasta")
        if os.path.exists(final_fn):
            return read_seq(final_fn)
        with self.metrics.stage("tandem_polish", "bases") as m:
            final = run_final_polish(
                assembly, placements, dec.records,
                self._artifact("polishing2"),
                n_iters=self.config.polisher.num_iters)
            m.items = len(final)
        write_seqs(final_fn, {"centroFlye_assembly": final})
        return final

    def run_placement_validation(self, placements, clouds):
        """Post-placement validation (the reference's map_reads_fast debug
        idea, cloud_contig.py:117-156, as a persisted artifact): rebuild the
        contig from the placements and re-map every read; writes
        tr_resolution/placement_validation.csv with re-mapped positions.
        Returns the set of read ids whose re-map AGREES with their
        placement — the polish stages consume only those (a read placed
        off by a few units aligns fine against the 99.7%-identical
        template but votes the WRONG base at every intra-array mutation
        site; measured at the 1500u shape: 29/2215 disagreeing reads <->
        62 units carrying 0.2-0.5% divergence each)."""
        from centroflye_tpu.stages.cloud_contig import (
            CloudContig, map_reads_fast)

        out_fn = self._artifact("tr_resolution", "placement_validation.csv")
        if os.path.exists(out_fn):
            agree = set()
            with open(out_fn) as f:
                next(f)
                for line in f:
                    parts = line.split()
                    if len(parts) == 4 and parts[3] == "True" \
                            and parts[1] != "None":
                        agree.add(parts[0])
            return agree
        contig = CloudContig(self.config.placer.min_cloud_kmer_freq)
        for r_id, pos in placements.items():
            if pos is not None and r_id in clouds:
                contig.add_read(clouds[r_id], pos)
        positions, _ = map_reads_fast(
            contig, clouds,
            threshold=(self.config.placer.min_unit,
                       self.config.placer.min_inters))
        n_same = 0
        agree_set = set()
        with atomic_write(out_fn) as f:
            print("r_id placed remapped agree", file=f)
            for r_id, pos in placements.items():
                remapped = positions.get(r_id)
                agree = (pos == remapped)
                if agree and pos is not None:
                    n_same += 1
                    agree_set.add(r_id)
                print(r_id, pos, remapped, agree, file=f)
        from centroflye_tpu.utils.logging_utils import logger
        placed = sum(1 for p in placements.values() if p is not None)
        logger.info("placement validation: %d/%d re-map to their placement",
                    n_same, placed)
        # starvation/misplacement tripwire: a healthy run places most
        # decomposed reads and they re-map consistently; both collapse
        # when the edge-coverage cutoff starves at low coverage
        # (benchmarks/coverage_ladder.json: 29 placed / 1 re-mapped at
        # 16x with the fixed reference cutoff). Surface the fix.
        total = max(len(placements), 1)
        if placed and (placed < 0.2 * total or n_same < 0.5 * placed) \
                and not self.config.kmer_recruitment.auto_min_coverage:
            logger.warning(
                "placement collapse signature: %d/%d reads placed, %d/%d "
                "re-map. At low coverage the fixed min_coverage=%d edge "
                "cutoff starves the unique-k-mer stage (the reference "
                "pipeline behaves identically); re-run with "
                "kmer_recruitment.auto_min_coverage=True",
                placed, total, n_same, placed,
                self.config.kmer_recruitment.min_coverage)
        return agree_set

    # ----------------------------------------------------------------- #
    def run(self, reads_fn: str) -> str:
        """Full chain; returns the final assembly sequence (on the
        coordinator; "" on other processes of a distributed run, which
        participate in stage 1 only)."""
        centromeric_fn = self.run_recruitment(reads_fn)
        if self.distributed:
            from centroflye_tpu.parallel.distributed import is_coordinator
            if not is_coordinator():
                return ""
        dec = self.run_decomposition(centromeric_fn)
        uniq = self.run_unique_kmers(dec)
        placements, clouds = self.run_placement(dec, uniq)
        agree = self.run_placement_validation(placements, clouds)
        # polish only with validation-agreeing placements: a read placed
        # off by a few units votes the wrong base at every intra-array
        # mutation site (see run_placement_validation)
        n_placed = sum(1 for p in placements.values() if p is not None)
        if agree and len(agree) >= 0.8 * max(n_placed, 1):
            placements_p = {r: (p if p is None or r in agree else None)
                            for r, p in placements.items()}
        else:
            # collapsed/low-agreement runs keep every placement — a thin
            # validated subset would polish from near-zero coverage
            placements_p = placements
        self.run_unit_consensus(dec)
        assembly = self.run_polisher(dec, placements_p)
        return self.run_tandem_polish(dec, placements_p, assembly)


# ------------------------- decomposition (de)serialization ----------------


def save_decomposition(dec: Decomposition, filename: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    payload = {
        "records": {
            r_id: {
                "r_len": rec.r_len, "strand": rec.strand,
                "r_st": rec.r_st, "r_en": rec.r_en, "seq": rec.seq,
                "bounds": rec.bounds.tolist(),
            } for r_id, rec in dec.records.items()
        },
        "positions_all": {
            r_id: [[st, en, strand] for st, en, strand in ivs]
            for r_id, ivs in dec.positions_all.items()
        },
        "read_lens": dec.read_lens,
        "discarded": dec.discarded,
    }
    with atomic_write(filename) as f:
        json.dump(payload, f)


def load_decomposition(filename: str) -> Decomposition:
    with open(filename) as f:
        payload = json.load(f)
    records = {
        r_id: DecompRecord(
            r_id=r_id, r_len=d["r_len"], strand=d["strand"],
            r_st=d["r_st"], r_en=d["r_en"], seq=d["seq"],
            bounds=np.array(d["bounds"], dtype=np.int32))
        for r_id, d in payload["records"].items()
    }
    positions_all = {
        r_id: [(st, en, strand) for st, en, strand in ivs]
        for r_id, ivs in payload["positions_all"].items()
    }
    return Decomposition(records=records, positions_all=positions_all,
                         read_lens=payload["read_lens"],
                         discarded=payload["discarded"])


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="centroflye_tpu cenX assembly pipeline")
    parser.add_argument("-i", "--reads", required=True,
                        help="reads FASTA/FASTQ(.gz)")
    parser.add_argument("-o", "--outdir", required=True)
    parser.add_argument("-u", "--unit", required=True,
                        help="HOR unit FASTA (DXZ1_rc for cenX)")
    parser.add_argument("-c", "--coverage", type=int, required=True)
    parser.add_argument("--ncrf", help="pinned NCRF report (parity path: "
                        "parse it instead of running the decomposer)")
    parser.add_argument("--config", help="JSON config file overriding "
                        "defaults (CentroFlyeConfig.to_json format)")
    args = parser.parse_args(argv)

    if args.config:
        with open(args.config) as f:
            config = CentroFlyeConfig.from_json(f.read())
        config = config.replace(coverage=args.coverage)
    else:
        config = CentroFlyeConfig(coverage=args.coverage)
    unit = read_seq(args.unit)
    pipeline = CenXPipeline(unit, config, args.outdir,
                            ncrf_report=args.ncrf)
    final = pipeline.run(args.reads)
    print(f"final assembly length: {len(final)}")


if __name__ == "__main__":
    main()
