"""Typed configuration for the centroflye_tpu pipeline.

The reference re-declares argparse flags per stage CLI and forwards them from a
master driver (reference centroFlye.py:13-134, and per-stage parsers, e.g.
distance_based_kmer_recruitment.py:15-36, read_placer.py:131-170,
eltr_polisher.py:168-180). Here a single frozen dataclass owns every parameter
with the reference defaults, and per-stage views are plain attribute groups.
Keeping names/defaults identical to the reference is required for output
parity runs.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RecruitmentConfig:
    """Read recruitment (reference scripts/read_recruitment/rr.cpp:41-90,
    run_read_recruitment.sh:29-31; run_all_cen6.sh:17)."""

    # Edit-distance threshold for HW-mode unit-vs-read alignment.
    # 350 for DXZ1/cenX (default), 550 for D6Z1/cen6.
    threshold: int = 350
    # Device batch: reads per kernel launch (padded to this many rows).
    # Bigger batches amortize per-call dispatch overhead (2048 is not yet
    # re-measured on a GPU).
    batch_size: int = 2048
    # Reads longer than this are scanned in chunks with (unit+threshold)-sized
    # overlap so an instance spanning a boundary is not missed.
    max_read_len: int = 131072
    # Seed prefilter (ops/seed_filter): segments with fewer than
    # min_seed_hits unit seed-k-mer hits skip the alignment kernel. Set
    # prefilter=False for the pure-Myers exact path (parity runs).
    prefilter: bool = True
    seed_k: int = 13
    min_seed_hits: int = 8
    # Sequence-parallel long-read overflow (parallel/seq_parallel): when a
    # mesh is present, reads at least this long are scored WHOLE — DP
    # columns sharded over the mesh, carry handed device to device —
    # instead of host-segmented (bit-identical distances; the ring-attention
    # analogue of SURVEY §5). 0 disables.
    seq_parallel_min_len: int = 3 * 32768


@dataclasses.dataclass(frozen=True)
class UnitDecompositionConfig:
    """NCRF-equivalent tandem decomposition of reads into unit instances
    (replaces the external NCRF binary; artifact-compatible with
    reference scripts/ncrf_parser.py parsing)."""

    # Only the longest alignment of a read is kept, and only if it is at least
    # this long (reference ncrf_parser.py:61 min_record_len).
    min_record_len: int = 5000
    # Seed k-mer length used to anchor unit instances within a read.
    seed_k: int = 15
    # Max divergence allowed when validating a unit instance (fractional).
    max_unit_divergence: float = 0.35


@dataclasses.dataclass(frozen=True)
class KmerRecruitmentConfig:
    """Rare/unique k-mer recruitment
    (reference distance_based_kmer_recruitment.py:15-36 defaults)."""

    k: int = 19
    min_coverage: int = 4          # minCov of an edge in the distance graph
    min_distance: int = 1
    max_distance: int = 150
    bottom: float = 0.9
    top: float = 3.0
    kmer_survival_rate: float = 0.34
    max_nonuniq: int = 3
    rel_threshold: float = 0.8     # distance-consistency (filter_dist_tuples)
    min_nreads: int = 0
    max_nreads: int = 2**63 - 1
    # Coverage-adaptive edge cutoff: the reference's fixed min_coverage=4
    # assumes its coverage-32 datasets; below ~16x UL coverage true-pair
    # edge counts drop under 4 and the stage starves. When on, ONE sweep
    # at the floor cutoff 2 yields every cutoff's exact edge set by freq
    # thresholding, and the largest non-starved cutoff <= min_coverage is
    # chosen (stages/distance_graph.recruit_unique_kmers). Off by default:
    # parity runs need the reference's fixed semantics.
    auto_min_coverage: bool = False
    # "non-starved" = unique k-mers >= this fraction of the rare set
    # (healthy runs measure >30%, collapsed runs <5%)
    auto_min_unique_frac: float = 0.15
    # endpoint-degree cleanup at sub-reference cutoffs: keep only
    # k-mers incident to >= this many surviving edges (true unique
    # k-mers pair with tens of unit copies; chance noise pairs are
    # nearly isolated). 1 disables.
    auto_min_degree: int = 3


@dataclasses.dataclass(frozen=True)
class PlacerConfig:
    """Read placement (reference read_placer.py:131-170 defaults)."""

    n_motif: int = 1
    k_cloud: int = 19
    min_cloud_kmer_freq: int = 2
    min_kmer_mult: int = 2
    min_unit: int = 2              # threshold on score[0]
    min_inters: int = 10           # threshold on score[1]
    min_prop: int = 3              # score[1] >= min_prop * score[0]
    prefix_threshold: int = 50000  # read classification large_threshold
    small_threshold: int = 1000    # read classification small_threshold


@dataclasses.dataclass(frozen=True)
class ConsensusUnitConfig:
    """Consensus unit ("unit*") reconstruction
    (reference better_consensus_unit_reconstruction.py:140-153)."""

    k: int = 30                    # cons-k-mer-len
    top_factor: int = 3            # keep 3x|unit kmers| most frequent k-mers


@dataclasses.dataclass(frozen=True)
class PolisherConfig:
    """ELTR polishing (reference eltr_polisher.py:168-180 defaults). The
    external Flye polisher is replaced by the in-repo device consensus
    polisher (ops/consensus)."""

    num_iters: int = 4
    min_pos: int = 0
    max_pos: float = math.inf
    error_mode: str = "nano"


@dataclasses.dataclass(frozen=True)
class MonoConfig:
    """centroFlyeMono / cen6 pipeline (reference scripts/centroFlyeMono.py:32-51
    and sd_parser.py / mono_error_correction.py defaults)."""

    min_k: int = 100
    max_k: int = 400
    min_mult: int = 5
    polish_n_iter: int = 2
    max_gap: int = 100             # SD_Report max inter-monomer nucleotide gap
    gap_symb: str = "?"
    max_lowercase: float = 0.1     # filter_lowercaserich_reads
    trim_max_gap: float = 0.2      # trim_reads moving-average threshold
    trim_ma_window: int = 30
    cut_max_gap: float = 0.05      # cut_gaprich_reads
    cut_min_length: int = 100
    hor_k: int = 3                 # correct_gaps HOR inference k
    hor_min_mult: int = 5000
    hor_max_gap: float = 0.3
    max_uniq_cov: int = 60         # DeBruijnGraph unique-edge coloring
    min_uniq_len: int = 1000
    min_connections: int = 2       # scaffolding support
    # evidence-based scaffold joining (the automated counterpart of the
    # reference's hard-coded cen6 join, centroFlyeMono.py:84-87): merge
    # scaffolds whose symbols share an exact >= join_min_overlap-monomer
    # suffix-prefix overlap and whose merged run maps to one valid graph
    # path (mono/scaffolding.merge_scaffolds_with_paths)
    auto_join: bool = True
    join_min_overlap: int = 50


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Multi-device execution over a jax.sharding.Mesh."""

    # Name of the data-parallel mesh axis over which read batches are sharded.
    data_axis: str = "reads"
    # If 0, use all local devices.
    n_devices: int = 0


@dataclasses.dataclass(frozen=True)
class CentroFlyeConfig:
    """Master configuration (union of all stage views, mirroring the master
    driver reference centroFlye.py:13-134)."""

    coverage: int = 32
    threads: int = 0               # host-side worker threads (0 = auto)
    recruitment: RecruitmentConfig = dataclasses.field(
        default_factory=RecruitmentConfig)
    decomposition: UnitDecompositionConfig = dataclasses.field(
        default_factory=UnitDecompositionConfig)
    kmer_recruitment: KmerRecruitmentConfig = dataclasses.field(
        default_factory=KmerRecruitmentConfig)
    placer: PlacerConfig = dataclasses.field(default_factory=PlacerConfig)
    consensus_unit: ConsensusUnitConfig = dataclasses.field(
        default_factory=ConsensusUnitConfig)
    polisher: PolisherConfig = dataclasses.field(
        default_factory=PolisherConfig)
    mono: MonoConfig = dataclasses.field(default_factory=MonoConfig)
    parallel: ParallelConfig = dataclasses.field(
        default_factory=ParallelConfig)

    @classmethod
    def cen6(cls, coverage: int = 120) -> "CentroFlyeConfig":
        """Preset matching run_all_cen6.sh (threshold 550)."""
        return cls(coverage=coverage,
                   recruitment=RecruitmentConfig(threshold=550))

    def replace(self, **kwargs) -> "CentroFlyeConfig":
        return dataclasses.replace(self, **kwargs)

    def to_json(self) -> str:
        def default(o):
            if dataclasses.is_dataclass(o):
                return dataclasses.asdict(o)
            if o == math.inf:
                return "inf"
            raise TypeError(o)
        return json.dumps(dataclasses.asdict(self), indent=2, default=default)

    @classmethod
    def from_json(cls, text: str) -> "CentroFlyeConfig":
        raw = json.loads(text)

        def build(tp, d):
            fields = {f.name: f for f in dataclasses.fields(tp)}
            kwargs = {}
            for key, value in d.items():
                if key not in fields:
                    raise KeyError(f"unknown config key: {key}")
                sub = _SUBCONFIGS.get(key)
                if sub is not None and isinstance(value, dict):
                    kwargs[key] = build(sub, value)
                elif value == "inf":
                    kwargs[key] = math.inf
                else:
                    kwargs[key] = value
            return tp(**kwargs)

        return build(cls, raw)


_SUBCONFIGS = {
    "recruitment": RecruitmentConfig,
    "decomposition": UnitDecompositionConfig,
    "kmer_recruitment": KmerRecruitmentConfig,
    "placer": PlacerConfig,
    "consensus_unit": ConsensusUnitConfig,
    "polisher": PolisherConfig,
    "mono": MonoConfig,
    "parallel": ParallelConfig,
}
