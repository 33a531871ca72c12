"""Read recruitment: select reads containing the HOR unit.

Device equivalent of the reference's native recruiter
(reference scripts/read_recruitment/rr.cpp:41-90: per read, edlib HW-mode
bounded edit distance of the unit and its reverse complement, keep the read
if either strand aligns within the threshold; thresholds 350/DXZ1,
550/D6Z1 per run_read_recruitment.sh:29-31, run_all_cen6.sh:17), and of the
process-level fan-out around it (run_read_recruitment.sh:35-44: awk split +
xargs -P + cat).

Design (not a port):
- Reads are cut into fixed-length segments with an overlap of
  ``len(unit) + threshold - 1`` — any unit alignment with <= threshold
  errors spans at most ``len(unit) + threshold`` target bases, so it lies
  entirely inside some segment. Segments from many reads pack into dense
  (B, SEG) batches: perfectly regular work regardless of read-length skew
  (the batched answer to the reference's awk-based load balancing).
- Each batch runs the two-strand Myers scorer (ops/myers_cuda);
  per-read distance = min over its segments. Dispatch is asynchronous, so
  host packing overlaps device compute.
- Multi-chip: segment batches are sharded over the mesh data axis
  (parallel/mesh.py shard_batch); the per-read min-reduction happens on
  host after device->host transfer of one int32 per segment.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Optional, Tuple

import jax
import numpy as np

from centroflye_tpu.config import RecruitmentConfig
from centroflye_tpu.io.encoding import encode, revcomp, PAD
from centroflye_tpu.ops.myers import build_peq


@dataclasses.dataclass
class RecruitmentResult:
    r_id: str
    dist_fwd: int
    dist_rc: int
    recruited: bool


def segment_starts(read_len: int, seg_len: int, overlap: int) -> List[int]:
    """Start offsets of segments covering [0, read_len) with `overlap`
    shared bases between consecutive segments."""
    if read_len <= seg_len:
        return [0]
    stride = seg_len - overlap
    starts = list(range(0, read_len - overlap, stride))
    return starts


class RecruitmentEngine:
    """Streaming recruiter: feed reads, collect per-read decisions."""

    def __init__(self, unit: str, config: RecruitmentConfig | None = None,
                 seg_len: int = 32768, mesh="auto"):
        """mesh: "auto" shards fused batches over all local devices when
        more than one is present; None forces single-device; an explicit
        jax.sharding.Mesh pins the device set."""
        self.config = config or RecruitmentConfig()
        self.unit = unit
        self.m = len(unit)
        unit_codes = encode(unit)
        self.peq_fwd = build_peq(unit_codes)
        self.peq_rc = build_peq(revcomp(unit_codes))
        self.threshold = self.config.threshold
        self.overlap = self.m + self.threshold - 1
        self.seg_len = max(seg_len, self.overlap + self.m)
        if isinstance(mesh, str) and mesh == "auto":
            from centroflye_tpu.parallel.mesh import auto_mesh
            mesh = auto_mesh()
        if mesh is not None and mesh.devices.size <= 1:
            mesh = None
        self.mesh = mesh
        n_dev = int(mesh.devices.size) if mesh is not None else 1
        # fused batches shard row-wise over the mesh: keep rows divisible
        self.batch = -(-self.config.batch_size // n_dev) * n_dev
        # the two-strand Myers scorer of both device tiers: the CUDA
        # kernel on a GPU, the XLA scan elsewhere (ops/myers_cuda)
        from centroflye_tpu.ops.myers_cuda import (
            myers_hw_2strand_xla, two_strand_scorer)
        dev = mesh.devices.flat[0] if mesh is not None else jax.devices()[0]
        self.scorer = two_strand_scorer(dev.platform, self.m)
        # sequence-parallel long-read tier: whole-read scoring with DP
        # columns sharded over the mesh (parallel/seq_parallel) — active
        # only with a real multi-device mesh and the XLA scan as scorer.
        # It shards that scan's one-column-per-step loop (~38 us a text
        # column for both strands on an H100, PERF.md); the CUDA kernel
        # scores a whole read's segments in milliseconds instead.
        self.seqpar_min = (self.config.seq_parallel_min_len
                           if (mesh is not None
                               and self.config.seq_parallel_min_len
                               and self.scorer is myers_hw_2strand_xla)
                           else 0)
        # in-flight fused-bundle queue depth (not yet measured on a GPU)
        self.queue_depth = 2
        if self.config.prefilter:
            from centroflye_tpu.ops.seed_filter import (
                build_seed_table, build_seed_bitmap)
            from centroflye_tpu.ops.fused_recruit import make_fused_recruit
            self._seed_hi, self._seed_lo = build_seed_table(
                unit, k=self.config.seed_k)
            self._seed_bitmap = build_seed_bitmap(
                unit, k=self.config.seed_k)
            self.k_budget = 128
            self._bitmap_le = build_seed_bitmap(
                unit, k=self.config.seed_k, le=True)
            # candidate (device) batch: small — the host stage-A prescan
            # (ops/seed_filter.host_prescan_hits) drops ~95% of rows
            # before upload, so the fused step only ever sees candidates.
            # Bigger batches flush too rarely to overlap with host fill
            # on realistic stream lengths (256 not yet re-measured on a
            # GPU).
            self.cand_batch = min(
                self.batch, -(-256 // n_dev) * n_dev)
            self._fused = make_fused_recruit(
                self._seed_bitmap, self.peq_fwd, self.peq_rc,
                m=self.m, seed_k=self.config.seed_k,
                min_hits=self.config.min_seed_hits,
                k_budget=self.k_budget, scorer=self.scorer,
                mesh=mesh, seed_bitmap_le=self._bitmap_le)

    # -- pure device steps (also used by __graft_entry__) -----------------

    def seed_counts(self, codes: np.ndarray, lens: np.ndarray):
        """(B, SEG) batch -> (B,) int32 seed hit counts (both strands)."""
        from centroflye_tpu.ops.seed_filter import seed_hit_counts
        return np.asarray(seed_hit_counts(
            self._seed_hi, self._seed_lo, codes, lens,
            k=self.config.seed_k))

    def distances(self, codes: np.ndarray, lens: np.ndarray):
        """(B, SEG) int8 batch -> (dist_fwd, dist_rc) each (B,) int32."""
        out = self.scorer(self.peq_fwd, self.peq_rc, codes, lens, m=self.m)
        return out["dist_f"], out["dist_r"]

    # -- streaming host driver -------------------------------------------

    def run(self, reads: Iterable[Tuple[str, str]],
            ) -> Iterator[RecruitmentResult]:
        """Stream (r_id, seq) pairs; yields per-read results in input order.

        Three tiers under config.prefilter:
        1. HOST stage-A prescan (ops/seed_filter.host_prescan_hits, pure
           numpy over the 2-bit packed batch): rows with zero sampled
           seed hits resolve as non-matching WITHOUT crossing the
           host→device link — the link, not compute, bounds streaming
           recruitment, and ~95% of real-data rows stop here;
        2. fused device step (exact sampled filter + Myers on survivors,
           ops/fused_recruit) over compacted candidate rows only;
        3. plain Myers tier for candidate overflow beyond the device
           budget and for rows with in-range N bases (the packed prescan
           is blind to N).
        Failing segments resolve immediately as non-matching (dist = m).

        With a mesh present and the XLA scan as scorer, reads >=
        config.seq_parallel_min_len take the SEQUENCE-PARALLEL tier
        instead: the whole read's DP columns
        shard over the mesh with a device-to-device carry handoff
        (parallel/seq_parallel) — no host segmentation, bit-identical
        distances (the whole-read HW minimum equals the
        overlapped-segment minimum).
        """
        SEG = self.seg_len
        prefilter = self.config.prefilter
        min_hits = self.config.min_seed_hits
        B_f = self.batch                  # host prescan batch: never uploaded
        B = 128 if prefilter else self.batch
        B_c = self.cand_batch if prefilter else 0

        seg_codes = np.full((B, SEG), PAD, dtype=np.int8)
        seg_lens = np.zeros((B,), dtype=np.int32)
        seg_read: List[int] = []          # myers-batch row -> read index

        # prescan batch buffer: rows are fully overwritten on enqueue and
        # rows beyond the fill level carry len 0 (ignored everywhere), so
        # the buffer recycles with no clearing; prescan is synchronous, so
        # one buffer suffices (candidate rows are copied out in packed form).
        # Native fill mode encodes + packs each segment row IN PLACE from
        # the ASCII read (cf_encode_pack_row, one scan, no int8 batch at
        # all — the encode+fill+pack trio was the dominant host cost);
        # the numpy fallback accumulates int8 codes and packs at flush.
        enc_pack = pack_row = None
        if prefilter and SEG % 8 == 0:
            from centroflye_tpu.native import (
                get_encode_pack, get_pack2bit_row)
            enc_pack = get_encode_pack()
            pack_row = get_pack2bit_row()
        native_fill = enc_pack is not None and pack_row is not None
        SEGQ = SEG // 4
        f_packed = np.zeros((B_f, SEGQ), dtype=np.uint8)
        f_lens = np.zeros((B_f,), dtype=np.int32)
        f_read: List[int] = []            # prescan-batch row -> read index
        f_codes = (None if (native_fill or not prefilter)
                   else np.full((B_f, SEG), PAD, dtype=np.int8))
        if native_fill:
            # single-row scratch for array-codes input (native reader path)
            t_codes = np.empty((SEG,), np.int8)
            t_len = np.empty((1,), np.int32)
            t_mask = np.empty((SEG // 8,), np.uint8)
            f_base = f_packed.ctypes.data
            t_codes_ptr = t_codes.ctypes.data
            t_len_ptr = t_len.ctypes.data
            t_mask_ptr = t_mask.ctypes.data

        # candidate (device) batch buffers: recycled only after their
        # in-flight bundle drains — JAX may still be reading the host
        # buffer while the upload is in flight
        cand_bufs: List[Tuple[np.ndarray, np.ndarray]] = [
            (np.zeros((max(B_c, 1), SEG // 4), dtype=np.uint8),
             np.zeros((max(B_c, 1),), dtype=np.int32)) for _ in range(4)]
        c_packed, c_lens = cand_bufs.pop()
        c_read: List[int] = []            # candidate row -> read index

        # per pending read: [r_id, n_pending_segments, min_f, min_r]
        pending: dict = {}
        order: List[int] = []             # read indices in input order
        done: dict = {}
        next_emit = 0
        inflight: List[Tuple] = []
        # fused-tier in-flight queue: (device bundle, row->read map,
        # packed copy, lens copy). Results stay on device until drained so
        # uploads/compute of later batches overlap earlier transfers —
        # materializing per batch would serialize the whole stream on the
        # host link round-trip.
        f_inflight: List[Tuple] = []
        F_DEPTH = self.queue_depth   # bounded in-flight fused bundles

        def resolve(ridx, df, dr):
            rec = pending[ridx]
            rec[2] = min(rec[2], df)
            rec[3] = min(rec[3], dr)
            rec[1] -= 1
            if rec[1] == 0:
                done[ridx] = rec
                del pending[ridx]

        def enqueue_myers(codes_row, length, ridx):
            row = len(seg_read)
            seg_codes[row, :length] = codes_row[:length]
            seg_codes[row, length:] = PAD
            seg_lens[row] = length
            seg_read.append(ridx)
            if len(seg_read) == B:
                flush_myers()

        def flush_myers():
            nonlocal seg_codes, seg_lens, seg_read
            if not seg_read:
                return
            rows = len(seg_read)
            df, dr = self.distances(seg_codes, seg_lens)
            inflight.append((df, dr, list(seg_read), rows))
            seg_codes = np.full((B, SEG), PAD, dtype=np.int8)
            seg_lens = np.zeros((B,), dtype=np.int32)
            seg_read = []
            while len(inflight) > 2:
                drain_one()

        # the fused filter samples every `stride` positions and scales its
        # threshold accordingly; the host fallback must apply the same one
        min_hits_sampled = self._fused.min_hits if prefilter else min_hits

        def flush_prescan():
            """Host tier: pack the batch, run the numpy stage-A prescan,
            and route every row — misses resolve immediately, rows with
            in-range N bases go to the exact Myers tier, candidates are
            copied (packed) into the small device batch. Synchronous and
            device-free: the 2-bit pack + one bitmap gather per 16 bases."""
            nonlocal f_read
            if not f_read:
                return
            from centroflye_tpu.ops.seed_filter import host_prescan_hits
            rows = len(f_read)
            if native_fill:
                # rows were encoded+packed in place; N rows never enter
                packed, n_rows = f_packed[:rows], None
            else:
                from centroflye_tpu.ops.fused_recruit import pack_2bit
                f_lens[rows:] = 0        # stale recycled rows: ignore
                packed, n_mask = pack_2bit(f_codes, f_lens)
                packed = packed[:rows]
                n_rows = n_mask.any(axis=1) if n_mask is not None else None
            hits_a = host_prescan_hits(packed, f_lens[:rows],
                                       self._bitmap_le,
                                       k=self.config.seed_k)
            for row, ridx in enumerate(f_read):
                if n_rows is not None and n_rows[row]:
                    enqueue_myers(f_codes[row], int(f_lens[row]), ridx)
                elif not hits_a[row]:
                    resolve(ridx, self.m, self.m)
                else:
                    crow = len(c_read)
                    c_packed[crow] = packed[row]
                    c_lens[crow] = f_lens[row]
                    c_read.append(ridx)
                    if len(c_read) == B_c:
                        flush_cands()
            f_read = []

        def flush_cands():
            """Fused device tier: one call computes the exact sampled
            filter AND the Myers distances of passing candidate rows
            (ops/fused_recruit). The call is asynchronous — the bundled
            result stays on device in f_inflight until drained, so
            prescan/upload of later batches overlaps this batch's compute
            and readback."""
            nonlocal c_packed, c_lens, c_read
            if not c_read:
                return
            rows = len(c_read)
            c_lens[rows:] = 0            # stale recycled rows: ignore
            bundle = self._fused.raw(c_packed, None, c_lens)
            f_inflight.append((bundle, c_read, c_packed, c_lens))
            if cand_bufs:
                c_packed, c_lens = cand_bufs.pop()
            else:
                c_packed = np.zeros((B_c, SEG // 4), dtype=np.uint8)
                c_lens = np.zeros((B_c,), dtype=np.int32)
            c_read = []
            while len(f_inflight) > F_DEPTH:
                drain_cands_one()

        def drain_cands_one():
            """Materialize the oldest fused bundle; overflow beyond the
            device survivor budget falls back to the plain Myers tier
            (packed rows were kept with the queue entry for exactly this;
            candidate rows never contain N, so the host unpack is exact)."""
            bundle, rows_map, packed_snap, lens_snap = f_inflight.pop(0)
            df, dr, hits, n_pass = self._fused.unbundle(
                np.asarray(bundle), lens_snap.shape[0])
            if n_pass <= self.k_budget:
                for row, ridx in enumerate(rows_map):
                    resolve(ridx, int(df[row]), int(dr[row]))
            else:
                from centroflye_tpu.ops.fused_recruit import unpack_2bit_host
                codes_snap = unpack_2bit_host(packed_snap)
                for row, ridx in enumerate(rows_map):
                    if int(hits[row]) >= min_hits_sampled:
                        enqueue_myers(codes_snap[row], int(lens_snap[row]),
                                      ridx)
                    else:
                        resolve(ridx, self.m, self.m)
            cand_bufs.append((packed_snap, lens_snap))

        def drain_one():
            df, dr, rows_map, rows = inflight.pop(0)
            df = np.asarray(df)[:rows]
            dr = np.asarray(dr)[:rows]
            for row, ridx in enumerate(rows_map):
                resolve(ridx, int(df[row]), int(dr[row]))

        def emit_ready():
            nonlocal next_emit
            while next_emit < len(order) and order[next_emit] in done:
                ridx = order[next_emit]
                r_id, _, mf, mr = done.pop(ridx)
                yield RecruitmentResult(
                    r_id=r_id, dist_fwd=mf, dist_rc=mr,
                    recruited=min(mf, mr) <= self.threshold)
                next_emit += 1

        # sequence-parallel long-read tier: whole reads batched and
        # scored with DP columns sharded over the mesh (exact — the
        # whole-read HW minimum equals the overlapped-segment minimum)
        long_batch: List[Tuple[int, np.ndarray]] = []
        LB = 8

        def flush_seqpar():
            nonlocal long_batch
            if not long_batch:
                return
            from centroflye_tpu.parallel.seq_parallel import (
                myers_distance_seqparallel)
            axis = self.mesh.axis_names[0]
            Lmax = max(len(c) for _, c in long_batch)
            Lb = -(-Lmax // SEG) * SEG      # bucketed shape: few compiles
            Bn = len(long_batch)
            text = np.full((Bn, Lb), PAD, np.int8)
            lens_l = np.zeros((Bn,), np.int32)
            for i, (_, c) in enumerate(long_batch):
                text[i, :len(c)] = c
                lens_l[i] = len(c)
            out_f = myers_distance_seqparallel(
                self.peq_fwd, text, lens_l, m=self.m,
                mesh=self.mesh, axis=axis)
            out_r = myers_distance_seqparallel(
                self.peq_rc, text, lens_l, m=self.m,
                mesh=self.mesh, axis=axis)
            for i, (ridx, _) in enumerate(long_batch):
                resolve(ridx, int(out_f["dist"][i]),
                        int(out_r["dist"][i]))
            long_batch = []

        # in-order emission lag bound: one straggler read parked in a
        # part-filled exact-tier batch (an N segment or a fused-overflow
        # row — rare in background-dominated streams, so that batch may
        # not fill for a long stretch) blocks ordered emission for every
        # later read, and streaming callers must hold those reads'
        # sequences until the straggler resolves (measured on the
        # 1M-read soak: RSS tripled in the second half of the stream).
        # When the lag exceeds a bound, force-flush every tier.
        LAG_LIMIT = max(32768, 16 * B)

        def force_drain():
            if prefilter:
                flush_prescan()
                flush_cands()
                while f_inflight:
                    drain_cands_one()
            flush_myers()
            while inflight:
                drain_one()
            if self.seqpar_min:
                flush_seqpar()

        read_idx = 0
        for r_id, seq in reads:
            if read_idx - next_emit > LAG_LIMIT:
                force_drain()
                yield from emit_ready()
            is_arr = isinstance(seq, np.ndarray)
            if native_fill and not is_arr:
                raw = seq.encode("ascii")    # no int8 encode: rows pack
                codes = None                 # straight from the ASCII
                n_len = len(raw)
            else:
                codes = seq if is_arr else encode(seq)
                n_len = len(codes)
            if self.seqpar_min and n_len >= self.seqpar_min:
                pending[read_idx] = [r_id, 1, self.m, self.m]
                order.append(read_idx)
                c = codes if codes is not None else encode(seq)
                long_batch.append((read_idx, np.asarray(c, np.int8)))
                if len(long_batch) >= LB:
                    flush_seqpar()
                    yield from emit_ready()
                read_idx += 1
                continue
            starts = segment_starts(n_len, SEG, self.overlap)
            pending[read_idx] = [r_id, len(starts), self.m, self.m]
            order.append(read_idx)
            for st in starts:
                ln = min(SEG, n_len - st)
                if prefilter and native_fill:
                    row = len(f_read)
                    if codes is None:
                        flag = enc_pack(raw, st, ln,
                                        f_base + row * SEGQ, SEGQ)
                    else:
                        t_codes[:ln] = codes[st:st + ln]
                        t_len[0] = ln
                        flag = pack_row(t_codes_ptr, 1, SEG, t_len_ptr,
                                        f_base + row * SEGQ, t_mask_ptr)
                    if flag:
                        # non-ACGT in range: exact (mask-aware) tier
                        cseg = (encode(seq[st:st + ln]) if codes is None
                                else codes[st:st + ln])
                        enqueue_myers(cseg, ln, read_idx)
                    else:
                        f_lens[row] = ln
                        f_read.append(read_idx)
                        if len(f_read) == B_f:
                            flush_prescan()
                            yield from emit_ready()
                elif prefilter:
                    chunk = codes[st:st + SEG]
                    row = len(f_read)
                    f_codes[row, :ln] = chunk
                    f_codes[row, ln:] = PAD
                    f_lens[row] = ln
                    f_read.append(read_idx)
                    if len(f_read) == B_f:
                        flush_prescan()
                        yield from emit_ready()
                else:
                    enqueue_myers(codes[st:st + SEG], ln, read_idx)
                    yield from emit_ready()
            read_idx += 1
        flush_seqpar()
        if prefilter:
            flush_prescan()
            flush_cands()
            while f_inflight:
                drain_cands_one()      # may enqueue Myers fallback rows
        flush_myers()
        while inflight:
            drain_one()
        yield from emit_ready()


def recruit_file(unit_fn: str, reads_fn: str, output_fn: str,
                 threshold: int, batch_size: int = 256,
                 seg_len: int = 32768, mesh="auto",
                 distributed: bool = False) -> int:
    """File-level driver with the same CLI contract as the reference rr
    binary (rr.cpp:43: unit.fasta reads.fasta[.gz] output.fasta threshold).
    Returns the number of recruited reads. Uses the native streaming
    packer (native/seqio.cpp) when built — base codes flow from the C++
    reader straight into device batches; only recruited reads are decoded
    back to strings for output.

    distributed=True on a multi-process run shards the read
    stream round-robin over processes (the redesign of the reference's
    awk-split + xargs -P fan-out, run_read_recruitment.sh:35-44): each
    process recruits its share on its own devices and writes a partial
    artifact; process 0 merges them back into exact global input order
    (parallel/distributed.py). Single-process runs are unchanged."""
    import jax as _jax
    if distributed and _jax.process_count() > 1:
        return _recruit_file_distributed(
            unit_fn, reads_fn, output_fn, threshold=threshold,
            batch_size=batch_size, seg_len=seg_len, mesh=mesh)
    from centroflye_tpu.io import read_seq, iter_seqs
    from centroflye_tpu.io.encoding import decode

    unit = read_seq(unit_fn)
    engine = RecruitmentEngine(
        unit, RecruitmentConfig(threshold=threshold, batch_size=batch_size),
        seg_len=seg_len, mesh=mesh)

    n_recruited = 0
    # recruited reads stream straight to the output FASTA; sequences are
    # held (as codes or strings) only while their decision is pending.
    # Keyed by input position, not read id — the engine yields results in
    # input order, and duplicate ids must stream through like the
    # reference rr does (rr.cpp:73-87 never inspects names).
    import collections
    pending_seqs: collections.deque = collections.deque()

    def reads_iter():
        try:
            from centroflye_tpu.native import (
                native_available, native_iter_seqs)
            use_native = native_available()
        except ImportError:
            use_native = False
        it = native_iter_seqs(reads_fn) if use_native \
            else iter_seqs(reads_fn)
        for r_id, seq in it:
            pending_seqs.append(seq)
            yield r_id, seq

    from centroflye_tpu.io.fasta import atomic_write
    with atomic_write(output_fn) as out:
        for res in engine.run(reads_iter()):
            seq = pending_seqs.popleft()
            if res.recruited:
                if isinstance(seq, np.ndarray):
                    seq = decode(seq)
                out.write(f">{res.r_id}\n{seq}\n")
                n_recruited += 1
    return n_recruited


def _recruit_file_distributed(unit_fn: str, reads_fn: str, output_fn: str,
                              *, threshold: int, batch_size: int,
                              seg_len: int, mesh) -> int:
    """Multi-process recruit_file body: every process streams the shared
    input, keeps its round-robin share (no coordination needed), recruits
    on its local devices, and writes `output_fn.part{p}` with global
    ordinals in the headers; the coordinator merges. Returns the global
    recruited count on the coordinator, the local count elsewhere."""
    import os

    from centroflye_tpu.io import read_seq, iter_seqs
    from centroflye_tpu.io.encoding import decode
    from centroflye_tpu.parallel.distributed import (
        finish_partial, is_coordinator, merge_partial_fastas, partial_path,
        shard_read_stream)

    unit = read_seq(unit_fn)
    engine = RecruitmentEngine(
        unit, RecruitmentConfig(threshold=threshold, batch_size=batch_size),
        seg_len=seg_len, mesh=mesh)

    import collections
    pending: collections.deque = collections.deque()  # (ordinal, seq)

    def reads_iter():
        try:
            from centroflye_tpu.native import (
                native_available, native_iter_seqs)
            use_native = native_available()
        except ImportError:
            use_native = False
        it = native_iter_seqs(reads_fn) if use_native \
            else iter_seqs(reads_fn)
        for ordinal, (r_id, seq) in shard_read_stream(it):
            pending.append((ordinal, seq))
            yield r_id, seq

    os.makedirs(os.path.dirname(os.path.abspath(output_fn)), exist_ok=True)
    n_local = 0
    part_fn = partial_path(output_fn)
    with open(part_fn, "w") as out:
        for res in engine.run(reads_iter()):
            ordinal, seq = pending.popleft()
            if res.recruited:
                if isinstance(seq, np.ndarray):
                    seq = decode(seq)
                out.write(f">{ordinal} {res.r_id}\n{seq}\n")
                n_local += 1
    finish_partial(output_fn)
    if is_coordinator():
        return merge_partial_fastas(output_fn)
    return n_local


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="Recruit centromeric reads (rr equivalent)")
    parser.add_argument("unit")
    parser.add_argument("reads")
    parser.add_argument("output")
    parser.add_argument("threshold", type=int)
    parser.add_argument("--batch-size", type=int, default=256)
    args = parser.parse_args(argv)
    n = recruit_file(args.unit, args.reads, args.output, args.threshold,
                     batch_size=args.batch_size)
    print(f"recruited {n} reads")


if __name__ == "__main__":
    main()
