"""Multi-host glue (parallel/distributed.py): read-stream sharding and the
coordinator merge of per-process partial artifacts. Multi-process runs are
simulated by monkeypatching jax.process_index/process_count — each simulated
process runs the REAL distributed recruit_file body against a shared
directory, and the merged artifact must be byte-identical to a
single-process run (the reference's cat-of-chunks reduction,
run_read_recruitment.sh:44, made order-exact)."""

import os

import jax
import numpy as np
import pytest

from centroflye_tpu.parallel import distributed as D


def _fake_process(monkeypatch, index: int, count: int):
    monkeypatch.setattr(jax, "process_index", lambda: index)
    monkeypatch.setattr(jax, "process_count", lambda: count)


def test_shard_read_files_partitions(monkeypatch):
    files = [f"f{i}" for i in range(10)]
    shards = []
    for p in range(3):
        _fake_process(monkeypatch, p, 3)
        shards.append(D.shard_read_files(files))
    flat = [f for s in shards for f in s]
    assert sorted(flat) == sorted(files)          # disjoint full cover
    assert shards[0] == ["f0", "f3", "f6", "f9"]  # round-robin


def test_shard_read_stream_ordinals(monkeypatch):
    reads = [(f"r{i}", "ACGT") for i in range(7)]
    seen = {}
    for p in range(2):
        _fake_process(monkeypatch, p, 2)
        for ordinal, (r_id, _) in D.shard_read_stream(iter(reads)):
            assert ordinal not in seen
            seen[ordinal] = r_id
    assert seen == {i: f"r{i}" for i in range(7)}


def test_init_distributed_single_host_noop():
    assert D.init_distributed() is False


def test_distributed_recruit_matches_single(monkeypatch, tmp_path, rng,
                                            make_dna, make_mutant):
    from centroflye_tpu.io import write_seqs
    from centroflye_tpu.stages.recruitment import recruit_file

    unit = make_dna(150)
    reads = {}
    for i in range(12):
        if i % 3 == 0:
            reads[f"read{i:02d}"] = make_mutant(unit * 3, n_sub=20,
                                                n_ins=6, n_del=6)
        else:
            reads[f"read{i:02d}"] = make_dna(600)
    unit_fn = str(tmp_path / "unit.fasta")
    reads_fn = str(tmp_path / "reads.fasta")
    write_seqs(unit_fn, {"unit": unit})
    write_seqs(reads_fn, reads)

    single_fn = str(tmp_path / "single.fasta")
    n_single = recruit_file(unit_fn, reads_fn, single_fn, threshold=40,
                            batch_size=8)
    assert n_single == 4

    dist_fn = str(tmp_path / "dist.fasta")
    # run the worker processes first (non-coordinators), coordinator last
    for p in (1, 0):
        _fake_process(monkeypatch, p, 2)
        n = recruit_file(unit_fn, reads_fn, dist_fn, threshold=40,
                         batch_size=8, distributed=True)
    assert n == n_single                     # coordinator: global count
    with open(single_fn) as a, open(dist_fn) as b:
        assert a.read() == b.read()          # byte-identical artifact
    assert not os.path.exists(dist_fn + ".part0")


def test_merge_timeout(monkeypatch, tmp_path):
    _fake_process(monkeypatch, 0, 2)
    out = str(tmp_path / "out.fasta")
    with open(D.partial_path(out, 0), "w"):
        pass
    D.finish_partial(out)
    with pytest.raises(TimeoutError):
        D.merge_partial_fastas(out, timeout_s=0.2, poll_s=0.05)


def test_init_distributed_needs_whole_cluster_spec(monkeypatch):
    for v in D._ENV:
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:12345")
    with pytest.raises(ValueError, match="JAX_NUM_PROCESSES"):
        D.init_distributed()
    with pytest.raises(ValueError):
        D.init_distributed("localhost:12345", num_processes=2)


def test_init_distributed_pins_local_cards(monkeypatch):
    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:12345")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    monkeypatch.setenv("CENTROFLYE_LOCAL_DEVICE_IDS", "2")
    assert D.init_distributed() is False      # process_count stays 1 here
    assert seen == {"coordinator_address": "localhost:12345",
                    "num_processes": 4, "process_id": 2,
                    "local_device_ids": [2]}
