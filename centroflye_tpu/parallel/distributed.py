"""Multi-process execution glue.

The reference has no multi-node anything (SURVEY §2.2); this engine scales
by data-parallelism over reads. In a multi-process run:

- every process calls `init_distributed()` (jax.distributed handshake),
  builds the global mesh over all devices, and streams its own shard of
  the read files (`shard_read_files` splits by round-robin so processes
  need no coordination);
- per-shard tables merge with the collectives in parallel/mesh.py;
- stage artifacts are written by process 0 only (`is_coordinator`).

A JAX process reserves most of the memory of every GPU it opens, so two
processes must never open the same card: run one process per host (it
drives all of that host's cards), or pin each process to its own cards
with `local_device_ids`. A single process on one host, with the mesh in
parallel/mesh.py over its local cards, is the default and needs none of
this.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import jax

_ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Optional[Sequence[int]] = None,
                     ) -> bool:
    """Join a multi-process run; returns True when one is active.

    Nothing on a GPU host describes the cluster to JAX, so the
    coordinator address (host:port), the process count and this
    process's id are all required, from the arguments or else from
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID (with
    CENTROFLYE_LOCAL_DEVICE_IDS, a comma list, for `local_device_ids`).
    With none of them given this is a single-process no-op. Leave
    `local_device_ids` unset only with one process per host."""
    args = (coordinator_address, num_processes, process_id)
    if all(a is None for a in args):
        if not any(v in os.environ for v in _ENV):
            return jax.process_count() > 1
        missing = [v for v in _ENV if v not in os.environ]
        if missing:
            raise ValueError(f"multi-process run needs {', '.join(missing)}")
        coordinator_address = os.environ["JAX_COORDINATOR_ADDRESS"]
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
        process_id = int(os.environ["JAX_PROCESS_ID"])
        ids = os.environ.get("CENTROFLYE_LOCAL_DEVICE_IDS")
        if ids and local_device_ids is None:
            local_device_ids = [int(i) for i in ids.split(",")]
    elif any(a is None for a in args):
        raise ValueError("coordinator_address, num_processes and "
                         "process_id are required together")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids)
    return jax.process_count() > 1


def is_coordinator() -> bool:
    return jax.process_index() == 0


def shard_read_files(files: List[str]) -> List[str]:
    """Round-robin assignment of input files to this process."""
    return [f for i, f in enumerate(files)
            if i % jax.process_count() == jax.process_index()]


def shard_read_stream(reads: Iterable[Tuple[str, str]]
                      ) -> Iterator[Tuple[int, Tuple[str, str]]]:
    """Round-robin assignment of reads within one stream (for a single
    shared input file on a common filesystem). Yields (global_ordinal,
    (r_id, seq)) so per-process outputs can be merged back into exact
    global input order."""
    p = jax.process_index()
    n = jax.process_count()
    for i, item in enumerate(reads):
        if i % n == p:
            yield i, item


def partial_path(output_fn: str, process: Optional[int] = None) -> str:
    p = jax.process_index() if process is None else process
    return f"{output_fn}.part{p}"


def finish_partial(output_fn: str) -> None:
    """Mark this process's partial artifact complete (shared-filesystem
    barrier token; the coordinator merge waits on all tokens)."""
    with open(partial_path(output_fn) + ".done", "w") as f:
        f.write("done\n")


def merge_partial_fastas(output_fn: str, timeout_s: float = 3600.0,
                         poll_s: float = 0.5) -> int:
    """Coordinator-side merge of all processes' partial FASTAs into
    `output_fn` in exact global input order. Each part line format:
    `>ordinal r_id` / sequence (written by the distributed recruit path).
    Waits for every process's .done token (shared filesystem), then
    streams a sorted merge. Returns the merged record count — the same
    count (and byte-identical file modulo the ordinal tags being removed)
    as a single-process run."""
    import time

    n = jax.process_count()
    deadline = time.monotonic() + timeout_s
    parts = [partial_path(output_fn, p) for p in range(n)]
    while any(not os.path.exists(p + ".done") for p in parts):
        if time.monotonic() > deadline:
            missing = [p for p in parts if not os.path.exists(p + ".done")]
            raise TimeoutError(f"partial artifacts never finished: {missing}")
        time.sleep(poll_s)

    records = []
    for part in parts:
        with open(part) as f:
            header = None
            for line in f:
                line = line.rstrip("\n")
                if line.startswith(">"):
                    header = line[1:]
                elif header is not None:
                    ordinal, _, r_id = header.partition(" ")
                    records.append((int(ordinal), r_id, line))
                    header = None
    records.sort()
    from centroflye_tpu.io.fasta import atomic_write
    with atomic_write(output_fn) as out:
        for _, r_id, seq in records:
            out.write(f">{r_id}\n{seq}\n")
    for part in parts:
        os.remove(part)
        os.remove(part + ".done")
    return len(records)
