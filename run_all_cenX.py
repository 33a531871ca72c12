#!/usr/bin/env python
"""End-to-end cenX runner (role of the reference run_all_cenX.sh:7-22:
build native tool -> recruit -> assemble). Usage:
    python run_all_cenX.py <reads.fasta[.gz]> <outdir> [coverage]
                           [--distributed]

One process drives every local device (GPUs are sharded over with the
mesh in parallel/mesh.py). --distributed joins a multi-process run
described by JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and
JAX_PROCESS_ID (parallel/distributed.init_distributed): reads are
sharded round-robin over processes for recruitment and process 0 runs
the remaining stages on the merged artifact.
"""
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def assemble(reads: str, outdir: str, coverage: int = 32, *, mesh="auto",
             distributed: bool = False):
    """Build the native runtime, then run CenXPipeline on `reads` into
    `outdir`. Returns (pipeline, final assembly sequence)."""
    # the native runtime is optional: stages fall back to Python without it
    subprocess.run(["make", "-C",
                    os.path.join(HERE, "centroflye_tpu", "native")],
                   check=False, capture_output=True)
    from centroflye_tpu.config import CentroFlyeConfig
    from centroflye_tpu.io import read_seq
    from centroflye_tpu.pipeline.cenx import CenXPipeline

    if distributed:
        from centroflye_tpu.parallel.distributed import init_distributed
        distributed = init_distributed()
    unit = read_seq(os.path.join(HERE, "centroflye_tpu", "data",
                                 "DXZ1_rc.fasta"))
    pipe = CenXPipeline(unit, CentroFlyeConfig(coverage=coverage), outdir,
                        mesh=mesh, distributed=distributed)
    return pipe, pipe.run(reads)


def main():
    args = [a for a in sys.argv[1:] if a != "--distributed"]
    if len(args) < 2:
        print(__doc__)
        sys.exit(1)
    sys.path.insert(0, HERE)
    _, final = assemble(args[0], args[1],
                        int(args[2]) if len(args) > 2 else 32,
                        distributed="--distributed" in sys.argv[1:])
    if final:
        print(f"final assembly: {len(final)} bp -> "
              f"{os.path.join(args[1], 'final_assembly.fasta')}")


if __name__ == "__main__":
    main()
