"""centroflye_tpu — a centromere assembly engine in JAX.

A from-scratch reimplementation of the centroFlye method (Bzikadze & Pevzner,
Nat. Biotech. 2020; reference implementation seryrzu/centroFlye): JAX/XLA
device compute with a CUDA kernel for the recruitment scorer on NVIDIA GPUs,
shard_map data parallelism over device meshes, and a small C++ native
runtime for streaming sequence IO and exact-parity alignment checks.

Subpackages
-----------
- ``io``        sequence IO (FASTA/FASTQ(.gz)), 2-bit encodings, artifact store
- ``ops``       device compute primitives (Myers edit distance, k-mer ops,
                placement scoring), with the recruitment scorer's CUDA kernel
- ``stages``    the cenX pipeline stages (recruitment, unit decomposition,
                rare/unique k-mer recruitment, read placement, consensus,
                polishing)
- ``mono``      the centroFlyeMono (cen6) monomer-alphabet pipeline
- ``parallel``  mesh construction + sharded multi-device execution
- ``pipeline``  end-to-end drivers and the tandem-repeat simulator
- ``native``    ctypes bindings to the C++ runtime (libcfnative)
"""

__version__ = "0.1.0"

import os as _os

# the persistent compile cache when JAX_COMPILATION_CACHE_DIR is unset: one
# fixed directory in the checkout (the path is part of what makes a hit)
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def compilation_cache_dir(environ=_os.environ) -> str | None:
    """The directory this package points JAX's compile cache at, or None
    when JAX_COMPILATION_CACHE_DIR is set (JAX then uses that directory
    itself and the package sets no other)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CACHE_DIR


def _enable_compilation_cache() -> None:
    """Point JAX at the persistent on-disk compile cache. The sweep and
    pipeline stages compile many programs; the cache shares them across
    processes and pipeline stages."""
    import jax
    path = compilation_cache_dir()
    if path is not None:
        _os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # cache everything, including sub-second compiles: pipeline runs
    # touch many small shapes and re-tracing dominates cold starts
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


_enable_compilation_cache()

from centroflye_tpu.config import CentroFlyeConfig  # noqa: F401,E402
