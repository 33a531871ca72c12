"""Test configuration: by default the tests run on an 8-device virtual
CPU platform, so sharding tests need no accelerator. The `gpu`-marked
tests need an NVIDIA card and skip elsewhere; run them on a GPU host with
`CENTROFLYE_TEST_PLATFORM=gpu python -m pytest -m gpu tests/`, which
leaves JAX on its default platform.
"""

import os

if os.environ.get("CENTROFLYE_TEST_PLATFORM", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

if os.environ.get("CENTROFLYE_TEST_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first JAX device when it is an NVIDIA GPU; skips otherwise
    (decided here, at run time, so every worker collects the same
    tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (CENTROFLYE_TEST_PLATFORM=gpu)")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(17)


def random_dna(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


@pytest.fixture
def make_dna(rng):
    def _make(n):
        return random_dna(rng, n)
    return _make


def mutate(rng, seq: str, n_sub=0, n_ins=0, n_del=0) -> str:
    """Apply exactly the given numbers of random subs/inserts/deletes."""
    s = list(seq)
    for _ in range(n_sub):
        i = int(rng.integers(0, len(s)))
        choices = [c for c in "ACGT" if c != s[i]]
        s[i] = choices[int(rng.integers(0, 3))]
    for _ in range(n_ins):
        i = int(rng.integers(0, len(s) + 1))
        s.insert(i, "ACGT"[int(rng.integers(0, 4))])
    for _ in range(n_del):
        i = int(rng.integers(0, len(s)))
        del s[i]
    return "".join(s)


@pytest.fixture
def make_mutant(rng):
    def _make(seq, n_sub=0, n_ins=0, n_del=0):
        return mutate(rng, seq, n_sub, n_ins, n_del)
    return _make


# files whose tests are long-running (e2e assemblies, reference-subprocess
# parity, 8-device pipeline identity): auto-mark as `slow` so
# `pytest -m "not slow"` stays a sub-minute signal
_SLOW_FILES = ("test_e2e_cenx", "test_mono_e2e", "test_reference_parity",
               "test_parallel")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if any(s in str(item.fspath) for s in _SLOW_FILES):
            item.add_marker(pytest.mark.slow)
