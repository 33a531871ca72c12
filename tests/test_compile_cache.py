"""Where the package points JAX's persistent compile cache."""

import os

import centroflye_tpu


def test_cache_defaults_to_fixed_dir_in_checkout():
    path = centroflye_tpu.compilation_cache_dir({})
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        centroflye_tpu.__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert path == centroflye_tpu.compilation_cache_dir({"HOME": "/x"})


def test_cache_env_var_wins_and_package_sets_none():
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/cache"}
    assert centroflye_tpu.compilation_cache_dir(env) is None
