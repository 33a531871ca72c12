"""chip_smoke.py refuses to report success without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "chip_smoke.py")


@pytest.mark.parametrize("alone", [False, True],
                         ids=["in_checkout", "script_alone"])
def test_chip_smoke_fails_on_cpu(tmp_path, alone):
    script = SMOKE
    if alone:           # a directory holding chip_smoke.py and nothing else
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SMOKE, script)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, script], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert not res.stdout.strip() or "{" not in res.stdout.splitlines()[-1]


def _smoke_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def smoke(monkeypatch):
    mod = _smoke_module()
    monkeypatch.setattr(mod, "TIMING_RUNS", 1)
    return mod


def test_kernel_phase_accepts_exact_scorer(smoke):
    """Phase 2's exact comparison with the C++ engine, run with the XLA
    scorer at a small size (the CUDA kernel needs a card)."""
    from centroflye_tpu.native import load_native
    from centroflye_tpu.ops.myers_cuda import myers_hw_2strand_xla
    if load_native(build=True) is None:
        pytest.skip("native lib not built")
    smoke.phase_kernel(7, scorer=myers_hw_2strand_xla, n=8, L=2560,
                       timing_batches=(8,))


def test_kernel_phase_rejects_off_by_one_scorer(smoke):
    from centroflye_tpu.native import load_native
    from centroflye_tpu.ops.myers_cuda import myers_hw_2strand_xla
    if load_native(build=True) is None:
        pytest.skip("native lib not built")

    def off_by_one(*args, m):
        out = dict(myers_hw_2strand_xla(*args, m=m))
        out["end_r"] = out["end_r"] + 1
        return out
    off_by_one.__name__ = "off_by_one"
    with pytest.raises(AssertionError, match="strand r"):
        smoke.phase_kernel(7, scorer=off_by_one, n=8, L=2560,
                           timing_batches=())


def test_recruit_phase_matches_exact_tier(smoke):
    got = smoke.phase_recruit(7, n_reads=256)
    assert len(got) >= 5
