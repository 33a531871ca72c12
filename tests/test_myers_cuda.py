"""Two-strand recruitment scorer (ops/myers_cuda): the choice of scorer,
the CUDA wrapper's shapes and padding, the kernel's lane-carry scheme
emulated in numpy, and the plain XLA scorer against the DP oracle and
the native engine at the DXZ1 unit length. The CUDA kernel itself has no
CPU mode; the `gpu`-marked test runs it on a card, and chip_smoke.py's
kernel phase checks the same contract at the engine's real shapes."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from centroflye_tpu.io import encode, encode_batch
from centroflye_tpu.io.encoding import revcomp, revcomp_str
from centroflye_tpu.native import load_native, native_edit_distance_batch
from centroflye_tpu.ops import myers_cuda
from centroflye_tpu.ops.myers import (
    build_peq, edit_distance_oracle, n_words)
from centroflye_tpu.ops.myers_cuda import (
    MAX_M, myers_hw_2strand, myers_hw_2strand_xla, two_strand_scorer)
from centroflye_tpu.pipeline.simulate import add_read_noise, gen_random_seq

DXZ1 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "centroflye_tpu", "data", "DXZ1_rc.fasta")
_M32 = np.uint64(0xFFFFFFFF)


def warp_emulation(peq, text, lens, m, K):
    """numpy model of ops/cuda/myers_hw.cu for one strand: each row is a
    warp of 32 lanes owning K words each; the carry between lanes comes
    from the generate/propagate ballots, the shift from one lane shuffle.
    Returns (dist, end) like myers_distance_batch(mode="HW")."""
    R, L = text.shape
    W = peq.shape[1]
    assert W <= 32 * K
    P = np.zeros((5, 32 * K), np.uint64)
    P[:, :W] = peq
    P = P.reshape(5, 32, K)
    lanes = np.arange(32, dtype=np.uint64)
    vp = np.full((R, 32, K), _M32, np.uint64)
    vn = np.zeros((R, 32, K), np.uint64)
    owner, kk = divmod((m - 1) // 32, K)
    hb = np.uint64((m - 1) % 32)
    score = np.full(R, m, np.int64)
    best = np.full(R, m, np.int64)
    end = np.full(R, -1, np.int64)
    one = np.uint64(1)
    for j in range(L):
        eq = P[np.minimum(text[:, j].astype(np.int64), 4)]
        x = eq & vp
        s = np.zeros_like(vp)
        carry = np.zeros((R, 32), np.uint64)
        ones = np.ones((R, 32), bool)
        for k in range(K):
            t1 = (x[:, :, k] + vp[:, :, k]) & _M32
            t2 = (t1 + carry) & _M32
            carry = ((t1 < x[:, :, k]) | (t2 < t1)).astype(np.uint64)
            s[:, :, k] = t2
            ones &= t2 == _M32
        g = (carry << lanes).sum(axis=1)                    # ballots
        p = (ones.astype(np.uint64) << lanes).sum(axis=1)
        a = g | p
        cin = (((((a + g) & _M32) ^ a ^ g)[:, None]) >> lanes) & one
        for k in range(K):
            sk = (s[:, :, k] + cin) & _M32
            cin = cin & (s[:, :, k] == _M32)
            s[:, :, k] = sk
        d0 = (s ^ vp) | eq | vn
        hp = vn | (~(d0 | vp) & _M32)
        hn = vp & d0
        inc = ((hp[:, owner, kk] >> hb) & one).astype(np.int64) - \
            ((hn[:, owner, kk] >> hb) & one).astype(np.int64)
        top = (hp[:, :, K - 1] >> np.uint64(31)) | \
            ((hn[:, :, K - 1] >> np.uint64(31)) << one)
        below = np.zeros_like(top)                          # shuffle up
        below[:, 1:] = top[:, :-1]
        hps = np.empty_like(hp)
        hns = np.empty_like(hn)
        for k in range(K):
            in_p = hp[:, :, k - 1] >> np.uint64(31) if k else below & one
            in_n = hn[:, :, k - 1] >> np.uint64(31) if k else below >> one
            hps[:, :, k] = ((hp[:, :, k] << one) & _M32) | in_p
            hns[:, :, k] = ((hn[:, :, k] << one) & _M32) | in_n
        active = j < lens
        sel = active[:, None, None]
        vp = np.where(sel, hns | (~(d0 | hps) & _M32), vp)
        vn = np.where(sel, hps & d0, vn)
        score = np.where(active, score + inc, score)
        improved = active & (score < best)
        best = np.where(improved, score, best)
        end = np.where(improved, j, end)
    return best, end


@pytest.mark.parametrize("m,K", [(23, 1), (64, 1), (100, 2), (150, 3)])
def test_warp_emulation_matches_oracle(m, K, rng, make_dna):
    """The kernel's lane layout and ballot carry, with K words per lane
    (K > 1 puts in-lane ripple and cross-lane carries on one path)."""
    q = make_dna(m)
    texts = [make_dna(int(rng.integers(10, 250))) for _ in range(6)]
    texts += [q + "NNN" + q[: m // 2], "", "N" * 40]
    codes, lens = encode_batch(texts, max_len=256)
    dist, end = warp_emulation(build_peq(encode(q)), np.asarray(codes),
                               np.asarray(lens), m, K)
    for i, t in enumerate(texts):
        assert (dist[i], end[i]) == edit_distance_oracle(q, t, "HW"), i


def _dxz1_batch(rng, L, n_rows):
    """DXZ1 rows as the engine sees them: noisy tandem copies on both
    strands, random sequence, an all-N row and an empty row."""
    from centroflye_tpu.io import read_seq
    unit = read_seq(DXZ1)
    rows = []
    for i in range(n_rows - 2):
        if i % 3 == 0:
            seq = add_read_noise(rng, unit * 2, 0.10)[:L]
            rows.append(revcomp_str(seq) if i % 2 else seq)
        else:
            rows.append(gen_random_seq(rng, int(rng.integers(L // 2, L))))
    rows += ["N" * L, ""]
    codes, lens = encode_batch(rows, max_len=L)
    return unit, np.asarray(codes), np.asarray(lens)


@pytest.mark.skipif(load_native(build=True) is None,
                    reason="native lib not built")
def test_warp_emulation_matches_native_dxz1(rng):
    unit, codes, lens = _dxz1_batch(rng, 2560, 5)
    m = len(unit)
    K = -(-n_words(m) // 32)
    dist, end = warp_emulation(build_peq(encode(unit)), codes, lens, m, K)
    nd, ne = native_edit_distance_batch(encode(unit), codes, lens, "HW")
    assert np.array_equal(dist, nd) and np.array_equal(end, ne)


@pytest.mark.skipif(load_native(build=True) is None,
                    reason="native lib not built")
def test_xla_two_strand_matches_native_dxz1(rng):
    """The plain scorer at m = 2055: dist and end of both strands equal
    the independent C++ engine, including all-N and empty rows."""
    unit, codes, lens = _dxz1_batch(rng, 4096, 8)
    u = encode(unit)
    out = myers_hw_2strand_xla(build_peq(u), build_peq(revcomp(u)),
                               codes, lens, m=len(unit))
    for strand, q in (("f", u), ("r", revcomp(u))):
        nd, ne = native_edit_distance_batch(q, codes, lens, "HW")
        assert np.array_equal(np.asarray(out["dist_" + strand]), nd)
        assert np.array_equal(np.asarray(out["end_" + strand]), ne)
    assert int(out["dist_f"][-1]) == int(out["dist_f"][-2]) == len(unit)
    assert int(out["end_f"][-1]) == -1


def _custom_call_types(B, L, m):
    """Lower the CUDA wrapper for the "cuda" platform (no card needed)
    and return the custom call's operand and result tensor types."""
    peq = jnp.zeros((5, n_words(m)), jnp.uint32)
    text = jnp.zeros((B, L), jnp.int8)
    lens = jnp.zeros((B,), jnp.int32)
    lib = myers_cuda._lib
    myers_cuda._lib = lib or object()   # lowering needs no library
    try:
        txt = myers_hw_2strand.trace(peq, peq, text, lens, m=m).lower(
            lowering_platforms=("cuda",)).as_text()
    finally:
        myers_cuda._lib = lib
    line = next(ln for ln in txt.splitlines()
                if "custom_call @" + myers_cuda.TARGET in ln)
    return re.findall(r"tensor<([0-9x]+)x(?:ui32|i8|i32)>",
                      line.split(":")[-1])


@pytest.mark.parametrize("B,L,Lpad", [(5, 37, 48), (128, 10240, 10240),
                                      (1, 1, 16)])
def test_cuda_wrapper_pads_text_rows(B, L, Lpad):
    """Rows are padded to whole 16-byte loads; odd batch sizes pass
    through unpadded (one block per row); outputs are (2, B)."""
    types = _custom_call_types(B, L, 2055)
    assert types == ["2x5x65", f"{B}x{Lpad}", f"{B}", f"2x{B}", f"2x{B}"]


def test_cuda_wrapper_rejects_long_unit():
    with pytest.raises(ValueError):
        _custom_call_types(4, 64, MAX_M + 1)


@pytest.mark.parametrize("platform,m,kernel", [
    ("gpu", 2055, True), ("gpu", MAX_M, True), ("gpu", MAX_M + 1, False),
    ("cpu", 2055, False)])
def test_two_strand_scorer_choice(platform, m, kernel):
    scorer = two_strand_scorer(platform, m)
    assert scorer is (myers_hw_2strand if kernel else myers_hw_2strand_xla)


def test_engine_scores_with_platform_choice(rng):
    from centroflye_tpu.config import RecruitmentConfig
    from centroflye_tpu.stages.recruitment import RecruitmentEngine
    eng = RecruitmentEngine(gen_random_seq(rng, 300),
                            RecruitmentConfig(threshold=60, batch_size=8),
                            seg_len=1024, mesh=None)
    assert eng.scorer is two_strand_scorer(jax.devices()[0].platform, 300)


def test_build_without_nvcc_is_an_error(monkeypatch, tmp_path):
    monkeypatch.setattr(myers_cuda, "LIB_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setattr(myers_cuda, "BUILD_DIR", str(tmp_path))
    monkeypatch.delenv("NVCC", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        myers_cuda.build_kernels()


@pytest.mark.gpu
def test_cuda_kernel_matches_xla_on_card(gpu_device, rng):
    unit, codes, lens = _dxz1_batch(rng, 3000, 40)
    u = encode(unit)
    pf, pr = build_peq(u), build_peq(revcomp(u))
    got = myers_hw_2strand(pf, pr, jnp.asarray(codes), jnp.asarray(lens),
                           m=len(unit))
    ref = myers_hw_2strand_xla(pf, pr, codes, lens, m=len(unit))
    for key in ref:
        assert np.array_equal(np.asarray(got[key]), np.asarray(ref[key]))


@pytest.mark.parametrize("kernel", [False, True])
def test_sequence_parallel_tier_only_with_xla_scorer(monkeypatch, kernel):
    """The column-sharded long-read tier shards the XLA scan; with the
    CUDA kernel as scorer the segmented tier scores every read."""
    from centroflye_tpu.config import RecruitmentConfig
    from centroflye_tpu.parallel.mesh import make_mesh
    from centroflye_tpu.stages.recruitment import RecruitmentEngine
    if kernel:
        monkeypatch.setattr(myers_cuda, "two_strand_scorer",
                            lambda platform, m: myers_hw_2strand)
    cfg = RecruitmentConfig(threshold=60, batch_size=8, prefilter=False)
    eng = RecruitmentEngine("ACGT" * 50, cfg, seg_len=1024,
                            mesh=make_mesh(2))
    assert eng.seqpar_min == (0 if kernel else cfg.seq_parallel_min_len)
