"""Device engine vs exact oracle (CPU, virtual devices).

f64 mode must agree with the exact engine to ~1e-9; f32 (the production
dtype) must agree on every accept/reject decision on representative data.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from poreseq_tpu.core.regions import MutationInfo
from poreseq_tpu.engine.exact import ExactEngine
from poreseq_tpu.engine.types import AlignData
from poreseq_tpu.sim import simulate_session


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _session(seed=42, **kw):
    rng = np.random.default_rng(seed)
    kw.setdefault("ref_len", 200)
    kw.setdefault("coverage", 4)
    return simulate_session(rng, **kw)


def _rand_muts(rng, seq, n):
    muts = []
    for _ in range(n):
        start = int(rng.integers(0, len(seq) - 6))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            o, mu = seq[start], "ACGT"[int(rng.integers(0, 4))]
        elif kind == 1:
            o, mu = "", "ACGT"[int(rng.integers(0, 4))]
        else:
            o, mu = seq[start : start + int(rng.integers(1, 4))], ""
        mi = MutationInfo()
        mi.start, mi.orig, mi.mut = start, o, mu
        muts.append(mi)
    return muts


def test_score_alignments_f64_matches_exact(x64):
    from poreseq_tpu.engine.tpu import TpuEngine

    pa, _ = _session()
    dE, dT = AlignData.from_session(pa), AlignData.from_session(pa)
    lE = np.zeros(len(pa.sequence))
    lT = np.zeros(len(pa.sequence))
    sE = ExactEngine().score_alignments(dE, likes=lE)
    sT = TpuEngine(dtype=jnp.float64).score_alignments(dT, likes=lT)
    np.testing.assert_allclose(sE, sT, rtol=0, atol=1e-9)
    np.testing.assert_allclose(lE, lT, rtol=0, atol=1e-8)
    for evE, evT in zip(dE.events, dT.events):
        np.testing.assert_array_equal(evE.ref_align, evT.ref_align)


@pytest.mark.slow
def test_score_mutations_f64_matches_exact(x64):
    from poreseq_tpu.engine.tpu import TpuEngine

    rng = np.random.default_rng(1)
    pa, _ = _session(seed=11, draft_error=0.04)
    dE, dT = AlignData.from_session(pa), AlignData.from_session(pa)
    muts = _rand_muts(rng, pa.sequence, 25)
    sE = np.array([m.score for m in ExactEngine().score_mutations(dE, muts)])
    sT = np.array(
        [m.score for m in TpuEngine(dtype=jnp.float64).score_mutations(dT, muts)]
    )
    np.testing.assert_allclose(sE, sT, rtol=0, atol=1e-8)


def test_score_mutations_f64_at_sequence_end(x64):
    """Mutations in the last bases refill columns past the original sequence
    end when they lengthen it; the device scoring band must be placed there
    as the oracle places it (limited_geometry open_tail)."""
    from poreseq_tpu.engine.tpu import TpuEngine

    pa, _ = _session(seed=7, ref_len=250, coverage=5, draft_error=0.03,
                     params=dict(realign_width=60, scoring_width=20))
    seq = pa.sequence
    muts = []
    for start in range(len(seq) - 7, len(seq) + 1):
        for orig, mut in (("", "T"), ("", "GA"), (seq[start:start + 1], ""),
                          (seq[start:start + 1], "C")):
            mi = MutationInfo()
            mi.start, mi.orig, mi.mut = start, orig, mut
            muts.append(mi)
    dE, dT = AlignData.from_session(pa), AlignData.from_session(pa)
    sE = np.array([m.score for m in ExactEngine().score_mutations(dE, muts)])
    sT = np.array(
        [m.score for m in TpuEngine(dtype=jnp.float64).score_mutations(dT, muts)]
    )
    np.testing.assert_allclose(sE, sT, rtol=0, atol=1e-8)


def test_score_mutations_f32_sign_agreement():
    from poreseq_tpu.engine.tpu import TpuEngine

    rng = np.random.default_rng(2)
    pa, _ = _session(seed=13, ref_len=300, coverage=6, draft_error=0.04)
    dE, dT = AlignData.from_session(pa), AlignData.from_session(pa)
    muts = _rand_muts(rng, pa.sequence, 40)
    sE = np.array([m.score for m in ExactEngine().score_mutations(dE, muts)])
    sT = np.array([m.score for m in TpuEngine().score_mutations(dT, muts)])
    assert np.max(np.abs(sE - sT)) < 0.01
    assert np.all((sE > 0) == (sT > 0))


@pytest.mark.slow
def test_tpu_consensus_converges():
    # production widths (realign 300) on CPU: compile-heavy; the fast suite
    # covers f32 consensus via narrower widths (test_f32_e2e, test_cli)
    pa, truth = _session(seed=7, ref_len=300, coverage=8, draft_error=0.04,
                         backend="tpu")
    from poreseq_tpu.api import swalign

    a0 = swalign(pa.sequence, truth)[0]
    pa.Mutate(reps=3)
    pa.Refine()
    a1 = swalign(pa.sequence, truth)[0]
    assert a1 > a0
    assert a1 >= 99.5


def test_tpu_viterbi_candidates_plausible():
    from poreseq_tpu.engine.tpu.viterbi import viterbi_mutate_tpu
    from poreseq_tpu.api import swalign

    pa, truth = _session(seed=3, ref_len=150, coverage=6)
    seqs = viterbi_mutate_tpu(pa.events, 4, 0.05, 0.01, 0.33, 0.75)
    assert len(seqs) == 4
    for s in seqs:
        # candidates seed proposals only; both engines produce ~55-65% here
        acc = swalign(s, truth)[0]
        assert acc > 45.0


def test_tpu_viterbi_deterministic_matches_exact():
    # nkeep=0 (deterministic backtrace) must reproduce the exact engine's
    # candidate string exactly
    pa, truth = _session(seed=5, ref_len=150, coverage=6)
    from poreseq_tpu.engine.tpu.viterbi import viterbi_mutate_tpu

    data = AlignData.from_session(pa)
    se = ExactEngine().viterbi_mutate(data.events, 0, 0.05, 0.01, 0.33, 0.75)
    st = viterbi_mutate_tpu(pa.events, 0, 0.05, 0.01, 0.33, 0.75)
    assert len(st) == 1 and st[0] == se[0]


def test_mut_windows_fast_tail_clamp():
    # mutations whose orig span runs past the sequence end must clamp the
    # deleted span to the in-sequence tail (Sequence.h:38-59) — reachable via
    # deferred-conflict re-scoring after an accepted deletion shortened the
    # sequence.  The fast vectorized window builder must match the literal
    # apply_mutation + seq_to_states path.
    from poreseq_tpu.core.regions import MutationInfo
    from poreseq_tpu.core.sequence import apply_mutation, seq_to_states
    from poreseq_tpu.engine.tpu.mutscore import (_mut_buckets,
                                                 _mut_windows_fast)

    rng = np.random.default_rng(0)
    seq = "".join(rng.choice(list("ACGT"), size=40))
    S0 = len(seq)
    muts = []
    for start in [S0 - 6, S0 - 3, S0 - 2, S0 - 1, S0, S0 + 2, 5, 20]:
        for orig_len in [0, 1, 3, 5, 8]:
            orig = seq[start : start + orig_len] if start < S0 else ""
            if start < S0 and start + orig_len > S0:
                # over-running orig: pad with bases past the end
                orig = seq[start:] + "A" * (start + orig_len - S0)
            for mut in ["", "G", "TTC"]:
                mi = MutationInfo()
                mi.start, mi.orig, mi.mut = start, orig, mut
                muts.append(mi)
    K_all, _ = _mut_buckets(muts)
    st_fast, nst_fast = _mut_windows_fast(seq, muts, K_all)
    for i, m in enumerate(muts):
        mutseq = apply_mutation(seq, m.start, m.orig, m.mut)
        nst = max(len(mutseq) - 4, 0)
        si = max(m.start - 4, 0)
        wl = len(m.mut) + 6
        w = seq_to_states(mutseq)[si : si + wl]
        exp = np.full(K_all, -1, dtype=np.int32)
        exp[: len(w)] = w
        assert nst_fast[i] == nst, (i, m)
        np.testing.assert_array_equal(st_fast[i], exp, err_msg=str((i, m)))


def test_defer_rlk_bounded():
    # Score* API paths with no sync point must not pin unbounded device
    # buffers: the pending map flushes itself past 4 distinct fill outputs
    from poreseq_tpu.engine.tpu import TpuEngine

    eng = TpuEngine.__new__(TpuEngine)
    eng._rlk_pending = {}

    class Ev:
        def __init__(self):
            self.mean = np.zeros(3)
            self.ref_like = None

    evs = [Ev() for _ in range(8)]
    for i, ev in enumerate(evs):
        eng._defer_rlk(ev, np.full((2, 3), float(i)), 0)
    assert len({id(d) for _, d, _ in eng._rlk_pending.values()}) <= 4
    eng.flush_ref_likes()
    assert not eng._rlk_pending
    assert all(ev.ref_like is not None for ev in evs)


def test_tpu_viterbi_multi_matches_solo():
    """viterbi_mutate_tpu_multi must yield each region's solo candidates
    exactly (row-indexed backtrace keys make the batch padding invisible)."""
    from poreseq_tpu.engine.tpu.viterbi import (viterbi_mutate_tpu,
                                                viterbi_mutate_tpu_multi)

    pa1, _ = _session(seed=3, ref_len=150, coverage=6)
    pa2, _ = _session(seed=9, ref_len=220, coverage=4)
    solo1 = viterbi_mutate_tpu(pa1.events, 4, 0.05, 0.01, 0.33, 0.75)
    solo2 = viterbi_mutate_tpu(pa2.events, 4, 0.05, 0.01, 0.33, 0.75)
    multi = viterbi_mutate_tpu_multi([pa1.events, [], pa2.events], 4,
                                     0.05, 0.01, 0.33, 0.75)
    assert multi[0] == solo1
    assert multi[1] == []
    assert multi[2] == solo2


def test_device_geometry_matches_host():
    """PSQ_DEV_GEOM=1 (post-backtrace scoring geometry computed on device,
    mutscore._geom_body) must reproduce the host limited_geometry path's
    mutation scores and realignments exactly."""
    import os

    from poreseq_tpu.engine.driver import find_point_mutations
    from poreseq_tpu.engine.tpu import TpuEngine

    def run(devgeom):
        os.environ["PSQ_DEV_GEOM"] = devgeom
        try:
            datas, mutsl = [], []
            for seed in (1, 2):
                pa, _ = _session(seed=seed, ref_len=120, coverage=5,
                                 draft_error=0.04, backend="tpu")
                d = AlignData.from_session(pa)
                d.params.realign_width = 20
                d.params.scoring_width = 9
                datas.append(d)
                mutsl.append(find_point_mutations(d))
            eng = TpuEngine()
            out = eng.score_mutations_multi(datas, mutsl)
            eng.flush_ref_likes()
            scores = [np.array([m.score for m in ms]) for ms in out]
            rals = [np.concatenate([ev.ref_align for ev in d.events])
                    for d in datas]
            return scores, rals
        finally:
            os.environ.pop("PSQ_DEV_GEOM", None)

    s_host, r_host = run("0")
    s_dev, r_dev = run("1")
    for a, b in zip(s_host, s_dev):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(r_host, r_dev):
        np.testing.assert_array_equal(a, b)
