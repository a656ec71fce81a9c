"""Bit-for-bit parity of the exact engine against the reference C++ core.

Fixtures in tests/golden/ were produced by tools/golden/oracle.cpp driving the
*reference* implementation.  Every comparison here is exact f64 equality —
the exact backend is the oracle the device backend is then validated against.
"""

import numpy as np
import pytest

from poreseq_tpu.core.regions import MutationInfo
from poreseq_tpu.engine.driver import find_point_mutations, make_mutations
from poreseq_tpu.engine.types import AlignData

from golden_util import load_fixture, session_from_fixture


def _events_match(d, data):
    for i, ev in enumerate(data.events):
        np.testing.assert_array_equal(
            ev.ref_align, d[f"out_ev{i}_ref_align"], err_msg=f"ref_align ev{i}"
        )
        np.testing.assert_array_equal(
            ev.ref_like, d[f"out_ev{i}_ref_like"], err_msg=f"ref_like ev{i}"
        )


@pytest.mark.parametrize("name", ["score_events_a.npz", "score_events_b.npz"])
def test_score_events_parity(name):
    d = load_fixture(name)
    pa = session_from_fixture(d)
    data = AlignData.from_session(pa)
    likes = np.zeros(len(pa.sequence))
    scores = pa.engine.score_alignments(data, likes=likes)
    np.testing.assert_array_equal(np.asarray(scores), d["out_scores"])
    np.testing.assert_array_equal(likes, d["out_likes"])
    _events_match(d, data)


@pytest.mark.parametrize("name", ["score_muts_a.npz", "score_muts_b.npz"])
def test_score_mutations_parity(name):
    d = load_fixture(name)
    pa = session_from_fixture(d)
    data = AlignData.from_session(pa)
    muts = []
    for s, o, m in zip(d["mut_starts"], d["mut_origs"], d["mut_muts"]):
        mi = MutationInfo()
        mi.start, mi.orig, mi.mut = int(s), str(o), str(m)
        muts.append(mi)
    scores = pa.engine.score_mutations(data, muts)
    np.testing.assert_array_equal(
        np.array([ms.score for ms in scores]), d["out_scores"]
    )
    _events_match(d, data)


def test_viterbi_parity():
    from poreseq_tpu.engine.exact._native import LIB

    d = load_fixture("viterbi_a.npz")
    pa = session_from_fixture(d)
    data = AlignData.from_session(pa)
    LIB.psq_srand(1)  # oracle process starts with glibc's default seed 1
    seqs = pa.engine.viterbi_mutate(data.events, int(d["nkeep"]), 0.05, 0.01, 0.33, 0.75)
    expected = [str(s) for s in d["out_seqs"]]
    assert seqs == expected


@pytest.mark.parametrize("name", ["swfull_a.npz", "swfull_b.npz"])
def test_swfull_parity(name):
    from poreseq_tpu.engine.exact.sw import swfull

    d = load_fixture(name)
    acc, pairs, score = swfull(str(d["seq1"]), str(d["seq2"]))
    assert acc == float(d["out_acc"])
    assert score == int(d["out_score"])
    np.testing.assert_array_equal(pairs[:, 0], d["out_i1"])
    np.testing.assert_array_equal(pairs[:, 1], d["out_i2"])


def test_mutate_rounds_parity():
    from poreseq_tpu.engine.driver import find_mutations

    d = load_fixture("mutate_a.npz")
    pa = session_from_fixture(d)
    data = AlignData.from_session(pa)
    seqs = [ev.sequence for ev in pa.events[::2]]
    totbases = 0
    for _ in range(int(d["reps"])):
        muts = find_mutations(pa.engine, data, seqs)
        scores = pa.engine.score_mutations(data, muts)
        nb = make_mutations(pa.engine, data, scores)
        if nb == 0:
            break
        totbases += nb
    assert data.sequence == str(d["out_seq"])
    assert totbases == int(d["out_nbases"])
    _events_match(d, data)


def test_refine_parity():
    d = load_fixture("refine_a.npz")
    pa = session_from_fixture(d)
    data = AlignData.from_session(pa)
    data.params.scoring_width = int(d["point_width"])
    muts = find_point_mutations(data)
    scores = pa.engine.score_mutations(data, muts)
    np.testing.assert_array_equal(
        np.array([ms.score for ms in scores]), d["out_scores"]
    )
    nb = make_mutations(pa.engine, data, scores)
    assert data.sequence == str(d["out_seq"])
    assert nb == int(d["out_nbases"])
