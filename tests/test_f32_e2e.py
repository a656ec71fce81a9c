"""f32 whole-pipeline DECISION equivalence: the device backend (f32, the dtype
used on hardware) must reproduce the exact backend's consensus sequence at
every phase of the pipeline when both see the same candidate proposals.

The viterbi candidate generators intentionally differ in RNG (JAX counted
PRNG vs glibc rand(), PARITY.md) — candidates only seed proposals — so this
sweep feeds BOTH engines the exact engine's candidates and asserts the
propose-score-accept *decisions* (and hence the sequences) match end to end:
phase 1 ('self' 2D-read candidates), a shared-candidate Mutate round, and
Refine (all 9/base point mutations).  Reference anchor: the acceptance path
whose deltas decide mutations, /root/reference/cpp/Alignment.cpp:447-512 and
MakeMutations.cpp:74-146.

Divergences, if any, must be bounded (equal-accuracy consensus) and are
surfaced as xfail so the rate is visible, not silently tolerated.
"""

import numpy as np
import pytest

from poreseq_tpu.api import swalign
from poreseq_tpu.engine.exact import ExactEngine
from poreseq_tpu.engine.types import AlignData
from poreseq_tpu.sim import simulate_session

# moderate widths so the sweep is runnable on the CPU test box; the same
# sweep at production widths runs on hardware via scripts/f32_equiv.py and is
# reported in PARITY.md
PARAMS = dict(realign_width=48, scoring_width=24, point_width=12, verbose=0)

CASES = [
    (101, 200, 6, 0.03),
    (202, 260, 8, 0.05),
    (303, 320, 6, 0.02),
    (404, 200, 10, 0.04),
    (505, 240, 4, 0.03),
    (606, 280, 8, 0.06),
    (707, 220, 6, 0.00),
    (808, 300, 6, 0.04),
    (909, 180, 12, 0.05),
    (111, 260, 6, 0.03),
]


@pytest.mark.slow
@pytest.mark.parametrize("seed,ref_len,coverage,draft_error", CASES)
def test_f32_consensus_decisions_match_exact(seed, ref_len, coverage,
                                             draft_error):
    def mk(backend):
        pa, truth = simulate_session(
            np.random.default_rng(seed), ref_len=ref_len, coverage=coverage,
            draft_error=draft_error, backend=backend, params=dict(PARAMS))
        return pa, truth

    pT, truth = mk("tpu")
    pE, _ = mk("exact")

    def check(phase):
        if pT.sequence != pE.sequence:
            aT = swalign(pT.sequence, truth)[0]
            aE = swalign(pE.sequence, truth)[0]
            assert abs(aT - aE) < 0.5 and aT >= 99.0, (
                f"f32 diverged AND degraded at {phase}: "
                f"tpu {aT:.2f}% vs exact {aE:.2f}%")
            pytest.xfail(f"bounded f32 divergence at {phase} "
                         f"(tpu {aT:.2f}% / exact {aE:.2f}% vs truth)")

    pT.Mutate(reps=2)
    pE.Mutate(reps=2)
    check("phase1-self")

    # shared candidates: generated ONCE by the exact engine from the (equal)
    # post-phase-1 state, fed to both engines
    cands = ExactEngine().viterbi_mutate(
        AlignData.from_session(pE).events, 16, 0.05, 0.01, 0.33, 0.75)
    pT.Mutate(seqs=list(cands), reps=2)
    pE.Mutate(seqs=list(cands), reps=2)
    check("viterbi-candidates")

    pT.Refine()
    pE.Refine()
    check("refine")
