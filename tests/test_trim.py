"""Event trimming (band-reachable level range) + first-column band anchoring.

Reads overhanging a short region carry levels no band can reach; the device
pack slices them (Event.trim, set at load).  Checks:
  * the device engine matches the exact oracle on an overhang scenario in f64
    (this also exercises the first-column window anchor — without it the
    band spends hundreds of columns catching up from level 0);
  * trim on/off produce identical f64 results (exact equivalence of the
    slice).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from poreseq_tpu.core.regions import RegionInfo
from poreseq_tpu.engine.exact import ExactEngine
from poreseq_tpu.engine.types import AlignData
from poreseq_tpu.io.load import load_aligned_events
from poreseq_tpu.sim import write_run


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("trimrun")
    rng = np.random.default_rng(5)
    write_run(str(d), rng, ref_len=3000, n_reads=4, draft_error=0.03)
    return str(d)


PARAMS = dict(realign_width=48, scoring_width=24, point_width=12,
              min_overlap=50, min_coverage=0, max_coverage=30,
              max_length=10000, lik_offset=4.5, verbose=0)


def _load(run_dir, trim: bool):
    os.environ["PSQ_TRIM_EVENTS"] = "1" if trim else "0"
    try:
        pa = load_aligned_events(
            os.path.join(run_dir, "ref.fasta"),
            os.path.join(run_dir, "reads.bam"),
            os.path.join(run_dir, "reads"),
            RegionInfo("synthref:1200:1600"), dict(PARAMS), backend="exact")
    finally:
        os.environ.pop("PSQ_TRIM_EVENTS", None)
    return pa


def test_trim_hint_set_on_overhang(run_dir):
    pa = _load(run_dir, trim=True)
    trims = [ev.trim for ev in pa.events if ev.trim is not None]
    assert trims, "overhanging reads should carry a trim hint"
    for ev in pa.events:
        if ev.trim:
            lo, hi = ev.trim
            assert 0 <= lo < hi <= len(ev.mean)
            assert hi - lo < len(ev.mean)


def test_trim_overhang_matches_exact_f64(x64, run_dir):
    from poreseq_tpu.engine.tpu import TpuEngine

    pa_e = _load(run_dir, trim=True)
    pa_t = _load(run_dir, trim=True)
    dE = AlignData.from_session(pa_e)
    dT = AlignData.from_session(pa_t)
    lE = np.zeros(len(pa_e.sequence))
    lT = np.zeros(len(pa_t.sequence))
    sE = ExactEngine().score_alignments(dE, likes=lE)
    eng = TpuEngine(dtype=jnp.float64)
    sT = eng.score_alignments(dT, likes=lT)
    eng.flush_ref_likes()
    np.testing.assert_allclose(sE, sT, rtol=0, atol=1e-8)
    np.testing.assert_allclose(lE, lT, rtol=0, atol=1e-7)
    for evE, evT in zip(dE.events, dT.events):
        np.testing.assert_array_equal(evE.ref_align, evT.ref_align)


def test_trim_on_off_identical_f64(x64, run_dir):
    from poreseq_tpu.engine.tpu import TpuEngine

    outs = []
    for trim in (True, False):
        pa = _load(run_dir, trim=trim)
        d = AlignData.from_session(pa)
        likes = np.zeros(len(pa.sequence))
        eng = TpuEngine(dtype=jnp.float64)
        s = eng.score_alignments(d, likes=likes)
        eng.flush_ref_likes()
        outs.append((s, likes, [ev.ref_align.copy() for ev in d.events],
                     [ev.ref_like.copy() for ev in d.events]))
    (s1, l1, ra1, rl1), (s0, l0, ra0, rl0) = outs
    np.testing.assert_allclose(s1, s0, rtol=0, atol=1e-9)
    np.testing.assert_allclose(l1, l0, rtol=0, atol=1e-8)
    for a, b in zip(ra1, ra0):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(rl1, rl0):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)
