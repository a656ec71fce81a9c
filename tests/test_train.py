"""Training paths: the device lockstep candidate batch must reproduce the
reference's pool-of-sequential-consensus semantics (cmdline.py:235-267) —
each parameter candidate's result equals running mutate() on it alone."""

import os

import numpy as np
import pytest

from poreseq_tpu.pipeline import mutate, train_candidates
from poreseq_tpu.sim import write_run


BASE = dict(
    realign_width=48, scoring_width=24, point_width=12,
    min_coverage=0, max_coverage=30, min_overlap=50,
    max_length=10000, lik_offset=4.5,
)


def _candidates():
    """Deterministic stand-ins for vary_params proposals (Params.py:50-57):
    strand-suffixed probability perturbations only."""
    cands = []
    for f in (1.0, 0.6):
        p = dict(BASE)
        p["skip_t"] = 0.1 * f
        p["stay_c"] = 0.05 * f
        p["insert_t"] = 0.03 * f
        cands.append(p)
    return cands


@pytest.mark.slow
def test_train_candidates_lockstep_matches_sequential(tmp_path):
    d = str(tmp_path)
    rng = np.random.default_rng(123)
    truth, draft, reads_dir, bam, fasta = write_run(
        d, rng, ref_len=250, n_reads=6, draft_error=0.0)
    cands = _candidates()

    seq_results = [
        mutate(fasta, bam, reads_dir, params=p, test=True, reps=1,
               backend="tpu")
        for p in cands
    ]
    lock_results = train_candidates(fasta, bam, reads_dir, None, cands,
                                    reps=1, backend="tpu", verbose=0)

    assert len(lock_results) == len(cands)
    for (seq_s, acc_s), (seq_l, acc_l) in zip(seq_results, lock_results):
        assert seq_l == seq_s
        assert abs(acc_l - acc_s) < 1e-9


def test_cli_train_tpu(tmp_path, monkeypatch, capsys):
    """`poreseq train --backend tpu` runs one lockstep iteration and writes
    train_best.conf (cmdline.py:263-265)."""
    from poreseq_tpu import cli
    from poreseq_tpu.core.params import load_params

    d = str(tmp_path)
    rng = np.random.default_rng(5)
    truth, draft, reads_dir, bam, fasta = write_run(
        d, rng, ref_len=200, n_reads=6, draft_error=0.0)
    conf = os.path.join(d, "params.conf")
    with open(conf, "w") as f:
        for k, v in dict(BASE, skip_t=0.1, stay_c=0.05).items():
            f.write(f"{k} = {v}\n")

    # keep the CLI test cheap: 2 candidates, 1 rep (the full-fat numerics are
    # covered by test_train_candidates_lockstep_matches_sequential)
    import poreseq_tpu.pipeline as pipeline

    real_tc = pipeline.train_candidates
    monkeypatch.setattr(
        pipeline, "train_candidates",
        lambda *a, **kw: real_tc(*a, **{**kw, "reps": 1}))
    monkeypatch.setattr(
        cli, "vary_params",
        lambda p: [dict(p), dict(p, skip_t=p.get("skip_t", 0.1) * 1.1)])

    monkeypatch.chdir(d)
    cli.main(["train", fasta, bam, reads_dir, "-i", "1", "-p", conf,
              "--backend", "tpu"])
    best = load_params(os.path.join(d, "train_best.conf"))
    assert "skip_t" in best and best["skip_t"] > 0
