"""Lockstep multi-region drivers: R regions' propose-score-accept rounds run
in step so every device dispatch batches all regions' events.

This is the device-engine answer to the reference's region-level parallelism
(files split across a cluster, /root/reference/poreseq/split_fasta.py,
README.md:48-62): instead of one process per region, one device program per
*round* serves R regions at once.  The per-region results are EXACTLY those
of running the sequential driver per region (same engine numerics, same host
control flow per region; regions that finish early are masked out of later
rounds, not recomputed) — verified by tests/test_multiregion.py.

Control-flow parity notes (vs api.PSAlign.Mutate / engine/driver.py):
  * find_mutations scores the consensus once, then each candidate sequence
    independently against a snapshot of the realigned events — candidate
    order does not affect results, so candidates are scored in rank WAVES
    (wave k = every region's k-th candidate) to batch across regions;
  * make_mutations (greedy accept) is inherently sequential *per region* and
    cheap — it stays host-side per region; the recursive re-score of >10
    deferred conflicts is batched across regions per recursion level
    (make_mutations_multi);
  * a region leaves its Mutate loop when a round accepts 0 bases, exactly as
    the sequential loop breaks.
"""

from __future__ import annotations

import sys

import numpy as np

from .driver import (candidate_dlikes, extract_mutations,
                     find_point_mutations, greedy_accept)
from .types import AlignData


def make_mutations_multi(engine, datas, scores_list, live=None):
    """MakeMutations for R regions: the greedy accept runs host-side per
    region (inherently sequential there, MakeMutations.cpp:74-139), but the
    recursive re-score of >10 deferred conflicts (:142-143) — one full
    ScoreMutations per region per recursion level in the sequential driver —
    is batched across regions into one engine call per level.  Per-region
    results are exactly the sequential driver's (scoring one region is
    independent of its batch neighbors)."""
    R = len(datas)
    if live is None:
        live = [True] * R
    nbases = [0] * R
    pending = {r: scores_list[r] for r in range(R) if live[r]}
    while pending:
        extras = {}
        for r, muts in pending.items():
            nb, mutextra = greedy_accept(datas[r], muts)
            nbases[r] += nb
            if len(mutextra) > 10:
                extras[r] = mutextra
        if not extras:
            break
        muts_list = [extras.get(r, []) for r in range(R)]
        scored = engine.score_mutations_multi(datas, muts_list)
        pending = {r: scored[r] for r in extras}
    return nbases


def find_mutations_multi(engine, datas, seqs_list, live=None):
    """FindMutations for R regions, batching device calls across regions.
    Regions with live[r] False (or no candidates) get [] and are untouched.

    Candidate sequences are scored in CHUNKS bounded by an event-row budget
    (engine.wave_rows, default 1024 — the HBM envelope of one fill at 1 kb /
    width 300): every chunk is one fused fill+backtrace dispatch covering
    many (region, candidate) snapshots at once.  Per-candidate numerics are
    identical to sequential scoring — each event row is independent in the
    batched fill — so results match the rank-wave and sequential drivers."""
    R = len(datas)
    if live is None:
        live = [True] * R
    live = [bool(live[r]) and len(seqs_list[r]) > 0 for r in range(R)]
    if not any(live):
        return [[] for _ in range(R)]

    seqreflikes = [np.zeros(len(d.sequence), dtype=np.float64) for d in datas]
    engine.score_alignments_multi(datas, likes_list=seqreflikes,
                                  participate=live)

    verbose = datas[0].params.verbose
    if verbose:
        sys.stderr.write("Finding mutations")

    # snapshot + host SW remap per (region, candidate); dedupe repeats of the
    # same candidate within a region (the per-region seqlikes cache serves
    # later occurrences, like the sequential loop's wave ordering did).
    # The SW alignments are independent per (region, candidate) and the C
    # core releases the GIL (ctypes), so they run on a thread pool — swfull
    # was ~4 s of host-blocked time per steady batch-8 run (PERF.md) executed
    # serially between device dispatches.
    from .exact.sw import fillinds, swfull
    from .host import host_pool

    jobs = []                         # (r, k, seq, fresh)
    seen = set()
    for r in range(R):
        if not live[r]:
            continue
        for k, seq in enumerate(seqs_list[r]):
            fresh = (datas[r].seqlikes.get(seq) is None
                     and (r, seq) not in seen)
            if fresh:
                seen.add((r, seq))
            jobs.append((r, k, seq, fresh))

    def run_job(job):
        r, k, seq, fresh = job
        if fresh:
            # snapshot + remap events onto the candidate for its fill
            newdata = AlignData(
                sequence=datas[r].sequence,
                events=[ev.light_copy() for ev in datas[r].events],
                params=datas[r].params,
            )
            _, pairs = engine.map_alignments(newdata, seq)
            return (r, k, seq, pairs, newdata)
        # cached likes: only the SW pair map is needed (same pairs
        # map_alignments would return; no event copies/remap)
        _, p0, _ = swfull(datas[r].sequence, seq)
        return (r, k, seq, fillinds(p0), None)

    done_jobs = list(host_pool().map(run_job, jobs))
    tasks = [(r, k, seq, pairs) for (r, k, seq, pairs, _) in done_jobs]
    todo = [(r, seq, nd) for (r, _, seq, _, nd) in done_jobs
            if nd is not None]

    # row budget scales inversely with the sequence column count — the
    # fill's HBM footprint is ~C*W*10 bytes per event row, and a chunk's C
    # comes from its longest CANDIDATE sequence (read basecalls run well past
    # the region length).  Shape-aware packing: candidates sorted by C so
    # each chunk's budget reflects ITS longest member (short candidates don't
    # pay the global bucket), which also groups same-shape candidates into
    # the same compile bucket.  Results are order-independent (each candidate
    # scores against its own snapshot; likes are keyed by (region, seq)).
    wave_rows = int(getattr(engine, "wave_rows", 1024))
    chunks = []
    cur, cur_rows, cur_budget = [], 0, 0
    for item in sorted(todo, key=lambda it: -len(it[2].sequence)):
        rows = len(item[2].events)
        if cur and cur_rows + rows > cur_budget:
            chunks.append(cur)
            cur, cur_rows = [], 0
        if not cur:
            C_chunk = max(len(item[2].sequence), 1024)
            cur_budget = max(wave_rows * 1024 // C_chunk, rows)
        cur.append(item)
        cur_rows += rows
    if cur:
        chunks.append(cur)
    # dispatch every chunk's fill BEFORE reading any chunk's result: the
    # blocking likes read of chunk N otherwise serializes with chunk N+1's
    # host packing + H2D upload (defer=True returns a finish() closure that
    # performs the reads; see TpuEngine.score_alignments_multi)
    pending = []
    for chunk in chunks:
        likes_list = [np.zeros(len(seq), dtype=np.float64)
                      for _, seq, _ in chunk]
        # likes_only: the snapshots are discarded after their likes are read,
        # so no [E, T] realignment output ever crosses the device boundary
        fin = engine.score_alignments_multi([nd for _, _, nd in chunk],
                                            likes_list=likes_list,
                                            likes_only=True, defer=True)
        pending.append((chunk, likes_list, fin))
    for chunk, likes_list, fin in pending:
        fin()
        for (r, seq, _), likes in zip(chunk, likes_list):
            datas[r].seqlikes[seq] = likes
        if verbose:
            sys.stderr.write("." * len(chunk))
            sys.stderr.flush()
    if verbose:
        sys.stderr.write("\n")

    alllikes = [[] for _ in range(R)]
    seqals = [[] for _ in range(R)]
    for (r, k, seq, pairs) in tasks:
        dl, als = candidate_dlikes(seqreflikes[r], datas[r].seqlikes[seq],
                                   pairs)
        alllikes[r].append(dl)
        seqals[r].append(als)

    return [extract_mutations(datas[r].sequence, seqs_list[r], alllikes[r],
                              seqals[r]) if live[r] else []
            for r in range(R)]


def mutate_datas(engine, datas, seqs_list, reps, live=None):
    """The PSAlign.Mutate rep loop (pyx:425-431) in lockstep: per rep, one
    batched find + one batched score across all still-live regions, then the
    sequential greedy accept per region.  Returns total accepted bases [R]."""
    R = len(datas)
    live = list(live) if live is not None else [True] * R
    totbases = [0] * R
    for _ in range(reps):
        if not any(live):
            break
        muts_list = find_mutations_multi(engine, datas, seqs_list, live=live)
        scores_list = engine.score_mutations_multi(datas, muts_list)
        nbases = make_mutations_multi(engine, datas, scores_list, live=live)
        for r in range(R):
            if not live[r]:
                continue
            if nbases[r] == 0:
                live[r] = False
            totbases[r] += nbases[r]
    return totbases


def refine_datas(engine, datas, live=None, point_width=None):
    """PSAlign.Refine (pyx:437-472) in lockstep: all regions' point mutations
    scored in one batched call; greedy accept per region.  Returns nbases [R]."""
    R = len(datas)
    if live is None:
        live = [True] * R
    if point_width is not None:
        for d in datas:
            d.params.scoring_width = int(point_width)
    muts_list = [find_point_mutations(datas[r]) if live[r] else []
                 for r in range(R)]
    scores_list = engine.score_mutations_multi(datas, muts_list)
    return make_mutations_multi(engine, datas, scores_list, live=live)
