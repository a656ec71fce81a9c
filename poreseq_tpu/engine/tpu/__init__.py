"""Device engine backend (`--backend tpu`; runs on whatever accelerator JAX
selects, the GPU in production): batched JAX/XLA banded DP, device
backtrace, batched mutation delta-scoring.  Control flow (FindMutations /
MakeMutations) is shared with the exact backend via engine/driver.py.

All entry points run through the MULTI-REGION path: events of R regions
(different sequences, different lengths) share one device batch, one fill
program and one mutation-scoring kernel call — single-region calls are the
R=1 case.  This replaces the reference's file-split region parallelism
(split_fasta.py): the fill is a column scan whose per-column cost is
dominated by fixed per-step work at small event batches, so batching regions
into one program shares that cost.
"""

from __future__ import annotations

import sys

import numpy as np

import jax
import jax.numpy as jnp

from ...core.sequence import seq_to_states
from ..types import AlignData
from ..exact.sw import map_alignments as _map_alignments
from .align import FUSED
from .pack import (event_ref_indexes, fill_geometry, pack_events,
                   place_full, round_up, to_device_batch)


def _mesh_from_env():
    """Resolve the engine mesh from PSQ_MESH: unset/'' -> single device;
    'auto' -> all devices on the 'ev' axis; 'AxB' -> (ev=A, mut=B).
    Falls back to single-device when too few devices are attached."""
    import os

    spec = os.environ.get("PSQ_MESH", "").strip().lower()
    if not spec or spec in ("0", "none", "off"):
        return None
    from ...parallel.mesh import make_mesh

    n = len(jax.devices())
    if spec == "auto":
        return make_mesh(n_ev=n, n_mut=1) if n > 1 else None
    a, _, b = spec.partition("x")
    n_ev, n_mut = int(a), int(b or 1)
    if n_ev * n_mut > n:
        import sys

        sys.stderr.write(
            "PSQ_MESH={} needs {} devices, have {}; running single-device\n"
            .format(spec, n_ev * n_mut, n))
        return None
    return make_mesh(n_ev=n_ev, n_mut=n_mut)


class TpuEngine:
    """Drop-in engine with the same primitive surface as ExactEngine, plus
    *_multi entry points batching several regions into one device program.

    dtype: jnp.float32 (default, the production path); float64 checks the
    device programs against the exact oracle with tight tolerances.

    mesh: optional jax.sharding.Mesh with ('ev', 'mut') axes — fills shard
    events over 'ev' (same fill as single-device, run per shard under
    shard_map) and the mutation kernel shards events x groups with a
    psum over 'ev'; outputs are bitwise independent of the mesh shape up to
    f32 reduction order.  Defaults from the PSQ_MESH env var (CLI --mesh)."""

    name = "tpu"

    #: event-row budget per candidate-scoring fill (engine/multi.py chunks
    #: (region, candidate) snapshots up to this many rows per dispatch; one
    #: 1 kb / width-300 fill holds ~6 MB of lattices per row, so 512 rows
    #: bound a dispatch's lattices to ~3 GB of device memory)
    wave_rows = int(__import__("os").environ.get("PSQ_WAVE_ROWS", 512))

    def __init__(self, dtype=None, mesh=None):
        from ...jaxcache import enable_compilation_cache

        enable_compilation_cache()
        self.dtype = dtype or jnp.float32
        self.mesh = mesh if mesh is not None else _mesh_from_env()
        # small device-batch cache: event level/model data is constant across
        # engine calls (only ref_align changes, which lives host-side), so
        # the ~35 MB batch upload happens once per region set
        self._bcache: dict = {}
        self._bcache_order: list = []
        # deferred ref_like reads: id(ev) -> (ev, device rlk [E, T], row).
        # ref_like is write-only inside the consensus loop (likes come from
        # the device), so the [E, T] read happens once per sync point instead
        # of once per fill
        self._rlk_pending: dict = {}

    # ---------------- packing / cache ----------------

    @staticmethod
    def _fingerprint(events):
        # prob_* must participate: train iterations vary only the transition
        # probabilities (Params.py:31-57) while levels stay identical, and the
        # lik_* arrays live in the cached device batch
        return (len(events),) + tuple(
            (len(ev.mean),
             float(ev.mean[0]) if len(ev.mean) else 0.0,
             float(ev.model.level_mean[0]),
             float(ev.model.prob_skip), float(ev.model.prob_stay),
             float(ev.model.prob_extend), float(ev.model.prob_insert))
            for ev in events)

    def _batch_for(self, events, ref_indexes):
        """Packed arrays + device batch for an event list, cached by content
        fingerprint; `active` refreshed from the given ref_indexes."""
        fp = self._fingerprint(events)
        hit = self._bcache.get(fp)
        if hit is not None:
            batch, arrays = hit
            E_pad = len(arrays["n0"])
            ref_indexes = list(ref_indexes)
            ref_indexes += [np.zeros(0)] * (E_pad - len(ref_indexes))
            active = np.array([len(r) > 0 for r in ref_indexes])
            if not np.array_equal(active, arrays["active"]):
                arrays = dict(arrays, active=active)
                batch = batch._replace(active=jnp.asarray(active))
                self._bcache[fp] = (batch, arrays)
        else:
            e_div = self.mesh.shape["ev"] if self.mesh is not None else 1
            arrays, ref_indexes = pack_events(events, e_div=e_div)
            batch = to_device_batch(arrays, self.dtype)
            self._bcache[fp] = (batch, arrays)
            self._bcache_order.append(fp)
            if len(self._bcache_order) > 4:
                self._bcache.pop(self._bcache_order.pop(0), None)
        return batch, arrays, ref_indexes

    def _prepare_multi(self, datas: list[AlignData], participate=None):
        """Combined context for R regions: one packed batch, per-event states
        [C, E], per-event sequence lengths, region ids, padding mask.  Each
        region's events occupy contiguous rows, in region order."""
        events = [ev for d in datas for ev in d.events]
        ref_indexes = [event_ref_indexes(ev) for ev in events]
        batch, arrays, ref_indexes = self._batch_for(events, ref_indexes)
        n0 = arrays["n0"]
        E = len(n0)

        ev_region = np.full(E, -1, dtype=np.int32)
        ev_region[: len(events)] = np.repeat(
            np.arange(len(datas), dtype=np.int32),
            [len(d.events) for d in datas])

        states_list = [seq_to_states(d.sequence) for d in datas]
        S_list = [len(s) for s in states_list]
        # keep at least one dead (all-zero) padding column past each S: the
        # mutation kernel indexes it for rab=0 (no-suffix) joins
        C = round_up(max(S_list) + 8, 64)
        S_e = np.zeros(E, dtype=np.int64)
        states2 = np.full((C, E), -1, dtype=np.int32)
        for e in range(E):
            r = ev_region[e]
            if r >= 0:
                S_e[e] = S_list[r]
                states2[: S_list[r], e] = states_list[r]

        if participate is not None:
            mask = np.array([participate[r] if r >= 0 else False
                             for r in ev_region])
            active = arrays["active"] & mask
            arrays = dict(arrays, active=active)
            batch = batch._replace(active=jnp.asarray(active))

        return dict(batch=batch, arrays=arrays, ref_indexes=ref_indexes,
                    n0=n0, E=E, ev_region=ev_region, S_list=S_list,
                    S_e=S_e, C=C, states2=states2)

    # ---------------- deferred ref_like ----------------

    def _defer_rlk(self, ev, rlk_dev, row: int):
        self._rlk_pending[id(ev)] = (ev, rlk_dev, row)
        # bound the HBM pinned by pending fills: API paths without a sync
        # point (variant's per-sequence ScoreEvents, direct Score* calls)
        # would otherwise pin one [E, T] device buffer per call forever.
        # Flushing early is always safe — it only reads sooner.
        if len({id(dev) for _, dev, _ in self._rlk_pending.values()}) > 4:
            self.flush_ref_likes()

    def flush_ref_likes(self):
        """Materialize pending ref_like rows (one D2H read per distinct fill
        output still holding a final value).  Called at sync points (before
        AlignData.sync_back); superseded fills are never read."""
        by_arr: dict = {}
        for ev, dev, row in self._rlk_pending.values():
            by_arr.setdefault(id(dev), (dev, []))[1].append((ev, row))
        for dev, items in by_arr.values():
            h = np.asarray(dev, dtype=np.float64)
            for ev, row in items:
                ev.ref_like = place_full(ev, h[row])
        self._rlk_pending.clear()

    @staticmethod
    def _likes_slice(vals_row, S_r: int, n_bases: int) -> np.ndarray:
        """Host tail of likes_contribution: place the device-selected values
        (vals[k] = score of last aligned level at/before ref index k+1) into
        the per-base likes layout."""
        out = np.zeros(n_bases, dtype=np.float64)
        lim = min(S_r + 3, n_bases - 1)
        if lim >= 2:
            out[2 : lim + 1] = vals_row[: lim - 1]
        return out

    # ---------------- engine primitives ----------------

    def score_alignments(self, data: AlignData, likes=None):
        return self.score_alignments_multi([data], [likes])[0]

    def score_alignments_multi(self, datas: list[AlignData], likes_list=None,
                               participate=None, likes_only=False,
                               defer=False):
        """ScoreAlignments for R regions in one fused fill+backtrace call:
        realign all events (updating them in place), return per-region score
        lists, optionally accumulate per-region per-base likes (computed on
        device — see align.device_likes).

        participate: optional [R] bools — regions marked False are skipped
        (their events are neither scored nor updated).

        likes_only: the candidate-scoring mode — events are NOT updated and
        nothing [E, T]-sized is read back from the device; only per-event
        scores and the [E, C] likes values cross the boundary.

        defer: return a zero-arg finish() closure instead of the result —
        the device program is DISPATCHED but no D2H read happens until
        finish() runs.  Callers with several independent calls (the
        candidate-chunk loop) dispatch them all first so chunk N+1's host
        prep + H2D overlaps chunk N's device time; each blocking read
        otherwise serializes host and device work."""
        if likes_list is None:
            likes_list = [None] * len(datas)
        if participate is None:
            participate = [True] * len(datas)
        ctx = self._prepare_multi(datas, participate=participate)
        arrays, n0 = ctx["arrays"], ctx["n0"]
        p = datas[0].params
        fi = fill_geometry(arrays, ctx["ref_indexes"], ctx["S_e"], ctx["C"],
                           p.realign_width)
        T = arrays["mean"].shape[1]
        max_steps = int(ctx["C"] + 2 * T + 8)
        n_like = int(ctx["C"])
        fused_args = (
            ctx["batch"], jnp.asarray(ctx["states2"]), jnp.asarray(fi["i0"]),
            jnp.asarray(fi["i1"]), jnp.asarray(fi["is_pad"]),
            float(p.lik_offset))
        ral = rlk_dev = None
        if likes_only:
            if self.mesh is not None:
                fused = FUSED.fwd_likes_sharded(p.realign_width, self.dtype,
                                                self.mesh, T, max_steps,
                                                n_like)
                best, vals = fused(*fused_args)
            else:
                fused = FUSED.fwd_likes(p.realign_width, self.dtype)
                best, vals = fused(*fused_args, t_pad=T, max_steps=max_steps,
                                   n_like=n_like)
        elif self.mesh is not None:
            fused = FUSED.fwd_dev_sharded(p.realign_width, self.dtype,
                                          self.mesh, T, max_steps, n_like)
            best, ral, rlk_dev, vals = fused(*fused_args)
        else:
            fused = FUSED.fwd_dev(p.realign_width, self.dtype)
            best, ral, rlk_dev, vals = fused(*fused_args, t_pad=T,
                                             max_steps=max_steps,
                                             n_like=n_like)
        def finish(ral_dev=ral):
            ral_h = (np.asarray(ral_dev, dtype=np.float64)
                     if ral_dev is not None else None)
            best_h = np.asarray(best, dtype=np.float64)
            any_likes = any(l is not None for l in likes_list)
            vals_h = np.asarray(vals, dtype=np.float64) if any_likes else None

            out = []
            e = 0
            for r, data in enumerate(datas):
                if not participate[r]:
                    e += len(data.events)
                    out.append(None)
                    continue
                scores = []
                S_r = ctx["S_list"][r]
                n_bases = len(data.sequence)
                for ev in data.events:
                    if ral_h is not None and arrays["active"][e]:
                        ev.ref_align = place_full(ev, ral_h[e])
                        self._defer_rlk(ev, rlk_dev, e)
                    scores.append(float(best_h[e]))
                    if likes_list[r] is not None:
                        likes_list[r] += self._likes_slice(vals_h[e], S_r,
                                                           n_bases)
                    e += 1
                out.append(scores)
            return out

        return finish if defer else finish()

    def map_alignments(self, data: AlignData, newseq: str):
        # host-side SW remap (same numerics as the exact engine)
        return _map_alignments(data, newseq)

    def score_mutations(self, data: AlignData, muts):
        return self.score_mutations_multi([data], [muts])[0]

    def score_mutations_multi(self, datas, muts_list):
        from .mutscore import score_mutations_multi

        p = datas[0].params
        if p.verbose:
            sys.stderr.write("Scoring[tpu] ({})".format(p.scoring_width))
        out = score_mutations_multi(self, datas, muts_list)
        if p.verbose:
            sys.stderr.write("\n")
        return out

    def viterbi_mutate(self, events, nkeep, skip_prob, stay_prob, mut_min,
                       mut_max, verbose=False):
        from .viterbi import viterbi_mutate_tpu

        return viterbi_mutate_tpu(events, nkeep, skip_prob, stay_prob,
                                  mut_min, mut_max, verbose)

    def viterbi_mutate_multi(self, events_lists, nkeep, skip_prob, stay_prob,
                             mut_min, mut_max, verbose=False):
        """ViterbiMutate for R regions in one device round-trip; per-region
        candidates equal the solo viterbi_mutate outputs (engine/tpu/
        viterbi.py:viterbi_mutate_tpu_multi)."""
        from .viterbi import viterbi_mutate_tpu_multi

        return viterbi_mutate_tpu_multi(events_lists, nkeep, skip_prob,
                                        stay_prob, mut_min, mut_max, verbose)

    @staticmethod
    def swalign(seq1: str, seq2: str):
        from ..exact.sw import swalign

        return swalign(seq1, seq2)
