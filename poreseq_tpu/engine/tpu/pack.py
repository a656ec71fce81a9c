"""Host-side packing: AlignData -> padded EventBatch + band geometry.

Band placement follows Alignment.cpp:127-148: per column refind, the band is
centered on the event's interpolated alignment (getrefstate) with half-width
`width`, clamped to [1, n0].  (The curwid->5 shrink branch is retained for
faithfulness though unreachable: getrefstate returns values in [0, n0].)
"""

from __future__ import annotations

import numpy as np

from ...core.events import Event, update_refs
from .dp import EventBatch


def _pad_to(x: np.ndarray, n: int, fill=0.0):
    out = np.full(n, fill, dtype=np.float64)
    out[: len(x)] = x
    return out


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def trim_range(ev: Event) -> tuple[int, int]:
    """The event's packed level range: its trim hint (Event.trim) or the full
    event."""
    t = getattr(ev, "trim", None)
    return (int(t[0]), int(t[1])) if t else (0, len(ev.mean))


def event_ref_indexes(ev: Event) -> np.ndarray:
    """Interpolated ref_index in PACKED (trimmed) level coordinates — the
    band geometry input.  Trim keeps every alignment anchor, so the flank
    extrapolation matches slicing the full update_refs output."""
    lo, hi = trim_range(ev)
    return update_refs(ev.ref_align[lo:hi])[0]


def place_full(ev: Event, vals: np.ndarray) -> np.ndarray:
    """Expand a packed per-level row (length >= the trimmed count) back to
    the event's full level axis; trimmed-away levels read 0 (= unaligned,
    exactly what the full-band DP yields for them)."""
    lo, hi = trim_range(ev)
    if lo == 0 and hi == len(ev.mean):
        return np.asarray(vals[:hi], dtype=np.float64).copy()
    full = np.zeros(len(ev.mean), dtype=np.float64)
    full[lo:hi] = vals[: hi - lo]
    return full


def pack_events(events: list[Event], t_pad: int | None = None,
                e_pad: int | None = None, e_div: int = 1):
    """Build the EventBatch arrays (numpy; cast to device later) and return
    (batch_arrays dict, ref_indexes list).

    The event axis is padded to at least 64 rows: the fill is a scan whose
    per-column cost is launch-bound at small batch, so small batches share
    one compiled program and the inactive padding rows cost little."""
    E_real = len(events)
    # coarse event-axis buckets: 32-granular up to 128, then 128-granular —
    # every distinct E is a separate compiled program and candidate-chunk
    # batches (engine/multi.py) sweep large, varying row counts.  e_div: the
    # mesh 'ev' axis size (shard_map needs E divisible by it).
    E = e_pad or (max(round_up(E_real, 32), 64) if E_real <= 128
                  else round_up(E_real, 128))
    E = round_up(E, max(e_div, 1))
    trims = [trim_range(ev) for ev in events]
    n0 = np.ones(E, dtype=np.int32)
    for e, (lo, hi) in enumerate(trims):
        n0[e] = hi - lo
    T = t_pad or round_up(int(n0.max()), 256)

    mean = np.zeros((E, T))
    stdv = np.ones((E, T))
    lsd = np.zeros((E, T))
    lsr = np.zeros((E, T))
    active = np.zeros(E, dtype=bool)
    lev_mean = np.zeros((E, 1024))
    lev_stdv = np.ones((E, 1024))
    log_lev = np.zeros((E, 1024))
    sd_mean = np.ones((E, 1024))
    sd_lambda = np.ones((E, 1024))
    log_lambda = np.zeros((E, 1024))
    lik4 = np.zeros((E, 4))

    ref_indexes = [np.zeros(0, dtype=np.float64)] * E
    for e, ev in enumerate(events):
        n = n0[e]
        lo, hi = trims[e]
        mean[e, :n] = ev.mean[lo:hi]
        stdv[e, :n] = ev.stdv[lo:hi]
        lsd[e, :n] = np.log(ev.stdv[lo:hi])
        # forward inverse-Gaussian quirk input: the reference indexes
        # log_stdv[n0 - i] with the FULL event's n0 (Alignment.cpp:171-172),
        # so the packed row slices the reversed FULL array — values come from
        # the mirror-image end of the read, not the trimmed window reversed
        lsr[e, :n] = np.log(ev.stdv)[::-1][lo:hi]
        ri = event_ref_indexes(ev)
        ref_indexes[e] = ri
        active[e] = len(ri) > 0
        m = ev.model
        d = m.derived()
        lev_mean[e] = m.level_mean
        lev_stdv[e] = m.level_stdv
        log_lev[e] = d["log_lev"]
        sd_mean[e] = m.sd_mean
        sd_lambda[e] = d["sd_lambda"]
        log_lambda[e] = d["log_lambda"]
        lik4[e] = [d["lik_skip"], d["lik_stay"], d["lik_extend"], d["lik_insert"]]

    arrays = dict(
        mean=mean, stdv=stdv, lsd=lsd, lsr=lsr,
        n0=n0, active=active,
        lev_mean=lev_mean, lev_stdv=lev_stdv, log_lev=log_lev,
        sd_mean=sd_mean, sd_lambda=sd_lambda, log_lambda=log_lambda,
        lik_skip=lik4[:, 0], lik_stay=lik4[:, 1],
        lik_extend=lik4[:, 2], lik_insert=lik4[:, 3],
    )
    return arrays, ref_indexes


def to_device_batch(arrays: dict, dtype) -> EventBatch:
    import jax.numpy as jnp

    f = lambda x: jnp.asarray(x, dtype)
    return EventBatch(
        mean=f(arrays["mean"]), stdv=f(arrays["stdv"]),
        lsd=f(arrays["lsd"]), lsr=f(arrays["lsr"]),
        n0=jnp.asarray(arrays["n0"]),
        active=jnp.asarray(arrays["active"]),
        lev_mean=f(arrays["lev_mean"]), lev_stdv=f(arrays["lev_stdv"]),
        log_lev=f(arrays["log_lev"]), sd_mean=f(arrays["sd_mean"]),
        sd_lambda=f(arrays["sd_lambda"]), log_lambda=f(arrays["log_lambda"]),
        lik_skip=f(arrays["lik_skip"]), lik_stay=f(arrays["lik_stay"]),
        lik_extend=f(arrays["lik_extend"]), lik_insert=f(arrays["lik_insert"]),
    )


def fill_geometry(arrays: dict, ref_indexes, S, S_pad: int, width: int):
    """Geometry-only device inputs (i0/i1/is_pad): the engine path builds the
    data windows ON DEVICE (dp.device_window_inputs), so per-call H2D is just
    these int32 arrays.  S may be an int or per-event [E] array."""
    n0 = arrays["n0"]
    i0p, i1p = limited_geometry(ref_indexes, n0, S, S_pad, width)
    if np.isscalar(S):
        is_pad = np.zeros(S_pad, dtype=bool)
        is_pad[S:] = True
    else:
        is_pad = (np.arange(S_pad, dtype=np.int64)[:, None]
                  >= np.asarray(S, dtype=np.int64)[None, :])
    return dict(i0=i0p, i1=i1p, is_pad=is_pad)


def fill_inputs(arrays: dict, ref_indexes, S: int, S_pad: int, width: int):
    """Complete device inputs for BOTH fill directions.

    One rate-limited forward band geometry serves forward and backward: the
    reference's backward band mirrors to exactly the forward band in forward
    coordinates (see dp.py module doc).  The rate limit (band start advances
    by at most DMAX per column) turns all cross-column data movement into
    selects over static rolls instead of per-row gathers.  When the cap
    binds (needs >DMAX event levels mapped to one reference base) the band
    lags the reference's placement by a few columns and catches up; the
    half-width dwarfs the lag."""
    from .dp import DMAX

    n0 = arrays["n0"]
    E = len(n0)
    W = 2 * width + 1
    g = fill_geometry(arrays, ref_indexes, S, S_pad, width)
    i0p, i1p, is_pad = g["i0"], g["i1"], g["is_pad"]

    # emission data: mean/stdv windows are shared; the inverse-Gaussian log-x
    # input is the REVERSED log_stdv forward (the reference quirk,
    # Alignment.cpp:171-172) and the plain log_stdv backward (mean[n0-i_b]
    # index algebra maps to i-1 in forward coordinates)
    T = arrays["mean"].shape[1]

    def window_at(src, anchors, pv):
        """w[e, r] = src[e, anchors[e]-1+r] with out-of-range -> pv."""
        idx = anchors[:, None] - 1 + np.arange(W)[None, :]
        ok = (idx >= 0) & (idx < T)
        idxc = np.clip(idx, 0, T - 1)
        vals = np.stack([src[e][idxc[e]] for e in range(E)], axis=0)
        return np.where(ok, vals, pv)

    def refill_arrays(src, base_anchors, pv):
        """[S_pad, E, DMAX] with vals[q, e, t] = src[e, base_anchors[e,q]+t]."""
        idx = base_anchors[:, :, None] + np.arange(DMAX)[None, None, :]
        ok = (idx >= 0) & (idx < T)
        idxc = np.clip(idx, 0, T - 1)
        vals = np.stack([src[e][idxc[e]] for e in range(E)], axis=0)
        vals = np.where(ok, vals, pv)
        return np.ascontiguousarray(np.transpose(vals, (1, 0, 2)))

    pad_vals = (0.0, 1.0, 0.0)
    fwd_srcs = (arrays["mean"], arrays["stdv"], arrays["lsr"])
    bwd_srcs = (arrays["mean"], arrays["stdv"], arrays["lsd"])

    # forward: window 0 anchored at the FIRST column's band start (its slide
    # is 0; the blank column's values are identically zero and need no data);
    # tails for column q refill from the PREVIOUS column's window end
    tail_base = i0p[:, :-1].astype(np.int64) + (W - 1)      # [E, S_pad]
    # backward: window 0 anchored at the frozen pad anchor; heads for column q
    # refill from the column's own start
    head_base = i0p[:, 1:].astype(np.int64) - 1             # [E, S_pad]

    fwd = dict(
        win0=tuple(window_at(s, i0p[:, 1].astype(np.int64), pv)
                   for s, pv in zip(fwd_srcs, pad_vals)),
        refills=tuple(refill_arrays(s, tail_base, pv)
                      for s, pv in zip(fwd_srcs, pad_vals)),
    )
    bwd = dict(
        win0=tuple(window_at(s, i0p[:, -1].astype(np.int64), pv)
                   for s, pv in zip(bwd_srcs, pad_vals)),
        refills=tuple(refill_arrays(s, head_base, pv)
                      for s, pv in zip(bwd_srcs, pad_vals)),
    )

    return dict(i0=i0p, i1=i1p, is_pad=is_pad, fwd=fwd, bwd=bwd)


def limited_geometry(ref_indexes, n0: np.ndarray, S, S_pad: int,
                     width: int, open_tail: bool = False):
    """Rate-limited band geometry padded to S_pad (+1 cols incl. blank):
    starts advance by at most DMAX per column, tops re-clipped to the
    rectangle, padding columns frozen at the col-S anchor with empty bands.

    S may be an int (all events share one sequence) or an [E] array of
    per-event sequence lengths-in-states (multi-region batches): each event's
    geometry freezes at its own column S_e.

    open_tail=True (the mutation-scoring geometry) places bands in the
    columns past S as in any other column instead: a mutation that
    lengthens the sequence refills columns past the original S, and the
    reference places their bands from the same ref_index."""
    from .dp import DMAX

    E = len(n0)
    W = 2 * width + 1
    S_e = (np.full(E, S, dtype=np.int64) if np.isscalar(S)
           else np.asarray(S, dtype=np.int64))
    S_max = S_pad if open_tail else (int(S_e.max()) if E else 0)
    i0, i1 = band_geometry(ref_indexes, n0, S_max, width, backward=False)
    # rate limit from the SECOND column on: column 1 anchors wherever its
    # band belongs (the data window starts there, dp.make_fill wa0), so a
    # read overhanging the region head — whose first in-band row sits
    # thousands of levels in — does not spend hundreds of columns catching
    # up at DMAX rows/column from the virtual blank column
    for j in range(2, S_max + 1):
        np.minimum(i0[:, j], i0[:, j - 1] + DMAX, out=i0[:, j])
    i1 = np.minimum(i1, i0 + (W - 1))
    if open_tail:
        return i0.astype(np.int32), i1.astype(np.int32)

    i0p = np.zeros((E, S_pad + 1), dtype=np.int32)
    i1p = np.zeros((E, S_pad + 1), dtype=np.int32)
    i0p[:, : S_max + 1] = i0
    i1p[:, : S_max + 1] = i1
    i0p[:, S_max + 1 :] = i0[:, S_max][:, None]
    i1p[:, S_max + 1 :] = 0
    if not np.isscalar(S):
        cols = np.arange(S_pad + 1, dtype=np.int64)[None, :]
        beyond = cols > S_e[:, None]
        anchor = i0p[np.arange(E), np.minimum(S_e, S_pad)]
        i0p = np.where(beyond, anchor[:, None], i0p).astype(np.int32)
        i1p = np.where(beyond, 0, i1p).astype(np.int32)
    return i0p, i1p


def band_geometry(ref_indexes, n0: np.ndarray, S: int, width: int, backward: bool):
    """i0/i1 [E, S+1] per column (col 0 = blank: i0=0, i1=n0).

    Column k (k>=1) corresponds to refind=k forward, refind=S-k+1 backward.
    Mirrors Alignment.cpp:127-148 / :296-321."""
    E = len(ref_indexes)
    i0 = np.zeros((E, S + 1), dtype=np.int32)
    i1 = np.zeros((E, S + 1), dtype=np.int32)
    i1[:, 0] = n0
    refinds = np.arange(1, S + 1)
    if backward:
        refinds = S - refinds + 1
    for e, ri in enumerate(ref_indexes):
        ne = int(n0[e])
        if len(ri) > 0:
            imid = np.searchsorted(ri, refinds, side="left").astype(np.int64)
            if backward:
                imid = ne - imid + 1
        else:
            imid = np.ones(S, dtype=np.int64)
        curwid = np.full(S, width, dtype=np.int64)
        shrink = (curwid < ne) & ((imid < -10) | (imid > ne + 10))
        curwid[shrink] = 5
        imid = np.clip(imid, 1, max(ne, 1))
        lo = np.maximum(imid - curwid, 1)
        hi = np.minimum(imid + curwid, ne)
        i0[e, 1:] = lo
        i1[e, 1:] = hi
    return i0, i1
