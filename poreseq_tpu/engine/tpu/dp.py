"""Batched banded pair-HMM dynamic programming in JAX.

Implements the reference recurrence (SURVEY.md Appendix A; spec
/root/reference/cpp/Alignment.cpp:111-444) as a column scan batched over
events.  The in-column dependency chain (stay lattice + U_INSERT main-lattice
move) is solved with an associative max-plus 2x2 matrix scan over the band:

    v[r] = A[r] (x) v[r-1]  (+)  u[r],     v = (M, S)
    A[r] = [[max(lik_insert, e+lik_stay), e+lik_extend],
            [e+lik_stay,                  e+lik_extend]]
    u[r] = (D[r], floor[r])

where D[r] collects the prev-column candidates (skip / match / ignore,
including the implicit-zero local restarts) and floor is 0 in-band except
-BIG at the no-stay-entry row (the reference's curstay[i0] = -inf).

Design decisions:
  * The host band geometry is rate-limited (starts advance by <= DMAX per
    column), so ALL cross-column data movement is selects over static rolls
    rather than per-row gathers inside the scan; emission data windows are
    carried in the scan and refilled from precomputed tail/head arrays.
  * The BACKWARD fill runs in *forward* event coordinates using the flip
    identity i = n0+1-i_b: the reference's backward band mirrors back to
    exactly the forward band [imid-w, imid+w] (Alignment.cpp:296-321), its
    emission indices mean[n0-i_b] become mean[i-1], and backward columns are
    stored with the same anchors as forward columns — which makes the
    fwd x back columnMax joins constant-lag elementwise maxes.  The reverse
    recurrence reads the previous (q+1) column at i and i+1 and chains
    within-column from i+1 downward (reverse associative scan).

Quirks preserved from the reference (values, not bitwise in f32):
  * forward emission feeds the reversed log_stdv index into the inverse
    Gaussian (Alignment.cpp:171-172) while the backward pass feeds the
    (flipped-flipped = plain) one;
  * the backward pass uses the previous column's emission for UL_MATCH with
    an implicit restart of 0, and the source cell's emission for stay/extend
    (Alignment.cpp:388-406);
  * candidate evaluation order 0..3 with strict >, then stay override, for
    the backpointer bytes;
  * the `i > p0 && i <= p1` membership tests for diagonal reads.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

LOG2PI = float(np.log(2.0 * np.pi))

# move codes (Alignment.cpp:19-28)
SKIP, MATCH, INSERT, IGNORE, STAY, EXTEND, IMPLICIT = 0, 1, 2, 3, 4, 5, 255

# maximum band-start advance per column enforced by the host geometry
DMAX = 8


def neg_big(dtype):
    # finite -inf sentinel: the reference uses 1e300 (AlignUtil.h:20); for f32
    # we use -1e30 so sums of sentinels stay finite
    return jnp.asarray(-1e300 if dtype == jnp.float64 else -1e30, dtype)


class EventBatch(NamedTuple):
    """Padded per-event data, levels along axis 1 (length T_pad)."""

    mean: jax.Array        # [E, T]
    stdv: jax.Array        # [E, T]
    lsd: jax.Array         # [E, T]  log(stdv)                (backward pass)
    lsr: jax.Array         # [E, T]  log_stdv[n0-1-t] reversed (forward quirk)
    n0: jax.Array          # [E] int32 true level counts
    active: jax.Array      # [E] bool: has a seed alignment (stripe > 0)
    lev_mean: jax.Array    # [E, 1024]
    lev_stdv: jax.Array
    log_lev: jax.Array
    sd_mean: jax.Array
    sd_lambda: jax.Array
    log_lambda: jax.Array
    lik_skip: jax.Array    # [E]
    lik_stay: jax.Array
    lik_extend: jax.Array
    lik_insert: jax.Array


class FillResult(NamedTuple):
    M: jax.Array        # [C, E, W] main lattice (stacked by column q-1)
    S: jax.Array        # [C, E, W] stay lattice
    steps_m: jax.Array  # [C, E, W] uint8 (forward only)
    steps_s: jax.Array  # [C, E, W] uint8
    i0: jax.Array       # [E, C+1] int32 band starts (col 0 = blank)
    i1: jax.Array       # [E, C+1]
    best: jax.Array     # [E] running max score
    best_i: jax.Array   # [E]
    best_j: jax.Array   # [E] (refind coordinates)
    best_pfx: jax.Array  # [C, E] per-column prefix max (the column's maxScore;
    #                      for the backward fill this is the suffix max, i.e.
    #                      the reference's scores_back[rab]->maxScore)


def emission(mean_v, stdv_v, logx_v, lm, ls, ll, sm, lam, llam, lik_offset):
    """e = lognormpdf(mean; level) + logigpdf(stdv; sd) + lik_offset
    (Alignment.cpp:167-174 / AlignUtil.h:34-53)."""
    d1 = (mean_v - lm) / ls
    ln = -0.5 * (d1 * d1 + LOG2PI) - ll
    d2 = (stdv_v - sm) / sm
    lig = 0.5 * (llam - 3.0 * logx_v - LOG2PI - d2 * d2 * lam / stdv_v)
    return ln + lig + lik_offset


def _mp_combine(lhs, rhs):
    """Max-plus combine for elements (a11,a12,a21,a22,u1,u2): rhs after lhs."""
    l11, l12, l21, l22, lu1, lu2 = lhs
    r11, r12, r21, r22, ru1, ru2 = rhs
    a11 = jnp.maximum(r11 + l11, r12 + l21)
    a12 = jnp.maximum(r11 + l12, r12 + l22)
    a21 = jnp.maximum(r21 + l11, r22 + l21)
    a22 = jnp.maximum(r21 + l12, r22 + l22)
    u1 = jnp.maximum(jnp.maximum(r11 + lu1, r12 + lu2), ru1)
    u2 = jnp.maximum(jnp.maximum(r21 + lu1, r22 + lu2), ru2)
    return (a11, a12, a21, a22, u1, u2)


def column_solve(D, a_stay, a_ext, lik_insert, floor0, cut, dtype,
                 reverse=False):
    """Solve one band column's (M, S): the max-plus linear scan over the band
    axis (last).  `cut` [..., W] is True where the row has NO within-column
    predecessor (top of the chain); floor0 is the stay-lattice floor.
    reverse=True chains from the high rows downward (backward fill)."""
    NB = neg_big(dtype)
    a11 = jnp.maximum(lik_insert, a_stay)
    a12 = a_ext
    a21 = a_stay
    a22 = a_ext
    a11 = jnp.where(cut, NB, a11)
    a12 = jnp.where(cut, NB, a12)
    a21 = jnp.where(cut, NB, a21)
    a22 = jnp.where(cut, NB, a22)
    elems = (a11, a12, a21, a22, D, floor0)
    res = jax.lax.associative_scan(_mp_combine, elems, axis=D.ndim - 1,
                                   reverse=reverse)
    return res[4], res[5]


def shift_select(x, d, shifts, fills=None):
    """Per-event band shift: out[e] = x[e] shifted left by d[e] (negative =
    right), with d[e] expected within `shifts` (out-of-range rows give 0).
    Vacated positions take fills[e, :|shift|] (tail for left shifts, head for
    right shifts) when given, else 0."""
    E, W = x.shape[-2], x.shape[-1]
    lead = x.shape[:-2]
    out = jnp.zeros_like(x)
    for s in shifts:
        if s < 0:
            head = (fills[..., : -s] if fills is not None
                    else jnp.zeros(lead + (E, -s), x.dtype))
            cand = jnp.concatenate([head, x[..., :s]], axis=-1)
        elif s == 0:
            cand = x
        else:
            tail = (fills[..., :s] if fills is not None
                    else jnp.zeros(lead + (E, s), x.dtype))
            cand = jnp.concatenate([x[..., s:], tail], axis=-1)
        out = jnp.where((d == s)[..., :, None], cand, out)
    return out


SH_FWD = tuple(range(0, DMAX + 1))
SH_FWD_M1 = tuple(range(-1, DMAX))
SH_BWD = tuple(range(-DMAX, 1))
SH_BWD_P1 = tuple(range(-DMAX + 1, 2))


def shift_select2(x, s, smin: int, smax: int, out_w: int):
    """Two-stage (coarse-8 + fine) variable shift: out[..., r] = x[..., r+s]
    for r < out_w, per-element s in [smin, smax] (else 0 rows).  Costs
    ~((smax-smin)/8 + 8) selects instead of (smax-smin) — used where the
    shift range is wide (refill seams, fwd x back joins)."""
    W = x.shape[-1]
    L = max(-smin, 0)
    ncoarse = (smax - smin) // 8 + 1
    R = max(smax + out_w + 8 - W, 0)
    pad_shape_l = x.shape[:-1] + (L,)
    pad_shape_r = x.shape[:-1] + (R,)
    xp = jnp.concatenate(
        [jnp.zeros(pad_shape_l, x.dtype), x, jnp.zeros(pad_shape_r, x.dtype)],
        axis=-1)
    c = (s - smin) >> 3                       # coarse index
    f = (s - smin) & 7                        # fine 0..7
    ok = (s >= smin) & (s <= smax)
    mid = jnp.zeros(x.shape[:-1] + (out_w + 8,), x.dtype)
    for ci in range(ncoarse):
        base = L + smin + 8 * ci
        cand = jax.lax.slice_in_dim(xp, base, base + out_w + 8, axis=-1)
        mid = jnp.where(((c == ci) & ok)[..., None], cand, mid)
    out = jnp.zeros(x.shape[:-1] + (out_w,), x.dtype)
    for fi in range(8):
        out = jnp.where((f == fi)[..., None], mid[..., fi : fi + out_w], out)
    return out


def device_window_inputs(batch: EventBatch, i0, backward: bool, W: int):
    """win0 + refill arrays for one fill direction, computed ON DEVICE from
    the band-start geometry (i0 [E, C+1] incl. the blank col 0).

    Replaces ~40 MB of host-built, host-uploaded window arrays per call with
    one bandwidth-bound gather on the device.  Matches pack.fill_inputs exactly:
    forward windows anchor at 0 and refill column q from the previous
    column's window end; backward windows anchor at the frozen pad anchor and
    refill from the column's own start."""
    E, T = batch.mean.shape
    if backward:
        srcs = (batch.mean, batch.stdv, batch.lsd)
        anchor0 = i0[:, -1].astype(jnp.int32)
        base = i0[:, 1:].astype(jnp.int32) - 1              # [E, C] heads
    else:
        srcs = (batch.mean, batch.stdv, batch.lsr)
        # window 0 anchored at the FIRST column's band start (the first
        # column's slide is then 0; the blank column needs no window since
        # its values are identically zero) — overhanging reads start their
        # band mid-read instead of sliding up from level 0
        anchor0 = i0[:, 1].astype(jnp.int32)
        base = i0[:, :-1].astype(jnp.int32) + (W - 1)       # [E, C] tails
    pad_vals = (0.0, 1.0, 0.0)
    r8 = jnp.arange(DMAX, dtype=jnp.int32)
    rW = jnp.arange(W, dtype=jnp.int32)
    wi = anchor0[:, None] - 1 + rW[None, :]
    wok = (wi >= 0) & (wi < T)
    wic = jnp.clip(wi, 0, T - 1)
    fi = base[:, :, None] + r8[None, None, :]
    fok = (fi >= 0) & (fi < T)
    fic = jnp.clip(fi, 0, T - 1).reshape(E, -1)
    win0, refills = [], []
    for src, pv in zip(srcs, pad_vals):
        w = jnp.take_along_axis(src, wic, axis=1)
        win0.append(jnp.where(wok, w, jnp.asarray(pv, src.dtype)))
        f = jnp.take_along_axis(src, fic, axis=1).reshape(E, -1, DMAX)
        f = jnp.where(fok, f, jnp.asarray(pv, src.dtype))
        refills.append(jnp.moveaxis(f, 0, 1))               # [C, E, DMAX]
    return tuple(win0), tuple(refills)


def make_fill(width: int, dtype=jnp.float32, need_steps: bool = True):
    """Build the jittable banded fill for a given half-width (static).
    See the module docstring for the layout contract."""
    W = 2 * width + 1

    def fill(batch: EventBatch, states, i0, i1, win0, refills, is_pad,
             lik_offset, backward: bool):
        """states [C] int32 (padded with -1) — or [C, E] for multi-region
        batches where each event aligns to its own sequence; i0/i1 [E, C+1]
        rate-limited geometry (col 0 = blank covering [0, n0]; both directions
        share it); win0: (mean, stdv, logx) [E, W] initial data windows for the
        scan's first processed column's *previous* anchor; refills [C, E, DMAX]
        per-column window tail (forward) or head (backward) values; is_pad [C]
        (or [C, E] per-event for multi-region) marks dead padding columns
        (carry passes through).  Returns FillResult stacked by column."""
        E, T = batch.mean.shape
        C = states.shape[0]
        NB = neg_big(dtype)
        rows = jnp.arange(W, dtype=jnp.int32)  # [W]

        per_event = states.ndim == 2
        if per_event:
            # hoist the per-(column, event) model lookups out of the scan:
            # one big gather each (bandwidth-bound) instead of a per-step
            # per-event gather (latency-bound)
            stc_t = jnp.clip(states, 0, 1023).astype(jnp.int32).T   # [E, C]
            model_cols = tuple(
                jnp.take_along_axis(tbl, stc_t, axis=1).T            # [C, E]
                for tbl in (batch.lev_mean, batch.lev_stdv, batch.log_lev,
                            batch.sd_mean, batch.sd_lambda,
                            batch.log_lambda))
        else:
            model_cols = ()

        def body(carry, xs):
            (prevM, prevS, prev_obs, mean_w, stdv_w, lsx_w, wa, p0, p1, best,
             best_i, best_j) = carry
            (st, i0c, i1c, refind, pad, rf_mean, rf_stdv, rf_lsx) = xs[:8]

            i = i0c[:, None] + rows[None, :]          # [E, W] absolute i
            in_band = i <= i1c[:, None]

            # ---- slide the data windows (anchor wa -> i0c) ----
            if backward:
                dw = i0c - wa                          # in [-DMAX, 0]
                sh_w = SH_BWD
            else:
                dw = i0c - wa                          # in [0, DMAX]
                sh_w = SH_FWD
            mean_v = shift_select(mean_w, dw, sh_w, rf_mean)
            stdv_v = shift_select(stdv_w, dw, sh_w, rf_stdv)
            lsx_v = shift_select(lsx_w, dw, sh_w, rf_lsx)

            if per_event:
                lm, ls, ll, sm, lam, llam = (m[:, None] for m in xs[8:14])
                st_live = (st >= 0)[:, None]
            else:
                stc = jnp.clip(st, 0, 1023)
                lm = batch.lev_mean[:, stc][:, None]
                ls = batch.lev_stdv[:, stc][:, None]
                ll = batch.log_lev[:, stc][:, None]
                sm = batch.sd_mean[:, stc][:, None]
                lam = batch.sd_lambda[:, stc][:, None]
                llam = batch.log_lambda[:, stc][:, None]
                st_live = st >= 0
            e = emission(mean_v, stdv_v, lsx_v, lm, ls, ll, sm, lam, llam,
                         lik_offset).astype(dtype)
            e = jnp.where(in_band, e, 0.0)
            live = in_band & st_live & batch.active[:, None]

            # ---- previous-column reads via rolls ----
            dv = i0c - p0
            lik_skip = batch.lik_skip[:, None]
            lik_stay = batch.lik_stay[:, None]
            lik_extend = batch.lik_extend[:, None]
            lik_insert = batch.lik_insert[:, None]

            valid_i = (i >= p0[:, None]) & (i <= p1[:, None])
            if backward:
                # prev column is q+1; diagonal reads at i+1
                pm_i = shift_select(prevM, jnp.clip(dv, -DMAX, 0), SH_BWD)
                pm_d = shift_select(prevM, jnp.clip(dv + 1, -DMAX + 1, 1),
                                    SH_BWD_P1)
                pobs_d = shift_select(prev_obs, jnp.clip(dv + 1, -DMAX + 1, 1),
                                      SH_BWD_P1)
                valid_ul = (i >= p0[:, None]) & (i < p1[:, None])
                match_c = jnp.where(valid_ul, pm_d + pobs_d, 0.0)
            else:
                pm_i = shift_select(prevM, jnp.clip(dv, 0, DMAX), SH_FWD)
                pm_d = shift_select(prevM, jnp.clip(dv - 1, -1, DMAX - 1),
                                    SH_FWD_M1)
                valid_ul = (i > p0[:, None]) & (i <= p1[:, None])
                match_c = jnp.where(valid_ul, pm_d, 0.0) + e

            skip_c = jnp.where(valid_i, pm_i, 0.0) + lik_skip
            ignore_c = jnp.where(valid_ul, pm_d + lik_insert, 0.0)
            D = jnp.maximum(jnp.maximum(0.0, skip_c),
                            jnp.maximum(match_c, ignore_c)).astype(dtype)

            # within-column source emission: forward uses the current cell's,
            # backward the source (i+1) cell's
            if backward:
                e_src = jnp.concatenate([e[:, 1:], jnp.zeros((E, 1), dtype)],
                                        axis=1)
                cut = i >= i1c[:, None]      # no predecessor above band top
                floor0 = jnp.where(i == i1c[:, None], NB,
                                   jnp.zeros_like(D)).astype(dtype)
            else:
                e_src = e
                cut = rows[None, :] == 0
                floor0 = jnp.where(cut, NB, jnp.zeros_like(D)).astype(dtype)
            a_stay = (e_src + lik_stay).astype(dtype)
            a_ext = (e_src + lik_extend).astype(dtype)

            M, S = column_solve(D, a_stay, a_ext, lik_insert, floor0, cut,
                                dtype, reverse=backward)

            M = jnp.where(live, M, 0.0)
            S = jnp.where(live, S, 0.0)
            e_out = jnp.where(live, e, 0.0)

            if need_steps:
                # ---- backpointer bytes (forward only; candidate walk,
                # strict >, order 0..3 then stay override) ----
                Mm1 = jnp.concatenate([jnp.zeros((E, 1), dtype), M[:, :-1]],
                                      axis=1)
                Sm1 = jnp.concatenate([jnp.zeros((E, 1), dtype), S[:, :-1]],
                                      axis=1)
                nfirst = rows[None, :] > 0
                ins_c = jnp.where(nfirst, Mm1 + lik_insert, 0.0)
                s4 = jnp.where(nfirst, Mm1 + e_src + lik_stay, NB)
                s5 = jnp.where(nfirst, Sm1 + e_src + lik_extend, NB)

                val = jnp.zeros_like(M)
                stp = jnp.zeros_like(M, dtype=jnp.uint8)
                bp0 = jnp.where(valid_i, jnp.uint8(SKIP), jnp.uint8(IMPLICIT))
                upd = skip_c > val
                val = jnp.where(upd, skip_c, val)
                stp = jnp.where(upd, bp0, stp)
                bp1 = jnp.where(valid_ul, jnp.uint8(MATCH), jnp.uint8(IMPLICIT))
                upd = match_c > val
                val = jnp.where(upd, match_c, val)
                stp = jnp.where(upd, bp1, stp)
                upd = ins_c > val
                val = jnp.where(upd, ins_c, val)
                stp = jnp.where(upd, jnp.uint8(INSERT), stp)
                upd = ignore_c > val
                val = jnp.where(upd, ignore_c, val)
                stp = jnp.where(upd, jnp.uint8(IGNORE), stp)
                upd = S > val
                stp = jnp.where(upd, jnp.uint8(STAY), stp)

                sfloor = jnp.where(rows[None, :] == 0, NB, 0.0).astype(dtype)
                sval = sfloor
                sstp = jnp.zeros_like(stp)
                upd = s4 > sval
                sval = jnp.where(upd, s4, sval)
                sstp = jnp.where(upd, jnp.uint8(STAY), sstp)
                upd = s5 > sval
                sstp = jnp.where(upd, jnp.uint8(EXTEND), sstp)

                stp = jnp.where(live, stp, 0)
                sstp = jnp.where(live, sstp, 0)
            else:
                stp = jnp.zeros((E, 0), jnp.uint8)
                sstp = jnp.zeros((E, 0), jnp.uint8)

            # ---- running best (strict >, first max within column) ----
            Mmask = jnp.where(live, M, NB)
            cmax = jnp.max(Mmask, axis=1)
            carg = jnp.argmax(Mmask, axis=1).astype(jnp.int32)
            better = cmax > best
            best_n = jnp.where(better, cmax, best)
            best_i_n = jnp.where(better, i0c + carg, best_i)
            best_j_n = jnp.where(better, refind, best_j)

            # padding columns pass the carry through untouched (pad is scalar
            # per column, or [E] when regions of different lengths share the
            # batch)
            pad_w = pad[:, None] if pad.ndim else pad

            def sel(new, old):
                return jnp.where(pad_w if new.ndim == 2 else pad, old, new)

            new_carry = (
                sel(M, prevM), sel(S, prevS), sel(e_out, prev_obs),
                sel(mean_v, mean_w), sel(stdv_v, stdv_w), sel(lsx_v, lsx_w),
                sel(i0c, wa), sel(i0c, p0), sel(i1c, p1),
                sel(best_n, best), sel(best_i_n, best_i), sel(best_j_n, best_j),
            )
            ys = (jnp.where(pad_w, 0.0, M), jnp.where(pad_w, 0.0, S), stp,
                  sstp, sel(best_n, best))
            return new_carry, ys

        win_mean0, win_stdv0, win_lsx0 = win0
        rf_mean, rf_stdv, rf_lsx = refills
        if backward:
            wa0 = i0[:, C]
            p0_init = jnp.zeros((E,), jnp.int32)
            p1_init = batch.n0.astype(jnp.int32)
        else:
            wa0 = i0[:, 1].astype(jnp.int32)   # window 0 sits at column 1
            p0_init = jnp.zeros((E,), jnp.int32)
            p1_init = batch.n0.astype(jnp.int32)
        init = (
            jnp.zeros((E, W), dtype),
            jnp.zeros((E, W), dtype),
            jnp.zeros((E, W), dtype),
            jnp.asarray(win_mean0, dtype),
            jnp.asarray(win_stdv0, dtype),
            jnp.asarray(win_lsx0, dtype),
            jnp.asarray(wa0, jnp.int32),
            p0_init,
            p1_init,
            jnp.zeros((E,), dtype),
            jnp.zeros((E,), jnp.int32),
            jnp.zeros((E,), jnp.int32),
        )
        refinds = jnp.arange(1, C + 1, dtype=jnp.int32)
        xs = (states, i0[:, 1:].T, i1[:, 1:].T, refinds, is_pad,
              jnp.asarray(rf_mean, dtype), jnp.asarray(rf_stdv, dtype),
              jnp.asarray(rf_lsx, dtype)) + model_cols
        carry, (M, S, steps_m, steps_s, best_pfx) = jax.lax.scan(
            body, init, xs, reverse=backward)
        best, best_i, best_j = carry[-3], carry[-2], carry[-1]
        return FillResult(M, S, steps_m, steps_s, i0, i1, best, best_i, best_j,
                          best_pfx)

    return fill
