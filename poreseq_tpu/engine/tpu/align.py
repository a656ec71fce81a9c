"""Device-engine alignment scoring: fill + device backtrace + likes.

Assembles the batched banded DP (dp.py) into the ScoreAlignments /
ScoreMutations plumbing (spec: /root/reference/cpp/MakeMutations.cpp:148-195,
Alignment.cpp:516-624 for the backtrace).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .dp import (EXTEND, IGNORE, INSERT, MATCH, SKIP, STAY,
                 device_window_inputs, make_fill)


def backtrace_core(M, S, steps_m, steps_s, i0, i1, best_i, best_j, t_pad: int = 0,
                   max_steps: int = 0):
    """Vectorized best-path backtrace (Alignment.cpp:516-624).

    M/S/steps: [C, E, W]; i0/i1: [E, C+1]; returns ref_align [E,T] (float:
    0 unaligned, -1 insert, else 1-based ref index), ref_like [E,T]."""
    C, E, W = M.shape
    T = t_pad

    def lane(M_e, S_e, sm_e, ss_e, i0_e, i1_e, bi, bj):
        # Per-event walk; arrays [C, W] / [C+1].  Every emit decrements i, so
        # each level index is written at most once — the writes are recorded
        # as scan outputs and materialized in ONE scatter afterwards instead
        # of two per-step scatters inside the walk (non-emits are routed to
        # the out-of-bounds index T, which scatter 'drop' mode discards).
        def body(carry, _):
            i, j, arr, act = carry
            jok = (j >= 1) & (j <= C)
            jc = jnp.clip(j, 1, C)
            row = i - i0_e[jc]
            inb = (row >= 0) & (row < W) & (i <= i1_e[jc]) & (i >= i0_e[jc])
            rowc = jnp.clip(row, 0, W - 1)
            sc = jnp.where(arr == 0, M_e[jc - 1, rowc], S_e[jc - 1, rowc])
            stp = jnp.where(arr == 0, sm_e[jc - 1, rowc], ss_e[jc - 1, rowc])
            ok = act & (i > 0) & jok & inb & (sc > 0.0)

            is_match = stp == MATCH
            is_ignore = stp == IGNORE
            is_insert = stp == INSERT
            is_stay = stp == STAY
            is_extend = stp == EXTEND
            is_skip = stp == SKIP

            emit_ref = is_match | is_extend | (is_stay & (arr == 1))
            emit_ins = is_ignore | is_insert
            emit = ok & (emit_ref | emit_ins)
            val = jnp.where(emit_ref, j.astype(M.dtype), jnp.asarray(-1.0, M.dtype))

            widx = jnp.where(emit, i - 1, T)

            di = jnp.where(emit, 1, 0)
            dj = jnp.where(is_skip | is_match | is_ignore, 1, 0)
            narr = jnp.where(is_stay, 1 - arr, arr)
            bad = (~(is_match | is_ignore | is_insert | is_stay | is_extend | is_skip))
            act2 = ok & ~bad
            i2 = jnp.where(ok, i - di, i)
            j2 = jnp.where(ok, j - dj, j)
            arr2 = jnp.where(ok, narr, arr)
            act2 = act2 & (i2 > 0)
            return (i2, j2, arr2, act2), (widx, val, sc)

        init = (bi, bj, jnp.int32(0), (bi > 0))
        _, (w_all, v_all, s_all) = jax.lax.scan(body, init, None,
                                                length=max_steps)
        ral = jnp.zeros(T, M.dtype).at[w_all].set(v_all, mode="drop")
        rlk = jnp.zeros(T, M.dtype).at[w_all].set(s_all, mode="drop")
        return ral, rlk

    return jax.vmap(lane)(
        jnp.moveaxis(M, 1, 0), jnp.moveaxis(S, 1, 0),
        jnp.moveaxis(steps_m, 1, 0), jnp.moveaxis(steps_s, 1, 0),
        i0, i1, best_i, best_j,
    )


def device_likes(ral, rlk, n_like: int):
    """Per-event per-reference-base cumulative likelihood values on device
    (the selection core of likes_contribution, cpp/MakeMutations.cpp:168-189).

    ral/rlk [E, T] are the backtrace outputs (ral monotone where > 0, as the
    device backtrace emits).  Returns vals [E, n_like] where vals[e, k] is
    the DP score of the last aligned level at or before reference index k+1
    (0 where none) — the host slices vals[:, :lim-1] into likes[2:lim+1]
    exactly like the host fast path."""
    T = ral.shape[1]
    iota = jnp.arange(T, dtype=jnp.int32)
    anchor = ral > 0
    idxf = jax.lax.cummax(jnp.where(anchor, iota, -1), axis=1)
    A = jax.lax.cummax(jnp.where(anchor, ral, 0), axis=1)
    V = jnp.take_along_axis(rlk, jnp.maximum(idxf, 0), axis=1)
    ks = jnp.arange(1, n_like + 1, dtype=A.dtype)

    def one(A_e, V_e):
        j = jnp.searchsorted(A_e, ks, side="right") - 1
        jc = jnp.maximum(j, 0)
        ok = (j >= 0) & (A_e[jc] > 0)
        return jnp.where(ok, V_e[jc], 0.0)

    return jax.vmap(one)(A, V)


class FusedCache:
    """Jitted fused programs: fill(s) + backtrace in ONE device call — the
    host needs only the (small) backtrace outputs between stages, so the
    full lattices never leave the device."""

    def __init__(self):
        self._fns = {}

    def fwd_dev(self, width, dtype):
        """Forward fill + backtrace with win0/refills built ON DEVICE from
        the geometry (H2D per call shrinks to the int32 band starts).
        Returns (best [E], ral, rlk, likes [E, n_like]): the full lattices /
        step bytes stay internal to the program, and per-base likes are
        computed on device so the host never reads rlk on the hot path."""
        key = ("fwd_dev", width, str(dtype))
        if key not in self._fns:
            fill = make_fill(width, dtype, need_steps=True)
            W = 2 * width + 1

            def fwd_dev(batch, states, i0, i1, is_pad, off, t_pad=0,
                    max_steps=0, n_like=8):
                w0, rf = device_window_inputs(batch, i0, False, W)
                r = fill(batch, states, i0, i1, w0, rf, is_pad, off, False)
                ral, rlk = backtrace_core(r.M, r.S, r.steps_m, r.steps_s,
                                          r.i0, r.i1, r.best_i, r.best_j,
                                          t_pad, max_steps)
                return r.best, ral, rlk, device_likes(ral, rlk, n_like)

            self._fns[key] = jax.jit(
                fwd_dev, static_argnames=("t_pad", "max_steps", "n_like"))
        return self._fns[key]

    def fwd_likes(self, width, dtype):
        """Candidate-scoring fill: fill + backtrace + device likes, returning
        ONLY (best [E], likes [E, n_like]) — nothing [E, T]-sized crosses the
        device boundary (candidate snapshots are discarded after their likes
        are read, so ral/rlk never need to reach the host)."""
        key = ("fwd_likes", width, str(dtype))
        if key not in self._fns:
            fill = make_fill(width, dtype, need_steps=True)
            W = 2 * width + 1

            def fwd_likes(batch, states, i0, i1, is_pad, off, t_pad=0,
                    max_steps=0, n_like=8):
                w0, rf = device_window_inputs(batch, i0, False, W)
                r = fill(batch, states, i0, i1, w0, rf, is_pad, off, False)
                ral, rlk = backtrace_core(r.M, r.S, r.steps_m, r.steps_s,
                                          r.i0, r.i1, r.best_i, r.best_j,
                                          t_pad, max_steps)
                return r.best, device_likes(ral, rlk, n_like)

            self._fns[key] = jax.jit(
                fwd_likes, static_argnames=("t_pad", "max_steps", "n_like"))
        return self._fns[key]

    def fwd_likes_sharded(self, width, dtype, mesh, t_pad, max_steps, n_like):
        """fwd_likes under shard_map over the engine mesh (events on 'ev')."""
        key = ("fwd_likes_sh", width, str(dtype), mesh, t_pad, max_steps,
               n_like)
        if key not in self._fns:
            from jax.sharding import PartitionSpec as PS

            from ...parallel.mesh import shard_map
            from .dp import EventBatch

            inner = self.fwd_likes(width, dtype)

            def fwd_likes_sharded(batch, states, i0, i1, is_pad, off):
                return inner(batch, states, i0, i1, is_pad, off,
                             t_pad=t_pad, max_steps=max_steps, n_like=n_like)

            ev, col_ev = PS("ev"), PS(None, "ev")
            bspec = EventBatch(*([ev] * len(EventBatch._fields)))
            f = shard_map(
                fwd_likes_sharded, mesh,
                in_specs=(bspec, col_ev, ev, ev, col_ev, PS()),
                out_specs=(ev, ev),
            )
            self._fns[key] = jax.jit(f)
        return self._fns[key]

    def both_dev(self, width, dtype):
        """fwd + bwd fills + backtrace, windows built on device.  Returns the
        blank-extended lattice stacks the mutation kernel consumes —
        (Mf, Sf, Mb, Sb [C+1, E, W], bpf, bpb [C+1, E], ral, rlk) — so the
        extension concats run inside the program and the step bytes never
        leave it."""
        key = ("both_dev", width, str(dtype))
        if key not in self._fns:
            fillf = make_fill(width, dtype, need_steps=True)
            fillb = make_fill(width, dtype, need_steps=False)
            W = 2 * width + 1

            def both_dev(batch, states, i0, i1, is_pad, off, t_pad=0,
                         max_steps=0):
                w0f, rff = device_window_inputs(batch, i0, False, W)
                w0b, rfb = device_window_inputs(batch, i0, True, W)
                rf = fillf(batch, states, i0, i1, w0f, rff, is_pad, off, False)
                rb = fillb(batch, states, i0, i1, w0b, rfb, is_pad, off, True)
                ral, rlk = backtrace_core(rf.M, rf.S, rf.steps_m, rf.steps_s,
                                          rf.i0, rf.i1, rf.best_i, rf.best_j,
                                          t_pad, max_steps)
                zc = jnp.zeros((1,) + rf.M.shape[1:], rf.M.dtype)
                zr = jnp.zeros((1, rf.M.shape[1]), rf.M.dtype)
                return (jnp.concatenate([zc, rf.M]),
                        jnp.concatenate([zc, rf.S]),
                        jnp.concatenate([zc, rb.M]),
                        jnp.concatenate([zc, rb.S]),
                        jnp.concatenate([zr, rf.best_pfx]),
                        jnp.concatenate([zr, rb.best_pfx]),
                        ral, rlk)

            self._fns[key] = jax.jit(both_dev,
                                     static_argnames=("t_pad", "max_steps"))
        return self._fns[key]

    def both_dev_sharded(self, width, dtype, mesh, t_pad, max_steps):
        """both_dev under shard_map over the engine mesh: events sharded on
        'ev' (replicated over 'mut'); same fill as single-device."""
        key = ("both_dev_sh", width, str(dtype), mesh, t_pad, max_steps)
        if key not in self._fns:
            from jax.sharding import PartitionSpec as PS

            from ...parallel.mesh import shard_map
            from .dp import EventBatch

            inner = self.both_dev(width, dtype)

            def both_dev_sharded(batch, states, i0, i1, is_pad, off):
                return inner(batch, states, i0, i1, is_pad, off,
                             t_pad=t_pad, max_steps=max_steps)

            ev, col_ev = PS("ev"), PS(None, "ev")
            bspec = EventBatch(*([ev] * len(EventBatch._fields)))
            f = shard_map(
                both_dev_sharded, mesh,
                in_specs=(bspec, col_ev, ev, ev, col_ev, PS()),
                out_specs=(col_ev, col_ev, col_ev, col_ev, col_ev, col_ev,
                           ev, ev),
            )
            self._fns[key] = jax.jit(f)
        return self._fns[key]

    def fwd_dev_sharded(self, width, dtype, mesh, t_pad, max_steps, n_like):
        """fwd_dev under shard_map over the engine mesh (events on 'ev')."""
        key = ("fwd_dev_sh", width, str(dtype), mesh, t_pad, max_steps,
               n_like)
        if key not in self._fns:
            from jax.sharding import PartitionSpec as PS

            from ...parallel.mesh import shard_map
            from .dp import EventBatch

            inner = self.fwd_dev(width, dtype)

            def fwd_dev_sharded(batch, states, i0, i1, is_pad, off):
                return inner(batch, states, i0, i1, is_pad, off,
                             t_pad=t_pad, max_steps=max_steps,
                             n_like=n_like)

            ev, col_ev = PS("ev"), PS(None, "ev")
            bspec = EventBatch(*([ev] * len(EventBatch._fields)))
            f = shard_map(
                fwd_dev_sharded, mesh,
                in_specs=(bspec, col_ev, ev, ev, col_ev, PS()),
                out_specs=(ev, ev, ev, ev),
            )
            self._fns[key] = jax.jit(f)
        return self._fns[key]


FUSED = FusedCache()
