"""Multi-chip scaling: device mesh over (event, mutation-group) axes.

The reference's parallelism inventory (SURVEY.md 2.2) maps onto a device mesh as:
  * 'ev'  axis — data parallelism over event strands (the reference's
    "different events simultaneously", MakeMutations.cpp:20-22);
  * 'mut' axis — parallelism over candidate mutation groups (independent per
    mutation, MakeMutations.cpp:43-52);
  * regions are embarrassingly parallel across *processes/hosts* exactly like
    the reference's file-split cluster mode (split_fasta.py) — one region per
    jit program, so no cross-chip DP is ever needed (the band keeps each
    region's working set local).

Per-event log-likelihood deltas are reduced with psum over the mesh before
the (replicated, deterministic) greedy accept, so acceptance is identical on
every device — the multi-host reduction the north star prescribes.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def shard_map(f, mesh, in_specs, out_specs):
    # check_vma off: scan carries are zero-initialized inside the mapped
    # function, which the varying-axis checker would otherwise reject
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                         check_vma=False)


def make_mesh(n_ev: int | None = None, n_mut: int = 1, devices=None) -> Mesh:
    """Mesh over available devices with shape (ev, mut)."""
    devices = devices if devices is not None else jax.devices()
    if n_ev is None:
        n_ev = len(devices) // n_mut
    devs = np.array(devices[: n_ev * n_mut]).reshape(n_ev, n_mut)
    return Mesh(devs, ("ev", "mut"))


def pad_axis(x: np.ndarray, n: int, axis: int = 0, fill=0):
    """Pad axis length up to a multiple of n."""
    ln = x.shape[axis]
    rem = (-ln) % n
    if rem == 0:
        return x
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, rem)
    return np.pad(x, pads, constant_values=fill)


def batch_spec(batch):
    """PartitionSpec pytree for an EventBatch: every array is per-event,
    sharded on 'ev'."""
    from ..engine.tpu.dp import EventBatch

    return EventBatch(*([P("ev")] * len(batch)))


def sharded_consensus_step(mesh: Mesh, width: int, scoring_width: int,
                           K: int, Pslots: int, DM: int, dtype):
    """One scoring round, sharded: banded fwd+back fills (events sharded),
    grouped mutation deltas (events x groups sharded), psum over 'ev' into
    replicated mutation totals, and a deterministic accept mask.

    Returns a jitted step:
      step(batch, states, i0, i1, win0f, reff, win0b, refb, is_pad,
           i0r, i1r, wins, g_start, g_startind, s_mlen, s_nst, s_win,
           s_valid, lik_offset, S_real) -> (scores [E], totals [G, P], accept)
    """
    from ..engine.tpu.dp import make_fill
    from ..engine.tpu.mutscore import _group_kernel, build_windows

    fill = make_fill(width, dtype)
    fill_ns = make_fill(width, dtype, need_steps=False)
    RS = max(width - scoring_width, 0)
    Ws = 2 * scoring_width + 1
    kern = _group_kernel(2 * width + 1, Ws, RS, K, Pslots,
                         DM, dtype)

    def local_step(batch, states, i0, i1, win0f, reff, win0b, refb, is_pad,
                   i0r, i1r, ev_region, g_start, g_startind, g_S, g_region,
                   g_evoff, s_mlen, s_nst, s_win, s_valid, lik_offset):
        resf = fill(batch, states, i0, i1, win0f, reff, is_pad, lik_offset,
                    False)
        resb = fill_ns(batch, states, i0, i1, win0b, refb, is_pad, lik_offset,
                       True)
        zero_col = jnp.zeros((1,) + resf.M.shape[1:], resf.M.dtype)
        Mf = jnp.concatenate([zero_col, resf.M])
        Sf = jnp.concatenate([zero_col, resf.S])
        Mb = jnp.concatenate([zero_col, resb.M])
        Sb = jnp.concatenate([zero_col, resb.S])
        zrow = jnp.zeros((1, resf.M.shape[1]), resf.M.dtype)
        bpf = jnp.concatenate([zrow, resf.best_pfx])
        bpb = jnp.concatenate([zrow, resb.best_pfx])
        win_m, win_s, win_l = build_windows(batch.mean, batch.stdv,
                                            batch.lsr, i0r, Ws, dtype)
        part = kern(batch, Mf, Sf, Mb, Sb, i0, i1, i0r, i1r,
                    win_m, win_s, win_l, bpf, bpb,
                    ev_region, g_start, g_startind, g_S, g_region, g_evoff,
                    s_mlen, s_nst, s_win, s_valid, lik_offset)
        totals = jax.lax.psum(part, "ev")
        scores = jnp.maximum(resf.best, resb.best)
        accept = totals > 0
        return scores, totals, accept

    def step(batch, *args):
        bs = batch_spec(batch)
        wspec = (P("ev"),) * 3
        rspec = (P(None, "ev"),) * 3
        f = shard_map(
            local_step, mesh,
            in_specs=(
                bs,                       # batch: events sharded
                P(),                      # states replicated
                P("ev"), P("ev"),         # band geometry
                wspec, rspec, wspec, rspec,  # windows + refills (both dirs)
                P(),                      # is_pad
                P("ev"), P("ev"),         # scoring geometry
                P("ev"),                  # ev_region
                P("mut"), P("mut"),       # group scalars
                P("mut"), P("mut"),       # g_S, g_region
                P("mut"),                 # g_evoff
                P("mut"), P("mut"), P("mut"), P("mut"),  # slot arrays
                P(),
            ),
            out_specs=(P("ev"), P("mut"), P("mut")),
        )
        return f(batch, *args)

    return jax.jit(step)
