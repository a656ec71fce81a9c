"""Multi-device sharding tests on the virtual CPU mesh."""

import numpy as np
import pytest

import jax


needs_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@needs_devices
@pytest.mark.slow   # ~6 min; `python __graft_entry__.py` runs the same
                    # dry run
def test_dryrun_multichip_8():
    import sys

    sys.path.insert(0, "/root/repo")
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(8)


@needs_devices
@pytest.mark.slow
@pytest.mark.parametrize("seed", [3, 9, 17])
def test_engine_mesh_consensus_matches_single_device(seed):
    """Full consensus (Mutate + viterbi candidates + Refine) through the
    PRODUCTION TpuEngine with a 4x2 mesh must reproduce the single-device
    engine's final sequence (same XLA fill per shard; psum'd mutation
    totals)."""
    import jax.numpy as jnp

    from poreseq_tpu.engine.tpu import TpuEngine
    from poreseq_tpu.parallel.mesh import make_mesh
    from poreseq_tpu.sim import simulate_session

    params = dict(realign_width=16, scoring_width=8, point_width=6, verbose=0)

    def run(mesh):
        pa, truth = simulate_session(
            np.random.default_rng(seed), ref_len=120, coverage=6,
            draft_error=0.04, backend="tpu", params=dict(params))
        pa._engine = TpuEngine(mesh=mesh)
        pa.Mutate(reps=2)
        pa.Mutate(seqs="viterbi", reps=1)
        pa.Refine()
        return pa.sequence

    seq1 = run(None)
    seq8 = run(make_mesh(n_ev=4, n_mut=2, devices=jax.devices()[:8]))
    assert seq1 == seq8


@needs_devices
def test_sharded_step_matches_single_device():
    """The psum-reduced mutation totals over a 4x2 (ev x mut) mesh must equal
    the single-shard computation."""
    import jax.numpy as jnp

    import sys

    sys.path.insert(0, "/root/repo")
    from __graft_entry__ import _tiny_inputs
    from poreseq_tpu.engine.tpu.pack import to_device_batch
    from poreseq_tpu.parallel.mesh import make_mesh, pad_axis, sharded_consensus_step

    rng = np.random.default_rng(1)
    t = _tiny_inputs(rng, coverage=8, n_muts=16)
    fi, gi = t["fi"], t["gi"]
    arrays = {k: pad_axis(np.asarray(v), 4, axis=0) for k, v in t["arrays"].items()}
    batch = to_device_batch(arrays, jnp.float32)

    def padE(x, axis=0):
        return jnp.asarray(np.ascontiguousarray(
            pad_axis(np.asarray(x), 4, axis=axis)))

    def padG(x):
        return jnp.asarray(pad_axis(np.asarray(x), 2, axis=0))

    common = (
        jnp.asarray(t["states_pad"]),
        padE(fi["i0"]), padE(fi["i1"]),
        tuple(padE(w) for w in fi["fwd"]["win0"]),
        tuple(padE(x, 1) for x in fi["fwd"]["refills"]),
        tuple(padE(w) for w in fi["bwd"]["win0"]),
        tuple(padE(x, 1) for x in fi["bwd"]["refills"]),
        jnp.asarray(fi["is_pad"]),
        padE(gi["i0r"]), padE(gi["i1r"]),
        jnp.zeros(len(arrays["n0"]), jnp.int32),
        padG(gi["g_start"]), padG(gi["g_startind"]),
        padG(gi["g_S"]), padG(gi["g_region"]), padG(gi["g_evoff"]),
        padG(gi["s_mlen"]), padG(gi["s_nst"]), padG(gi["s_win"]),
        padG(gi["s_valid"]),
        4.5,
    )

    mesh1 = make_mesh(n_ev=1, n_mut=1, devices=jax.devices()[:1])
    step1 = sharded_consensus_step(mesh1, t["width"], t["scoring_width"],
                                   gi["K"], gi["P"], gi["D"], jnp.float32)
    s1, tot1, acc1 = step1(batch, *common)

    mesh8 = make_mesh(n_ev=4, n_mut=2, devices=jax.devices()[:8])
    step8 = sharded_consensus_step(mesh8, t["width"], t["scoring_width"],
                                   gi["K"], gi["P"], gi["D"], jnp.float32)
    s8, tot8, acc8 = step8(batch, *common)

    np.testing.assert_allclose(np.asarray(s1), np.asarray(s8), atol=1e-5)
    np.testing.assert_allclose(np.asarray(tot1), np.asarray(tot8), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(acc1), np.asarray(acc8))


@needs_devices
@pytest.mark.slow
def test_engine_mesh_consensus_matches_single_device_production_widths():
    """Mesh==single-device consensus parity at the PRODUCTION band widths
    (defaults.conf realign 300 / scoring 100 / point 20) — the shapes real
    runs use, not toy bands.  Slow: full consensus twice on the virtual CPU
    mesh at width 300."""
    from poreseq_tpu.engine.tpu import TpuEngine
    from poreseq_tpu.parallel.mesh import make_mesh
    from poreseq_tpu.sim import simulate_session

    params = dict(realign_width=300, scoring_width=100, point_width=20,
                  verbose=0)

    def run(mesh):
        pa, truth = simulate_session(
            np.random.default_rng(23), ref_len=1000, coverage=6,
            draft_error=0.03, backend="tpu", params=dict(params))
        pa._engine = TpuEngine(mesh=mesh)
        pa.Mutate(reps=1)
        pa.Mutate(seqs="viterbi", reps=1)
        pa.Refine()
        return pa.sequence

    seq1 = run(None)
    seq8 = run(make_mesh(n_ev=4, n_mut=2, devices=jax.devices()[:8]))
    assert seq1 == seq8
