#!/usr/bin/env python3
"""Start-up proof of the consensus engine on the GPU.

    python chip_smoke.py                   # one card: device, parity, consensus
    python chip_smoke.py --profile [DIR]   # the same, plus one traced warm run
    python chip_smoke.py --four [mesh|shards]  # four cards (default: both)

One card (the default) runs three phases in this process, in order:

  device     fails at once unless JAX's default device is a GPU; prints the
             card (nvidia-smi name and power limit), the JAX version, the
             device memory limit, XLA_FLAGS, the compile-cache directory and
             the engine's blocking constants.
  parity     one 1 kb region at 20 strands with the production bands
             (realign 300 / scoring 100 / point 20): the device engine on the
             card against the exact C++ oracle on the host.  (a) float64:
             ScoreAlignments and every Refine point mutation to the CPU
             tests' bounds; (b) the production float32 engine on the same
             mutations: largest |delta| and sign disagreements; (c) the
             deterministic Viterbi candidate equals the oracle's.
  consensus  8 x 1 kb regions at 10X with the production bands, corrected
             in lockstep through pipeline.mutate_many, the call behind
             `poreseq consensus --region-batch 8 -i 4`, twice (cold, warm).
             The regions are simulated in memory (sim.simulate_session): the
             fast5 reader needs h5py, which the GPU host lacks.  This is an
             easier workload than bench.py's on-disk run (sim.write_run):
             every strand spans exactly its 1 kb region, each region has
             exactly 10 strands, and the seed alignments are the truth
             jittered, where bench.py tiles 1200-base reads over an 8 kb
             reference, trims their overhang and takes seeds from the BAM.

--profile traces one more warm run (poreseq_tpu.profiling, the tracing
path of `poreseq consensus --profile`) into DIR, or a new temporary
directory, and prints the device idle share and kernel time by program.

--four runs only the multi-device paths on the same consensus fixture and
compares each with a one-card run of it: `mesh` is the (ev x mut) engine
mesh over four cards in one process (`consensus --mesh 4`); `shards` is four
jax.distributed processes with one card each, whose outputs `poreseq merge`
joins.  Every run is a child process started after the previous one ends,
so one process holds each card.  `--four shards` is the cheaper call: its
programs are those of one card, which the persistent compile cache may
already hold; the mesh's are its own.

Any failed phase exits non-zero without the result line.  The last line of
a passing run is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

# the consensus fixture: 1 kb regions at 10X with the production bands
N_REGIONS, REGION_LEN, COVERAGE, DRAFT_ERROR = 8, 1000, 10, 0.02
ITERATIONS = 4
PARAMS = dict(realign_width=300, scoring_width=100, point_width=20,
              min_coverage=0, max_coverage=30, min_overlap=300,
              max_length=10000, lik_offset=4.5)
FIXTURE_SEED = 0
MIN_MEAN_ACCURACY = 99.5       # percent, against the truth sequence
FOUR_TOLERANCE_PP = 0.1        # per-region accuracy, multi-device vs one card

# parity region: one 1 kb region at 20 strands
PARITY_SEED, PARITY_COVERAGE = 1, 20
# (a) float64: tests/test_tpu_engine.py's bounds
F64_SCORE_ATOL, F64_LIKES_ATOL, F64_MUT_ATOL = 1e-9, 1e-8, 1e-8
# (b) float32: the device path has no matrix product (no TF32); it differs
# from the f64 oracle by f32 rounding, reassociated reductions and the GPU's
# log/exp.  A sign disagreement is tolerated only where the oracle's score is
# within F32_SIGN_TOL of zero: the CPU test's f32 bound
# (test_score_mutations_f32_sign_agreement), i.e. a near-tie that either
# decision serves.
F32_SIGN_TOL = 0.01


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def nvidia_smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return "nvidia-smi unavailable: {}".format(e)
    return out.stdout.strip() or out.stderr.strip()


def require_gpu():
    import jax

    dev = jax.devices()[0]
    check(dev.platform == "gpu",
          "default JAX device is {!r}, not a GPU".format(dev.platform))
    return dev


def device_summary():
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


# ---------------------------------------------------------------- fixtures


def make_regions():
    """[(name, session, truth, draft)]: fresh in-memory regions, the same on
    every call (the consensus mutates its sessions in place)."""
    from poreseq_tpu.sim import simulate_session

    rng = np.random.default_rng(FIXTURE_SEED)
    out = []
    for r in range(N_REGIONS):
        pa, truth = simulate_session(rng, ref_len=REGION_LEN,
                                     coverage=COVERAGE,
                                     draft_error=DRAFT_ERROR, backend="tpu",
                                     params=PARAMS)
        out.append(("synth{}:0:{}".format(r, REGION_LEN), pa, truth,
                    pa.sequence))
    return out


class CompileStats:
    """Counts, over a block, the programs built and those of them read from
    the persistent cache, and the seconds spent tracing, lowering, in the
    backend (compiling, or reading the cache) and reading the cache
    (jax.monitoring events)."""

    EVENTS = {"/jax/core/compile/jaxpr_trace_duration": "trace",
              "/jax/core/compile/jaxpr_to_mlir_module_duration": "lower",
              "/jax/core/compile/backend_compile_duration": "backend",
              "/jax/compilation_cache/cache_retrieval_time_sec": "cache read"}

    def __enter__(self):
        import jax

        self.secs = {v: 0.0 for v in self.EVENTS.values()}
        self.built = self.hits = 0
        jax.monitoring.register_event_duration_secs_listener(self._duration)
        jax.monitoring.register_event_listener(self._event)
        return self

    def __exit__(self, *exc):
        import jax

        jax.monitoring.unregister_event_duration_listener(self._duration)
        jax.monitoring.unregister_event_listener(self._event)
        return False

    def _duration(self, event, secs, **kw):
        if event in self.EVENTS:
            self.secs[self.EVENTS[event]] += secs
            self.built += self.EVENTS[event] == "backend"

    def _event(self, event, **kw):
        self.hits += event == "/jax/compilation_cache/cache_hits"

    def __str__(self):
        return "{} programs, {} read from the cache; {}".format(
            self.built, self.hits, ", ".join(
                "{} {:.1f} s".format(k, v) for k, v in self.secs.items()))


def run_consensus(regions, engine=None, label=None):
    """Lockstep consensus of every region through pipeline.mutate_many (the
    CLI's --region-batch path).  Returns ({name: sequence}, wall seconds);
    with a label, also prints what compiling took during the run."""
    from poreseq_tpu.pipeline import mutate_many

    for _, pa, _, _ in regions:
        pa._engine = engine
    names = [r[0] for r in regions]
    t0 = time.perf_counter()
    with CompileStats() as stats:
        results = mutate_many(None, None, None, names, params=PARAMS,
                              reps=ITERATIONS, backend="tpu",
                              loaded=[(r[1], None) for r in regions])
    wall = time.perf_counter() - t0
    if label:
        print("{}: {}".format(label, stats), flush=True)
    check(all(r is not None for r in results),
          "{} of {} regions came out".format(
              sum(r is not None for r in results), len(names)))
    return {n: r[0] for n, r in zip(names, results)}, wall


# ---------------------------------------------------------------- phases


def phase_device():
    import jax

    dev = require_gpu()
    from poreseq_tpu.engine.tpu import TpuEngine
    from poreseq_tpu.engine.tpu.mutscore import _resolve_gb
    from poreseq_tpu.jaxcache import enable_compilation_cache

    enable_compilation_cache()
    print("card: {}".format(nvidia_smi()))
    print("jax {}, device_kind {!r}, {} device(s), bytes_limit {}".format(
        jax.__version__, dev.device_kind, len(jax.devices()),
        (dev.memory_stats() or {}).get("bytes_limit")))
    print("XLA_FLAGS={!r}".format(os.environ.get("XLA_FLAGS", "")))
    print("compile cache: {}".format(jax.config.jax_compilation_cache_dir))
    print("engine constants: wave_rows {}, group block GB {} (Refine) / {} "
          "(Mutate), event rows padded to >=64, group event slice 32".format(
              TpuEngine.wave_rows, _resolve_gb(41, 7), _resolve_gb(201, 16)))


def phase_parity():
    import jax
    import jax.numpy as jnp

    from poreseq_tpu.engine.driver import find_point_mutations
    from poreseq_tpu.engine.exact import ExactEngine
    from poreseq_tpu.engine.tpu import TpuEngine
    from poreseq_tpu.engine.tpu.viterbi import viterbi_mutate_tpu
    from poreseq_tpu.engine.types import AlignData
    from poreseq_tpu.sim import simulate_session

    pa, _ = simulate_session(np.random.default_rng(PARITY_SEED),
                             ref_len=REGION_LEN, coverage=PARITY_COVERAGE,
                             draft_error=DRAFT_ERROR, backend="tpu",
                             params=PARAMS)
    exact = ExactEngine()

    def point_data():
        d = AlignData.from_session(pa)
        d.params.scoring_width = PARAMS["point_width"]   # Refine's band
        return d

    muts = find_point_mutations(point_data())
    oracle = np.array([m.score for m in exact.score_mutations(point_data(),
                                                              muts)])

    # (a) float64 on the card vs the oracle
    jax.config.update("jax_enable_x64", True)
    try:
        eng64 = TpuEngine(dtype=jnp.float64)
        dE, dT = AlignData.from_session(pa), AlignData.from_session(pa)
        lE, lT = np.zeros(len(pa.sequence)), np.zeros(len(pa.sequence))
        sE = np.array(exact.score_alignments(dE, likes=lE))
        sT = np.array(eng64.score_alignments(dT, likes=lT))
        eng64.flush_ref_likes()
        d_score = float(np.max(np.abs(sE - sT)))
        d_likes = float(np.max(np.abs(lE - lT)))
        same_align = all(np.array_equal(a.ref_align, b.ref_align)
                         for a, b in zip(dE.events, dT.events))
        m64 = np.array([m.score
                        for m in eng64.score_mutations(point_data(), muts)])
        d_mut64 = float(np.max(np.abs(m64 - oracle)))
    finally:
        jax.config.update("jax_enable_x64", False)
    print("(a) f64: {} strands, {} mutations; max|d| scores {:.3e} (<= {}), "
          "likes {:.3e} (<= {}), mutations {:.3e} (<= {}); ref_align "
          "identical: {}".format(len(pa.events), len(muts), d_score,
                                 F64_SCORE_ATOL, d_likes, F64_LIKES_ATOL,
                                 d_mut64, F64_MUT_ATOL, same_align))
    check(d_score <= F64_SCORE_ATOL, "f64 alignment scores off")
    check(d_likes <= F64_LIKES_ATOL, "f64 likes off")
    check(same_align, "f64 ref_align differs from the oracle")
    check(d_mut64 <= F64_MUT_ATOL, "f64 mutation scores off")

    # (b) production float32 on the same mutations
    m32 = np.array([m.score for m in TpuEngine().score_mutations(
        point_data(), muts)])
    diff = np.abs(m32 - oracle)
    flips = (m32 > 0) != (oracle > 0)
    hard = flips & (np.abs(oracle) > F32_SIGN_TOL)
    worst = int(np.argmax(diff))
    print("(b) f32: max|d| {:.4g} (mutation at {}, oracle {:.4g}); {} with "
          "|d| > {}; sign disagreements {} ({} where |oracle| > {})".format(
              diff[worst], muts[worst].start, oracle[worst],
              int(np.sum(diff > F32_SIGN_TOL)), F32_SIGN_TOL,
              int(np.sum(flips)), int(np.sum(hard)), F32_SIGN_TOL))
    check(not hard.any(), "f32 accept decision differs from the oracle")

    # (c) deterministic Viterbi candidate
    se = exact.viterbi_mutate(AlignData.from_session(pa).events, 0, 0.05,
                              0.01, 0.33, 0.75)
    st = viterbi_mutate_tpu(pa.events, 0, 0.05, 0.01, 0.33, 0.75)
    print("(c) Viterbi (nkeep=0): {} bases, equal to the oracle: {}".format(
        len(st[0]) if st else 0, st == se))
    check(st == se, "deterministic Viterbi candidate differs")


def check_consensus(seqs, regions, label):
    """Every region out, mean accuracy against the truth at least
    MIN_MEAN_ACCURACY, and no region less accurate than its draft."""
    from poreseq_tpu.api import swalign

    accs, worse = [], []
    for name, _, truth, draft in regions:
        check(name in seqs, "{}: {} missing".format(label, name))
        acc, draft_acc = swalign(seqs[name], truth)[0], swalign(draft,
                                                                truth)[0]
        accs.append(acc)
        if acc < draft_acc:
            worse.append((name, draft_acc, acc))
    mean = float(np.mean(accs))
    print("{}: {}/{} regions, mean accuracy {:.3f}% (>= {}), min {:.3f}%"
          .format(label, len(seqs), len(regions), mean, MIN_MEAN_ACCURACY,
                  min(accs)))
    check(mean >= MIN_MEAN_ACCURACY, "mean accuracy below the bound")
    check(not worse, "regions less accurate than their draft: {}".format(
        worse))


def phase_consensus(profile=None):
    import jax

    outs = []
    for label in ("cold", "warm"):
        regions = make_regions()
        seqs, wall = run_consensus(regions, label=label)
        outs.append(seqs)
        check_consensus(seqs, regions, label)
        print("{} run: {:.2f} s, {:.3f} s/region".format(
            label, wall, wall / len(regions)))
    same = outs[0] == outs[1]
    print("cold and warm FASTA identical: {}{}".format(
        same, "" if same else " (differing regions: {})".format(
            [n for n in outs[0] if outs[0][n] != outs[1].get(n)])))
    print("peak device memory: {} bytes".format(
        (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")))
    if profile:
        traced_run(profile if isinstance(profile, str) else None)


def traced_run(profile_dir):
    """One more warm run under the JAX profiler; prints the device idle
    share and where the kernel time went."""
    import jax

    from poreseq_tpu.profiling import summarize, trace

    regions = make_regions()
    with trace(profile_dir or None) as tr:
        with jax.profiler.TraceAnnotation("psq_consensus"):
            _, wall = run_consensus(regions)
    print("traced warm run: {:.2f} s, trace {}".format(wall, tr.path))
    check(tr.path, "no trace written")
    summarize(tr.path, window="psq_consensus")


# ---------------------------------------------------------------- four cards


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def worker_single(outdir):
    """The one-card reference: the consensus fixture on one card."""
    from poreseq_tpu.io.fasta import write_fasta

    require_gpu()
    seqs, wall = run_consensus(make_regions(), label="one card")
    write_fasta(os.path.join(outdir, "single.fasta"), seqs)
    print("one card: {:.2f} s".format(wall), flush=True)


def worker_mesh(outdir):
    """One process on all four cards: the fixture through the engine mesh
    (`--mesh 4`)."""
    import jax

    require_gpu()
    check(len(jax.devices()) >= 4, "needs 4 GPUs, found {}".format(
        len(jax.devices())))
    from poreseq_tpu.engine.tpu import TpuEngine
    from poreseq_tpu.io.fasta import write_fasta

    os.environ["PSQ_MESH"] = "4"        # what `consensus --mesh 4` sets
    eng = TpuEngine()
    check(eng.mesh is not None and eng.mesh.size == 4, "no 4-device mesh")
    seqs, wall = run_consensus(make_regions(), engine=eng, label="mesh 4")
    print("mesh 4 (cold): {:.2f} s".format(wall), flush=True)
    write_fasta(os.path.join(outdir, "mesh.fasta"), seqs)


def worker_shard(outdir, port, pid, nproc):
    """One of `nproc` coordinated processes, one card each: its round-robin
    share of the regions, written to out.fasta.p<pid> as the CLI does."""
    import jax

    from poreseq_tpu.io.fasta import write_fasta
    from poreseq_tpu.parallel.distributed import (init_multihost,
                                                  shard_regions)

    pid, nproc = init_multihost("localhost:{}".format(port), nproc, pid)
    require_gpu()
    check(len(jax.local_devices()) == 1, "process sees {} cards".format(
        len(jax.local_devices())))
    regions = make_regions()
    mine = set(shard_regions([r[0] for r in regions], pid, nproc))
    seqs, wall = run_consensus([r for r in regions if r[0] in mine],
                               label="process {}".format(pid))
    write_fasta(os.path.join(outdir, "out.fasta.p{}".format(pid)), seqs)
    print("process {}/{} on {} ({} global devices): {} regions, {:.2f} s"
          .format(pid, nproc, jax.local_devices()[0], len(jax.devices()),
                  len(seqs), wall))


def compare(ref, other, regions, label):
    """Same FASTA, or every differing region within FOUR_TOLERANCE_PP."""
    from poreseq_tpu.api import swalign

    truth = {r[0].split(":")[0]: r[2] for r in regions}
    check(set(ref) == set(other), "{}: region sets differ".format(label))
    differ = []
    for name in sorted(ref):
        if ref[name] != other[name]:
            a = swalign(ref[name], truth[name])[0]
            b = swalign(other[name], truth[name])[0]
            differ.append((name, a, b))
    print("{} vs one card: {} of {} regions identical".format(
        label, len(ref) - len(differ), len(ref)))
    for name, a, b in differ:
        print("  {}: one card {:.3f}%, {} {:.3f}%".format(name, a, label, b))
    check(all(abs(a - b) <= FOUR_TOLERANCE_PP for _, a, b in differ),
          "{} differs from one card by more than {} pp".format(
              label, FOUR_TOLERANCE_PP))


def run_children(cmds, timeout):
    """Start the commands together and wait for all; kills the rest if one
    fails or the time runs out."""
    procs = [subprocess.Popen(cmd, env=env) for cmd, env in cmds]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            rc = p.wait(timeout=max(deadline - time.monotonic(), 1))
            check(rc == 0, "child {} exited {}".format(p.args[2:], rc))
    except subprocess.TimeoutExpired as e:
        raise PhaseError("child {} timed out".format(e.cmd[2:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def main_four(paths=("mesh", "shards")):
    """Multi-device paths, each compared with the one-card reference.  The
    runs are child processes started one after another, one process per
    card; the parent stays off the cards until the last has exited."""
    from poreseq_tpu.cli import main as cli_main
    from poreseq_tpu.io.fasta import read_fasta

    me = [sys.executable, os.path.abspath(__file__)]
    env = dict(os.environ)
    with tempfile.TemporaryDirectory(prefix="psq_four_") as d:
        def by_ref(name):      # merge names its records by reference
            return {k.split(":")[0]: v for k, v in read_fasta(
                os.path.join(d, name)).items()}

        t0 = time.perf_counter()
        run_children([(me + ["--worker", "single", "--outdir", d],
                       dict(env, CUDA_VISIBLE_DEVICES="0"))], 1200)
        print("phase one card: ok ({:.1f} s)".format(
            time.perf_counter() - t0), flush=True)
        regions = make_regions()
        ref = by_ref("single.fasta")

        if "shards" in paths:
            t0 = time.perf_counter()
            port = _free_port()
            run_children([(me + ["--worker", "shard", "--outdir", d,
                                 "--port", str(port), "--pid", str(i)],
                           dict(env, CUDA_VISIBLE_DEVICES=str(i)))
                          for i in range(4)], 1200)
            parts = sorted(glob.glob(os.path.join(d, "out.fasta.p*")))
            check(len(parts) == 4, "{} shard outputs".format(len(parts)))
            merged = os.path.join(d, "merged.fasta")
            cli_main(["merge", merged] + parts)
            compare(ref, by_ref("merged.fasta"), regions, "4 processes")
            print("phase shards: ok ({:.1f} s)".format(
                time.perf_counter() - t0), flush=True)

        if "mesh" in paths:
            t0 = time.perf_counter()
            run_children([(me + ["--worker", "mesh", "--outdir", d], env)],
                         1200)
            compare(ref, by_ref("mesh.fasta"), regions, "mesh 4")
            print("phase mesh: ok ({:.1f} s)".format(
                time.perf_counter() - t0), flush=True)
    require_gpu()
    print("card: {}".format(nvidia_smi()))
    return device_summary()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", nargs="?", const="both",
                    choices=("mesh", "shards", "both"),
                    help="run only the four-card paths: the engine mesh, "
                    "the four coordinated processes, or both (default)")
    ap.add_argument("--profile", nargs="?", const=True, metavar="DIR",
                    help="also trace one warm consensus run (into DIR, "
                    "else a new temporary directory)")
    ap.add_argument("--worker", choices=("single", "mesh", "shard"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--outdir", help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--pid", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()

    try:
        if args.worker == "single":
            worker_single(args.outdir)
            return 0
        if args.worker == "mesh":
            worker_mesh(args.outdir)
            return 0
        if args.worker == "shard":
            worker_shard(args.outdir, args.port, args.pid, 4)
            return 0
        if args.four:
            device = main_four(("mesh", "shards") if args.four == "both"
                               else (args.four,))
        else:
            for name, fn in (("device", phase_device),
                             ("parity", phase_parity),
                             ("consensus",
                              lambda: phase_consensus(args.profile))):
                t0 = time.perf_counter()
                fn()
                print("phase {}: ok ({:.1f} s)".format(
                    name, time.perf_counter() - t0), flush=True)
            device = device_summary()
    except PhaseError as e:
        print("FAILED: {}".format(e), flush=True)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
