#!/usr/bin/env python3
"""Benchmark: end-to-end consensus throughput on one GPU.

Headline metric (the one the mission is graded on, BASELINE.md): 1 kb
regions per hour at 10X coverage through the FULL `poreseq consensus`
pipeline (--region-batch lockstep, i=4, realign_width=300) — the reference's
number is ~2 min per 1 kb region on a 2015 CPU (= 30 regions/hr,
/root/reference/README.md:102), so vs_baseline = value / 30.

The JSON line also carries secondary metrics in "extra": the dual banded-fill
DP rate (cells/s/chip; reference-implied baseline 1e7) and the Refine-scale
ScoreMutations kernel rate (mutation-event scores/s), plus mean accuracy.

Falls back to the DP-kernel-only metric if the e2e run fails (its synthetic
run is written as fast5, which needs h5py); the JSON line then carries the
failure as "e2e_error" in "extra".  Exits non-zero, printing no
metric, when JAX's default device is not a GPU.

Prints ONE json line: {"metric", "value", "unit", "vs_baseline", "device",
...}, the device as JAX reports it (platform, device_kind, count).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


def bench_e2e(deadline):
    """Full-pipeline consensus over R 1 kb regions at 10X; returns metrics."""
    import shutil
    import tempfile

    from poreseq_tpu import cli
    from poreseq_tpu.api import swalign
    from poreseq_tpu.io.fasta import read_fasta
    from poreseq_tpu.sim import write_run

    R, L, cov = 8, 1000, 10
    d = tempfile.mkdtemp(prefix="psqbench_")
    try:
        rng = np.random.default_rng(0)
        truth, draft, reads_dir, bam, fasta = write_run(
            d, rng, ref_len=R * L, n_reads=(cov // 2) * R, read_len=L + 200,
            draft_error=0.02)
        conf = os.path.join(d, "params.conf")
        with open(conf, "w") as f:
            f.write("realign_width = 300\nscoring_width = 100\n"
                    "point_width = 20\nmin_coverage = 0\nmax_coverage = 30\n"
                    "min_overlap = 300\nmax_length = 10000\n"
                    "lik_offset = 4.5\n")
        rf = os.path.join(d, "regions.txt")
        with open(rf, "w") as f:
            f.write("\n".join("synthref:{}:{}".format(r * L, (r + 1) * L)
                              for r in range(R)) + "\n")
        out = os.path.join(d, "out.fasta")

        def run_once():
            if os.path.exists(out):
                os.unlink(out)
            t0 = time.perf_counter()
            cli.main(["consensus", fasta, bam, reads_dir, "-R", rf,
                      "-p", conf, "-o", out, "-i", "4", "--backend", "tpu",
                      "--region-batch", str(R)])
            return time.perf_counter() - t0

        t1 = run_once()
        # steady-state reruns: the first run is compile-laden, so the
        # HEADLINE is the MEDIAN of up to 5 steady runs, with the best run
        # in extra
        steady = []
        while (len(steady) < 5
               and time.monotonic() + (min(steady) if steady else t1) * 1.2
               < deadline):
            steady.append(run_once())
        med = float(np.median(steady)) if steady else t1
        best = float(min(steady)) if steady else t1

        seqs = read_fasta(out)
        # regions are draft coordinates; widen the truth window so draft
        # indel drift doesn't push a region out of its scoring window
        accs = [swalign(seq,
                        truth[max(int(n.split(":")[1]) - 400, 0)
                              : int(n.split(":")[2]) + 400])[0]
                for n, seq in seqs.items()]
        n_out = len(seqs)
        return {
            "regions_per_hour": 3600.0 * n_out / med,
            "s_per_region": med / max(n_out, 1),
            "first_run_s": t1,
            "steady_run_best_s": best,
            "steady_run_median_s": med,
            "s_per_region_best": best / max(n_out, 1),
            "steady_runs_s": [round(t, 2) for t in steady],
            "n_regions": n_out,
            "mean_accuracy_pct": float(np.nanmean(accs)) if accs else 0.0,
        }
    finally:
        shutil.rmtree(d, ignore_errors=True)


def bench_refine_kernel():
    """Refine-scale ScoreMutations call (all 9/base point mutations of a 1 kb
    region, 20 events, point_width=20): mutation-event scores per second."""
    from poreseq_tpu.engine.driver import find_point_mutations
    from poreseq_tpu.engine.tpu import TpuEngine
    from poreseq_tpu.engine.types import AlignData
    from poreseq_tpu.sim import simulate_session

    rng = np.random.default_rng(3)
    pa, _ = simulate_session(rng, ref_len=1000, coverage=20)
    engine = TpuEngine()
    data = AlignData.from_session(pa)
    data.params.scoring_width = 20
    muts = find_point_mutations(data)
    engine.score_mutations(data, muts)          # compile + warm
    t0 = time.perf_counter()
    engine.score_mutations(data, muts)
    dt = time.perf_counter() - t0
    return {
        "refine_call_s": dt,
        "refine_mut_event_scores_per_s": len(muts) * len(data.events) / dt,
        "refine_n_muts": len(muts),
    }


def bench_fill_kernel():
    import jax
    import jax.numpy as jnp

    from poreseq_tpu.engine.tpu.dp import make_fill
    from poreseq_tpu.engine.tpu.pack import (
        fill_inputs, pack_events, round_up, to_device_batch,
    )
    from poreseq_tpu.engine.types import AlignData
    from poreseq_tpu.core.sequence import seq_to_states
    from poreseq_tpu.sim import simulate_session

    rng = np.random.default_rng(0)
    REF_LEN = 1000
    COVERAGE = 60  # 30 reads x 2 strands: the default max_coverage cap
                   # (/root/reference/defaults.conf:6); rates are
                   # coverage-independent so vs_baseline stays comparable
    WIDTH = 300    # realign_width

    pa, _ = simulate_session(rng, ref_len=REF_LEN, coverage=COVERAGE)
    data = AlignData.from_session(pa)
    states = seq_to_states(data.sequence)
    S = len(states)
    S_pad = round_up(S, 64)
    states_pad = np.full(S_pad, -1, dtype=np.int32)
    states_pad[:S] = states
    arrays, ref_indexes = pack_events(data.events)
    batch = to_device_batch(arrays, jnp.float32)

    fi = fill_inputs(arrays, ref_indexes, S, S_pad, WIDTH)
    i0 = jnp.asarray(fi["i0"])
    i1 = jnp.asarray(fi["i1"])
    is_pad = jnp.asarray(fi["is_pad"])
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    win0f = tuple(f32(w) for w in fi["fwd"]["win0"])
    reff = tuple(f32(x) for x in fi["fwd"]["refills"])
    win0b = tuple(f32(w) for w in fi["bwd"]["win0"])
    refb = tuple(f32(x) for x in fi["bwd"]["refills"])

    # actual DP cells: band rows per column, 2 lattices, both directions
    h0, h1 = fi["i0"], fi["i1"]
    cells = int(np.sum(np.maximum(h1[:, 1 : S + 1] - h0[:, 1 : S + 1] + 1, 0)) * 4)

    fill = make_fill(WIDTH, jnp.float32)
    fill_ns = make_fill(WIDTH, jnp.float32, need_steps=False)

    @jax.jit
    def dual(batch, sf):
        rf = fill(batch, sf, i0, i1, win0f, reff, is_pad, 4.5, False)
        rb = fill_ns(batch, sf, i0, i1, win0b, refb, is_pad, 4.5, True)
        return rf.M, rf.steps_m, rb.M

    args = (batch, jnp.asarray(states_pad))
    jax.block_until_ready(dual(*args))          # compile + warm
    # one call after another, each output dropped once it is ready, so only
    # one call's lattices are alive at a time
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        jax.block_until_ready(dual(*args))
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))

    cells_per_sec = cells / dt
    print(
        f"# fill wall time (median of 10) {dt*1000:.2f} ms for {cells/1e6:.1f}M cells "
        f"({COVERAGE} events x {REF_LEN} b region, width {WIDTH})",
        file=sys.stderr,
    )
    return {"dp_cells_per_s": float(cells_per_sec),
            "dp_vs_1e7_baseline": float(cells_per_sec / 1e7)}


def main():
    """Inner measurement: e2e headline + secondary kernel metrics."""
    deadline = time.monotonic() + float(os.environ.get("PSQ_BENCH_BUDGET_S",
                                                       2200))
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.stderr.write("# no GPU: default JAX device is {!r}\n".format(
            dev.platform))
        raise SystemExit(2)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    extra = {}
    e2e = None
    try:
        e2e = bench_e2e(deadline)
        extra.update(e2e)
    except Exception as e:  # report the kernel metric instead
        sys.stderr.write("# e2e bench failed: {}\n".format(e))
        extra["e2e_error"] = "{}: {}".format(type(e).__name__, e)

    for fn in (bench_refine_kernel, bench_fill_kernel):
        if time.monotonic() > deadline - 180:
            sys.stderr.write("# skipping {} (budget)\n".format(fn.__name__))
            continue
        try:
            extra.update(fn())
        except Exception as e:
            sys.stderr.write("# {} failed: {}\n".format(fn.__name__, e))

    if e2e is not None:
        print(json.dumps({
            "metric": "kb_regions_per_hour_10x_e2e",
            "value": round(e2e["regions_per_hour"], 2),
            "unit": "regions/hr",
            # reference: ~2 min per 1 kb region = 30 regions/hr
            "vs_baseline": round(e2e["regions_per_hour"] / 30.0, 2),
            "device": device,
            "extra": {k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in extra.items()},
        }))
    elif "dp_cells_per_s" in extra:
        print(json.dumps({
            "metric": "dp_cells_per_sec_per_chip",
            "value": extra["dp_cells_per_s"],
            "unit": "cells/s",
            "vs_baseline": extra["dp_vs_1e7_baseline"],
            "device": device,
            "extra": {k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in extra.items()},
        }))
    else:
        raise SystemExit(3)


def _outer():
    """Run the measurement in a subprocess with a deadline, so that a hung
    device reports a failure instead of nothing."""
    try:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--inner"],
            capture_output=True, text=True, timeout=2400)
    except subprocess.TimeoutExpired:
        sys.stderr.write("# bench timed out\n")
        raise SystemExit(3)
    sys.stderr.write(out.stderr[-2000:])
    line = None
    for ln in out.stdout.splitlines():
        if ln.startswith("{"):
            line = ln
    if out.returncode != 0 or line is None:
        sys.stderr.write("# bench failed (rc={})\n".format(out.returncode))
        raise SystemExit(out.returncode or 3)
    print(line)


if __name__ == "__main__":
    if "--inner" in sys.argv:
        main()
    else:
        _outer()
