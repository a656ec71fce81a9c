"""Multi-host execution: jax.distributed-coordinated CLI runs.

The reference's cluster mode is manual .region-file splitting across jobs
(/root/reference/README.md:48-62).  This repo's equivalent initializes
jax.distributed from --coordinator/--num-processes/--process-id, deals
regions round-robin across processes, and writes per-process OUTPUT.pN
shards (poreseq_tpu/cli.py, parallel/distributed.py).  This test runs a REAL
2-process jax.distributed job on CPU and asserts the sharded outputs union
to exactly the single-process run's output.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REGIONS = ["synthref:0:200", "synthref:200:400", "synthref:400:600"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from poreseq_tpu.sim import write_run

    d = str(tmp_path_factory.mktemp("distrun"))
    rng = np.random.default_rng(11)
    truth, draft, reads_dir, bam, fasta = write_run(
        d, rng, ref_len=600, n_reads=9, read_len=260, draft_error=0.02)
    conf = os.path.join(d, "params.conf")
    with open(conf, "w") as f:
        f.write("realign_width = 100\nscoring_width = 50\npoint_width = 12\n"
                "min_coverage = 0\nmax_coverage = 30\nmin_overlap = 50\n"
                "max_length = 10000\nlik_offset = 4.5\n")
    rf = os.path.join(d, "regions.txt")
    with open(rf, "w") as f:
        f.write("\n".join(REGIONS) + "\n")
    return dict(dir=d, reads=reads_dir, bam=bam, fasta=fasta, conf=conf,
                regions=rf, truth=truth)


def _cli_args(run, out):
    return ["consensus", run["fasta"], run["bam"], run["reads"],
            "-R", run["regions"], "-p", run["conf"], "-o", out, "-i", "1",
            "--backend", "exact"]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_distributed_matches_single(run, tmp_path):
    from poreseq_tpu import cli
    from poreseq_tpu.io.fasta import read_fasta

    single = str(tmp_path / "single.fasta")
    cli.main(_cli_args(run, single))
    exp = read_fasta(single)
    assert len(exp) == len(REGIONS)

    multi = str(tmp_path / "multi.fasta")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "poreseq_tpu.cli"]
            + _cli_args(run, multi)
            + ["--coordinator", "127.0.0.1:{}".format(port),
               "--num-processes", "2", "--process-id", str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = [p.communicate(timeout=900) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]

    # round-robin shard: p0 gets regions 0 and 2, p1 gets region 1
    got0 = read_fasta(multi + ".p0")
    got1 = read_fasta(multi + ".p1")
    assert set(got0) == {REGIONS[0], REGIONS[2]}
    assert set(got1) == {REGIONS[1]}
    merged = dict(got0)
    merged.update(got1)
    assert merged == exp


@pytest.mark.slow
def test_two_process_distributed_tpu_engine(run, tmp_path):
    """The coordinator + TpuEngine combination (the production multi-host
    configuration): 2 jax.distributed processes each running the device engine
    path on their local CPU device must shard and union exactly like the
    exact-backend run."""
    from poreseq_tpu import cli
    from poreseq_tpu.io.fasta import read_fasta

    def tpu_args(out):
        a = _cli_args(run, out)
        a[a.index("exact")] = "tpu"
        return a

    single = str(tmp_path / "single_tpu.fasta")
    cli.main(tpu_args(single))
    exp = read_fasta(single)
    assert len(exp) == len(REGIONS)

    multi = str(tmp_path / "multi_tpu.fasta")
    port = _free_port()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "poreseq_tpu.cli"]
            + tpu_args(multi)
            + ["--coordinator", "127.0.0.1:{}".format(port),
               "--num-processes", "2", "--process-id", str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = [p.communicate(timeout=1800) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]

    got0 = read_fasta(multi + ".p0")
    got1 = read_fasta(multi + ".p1")
    assert set(got0) == {REGIONS[0], REGIONS[2]}
    assert set(got1) == {REGIONS[1]}
    merged = dict(got0)
    merged.update(got1)
    assert merged == exp


@pytest.mark.slow
def test_two_process_distributed_train(run, tmp_path, monkeypatch):
    """Multi-host `train`: 2 coordinated processes each evaluate half the
    candidate proposals; the allgathered argmax must pick the same best
    params as a single-process run with the same deterministic seeding."""
    from poreseq_tpu.core.params import load_params

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()

    # vary_params proposes over the strand-suffixed transition keys
    # (Params.py:50-57) — the shared fixture conf has none, so extend it
    tconf = str(tmp_path / "train.conf")
    with open(tconf, "w") as f:
        f.write(open(run["conf"]).read())
        f.write("skip_t = 0.141\nskip_c = 0.088\nstay_t = 0.043\n"
                "stay_c = 0.057\nextend_t = 0.072\nextend_c = 0.046\n"
                "insert_t = 0.020\ninsert_c = 0.025\n")

    def train_args():
        return [sys.executable, "-m", "poreseq_tpu.cli", "train",
                run["fasta"], run["bam"], run["reads"],
                "-p", tconf, "-r", REGIONS[0], "-i", "1", "-n", "1",
                "--backend", "exact"]

    d2 = str(tmp_path / "two")
    os.makedirs(d2)
    procs = [subprocess.Popen(
        train_args() + ["--coordinator", "127.0.0.1:{}".format(port),
                        "--num-processes", "2", "--process-id", str(pid)],
        env=env, cwd=d2, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(2)]
    outs = [p.communicate(timeout=1800) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
    best2 = load_params(os.path.join(d2, "train_best.conf"))
    assert best2  # a best-params checkpoint was written by the sharded run
    # both processes agreed on the (replicated) winner: identical best lines
    lines = [[l for l in se.splitlines() if l.startswith("Best at iter 1")]
             for _, se in outs]
    assert lines[0] and lines[0] == lines[1]


def test_shard_regions_round_robin():
    from poreseq_tpu.parallel.distributed import shard_regions

    rs = ["a", "b", "c", "d", "e"]
    assert shard_regions(rs, 0, 2) == ["a", "c", "e"]
    assert shard_regions(rs, 1, 2) == ["b", "d"]
    # explicit args bypass jax.process_index entirely
    assert shard_regions(rs, 0, 1) == rs
