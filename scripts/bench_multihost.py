"""1 -> N process scaling efficiency of the jax.distributed CLI path.

BASELINE.md demands >=80% scaling efficiency from 1 to 2 hosts.  This
harness measures the closest available proxy: N coordinated jax.distributed
CPU processes (the exact code path a multi-host run takes — coordinator
init, round-robin region shard, per-process output shard) on a shared-nothing
region workload, vs the same workload in one process.

Efficiency = T1 / (N * TN).  The workload is region-data-parallel with zero
cross-process communication after init (SURVEY.md section 2.2), so the
measured loss is coordinator/init overhead plus shard imbalance.

Usage:  python scripts/bench_multihost.py [n_regions] [ref_len_per_region]
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main():
    import argparse

    from poreseq_tpu.sim import write_run

    ap = argparse.ArgumentParser()
    ap.add_argument("n_regions", type=int, nargs="?", default=8)
    ap.add_argument("region_len", type=int, nargs="?", default=250)
    ap.add_argument("--backend", default="exact", choices=["exact", "tpu"],
                    help="engine each process runs (tpu = the production "
                    "TpuEngine path on this host's devices)")
    ap.add_argument("--fake-work", type=float, default=None, metavar="S",
                    help="replace each region's compute with an S-second "
                    "sleep (PSQ_FAKE_MUTATE_S) so the efficiency number "
                    "isolates the distributed path from CPU contention")
    args = ap.parse_args()
    n_regions, rl = args.n_regions, args.region_len
    d = tempfile.mkdtemp(prefix="psqmh_")
    rng = np.random.default_rng(0)
    truth, draft, reads_dir, bam, fasta = write_run(
        d, rng, ref_len=n_regions * rl, n_reads=3 * n_regions,
        read_len=rl + 60, draft_error=0.02)
    conf = os.path.join(d, "params.conf")
    with open(conf, "w") as f:
        f.write("realign_width = 100\nscoring_width = 50\npoint_width = 12\n"
                "min_coverage = 0\nmax_coverage = 30\nmin_overlap = 50\n"
                "max_length = 10000\nlik_offset = 4.5\n")
    rf = os.path.join(d, "regions.txt")
    with open(rf, "w") as f:
        f.write("\n".join("synthref:{}:{}".format(r * rl, (r + 1) * rl)
                          for r in range(n_regions)) + "\n")

    base = [sys.executable, "-m", "poreseq_tpu.cli", "consensus",
            fasta, bam, reads_dir, "-R", rf, "-p", conf, "-i", "2",
            "--backend", args.backend]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if args.fake_work is not None:
        env["PSQ_FAKE_MUTATE_S"] = str(args.fake_work)

    def run_n(n):
        out = os.path.join(d, "out{}.fasta".format(n))
        t0 = time.perf_counter()
        if n == 1:
            subprocess.run(base + ["-o", out], env=env, check=True,
                           capture_output=True)
        else:
            port = free_port()
            procs = [subprocess.Popen(
                base + ["-o", out, "--coordinator",
                        "127.0.0.1:{}".format(port),
                        "--num-processes", str(n), "--process-id", str(i)],
                env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL) for i in range(n)]
            for p in procs:
                assert p.wait(timeout=3600) == 0
        return time.perf_counter() - t0

    t1 = run_n(1)
    t1 = min(t1, run_n(1))          # warm FS caches
    res = {"n_regions": n_regions, "region_len": rl, "t1_s": round(t1, 2)}
    for n in (2, 4):
        if n > os.cpu_count():
            continue
        tn = run_n(n)
        res["t{}_s".format(n)] = round(tn, 2)
        res["efficiency_1_to_{}".format(n)] = round(t1 / (n * tn), 3)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
