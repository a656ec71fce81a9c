#!/usr/bin/env python3
"""BASELINE config 5 rehearsal: bacterial-scale consensus, sharded 2 ways.

The reference's largest published config is a ~4.65 Mb bacterial genome
corrected on a CPU cluster in "thousands of CPU-hours"
(/root/reference/README.md:102-104), distributed by manual region-file
splitting.  This harness rehearses that topology at a configurable scale
(default 500 kb, 10X):

    split into overlapping 2 kb regions (1 kb overlap)
      -> regions dealt ROUND-ROBIN over N shards (the multi-host deal;
         --shard-index/--num-shards, identical arithmetic to the
         --coordinator path)
      -> each shard runs `consensus --region-batch B` on the device
         (shards execute sequentially on one device here, and the
         extrapolated N-host wall = max shard wall;
         the coordinator protocol itself is exercised/validated by
         tests/test_distributed.py and scripts/bench_multihost.py)
      -> `poreseq merge` joins ALL shard outputs (interleaved regions —
         the merge must reassemble round-robin shards into one contig)
      -> accuracy vs truth over the corrected span.

--limit K processes only the first K regions per shard and extrapolates
full-genome throughput from the steady rate.

Usage: python scripts/bench_ecoli.py [--genome 500000] [--shards 2]
       [--limit 24] [--batch 8]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome", type=int, default=500000)
    ap.add_argument("--coverage", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--region-length", type=int, default=2000)
    ap.add_argument("--read-len", type=int, default=8000)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--limit", type=int, default=24,
                    help="regions per shard to actually run (0 = all)")
    ap.add_argument("--backend", default="tpu")
    ap.add_argument("--draft-error", type=float, default=0.02)
    ap.add_argument("--iterations", type=int, default=4)
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args()

    from poreseq_tpu import cli
    from poreseq_tpu.api import swalign
    from poreseq_tpu.io.fasta import read_fasta
    from poreseq_tpu.io.regions_io import split_regions
    from poreseq_tpu.sim import write_run

    d = tempfile.mkdtemp(prefix="psqecoli_")
    rng = np.random.default_rng(0)
    t0 = time.time()
    n_reads = max(args.coverage * args.genome // (2 * args.read_len), 4)
    truth, draft, reads_dir, bam, fasta = write_run(
        d, rng, ref_len=args.genome, n_reads=n_reads,
        read_len=args.read_len, draft_error=args.draft_error)
    sys.stderr.write("synthetic genome built in {:.1f}s ({} bp, {} reads)\n"
                     .format(time.time() - t0, args.genome, n_reads))

    conf = os.path.join(d, "params.conf")
    with open(conf, "w") as f:
        f.write("realign_width = 300\nscoring_width = 100\npoint_width = 20\n"
                "min_coverage = 0\nmax_coverage = 30\nmin_overlap = 300\n"
                "max_length = {}\nlik_offset = 4.5\n".format(
                    args.region_length))

    regions = split_regions(fasta, args.region_length)
    sys.stderr.write("{} overlapping regions of {} bp, {} shards\n".format(
        len(regions), args.region_length, args.shards))

    # limit regions while keeping the round-robin interleave contiguous in
    # genome order: the first shards*limit regions cover a prefix span
    n_run = (min(args.shards * args.limit, len(regions)) if args.limit
             else len(regions))
    rf = os.path.join(d, "regions.txt")
    with open(rf, "w") as f:
        f.write("\n".join(regions[:n_run]) + "\n")

    shard_walls = []
    outs = []
    for si in range(args.shards):
        out = os.path.join(d, "out.s{}.fasta".format(si))
        outs.append(out)
        t0 = time.time()
        cli.main(["consensus", fasta, bam, reads_dir, "-R", rf, "-p", conf,
                  "-o", out, "-i", str(args.iterations),
                  "--backend", args.backend,
                  "--region-batch", str(args.batch),
                  "--num-shards", str(args.shards),
                  "--shard-index", str(si)])
        shard_walls.append(time.time() - t0)
        sys.stderr.write("shard {}/{}: {:.1f}s, {} regions\n".format(
            si, args.shards, shard_walls[-1], len(read_fasta(out))))

    merged = os.path.join(d, "merged.fasta")
    cli.main(["merge", merged] + outs)
    mseqs = list(read_fasta(merged).values())
    # accuracy over the corrected prefix span (limited runs cover a prefix)
    span_end = min(n_run * (args.region_length // 2)
                   + args.region_length // 2, args.genome)
    acc = (swalign(max(mseqs, key=len), truth[:span_end + 400])[0]
           if mseqs else 0.0)

    n_done = sum(len(read_fasta(o)) for o in outs)
    # extrapolated N-host wall for the FULL genome: shards run concurrently
    # on real hardware, so wall = max over shards of (its share / its rate)
    rates = [len(read_fasta(o)) / w for o, w in zip(outs, shard_walls)]
    full_share = (len(regions) + args.shards - 1) // args.shards
    wall_full = max(full_share / r for r in rates if r > 0)
    mb_per_hr = args.genome / 1e6 / (wall_full / 3600.0)
    res = dict(
        genome_bp=args.genome, coverage=args.coverage,
        regions_total=len(regions), regions_run=n_done,
        shards=args.shards, batch=args.batch,
        shard_walls_s=[round(w, 1) for w in shard_walls],
        s_per_region=[round(w / max(len(read_fasta(o)), 1), 2)
                      for o, w in zip(outs, shard_walls)],
        merged_contigs=len(mseqs),
        merged_accuracy_pct=round(float(acc), 3),
        extrapolated_wall_h_full_genome=round(wall_full / 3600.0, 2),
        extrapolated_mb_per_hour=round(mb_per_hr, 3),
        note=("shards executed sequentially on one device; "
              "N-host wall extrapolated as max shard wall at full share"),
    )
    print(json.dumps(res))
    if not args.keep:
        import shutil

        shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    main()
