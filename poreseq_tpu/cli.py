"""poreseq-compatible command line interface.

Mirrors /root/reference/poreseq/cmdline.py: subcommands consensus, variant,
train, split, merge, extract with identical flags and output formats, plus a
--backend flag selecting the compute engine (exact CPU oracle vs the JAX
device engine, named `tpu`).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from multiprocessing import Pool

import numpy as np

from .core.params import load_params, save_params, vary_params
from .core.regions import MutationInfo, RegionInfo
from .io.regions_io import extract_fasta, merge_fasta, split_fasta, split_regions
from .pipeline import mutate, variant as variant_fn


def main(argv=None):
    parser = argparse.ArgumentParser(prog="poreseq")
    subparsers = parser.add_subparsers(help="Nanopore sequence consensus tool")

    parse_cons = subparsers.add_parser(
        "consensus", help="run consensus algorithm using alignment")
    parse_cons.add_argument("ref", help="reference fasta file")
    parse_cons.add_argument("bam", help="input BAM file")
    parse_cons.add_argument("dir", help="root fast5 directory")
    group = parse_cons.add_mutually_exclusive_group(required=False)
    group.add_argument("-r", "--region", default=None,
                       help="region to correct (eg. 1000:3000 or header_name:1000:3000)")
    group.add_argument("-R", "--region-file", default=None,
                       help="file containing region strings, one per line")
    parse_cons.add_argument("-i", "--iterations", type=int, default=4,
                            help="how many iterations to run")
    parse_cons.add_argument("-p", "--params", default=None,
                            help="parameter file to use")
    parse_cons.add_argument("-v", "--verbose", action="count", default=0,
                            help="output verbosity (0-2)")
    parse_cons.add_argument("-o", "--output", default=None,
                            help="output fasta file")
    parse_cons.add_argument("-T", "--test", action="store_true", default=False,
                            help="test mode: seed with loaded sequence, output score as well")
    parse_cons.add_argument("--backend", default="exact",
                            choices=["exact", "tpu"],
                            help="compute backend")
    parse_cons.add_argument("--resume", action="store_true", default=False,
                            help="skip regions already present in the output fasta")
    parse_cons.add_argument("--shard-index", type=int, default=0,
                            help="this worker's index for multi-host region sharding")
    parse_cons.add_argument("--num-shards", type=int, default=1,
                            help="total workers; regions are dealt round-robin")
    parse_cons.add_argument("--region-batch", type=int, default=1,
                            help="process this many regions per device "
                            "program (lockstep cross-region batching; "
                            "tpu backend)")
    parse_cons.add_argument("--profile", default=None, metavar="DIR",
                            help="write a JAX profiler trace of the run to "
                            "DIR (view with tensorboard/xprof)")
    parse_cons.add_argument("--mesh", default=None, metavar="EVxMUT",
                            help="multi-chip device mesh for the tpu backend"
                            " (e.g. '8' or '4x2'; 'auto' = all devices on"
                            " the event axis)")
    parse_cons.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                            help="jax.distributed coordinator address for "
                            "multi-host runs (or set PSQ_COORDINATOR); "
                            "regions are dealt round-robin across processes "
                            "and each process writes OUTPUT.pN")
    parse_cons.add_argument("--num-processes", type=int, default=None,
                            help="total processes in the multi-host run")
    parse_cons.add_argument("--process-id", type=int, default=None,
                            help="this process's index in the multi-host run")
    parse_cons.set_defaults(func=consensus)

    parse_var = subparsers.add_parser("variant", help="call sequence variants")
    parse_var.add_argument("ref", help="reference fasta file")
    parse_var.add_argument("bam", help="input BAM file")
    parse_var.add_argument("dir", help="root fast5 directory")
    group = parse_var.add_mutually_exclusive_group(required=True)
    group.add_argument("-f", "--fasta", default=None,
                       help="fasta of variant sequences to test")
    group.add_argument("-m", "--mut-file", default=None,
                       help="file with mutations to test")
    group.add_argument("-a", "--all", action="store_true", default=False,
                       help="test all single-base mutations")
    group = parse_var.add_mutually_exclusive_group(required=False)
    group.add_argument("-r", "--region", default=None)
    group.add_argument("-R", "--region-file", default=None)
    parse_var.add_argument("-p", "--params", default=None)
    parse_var.add_argument("-v", "--verbose", action="count", default=0)
    parse_var.add_argument("--backend", default="exact",
                           choices=["exact", "tpu"])
    _add_multihost_args(parse_var)
    parse_var.set_defaults(func=variant)

    parse_train = subparsers.add_parser(
        "train", help="train model parameters on data")
    parse_train.add_argument("ref")
    parse_train.add_argument("bam")
    parse_train.add_argument("dir")
    parse_train.add_argument("-i", "--iter", type=int, default=30)
    parse_train.add_argument("-n", "--threads", type=int, default=4)
    parse_train.add_argument("-p", "--params", default=None)
    parse_train.add_argument("-r", "--region", default=None)
    parse_train.add_argument("-d", "--descend", action="store_true", default=False,
                             help="Run consensus by descending from reference")
    parse_train.add_argument("--backend", default="exact",
                             choices=["exact", "tpu"])
    _add_multihost_args(parse_train)
    parse_train.set_defaults(func=train)

    parse_split = subparsers.add_parser("split", help="split fasta files into chunks")
    parse_split.add_argument("fasta")
    parse_split.add_argument("-R", "--region-length", type=int, default=None)
    group = parse_split.add_mutually_exclusive_group(required=True)
    group.add_argument("-n", "--num-files", type=int, default=None)
    group.add_argument("-m", "--per-file", type=int, default=None)
    parse_split.set_defaults(func=split)

    parse_merge = subparsers.add_parser("merge", help="merge corrected fasta files")
    parse_merge.add_argument("fasta_out")
    parse_merge.add_argument("fasta_in", nargs="+")
    parse_merge.set_defaults(func=merge)

    parse_ext = subparsers.add_parser("extract", help="extract fasta from fast5")
    parse_ext.add_argument("dirs", nargs="+")
    parse_ext.add_argument("fasta")
    parse_ext.add_argument("-p", "--path", action="store_true", default=False)
    parse_ext.set_defaults(func=extract)

    args = parser.parse_args(argv)
    if not hasattr(args, "func"):
        parser.print_help()
        return
    args.func(args)


def _add_multihost_args(p):
    """jax.distributed flags shared by the per-region subcommands (consensus
    declares its own copies inline with subcommand-specific help)."""
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="jax.distributed coordinator address for multi-host "
                   "runs (or set PSQ_COORDINATOR)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total processes in the multi-host run")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's index in the multi-host run")


def parse_regions(args):
    """Region resolution (cmdline.py:127-165)."""
    regions = []
    if getattr(args, "region_file", None) is not None:
        if os.path.isfile(args.region_file):
            regions += [x.strip() for x in open(args.region_file).readlines()]
    reginfo = RegionInfo(args.region)
    if reginfo.start is not None:
        regions.append(args.region)
    if regions == []:
        if "max_length" in args.params:
            regions = split_regions(args.ref, args.params["max_length"],
                                    userefs=args.region)
        else:
            regions = split_regions(args.ref, 10000, userefs=args.region)
    return regions


def consensus(args):
    if getattr(args, "profile", None):
        # profiler trace of the whole run (the reference has no tracing at
        # all, SURVEY.md section 5.1); works for both backends — exact runs
        # appear as host activity only
        from .profiling import trace

        with trace(args.profile) as tr:
            _consensus(args)
        sys.stderr.write("profile trace: {}\n".format(tr.path))
        return
    _consensus(args)


def _consensus(args):
    if getattr(args, "mesh", None):
        # resolved when the engine is first created (engine/tpu/_mesh_from_env)
        os.environ["PSQ_MESH"] = args.mesh
    args.params = load_params(args.params)
    args.params["verbose"] = args.verbose
    regions = parse_regions(args)

    # multi-host execution (jax.distributed): initialized when a coordinator
    # is given (--coordinator / PSQ_COORDINATOR) — each process corrects a
    # round-robin region shard and writes OUTPUT.pN; `poreseq merge` joins
    # them, replacing the reference's manual cluster .region-file mode
    # (/root/reference/README.md:48-62)
    from .parallel.distributed import init_multihost, shard_regions

    pid, nproc = init_multihost(getattr(args, "coordinator", None),
                                getattr(args, "num_processes", None),
                                getattr(args, "process_id", None))
    if nproc > 1:
        regions = shard_regions(regions, pid, nproc)
        if args.output is not None:
            args.output = "{}.p{}".format(args.output, pid)
        sys.stderr.write("Process {}/{}: {} regions -> {}\n".format(
            pid, nproc, len(regions), args.output or "stdout"))

    # single-host manual sharding: the same topology without a coordinator
    # (workers launched independently with --shard-index/--num-shards)
    if args.num_shards > 1:
        regions = regions[args.shard_index :: args.num_shards]

    # region-granular resume: output is flushed after every region, so a
    # killed job loses at most one region (SURVEY.md section 5.4)
    done = set()
    if args.resume and args.output is not None and os.path.isfile(args.output):
        from .io.fasta import read_fasta

        done = {name.split(" ")[0] for name in read_fasta(args.output)}
        out = open(args.output, "a")
    else:
        out = sys.stdout if args.output is None else open(args.output, "w")
    regions = [r for r in regions if r.split(" ")[0] not in done]
    for r in sorted(done):
        sys.stderr.write("Resuming past {}\n".format(r))

    def emit(region, seq, acc):
        if args.test:
            region += " [" + str(round(acc, 2)) + "]"
        out.write(">{}\n{}\n".format(region, seq))
        out.flush()

    batch = max(int(getattr(args, "region_batch", 1) or 1), 1)
    if batch > 1:
        from concurrent.futures import ThreadPoolExecutor

        from .pipeline import load_many, mutate_many

        # one loader thread prefetches the NEXT chunk's BAM/fast5 loads while
        # the device computes the current chunk (region loading was serial
        # with compute — part of the host floor named in PERF.md); only the
        # top-level pass prefetches, halving retries reload via the parsed
        # caches (a failed attempt may have mutated its loaded sessions)
        loader = ThreadPoolExecutor(max_workers=1,
                                    thread_name_prefix="psq-load")

        def load_part(part):
            return load_many(args.ref, args.bam, args.dir, part,
                             params=args.params, backend=args.backend)

        def run_chunk(chunk, width, prefetch=False):
            """Lockstep-batch a chunk, halving the batch width on failure
            (device OOM at large widths is recoverable at smaller ones once
            the jit caches release the big programs' buffers); width 1 keeps
            the sequential skip-one-region error unit."""
            parts = [chunk[at : at + width]
                     for at in range(0, len(chunk), width)]
            fut = None
            for pi, part in enumerate(parts):
                loaded = None
                if prefetch:
                    loaded = (fut.result() if fut is not None
                              else load_part(part))
                    fut = (loader.submit(load_part, parts[pi + 1])
                           if pi + 1 < len(parts) else None)
                try:
                    if width == 1:
                        results = [mutate(
                            args.ref, args.bam, args.dir, params=args.params,
                            region=part[0], test=args.test,
                            verbose=args.verbose, reps=args.iterations,
                            backend=args.backend)]
                    else:
                        results = mutate_many(
                            args.ref, args.bam, args.dir, part,
                            params=args.params, test=args.test,
                            verbose=args.verbose, reps=args.iterations,
                            backend=args.backend, loaded=loaded)
                except Exception as e:
                    if width == 1:
                        sys.stderr.write(
                            "Skipping {}: {}\n".format(part[0], str(e)))
                        continue
                    sys.stderr.write(
                        "Batch of {} failed ({}), retrying at {}\n".format(
                            len(part), str(e), max(width // 2, 1)))
                    # drop the failed programs' device buffers before retrying
                    import gc

                    gc.collect()
                    try:
                        import jax

                        jax.clear_caches()
                    except Exception:
                        pass
                    run_chunk(part, max(width // 2, 1))
                    continue
                for region, res in zip(part, results):
                    if res is not None:  # None = region skipped during load
                        emit(region, res[0], res[1])

        try:
            run_chunk(regions, batch, prefetch=True)
        finally:
            # always release the loader thread (and cancel any in-flight
            # prefetch) — a raise from run_chunk/emit must not leak a
            # non-daemon worker that delays interpreter exit
            loader.shutdown(wait=False, cancel_futures=True)
        return

    for region in regions:
        try:
            seq, acc = mutate(args.ref, args.bam, args.dir, params=args.params,
                              region=region, test=args.test,
                              verbose=args.verbose, reps=args.iterations,
                              backend=args.backend)
        except Exception as e:
            sys.stderr.write("Skipping {}: {}\n".format(region, str(e)))
            continue
        emit(region, seq, acc)


def variant(args):
    args.params = load_params(args.params)
    regions = parse_regions(args)

    # multi-host: regions dealt round-robin, scores go to each process's own
    # stdout.  The muts partitioning below must still walk EVERY region in
    # order (it consumes the list sequentially), so sharding only skips the
    # execution, not the bookkeeping.
    from .parallel.distributed import init_multihost

    pid, nproc = init_multihost(getattr(args, "coordinator", None),
                                getattr(args, "num_processes", None),
                                getattr(args, "process_id", None))
    if nproc > 1:
        sys.stderr.write("Process {}/{}: {} of {} regions\n".format(
            pid, nproc, len(regions[pid::nproc]), len(regions)))

    muts = []
    if args.mut_file is not None:
        for line in open(args.mut_file).readlines():
            mi = MutationInfo(line)
            if mi.start < 0:
                continue
            muts.append(mi)

    if "end_trim" not in args.params:
        args.params["end_trim"] = 0
    for ri, region in enumerate(regions):
        reginfo = RegionInfo(region)
        curmuts = [x for x in muts
                   if x.start < reginfo.end - args.params["end_trim"]]
        muts = [x for x in muts
                if x.start >= reginfo.end - args.params["end_trim"]]
        if curmuts == [] and not args.all:
            continue
        if nproc > 1 and ri % nproc != pid:
            continue
        try:
            variant_fn(args.ref, args.bam, args.dir, args.fasta, curmuts,
                       region, args.params, args.verbose, backend=args.backend)
        except Exception as e:
            sys.stderr.write("Skipping {}: {}\n".format(region, str(e)))
            continue


class trainhelper:
    """Picklable closure for the training pool (cmdline.py:235-244)."""

    def __init__(self, _args):
        self.args = _args

    def __call__(self, params):
        return mutate(self.args.ref, self.args.bam, self.args.dir,
                      params=params, region=self.args.region,
                      test=(not self.args.descend), verbose=1, reps=10,
                      backend=self.args.backend)


def train(args):
    """Hill-climb on consensus accuracy (cmdline.py:246-267).

    exact backend: a process pool over candidates, like the reference.
    tpu backend: one device can't be shared by a fork pool — the 16 candidates
    run as ONE lockstep batch instead (pipeline.train_candidates), every
    propose/score round batched across candidates."""
    from .parallel.distributed import allgather_round_robin, init_multihost

    pid, nproc = init_multihost(getattr(args, "coordinator", None),
                                getattr(args, "num_processes", None),
                                getattr(args, "process_id", None))

    params = load_params(args.params)
    for i in range(args.iter):
        if nproc > 1:
            # every process must propose the IDENTICAL candidate list, so the
            # proposal rng is seeded deterministically from the shared state
            # (current params + iteration); each process evaluates its
            # round-robin share and accuracies are allgathered before the
            # (replicated) argmax — the multi-host form of the reference's
            # fork pool (cmdline.py:258-259)
            import random as _random

            seed = "{}|{}".format(i, sorted(params.items()))
            paramlist = vary_params(params, rng=_random.Random(seed))
            mine = paramlist[pid::nproc]
        else:
            paramlist = vary_params(params)
            mine = paramlist
        if args.backend == "tpu":
            from .pipeline import train_candidates

            seqs = train_candidates(args.ref, args.bam, args.dir, args.region,
                                    mine, descend=args.descend,
                                    backend=args.backend)
        elif args.threads > 1:
            with Pool(processes=args.threads) as pool:
                seqs = pool.map(trainhelper(args), mine)
        else:
            seqs = [trainhelper(args)(p) for p in mine]
        accs = [s[1] for s in seqs]
        if nproc > 1:
            accs = allgather_round_robin(accs, len(paramlist), pid, nproc)
        params = paramlist[int(np.argmax(accs))]
        save_params("train_best.conf", params)
        sys.stderr.write("Best at iter {}: {}\n".format(i + 1, max(accs)))


def extract(args):
    fast5files = []
    for d in args.dirs:
        fast5files += glob.glob(os.path.join(d, "*.fast5"))
    extract_fasta(fast5files, args.fasta, args.path, False)


def split(args):
    if args.region_length is None:
        split_fasta(args.fasta, args.num_files, args.per_file)
    else:
        split_regions(args.fasta, args.region_length, args.num_files,
                      args.per_file)


def merge(args):
    merge_fasta(args.fasta_in, args.fasta_out)


if __name__ == "__main__":
    main()
