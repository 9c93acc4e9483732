"""`dsk` CLI: count canonical k-mers into a count store (`<out>.dsk`).

Replaces the reference's dsk tool (src/main.cpp, src/DSK.cpp).  The
options are owned by the engine layer (RunParams) and merely surfaced
here — the same composition design as the reference, where the Tool's
parser IS SortingCountAlgorithm::getOptionsParser() (src/DSK.cpp:83-86).
"""

from __future__ import annotations

import argparse
import sys

from dsk_tpu.engine.run import RunParams, execute


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dsk",
        description="k-mer counter on an accelerator (dsk-compatible CLI)",
        prefix_chars="-",
        add_help=False,
    )
    p.add_argument("-help", "--help", action="help")
    p.add_argument("-version", action="version", version="dsk_tpu 0.1.0")
    req = p.add_argument_group("required")
    req.add_argument("-file", required=True,
                     help="input file(s): fasta/fastq(.gz), comma list, or album file")
    req.add_argument("-kmer-size", dest="kmer_size", type=int, default=31,
                     help="size of a kmer (default 31)")
    opt = p.add_argument_group("options")
    opt.add_argument("-abundance-min", dest="abundance_min", type=int, default=2,
                     help="min abundance threshold for solid kmers (default 2)")
    opt.add_argument("-abundance-max", dest="abundance_max", type=int,
                     default=2**31 - 1, help="max abundance threshold")
    opt.add_argument("-solidity-kind", dest="solidity_kind", default="sum",
                     choices=["sum", "min", "max", "one", "all", "custom"],
                     help="way to compute kmer solidity over multiple banks")
    opt.add_argument("-solidity-custom", dest="solidity_custom", default=None,
                     help="0/1 list over banks: kmers solid in exactly that subset")
    opt.add_argument("-out", default=None, help="output file prefix")
    opt.add_argument("-out-dir", dest="out_dir", default=".",
                     help="output directory")
    opt.add_argument("-out-tmp", dest="out_tmp", default=None,
                     help="directory for temporary (spill) files")
    opt.add_argument("-max-memory", dest="max_memory", type=int, default=5000,
                     help="max memory in MBytes (device table budget)")
    opt.add_argument("-max-disk", dest="max_disk", type=int, default=0,
                     help="max spill space in MBytes (0 = auto)")
    opt.add_argument("-histo-max", dest="histo_max", type=int, default=10000,
                     help="max abundance bin in the histogram (default 10000)")
    opt.add_argument("-histo", type=int, default=0,
                     help="output the abundance histogram as a .histo text file")
    opt.add_argument("-histo2D", dest="histo2d", type=int, default=0,
                     help="output the 2D assembly-vs-reads abundance matrix "
                          "(assembly must be the FIRST input file)")
    opt.add_argument("-nb-cores", dest="nb_cores", type=int, default=0,
                     help="number of host pipeline cores (0 = all)")
    opt.add_argument("-solid-kmers-out", dest="solid_kmers_out", default=None,
                     help="explicit output file for the solid-kmer store")
    opt.add_argument("-out-compress", dest="out_compress", type=int, default=0,
                     help="zlib-compress the output store datasets")
    opt.add_argument("-storage-type", dest="storage_type", default="dsk",
                     choices=["dsk"],
                     help="output container format (numpy container "
                          "directory, store/container.py)")
    opt.add_argument("-minimizer-size", dest="minimizer_size", type=int,
                     default=10, help="m-mer size for minimizer statistics")
    opt.add_argument("-minimizer-type", dest="minimizer_type", type=int,
                     default=0, choices=[0, 1],
                     help="0: round-robin, 1: frequency-balanced repartition")
    opt.add_argument("-repartition-type", dest="repartition_type", type=int,
                     default=0, choices=[0, 1],
                     help="1: compute a minimizer repartition table "
                          "(stored in run info)")
    opt.add_argument("-send-slack", dest="send_slack", type=float,
                     default=2.5,
                     help="all_to_all per-destination capacity headroom "
                          "(auto-doubled on routing overflow)")
    opt.add_argument("-max-retries", dest="max_retries", type=int, default=3,
                     help="auto re-plan attempts on capacity overflow")
    opt.add_argument("-flush-buckets", dest="flush_buckets", type=int,
                     default=1,
                     help=">1: split the key space into S hash buckets and "
                          "flush with batched per-bucket sorts (DSK's "
                          "per-partition sort analog); 1 = flat merge")
    opt.add_argument("-trace-dir", dest="trace_dir", default=None,
                     help="write a jax.profiler (xprof) device trace of "
                          "the count phase to this directory")
    opt.add_argument("-verbose", type=int, default=1, help="verbosity level")
    opt.add_argument("-engine", default="auto",
                     choices=["auto", "simple", "dist"],
                     help="counting engine: static-shape mesh engine (dist), "
                          "dynamic single-device (simple), or auto")
    opt.add_argument("-resume", action="store_true",
                     help="resume a multi-pass run from <out>.ckpt")
    opt.add_argument("-no-checkpoint", dest="no_checkpoint",
                     action="store_true",
                     help="disable per-pass checkpointing")
    opt.add_argument("-wire", default=None, choices=["exc", "bitmap"],
                     help="H2D wire format (default auto: sparse exc, "
                          "bitmap on N-dense fallback / multi-process)")
    opt.add_argument("-spill", default="auto",
                     choices=["auto", "on", "off"],
                     help="host partition spill (DSK's disk fill/count "
                          "split): auto = planner decides from measured "
                          "wire/re-read cost")
    opt.add_argument("-spill-partitions", dest="spill_partitions",
                     type=int, default=0,
                     help="override the planner's spill partition count")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    params = RunParams(
        file=args.file,
        kmer_size=args.kmer_size,
        abundance_min=args.abundance_min,
        abundance_max=args.abundance_max,
        solidity_kind=args.solidity_kind,
        solidity_custom=args.solidity_custom,
        out=args.out,
        out_dir=args.out_dir,
        out_tmp=args.out_tmp,
        max_memory=args.max_memory,
        max_disk=args.max_disk,
        histo_max=args.histo_max,
        histo=bool(args.histo),
        histo2d=bool(args.histo2d),
        nb_cores=args.nb_cores,
        verbose=args.verbose,
        resume=args.resume,
        checkpoint=not args.no_checkpoint,
        engine=args.engine,
        solid_kmers_out=args.solid_kmers_out,
        out_compress=bool(args.out_compress),
        minimizer_size=args.minimizer_size,
        minimizer_type=args.minimizer_type,
        repartition_type=args.repartition_type,
        send_slack=args.send_slack,
        max_retries=args.max_retries,
        flush_buckets=args.flush_buckets,
        wire=args.wire,
        trace_dir=args.trace_dir,
        spill=args.spill,
        spill_partitions=args.spill_partitions,
    )
    try:
        execute(params)
    except (ValueError, FileNotFoundError, RuntimeError) as e:
        print(f"dsk: error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
